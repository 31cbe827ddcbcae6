#!/usr/bin/env python3
"""What a change to ``chip_smoke.py`` cut from its run time, from the ``[time]`` lines of two or more of its logs.

Usage: python3 scripts/smoke_time_groups.py BEFORE_LOG AFTER_LOG [AFTER_LOG ...] [--cut PREFIX ...] [--new PREFIX ...]

Each ``[time] phases <group>: <s> s;`` line is one group of phases. A group whose name starts with a ``--cut`` prefix
is one the change altered; a ``--new`` group (phases the change added) is left out of both totals; every other group
is taken as untouched. For each AFTER_LOG it prints the totals, the untouched groups' ratio (after / before: how much
faster or slower the host ran), and the cut: the altered groups' time before, scaled by that ratio, less their time
after. Where both logs come from one call on one machine the ratio is near 1 and the raw and scaled cuts agree.
"""

from __future__ import annotations

import argparse
import re

TIME_LINE = re.compile(r"\[time\] phases (.*): ([0-9.]+) s;")


def groups(path: str) -> dict[str, float]:
    with open(path) as f:
        return {m.group(1): float(m.group(2)) for m in map(TIME_LINE.match, f) if m}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after", nargs="+")
    ap.add_argument("--cut", action="append", default=[], help="name prefix of a group the change altered")
    ap.add_argument("--new", action="append", default=[], help="name prefix of a group the change added")
    args = ap.parse_args()
    kind = lambda name: ("new" if name.startswith(tuple(args.new)) else  # noqa: E731
                         "cut" if name.startswith(tuple(args.cut)) else "untouched")
    before = groups(args.before)
    total = lambda g, k: sum(v for name, v in g.items() if kind(name) == k)  # noqa: E731
    b_cut, b_same = total(before, "cut"), total(before, "untouched")
    for path in args.after:
        after = groups(path)
        a_cut, a_same, a_new = total(after, "cut"), total(after, "untouched"), total(after, "new")
        ratio = a_same / b_same
        print(f"{path}: before {b_cut + b_same:.1f} s, after {a_cut + a_same:.1f} s without the new groups "
              f"({a_new:.1f} s); untouched groups {b_same:.1f} -> {a_same:.1f} s (ratio {ratio:.4f}); altered groups "
              f"{b_cut:.1f} -> {a_cut:.1f} s: raw cut {b_cut + b_same - a_cut - a_same:.1f} s, scaled cut "
              f"{b_cut * ratio - a_cut:.1f} s")


if __name__ == "__main__":
    main()
