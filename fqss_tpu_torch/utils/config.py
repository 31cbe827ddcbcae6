"""Config loading: plain YAML + the HyperPyYAML subset the reference uses
(``fqss_tpu/utils/config.py``).

``yaml`` is imported by the loading functions only, so that importing the
port loads no YAML parser (the GPU machine has none; ``chip_smoke.py``
writes its configs out as dicts, or as JSON files for the CLIs, which
:func:`load_config` reads without a YAML parser).

The reference parses configs with three dialects (SURVEY.md §5): plain
``yaml.safe_load`` (asteroid/tasnet), HyperPyYAML (sepformer + val/infer,
val.py:193), and hydra/OmegaConf (htdemucs). This loader covers all
experiment YAMLs with one parser:

* ``!ref <key>`` / ``!ref <a[b]>`` value references, including string
  interpolation (``!ref <work_dir>/train_log.txt``) and chained refs.
* ``!new:pkg.Cls`` / ``!name:pkg.fn`` tags are preserved as
  ``{"_target_": "pkg.Cls", ...kwargs}`` dicts instead of instantiating
  framework objects — this build configures its own trainer from the plain
  keys, so speechbrain/hydra are not needed.
"""

from __future__ import annotations

import json
import re
from typing import Any

_REF_RE = re.compile(r"<([^<>]+)>")


class _Ref(str):
    """Marker for an unresolved !ref string."""


class _Tagged(dict):
    pass


def _make_loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def ref_constructor(loader, node):
        return _Ref(loader.construct_scalar(node))

    def multi_constructor(loader, tag_suffix, node):
        target = tag_suffix
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = {"_args_": loader.construct_sequence(node, deep=True)}
        else:
            scalar = loader.construct_scalar(node)
            value = {"_args_": [scalar]} if scalar else {}
        out = _Tagged(value)
        out["_target_"] = target
        return out

    Loader.add_constructor("!ref", ref_constructor)
    Loader.add_multi_constructor("!new:", lambda lo, ts, n: multi_constructor(lo, ts, n))
    Loader.add_multi_constructor("!name:", lambda lo, ts, n: multi_constructor(lo, ts, n))
    Loader.add_multi_constructor("!module:", lambda lo, ts, n: multi_constructor(lo, ts, n))
    Loader.add_multi_constructor("!apply:", lambda lo, ts, n: multi_constructor(lo, ts, n))
    return Loader


def _lookup(root: Any, path: str) -> Any:
    """Resolve 'a[b][c]' or plain 'a' against the config root."""
    m = re.match(r"^([^\[\]]+)((\[[^\[\]]+\])*)$", path.strip())
    if not m:
        raise KeyError(path)
    cur = root[m.group(1)]
    for part in re.findall(r"\[([^\[\]]+)\]", m.group(2) or ""):
        key: Any = part
        if isinstance(cur, (list, tuple)):
            key = int(part)
        cur = cur[key]
    return cur


def _resolve(node: Any, root: Any) -> Any:
    if isinstance(node, _Ref):
        matches = _REF_RE.findall(node)
        if len(matches) == 1 and node.strip() == f"<{matches[0]}>":
            return _resolve(_lookup(root, matches[0]), root)
        # string interpolation
        out = str(node)
        for mtext in matches:
            val = _resolve(_lookup(root, mtext), root)
            out = out.replace(f"<{mtext}>", str(val))
        return out
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    return node


def load_config(path: str, overrides: dict | None = None) -> dict:
    """Load an experiment YAML (any of the reference's dialects' files), or the same config written as JSON
    (a ``.json`` path), which needs no YAML parser."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.load(f, Loader=_make_loader())
    if overrides:
        raw.update(overrides)
    return _resolve(raw, raw)


def load_config_str(text: str) -> dict:
    import yaml

    raw = yaml.load(text, Loader=_make_loader())
    return _resolve(raw, raw)
