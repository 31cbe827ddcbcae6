"""The port's multi-rank dry run (``fqss_tpu_torch/parallel/dryrun.py``, ``__graft_entry__.py:25``'s counterpart) on
gloo ranks on the CPU: the four phases' lines in order and the final line, with finite losses (each step phase checks
that its state reached step 1), and an odd count skipping phases 1-2 and running the pipeline on one stage, as JAX's
``dryrun_multichip`` does."""

import math
import os
import re
import subprocess
import sys

import pytest

from fqss_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE = re.compile(r"^\[dryrun \+\s*[\d.]+s\] phase (\d)/4 (.*)$")


def _phases(out: str) -> dict[int, str]:
    return {int(m.group(1)): m.group(2) for m in map(PHASE.match, out.splitlines()) if m}


def _losses(line: str) -> list[float]:
    return [float(v) for v in re.findall(r"loss=(-?[\d.]+|nan)", line)]


def test_dryrun_multichip_four_ranks_prints_every_phase(capfd):
    dryrun.dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    phases = _phases(out)
    assert list(phases) == [1, 2, 3, 4]
    assert phases[1].startswith("dp+tp Sepformer KD train step OK on a (2, 2) grid") and "step 1" in phases[1]
    assert phases[2].startswith("sp OLA chunk-sharded eval forward OK (8 chunks over 4 ranks)")
    assert phases[3].startswith("fsdp ConvTasNet KD train step OK") and "step 1" in phases[3]
    assert phases[4].startswith("pp 2-stage fwd+grad OK")
    assert all(math.isfinite(v) for i in (1, 3, 4) for v in _losses(phases[i]))
    final = out.strip().splitlines()[-1]
    assert final.startswith("dryrun_multichip(4): dp+tp loss=") and final.endswith("pp 2-stage fwd+grad OK")
    assert len(_losses(final)) == 2 and all(math.isfinite(v) for v in _losses(final))


def test_dryrun_cli_odd_count_skips_as_jaxs_does():
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.parallel.dryrun", "--ranks", "3", "--device", "cpu"],
                          cwd=REPO, env={**env, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    phases = _phases(proc.stdout)
    assert phases[1].startswith("dp+tp skipped (odd n_ranks)") and phases[2].startswith("sp skipped (odd n_ranks)")
    assert "fsdp ConvTasNet KD train step OK" in phases[3] and phases[4].startswith("pp 1-stage fwd+grad OK")
    final = proc.stdout.strip().splitlines()[-1]
    assert final.startswith("dryrun_multichip(3): dp+tp loss=nan;") and math.isfinite(_losses(final)[1])


def test_dryrun_under_torchrun_refuses_another_count(monkeypatch):
    for k, v in dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="torchrun world of 2"):
        dryrun.dryrun_multichip(4, device="cpu")
