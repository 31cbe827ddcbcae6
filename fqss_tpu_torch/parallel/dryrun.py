"""The multi-rank dry run (``__graft_entry__.py:25`` ``dryrun_multichip``): one step of every parallel path.

Four phases, each printed as it completes, at the JAX function's sizes, with its final line:

1. dp+tp: the Sepformer's KD step on a (dp, tp) grid (``parallel/tp.py``). JAX's grid is (2, n/2); the port's tensor
   parallelism shards whole heads, so its tp is the largest divisor of n/2 that divides the 2 heads (2 at 4 ranks:
   JAX's grid) and dp the rest.
2. sp: OLA chunks of a long mixture sharded over every rank (``ola_infer(mesh=...)``), 2 a rank: JAX's (dp, sp) mesh
   is the same partition of the chunks.
3. fsdp: ConvTasNet's KD step with its state sharded over the ranks (``parallel/fsdp.py``, ``min_size=2**8``).
4. pp: a 2-stage GPipe forward and gradient of two transformer layers on ranks 0-1 (``parallel/pp.py``); the other
   ranks wait.

An odd number of ranks skips phases 1-2 and runs the pipeline on one stage, as JAX does.

Run: ``python -m fqss_tpu_torch.parallel.dryrun --ranks N [--device cpu]``. Under torchrun (``RANK`` and the rest
set) each process joins the group; otherwise the command starts ``N`` ranks of itself on this host. On the card
(the default) the ranks take a card each over NCCL where the host has ``N``, else share ``cuda:0`` over gloo. A rank
that fails fails the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from fqss_tpu_torch.data import synth_batch
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.sepformer import Sepformer, TransformerLayer
from fqss_tpu_torch.parallel import fsdp, pp, shards, tp
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

# The sizes of __graft_entry__.py:107-108, :132-133, :191-193.
SEPFORMER = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=16, n_repeats=1, n_heads=2, chunk_size=10, n_ffn=32,
                 n_layers=1)
CONVTASNET = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=1, n_repeats=1)
SPEC = QuantSpec(qat=True, observer=True, n_splitter=2, n_combiner=2, out_quant=True)
CFG = TrainConfig(kd_lambda=0.1, lr=1e-3)
LENGTH = 800  # samples a row, and the OLA segment
PP_LAYER = dict(n_filters=8, n_ffn=16, n_heads=2)
PP_TOKENS = (16, 8)  # [L, F] of each of the pipeline's rows, one row a stage
FSDP_MIN_SIZE = 2**8


def _kd_state(student, teacher, n: int, seed: int) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """The train state of CFG for ``student`` and ``teacher``, and a global batch of 2n synthetic rows."""
    mix, src = map(torch.from_numpy, synth_batch(np.random.default_rng(seed), 2 * n, 2, LENGTH))
    state = TrainState(student, make_optimizer(CFG, [p for p in student.parameters() if p.requires_grad]),
                       teacher.requires_grad_(False).eval())
    return state, mix, src


def _check_step(state: TrainState, metrics: dict, what: str) -> float:
    loss = float(metrics["loss"])
    if not math.isfinite(loss) or state.step != 1:
        raise AssertionError(f"{what}: loss {loss}, step {state.step}")
    return loss


def dp_tp_step(world: dp.Mesh, device) -> tuple[float, tuple[int, int]]:
    """Phase 1: the Sepformer's KD step on a (dp, tp) grid; its loss and the grid."""
    n = world.size
    grid = dp.grid(world, math.gcd(n // 2, SEPFORMER["n_heads"]))
    student = Sepformer(q=SPEC, generator=torch.Generator().manual_seed(3), **SEPFORMER).to(device)
    teacher = Sepformer(generator=torch.Generator().manual_seed(3), **SEPFORMER).to(device)
    tp.shard_model_tp(student, grid)
    state, mix, src = _kd_state(student, teacher, n, 2)
    rows = grid.rows(len(mix))
    metrics = make_train_step(CFG, grid)(state, mix[rows].to(device), src[rows].to(device))
    return _check_step(state, metrics, "the dp+tp step"), (grid.size, grid.tp_size)


def _convtasnet(device, q: QuantSpec = SPEC) -> ConvTasNet:
    return ConvTasNet(q=q, generator=torch.Generator().manual_seed(0), **CONVTASNET).to(device)


def sp_ola(world: dp.Mesh, device) -> np.ndarray:
    """Phase 2: ConvTasNet's OLA separation of a mixture of 2n chunks, 2 a rank; the separation."""
    n = world.size
    model = _convtasnet(device).eval()
    stride = int(0.75 * LENGTH)
    mix = np.random.default_rng(1).uniform(-1, 1, (1, 2 * n * stride)).astype(np.float32)
    y = ola_infer(model, mix, n_srcs=2, segment=LENGTH, overlap=0.25, chunk_batch=2, mesh=world, device=device)
    if y.shape != (2, mix.shape[1]) or not np.isfinite(y).all():
        raise AssertionError(f"the sharded OLA gave {y.shape}, finite {np.isfinite(y).all()}")
    return y


def fsdp_step(world: dp.Mesh, device) -> tuple[float, int]:
    """Phase 3: ConvTasNet's KD step with its state sharded over the ranks; its loss and the parameters sharded."""
    state, mix, src = _kd_state(_convtasnet(device), _convtasnet(device, QuantSpec()), world.size, 0)
    fsdp.shard_state_fsdp(state, world, min_size=FSDP_MIN_SIZE)
    rows = world.rows(len(mix))
    metrics = make_train_step(CFG, world)(state, mix[rows].to(device), src[rows].to(device))
    sharded = sum(shards.is_part(p, shards.DP) for p in state.model.parameters())
    return _check_step(state, metrics, "the fsdp step"), sharded


def pp_fwd_grad(world: dp.Mesh, device) -> tuple[int, float | None]:
    """Phase 4: two transformer layers as GPipe stages on ranks 0-1 (one stage at an odd world size), the forward and
    the gradient of ``sum(y^2)``; the stages and the loss (None on a rank outside the pipeline, which waits)."""
    n_stages = 2 if world.size % 2 == 0 else 1
    pmesh = pp.pipeline_mesh(world, n_stages)
    loss = None
    if pmesh is not None:
        q = dataclasses.replace(SPEC, observer=False)
        layers = [TransformerLayer(**PP_LAYER, q=q, generator=torch.Generator().manual_seed(20 + i)).to(device)
                  for i in range(n_stages)]
        x = torch.randn((n_stages, *PP_TOKENS), generator=torch.Generator().manual_seed(7)).to(device)
        stage = pp.shard_layer_stack(layers, pmesh)
        value = pp.pipeline_layer_module(stage, x, pmesh).square().sum()
        value.backward()
        grads = [p.grad for p in stage.parameters() if p.grad is not None]
        if not math.isfinite(float(value)) or not grads or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"the pipeline's loss {float(value)} or a gradient is not finite")
        loss = float(value)
    if dist.is_initialized():
        dist.barrier()
    return n_stages, loss


def run(world: dp.Mesh, device, mark) -> str:
    """The four phases on this rank of ``world``; ``mark(msg)`` prints a phase's line. Returns the final line."""
    n = world.size
    tp_loss = fsdp_loss = float("nan")
    if n % 2 == 0:
        tp_loss, (d, t) = dp_tp_step(world, device)
        mark(f"phase 1/4 dp+tp Sepformer KD train step OK on a ({d}, {t}) grid (loss={tp_loss:.4f}, step 1)")
        sp_ola(world, device)
        mark(f"phase 2/4 sp OLA chunk-sharded eval forward OK ({2 * n} chunks over {n} ranks)")
    else:
        mark("phase 1/4 dp+tp skipped (odd n_ranks); pure-dp step runs in phase 3 unsharded form")
        mark("phase 2/4 sp skipped (odd n_ranks)")
    fsdp_loss, sharded = fsdp_step(world, device)
    mark(f"phase 3/4 fsdp ConvTasNet KD train step OK, {sharded} parameters sharded (loss={fsdp_loss:.4f}, step 1)")
    n_stages, pp_loss = pp_fwd_grad(world, device)
    mark(f"phase 4/4 pp {n_stages}-stage fwd+grad OK (loss={pp_loss:.4f})" if pp_loss is not None else
         f"phase 4/4 pp {n_stages}-stage fwd+grad OK")
    return (f"dryrun_multichip({n}): dp+tp loss={tp_loss:.4f}; sp eval OK; fsdp loss={fsdp_loss:.4f}; "
            f"pp {n_stages}-stage fwd+grad OK")


def _join(device: str) -> dp.Mesh:
    """This torchrun rank in its group: on the card a card a rank over NCCL where there are enough, else cuda:0
    shared over gloo; gloo on the CPU."""
    if device == "cpu":
        return dp.init_distributed("cpu", backend="gloo")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the dry run on the CPU")
    if torch.cuda.device_count() >= int(os.environ["WORLD_SIZE"]):
        return dp.init_distributed("cuda")
    return dp.init_distributed("cuda:0", backend="gloo")


def _rank_main(device: str) -> None:
    start = time.time()
    world = _join(device)
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world.size))
        mark = (lambda msg: print(f"[dryrun +{time.time() - start:6.1f}s] {msg}", flush=True)) if world.is_main \
            else (lambda msg: None)
        mark(f"{world.size} ranks up on {world.device} over {world.backend}")
        final = run(world, world.device, mark)
        if world.is_main:
            print(final, flush=True)
    finally:
        dp.shutdown()


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> None:
    """The dry run on ``n_ranks`` ranks: this process's group under torchrun, else ``n_ranks`` processes of this
    module on this host (rank 0's lines on this process's output). Raises where a rank fails."""
    if all(k in os.environ for k in dp.ENV):
        if int(os.environ["WORLD_SIZE"]) != n_ranks:
            raise ValueError(f"--ranks {n_ranks} under a torchrun world of {os.environ['WORLD_SIZE']}")
        _rank_main(device)
        return
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the package's parent
    path = os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))
    dp.spawn([sys.executable, "-m", "fqss_tpu_torch.parallel.dryrun", "--ranks", str(n_ranks), "--device", device],
             n_ranks, env={"PYTHONPATH": path}, echo=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.parallel.dryrun")
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
