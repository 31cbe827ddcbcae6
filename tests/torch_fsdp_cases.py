"""The FSDP cases of ``tests/test_torch_fsdp.py``, and the rank worker that runs them.

Run as ``python tests/torch_fsdp_cases.py OUT_DIR [DEVICE]`` with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) in the environment: each rank joins a gloo group on the CPU (or on the card, shared,
where ``tests/test_torch_cuda.py`` runs the QAT case alone) and writes what it saw to ``OUT_DIR/rank<r>.pt``. Two
ranks run the float KD step of ``OUT_DIR/inputs.pt`` (the JAX package's weights and batch) with the state sharded,
and the tiny QAT ConvTasNet's steps through its observer window sharded and data-parallel on the same ranks; four
ranks, a dp 2 x tp 2 grid, the tiny Sepformer's forward and KD step with tensor and FSDP shards. It imports no JAX:
the test process writes the inputs and holds the results to JAX's step and to one-process runs.
"""

from __future__ import annotations

import os
import sys

import torch

import torch_ddp_cases as ddp_cases
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.parallel import fsdp, shards, tp
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train import trainer
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

# tests/test_fsdp.py's ConvTasNet (KW) and step, and its tp + fsdp Sepformer (test_tp_fsdp_compose)
KW = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=64, bn_chan=32, hid_chan=64, n_blocks=2, n_repeats=1)
STEP_CFG = TrainConfig(kd_lambda=0.1, lr=1e-3)
SEPFORMER = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=64,
                 n_layers=1)
TP = 2
COMPOSE_MIN_SIZE = 2**8
# The QAT case: tests/torch_ddp_cases.py's ConvTasNet through its 3-step window, its weights sharded at this size.
QAT_CASE = ddp_cases.KD_CASES["ConvTasNet"]
QAT_MIN_SIZE = 2**8


def convtasnet(state: dict, q: QuantSpec = QuantSpec()) -> ConvTasNet:
    model = ConvTasNet(q=q, **KW)
    model.load_state_dict(state)
    return model


def sepformer(seed: int = 0) -> Sepformer:
    return Sepformer(generator=torch.Generator().manual_seed(seed), **SEPFORMER)


def float_step(inputs: dict, mesh: dp.Mesh) -> dict:
    """tests/test_fsdp.py:62's float KD step on this rank's rows, the state sharded over ``mesh``: the loss, the whole
    parameters after it, which parameters are sharded and whether Adam's moments are slices."""
    student, teacher = convtasnet(inputs["student"]), convtasnet(inputs["teacher"]).requires_grad_(False).eval()
    state = TrainState(student, make_optimizer(STEP_CFG, list(student.parameters())), teacher)
    fsdp.shard_state_fsdp(state, mesh)
    rows = mesh.rows(len(inputs["mix"]))
    m = make_train_step(STEP_CFG, mesh)(state, inputs["mix"][rows], inputs["src"][rows])
    whole = shards.whole_state_dict(student)
    moments = [(v.shape, p.shape) for p, st in state.optimizer.state.items() if shards.is_part(p, shards.DP)
               for k, v in st.items() if k.startswith("exp_avg")]
    return {"loss": float(m["loss"]), "params": {k: whole[k] for k, _ in student.named_parameters()},
            "sharded": {k: p.placement.dim for k, p in student.named_parameters() if shards.is_part(p, shards.DP)},
            "teacher_sharded": sorted(k for k, p in teacher.named_parameters() if shards.is_part(p, shards.DP)),
            "sliced_moments": moments}


def qat_run(mesh: dp.Mesh, sharded: bool, forced: list | None = None, device: str = "cpu") -> dict:
    """QAT_CASE's KD steps through its window on this rank's rows, data-parallel or with the state
    sharded at QAT_MIN_SIZE; ``forced``: the learned parameters to take before each step (another run's). Per step the
    whole learned parameters before it, the observers after its forward, the loss, the gradient's global norm, the
    whole reduced gradients before the clip and the whole state after the step; then what the rank holds."""
    state = ddp_cases.new_state(QAT_CASE, device=device)
    if sharded:
        fsdp.shard_state_fsdp(state, mesh, min_size=QAT_MIN_SIZE)
    step = make_train_step(TrainConfig(), mesh)
    out = {"before": [], "observed": [], "loss": [], "grad_norm": [], "grads": [], "after": []}
    state.model.register_forward_hook(lambda m, args, o: out["observed"].append(ddp_cases.observer_state(m)))
    clip = trainer.clip_by_global_norm_

    def whole_before_clip(grads, max_norm, norm=None):
        out["grads"].append(shards.whole_gradients(state.model))
        return clip(grads, max_norm, norm)

    rows = mesh.rows(ddp_cases.BATCH)
    trainer.clip_by_global_norm_ = whole_before_clip
    try:
        for i, (mix, src) in enumerate(ddp_cases.batches(QAT_CASE)):
            if forced is not None:
                shards.load_whole_state_dict(state.model, forced[i])
            out["before"].append({k: v for k, v in shards.whole_state_dict(state.model).items()
                                  if k in ddp_cases.learned(state.model)})
            m = step(state, mix[rows].to(device), src[rows].to(device))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["after"].append(shards.whole_state_dict(state.model))
    finally:
        trainer.clip_by_global_norm_ = clip
    out["held"] = fsdp.held_elements(state)
    out["buffers"] = {k: v.numel() for k, v in fsdp.gather_buffers(state.model).items()}
    out["sharded"] = {k: (p.placement.dim, p.shape[p.placement.dim]) for k, p in state.model.named_parameters()
                      if shards.is_part(p, shards.DP)}
    return out


def round_trip(mesh: dp.Mesh) -> dict:
    """A sharded QAT ConvTasNet's whole state, and the whole state after taking another model's whole state."""
    model = ddp_cases.new_state(QAT_CASE).model
    other = ddp_cases.new_state(QAT_CASE, seed=5).model.state_dict()
    fsdp.shard_state_fsdp(model, mesh, min_size=QAT_MIN_SIZE)
    first = shards.whole_state_dict(model)
    shards.load_whole_state_dict(model, other)
    return {"first": first, "loaded": shards.whole_state_dict(model), "other": other}


def compose(x: torch.Tensor, mesh: dp.Mesh) -> dict:
    """tests/test_fsdp.py:103 on the port: the tiny Sepformer sharded over tp, then FSDP at COMPOSE_MIN_SIZE; which
    parameters each shards, and the eval forward of ``x`` (this dp rank's rows, gathered)."""
    model = tp.shard_model_tp(sepformer(), mesh)
    tp_parts = {k: p for k, p in model.named_parameters() if shards.is_part(p, shards.TP)}
    fsdp.shard_state_fsdp(model, mesh, min_size=COMPOSE_MIN_SIZE)
    model.eval()
    with torch.no_grad(), dp.sharded(mesh):
        y = dp.gather_rows(model(x[mesh.rows(len(x))]), len(x))
    params = dict(model.named_parameters())
    return {"y": y, "tp": sorted(k for k, p in params.items() if shards.is_part(p, shards.TP)),
            "dp": sorted(k for k, p in params.items() if shards.is_part(p, shards.DP)),
            "both": sorted(k for k, p in tp_parts.items() if params[k] is not p)}  # a tp shard that FSDP cut again


def grid_step(inputs: dict, mesh: dp.Mesh, sharded: bool) -> dict:
    """A float KD step of the tiny Sepformer (seed 0, teacher seed 1) on the grid ``mesh``: sharded over tp, then
    (``sharded``) FSDP at COMPOSE_MIN_SIZE; the loss, the whole gradients after the clip and the whole parameters."""
    student = tp.shard_model_tp(sepformer(), mesh)
    state = TrainState(student, make_optimizer(STEP_CFG, list(student.parameters())),
                       sepformer(1).requires_grad_(False).eval())
    if sharded:
        fsdp.shard_state_fsdp(state, mesh, min_size=COMPOSE_MIN_SIZE)
    rows = mesh.rows(len(inputs["mix"]))
    m = make_train_step(STEP_CFG, mesh)(state, inputs["mix"][rows], inputs["src"][rows])
    with dp.sharded(mesh):
        return {"loss": float(m["loss"]), "grads": shards.whole_gradients(student),
                "params": {k: v for k, v in shards.whole_state_dict(student).items()
                           if k in dict(student.named_parameters())}}


def worker(out_dir: str, device: str = "cpu") -> None:
    torch.set_num_threads(1)
    # on a card: TF32 off (it would move values off the 8-bit grids), cuDNN's deterministic algorithms
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    world = dp.init_distributed(device, backend="gloo")
    try:
        result: dict = {}
        if world.device.type == "cuda":
            ddp = qat_run(world, sharded=False, device=device)
            result["ddp"] = ddp
            result["fsdp"] = qat_run(world, sharded=True, forced=ddp["before"], device=device)
            torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
            return
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        if world.size == 2:
            result["float"] = float_step(inputs, world)
            ddp = qat_run(world, sharded=False)
            result["ddp"] = ddp
            result["fsdp"] = qat_run(world, sharded=True, forced=ddp["before"])
            result["round_trip"] = round_trip(world)
        else:
            mesh = dp.grid(world, TP)
            result["compose"] = compose(inputs["x"], mesh)
            result["grid_steps"] = [grid_step(inputs, mesh, sharded) for sharded in (False, True)]
        torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
    finally:
        dp.shutdown()


if __name__ == "__main__":
    worker(*sys.argv[1:3])
