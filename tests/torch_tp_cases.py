"""The tensor-parallel cases of ``tests/test_torch_tp.py``, and the rank worker that runs them.

Run as ``python tests/torch_tp_cases.py OUT_DIR`` with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) in the environment: each rank joins a gloo group on the CPU, builds the grid of
``OUT_DIR/inputs.pt`` (tp 2; dp the world size over 2), shards the models there and writes what it saw to
``OUT_DIR/rank<r>.pt``. It imports no JAX: the test process writes the inputs (the models' states converted from
JAX's variables) and holds the results to JAX's functions and to one-process runs of this module's functions.
"""

from __future__ import annotations

import os
import sys

import torch

import torch_ddp_cases as ddp_cases
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import shards, tp
from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers
from fqss_tpu_torch.quant.quantizers import ActQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

TP = 2
# tests/test_tp.py's tiny Sepformer
KW = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=64,
          n_layers=1)
QAT = dict(qat=True, observer=True, out_quant=True)
HTD_TINY = dict(channels=8, nfft=512, t_layers=3, t_heads=4, segment=0.5, samplerate=8000)  # test_htdemucs.py's
# The attentions of DPTNet and HTDemucs under tp (their only sharded layers): (class, architecture, input shape)
ATTENTION_MODELS = {"DPTNet": (DPTNet, ddp_cases.DPTNET, (2, 800)), "HTDemucs": (HTDemucs, HTD_TINY, (2, 2, 4000))}
STEP_CFG = TrainConfig(kd_lambda=0.1, lr=1e-3)
MSE_CASE = ddp_cases.KD_CASES["Sepformer-mse"]
MSE_STEPS = ddp_cases.STEPS + 1  # the window's steps and the first after it


def sepformer(state: dict | None, q: QuantSpec = QuantSpec(), **kw) -> Sepformer:
    """The tiny Sepformer with ``state`` loaded (the seed's weights where None)."""
    model = Sepformer(q=q, generator=torch.Generator().manual_seed(0), **(kw or KW))
    if state is not None:
        model.load_state_dict(state)
    return model


def attention_model(name: str) -> torch.nn.Module:
    """The float tiny model of ATTENTION_MODELS from seed 0."""
    cls, arch, _ = ATTENTION_MODELS[name]
    return cls(generator=torch.Generator().manual_seed(0), **arch)


def forward(model: torch.nn.Module, x: torch.Tensor, mesh: dp.Mesh | None) -> torch.Tensor:
    """An eval forward of ``model`` (sharded over ``mesh``'s tp ranks where given) on ``x``."""
    model.eval()
    with torch.no_grad(), dp.sharded(mesh):
        return model(x)


def kd_step(student: torch.nn.Module, teacher: torch.nn.Module, mix, src, mesh: dp.Mesh | None) -> dict:
    """One float KD step of STEP_CFG on this rank's rows of ``mix``/``src`` (the whole batch without a mesh): the
    loss, the gradient's global norm and the whole parameters after it."""
    state = TrainState(student, make_optimizer(STEP_CFG, [p for p in student.parameters() if p.requires_grad]),
                       teacher.requires_grad_(False).eval())
    rows = mesh.rows(len(mix)) if mesh is not None else slice(None)
    m = make_train_step(STEP_CFG, mesh)(state, mix[rows], src[rows])
    with dp.sharded(mesh):
        whole = shards.whole_state_dict(student) if mesh is not None else {k: v.detach().clone() for k, v in
                                                                        student.state_dict().items()}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: whole[k] for k, _ in student.named_parameters()}}


def emulate_row_parallel(model: torch.nn.Module, size: int = TP) -> None:
    """Make ``model`` (whole, one process) compute its row-parallel products as a grid of ``size`` tp ranks does:
    each the sum, in rank order, of the products of ``size`` column blocks, then the bias (and the output grid as
    a module); every other product is bitwise a column shard's already (each column's sum is the same whatever
    the columns). So a one-process run sees the values that the ranks see, and only the reductions tell them
    apart."""

    def split_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        k = w.shape[1] // size
        parts = [torch.matmul(x[..., i * k:(i + 1) * k], w[:, i * k:(i + 1) * k].t()) + 0.0 for i in range(size)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    for name, m in model.named_modules():
        if isinstance(m, QMultiheadAttention):
            project = m._project

            def out_split(x, w, b, m=m, project=project):
                return split_sum(x, w) + b if b is m.out_proj_bias else project(x, w, b)

            m._project = out_split
        elif name.endswith("ffn_out"):
            def ffn_out(x, m=m):
                wq = m.weight_fake_quantize
                w = wq.grouped(m.weight) if wq is not None else m.weight
                y = split_sum(x, w) + m.bias
                return m.activation_fake_quantize(y) if m.activation_fake_quantize is not None else y

            m.forward = ffn_out


def act_range_grads(model: torch.nn.Module) -> dict:
    """The gradients of the act quantizers' ranges (replicated parameters, whole on every rank)."""
    return {f"{n}.{k}": p.grad.detach().clone() for n, m in model.named_modules() if isinstance(m, ActQuantizer)
            for k, p in m.named_parameters() if p.grad is not None}


def mse_run(mesh: dp.Mesh | None, forced: list | None = None) -> dict:
    """tests/torch_ddp_cases.py's Sepformer-MSE KD steps through its 3-step window and one step after it, on this
    rank's rows under ``mesh`` (the model sharded over its tp ranks) or, without one, on the whole batch from
    ``forced`` learned parameters before each step with the row-parallel products emulated
    (:func:`emulate_row_parallel`): the MSE search where the window closes, as the recipe runs it; per step the
    observers' state after the forward, the loss, the act quantizers' range gradients after the last step (the
    first whose grids quantize), and on the grid the learned parameters
    before each step and the state after the last step, whole."""
    state = ddp_cases.new_state(MSE_CASE)
    if mesh is not None:
        tp.shard_model_tp(state.model, mesh)
        state.optimizer = make_optimizer(TrainConfig(), [p for p in state.model.parameters() if p.requires_grad])
    else:
        emulate_row_parallel(state.model)
    step = make_train_step(TrainConfig(), mesh)
    out = {"before": [], "loss": [], "observed": []}
    state.model.register_forward_hook(lambda m, args, o: out["observed"].append(ddp_cases.observer_state(m)))
    rows = mesh.rows(ddp_cases.BATCH) if mesh is not None else slice(None)
    for i, (mix, src) in enumerate(ddp_cases.batches(MSE_CASE, n=MSE_STEPS)):
        if forced is not None:
            with torch.no_grad():
                for k, p in state.model.named_parameters():
                    if k in forced[i]:
                        p.copy_(forced[i][k])
        if mesh is not None:
            with dp.sharded(mesh):
                whole = shards.whole_state_dict(state.model)
            out["before"].append({k: whole[k] for k in ddp_cases.learned(state.model)})
        out["loss"].append(float(step(state, mix[rows], src[rows])["loss"]))
        if i + 1 == ddp_cases.STEPS:  # the window closes: the MSE search, as the recipe runs it on every rank
            calibrate_mse_quantizers(state.model)
    out["act_grads"] = act_range_grads(state.model)
    if mesh is not None:
        out["tp_sharded"] = sorted(k for k in out["act_grads"]
                                   if getattr(state.model.get_submodule(k.rpartition(".")[0]), "tp_sharded", False))
        with dp.sharded(mesh):
            out["state"] = shards.whole_state_dict(state.model)
    return out


def worker(out_dir: str) -> None:
    torch.set_num_threads(1)
    world = dp.init_distributed("cpu", backend="gloo")
    try:
        mesh = dp.grid(world, TP)
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        result: dict = {"tp": (mesh.tp_rank, mesh.tp_size), "dp": (mesh.rank, mesh.size)}
        if mesh.size == 1:  # tp 2 alone: the forwards
            for name, q in (("float", QuantSpec()), ("qat", QuantSpec(**{**QAT, "observer": False}))):
                model = tp.shard_model_tp(sepformer(inputs[name], q), mesh)
                result[name] = forward(model, inputs["x"], mesh)
                if name == "float":
                    with dp.sharded(mesh):
                        result["float_whole"] = shards.whole_state_dict(model)
            for name in ATTENTION_MODELS:
                model = tp.shard_model_tp(attention_model(name), mesh)
                result[name] = forward(model, inputs[name], mesh)
        else:  # dp 2 x tp 2: the float KD step, and the MSE case's reductions
            student = tp.shard_model_tp(sepformer(inputs["student"]), mesh)
            result["step"] = kd_step(student, sepformer(inputs["teacher"]), inputs["mix"], inputs["src"], mesh)
            result["mse"] = mse_run(mesh)
        torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
    finally:
        dp.shutdown()


if __name__ == "__main__":
    worker(sys.argv[1])
