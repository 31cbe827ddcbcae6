"""The data-parallel cases of ``tests/test_torch_ddp.py``, and the rank worker that runs them.

Run as ``python tests/torch_ddp_cases.py OUT_DIR [DEVICE]`` with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) in the environment: each rank joins a gloo group on the CPU (or on the card,
shared, where ``tests/test_torch_cuda.py`` runs the KD cases), runs every case on its rows of the global batch and
writes what it saw to ``OUT_DIR/rank<r>.pt``. It imports no JAX: the test process
builds the same cases from the same seeds and runs them in one process (the module's functions), and holds the
JAX package's step to the same inputs.

Every global batch is 4 rows, 2 a rank: on the CPU the tiny models' forwards at 2 rows equal their forwards at 4 row
for row (at 1 row DPTNet's do not: the products take another path), so the observers see the same values.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator

import numpy as np
import torch

from fqss_tpu_torch.data import synth_batch
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers
from fqss_tpu_torch.quant.quantizers import ActQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.separation.losses import fqss_kd_loss
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

BATCH = 4
STEPS = 3  # through the observer window of 3 steps
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=STEPS)
CONVTASNET = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
DPTNET = dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)
SEPFORMER = dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=48,
                 n_layers=1)
# (model class, architecture, spec keys beyond SPEC, samples a row)
KD_CASES = {
    "ConvTasNet": (ConvTasNet, CONVTASNET, {}, 1600),
    "DPTNet": (DPTNet, DPTNET, {}, 800),
    "DPTNet-static": (DPTNet, DPTNET, {"lstm_mode": "static"}, 800),
    "Sepformer-mse": (Sepformer, SEPFORMER, {"act_quantizer": "mse"}, 800),
}
DYNAMIC = (DPTNet, DPTNET, {"lstm_mode": "dynamic"}, 800)
# The power and threshold cases: the post-window ConvTasNet state of the JAX comparison (written by the test).
OLA = dict(seconds=24000, segment=1600, overlap=0.25, chunk_batch=3)


@contextlib.contextmanager
def one_rank_mesh(device: str = "cpu") -> Iterator[dp.Mesh]:
    """A one-rank gloo group in this process (torchrun's variables set for its life): every collective runs, each
    the identity."""
    saved = {k: os.environ.get(k) for k in dp.ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(dp.free_port()))
    try:
        mesh = dp.init_distributed(device, backend="gloo")
        try:
            yield mesh
        finally:
            dp.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn_ranks(script: str, out_dir, world: int, *args: str, timeout: float = 600) -> list[dict]:
    """``world`` gloo ranks of ``tests/<script> OUT_DIR [ARGS]`` on this host (``parallel.mesh.spawn``: torchrun's
    variables set for each; the repo and ``tests/`` on the path, one thread each), and each rank's
    ``OUT_DIR/rank<r>.pt``; raises with a rank's output where one fails."""
    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests)
    dp.spawn([sys.executable, os.path.join(tests, script), str(out_dir), *args], world, cwd=repo, timeout=timeout,
             env={"PYTHONPATH": os.pathsep.join([repo, tests]), "OMP_NUM_THREADS": "1"})
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True) for r in range(world)]


def new_state(case: tuple, seed: int = 0, cfg: TrainConfig = TrainConfig(), device: str = "cpu") -> TrainState:
    """A student of ``case`` and its float teacher from ``seed`` on ``device``, with ``cfg``'s optimizer."""
    cls, arch, extra, _ = case
    gen = torch.Generator().manual_seed(seed)
    model = cls(q=QuantSpec(observer=True, **SPEC, **extra), generator=gen, **arch).to(device)
    teacher = cls(generator=gen, **arch).requires_grad_(False).eval().to(device)
    return TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]), teacher)


def first_unlike(case: tuple, device: str = "cpu") -> str | None:
    """The first module, in the forward's order, of ``case``'s float model whose output for a batch's first 2 rows
    differs between a forward of those 2 rows and one of the whole batch on ``device`` (outputs whose leading axis
    is a multiple of the batch, batch first), or None where every one agrees bit for bit. Where one differs, a
    rank's rows differ from one process's before any reduction, and so may the extremes that the observers see."""
    teacher = new_state(case, device=device).teacher
    (mix, _), = batches(case, 1)
    runs = []
    for rows in (mix[:2], mix):
        seen: list = []
        hooks = [m.register_forward_hook(lambda m, args, out, name=name: seen.append((name, out)))
                 for name, m in teacher.named_modules() if name and not any(True for _ in m.children())]
        with torch.no_grad():
            teacher(rows.to(device))
        for h in hooks:
            h.remove()
        runs.append(seen)
    for (name, few), (_, whole) in zip(*runs):
        if (isinstance(few, torch.Tensor) and isinstance(whole, torch.Tensor) and few.ndim
                and whole.shape[1:] == few.shape[1:] and whole.shape[0] == 2 * few.shape[0]
                and not torch.equal(whole[: few.shape[0]], few)):
            return name
    return None


def batches(case: tuple, n: int = STEPS, seed: int = 1) -> list[tuple[torch.Tensor, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    return [tuple(map(torch.from_numpy, synth_batch(rng, BATCH, 2, case[3]))) for _ in range(n)]


def observer_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """What the observers write: every act quantizer's parameters and buffers (ranges, counters, histograms) and
    every static LSTM direction's site ranges and counter."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ActQuantizer):
            out.update({f"{name}.{k}": v.detach().cpu().clone() for k, v in m.state_dict().items()})
        elif "site_n_iter" in m._buffers:
            out.update({f"{name}.{k}": getattr(m, k).detach().cpu().clone()
                        for k in ("site_min", "site_max", "site_n_iter")})
    return out


def act_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The act quantizers' part of :func:`observer_state` (what the MSE calibration writes; the static sites are
    the optimizer's once out of their window)."""
    return {k: v for k, v in observer_state(model).items() if "site_" not in k}


def learned(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The parameters that the act quantizers' observers do not write (inside the window the optimizer leaves
    those: their gradient is 0). The static sites are among them: out of their window the optimizer moves them."""
    acts = {f"{n}.{k}" for n, m in model.named_modules() if isinstance(m, ActQuantizer) for k, _ in
            m.named_parameters()}
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters() if k not in acts}


def grads(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters() if p.grad is not None}


def _observed(model: torch.nn.Module, snaps: list) -> None:
    """Keep the observers' state after each forward of ``model`` (before the backward and the optimizer)."""
    model.register_forward_hook(lambda m, args, out: snaps.append(observer_state(m)))


def kd_run(case: tuple, mesh: dp.Mesh | None, device: str = "cpu") -> dict:
    """STEPS KD steps of ``case`` on this rank's rows, free-running; per step the learned parameters before it, the
    observers' state after its forward, the loss, the KD loss and the clipped gradients; then the whole state and
    the act quantizers' state after the MSE calibration (where the model has MSE quantizers)."""
    state = new_state(case, device=device)
    step = make_train_step(TrainConfig(), mesh)
    rows = mesh.rows(BATCH) if mesh is not None else slice(None)
    out = {"before": [], "loss": [], "kd_loss": [], "grads": [], "observed": []}
    _observed(state.model, out["observed"])
    for mix, src in batches(case):
        out["before"].append(learned(state.model))
        m = step(state, mix[rows].to(device), src[rows].to(device))
        out["loss"].append(float(m["loss"]))
        out["kd_loss"].append(float(m["kd_loss"]))
        out["grads"].append(grads(state.model))
    out["state"] = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
    out["calibrated"] = calibrate_mse_quantizers(state.model)
    out["calibrated_state"] = act_state(state.model)
    return out


def forced_run(case: tuple, forced: list[dict[str, torch.Tensor]], mix_src: list, device: str = "cpu") -> dict:
    """The one-process run of ``case`` on the whole batches, each step from the learned parameters ``forced`` gives
    it (the data-parallel run's: a free-running process would part from it in the last bits at the first update,
    the gradients' sums taken in another order); the act quantizers' observers keep their own state throughout."""
    state = new_state(case, device=device)
    step = make_train_step(TrainConfig())
    out = {"loss": [], "kd_loss": [], "grads": [], "observed": []}
    _observed(state.model, out["observed"])
    for params, (mix, src) in zip(forced, mix_src):
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                if k in params:
                    p.copy_(params[k])
        m = step(state, mix.to(device), src.to(device))
        out["loss"].append(float(m["loss"]))
        out["kd_loss"].append(float(m["kd_loss"]))
        out["grads"].append(grads(state.model))
    out["state"] = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
    out["calibrated"] = calibrate_mse_quantizers(state.model)
    out["calibrated_state"] = act_state(state.model)
    return out


def load_state(path: str) -> TrainState:
    """The post-window ConvTasNet written by the test (student and teacher state dicts)."""
    saved = torch.load(path, weights_only=True)
    state = new_state(KD_CASES["ConvTasNet"], cfg=TrainConfig(grad_clip=0.0))
    state.model.load_state_dict(saved["student"])
    state.teacher.load_state_dict(saved["teacher"])
    return state


def global_step(state: TrainState, mix, src, cfg: TrainConfig, mesh: dp.Mesh | None) -> dict:
    """One step of ``cfg`` on this rank's rows (the whole batch without a mesh), unclipped: loss and gradients."""
    rows = mesh.rows(len(mix)) if mesh is not None else slice(None)
    m = make_train_step(cfg, mesh)(state, mix[rows], src[rows])
    return {"loss": float(m["loss"]), "grads": grads(state.model)}


def local_mean_gradients(state: TrainState, mix, src, mesh: dp.Mesh) -> dict[str, torch.Tensor]:
    """What DDP computes from the ranks' own losses: each rank's loss of its rows alone (the log of its own batch
    means), its gradient, the mean over the ranks. Not the global batch's."""
    rows = mesh.rows(len(mix))
    state.model.train()
    state.model.zero_grad(set_to_none=True)
    est = state.model(mix[rows])[..., : src.shape[-1]]
    with torch.no_grad():
        fest = state.teacher(mix[rows])[..., : src.shape[-1]]
    fqss_kd_loss(est, fest, src[rows], kd_lambda=0.1)[0].backward()
    g = grads(state.model)
    with dp.sharded(mesh):
        dp.reduce_gradients_(list(g.values()))
    return g


def dynamic_forward(mesh: dp.Mesh | None) -> dict:
    """The dynamic-cell DPTNet's eval forward of the batch (gathered from the ranks), and one KD step's loss and
    gradients, from the seed's weights."""
    state = new_state(DYNAMIC)
    (mix, src), = batches(DYNAMIC, 1)
    rows = mesh.rows(BATCH) if mesh is not None else slice(None)
    state.model.eval()
    with torch.no_grad(), dp.sharded(mesh):
        y = dp.gather_rows(state.model(mix[rows]), BATCH)
    return {"forward": y, **global_step(state, mix, src, TrainConfig(), mesh)}


def ola_mix() -> np.ndarray:
    return synth_batch(np.random.default_rng(5), 1, 2, OLA["seconds"])[0]


def sharded_ola(state: TrainState, mesh: dp.Mesh | None, chunk_batch: int) -> np.ndarray:
    """The post-window ConvTasNet's OLA separation of :func:`ola_mix` (``mesh``: sharded over its ranks)."""
    model = state.model.eval()
    return ola_infer(model, ola_mix(), n_srcs=2, segment=OLA["segment"], overlap=OLA["overlap"],
                     chunk_batch=chunk_batch, mesh=mesh)


def worker(out_dir: str, device: str = "cpu") -> None:
    """Every case on the CPU; on a card (``device`` ``cuda:0``, gloo: the ranks share it) the KD cases alone."""
    torch.set_num_threads(1)
    # on a card as the test process runs: TF32 off (it would move values off the 8-bit grids), and cuDNN's
    # deterministic algorithms (its default convolution backward sums with atomics)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = dp.init_distributed(device, backend="gloo")
    assert mesh is not None and mesh.backend == "gloo"
    try:
        result: dict = {"kd": {name: kd_run(case, mesh, device) for name, case in KD_CASES.items()}}
        if mesh.device.type == "cuda":
            torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
            return
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        state_path = os.path.join(out_dir, "post_window.pt")
        result["jax_step"] = global_step(load_state(state_path), inputs["jax_mix"], inputs["jax_src"],
                                         TrainConfig(), mesh)
        result["power"] = global_step(load_state(state_path), inputs["power_mix"], inputs["power_src"],
                                      TrainConfig(grad_clip=0.0), mesh)
        result["local_mean"] = local_mean_gradients(load_state(state_path), inputs["power_mix"], inputs["power_src"],
                                                    mesh)
        result["threshold"] = global_step(load_state(state_path), inputs["power_mix"], inputs["power_src"],
                                          TrainConfig(grad_clip=0.0, threshold_byloss=True,
                                                      threshold=float(inputs["threshold"])), mesh)
        result["dynamic"] = dynamic_forward(mesh)
        result["ola"] = torch.from_numpy(sharded_ola(load_state(state_path), mesh, OLA["chunk_batch"]))
        torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        dp.shutdown()


if __name__ == "__main__":
    worker(*sys.argv[1:3])
