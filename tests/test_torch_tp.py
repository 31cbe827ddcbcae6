"""Tensor parallelism (``fqss_tpu_torch/parallel/tp.py``) on the CPU, held against ``fqss_tpu/parallel/tp.py``.

Gloo ranks (``tests/torch_tp_cases.py``, spawned once for the file as ``tests/test_torch_ddp.py`` spawns its ranks;
they import no JAX) shard ``tests/test_tp.py``'s tiny Sepformer over a grid of tp 2: two ranks (dp 1) run the
forwards, four (dp 2 x tp 2) a KD step and the MSE case's observers. The weights are the port's seeded init, carried
to JAX by ``sepformer_to_jax``. The rules, fixed before the first run:

* specs: the port's :func:`transformer_tp_specs` marks, leaf for leaf through the port's name and layout maps,
  what JAX's marks on a tp mesh of 2, for the tiny Sepformer, DPTNet and HTDemucs (JAX's trees by tracing its
  ``init``, no compile), and falls back to replicated where JAX does (a dimension that does not divide);
* the tp 2 float forward within ``atol=2e-5`` of JAX's ``shard_variables_tp`` forward on two of conftest's virtual
  CPU devices (``tests/test_tp.py:61``'s rule); the calibrated QAT forward (JAX's 55 observer steps) at an SNR
  above 25 dB against JAX's replicated one (``:70``); the tiny DPTNet's and HTDemucs's forwards, their attentions
  sharded, within the same ``atol`` of one process's;
* the dp 2 x tp 2 float KD step: loss and every parameter within ``atol=1e-4`` of JAX's single-device step
  (``:96``), and its gradient norm (each sharded parameter counted once) within 1e-5 of one process's, relative;
* the reductions: tests/torch_ddp_cases.py's Sepformer-MSE case on the dp 2 x tp 2 grid through its 3-step window,
  each observer's ranges, window and int64 counts after every forward bit for bit a one-process run's on the same
  global batch (from the grid's learned parameters before each step; the one-process run computes its two
  row-parallel products as the ranks do, the sum of the two column blocks' products in rank order, so that only
  the reductions can part them), and every rank's whole state after the steps bit for bit rank 0's; in the first
  step after the window, whose act grids quantize, every act quantizer's range gradient (the tp-sharded ones' the
  sum over tp of the shards' partials) within 1e-3 of one process's, leaf by leaf.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_ddp_cases as ddp_cases
import torch_tp_cases as cases
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
from fqss_tpu.models.sepformer import Sepformer as JaxSepformer
from fqss_tpu.parallel.tp import shard_variables_tp
from fqss_tpu.parallel.tp import transformer_tp_specs as jax_tp_specs
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.train import TrainConfig as JaxTrainConfig
from fqss_tpu.train import create_train_state, make_optimizer, make_train_step
from fqss_tpu_torch.models.convert import dptnet_from_jax, htdemucs_from_jax, sepformer_from_jax, sepformer_to_jax
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import tp
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_ATOL = 2e-5
QAT_SNR_DB = 25.0
STEP_ATOL = 1e-4
NORM_REL = 1e-5
LOSS_DB = 1e-5
# The act ranges' gradients after the window: float32 sums in another order alone (the forwards are bitwise), relative
# to the leaf, or to ACT_GRAD_FLOOR of the largest leaf where the leaf's own sum cancels below that.
ACT_GRAD_REL = 1e-3
ACT_GRAD_FLOOR = 1e-6
OBSERVE_STEPS = 55
HTD_TINY = cases.HTD_TINY


def _spawn(out, world: int) -> list[dict]:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in dp.ENV + ("LOCAL_RANK", "PYTHONPATH")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_tp_cases.py"), str(out)], cwd=REPO,
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-2000:]}\n{e[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _jax_tp_mesh(n: int = cases.TP) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(n), ("tp",))


def _float_state(seed: int) -> dict:
    return Sepformer(generator=torch.Generator().manual_seed(seed), **cases.KW).state_dict()


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """The tp 2 ranks' forwards of the float and the calibrated QAT model, and JAX's references."""
    out = tmp_path_factory.mktemp("tp2")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 2000)).astype(np.float32)
    float_vars = sepformer_to_jax(_float_state(0))
    jm = JaxSepformer(q=JaxQuantSpec(), **cases.KW)
    jax_float = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(shard_variables_tp(float_vars, _jax_tp_mesh()),
                                                               jnp.asarray(x)))
    qat = Sepformer(q=QuantSpec(**cases.QAT), generator=torch.Generator().manual_seed(0), **cases.KW)
    jq_obs = JaxSepformer(q=JaxQuantSpec(**cases.QAT), **cases.KW)
    calibrated = run_observer(jq_obs, sepformer_to_jax(qat.state_dict()), jnp.asarray(x), steps=OBSERVE_STEPS)
    jq = JaxSepformer(q=JaxQuantSpec(**{**cases.QAT, "observer": False}), **cases.KW)
    jax_qat = np.asarray(jax.jit(lambda v, x: jq.apply(v, x))(calibrated, jnp.asarray(x)))
    attention_inputs = {name: torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32))
                        for name, (_, _, shape) in cases.ATTENTION_MODELS.items()}
    torch.save({"float": sepformer_from_jax(float_vars), "qat": sepformer_from_jax(calibrated),
                "x": torch.from_numpy(x), **attention_inputs}, out / "inputs.pt")
    return {"ranks": _spawn(out, cases.TP), "jax_float": jax_float, "jax_qat": jax_qat,
            "float_state": sepformer_from_jax(float_vars), "attention_inputs": attention_inputs}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The dp 2 x tp 2 ranks' KD step and MSE case, with the step's inputs and JAX's single-device step."""
    out = tmp_path_factory.mktemp("dp2tp2")
    rng = np.random.default_rng(0)
    mix = rng.uniform(-1, 1, (4, 2000)).astype(np.float32)
    src = rng.uniform(-1, 1, (4, 2, 2000)).astype(np.float32)
    student, teacher = sepformer_to_jax(_float_state(1)), sepformer_to_jax(_float_state(2))
    cfg = JaxTrainConfig(kd_lambda=cases.STEP_CFG.kd_lambda, lr=cases.STEP_CFG.lr)
    tx = make_optimizer(cfg)
    jm = JaxSepformer(**cases.KW)
    state = create_train_state(student, tx, teacher_params=teacher["params"])
    s_ref, m_ref = make_train_step(jm, jm, tx, cfg, donate=False)(state, jnp.asarray(mix), jnp.asarray(src))
    inputs = {"student": sepformer_from_jax(student), "teacher": sepformer_from_jax(teacher),
              "mix": torch.from_numpy(mix), "src": torch.from_numpy(src)}
    torch.save(inputs, out / "inputs.pt")
    jax_params = sepformer_from_jax({"params": jax.device_get(s_ref.params)})
    return {"ranks": _spawn(out, 4), "inputs": inputs, "jax_loss": float(m_ref["loss"]), "jax_params": jax_params}


# ---------------------------------------------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------------------------------------------


def _port_specs_on_jax_leaves(port: torch.nn.Module, shapes, from_jax, n: int) -> dict:
    """The port's specs at ``n`` ranks as PartitionSpecs on JAX's leaves (by path): ``from_jax`` run on a tree of
    element indices gives each port tensor's place in JAX's leaves, and so the JAX axis that a port dim runs along."""
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    sizes = np.cumsum([0] + [leaf.size for _, leaf in flat])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, (_, leaf) in zip(sizes[:-1], sizes[1:], flat)])
    places = from_jax(index)
    specs = tp.transformer_tp_specs(port, n)
    assert places.keys() == specs.keys()
    out = {}
    for key, place in places.items():
        first = int(place.reshape(-1)[0])
        i = int(np.searchsorted(sizes, first, side="right") - 1)
        path, leaf = flat[i]
        d = specs[key]
        if d is None:
            out[jax.tree_util.keystr(path)] = P()
            continue
        step = int(place.select(d, 1).reshape(-1)[0])  # the element one step along the port's dim d
        a0, a1 = np.unravel_index(first - sizes[i], leaf.shape), np.unravel_index(step - sizes[i], leaf.shape)
        axes = [ax for ax in range(len(leaf.shape)) if a0[ax] != a1[ax]]
        assert len(axes) == 1, (key, axes)
        out[jax.tree_util.keystr(path)] = P(*["tp" if ax == axes[0] else None for ax in range(len(leaf.shape))])
    assert len(out) == len(flat)
    return out


def _jax_specs(shapes, n: int) -> dict:
    shardings = jax_tp_specs(shapes, mesh=_jax_tp_mesh(n))
    return {jax.tree_util.keystr(path): s.spec for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}


SPEC_MODELS = {
    "Sepformer": lambda q: (Sepformer(q=q, **cases.KW), JaxSepformer(q=JaxQuantSpec(**q.__dict__), **cases.KW),
                            sepformer_from_jax, {}),
    "DPTNet": lambda q: (DPTNet(q=q, **ddp_cases.DPTNET), JaxDPTNet(q=JaxQuantSpec(**q.__dict__), **ddp_cases.DPTNET),
                         dptnet_from_jax, {}),
    "HTDemucs": lambda q: (HTDemucs(q=q, **HTD_TINY), JaxHTDemucs(q=JaxQuantSpec(**q.__dict__), **HTD_TINY),
                           htdemucs_from_jax, {"train": True}),
}


@pytest.mark.parametrize("name", list(SPEC_MODELS))
def test_specs_mark_what_jaxs_mark_leaf_for_leaf(name):
    q = QuantSpec(qat=True, observer=True, n_splitter=2, n_combiner=2, out_quant=True)
    port, jm, from_jax, kw = SPEC_MODELS[name](q)
    channels = 2 if name == "HTDemucs" else None
    x = jnp.zeros((1, channels, 4000) if channels else (1, 2000), jnp.float32)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, **kw), x)
    want = _jax_specs(shapes, cases.TP)
    got = _port_specs_on_jax_leaves(port, shapes, from_jax, cases.TP)
    assert got == want
    assert any(s != P() for s in want.values())  # the model has tp-sharded leaves at all


@pytest.mark.parametrize("n", [3, 4])
def test_specs_fall_back_to_replicated_where_jaxs_do(n):
    """JAX's case (``tests/test_tp.py:50``): an in-projection kernel of 9 output columns, sharded at 3, replicated at
    4; the port's ``[9, 10]`` weight alike."""
    tree = {"params": {"mha": {"in_proj_kernel": jnp.zeros((10, 9))}}}
    want = jax_tp_specs(tree, mesh=_jax_tp_mesh(n))["params"]["mha"]["in_proj_kernel"].spec
    port = torch.nn.Module()
    port.mha = torch.nn.Module()
    port.mha.in_proj_weight = torch.nn.Parameter(torch.zeros(9, 10))
    got = tp.transformer_tp_specs(port, n)["mha.in_proj_weight"]
    assert want == (P(None, "tp") if n == 3 else P())
    assert got == (0 if n == 3 else None)


# ---------------------------------------------------------------------------------------------------------------
# Forwards, the step, the reductions
# ---------------------------------------------------------------------------------------------------------------


def test_tp2_float_forward_meets_jaxs_sharded_forward(forwards):
    for r in forwards["ranks"]:
        np.testing.assert_allclose(r["float"].numpy(), forwards["jax_float"], atol=FLOAT_ATOL)


def test_tp2_calibrated_qat_forward_meets_jaxs_replicated_forward(forwards):
    ref = forwards["jax_qat"]
    for r in forwards["ranks"]:
        y = r["qat"].numpy()
        snr = 10 * np.log10(np.sum(ref**2) / (np.sum((y - ref) ** 2) + 1e-20))
        assert snr > QAT_SNR_DB, f"tp 2 QAT forward against JAX's replicated one: {snr:.1f} dB"


@pytest.mark.parametrize("name", list(cases.ATTENTION_MODELS))
def test_tp2_attention_of_dptnet_and_htdemucs_meets_one_process(forwards, name):
    """DPTNet's and HTDemucs's attentions (self and cross) sharded by heads: the tp 2 float forward within
    ``FLOAT_ATOL`` of one process's on the whole weights."""
    want = cases.forward(cases.attention_model(name), forwards["attention_inputs"][name], None)
    for r in forwards["ranks"]:
        assert r[name].shape == want.shape
        np.testing.assert_allclose(r[name].numpy(), want.numpy(), atol=FLOAT_ATOL)


def test_shards_gather_back_to_the_whole_weights(forwards):
    for r in forwards["ranks"]:
        assert r["float_whole"].keys() == forwards["float_state"].keys()
        assert all(torch.equal(r["float_whole"][k], v) for k, v in forwards["float_state"].items())


def test_dp2_tp2_step_meets_jaxs_single_device_step(grid):
    got = grid["ranks"][0]["step"]
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], grid["jax_loss"], atol=STEP_ATOL)
    assert got["params"].keys() == grid["jax_params"].keys()
    for k, v in grid["jax_params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=STEP_ATOL, err_msg=k)


def test_dp2_tp2_gradient_norm_counts_each_parameter_once(grid):
    inputs = grid["inputs"]
    one = cases.kd_step(cases.sepformer(inputs["student"]), cases.sepformer(inputs["teacher"]), inputs["mix"],
                        inputs["src"], None)
    for r in grid["ranks"]:
        assert abs(r["step"]["grad_norm"] - one["grad_norm"]) <= NORM_REL * one["grad_norm"]


def test_dp2_tp2_observers_and_counts_equal_one_process_bit_for_bit(grid):
    got = grid["ranks"][0]["mse"]
    want = cases.mse_run(None, got["before"])
    assert len(got["observed"]) == len(want["observed"]) == cases.MSE_STEPS
    for i, (g, w) in enumerate(zip(got["observed"], want["observed"])):
        assert g.keys() == w.keys()
        bad = [k for k in w if not torch.equal(g[k], w[k])]
        assert not bad, f"step {i + 1}: {bad[:6]}"
    assert any(k.endswith(".hist") for k in got["observed"][0])  # the MSE histograms and their int64 counts
    assert max(abs(a - b) for a, b in zip(got["loss"], want["loss"])) <= LOSS_DB


def test_dp2_tp2_act_range_gradients_after_the_window_equal_one_process(grid):
    """The first step after the window, whose act grids quantize: each act quantizer's range gradient (the tp-sharded
    grids' summed over tp from K1-bwd's and K5-bwd's partials, then over dp) within ACT_GRAD_REL of one process's on
    the same global batch, leaf by leaf (a sum over tp missing or doubled moves a leaf by half or all of itself)."""
    got = grid["ranks"][0]["mse"]["act_grads"]
    want = cases.mse_run(None, grid["ranks"][0]["mse"]["before"])["act_grads"]
    assert got.keys() == want.keys()
    largest = max(float(w.abs().max()) for w in want.values())
    bad = [k for k, w in want.items()
           if not bool(((got[k] - w).abs() <= ACT_GRAD_REL * torch.clamp(w.abs(), min=ACT_GRAD_FLOOR * largest)).all())]
    assert not bad, [(k, got[k].tolist(), want[k].tolist()) for k in bad[:4]]
    sharded = grid["ranks"][0]["mse"]["tp_sharded"]
    assert sharded and all(float(want[k].abs().max()) > 0 for k in sharded)


def test_dp2_tp2_ranks_hold_the_same_whole_state(grid):
    ranks = grid["ranks"]
    assert [r["tp"] for r in ranks] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    assert [r["dp"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    for r in ranks[1:]:
        for name in ("mse",):
            assert all(torch.equal(r[name]["state"][k], v) for k, v in ranks[0][name]["state"].items())
        assert all(torch.equal(r["step"]["params"][k], v) for k, v in ranks[0]["step"]["params"].items())
