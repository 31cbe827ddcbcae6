"""FSDP (``fqss_tpu_torch/parallel/fsdp.py``) on the CPU, held against ``fqss_tpu/parallel/fsdp.py``.

Gloo ranks (``tests/torch_fsdp_cases.py``, spawned once a world size for the file; they import no JAX): two run
``tests/test_fsdp.py``'s float KD step with the state sharded, and the tiny QAT ConvTasNet's steps through its observer
window sharded and data-parallel on the same ranks; four, a dp 2 x tp 2 grid, the tiny Sepformer with tensor and FSDP
shards. The rules, fixed before the first run:

* ``fsdp_sharding`` gives JAX's answer on the five cases of ``tests/test_fsdp.py:25-37``;
* on ``tests/test_fsdp.py``'s ConvTasNet (float and QAT) at 2 and 4 ranks the port shards exactly the parameters whose
  JAX leaves JAX shards (names and axes through ``convtasnet_from_jax``), each along an axis of the extent JAX's takes;
* the float step on 2 ranks meets JAX's single-device step: loss within 1e-4, every parameter within 1e-4 absolute
  (``tests/test_fsdp.py:62``'s tolerances); at least one parameter and its Adam moments are slices;
* the QAT steps with observers on, inside the window, against the data-parallel step on the same ranks and batches
  (each sharded step from the data-parallel run's learned parameters before it): the observers' ranges and counters,
  the loss and the reduced gradients before the clip bit for bit, the gradient's global norm within 1e-6 relative, the
  whole state after each step bit for bit where the clip does not bind, else within 1e-6 of each tensor's largest
  magnitude;
* between steps a rank holds exactly the replicated elements plus 1/W of each sharded one (the student's parameters,
  the teacher's, Adam's two moments), plus the named persistent gather buffers of the weights that the weight
  quantizers read;
* tp + fsdp on the dp 2 x tp 2 grid at ``min_size=2**8`` (``tests/test_fsdp.py:103``): the tp shards stay tp shards,
  at least one other parameter is dp-sharded, and the forward is within 2e-5 of one process's; a KD step there keeps
  the tp-only step's loss bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_ddp_cases as ddp_cases
import torch_fsdp_cases as cases
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.parallel.fsdp import fsdp_sharding as jax_fsdp_sharding
from fqss_tpu.parallel.mesh import make_mesh
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.train import TrainConfig as JaxTrainConfig
from fqss_tpu.train import create_train_state, make_optimizer, make_train_step
from fqss_tpu_torch.models.convert import convtasnet_from_jax, convtasnet_to_jax
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.parallel import fsdp, shards
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer, weight_quantizer_sites
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

STEP_ATOL = 1e-4
NORM_REL = 1e-6
STATE_REL = 1e-6
COMPOSE_ATOL = 2e-5
QAT_Q = dict(qat=True, observer=True, n_splitter=2, n_combiner=2)  # tests/test_fsdp.py:91's spec, observers on


def _float_state(seed: int) -> dict:
    return ConvTasNet(generator=torch.Generator().manual_seed(seed), **cases.KW).state_dict()


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Two ranks: the float step (with JAX's single-device step on the same weights and batch) and the QAT runs."""
    out = tmp_path_factory.mktemp("fsdp2")
    rng = np.random.default_rng(0)
    mix = rng.uniform(-1, 1, (8, 4000)).astype(np.float32)
    src = rng.uniform(-1, 1, (8, 2, 4000)).astype(np.float32)
    student, teacher = convtasnet_to_jax(_float_state(0)), convtasnet_to_jax(_float_state(1))
    cfg = JaxTrainConfig(kd_lambda=cases.STEP_CFG.kd_lambda, lr=cases.STEP_CFG.lr)
    tx = make_optimizer(cfg)
    jm = JaxConvTasNet(**cases.KW)
    state = create_train_state(student, tx, teacher_params=teacher["params"])
    s_ref, m_ref = make_train_step(jm, jm, tx, cfg, donate=False)(state, jnp.asarray(mix), jnp.asarray(src))
    torch.save({"student": convtasnet_from_jax(student), "teacher": convtasnet_from_jax(teacher),
                "mix": torch.from_numpy(mix), "src": torch.from_numpy(src)}, out / "inputs.pt")
    return {"ranks": ddp_cases.spawn_ranks("torch_fsdp_cases.py", out, 2), "jax_loss": float(m_ref["loss"]),
            "jax_params": convtasnet_from_jax({"params": jax.device_get(s_ref.params)})}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Four ranks, a dp 2 x tp 2 grid: the tiny Sepformer's forward with tensor and FSDP shards."""
    out = tmp_path_factory.mktemp("fsdp4")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 2000)).astype(np.float32))
    mix = torch.from_numpy(rng.uniform(-1, 1, (4, 2000)).astype(np.float32))
    src = torch.from_numpy(rng.uniform(-1, 1, (4, 2, 2000)).astype(np.float32))
    torch.save({"x": x, "mix": mix, "src": src}, out / "inputs.pt")
    return {"ranks": ddp_cases.spawn_ranks("torch_fsdp_cases.py", out, 4), "x": x}


# ---------------------------------------------------------------------------------------------------------------
# The rule and the placements
# ---------------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 512), (513, 64), (4, 4), (), (9, 2**13 + 1)])
def test_fsdp_sharding_gives_jaxs_answer(shape):
    """tests/test_fsdp.py:25-37's five cases on an 8-rank mesh."""
    spec = jax_fsdp_sharding(jnp.zeros(shape), make_mesh(8)).spec
    want = next((d for d, s in enumerate(spec) if s == "dp"), None) if spec != P() else None
    assert fsdp.fsdp_sharding(shape, 8) == want
    assert want == {(64, 512): 1, (513, 64): 1}.get(shape)


def _placements(port: torch.nn.Module, shapes) -> dict:
    """Each port parameter's JAX leaf (path) and, per port dim, the JAX axis it runs along: ``convtasnet_from_jax`` of
    a tree of element indices gives each port tensor's place in JAX's leaves."""
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    sizes = np.cumsum([0] + [leaf.size for _, leaf in flat])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, (_, leaf) in zip(sizes[:-1], sizes[1:], flat)])
    places = convtasnet_from_jax(index)
    out = {}
    for key, _ in port.named_parameters():
        place = np.asarray(places[key])
        first = int(place.reshape(-1)[0])
        i = int(np.searchsorted(sizes, first, side="right") - 1)
        path, leaf = flat[i]
        a0 = np.unravel_index(first - sizes[i], leaf.shape)
        axes = {}
        for d in range(place.ndim):
            if place.shape[d] > 1:
                a1 = np.unravel_index(int(place.take(1, axis=d).reshape(-1)[0]) - sizes[i], leaf.shape)
                axes[d] = next(ax for ax in range(len(leaf.shape)) if a0[ax] != a1[ax])
        out[key] = (path, leaf, axes)
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("qat", [False, True])
def test_port_shards_what_jax_shards(n, qat):
    q = QuantSpec(**QAT_Q) if qat else QuantSpec()
    jm = JaxConvTasNet(q=JaxQuantSpec(**q.__dict__), **cases.KW)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.zeros((1, 4000), jnp.float32))
    shapes = {k: v for k, v in shapes.items() if k in ("params", "qparams")}  # what JAX's TrainState trains
    port = ConvTasNet(q=q, **cases.KW)
    places = _placements(port, shapes)
    fsdp.shard_state_fsdp(port, dp.Mesh(0, n, torch.device("cpu"), "gloo"))  # no collective: the placement alone
    mesh = make_mesh(n)
    saw = 0
    for key, p in port.named_parameters():
        path, leaf, axes = places[key]
        spec = jax_fsdp_sharding(leaf, mesh).spec
        jax_axis = next((a for a, s in enumerate(spec) if s == "dp"), None) if spec != P() else None
        port_dim = p.placement.dim if shards.is_part(p, shards.DP) else None
        assert (jax_axis is None) == (port_dim is None), (key, jax.tree_util.keystr(path), spec, port_dim)
        if port_dim is not None:
            saw += 1
            assert p.shape[port_dim] * n == leaf.shape[jax_axis], (key, port_dim, jax_axis)
    assert saw  # the mask conv at least


# ---------------------------------------------------------------------------------------------------------------
# The steps on two ranks
# ---------------------------------------------------------------------------------------------------------------


def test_float_step_meets_jaxs_single_device_step(two):
    for r in two["ranks"]:
        got = r["float"]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], two["jax_loss"], atol=STEP_ATOL)
        assert got["params"].keys() == two["jax_params"].keys()
        for k, v in two["jax_params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=STEP_ATOL, err_msg=k)


def test_float_step_shards_parameters_teacher_and_moments(two):
    got = two["ranks"][0]["float"]
    assert got["sharded"] and got["teacher_sharded"] == sorted(got["sharded"])
    assert got["sliced_moments"] and all(m == p for m, p in got["sliced_moments"])


def test_qat_steps_observers_loss_and_gradients_equal_the_data_parallel_steps(two):
    for r in two["ranks"]:
        ddp, sharded = r["ddp"], r["fsdp"]
        assert sharded["sharded"], "nothing sharded at QAT_MIN_SIZE"
        assert len(sharded["observed"]) == len(ddp["observed"]) == ddp_cases.STEPS
        for i in range(ddp_cases.STEPS):
            g, w = sharded["observed"][i], ddp["observed"][i]
            assert g.keys() == w.keys() and [k for k in w if not torch.equal(g[k], w[k])] == [], f"step {i + 1}"
            assert sharded["loss"][i] == ddp["loss"][i], f"step {i + 1}"
            assert sharded["grads"][i].keys() == ddp["grads"][i].keys()
            bad = [k for k, v in ddp["grads"][i].items() if not torch.equal(sharded["grads"][i][k], v)]
            assert not bad, f"step {i + 1}: {bad[:5]}"


def test_qat_steps_norm_and_state_after_each_step(two):
    for r in two["ranks"]:
        ddp, sharded = r["ddp"], r["fsdp"]
        for i in range(ddp_cases.STEPS):
            norm = ddp["grad_norm"][i]
            assert abs(sharded["grad_norm"][i] - norm) <= NORM_REL * norm, f"step {i + 1}"
            binds = not norm < cases.TrainConfig().grad_clip
            for k, w in ddp["after"][i].items():
                g = sharded["after"][i][k]
                if binds and w.is_floating_point():
                    assert float((g - w).abs().max()) <= STATE_REL * float(w.abs().max()), (i, k)
                else:
                    assert torch.equal(g, w), (i, k)


def test_a_rank_holds_its_slices_and_the_named_buffers(two):
    whole = ddp_cases.new_state(cases.QAT_CASE)
    names = {id(m): n for n, m in whole.model.named_modules()}
    quantizer_params = {f"{n}.{k}" for n, m in whole.model.named_modules()
                        if isinstance(m, (ActQuantizer, WeightQuantizer)) for k, _ in m.named_parameters()}
    rule = {k for k, p in whole.model.named_parameters()
            if k not in quantizer_params and fsdp.fsdp_sharding(p.shape, 2, cases.QAT_MIN_SIZE) is not None}
    quantized = {f"{names[id(layer)]}.{wname}" for layer, _, wname in weight_quantizer_sites(whole.model)}
    params = dict(whole.model.named_parameters())

    def held(named, sharded):
        return sum(p.numel() // 2 if k in sharded else p.numel() for k, p in named)

    for r in two["ranks"]:
        got = r["fsdp"]
        assert set(got["sharded"]) == rule
        assert got["held"]["params"] == held(params.items(), rule)
        assert got["held"]["teacher"] == held(((k, p) for k, p in whole.teacher.named_parameters()),
                                              {k for k, p in whole.teacher.named_parameters()
                                               if fsdp.fsdp_sharding(p.shape, 2, cases.QAT_MIN_SIZE) is not None})
        stepped = r["ddp"]["grads"][-1]  # Adam keeps moments of the parameters that had a gradient
        assert got["held"]["moments"] == 2 * held(((k, p) for k, p in params.items() if k in stepped), rule)
        assert set(got["buffers"]) == rule & quantized  # the whole weights that the weight quantizers read
        assert got["held"]["buffers"] == sum(params[k].numel() for k in got["buffers"])


def test_whole_state_round_trips_through_the_slices(two):
    rt = two["ranks"][1]["round_trip"]
    want = ddp_cases.new_state(cases.QAT_CASE).model.state_dict()
    assert rt["first"].keys() == want.keys()
    assert all(torch.equal(rt["first"][k], v) for k, v in want.items())
    assert all(torch.equal(rt["loaded"][k], v) for k, v in rt["other"].items())


# ---------------------------------------------------------------------------------------------------------------
# tp + fsdp on four ranks
# ---------------------------------------------------------------------------------------------------------------


def test_tp_shards_stay_tp_shards_under_fsdp(grid):
    for r in grid["ranks"]:
        got = r["compose"]
        assert "masker.dp_0.intra_transformer_block.layer_0.mha.in_proj_weight" in got["tp"]
        assert not got["both"]


def test_fsdp_shards_other_parameters_on_the_grid(grid):
    for r in grid["ranks"]:
        assert r["compose"]["dp"]


def test_tp_fsdp_step_meets_the_tp_step(grid):
    """make_train_step on the grid with FSDP slices beside the tp shards: the loss bit for bit the tp-only step's, the
    clipped gradients and the parameters after it within 1e-6 of each tensor's largest magnitude (the clip's norm is
    summed over the slices in float64)."""
    for r in grid["ranks"]:
        tp_only, both = r["grid_steps"]
        assert both["loss"] == tp_only["loss"]
        for name in ("grads", "params"):
            assert both[name].keys() == tp_only[name].keys()
            for k, w in tp_only[name].items():
                assert float((both[name][k] - w).abs().max()) <= STATE_REL * float(w.abs().max()), (name, k)


def test_tp_fsdp_forward_meets_one_process(grid):
    model = cases.sepformer().eval()
    with torch.no_grad():
        want = model(grid["x"])
    for r in grid["ranks"]:
        np.testing.assert_allclose(r["compose"]["y"].numpy(), want.numpy(), atol=COMPOSE_ATOL)
