"""Pipeline parallelism (``fqss_tpu_torch/parallel/pp.py``) on the CPU, held against ``fqss_tpu/parallel/pp.py``.

Four gloo ranks (``tests/torch_pp_cases.py``, spawned once for the file; they import no JAX) are the stages of
``tests/test_pp.py``'s ``TransformerLayer(16, 32, 4)`` stacks, whose weights come from JAX's init through
``sepformer_from_jax``. The rules, fixed before the first run:

* ``layer_stack_vars`` stacks the layers in numeric order, slice i JAX's layer i;
* the float forward within 1e-5 absolute and relative of JAX's ``pipeline_layer_module`` on 4 virtual devices, at
  M = 2 and M = 4 and at 2 layers a stage (``tests/test_pp.py:64``, ``:74``), on every rank;
* the QAT stack with ``observer=False`` within 1e-2 of max|y| of JAX's (``:84``);
* the float gradient of ``sum(y^2)`` within 2e-4 absolute and 1e-4 relative of the sequential stack's, JAX's and the
  port's (``:97``): a cotangent summed over the stages would give it 4 times over;
* the two ``ValueError``s with JAX's messages (``:119``);
* a QAT stack with its observers' window open, in ``train()`` mode, leaves every range, counter and flag bit for bit
  as it was after the pipelined forward and backward (JAX applies a stage without mutable collections).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import torch_ddp_cases as ddp_cases
import torch_pp_cases as cases
from fqss_tpu.models.sepformer import TransformerLayer as JaxTransformerLayer
from fqss_tpu.parallel.pp import layer_stack_vars as jax_layer_stack_vars
from fqss_tpu.parallel.pp import pipeline_layer_module as jax_pipeline_layer_module
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import sepformer_from_jax
from fqss_tpu_torch.parallel import pp
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

FWD_TOL = 1e-5
QAT_OF_MAX = 1e-2
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-4


def _jax_stack(q, n: int, x):
    """JAX's layer and ``n`` layers' variables (tests/test_pp.py:_stack), as a parent's ``layer_i`` children."""
    layer = JaxTransformerLayer(cases.F, cases.FFN, cases.HEADS, q=q)
    init = jax.jit(layer.init)
    per_layer = [jax.device_get(init(jax.random.PRNGKey(10 + i), x)) for i in range(n)]
    variables = {col: {f"layer_{i}": dict(per_layer[i][col]) for i in range(n)} for col in per_layer[0]}
    return layer, variables, per_layer


def _jax_pipeline(layer, variables, x, m):
    mesh = JaxMesh(np.asarray(jax.devices()[:cases.STAGES]), ("pp",))
    return np.asarray(jax_pipeline_layer_module(layer, jax_layer_stack_vars(variables), x, mesh, n_microbatches=m))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp4")
    x = jax.random.normal(jax.random.PRNGKey(0), (cases.BATCH, cases.L, cases.F))
    layer, variables8, per8 = _jax_stack(JaxQuantSpec(), 8, x)
    variables4 = {col: {k: v for k, v in tree.items() if int(k[len("layer_"):]) < 4}
                  for col, tree in variables8.items()}
    qlayer, qvariables, qper = _jax_stack(JaxQuantSpec(**cases.QAT), 4, x)

    def loss_seq(stacked):
        h = x
        for i in range(4):
            h = layer.apply(jax.tree_util.tree_map(lambda a, i=i: a[i], stacked), h)
        return jnp.sum(h**2)

    g = jax.device_get(jax.jit(jax.grad(loss_seq))(jax_layer_stack_vars(variables4)))
    jax_grads = {f"{i}.{k}": v for i in range(4)
                 for k, v in sepformer_from_jax(jax.tree_util.tree_map(lambda a, i=i: a[i], g)).items()}
    inputs = {"x": torch.from_numpy(np.array(x)), "float4": [sepformer_from_jax(v) for v in per8[:4]],
              "float8": [sepformer_from_jax(v) for v in per8], "qat4": [sepformer_from_jax(v) for v in qper]}
    torch.save(inputs, out / "inputs.pt")
    jax_out = {"float_m2": _jax_pipeline(layer, variables4, x, 2), "float_m4": _jax_pipeline(layer, variables4, x, 4),
               "float_8_layers": _jax_pipeline(layer, variables8, x, None),
               "qat": _jax_pipeline(qlayer, qvariables, x, None)}
    return {"ranks": ddp_cases.spawn_ranks("torch_pp_cases.py", out, cases.STAGES), "inputs": inputs, "jax": jax_out,
            "jax_grads": jax_grads, "variables4": variables4}


def test_layer_stack_vars_stacks_jaxs_layers_in_order(run):
    parent = torch.nn.Module()
    for i, state in enumerate(run["inputs"]["float4"]):
        parent.add_module(f"layer_{i}", cases.layers([state])[0])
    got = pp.layer_stack_vars(parent)
    want = jax_layer_stack_vars(run["variables4"])
    for i in range(4):
        one = sepformer_from_jax(jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), want))
        assert set(one) <= set(got)
        assert all(torch.equal(got[k][i], v) for k, v in one.items())
    assert all(t.shape[0] == 4 for t in got.values())


def test_layer_stack_vars_takes_numeric_order_and_a_path():
    parent = torch.nn.Module()
    parent.block = torch.nn.Module()
    for i in range(12):
        parent.block.add_module(f"layer_{i}", torch.nn.Linear(2, 2))
        torch.nn.init.constant_(parent.block.get_submodule(f"layer_{i}").bias, float(i))
    stacked = pp.layer_stack_vars(parent, "block")
    assert stacked["bias"][:, 0].tolist() == [float(i) for i in range(12)]  # layer_10 after layer_9
    assert pp.layer_stack_vars(parent, "block", n_layers=3)["weight"].shape == (3, 2, 2)
    assert pp.layer_stack_vars(parent, "nowhere") == {}


@pytest.mark.parametrize("name", ["float_m2", "float_m4", "float_8_layers"])
def test_pipeline_float_forward_meets_jaxs_pipeline(run, name):
    for r in run["ranks"]:
        n_local, y = r[name]
        assert n_local == (2 if name == "float_8_layers" else 1)  # a stage holds its layers alone
        np.testing.assert_allclose(y.numpy(), run["jax"][name], atol=FWD_TOL, rtol=FWD_TOL)


def test_pipeline_float_forward_equals_the_port_sequential_stack(run):
    """Not JAX's rule: the same device's sequential stack, within the same tolerance (the CPU's products need not
    be bitwise at another row count)."""
    want = cases.sequential(cases.layers(run["inputs"]["float4"]), run["inputs"]["x"]).detach()
    for r in run["ranks"]:
        np.testing.assert_allclose(r["float_m2"][1].numpy(), want.numpy(), atol=FWD_TOL, rtol=FWD_TOL)


def test_pipeline_quantized_stack_meets_jaxs_pipeline(run):
    want = run["jax"]["qat"]
    for r in run["ranks"]:
        assert np.abs(r["qat"][1].numpy() - want).max() <= QAT_OF_MAX * np.abs(want).max() + 1e-6


def test_pipeline_gradient_matches_the_sequential_stacks(run):
    got = {}
    for r in run["ranks"]:
        got.update(r["grads"])
    stack = cases.layers(run["inputs"]["float4"])
    cases.sequential(stack, run["inputs"]["x"]).square().sum().backward()
    port = {f"{i}.{k}": p.grad for i, layer in enumerate(stack) for k, p in layer.named_parameters()}
    assert got.keys() == port.keys() and set(run["jax_grads"]) <= set(got)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), port[k].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
        if k in run["jax_grads"]:
            np.testing.assert_allclose(g.numpy(), np.asarray(run["jax_grads"][k]), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=k)


def test_pipeline_validates_divisibility():
    mesh = pp.PipelineMesh(0, 4)  # the checks come before any collective
    x = torch.zeros(cases.BATCH, cases.L, cases.F)
    with pytest.raises(ValueError, match="pipeline stages"):
        pp.pipeline_layer_module(cases.layers(None, n=3), x, mesh)
    with pytest.raises(ValueError, match="n_microbatches"):
        pp.pipeline_layer_module(cases.layers(None), x, mesh, n_microbatches=3)


def test_pipeline_with_observers_in_their_window_writes_no_state(run):
    for r in run["ranks"]:
        window = r["window"]
        assert any(k.endswith("n_iter") for k in window["keys"]) and any(k.endswith("observed") for k in window["keys"])
        assert window["changed"] == []
