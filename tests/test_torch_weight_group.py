"""The grouped weight quantizers (``ops/fake_quant.py:weight_fake_quant_group``) and the models' weight pass.

* The grouped call's plain version against the JAX package's
  ``WeightQuantizer`` modules, one each, applied with mutable collections
  under ``jax.grad``: through the Pallas path in interpret mode (as
  ``tests/test_pallas_qat.py`` runs it) and through its
  ``linear_fake_quant`` reference. Mixed channel axes, 2-D and 3-D weights,
  the observing call, the call after it, then planted half-step ties and
  ``|mn| == |mx|`` ranges: outputs and written ranges bitwise equal, ``dw``
  and range gradients as ``RANGE_TOL`` says.
* Tiny ConvTasNet, DPTNet and Sepformer models: the forward bitwise equal to
  the model folded through the per-tensor route, and KD steps (the observing
  one and one after it) whose gradients and updates equal bit for bit those
  of the per-tensor route (the pass closed), which
  ``tests/test_torch_train.py`` and ``tests/test_torch_train_models.py`` hold
  to JAX; one grouped call per forward and one per backward, no per-tensor
  weight call and no weight grid in K5's plain version.
* A quantizer reached twice in one forward, against flax's module called
  twice in one apply.
* The kernel table's layout (``csrc/fake_quant.cu:GroupEntry``), its work
  split, and the backward's strided view of a transposed gradient.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from fqss_tpu_torch.models import convtasnet as ctn_mod
from fqss_tpu_torch.models import dptnet as dpt_mod
from fqss_tpu_torch.models import sepformer as sep_mod
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.quant.quantizers import WeightQuantizer, weight_pass, weight_quantizer_sites
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

torch.set_num_threads(1)

MUTABLE = ["qparams", "qstats"]
STEP = 2.0**-7
# Range gradients against the Pallas VJP (the same terms, summed in another order): within RANGE_TOL of the sum of
# their magnitudes (read <= 1.9e-7). jax.grad of the XLA reference differentiates delta * clip(round(w / delta))
# term by term, another formula: tests/test_torch_grads.py's absolute bound (read <= 2.9e-6).
RANGE_TOL, XLA_RANGE_ATOL = 1e-6, 5e-5
# (shape, channel axis, scale_grad): conv [Cout, Cin, k], transposed conv [Cin, Cout, k], dense [out, in], LSTM
# [C, 4H], a channel axis last on a 3-D weight
CASES = (((24, 5, 3), 0, False), ((7, 40, 3), 1, True), ((40, 65), 0, False), ((65, 40), 1, False),
         ((6, 9, 11), 2, False))
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)
MODELS = {
    "convtasnet": (ctn_mod, ctn_mod.ConvTasNet,
                   dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2,
                        n_repeats=1)),
    "dptnet": (dpt_mod, dpt_mod.DPTNet,
               dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)),
    "sepformer": (sep_mod, sep_mod.Sepformer,
                  dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20,
                       n_ffn=48, n_layers=1)),
}


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _weight(rng, shape, ch_axis):
    """Random weights whose channel 0 holds half-step ties of the planted range (step STEP) and both clip ends."""
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    first = np.moveaxis(w, ch_axis, 0)[0]
    k = np.arange(first.size) % 262 - 131
    first[...] = ((k + 0.5) * STEP).reshape(first.shape)
    return w


def _planted_ranges(mn):
    """Steps of 2^-7 ... 2^-10 (max |range| = 255/256 / 2^k: the step is exact, divided or multiplied by the
    reciprocal of 255, and channel 0's ties are exact), |mn| == |mx| on every third channel, |mn| < |mx| or
    |mn| > |mx| on the others."""
    c = np.arange(mn.size)
    big = (255 / 256 / 2.0 ** (c % 4)).astype(np.float32)
    mn_c = np.where(c % 3 == 1, -big, np.where(c % 3 == 0, -big / 2, -big))
    mx_c = np.where(c % 3 == 2, big / 4, big)
    return mn_c.astype(np.float32).reshape(mn.shape), mx_c.astype(np.float32).reshape(mn.shape)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas-interpret", "xla-reference"])
def _terms_bound(w, g, mn, mx, ch_axis, s):
    """The range gradients' sums of |term| (float64), routed as the gradients are: their tolerance's scale."""
    dims = tuple(d for d in range(w.ndim) if d != ch_axis)
    _, terms = fq.weight_bwd_terms(*(torch.from_numpy(a) for a in (w, g, mn, mx)), 8, ch_axis)
    mn64, mx64 = torch.from_numpy(mn).double(), torch.from_numpy(mx).double()
    return [b.abs().numpy() for b in fq.route_range_grad(terms.double().abs().sum(dims), mn64, mx64, 8, s)]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas-interpret", "xla-reference"])
def test_grouped_plain_version_matches_jax_weight_quantizers(use_pallas, interpret_mode):
    """JAX runs eagerly (``jax.disable_jit``), except the Pallas kernel body, which interpret mode compiles: there
    the step is a product with the reciprocal of Q (ROADMAP.md, queue 3), so after the observing call the Pallas
    route quantizes with planted ranges whose steps are powers of two, exact either way. The Pallas VJP gives
    ``dw = g m`` as the port does, bit for bit; ``jax.grad`` of the XLA reference rounds ``g δ / δ`` and is held
    to 1e-6, as ``tests/test_torch_grads.py`` holds it."""
    with jax.disable_jit():
        _grouped_against_jax(use_pallas)


def _grouped_against_jax(use_pallas):
    from fqss_tpu.quant.quantizers import WeightQuantizer as JaxWeightQuantizer

    rng = np.random.default_rng(11)
    ws = [_weight(rng, shape, ax) for shape, ax, _ in CASES]
    jqs = [JaxWeightQuantizer(weight_shape=w.shape, ch_axis=ax, scale_grad=sg, use_pallas=use_pallas)
           for w, (_, ax, sg) in zip(ws, CASES)]
    variables = [jq.init({}, jnp.asarray(w)) for jq, w in zip(jqs, ws)]
    tqs = [WeightQuantizer(w.shape, ch_axis=ax, scale_grad=sg).train() for w, (_, ax, sg) in zip(ws, CASES)]
    wts = [torch.from_numpy(w).requires_grad_() for w in ws]
    for call in range(3):  # the observing call, one with the observed ranges (planted for Pallas), one planted
        if call == 2 or (use_pallas and call == 1):
            for i, (tq, v) in enumerate(zip(tqs, variables)):
                mn, mx = _planted_ranges(tq.min_range.detach().numpy())
                with torch.no_grad():
                    tq.min_range.copy_(torch.from_numpy(mn))
                    tq.max_range.copy_(torch.from_numpy(mx))
                variables[i] = {**v, "qparams": {"min_range": jnp.asarray(mn), "max_range": jnp.asarray(mx)}}
        gs = [rng.standard_normal(w.shape).astype(np.float32) for w in ws]
        used = [(tq.min_range.detach().numpy().copy(), tq.max_range.detach().numpy().copy()) for tq in tqs]
        for tq in tqs:
            tq.min_range.grad = tq.max_range.grad = None
        for wt in wts:
            wt.grad = None
        outs = fq.weight_fake_quant_group(fq.WeightGroup([tq.entry(wt) for tq, wt in zip(tqs, wts)]))
        sum((y * torch.from_numpy(g)).sum() for y, g in zip(outs, gs)).backward()
        for i, (jq, w, g, (_, ax, sg)) in enumerate(zip(jqs, ws, gs, CASES)):

            def loss(qparams, w, jq=jq, v=variables[i], g=g):
                y, upd = jq.apply({**v, "qparams": qparams}, w, mutable=MUTABLE)
                return jnp.vdot(g, y), (y, upd)

            (dq, dw), (y, upd) = jax.grad(loss, argnums=(0, 1), has_aux=True)(variables[i]["qparams"], jnp.asarray(w))
            variables[i] = {**variables[i], **upd}
            tq = tqs[i]
            np.testing.assert_array_equal(outs[i].detach().numpy(), np.asarray(y))
            np.testing.assert_array_equal(tq.min_range.detach().numpy(), np.asarray(upd["qparams"]["min_range"]))
            np.testing.assert_array_equal(tq.max_range.detach().numpy(), np.asarray(upd["qparams"]["max_range"]))
            assert bool(tq.observed) and bool(upd["qstats"]["observed"])
            if use_pallas:
                np.testing.assert_array_equal(wts[i].grad.numpy(), np.asarray(dw))
            else:
                np.testing.assert_allclose(wts[i].grad.numpy(), np.asarray(dw), rtol=0, atol=1e-6)
            bounds = _terms_bound(w, g, *used[i], ax, fq.weight_scale(w.shape[ax], 8, sg))
            for got, want, bound in zip((tq.min_range.grad, tq.max_range.grad), (dq["min_range"], dq["max_range"]),
                                        bounds):
                err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
                limit = RANGE_TOL * bound.reshape(err.shape) if use_pallas else XLA_RANGE_ATOL
                assert np.all(err <= limit), (call, i, err.max())
                assert bool(got.any()) == (call > 0)  # the observing call gives the ranges no gradient
            if call == 0:
                np.testing.assert_array_equal(outs[i].detach().numpy(), w)
    # the planted |mn| == |mx| channels split their gradient 0.5 / 0.5
    tq = tqs[2]
    assert torch.equal(tq.min_range.grad.view(-1)[1::3], -tq.max_range.grad.view(-1)[1::3])


def test_grouped_eval_observes_nothing_and_quantizes_after_the_observation():
    rng = np.random.default_rng(12)
    tqs = [WeightQuantizer(shape, ch_axis=ax) for shape, ax, _ in CASES]
    ws = [torch.from_numpy(_weight(rng, shape, ax)) for shape, ax, _ in CASES]
    state = [{k: v.clone() for k, v in tq.state_dict().items()} for tq in tqs]
    with torch.no_grad():
        outs = fq.weight_fake_quant_group(fq.WeightGroup([tq.eval().entry(w) for tq, w in zip(tqs, ws)]))
    for tq, w, y, sd in zip(tqs, ws, outs, state):  # inside the window in eval(): the weights, nothing written
        assert torch.equal(y, w)
        assert all(torch.equal(v, sd[k]) for k, v in tq.state_dict().items())
    with torch.no_grad():
        fq.weight_fake_quant_group(fq.WeightGroup([tq.train().entry(w) for tq, w in zip(tqs, ws)]))
        outs = fq.weight_fake_quant_group(fq.WeightGroup([tq.eval().entry(w) for tq, w in zip(tqs, ws)]))
    for tq, w, y in zip(tqs, ws, outs):
        assert torch.equal(y, fq.weight_fake_quant_ref(w, tq.min_range, tq.max_range, 8, tq.ch_axis))
    # without an observer the ranges quantize at once, and no flag is touched
    tq = WeightQuantizer((4, 6), observer=False).train()
    w = torch.from_numpy(_weight(rng, (4, 6), 0))
    (y,) = fq.weight_fake_quant_group(fq.WeightGroup([tq.entry(w)]))
    assert torch.equal(y, fq.weight_fake_quant_ref(w, tq.min_range, tq.max_range, 8, 0)) and not bool(tq.observed)


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def _model(name, seed=0, **spec):
    mod, cls, arch = MODELS[name]
    return cls(q=QuantSpec(**{**SPEC, **spec}), generator=torch.Generator().manual_seed(seed), **arch)


def _mix(seed, batch=2, samples=1600):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, samples)).astype(np.float32) * 0.3)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_equals_the_folded_per_tensor_route(name, monkeypatch):
    model = _model(name, max_observations=2)
    x = _mix(1)
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    counts = {}
    for fn in ("weight_group_forward_ref", "_weight_forward"):
        _count(monkeypatch, fq, fn, counts)
    with torch.no_grad():
        y = model.eval()(x)
    assert counts == {"weight_group_forward_ref": 1}  # one grouped call, no per-tensor one
    with torch.no_grad():
        want = fold_quantized_weights(model)(x)  # the fold takes the per-tensor route
    assert counts["_weight_forward"] == len(weight_quantizer_sites(model))
    assert torch.equal(y, want)
    counts.clear()
    float_model = MODELS[name][1](**MODELS[name][2])
    with torch.no_grad():
        float_model(x)
    assert counts == {}  # no weight quantizers: nothing launched


def _step_states(name, route, steps=2):
    """Gradients and updated parameters of ``steps`` KD steps (the observing one first) of a tiny model."""
    student = _model(name, seed=3, max_observations=1)
    teacher = MODELS[name][1](generator=torch.Generator().manual_seed(4), **MODELS[name][2]).requires_grad_(False)
    state = TrainState(student, make_optimizer(TrainConfig(), [p for p in student.parameters() if p.requires_grad]),
                       teacher)
    step = make_train_step(TrainConfig())
    src = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 2, 1600)).astype(np.float32) * 0.3)
    out = []
    with route():
        for _ in range(steps):
            metrics = step(state, src.sum(1), src)
            out.append((float(metrics["loss"]), {n: p.grad.clone() for n, p in student.named_parameters()
                                                 if p.grad is not None},
                        {n: p.detach().clone() for n, p in student.named_parameters()}))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kd_steps_equal_the_per_tensor_route_with_one_grouped_call_each_way(name, monkeypatch):
    counts = {}
    for fn in ("weight_group_forward_ref", "weight_group_backward_ref", "_weight_forward", "weight_fake_quant_bwd"):
        _count(monkeypatch, fq, fn, counts)
    for fn in ("weight_fake_quant_ref", "weight_fake_quant_bwd", "weight_fake_quant_bwd_ref"):
        _count(monkeypatch, qd, fn, counts)  # K5's weight grid, forward and backward
    grouped = _step_states(name, contextlib.nullcontext)
    assert counts == {"weight_group_forward_ref": 2, "weight_group_backward_ref": 2}  # student only: the teacher
    # is a float model
    mod = MODELS[name][0]

    @contextlib.contextmanager
    def per_tensor():
        with monkeypatch.context() as m:
            m.setattr(mod, "weight_pass", lambda model: contextlib.nullcontext())
            yield

    counts.clear()
    per_tensor_states = _step_states(name, per_tensor)
    assert "weight_group_forward_ref" not in counts
    for (loss_a, grads_a, params_a), (loss_b, grads_b, params_b) in zip(grouped, per_tensor_states):
        assert loss_a == loss_b
        assert grads_a.keys() == grads_b.keys()
        for n in grads_a:
            assert torch.equal(grads_a[n], grads_b[n]), n
        for n in params_a:
            assert torch.equal(params_a[n], params_b[n]), n
    # after the observing step every weight quantizer's ranges get a gradient (the larger of |mn|, |mx| per channel)
    grads = grouped[1][1]
    quantizers = {n.rsplit(".", 1)[0] for n in grads if n.endswith("_range") and ("weight_fake_quantize" in n
                                                                                   or ".wq_" in n)}
    assert quantizers and all(grads[f"{q}.min_range"].any() or grads[f"{q}.max_range"].any() for q in quantizers)


class _JaxTwice(fnn.Module):
    """One flax WeightQuantizer called twice in one apply."""

    shape: tuple

    @fnn.compact
    def __call__(self, w):
        from fqss_tpu.quant.quantizers import WeightQuantizer as JaxWeightQuantizer

        q = JaxWeightQuantizer(weight_shape=self.shape, ch_axis=0)
        return q(w), q(w)


class _Twice(torch.nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(shape))
        self.weight_fake_quantize = WeightQuantizer(shape, ch_axis=0)

    def forward(self):
        with weight_pass(self):
            return self.weight_fake_quantize(self.weight), self.weight_fake_quantize(self.weight)


def test_a_quantizer_reached_twice_in_one_forward_matches_flax():
    w = _weight(np.random.default_rng(13), (5, 7), 0)
    jmod = _JaxTwice(w.shape)
    variables = jmod.init({}, jnp.asarray(w))
    tmod = _Twice(w.shape)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w))
    for call in range(2):  # in train(): the observing call (float, then quantized), then two quantized reads
        (y1, y2), upd = jmod.apply(variables, jnp.asarray(w), mutable=MUTABLE)
        variables = {**variables, **upd}
        with torch.no_grad():
            t1, t2 = tmod.train()()
        np.testing.assert_array_equal(t1.numpy(), np.asarray(y1))
        np.testing.assert_array_equal(t2.numpy(), np.asarray(y2))
        assert call > 0 or torch.equal(t1, tmod.weight) and not torch.equal(t2, t1)
    with torch.no_grad():
        t1, t2 = tmod.eval()()
    assert t1 is t2  # in eval() both reads take the pass's tensor
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(w))[0]))


def test_the_pass_keeps_its_table_until_storage_mode_or_tree_change():
    from fqss_tpu_torch.quant.quantizers import _PASSES

    model = _model("dptnet")
    x = _mix(6, batch=1)
    with torch.no_grad():
        model.eval()(x)
        first = _PASSES[model].group
        model(x)
        assert _PASSES[model].group is first  # the same weights, ranges, flags and mode: the same table
        model.train()(x)
        trained = _PASSES[model].group
        assert trained is not first and all(e.writes for e in trained.entries)
        w = model.decoder.weight
        w.data = w.data.clone()  # new storage
        model(x)
        assert _PASSES[model].group is not trained
        assert [e.w.data_ptr() for e in _PASSES[model].group.entries if e.w is w] == [w.data_ptr()]
        n = len(_PASSES[model].group)
        model.decoder.weight_fake_quantize = None  # a quantizer taken out of the tree
        model.eval()(x)
        assert len(_PASSES[model].group) == n - 1


def test_table_layout_and_work_split():
    """The 12 words of an entry as ``GroupEntry`` reads them, and how each layout's channels take blocks."""
    shapes = (((512, 1, 16), 1), ((128, 512, 1), 0), ((64, 512), 1), ((512, 1, 3), 0), ((3, 5, 7, 2), 2))
    entries = [fq.WeightEntry(torch.zeros(shape), torch.zeros(shape[ax]), torch.zeros(shape[ax]),
                              torch.zeros((), dtype=torch.bool) if i % 2 else None, bool(i % 2), 8, ax, 0.25)
               for i, (shape, ax) in enumerate(shapes)]
    group = fq.WeightGroup(entries)
    assert group.views == ((512, 1, 16), (1, 128, 512), (64, 512, 1), (1, 512, 3), (15, 7, 2))
    # a block a channel (8192 elements), a warp a channel, a lane a channel (channel axis last), a warp a channel
    assert group.kinds == (2, 0, 1, 0, 0)
    assert group.block0.tolist() == [0, 1, 17, 33, 97, 98]
    assert group.offsets == (0, 8192, 73728, 106496, 108032) and group.ch0 == (0, 1, 129, 641, 1153)
    ptrs = [(11 + 4 * i, 12 + 4 * i, 13 + 4 * i, 0 if e.observed is None else 14 + 4 * i) for i, e in enumerate(entries)]
    packed = group.pack(ptrs)
    layout = np.dtype({"names": ["w", "mn", "mx", "observed", "out", "ch0", "outer", "channels", "inner", "block0",
                                 "kind", "n_bits", "writes", "dmax_scale"],
                       "formats": ["<u8"] * 4 + ["<i8"] * 6 + ["<i4"] * 3 + ["<f4"],
                       "offsets": [0, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 84, 88, 92], "itemsize": 96})
    table = packed[:96 * len(entries)].view(layout)
    block_entry = packed[96 * len(entries):].view(np.int32)
    for i, e in enumerate(entries):
        row = table[i]
        assert (row["w"], row["mn"], row["mx"], row["observed"]) == ptrs[i]
        assert (row["out"], row["ch0"], row["block0"]) == (group.offsets[i], group.ch0[i], group.block0[i])
        assert (row["outer"], row["channels"], row["inner"]) == group.views[i]
        assert (row["kind"], row["n_bits"], row["writes"]) == (group.kinds[i], 8, int(e.writes))
        assert row["dmax_scale"] == np.float32(0.25 * 2 / 255)
    assert block_entry.tolist() == np.repeat(np.arange(5), np.diff(group.block0)).tolist()


def test_a_transposed_gradient_is_read_in_place():
    """The attention's ``x @ w_in.t()`` hands back a transposed gradient: the kernel reads it by its strides."""
    g = torch.randn(12, 30).t()  # [30, 12] with strides (1, 30)
    v = fq._grad_view(g, (1, 30, 12), g.shape)
    assert v.data_ptr() == g.data_ptr() and v.stride()[1:] == (1, 30)
    g3 = torch.randn(4, 3, 5).transpose(0, 2)  # [5, 3, 4]: no [1, 5, 12] view exists, so it is copied
    v3 = fq._grad_view(g3, (1, 5, 12), g3.shape)
    assert v3.is_contiguous() and torch.equal(v3.view(5, 3, 4), g3)
    with pytest.raises(ValueError):
        fq._grad_view(g.double(), (1, 30, 12), g.shape)
