"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device. This file imports no JAX,
so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.ops import qmatmul as qm
from fqss_tpu_torch.nn.nonlin import gelu as gelu_ref

pytestmark = pytest.mark.cuda

STEP = 2.0**-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ties(n, dev):
    return ((torch.arange(n, device=dev) % 262 - 131) + 0.5) * STEP


@pytest.mark.parametrize("n", [1, 1023, 1025, 1 << 18])
def test_act_kernel_bitwise_equals_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    mn, mx = torch.tensor([-1.0], device=dev), torch.tensor([-1.0 + 255 * STEP], device=dev)
    x = mn + _ties(n, dev)
    x[: n // 2] = torch.randn(n // 2, device=dev, generator=g)
    before = fq.LAUNCHES["act"]
    y = fq.act_fake_quant(x, mn, mx, 8)
    assert fq.LAUNCHES["act"] == before + 1
    assert torch.equal(y, fq.act_fake_quant_ref(x, mn, mx, 8))
    assert torch.equal(fq.fake_quant(x, mn, mx, 8), y)


@pytest.mark.parametrize("shape,ch_axis", [((512, 2, 16), 0), ((512, 1, 3), 0), ((1024, 128, 1), 0),
                                           ((512, 1, 16), 1), ((5, 33, 24), 2)])
def test_weight_kernel_bitwise_equals_plain(dev, shape, ch_axis):
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn(shape, device=dev, generator=g) * 0.3
    dims = tuple(i for i in range(w.ndim) if i != ch_axis)
    mn, mx = w.amin(dims, keepdim=True), w.amax(dims, keepdim=True)
    mn.view(-1)[0], mx.view(-1)[0] = -255 / 256, 255 / 256
    first = w.select(ch_axis, 0)
    first.copy_(_ties(first.numel(), dev).reshape(first.shape))
    before = fq.LAUNCHES["weight"]
    y = fq.weight_fake_quant(w, mn, mx, 8, ch_axis)
    assert fq.LAUNCHES["weight"] == before + 1
    assert torch.equal(y, fq.weight_fake_quant_ref(w, mn, mx, 8, ch_axis))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(4, 6, device=dev)
    r = torch.tensor([-1.0], device=dev), torch.tensor([1.0], device=dev)
    with pytest.raises(TypeError):
        fq.act_fake_quant(x.double(), r[0].double(), r[1].double())
    with pytest.raises(ValueError):
        fq.act_fake_quant(x.t(), *r)
    with pytest.raises(ValueError):
        fq.act_fake_quant(x, torch.zeros(2, device=dev), torch.ones(2, device=dev))
    with pytest.raises(ValueError):
        fq.weight_fake_quant(x, torch.zeros(5, device=dev), torch.ones(5, device=dev), 8, 0)
    # a call that needs a gradient runs the forward kernel, and its backward the backward kernel
    before = dict(fq.LAUNCHES)
    x.requires_grad_()
    fq.act_fake_quant(x, *r).sum().backward()
    assert fq.LAUNCHES["act"] == before["act"] + 1 and fq.LAUNCHES["act_bwd"] == before["act_bwd"] + 1
    assert torch.equal(x.grad, fq.act_fake_quant_bwd_ref(x.detach(), torch.ones_like(x), *r)[0])


SUM_RTOL = 1e-5  # a float32 sum in another order than float64's, relative to sum |term|


def _assert_sum(got, terms, dims=None):
    exact = terms.double().sum(dims) if dims else terms.double().sum()
    bound = terms.double().abs().sum(dims) if dims else terms.double().abs().sum()
    assert bool(((got.double().reshape(exact.shape) - exact).abs() <= SUM_RTOL * bound).all())


@pytest.mark.parametrize("n", [1, 1023, 1025, 1 << 18])
def test_act_bwd_kernel_matches_plain(dev, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    mn, mx = torch.tensor([-1.0], device=dev), torch.tensor([-1.0 + 255 * STEP], device=dev)
    x = mn + _ties(n, dev)
    x[: n // 2] = torch.randn(n // 2, device=dev, generator=gen)
    x, g = x.reshape(1, n), torch.randn(1, n, device=dev, generator=gen)
    for s in (1.0, fq.act_scale(x, 8, True)):
        before = fq.LAUNCHES["act_bwd"]
        dx, dmn, dmx = fq.act_fake_quant_bwd(x, g, mn, mx, 8, s)
        assert fq.LAUNCHES["act_bwd"] == before + 1
        ref_dx, p_mn, p_mx = fq.act_bwd_terms(x, g, mn, mx, 8, s)
        assert torch.equal(dx, ref_dx)
        _assert_sum(dmn, p_mn)
        _assert_sum(dmx, p_mx)


@pytest.mark.parametrize("shape,ch_axis", [((512, 2, 16), 0), ((512, 1, 3), 1), ((1024, 128, 1), 0),
                                           ((512, 1, 16), 1), ((5, 33, 24), 2)])
def test_weight_bwd_kernel_matches_plain(dev, shape, ch_axis):
    gen = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn(shape, device=dev, generator=gen) * 0.3
    g = torch.randn(shape, device=dev, generator=gen)
    dims = tuple(i for i in range(w.ndim) if i != ch_axis)
    mn, mx = w.amin(dims, keepdim=True), w.amax(dims, keepdim=True)
    mx.view(-1)[1::3] = -mn.view(-1)[1::3]  # |mn| == |mx|: half of the gradient to each
    first = w.select(ch_axis, 0)
    first.copy_(_ties(first.numel(), dev).reshape(first.shape))
    for s in (1.0, fq.weight_scale(shape[ch_axis], 8, True)):
        before = fq.LAUNCHES["weight_bwd"]
        dw, dmn, dmx = fq.weight_fake_quant_bwd(w, g, mn, mx, 8, s, ch_axis)
        assert fq.LAUNCHES["weight_bwd"] == before + 1
        ref_dw, terms = fq.weight_bwd_terms(w, g, mn, mx, 8, ch_axis)
        assert torch.equal(dw, ref_dw)
        exact = fq.route_range_grad(terms.double().sum(dims), mn.double(), mx.double(), 8, s)
        bound = fq.route_range_grad(terms.double().abs().sum(dims), mn.double(), mx.double(), 8, s)
        for got, want, b in zip((dmn, dmx), exact, bound):
            assert bool(((got.double() - want).abs() <= SUM_RTOL * b.abs()).all())


# The grouped weight quantizers: every work split of the kernels (a block a channel: 4099 and 8192 elements; a lane a
# channel: the channel axis last, 300 and 257 channels; a warp a channel: the rest), odd channel counts, 2-D to 4-D
# weights, each observer state, gradients that are absent or transposed.
GROUP_SPECS = (((512, 1, 16), 1), ((7, 33, 3), 0), ((64, 300), 1), ((300, 5), 0), ((3, 5, 7, 2), 2), ((1, 4099), 0),
               ((2, 257), 1), ((37, 1, 3), 0), ((20, 31), 0))


def _group_entries(dev, specs, writes, seed):
    """Two copies (kernel, plain) of the same entries: observer flags unset (observing), set, and absent in turn,
    ranges with |mn| == |mx| on every third channel and channel 0 at a step of 2^-7 with tie values."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    copies = ([], [])
    for i, (shape, ax) in enumerate(specs):
        w = torch.randn(shape, device=dev, generator=gen) * 0.3
        first = w.select(ax, 0)
        first.copy_(_ties(first.numel(), dev).reshape(first.shape))
        dims = tuple(d for d in range(w.ndim) if d != ax)
        mn, mx = w.amin(dims, keepdim=True) * 0.9, w.amax(dims, keepdim=True) * 0.9
        mx.view(-1)[1::3] = -mn.view(-1)[1::3]
        mn.view(-1)[0], mx.view(-1)[0] = -255 / 256, 255 / 256
        observed = (torch.zeros((), dtype=torch.bool, device=dev), torch.ones((), dtype=torch.bool, device=dev),
                    None)[i % 3]
        for c in copies:
            c.append(fq.WeightEntry(w.clone(), mn.clone(), mx.clone(), None if observed is None else observed.clone(),
                                    writes, 8, ax, fq.weight_scale(shape[ax], 8, i % 2 == 1)))
    return copies


def _group_grads(dev, specs, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = []
    for i, (shape, _) in enumerate(specs):
        if i % 4 == 3:
            grads.append(None)
        elif len(shape) == 2 and i % 2 == 0:  # transposed, as x @ w.t() hands it back
            grads.append(torch.randn(shape[::-1], device=dev, generator=gen).t())
        else:
            grads.append(torch.randn(shape, device=dev, generator=gen))
    return grads


@pytest.mark.parametrize("writes", [True, False], ids=["train", "eval"])
def test_weight_group_kernels_match_plain(dev, writes):
    kernel, plain = _group_entries(dev, GROUP_SPECS, writes, 21)
    gk, gp = fq.WeightGroup(kernel), fq.WeightGroup(plain)
    assert set(gk.kinds) == {0, 1, 2}
    before = dict(fq.LAUNCHES)
    buf = fq._group_forward(gk)
    ref = torch.empty_like(buf)
    fq.weight_group_forward_ref(gp, ref)
    assert fq.LAUNCHES["weight"] == before["weight"] + 1
    assert torch.equal(buf, ref)  # outputs, the ranges used and the flags
    for ek, ep in zip(kernel, plain):  # the observers' writes
        assert torch.equal(ek.min_range, ep.min_range) and torch.equal(ek.max_range, ep.max_range)
        assert ek.observed is None or bool(ek.observed) == bool(ep.observed) == (writes or bool(ek.observed))
    grads = _group_grads(dev, GROUP_SPECS, 22)
    dk = fq.weight_fake_quant_group_bwd(gk, buf, grads)
    dp = fq.weight_group_backward_ref(gp, ref, grads)
    assert fq.LAUNCHES["weight_bwd"] == before["weight_bwd"] + 1
    used_mn, used_mx, flags = gk.scratch(buf)
    used_mn, used_mx = gk.split_ranges(used_mn), gk.split_ranges(used_mx)
    for i, (e, g) in enumerate(zip(plain, grads)):
        if g is None:
            assert dk[0][i] is dk[1][i] is dk[2][i] is None
            continue
        assert torch.equal(dk[0][i], dp[0][i])
        if flags[i]:
            assert torch.equal(dk[0][i], g) and not dk[1][i].any() and not dk[2][i].any()
            continue
        mn, mx = used_mn[i], used_mx[i]
        dims = tuple(d for d in range(g.ndim) if d != e.ch_axis)
        _, terms = fq.weight_bwd_terms(e.w, g, mn, mx, 8, e.ch_axis)
        exact = fq.route_range_grad(terms.double().sum(dims), mn.double(), mx.double(), 8, e.s)
        bound = fq.route_range_grad(terms.double().abs().sum(dims), mn.double(), mx.double(), 8, e.s)
        for got, want, b in zip((dk[1][i], dk[2][i]), exact, bound):
            assert bool(((got.double() - want).abs() <= SUM_RTOL * b.abs()).all())


def test_weight_group_backward_over_many_entries(dev):
    """More entries than one backward launch takes (256): one call, two launches, every entry's gradients."""
    specs = [((3 + i % 5, 4 + i % 3), i % 2) for i in range(300)]
    kernel, plain = _group_entries(dev, specs, False, 23)
    gk, gp = fq.WeightGroup(kernel), fq.WeightGroup(plain)
    buf = fq._group_forward(gk)
    grads = [torch.randn(shape, device=dev) if i % 5 else None for i, (shape, _) in enumerate(specs)]
    before = fq.LAUNCHES["weight_bwd"]
    dk = fq.weight_fake_quant_group_bwd(gk, buf, grads)
    assert fq.LAUNCHES["weight_bwd"] == before + 1
    dp = fq.weight_group_backward_ref(gp, buf, grads)
    for i, g in enumerate(grads):
        assert (dk[0][i] is None) == (g is None)
        if g is not None:
            assert torch.equal(dk[0][i], dp[0][i])
            for got, want in zip(dk[1:], dp[1:]):
                assert torch.allclose(got[i], want[i], rtol=1e-5, atol=1e-6)


def test_model_weight_pass_is_one_launch_each_way(dev):
    """A tiny DPTNet's forward and backward: one grouped launch each way, no K2 per tensor (K5 and K3 with their
    weight grids off); the forward equals the per-tensor route's, and every weight and range gets a gradient."""
    import contextlib

    from fqss_tpu_torch.models import dptnet
    from fqss_tpu_torch.quant.quantizers import weight_quantizer_sites
    from fqss_tpu_torch.quant.spec import QuantSpec

    arch = dict(n_srcs=2, kernel_size=2, enc_dim=32, feature_dim=16, hidden_dim=32, layer=2, segment_size=40)
    q = QuantSpec(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=1)
    model = dptnet.DPTNet(q=q, generator=torch.Generator().manual_seed(0), **arch).to(dev)
    other = dptnet.DPTNet(q=q, **arch).to(dev)
    other.load_state_dict(model.state_dict())
    x = torch.randn(2, 2000, generator=torch.Generator().manual_seed(1)).to(dev) * 0.3
    for step in range(2):  # the observing call, then a quantizing one
        fq.reset_launches()
        y = model(x)
        y.square().sum().backward()
        assert (fq.LAUNCHES["weight"], fq.LAUNCHES["weight_bwd"]) == (1, 1), step
        for layer, qname, wname in weight_quantizer_sites(model):
            wq = getattr(layer, qname)
            assert all(p.grad is not None for p in (getattr(layer, wname), wq.min_range, wq.max_range)), (step, qname)
        model.zero_grad(set_to_none=True)
        original, dptnet.weight_pass = dptnet.weight_pass, lambda m: contextlib.nullcontext()
        try:  # with gradients on, as above: without them the bias-free 1x1 convs take K3
            assert torch.equal(other(x).detach(), y.detach()), step
        finally:
            dptnet.weight_pass = original


def test_tiny_train_step_runs_the_backward_kernels(dev):
    from fqss_tpu_torch.models.convtasnet import ConvTasNet
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.train.state import TrainState
    from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    arch = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
    q = QuantSpec(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=1)
    model = ConvTasNet(q=q, generator=torch.Generator().manual_seed(0), **arch).to(dev)
    teacher = ConvTasNet(generator=torch.Generator().manual_seed(1), **arch).to(dev).requires_grad_(False)
    state = TrainState(model, make_optimizer(TrainConfig(), [p for p in model.parameters() if p.requires_grad]),
                       teacher)
    gen = torch.Generator(device=dev).manual_seed(2)
    src = torch.randn(2, 2, 1600, device=dev, generator=gen)
    step = make_train_step(TrainConfig())
    for _ in range(3):  # the observing step, then two quantizing ones
        fq.reset_launches()
        metrics = step(state, src.sum(1), src)
        assert torch.isfinite(metrics["loss"]) and not metrics["skipped"]
        # 24 act quantizers, the last block's res_conv and add (2 act) feeding nothing; the 13 weight quantizers
        # as one grouped launch each way
        assert fq.LAUNCHES == {"act": 24, "weight": 1, "act_bwd": 22, "weight_bwd": 1}


def _int8_case(dev, m, k, n, seed):
    """Random int8 operands with planted extremes, and per-channel scale/corr."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
    xs[0] = -128  # against the columns of -128 and 127 below: the largest |acc|, 128 * 128 * k
    w[0], w[-1] = -128, 127
    scale = torch.rand(n, device=dev, generator=gen) * 1e-4 + 1e-6
    corr = torch.randn(n, device=dev, generator=gen) * 0.1
    return xs, w, scale, corr


@pytest.mark.parametrize("m,k,n", [(1, 48, 40), (17, 48, 40), (1023, 48, 40), (300, 7, 3), (129, 130, 257),
                                   (2048, 512, 128), (2048, 128, 1024)])
@pytest.mark.parametrize("alpha", [1.0, 0.25, 0.0])
def test_int8_matmul_kernel_bitwise_equals_plain(dev, m, k, n, alpha):
    from fqss_tpu_torch.ops import int8_matmul as im

    xs, w, scale, corr = _int8_case(dev, m, k, n, m + k + n)
    delta, mn = 2.0**-6, -1.0
    before = im.LAUNCHES["int8_mm"]
    got = im.int8_matmul_requant(xs, w, scale, corr, alpha, delta, mn)
    assert im.LAUNCHES["int8_mm"] == before + 1
    assert got.dtype == torch.int8 and got.shape == (m, n)
    assert torch.equal(got, im.int8_matmul_requant_ref(xs, w, scale, corr, alpha, delta, mn))


def test_int8_matmul_kernel_on_exact_ties(dev):
    """Products placed on half steps of the out grid: rint must round them half to even."""
    from fqss_tpu_torch.ops import int8_matmul as im

    m, k, n = 512, 64, 96
    xs = torch.zeros(m, k, dtype=torch.int8, device=dev)
    w = torch.zeros(n, k, dtype=torch.int8, device=dev)
    xs[:, 0] = (torch.arange(m, device=dev) % 255 - 127).to(torch.int8)
    w[:, 0] = 1
    delta, mn = 2.0**-4, -8.0
    scale = torch.full((n,), delta, device=dev)  # v = acc * delta + corr
    corr = torch.full((n,), delta / 2, device=dev)  # every v sits half a step off the grid
    got = im.int8_matmul_requant(xs, w, scale, corr, 1.0, delta, mn)
    want = im.int8_matmul_requant_ref(xs, w, scale, corr, 1.0, delta, mn)
    assert torch.equal(got, want)
    # half to even: (acc + 0.5) + 128 rounds to the even neighbour
    X = (xs[:, 0].float() + 128.5).round().clamp(0, 255)
    assert torch.equal(want[:, 0], (X - 128).to(torch.int8))


def test_int8_matmul_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from fqss_tpu_torch.ops import int8_matmul as im

    xs, w, scale, corr = _int8_case(dev, 8, 32, 16, 0)
    with pytest.raises(TypeError):
        im.int8_matmul_requant(xs.float(), w, scale, corr, 1.0, 0.1, 0.0)
    with pytest.raises(TypeError):
        im.int8_matmul_requant(xs, w, scale.double(), corr, 1.0, 0.1, 0.0)
    with pytest.raises(ValueError):
        im.int8_matmul_requant(xs.t(), w, scale, corr, 1.0, 0.1, 0.0)
    with pytest.raises(ValueError):
        im.int8_matmul_requant(xs, w.t().contiguous(), scale, corr, 1.0, 0.1, 0.0)
    with pytest.raises(ValueError):
        im.int8_matmul_requant(xs, w, scale.cpu(), corr, 1.0, 0.1, 0.0)
    with pytest.raises(ValueError):
        im.int8_matmul_requant(xs, w, scale[:-1], corr[:-1], 1.0, 0.1, 0.0)


# The int8 engine card vs CPU: the minimum SNR per output in dB, as chip_smoke.py's INT8_CARD_VS_CPU.
INT8_CARD_VS_CPU_DB = {"float32": 90.0, "bfloat16": 40.0}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiny_int8_engine_runs_k4_at_every_1x1_conv(dev, compute_dtype):
    import numpy as np

    from fqss_tpu_torch.models.convtasnet import ConvTasNet
    from fqss_tpu_torch.ops import int8_matmul as im
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.serve import make_int8_engine

    arch = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
    observe = QuantSpec(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)
    model = ConvTasNet(q=observe, generator=torch.Generator().manual_seed(0), **arch).train()
    x = torch.randn(2, 1600, generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        for _ in range(2):
            model(x)
    served = ConvTasNet(q=QuantSpec(qat=True, n_splitter=2, n_combiner=2, out_quant=True, observer=False), **arch)
    served.load_state_dict(model.state_dict())
    cpu = make_int8_engine(served.eval(), compute_dtype=compute_dtype)(x)
    card_engine = make_int8_engine(served.to(dev), compute_dtype=compute_dtype)
    im.reset_launches()
    card = card_engine(x.to(dev)).cpu()
    assert im.LAUNCHES["int8_mm"] == 1 + 3 * 2 + 1  # bottleneck, 2 blocks x (conv_in, res, skip), mask
    snr = 10 * torch.log10(cpu.pow(2).sum(-1) / (cpu - card).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= INT8_CARD_VS_CPU_DB[compute_dtype]).all()), snr
    assert np.isfinite(card.numpy()).all()


# LSTM recurrence (K7 both directions, K6 one) against its plain version: max |difference| <= 1e-5 (float32
# sums in another order than cuBLAS's, ulp-level transcendentals; chip_smoke.py's LSTM_TOL).
LSTM_TOL = 1e-5


@pytest.mark.parametrize("T,B,H", [(40, 300, 128), (7, 3, 96), (5, 17, 130), (33, 20, 64)])
def test_lstm_kernels_match_plain(dev, T, B, H):
    from fqss_tpu_torch.ops import lstm

    gen = torch.Generator(device=dev).manual_seed(T * B + H)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / H**0.5 for _ in range(2)]
    before = dict(lstm.LAUNCHES)
    with torch.no_grad():
        hf, hb = lstm.bilstm_sequence(ih[0], ih[1], w[0], w[1])
        h1 = lstm.lstm_sequence(ih[1], w[1])
        rf, rb = lstm.bilstm_sequence_ref(ih[0], ih[1], w[0], w[1])
    torch.cuda.synchronize()
    assert lstm.LAUNCHES == {**before, "lstm": before["lstm"] + 1, "bilstm": before["bilstm"] + 1}
    assert hf.shape == hb.shape == h1.shape == (T, B, H)
    for got, want in ((hf, rf), (hb, rb), (h1, rb)):
        assert (got - want).abs().max().item() <= LSTM_TOL


def test_lstm_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from fqss_tpu_torch.ops import lstm

    ih, w = torch.randn(4, 3, 32, device=dev), torch.randn(8, 32, device=dev)
    with pytest.raises(TypeError):
        lstm.lstm_sequence(ih.double(), w.double())
    with pytest.raises(ValueError):
        lstm.lstm_sequence(ih.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError):
        lstm.bilstm_sequence(ih, ih.cpu(), w, w.cpu())
    # a call that needs a gradient launches the kernel; its backward is the plain recurrence's gradient
    before = dict(lstm.LAUNCHES)
    w.requires_grad_()
    lstm.lstm_sequence(ih, w).sum().backward()
    assert lstm.LAUNCHES == {**before, "lstm": before["lstm"] + 1}
    want = torch.autograd.grad(lstm.lstm_sequence_ref(ih, w).sum(), w)[0]
    assert torch.equal(w.grad, want)


@pytest.mark.parametrize("T,B,H", [(40, 300, 128), (7, 3, 96)])
def test_lstm_backward_equals_the_plain_gradient(dev, T, B, H):
    from fqss_tpu_torch.ops import lstm

    gen = torch.Generator(device=dev).manual_seed(T + B + H)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(3)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / H**0.5 for _ in range(3)]
    g = [torch.randn(T, B, H, device=dev, generator=gen) for _ in range(3)]
    grads = []
    for bi, uni in ((lstm.bilstm_sequence, lstm.lstm_sequence), (lstm.bilstm_sequence_ref, lstm.lstm_sequence_ref)):
        # each input feeds one recurrence, so that its gradient sums its steps in the same order on both sides
        t = [a.clone().requires_grad_(True) for a in (*ih, *w)]
        hf, hb = bi(t[0], t[1], t[3], t[4])
        ((hf * g[0]).sum() + (hb * g[1]).sum() + (uni(t[2], t[5]) * g[2]).sum()).backward()
        grads.append([a.grad for a in t])
    for got, want in zip(*grads):  # the same plain recurrence differentiated at the same saved inputs
        assert torch.equal(got, want)


# The static route of K7/K6 (QLSTM(mode="static")) against its plain version, chip_smoke.py's rule: every output
# within one step of the output site's (mul2's) grid of the plain version's, at most STATIC_SHARE of them more than
# half a step apart; the ranges after an observer window within STATIC_RANGE_REL of each site's range width.
STATIC_SHARE = 0.01
STATIC_RANGE_REL = 1e-6


def _static_case(dev, T, B, H, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / H**0.5 for _ in range(2)]
    # ranges about the cell's own: the gates in [0, 1], the sums and products a little wider
    lo = torch.tensor([-2.0, -1.5, -3.0, 0.0, 0.0, -1.0, 0.0, -1.0, -1.0, -2.0, -1.0, -1.0], device=dev)
    sites = [(lo * (1 + 0.1 * d), -lo.clamp(max=-1.0) * (1 + 0.1 * d)) for d in range(2)]
    return ih, w, sites


def _assert_static_rule(got, want, mx, mn):
    step = float(mx[11] - mn[11]) / 255
    diff = (got - want).abs()
    assert diff.max().item() <= step * (1 + 1e-4), diff.max().item() / step
    assert (diff > 0.5 * step).float().mean().item() <= STATIC_SHARE


@pytest.mark.parametrize("T,B,H,observe", [(40, 300, 128, 0), (12, 300, 128, 5), (12, 37, 96, 12), (20, 67, 130, 7),
                                           (9, 11, 400, 4), (6, 5, 400, 0)])
def test_lstm_static_route_matches_plain(dev, T, B, H, observe):
    from fqss_tpu_torch.ops import lstm

    ih, w, sites = _static_case(dev, T, B, H, T * B + H + observe)
    before = dict(lstm.LAUNCHES)
    with torch.no_grad():
        hf, hb, rf, rb = lstm.bilstm_static_sequence(ih[0], ih[1], w[0], w[1], sites[0], sites[1], observe)
        h1, *r1 = lstm.lstm_static_sequence(ih[1], w[1], *sites[1], observe)
        want = [lstm.lstm_static_sequence_ref(ih[d], w[d], *sites[d], observe) for d in range(2)]
    torch.cuda.synchronize()
    launches = 2 if 0 < observe < T else 1
    assert lstm.LAUNCHES == {**before, "lstm_static": before["lstm_static"] + launches,
                             "bilstm_static": before["bilstm_static"] + launches}
    assert lstm.launch_plan(dev, B, H, 2, lstm.MODES["static"]).route == ("blocks" if H == 400 else "cluster")
    for got, ranges, (hs, mn, mx) in ((hf, rf, want[0]), (hb, rb, want[1]), (h1, r1, want[1])):
        assert got.shape == (T, B, H)
        width = mx - mn
        for a, b in zip(ranges, (mn, mx)):
            assert bool(((a - b).abs() <= STATIC_RANGE_REL * width).all()), ((a - b).abs() / width).max()
        _assert_static_rule(got, hs, mx, mn)
    assert torch.equal(h1, hb)


def test_lstm_static_route_backward_equals_the_plain_gradient(dev):
    from fqss_tpu_torch.ops import lstm

    ih, w, sites = _static_case(dev, 12, 40, 64, 3)
    g = torch.randn(12, 40, 64, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    grads = []
    for fn in (lstm.lstm_static_sequence, lstm.lstm_static_sequence_ref):
        t = [a.clone().requires_grad_(True) for a in (ih[0], w[0], *sites[0])]
        before = dict(lstm.LAUNCHES)
        (fn(*t, 5)[0] * g).sum().backward()
        if fn is lstm.lstm_static_sequence:
            assert lstm.LAUNCHES == {**before, "lstm_static": before["lstm_static"] + 2}
        grads.append([a.grad for a in t])
    for got, want in zip(*grads):  # the backward recomputes the same plain recurrence at the same saved inputs
        assert torch.equal(got, want)


def test_lstm_static_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from fqss_tpu_torch.ops import lstm

    ih, w = torch.randn(4, 3, 32, device=dev), torch.randn(8, 32, device=dev)
    mn, mx = torch.full((12,), -1.0, device=dev), torch.ones(12, device=dev)
    with pytest.raises(ValueError):
        lstm.lstm_static_sequence(ih, w, mn.cpu(), mx.cpu())
    with pytest.raises(ValueError):
        lstm.lstm_static_sequence(ih, w, mn[:11], mx[:11])
    with pytest.raises(ValueError):
        lstm.lstm_static_sequence(ih, w, mn, mx, observe=5)
    with pytest.raises(TypeError):
        lstm.lstm_static_sequence(ih.double(), w.double(), mn, mx)


def test_tiny_static_dptnet_runs_the_static_route(dev):
    """A tiny static-mode DPTNet on the card: one static-route launch a bidirectional LSTM (two where a call
    crosses the window), no fused or plain recurrence, and the CPU's output within 20 dB."""
    from fqss_tpu_torch.models.dptnet import DPTNet
    from fqss_tpu_torch.ops import lstm
    from fqss_tpu_torch.quant.spec import QuantSpec

    arch = dict(n_srcs=2, kernel_size=2, enc_dim=32, feature_dim=16, hidden_dim=32, layer=2, segment_size=40)
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, lstm_mode="static", max_observations=2)
    model = DPTNet(q=QuantSpec(**spec), generator=torch.Generator().manual_seed(0), **arch).to(dev)
    x = torch.randn(1, 2000, generator=torch.Generator().manual_seed(1)) * 0.3
    lstm.reset_launches()
    with torch.no_grad():
        model.train()(x.to(dev))  # the row LSTMs see T 40 (inside the window), the column ones T 102 (across it)
    assert lstm.LAUNCHES == {"lstm": 0, "bilstm": 0, "lstm_static": 0, "bilstm_static": 2 + 2 * 2}
    counts = {n: int(b) for n, b in model.named_buffers() if n.endswith("site_n_iter")}
    assert set(counts.values()) == {40, 50}
    served = DPTNet(q=QuantSpec(**dict(spec, observer=False)), **arch)
    served.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    card = DPTNet(q=QuantSpec(**dict(spec, observer=False)), **arch)
    card.load_state_dict(served.state_dict())
    card = card.to(dev).eval()
    lstm.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev)).cpu()
        want = served.eval()(x)
    assert lstm.LAUNCHES == {"lstm": 0, "bilstm": 0, "lstm_static": 0, "bilstm_static": 4}
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= 20).all()), snr


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (1023, 64, 64), (4096, 256, 64), (300, 7, 3)])
@pytest.mark.parametrize("nl", ["tanh", "sigmoid"])
def test_int8_matmul_kernel_epilogues_bitwise_equal_plain(dev, m, k, n, nl):
    from fqss_tpu_torch.ops import int8_matmul as im

    xs, w, scale, corr = _int8_case(dev, m, k, n, m + k + n)
    args = (xs, w, scale * 0.05, corr, 1.0, 2.0**-6, -2.0)
    before = im.LAUNCHES["int8_mm"]
    got = im.int8_matmul_requant(*args, nl=nl)
    assert im.LAUNCHES["int8_mm"] == before + 1
    assert torch.equal(got, im.int8_matmul_requant_ref(*args, nl=nl))


# The cluster route's plans (ops/lstm.py:plan) at odd shapes: a last tile of 3 of 8 rows (B 67), one row and one
# step, H 96 and 130 (48 units a CTA of 2, 44/44/42 of 3), H 322 (the largest a cluster of 8 holds), and H 400 on
# the blocks route.
@pytest.mark.parametrize("T,B,H", [(20, 67, 128), (1, 1, 128), (9, 1, 128), (11, 37, 96), (6, 70, 130), (4, 9, 322),
                                   (5, 11, 400)])
def test_lstm_routes_match_plain_and_repeat(dev, T, B, H):
    from fqss_tpu_torch.ops import lstm

    gen = torch.Generator(device=dev).manual_seed(T * B + H)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / H**0.5 for _ in range(2)]
    plan = lstm.launch_plan(dev, B, H, 2)
    assert plan.route == ("blocks" if H == 400 else "cluster")
    before = dict(lstm.LAUNCHES)
    with torch.no_grad():
        hf, hb = lstm.bilstm_sequence(ih[0], ih[1], w[0], w[1])
        h1 = lstm.lstm_sequence(ih[1], w[1])
        again = lstm.bilstm_sequence(ih[0], ih[1], w[0], w[1])
        rf, rb = lstm.bilstm_sequence_ref(ih[0], ih[1], w[0], w[1])
    torch.cuda.synchronize()
    assert lstm.LAUNCHES == {**before, "lstm": before["lstm"] + 1, "bilstm": before["bilstm"] + 2}
    for got, want in ((hf, rf), (hb, rb), (h1, rb)):
        assert (got - want).abs().max().item() <= LSTM_TOL
    assert torch.equal(hf, again[0]) and torch.equal(hb, again[1]) and torch.equal(h1, hb)


# K4's persistent grid and its N tiles at the engines' odd shapes: DPTNet's N = 64 (64-column tiles), the
# Sepformer's ffn_out K = 1024, M not a multiple of 128, K = 7 and 130 (the byte path), a ragged N, the three
# output grids of an in-projection.
@pytest.mark.parametrize("m,k,n,grids", [(4097, 256, 64, 1), (1000, 1024, 256, 1), (2049, 128, 200, 1), (333, 7, 48, 1),
                                         (513, 130, 96, 1), (777, 64, 192, 3), (300, 256, 768, 3), (129, 2176, 20, 1)])
def test_int8_matmul_kernel_shapes_bitwise_equal_plain_and_repeat(dev, m, k, n, grids):
    from fqss_tpu_torch.ops import int8_matmul as im

    xs, w, scale, corr = _int8_case(dev, m, k, n, m + k + n)
    delta, mn = ([2.0**-6, 0.013, 2.0**-5], [-1.0, -2.5, -0.25]) if grids == 3 else (2.0**-6, -1.0)
    before = im.LAUNCHES["int8_mm"]
    got = im.int8_matmul_requant(xs, w, scale, corr, 0.25, delta, mn)
    again = im.int8_matmul_requant(xs, w, scale, corr, 0.25, delta, mn)
    assert im.LAUNCHES["int8_mm"] == before + 2
    assert torch.equal(got, im.int8_matmul_requant_ref(xs, w, scale, corr, 0.25, delta, mn))
    assert torch.equal(got, again)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiny_dptnet_serving_runs_k7_and_k4(dev, compute_dtype):
    from fqss_tpu_torch.models.dptnet import DPTNet
    from fqss_tpu_torch.ops import int8_matmul as im
    from fqss_tpu_torch.ops import lstm
    from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.serve import make_int8_engine
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    arch = dict(n_srcs=2, kernel_size=2, enc_dim=32, feature_dim=16, hidden_dim=32, layer=2, segment_size=40)
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)
    model = DPTNet(q=QuantSpec(max_observations=2, **spec), generator=torch.Generator().manual_seed(0), **arch)
    x = torch.randn(2, 2000, generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    served = DPTNet(q=QuantSpec(observer=False, **spec), **arch)
    served.load_state_dict(model.state_dict())
    cpu = served.eval()
    card = DPTNet(q=QuantSpec(observer=False, **spec), **arch)
    card.load_state_dict(model.state_dict())
    card = card.to(dev).eval()
    n_act = sum(isinstance(m, ActQuantizer) for m in card.modules())
    n_weight = sum(isinstance(m, WeightQuantizer) for m in card.modules())
    fq.reset_launches()
    lstm.reset_launches()
    k8.reset_launches()
    qd.reset_launches()
    qm.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev))
        want = cpu(x)
    assert lstm.LAUNCHES == {"lstm": 0, "bilstm": 4, "lstm_static": 0, "bilstm_static": 0}
    # 4 MHAs x 2 no-op sites; the 4 head grids are applied in K8's epilogue; the 5 QDense layers' act grids in K5,
    # BN's in K3; every weight grid in the one grouped launch. K5: the 5 QDense layers and each MHA's in- and
    # out-projection (its core, both grids off)
    assert fq.LAUNCHES["act"] == n_act - 8 - 4 - 5 - 1 and fq.LAUNCHES["weight"] == 1 < n_weight
    assert qd.LAUNCHES["dense"] == 5 + 2 * 4 and qm.LAUNCHES["qmatmul"] == 1
    assert k8.LAUNCHES["attention"] == 4
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= 20).all()), snr
    with torch.inference_mode():
        assert torch.equal(fold_quantized_weights(card)(x.to(dev)), y)
    im.reset_launches()
    y8 = make_int8_engine(card, compute_dtype=compute_dtype)(x.to(dev)).cpu()
    assert im.LAUNCHES["int8_mm"] == 5 + 4 + 3  # BN, out_conv, 2 gates, mask; 4 out- and 3 in-projections
    want8 = make_int8_engine(cpu, compute_dtype=compute_dtype)(x)
    snr8 = 10 * torch.log10(want8.pow(2).sum(-1) / (want8 - y8).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr8 >= 20).all()), snr8


# Fused attention (K8) against its plain version: the float heads within ATTN_REL_TOL of their largest
# magnitude (sums in another order, an online softmax); on the head grid every value within one step of the
# plain version's, at most ATTN_GRID_SHARE of them a step apart, and each equal to its own float head put
# through the plain grid (chip_smoke.py's phase 24).
ATTN_REL_TOL = 1e-5
ATTN_GRID_SHARE = 1e-3


def _attention_case(dev, bh, lq, lk, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qs = torch.randn(bh, lq, d, device=dev, generator=gen) * 0.3
    k, v = (torch.randn(bh, lk, d, device=dev, generator=gen) for _ in range(2))
    mn, mx = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
    return qs, k, v, mn, mx


@pytest.mark.parametrize("bh,lq,lk,d", [(3, 37, 53, 24), (2176, 250, 250, 32), (40, 34, 34, 32), (7, 300, 40, 16),
                                        (5, 70, 129, 64), (2, 33, 17, 128), (1, 1, 1, 5)])
def test_attention_kernel_matches_plain(dev, bh, lq, lk, d):
    qs, k, v, mn, mx = _attention_case(dev, bh, lq, lk, d, bh + lq + d)
    before = k8.LAUNCHES["attention"]
    heads = k8.fused_attention(qs, k, v, quantize=False)
    got = k8.fused_attention(qs, k, v, mn, mx, 8)
    assert k8.LAUNCHES["attention"] == before + 2
    ref = k8.fused_attention_ref(qs, k, v, quantize=False)
    assert (heads - ref).abs().max().item() <= ATTN_REL_TOL * ref.abs().max().item()
    assert torch.equal(got, fq.act_fake_quant_ref(heads, mn, mx, 8))  # the epilogue is K1's grid, exactly
    step = (mx - mn).item() / 255
    diff = (got - k8.fused_attention_ref(qs, k, v, mn, mx, 8)).abs()
    assert diff.max().item() <= step * (1 + 1e-4)
    assert (diff > 0.5 * step).float().mean().item() <= ATTN_GRID_SHARE


def test_attention_backward_equals_the_plain_gradient(dev):
    qs, k, v, mn, mx = _attention_case(dev, 4, 50, 50, 32, 1)
    g = torch.randn_like(qs)
    grads = []
    for fn in (k8.fused_attention, k8.fused_attention_ref):
        t = [a.clone().requires_grad_(True) for a in (qs, k, v, mn, mx)]
        (fn(*t, 8) * g).sum().backward()
        grads.append([a.grad for a in t])
    for got, want in zip(*grads):  # the same plain composition differentiated at the same saved inputs
        assert torch.equal(got, want)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    qs, k, v, mn, mx = _attention_case(dev, 2, 8, 8, 16, 2)
    with pytest.raises(TypeError):
        k8.fused_attention(qs.double(), k.double(), v.double(), quantize=False)
    with pytest.raises(ValueError):
        k8.fused_attention(qs.transpose(0, 1).contiguous().transpose(0, 1), k, v, quantize=False)
    with pytest.raises(ValueError):
        k8.fused_attention(qs, k.cpu(), v, quantize=False)
    with pytest.raises(ValueError):
        k8.fused_attention(*_attention_case(dev, 1, 4, 4, 129, 3)[:3], quantize=False)


# The packed entry (K8 on the views QMultiheadAttention hands it: q a [B, L, E] viewed [B, L, h, d], k and v the
# E:2E and 2E: thirds of an in-projection [B, L, 3E]) against its plain version, under the same bounds. Where E is
# not a multiple of 4 the rows are off 16 bytes and the kernel copies them 4 bytes at a time.
def _packed_case(dev, B, L, h, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    E = h * d
    Q = torch.randn(B, L, E, device=dev, generator=gen) * 0.3
    X = torch.randn(B, L, 3 * E, device=dev, generator=gen)
    mn, mx = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
    return (Q.unflatten(-1, (h, d)), X[..., E:2 * E].unflatten(-1, (h, d)), X[..., 2 * E:].unflatten(-1, (h, d)), mn,
            mx)


@pytest.mark.parametrize("B,L,h,d", [(272, 250, 8, 32), (2000, 34, 8, 32), (2064, 250, 4, 16), (2000, 258, 4, 16),
                                     (1, 250, 8, 32), (1, 258, 4, 16), (3, 53, 2, 5), (2, 53, 4, 24), (5, 1, 8, 32),
                                     (4, 34, 4, 16), (2, 37, 3, 128), (3, 20, 2, 64), (2, 17, 2, 3), (3, 9, 3, 7)])
def test_packed_attention_kernel_matches_plain(dev, B, L, h, d):
    q, k, v, mn, mx = _packed_case(dev, B, L, h, d, B + L + d)
    before = k8.LAUNCHES["attention"]
    heads = k8.fused_attention_packed(q, k, v, quantize=False)
    got = k8.fused_attention_packed(q, k, v, mn, mx, 8)
    assert k8.LAUNCHES["attention"] == before + 2 and heads.shape == (B, L, h * d)
    ref = k8.fused_attention_packed_ref(q, k, v, quantize=False)
    assert (heads - ref).abs().max().item() <= ATTN_REL_TOL * ref.abs().max().item()
    assert torch.equal(got, fq.act_fake_quant_ref(heads, mn, mx, 8))  # the epilogue is K1's grid, exactly
    step = (mx - mn).item() / 255
    diff = (got - k8.fused_attention_packed_ref(q, k, v, mn, mx, 8)).abs()
    assert diff.max().item() <= step * (1 + 1e-4)
    assert (diff > 0.5 * step).float().mean().item() <= ATTN_GRID_SHARE
    # the same heads as the [BH, L, d] entry on the head-layout copies, bit for bit
    want = k8.fused_attention(*(k8.head_layout(x) for x in (q, k, v)), quantize=False)
    assert torch.equal(heads.reshape(B, L, h, d).transpose(1, 2).reshape(B * h, L, d), want)


def test_packed_attention_takes_rows_off_16_bytes(dev):
    """q, k and v each starting one float past 16 bytes: the kernel's 4-byte copies, the same heads bit for bit."""
    q, k, v, mn, mx = _packed_case(dev, 2, 8, 2, 16, 4)
    shifted = []
    for x in (q, k, v):
        buf = torch.empty(x.numel() + 1, device=dev)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        shifted.append(y)
    assert all(y.data_ptr() % 16 for y in shifted)
    for quantize in (False, True):
        want = k8.fused_attention_packed(q, k, v, mn, mx, 8, quantize)
        assert torch.equal(k8.fused_attention_packed(*shifted, mn, mx, 8, quantize), want)


def test_packed_attention_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, mn, mx = _packed_case(dev, 2, 8, 2, 16, 4)
    with pytest.raises(ValueError, match="unit inner stride"):
        k8.fused_attention_packed(q, torch.randn(2, 8, 2, 32, device=dev)[..., ::2], v, quantize=False)
    with pytest.raises(ValueError):
        k8.fused_attention_packed(q, k.cpu(), v, quantize=False)
    with pytest.raises(TypeError):
        k8.fused_attention_packed(q.double(), k.double(), v.double(), quantize=False)
    with pytest.raises(ValueError, match="head width"):
        k8.fused_attention_packed(*_packed_case(dev, 1, 4, 1, 132, 5)[:3], quantize=False)


def test_attention_widths_are_the_kernel_widths(dev):
    from fqss_tpu_torch.ops import _build

    assert _build.library().fqss_attention_max_dim() == k8.DIMS[-1]


@pytest.mark.parametrize("E,h", [(64, 4), (6, 2), (10, 5)])
def test_attention_module_on_the_card_matches_its_plain_core(dev, monkeypatch, E, h):
    """QMultiheadAttention's serving forward on the card through the packed entry, E a multiple of 4 or not (rows
    off 16 bytes: 4-byte copies), against the same forward with the plain version of the packed entry."""
    from fqss_tpu_torch.nn import attention as port_attention
    from fqss_tpu_torch.nn.attention import QMultiheadAttention
    from fqss_tpu_torch.quant.spec import QuantSpec

    mha = QMultiheadAttention(E, h, q=QuantSpec(qat=True, observer=False, n_splitter=2, n_combiner=2,
                                                out_quant=True), generator=torch.Generator().manual_seed(E))
    mha = mha.to(dev).eval()
    x = torch.randn(3, 21, E, device=dev, generator=torch.Generator(device=dev).manual_seed(h))
    with torch.inference_mode():
        before = k8.LAUNCHES["attention"]
        got = mha(x, x, x)
        assert k8.LAUNCHES["attention"] == before + 1
        monkeypatch.setattr(port_attention, "fused_attention_packed", k8.fused_attention_packed_ref)
        want = mha(x, x, x)
    assert got.shape == want.shape == (3, 21, E) and torch.isfinite(got).all()
    # the heads agree within ATTN_REL_TOL, so their grid, and the output's after the out-projection, at most a step
    step = (mha.activation_fake_quantize.max_range - mha.activation_fake_quantize.min_range).item() / 255
    assert (got - want).abs().max().item() <= step * (1 + 1e-4)
    assert ((got - want).abs() > 0.5 * step).float().mean().item() <= 0.05


def test_attention_module_makes_no_copy_of_the_head_layout(dev):
    """QMultiheadAttention's serving forward on the card: K8 reads the in-projection's views and writes [B, L, E],
    so no copy runs (the head layout's copies and transpose were aten::copy_ calls)."""
    from fqss_tpu_torch.nn.attention import QMultiheadAttention
    from fqss_tpu_torch.quant.spec import QuantSpec

    mha = QMultiheadAttention(64, 4, q=QuantSpec(qat=True, observer=False, n_splitter=2, n_combiner=2,
                                                 out_quant=True), generator=torch.Generator().manual_seed(0))
    mha = mha.to(dev).eval()
    x = torch.randn(3, 40, 64, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        mha(x, x, x)
        before = k8.LAUNCHES["attention"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mha(x, x, x)
    assert k8.LAUNCHES["attention"] == before + 1
    names = [e.name for e in prof.events()]
    assert not [n for n in names if n in ("aten::copy_", "aten::contiguous", "aten::clone")], sorted(set(names))


def test_int8_matmul_kernel_three_grids_bitwise_equal_plain(dev):
    from fqss_tpu_torch.ops import int8_matmul as im

    xs, w, scale, corr = _int8_case(dev, 1000, 256, 768, 5)
    deltas, mns = [2.0**-6, 0.013, 2.0**-5], [-1.0, -2.5, -0.25]
    got = im.int8_matmul_requant(xs, w, scale, corr, 1.0, deltas, mns)
    assert torch.equal(got, im.int8_matmul_requant_ref(xs, w, scale, corr, 1.0, deltas, mns))
    for i in range(3):  # each third on its own grid, as three launches would give
        rows = slice(256 * i, 256 * (i + 1))
        one = im.int8_matmul_requant(xs, w[rows].contiguous(), scale[rows].contiguous(), corr[rows].contiguous(),
                                     1.0, deltas[i], mns[i])
        assert torch.equal(got[:, rows], one)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiny_sepformer_serving_runs_k8_and_k4(dev, compute_dtype):
    from fqss_tpu_torch.models.sepformer import Sepformer
    from fqss_tpu_torch.ops import int8_matmul as im
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.serve import make_int8_engine
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    arch = dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=48,
                n_layers=2)
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)
    model = Sepformer(q=QuantSpec(max_observations=2, **spec), generator=torch.Generator().manual_seed(0), **arch)
    x = torch.randn(2, 1600, generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    cpu = Sepformer(q=QuantSpec(observer=False, **spec), **arch)
    cpu.load_state_dict(model.state_dict())
    cpu.eval()
    card = Sepformer(q=QuantSpec(observer=False, **spec), **arch)
    card.load_state_dict(model.state_dict())
    card = card.to(dev).eval()
    k8.reset_launches()
    qm.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev))
        want = cpu(x)
    assert k8.LAUNCHES["attention"] == 4  # intra and inter, 2 layers each
    assert qm.LAUNCHES["qmatmul"] == 1  # the masker's conv1d
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= 20).all()), snr
    with torch.inference_mode():
        assert torch.equal(fold_quantized_weights(card)(x.to(dev)), y)
    im.reset_launches()
    k8.reset_launches()
    y8 = make_int8_engine(card, compute_dtype=compute_dtype)(x.to(dev)).cpu()
    assert im.LAUNCHES["int8_mm"] == 4 * 4 + 3 and k8.LAUNCHES["attention"] == 0
    want8 = make_int8_engine(cpu, compute_dtype=compute_dtype)(x)
    snr8 = 10 * torch.log10(want8.pow(2).sum(-1) / (want8 - y8).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr8 >= 20).all()), snr8


# The fused QAT dense layer (K5) and its backward (K5-bwd) against their plain versions. The kernel takes each
# product as 3xTF32 on the tensor cores (tests/test_torch_tf32_split.py emulates it), cuBLAS in float32 in its own
# order: the float pre-activations agree within DENSE_RTOL of the sum of the terms' magnitudes (the rounding of a
# K-term float32 sum grows as sqrt(K) ulps of it, about 2e-6 at K = 1024), dx, dw and db likewise, the range
# gradients within SUM_RTOL of sum |term|. On the act grid each output is the kernel's own pre-activation put
# through K1's plain grid exactly, at most one step from the plain version's and at most DENSE_GRID_SHARE of them
# a step apart (a pre-activation within a rounding error of a half step); the planted ties are exact sums, so
# they round alike (chip_smoke.py's phase 31).
DENSE_RTOL = 1e-5
DENSE_GRID_SHARE = 1e-3
GELU_SLOPE = 1.13  # the exact GELU's largest slope (1.1289): |gelu'(v)| <= this


def _dense_case(dev, m, k, n, seed):
    """x [m, k], w [n, k] (~unit-variance products), b, ranges; output channel 0 carries planted ties."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(n, k, device=dev, generator=gen) / k**0.5
    b = torch.randn(n, device=dev, generator=gen) * 0.1
    w_mn, w_mx = w.amin(1, keepdim=True), w.amax(1, keepdim=True)
    a_mn, a_mx = torch.tensor([-1.0], device=dev), torch.tensor([-1.0 + 255 * STEP], device=dev)
    # channel 0: a weight grid of step STEP, w[0, 0] = 5 steps, b[0] half a step above a_mn; rows 0-5 take x[r, 0]
    # alone, r + 1 for r < 5 and 0 for row 5, so pre = a_mn + (5 (r + 1) + 0.5) STEP, a half-step tie, and row 5
    # lands on the tie at the grid's lower bound; row 6 is far past both clip bounds
    w_mn[0], w_mx[0] = -255 / 256, 255 / 256
    w[0, 0], b[0] = 5 * STEP, -1.0 + 0.5 * STEP
    rows = min(m, 6)
    x[:rows] = 0
    x[:rows, 0] = torch.tensor([1.0, 2, 3, 4, 5, 0], device=dev)[:rows]
    if m > 6:
        x[6] = 50.0 * torch.sign(x[6])
    return x, w, b, w_mn, w_mx, a_mn, a_mx


DENSE_SHAPES = [(300, 256, 1024), (257, 1024, 256), (1000, 256, 64), (77, 64, 128), (5, 3, 2), (1, 256, 512),
                (300, 37, 65), (130, 1030, 200)]  # rows of 37 and 1030 floats: not 16-byte aligned
DENSE_FLAGS = [dict(w=True, a=True), dict(w=False, a=True), dict(w=True, a=False), dict(w=False, a=False),
               dict(w=True, a=True, w_obs=True), dict(w=True, a=True, a_obs=True),
               dict(w=True, a=True, w_obs=False, a_obs=False)]


def _dense_args(case, dev, w=True, a=True, w_obs=None, a_obs=None):
    x, wt, b, w_mn, w_mx, a_mn, a_mx = case
    flag = (lambda v: None if v is None else torch.tensor(v, device=dev))
    return (x, wt, b, w_mn if w else None, w_mx if w else None, a_mn if a else None, a_mx if a else None, 8, 8,
            flag(w_obs), flag(a_obs))


@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_qat_dense_kernel_matches_plain(dev, m, k, n):
    case = _dense_case(dev, m, k, n, m + k + n)
    for flags in DENSE_FLAGS:
        args = _dense_args(case, dev, **flags)
        before = qd.LAUNCHES["dense"]
        y = qd.qat_dense(*args)
        pre = qd.qat_dense(*args[:5], None, None, 8, 8, args[9], None)
        assert qd.LAUNCHES["dense"] == before + 2
        x, w, b = args[:3]
        wq = qd._weight_q(w, args[3], args[4], 8, args[9])
        terms = x.abs() @ wq.abs().t() + b.abs()
        assert bool(((pre - qd.qat_dense_ref(*args[:5], None, None, 8, 8, args[9], None)).abs()
                     <= DENSE_RTOL * terms).all()), flags
        if args[5] is None or flags.get("a_obs"):
            assert torch.equal(y, pre), flags
            continue
        assert torch.equal(y, fq.act_fake_quant_ref(pre, args[5], args[6], 8)), flags
        step = (args[6] - args[5]).item() / 255
        diff = (y - qd.qat_dense_ref(*args)).abs()
        assert diff.max().item() <= step * (1 + 1e-4), flags
        assert (diff > 0.5 * step).float().mean().item() <= DENSE_GRID_SHARE, flags


def _assert_dense_grads(got, case_args, g, gelu=False):
    """K5-bwd's gradients against the plain backward at the kernel's own pre-activation (so at the same act
    mask): dx, dw, db within DENSE_RTOL of the sums of their terms' magnitudes, the act ranges' gradients within
    SUM_RTOL of sum |term|, the weight ranges' within twice DENSE_RTOL of the magnitudes through the grid.
    ``gelu``: the GELU route's, |gm| bounded by GELU_SLOPE |g| and the act terms taken at gelu(pre)."""
    x, w, b, w_mn, w_mx, a_mn, a_mx, _, _, w_obs, a_obs = case_args
    pre = qd.qat_dense(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None)  # the mask kernel recomputes it so
    want = qd.qat_dense_bwd_ref(x, w, b, g, w_mn, w_mx, a_mn, a_mx, 8, 8, w_obs, a_obs, pre=pre, gelu=gelu)
    for a, b_ in zip(got, want):
        assert (a is None) == (b_ is None) and (a is None or a.shape == b_.shape)
    dx, dw, db, dw_mn, dw_mx, da_mn, da_mx = got
    wq = qd._weight_q(w, w_mn, w_mx, 8, w_obs)
    absg = g.abs() * (GELU_SLOPE if gelu else 1.0)  # bounds |gm|
    act_in = (lambda v: gelu_ref(v)) if gelu else (lambda v: v)
    assert bool(((dx - want[0]).abs() <= DENSE_RTOL * (absg @ wq.abs())).all())
    a_prod = absg.t() @ x.abs()
    assert bool(((dw - want[1]).abs() <= DENSE_RTOL * a_prod).all())
    assert bool(((db - want[2]).abs() <= DENSE_RTOL * absg.sum(0)).all())
    if a_mn is not None and not (a_obs is not None and bool(a_obs)):
        _, p_mn, p_mx = fq.act_bwd_terms(act_in(pre), g, a_mn, a_mx, 8, 1.0)
        _assert_sum(da_mn, p_mn)
        _assert_sum(da_mx, p_mx)
    if w_mn is not None:
        _, terms = fq.weight_bwd_terms(w, a_prod, w_mn, w_mx, 8, 0)  # |dwq|'s bound through the grid's terms
        bound = fq.route_range_grad(terms.double().abs().sum(1), w_mn.double(), w_mx.double(), 8, 1.0)
        for got_r, want_r, b_r in zip((dw_mn, dw_mx), want[3:5], bound):
            assert bool(((got_r.double() - want_r.double()).abs() <= 2 * DENSE_RTOL * b_r.abs() + 1e-30).all())
    if a_mn is not None:  # the plain version's own pre-activation gives the same mask but at rounding flips
        flips = (fq.act_bwd_terms(act_in(pre), g, a_mn, a_mx, 8, 1.0)[0]
                 != fq.act_bwd_terms(act_in(qd.qat_dense_ref(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None)), g,
                                     a_mn, a_mx, 8, 1.0)[0])
        assert flips.float().mean().item() <= DENSE_GRID_SHARE


@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_qat_dense_backward_matches_plain(dev, m, k, n):
    case = _dense_case(dev, m, k, n, m * k + n)
    g = torch.randn(m, n, device=dev, generator=torch.Generator(device=dev).manual_seed(n))
    for flags in DENSE_FLAGS:
        args = _dense_args(case, dev, **flags)
        before = dict(qd.LAUNCHES), fq.LAUNCHES["weight_bwd"]
        got = qd.qat_dense_bwd(*args[:3], g, *args[3:])
        assert {k_: qd.LAUNCHES[k_] - before[0][k_] for k_ in qd.LAUNCHES} == {
            "dense": 0, "dense_bf16": 0, "dense_gelu": 0, "dense_bf16_gelu": 0, "dense_mask": 1,
            "dense_mask_gelu": 0, "dense_dx": 1, "dense_dwq": 1}
        assert fq.LAUNCHES["weight_bwd"] == before[1] + (args[3] is not None)
        _assert_dense_grads(got, args, g)
        if flags.get("a_obs"):
            assert got[5].item() == got[6].item() == 0.0
        if flags.get("w_obs"):
            assert not got[3].any() and not got[4].any()


def test_qat_dense_autograd_runs_the_kernels(dev):
    case = _dense_case(dev, 600, 256, 128, 5)
    args = _dense_args(case, dev, w_obs=False, a_obs=False)
    g = torch.randn(600, 128, device=dev, generator=torch.Generator(device=dev).manual_seed(6))
    leaves = [t.clone().requires_grad_(True) for t in args[:7]]
    qd.reset_launches()
    (qd.qat_dense(*leaves, *args[7:]) * g).sum().backward()
    assert qd.LAUNCHES == {"dense": 1, "dense_bf16": 0, "dense_gelu": 0, "dense_bf16_gelu": 0, "dense_mask": 1,
                           "dense_mask_gelu": 0, "dense_dx": 1, "dense_dwq": 1}
    _assert_dense_grads([t.grad for t in leaves], args, g)


def _misaligned(t):
    """A contiguous copy of t whose first element lies 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, device=t.device)
    shift = (4 - flat.data_ptr() // 4 % 4 + 1) % 4
    out = flat[shift:shift + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.parametrize("m,k,n", [(300, 256, 1024), (1000, 256, 64), (300, 37, 65), (130, 1030, 200)])
def test_qat_dense_kernels_repeat_bitwise(dev, m, k, n):
    """Two runs of the forward and of the backward are bitwise equal (fixed-order sums, no atomics), and so are
    runs on operands that are not 16-byte aligned (the 4-byte copy path) and on aligned ones (16-byte copies)."""
    case = _dense_case(dev, m, k, n, m + n)
    args = _dense_args(case, dev, w_obs=False, a_obs=False)
    g = torch.randn(m, n, device=dev, generator=torch.Generator(device=dev).manual_seed(k))
    runs = [(qd.qat_dense(*args), qd.qat_dense_bwd(*args[:3], g, *args[3:])) for _ in range(2)]
    odd = (_misaligned(args[0]), _misaligned(args[1]), *args[2:])
    runs.append((qd.qat_dense(*odd), qd.qat_dense_bwd(*odd[:3], _misaligned(g), *odd[3:])))
    for y, grads in runs[1:]:
        assert torch.equal(y, runs[0][0])
        for got, want in zip(grads, runs[0][1]):
            assert (got is None and want is None) or torch.equal(got, want)


def test_qat_dense_mask_pass_recomputes_the_forward_pre_activation(dev):
    """The mask kernel's gm is g times the act mask of the forward kernel's own pre-activation, exactly: the two
    run the same tiles in the same order."""
    m, k, n = 1000, 1030, 200
    x, w, b, w_mn, w_mx, a_mn, a_mx = _dense_case(dev, m, k, n, 3)
    g = torch.randn(m, n, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    pre = qd.qat_dense(x, w, b, w_mn, w_mx)
    gm = qd.mask_pass(x, w, b, g, w_mn, w_mx, a_mn, a_mx, 8, 8, None, None, 1.0)[0]
    assert torch.equal(gm, fq.act_bwd_terms(pre, g, a_mn, a_mx, 8, 1.0)[0])


@pytest.mark.parametrize("b,k,t,n", [(2, 256, 1000, 256), (2, 256, 3000, 64), (3, 37, 301, 65)])
def test_qmatmul_kernel_repeats_bitwise(dev, b, k, t, n):
    x, w, w_mn, w_mx, a_mn, a_mx = _qmatmul_case(dev, b, k, t, n, t)
    y = qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx)
    assert torch.equal(qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx), y)
    assert torch.equal(qm.qmatmul(_misaligned(x), _misaligned(w), w_mn, w_mx, a_mn, a_mx), y)


def test_qat_dense_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w, b, w_mn, w_mx, a_mn, a_mx = _dense_case(dev, 8, 16, 4, 1)
    with pytest.raises(TypeError):
        qd.qat_dense(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        qd.qat_dense(x.t().contiguous().t(), w, b)
    with pytest.raises(ValueError):
        qd.qat_dense(x, w.cpu(), b)
    with pytest.raises(ValueError):
        qd.qat_dense(x, w, b, a_mn=a_mn, a_mx=a_mx, a_observing=torch.tensor([1, 2], device=dev) > 0)


def _tiny_models(name):
    from fqss_tpu_torch.models.dptnet import DPTNet
    from fqss_tpu_torch.models.sepformer import Sepformer
    from fqss_tpu_torch.quant.spec import QuantSpec

    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=1)
    if name == "DPTNet":
        cls, arch = DPTNet, dict(n_srcs=2, kernel_size=2, enc_dim=32, feature_dim=16, hidden_dim=32, layer=2,
                                 segment_size=40)
    else:
        cls, arch = Sepformer, dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4,
                                    chunk_size=20, n_ffn=48, n_layers=2)
    model = cls(q=QuantSpec(**spec), generator=torch.Generator().manual_seed(0), **arch)
    teacher = cls(generator=torch.Generator().manual_seed(1), **arch).requires_grad_(False).eval()
    return model, teacher


# A tiny model's KD step, card against CPU (test_tiny_train_step_card_vs_cpu): (|loss difference| in dB, minimum
# whole-gradient cosine). The observing step runs no grid, so the two differ by float32 sums in another order
# alone. The quantizing step adds the grids' tie flips, which on a tiny random-weight model with a one-step
# observer move the loss most: the Sepformer read 0.154 dB on an H100 (the ConvTasNet of phase 10, full width,
# 0.003-0.008 dB).
TINY_TRAIN_CARD_VS_CPU = {"observing": (1e-3, 0.9999), "quantizing": (0.5, 0.99)}


def _two_kd_steps(model, teacher, src, device, scale: float = 1.0) -> list[tuple]:
    """The observing and then a quantizing KD step of copies of ``model`` and ``teacher`` on ``device`` (the
    mixture times ``scale``): per step the loss, the clipped gradient, and K5's and the LSTM kernels' launches."""
    import copy

    from fqss_tpu_torch.ops import lstm
    from fqss_tpu_torch.train.state import TrainState
    from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    m, t = copy.deepcopy(model).to(device), copy.deepcopy(teacher).to(device)
    state = TrainState(m, make_optimizer(TrainConfig(), [p for p in m.parameters() if p.requires_grad]), t)
    step = make_train_step(TrainConfig())
    out = []
    for _ in range(2):
        for mod in (qd, lstm):
            mod.reset_launches()
        metrics = step(state, (src.sum(1) * scale).to(device), src.to(device))
        grads = torch.cat([p.grad.flatten().double().cpu() for p in m.parameters() if p.grad is not None])
        out.append((float(metrics["loss"]), grads, dict(qd.LAUNCHES), dict(lstm.LAUNCHES)))
    return out


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def _tiny_step_witnesses(dev, model, teacher, src, card: list, cpu: list) -> str:
    """Where the tiny step misses its rule, what else the card gives for the same step (quantizing step): the card
    against itself on the mixture times 1 + 2^-22 (its own floor), and the card with the attentions' projections
    on ``torch.matmul`` (cuBLAS, as before they moved onto K5's core) against the CPU."""
    from unittest import mock

    from fqss_tpu_torch.nn.attention import QMultiheadAttention

    def matmul_project(self, x, w, b):
        y = torch.matmul(x, w.t())
        return y if b is None else y + b

    own = _two_kd_steps(model, teacher, src, dev, 1.0 + 2.0**-22)
    with mock.patch.object(QMultiheadAttention, "_project", matmul_project):
        cublas = _two_kd_steps(model, teacher, src, dev)
    return (f"witnesses, quantizing step: card vs card x (1 + 2^-22) |dloss| {abs(card[1][0] - own[1][0]):.4f} dB "
            f"cos {_cosine(card[1][1], own[1][1]):.6f}; card with the projections on torch.matmul vs CPU |dloss| "
            f"{abs(cublas[1][0] - cpu[1][0]):.4f} dB cos {_cosine(cublas[1][1], cpu[1][1]):.6f}")


@pytest.mark.parametrize("name", ["DPTNet", "Sepformer"])
def test_tiny_train_step_card_vs_cpu(dev, name):
    """Two KD steps (the observing one, then a quantizing one) on the card and on the CPU from the same state:
    the kernels launch once per module, the loss and the clipped gradients agree within TINY_TRAIN_CARD_VS_CPU.
    Where they do not, the failure carries the witnesses of :func:`_tiny_step_witnesses`."""
    from fqss_tpu_torch.nn.attention import QMultiheadAttention
    from fqss_tpu_torch.nn.layers import QDense

    model, teacher = _tiny_models(name)
    src = torch.randn(2, 2, 1600, generator=torch.Generator().manual_seed(2)) * 0.3
    # K5 per QDense layer and per self-attention's in- and out-projection (its core, both grids off)
    n_dense = sum(isinstance(m, QDense) for m in model.modules()) + 2 * sum(
        isinstance(m, QMultiheadAttention) for m in model.modules())
    runs = [_two_kd_steps(model, teacher, src, device) for device in (dev, torch.device("cpu"))]
    missed = []
    for step, (loss_card, g_card, dense, rec), (loss_cpu, g_cpu, cpu_dense, _) in zip(TINY_TRAIN_CARD_VS_CPU, *runs):
        assert dense == {"dense": 2 * n_dense, "dense_bf16": 0, "dense_gelu": 0, "dense_bf16_gelu": 0,
                         "dense_mask": n_dense, "dense_mask_gelu": 0, "dense_dx": n_dense, "dense_dwq": n_dense}
        assert set(cpu_dense.values()) == {0}
        if name == "DPTNet":
            assert rec == {"lstm": 0, "bilstm": 2 * 4, "lstm_static": 0, "bilstm_static": 0}  # student and teacher, 2 layers x row and col each
        cos = _cosine(g_card, g_cpu)
        loss_tol, cos_min = TINY_TRAIN_CARD_VS_CPU[step]
        if not (abs(loss_card - loss_cpu) <= loss_tol and cos >= cos_min):
            missed.append((step, loss_card, loss_cpu, cos))
    if missed:
        raise AssertionError(f"{missed}; {_tiny_step_witnesses(dev, model, teacher, src, *runs)}")


# The fused fake-quant matmul (K3) against its plain version (chip_smoke.py's phase 37): the float products within
# DENSE_RTOL of the sum of the terms' magnitudes, each quantized output its own float output on K1's plain grid, at
# most one step from the plain version's and at most DENSE_GRID_SHARE of them a step apart; the planted ties and
# clip extremes exactly. Shapes (B, K, T, N): DPTNet's BN (256 -> 64, 64-row tiles) and the Sepformer masker's
# conv1d (256 -> 256) at short T, ragged tiles on every axis, a single column.
QMM_SHAPES = [(2, 256, 3000, 64), (2, 256, 1000, 256), (3, 37, 301, 65), (1, 5, 7, 3), (2, 256, 1, 64),
              (2, 1030, 203, 96)]


def _qmatmul_case(dev, b, k, t, n, seed):
    """x [B, K, T], w [N, K], ranges; output channel 0 carries planted ties (time steps 0-5) and clips (step 6)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, k, t, device=dev, generator=gen)
    w = torch.randn(n, k, device=dev, generator=gen) / k**0.5
    w_mn, w_mx = w.amin(1), w.amax(1)
    a_mn = torch.tensor([-128.5 * STEP], device=dev)
    a_mx = a_mn + 255 * STEP
    # channel 0: weight step STEP, w[0, 0] = 5 steps, so y[0, 0, t] = 5 (t + 1) steps, a half-step tie of the act
    # grid (whose mn is half a step off zero); step 5 takes 0, step 6 clips every channel
    w_mn[0], w_mx[0] = -255 / 256, 255 / 256
    w[0] = 0.0
    w[0, 0] = 5 * STEP
    steps = min(t, 6)
    x[0, 0, :steps] = torch.tensor([1.0, 2, 3, 4, 5, 0], device=dev)[:steps]
    if t > 6:
        x[0, :, 6] = 100.0 * torch.sign(w[min(1, n - 1)])
    return x, w, w_mn, w_mx, a_mn, a_mx


@pytest.mark.parametrize("b,k,t,n", QMM_SHAPES)
def test_qmatmul_kernel_matches_plain(dev, b, k, t, n):
    x, w, w_mn, w_mx, a_mn, a_mx = _qmatmul_case(dev, b, k, t, n, b + k + t + n)
    for flags in DENSE_FLAGS:
        flag = (lambda v: None if v is None else torch.tensor(v, device=dev))
        wr = (w_mn, w_mx) if flags["w"] else (None, None)
        ar = (a_mn, a_mx) if flags["a"] else (None, None)
        w_obs, a_obs = flag(flags.get("w_obs")), flag(flags.get("a_obs"))
        before = qm.LAUNCHES["qmatmul"]
        y = qm.qmatmul(x, w, *wr, *ar, 8, 8, w_obs, a_obs)
        pre = qm.qmatmul(x, w, *wr, None, None, 8, 8, w_obs, None)
        assert qm.LAUNCHES["qmatmul"] == before + 2
        terms = qd._weight_q(w, *wr, 8, w_obs).abs() @ x.abs()
        assert bool(((pre - qm.qmatmul_ref(x, w, *wr, None, None, 8, 8, w_obs, None)).abs()
                     <= DENSE_RTOL * terms).all()), flags
        if ar[0] is None or flags.get("a_obs"):
            assert torch.equal(y, pre), flags
            continue
        assert torch.equal(y, fq.act_fake_quant_ref(pre, a_mn, a_mx, 8)), flags
        diff = (y - qm.qmatmul_ref(x, w, *wr, *ar, 8, 8, w_obs, a_obs)).abs()
        assert diff.max().item() <= STEP * (1 + 1e-4), flags
        assert (diff > 0.5 * STEP).float().mean().item() <= DENSE_GRID_SHARE, flags
        ref = qm.qmatmul_ref(x, w, *wr, *ar, 8, 8, w_obs, a_obs)
        assert torch.equal(y[0, 0, : min(t, 7)], ref[0, 0, : min(t, 7)]), flags  # ties and clips exactly


def test_qmatmul_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w, w_mn, w_mx, a_mn, a_mx = _qmatmul_case(dev, 2, 16, 9, 4, 1)
    with pytest.raises(TypeError):
        qm.qmatmul(x.double(), w.double())
    with pytest.raises(ValueError):
        qm.qmatmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):
        qm.qmatmul(x, w.cpu())
    with pytest.raises(ValueError):
        qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx, a_observing=torch.tensor([1, 2], device=dev) > 0)
    with pytest.raises(ValueError, match="forward only"):
        qm.qmatmul(x.clone().requires_grad_(), w)



# The bf16 routes (QuantSpec.compute_dtype "bfloat16") of K5, K3 and K8 against their plain versions: K5's and K3's
# by the float32 routes' rules, the sums of the terms' magnitudes taken over the operands rounded to bf16 (the planted
# ties are bf16 values, so they stay exact); K8's by chip_smoke.py's phase 43 rule: every row within ATTN_REL_TOL of
# max |heads|, a row with a softmax weight within ATTN_BF16_TIE_ULPS float32 ulps of a bf16 tie also within one
# bf16 step (2^-7 p) of p |v| over such weights.
ATTN_BF16_TIE_ULPS = 2


@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_qat_dense_bf16_route_matches_plain(dev, m, k, n):
    case = _dense_case(dev, m, k, n, m + k + n)
    for flags in DENSE_FLAGS:
        args = _dense_args(case, dev, **flags)
        before = dict(qd.LAUNCHES)
        y = qd.qat_dense(*args, bf16=True)
        pre = qd.qat_dense(*args[:5], None, None, 8, 8, args[9], None, bf16=True)
        assert qd.LAUNCHES == {**before, "dense_bf16": before["dense_bf16"] + 2}
        xr, wq = qd.operands(args[0], qd._weight_q(args[1], args[3], args[4], 8, args[9]), True)
        terms = xr.abs() @ wq.abs().t() + args[2].abs()
        plain = qd.qat_dense_ref(*args[:5], None, None, 8, 8, args[9], None, bf16=True)
        assert bool(((pre - plain).abs() <= DENSE_RTOL * terms).all()), flags
        if args[5] is None or flags.get("a_obs"):
            assert torch.equal(y, pre), flags
            continue
        assert torch.equal(y, fq.act_fake_quant_ref(pre, args[5], args[6], 8)), flags
        step = (args[6] - args[5]).item() / 255
        diff = (y - qd.qat_dense_ref(*args, bf16=True)).abs()
        assert diff.max().item() <= step * (1 + 1e-4), flags
        assert (diff > 0.5 * step).float().mean().item() <= DENSE_GRID_SHARE, flags
        assert torch.equal(y[: min(m, 7), 0], qd.qat_dense_ref(*args, bf16=True)[: min(m, 7), 0]), flags


@pytest.mark.parametrize("b,k,t,n", QMM_SHAPES)
def test_qmatmul_bf16_route_matches_plain(dev, b, k, t, n):
    x, w, w_mn, w_mx, a_mn, a_mx = _qmatmul_case(dev, b, k, t, n, b + k + t + n)
    for flags in DENSE_FLAGS:
        flag = (lambda v: None if v is None else torch.tensor(v, device=dev))
        wr = (w_mn, w_mx) if flags["w"] else (None, None)
        ar = (a_mn, a_mx) if flags["a"] else (None, None)
        w_obs, a_obs = flag(flags.get("w_obs")), flag(flags.get("a_obs"))
        before = dict(qm.LAUNCHES)
        y = qm.qmatmul(x, w, *wr, *ar, 8, 8, w_obs, a_obs, bf16=True)
        pre = qm.qmatmul(x, w, *wr, None, None, 8, 8, w_obs, None, bf16=True)
        assert qm.LAUNCHES == {**before, "qmatmul_bf16": before["qmatmul_bf16"] + 2}
        xr, wq = qd.operands(x, qd._weight_q(w, *wr, 8, w_obs), True)
        terms = wq.abs() @ xr.abs()
        assert bool(((pre - qm.qmatmul_ref(x, w, *wr, None, None, 8, 8, w_obs, None, bf16=True)).abs()
                     <= DENSE_RTOL * terms).all()), flags
        if ar[0] is None or flags.get("a_obs"):
            assert torch.equal(y, pre), flags
            continue
        assert torch.equal(y, fq.act_fake_quant_ref(pre, a_mn, a_mx, 8)), flags
        ref = qm.qmatmul_ref(x, w, *wr, *ar, 8, 8, w_obs, a_obs, bf16=True)
        diff = (y - ref).abs()
        assert diff.max().item() <= STEP * (1 + 1e-4), flags
        assert (diff > 0.5 * STEP).float().mean().item() <= DENSE_GRID_SHARE, flags
        assert torch.equal(y[0, 0, : min(t, 7)], ref[0, 0, : min(t, 7)]), flags


def _assert_bf16_heads(heads, qs, k, v):
    """K8's bf16 float heads against the plain version's by the tie rule above."""
    ref = k8.fused_attention_ref(qs, k, v, quantize=False, bf16=True)
    p = k8.softmax_ref(torch.matmul(qd.bf16_round(qs), qd.bf16_round(k).transpose(-1, -2)))
    near = k8.bf16_tie_mask(p, ATTN_BF16_TIE_ULPS)
    slack = 2.0**-7 * torch.matmul(qd.bf16_round(p) * near, qd.bf16_round(v).abs())
    assert bool(((heads - ref).abs() <= ATTN_REL_TOL * ref.abs().max() + slack).all())
    return ref


@pytest.mark.parametrize("bh,lq,lk,d", [(3, 37, 53, 24), (2176, 250, 250, 32), (40, 34, 34, 32), (7, 300, 40, 16),
                                        (5, 70, 129, 64), (2, 33, 17, 128), (1, 1, 1, 5)])
def test_attention_bf16_route_matches_plain(dev, bh, lq, lk, d):
    qs, k, v, mn, mx = _attention_case(dev, bh, lq, lk, d, bh + lq + d)
    qs[:, 0] *= 100.0  # logits far past expf's range
    before = dict(k8.LAUNCHES)
    heads = k8.fused_attention(qs, k, v, quantize=False, bf16=True)
    got = k8.fused_attention(qs, k, v, mn, mx, 8, bf16=True)
    assert k8.LAUNCHES == {**before, "attention_bf16": before["attention_bf16"] + 2}
    _assert_bf16_heads(heads, qs, k, v)
    assert torch.equal(got, fq.act_fake_quant_ref(heads, mn, mx, 8))
    step = (mx - mn).item() / 255
    diff = (got - k8.fused_attention_ref(qs, k, v, mn, mx, 8, bf16=True)).abs()
    assert diff.max().item() <= step * (1 + 1e-4)
    assert (diff > 0.5 * step).float().mean().item() <= ATTN_GRID_SHARE


@pytest.mark.parametrize("B,L,h,d", [(272, 250, 8, 32), (2000, 34, 8, 32), (2064, 250, 4, 16), (3, 9, 2, 5)])
def test_packed_attention_bf16_route_equals_the_contiguous_entry(dev, B, L, h, d):
    qs, k, v, mn, mx = _attention_case(dev, B * h, L, L, d, B + L)
    E = h * d
    X = torch.randn(B, L, 3 * E, device=dev)  # an in-projection: K and V its thirds, Q its own [B, L, E]
    X[..., E:2 * E] = k.reshape(B, h, L, d).transpose(1, 2).reshape(B, L, E)
    X[..., 2 * E:] = v.reshape(B, h, L, d).transpose(1, 2).reshape(B, L, E)
    Q = qs.reshape(B, h, L, d).transpose(1, 2).reshape(B, L, E).contiguous()
    packed = k8.fused_attention_packed(Q.unflatten(-1, (h, d)), X[..., E:2 * E].unflatten(-1, (h, d)),
                                       X[..., 2 * E:].unflatten(-1, (h, d)), mn, mx, 8, bf16=True)
    want = k8.fused_attention(qs, k, v, mn, mx, 8, bf16=True)
    assert torch.equal(packed.reshape(B, L, h, d).transpose(1, 2).reshape(B * h, L, d), want)


def test_bf16_routes_refuse_a_gradient_on_the_card(dev):
    x = torch.randn(4, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bf16 training"):
        qd.qat_dense(x, torch.ones(3, 16, device=dev), torch.zeros(3, device=dev), bf16=True)
    with pytest.raises(NotImplementedError, match="bf16 training"):
        k8.fused_attention(x[None], x[None].detach(), x[None].detach(), quantize=False, bf16=True)


@pytest.mark.parametrize("name", ["DPTNet", "Sepformer"])
def test_tiny_bf16_model_runs_the_bf16_routes(dev, name):
    """A tiny bf16 model on the card: K5, K3 and K8 on their bf16 routes only, card vs CPU >= 20 dB, folded bitwise
    equal to fake_quant."""
    import dataclasses

    from fqss_tpu_torch.models.factory import create_model
    from fqss_tpu_torch.serve.fold import fold_quantized_weights
    from fqss_tpu_torch.quant.spec import QuantSpec

    cfg = {"name": name, "n_src": 2, "kernel_size": 2 if name == "DPTNet" else 8, "stride": 4}
    cfg.update(dict(enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20) if name == "DPTNet" else
               dict(n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=48, n_layers=1))
    spec = QuantSpec(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)
    model = create_model(cfg, spec, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 1600, generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    bf16 = dataclasses.replace(spec, observer=False, compute_dtype="bfloat16")
    cpu, card = create_model(cfg, bf16), create_model(cfg, bf16)
    for m in (cpu, card):
        m.load_state_dict(model.state_dict())
        m.eval()
    card = card.to(dev)
    with torch.inference_mode():
        want = cpu(x)
    for module in (qd, qm, k8):
        module.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev))
    assert qd.LAUNCHES["dense"] == qm.LAUNCHES["qmatmul"] == k8.LAUNCHES["attention"] == 0
    assert qd.LAUNCHES["dense_bf16"] > 0 and qm.LAUNCHES["qmatmul_bf16"] == 1 and k8.LAUNCHES["attention_bf16"] > 0
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= 20).all()), snr
    with torch.inference_mode():
        assert torch.equal(fold_quantized_weights(card)(x.to(dev)), y)


# A tiny ConvTasNet-music (n_filters 16, bn 8, hid 16, 2 blocks x 1 repeat, stereo, 4 stems), calibrated by a
# 2-step observer window on the CPU, then served and trained on the card against the same model on the CPU.
MUSIC_CFG = {"name": "ConvTasNetMusic", "sources": ["drums", "bass", "other", "vocals"], "audio_channels": 2,
             "kernel_size": 20, "stride": 10, "n_filters": 16, "bn_chan": 8, "hid_chan": 16, "n_blocks": 2,
             "n_repeats": 1}
MUSIC_SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)


def _tiny_music(observer=False):
    import numpy as np

    from fqss_tpu_torch.data.synthetic import synth_music_batch
    from fqss_tpu_torch.models.factory import create_model
    from fqss_tpu_torch.quant.spec import QuantSpec

    model = create_model(MUSIC_CFG, QuantSpec(**MUSIC_SPEC), generator=torch.Generator().manual_seed(0))
    stems = synth_music_batch(np.random.default_rng(0), 2, 4000)
    x = torch.from_numpy(stems.sum(axis=1))
    with torch.no_grad():
        for _ in range(2):
            model.train()(x)
    served = create_model(MUSIC_CFG, QuantSpec(observer=observer, **MUSIC_SPEC))
    served.load_state_dict(model.state_dict())
    return served.eval(), x, torch.from_numpy(stems)


def test_tiny_music_serving_launches_and_agrees_with_the_cpu(dev):
    """Fake-quant: K1 per act quantizer but the 3 K3 convs' (bottleneck, 2 pointwise), one grouped weight launch,
    K3 3; card vs CPU >= 20 dB; folded bitwise equal with no weight launch."""
    import copy

    from fqss_tpu_torch.quant.quantizers import ActQuantizer
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    cpu, x, _ = _tiny_music()
    card = copy.deepcopy(cpu).to(dev)
    n_act = sum(isinstance(m, ActQuantizer) for m in cpu.modules())
    for module in (fq, qm):
        module.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev))
        want = cpu(x)
    assert fq.LAUNCHES == {"act": n_act - 3, "weight": 1, "act_bwd": 0, "weight_bwd": 0}
    assert qm.LAUNCHES == {"qmatmul": 3, "qmatmul_bf16": 0}
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert y.shape == (2, 4, 2, 4000) and bool((snr >= 20).all()), snr
    folded = fold_quantized_weights(card)  # the fold quantizes each weight once, with the per-tensor kernel
    fq.reset_launches()
    with torch.inference_mode():
        assert torch.equal(folded(x.to(dev)), y)
    assert fq.LAUNCHES["weight"] == 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiny_music_int8_engine_runs_k4_and_agrees_with_the_cpu(dev, compute_dtype):
    import copy

    from fqss_tpu_torch.ops import int8_matmul as im
    from fqss_tpu_torch.serve import make_int8_engine

    cpu, x, _ = _tiny_music()
    want = make_int8_engine(cpu, compute_dtype=compute_dtype)(x)
    engine = make_int8_engine(copy.deepcopy(cpu).to(dev), compute_dtype=compute_dtype)
    im.reset_launches()
    fq.reset_launches()
    got = engine(x.to(dev)).cpu()
    assert im.LAUNCHES["int8_mm"] == 1 + 2 * 2 + 1 + 1  # bottleneck, 2 x (conv1x1, pointwise), mask conv, decoder
    assert set(fq.LAUNCHES.values()) == {0}
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - got).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= INT8_CARD_VS_CPU_DB[compute_dtype]).all()), snr


def test_tiny_music_kd_step_card_vs_cpu(dev):
    """Two tasnet KD steps (augmented, the same draws on both devices: the observing one, then a quantizing one):
    every act quantizer's K1 and K1-bwd, one grouped K2 and K2-bwd, K3 for the teacher's 3 1x1 convs; loss and
    clipped gradients within TINY_TRAIN_CARD_VS_CPU."""
    import copy
    import math

    from fqss_tpu_torch.models.factory import create_model
    from fqss_tpu_torch.quant.quantizers import ActQuantizer
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.train.recipes_music import make_music_train_step
    from fqss_tpu_torch.train.state import TrainState
    from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer

    _, _, stems = _tiny_music()
    model = create_model(MUSIC_CFG, QuantSpec(observer=True, **{**MUSIC_SPEC, "max_observations": 1}),
                         generator=torch.Generator().manual_seed(3))
    teacher = create_model(MUSIC_CFG, QuantSpec(), generator=torch.Generator().manual_seed(4)).requires_grad_(False)
    n_act = sum(isinstance(m, ActQuantizer) for m in model.modules())
    step = make_music_train_step(TrainConfig(lr=3e-4), {"enable": True, "shift": 95, "remix_group_size": 0})
    runs = []
    for device in (dev, torch.device("cpu")):
        m, t = copy.deepcopy(model).to(device), copy.deepcopy(teacher).to(device).eval()
        state = TrainState(m, make_optimizer(TrainConfig(lr=3e-4), list(m.parameters())), t)
        gen = torch.Generator().manual_seed(5)
        out = []
        for _ in range(2):
            fq.reset_launches()
            qm.reset_launches()
            metrics = step(state, stems.to(device), gen)
            grads = torch.cat([p.grad.flatten().double().cpu() for p in m.parameters() if p.grad is not None])
            out.append((float(metrics["loss"]), grads, dict(fq.LAUNCHES), dict(qm.LAUNCHES)))
        runs.append(out)
    for phase, (loss_card, g_card, launches, k3), (loss_cpu, g_cpu, *_) in zip(TINY_TRAIN_CARD_VS_CPU, *runs):
        assert launches == {"act": n_act, "weight": 1, "act_bwd": n_act, "weight_bwd": 1}
        assert k3 == {"qmatmul": 3, "qmatmul_bf16": 0}
        cos = float(g_card @ g_cpu / (g_card.norm() * g_cpu.norm()))
        loss_tol, cos_min = TINY_TRAIN_CARD_VS_CPU[phase]
        db = abs(10 * math.log10(loss_card / loss_cpu))  # the L1 losses' ratio in dB, as the speech losses
        assert db <= loss_tol and cos >= cos_min, (phase, loss_card, loss_cpu, cos)


# HTDemucs: the GELU routes of K5 and K4, K8 at head width 48 with Lq != Lk, and a tiny HTDemucs (JAX's TINY test
# configuration) calibrated on the CPU, then served on the card against the same model on the CPU.
HTD_CFG = {"name": "HTDemucs", "sources": ["drums", "bass", "other", "vocals"], "audio_channels": 2, "channels": 8,
           "nfft": 512, "t_layers": 3, "t_heads": 4, "segment": 0.5, "samplerate": 8000}


@pytest.mark.parametrize("m,k,n", [(700, 64, 256), (1000, 384, 1536), (33, 37, 65)])
@pytest.mark.parametrize("bf16", [False, True])
def test_qat_dense_gelu_route_matches_plain(dev, m, k, n, bf16):
    """K5's GELU route: the pre-grid value within 1e-5 x 1.13 of sum |term| (the GELU's largest slope), on the act
    grid the kernel's own post-GELU value on K1's grid, at most 0.1% of outputs a step from the plain version."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    x, w = torch.randn(m, k, device=dev, generator=g), torch.randn(n, k, device=dev, generator=g) / k**0.5
    b = torch.randn(n, device=dev, generator=g) * 0.1
    mn, mx = torch.tensor([-0.2], device=dev), torch.tensor([-0.2 + 255 * STEP], device=dev)
    qd.reset_launches()
    pre = qd.qat_dense(x, w, b, gelu=True, bf16=bf16)
    y = qd.qat_dense(x, w, b, a_mn=mn, a_mx=mx, gelu=True, bf16=bf16)
    assert qd.LAUNCHES["dense_bf16_gelu" if bf16 else "dense_gelu"] == 2 and qd.LAUNCHES["dense"] == 0
    xr, wr = qd.operands(x, w, bf16)
    bound = (xr.abs() @ wr.abs().t() + b.abs()) * 1.13
    plain = qd.qat_dense_ref(x, w, b, gelu=True, bf16=bf16)
    assert float(((pre - plain).abs() / bound).max()) <= 1e-5
    assert torch.equal(y, fq.act_fake_quant_ref(pre, mn, mx, 8))
    diff = (y - qd.qat_dense_ref(x, w, b, a_mn=mn, a_mx=mx, gelu=True, bf16=bf16)).abs()
    assert float(diff.max()) <= STEP * (1 + 1e-4) and float((diff > 0.5 * STEP).float().mean()) <= 1e-3


@pytest.mark.parametrize("m,k,n", [(1000, 384, 1536), (77, 64, 256), (33, 40, 24)])
def test_int8_gelu_epilogue_bitwise_equals_plain(dev, m, k, n):
    from fqss_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(m)
    xs = torch.randint(-128, 128, (m, k), device=dev, dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (n, k), device=dev, dtype=torch.int8, generator=g)
    scale = torch.rand(n, device=dev, generator=g) * 2e-4 + 1e-5
    corr = torch.randn(n, device=dev, generator=g) * 0.3
    im.reset_launches()
    got = im.int8_matmul_requant(xs, w, scale, corr, 1.0, 3.0 / 255, -0.4, nl="gelu")
    assert im.LAUNCHES["int8_mm"] == 1 and im.GELU_LAUNCHES["int8_mm"] == 1
    assert torch.equal(got, im.int8_matmul_requant_ref(xs, w, scale, corr, 1.0, 3.0 / 255, -0.4, nl="gelu"))


@pytest.mark.parametrize("lq,lk", [(344, 344), (344, 173), (173, 344)])
@pytest.mark.parametrize("bf16", [False, True])
def test_attention_at_head_width_48_self_and_cross(dev, lq, lk, bf16):
    """K8 at d 48 (the D 64 instantiation) through the packed entry, Lq != Lk for cross-attention: float heads within
    1e-5 of their magnitude (bf16: one bf16 step of p |v| more), bitwise equal to the [BH, L, d] entry."""
    g = torch.Generator(device=dev).manual_seed(lq * lk)
    q = torch.randn(2, lq, 8, 48, device=dev, generator=g) * 0.15
    k, v = (torch.randn(2, lk, 8, 48, device=dev, generator=g) for _ in range(2))
    k8.reset_launches()
    got = k8.fused_attention_packed(q, k, v, quantize=False, bf16=bf16)
    assert k8.LAUNCHES["attention_bf16" if bf16 else "attention"] == 1
    ref = k8.fused_attention_packed_ref(q, k, v, quantize=False, bf16=bf16)
    tol = 1e-5 * float(ref.abs().max()) + (2.0**-7 * float(v.abs().max()) if bf16 else 0.0)
    assert float((got - ref).abs().max()) <= tol
    heads = k8.fused_attention(k8.head_layout(q), k8.head_layout(k), k8.head_layout(v), quantize=False, bf16=bf16)
    assert torch.equal(got, heads.reshape(2, 8, lq, 48).transpose(1, 2).reshape(2, lq, 384))


def _tiny_htdemucs():
    import numpy as np

    from fqss_tpu_torch.data.synthetic import synth_music_batch
    from fqss_tpu_torch.models.factory import create_model
    from fqss_tpu_torch.quant.spec import QuantSpec

    model = create_model(HTD_CFG, QuantSpec(**MUSIC_SPEC), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(synth_music_batch(np.random.default_rng(0), 2, 4000).sum(axis=1))
    with torch.no_grad():
        for _ in range(3):
            model.train()(x)
    served = create_model(HTD_CFG, QuantSpec(observer=False, **MUSIC_SPEC))
    served.load_state_dict(model.state_dict())
    return served.eval(), x[..., :3500]


def test_tiny_htdemucs_serving_launches_and_agrees_with_the_cpu(dev):
    """Fake-quant with train=False: K1 per act quantizer but the 12 QDense layers' and the 6 attentions' three
    sites each, one grouped weight launch, K5 6 + 6 on the GELU route, K8 6; card vs CPU >= 20 dB; folded bitwise
    equal with no weight launch."""
    import copy

    from fqss_tpu_torch.quant.quantizers import ActQuantizer
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    cpu, x = _tiny_htdemucs()
    card = copy.deepcopy(cpu).to(dev)
    n_act = sum(isinstance(m, ActQuantizer) for m in cpu.modules())
    for module in (fq, qd, k8):
        module.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev), train=False)
        want = cpu(x, train=False)
    assert fq.LAUNCHES == {"act": n_act - 12 - 3 * 6, "weight": 1, "act_bwd": 0, "weight_bwd": 0}
    # K5: 6 linear2 and the attentions' projections (4 self: in and out; 2 cross: query, key and out)
    assert (qd.LAUNCHES["dense"], qd.LAUNCHES["dense_gelu"], k8.LAUNCHES["attention"]) == (6 + 4 * 2 + 2 * 3, 6, 6)
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert y.shape == (2, 4, 2, 3500) and bool((snr >= 20).all()), snr
    folded = fold_quantized_weights(card)
    fq.reset_launches()
    with torch.inference_mode():
        assert torch.equal(folded(x.to(dev), train=False), y)
    assert fq.LAUNCHES["weight"] == 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tiny_htdemucs_int8_engine_runs_k4_and_k8_and_agrees_with_the_cpu(dev, compute_dtype):
    """26 K4 launches (3 layers: self, cross, self pairs), 6 of them with the GELU epilogue, K8 6 on the compute
    dtype's route, no K5; card vs CPU >= 20 dB (the float conv branches flip requantization ties as the fake-quant
    forward's do)."""
    import copy

    from fqss_tpu_torch.ops import int8_matmul as im
    from fqss_tpu_torch.serve import make_int8_engine

    cpu, x = _tiny_htdemucs()
    want = make_int8_engine(cpu, compute_dtype=compute_dtype)(x, train=False)
    engine = make_int8_engine(copy.deepcopy(cpu).to(dev), compute_dtype=compute_dtype)
    for module in (im, qd, k8):
        module.reset_launches()
    got = engine(x.to(dev), train=False).cpu()
    assert (im.LAUNCHES["int8_mm"], im.GELU_LAUNCHES["int8_mm"]) == (26, 6)
    assert k8.LAUNCHES["attention_bf16" if compute_dtype == "bfloat16" else "attention"] == 6
    assert set(qd.LAUNCHES.values()) == {0}
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - got).pow(2).sum(-1).clamp_min(1e-30))
    assert bool((snr >= 20).all()), snr


@pytest.mark.parametrize("m,k,n", [(1000, 384, 1536), (700, 64, 256), (300, 37, 65), (5, 3, 2)])
def test_qat_dense_gelu_backward_matches_plain(dev, m, k, n):
    """K5-bwd's GELU route (its mask pass, then dx, dwq and K2-bwd) against the plain backward at the kernel's own
    pre-activation, every grid and observing-flag combination: inside the act window and with the act grid off
    ``gm = g gelu'(pre)``, not ``g``."""
    case = _dense_case(dev, m, k, n, m + 2 * k + n)
    g = torch.randn(m, n, device=dev, generator=torch.Generator(device=dev).manual_seed(m + n))
    for flags in DENSE_FLAGS:
        args = _dense_args(case, dev, **flags)
        before = dict(qd.LAUNCHES)
        got = qd.qat_dense_bwd(*args[:3], g, *args[3:], gelu=True)
        assert {k_: qd.LAUNCHES[k_] - before[k_] for k_ in qd.LAUNCHES if qd.LAUNCHES[k_] != before[k_]} == {
            "dense_mask_gelu": 1, "dense_dx": 1, "dense_dwq": 1}, flags
        _assert_dense_grads(got, args, g, gelu=True)
        if args[5] is None or flags.get("a_obs"):  # no act mask: db is the column sum of g gelu'(pre)
            pre = qd.qat_dense(*args[:5], None, None, 8, 8, args[9], None)
            want_db = (g * qd.gelu_grad(pre)).sum(0)
            assert bool(((got[2] - want_db).abs() <= DENSE_RTOL * GELU_SLOPE * g.abs().sum(0)).all()), flags
        if flags.get("a_obs"):
            assert got[5].item() == got[6].item() == 0.0


def test_qat_dense_gelu_autograd_runs_the_gelu_backward(dev):
    case = _dense_case(dev, 600, 384, 1536, 7)
    args = _dense_args(case, dev, w_obs=False, a_obs=False)
    g = torch.randn(600, 1536, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    leaves = [t.clone().requires_grad_(True) for t in args[:7]]
    qd.reset_launches()
    (qd.qat_dense(*leaves, *args[7:], gelu=True) * g).sum().backward()
    assert {k_: v for k_, v in qd.LAUNCHES.items() if v} == {"dense_gelu": 1, "dense_mask_gelu": 1, "dense_dx": 1,
                                                             "dense_dwq": 1}
    _assert_dense_grads([t.grad for t in leaves], args, g, gelu=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        qd.qat_dense(*leaves, *args[7:], gelu=True, bf16=True)


def test_weight_group_backward_at_htdemucs_full_weight_set(dev):
    """The grouped K2-bwd over the full-width HTDemucs's 108 weight quantizers (2-D convs, transposed convs with
    ch_axis 1, the embedding table, the transformer's linears): dw bitwise, range gradients within SUM_RTOL of
    sum |term|, in one launch."""
    from fqss_tpu_torch.models.factory import create_model
    from fqss_tpu_torch.quant.quantizers import weight_quantizer_sites

    cfg = {"name": "HTDemucs", "sources": ["drums", "bass", "other", "vocals"], "audio_channels": 2,
           "quantization": {"qat": True, "n_splitter": 2, "n_combiner": 2, "out_quant": True, "observer": True}}
    model = create_model(cfg, generator=torch.Generator().manual_seed(2)).to(dev).train()

    def model_entries():
        return [getattr(layer, q).entry(getattr(layer, w)) for layer, q, w in weight_quantizer_sites(model)]

    fq._group_forward(fq.WeightGroup(model_entries()))  # the one-shot observers: every entry's ranges and flag set
    model.eval()
    entries = model_entries()
    assert len(entries) == 108 and {e.ch_axis for e in entries} == {0, 1} and all(bool(e.observed) for e in entries)
    gk = fq.WeightGroup(entries)
    buf = fq._group_forward(gk)
    gen = torch.Generator(device=dev).manual_seed(9)
    grads = [torch.randn(e.w.shape, device=dev, generator=gen) if i % 9 else None for i, e in enumerate(entries)]
    before = fq.LAUNCHES["weight_bwd"]
    dk = fq.weight_fake_quant_group_bwd(gk, buf, grads)
    assert fq.LAUNCHES["weight_bwd"] == before + 1
    dp = fq.weight_group_backward_ref(gk, buf, grads)
    used_mn, used_mx = (gk.split_ranges(r) for r in gk.scratch(buf)[:2])
    for i, (e, g) in enumerate(zip(entries, grads)):
        if g is None:
            assert dk[0][i] is None
            continue
        assert torch.equal(dk[0][i], dp[0][i]), i
        dims = tuple(d for d in range(e.w.ndim) if d != e.ch_axis % e.w.ndim)
        _, terms = fq.weight_bwd_terms(e.w, g, used_mn[i], used_mx[i], 8, e.ch_axis)
        exact = fq.route_range_grad(terms.double().sum(dims), used_mn[i].double(), used_mx[i].double(), 8, e.s)
        bound = fq.route_range_grad(terms.double().abs().sum(dims), used_mn[i].double(), used_mx[i].double(), 8, e.s)
        for got, want, b in zip((dk[1][i], dk[2][i]), exact, bound):
            assert bool(((got.double() - want).abs() <= SUM_RTOL * b.abs()).all()), i


def test_tiny_htdemucs_kd_step_runs_the_gelu_backward(dev):
    """A KD step of the tiny HTDemucs on the card: K5-bwd's GELU route once per linear1 (3 layers x 2), K5-bwd
    once per linear2, one grouped K2 and K2-bwd, K8 for student and teacher; finite loss and gradients."""
    import numpy as np

    from fqss_tpu_torch.data.synthetic import synth_music_batch
    from fqss_tpu_torch.models.factory import create_model_and_teacher
    from fqss_tpu_torch.train.recipes_music import make_music_train_step
    from fqss_tpu_torch.train.state import TrainState
    from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer

    cfg = {**HTD_CFG, "quantization": {**MUSIC_SPEC, "observer": True}}
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(3))
    model, teacher = model.to(dev), teacher.to(dev)
    state = TrainState(model, make_optimizer(TrainConfig(), [p for p in model.parameters() if p.requires_grad]),
                       teacher)
    step = make_music_train_step(TrainConfig(grad_clip=0.0), {"enable": False}, weight_kind="exp", is_htdemucs=True)
    src = torch.from_numpy(synth_music_batch(np.random.default_rng(3), 2, 4000)).to(dev)
    for i in range(MUSIC_SPEC["max_observations"] + 1):  # through the act window and one step after it
        for module in (fq, qd, k8):
            module.reset_launches()
        metrics = step(state, src, None)
        assert np.isfinite(float(metrics["loss"])) and not metrics["skipped"], i
        proj = 4 * 2 + 2 * 3  # the attentions' projections (4 self: in and out; 2 cross: query, key and out)
        assert {k_: v for k_, v in qd.LAUNCHES.items() if v} == {"dense": 2 * (6 + proj), "dense_gelu": 6 + 6,
                                                                 "dense_mask": 6 + proj, "dense_mask_gelu": 6,
                                                                 "dense_dx": 12 + proj, "dense_dwq": 12 + proj}, i
        assert fq.LAUNCHES["weight"] == 1 and fq.LAUNCHES["weight_bwd"] == 1
        assert k8.LAUNCHES["attention"] == 12
    grads = torch.cat([p.grad.flatten() for p in model.parameters() if p.grad is not None])
    assert bool(torch.isfinite(grads).all())


def _mse_layer_pair(dev, make):
    """(the layer on the card, the same layer on the CPU): an MSE act quantizer with a 2-step window."""
    from fqss_tpu_torch.quant.spec import QuantSpec

    cpu = make(QuantSpec(qat=True, act_quantizer="mse", max_observations=2))
    card = make(QuantSpec(qat=True, act_quantizer="mse", max_observations=2))
    card.load_state_dict(cpu.state_dict())
    return card.to(dev), cpu


@pytest.mark.parametrize("layer", ["qdense", "qconv1d"])
def test_fused_routes_take_an_mse_quantizers_flag(dev, layer):
    """K5 (QDense, with a gradient) and K3 (the bias-free 1x1 QConv1d, without) with an MSE act quantizer, against the
    same layer on the CPU: inside the window and until the calibration the kernels' flag passes the pre-activation
    (which the histogram observes: window ends within DENSE_RTOL), after it the grid on the calibrated ranges (at most
    one step apart, DENSE_GRID_SHARE of the values)."""
    from fqss_tpu_torch.nn.layers import QConv1d, QDense
    from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers

    if layer == "qdense":
        card, cpu = _mse_layer_pair(dev, lambda q: QDense(256, 64, q=q, generator=torch.Generator().manual_seed(1)))
        shape, counter, grad = (4, 300, 256), (qd, "dense"), True
    else:
        card, cpu = _mse_layer_pair(dev, lambda q: QConv1d(256, 64, 1, use_bias=False, q=q,
                                                           generator=torch.Generator().manual_seed(1)))
        shape, counter, grad = (4, 256, 300), (qm, "qmatmul"), False
    gen = torch.Generator().manual_seed(2)
    for k in range(4):
        if k == 3:  # the host's calibration, on the CPU's histogram, carried to the card
            assert calibrate_mse_quantizers(cpu) == 1
            card.load_state_dict(cpu.state_dict())
        x = torch.randn(shape, generator=gen) * (1 + k)
        before = counter[0].LAUNCHES[counter[1]]
        with torch.set_grad_enabled(grad):
            y_card = card.train()(x.to(dev).requires_grad_(grad))
            y_cpu = cpu.train()(x.requires_grad_(grad))
        assert counter[0].LAUNCHES[counter[1]] == before + 1
        aq_card, aq_cpu = card.activation_fake_quantize, cpu.activation_fake_quantize
        if k < 3:  # the input of the grid, unquantized
            assert torch.allclose(y_card.detach().cpu(), y_cpu.detach(), rtol=DENSE_RTOL, atol=DENSE_RTOL * 16)
            for name in ("val_min", "val_max"):
                assert torch.allclose(getattr(aq_card, name).cpu(), getattr(aq_cpu, name), rtol=DENSE_RTOL)
            assert int(aq_card.n_iter) == int(aq_cpu.n_iter) == min(k + 1, 2)
        else:
            step = float(aq_cpu.max_range.detach() - aq_cpu.min_range.detach()) / 255
            diff = (y_card.detach().cpu() - y_cpu.detach()).abs()
            assert diff.max().item() <= step * (1 + 1e-4)
            assert (diff > 0.5 * step).float().mean().item() <= DENSE_GRID_SHARE
        if grad:
            before = qd.LAUNCHES["dense_mask"]
            y_card.sum().backward()
            assert qd.LAUNCHES["dense_mask"] == before + 1


def test_mulaw_quantizer_runs_k1_and_matches_plain(dev):
    """The mu-law quantizer on the card (its inner grid on K1 forward and K1-bwd backward) against its plain version
    on the CPU: values within 1e-5 of the range but at most DENSE_GRID_SHARE of them (a code apart where log1p or pow
    rounds an ulp otherwise), gradients of mu and the ranges within 1e-3 relative."""
    from fqss_tpu_torch.quant.quantizers import ActQuantizer

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 2, 5000, generator=gen) * 0.4
    x[0, 0, :4] = torch.tensor([0.0, 1.5, -2.0, 0.7])
    g = torch.randn(x.shape, generator=gen)
    out = []
    for device in (dev, torch.device("cpu")):
        q = ActQuantizer(kind="mulaw", observer=False).to(device)
        with torch.no_grad():
            q.min_range.fill_(-0.8)
            q.max_range.fill_(0.7)
            q.mu.fill_(3.0)
        xd = x.to(device).requires_grad_()
        before = dict(fq.LAUNCHES)
        y = q(xd)
        (y * g.to(device)).sum().backward()
        if device.type == "cuda":
            assert fq.LAUNCHES["act"] == before["act"] + 1 and fq.LAUNCHES["act_bwd"] == before["act_bwd"] + 1
        out.append((y.detach().cpu(), xd.grad.cpu(), q.max_range.grad.cpu(), q.mu.grad.cpu()))
    (y_card, dx_card, dmx_card, dmu_card), (y_cpu, dx_cpu, dmx_cpu, dmu_cpu) = out
    assert ((y_card - y_cpu).abs() > 1e-5 * 0.8).float().mean().item() <= DENSE_GRID_SHARE
    assert ((dx_card - dx_cpu).abs() > 1e-5 * dx_cpu.abs().max()).float().mean().item() <= DENSE_GRID_SHARE
    for a, b in ((dmx_card, dmx_cpu), (dmu_card, dmu_cpu)):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


# ---------------------------------------------------------------------------------------------------------------
# Data parallelism: two gloo ranks sharing the card (tests/torch_ddp_cases.py) against one process
# ---------------------------------------------------------------------------------------------------------------


def test_two_gloo_ranks_on_the_card_equal_one_process(dev, tmp_path, monkeypatch):
    """The KD cases of tests/test_torch_ddp.py on the card by its rules (TF32 off and cuDNN deterministic on both
    sides): each rank's observers after every forward bit for bit the one-process run's (from the ranks' learned
    parameters), the ranks' whole states equal, the loss within 1e-5 dB and each gradient tensor within 1e-5 of the
    whole gradient's norm."""
    import os
    import socket
    import subprocess
    import sys

    import torch_ddp_cases as cases

    tests = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(tests), tests])
    procs = [subprocess.Popen([sys.executable, os.path.join(tests, "torch_ddp_cases.py"), str(tmp_path), "cuda:0"],
                              env={**env, "RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                                   "MASTER_PORT": str(port)}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o}\n{e[-4000:]}"
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)["kd"] for r in range(2)]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)  # as the ranks: cuDNN's default backward uses atomics
    for name, case in cases.KD_CASES.items():
        got = ranks[0][name]
        want = cases.forced_run(case, got["before"], cases.batches(case), dev)
        for i, (g, w) in enumerate(zip(got["observed"], want["observed"])):
            bad = [k for k in w if not torch.equal(g[k], w[k])]
            assert not bad, (f"{name} step {i + 1}: {bad[:4]}; the float model's first module whose output rows "
                             f"differ at 2 and 4 rows on this card: {cases.first_unlike(case, dev)}")
        assert all(torch.equal(ranks[1][name]["state"][k], v) for k, v in got["state"].items()), name
        assert max(abs(a - b) for a, b in zip(got["loss"], want["loss"])) <= 1e-5, name
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            whole = torch.cat([t.flatten().double() for t in w.values()]).norm()
            worst = max(w, key=lambda k: float((g[k].double() - w[k].double()).norm()))
            err = float((g[worst].double() - w[worst].double()).norm() / whole)
            assert err <= 1e-5, f"{name} step {i + 1}: {worst} off by {err:.3g} of the whole gradient's norm"


# ---------------------------------------------------------------------------------------------------------------
# The attention's projections on K5's core, and tensor parallelism's routes (fqss_tpu_torch/parallel/tp.py)
# ---------------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_projections_compute_each_row_alike_at_m_and_2m_rows(dev, bf16):
    """The in- and out-projections (K5's core, both grids off, the bias in the epilogue) and the whole module give
    a batch's first rows bitwise alike at B and 2B rows: a data-parallel rank's rows are one process's."""
    from fqss_tpu_torch.nn.attention import QMultiheadAttention
    from fqss_tpu_torch.quant.spec import QuantSpec

    q = QuantSpec(compute_dtype="bfloat16") if bf16 else QuantSpec()
    mha = QMultiheadAttention(32, 4, q=q, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mha.in_proj_bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    mha = mha.to(dev).eval()
    x = torch.randn(88, 20, 32, generator=torch.Generator().manual_seed(2)).to(dev)
    before = dict(qd.LAUNCHES)
    with torch.inference_mode():
        whole_in = mha._project(x, mha.in_proj_weight, mha.in_proj_bias)
        half_in = mha._project(x[:44], mha.in_proj_weight, mha.in_proj_bias)
        whole_out = mha._project(x, mha.out_proj_weight, mha.out_proj_bias)
        half_out = mha._project(x[:44], mha.out_proj_weight, mha.out_proj_bias)
        half = x[:44]  # one tensor: self-attention computes its in-projection once
        y, y_half = mha(x, x, x), mha(half, half, half)
    route = "dense_bf16" if bf16 else "dense"
    assert qd.LAUNCHES[route] == before[route] + 4 + 2 * 2
    assert torch.equal(whole_in[:44], half_in) and torch.equal(whole_out[:44], half_out)
    assert torch.equal(y[:44], y_half)
    plain = torch.matmul(*qd.operands(x.cpu(), mha.in_proj_weight.detach().cpu().t(), bf16)) + mha.in_proj_bias.cpu()
    terms = x.cpu().abs() @ mha.in_proj_weight.detach().cpu().abs().t() + mha.in_proj_bias.detach().cpu().abs()
    assert bool(((whole_in.cpu() - plain).abs() <= DENSE_RTOL * terms).all())


def test_row_parallel_dense_route_matches_its_plain_version(dev):
    """A row-parallel QDense (its tp group of one rank: the sum is the identity) runs K5's core with the bias and
    both grids off, then the bias and K1 as a module; forward and backward (K5-bwd, K1-bwd) against the same
    route's plain versions on the CPU."""
    import copy

    import torch_ddp_cases as cases
    from fqss_tpu_torch.nn.layers import QDense
    from fqss_tpu_torch.parallel import mesh as dp
    from fqss_tpu_torch.parallel import tp
    from fqss_tpu_torch.quant.spec import QuantSpec

    layer = QDense(96, 40, q=QuantSpec(qat=True, weight_quant=False, max_observations=1),
                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 50, 96, generator=torch.Generator().manual_seed(1))
    with cases.one_rank_mesh("cuda:0") as mesh:
        outs = []
        for device in (dev, torch.device("cpu")):
            m = copy.deepcopy(layer).to(device).train()
            m.tp = tp.Shard(tp.ROW, 0, 1)
            xi = x.to(device).requires_grad_()
            for mod in (qd, fq):
                mod.reset_launches()
            with dp.sharded(mesh):
                m(xi)  # the observing call
                y = m(xi)
                y.square().sum().backward()
            aq = m.activation_fake_quantize
            outs.append((y.detach().cpu(), xi.grad.cpu(), m.weight.grad.cpu(), m.bias.grad.cpu(),
                         aq.min_range.grad.cpu(), dict(qd.LAUNCHES), dict(fq.LAUNCHES),
                         (aq.max_range - aq.min_range).item() / 255))
    (y, dx, dw, db, dmn, dense, act, step), (y_cpu, dx_cpu, dw_cpu, db_cpu, dmn_cpu, _, _, step_cpu) = outs
    assert dense["dense"] == 2 and dense["dense_mask"] == dense["dense_dx"] == dense["dense_dwq"] == 1
    assert act["act"] == 2 and act["act_bwd"] == 1
    assert abs(step - step_cpu) <= 1e-6 * step
    diff = (y - y_cpu).abs()
    assert diff.max().item() <= step * (1 + 1e-4) and (diff > 0.5 * step).float().mean().item() <= DENSE_GRID_SHARE
    for got, want in ((dx, dx_cpu), (dw, dw_cpu), (db, db_cpu), (dmn, dmn_cpu)):
        assert float((got - want).norm() / want.norm()) <= 1e-3


@pytest.mark.parametrize("kind", ["row", "column"])
def test_weight_pass_split_on_a_shard_equals_the_per_tensor_kernel(dev, kind):
    """A tensor-parallel shard's weight quantizer in the weight pass's split (observe the table, reduce over tp:
    here one rank, quantize): the ranges the per-channel extremes of the shard's weight (a column shard, its rows in
    another order as the in-projection's heads take them, writes them into its rows of the whole ranges), the first
    call's output the weight itself, the next ones the per-tensor K2's on the same ranges, bitwise; the gradients
    K2-bwd's, a column shard's reaching its rows of the whole ranges."""
    import torch_ddp_cases as cases
    from fqss_tpu_torch.parallel import mesh as dp
    from fqss_tpu_torch.quant import quantizers as qz

    g = torch.Generator().manual_seed(3)
    whole = torch.randn(64, 48, generator=g)
    rows = torch.cat([torch.arange(32, 64), torch.arange(32)]) if kind == "column" else None
    w = (whole[rows] if kind == "column" else whole[:, :24]).contiguous().to(dev).requires_grad_()
    wq = qz.WeightQuantizer((64, 48) if kind == "column" else (64, 24)).to(dev).train()
    wq.tp = qz.TpWeight(kind, rows, 64)
    with cases.one_rank_mesh("cuda:0") as mesh, dp.sharded(mesh):
        fq.reset_launches()
        first, = qz._tp_pass([w], [wq])
        assert fq.LAUNCHES["weight"] == 2 and bool(wq.observed)
        assert torch.equal(first, w)
        mn, mx = wq.ranges()
        assert torch.equal(mn.view(-1), w.detach().amin(1)) and torch.equal(mx.view(-1), w.detach().amax(1))
        if kind == "column":
            assert torch.equal(wq.min_range.view(-1), whole.amin(1).to(dev))
        y, = qz._tp_pass([w], [wq])
        want = fq.weight_fake_quant(w.detach(), mn.detach(), mx.detach(), 8, 0)
        assert torch.equal(y, want)
        gy = torch.randn(y.shape, generator=g).to(dev)
        y.backward(gy)
    dw, dmn, dmx = fq.weight_fake_quant_bwd(w.detach(), gy, mn.detach().contiguous(), mx.detach().contiguous(), 8)
    assert torch.equal(w.grad, dw)
    got_mn = wq.min_range.grad[rows.to(dev)] if kind == "column" else wq.min_range.grad
    assert torch.allclose(got_mn.view(-1), dmn.view(-1), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------------------------------------------
# FSDP and pipeline parallelism: gloo ranks sharing the card (tests/torch_fsdp_cases.py, tests/torch_pp_cases.py)
# ---------------------------------------------------------------------------------------------------------------


def test_two_gloo_ranks_fsdp_steps_equal_their_ddp_steps_on_the_card(dev, tmp_path):
    """tests/test_torch_fsdp.py's QAT case on the card (TF32 off, cuDNN deterministic): the ConvTasNet's steps through
    its window with the state sharded over two ranks, each from the data-parallel run's learned parameters on the
    same ranks: the observers, the loss and the reduced gradients before the clip bit for bit the data-parallel
    steps', the global norm within 1e-6 relative, the state after each step bit for bit where the clip does not
    bind, else within 1e-6 of each tensor's largest magnitude."""
    import torch_ddp_cases as ddp_cases

    for r in ddp_cases.spawn_ranks("torch_fsdp_cases.py", tmp_path, 2, "cuda:0"):
        ddp, sharded = r["ddp"], r["fsdp"]
        assert sharded["sharded"]
        for i in range(ddp_cases.STEPS):
            assert not [k for k, w in ddp["observed"][i].items() if not torch.equal(sharded["observed"][i][k], w)]
            assert sharded["loss"][i] == ddp["loss"][i]
            assert not [k for k, w in ddp["grads"][i].items() if not torch.equal(sharded["grads"][i][k], w)], i
            norm = ddp["grad_norm"][i]
            assert abs(sharded["grad_norm"][i] - norm) <= 1e-6 * norm
            binds = not norm < 5.0
            for k, w in ddp["after"][i].items():
                g = sharded["after"][i][k]
                if binds and w.is_floating_point():
                    assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max()), (i, k)
                else:
                    assert torch.equal(g, w), (i, k)


def test_two_stage_pipeline_on_the_card_meets_the_sequential_stack(dev, tmp_path):
    """A 4-layer float TransformerLayer(16, 32, 4) stack over two gloo ranks sharing the card, 2 microbatches: every
    rank's output within 1e-5 absolute and relative of the stack in order on the card, and the stages' gradients of
    sum(y^2) within 2e-4 absolute and 1e-4 relative (tests/test_pp.py's rules)."""
    import numpy as np
    import torch_ddp_cases as ddp_cases
    import torch_pp_cases as cases

    ranks = ddp_cases.spawn_ranks("torch_pp_cases.py", tmp_path, 2, "cuda:0")
    stack = [layer.to(dev) for layer in cases.layers(None)]
    y = cases.sequential(stack, cases.card_input().to(dev))
    y.square().sum().backward()
    want = {f"{i}.{k}": p.grad.cpu() for i, layer in enumerate(stack) for k, p in layer.named_parameters()}
    got = {k: g for r in ranks for k, g in r["grads"].items()}
    assert got.keys() == want.keys()
    for r in ranks:
        np.testing.assert_allclose(r["y"].numpy(), y.detach().cpu().numpy(), atol=1e-5, rtol=1e-5)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=2e-4, rtol=1e-4, err_msg=k)


# The legacy HDemucs's BLSTMs at the default model's shapes: the frequency encoder's at index 4 (T 200, 4 frames of
# the 4-item batch, H 192: the cluster route) and the time encoder's at index 5 (T 200, 2 frames, H 384: the blocks
# route, which reads w_hh from L2 at every step), at batch 1 and 4.
@pytest.mark.parametrize("T,B,H", [(200, 16, 192), (200, 4, 192), (200, 8, 384), (200, 2, 384)])
def test_lstm_routes_at_the_blstm_shapes_match_plain(dev, T, B, H):
    from fqss_tpu_torch.ops import lstm

    gen = torch.Generator(device=dev).manual_seed(T + B + H)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / H**0.5 for _ in range(2)]
    assert lstm.launch_plan(dev, B, H, 2).route == ("blocks" if H == 384 else "cluster")
    before = lstm.LAUNCHES["bilstm"]
    with torch.no_grad():
        hf, hb = lstm.bilstm_sequence(ih[0], ih[1], w[0], w[1])
        rf, rb = lstm.bilstm_sequence_ref(ih[0], ih[1], w[0], w[1])
    torch.cuda.synchronize()
    assert lstm.LAUNCHES["bilstm"] == before + 1
    for got, want in ((hf, rf), (hb, rb)):
        assert (got - want).abs().max().item() <= LSTM_TOL


def test_tiny_hdemucs_legacy_folded_equals_fake_quant_on_the_card(dev):
    """The tiny HDemucsLegacy (JAX's test config) after a 3-step observer window: K1 per act quantizer but the 8
    QDense layers', one grouped weight launch, K5 8, K7 8; folded bitwise equal with no weight launch; card vs CPU
    >= 20 dB."""
    import copy

    from fqss_tpu_torch.models.hdemucs import HDemucs
    from fqss_tpu_torch.ops import lstm
    from fqss_tpu_torch.quant.quantizers import ActQuantizer
    from fqss_tpu_torch.quant.spec import QuantSpec
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    tiny = dict(channels=4, nfft=1024, samplerate=8000, segment=0.5)
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
    gen = torch.Generator().manual_seed(23)
    x = (torch.rand(2, 2, 4000, generator=gen) - 0.5)
    model = HDemucs(q=QuantSpec(observer=True, **spec), generator=gen, **tiny).to(dev)
    with torch.no_grad():
        for _ in range(3):
            model(x.to(dev))
    cpu = HDemucs(q=QuantSpec(observer=False, **spec), **tiny)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    card = copy.deepcopy(cpu).to(dev)
    n_act = sum(isinstance(m, ActQuantizer) for m in cpu.modules())
    for module in (fq, qd, lstm):
        module.reset_launches()
    with torch.inference_mode():
        y = card(x.to(dev))
        want = cpu(x)
    assert fq.LAUNCHES == {"act": n_act - 8, "weight": 1, "act_bwd": 0, "weight_bwd": 0}
    assert (qd.LAUNCHES["dense"], lstm.LAUNCHES["bilstm"]) == (8, 8)
    snr = 10 * torch.log10(want.pow(2).sum(-1) / (want - y.cpu()).pow(2).sum(-1).clamp_min(1e-30))
    assert y.shape == (2, 4, 2, 4000) and bool((snr >= 20).all()), snr
    folded = fold_quantized_weights(card)
    fq.reset_launches()
    with torch.inference_mode():
        assert torch.equal(folded(x.to(dev)), y)
    assert fq.LAUNCHES["weight"] == 0
