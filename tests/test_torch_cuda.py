"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device. This file imports no JAX,
so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from fqss_tpu_torch.ops import fake_quant as fq

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
        # 24 act and 13 weight quantizers; the last block's res_conv and add (2 act, 1 weight) feed nothing
        assert fq.LAUNCHES == {"act": 24, "weight": 13, "act_bwd": 22, "weight_bwd": 12}
