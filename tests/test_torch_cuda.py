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
    with pytest.raises(RuntimeError, match="forward only"):
        fq.act_fake_quant(x.requires_grad_(), *r)
