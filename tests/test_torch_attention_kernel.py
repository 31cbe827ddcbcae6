"""K8's CUDA kernel (``csrc/attention.cu``) on the CPU: its arithmetic emulated, its launch plan, its packed entry.

The kernel cannot run here, so these tests hold what surrounds it:

* an emulation of its arithmetic, warp tile by warp tile: S = Q K^T as a
  chain of float32 FMAs over the head dimension in order, from zero
  (cuBLAS's rounding of the logits; emulated as each exact product added in
  float64, then rounded to float32); the online softmax over key tiles (row
  max, the rescale alpha, each quad thread's share of the row sum, its keys t
  and t + 4 of every 8-key group); P, held as the A fragment of P V (rows g
  and g + 8, keys t and t + 4), split into TF32 ``hi`` and ``lo``
  (``rna_tf32``, ``trunc_tf32`` and ``split`` as in
  ``tests/test_torch_tf32_split.py``) against V's B fragment (rows t and
  t + 4), three TF32 products a term on m16n8k8 tiles, each mma truncating its
  sum (round toward zero, as the card's tensor cores do), each 8-key group
  summed from zero and added to the rescaled output. It is held to a float64
  attention, over several seeds and plants;
* the launch plan (``ops/attention.py:plan``) against the kernel's indexing:
  every (head, query row) once, key tiles of a multiple of 8 keys;
* the packed entry's plain version against ``fused_attention_ref`` on the
  head-layout copies, and ``QMultiheadAttention``'s CPU output against the
  computation it made before the packed entry, bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ATTN_REL_TOL = 1e-5  # chip_smoke.py's and tests/test_torch_cuda.py's bound on K8's float heads
MARGIN = 10  # the emulated error stays this many times inside ATTN_REL_TOL
ATTN_PLANT = 100.0  # chip_smoke.py's planted query: logits far past expf's range

G = torch.arange(32) // 4  # a lane's group (row of the A and C fragments, column of B)
T = torch.arange(32) % 4  # its thread in the quad


def rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest, ties away from zero, on the int32 view."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def trunc_tf32(v: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from a float32 register: its low 13 mantissa bits dropped."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(v)
    return hi, trunc_tf32(v - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, truncated: what an mma's accumulation does to its sum."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d = c + a b of m16n8k8 tiles ``[..., 16, 8] x [..., 8, 8]``: the products of TF32 values exact, the sum
    truncated to float32."""
    return round_toward_zero(c.double() + a.double() @ b.double())


def a_operand(regs: torch.Tensor) -> torch.Tensor:
    """The ``[16, 8]`` A operand that lanes' registers ``[..., 32, 4]`` stand for: a0 (row g, slot t), a1 (row g
    + 8, slot t), a2 (row g, slot t + 4), a3 (row g + 8, slot t + 4)."""
    a = regs.new_zeros(*regs.shape[:-2], 16, 8)
    a[..., G, T], a[..., G + 8, T] = regs[..., 0], regs[..., 1]
    a[..., G, T + 4], a[..., G + 8, T + 4] = regs[..., 2], regs[..., 3]
    return a


def b_operand(regs: torch.Tensor) -> torch.Tensor:
    """The ``[8, 8]`` B operand of registers ``[..., 32, 2]``: b0 (slot t, column g), b1 (slot t + 4, column g)."""
    b = regs.new_zeros(*regs.shape[:-2], 8, 8)
    b[..., T, G], b[..., T + 4, G] = regs[..., 0], regs[..., 1]
    return b


def fma_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q k^T`` of ``[H, Lq, d]`` and ``[H, Lk, d]`` as a float32 FMA chain over d in order, from zero."""
    qd, kd = q.double(), k.double().unsqueeze(1)
    acc = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
    for c in range(q.shape[-1]):
        acc = (acc.double() + qd[..., c:c + 1] * kd[..., c]).float()
    return acc


def tensor_core_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q k^T`` as 3xTF32 mma tiles would take it: each 32-dim stage summed from zero, its cross products first,
    the stages added in float32 (the rounding the kernel does not use)."""
    d = q.shape[-1]
    qp, kp = (torch.nn.functional.pad(x, (0, -d % 8)) for x in (q, k))
    s = None
    for c0 in range(0, qp.shape[-1], 32):
        steps = [(split(qp[..., c:c + 8]), split(kp[..., c:c + 8].transpose(-1, -2)))
                 for c in range(c0, min(c0 + 32, qp.shape[-1]), 8)]
        part = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
        for (qh, ql), (kh, kl) in steps:
            part = mma(mma(part, ql, kh), qh, kl)
        for (qh, _), (kh, _) in steps:
            part = mma(part, qh, kh)
        s = part if s is None else s + part
    return s


# V's B fragment rows for the slots t and t + 4: the kernel's (keys t and t + 4, as P's A fragment holds them), and
# the rows an mma's C fragment pairs (keys 2t and 2t + 1).
V_ROWS, C_ROWS = ((0, 1), (4, 1)), ((0, 2), (1, 2))  # key = a + b t for (a, b) of slot t and of slot t + 4


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tile: int, pv_products: int = 3,
                     v_rows: tuple = V_ROWS, logits=fma_logits) -> torch.Tensor:
    """``softmax(q k^T) v`` of heads ``q [H, Lq, d]``, ``k, v [H, Lk, d]`` as the kernel computes it with key tiles
    of ``tile`` keys; ``pv_products``: 3 (3xTF32) or 1 (hi hi alone)."""
    H, Lq, d = q.shape
    Lk = k.shape[1]
    D = next(x for x in k8.DIMS if d <= x)
    tiles, W = -(-Lk // tile), -(-Lq // 16)
    s_all = torch.full((H, 16 * W, tile * tiles), -float("inf"))
    s_all[:, :Lq, :Lk] = logits(q, k)
    s_all = s_all.view(H, W, 16, tile * tiles)
    vp = torch.zeros(H, tile * tiles, D)
    vp[:, :Lk, :d] = v
    (a0, b0), (a1, b1) = v_rows
    o = torch.zeros(H, W, 16, D)
    m = torch.full((H, W, 16), -float("inf"))
    l_quad = torch.zeros(H, W, 16, 4)  # each quad thread's share of its rows' sums
    for j0 in range(0, tiles * tile, tile):
        groups = -(-min(tile, Lk - j0) // 8)  # the tile's groups that hold a key
        s = s_all[..., j0:j0 + tile]
        new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - new)
        m = new
        p = torch.exp(s - m.unsqueeze(-1))
        pq = p.view(H, W, 16, tile // 8, 2, 4)  # thread t of the quad: keys 8n + t, then 8n + t + 4
        psum = torch.zeros(H, W, 16, 4)
        for n in range(groups):
            psum = psum + pq[..., n, 0, :]
            psum = psum + pq[..., n, 1, :]
        l_quad = l_quad * alpha.unsqueeze(-1) + psum
        o = o * alpha.unsqueeze(-1)
        for n in range(groups):  # each 8-key group from zero, then added to O
            pg = p[..., 8 * n: 8 * n + 8]
            ph, pl = split(a_operand(torch.stack([pg[..., G, T], pg[..., G + 8, T], pg[..., G, T + 4],
                                                  pg[..., G + 8, T + 4]], -1)))
            vg = vp[:, j0 + 8 * n: j0 + 8 * n + 8].unsqueeze(1)
            for dn in range(D // 8):
                vh, vl = split(b_operand(torch.stack([vg[..., a0 + b0 * T, 8 * dn + G],
                                                      vg[..., a1 + b1 * T, 8 * dn + G]], -1)))
                acc = torch.zeros(H, W, 16, 8)
                if pv_products == 3:
                    acc = mma(mma(acc, pl, vh), ph, vl)
                cols = slice(8 * dn, 8 * dn + 8)
                o[..., cols] = o[..., cols] + mma(acc, ph, vh)
    l = (l_quad[..., 0] + l_quad[..., 1]) + (l_quad[..., 2] + l_quad[..., 3])
    return (o / l.unsqueeze(-1)).reshape(H, 16 * W, D)[:, :Lq, :d]


def attention64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.softmax(q.double() @ k.double().transpose(-1, -2), -1) @ v.double()


def planted_heads(h: int, lq: int, lk: int, d: int, plant: float, seed: int):
    """chip_smoke.py's phase-24 operands: queries of 0.3 standard deviation, the first of every head times
    ``plant``; keys and values of 1."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((h, lq, d)) * 0.3).astype(np.float32))
    q[:, 0] *= plant
    k, v = (torch.from_numpy(rng.standard_normal((h, lk, d)).astype(np.float32)) for _ in range(2))
    return q, k, v


def relative_error(got: torch.Tensor, want: torch.Tensor, scale: float | None = None) -> float:
    """max |got - want| over max |want| (or ``scale``)."""
    return (got.double() - want).abs().max().item() / (want.abs().max().item() if scale is None else scale)


# (H, Lq, Lk, d): the Sepformer's intra- and inter-chunk heads, DPTNet's row and column heads, heads cut to 4-8;
# each with the tile the plan gives it.
HEADS = {"Sepformer intra": (4, 250, 250, 32), "Sepformer inter": (8, 34, 34, 32), "DPTNet row": (4, 250, 250, 16),
         "DPTNet column": (4, 258, 258, 16)}
# The first query of every head planted 1x (none), 5x (logits to about +-25: that row's softmax nearly one-hot,
# and later tiles rescale what earlier ones summed by factors far below 1) and 100x (chip_smoke's: +-400), on
# seeds 0-3. Readings (this emulation): from the float64 attention of its own float32 logits 0.9e-7 to 4.9e-7 of
# max |heads|; the rows other than the planted one from the float64 attention of the exact logits 1.2e-7 to
# 6.9e-7. The planted row itself is not held to the exact logits' attention: there the float32 rounding of the
# logits moves the softmax weights by up to |logit| 2^-24 of themselves (up to 6.9e-6 of max |heads| on these
# seeds at 100x), whatever the arithmetic; the kernel rounds them as the plain version does on the card (phase 24
# holds every row, the planted ones too, within ATTN_REL_TOL of it).
PLANTS = (1.0, 5.0, ATTN_PLANT)
SEEDS = range(4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("name", list(HEADS))
def test_the_kernel_arithmetic_is_float32_accurate(name, plant, seed):
    """Within ATTN_REL_TOL / MARGIN of max |heads|: every row from the float64 attention of the kernel's own float32
    logits (the online softmax and 3xTF32 P V); the rows other than the planted one from that of the exact
    logits."""
    h, lq, lk, d = HEADS[name]
    q, k, v = planted_heads(h, lq, lk, d, plant, seed)
    got = kernel_attention(q, k, v, k8.plan(h, lq, lk, d).tile)
    truth = attention64(q, k, v)
    scale = truth.abs().max().item()
    own = torch.softmax(fma_logits(q, k).double(), -1) @ v.double()
    assert torch.isfinite(got).all()
    assert relative_error(got, own, scale) <= ATTN_REL_TOL / MARGIN
    assert relative_error(got[:, 1:], truth[:, 1:], scale) <= ATTN_REL_TOL / MARGIN


def test_tensor_core_logits_leave_the_bound_at_the_plant():
    """Why S runs on the CUDA cores: at chip_smoke's plant (logits to +-400, float32 spacing 3e-5) over 1000
    heads, the kernel's arithmetic on 3xTF32 tensor-core logits reads more than ATTN_REL_TOL of max |heads| from
    the plain version's float32 composition (its logits cuBLAS's FMA chain), and on the FMA chain well inside it."""
    q, k, v = planted_heads(1000, 1, 34, 32, ATTN_PLANT, seed=24)
    plain = torch.softmax(fma_logits(q, k), -1) @ v
    scale = plain.abs().max().item()
    assert relative_error(kernel_attention(q, k, v, 40), plain, scale) <= ATTN_REL_TOL / MARGIN
    assert relative_error(kernel_attention(q, k, v, 40, logits=tensor_core_logits), plain, scale) > ATTN_REL_TOL


@pytest.mark.parametrize("name", ["Sepformer intra", "DPTNet row"])
def test_one_tf32_product_leaves_the_bound(name):
    """P V's hi hi alone (plain TF32) puts the heads more than ATTN_REL_TOL off: why the kernel takes three."""
    h, lq, lk, d = HEADS[name]
    q, k, v = planted_heads(2, lq, lk, d, 5.0, seed=1)
    got = kernel_attention(q, k, v, k8.plan(2, lq, lk, d).tile, pv_products=1)
    assert relative_error(got, attention64(q, k, v)) > ATTN_REL_TOL


def test_v_fragment_rows_follow_p_fragment_keys():
    """P's A fragment holds keys t and t + 4 of a group; V's B fragment must take the same rows. The rows an mma's C
    fragment pairs (2t and 2t + 1) give wrong heads."""
    q, k, v = planted_heads(2, 40, 40, 32, 1.0, seed=3)
    want = attention64(q, k, v)
    assert relative_error(kernel_attention(q, k, v, 40, v_rows=V_ROWS), want) <= ATTN_REL_TOL / MARGIN
    assert relative_error(kernel_attention(q, k, v, 40, v_rows=C_ROWS), want) > 0.1


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------


def covered_rows(p: k8.Plan, bh: int, lq: int) -> np.ndarray:
    """How often each (head, query row) is computed by a launch of plan p, by attention_kernel's indexing: block
    x takes head group x / qblocks and query block x % qblocks; its warp w head w / wph of the group and rows
    16 mt (qblock wph + w % wph) + [0, 16 mt), those inside Lq of a head inside BH."""
    count = np.zeros((bh, lq), np.int64)
    rows = 16 * p.mt
    for x in range(p.blocks(bh)):
        group, qb = divmod(x, p.qblocks)
        for w in range(p.wph * p.hpb):
            hl, wq = divmod(w, p.wph)
            head, r0 = group * p.hpb + hl, rows * (qb * p.wph + wq)
            if head < bh and r0 < lq:
                count[head, r0:min(r0 + rows, lq)] += 1
    return count


PLAN_CASES = [(2176, 250, 250, 32), (16000, 34, 34, 32), (8256, 250, 250, 16), (8000, 258, 258, 16),
              (3, 37, 53, 24), (1, 1, 1, 5), (7, 300, 40, 16), (5, 70, 129, 64), (2, 33, 17, 128), (40, 16, 300, 16),
              (13, 17, 8, 8), (9, 64, 65, 32), (1, 129, 513, 64), (6, 5, 1000, 128), (11, 48, 49, 33), (4, 1, 64, 16)]


@pytest.mark.parametrize("bh,lq,lk,d", PLAN_CASES)
def test_plan_covers_every_query_once_and_tiles_the_keys(bh, lq, lk, d):
    p = k8.plan(bh, lq, lk, d)
    assert p.dim >= d and p.dim in k8.DIMS
    assert (covered_rows(p, min(bh, 3 * p.hpb + 1), lq) == 1).all()  # the ragged last head group included
    assert p.tile % 8 == 0 and 8 <= p.tile <= k8.max_tile(p.dim, p.mt)
    assert (p.tiles - 1) * p.tile < lk <= p.tiles * p.tile  # every tile holds a key, and the tiles hold them all
    assert 1 <= p.wph * p.hpb <= k8.max_warps(p.dim, p.mt)
    assert p.mt == (1 if lq <= 4 * 16 or p.dim > 64 else 2) and (p.hpb == 1 or p.qblocks == 1)
    assert p.smem <= k8.SMEM_BUDGET or p.hpb == 1


def slot_use(p: k8.Plan, lq: int, lk: int) -> float:
    """The live share of the (query, key) pairs a head's warps compute: 16 mt-row warps, tile-sized key groups."""
    return lq * lk / (16 * p.mt * p.wph * p.qblocks * p.tile * p.tiles)


def test_slot_use_at_the_sepformer_inter_chunk_shape():
    """L 34: 3 warps a head (34 of 48 rows) over one tile of 40 keys (34 live), 60% of the pairs computed are
    live; the one-query-a-thread kernel this one replaced packed 3 heads x 34 = 102 of 128 query slots over two
    32-key tiles (34 of 64): 42%."""
    p = k8.plan(16000, 34, 34, 32)
    assert (p.tile, p.tiles, p.wph, p.mt) == (40, 1, 3, 1)
    assert slot_use(p, 34, 34) >= 102 / 128 * 34 / 64
    assert slot_use(k8.plan(2176, 250, 250, 32), 250, 250) >= 0.95


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((0, 4, 4, 16), (1, 0, 4, 16), (1, 4, 0, 16), (1, 4, 4, 0), (1, 4, 4, 129)):
        with pytest.raises(ValueError):
            k8.plan(*args)


# ---------------------------------------------------------------------------
# The packed entry and the module
# ---------------------------------------------------------------------------


def in_projection(B, L, h, d, seed):
    """q [B, L, h, d] (a contiguous [B, L, E] viewed), and k, v: the E:2E and 2E: thirds of an [B, L, 3E]."""
    rng = np.random.default_rng(seed)
    E = h * d
    X = torch.from_numpy(rng.standard_normal((B, L, 3 * E)).astype(np.float32))
    Q = torch.from_numpy((rng.standard_normal((B, L, E)) * 0.3).astype(np.float32))
    return Q.view(B, L, h, d), X[..., E:2 * E].unflatten(-1, (h, d)), X[..., 2 * E:].unflatten(-1, (h, d))


@pytest.mark.parametrize("B,L,h,d", [(2, 11, 4, 4), (1, 34, 8, 32), (1, 1, 2, 5), (3, 20, 4, 16)])
@pytest.mark.parametrize("quantize", [False, True])
def test_packed_plain_version_is_the_head_layout_plain_version(B, L, h, d, quantize):
    q, k, v = in_projection(B, L, h, d, seed=B + L + d)
    mn, mx = torch.tensor([-0.6]), torch.tensor([0.9])
    assert L == 1 or not (k.is_contiguous() or v.is_contiguous())
    heads = k8.fused_attention_ref(*(x.transpose(1, 2).reshape(B * h, L, d).contiguous() for x in (q, k, v)), mn, mx,
                                   8, quantize)
    want = heads.reshape(B, h, L, d).transpose(1, 2).reshape(B, L, h * d)
    got = k8.fused_attention_packed_ref(q, k, v, mn, mx, 8, quantize)
    assert got.shape == (B, L, h * d) and torch.equal(got, want)
    k8.reset_launches()
    assert torch.equal(k8.fused_attention_packed(q, k, v, mn, mx, 8, quantize), want)
    assert k8.LAUNCHES == {"attention": 0, "attention_bf16": 0}


def test_packed_autograd_function_gives_the_plain_gradient():
    q, k, v = (x.clone().requires_grad_(True) for x in in_projection(2, 9, 2, 8, seed=4))
    mn, mx = torch.tensor([-0.6], requires_grad=True), torch.tensor([0.9], requires_grad=True)
    g = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(5))
    grads = []
    for fn in (k8.fused_attention_packed, k8.fused_attention_packed_ref):
        out = fn(q, k, v, mn, mx, 8)
        grads.append(torch.autograd.grad((out * g).sum(), (q, k, v, mn, mx)))
    assert type(k8.fused_attention_packed(q, k, v, mn, mx, 8).grad_fn).__name__ == "_FusedAttentionPackedBackward"
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_packed_entry_refuses_what_the_kernel_does_not_take():
    q, k, v = in_projection(2, 6, 2, 8, seed=6)
    with pytest.raises(ValueError, match="unit inner stride"):
        k8.fused_attention_packed(q, torch.zeros(2, 6, 2, 16)[..., ::2], v, quantize=False)
    with pytest.raises(ValueError, match="expected"):
        k8.fused_attention_packed(q, k[:, :, :1], v[:, :, :1], quantize=False)
    with pytest.raises(ValueError, match="no keys"):
        k8.fused_attention_packed(q, k[:, :0], v[:, :0], quantize=False)
    with pytest.raises(ValueError, match="one-element"):
        k8.fused_attention_packed(q, k, v, quantize=True)
    with pytest.raises(TypeError):
        k8.fused_attention_packed(q.double(), k.double(), v.double(), quantize=False)


def module_before_the_packed_entry(mha: QMultiheadAttention, x: torch.Tensor) -> torch.Tensor:
    """QMultiheadAttention's self-attention forward as it was computed before the packed entry: contiguous
    ``[B h, L, d]`` copies of the heads, the [BH, L, d] core, the heads transposed back."""
    E, h = mha.embed_dim, mha.num_heads
    d = E // h
    B, L, _ = x.shape
    w_in, w_out = mha.weight_fake_quantize_in(mha.in_proj_weight), mha.weight_fake_quantize_out(mha.out_proj_weight)
    X = torch.matmul(x, w_in.t()) + mha.in_proj_bias
    Xq, Xk, Xv = mha.activation_fake_quantize_q(X), mha.activation_fake_quantize_k(X), mha.activation_fake_quantize_v(X)
    Q = mha.activation_fake_quantize_div(Xq[..., :E] / torch.full((1,), np.sqrt(d)))
    Qh = Q.reshape(B, L, h, d).transpose(1, 2).reshape(B * h, L, d).contiguous()
    Kh = Xk[..., E:2 * E].reshape(B, L, h, d).transpose(1, 2).reshape(B * h, L, d).contiguous()
    Vh = Xv[..., 2 * E:].reshape(B, L, h, d).transpose(1, 2).reshape(B * h, L, d).contiguous()
    qa, qs = mha.activation_fake_quantize_attn, mha.activation_fake_quantize_softmax
    if mha.training and qa.observer:  # the reference's no-op sites, evaluated for their observers
        attn = torch.matmul(Qh, Kh.transpose(-1, -2))
        qa(attn)
        qs(torch.softmax(attn, dim=-1))
    hq = mha.activation_fake_quantize_head
    if hq.observer:
        heads = hq(k8.fused_attention(Qh, Kh, Vh, quantize=False))
    else:
        heads = k8.fused_attention(Qh, Kh, Vh, hq.min_range, hq.max_range, hq.n_bits, quantize=True)
    y = torch.matmul(heads.reshape(B, h, L, d).transpose(1, 2).reshape(B, L, E), w_out.t()) + mha.out_proj_bias
    return mha.activation_fake_quantize(y)


@pytest.mark.parametrize("observer", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_module_cpu_output_is_unchanged(observer, batch):
    """Serving (the head grid in K8) and the observer window (K8, then the quantizer, in eval and train mode):
    the module's output bit for bit as before, and the same observer state after a train-mode call."""
    spec = QuantSpec(qat=True, observer=observer, max_observations=3, n_splitter=2, n_combiner=2, out_quant=True)
    mha = QMultiheadAttention(32, 4, q=spec, generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((batch, 13, 32)).astype(np.float32))
    with torch.no_grad():
        mha.train()(x, x, x)  # set the ranges (observer) or leave them at their initial values
        for mode in ("eval", "train"):
            a, b = copy.deepcopy(mha), copy.deepcopy(mha)
            getattr(a, mode)(), getattr(b, mode)()
            assert torch.equal(a(x, x, x), module_before_the_packed_entry(b, x))
            for (name, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
                assert torch.equal(ta, tb), name
