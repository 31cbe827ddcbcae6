"""The launch plans of the LSTM (K7/K6) and int8 requantizing matmul (K4) kernels, and K4's division, on the CPU.

The kernels run only on the card, but what they are told to do is plain Python (``ops/lstm.py:plan``,
``ops/int8_matmul.py:grid``), and the epilogue's division is float32 arithmetic that PyTorch can emulate bit for
bit. These tests hold the plans to covering every row and tile once within what fits co-resident, and the
division to IEEE division around every rounding boundary the epilogue can meet.
"""

import numpy as np
import pytest
import torch

from fqss_tpu_torch.models.dptnet import split_segments
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.ops import lstm as lk

torch.set_num_threads(1)

# DPTNet (configs/dptnet_2spks_8k.yaml): H 128, segments of 250; the serving batch of 8 x 4 s and a streamed
# 16000-sample window at batch 1 (kernel_size 2, stride 1: 15999 frames).
DPT_H, DPT_SEGMENT = 128, 250
# An H100's co-resident clusters of the cluster route at H 128 (2 CTAs a cluster, one CTA an SM).
H100_CLUSTERS = 66


def dptnet_lstm_shapes(batch: int, samples: int) -> list[tuple[int, int]]:
    """(T, B') of DPTNet's row and column LSTMs."""
    segs, _ = split_segments(torch.empty(1, samples - 1, 1), DPT_SEGMENT)
    k, s = segs.shape[1], segs.shape[2]
    return [(k, batch * s), (s, batch * k)]


def covered_rows(p: lk.Plan, B: int, dirs: int) -> list[list[int]]:
    """The rows each direction's clusters own under plan ``p`` (the kernel's blockIdx.x / cluster tiles)."""
    per_dir = p.units // dirs
    return [[r for tile in range(per_dir) for r in range(tile * p.rows, min(B, (tile + 1) * p.rows))]
            for _ in range(dirs)]


@pytest.mark.parametrize("B", [1, 3, 7, 8, 9, 63, 64, 65, 130, 250, 300, 2000, 2064, 5000])
@pytest.mark.parametrize("H", [16, 64, 96, 128, 130, 256, 330, 331, 1210])
@pytest.mark.parametrize("dirs", [1, 2])
def test_lstm_plan_covers_every_row_once_within_the_co_resident_clusters(B, H, dirs):
    coresident = 40
    p = lk.plan(B, H, dirs, coresident)
    for rows in covered_rows(p, B, dirs):
        assert rows == list(range(B))
    assert p.units == dirs * -(-B // p.rows) and p.ctas == p.units * p.cluster
    if p.route == "blocks":
        assert lk.cluster_size(H) is None and p.rows == lk.BLOCKS_ROWS
        return
    assert p.rows in lk.cluster_tiles(H)
    assert -(-H // p.cluster) <= lk.CTA_UNITS and 1 <= p.cluster <= lk.MAX_CLUSTER
    assert lk.cluster_smem(H, p.cluster, p.rows) <= lk.SMEM_BYTES
    fitting = [r for r in lk.cluster_tiles(H) if dirs * -(-B // r) <= coresident]
    if fitting:  # the least tile whose clusters all fit co-resident: no second wave
        assert p.rows == fitting[0] and p.units <= coresident
    else:  # no tile fits in one wave: the largest tile, the fewest waves
        assert p.rows == lk.cluster_tiles(H)[-1]
    if dirs * -(-B // lk.TILE_ROWS[0]) <= coresident:  # a tile of the smallest size fits
        assert p.units <= coresident


def test_lstm_plan_at_dptnet_serving_shapes_is_one_wave_of_clusters_of_two():
    (row_t, row_b), (col_t, col_b) = dptnet_lstm_shapes(8, 32000)
    assert (row_t, row_b, col_t, col_b) == (250, 2064, 258, 2000)
    row, col = lk.plan(row_b, DPT_H, 2, H100_CLUSTERS), lk.plan(col_b, DPT_H, 2, H100_CLUSTERS)
    assert (row.route, row.cluster, row.rows, row.units, row.ctas) == ("cluster", 2, 64, 66, 132)
    assert (col.route, col.cluster, col.rows, col.units, col.ctas) == ("cluster", 2, 64, 64, 128)
    # the W_hh slice of a CTA: 128 x 64 units x 4 gates in float32, h of 64 rows in two buffers, 16 mbarriers
    assert lk.cluster_smem(DPT_H, 2, 64) == 128 * 1024 + 64 * 1024 + 16 * 8


def test_lstm_plan_spreads_the_streaming_window_over_many_clusters():
    shapes = dptnet_lstm_shapes(1, 16000)
    assert shapes == [(250, 130), (130, 250)]
    for _, b in shapes:
        p = lk.plan(b, DPT_H, 2, H100_CLUSTERS)
        assert p.rows == lk.TILE_ROWS[0] and p.units >= 32 and p.units <= H100_CLUSTERS


@pytest.mark.parametrize("H", [331, 400, 512, 1210])
def test_lstm_plan_takes_the_blocks_route_beyond_what_a_cluster_of_8_holds(H):
    assert lk.cluster_size(H) is None
    assert lk.plan(100, H, 2, H100_CLUSTERS).route == "blocks"
    assert lk.cluster_smem(H, lk.MAX_CLUSTER, lk.TILE_ROWS[0]) > lk.SMEM_BYTES or -(-H // 8) > lk.CTA_UNITS


# (M, K, N) of K4's launches: ConvTasNet's engine (phase 12: 32 x 11999 rows), DPTNet's (phase 22: BN, the in- and
# out-projections at the row shape, the gates and mask), the Sepformer's (phase 29, 8 x 4 s: 8500 tokens a
# sequence), and ragged ones.
K4_SHAPES = [(383968, 512, 128), (383968, 128, 512), (383968, 128, 1024), (255992, 256, 64), (516000, 64, 192),
             (516000, 64, 64), (511984, 64, 256), (68000, 256, 768), (68000, 256, 1024), (68000, 1024, 256),
             (31992, 256, 256), (63984, 256, 512), (1, 48, 40), (17, 48, 40), (1023, 48, 40), (300, 7, 3),
             (129, 130, 257), (4097, 1024, 64), (333, 2176, 20), (1000, 130, 1000)]


def tiles_of_block(b: int, blocks: int, m: int, n: int, k: int) -> list[tuple[int, int]]:
    """The (M tile, N tile) pairs that block b of a launch of ``blocks`` walks (csrc/int8_matmul.cu: N tile
    b % n_tiles, M tiles b / n_tiles, + blocks / n_tiles, ...)."""
    n_tiles, m_tiles = -(-n // im.tile_n(n, k)), -(-m // im.TILE_M)
    return [(mt, b % n_tiles) for mt in range(b // n_tiles, m_tiles, blocks // n_tiles)]


@pytest.mark.parametrize("m,k,n", K4_SHAPES)
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
def test_int8_grid_visits_every_tile_once(m, k, n, blocks_per_sm):
    sms = 132
    blocks = im.grid(m, n, k, sms, blocks_per_sm)
    tile_n = im.tile_n(n, k)
    n_tiles, m_tiles = -(-n // tile_n), -(-m // im.TILE_M)
    assert blocks % n_tiles == 0 and n_tiles <= blocks <= max(n_tiles, sms * blocks_per_sm)
    assert im.smem_bytes(tile_n, k) <= im.SMEM_BYTES
    visits = [t for b in range(blocks) for t in tiles_of_block(b, blocks, m, n, k)]
    assert sorted(visits) == [(mt, nt) for mt in range(m_tiles) for nt in range(n_tiles)]
    per_block = [len(tiles_of_block(b, blocks, m, n, k)) for b in range(blocks)]
    assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1  # balanced, no idle block


def test_int8_tile_n_follows_the_shared_memory():
    assert im.tile_n(128, 512) == 128 and im.tile_n(64, 256) == 64 and im.tile_n(256, 1024) == 128
    assert im.tile_n(256, 1152) == 128 and im.tile_n(256, 1280) == 64 and im.tile_n(20, 2560) == 64 and im.tile_n(20, 2688) == 0


def _round_to_float32(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """RN to float32 of the exact value s + err (float64 s, |err| below half an ulp of s)."""
    f = s.float()
    toward = torch.where(s > f.double(), torch.full_like(f, float("inf")), torch.full_like(f, -float("inf")))
    g = torch.nextafter(f, toward)
    on_midpoint = (f.double() != s) & (s == (f.double() + g.double()) / 2) & (err != 0)
    return torch.where(on_midpoint, torch.where(err > 0, torch.maximum(f, g), torch.minimum(f, g)), f)


def fmaf(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """CUDA's fmaf on float32 tensors: RN(x y + z) with one rounding (the product is exact in float64, the sum is
    carried as float64 plus its rounding error)."""
    p, zd = x.double() * y.double(), z.double()
    s = p + zd
    bb = s - p
    return _round_to_float32(s, (p - (s - bb)) + (zd - bb))


def kernel_quotient(a: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """csrc/int8_matmul.cu:requant's quotient: a clamped to [-delta, 256 delta], r = RN(1 / delta),
    q = RN(a r), q' = RN(q + RN(a - q delta) r)."""
    a = torch.minimum(torch.maximum(a, -delta), delta * 256.0)
    r = torch.ones_like(delta) / delta
    q = a * r
    return fmaf(fmaf(-q, delta, a), r, q)


def near_boundaries(delta: float, ulps: int = 64) -> torch.Tensor:
    """Every float32 within ``ulps`` ulps of (k + 0.5) delta, k = -1 .. 256."""
    base = ((torch.arange(-1, 257, dtype=torch.float64) + 0.5) * torch.tensor(delta, dtype=torch.float32).double())
    lo = hi = base.float()
    out = [lo]
    for _ in range(ulps):
        lo, hi = torch.nextafter(lo, torch.tensor(-np.inf)), torch.nextafter(hi, torch.tensor(np.inf))
        out += [lo, hi]
    return torch.cat(out)


# The out grids' steps chip_smoke.py plants ties on (INT8_TIE_DELTA and QKV_GRIDS), and 100 seeded ones.
DELTAS = [2.0**-6, 0.013, 2.0**-5, *np.exp(np.random.default_rng(9).uniform(np.log(1e-4), np.log(1.0), 100))]


@pytest.mark.parametrize("chunk", range(4))
def test_int8_epilogue_division_equals_ieee_division_near_every_rounding_boundary(chunk):
    for delta in DELTAS[chunk::4]:
        a = near_boundaries(delta)
        d = torch.full_like(a, delta)
        want = torch.div(a, d)
        got = kernel_quotient(a, d)
        inside = (a >= -d) & (a <= d * 256.0)
        assert torch.equal(got[inside], want[inside]), delta
        # where the clamp moved a, the output grid clips both to the same end
        assert torch.equal(torch.round(got).clamp(0, 255), torch.round(want).clamp(0, 255)), delta


def test_the_fmaf_emulation_rounds_once():
    # x y + z = 1 + 2^-23 + 2^-24 - 2^-70, just below the midpoint of 1 + 2^-23 and 1 + 2^-22: one rounding goes
    # down, where the float64 sum (the midpoint itself, a tie) and then float32 (to even) would go up.
    x = torch.tensor([2.0**-12 * (1 - 2.0**-23)], dtype=torch.float32)
    y = torch.tensor([2.0**-12 * (1 + 2.0**-23)], dtype=torch.float32)
    z = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    assert fmaf(x, y, z).item() == 1 + 2.0**-23
    assert (x.double() * y.double() + z.double()).float().item() == 1 + 2.0**-22
