"""LSTM recurrence: wrappers, plain versions and launch counters.

The CUDA kernels in ``csrc/lstm.cu`` (templates in ``csrc/lstm.cuh``; the
static route's quantized launch in ``csrc/lstm_static.cu``) replace the TPU
kernels of the LSTM recurrence, ``fqss_tpu/ops/pallas_lstm.py``:

* :func:`lstm_sequence` — one direction (``lstm_sequence``, ``_lstm_kernel``);
* :func:`bilstm_sequence` — both directions of a bidirectional LSTM in one
  launch (``bilstm_sequence``, ``_bilstm_kernel``).

Both take the hoisted input projections ``ih = x @ W_ih + b_ih + b_hh``
time-major, ``[T, B, 4H]`` in torch's gate order (i, f, g, o), each
direction's in its own scan order (the caller flips the reverse direction),
and ``w_hh`` as ``[H, 4H]``; they return ``hs [T, B, H]`` in the same order,
from zero initial state. Unlike the TPU kernel (``H % 128 == 0``), the
Hopper kernels take any H up to a shared-memory limit (1210) and any B.

Two routes, chosen by shape (:func:`plan`), count under the same key:

* the cluster route (H up to 322, DPTNet's 128 among them): a
  thread-block cluster of ``cluster`` CTAs owns ``rows`` batch rows of one
  direction, each CTA a slice of the hidden units with its slice of ``w_hh``
  kept in shared memory for the whole launch, h exchanged through
  distributed shared memory at every step. The cluster size is the least
  that holds the slice; the row tile is the least whose clusters all fit
  co-resident on the card (``cudaOccupancyMaxActiveClusters``, asked once a
  device and H), so that small batches spread over many SMs and none waits
  for a second wave;
* the blocks route, for H that no cluster of 8 holds: a block owns 16 rows
  of one direction and reads ``w_hh`` from L2 at every step.

The static route (:func:`lstm_static_sequence`, :func:`bilstm_static_sequence`) is the
cell of ``QLSTM(mode="static")`` on the same kernels, the port's own: JAX runs
that cell as a ``lax.scan`` (``fqss_tpu/nn/lstm.py:108-176``). Its 12
quantizer sites per direction (:data:`SITES`) are per-tensor uniform grids
from the direction's ``site_min``/``site_max``. A call that starts inside the
observer window (the first :data:`OBSERVE_STEPS` steps a direction has seen,
with ``QuantSpec.observer`` on) is two launches: the float cell over the
window's ``k`` steps, each warp writing every site's min and max at every
step, then on the device the reduction and the 0.9/0.1 EMA of the ranges over
the ``k`` steps in JAX's order, then the quantized cell over the rest from the
window's last ``h`` and ``c``. A call outside the window is one launch. Both
count under ``lstm_static`` / ``bilstm_static``; the new ranges come back for
the module to keep in ``train()`` mode. The plain version
(:func:`lstm_static_sequence_ref`) takes the same two parts.

The dynamic cell (:func:`lstm_dynamic_sequence`, :func:`bilstm_dynamic_sequence`)
quantizes each site on the grid of its own min and max at every step
(:func:`~fqss_tpu_torch.quant.quantizers.dynamic_act_quant`): 12 whole-tensor
reductions a step, which do not fit the kernel's clusters of one batch tile
each. It runs as a plain loop of PyTorch ops on every device, as JAX runs it
as a ``lax.scan``; it launches no kernel of this module and has no counter.

Under a data-parallel mesh (:mod:`fqss_tpu_torch.parallel.mesh`) both cells
take the global batch's extremes, as JAX's one program over a sharded batch
does: the static window's per-step site extremes are reduced over the ranks
between the observing launch and the EMA (one ``all_reduce`` a call), and the
dynamic cell's min and max at each site and step (one ``all_reduce`` each
forward and backward: 12 a step).

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain version (:func:`lstm_sequence_ref`,
:func:`bilstm_sequence_ref`: a Python time loop of ``h @ w_hh`` and the
gates, JAX's ``_lstm_scan``), which autograd differentiates. On the card a
call that needs a gradient runs through a ``torch.autograd.Function`` whose
forward is the kernel and whose backward recomputes the recurrence through
the plain version (under ``enable_grad``, from the saved inputs alone) and
returns its gradient: JAX's ``custom_vjp`` around the Pallas kernel
(``pallas_lstm.py:217-225``, ``:258-266``), which rematerialises through
``lax.scan``. JAX has no Pallas backward for the LSTM, so neither has the
port. ``LAUNCHES`` counts the kernel's launches, one per launch (a static
call inside the window makes two); the backward launches none.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import _check_device, _needs_grad
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.fake_quant import linear_fake_quant
from fqss_tpu_torch.quant.quantizers import dynamic_act_quant

Tensor = torch.Tensor

LAUNCHES = {"lstm": 0, "bilstm": 0, "lstm_static": 0, "bilstm_static": 0}

# The static and dynamic cells' quantizer sites, in the order of JAX's _SITES (fqss_tpu/nn/lstm.py:37): the index of
# each in site_min/site_max and in the kernel's grids.
SITES = ("ih", "hh", "add0", "sig0", "sig1", "tanh0", "sig2", "mul0", "mul1", "add1", "tanh1", "mul2")
OBSERVE_STEPS = 50  # the static cell's observer window, in steps (fixed in JAX, fqss_tpu/nn/lstm.py:118-129)
EMA = 0.9  # the window's range update: EMA * r + (1 - EMA) * the step's min or max, as JAX writes 0.9 and 0.1
MODES = {"fused": 0, "observe": 1, "static": 2}  # the kernel's template modes (csrc/lstm.cu Mode)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The cluster route's layout and limits (csrc/lstm.cu): a CTA owns at most 64 units, in 8 row groups, and its shared
# memory holds its w_hh slice [H][ceil(H / cluster)][4] and h of the tile in two buffers [2][rows][H], float32,
# and an mbarrier for each buffer and row group.
SMEM_BYTES = 232448  # the most shared memory a block may have on sm_90
CTA_UNITS = 64  # the most hidden units a CTA owns (2 a thread of a warp)
MAX_CLUSTER = 8  # the portable cluster size
TILE_ROWS = (8, 16, 32, 64)  # the row tiles the kernel is built for (1 to 8 rows a thread)
OBSERVE_ROWS = 32  # the largest tile of the static route's observing launch (at most 50 steps a call)
BLOCKS_ROWS = 16  # the blocks route's rows a block


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch covers ``dirs`` x B rows: ``units`` clusters (blocks on the blocks route) of ``cluster`` CTAs,
    each owning ``rows`` rows of one direction."""

    route: str  # "cluster" or "blocks"
    cluster: int
    rows: int
    units: int

    @property
    def ctas(self) -> int:
        return self.units * self.cluster


def cluster_smem(H: int, cluster: int, rows: int, grids: bool = False) -> int:
    """Shared-memory bytes of one CTA of the cluster route (with its 16 mbarriers, and with ``grids`` the static
    route's 12 grids)."""
    units = -(-H // cluster)
    return 4 * (4 * H * units + 2 * rows * H) + 8 * 16 + (4 * 2 * len(SITES) if grids else 0)


def cluster_size(H: int, grids: bool = False) -> int | None:
    """The least cluster whose CTAs each hold their slice of ``w_hh`` with the smallest row tile; None where no
    cluster of MAX_CLUSTER does (the blocks route)."""
    for c in range(1, MAX_CLUSTER + 1):
        if -(-H // c) <= CTA_UNITS and cluster_smem(H, c, TILE_ROWS[0], grids) <= SMEM_BYTES:
            return c
    return None


def cluster_tiles(H: int, grids: bool = False) -> tuple[int, ...]:
    """The row tiles whose CTAs fit in shared memory at H (with :func:`cluster_size`'s cluster)."""
    c = cluster_size(H, grids)
    return () if c is None else tuple(r for r in TILE_ROWS if cluster_smem(H, c, r, grids) <= SMEM_BYTES)


def plan(B: int, H: int, dirs: int, coresident: int, grids: bool = False, max_rows: int = TILE_ROWS[-1]) -> Plan:
    """The launch of ``dirs`` directions of B rows at H, given how many clusters of the largest fitting tile fit
    co-resident on the card: the least row tile whose clusters all fit, else the largest tile. ``grids``: the
    static route's quantized launch, whose CTAs also hold the 12 grids; ``max_rows``: the kernel's largest tile."""
    c = cluster_size(H, grids)
    if c is None:
        return Plan("blocks", 1, BLOCKS_ROWS, dirs * -(-B // BLOCKS_ROWS))
    tiles = tuple(r for r in cluster_tiles(H, grids) if r <= max_rows)
    rows = next((r for r in tiles if dirs * -(-B // r) <= coresident), tiles[-1])
    return Plan("cluster", c, rows, dirs * -(-B // rows))


_CORESIDENT: dict[tuple[int, int, int], int] = {}


def coresident(device: torch.device, H: int, mode: int = 0) -> int:
    """Clusters of the cluster route's kernel ``mode`` (:data:`MODES`) at H and its largest fitting tile that fit
    co-resident on ``device``, asked of the card once a device, H and mode."""
    key = (device.index, H, mode)
    if key not in _CORESIDENT:
        grids, lib = mode == MODES["static"], _build.library()
        rows = max(r for r in cluster_tiles(H, grids) if r <= _max_rows(mode))
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            if grids:
                rc = lib.fqss_lstm_static_max_active(H, cluster_size(H, grids), rows, ctypes.byref(n))
            else:
                rc = lib.fqss_lstm_cluster_max_active(H, cluster_size(H, grids), rows, mode, ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"lstm: cudaOccupancyMaxActiveClusters failed with error {rc} ({n.value} clusters)")
        _CORESIDENT[key] = n.value
    return _CORESIDENT[key]


def _max_rows(mode: int) -> int:
    return OBSERVE_ROWS if mode == MODES["observe"] else TILE_ROWS[-1]


def launch_plan(device: torch.device, B: int, H: int, dirs: int, mode: int = 0) -> Plan:
    """The plan a launch of the kernel ``mode`` (:data:`MODES`) on ``device`` takes."""
    grids = mode == MODES["static"]
    return plan(B, H, dirs, coresident(device, H, mode) if cluster_size(H, grids) is not None else 0, grids,
                _max_rows(mode))


def lstm_sequence_ref(ih: Tensor, w_hh: Tensor) -> Tensor:
    """Plain version: ``[T, B, 4H]``, ``[H, 4H]`` -> ``hs [T, B, H]`` (``pallas_lstm.py:_lstm_scan``)."""
    B, G = ih.shape[1:]
    H = G // 4
    h = ih.new_zeros(B, H)
    c = ih.new_zeros(B, H)
    hs = []
    # unbind, not ih[t]: autograd then stacks the steps' gradients once, where T selects would each add a zero
    # tensor of the whole ih (a full-width DPTNet train step's backward, which recomputes through this loop, spent
    # 0.73 s of its 1.27 s of device time on those adds and fills on an H100)
    for ih_t in ih.unbind(0):
        i, f, g, o = (ih_t + h @ w_hh).split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs) if hs else ih.new_zeros(0, B, H)


def bilstm_sequence_ref(ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor) -> tuple[Tensor, Tensor]:
    """Plain version of :func:`bilstm_sequence`: the two recurrences one after the other."""
    return lstm_sequence_ref(ih_f, w_f), lstm_sequence_ref(ih_b, w_b)


def _check(name: str, ih: Tensor, w_hh: Tensor) -> None:
    """Hold a direction's operands to what the kernel takes."""
    if ih.ndim != 3 or ih.shape[2] % 4 or w_hh.shape != (ih.shape[2] // 4, ih.shape[2]):
        raise ValueError(f"{name}: ih [T, B, 4H] and w_hh [H, 4H] expected, got {tuple(ih.shape)} and "
                         f"{tuple(w_hh.shape)}")
    for arg, t in (("ih", ih), ("w_hh", w_hh)):
        if t.device != ih.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, ih on {ih.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, {arg} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors ({arg} is not)")


def _launch(name: str, key: str, pairs: list[tuple[Tensor, Tensor]]) -> list[Tensor]:
    """One kernel launch over one or two directions' ``(ih, w_hh)``, counted under ``key``; their ``hs``."""
    ih = pairs[0][0]
    T, B, G = ih.shape
    H = G // 4
    outs = [torch.empty(T, B, H, device=ih.device) for _ in pairs]
    if not ih.numel():
        return outs
    lib = _build.library()
    if H > lib.fqss_lstm_max_hidden():
        raise ValueError(f"{name}: H = {H} exceeds the kernel's shared memory (at most {lib.fqss_lstm_max_hidden()})")
    p = launch_plan(ih.device, B, H, len(pairs))
    (ih0, w0), (ih1, w1) = pairs[0], pairs[-1]
    ptrs = (ih0.data_ptr(), w0.data_ptr(), outs[0].data_ptr(), ih1.data_ptr(), w1.data_ptr(), outs[-1].data_ptr())
    with torch.cuda.device(ih.device):
        stream = torch.cuda.current_stream(ih.device).cuda_stream
        if p.route == "cluster":
            rc = lib.fqss_lstm_cluster(*ptrs, len(pairs), T, B, H, p.cluster, p.rows, stream)
        else:
            rc = lib.fqss_lstm_recurrence(*ptrs, len(pairs), T, B, H, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[key] += 1
    return outs


class _Recurrence(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain recurrence, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, ih_f, w_f, ih_b, w_b):
        ctx.save_for_backward(ih_f, w_f, ih_b, w_b)
        if ih_b is None:
            return _launch("lstm_sequence", "lstm", [(ih_f, w_f)])[0]
        return tuple(_launch("bilstm_sequence", "bilstm", [(ih_f, w_f), (ih_b, w_b)]))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) if t is not None else None
                      for t, need in zip(saved, ctx.needs_input_grad)]
            outs = [lstm_sequence_ref(inputs[0], inputs[1])]
            if inputs[2] is not None:
                outs.append(lstm_sequence_ref(inputs[2], inputs[3]))
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads[: len(outs)]))
        return tuple(next(got) if t is not None and t.requires_grad else None for t in inputs)


def lstm_sequence(ih: Tensor, w_hh: Tensor) -> Tensor:
    """LSTM recurrence over hoisted input projections: ``[T, B, 4H]``, ``[H, 4H]`` -> ``[T, B, H]``."""
    _check_device("lstm_sequence", ih)
    _check("lstm_sequence", ih, w_hh)
    if ih.device.type == "cpu":
        return lstm_sequence_ref(ih, w_hh)
    if _needs_grad(ih, w_hh):
        return _Recurrence.apply(ih, w_hh, None, None)
    (hs,) = _launch("lstm_sequence", "lstm", [(ih, w_hh)])
    return hs


def bilstm_sequence(ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor) -> tuple[Tensor, Tensor]:
    """Both directions of a BiLSTM in one launch; each input and output in its own scan order."""
    _check_device("bilstm_sequence", ih_f)
    _check_pair("bilstm_sequence", ih_f, ih_b, w_f, w_b)
    if ih_f.device.type == "cpu":
        return bilstm_sequence_ref(ih_f, ih_b, w_f, w_b)
    if _needs_grad(ih_f, ih_b, w_f, w_b):
        return _Recurrence.apply(ih_f, w_f, ih_b, w_b)
    hs_f, hs_b = _launch("bilstm_sequence", "bilstm", [(ih_f, w_f), (ih_b, w_b)])
    return hs_f, hs_b


# ---------------------------------------------------------------------------------------------------------------
# The static and dynamic cells (QLSTM's static and dynamic modes)
# ---------------------------------------------------------------------------------------------------------------


def _cell(h: Tensor, c: Tensor, ih_t: Tensor, w_hh: Tensor, q) -> tuple[Tensor, Tensor]:
    """One step of JAX's ``_cell_step`` (``fqss_tpu/nn/lstm.py:40-60``) with ``q(site index, value)`` at each of the
    12 sites; ``h @ w_hh`` as JAX computes it before the step. Also batched over a leading direction axis."""
    H = h.shape[-1]
    i, f, g, o = q(2, q(0, ih_t) + q(1, h @ w_hh)).split(H, dim=-1)
    i, f, g, o = q(3, torch.sigmoid(i)), q(4, torch.sigmoid(f)), q(5, torch.tanh(g)), q(6, torch.sigmoid(o))
    c = q(9, q(7, f * c) + q(8, i * g))
    return q(11, o * q(10, torch.tanh(c))), c


def window_ranges(site_min: Tensor, site_max: Tensor, step_min: Tensor, step_max: Tensor) -> tuple[Tensor, Tensor]:
    """The ranges after the observed steps: for each step ``0.9 r + 0.1 m`` of its min (max) ``m`` of each site, in
    JAX's order and rounding (``step_min``/``step_max`` ``[k, ..., 12]``)."""
    mn, mx = site_min, site_max
    for lo, hi in zip(step_min.unbind(0), step_max.unbind(0)):
        mn = EMA * mn + 0.1 * lo
        mx = EMA * mx + 0.1 * hi
    return mn, mx


def lstm_static_sequence_ref(ih: Tensor, w_hh: Tensor, site_min: Tensor, site_max: Tensor, observe: int,
                             n_bits: int = 8) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`lstm_static_sequence`, in its two parts: the float cell over the first ``observe``
    steps, each site's min and max kept at each step, the ranges' EMA over them, then the quantized cell over the
    rest from the last ``h`` and ``c``. ``-> (hs [T, B, H], site_min, site_max after the window)``; differentiable
    in ``ih``, ``w_hh`` and the ranges (the steps' min and max carry no gradient, as JAX's ``stop_gradient``)."""
    B, G = ih.shape[1:]
    h = ih.new_zeros(B, G // 4)
    c = ih.new_zeros(B, G // 4)
    steps = ih.unbind(0)
    hs, lows, highs = [], [], []
    for ih_t in steps[:observe]:
        seen = [None] * len(SITES)

        def keep(s: int, v: Tensor) -> Tensor:
            seen[s] = v.detach()
            return v

        h, c = _cell(h, c, ih_t, w_hh, keep)
        lows.append(torch.stack([v.amin() for v in seen]))
        highs.append(torch.stack([v.amax() for v in seen]))
        hs.append(h)
    mn, mx = site_min, site_max
    if lows:  # each step's extremes over the global batch, under a mesh
        mn, mx = window_ranges(site_min, site_max, *dp.extremes(torch.stack(lows), torch.stack(highs)))
    for ih_t in steps[observe:]:
        h, c = _cell(h, c, ih_t, w_hh, lambda s, v: linear_fake_quant(v, mn[s], mx[s], n_bits))
        hs.append(h)
    return (torch.stack(hs) if hs else ih.new_zeros(0, B, G // 4)), mn, mx


def _dynamic_recurrence(ih: Tensor, w: Tensor, n_bits: int) -> Tensor:
    """The dynamic cell over ``D`` directions at once: ``ih [D, T, B, 4H]``, ``w [D, H, 4H]`` -> ``[D, T, B, H]``, each
    site of each direction on the grid of its own min and max over the step's ``[B, ·]`` tensor."""
    D, T, B, G = ih.shape
    h = ih.new_zeros(D, B, G // 4)
    c = ih.new_zeros(D, B, G // 4)
    hs = []
    for ih_t in ih.unbind(1):
        h, c = _cell(h, c, ih_t, w, lambda s, v: dynamic_act_quant(v, n_bits, dims=(1, 2)))
        hs.append(h)
    return torch.stack(hs, 1) if hs else ih.new_zeros(D, 0, B, G // 4)


def lstm_dynamic_sequence(ih: Tensor, w_hh: Tensor, n_bits: int = 8) -> Tensor:
    """The dynamic cell over one direction: ``[T, B, 4H]``, ``[H, 4H]`` -> ``[T, B, H]``, plain PyTorch on every
    device (differentiable)."""
    _check_device("lstm_dynamic_sequence", ih)
    _check("lstm_dynamic_sequence", ih, w_hh)
    return _dynamic_recurrence(ih[None], w_hh[None], n_bits)[0]


def bilstm_dynamic_sequence(ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor,
                            n_bits: int = 8) -> tuple[Tensor, Tensor]:
    """The dynamic cell over both directions in one loop (each direction's sites on its own grids)."""
    _check_device("bilstm_dynamic_sequence", ih_f)
    _check_pair("bilstm_dynamic_sequence", ih_f, ih_b, w_f, w_b)
    hs = _dynamic_recurrence(torch.stack([ih_f, ih_b]), torch.stack([w_f, w_b]), n_bits)
    return hs[0], hs[1]


def _check_pair(name: str, ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor) -> None:
    _check(name, ih_f, w_f)
    _check(name, ih_b, w_b)
    if ih_b.shape != ih_f.shape or ih_b.device != ih_f.device:
        raise ValueError(f"{name}: the directions differ: {tuple(ih_f.shape)} on {ih_f.device}, "
                         f"{tuple(ih_b.shape)} on {ih_b.device}")


def _check_sites(name: str, ih: Tensor, site_min: Tensor, site_max: Tensor, observe: int) -> None:
    for arg, t in (("site_min", site_min), ("site_max", site_max)):
        if t.shape != (len(SITES),) or t.dtype != torch.float32 or t.device != ih.device:
            raise ValueError(f"{name}: {arg} must be float32 [{len(SITES)}] on {ih.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= observe <= ih.shape[0]:
        raise ValueError(f"{name}: observe = {observe} steps of a call of {ih.shape[0]}")


def _pointers(*tensors: Tensor | None) -> list[int]:
    return [0 if t is None else t.data_ptr() for t in tensors]


def _static_launch(name: str, key: str, dirs: list[tuple[Tensor, ...]], observe: int,
                   n_bits: int) -> tuple[list[Tensor], list[Tensor], list[Tensor]]:
    """The static route over one or two directions' ``(ih, w_hh, site_min, site_max)``: the observed launch over the
    first ``observe`` steps and the EMA, then the quantized launch; counted under ``key`` once a launch. Their
    ``hs`` and the ranges after the window."""
    ih = dirs[0][0]
    T, B, G = ih.shape
    H = G // 4
    outs = [torch.empty(T, B, H, device=ih.device) for _ in dirs]
    mins, maxs = [d[2] for d in dirs], [d[3] for d in dirs]
    if not ih.numel():
        return outs, mins, maxs
    lib = _build.library()
    if H > lib.fqss_lstm_max_hidden():
        raise ValueError(f"{name}: H = {H} exceeds the kernel's shared memory (at most {lib.fqss_lstm_max_hidden()})")

    def launch(mode: int, steps: int, table: list[int]) -> None:
        p = launch_plan(ih.device, B, H, len(dirs), mode)
        ptrs = (ctypes.c_int64 * len(table))(*table)
        cluster = p.cluster if p.route == "cluster" else 0
        with torch.cuda.device(ih.device):
            stream = torch.cuda.current_stream(ih.device).cuda_stream
            if mode == MODES["observe"]:
                rc = lib.fqss_lstm_observe(ptrs, len(dirs), steps, B, H, cluster, p.rows, stream)
            else:
                rc = lib.fqss_lstm_static(ptrs, len(dirs), steps, B, H, cluster, p.rows, n_bits, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        LAUNCHES[key] += 1

    k = observe
    c_k = [torch.empty(B, H, device=ih.device) if k < T else None for _ in dirs] if k else [None] * len(dirs)
    if k:
        partials = 8 * launch_plan(ih.device, B, H, len(dirs), MODES["observe"]).ctas // len(dirs)
        stats = [torch.empty(k, partials, len(SITES), 2, device=ih.device) for _ in dirs]
        launch(MODES["observe"], k, [v for d, out, cl, st in zip(dirs, outs, c_k, stats)
                                     for v in _pointers(d[0], d[1], out, None, None, cl, None, None, st)])
        for i, st in enumerate(stats):  # each step's extremes over the global batch, under a mesh
            mins[i], maxs[i] = window_ranges(mins[i], maxs[i], *dp.extremes(st[..., 0].amin(1), st[..., 1].amax(1)))
    if k < T:
        mins = [m.contiguous() for m in mins]
        maxs = [m.contiguous() for m in maxs]
        launch(MODES["static"], T - k, [v for d, out, cl, mn, mx in zip(dirs, outs, c_k, mins, maxs)
                                        for v in _pointers(d[0][k:], d[1], out[k:], out[k - 1] if k else None, cl,
                                                           None, mn, mx, None)])
    return outs, mins, maxs


class _StaticRecurrence(torch.autograd.Function):
    """The static route's launches forward; the backward differentiates the plain static recurrence (the same two
    parts), recomputed from the saved inputs. Inputs: ``observe``, ``n_bits``, then ``(ih, w_hh, site_min,
    site_max)`` of each direction; outputs: each direction's ``hs``, then its ranges after the window (no
    gradient)."""

    @staticmethod
    def forward(ctx, observe, n_bits, *flat):
        ctx.observe, ctx.n_bits, ctx.mesh = observe, n_bits, dp.active()
        ctx.save_for_backward(*flat)
        dirs = [flat[i : i + 4] for i in range(0, len(flat), 4)]
        name, key = ("lstm_static_sequence", "lstm_static") if len(dirs) == 1 else ("bilstm_static_sequence",
                                                                                     "bilstm_static")
        outs, mins, maxs = _static_launch(name, key, dirs, observe, n_bits)
        ranges = [r.clone() for pair in zip(mins, maxs) for r in pair]  # new tensors, where no step was observed too
        ctx.mark_non_differentiable(*ranges)
        return (*outs, *ranges)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n = len(saved) // 4
        # the recomputed window's extremes over the forward's ranks (the engine's thread does not see its mesh)
        with torch.enable_grad(), dp.sharded(ctx.mesh):
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad[2:])]
            outs = [lstm_static_sequence_ref(*inputs[4 * i : 4 * i + 4], ctx.observe, ctx.n_bits)[0] for i in range(n)]
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads[:n], allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in inputs))


def _static(name: str, key: str, dirs: list[tuple[Tensor, ...]], observe: int, n_bits: int) -> list[Tensor]:
    """``[hs, site_min, site_max]`` of each direction, flat: the plain version on the CPU, else the launches (through
    the autograd Function where a gradient is needed)."""
    if dirs[0][0].device.type == "cpu":
        return [v for d in dirs for v in lstm_static_sequence_ref(*d, observe, n_bits)]
    if _needs_grad(*(t for d in dirs for t in d)):
        # copies of the ranges: the module writes its own in place after the call, and the backward needs these
        got = _StaticRecurrence.apply(observe, n_bits, *(t.clone() if i >= 2 else t for d in dirs
                                                         for i, t in enumerate(d)))
        n = len(dirs)
        return [v for i in range(n) for v in (got[i], got[n + 2 * i], got[n + 2 * i + 1])]
    outs, mins, maxs = _static_launch(name, key, dirs, observe, n_bits)
    return [v for trio in zip(outs, mins, maxs) for v in trio]


def lstm_static_sequence(ih: Tensor, w_hh: Tensor, site_min: Tensor, site_max: Tensor, observe: int = 0,
                         n_bits: int = 8) -> tuple[Tensor, Tensor, Tensor]:
    """The static cell over one direction: ``[T, B, 4H]``, ``[H, 4H]``, ranges ``[12]`` -> ``(hs [T, B, H], site_min,
    site_max after the call's first ``observe`` steps, which are the observer window's)``."""
    _check_device("lstm_static_sequence", ih)
    _check("lstm_static_sequence", ih, w_hh)
    _check_sites("lstm_static_sequence", ih, site_min, site_max, observe)
    hs, mn, mx = _static("lstm_static_sequence", "lstm_static", [(ih, w_hh, site_min, site_max)], observe, n_bits)
    return hs, mn, mx


def bilstm_static_sequence(ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor, sites_f: tuple[Tensor, Tensor],
                           sites_b: tuple[Tensor, Tensor], observe: int = 0,
                           n_bits: int = 8) -> tuple[Tensor, Tensor, tuple[Tensor, Tensor], tuple[Tensor, Tensor]]:
    """The static cell over both directions in one launch (two in a call inside the window); ``sites_*`` are each
    direction's ``(site_min, site_max)``, and both directions take the same window. ``-> (hs_f, hs_b, (site_min,
    site_max) of each after the call)``."""
    name = "bilstm_static_sequence"
    _check_device(name, ih_f)
    _check_pair(name, ih_f, ih_b, w_f, w_b)
    _check_sites(name, ih_f, *sites_f, observe)
    _check_sites(name, ih_b, *sites_b, observe)
    hs_f, mn_f, mx_f, hs_b, mn_b, mx_b = _static(name, "bilstm_static", [(ih_f, w_f, *sites_f), (ih_b, w_b, *sites_b)],
                                                 observe, n_bits)
    return hs_f, hs_b, (mn_f, mx_f), (mn_b, mx_b)
