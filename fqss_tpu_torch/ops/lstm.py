"""LSTM recurrence: wrappers, plain versions and launch counters.

The CUDA kernel in ``csrc/lstm.cu`` replaces the TPU kernels of the LSTM
recurrence, ``fqss_tpu/ops/pallas_lstm.py``:

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
port. ``LAUNCHES`` counts the kernel's launches, one per call that launches
it; the backward launches none.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import _check_device, _needs_grad

Tensor = torch.Tensor

LAUNCHES = {"lstm": 0, "bilstm": 0}


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


def cluster_smem(H: int, cluster: int, rows: int) -> int:
    """Shared-memory bytes of one CTA of the cluster route (with its 16 mbarriers)."""
    units = -(-H // cluster)
    return 4 * (4 * H * units + 2 * rows * H) + 8 * 16


def cluster_size(H: int) -> int | None:
    """The least cluster whose CTAs each hold their slice of ``w_hh`` with the smallest row tile; None where no
    cluster of MAX_CLUSTER does (the blocks route)."""
    for c in range(1, MAX_CLUSTER + 1):
        if -(-H // c) <= CTA_UNITS and cluster_smem(H, c, TILE_ROWS[0]) <= SMEM_BYTES:
            return c
    return None


def cluster_tiles(H: int) -> tuple[int, ...]:
    """The row tiles whose CTAs fit in shared memory at H (with :func:`cluster_size`'s cluster)."""
    c = cluster_size(H)
    return () if c is None else tuple(r for r in TILE_ROWS if cluster_smem(H, c, r) <= SMEM_BYTES)


def plan(B: int, H: int, dirs: int, coresident: int) -> Plan:
    """The launch of ``dirs`` directions of B rows at H, given how many clusters of the largest fitting tile fit
    co-resident on the card: the least row tile whose clusters all fit, else the largest tile."""
    c = cluster_size(H)
    if c is None:
        return Plan("blocks", 1, BLOCKS_ROWS, dirs * -(-B // BLOCKS_ROWS))
    tiles = cluster_tiles(H)
    rows = next((r for r in tiles if dirs * -(-B // r) <= coresident), tiles[-1])
    return Plan("cluster", c, rows, dirs * -(-B // rows))


_CORESIDENT: dict[tuple[int, int], int] = {}


def coresident(device: torch.device, H: int) -> int:
    """Clusters of the cluster route at H and its largest fitting tile that fit co-resident on ``device``, asked of
    the card once a device and H."""
    key = (device.index, H)
    if key not in _CORESIDENT:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _build.library().fqss_lstm_cluster_max_active(H, cluster_size(H), cluster_tiles(H)[-1],
                                                               ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"lstm: cudaOccupancyMaxActiveClusters failed with error {rc} ({n.value} clusters)")
        _CORESIDENT[key] = n.value
    return _CORESIDENT[key]


def launch_plan(device: torch.device, B: int, H: int, dirs: int) -> Plan:
    """The plan a launch on ``device`` takes."""
    return plan(B, H, dirs, coresident(device, H) if cluster_size(H) is not None else 0)


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
    _check("bilstm_sequence", ih_f, w_f)
    _check("bilstm_sequence", ih_b, w_b)
    if ih_b.shape != ih_f.shape or ih_b.device != ih_f.device:
        raise ValueError(f"bilstm_sequence: the directions differ: {tuple(ih_f.shape)} on {ih_f.device}, "
                         f"{tuple(ih_b.shape)} on {ih_b.device}")
    if ih_f.device.type == "cpu":
        return bilstm_sequence_ref(ih_f, ih_b, w_f, w_b)
    if _needs_grad(ih_f, ih_b, w_f, w_b):
        return _Recurrence.apply(ih_f, w_f, ih_b, w_b)
    hs_f, hs_b = _launch("bilstm_sequence", "bilstm", [(ih_f, w_f), (ih_b, w_b)])
    return hs_f, hs_b
