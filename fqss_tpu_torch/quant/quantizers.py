"""Learned fake-quantizer modules (``fqss_tpu/quant/quantizers.py``).

Each quantizer keeps its learned ranges as parameters (the JAX ``qparams``
collection) and its observer counter as a buffer (``qstats``):

* :class:`ActQuantizer` — per-tensor uniform grid. For its first
  ``max_observations`` calls in ``train()`` mode it tracks the batch min/max
  with an EMA (alpha = 0.9) and returns the input unquantized; afterwards it
  fake-quantizes with the ranges. Under a data-parallel mesh the min/max (and
  the MSE quantizer's counts) are the global batch's (``parallel/mesh.py``),
  except for a ``replicated`` quantizer's constant input. ``kind='mulaw'`` is the mu-law grid
  with a learnable ``mu``, under the same observer.
* :class:`MseActQuantizer` — the same uniform grid, with ranges that the
  host's MSE search sets from a histogram observed in the window.
* :class:`WeightQuantizer` — per-channel symmetric grid. A one-shot observer
  captures the per-channel min/max on the first ``train()`` call, which
  returns the float weights once.
* :func:`dynamic_act_quant` — the stateless grid from each call's own
  min/max, at the 12 sites of the LSTM's dynamic cell.

State is written only in ``train()`` mode, and under ``torch.no_grad()``.
In ``eval()`` mode a quantizer still inside its observer window returns its
input and writes nothing, as a JAX call without mutable collections does
(``fqss_tpu/quant/quantizers.py:21-24``); inside :func:`read_only` (a
pipeline stage, ``parallel/pp.py``) so does one in ``train()`` mode. The window test stays on the
device (``torch.where`` on the counter): no call waits for the card.

The quantize op itself is :mod:`fqss_tpu_torch.ops.fake_quant`: CUDA
kernels forward and backward on CUDA tensors, the plain versions on CPU
tensors.

A model's forward opens a :func:`weight_pass`: all of its weight
quantizers (:func:`weight_quantizer_sites`) run as one grouped call,
:func:`fqss_tpu_torch.ops.fake_quant.weight_fake_quant_group`, one launch
forward and one backward, with the one-shot observers inside. Within the
pass each ``WeightQuantizer`` returns its entry of that call, and a layer
that fuses its weight grid into its own kernel (``QDense``, the K3
``QConv1d``) takes the entry with the kernel's weight grid off. A quantizer
reached again in ``train()`` mode takes its own call, as the JAX module's
second call in one apply sees the flag the first one set; one called
outside a pass (a layer alone, the fold) takes its own call too. A layer that fuses its quantizers into its own kernel
(``QDense``, :mod:`fqss_tpu_torch.ops.qat_dense`) takes the window test
from :meth:`observing`, hands the flag and the ranges to the kernel, and
calls :meth:`observe` for the writes: the same values and the same state
writes, still without a wait for the card. Gradients reach the input and, with ``gradient_based``, the ranges,
with the JAX package's rules; ``scale_grad`` (LSQ step-size scaling) is off
by default, as on the JAX ConvTasNet path.
"""

from __future__ import annotations

import contextlib
import contextvars
import weakref
from typing import Iterator, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn

from fqss_tpu_torch.ops.fake_quant import (
    WeightEntry,
    WeightGroup,
    act_fake_quant,
    weight_fake_quant,
    weight_fake_quant_group,
)
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant import histogram
from fqss_tpu_torch.quant.fake_quant import linear_fake_quant, mulaw_fake_quant, qrange, true_div, weight_scale
from fqss_tpu_torch.quant.ste import round_ste

Tensor = torch.Tensor

_READ_ONLY: contextvars.ContextVar[bool] = contextvars.ContextVar("fqss_tpu_torch_read_only", default=False)


@contextlib.contextmanager
def read_only() -> Iterator[None]:
    """Inside this block no quantizer writes its state, in ``train()`` mode too: each reads its ranges, flags and
    counters and computes what it would in ``eval()`` mode (an act quantizer inside its window returns its input, an
    unobserved weight quantizer its float weight), and the grouped pass launches no flag kernel. A JAX apply without
    mutable collections, as ``fqss_tpu/parallel/pp.py`` applies a pipeline stage."""
    token = _READ_ONLY.set(True)
    try:
        yield
    finally:
        _READ_ONLY.reset(token)


def writes(module: nn.Module) -> bool:
    """Whether ``module`` (a quantizer, or a layer that feeds observers) writes its state in this call: in
    ``train()`` mode, outside :func:`read_only`."""
    return module.training and not _READ_ONLY.get()


class ActQuantizer(nn.Module):
    """Per-tensor learned activation fake-quantizer.

    ``kind='linear'`` matches GradientActivationFakeQuantize (qat_quant.py:206-242); ``kind='mulaw'`` matches
    GradientNlActivationFakeQuantize (qat_quant.py:167-203), the mu-law grid
    (:func:`~fqss_tpu_torch.quant.fake_quant.mulaw_fake_quant`) with a learnable ``mu`` (init 1.0), and the same EMA
    observer. A caller that fuses the quantizer into its kernel's epilogue takes a linear one only.
    """

    ALPHA = 0.9  # EMA weight of the old range (qat_quant.py:227-242)

    def __init__(self, n_bits: int = 8, gradient_based: bool = True, observer: bool = True,
                 max_observations: int = 50, scale_grad: bool = False, kind: str = "linear"):
        super().__init__()
        self.kind = kind
        self.n_bits = n_bits
        self.scale_grad = scale_grad
        self.observer = observer
        self.max_observations = max_observations
        self.min_range = nn.Parameter(torch.full((1,), -0.5), requires_grad=gradient_based)
        self.max_range = nn.Parameter(torch.full((1,), 0.5), requires_grad=gradient_based)
        if kind == "mulaw":
            self.mu = nn.Parameter(torch.ones(1), requires_grad=gradient_based)
        self.register_buffer("n_iter", torch.zeros((), dtype=torch.int32))
        # The input is a constant, the same on every data-parallel rank (a positional embedding): observed as
        # this rank's alone, as JAX observes a replicated array once. Else it is a batch's, reduced over the ranks.
        self.replicated = False
        # The input is sharded over the tensor-parallel ranks too (parallel/tp.py): observed over every rank of the
        # grid, as GSPMD's observer sees the whole tensor.
        self.tp_sharded = False

    def observing(self) -> Tensor | None:
        """The device-resident window test (``n_iter < max_observations``), or None without an observer."""
        return self.n_iter < self.max_observations if self.observer else None

    def _observed_over(self) -> contextlib.AbstractContextManager:
        """The ranks an observation reduces over: the active mesh's data ranks, every rank of the grid for a tensor
        that tp shards, or this rank's alone for a constant."""
        if self.replicated:
            return dp.sharded(None)
        mesh = dp.active()
        if self.tp_sharded and mesh is not None:
            return dp.sharded(mesh.whole())
        return contextlib.nullcontext()

    def observe(self, x: Tensor, observing: Tensor | None) -> None:
        """The observer's EMA write of ``x``'s min/max and the counter step, in ``train()`` mode only.

        ``observing`` is :meth:`observing` taken before the quantize call. Only
        the values of ``x`` where ``observing`` holds are kept, so a fused caller
        may pass its output, which is ``x`` unquantized there."""
        if observing is None or not writes(self):
            return
        with torch.no_grad(), self._observed_over():
            a = self.ALPHA
            mn, mx = dp.extremes(x.min().reshape(1), x.max().reshape(1))  # the global batch's, under a mesh
            new_min = a * self.min_range + (1.0 - a) * mn
            new_max = a * self.max_range + (1.0 - a) * mx
            self.min_range.copy_(torch.where(observing, new_min, self.min_range))
            self.max_range.copy_(torch.where(observing, new_max, self.max_range))
            self.n_iter.add_(observing.to(torch.int32))

    def quantize(self, x: Tensor) -> Tensor:
        """``x`` on the grid of the current ranges (and ``mu``)."""
        if self.kind == "mulaw":  # copies of the ranges, which the observer then writes in place
            return mulaw_fake_quant(x, self.min_range.clone(), self.max_range.clone(), self.mu, self.n_bits,
                                    self.scale_grad)
        return act_fake_quant(x, self.min_range, self.max_range, self.n_bits, self.scale_grad)

    def forward(self, x: Tensor) -> Tensor:
        # Quantize with the ranges as they are before the observer's write
        # below, as the JAX module does.
        y = self.quantize(x)
        observing = self.observing()
        if observing is None:
            return y
        self.observe(x, observing)
        return torch.where(observing, x, y)


class MseActQuantizer(ActQuantizer):
    """Histogram/MSE-calibrated activation quantizer (qat_quant.py:245-326; ``fqss_tpu/quant/quantizers.py:
    MseActQuantizer``).

    In ``train()`` mode, while ``n_iter < max_observations`` and it is not calibrated, each call adds its input to a
    running histogram over a window that grows to the values seen (buffers ``hist [512]``, ``val_min``, ``val_max``,
    ``n_iter``; :func:`fqss_tpu_torch.quant.histogram.observe`). With an observer it returns its input unquantized
    until it is calibrated, after the window's end too. The host's grid search
    (:func:`fqss_tpu_torch.quant.calibration.calibrate_mse_quantizers`) then writes the MSE-optimal ranges and sets
    ``calibrated``, and it quantizes on the linear grid, K1's. A fused caller takes :meth:`observing`, here "not
    calibrated", as its kernel's window flag, and :meth:`observe` with the kernel's output, which is then the
    unquantized value.
    """

    def __init__(self, n_bits: int = 8, gradient_based: bool = True, observer: bool = True,
                 max_observations: int = 50, scale_grad: bool = False):
        super().__init__(n_bits, gradient_based, observer, max_observations, scale_grad)
        self.register_buffer("hist", torch.zeros(histogram.N_BINS))
        self.register_buffer("val_min", torch.zeros(()))
        self.register_buffer("val_max", torch.zeros(()))
        self.register_buffer("calibrated", torch.zeros((), dtype=torch.bool))

    def observing(self) -> Tensor | None:
        """The device-resident flag "return the input": ``not calibrated``, or None without an observer."""
        return ~self.calibrated if self.observer else None

    def observe(self, x: Tensor, observing: Tensor | None) -> None:
        """One histogram observation of ``x`` in ``train()`` mode, kept while ``n_iter < max_observations`` and not
        calibrated. ``observing`` is :meth:`observing` (it does not decide the write)."""
        if observing is None or not writes(self):
            return
        with torch.no_grad(), self._observed_over():
            keep = (self.n_iter < self.max_observations) & ~self.calibrated
            hist, nmin, nmax = histogram.observe(x, self.hist, self.val_min, self.val_max, self.n_iter == 0)
            self.hist.copy_(torch.where(keep, hist, self.hist))
            self.val_min.copy_(torch.where(keep, nmin, self.val_min))
            self.val_max.copy_(torch.where(keep, nmax, self.val_max))
            self.n_iter.add_(keep.to(torch.int32))


def dynamic_act_quant(x: Tensor, n_bits: int = 8, sym: bool = False, factor: float = 0.99,
                      dims: tuple[int, ...] | None = None) -> Tensor:
    """Stateless dynamic fake-quantizer (qat_quant.py:329-347; ``fqss_tpu/quant/quantizers.py:187-197``).

    The per-call min and max of ``x`` (over ``dims``, all of them by default) times ``factor``, against outliers;
    ``sign = min < 0`` picks the signed or unsigned window of the symmetric grid (the uniform grid ignores it); the
    identity where ``min == max``. The gradient is the JAX function's: the STE of
    :func:`~fqss_tpu_torch.quant.fake_quant.linear_fake_quant`, and through the min and max (``amin``/``amax``
    split a tie evenly, as ``jnp.min``/``jnp.max`` do). Where ``min == max`` JAX's gradient is NaN (the unselected
    branch divides 0 by a zero grid step, and ``where`` passes 0 × NaN on); here that branch takes a stand-in
    range, so the gradient there is the identity's, as the reference's early return gives it.
    """
    if dp.active() is not None:  # the global batch's, with jnp.min's gradient
        mn, mx = dp.batch_extremes(x, dims if dims is not None else tuple(range(x.ndim)))
        if dims is None:
            mn, mx = mn.reshape(()), mx.reshape(())
    else:
        mn = x.amin(dim=dims, keepdim=dims is not None)
        mx = x.amax(dim=dims, keepdim=dims is not None)
    flat = mn == mx
    lo = torch.where(flat, torch.zeros_like(mn), factor * mn)
    hi = torch.where(flat, torch.ones_like(mx), factor * mx)
    if sym:  # jnp.clip(X, qmin, qmax) with the window a tensor: minimum(maximum(...)), 0.5 at a tie
        sign = mn < 0
        qmin = torch.where(sign, float(qrange(n_bits, True)[0]), 0.0)
        qmax = torch.where(sign, float(qrange(n_bits, True)[1]), float(qrange(n_bits, False)[1]))
        delta = true_div(2.0 * torch.maximum(lo.abs(), hi.abs()), 2**n_bits - 1)
        y = delta * torch.minimum(torch.maximum(round_ste(x / delta), qmin), qmax)
    else:
        y = linear_fake_quant(x, lo, hi, n_bits, sym=False)
    return torch.where(flat, x, y)


class TpWeight(NamedTuple):
    """A weight quantizer's weight under tensor parallelism (``parallel/tp.py``): ``column`` (the rank holds the
    out-channels ``rows`` of the ranges' ``channels``) or ``row`` (every out-channel, a shard of its inputs)."""

    kind: str
    rows: Tensor | None
    channels: int


class WeightQuantizer(nn.Module):
    """Per-channel symmetric learned weight fake-quantizer.

    Matches GradientWeightFakeQuantize (qat_quant.py:350-381). ``weight_shape``
    is the torch-layout shape of the weight; ``ch_axis`` its channel axis
    (0 for conv weights ``[Cout, Cin/g, k]``, 1 for transposed-conv weights
    ``[Cin, Cout, k]``). The ranges keep the keepdims layout.
    """

    def __init__(self, weight_shape: Sequence[int], n_bits: int = 8, ch_axis: int = 0,
                 gradient_based: bool = True, observer: bool = True, scale_grad: bool = False):
        super().__init__()
        self.n_bits = n_bits
        self.scale_grad = scale_grad
        self.ch_axis = ch_axis
        self.observer = observer
        shape = [1] * len(weight_shape)
        shape[ch_axis] = weight_shape[ch_axis]
        self.reduce_dims = tuple(i for i in range(len(weight_shape)) if i != ch_axis)
        self.min_range = nn.Parameter(torch.full(shape, -0.5), requires_grad=gradient_based)
        self.max_range = nn.Parameter(torch.full(shape, 0.5), requires_grad=gradient_based)
        self.register_buffer("observed", torch.zeros((), dtype=torch.bool))
        self._pass: list | None = None  # inside a weight_pass: [weight, its entry's tensor, reached]
        self.tp: TpWeight | None = None  # a shard's weight (parallel/tp.py): quantized in a weight pass only

    def observing(self) -> Tensor | None:
        """The device-resident flag ``~observed``, or None without an observer."""
        return ~self.observed if self.observer else None

    def observe(self, w: Tensor, observing: Tensor | None) -> None:
        """The one-shot observer: in ``train()`` mode, where ``observing``, the ranges become ``w``'s per-channel
        min/max, before the quantize call that uses them."""
        if observing is None or not writes(self):
            return
        with torch.no_grad():
            self.min_range.copy_(torch.where(observing, w.amin(self.reduce_dims, keepdim=True), self.min_range))
            self.max_range.copy_(torch.where(observing, w.amax(self.reduce_dims, keepdim=True), self.max_range))
            self.observed.fill_(True)

    def entry(self, w: Tensor) -> WeightEntry:
        """This quantizer on ``w`` as an entry of a grouped call."""
        return WeightEntry(w, self.min_range, self.max_range, self.observed if self.observer else None,
                           writes(self), self.n_bits, self.ch_axis,
                           weight_scale(w.shape[self.ch_axis], self.n_bits, self.scale_grad))

    def refuse_shard(self) -> None:
        """A shard's weight takes its grid in a model's weight pass alone, where its ranges reduce over tp."""
        if self.tp is not None:
            raise NotImplementedError("a tensor-parallel weight quantizer runs inside its model's weight pass")

    def ranges(self) -> tuple[Tensor, Tensor]:
        """The ranges of the weight this rank holds: a column shard's rows of the whole ranges (a gather, whose
        gradient reaches the whole ranges), else the ranges themselves."""
        if self.tp is None or self.tp.kind != "column":
            return self.min_range, self.max_range
        rows = self.tp.rows.to(self.min_range.device)
        return self.min_range.index_select(0, rows), self.max_range.index_select(0, rows)

    def grouped(self, w: Tensor) -> Tensor | None:
        """Inside a :func:`weight_pass`, the pass's tensor for ``w`` (the weight the pass took), or None where
        this call must take its own: outside a pass, and when the quantizer is reached again in ``train()`` mode
        with an observer (JAX's second call then quantizes with the ranges the first one observed)."""
        state = self.__dict__.get("_pass")
        if state is None or w is not state[0]:
            return None
        if state[2] and writes(self) and self.observer:
            return None
        state[2] = True
        return state[1]

    def forward(self, w: Tensor) -> Tensor:
        y = self.grouped(w)
        if y is not None:
            return y
        self.refuse_shard()
        observing = self.observing()
        self.observe(w, observing)
        y = weight_fake_quant(w, self.min_range, self.max_range, self.n_bits, self.ch_axis, self.scale_grad)
        return y if observing is None else torch.where(observing, w, y)


# A layer's weight quantizers and the parameter each quantizes, where the layer does not name them itself in a
# class attribute ``WEIGHT_QUANTIZERS`` (fqss_tpu_torch/nn/layers.py).
DEFAULT_WEIGHT_QUANTIZERS = {"weight_fake_quantize": "weight"}


def weight_quantizer_sites(model: nn.Module) -> list[tuple[nn.Module, str, str]]:
    """``(layer, quantizer name, weight name)`` of every ``WeightQuantizer`` in ``model``'s tree, in module order:
    a layer's ``weight`` and its ``weight_fake_quantize``, or the pairs its ``WEIGHT_QUANTIZERS`` lists (the LSTM's
    ``w_ih``/``w_hh`` per direction, the attention's in- and out-projections, the combiner's residual coders)."""
    return [(layer, qname, wname) for layer in model.modules()
            for qname, wname in getattr(layer, "WEIGHT_QUANTIZERS", DEFAULT_WEIGHT_QUANTIZERS).items()
            if isinstance(getattr(layer, qname, None), WeightQuantizer)]


class _PassCache:
    """A model's weight quantizer sites, and the grouped call's table with the key it was built for (the sites of
    replicated weights: a tensor-parallel shard's table is built on every pass, ``_tp_pass``). The pass runs on
    every forward, so it reads the tree through the modules' own dictionaries (``Module.__getattr__`` costs a
    microsecond a lookup)."""

    def __init__(self, model: nn.Module):
        sites = weight_quantizer_sites(model)
        self.modules = [(layer._modules, qname) for layer, qname, _ in sites]
        self.weights = [(layer, wname) for layer, _, wname in sites]
        self.quantizers = [getattr(layer, qname) for layer, qname, _ in sites]
        self.whole = [i for i, wq in enumerate(self.quantizers) if wq.tp is None]
        self.shards = [i for i, wq in enumerate(self.quantizers) if wq.tp is not None]
        self.key: tuple | None = None
        self.group: WeightGroup | None = None

    def stale(self) -> bool:
        return any(modules.get(qname) is not wq for (modules, qname), wq in zip(self.modules, self.quantizers))

    def current(self) -> tuple[list[Tensor], tuple]:
        """The weights as the layers hold them now, and what the group's table depends on: every weight's,
        range's and flag's tensor and storage, each quantizer's mode and settings."""
        weights = [layer._parameters.get(wname) for layer, wname in self.weights]
        weights = [w if w is not None else getattr(layer, wname) for w, (layer, wname) in zip(weights, self.weights)]
        tensors = [weights[i] for i in self.whole]
        for wq in (self.quantizers[i] for i in self.whole):
            params = wq._parameters
            tensors += (params["min_range"], params["max_range"], wq._buffers["observed"])
        settings = tuple((writes(wq), wq.observer, wq.n_bits, wq.ch_axis, wq.scale_grad) for wq in self.quantizers)
        return weights, (weights[0].device, tuple(map(id, tensors)), tuple(map(Tensor.data_ptr, tensors)), settings)


def forget_weight_pass(model: nn.Module) -> None:
    """Drop ``model``'s cached pass (its sites changed kind: ``parallel/tp.py`` sharded some)."""
    _PASSES.pop(model, None)


def _tp_pass(weights: list[Tensor], quantizers: list[WeightQuantizer]) -> list[Tensor]:
    """The grouped call for tensor-parallel shards' weights (``WeightQuantizer.tp``), split in three where an
    observer writes: observe the table (a grouped launch that writes each entry's extremes over this rank's shard
    into copies of its ranges, where observing), reduce the extremes over the tp ranks (a column shard contributes
    its rows, a row shard a partial extreme of every channel: one ``all_reduce`` of them all), write the whole
    ranges where observing and set the flags; then quantize (a grouped launch on the ranges this rank's weight
    takes, ``WeightQuantizer.ranges``, that writes nothing: an entry that was observing returns its weight),
    differentiable as the pass's call."""
    observing = [(w, wq) for w, wq in zip(weights, quantizers) if writes(wq) and wq.observer]
    # the flags as this call found them: an entry that observes now returns its weight, as WeightQuantizer's call
    flags = {id(wq): wq.observed.clone() for _, wq in observing}
    if observing:
        mesh = dp.active()
        if mesh is None:
            raise RuntimeError("a tensor-parallel model's forward runs inside parallel.mesh.sharded() of its grid")
        with torch.no_grad():
            copies = [tuple(t.detach().clone() for t in (*wq.ranges(), wq.observed)) for _, wq in observing]
            weight_fake_quant_group(WeightGroup([WeightEntry(w.detach(), mn, mx, flag, True, wq.n_bits, wq.ch_axis, 1.0)
                                                 for (w, wq), (mn, mx, flag) in zip(observing, copies)]))
            lows, highs = [], []
            for (_, wq), (mn, mx, _) in zip(observing, copies):
                if wq.tp.kind == "column":  # the other ranks' rows: the extremes' identities
                    rows = wq.tp.rows.to(mn.device)
                    mn = torch.full_like(wq.min_range, float("inf")).index_copy_(0, rows, mn)
                    mx = torch.full_like(wq.max_range, float("-inf")).index_copy_(0, rows, mx)
                lows.append(mn.reshape(-1))
                highs.append(mx.reshape(-1))
            buf = torch.cat([torch.cat(lows).neg(), torch.cat(highs)])
            if mesh.tp_size > 1:
                dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.tp_group)
            lo, hi = buf.split(buf.numel() // 2)
            offset = 0
            for _, wq in observing:
                n = wq.min_range.numel()
                sel = ~wq.observed
                wq.min_range.copy_(torch.where(sel, -lo[offset:offset + n].view_as(wq.min_range), wq.min_range))
                wq.max_range.copy_(torch.where(sel, hi[offset:offset + n].view_as(wq.max_range), wq.max_range))
                wq.observed.fill_(True)
                offset += n
    entries = []
    for w, wq in zip(weights, quantizers):
        mn, mx = wq.ranges()
        flag = flags.get(id(wq), wq.observed) if wq.observer else None
        entries.append(WeightEntry(w, mn, mx, flag, False, wq.n_bits, wq.ch_axis,
                                   weight_scale(wq.tp.channels, wq.n_bits, wq.scale_grad)))
    return weight_fake_quant_group(WeightGroup(entries))


# Each model's cache, outside the model: a copy or a pickle of the model never carries device pointers, and the
# cache goes with the model. It holds nothing of the computation: a stale table is rebuilt, not used.
_PASSES: "weakref.WeakKeyDictionary[nn.Module, _PassCache]" = weakref.WeakKeyDictionary()


@contextlib.contextmanager
def weight_pass(model: nn.Module) -> Iterator[None]:
    """Run all of ``model``'s weight quantizers as one grouped call, and let each return its entry inside.

    The call is :func:`fqss_tpu_torch.ops.fake_quant.weight_fake_quant_group`: one kernel launch (and, in
    ``train()`` mode, one that sets the observers' flags), one backward launch. Its table is kept per model and
    rebuilt when a weight, range or flag changes storage, or a quantizer's mode or settings change. A model without
    weight quantizers (folded, float) launches nothing. Every quantizer observes at the pass's start, as each would
    at its own call; a quantizer that the forward does not reach has observed all the same."""
    cache = _PASSES.get(model)
    if cache is None or cache.stale():
        cache = _PASSES[model] = _PassCache(model)
    if not cache.quantizers:
        yield
        return
    weights, key = cache.current()
    quantizers = cache.quantizers
    outs: list = [None] * len(quantizers)
    if cache.whole:
        if key != cache.key:
            cache.group = WeightGroup([quantizers[i].entry(weights[i]) for i in cache.whole])
            cache.key = key
        for i, y in zip(cache.whole, weight_fake_quant_group(cache.group)):
            outs[i] = y
    if cache.shards:
        for i, y in zip(cache.shards, _tp_pass([weights[i] for i in cache.shards],
                                               [quantizers[i] for i in cache.shards])):
            outs[i] = y
    for w, wq, y in zip(weights, quantizers, outs):
        wq.__dict__["_pass"] = [w, y, False]
    try:
        yield
    finally:
        for wq in quantizers:
            wq.__dict__["_pass"] = None
