"""Real-time streaming source separation (``fqss_tpu/serve/streaming.py``).

Audio arrives in pushes of any size; the model runs on a fixed
``segment``-sample window every ``stride`` new samples, and the outputs are
cross-faded with the triangular window of offline OLA, so a drained stream
equals :func:`fqss_tpu_torch.separation.ola.ola_infer` with
``chunk_batch=1`` on the whole track (``tests/test_torch_streaming.py``).

A sample is emitted once the last window covering it has run: at most
``segment`` samples (and one model call) behind the newest sample received.
The ring buffers are numpy arrays on the host and hold O(segment) samples,
however long the stream.

Consecutive windows may give the sources in another order (the PIT
ambiguity). With ``align_sources=True`` each window's sources are
re-ordered to the running output by the largest correlation on the overlap
before they are added: the live counterpart of the evaluation's
``swap_channel_order``, which needs the clean sources.

``apply_fn`` is any serving forward of the port (the fake-quant model, its
weight-folded copy, an int8 engine): it takes one window ``[1, segment]``
(``[1, C, segment]`` in stereo) as a tensor on ``device`` and returns
``[1, S, segment']`` (``[1, S, C, segment']``). With ``device=None`` it is a
host function of numpy arrays.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable

import numpy as np
import torch

from fqss_tpu_torch.separation.ola import triangular_weight

Array = np.ndarray


class StreamingSeparator:
    """Stateful chunked separation of an unbounded audio stream.

    apply_fn: forward over one window (see the module's docstring); fixed shapes.
    segment/overlap: OLA geometry (reference default overlap=0.25).
    channels: input channels (1 = mono).
    align_sources: re-align each window's source order to the running output
              on the overlap (off: equal to offline OLA).
    device: where ``apply_fn`` takes its input, or None for a numpy function.
    """

    def __init__(
        self,
        apply_fn: Callable,
        n_srcs: int,
        segment: int,
        overlap: float = 0.25,
        channels: int = 1,
        align_sources: bool = False,
        device: torch.device | str | None = "cpu",
    ):
        if not 0 <= overlap < 1:
            raise ValueError(f"overlap must be in [0, 1): {overlap}")
        self.apply_fn = apply_fn
        self.n_srcs = n_srcs
        self.segment = segment
        self.stride = int((1 - overlap) * segment)
        if self.stride <= 0:
            raise ValueError("stride must be positive")
        self.channels = channels
        self.align_sources = align_sources
        self.device = device
        self.weight = triangular_weight(segment)
        self._out_lead = (n_srcs, channels) if channels > 1 else (n_srcs,)
        self.reset()

    def reset(self) -> None:
        """Start a new stream with the same ``apply_fn`` and geometry."""
        self._base = 0  # absolute index of mix[..., 0] / out[..., 0]
        self._mix = np.zeros((self.channels, 0), np.float32)
        self._out = np.zeros(self._out_lead + (0,), np.float32)
        self._wsum = np.zeros((0,), np.float32)
        self._next_start = 0  # absolute start of the next window
        self._total = 0  # total samples received
        self._finished = False

    @property
    def latency_samples(self) -> int:
        """Worst-case algorithmic latency: a sample is final ``segment`` samples behind the newest one."""
        return self.segment

    # -- internals -----------------------------------------------------

    def _grow(self, upto_abs: int) -> None:
        """Ensure out/wsum cover absolute indices [base, upto_abs)."""
        need = upto_abs - self._base - self._out.shape[-1]
        if need > 0:
            self._out = np.concatenate([self._out, np.zeros(self._out_lead + (need,), np.float32)], axis=-1)
            self._wsum = np.concatenate([self._wsum, np.zeros((need,), np.float32)])

    def _align(self, co: Array, start_rel: int, clen: int) -> Array:
        """Permute the sources of window output ``co`` to best match the accumulated output on the overlap."""
        cov = self._wsum[start_rel: start_rel + clen] > 0
        if int(cov.sum()) == 0 or self.n_srcs == 1:
            return co
        acc = self._out[..., start_rel: start_rel + clen][..., cov]
        ref = acc / self._wsum[start_rel: start_rel + clen][cov]  # normalized running estimate on the overlap
        flat_ref = ref.reshape(self.n_srcs, -1)
        flat_cand = co[..., cov].reshape(self.n_srcs, -1)
        num = flat_cand @ flat_ref.T  # correlation matrix [cand_src, ref_src]
        den = (np.linalg.norm(flat_cand, axis=1, keepdims=True) * np.linalg.norm(flat_ref, axis=1)[None] + 1e-12)
        corr = num / den
        best, best_score = None, -np.inf
        for perm in permutations(range(self.n_srcs)):
            score = sum(corr[p, i] for i, p in enumerate(perm))
            if score > best_score:
                best, best_score = perm, score
        return co[list(best)]

    def _apply(self, inp: Array) -> Array:
        if self.device is None:
            return np.asarray(self.apply_fn(inp), np.float32)
        with torch.inference_mode():
            return self.apply_fn(torch.from_numpy(inp).to(self.device)).float().cpu().numpy()

    def _run_window(self, start_abs: int, clen: int) -> None:
        """Run the model on mix[start_abs : start_abs+clen] (zero-padded to segment) and add its cross-faded
        output."""
        rel = start_abs - self._base
        x = np.zeros((self.channels, self.segment), np.float32)
        x[:, :clen] = self._mix[:, rel: rel + clen]
        y = self._apply(x[None, 0] if self.channels == 1 else x[None])[0]  # [S, (C,) T']
        co = y[..., :clen]
        self._grow(start_abs + clen)
        if self.align_sources:
            co = self._align(co, rel, clen)
        self._out[..., rel: rel + clen] += self.weight[:clen] * co
        self._wsum[rel: rel + clen] += self.weight[:clen]

    def _emit(self, upto_abs: int) -> Array:
        """Pop normalized samples [base, upto_abs) and advance the ring."""
        n = max(0, upto_abs - self._base)
        if n == 0:
            return np.zeros(self._out_lead + (0,), np.float32)
        self._grow(upto_abs)
        w = self._wsum[:n]
        y = self._out[..., :n] / np.where(w > 0, w, 1.0)
        self._out = self._out[..., n:]
        self._wsum = self._wsum[n:]
        self._mix = self._mix[:, n:]
        self._base = upto_abs
        return y

    # -- public API ------------------------------------------------------

    def push(self, samples: Array) -> Array:
        """Feed new audio; returns the newly final separated samples ``[S, (C,) m]`` (m may be 0). Mono input may
        be 1-D."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        x = np.asarray(samples, np.float32)
        if x.ndim == 1:
            x = x[None]
        if x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[0]}")
        self._mix = np.concatenate([self._mix, x], axis=1)
        self._total += x.shape[1]
        while self._next_start + self.segment <= self._total:
            self._run_window(self._next_start, self.segment)
            self._next_start += self.stride
        # final once every covering window has run: indices < next_start
        return self._emit(min(self._next_start, self._total))

    def flush(self) -> Array:
        """End of stream: run the remaining (tail) windows and return every outstanding sample. The stream is
        closed after this."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        self._finished = True
        while self._next_start < self._total:
            clen = min(self.segment, self._total - self._next_start)
            self._run_window(self._next_start, clen)
            self._next_start += self.stride
        return self._emit(self._total)
