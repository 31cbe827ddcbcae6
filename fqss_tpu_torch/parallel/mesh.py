"""Data parallelism over ``torch.distributed`` (``fqss_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh: the batch is sharded over the ``dp`` axis, the
parameters are replicated, and every reduction over the batch is global (an observer's min/max, the MSE histogram,
the loss's batch means, the splitter's max-abs, the dynamic LSTM cell's grids). Here each rank is a process that
holds rows ``[r·B/W, (r+1)·B/W)`` of the global batch (:meth:`Mesh.rows`, :func:`rank_rows`), and the code that
reduces over the batch reduces over the ranks too, through the helpers below, while a :class:`Mesh` is active
(:func:`sharded`). The entry points that take a mesh activate it: the train and eval steps
(``train/trainer.py``, ``train/recipes_music.py``) and ``ola_infer(mesh=...)``. Without an active mesh (every
plain ``python -m`` run, and work that a rank does alone) each helper is the identity and the path is the
one-process path bit for bit.

Every collective is an ``all_reduce``: gloo reduces CUDA tensors with it but gathers none, so two ranks that share
one card (gloo) take the same code as ranks on cards of their own (NCCL). Min and max are exact in any order, so the
observers' ranges on W ranks equal the one-process run's on the same global batch bit for bit; the float sums are
not (another order), and the int64 counts are.

Gradients: :func:`all_sum`'s backward sums the ranks' upstream gradients, as ``torch.distributed.nn``'s does (the
objective is the sum of the ranks' losses, which are equal), so the gradients of the global loss come out W times
over on every rank, and :func:`reduce_gradients_` divides the ranks' sum by W once. The buffers (the observers'
counters, histograms and ranges) are written by every rank from the same reduced values, so they stay equal without
DDP's buffer broadcast.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

# What torchrun (``python -m torch.distributed.run``) sets for each rank; init_method="env://" reads them.
ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel group over the default process group: this process's ``rank`` of ``size``, the device
    its rows live on and the backend (``nccl`` or ``gloo``)."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0, which writes the run's files."""
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``; the batch must divide by the world size, as the
        reference's DDP requires (musdbhq_train.py:294)."""
        if batch % self.size:
            raise ValueError(f"a global batch of {batch} does not divide over {self.size} ranks")
        n = batch // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("fqss_tpu_torch_mesh", default=None)


def init_distributed(device: torch.device | str = "cuda", backend: str | None = None) -> Mesh | None:
    """Join the process group that torchrun describes in ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``LOCAL_RANK`` picks the card); the counterpart of ``initialize_multihost``.

    ``device``: ``cuda`` runs rank r on ``cuda:LOCAL_RANK`` over NCCL, ``cuda:K`` on card K, ``cpu`` over gloo;
    ``backend`` overrides the choice (``gloo`` lets ranks share one card). Without any of those variables it
    does nothing and returns None: one process, world size 1. A partial environment, a missing card or a failed
    ``init_process_group`` raises: no rank goes on alone."""
    present = [k for k in ENV if k in os.environ]
    if not present:
        return None
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torch.distributed: {', '.join(present)} set but {', '.join(missing)} not; launch "
                           "with torchrun (python -m torch.distributed.run)")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized already")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU over gloo")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors only; the CPU takes gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, init_method="env://", rank=rank, world_size=size, **kwargs)
    return Mesh(rank, size, device, backend)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_rows(batch, mesh: Mesh | None = None):
    """This rank's rows of a global ``batch`` (an array or tensor, batch first): the counterpart of
    ``shard_batch``. ``mesh``: the process group's rank and size when None."""
    if mesh is None:
        mesh = Mesh(rank(), world_size(), torch.device("cpu"), "")
    return batch[mesh.rows(len(batch))]


def active() -> Mesh | None:
    """The mesh whose ranks the batch is sharded over, inside :func:`sharded`; else None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(mesh: Mesh | None) -> Iterator[None]:
    """Reduce over ``mesh``'s ranks inside this block (None: over this process alone). The block's work must run
    on every rank in the same order, as the collectives pair up by order."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def extremes(mn: Tensor, mx: Tensor) -> tuple[Tensor, Tensor]:
    """The global minimum of ``mn`` and maximum of ``mx``, elementwise over the ranks, in one ``all_reduce`` (the
    maximum of ``-mn`` and ``mx``: negation is exact). Values, not gradients: the observers' and the splitter's."""
    mesh = active()
    if mesh is None:
        return mn, mx
    with torch.no_grad():
        buf = torch.cat([mn.reshape(-1).neg(), mx.reshape(-1)])
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        lo, hi = buf.split(mn.numel())
        return lo.neg().reshape(mn.shape), hi.reshape(mx.shape)


def sum_counts(counts: Tensor) -> Tensor:
    """Integer counts summed over the ranks (exact)."""
    if active() is None:
        return counts
    out = counts.clone()
    dist.all_reduce(out)
    return out


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks, differentiable (the module note's convention)."""
    return x if active() is None else _AllSum.apply(x)


def batch_mean(v: Tensor, dim: int | tuple[int, ...] | None = None) -> Tensor:
    """``v.mean(dim)`` over the global batch, where ``dim`` (all of them when None) holds the batch axis: the mean
    of the ranks' means, whose batches are equal. ``v.mean(dim)`` itself without an active mesh."""
    local = v.mean() if dim is None else v.mean(dim=dim)
    mesh = active()
    return local if mesh is None else all_sum(local) / mesh.size


def batch_sum(v: Tensor) -> Tensor:
    """``v.sum()`` over the global batch."""
    return all_sum(v.sum())


class _BatchExtremes(torch.autograd.Function):
    """``(amin, amax)`` of ``x`` over ``dims`` (kept) and over the ranks, with ``jnp.min``'s gradient over a sharded
    array: the upstream gradient, summed over the ranks, split evenly between every rank's elements that equal the
    extreme."""

    @staticmethod
    def forward(ctx, x, dims):
        mn, mx = extremes(x.amin(dims, keepdim=True), x.amax(dims, keepdim=True))
        ctx.dims = dims
        ctx.save_for_backward(x, mn, mx)
        return mn, mx

    @staticmethod
    def backward(ctx, g_mn, g_mx):
        x, mn, mx = ctx.saved_tensors
        at_mn, at_mx = x == mn, x == mx
        g_mn = torch.zeros_like(mn) if g_mn is None else g_mn
        g_mx = torch.zeros_like(mx) if g_mx is None else g_mx
        packed = torch.stack([g_mn.double(), g_mx.double(), at_mn.sum(ctx.dims, keepdim=True).double(),
                              at_mx.sum(ctx.dims, keepdim=True).double()])
        dist.all_reduce(packed)
        u_mn, u_mx, n_mn, n_mx = packed.to(x.dtype).unbind(0)
        return at_mn * (u_mn / n_mn) + at_mx * (u_mx / n_mx), None


def batch_extremes(x: Tensor, dims: tuple[int, ...]) -> tuple[Tensor, Tensor]:
    """``x.amin(dims, keepdim=True)`` and ``x.amax(dims, keepdim=True)`` over the global batch (``dims`` hold the
    batch axis), differentiable; the local ones without an active mesh."""
    if active() is None:
        return x.amin(dims, keepdim=True), x.amax(dims, keepdim=True)
    return _BatchExtremes.apply(x, dims)


def reduce_gradients_(grads: Sequence[Tensor]) -> None:
    """Sum the ranks' gradients and divide by the world size, in place: one ``all_reduce`` of all of them
    flattened, per device and dtype. Nothing without an active mesh."""
    mesh = active()
    if mesh is None or not grads:
        return
    buckets: dict[tuple, list[Tensor]] = {}
    for g in grads:
        buckets.setdefault((g.device, g.dtype), []).append(g)
    for bucket in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(mesh.size)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()


def all_agree(flag: bool) -> bool:
    """True only if ``flag`` holds on every rank."""
    mesh = active()
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def gather_rows(local: Tensor, batch: int) -> Tensor:
    """The global batch of ``batch`` rows on every rank, from each rank's :meth:`Mesh.rows`: each rank writes its
    rows into a zeroed buffer and the ranks sum the buffers (an ``all_reduce``, which gloo takes on CUDA tensors
    too; every other row adds zeros, so the rows come back as their rank computed them)."""
    mesh = active()
    if mesh is None:
        return local
    full = local.new_zeros((batch, *local.shape[1:]))
    full[mesh.rows(batch)] = local
    dist.all_reduce(full)
    return full


def host_sum(values: np.ndarray, mesh: Mesh | None) -> np.ndarray:
    """A float64 host array summed over ``mesh``'s ranks (through its device, which NCCL needs); the array itself
    without a mesh."""
    if mesh is None:
        return values
    t = torch.from_numpy(np.ascontiguousarray(values, np.float64)).to(mesh.device)
    dist.all_reduce(t)
    return t.cpu().numpy()
