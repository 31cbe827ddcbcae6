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

A 2-D grid of ranks (:func:`grid`, for tensor parallelism: ``parallel/tp.py``) is a :class:`Mesh` whose ``rank`` and
``size`` are the data-parallel index and extent, with its ``group`` of the ranks that share this rank's tensor-parallel
index, and its ``tp_rank``, ``tp_size`` and ``tp_group``. The batch is sharded over dp and replicated over tp, so every
helper here reduces over ``group``: the default group for a 1-D mesh (world size = dp), the dp group on a grid. A
reduction over the tp ranks too (an observer of a tensor that tp shards) activates :meth:`Mesh.whole`.

Gradients: :func:`all_sum`'s backward sums the ranks' upstream gradients, as ``torch.distributed.nn``'s does (the
objective is the sum of the ranks' losses, which are equal), so the gradients of the global loss come out W times
over on every rank, and :func:`reduce_gradients_` divides the ranks' sum by W once. The buffers (the observers'
counters, histograms and ranges) are written by every rank from the same reduced values, so they stay equal without
DDP's buffer broadcast.

:func:`spawn` starts the ranks of one host as torchrun would, where no launcher does (the dry run, the tests).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from typing import Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

# What torchrun (``python -m torch.distributed.run``) sets for each rank; init_method="env://" reads them.
ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel group: this process's ``rank`` of ``size``, the device its rows live on and the backend
    (``nccl`` or ``gloo``); ``group`` the ranks a reduction over the batch takes (None: the default group). On a
    grid (:func:`grid`) also this process's ``tp_rank`` of ``tp_size`` in its ``tp_group``."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    tp_rank: int = 0
    tp_size: int = 1
    tp_group: object = None

    @property
    def is_main(self) -> bool:
        """Rank 0 of the world, which writes the run's files."""
        return self.rank == 0 and self.tp_rank == 0

    def whole(self) -> "Mesh":
        """This mesh with every rank of the world as its reduction group: what an observer of a tensor sharded over
        tp (and of a batch sharded over dp) reduces over. The mesh itself without tensor parallelism."""
        return self if self.tp_size == 1 else dataclasses.replace(self, group=dist.group.WORLD)

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


def grid(world: Mesh, tp: int) -> Mesh:
    """The 2-D (dp, tp) grid of ``world``'s ranks (a 1-D mesh over the default group, :func:`init_distributed`):
    world rank w is tp rank ``w % tp`` of dp rank ``w // tp``, so a tp group is ``tp`` consecutive ranks. Every rank
    creates every subgroup, the tp groups then the dp groups, in one order (``dist.new_group`` pairs them up by
    order). ``tp`` 1 is the 1-D mesh itself."""
    if tp < 1 or world.size % tp:
        raise ValueError(f"a grid of tp {tp} does not divide {world.size} ranks")
    if tp == 1:
        return world
    dp_size = world.size // tp
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp_size)]
    dp_groups = [dist.new_group([d * tp + t for d in range(dp_size)]) for t in range(tp)]
    d, t = divmod(world.rank, tp)
    return Mesh(d, dp_size, world.device, world.backend, group=dp_groups[t], tp_rank=t, tp_size=tp,
                tp_group=tp_groups[d])


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that is free now: a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, world: int, port: int, base: dict | None = None) -> dict:
    """``base`` (this process's environment when None) with the variables torchrun gives rank ``rank`` of ``world``
    on this host, the rendezvous at ``localhost:port``."""
    env = {k: v for k, v in (os.environ if base is None else base).items() if k not in ENV + ("LOCAL_RANK",)}
    return {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def spawn(cmd: Sequence[str], world: int, *, env: dict | None = None, cwd=None, timeout: float | None = None,
          echo: bool = False) -> list[str]:
    """Run ``world`` ranks of ``cmd`` on this host as torchrun would (:func:`rank_env` over this process's
    environment updated by ``env``) and wait for them all. A rank that fails, or a run longer than ``timeout``
    seconds, ends every rank still running, and this raises with that rank's output (rank 0's on a timeout). Returns
    each rank's standard output; rank 0's goes to this process's own instead where ``echo`` (its entry empty)."""
    base = {**os.environ, **(env or {})}
    port = free_port()
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        files = [(open(os.path.join(tmp, f"{r}.out"), "w+"), open(os.path.join(tmp, f"{r}.err"), "w+"))
                 for r in range(world)]
        procs = [subprocess.Popen(list(cmd), cwd=cwd, env=rank_env(r, world, port, base),
                                  stdout=None if echo and r == 0 else out, stderr=err)
                 for r, (out, err) in enumerate(files)]
        failed, late = None, False
        try:
            while failed is None and any(p.poll() is None for p in procs):
                if deadline is not None and time.monotonic() > deadline:
                    late = True
                    break
                time.sleep(0.1)
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if failed is None and not late:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:  # no rank waits alone for one that has ended
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if late or failed is not None:
        r = 0 if late else failed
        what = f"ran past {timeout} s" if late else f"failed ({procs[r].returncode})"
        raise RuntimeError(f"rank {r} of {world} ({' '.join(map(str, cmd))}) {what}:\n{texts[r][0][-2000:]}\n"
                           f"{texts[r][1][-4000:]}")
    return [out for out, _ in texts]


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
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
        lo, hi = buf.split(mn.numel())
        return lo.neg().reshape(mn.shape), hi.reshape(mx.shape)


def sum_counts(counts: Tensor) -> Tensor:
    """Integer counts summed over the ranks (exact)."""
    mesh = active()
    if mesh is None:
        return counts
    out = counts.clone()
    dist.all_reduce(out, group=mesh.group)
    return out


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks, differentiable (the module note's convention)."""
    mesh = active()
    return x if mesh is None else _AllSum.apply(x, mesh.group)


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
        ctx.dims, ctx.group = dims, active().group
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
        dist.all_reduce(packed, group=ctx.group)
        u_mn, u_mx, n_mn, n_mx = packed.to(x.dtype).unbind(0)
        return at_mn * (u_mn / n_mn) + at_mx * (u_mx / n_mx), None


def batch_extremes(x: Tensor, dims: tuple[int, ...]) -> tuple[Tensor, Tensor]:
    """``x.amin(dims, keepdim=True)`` and ``x.amax(dims, keepdim=True)`` over the global batch (``dims`` hold the
    batch axis), differentiable; the local ones without an active mesh."""
    if active() is None:
        return x.amin(dims, keepdim=True), x.amax(dims, keepdim=True)
    return _BatchExtremes.apply(x, dims)


def reduce_gradients_(grads: Sequence[Tensor]) -> None:
    """Sum the data ranks' gradients and divide by their number, in place (:func:`sum_flat_` over the mesh's
    group). Nothing without an active mesh."""
    mesh = active()
    if mesh is None or not grads:
        return
    sum_flat_(grads, mesh.group, mesh.size)


def sum_flat_(tensors: Sequence[Tensor], group, divisor: int = 1) -> None:
    """Sum ``tensors`` over ``group``'s ranks in place (divided by ``divisor``): one ``all_reduce`` of them
    flattened, per device and dtype."""
    buckets: dict[tuple, list[Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for bucket in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def all_agree(flag: bool) -> bool:
    """True only if ``flag`` holds on every rank of the world."""
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
    dist.all_reduce(full, group=mesh.group)
    return full


def host_sum(values: np.ndarray, mesh: Mesh | None) -> np.ndarray:
    """A float64 host array summed over ``mesh``'s ranks (through its device, which NCCL needs); the array itself
    without a mesh."""
    if mesh is None:
        return values
    t = torch.from_numpy(np.ascontiguousarray(values, np.float64)).to(mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return t.cpu().numpy()
