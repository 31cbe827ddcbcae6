"""Pipeline parallelism (GPipe) over a stack of like layers (``fqss_tpu/parallel/pp.py``).

The JAX package stacks the variables of ``layer_0 .. layer_{N-1}`` (the Sepformer's transformer layers) on a leading
axis sharded over a ``pp`` mesh axis, and runs one ``shard_map`` program: each tick every stage applies its layers and
hands its activation to the next stage with ``ppermute``; ``M`` microbatches drain in ``M + S - 1`` ticks, and the last
stage's outputs reach every device by a ``psum`` of the masked outputs. Here each rank of a :class:`PipelineMesh` (the
first ``S`` ranks of the world) is a stage that holds its ``N / S`` consecutive layer modules
(:func:`shard_layer_stack`) and runs the same schedule, skipping the ticks of the bubble, where it has nothing to
compute.

The hops. Gloo moves CUDA tensors by ``all_reduce`` and ``broadcast`` alone, so a hop from stage s to s + 1 is a
``broadcast`` from s in the group of the two (:class:`_Send` on s, :class:`_Recv` on s + 1), and the last stage's
outputs go to every stage by a ``broadcast`` over the pipeline's group (:class:`_Out`). Each is an autograd function
whose backward is the reverse hop: the gradient of a received activation goes back to its sender. The stage's rows of
the loss's cotangent are the last stage's own: every rank computes the loss from the same broadcast output, and summing
the S ranks' cotangents would give the gradients S times over, so :class:`_Out`'s backward passes the last stage's
cotangent alone, as JAX's transpose of its ``psum`` of masked outputs does.

The order of the collectives. Within a tick a stage receives from s - 1, then sends to s + 1: the hops of a tick run
from the first pair to the last, so no two ranks wait on each other. Every hop and the output's broadcast thread one
token tensor, so a rank's backward runs its reverse hops in exactly the reverse order of its forward's hops (autograd
reaches a hop's node only after the next hop's), whatever order autograd's engine would take for independent nodes.

No state writes: JAX applies a stage without mutable collections (``pp.py:168-169``), so the stage runs inside
:func:`fqss_tpu_torch.quant.quantizers.read_only`: an act quantizer inside its window passes its input and updates
nothing, an unobserved weight quantizer returns its float weight, in ``train()`` mode too. The stage's weight
quantizers run as one grouped call (``quant/quantizers.py:weight_pass``) over the whole schedule: one K2 launch forward
and one backward a stage.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.quantizers import read_only, weight_pass

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """The pipeline axis: this process is stage ``rank`` of ``size``; ``ranks`` the stages' world ranks, ``group``
    their group (None: one process without a process group) and ``pairs[i]`` the group of stages i and i + 1."""

    rank: int
    size: int
    ranks: tuple[int, ...] = (0,)
    group: object = None
    pairs: tuple = ()


def pipeline_mesh(world: dp.Mesh | None, stages: int | None = None) -> PipelineMesh | None:
    """The first ``stages`` ranks of the world (all of them where None) as a pipeline, stage s on world rank s. Every
    rank of the world calls it, in one order with its other ``new_group`` calls (the groups pair up by order); a rank
    outside the pipeline gets None. ``world`` None: one process, one stage."""
    if world is None or not dist.is_initialized():
        if stages not in (None, 1):
            raise ValueError(f"{stages} pipeline stages need a process group of as many ranks")
        return PipelineMesh(0, 1)
    n = dist.get_world_size()
    size = n if stages is None else stages
    if not 1 <= size <= n:
        raise ValueError(f"{size} pipeline stages on a world of {n} ranks")
    ranks = tuple(range(size))
    group = dist.new_group(list(ranks))
    pairs = tuple(dist.new_group([i, i + 1]) for i in range(size - 1))
    r = dist.get_rank()
    return PipelineMesh(r, size, ranks, group, pairs) if r < size else None


def _layer_names(names, prefix: str) -> list[str]:
    pattern = re.compile(re.escape(prefix) + r"(\d+)$")
    found = {n for n in names if pattern.match(n)}
    return sorted(found, key=lambda n: int(n[len(prefix):]))


def layer_stack_vars(module_or_state, path: str = "", prefix: str = "layer_",
                     n_layers: int | None = None) -> dict[str, Tensor]:
    """The state of the layers ``<path>.<prefix>i`` (a module's, or a state dict's) stacked on a new leading axis in
    numeric order: one layer's keys, each tensor ``[n_layers, ...]`` (JAX's ``layer_stack_vars``). ``n_layers``: the
    first that many. Empty where ``path`` holds no such layers."""
    state = module_or_state.state_dict() if isinstance(module_or_state, nn.Module) else module_or_state
    scope = f"{path}." if path else ""
    per_layer: dict[str, dict[str, Tensor]] = {}
    for key, t in state.items():
        if key.startswith(scope):
            head, _, rest = key[len(scope):].partition(".")
            if rest:
                per_layer.setdefault(head, {})[rest] = t
    names = _layer_names(per_layer, prefix)[:n_layers]
    if not names:
        return {}
    return {k: torch.stack([per_layer[n][k] for n in names]) for k in per_layer[names[0]]}


class Stage(nn.ModuleList):
    """A rank's stage: its consecutive layers ``[index * n, (index + 1) * n)`` of a stack of ``n_layers``."""

    def __init__(self, layers: Sequence[nn.Module], n_layers: int, index: int):
        super().__init__(layers)
        self.n_layers, self.index = n_layers, index


def shard_layer_stack(layers: Sequence[nn.Module], mesh: PipelineMesh | None) -> Stage:
    """This rank's stage of the stack ``layers``: its ``n_layers / S`` consecutive layers and nothing else. Raises
    where the stack does not divide over the stages."""
    stack = list(layers)
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    if len(stack) % size:
        raise ValueError(f"{len(stack)} layers not divisible by {size} pipeline stages")
    n = len(stack) // size
    return Stage(stack[rank * n:(rank + 1) * n], len(stack), rank)


class _Send(torch.autograd.Function):
    """Stage s hands ``y`` to s + 1 (a broadcast from s in their pair); backward, it takes ``y``'s gradient back."""

    @staticmethod
    def forward(ctx, y, token, group, src, dst):
        ctx.group, ctx.dst, ctx.like = group, dst, (y.shape, y.dtype, y.device)
        dist.broadcast(y.contiguous(), src=src, group=group)
        return token.clone()

    @staticmethod
    def backward(ctx, g_token):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(g, src=ctx.dst, group=ctx.group)
        return g, g_token, None, None, None


class _Recv(torch.autograd.Function):
    """Stage s + 1 takes stage s's activation; backward, it hands the activation's gradient back to s."""

    @staticmethod
    def forward(ctx, token, like, group, src, dst):
        ctx.set_materialize_grads(False)
        ctx.group, ctx.dst, ctx.like = group, dst, like
        shape, dtype, device = like
        h = torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(h, src=src, group=group)
        return h, token.clone()

    @staticmethod
    def backward(ctx, g_h, g_token):
        shape, dtype, device = ctx.like
        g = torch.zeros(shape, dtype=dtype, device=device) if g_h is None else g_h.contiguous()
        dist.broadcast(g, src=ctx.dst, group=ctx.group)
        return (torch.zeros((), device=device) if g_token is None else g_token), None, None, None, None


class _Out(torch.autograd.Function):
    """The last stage's outputs on every stage (a broadcast over the pipeline); backward, the last stage's own
    cotangent alone (module note), and the token's chain started on every stage."""

    @staticmethod
    def forward(ctx, outs, token, group, src, last):
        ctx.last = last
        y = outs.clone()
        if group is not None:
            dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), torch.zeros((), device=g.device), None, None, None


def pipeline_apply(apply_fn: Callable[[nn.Module, Tensor], Tensor], stage, x: Tensor, mesh: PipelineMesh | None,
                   n_microbatches: int | None = None) -> Tensor:
    """``x`` through the stack with GPipe microbatch pipelining (module note); every stage returns the whole output.

    ``apply_fn(layer, h) -> y`` applies one layer (the same shape in and out: the transformer layer's contract);
    ``stage``: this rank's :class:`Stage`, or the whole stack (its stage is taken here); ``x``: the whole batch, the
    same on every stage, its leading dimension divisible by ``n_microbatches`` (default: the number of stages)."""
    S, s = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    M = int(n_microbatches or S)
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    if not isinstance(stage, Stage):
        stage = shard_layer_stack(stage, mesh)
    if stage.n_layers % S != 0:
        raise ValueError(f"{stage.n_layers} layers not divisible by {S} pipeline stages")
    group = mesh.group if mesh is not None else None
    ranks = mesh.ranks if mesh is not None else (0,)
    mb = x.reshape(M, B // M, *x.shape[1:])
    like = (mb.shape[1:], x.dtype, x.device)
    token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    outs, h = [], None
    with read_only(), weight_pass(stage):
        for t in range(M + S - 1):
            m = t - s
            if 0 <= m < M:
                y = mb[m] if s == 0 else h
                for layer in stage:
                    y = apply_fn(layer, y)
                if s == S - 1:
                    outs.append(y)
            if s > 0 and 0 <= m + 1 < M:  # stage s - 1's microbatch m + 1, for the next tick
                h, token = _Recv.apply(token, like, mesh.pairs[s - 1], ranks[s - 1], ranks[s])
            if s < S - 1 and 0 <= m < M:
                token = _Send.apply(y, token, mesh.pairs[s], ranks[s], ranks[s + 1])
    last = s == S - 1
    out = torch.stack(outs) if last else torch.zeros((M, *like[0]), dtype=x.dtype, device=x.device)
    out = _Out.apply(out, token, group, ranks[-1], last)
    return out.reshape(B, *out.shape[2:])


def pipeline_layer_module(stage, x: Tensor, mesh: PipelineMesh | None, n_microbatches: int | None = None) -> Tensor:
    """:func:`pipeline_apply` of the stage's layer modules themselves (the port's ``TransformerLayer``)."""
    return pipeline_apply(lambda layer, h: layer(h), stage, x, mesh, n_microbatches=n_microbatches)


__all__ = ["PipelineMesh", "Stage", "layer_stack_vars", "pipeline_apply", "pipeline_layer_module", "pipeline_mesh",
           "shard_layer_stack"]
