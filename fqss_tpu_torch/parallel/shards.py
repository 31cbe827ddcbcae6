"""A rank's part of a sharded parameter, and the views of a whole model over such parts.

Tensor parallelism (``parallel/tp.py``) and FSDP (``parallel/fsdp.py``) each replace a parameter by this rank's part
of it and mark the part with a :class:`Placement`: which scheme cut it (``tp`` or ``dp``), the dimension it cut, the
indices along it that this rank holds, the whole extent and the group of ranks that hold the rest. A parameter has
at most one placement (FSDP leaves tensor parallelism's parts alone). What needs the whole model reads the placement
alone: the clip's global norm (:func:`global_norm`), the whole state and gradients for a checkpoint or a comparison
(:func:`whole_state_dict`, :func:`whole_gradients`) and their inverse (:func:`load_whole_state_dict`).

A gather is one ``all_reduce`` of the ranks' parts written into a zeroed buffer, per group, device and dtype (gloo
reduces CUDA tensors but gathers none): each element is one rank's value plus zeros, so it comes back as that rank
held it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

Tensor = torch.Tensor

TP, DP = "tp", "dp"
_SLOT = {TP: 0, DP: 1}  # the global norm's float64 partial sums: tp parts, dp parts, then the replicated


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """This rank's part of a parameter: ``index`` (along ``dim``, of the whole ``extent``) of the whole, cut by
    ``kind``'s scheme; ``group`` the ranks that hold the other parts (None: the default group)."""

    kind: str
    dim: int
    index: Tensor
    extent: int
    group: object = None

    def take(self, whole: Tensor) -> Tensor:
        """This rank's part of ``whole`` (a new tensor)."""
        return whole.index_select(self.dim, self.index.to(whole.device))

    def put(self, whole: Tensor, part: Tensor) -> Tensor:
        """``part`` written into ``whole`` at this rank's indices, in place."""
        return whole.index_copy_(self.dim, self.index.to(whole.device), part)

    def whole_shape(self, part: Tensor) -> list[int]:
        shape = list(part.shape)
        shape[self.dim] = self.extent
        return shape


def place(part: Tensor, kind: str, dim: int, index: Tensor, extent: int, group=None) -> Tensor:
    """Mark ``part`` (a parameter) as this rank's ``index`` along ``dim`` of a whole of ``extent`` there."""
    part.placement = Placement(kind, dim, index.to(part.device), extent, group)
    return part


def placement(t: Tensor) -> Placement | None:
    """``t``'s placement; None for a replicated tensor."""
    return getattr(t, "placement", None)


def is_part(t: Tensor, kind: str) -> bool:
    """Whether ``kind``'s scheme (:data:`TP` or :data:`DP`) cut ``t``."""
    pl = placement(t)
    return pl is not None and pl.kind == kind


def global_norm(params) -> Tensor:
    """The L2 norm of the whole model's gradient from this rank's parameters: the squares of each scheme's parts'
    gradients summed over their group, each replicated parameter's counted once (float64 sums, the norm float32)."""
    with_grad = [p for p in params if p.grad is not None]
    sq = torch.zeros(3, dtype=torch.float64, device=with_grad[0].grad.device)
    groups = {}
    for p in with_grad:
        pl = placement(p)
        i = 2 if pl is None else _SLOT[pl.kind]
        if pl is not None:
            groups.setdefault(i, pl.group)
        sq[i] += p.grad.double().square().sum()
    for i in sorted(groups):
        part = sq[i:i + 1].clone()
        dist.all_reduce(part, group=groups[i])
        sq[i] = part[0]
    return sq.sum().sqrt().float()


def whole(pairs: Sequence[tuple[Tensor, Tensor]]) -> list[Tensor]:
    """Each ``t`` of ``pairs`` (``(p, t)``: a value or gradient of a part ``p``) whole on every rank of ``p``'s
    group: one ``all_reduce`` per group, device and dtype (module note)."""
    out: list[Tensor | None] = [None] * len(pairs)
    buckets: dict[tuple, list[int]] = {}
    for i, (p, t) in enumerate(pairs):
        buckets.setdefault((id(placement(p).group), t.device, t.dtype), []).append(i)
    for idx in buckets.values():
        shapes = [placement(pairs[i][0]).whole_shape(pairs[i][1]) for i in idx]
        sizes = [math.prod(s) for s in shapes]
        flat = pairs[idx[0]][1].new_zeros(sum(sizes))
        offset = 0
        for i, shape, n in zip(idx, shapes, sizes):
            p, t = pairs[i]
            out[i] = placement(p).put(flat[offset:offset + n].view(shape), t)
            offset += n
        dist.all_reduce(flat, group=placement(pairs[idx[0]][0]).group)
    return out


def _gathered(named: list[tuple[str, Tensor, Tensor]]) -> dict[str, Tensor]:
    """``{key: t}`` of ``named`` ``(key, p, t)`` (``t`` a value or gradient of ``p``), every part whole, on the
    CPU."""
    parts = [i for i, (_, p, _) in enumerate(named) if placement(p) is not None]
    wholes = dict(zip(parts, whole([named[i][1:] for i in parts])))
    return {key: wholes.get(i, t).cpu().clone() for i, (key, _, t) in enumerate(named)}


def whole_state_dict(model: nn.Module) -> dict[str, Tensor]:
    """``model``'s state dict with every part gathered whole, on the CPU. Every rank of the parts' groups calls it."""
    return _gathered([(key, t, t.detach()) for key, t in model.state_dict(keep_vars=True).items()])


def whole_gradients(model: nn.Module) -> dict[str, Tensor]:
    """Every parameter's gradient (those that have one), parts gathered whole, on the CPU."""
    return _gathered([(key, p, p.grad.detach()) for key, p in model.named_parameters() if p.grad is not None])


def load_whole_state_dict(model: nn.Module, state: dict[str, Tensor]) -> None:
    """The inverse of :func:`whole_state_dict`: ``model`` takes its part of each whole tensor of ``state`` (some or
    all of its keys), in place; every rank calls it with the same state."""
    with torch.no_grad():
        for key, t in model.state_dict(keep_vars=True).items():
            if key in state:
                w = state[key].to(t.device)
                pl = placement(t)
                t.copy_(w if pl is None else pl.take(w))


__all__ = ["DP", "TP", "Placement", "global_norm", "is_part", "load_whole_state_dict", "place", "placement", "whole",
           "whole_gradients", "whole_state_dict"]
