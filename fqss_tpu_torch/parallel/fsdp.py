"""FSDP / ZeRO-3 sharding of the KD step's state over the data ranks (``fqss_tpu/parallel/fsdp.py``).

The JAX package places every large leaf of its ``TrainState`` (the parameters, the float teacher's weights and Adam's
``mu``/``nu``, which mirror the parameters) with a sharding over the ``dp`` axis and lets GSPMD emit the gathers and the
gradient reduce-scatters. Here each data rank (:class:`~fqss_tpu_torch.parallel.mesh.Mesh`: ``rank`` of ``size`` in
``group``; the dp group of a (dp, tp) grid) keeps its slice of such a parameter as the parameter itself, so the
optimizer built over the model's parameters (or re-pointed by :func:`shard_state_fsdp`) holds Adam's moments of the
slice alone, and the update runs on the slice.

Which leaves: :func:`fsdp_sharding`, JAX's rule dim for dim: the largest dimension that divides by the dp size, the
first of equal ones, and none (replicated) for a scalar, a leaf of fewer than ``min_size`` elements or one with no such
dimension. The port's layouts are ``[out, in, k]`` and ``[out, in]`` where JAX's are ``(k, in, out)`` and ``[in,
out]``: the rule picks the same physical axis except where two axes have equal extents, where the port takes the
first in its own layout (the output channels before the inputs) and JAX the first in its. Both are the same extent.
A slice carries its placement (``parallel/shards.py``, over the dp group), by which the clip's norm and the whole
state read it. Left replicated: a parameter that tensor parallelism already shards (JAX's ``skip_sharded``), every
buffer, and every quantizer's parameters (ranges, ``mu``): the observers write them in place inside the forward, from
the same reduced values on every rank (``parallel/mesh.py``). JAX would shard a ``qparams`` or ``qstats`` leaf of
``min_size`` elements or more; no model's reaches that at the default ``min_size``.

The step. A sharded model gathers its whole weights at the top of its forward (a pre-hook) and puts its slices back at
its end, so the layers and the grouped weight pass (``quant/quantizers.py:weight_pass``, one K2 launch over every weight
quantizer) see whole weights: a per-channel extreme over a slice would not be the channel's. The gather
(:class:`_Gather`) is one ``all_reduce`` of the slices written into a zeroed flat buffer, per device and dtype (gloo
reduces CUDA tensors but gathers none; every other rank adds zeros). Its backward sums the ranks' whole gradients in one
``all_reduce`` and keeps this rank's slice: a reduce-scatter. Under the data-parallel convention (``parallel/mesh.py``)
that sum is the ranks' gradient summed once, so ``train/trainer.py:backward_and_update`` divides a slice's gradient by
the dp size and does not reduce it again; a replicated parameter's gradient is reduced as before.

The whole weights that a weight quantizer reads are gathered into buffers that persist with the model
(:func:`gather_buffers`): the weight pass's table keys on each weight's tensor and storage, and fresh tensors would
rebuild it on every forward. The other whole weights (biases, norms, a float teacher's) are fresh each forward and
freed after it. So between steps a rank holds the replicated elements, ``1/size`` of each sharded one (parameters,
teacher, Adam's moments) and the persistent buffers; inside a step it holds the whole weights from the forward's top to
the end of the backward. For these models FSDP is headroom, as JAX's docstring says, not a need.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import shards
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer, weight_quantizer_sites

Tensor = torch.Tensor


def fsdp_sharding(shape: Sequence[int], size: int, min_size: int = 2**12) -> int | None:
    """The dimension of a leaf of ``shape`` that FSDP shards over ``size`` data ranks, or None (replicated): JAX's
    ``fsdp_sharding`` (the largest dimension that divides by ``size``, the first of equal ones)."""
    best, best_dim = None, 0
    for d, dim in enumerate(shape):
        if dim % size == 0 and dim > best_dim:
            best, best_dim = d, dim
    if not len(shape) or math.prod(shape) < min_size or best is None:
        return None
    return best


@dataclasses.dataclass
class _Entry:
    module: nn.Module
    name: str
    shard: nn.Parameter
    shape: torch.Size  # the whole parameter's
    persistent: bool  # a weight quantizer reads it: gathered into a buffer that persists


class _Plan:
    """A sharded module's parameters and its group: what the pre-hook gathers and the post-hook puts back."""

    def __init__(self, entries: list[_Entry], mesh: dp.Mesh):
        self.entries, self.group = entries, mesh.group
        self.buffers: dict[int, Tensor] = {}  # entry index -> its persistent whole buffer

    def _buckets(self) -> dict[tuple, list[int]]:
        out: dict[tuple, list[int]] = {}
        for i, e in enumerate(self.entries):
            out.setdefault((e.shard.device, e.shard.dtype), []).append(i)
        return out

    def gather(self, parts: Sequence[Tensor]) -> list[Tensor]:
        """The whole tensors of ``parts`` (one slice per entry): one ``all_reduce`` a bucket."""
        wholes: list[Tensor | None] = [None] * len(self.entries)
        for (device, dtype), idx in self._buckets().items():
            sizes = [math.prod(self.entries[i].shape) for i in idx]
            flat = torch.zeros(sum(sizes), device=device, dtype=dtype)
            offset = 0
            for i, n in zip(idx, sizes):
                e = self.entries[i]
                e.shard.placement.put(flat[offset:offset + n].view(e.shape), parts[i])
                offset += n
            dist.all_reduce(flat, group=self.group)
            offset = 0
            for i, n in zip(idx, sizes):
                e, part = self.entries[i], flat[offset:offset + n].view(self.entries[i].shape)
                if e.persistent:
                    buf = self.buffers.get(i)
                    if buf is None:  # a normal tensor, should the first forward run in inference mode
                        with torch.inference_mode(False):
                            buf = self.buffers[i] = torch.empty(e.shape, device=device, dtype=dtype)
                    wholes[i] = buf.copy_(part)
                else:
                    wholes[i] = part.clone()
                offset += n
        return wholes

    def reduce_scatter(self, grads: Sequence[Tensor | None]) -> list[Tensor | None]:
        """Each entry's slice of the ranks' whole gradients summed (one ``all_reduce`` a bucket, with a count per
        entry of the ranks that had a gradient: None where none had)."""
        out: list[Tensor | None] = [None] * len(self.entries)
        for (device, dtype), idx in self._buckets().items():
            sizes = [math.prod(self.entries[i].shape) for i in idx]
            had = torch.tensor([float(grads[i] is not None) for i in idx], device=device, dtype=dtype)
            flat = torch.cat([grads[i].reshape(-1) if grads[i] is not None else
                              torch.zeros(n, device=device, dtype=dtype) for i, n in zip(idx, sizes)] + [had])
            dist.all_reduce(flat, group=self.group)
            counts = flat[-len(idx):].tolist()
            offset = 0
            for j, (i, n) in enumerate(zip(idx, sizes)):
                e = self.entries[i]
                if counts[j] > 0:
                    out[i] = e.shard.placement.take(flat[offset:offset + n].view(e.shape))
                offset += n
        return out


class _Gather(torch.autograd.Function):
    """The whole parameters of a plan's slices forward; the reduce-scatter of their gradients backward."""

    @staticmethod
    def forward(ctx, plan: _Plan, *parts):
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        return tuple(plan.gather(parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.plan.reduce_scatter(grads))


# Each sharded module's plan, outside the module (as the weight pass's cache): a copy of the module carries no group.
_PLANS: "weakref.WeakKeyDictionary[nn.Module, _Plan]" = weakref.WeakKeyDictionary()


def _put_whole(module: nn.Module, args) -> None:
    plan = _PLANS[module]
    wholes = _Gather.apply(plan, *(e.shard for e in plan.entries))
    for e, w in zip(plan.entries, wholes):
        e.module._parameters[e.name] = w


def _put_shards(module: nn.Module, args, out) -> None:
    for e in _PLANS[module].entries:
        e.module._parameters[e.name] = e.shard


def _quantizer_params(model: nn.Module) -> set[int]:
    return {id(p) for m in model.modules() if isinstance(m, (ActQuantizer, WeightQuantizer)) for p in m.parameters()}


def _shard_module(model: nn.Module, mesh: dp.Mesh, min_size: int, skip_sharded: bool) -> dict[int, nn.Parameter]:
    """Shard ``model``'s parameters over ``mesh``'s data ranks, in place (module note). Returns ``{id(whole
    parameter): its slice}``."""
    if model in _PLANS:
        raise ValueError("the module is sharded over its data ranks already")
    persistent = {(id(layer), wname) for layer, _, wname in weight_quantizer_sites(model)}
    skip = _quantizer_params(model)
    entries, slices = [], {}
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is None or id(p) in skip:
                continue
            if id(p) in slices:  # a parameter that two modules share: one slice, gathered for each
                mod._parameters[name] = slices[id(p)]
                entries.append(_Entry(mod, name, slices[id(p)], p.shape, (id(mod), name) in persistent))
                continue
            if shards.is_part(p, shards.TP):
                if skip_sharded:
                    continue
                raise ValueError(f"{name}: tensor parallelism shards it already (skip_sharded=False)")
            d = fsdp_sharding(p.shape, mesh.size, min_size)
            if d is None:
                continue
            k = p.shape[d] // mesh.size
            shard = nn.Parameter(p.detach().narrow(d, mesh.rank * k, k).clone(), requires_grad=p.requires_grad)
            shards.place(shard, shards.DP, d, torch.arange(mesh.rank * k, (mesh.rank + 1) * k), p.shape[d], mesh.group)
            mod._parameters[name] = shard
            entries.append(_Entry(mod, name, shard, p.shape, (id(mod), name) in persistent))
            slices[id(p)] = shard
    if entries:
        _PLANS[model] = _Plan(entries, mesh)
        model.register_forward_pre_hook(_put_whole)
        model.register_forward_hook(_put_shards, always_call=True)
    return slices


def shard_state_fsdp(state, mesh: dp.Mesh, min_size: int = 2**12, skip_sharded: bool = True):
    """Shard a :class:`~fqss_tpu_torch.train.state.TrainState` (or a module) over ``mesh``'s data ranks, in place,
    and return it: the student's and the teacher's parameters (module note), and the optimizer re-pointed at the
    student's slices, with any state it holds (Adam's moments) cut to them. Every rank holds the same whole weights
    beforehand (the same seed or checkpoint). On a (dp, tp) grid shard over tp first (``parallel/tp.py:
    shard_model_tp``): ``skip_sharded`` leaves its shards alone (JAX's default); False refuses one, as the port keeps
    one sharding a parameter."""
    if isinstance(state, nn.Module):
        _shard_module(state, mesh, min_size, skip_sharded)
        return state
    slices = _shard_module(state.model, mesh, min_size, skip_sharded)
    if state.teacher is not None:
        _shard_module(state.teacher, mesh, min_size, skip_sharded)
    opt = state.optimizer
    for group in opt.param_groups:
        whole = group["params"]
        group["params"] = [slices.get(id(p), p) for p in whole]
        for p, s in zip(whole, group["params"]):
            if s is not p and p in opt.state:
                opt.state[s] = {k: s.placement.take(v) if torch.is_tensor(v) and v.shape == p.shape else v
                                for k, v in opt.state.pop(p).items()}
    return state


def gather_buffers(model: nn.Module) -> dict[str, Tensor]:
    """The whole-weight buffers that persist with a sharded ``model`` (the weights its weight quantizers read), by
    parameter name; empty before its first forward or where nothing is gathered into one."""
    plan = _PLANS.get(model)
    if plan is None:
        return {}
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(plan.entries[i].shard)]: buf for i, buf in plan.buffers.items()}


def held_elements(state) -> dict[str, int]:
    """What a rank holds between steps, in elements: the student's parameters (``params``, slices and replicated),
    the teacher's (``teacher``), the optimizer's tensors of the parameters' shapes (``moments``: Adam's two) and the
    persistent gather buffers (``buffers``)."""
    opt_state = state.optimizer.state
    return {"params": sum(p.numel() for p in state.model.parameters()),
            "teacher": sum(p.numel() for p in state.teacher.parameters()) if state.teacher is not None else 0,
            "moments": sum(v.numel() for p, st in opt_state.items() for v in st.values()
                           if torch.is_tensor(v) and v.shape == p.shape),
            "buffers": sum(b.numel() for b in gather_buffers(state.model).values())}


__all__ = ["fsdp_sharding", "gather_buffers", "held_elements", "shard_state_fsdp"]
