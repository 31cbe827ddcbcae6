"""Tensor parallelism: Megatron column/row shards of the transformer projections (``fqss_tpu/parallel/tp.py``).

The JAX package annotates parameters with shardings and lets GSPMD emit the collectives. Here each rank of a
(dp, tp) grid (:func:`fqss_tpu_torch.parallel.mesh.grid`) holds its shard of those parameters and the layers make
the collectives themselves, inside :func:`~fqss_tpu_torch.parallel.mesh.sharded` of the grid.

What is sharded is what JAX's ``_leaf_spec`` marks (:func:`transformer_tp_specs`), in the port's ``[out, in]`` layout:

* column-parallel on dim 0: the attention's ``in_proj_weight [3E, E]`` and ``in_proj_bias``, an ``ffn_in`` dense
  layer's ``weight`` and ``bias`` (JAX's ``P(None, 'tp')`` on ``[in, out]`` kernels, ``P('tp')`` on biases);
* row-parallel on dim 1: the attention's ``out_proj_weight [E, E]`` and an ``ffn_out`` layer's ``weight`` (JAX's
  ``P('tp', None)``);
* replicated: everything else, the quantizers' ranges included. As in JAX, a matched dimension that does not
  divide by tp falls back to replicated.

The in-projection is split by heads (:func:`head_rows`): a rank holds the q, k and v rows of its ``h / tp`` heads,
the same product with its columns in another order, so K8 runs on a rank's own heads with no collective, and the
out-projection's input columns are those heads' ``E / tp``. So JAX's specs hold, dim for dim, while the placement
within the sharded dim differs.

The layers (``nn/layers.py:QDense``, ``nn/attention.py``) use Megatron's pair of autograd functions on the tp group:
:func:`copy_to_tp` before a column-parallel product (identity forward, the gradient summed over tp backward) and
:func:`reduce_from_tp` after a row-parallel product (the partial sums summed over tp forward, identity backward;
not ``mesh.all_sum``, whose backward sums the ranks' gradients as the data ranks' losses need). A row-parallel
product runs without its bias and act grid (no fused epilogue on a partial sum); they follow the reduction.

Quantizers (:func:`shard_model_tp` marks them): an act quantizer whose input tp shards (``ActQuantizer.tp_sharded``:
the q/k/v, scale, logit, softmax and head grids of a sharded attention, a column-parallel layer's output grid and
the grids between it and its row-parallel partner) observes over every rank of the grid, as GSPMD's observer sees
the whole tensor; a replicated one over dp alone. A weight quantizer of a sharded weight (``WeightQuantizer.tp``)
takes the weight pass's split: observe, reduce over tp, quantize (``quant/quantizers.py:weight_pass``). The range
gradients of all of them are partial sums over a shard (K1-bwd's, K5-bwd's and K2-bwd's partials; a column shard's
rows of a whole range tensor): such parameters carry ``tp_partial`` and :func:`reduce_partial_gradients_` sums them
over tp before the data-parallel reduction. A sharded parameter carries its placement (``parallel/shards.py``: the
dim, its index along it and the whole extent, over the tp group), by which the clip's global norm counts its square
once over the shards and the whole state is gathered.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import shards
from fqss_tpu_torch.quant import quantizers as qz
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer

Tensor = torch.Tensor

COLUMN, ROW = "column", "row"
_COL_WEIGHTS = {"in_proj_weight": 0, "in_proj_bias": 0}
_ROW_WEIGHTS = {"out_proj_weight": 1}
_COL_PARENTS = {"ffn_in"}
_ROW_PARENTS = {"ffn_out"}


@dataclasses.dataclass(frozen=True)
class Shard:
    """A module's place on the tp axis: ``kind`` (column or row), this rank of ``size``."""

    kind: str
    rank: int
    size: int


def leaf_spec(key: str) -> int | None:
    """The dimension that tp shards of the state-dict entry ``key`` (JAX's ``_leaf_spec`` through the port's names
    and layouts), or None where it is replicated."""
    *scope, name = key.split(".")
    parent = scope[-1] if scope else ""
    if name in _COL_WEIGHTS:
        return _COL_WEIGHTS[name]
    if name in _ROW_WEIGHTS:
        return _ROW_WEIGHTS[name]
    if parent in _COL_PARENTS and name in ("weight", "bias"):
        return 0
    if parent in _ROW_PARENTS and name == "weight":
        return 1
    return None


def transformer_tp_specs(model: nn.Module, tp: int | None = None) -> dict[str, int | None]:
    """``{state-dict key: sharded dim or None}`` of ``model`` (:func:`leaf_spec`); with ``tp``, a dim that does not
    divide by it is None (replicated), as JAX's ``transformer_tp_specs`` with a mesh."""
    specs = {}
    for key, t in model.state_dict(keep_vars=True).items():
        d = leaf_spec(key)
        if d is not None and (t.ndim <= d or (tp is not None and t.shape[d] % tp)):
            d = None
        specs[key] = d
    return specs


def head_rows(embed_dim: int, num_heads: int, rank: int, size: int) -> Tensor:
    """The rows of ``in_proj_weight [3E, E]`` that tp rank ``rank`` of ``size`` holds: the q, k and v rows of its
    ``num_heads / size`` heads, in that order."""
    if num_heads % size:
        raise ValueError(f"tensor parallelism: {num_heads} heads do not divide over {size} ranks")
    width = embed_dim // size
    return torch.cat([torch.arange(j * embed_dim + rank * width, j * embed_dim + (rank + 1) * width)
                      for j in range(3)])


def _active_tp(shard: Shard) -> dp.Mesh:
    mesh = dp.active()
    if mesh is None or mesh.tp_size != shard.size:
        raise RuntimeError(f"a module sharded over {shard.size} tp ranks runs inside parallel.mesh.sharded() of a "
                           f"grid of that tp size (active: {mesh})")
    return mesh


def _sum_over_tp(x: Tensor, group) -> Tensor:
    """The layers' sums over tp (the row-parallel forwards' and the column-parallel backwards')."""
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _CopyToTp(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward (Megatron's "copy")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_tp(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    """The sum over the tp group forward; identity backward (Megatron's "reduce")."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over_tp(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: Tensor, shard: Shard) -> Tensor:
    """``x`` (replicated over tp) as a column-parallel layer's input: its gradient is summed over tp."""
    group = _active_tp(shard).tp_group
    return x if shard.size == 1 else _CopyToTp.apply(x, group)


def reduce_from_tp(x: Tensor, shard: Shard) -> Tensor:
    """A row-parallel layer's partial products summed over tp."""
    group = _active_tp(shard).tp_group
    return x if shard.size == 1 else _ReduceFromTp.apply(x, group)


def _shard_param(module: nn.Module, name: str, dim: int, index: Tensor, group) -> None:
    """Replace ``module.<name>`` by its rows (``dim`` 0) or columns (1) ``index``, placed over the tp ``group``."""
    whole = getattr(module, name)
    part = nn.Parameter(whole.detach().index_select(dim, index.to(whole.device)).clone(),
                        requires_grad=whole.requires_grad)
    setattr(module, name, shards.place(part, shards.TP, dim, index, whole.shape[dim], group))


def _mark_act(aq: ActQuantizer | None) -> None:
    if aq is not None:
        aq.tp_sharded = True
        for p in aq.parameters():
            p.tp_partial = True


def _mark_weight(wq: WeightQuantizer | None, kind: str, rows: Tensor | None, channels: int) -> None:
    if wq is not None:
        wq.tp = qz.TpWeight(kind, rows, channels)
        for p in (wq.min_range, wq.max_range):
            p.tp_partial = True


def _act_quantizers(module: nn.Module) -> list[ActQuantizer]:
    return [m for m in module.modules() if isinstance(m, ActQuantizer)]


def shard_model_tp(model: nn.Module, mesh: dp.Mesh) -> nn.Module:
    """Shard ``model``'s transformer projections over ``mesh``'s tp ranks, in place, from the whole weights that
    every rank holds (the same seed or checkpoint): each rank keeps its shard (module note). Build the optimizer
    after this. ``mesh.tp_size`` 1 leaves the model as it is."""
    if mesh.tp_size == 1:
        return model
    tp, r = mesh.tp_size, mesh.tp_rank
    specs = transformer_tp_specs(model, tp)
    for name, m in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        layer = getattr(m, "TP_LAYER", None)  # nn/attention.py's QMultiheadAttention, nn/layers.py's QDense
        if layer == "attention":
            col, row = specs[prefix + "in_proj_weight"], specs[prefix + "out_proj_weight"]
            if (col is None) != (row is None):
                raise ValueError(f"{name}: its in-projection and out-projection must both shard over {tp} or neither")
            if col is None:
                continue
            E = m.embed_dim
            rows = head_rows(E, m.num_heads, r, tp)
            cols = torch.arange(r * E // tp, (r + 1) * E // tp)
            _shard_param(m, "in_proj_weight", 0, rows, mesh.tp_group)
            _shard_param(m, "in_proj_bias", 0, rows, mesh.tp_group)
            _shard_param(m, "out_proj_weight", 1, cols, mesh.tp_group)
            _mark_weight(m.weight_fake_quantize_in, COLUMN, rows, 3 * E)
            _mark_weight(m.weight_fake_quantize_out, ROW, None, E)
            for site in ("q", "k", "v", "div", "attn", "softmax", "head"):
                _mark_act(getattr(m, f"activation_fake_quantize_{site}"))
            m.tp = Shard(COLUMN, r, tp)
        elif layer == "dense" and specs.get(prefix + "weight") is not None:
            scope = name.rpartition(".")[0]
            parent = model.get_submodule(scope)
            pair = [specs.get(f"{scope}.{c}.weight" if scope else f"{c}.weight") for c in ("ffn_in", "ffn_out")]
            if None in pair:
                raise ValueError(f"{name}: ffn_in and ffn_out must both shard over {tp} or neither")
            features = m.weight.shape[0]
            if specs[prefix + "weight"] == 0:
                rows = torch.arange(r * features // tp, (r + 1) * features // tp)
                _shard_param(m, "weight", 0, rows, mesh.tp_group)
                _shard_param(m, "bias", 0, rows, mesh.tp_group)
                _mark_weight(m.weight_fake_quantize, COLUMN, rows, features)
                _mark_act(m.activation_fake_quantize)
                for between in getattr(parent, "TP_SHARDED_BETWEEN", ()):
                    for aq in _act_quantizers(getattr(parent, between)):
                        _mark_act(aq)
                m.tp = Shard(COLUMN, r, tp)
            else:
                k = m.weight.shape[1]
                _shard_param(m, "weight", 1, torch.arange(r * k // tp, (r + 1) * k // tp), mesh.tp_group)
                _mark_weight(m.weight_fake_quantize, ROW, None, features)
                m.tp = Shard(ROW, r, tp)
    qz.forget_weight_pass(model)
    return model


def reduce_partial_gradients_(params) -> None:
    """Sum over the active grid's tp group, in place, the gradients of the parameters marked ``tp_partial`` (one
    ``all_reduce`` per device and dtype). Nothing without tensor parallelism."""
    mesh = dp.active()
    if mesh is None or mesh.tp_size == 1:
        return
    dp.sum_flat_([p.grad for p in params if getattr(p, "tp_partial", False) and p.grad is not None], mesh.tp_group)


__all__ = ["COLUMN", "ROW", "Shard", "copy_to_tp", "head_rows", "leaf_spec", "reduce_from_tp",
           "reduce_partial_gradients_", "shard_model_tp", "transformer_tp_specs"]
