"""Tensor parallelism over a ``model`` process group (the port of
transformer_tts_tpu/parallel/tp.py).

The JAX package shards every kernel whose last dimension divides the
``model`` axis and lets GSPMD derive the activations' shardings and the
collectives; a ``pallas_call`` cannot be partitioned, so its attention
kernels run on every head. Here the split is Megatron's, written out:
``tensor_parallel(model, group)`` shards a model that every rank built
whole from one seed, so each rank's shards are exactly the unsharded
weights' slices, and rank r of n holds

* in every ``MultiHeadAttention`` and ``RelativeMultiHeadAttention``
  (ops/attention.py) heads [r H/n, (r+1) H/n): the rows of ``q_linear``,
  ``k_linear``, ``v_linear`` (and ``linear_pos``) that make them, with
  their biases, the rows of ``pos_bias_u``/``pos_bias_v``, and the
  matching input columns of ``out`` -- only its context columns under
  ``concat_after``, whose ``q_in`` columns stay whole;
* in every ``ConvFeedForward`` the output channels [r 4d/n, (r+1) 4d/n)
  of ``f_1`` and the matching input channels of ``f_2``; in every
  ``ConformerFeedForward`` the same of ``linear1`` and ``linear2``;
* everything else whole (replicated).

A block's column-split products (``TensorParallel.column``: q/k/v,
``linear_pos``, ``f_1``, ``linear1``) take their inputs through
``copy_to_group`` (identity forward, one all-reduce of the inputs'
gradients backward), a row-split one
(``TensorParallel.row``: ``out``, ``f_2``, ``linear2``) sums its partial
products through ``reduce_from_group`` (all-reduce forward in fp32,
identity backward) before its bias and, under ``concat_after``, the
``q_in`` term are added on every rank. So every replicated activation and
every replicated parameter's gradient is the same on each rank of the
group, and equal to the unsharded model's. Under autocast both take
their products in fp32 over the values autocast multiplies (bf16 values,
whose products fp32 holds exactly; on the card in TF32, which holds
bf16 values exactly too) and round them where one process's
layer rounds them: a row-split output once, after the fp32 sum over the
group, and a column-split layer's input gradient once, after its own
fp32 sum over the group, before autograd adds the q, k and v layers'
gradients; every other product's contraction is whole on each rank and
is rounded once, as one process's is. So the split step differs from one
process's only by the order of fp32 sums. The attention kernels run on a
rank's H/n heads with ``head_offset`` r H/n and ``heads_total`` H, so
their in-kernel dropout hashes the unsharded model's batch-heads; the
masked path's and the conformer FFN's plain dropouts draw torch's mask for
the whole tensor and keep the rank's slice (``TensorParallel.dropout``),
so every dropout draws what the unsharded step draws.

``param_shardings`` gives, per parameter, the dimension it is split on;
``gather_state_dict`` the whole ``state_dict`` in the unsharded names and
shapes; ``shard_optimizer_state`` (the counterpart of ``shard_state_tp``)
slices an optimizer's moments as the parameters, and ``load_full_state``
a whole checkpoint into a sharded model.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.autograd.graph import get_gradient_edge


@dataclass(frozen=True)
class Shard:
    """How a parameter is split: along ``dim``, the region [offset,
    offset + length) of the unsharded tensor in n equal parts, rank r
    holding part r after the region's front [0, offset), which every rank
    holds whole."""
    dim: int
    length: int
    offset: int = 0


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        if live:
            flat = torch.cat([g.reshape(-1) for g in live])
            dist.all_reduce(flat, group=ctx.group)
            parts = iter(flat.split([g.numel() for g in live]))
            grads = tuple(None if g is None else next(parts).view_as(g)
                          for g in grads)
        return (None,) + tuple(grads)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        total = x.float().contiguous().clone()
        dist.all_reduce(total, group=group)
        # in x's layout (a transposed conv output's strides), which the
        # unsharded output has: a dropout mask is drawn in memory order
        return torch.empty_like(x, dtype=torch.float32).copy_(total)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in
                 range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_group(xs, group) -> list:
    """The tensors ``xs`` unchanged; the gradients of those that require
    one summed over ``group``'s ranks in one all-reduce (a tensor given
    twice passes once, its gradients added before the sum)."""
    unique = {id(x): x for x in xs if x.requires_grad}
    copied = dict(zip(unique, _CopyToGroup.apply(group, *unique.values())))
    return [copied.get(id(x), x) for x in xs]


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum of ``x`` over ``group``'s ranks, in ``x``'s memory
    layout; the gradient passes unchanged."""
    return _ReduceFromGroup.apply(x, group)


def _amp_dtype(x: torch.Tensor) -> Optional[torch.dtype]:
    """The dtype autocast takes products in on ``x``'s device, or None
    outside autocast."""
    device = x.device.type
    if not torch.is_autocast_enabled(device):
        return None
    return torch.get_autocast_dtype(device)


def _operand(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` as the fp32 tensor of the values autocast multiplies (None:
    ``x``). Its gradient is rounded to ``dtype`` once on the way back, as
    the gradient of autocast's cast is."""
    return x if dtype is None else x.to(dtype).float()


@contextmanager
def _tf32(on: bool):
    """cuBLAS and cuDNN take fp32 products in TF32 while ``on``."""
    if not on:
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class _Product(torch.autograd.Function):
    """``op(x, weight, None)`` of fp32 tensors that hold bf16 values, its
    forward and backward in TF32 on the card. TF32 holds a bf16 value
    exactly, so the tensor cores take the exact products and fp32 sums
    that an fp32 product takes. The op's own graph is kept by its
    gradient edge (not its output) and differentiated in the backward."""

    @staticmethod
    def forward(ctx, op, x, weight):
        need = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((x, weight), need)]
        with torch.enable_grad(), _tf32(x.is_cuda):
            y = op(*leaves, None)
        ctx.graph = (get_gradient_edge(y), leaves) if any(need) else None
        return y.detach()

    @staticmethod
    def backward(ctx, grad):
        edge, leaves = ctx.graph
        with _tf32(grad.is_cuda):
            grads = iter(torch.autograd.grad(
                [edge], [t for t in leaves if t.requires_grad], [grad]))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in leaves)


def _product(op, x: torch.Tensor, weight: torch.Tensor,
             dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``op(x, weight, None)``; under autocast (``dtype``) in fp32 over the
    values autocast multiplies (``_Product``)."""
    if dtype is None:
        return op(x, weight, None)
    return _Product.apply(op, _operand(x, dtype), _operand(weight, dtype))


def _rounded(product: torch.Tensor, bias: Optional[torch.Tensor],
             dtype: torch.dtype, apart: bool) -> torch.Tensor:
    """An fp32 ``product`` plus ``bias`` in ``dtype``, rounded where the
    library's layer rounds them: once, the bias (in ``dtype``) added in
    fp32 (cuBLAS's and oneDNN's GEMMs and oneDNN's convolution), or with
    ``apart`` the product first and then its sum with the bias (cuDNN's
    convolution adds its bias to the rounded output)."""
    if bias is None:
        return product.to(dtype)
    bias = bias.to(dtype)
    if apart:
        return product.to(dtype) + bias
    return (product + bias.float()).to(dtype)


class TensorParallel:
    """A rank's place in the ``model`` group, held by every split module
    as ``module.tp`` (None when unsplit): its rank, the group's size and
    the split products and collectives the modules call."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def column(self, op, layers, *, bias_apart: bool = False) -> list:
        """``op(x, weight, bias)`` for each (x, weight, bias) of a block's
        column-split layers: this rank's slice of each output, whose
        contraction is whole, and each ``x``'s gradient, this rank's part
        of a contraction over the group's slices, summed over the group
        (``copy_to_group``: one all-reduce for the block). Under autocast
        each product is taken in fp32 over the values autocast multiplies
        and rounded as one process's layer rounds it (``_rounded``), and
        each layer's input gradient is summed over the group in fp32 before
        its one rounding, the layer's own; the weights' and biases'
        gradients are rounded once."""
        dtype = _amp_dtype(layers[0][0])
        xs = copy_to_group([_operand(x, dtype) for x, _, _ in layers],
                           self.group)
        if dtype is None:
            return [op(x, w, b) for x, (_, w, b) in zip(xs, layers)]
        with torch.autocast(xs[0].device.type, enabled=False):
            return [_rounded(_Product.apply(op, x, _operand(w, dtype)), b,
                             dtype, bias_apart)
                    for x, (_, w, b) in zip(xs, layers)]

    def row(self, op, x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None, front=None, *,
            bias_apart: bool = False) -> torch.Tensor:
        """``op(x, weight) + bias`` of a row-split layer, ``x`` and
        ``weight``'s inputs this rank's slice: the ranks' partial products
        summed over the group in fp32, then ``front`` (an (input, weight)
        pair every rank holds whole: the ``concat_after`` query columns
        of the same contraction) added in fp32, then the bias, rounded as
        one process's layer rounds its whole contraction (``_rounded``).
        Under autocast the products are taken in fp32 over the values
        autocast multiplies; their gradients, whose contractions are whole
        on each rank, are rounded once."""
        dtype = _amp_dtype(x)
        with torch.autocast(x.device.type, enabled=False):
            total = reduce_from_group(_product(op, x, weight, dtype),
                                      self.group)
            if front is not None:
                total = total + _product(op, *front, dtype)
            return _rounded(total, bias, dtype or x.dtype, bias_apart)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices of a tensor split along ``dim``, whole on
        every rank (the attention maps a loss reads); the gradient of a
        rank's slice is its slice of the whole tensor's, which every rank
        holds alike."""
        return _GatherFromGroup.apply(x, self.group, dim)

    def heads(self, local: int, total: int) -> dict:
        """The kernels' hash arguments for this rank's ``local`` heads of
        ``total``."""
        return dict(head_offset=self.rank * local, heads_total=total)

    def dropout(self, module: nn.Dropout, x: torch.Tensor,
                dim: int) -> torch.Tensor:
        """``module`` applied to this rank's slice ``x`` (along ``dim``) of
        a tensor split in equal parts over the group: torch's mask is drawn
        for the whole tensor, as the unsharded model draws it from the same
        generator state, and the rank keeps its slice, scaled as torch
        scales it on that device: x times the drawn keep value on the CPU
        and in fp32; on the card another dtype rounds x * (1 / (1 - p))
        once, as its fused dropout does. The mask
        is drawn in memory order: ``x`` is contiguous, as the unsharded
        tensors here (attention probabilities, a Linear's output) are."""
        if not module.training or module.p == 0.0:
            return x
        dim = dim % x.dim()
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        keep = F.dropout(torch.ones(shape, dtype=x.dtype, device=x.device),
                         module.p, True)
        keep = keep.narrow(dim, self.rank * n, n)
        if x.dtype == torch.float32 or x.device.type == "cpu":
            return x * keep
        scale = float(np.float32(1.0 / np.float64(np.float32(
            1.0 - module.p))))
        return torch.where(keep != 0, x.float() * scale,
                           torch.zeros((), device=x.device)).to(x.dtype)


# ---- sharding a model -------------------------------------------------------

def _split_(param: nn.Parameter, shard: Shard, tp: TensorParallel) -> None:
    """Replace ``param``'s data by this rank's part, in place (the
    parameter object stays, so an optimizer built on it keeps it)."""
    part = shard.length // tp.size
    data = param.data
    front = data.narrow(shard.dim, 0, shard.offset)
    mine = data.narrow(shard.dim, shard.offset + tp.rank * part, part)
    param.data = torch.cat([front, mine], dim=shard.dim).contiguous()
    param.tp_shard = shard


def _mark(module, name: str, shard: Shard, tp: TensorParallel) -> None:
    param = getattr(module, name)
    if param is not None:
        _split_(param, shard, tp)


def tensor_parallel(model: nn.Module, group) -> int:
    """Split ``model``'s attention heads and FFN channels over ``group``
    in place (see the module doc); returns the number of blocks split. A
    block whose heads or channels the group's size does not divide stays
    whole, and so does every module of one rank's group."""
    from transformer_tts_tpu_torch.ops.attention import (
        MultiHeadAttention, RelativeMultiHeadAttention)
    from transformer_tts_tpu_torch.ops.feedforward import (
        ConformerFeedForward, ConvFeedForward)
    tp = TensorParallel(group)
    if tp.size == 1:
        return 0
    n = 0
    for module in model.modules():
        if getattr(module, "tp", None) is not None:
            raise ValueError("the model is split already")
        if isinstance(module, (MultiHeadAttention,
                               RelativeMultiHeadAttention)):
            if module.heads % tp.size:
                continue
            d = module.d_model
            for lin in ("q_linear", "k_linear", "v_linear"):
                _mark(getattr(module, lin), "weight", Shard(0, d), tp)
                _mark(getattr(module, lin), "bias", Shard(0, d), tp)
            out_in = module.out.weight.shape[1]
            _mark(module.out, "weight", Shard(1, d, out_in - d), tp)
            if isinstance(module, RelativeMultiHeadAttention):
                _mark(module.linear_pos, "weight", Shard(0, d), tp)
                for name in ("pos_bias_u", "pos_bias_v"):
                    _mark(module, name, Shard(0, module.heads), tp)
        elif isinstance(module, ConvFeedForward):
            width = module.f_1.out_channels
            if width % tp.size:
                continue
            _mark(module.f_1, "weight", Shard(0, width), tp)
            _mark(module.f_1, "bias", Shard(0, width), tp)
            _mark(module.f_2, "weight", Shard(1, width), tp)
        elif isinstance(module, ConformerFeedForward):
            width = module.linear1.out_features
            if width % tp.size:
                continue
            _mark(module.linear1, "weight", Shard(0, width), tp)
            _mark(module.linear1, "bias", Shard(0, width), tp)
            _mark(module.linear2, "weight", Shard(1, width), tp)
        else:
            continue
        module.tp = tp
        n += 1
    return n


def param_shardings(model: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension it is split on, or None}: the port's
    counterpart of JAX ``param_shardings``, for tests and logs."""
    return {name: (p.tp_shard.dim if hasattr(p, "tp_shard") else None)
            for name, p in model.named_parameters()}


def _gather(local: torch.Tensor, shard: Shard, group) -> torch.Tensor:
    """The unsharded tensor from every rank's ``local`` part."""
    parts = [torch.empty_like(local) for _ in
             range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    own = shard.length // len(parts)
    front = local.narrow(shard.dim, 0, shard.offset)
    return torch.cat([front] + [p.narrow(shard.dim, shard.offset, own)
                                for p in parts], dim=shard.dim)


def _slice(full: torch.Tensor, shard: Shard, rank: int,
           size: int) -> torch.Tensor:
    part = shard.length // size
    return torch.cat([full.narrow(shard.dim, 0, shard.offset),
                      full.narrow(shard.dim, shard.offset + rank * part,
                                  part)], dim=shard.dim)


def _shards_by_name(model: nn.Module) -> Dict[str, Shard]:
    return {name: p.tp_shard for name, p in model.named_parameters()
            if hasattr(p, "tp_shard")}


def gather_state_dict(model: nn.Module, group) -> Dict[str, torch.Tensor]:
    """``model``'s whole ``state_dict`` in the unsharded names and shapes
    (a collective: every rank of ``group`` calls it)."""
    shards = _shards_by_name(model)
    return {k: (_gather(v.detach(), shards[k], group) if k in shards
                else v.detach())
            for k, v in model.state_dict().items()}


def _tensor_states(optimizer):
    """(index, parameter, its state dict) of the inner torch optimizer,
    in the order of ``optimizer.params``."""
    inner = optimizer.inner
    for i, p in enumerate(optimizer.params):
        yield i, p, inner.state.get(p, {})


def _moments(state: dict, p: nn.Parameter):
    return [k for k, v in state.items()
            if torch.is_tensor(v) and v.shape == p.shape and v.dim() > 0]


def shard_optimizer_state(optimizer, model_group) -> None:
    """The counterpart of ``shard_state_tp``'s ``opt_state``: every moment
    of a split parameter (and a partial sum of an accumulation) sliced as
    the parameter, and the optimizer's global norm told which gradients
    are split over ``model_group``."""
    tp = TensorParallel(model_group)
    for _, p, state in _tensor_states(optimizer):
        shard = getattr(p, "tp_shard", None)
        if shard is None:
            continue
        for k, v in state.items():
            if torch.is_tensor(v) and v.dim() > 0 and v.shape != p.shape:
                state[k] = _slice(v, shard, tp.rank, tp.size).contiguous()
        if p.grad is not None and p.grad.shape != p.shape:
            p.grad = _slice(p.grad, shard, tp.rank, tp.size).contiguous()
    optimizer.norm_group = model_group
    optimizer.split = [hasattr(p, "tp_shard") for p in optimizer.params]


def gather_optimizer_state(optimizer, group) -> dict:
    """``optimizer.state_dict()`` with every split moment (and partial sum)
    gathered to the unsharded shape (a collective over ``group``)."""
    out = optimizer.state_dict()
    inner = out["inner"]["state"]
    for i, p, state in _tensor_states(optimizer):
        shard = getattr(p, "tp_shard", None)
        if shard is None:
            continue
        # a new dict: state_dict() hands out the live per-parameter dicts
        inner[i] = dict(inner[i], **{k: _gather(state[k], shard, group)
                                     for k in _moments(state, p)})
        if out["acc"] is not None:
            out["acc"][i] = _gather(out["acc"][i], shard, group)
    return out


def load_full_state(model: nn.Module, full: Dict[str, torch.Tensor],
                    group) -> None:
    """Load a whole (unsharded) ``state_dict`` into a split ``model``:
    each split parameter takes this rank's part."""
    shards = _shards_by_name(model)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    model.load_state_dict({k: (_slice(v, shards[k], rank, size)
                               if k in shards else v)
                           for k, v in full.items()})
