"""Collectives of a step that every rank runs replicated, with the
autograd rules that make each rank's gradients the reference's.

The port's train and prefill steps run whole on every rank of a mesh:
each rank holds the full batch and every replicated parameter, and
computes the same graph outside the expert-parallel MoE layer
(``models/moe.py``'s ``moe_mlp_ep``).  Inside it a rank works on its own
block of the tokens, as a ``shard_map`` region does in the reference.
The functions here cross between the two, so that after the backward
every rank holds ``jax.grad`` of the reference's step:

* :func:`to_block` keeps the rank's block of a replicated tensor; its
  backward gathers the blocks' gradients back to the full tensor.
* :func:`from_blocks` gathers every rank's block into the full tensor;
  its backward keeps the rank's own block of the gradient.  (Every rank
  runs the same graph downstream, so the gradient there is the same on
  every rank; ``torch.distributed.nn.functional.all_gather`` sums the
  ranks' copies, n times too much here.)
* :func:`sum_grad` is the identity; its backward sums the gradient over
  the ranks, for a replicated parameter used on a block (the router, the
  experts over the data axis).
* :func:`all_to_all` exchanges equal chunks of the leading axis with
  ``all_to_all_single``; its backward is the same exchange.

The placed launch steps (``launch/steps.py``: FSDP over ``data``, tensor
and sequence parallelism over ``model``) use the collectives over one
mesh axis, each with its autograd rule:

* :func:`all_gather` concatenates every rank's block along a dim; its
  backward is a reduce-scatter (the gathered tensor's gradient is a
  partial sum on each rank: an FSDP weight under a batch split over the
  axis, a sequence-parallel residual entering a column-parallel product)
  or, with ``grad="slice"``, keeps the rank's block (the gradient is the
  same on every rank: a batch replicated over the axis).
* :func:`reduce_scatter` sums the ranks' tensors and keeps the rank's
  block along a dim (a row-parallel product's output entering the
  sequence-parallel residual); its backward is an all-gather.
* :func:`all_reduce` sums the ranks' tensors (a row-parallel product's
  output, a vocabulary-split lookup); its backward is the identity.

A split is a list of (process group, tensor dim) pairs, outermost
first: the tensor is cut over the first group, that block over the
next, and so on, as a ``PartitionSpec`` of several mesh axes cuts a
dim.  Sums gather every rank's tensor and add them in rank order, so the
result is the same bits on every rank (replicated parameters stay
bit-equal across ranks after an update).  :data:`CALLS` counts the
collectives by name.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Split = Sequence[Tuple[Optional[dist.ProcessGroup], int]]

CALLS: collections.Counter = collections.Counter()


def _gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x``, in the group's rank order."""
    CALLS["all_gather"] += 1
    if x.ndim == 0:
        return [p[0] for p in _gather(x[None], group)]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def _gather_cat(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The blocks of ``split`` (outermost first) gathered back to full:
    the innermost group first."""
    for group, dim in reversed(split):
        x = torch.cat(_gather(x, group), dim=dim)
    return x


def _own_block(x: torch.Tensor, split: Split) -> torch.Tensor:
    for group, dim in split:
        n = dist.get_world_size(group)
        x = x.chunk(n, dim=dim)[dist.get_rank(group)]
    return x.contiguous()


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each group in turn, in rank order (not autograd)."""
    for group in groups:
        parts = _gather(x, group)
        x = parts[0].clone()
        for p in parts[1:]:
            x += p
    return x


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of the sum of every rank's ``x``:
    each rank sends block i to rank i (``all_to_all_single``), then adds
    the blocks it received in rank order."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: {n} ranks do not divide dim "
                         f"{dim} of {tuple(x.shape)}")
    CALLS["reduce_scatter"] += 1
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    parts = out.chunk(n, dim=0)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            n = dist.get_world_size(ctx.group)
            g = g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
            return g.contiguous(), None, None, None
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g, ctx.group), dim=ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_over(x, [group])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _own_block(x, split)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.split), None


class _FromBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_cat(x, split)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.split), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.groups), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    CALLS["all_to_all_single"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def to_block(x: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's block of ``x`` (same on every rank) under ``split``."""
    return _ToBlock.apply(x, tuple(split))


def from_blocks(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's block ``x`` under ``split``, gathered to full."""
    return _FromBlocks.apply(x, tuple(split))


def sum_grad(x: torch.Tensor, groups) -> torch.Tensor:
    """``x``; its gradient summed over ``groups`` in the backward."""
    return _SumGrad.apply(x, tuple(groups))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``i`` of ``x``'s leading axis to rank ``i`` of ``group``;
    chunk ``i`` of the result from rank ``i``."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order; the backward reduce-scatters the gradient (``grad=
    "reduce_scatter"``) or keeps the rank's block of it (``"slice"``)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"all_gather: grad {grad!r}")
    return _AllGather.apply(x, group, dim, grad)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of the sum over ``group`` (rank
    order); the backward all-gathers the gradient."""
    return _ReduceScatter.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, added in rank order
    (the same bits on every rank); the backward is the identity."""
    return _AllReduce.apply(x, group)


def max_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x``'s elementwise max over each group in turn (not autograd)."""
    for group in groups:
        x = torch.stack(_gather(x, group)).amax(dim=0)
    return x
