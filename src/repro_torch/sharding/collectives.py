"""Collectives over one mesh axis's process group, with the gradients
that explicit SPMD needs.

The reference never writes these: GSPMD derives every collective and its
transpose from the shardings.  In the port each rank runs the model on
its own shards, and the model code calls the pairs below (Megatron's
tensor-parallel regions).  The invariant they keep: an activation that
is replicated over the group has the same gradient on every rank, and
one that is a per-rank part has that rank's part of it.

* :func:`copy_to` — identity forward, all-reduce (sum) backward: a
  replicated input entering a rank's slice of a column-parallel product.
* :func:`reduce_from` — all-reduce (sum) forward, identity backward: the
  partial sums of a row-parallel product, replicated after.
* :func:`gather_from` — all-gather along a dim forward, this rank's
  split backward: a column-parallel output made whole.
* :func:`scatter_to` — this rank's split forward, all-gather backward:
  a replicated tensor cut for a row-parallel product.
* :func:`all_to_all` — ``all_to_all_single`` over equal chunks of dim 0,
  forward and backward (the expert dispatch and its return).

``torch.distributed.all_to_all_single`` and the other in-place
collectives record no gradient; these do.  Sizes of one rank are not
short-cut: a mesh of one rank still issues its collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x, group, dim: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _split(x, group, dim: int):
    return x.chunk(_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.group, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int = -1):
    return _GatherFrom.apply(x, group, dim % x.dim())


def scatter_to(x, group, dim: int = -1):
    return _ScatterTo.apply(x, group, dim % x.dim())


def all_to_all(x, group):
    """x: (n, ...) with n the group's size: chunk j goes to rank j, and
    chunk j of the result came from rank j."""
    if x.shape[0] != _size(group):
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} for "
                         f"{_size(group)} ranks")
    return _AllToAll.apply(x, group)


@torch.no_grad()
def all_reduce(x, group, op: str = "sum"):
    """A reduced copy of ``x`` (no gradient): ``op`` "sum" or "max"."""
    return _all_reduce(x, group, {"sum": dist.ReduceOp.SUM,
                                  "max": dist.ReduceOp.MAX}[op])


@torch.no_grad()
def all_gather(x, group, dim: int = 0):
    """The group's ``x`` concatenated along ``dim`` (no gradient)."""
    return _all_gather(x, group, dim)
