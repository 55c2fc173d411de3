"""The mesh train step's collectives, differentiable, over
``torch.distributed`` groups (the JAX package gets these from XLA's SPMD
partitioner).

Each primitive is a ``torch.autograd.Function`` whose backward is the
adjoint of its forward:

- :func:`sum_over`: the sum over a group; backward the sum of the
  gradients over the group.
- :func:`grad_sum_over`: the identity; backward the sum of the gradients
  over the group. A tensor-parallel conv's input is the same on every
  rank of the ``model`` group, and each rank's backward gives only its
  output channels' share of the input's gradient.
- :func:`gather_channels`: the all-gather of the last (channel) axis over
  ``model``. Every rank of the group computes the same thing downstream
  from the gathered map, so their gradients are already equal: backward
  takes this rank's slice, with no reduction.
- :func:`gather_rows`: the all-gather of H over ``spatial``. Each rank
  consumes the gathered map for its own output rows, so backward is a
  reduce-scatter: the sum over the group, then this rank's rows.
- :func:`halo_rows`: H padded with one row from the neighbour above and
  one from the neighbour below (zero rows at the map's global top and
  bottom); backward adds each halo row's gradient to the row it came
  from, on the neighbour that owns it.

Group ``None`` is a group of one rank: every primitive is then the
identity. A group's ranks are in global rank order, which is the order of
their mesh coordinate along the group's axis (``parallel/mesh.py``).

Transport. Everything goes through :func:`all_reduce_` and
:func:`all_gather` (the halo and the reduce-scatter are built from them),
the one place that talks to the backend; the tensor goes to it as it is.
Ranks that share one card use ``gloo`` (NCCL refuses two ranks on one
device), which runs both collectives on CUDA tensors.
"""

from __future__ import annotations

import torch


def size(group) -> int:
    """The number of ranks in ``group`` (1 for ``None``)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def index(group) -> int:
    """This rank's position in ``group`` (0 for ``None``)."""
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place and return it (not
    differentiable)."""
    if group is None:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in
    group order (not differentiable)."""
    if group is None:
        return t
    import torch.distributed as dist

    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def barrier(group, device: torch.device) -> None:
    """Wait until every rank of ``group`` reaches this call (an all-reduce
    of one element on ``device``)."""
    all_reduce_(torch.zeros(1, device=device), group)


def _block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t``'s ``dim``, split evenly over ``group``."""
    n = t.shape[dim] // size(group)
    return t.narrow(dim, index(group) * n, n)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather(t, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.group, grad.dim() - 1).contiguous(), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather(t, group, 1)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_(grad.contiguous().clone(), ctx.group)
        return _block(total, ctx.group, 1).contiguous(), None


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        s, n = index(group), size(group)
        # every rank's [first row, last row], gathered: [n * 2, B, W, C]
        edges = all_gather(torch.stack([t[:, 0], t[:, -1]]), group, 0)
        zero = torch.zeros_like(t[:, :1])
        above = edges[2 * s - 1][:, None] if s > 0 else zero
        below = edges[2 * s + 2][:, None] if s < n - 1 else zero
        return torch.cat([above, t, below], dim=1)

    @staticmethod
    def backward(ctx, grad):
        s, n = index(ctx.group), size(ctx.group)
        # every rank's [gradient of its row above, of its row below]
        halo = all_gather(torch.stack([grad[:, 0], grad[:, -1]]), ctx.group,
                          0)
        out = grad[:, 1:-1].clone()
        if s > 0:  # my first row was the row below of rank s - 1
            out[:, 0] += halo[2 * (s - 1) + 1]
        if s < n - 1:  # my last row was the row above of rank s + 1
            out[:, -1] += halo[2 * (s + 1)]
        return out, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable."""
    return t if group is None else _SumOver.apply(t, group)


def grad_sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, its gradient summed over ``group``."""
    return t if group is None else _GradSumOver.apply(t, group)


def gather_channels(t: torch.Tensor, group) -> torch.Tensor:
    """NHWC ``t``'s channels gathered over ``group``, differentiable."""
    return t if group is None else _GatherChannels.apply(t, group)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """NHWC ``t``'s rows gathered over ``group``, differentiable."""
    return t if group is None else _GatherRows.apply(t, group)


def halo_rows(t: torch.Tensor, group) -> torch.Tensor:
    """NHWC ``t`` with one halo row above and below (``[B, H + 2, W,
    C]``), differentiable. ``group`` is the spatial group: with one rank
    the halo rows are zero."""
    if group is None:
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 1, 1))
    return _HaloRows.apply(t, group)
