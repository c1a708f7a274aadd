"""Differentiable collectives of the per-rank backbone program.

On a ``launch.mesh.Mesh`` larger than one rank, every rank of the
backbone holds its block of each parameter tree (``sharding.
param_specs``) and runs the program on its own rows of the batch.  The
residual stream is data-sharded and replicated over ``model``; a
column-parallel product leaves a model-sharded activation and a
row-parallel product ends in one all-reduce over ``model``, the
collectives GSPMD inserts in the JAX package.  Each collective here is a
``torch.autograd.Function`` whose backward keeps the invariant that a
tensor replicated over ``model`` has the same gradient on every rank of
its slice:

* :func:`reduce_model`: all-reduce over ``model``; backward the identity.
* :func:`copy_model`: the identity into a model-sharded region; backward
  all-reduces the partial gradients.
* :func:`gather_model`: all-gather of the blocks along a dim; backward
  keeps this rank's block of the (replicated) gradient.
* :func:`scatter_model`: this rank's block of a replicated tensor;
  backward all-gathers.
* :func:`mean_data`: the mean over ``data`` (the MoE balance loss of
  each data shard); backward the identity, since the train step averages
  the gradients over ``data`` itself.

Each reads the active mesh (``ctx.use_mesh``) when it runs forward and
keeps it for its backward, which may run on autograd's device thread.
With no such mesh (one process, or an axis of size one) each is the
identity.

A sharded SOL graph (``core.executor.lower_graph`` on a graph that
``sharding.shard_graph`` partitioned) has its mesh and axes in hand, so
it calls the same collectives with both given: :func:`reduce_over` after
a row-parallel product (``psum_axes``), :func:`copy_over` where a
replicated tensor enters column-parallel products, and
:func:`gather_over` on a sharded output.
"""
from __future__ import annotations

import torch

from . import ctx

Tensor = torch.Tensor


def process_mesh():
    """The active mesh when it has process groups and more than one rank
    (a ``launch.mesh.Mesh``), else None."""
    mesh = ctx._mesh()
    if mesh is None or not hasattr(mesh, "all_reduce") or mesh.size == 1:
        return None
    return mesh


def span(axis: str) -> int:
    """The number of ranks along ``axis`` of the active mesh (1 without
    one)."""
    mesh = process_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def coord(axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    mesh = process_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 0
    return mesh.coords[axis]


def _block(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """This rank's block of ``x`` along ``dim``, cut over ``axes`` (a name
    or names) row-major, the order ``Mesh.all_gather`` joins them in."""
    n, i = 1, 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx_, x, mesh, axis, scale):
        out = mesh.all_reduce(x, axis)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx_, g):
        return g, None, None, None


class _Copy(torch.autograd.Function):

    @staticmethod
    def forward(ctx_, x, mesh, axis):
        ctx_.mesh, ctx_.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return ctx_.mesh.all_reduce(g, ctx_.axis), None, None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx_, x, mesh, axis, dim):
        ctx_.mesh, ctx_.axis, ctx_.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx_, g):
        return _block(g, ctx_.mesh, ctx_.axis, ctx_.dim), None, None, None


class _Scatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx_, x, mesh, axis, dim):
        ctx_.mesh, ctx_.axis, ctx_.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx_, g):
        return ctx_.mesh.all_gather(g, ctx_.axis, ctx_.dim), None, None, None


def _on(axis: str):
    mesh = process_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or mesh.shape[axis] == 1:
        return None
    return mesh


def reduce_over(x: Tensor, mesh, axes) -> Tensor:
    """The sum of ``x`` over the ranks of this rank's ``axes`` slice of
    ``mesh`` (partial sums); backward the identity."""
    return _AllReduce.apply(x, mesh, axes, 1.0)


def copy_over(x: Tensor, mesh, axes) -> Tensor:
    """``x`` (replicated over ``axes``) entering a region sharded over
    them: the identity, whose backward sums the ranks' partial
    gradients."""
    return _Copy.apply(x, mesh, axes)


def gather_over(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """The blocks of ``x`` of this rank's ``axes`` slice joined along
    ``dim``; backward keeps this rank's block."""
    return _Gather.apply(x, mesh, axes, dim % x.dim())


def reduce_model(x: Tensor) -> Tensor:
    """The sum of ``x`` over the ``model`` ranks (a row-parallel
    product's partial sums)."""
    mesh = _on("model")
    return x if mesh is None else reduce_over(x, mesh, "model")


def copy_model(x: Tensor) -> Tensor:
    """``x`` (replicated over ``model``) entering a model-sharded region:
    the identity, whose backward sums the ranks' partial gradients."""
    mesh = _on("model")
    return x if mesh is None else copy_over(x, mesh, "model")


def gather_model(x: Tensor, dim: int) -> Tensor:
    """The ``model`` ranks' blocks of ``x`` joined along ``dim``."""
    mesh = _on("model")
    return x if mesh is None else gather_over(x, mesh, "model", dim)


def scatter_model(x: Tensor, dim: int) -> Tensor:
    """This rank's block along ``dim`` of ``x`` (replicated over
    ``model``)."""
    mesh = _on("model")
    return x if mesh is None else _Scatter.apply(x, mesh, "model",
                                                 dim % x.dim())


def mean_data(x: Tensor) -> Tensor:
    """The mean of ``x`` over the data-parallel ranks."""
    mesh = process_mesh()
    if mesh is None:
        return x
    from .sharding import dp_axes
    dp = dp_axes(mesh)
    n = mesh.span(dp) if dp else 1
    return x if n == 1 else _AllReduce.apply(x, mesh, dp, 1.0 / n)

