"""The rows of a global batch on the ranks of a host mesh: the cut that
``partition.batch_specs`` gives a batch's leading dim, applied to local
tensors, and its inverse.  The rule is ``launch.mesh.batch_axes``, the
reference's, which ``partition`` reads too."""
from __future__ import annotations

from repro_torch.launch.mesh import batch_axes

from . import collectives


def axes_index(mesh, axes) -> int:
    """This rank's index over ``axes`` (major to minor) of a host mesh."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coord(a)
    return i


def batch_tuple(mesh, batch_size: int):
    """``batch_axes`` as a tuple of axis names, () when no axis divides
    the batch."""
    axes = batch_axes(mesh, batch_size)
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else axes


def local_rows(x, mesh, batch_size: int):
    """This rank's rows of a global batch tensor ``x`` (dim 0 of size
    ``batch_size``): cut over ``batch_axes``, or all of them when no
    axis divides the batch.  None stays None."""
    axes = batch_tuple(mesh, batch_size)
    if x is None or not axes:
        return x
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return x.chunk(n, dim=0)[axes_index(mesh, axes)]


def gather_rows(x, mesh, batch_size: int, dim: int = 0):
    """The global batch whose rows ``local_rows`` gave this rank, its
    rows along ``dim``: an all-gather over the batch axes of more than
    one rank (no gradient).  An axis of one rank cuts no rows, so ``x``
    is already whole over it, and no gather is issued: a (1, M) mesh
    gathers nothing."""
    for a in reversed(batch_tuple(mesh, batch_size)):
        if mesh.shape[a] > 1:
            x = collectives.all_gather(x, mesh.group(a), dim)
    return x
