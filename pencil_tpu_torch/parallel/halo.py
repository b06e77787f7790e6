"""Ghost-zone fill on one device (counterpart of ``fill_ghosts`` in
``pencil_tpu/parallel/halo.py:67-158`` without a mesh or alignment
padding).

Axes are filled in order x, y, z: each axis first wraps periodically from
the interior, then, if it is not periodic, takes its physical BCs.  With
``shear_dy`` the x faces are shear-periodic: right after the x wrap the
two x ghost slabs are shifted in y by ±shear_dy (the JAX package's
single-device branch, halo.py:112-152).  Every wrap copies the full extent
of the axes filled before it, so the ghost corners (which the bidiagonal
mixed derivative reads) come out as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.boundary import apply_axis_bcs
from ..physics.shear import shift_x_faces


def _wrap_axis(fg, axis, g):
    """Periodic fill of one spatial axis from the interior, in place."""
    ax = fg.ndim - 3 + axis
    m = fg.shape[ax]
    n = m - 2 * g
    if n < g:
        # a short axis: tile the interior periodically
        idx = torch.remainder(torch.arange(m, device=fg.device) - g, n) + g
        fg.copy_(fg.index_select(ax, idx))
        return
    fg.narrow(ax, 0, g).copy_(fg.narrow(ax, m - 2 * g, g))
    fg.narrow(ax, m - g, g).copy_(fg.narrow(ax, g, g))


def fill_ghosts(fa, spec, bc_axes: Tuple[tuple, tuple, tuple], reg, grid,
                cfg, eos=None, axes: Tuple[int, ...] = (0, 1, 2),
                shear_dy=None, zgh=None):
    """Interior stack (nc, nx, ny, nz) → a new stack ghosted along
    ``axes`` (nc, nx + 2g, ...).  ``fa`` is not modified.  ``shear_dy``
    (a 0-d device tensor) makes the x faces shear-periodic.  ``zgh``: the
    ghosted z coordinates of ``fa``'s planes where ``fa`` is a cut of the
    full z extent (the z BCs that read coordinates read these)."""
    g = spec.nghost
    lead = fa.ndim - 3
    shape = list(fa.shape)
    for a in axes:
        shape[lead + a] += 2 * g
    # every ghost cell is written below (wraps, then BCs), so no zero fill
    fg = fa.new_empty(shape)
    inner = fg
    for a in axes:
        inner = inner.narrow(lead + a, g, fa.shape[lead + a])
    inner.copy_(fa)
    for axis in axes:
        _wrap_axis(fg, axis, g)
        if not spec.periodic[axis]:
            apply_axis_bcs(fg, axis, bc_axes[axis], reg, grid, cfg, eos,
                           zgh=zgh if axis == 2 else None)
        if axis == 0 and shear_dy is not None:
            shift_x_faces(fg, shear_dy, spec.Ly, 1 in axes, 2 in axes)
    return fg


def ghosted_from_z_slabs(fa, zlo, zhi):
    """The stack ghosted in all three axes from the interior ``fa`` (nc,
    nx, ny, nz) and its z-halo slabs ``zlo`` and ``zhi`` (nc, nx, ny, g),
    cut from a z-only fill: z joined, then x and y wrapped.  This is
    ``fill_ghosts``' 3-axis result, the ghost corners included, where the
    z BCs leave the ghost columns of their ghost planes as an x/y wrap of
    the interior columns: every code but 'pot', 'pwd', 'pfe' (zeros there)
    and 'div' (edge values), whose sets the model feeds the x/y-ghosted
    layout (``ghosted_from_sheared_z_slabs``) instead."""
    g = zlo.shape[-1]
    nc, nx, ny, nz = fa.shape
    fg = fa.new_empty((nc, nx + 2 * g, ny + 2 * g, nz + 2 * g))
    inner = fg[:, g:g + nx, g:g + ny]
    inner[..., :g] = zlo
    inner[..., g:g + nz] = fa
    inner[..., g + nz:] = zhi
    _wrap_axis(fg, 0, g)
    _wrap_axis(fg, 1, g)
    return fg


def ghosted_from_sheared_z_slabs(fg, zlo, zhi):
    """The stack ghosted in all three axes from the x/y-ghosted stack
    ``fg`` (nc, nx+2g, ny+2g, nz) and its z-halo slabs ``zlo`` and
    ``zhi`` (nc, nx+2g, ny+2g, g), cut from a z-only fill of ``fg``'s end
    planes (``Model.z_slabs`` of ``Model.ghosted(fa, (0, 1), shear_dy)``):
    the sheared counterpart of ``ghosted_from_z_slabs``.  The x/y fill
    shifts the x faces before the z BCs act on them, so this is
    ``fill_ghosts``' 3-axis result with ``shear_dy``, the corners beside
    the shifted faces included, for every z BC: the slabs' ghost columns
    are what the BCs wrote there.  The sets whose z BCs write ghost
    columns that no wrap gives ('pot', 'div') take this layout without
    Shear too (``shear_dy`` None)."""
    return torch.cat([zlo, fg, zhi], dim=-1)
