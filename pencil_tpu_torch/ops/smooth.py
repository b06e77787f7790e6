"""Neighbourhood maximum and binomial smoothing (counterpart of
``max_filter`` and ``smooth_binomial`` in ``pencil_tpu/ops/smooth.py:11-29,
:75-87``), the stages of the shock profile.  Both act on the trailing three
axes of a ghosted tensor and consume ghost width as they go.
"""
from __future__ import annotations

import torch


def max_filter(fg, radius=2):
    """Separable running maximum over a (2r+1)³ box (reference max5); each
    axis shrinks by 2·radius."""
    out = fg
    for axis in range(3):
        ax = out.ndim - 3 + axis
        n = out.shape[ax] - 2 * radius
        acc = None
        for k in range(2 * radius + 1):
            s = out.narrow(ax, k, n)
            acc = s if acc is None else torch.maximum(acc, s)
        out = acc
    return out


def smooth_binomial(fg):
    """Separable binomial [1, 2, 1]/4 smoothing; each axis shrinks by 2."""
    out = fg
    for axis in range(3):
        ax = out.ndim - 3 + axis
        n = out.shape[ax] - 2
        out = (0.25 * out.narrow(ax, 0, n) + 0.5 * out.narrow(ax, 1, n)
               + 0.25 * out.narrow(ax, 2, n))
    return out
