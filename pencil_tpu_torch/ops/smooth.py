"""Neighbourhood maxima and smoothing (counterpart of
``pencil_tpu/ops/smooth.py``), the stages of the shock profile: the
'original' variant's max filter and binomial smoothing and the
'highorder' variant's per-axis max filter and 7-point smoothing.  Each acts
on the trailing three axes of a ghosted tensor and consumes ghost width as
it goes.
"""
from __future__ import annotations

import torch


def max_filter(fg, radius=2):
    """Separable running maximum over a (2r+1)³ box (reference max5); each
    axis shrinks by 2·radius."""
    return max_filter_axes(fg, radius, (True, True, True))


def max_filter_axes(fg, radius, active):
    """Separable running maximum over ±radius along the axes where
    ``active`` is True; every axis shrinks by 2·radius, an inactive one
    centre-cropped (reference shock_highorder.f90: ``ni =
    merge(ishock_max, 0, nxgrid > 1)``)."""
    out = fg
    for axis in range(3):
        ax = out.ndim - 3 + axis
        n = out.shape[ax] - 2 * radius
        if not active[axis]:
            out = out.narrow(ax, radius, n)
            continue
        acc = None
        for k in range(2 * radius + 1):
            s = out.narrow(ax, k, n)
            acc = s if acc is None else torch.maximum(acc, s)
        out = acc
    return out


def smooth_7pt(fg, active, lgaussian=False):
    """Separable 7-point smoothing along the active axes with the weights
    of the reference ``smoothing_kernel`` (src/sub.f90:8674), normalised:
    binomial (1, 6, 15, 20, 15, 6, 1) or 'gaussian' (1, 9, 45, 70, 45, 9,
    1); each axis shrinks by 6, an inactive one centre-cropped."""
    w = ((1., 9., 45., 70., 45., 9., 1.) if lgaussian
         else (1., 6., 15., 20., 15., 6., 1.))
    w = [c / sum(w) for c in w]
    out = fg
    for axis in range(3):
        ax = out.ndim - 3 + axis
        n = out.shape[ax] - 6
        if not active[axis]:
            out = out.narrow(ax, 3, n)
            continue
        acc = None
        for k in range(7):
            s = w[k] * out.narrow(ax, k, n)
            acc = s if acc is None else acc + s
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
