"""Physics-module protocol (counterpart of ``pencil_tpu/physics/base.py``).

A module is a frozen config dataclass with optional hooks; an absent module
is simply not composed in.  The flagship has no trained parameters, so no
module is an ``nn.Module``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict

import torch


class TimestepAccum:
    """Per-point CFL accumulators (reference advec_*/maxdiffus*,
    src/equ.f90:916-931).  Modules add; ``cfl_dt1`` reduces."""

    def __init__(self):
        self.maxadvec = 0.0    # Σ_a |u_a|·dline_1_a  (linear advection terms)
        self.advec_cs2 = 0.0   # (cs² + vA²)·Σ_a Δ_a⁻²  (wave speeds, squared)
        self.advec2_hypermesh = 0.0  # Σ (c·π⁻⁵·√Σ_a dline_a⁻²)²  (mesh hyper)
        self.maxdiffus = 0.0   # max(ν, η, χ, ...) — scaled by dxyz_2 at the end
        self.maxdiffus3 = 0.0  # hyper-diffusivities — scaled by dxyz_6

    def advec(self, val):
        self.maxadvec = self.maxadvec + val

    def advec_mesh(self, val):
        """The rate of a mesh hyper-diffusion, c·π⁻⁵·√Σ_a dline_1_a²: its
        square joins advec2_hypermesh, whose root joins maxadvec linearly
        after the wave-speed root (JAX physics/base.py:31-36; reference
        density.f90:2801-2803, equ.f90:1100-1107)."""
        self.advec2_hypermesh = self.advec2_hypermesh + val * val

    def advec2(self, val):
        """Squared wave-speed term; its root joins maxadvec linearly."""
        self.advec_cs2 = self.advec_cs2 + val

    def diffus(self, val):
        """A diffusivity: a float (ν, η) or a pointwise tensor (the K-const
        conduction's χ = K/(ρcp)·γ), kept as their elementwise maximum."""
        self.maxdiffus = _maximum(self.maxdiffus, val)

    def diffus3(self, val):
        """A hyper-diffusivity (ν₃, η₃, D₃), kept as their maximum (JAX
        physics/base.py:59-60)."""
        self.maxdiffus3 = _maximum(self.maxdiffus3, val)


def _maximum(a, b):
    """max of two rates, each a float or a tensor (JAX ``jnp.maximum``)."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        return max(a, b)
    if not torch.is_tensor(a):
        return torch.clamp_min(b, a)
    if not torch.is_tensor(b):
        return torch.clamp_min(a, b)
    return torch.maximum(a, b)


def accumulate(df: Dict[str, torch.Tensor], name: str, val: torch.Tensor):
    if name in df:
        df[name] = df[name] + val
    else:
        df[name] = val


@dataclass(frozen=True)
class ModuleBase:
    """Base with no-op hooks; subclasses override what they provide."""

    name: ClassVar[str] = "base"

    def register(self, reg):
        """Claim f-array slots."""

    def rhs(self, pen, df, ts):
        """Accumulate RHS contributions into df and CFL terms into ts."""

    def init_fields(self, grid, spec, generator, cfg=None):
        """Initial condition for this module's fields."""
        return {}
