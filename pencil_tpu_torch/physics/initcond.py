"""Initial conditions (counterpart of the 'zero' and 'gaussian-noise' cases
of ``pencil_tpu/physics/initcond.py``).  Other profiles enter through
``Model.init_state(overrides=...)``."""
from __future__ import annotations

import torch


def _noise(shape, grid, generator, ampl):
    return ampl * torch.randn(shape, generator=generator,
                              dtype=grid.x.dtype, device=grid.x.device)


def init_scalar(name, grid, spec, generator, ampl=0.0):
    shape = spec.shape
    if name in ("zero", "nothing", ""):
        return torch.zeros(shape, dtype=grid.x.dtype, device=grid.x.device)
    if name == "gaussian-noise":
        return _noise(shape, grid, generator, ampl)
    raise NotImplementedError(
        f"pencil_tpu_torch init_scalar {name!r}: pass the field through "
        "init_state(overrides=...)")


def init_vector(name, grid, spec, generator, ampl=0.0):
    shape = (3,) + spec.shape
    if name in ("zero", "nothing", ""):
        return torch.zeros(shape, dtype=grid.x.dtype, device=grid.x.device)
    if name == "gaussian-noise":
        return _noise(shape, grid, generator, ampl)
    raise NotImplementedError(
        f"pencil_tpu_torch init_vector {name!r}: pass the field through "
        "init_state(overrides=...)")
