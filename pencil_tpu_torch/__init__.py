"""pencil_tpu_torch — the PyTorch/CUDA port of pencil_tpu.

The first slice: the flagship step (forced isothermal MHD in a periodic
cube, 6th-order central differences, 2N-RK3, float32) runs on an NVIDIA
Hopper GPU through three hand-written CUDA kernels, and on the CPU through
their plain PyTorch versions.  The JAX package ``pencil_tpu`` is the
reference it is held to; this package never imports it or JAX.
"""
from .core.config import Config, GridSpec, MeshSpec, TimeSpec
from .core.grid import make_grid
from .model import Model, fused_gate
from .physics import (Density, EosIdealGas, Forcing, Hydro, Magnetic,
                      Viscosity)

__version__ = "0.1.0"
