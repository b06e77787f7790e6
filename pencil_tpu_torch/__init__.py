"""pencil_tpu_torch — the PyTorch/CUDA port of pencil_tpu.

Four slices run on an NVIDIA Hopper GPU through hand-written CUDA kernels,
and on the CPU through their plain PyTorch versions (float32, 6th-order
central differences, the 2N-RK orders 1-4):

* the flagship step: forced isothermal MHD in a periodic cube;
* stratified convection with a non-periodic z axis
  (``configs.conv_slab``);
* the sheared, rotating MHD box with shock viscosity and hyper-diffusion
  (``configs.shear_box``);
* the shocked periodic box: forced MHD with shock viscosity
  (``configs.shock_box``).

The JAX package ``pencil_tpu`` is the reference it is held to; this
package never imports it or JAX.
"""
from . import configs
from .core.config import Config, GridSpec, MeshSpec, TimeSpec
from .core.grid import make_grid
from .model import Model, fused_gate
from .ops.boundary import BC
from .physics import (Density, Entropy, EosIdealGas, Forcing, Gravity, Hydro,
                      Magnetic, Shear, Shock, Viscosity)

__version__ = "0.5.0"
