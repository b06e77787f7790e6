"""pencil_tpu_torch — the PyTorch/CUDA port of pencil_tpu.

These slices run on an NVIDIA Hopper GPU through hand-written CUDA kernels,
and on the CPU through their plain PyTorch versions (float32, 6th-order
central differences, the 2N-RK orders 1-4):

* the flagship step: forced isothermal MHD in a periodic cube
  (``configs.flagship``), and the same without Magnetic
  (``configs.forced_hydro``);
* non-isothermal forced turbulence: the flagship with an entropy field,
  with and without Magnetic (``configs.forced_entropy``);
* stratified convection with a non-periodic z axis
  (``configs.conv_slab``);
* the sheared, rotating MHD box with shock viscosity and hyper-diffusion
  (``configs.shear_box``);
* the shocked periodic box: forced MHD with shock viscosity
  (``configs.shock_box``).

``Run`` and ``simulate`` drive a model through a whole simulation:
``time_series.dat``, rolling checkpoints and bit-exact restart.

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
from .run import Run, RunParams, simulate

__version__ = "0.6.0"
