"""pencil_tpu_torch — the PyTorch/CUDA port of pencil_tpu.

These slices run on an NVIDIA Hopper GPU through hand-written CUDA kernels,
and on the CPU through their plain PyTorch versions (float32, 6th-order
central differences, the 2N-RK orders 1-4):

* the flagship step: forced isothermal MHD in a periodic cube
  (``configs.flagship``), and the same without Magnetic
  (``configs.forced_hydro``);
* non-isothermal forced turbulence: the flagship with an entropy field,
  with and without Magnetic (``configs.forced_entropy``); these four also
  with del6 hyper-diffusion (``hyper3=True``);
* stratified convection with a non-periodic z axis, with and without
  Magnetic (magnetoconvection), rotation and chi-const conduction
  (``configs.conv_slab``);
* the isothermal stratified layer, hydro or MHD, under constant gravity
  or in the stratified shearing box (the MRI box; ``configs.strat_box``);
* the sheared, rotating MHD box with shock viscosity and hyper-diffusion
  (``configs.shear_box``);
* the shocked periodic box: forced MHD with shock viscosity
  (``configs.shock_box``).

``Run`` and ``simulate`` drive a model through a whole simulation:
``time_series.dat``, rolling checkpoints and bit-exact restart, power
spectra, plane and phi averages, slices, time averages, downsampled
snapshots, sound probes and ``timing.dat`` (``post.read`` reads them
back).  ``python -m pencil_tpu_torch start|run|export <rundir>`` runs a
Pencil Code run directory (``compat.rundir`` loads it, replaying the
reference's random stream; ``compat.io_dist`` writes the reference's
var.dat).

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
