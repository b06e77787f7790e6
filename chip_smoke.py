#!/usr/bin/env python3
"""Drive the pencil_tpu_torch main paths on one NVIDIA GPU: the forced-MHD
flagship step (kernels K1-K3; K2L at 2N-RK order 2, K3′ at order 4; the
K8 memory floor), forced hydro turbulence on the same template's 4-field
build (K1h-K3h, K3′h, K2Lh), non-isothermal forced turbulence on its
entropy builds (K1e-K2Le with Magnetic, K1he-K2Lhe without) and through
the run loop (``simulate``: time_series.dat, checkpoints, a bit-exact
restart), each of these four also with del6 hyper-diffusion
(``hyper3=True``: the H3 instances of the same kernels, launch names
``*_h3``), stratified convection with a non-periodic z (kernels K6, K7,
on the template's z-ghosted build) and magnetoconvection (K6m, K7m, on
its 8-field z-ghosted build), each also with chi-const conduction
(``chi=4e-3``: their CHI instances, ``*_chi``) and with del6
hyper-diffusion (``hyper3=True``: their H3 instances, ``*_h3``), both
in a shearing box (``shear=True``, the stratified shearing box: kernels
K6s, K7s and K6ms, K7ms, on the z-ghosted shear builds) and forced
convection (``forcing=0.05``: K6, K7 and the kick after the step), the
isothermal stratified layer (``strat_box``: the stratified MRI box and
its hydro flow, and forced stratified MHD and hydro under constant
gravity: K6msi/K7msi, K6si/K7si, K6mi/K7mi, K6i/K7i, on the z-ghosted
builds without ss), the stratified shearing box with an energy equation
(``strat_box(n, entropy=True)``, MHD and hydro: K6ms/K7ms and K6s/K7s,
their CHI instances, under g_z = −Ω²z) and forced stratified turbulence
in a periodic box (``strat_box(n, periodic=True, shear=False,
forcing=...)``, MHD and hydro: K1-K3 and K1h-K3h under g_z = −sin(πz/2);
every kernel but K8's reads g_z(z) as a vector), the sheared, rotating
MHD box with shock viscosity and hyper-diffusion (kernels K4, K5) and
the shocked periodic box (kernels K1s, K5w), these four on the same
template's two shock builds, and the other isothermal layouts of those
two chains, each on a build of its own: supersonic hydro turbulence (the
shocked box without Magnetic: K1sh, K5wh), the shear box without the
shock slot (K4n, K5n) and the forced hydro shear box with and without it
(K4h, K5h; K4hn, K5hn), the hydro ones with an entropy field:
non-isothermal supersonic turbulence (K1she, K5whe) and the hydro shear
box with ss, with and without the shock slot (K4he, K5he; K4hne, K5hne),
and the MHD ones with an entropy field: non-isothermal MHD shock
turbulence (K1se, K5wse) and the MHD shear box with ss, with and without
the shock slot (K4e, K5e; K4ne, K5ne), and the upwinding of the advection
(``upwind=True``: the UPW instances of every build, launch names
``*_upw``) on the flagship and the conv-slab, and the shock diffusivities
(``shock_box(n, shock_diffusion=True)``: D_sh, with Magnetic η_sh, with
ss χ_sh; the SHK instances, launch names ``*_sd``) on the shocked boxes,
MHD with ss and hydro, and stratified convection and magnetoconvection
with the Shock module's slot between the walls (``conv_slab(n,
shock=True)``: ν_sh; kernels K6k, K7k and, with Magnetic and chi-const,
K6mk, K7mk, launch names ``rhs_zg_shock*``, ``rhs_zg_mag_shock*``, each
also with the shock diffusivities, ``*_sd``, on the z-ghosted builds with
the shock slot) and the shocked box with the 'highorder' profile
(``shock_box(n)`` with ``Shock(variant="highorder")``, K1s and K5w), and
the shearing box's own options: SAFI (``safi=True``: the shear flow's
advection as a Fourier shift between substeps, the shear builds' kernels
with the flow's nodes at 0), the mesh flavour of del6 (``hyper3="mesh"``:
every H3 instance with the mesh weights and rate) and the mean momenta
removed after each step (``remove_mean_momenta=True``): the sheared,
rotating MHD box with all three (K4/K5), the stratified MRI box
(K6msi/K7msi) and the sheared conv-slab (K6s/K7s) with SAFI, and the
z-wall boundary conditions: magnetoconvection with a vacuum exterior
(ax, ay, az 'pot': the x/y-ghosted slabs on K6ms/K7ms at S = 0) and
Kramers convection with a black-body top over a hydrostatic density top
(ss 'c1:Fgs', lnρ 'a2:hs': K6/K7 chi).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and toolchain: the card, its power limit, nvcc, and the
     kernel build started in the background (one nvcc per library, at
     most one per CPU, the longest first; a kernel's first call waits for
     its own library, and phase 2 takes the builds in the order they
     finish);
  2. each fused kernel against its plain PyTorch version on the same CUDA
     inputs at 64³ and 32×64×128, the flagship template's instances also
     at 24×20×42, which breaks every edge of their x-march, K4, K5, K1s,
     K5w, K6, K7, K6m and K7m also at 16×24×40 and 24×20×42, and so
     K1sh/K5wh, K4n/K5n, K4h/K5h, K4hn/K5hn, K1she/K5whe, K4he/K5he,
     K4hne/K5hne, K1se/K5wse, K4e/K5e and K4ne/K5ne (each of these
     twenty also with and without Ω = 1 and del6 at 64³ and 24×20×42),
     the z-ghosted four at 32³ too, and each
     with Ω = 1 (their Coriolis instances) at
     the same five shapes, and with chi-const (their CHI instances, with
     and without Ω), and their H3 instances at 64³ and, with and
     without Ω and chi-const, at 24×20×42, K6s/K7s and K6ms/K7ms (Ω = 1,
     the input at t = 0.37) with and without chi-const and del6 at 64³
     and 24×20×42, the z-ghosted builds without ss (K6i/K7i … K6msi/K7msi)
     with and without Ω and del6 at 64³, 32³, 16×24×40 and 24×20×42 (the
     sheared ones at Ω = 1 from t = 0.37), every build under gravity at
     64³ and 24×20×42 ('const', 'linear-z' and 'sin-z' in turn across the
     chains: the periodic builds and the MHD one's H3 instances, the
     twelve shock and shear builds, the four z-ghosted builds with ss
     under 'linear-z' and 'sin-z', with Ω, chi-const or del6 in turn, the
     four without ss under 'sin-z'), every instance of the 24 builds
     with the continuous forcing (the four profiles in turn) and, in the
     12 MHD builds, B_ext at 24×20×42 (with and without Ω, del6 and
     chi-const), and the instances without those flags at 64³ (within
     the bounds of the checks without the terms), every UPW instance of
     the 24 builds with the three lupw flags on (with and without Ω and,
     with ss, chi-const) and every instance of the 8 builds with the
     shock slot with the three shock diffusivities on (with and without
     Ω, del6 and the upwinding) at 24×20×42, every instance of the two
     z-ghosted builds with the shock slot (with and without Ω, chi-const,
     the upwinding and the shock diffusivities) at 64³ and 24×20×42 and
     their plain and SHK ones at 32×64×128 and 16×24×40, the four periodic
     builds'
     H3 instances with and
     without Ω at 64³, 32×64×128 and 24×20×42 (each field
     within 2e-5 × its max, and within 1e-6 for K1s, K5w, K3′, K2L, K8,
     the hydro instances and K1-K3, K3′, K2L with Ω = 1, K8's K1 and K2
     variants bit for bit; the CFL maximum within 1e-6 relative; the
     shear-box input at t = 0.37 with a positive shock slot, the shock-box
     input at urms ≈ 1 with its shock slot from the pre-pass; the entropy
     instances within 2e-5, with chi-const alone, with K-const beside it
     and with K-const alone, the last two with Ω = 1), and two full
     steps of each path on the card against the same steps on the CPU at
     32³ (the flagship, forced hydro and both entropy sets at orders 2, 3
     and 4, the first two with Ω = 1 at order 3, the four with
     hyper-diffusion at order 3 and the flagship with it at orders 2 and
     4 and with Ω = 1, the shear box unforced and forced, the conv-slab
     with Magnetic, with Ω = 1 and with both, with chi-const, with
     Magnetic and chi-const, and with all three, both with del6 and
     magnetoconvection with del6, chi-const and Ω, the sheared conv-slab
     and magnetoconvection from t = 0.37, forced convection, the four
     isothermal stratified sets and forced stratified MHD, the stratified
     shearing box with an energy equation (MHD and hydro, from t = 0.37)
     and forced stratified turbulence in a periodic box (MHD and hydro),
     the imposed-field flagship, the ABC-flow dynamo, the Roberts flow and
     the NEMPI box, the upwinded flagship and conv-slab, the shocked
     boxes with the shock diffusivities (MHD with ss, hydro), the shocked
     conv-slab and magnetoconvection with chi-const, each with and
     without the shock diffusivities, the shocked box with the 'highorder'
     profile, the hydro shock box,
     the three other shear-box layouts, the three hydro layouts with ss
     and the three MHD layouts with ss), and at 64³ and 24×20×42 each of
     the twelve shear builds' two kernels with SAFI (without del6, and
     with the mesh flavour) and every H3 instance with the mesh weights
     (the twelve aux builds, the eight z-ghosted builds with H3, the four
     periodic builds' five kernels), and two steps at 32³ of the forced
     flagship with the mean removal (the kick after it) and with the mesh
     flavour, and of the three SAFI paths; every ported z-wall code's
     fills (the 3-axis one, the chain's cut and layout, the pinned
     boundary planes) on the card against the CPU at 32³, 'pot'/'pwd'/
     'pfe' and 'c1' on A also at 128×128×16, each component within 1e-6
     of its max, and two steps at 32³ of each layout route (the vacuum
     exterior, the black-body top, 's0d' on ux and uy);
  3. the main paths at 256³ through Model(cfg, device="cuda"),
     init_state(0) and make_step(), 3 warm-up and 20 timed steps under
     torch.cuda.set_sync_debug_mode("error"), the launch counts set to 0
     just before each path's timed steps and read just after: the
     flagship with exactly one launch of K1, K2, K3 per step, forced
     hydro with one of K1h, K2h, K3h, the conv-slab layer with one K6 and
     two K7 and magnetoconvection with one K6m and two K7m (each timed in
     5 windows of 20 steps, their spread and the card's busy time
     printed), the
     shear box with one K4 and two K5, the shock box with one
     K1s and two K5w, the hydro shock box, the shear box without the
     shock slot, the hydro shear box with and without it, the three
     hydro layouts with ss and the three MHD layouts with ss with one
     first and two update kernels of their builds (each of the twelve
     with
     the card's busy time of a step), the flagship at order 4 with K1,
     K2, two K3′ and K3,
     at order 2 with K1 and K2L (forced hydro and both entropy sets
     likewise with their builds; the four again with hyper3=True, on
     their H3 instances), the conv-slab and magnetoconvection again with
     chi-const (their CHI instances) and with del6 (their H3 instances),
     both in the shearing box (Ω = 0.5: one K6s and two K7s, one K6ms and
     two K7ms) and forced convection (one K6, two K7), each in 3 windows
     with the card's busy time, the isothermal stratified layer
     (strat_box(256) with and without hyper3=True, strat_box(256,
     magnetic=False), both with shear=False and forcing=0.05: one K6x
     and two K7x a step of their builds; strat_box(256, entropy=True)
     with and without Magnetic: one K6ms or K6s and two K7ms or K7s, CHI
     instances, a step), in 3 windows likewise, forced stratified
     turbulence in a periodic box (strat_box(256, periodic=True,
     shear=False, forcing=0.05) with and without Magnetic: one K1, K2, K3
     or K1h, K2h, K3h a step), the flagship in an imposed field
     (flagship(256, b_ext=(0, 0, 0.1))) and driven by the ABC flow alone
     (flagship(256, fcont=("ABC", 0.1, 1.0)), force = 0) with one K1, K2,
     K3 a step, the Roberts flow (forced_hydro(256, fcont=("RobertsFlow",
     0.1, 1.0))) with one K1h, K2h, K3h, the negative-effective-magnetic-
     pressure box (strat_box(256, shear=False, forcing=0.05, b_ext=(0,
     NEMPI_B0, 0))) with one K6mi and two K7mi in 3 windows, the
     upwinded flagship (flagship(256, upwind=True)) with one K1, K2, K3
     UPW a step, the upwinded conv-slab (conv_slab(256, upwind=True))
     with one K6 and two K7 UPW in 3 windows, the shocked boxes with the
     whole shock-capturing set (shock_box(256, entropy=True,
     shock_diffusion=True): one K1se and two K5wse SHK; shock_box(256,
     magnetic=False, shock_diffusion=True): one K1sh and two K5wh SHK),
     the shocked conv-slab (conv_slab(256, shock=True), with and without
     with_shock_diffusion: one K6k and two K7k, or their SHK instances, a
     step) and magnetoconvection (conv_slab(256, magnetic=True,
     shock=True, chi=4e-3), likewise: one K6mk and two K7mk, CHI or CHI
     and SHK, a step), each in 3 windows, the shocked box with the
     'highorder' profile (shock_box(256) with Shock(variant="highorder"):
     one K1s and two K5w a step), the SAFI paths (shear_box(256,
     safi=True, hyper3="mesh", remove_mean_momenta=True): one K4 and two
     K5; strat_box(256, safi=True): one K6msi and two K7msi;
     conv_slab(256, shear=True, Omega=0.5, safi=True): one K6s and two
     K7s), each with its dt beside the dt that the same state sets
     without SAFI and two steps on the card against the same steps on
     the CPU (the fields made on the CPU), the two z-wall paths
     (conv_slab(256, magnetic=True) with ax, ay, az 'pot': one K6ms and
     two K7ms at S = 0; conv_slab(256, heatcond="kramers") with ss
     'c1:Fgs' and lnρ 'a2:hs', σ_SBt from configs.fgs_sigma: one K6 and
     two K7 chi), each in 3 windows, and the K8 chain
     (Model(fake_rhs=True))
     with one launch of each of its three variants; then
     simulate(forced_entropy(256), nt=40) with rows every 10 steps and a
     checkpoint every 20, every chunk of steps under the sync debug mode
     "error": the rows it = 0, 1, 10, 20, 30, 40 all finite, COMPLETED,
     40 launches each of K1e, K2e, K3e, and a second run of 20 steps, a
     new model resumed from its var.npz and 20 more steps that gives the
     first run's fields bit for bit; then the run driver's outputs on the
     README quickstart's configuration (K1-K3, γ = 1.0001): 40 steps with
     the helical-MHD columns, 4 kinetic and magnetic spectra, plane
     averages every 10 steps, 2 phi-average dumps, 4 slices and 2
     downsampled snapshots, against the same 40 steps without them (K1,
     K2, K3 40 times each in both, every chunk under the sync debug mode
     "error"; every file's records finite; Parseval on the final
     velocity), and 20 steps with the time average, 3 sound probes and
     timing.dat, one step a call; the wall µs per step and point of each,
     the peak device memory and each evaluator's device ms; then the
     run-directory entry point: two run directories at 256³ (helical MHD
     turbulence in helical-MHDturb's shape, the reference's forcing draws
     replayed, on K1-K3; stratified convection in conv-slab's shape on
     K6/K7) and two at 128³ (helical-MHDturb's shape in an imposed field
     B_ext, and driven by the continuous forcing 'ABC' in place of the
     kicks) through ``python -m pencil_tpu_torch`` start, run --nt 20 and
     export in this process, the wall seconds of each, the launches per
     step (1/1/1; 1/2) under the sync guard, the final state within 2e-5
     of make_step's from the same replayed fields, the exported var.dat
     read back through the C++ codec bit for bit;
  4. each kernel's time against its plain version, each plain chain's
     step time, and the K8 chain's step time beside the flagship's, at
     256³, and the conv-slab's and magnetoconvection's step split (K6 or
     K6m, K7 or K7m, the z-halo fills, the boundary-plane writeback, the
     glue: each part's device time from one torch.profiler trace, its
     host issue time from a run without it); each H3 instance in turns
     with the instance without H3 and each CHI and z-ghosted H3 instance
     with the one without (with and without Ω), kernel by kernel;
     K6s/K7s and K6ms/K7ms in turns with K6/K7 and K6m/K7m, the sheared
     paths' and forced convection's step split (the x/y fills with the
     shifted faces and the kick among the parts); the isothermal
     stratified paths' kernels and splits, K6i/K7i, K6mi/K7mi, K6si/K7si
     and K6msi/K7msi in turns with K6/K7, K6m/K7m, K6s/K7s and
     K6ms/K7ms; the paths under gravity: the sheared ones' kernels and
     splits, K6ms/K7ms and K6s/K7s with chi-const in turns with the
     sheared magnetoconvection's and conv-slab's, and the periodic ones'
     K1, K2, K3 (K1h, K2h, K3h) in turns with the flagship's (forced
     hydro's) same instances without gravity; the paths with B_ext or
     the continuous forcing: their K1, K2, K3 in turns with the same
     instances of the flagship (forced hydro) without the term, with the
     byte bound of each (the profile's field 12 B a point more), the NEMPI
     box's K6mi/K7mi in turns with forced stratified MHD's;
     K1sh/K5wh in turns with K1s/K5w, K4n/K5n and K4h/K5h with K4/K5,
     K4hn/K5hn with K4h/K5h, K1she/K5whe with K1sh/K5wh, K4he/K5he with
     K4h/K5h, K4hne/K5hne with K4hn/K5hn, K1se/K5wse with K1s/K5w,
     K4e/K5e with K4/K5, K4ne/K5ne with K4n/K5n, each on its own path's
     final state; the upwinded paths' UPW kernels checked and timed
     against their plain versions and in turns with the flagship's K1-K3
     and the conv-slab's K6/K7, the shocked boxes with the shock
     diffusivities in turns with the same kernels without them; the
     shocked conv-slab paths' K6k/K7k and K6mk/K7mk (with and without
     SHK) checked and timed against their plain versions, in turns with
     K6/K7 and K6m/K7m, and their step split (the three shock pre-passes a
     part); the 'highorder' shocked box's K1s/K5w and its pre-pass; the
     SAFI paths' kernels checked and timed, in turns with their
     counterparts without SAFI, the z-ghosted ones' step splits (the three
     SAFI shifts a part) and the shear box's shift of one substep (device
     ms, kernels, host issue ms); the z-wall paths' kernels checked and
     their plain versions timed, in turns with their parent sets'
     (magnetoconvection's K6m/K7m, the Kramers conv-slab's K6/K7 chi), and
     their step splits (the z fills' device and host ms); the paths of
     Viscosity's other flavours and diffrho (VISC_COUNTERPART) in turns
     with their counterparts with 'nu-const' (the same instances with
     visx not taken); for
     each instance of the flagship template (csrc/fused_rhs.cu, all 26
     builds, with and without rotation and their own terms) its
     registers, local bytes (which must be 0: no spill, no stack), static
     and dynamic shared memory per block and resident blocks per SM.
Phase 2 also holds every build's instances with Viscosity's other
flavours and Density's diffrho on (PcParams.visx: 'nu-simplified',
'rho-nu-const', the bulk ζ and diffrho everywhere, 'shock-simple' with the
shock slot, 'nu-cspeed' between walls with ss, the anisotropic del6 on
the H3 instances; with Ω, the upwinding, chi-const and the shock
diffusivities) against their plain versions at 32³ (``compare_visc``),
and phase 3 runs the six paths of configs.VISCOSITY_PATHS at 256³ beside
their counterparts with 'nu-const', with two steps of each on the card
against the CPU at 64³ (at 256³ the CPU's plain chain takes minutes a
path).

    python3 chip_smoke.py --only visc

runs phase 1, those checks and paths and their counterparts, and their
kernels in turns, alone (a quicker run for work on those terms; no
kernels line and no result line).  Phase 2 also holds every H3 instance
of the 12 builds with ss with each flavour of Entropy's hyper-diffusion
of s (χ₃, the mesh χ₃ᵐ, the anisotropic χ₃ⱼ; the first beside Newtonian
and uniform cooling) and every kernel of the 8 periodic builds with ss
with the cooling terms alone against their plain versions at 32³
(``compare_chi3``), phase 3 runs hyper-diffusive forced MHD turbulence
with ss, χ₃ and Newtonian cooling (K1e-K3e H3) and hyper-diffusive
convection with χ₃ (K6/K7 H3) at 256³ beside the same paths without
them (ms/step and the card's busy ms/step), with two steps of each on
the card against the CPU at 64³, and phase 4 times their kernels in
turns with the counterparts'.

    python3 chip_smoke.py --only chi3

runs phase 1 and those alone, likewise.
The line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the exit code is then not 0.  Without a CUDA device the script
exits 1 and prints no result.  It imports no JAX.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_MAIN = 256
WARM, TIMED = 3, 20
# calls of a plain version or a plain chain timed: each takes 50-450 ms at
# 256³, a yardstick where one call is enough; timed with no warm-up call
# of its own, after the check's call of the same plain version (a chain:
# after its plain versions' calls)
PLAIN_CALLS = 1
RTOL_FIELD, RTOL_DT = 2e-5, 1e-6
# K1s, K5w, K3′, K2L, K8, the hydro instances and the Ω instances against
# their plain versions
RTOL_NEW = 1e-6
# K8's K1 and K2 variants round once per operation, as their plain versions
# do: they must agree bit for bit
EXACT = ("rhs_first_fake", "rhs_tail_defer_fake")
# the flagship instances' extra shape: nx below the x segment (64), ny not
# a multiple of the column's 8, nz neither of its 32 nor of 4
EDGE_SHAPE = (24, 20, 42)
FLAGSHIP_KERNELS = ("rhs_first", "rhs_tail_defer", "rhs_tail_last")
TAIL_KERNELS = ("rhs_tail_mid", "rhs_tail_defer_last")
# the flagship template's 4-field build (PC_MAG=0): K1h-K3h, K3′h, K2Lh
HYDRO_KERNELS = tuple(k + "_hydro" for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
# its builds with an entropy field (PC_ENT=1): K1e-K3e, K3′e, K2Le on 8
# fields, K1he-K3he, K3′he, K2Lhe on 5
ENT_KERNELS = tuple(k + "_ent" for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
HYDRO_ENT_KERNELS = tuple(k + "_hydro_ent"
                          for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
FAKE_KERNELS = ("rhs_first_fake", "rhs_tail_defer_fake", "rhs_tail_last_fake")
ZROLL_KERNELS = ("rhs_zroll", "rhs_zroll_upd")
SHOCK_KERNELS = ("rhs_wrap_shock", "rhs_wrap_shock_upd")
# the paths of the shock and shear builds (the aux chains): label ->
# (configuration function, its keyword arguments, launch-name suffix); the
# next four are the builds' other isothermal layouts: K1sh/K5wh, K4n/K5n,
# K4h/K5h, K4hn/K5hn
AUX_PATHS = {
    "shear box": ("shear_box", {}, ""),
    "shock box": ("shock_box", {}, ""),
    "hydro shock box": ("shock_box", dict(magnetic=False), "_hydro"),
    "shear box ns": ("shear_box", dict(shock=False), "_ns"),
    "hydro shear box": ("shear_box", dict(magnetic=False), "_hydro"),
    "hydro shear box ns": ("shear_box", dict(magnetic=False, shock=False),
                           "_hydro_ns"),
    # the hydro layouts with an entropy field: K1she/K5whe, K4he/K5he,
    # K4hne/K5hne
    "hydro shock box ent": ("shock_box", dict(magnetic=False, entropy=True),
                            "_hydro_ent"),
    "hydro shear box ent": ("shear_box", dict(magnetic=False, entropy=True),
                            "_hydro_ent"),
    "hydro shear box ent ns": ("shear_box", dict(
        magnetic=False, entropy=True, shock=False), "_hydro_ent_ns"),
    # the MHD layouts with an entropy field: K1se/K5wse, K4e/K5e,
    # K4ne/K5ne
    "shock box ent": ("shock_box", dict(entropy=True), "_ent"),
    "shear box ent": ("shear_box", dict(entropy=True), "_ent"),
    "shear box ent ns": ("shear_box", dict(entropy=True, shock=False),
                         "_ent_ns"),
}
NEW_AUX_PATHS = tuple(AUX_PATHS)[2:]
# each aux path's kernels (first, update) and the one its phase-4 turns
# hold it against: the MHD or shock-slot counterpart
AUX_NAMES = {label: tuple(k + sfx for k in (
    ZROLL_KERNELS if make == "shear_box" else SHOCK_KERNELS))
    for label, (make, _, sfx) in AUX_PATHS.items()}
AUX_COUNTERPART = {"hydro shock box": "shock box", "shear box ns": "shear box",
                   "hydro shear box": "shear box",
                   "hydro shear box ns": "hydro shear box",
                   "hydro shock box ent": "hydro shock box",
                   "hydro shear box ent": "hydro shear box",
                   "hydro shear box ent ns": "hydro shear box ns",
                   "shock box ent": "shock box",
                   "shear box ent": "shear box",
                   "shear box ent ns": "shear box ns"}
NEW_AUX_KERNELS = tuple(k for label in NEW_AUX_PATHS
                        for k in AUX_NAMES[label])
# each aux path's bound against its plain version in phase 2: the shocked
# boxes' 1e-6, the shear boxes' (del6 and the shifted faces) 2e-5
AUX_RTOL = {label: 1e-6 if AUX_PATHS[label][0] == "shock_box" else 2e-5
            for label in AUX_PATHS}
ZGHOST_KERNELS = ("rhs_zg", "rhs_zg_upd")
# the template's 8-field z-ghosted build: K6m, K7m
ZGHOST_MAG_KERNELS = ("rhs_zg_mag", "rhs_zg_upd_mag")
# the z-ghosted shear builds (the stratified shearing box): K6s, K7s and
# K6ms, K7ms
ZG_SHEAR_KERNELS = ("rhs_zg_shear", "rhs_zg_upd_shear",
                    "rhs_zg_mag_shear", "rhs_zg_upd_mag_shear")
# the H3 instances (del6 hyper-diffusion) of the four periodic builds
H3_KERNELS = tuple(k + sfx + "_h3" for sfx in ("", "_hydro", "_ent",
                                               "_hydro_ent")
                   for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
# the CHI instances (chi-const) and the H3 instances (del6) of the two
# z-ghosted builds
CHI_KERNELS = tuple(k + "_chi" for k in ZGHOST_KERNELS + ZGHOST_MAG_KERNELS)
ZG_H3_KERNELS = tuple(k + "_h3" for k in ZGHOST_KERNELS + ZGHOST_MAG_KERNELS)
# the z-ghosted builds without ss (the isothermal stratified layer): K6i,
# K7i, K6mi, K7mi, K6si, K7si, K6msi, K7msi, and the MRI box's H3
# instances (K6msi, K7msi with del6)
ISO_SFX = ("_iso", "_iso_mag", "_iso_shear", "_iso_mag_shear")
ZG_ISO_KERNELS = tuple(k + sfx for sfx in ISO_SFX for k in ZGHOST_KERNELS)
ZG_ISO_H3_KERNELS = tuple(k + "_iso_mag_shear_h3" for k in ZGHOST_KERNELS)
# the CHI instances of the z-ghosted shear builds, which the stratified
# shearing box with an energy equation runs (chi-const, g_z = −Ω²z)
ZG_SHEAR_CHI_KERNELS = tuple(k + "_chi" for k in ZG_SHEAR_KERNELS)
# the UPW instances (upwinding of the advection: lupw_lnrho, lupw_uu,
# lupw_ss) that the phase-3 paths run: the flagship's K1-K3 and the
# conv-slab's K6/K7
UPW_KERNELS = tuple(k + "_upw" for k in FLAGSHIP_KERNELS)
ZG_UPW_KERNELS = tuple(k + "_upw" for k in ZGHOST_KERNELS)
# the SHK instances (the shock diffusivities D_sh, η_sh, χ_sh) that the
# phase-3 paths run, launch names with the suffix _sd: K1se/K5wse and
# K1sh/K5wh
SD_KERNELS = tuple(k + "_sd" for label in ("shock box ent", "hydro shock box")
                   for k in AUX_NAMES[label])
# the z-ghosted builds with the shock slot on the phase-3 paths: K6k/K7k
# (ν_sh) and K6mk/K7mk with chi-const, each with and without the shock
# diffusivities (SHK, _sd)
ZG_SHOCK_KERNELS = tuple(k + sfx + sd for sfx in ("_shock", "_mag_shock_chi")
                         for sd in ("", "_sd")
                         for k in ("rhs_zg", "rhs_zg_upd"))
KERNEL_NAMES = (FLAGSHIP_KERNELS + TAIL_KERNELS + FAKE_KERNELS
                + HYDRO_KERNELS + ENT_KERNELS + HYDRO_ENT_KERNELS
                + ZROLL_KERNELS + SHOCK_KERNELS + ZGHOST_KERNELS
                + ZGHOST_MAG_KERNELS + H3_KERNELS + CHI_KERNELS
                + NEW_AUX_KERNELS + ZG_H3_KERNELS + ZG_SHEAR_KERNELS
                + ZG_ISO_KERNELS + ZG_ISO_H3_KERNELS + ZG_SHEAR_CHI_KERNELS
                + UPW_KERNELS + ZG_UPW_KERNELS + SD_KERNELS
                + ZG_SHOCK_KERNELS)
# the phase-3 paths on the flagship template: name -> launch suffix; " h3"
# the same set with del6 hyper-diffusion (its H3 instances)
TEMPLATE_PATHS = {"flagship": "", "forced hydro": "_hydro",
                  "entropy MHD": "_ent", "entropy hydro": "_hydro_ent"}
TEMPLATE_PATHS.update({k + " h3": v + "_h3"
                       for k, v in TEMPLATE_PATHS.items()})
# the chi-const value of the conv-slab paths with it (χ = ν, a Prandtl
# number of 1)
CHI = 4e-3
# the rotation of the sheared conv-slab paths in phase 3 (S = −1.5 Ω) and
# the amplitude of forced convection
OMEGA_SHEAR, FORCE = 0.5, 0.05
# the conv-slab paths of phase 3: label -> conv_slab keyword arguments
CONV_SLAB_PATHS = {
    "conv-slab": {}, "magnetoconvection": dict(magnetic=True),
    "conv-slab chi": dict(chi=CHI),
    "magnetoconvection chi": dict(magnetic=True, chi=CHI),
    "conv-slab h3": dict(hyper3=True),
    "magnetoconvection h3": dict(magnetic=True, hyper3=True),
    "sheared conv-slab": dict(Omega=OMEGA_SHEAR, shear=True),
    "sheared magnetoconvection": dict(magnetic=True, Omega=OMEGA_SHEAR,
                                      shear=True),
    "forced conv-slab": dict(forcing=FORCE),
    # stratified convection with lnρ, u and s upwinded: K6/K7 UPW
    "conv-slab upwind": dict(upwind=True),
    # supersonic stratified convection and magnetoconvection with shocks
    # (ν_sh = 1), the latter with chi-const, each also with the shock
    # diffusivities (a label ending in " sd": with_shock_diffusion):
    # K6k/K7k, K6mk/K7mk and their SHK instances
    "shocked conv-slab": dict(shock=True),
    "shocked conv-slab sd": dict(shock=True),
    "shocked magnetoconvection chi": dict(magnetic=True, shock=True,
                                          chi=CHI),
    "shocked magnetoconvection chi sd": dict(magnetic=True, shock=True,
                                             chi=CHI)}
# SAFI (the shear advection as a shift between substeps) on the
# z-ghosted shear builds: the sheared conv-slab on K6s/K7s
CONV_SLAB_PATHS["SAFI sheared conv-slab"] = dict(Omega=OMEGA_SHEAR,
                                                 shear=True, safi=True)
# Entropy's other conduction and cooling terms on the z-ghosted builds
# with ss: phase 2's flavour sets (conv_slab keyword arguments, a set's
# terms in one configuration), each held on the six builds' instances
# that it reaches, and the three paths at 256³ in phase 3: convection
# with the layered K(z) of 'K-profile' (K6/K7), with Kramers opacity (the
# CHI instances K6/K7 chi) and magnetoconvection with Kramers opacity,
# Newtonian cooling of T towards the top's and the 'cubic_step' cooling
# profile (K6m/K7m chi)
TAU_COOL = 2.0
HEATCOND_SETS = {
    "K-profile, tau_cool, uniform heating and cooling, step": dict(
        heatcond="K-profile", tau_cool=TAU_COOL, cooling_profile="step",
        entropy=dict(heat_uniform=1e-2, cool_uniform=2e-3)),
    "kramers clipped, step2": dict(
        heatcond="kramers", cooling_profile="step2", entropy=dict(
            zcool=0.1, chimin_kramers=6e-3, chimax_kramers=1.5e-2)),
    "chi-cspeed, K-profile, tau_cool, lin-z": dict(
        chi=CHI, chi_cspeed=0.5, heatcond="K-profile", tau_cool=TAU_COOL,
        cooling_profile="lin-z")}
ZG_SS_BUILDS = {"conv-slab": {}, "magnetoconvection": dict(magnetic=True),
                "sheared conv-slab": dict(shear=True, Omega=1.0),
                "sheared magnetoconvection": dict(magnetic=True, shear=True,
                                                  Omega=1.0),
                "shocked conv-slab": dict(shock=True),
                "shocked magnetoconvection": dict(magnetic=True,
                                                  shock=True)}
HEATCOND_PATHS = {
    "conv-slab K-profile": dict(heatcond="K-profile"),
    "conv-slab kramers": dict(heatcond="kramers"),
    "magnetoconvection kramers cooled": dict(
        magnetic=True, heatcond="kramers", tau_cool=TAU_COOL,
        cooling_profile="cubic_step")}
CONV_SLAB_PATHS.update(HEATCOND_PATHS)
# each one's counterparts, timed in turns with it in phase 4 on one
# input: K-const, and beside the CHI instances chi-const
HEATCOND_COUNTERPART = {
    "conv-slab K-profile": ("conv-slab",),
    "conv-slab kramers": ("conv-slab", "conv-slab chi"),
    "magnetoconvection kramers cooled": ("magnetoconvection",
                                         "magnetoconvection chi")}
# Viscosity's other flavours and Density's diffrho: the paths of
# configs.VISCOSITY_PATHS, each with the path of the same configuration
# with 'nu-const' whose kernels (the same instances, visx taken) it
# launches, timed beside it in phase 3 and in turns with it in phase 4
VISC_COUNTERPART = {"flagship rho-nu-const": "flagship",
                    "forced hydro aniso": "forced hydro h3",
                    "shock box bulk": "hydro shock box ent",
                    "conv-slab rho-nu-const": "conv-slab",
                    "magnetoconvection nu-therm": "magnetoconvection",
                    "shear box rho-nu-const": "shear box"}
# the bulk viscosity of phase 2's checks
VISC_ZETA = 1e-3
# Entropy's hyper-diffusion of s and its cooling: phase 2 holds every H3
# instance of the 12 builds with ss with each flavour (χ₃, the mesh χ₃ᵐ,
# the anisotropic χ₃ⱼ: configs.with_chi_hyper3's) against its plain
# version, the first flavour beside CHI3_COOLING (Newtonian cooling
# towards T = 1.2, off the inputs' T ≈ 1.5, and the uniform heating and
# cooling), and every kernel of the 8 periodic builds with ss with
# CHI3_COOLING alone; phase 3 runs two paths at 256³, each beside its
# counterpart without the terms: (a) hyper-diffusive non-isothermal
# forced MHD turbulence with χ₃ and Newtonian cooling towards the
# initial T on CHI3_COOLING's τ (K1e-K3e H3), (b) hyper-diffusive
# convection with χ₃ (K6/K7 H3)
CHI3_FLAVOURS = (True, "mesh", "aniso")
CHI3_COOLING = dict(tau_cool=1.0, TTref_cool=1.2, heat_uniform=1e-2,
                    cool_uniform=2e-3)
CHI3_COUNTERPART = {"entropy MHD h3 chi3 cooled": "entropy MHD h3",
                    "conv-slab h3 chi3": "conv-slab h3"}
CONV_SLAB_PATHS["conv-slab h3 chi3"] = dict(hyper3=True, chi_hyper3=True)
# the z-wall codes: phase 2's fills of every ported code on the card
# against the CPU at 32³ (WALL_CASES: a bcz override of conv_slab(n,
# magnetic=True) each, with its conv_slab keyword arguments and
# force_bound; the flux walls' Entropy fields in WALL_FLUX, σ_SBt from
# configs.fgs_sigma), the FFT codes ('pot' and 'c1' on A) also at 128
# rows, two steps of each layout route at 32³ (WALL_STEPS: the x/y-ghosted
# slabs, the z-only cut of g + 1 planes and of 2g + 1), and two paths at
# 256³: magnetoconvection with a vacuum exterior (ax, ay, az 'pot': the
# x/y-ghosted layout on K6ms/K7ms at S = 0) and Kramers convection with a
# black-body top over a hydrostatic density top (ss 'c1:Fgs', lnρ
# 'a2:hs': K6/K7 chi)
WALL_FLUX = dict(chi_t=2e-3, chit_prof1=0.5, chit_prof2=1.5, hcondbot=1e-3,
                 hcondtop=2e-3, Fbot=0.02, Ftop=0.01)
WALL_CASES = {
    "der": ({"ux": ("der", 0.5, -0.3)}, {}, None),
    "0, cop, e1": ({"ux": "cop", "uy": "0", "uz": "e1"}, {}, None),
    "e2, 1s": ({"ux": "e2", "uy": "1s"}, {}, None),
    "e3": ({"uz": "e3"}, {}, None),
    "s0d, d1s, n1s": ({"ux": "s0d", "uy": ("d1s", 0.01, -0.02),
                       "uz": ("n1s", 0.1, 0.2)}, {}, None),
    "v, v3, out": ({"ux": "v", "uy": "v3", "uz": "out"}, {}, None),
    "ouf, ubs": ({"uy": "ubs", "uz": "ouf"}, {}, None),
    "nil, StS, none": ({"ux": "nil", "uy": "none", "lnrho": "StS"}, {},
                       None),
    "ism": ({"lnrho": ("ism", 0.9, 0.9), "ss": ("ism", 0.5, 0.5)}, {},
            None),
    "cdz, sT": ({"lnrho": "cdz", "ss": "sT"}, {}, None),
    "c2": ({"ss": ("c2", 1.2, 0.0)}, {}, None),
    "ctz": ({"ss": "ctz"}, {}, None),
    "cT2": ({"ss": ("cT2", 0.0, 1.1)}, {}, None),
    "ce": ({"ss": "ce"}, {}, None),
    "hs": ({"lnrho": "a2:hs", "ss": "c1:hs"}, {}, None),
    "div": ({"uz": ("div", 0.1, -0.1)}, {}, None),
    "pot": ({"ax": "pot", "ay": "pot", "az": "pot"}, {}, None),
    "pwd, pfe": ({"ux": "pwd", "uy": "pfe"}, {}, None),
    "c1 on A": ({"ax": "c1", "ay": "c1", "az": "c1"}, {}, None),
    "c1 on A, nil": ({"ax": "c1", "ay": "nil", "az": "nil"}, {}, None),
    "Fgs, kramers": ({"lnrho": "a2:hs", "ss": "c1:Fgs"},
                     dict(heatcond="kramers"), None),
    "Fgs": ({"ss": "Fgs"}, {}, None),
    "Fct": ({"ss": "Fct"}, {}, None),
    "Fct, kramers": ({"ss": "Fct"}, dict(heatcond="kramers"), None),
    "g": ({"ux": "g", "ss": "g"}, {}, ("", "cT")),
}
# the cases with a torch.fft, checked again with 128 rows along x and y
WALL_FFT_CASES = ("pot", "pwd, pfe", "c1 on A", "c1 on A, nil")
WALL_PATHS = {
    "magnetoconvection vacuum": dict(magnetic=True, bcz=dict.fromkeys(
        ("ax", "ay", "az"), "pot")),
    "conv-slab kramers radiative": dict(heatcond="kramers", bcz={
        "lnrho": "a2:hs", "ss": "c1:Fgs"})}
CONV_SLAB_PATHS.update(WALL_PATHS)
# each one's parent set, run in the same call, in turns with it in phase 4
WALL_COUNTERPART = {"magnetoconvection vacuum": "magnetoconvection",
                    "conv-slab kramers radiative": "conv-slab kramers"}
# two steps on the card against the CPU at 32³ of each layout route
WALL_STEPS = dict(WALL_PATHS, **{
    "conv-slab s0d": dict(bcz={"ux": "s0d", "uy": "s0d"})})
# each shocked conv-slab path's counterpart without the slot, timed in
# turns with it in phase 4, and the phase-3 label of its launch names
ZG_SHOCK_COUNTERPART = {"shocked conv-slab": "conv-slab",
                        "shocked conv-slab sd": "conv-slab",
                        "shocked magnetoconvection chi":
                            "magnetoconvection chi",
                        "shocked magnetoconvection chi sd":
                            "magnetoconvection chi"}
# the isothermal stratified layer's paths of phase 3: label -> strat_box
# keyword arguments (the MRI box: Magnetic, Shear, g_z = −z, Ω = 1)
STRAT_PATHS = {
    "stratified MRI box": {},
    "stratified MRI box h3": dict(hyper3=True),
    "forced stratified MHD": dict(shear=False, forcing=FORCE),
    "forced stratified hydro": dict(magnetic=False, shear=False,
                                    forcing=FORCE),
    "stratified shear hydro": dict(magnetic=False),
    # the stratified shearing box with an energy equation, MHD and hydro:
    # K6ms/K7ms and K6s/K7s (their CHI instances) under g_z = −Ω²z
    "stratified MRI box ent": dict(entropy=True),
    "stratified shear hydro ent": dict(entropy=True, magnetic=False),
    # the negative-effective-magnetic-pressure box (Brandenburg et al.
    # 2011): forced isothermal stratified MHD in a horizontal imposed
    # field B0 = configs.NEMPI_B0 on K6mi/K7mi (phase 1 checks the value)
    "NEMPI box": dict(shear=False, forcing=FORCE, b_ext=(0.0, 0.01, 0.0)),
    # the stratified MRI box with SAFI: K6msi/K7msi, the shift between
    # substeps
    "SAFI stratified MRI box": dict(safi=True)}
# forced stratified turbulence in a periodic box under g_z = −sin(πz/2),
# MHD and hydro: the flagship's and forced hydro's kernels with gravity
GRAV_WRAP_PATHS = {
    "stratified periodic MHD": dict(periodic=True, shear=False,
                                    forcing=FORCE),
    "stratified periodic hydro": dict(periodic=True, shear=False,
                                      magnetic=False, forcing=FORCE)}
# each one's counterpart without gravity, timed in turns with it in
# phase 4
GRAV_COUNTERPART = {"stratified periodic MHD": "flagship",
                    "stratified periodic hydro": "forced hydro"}
# the paths of B_ext and the continuous forcing at 256³: label ->
# (configuration function, its keyword arguments); imposed-field MHD
# turbulence, the ABC-flow dynamo (force = 0: the flow is driven by the
# profile alone) and the Roberts flow on the periodic builds, the
# negative-effective-magnetic-pressure box on K6mi/K7mi
TERM_WRAP_PATHS = {
    "imposed-field MHD": ("flagship", dict(b_ext=(0.0, 0.0, 0.1))),
    "ABC-flow dynamo": ("flagship", dict(fcont=("ABC", 0.1, 1.0))),
    "Roberts flow": ("forced_hydro", dict(fcont=("RobertsFlow", 0.1, 1.0)))}
# each one's counterpart without the term, timed in turns with it in
# phase 4
TERM_COUNTERPART = {"imposed-field MHD": "flagship",
                    "ABC-flow dynamo": "flagship",
                    "Roberts flow": "forced hydro",
                    "NEMPI box": "forced stratified MHD"}
# upwinding and the shock diffusivities at 256³: forced MHD turbulence
# with lnρ and u upwinded, "flagship upwind", on K1-K3 UPW (the 8-field
# wrap build with the least register room; the conv-slab's is in
# CONV_SLAB_PATHS), and supersonic turbulence with the whole
# shock-capturing set (ν_sh, D_sh, η_sh, χ_sh): MHD with an energy
# equation on K1se/K5wse and hydro on K1sh/K5wh, labels as AUX_PATHS's
SHOCK_DIFFUSION_PATHS = {
    "shock box ent sd": ("shock_box", dict(entropy=True,
                                           shock_diffusion=True), "_ent"),
    "hydro shock box sd": ("shock_box", dict(magnetic=False,
                                             shock_diffusion=True),
                           "_hydro")}
# each one's counterpart without the option, timed in turns with it in
# phase 4
OPTION_COUNTERPART = {"shock box ent sd": "shock box ent",
                      "hydro shock box sd": "hydro shock box"}
# the sheared, rotating MHD box with SAFI, the mesh flavour of del6 on u
# and lnρ (η₃ on A) and the mean momenta removed after each step: K4/K5
# (H3), the shift between substeps; a label as AUX_PATHS's
SAFI_AUX_PATHS = {"SAFI shear box": ("shear_box", dict(
    safi=True, hyper3="mesh", remove_mean_momenta=True), "")}
# each SAFI path's counterpart without SAFI (the same instance, S in the
# advection terms; the shear box's also without the mesh flavour and the
# mean removal), timed in turns with it in phase 4
# the SAFI shift of a stratified state Fourier-transforms lnρ's O(1)
# profile along y, whose float32 roundoff the pressure gradient turns into
# velocity noise: with velocity noise of 1e-2, two transforms that round
# differently (the card's cuFFT, the CPU's pocketfft) part by 1.1e-5 to
# 2.6e-5 of u's max after 2 steps at 8×8×16 to 64³ (the full transform
# against one of the field less its y-mean, on the CPU), at the 2e-5
# bound; with noise of 1e-1 a tenth of that.  So the SAFI stratified
# paths are held to the CPU with that noise, as the conv-slab is with 1e-2
# for its own float32 floor (ROADMAP Queue 3, not faults)
SAFI_UU_NOISE = 0.1
SAFI_COUNTERPART = {"SAFI shear box": "shear box",
                    "SAFI stratified MRI box": "stratified MRI box",
                    "SAFI sheared conv-slab": "sheared conv-slab"}
# the shocked box with the Shock module's 'highorder' profile on K1s/K5w
# (aux_cfg swaps the profile in), a label as AUX_PATHS's
SHOCK_VARIANT_PATHS = {"shock box highorder": ("shock_box", {}, "")}
# B_ext and the continuous forcing on every build in phase 2: an imposed
# field along no axis, of the size of the noise's curl A, and the four
# profiles taken in turn across the builds
B_EXT = (0.03, -0.05, 0.1)
FCONT = ("ABC", "RobertsFlow", "cosx*cosy*cosz", "xz")
TERMS_LABEL = ", with fcont (B_ext in the MHD builds)"
# gravity on every build in phase 2: each profile's Gravity keyword
# arguments ('sin-z': one period over the box's z)
GRAVITY = {"const": dict(gravz=-1.0), "linear-z": dict(gravz=-1.0),
           "sin-z": dict(gravz=-1.0)}
# the four sets of the builds without ss in phase 2: label -> strat_box
# keyword arguments
ISO_SETS = {"hydro": dict(magnetic=False, shear=False),
            "MHD": dict(shear=False), "shear hydro": dict(magnetic=False),
            "MRI box": {}}
# each one's entropy counterpart, timed in turns with it in phase 4
STRAT_COUNTERPART = {"stratified MRI box": "sheared magnetoconvection",
                     "forced stratified MHD": "magnetoconvection",
                     "forced stratified hydro": "conv-slab",
                     "stratified shear hydro": "sheared conv-slab",
                     "stratified MRI box ent": "sheared magnetoconvection",
                     "stratified shear hydro ent": "sheared conv-slab"}
# launches of each kernel in one step of each phase-3 path
PER_STEP = {
    "flagship": dict.fromkeys(FLAGSHIP_KERNELS, 1),
    "flagship rk4": {"rhs_first": 1, "rhs_tail_defer": 1, "rhs_tail_mid": 2,
                     "rhs_tail_last": 1},
    "flagship rk2": {"rhs_first": 1, "rhs_tail_defer_last": 1},
    "K8 chain": dict.fromkeys(FAKE_KERNELS, 1),
    "conv-slab": {"rhs_zg": 1, "rhs_zg_upd": 2},
    "magnetoconvection": {"rhs_zg_mag": 1, "rhs_zg_upd_mag": 2},
    "conv-slab chi": {"rhs_zg_chi": 1, "rhs_zg_upd_chi": 2},
    "magnetoconvection chi": {"rhs_zg_mag_chi": 1, "rhs_zg_upd_mag_chi": 2},
    "conv-slab h3": {"rhs_zg_h3": 1, "rhs_zg_upd_h3": 2},
    "magnetoconvection h3": {"rhs_zg_mag_h3": 1, "rhs_zg_upd_mag_h3": 2},
    "sheared conv-slab": {"rhs_zg_shear": 1, "rhs_zg_upd_shear": 2},
    "sheared magnetoconvection": {"rhs_zg_mag_shear": 1,
                                  "rhs_zg_upd_mag_shear": 2},
    "forced conv-slab": {"rhs_zg": 1, "rhs_zg_upd": 2},
    "stratified MRI box": {"rhs_zg_iso_mag_shear": 1,
                           "rhs_zg_upd_iso_mag_shear": 2},
    "stratified MRI box h3": {"rhs_zg_iso_mag_shear_h3": 1,
                              "rhs_zg_upd_iso_mag_shear_h3": 2},
    "forced stratified MHD": {"rhs_zg_iso_mag": 1, "rhs_zg_upd_iso_mag": 2},
    "forced stratified hydro": {"rhs_zg_iso": 1, "rhs_zg_upd_iso": 2},
    "stratified shear hydro": {"rhs_zg_iso_shear": 1,
                               "rhs_zg_upd_iso_shear": 2},
    "stratified MRI box ent": {"rhs_zg_mag_shear_chi": 1,
                               "rhs_zg_upd_mag_shear_chi": 2},
    "stratified shear hydro ent": {"rhs_zg_shear_chi": 1,
                                   "rhs_zg_upd_shear_chi": 2},
    "stratified periodic MHD": dict.fromkeys(FLAGSHIP_KERNELS, 1),
    "stratified periodic hydro": {k + "_hydro": 1 for k in FLAGSHIP_KERNELS},
    "imposed-field MHD": dict.fromkeys(FLAGSHIP_KERNELS, 1),
    "ABC-flow dynamo": dict.fromkeys(FLAGSHIP_KERNELS, 1),
    "Roberts flow": {k + "_hydro": 1 for k in FLAGSHIP_KERNELS},
    "NEMPI box": {"rhs_zg_iso_mag": 1, "rhs_zg_upd_iso_mag": 2},
    "conv-slab K-profile": {"rhs_zg": 1, "rhs_zg_upd": 2},
    "conv-slab kramers": {"rhs_zg_chi": 1, "rhs_zg_upd_chi": 2},
    "magnetoconvection kramers cooled": {"rhs_zg_mag_chi": 1,
                                         "rhs_zg_upd_mag_chi": 2},
    # the vacuum exterior runs the MHD shear build at S = 0
    "magnetoconvection vacuum": {"rhs_zg_mag_shear": 1,
                                 "rhs_zg_upd_mag_shear": 2},
    "conv-slab kramers radiative": {"rhs_zg_chi": 1, "rhs_zg_upd_chi": 2},
}
PER_STEP.update({label: {first: 1, upd: 2}
                 for label, (first, upd) in AUX_NAMES.items()})
PER_STEP["flagship upwind"] = dict.fromkeys(UPW_KERNELS, 1)
PER_STEP["conv-slab upwind"] = {"rhs_zg_upw": 1, "rhs_zg_upd_upw": 2}
PER_STEP.update({label: {k + "_sd": n for k, n in
                         PER_STEP[OPTION_COUNTERPART[label]].items()}
                 for label in SHOCK_DIFFUSION_PATHS})
PER_STEP.update({label: {first: 1, upd: 2} for label, (first, upd) in zip(
    (k for k in CONV_SLAB_PATHS if k.startswith("shocked")),
    zip(ZG_SHOCK_KERNELS[::2], ZG_SHOCK_KERNELS[1::2]))})
PER_STEP["shock box highorder"] = PER_STEP["shock box"]
PER_STEP.update({label: PER_STEP[other]
                 for label, other in VISC_COUNTERPART.items()
                 if other in PER_STEP})
PER_STEP.update({label: PER_STEP[other]
                 for label, other in SAFI_COUNTERPART.items()})
# the other template paths launch the flagship's kernels of their builds
for _name, _sfx in TEMPLATE_PATHS.items():
    for _order in ("", " rk4", " rk2"):
        PER_STEP[_name + _order] = {
            k + _sfx: n for k, n in PER_STEP["flagship" + _order].items()}
PER_STEP["forced hydro aniso"] = PER_STEP["forced hydro h3"]
PER_STEP.update({label: PER_STEP[other]
                 for label, other in CHI3_COUNTERPART.items()})
_FR = "pencil_tpu/ops/fused_rhs.py:"
REPLACES = {
    "rhs_first": _FR + "306", "rhs_tail_defer": _FR + "379",
    "rhs_tail_last": _FR + "379",
    # the JAX step's order-4 middle substeps build `kernel_upd` with the
    # wrap fetch (pencil_tpu/model.py:690), not a `kernel_tail` variant
    "rhs_tail_mid": _FR + "331", "rhs_tail_defer_last": _FR + "379",
    "rhs_first_fake": _FR + "127", "rhs_tail_defer_fake": _FR + "127",
    "rhs_tail_last_fake": _FR + "127",
    "rhs_zroll": _FR + "306", "rhs_zroll_upd": _FR + "331",
    "rhs_wrap_shock": _FR + "306", "rhs_wrap_shock_upd": _FR + "331",
    "rhs_zg": _FR + "317", "rhs_zg_upd": _FR + "349",
    "rhs_zg_mag": _FR + "317", "rhs_zg_upd_mag": _FR + "349",
    "rhs_zg_shear": _FR + "317", "rhs_zg_upd_shear": _FR + "349",
    "rhs_zg_mag_shear": _FR + "317", "rhs_zg_upd_mag_shear": _FR + "349",
}
# the builds without ss replace the same calls, traced without Entropy
REPLACES.update({k: REPLACES[k.split("_iso")[0]]
                 for k in ZG_ISO_KERNELS + ZG_ISO_H3_KERNELS})
# the hydro build replaces the same calls, traced for the hydro set; the
# H3 and CHI instances the same calls, traced with those terms
REPLACES.update({k + sfx: REPLACES[k]
                 for k in FLAGSHIP_KERNELS + TAIL_KERNELS
                 for sfx in ("_hydro", "_ent", "_hydro_ent")})
REPLACES.update({k + "_h3": REPLACES[k] for k in KERNEL_NAMES
                 if k + "_h3" in H3_KERNELS})
REPLACES.update({k + sfx: REPLACES[k] for k in KERNEL_NAMES
                 for sfx in ("_chi", "_h3")
                 if k + sfx in CHI_KERNELS + ZG_H3_KERNELS
                 + ZG_SHEAR_CHI_KERNELS})
# the aux builds' other layouts replace the same calls, traced for theirs
REPLACES.update({k: REPLACES[base] for label in NEW_AUX_PATHS
                 for k, base in zip(AUX_NAMES[label], AUX_NAMES[
                     "shear box" if AUX_PATHS[label][0] == "shear_box"
                     else "shock box"])})
# the UPW instances replace the same calls, traced with the lupw flags
REPLACES.update({k + "_upw": REPLACES[k]
                 for k in FLAGSHIP_KERNELS + ZGHOST_KERNELS})
# the SHK instances the same calls, traced with the shock diffusivities
REPLACES.update({k: REPLACES[k[:-len("_sd")]] for k in SD_KERNELS})
# the z-ghosted builds with the shock slot replace the zghost calls,
# traced with the Shock module (and Magnetic, chi-const, the shock
# diffusivities)
REPLACES.update({k: REPLACES[k.split("_shock")[0].replace("_mag", "")]
                 for k in ZG_SHOCK_KERNELS})
# every kernel is an instance of the flagship template
SOURCES = dict.fromkeys(KERNEL_NAMES, "pencil_tpu_torch/csrc/fused_rhs.cu")

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet): device
# memory at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# Operations per grid point, counted from the kernels' source
# (csrc/fused_rhs.cu): a scaled paired first derivative is 9 (3
# differences, 3 products, 2 sums, the 1/dx), a scaled second or 6th
# difference 13, a bidiagonal mixed derivative in the JAX package's form
# 23 (12 products, 11 sums), the pointwise physics of each module as
# written, a transcendental, root or division counted as one; terms that
# this run's coefficients switch off are left out.  The flagship template
# (all its builds) joins each weighted term to its sum by one FMA, still
# two operations, so its first and second derivatives count the same, and
# a scaled 6th difference, summed as the second derivative is, 13 too; it
# sums the four taps of a diagonal offset before their one weight
# multiplies them, so its mixed derivative is 14 (9 sums and differences,
# 3 products, 2 sums).  The update per field (df
# = α·df_prev + r, f = f + βΔt·df) is 4, the rebuilt f1 = f0 + cprev·df1
# is 2.  The kick at a point is 21: cos(A+B) and sin(A+B) by angle
# addition (6), and per component P·U − Q·V, the amplitude and the sum
# (5); the sin and cos of A, B, C and the rotated amplitudes U, V are
# formed once per plane, row and thread of a block, outside its march.
D1, D2, DMIX, DMIX_FACTORED, UPD, REBUILD, KICK_OPS = 9, 13, 23, 14, 4, 2, 21
FLAGSHIP_RHS = 21 * D1 + 18 * D2 + 12 * DMIX_FACTORED + 174
# the flagship's without the magnetic terms: the derivatives of u and lnρ
# only, the pointwise density, hydro and viscosity terms (no Coriolis at
# Ω = 0); its CFL maximum has no Alfvén speed (26 → 16)
HYDRO_RHS = 12 * D1 + 9 * D2 + 6 * DMIX_FACTORED + 115
# with the entropy field and chi-const conduction (K-const off): ∇s and
# the Laplacians of lnρ and s, then pointwise the equation of state (cs²,
# 1/T), the pressure force of ∇s, S², −u·∇s, ∇lnT and the conduction term,
# the viscous heat (70), with Magnetic the Ohmic heat (9), without it 1/ρ
# (2), which the magnetic terms otherwise hold
ENT_TERMS = 3 * D1 + 6 * D2 + 70
ENT_MHD_RHS = FLAGSHIP_RHS + ENT_TERMS + 9
ENT_HYDRO_RHS = HYDRO_RHS + ENT_TERMS + 2
# the flagship's with the shock slot: ∇shock, the ν_sh force, the shock
# diffusivity in the CFL maximum
SHOCKBOX_RHS = 24 * D1 + 18 * D2 + 12 * DMIX_FACTORED + 198
# plus del6 of 7 components (21 scaled 6th differences and their sums),
# the hyper-diffusive terms, Coriolis and the shear terms
SHEARBOX_RHS = SHOCKBOX_RHS + 21 * D2 + 14 + 14 + 15 + 22
# the shock slot's share of those: ∇shock, the ν_sh force, the shock
# diffusivity; and the shear box's share of its own: del6 of n fields (3 n
# scaled 6th differences, 2 n sums, 2 n for the coefficient and the join),
# Coriolis (15), the shear terms (−S x ∂/∂y of n fields, −S u_x, with A
# −S A_y, −S x itself, |S x|/Δy in the CFL: 2 n + 6 + 2 with A)
SHOCK_TERMS = SHOCKBOX_RHS - FLAGSHIP_RHS


def shear_terms(n, magnetic):
    return 3 * n * D2 + 4 * n + 15 + 2 * n + 6 + 2 * magnetic


# the new aux layouts: the hydro shock box; the shear box without the
# shock slot, and the hydro shear box with and without it
SHOCK_HYDRO_RHS = HYDRO_RHS + SHOCK_TERMS
SHEAR_NS_RHS = FLAGSHIP_RHS + shear_terms(7, True)
SHEAR_HYDRO_NS_RHS = HYDRO_RHS + shear_terms(4, False)
SHEAR_HYDRO_RHS = SHEAR_HYDRO_NS_RHS + SHOCK_TERMS
# the hydro layouts with ss add the entropy terms and 1/ρ; with the shock
# slot the shock heat ν_sh·shock·(∇·u)² (4), with the shear −S x ∂s/∂y (2)
SHOCK_HYDRO_ENT_RHS = SHOCK_HYDRO_RHS + ENT_TERMS + 2 + 4
SHEAR_HYDRO_ENT_NS_RHS = SHEAR_HYDRO_NS_RHS + ENT_TERMS + 2 + 2
SHEAR_HYDRO_ENT_RHS = SHEAR_HYDRO_ENT_NS_RHS + SHOCK_TERMS + 4
# the MHD layouts with ss add the entropy terms and the Ohmic heat (9, as
# ENT_MHD_RHS), with the shock slot the shock heat (4), with the shear
# −S x ∂s/∂y (2)
SHOCK_ENT_RHS = SHOCKBOX_RHS + ENT_TERMS + 9 + 4
SHEAR_ENT_NS_RHS = SHEAR_NS_RHS + ENT_TERMS + 9 + 2
SHEAR_ENT_RHS = SHEAR_ENT_NS_RHS + SHOCK_TERMS + 4
# the conv-slab (the z-ghosted build): ∇u, ∇lnρ, ∇s, the Laplacians of
# u, lnρ and s, grad div u; pointwise the EOS, pressure and gravity, the
# viscous force and heat, K-const conduction and the two layers
CONVSLAB_RHS = 15 * D1 + 15 * D2 + 6 * DMIX_FACTORED + 204
# magnetoconvection adds the flagship's magnetic terms (∇A, ∇²A, grad div
# A, u×B, η∇²A, J×B/ρ) and the Ohmic heat, less the 1/ρ they share with
# the entropy terms; its CFL maximum adds the Alfvén speed (19 → 29)
MAGCONV_RHS = CONVSLAB_RHS + (FLAGSHIP_RHS - HYDRO_RHS) + 9 - 2
# del6 hyper-diffusion of one field, as the shear box counts it: three
# scaled 6th differences, their 2 sums, the coefficient's product and the
# join; the H3 instances' first kernel adds the del6 rate to the CFL's (1)
HYPER3 = 3 * D2 + 4
# chi-const beside K-const (the Laplacian of lnT and ∇lnT are K-const's):
# ∇lnT·(∇lnT + ∇lnρ) (8), the sum with ∇²lnT, cp·χ's product, the join
CHI_OPS = 11
OPS = {
    "rhs_first": FLAGSHIP_RHS + 26,
    "rhs_tail_defer": FLAGSHIP_RHS + 7 * (REBUILD + UPD),
    "rhs_tail_last": FLAGSHIP_RHS + 7 * UPD + KICK_OPS,
    "rhs_tail_mid": FLAGSHIP_RHS + 7 * UPD,
    "rhs_tail_defer_last": FLAGSHIP_RHS + 7 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_fake": 7,
    "rhs_tail_defer_fake": 7 * (REBUILD + 1 + UPD),
    "rhs_tail_last_fake": 7 * (1 + UPD) + KICK_OPS,
    "rhs_first_hydro": HYDRO_RHS + 16,
    "rhs_tail_defer_hydro": HYDRO_RHS + 4 * (REBUILD + UPD),
    "rhs_tail_last_hydro": HYDRO_RHS + 4 * UPD + KICK_OPS,
    "rhs_tail_mid_hydro": HYDRO_RHS + 4 * UPD,
    "rhs_tail_defer_last_hydro": HYDRO_RHS + 4 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_ent": ENT_MHD_RHS + 26,
    "rhs_tail_defer_ent": ENT_MHD_RHS + 8 * (REBUILD + UPD),
    "rhs_tail_last_ent": ENT_MHD_RHS + 8 * UPD + KICK_OPS,
    "rhs_tail_mid_ent": ENT_MHD_RHS + 8 * UPD,
    "rhs_tail_defer_last_ent": ENT_MHD_RHS + 8 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_hydro_ent": ENT_HYDRO_RHS + 16,
    "rhs_tail_defer_hydro_ent": ENT_HYDRO_RHS + 5 * (REBUILD + UPD),
    "rhs_tail_last_hydro_ent": ENT_HYDRO_RHS + 5 * UPD + KICK_OPS,
    "rhs_tail_mid_hydro_ent": ENT_HYDRO_RHS + 5 * UPD,
    "rhs_tail_defer_last_hydro_ent": (ENT_HYDRO_RHS + 5 * (REBUILD + UPD)
                                      + KICK_OPS),
    "rhs_zroll": SHEARBOX_RHS + 35, "rhs_zroll_upd": SHEARBOX_RHS + 7 * UPD,
    "rhs_wrap_shock": SHOCKBOX_RHS + 32,
    "rhs_wrap_shock_upd": SHOCKBOX_RHS + 7 * UPD,
    # the first kernels' CFL maximum: 26 with A, 16 without, the shock
    # diffusivity 6, the del6 rate 3
    "rhs_wrap_shock_hydro": SHOCK_HYDRO_RHS + 22,
    "rhs_wrap_shock_upd_hydro": SHOCK_HYDRO_RHS + 4 * UPD,
    "rhs_zroll_ns": SHEAR_NS_RHS + 29,
    "rhs_zroll_upd_ns": SHEAR_NS_RHS + 7 * UPD,
    "rhs_zroll_hydro": SHEAR_HYDRO_RHS + 25,
    "rhs_zroll_upd_hydro": SHEAR_HYDRO_RHS + 4 * UPD,
    "rhs_zroll_hydro_ns": SHEAR_HYDRO_NS_RHS + 19,
    "rhs_zroll_upd_hydro_ns": SHEAR_HYDRO_NS_RHS + 4 * UPD,
    # with ss: χγ among the CFL's diffusivities (2), 5 fields updated
    "rhs_wrap_shock_hydro_ent": SHOCK_HYDRO_ENT_RHS + 24,
    "rhs_wrap_shock_upd_hydro_ent": SHOCK_HYDRO_ENT_RHS + 5 * UPD,
    "rhs_zroll_hydro_ent": SHEAR_HYDRO_ENT_RHS + 27,
    "rhs_zroll_upd_hydro_ent": SHEAR_HYDRO_ENT_RHS + 5 * UPD,
    "rhs_zroll_hydro_ent_ns": SHEAR_HYDRO_ENT_NS_RHS + 21,
    "rhs_zroll_upd_hydro_ent_ns": SHEAR_HYDRO_ENT_NS_RHS + 5 * UPD,
    "rhs_wrap_shock_ent": SHOCK_ENT_RHS + 34,
    "rhs_wrap_shock_upd_ent": SHOCK_ENT_RHS + 8 * UPD,
    "rhs_zroll_ent": SHEAR_ENT_RHS + 37,
    "rhs_zroll_upd_ent": SHEAR_ENT_RHS + 8 * UPD,
    "rhs_zroll_ent_ns": SHEAR_ENT_NS_RHS + 31,
    "rhs_zroll_upd_ent_ns": SHEAR_ENT_NS_RHS + 8 * UPD,
    "rhs_zg": CONVSLAB_RHS + 19, "rhs_zg_upd": CONVSLAB_RHS + 5 * UPD,
    "rhs_zg_mag": MAGCONV_RHS + 29, "rhs_zg_upd_mag": MAGCONV_RHS + 8 * UPD,
}
# the H3 instances: del6 of u, lnρ and A (not of s), the first kernel's
# CFL +1; the CHI instances: the chi-const term
_NFIELDS = {"": 7, "_hydro": 4, "_ent": 7, "_hydro_ent": 4}
OPS.update({k + sfx + "_h3": OPS[k + sfx] + n * HYPER3
            + (k == "rhs_first")
            for sfx, n in _NFIELDS.items()
            for k in FLAGSHIP_KERNELS + TAIL_KERNELS})
OPS.update({k + "_chi": OPS[k] + CHI_OPS
            for k in ZGHOST_KERNELS + ZGHOST_MAG_KERNELS})
OPS.update({k + "_h3": OPS[k] + n * HYPER3 + (k in ("rhs_zg", "rhs_zg_mag"))
            for ks, n in ((ZGHOST_KERNELS, 4), (ZGHOST_MAG_KERNELS, 7))
            for k in ks})
# the upwinding of one field: three unscaled 6th differences (12 each: a
# scaled one less its product with 1/Δ⁶), and per axis |u_a|, its product
# with the difference and with 1/(60Δ_a), the 2 sums and the join to the
# advection (12); the UPW instances upwind lnρ and u on the flagship, lnρ,
# u and s on the conv-slab
UPWIND = 3 * (D2 - 1) + 12
OPS.update({k + "_upw": OPS[k] + 4 * UPWIND for k in FLAGSHIP_KERNELS})
OPS.update({k + "_upw": OPS[k] + 5 * UPWIND for k in ZGHOST_KERNELS})
# the shock diffusivities of the SHK instances (∇shock is formed already,
# for ν_sh): D_sh adds |∇lnρ|² and ∇shock·∇lnρ (5 each), the joins
# D_sh[shock(∇²lnρ + |∇lnρ|²) + ∇shock·∇lnρ] (5) and ∇²lnρ (three scaled
# second differences and 2 sums, 41) where no conduction block forms it
# (the isothermal builds); η_sh −(η_sh shock)J (1, and 2 per component);
# χ_sh (∇lnρ+∇lnT)·∇lnT (8), ∇shock·∇lnT (5) and the joins (5) on the
# conduction block's ∇²lnT and ∇lnT; the first kernel takes each one's
# rate into its diffusivity max (2)
SD_RHO, SD_DEL2, SD_ETA, SD_CHI, SD_RATE = 15, 3 * D2 + 2, 7, 18, 2
OPS.update({k + sfx + "_sd": OPS[k + sfx] + n * SD_RATE * first + ops
            for sfx, n, ops in (("_ent", 3, SD_RHO + SD_ETA + SD_CHI),
                                ("_hydro", 1, SD_RHO + SD_DEL2))
            for k, first in zip(SHOCK_KERNELS, (True, False))})


# the shock slot on the z-ghosted builds: ∇shock (3 scaled first
# derivatives), the ν_sh force (7 a component: shock(∇∇·u + ∇·u ∇lnρ) +
# ∇·u ∇shock, ν_sh's product, the join) and the shock heat ν_sh shock
# (∇·u)² (4); the first kernel takes ν_sh shock into its diffusivity max
# (2); the SHK instances the shock diffusivities as the aux builds with ss
# count them (D_sh, χ_sh, with A η_sh, each rate in the first kernel's
# max)
ZG_SHOCK_OPS = 3 * D1 + 21 + 4
for _k, _first in (("rhs_zg", True), ("rhs_zg_upd", False)):
    for _base, _mag in (("", False), ("_mag", True)):
        _ops = OPS[_k + _base] + ZG_SHOCK_OPS + SD_RATE * _first
        for _chi in ("", "_chi"):
            _c = _ops + (CHI_OPS if _chi else 0)
            OPS[_k + _base + "_shock" + _chi] = _c
            OPS[_k + _base + "_shock" + _chi + "_sd"] = (
                _c + SD_RHO + SD_CHI + SD_ETA * _mag
                + (2 + _mag) * SD_RATE * _first)


def zg_shear_ops(n, magnetic, first):
    """The shear terms of the z-ghosted shear builds on n fields: the node
    x and −S·x (4), −S x ∂f/∂y of each field (2 n), −S u_x on u_y (2),
    with A −S A_y on A_x (2), and in the first kernel |S x|/Δy in the
    CFL maximum (3)."""
    return 4 + 2 * n + 2 + 2 * magnetic + 3 * first


OPS.update({k + "_shear": OPS[k] + zg_shear_ops(n, n == 8, first)
            for k, n, first in (("rhs_zg", 5, True), ("rhs_zg_upd", 5, False),
                                ("rhs_zg_mag", 8, True),
                                ("rhs_zg_upd_mag", 8, False))})
OPS.update({k + "_chi": OPS[k] + CHI_OPS for k in ZG_SHEAR_KERNELS})
# the builds without ss: the periodic isothermal terms (HYDRO_RHS, or
# FLAGSHIP_RHS with A), g_z(z) on u_z (1), the CFL maximum of the periodic
# builds (16, with A 26) in the first kernel, the update of n fields in
# the other; sheared the shear terms, with del6 that of n fields and the
# del6 rate (1)
for _sfx, _rhs, _n in (("_iso", HYDRO_RHS, 4), ("_iso_mag", FLAGSHIP_RHS, 7)):
    for _shear in (False, True):
        _name = _sfx + ("_shear" if _shear else "")
        for _k, _first in (("rhs_zg", True), ("rhs_zg_upd", False)):
            _ops = _rhs + 1 + ((16 + 10 * (_n == 7)) if _first
                               else _n * UPD)
            if _shear:
                _ops += zg_shear_ops(_n, _n == 7, _first)
            OPS[_k + _name] = _ops
            if _name == "_iso_mag_shear":
                OPS[_k + _name + "_h3"] = _ops + _n * HYPER3 + _first
# the shear-box comparisons start here, where deltay = 0.555·Ly is not a
# whole number of cells (at t = 0 the shifted faces are plain wraps)
T_SHEAR = 0.37


def flagship(pt, shape, itorder=3, dt=0.0, hyper3=False):
    """configs.flagship at a 2N-RK order, with a fixed dt when ``dt`` >
    0."""
    return pt.configs.flagship(shape, itorder=itorder, dt=dt, hyper3=hyper3)


def forced_hydro(pt, shape, itorder=3, Omega=0.0, hyper3=False):
    """configs.forced_hydro at a 2N-RK order."""
    cfg = pt.configs.forced_hydro(shape, Omega=Omega, hyper3=hyper3)
    return cfg.replace(time=pt.TimeSpec(itorder=itorder))


def forced_entropy(pt, shape, magnetic=True, itorder=3, Omega=0.0,
                   entropy=None, hyper3=False):
    """configs.forced_entropy at a 2N-RK order; ``entropy`` = keyword
    arguments of another Entropy module in place of its chi-const one."""
    cfg = pt.configs.forced_entropy(shape, magnetic=magnetic, Omega=Omega,
                                    hyper3=hyper3)
    if entropy is not None:
        cfg = cfg.replace(modules=tuple(
            pt.Entropy(**entropy) if m.name == "entropy" else m
            for m in cfg.modules))
    return cfg.replace(time=pt.TimeSpec(itorder=itorder))


def template_cfg(pt, name, shape, itorder=3, Omega=0.0):
    """The configuration of the phase-3 path ``name`` (TEMPLATE_PATHS),
    with Ω about z where ``Omega`` is not 0."""
    hyper3 = name.endswith(" h3")
    base = name[:-3] if hyper3 else name
    if base == "flagship":
        cfg = flagship(pt, shape, itorder=itorder, hyper3=hyper3)
        return with_omega(pt, cfg, Omega) if Omega else cfg
    if base == "forced hydro":
        return forced_hydro(pt, shape, itorder, Omega, hyper3)
    return forced_entropy(pt, shape, base == "entropy MHD", itorder, Omega,
                          hyper3=hyper3)


def strat_cfg(pt, shape, Omega=None, **kw):
    """configs.strat_box with ``kw``, the sheared ones from t = T_SHEAR;
    ``Omega`` sets Ω: of the shear (and g_z = −Ω²z), or of Coriolis alone
    in an unsheared set."""
    sheared = kw.get("shear", True)
    if sheared and Omega is not None:
        kw = dict(kw, Omega=Omega)
    cfg = pt.configs.strat_box(shape, **kw)
    if not sheared and Omega:
        cfg = with_omega(pt, cfg, Omega)
    if sheared:
        cfg = cfg.replace(time=pt.TimeSpec(itorder=3, tstart=T_SHEAR))
    return cfg


def with_omega(pt, cfg, Omega):
    """cfg with Hydro(Omega=...) in place of its Hydro."""
    return cfg.replace(modules=tuple(
        pt.Hydro(init=m.init, ampl=m.ampl, Omega=Omega) if m.name == "hydro"
        else m for m in cfg.modules))


def with_gravity(pt, cfg, profile):
    """``cfg`` with Gravity of ``profile`` (GRAVITY) in place of its own,
    or added: g_z = −1, −z, or −sin(2πz/Lz)."""
    kw = dict(GRAVITY[profile])
    if profile == "sin-z":
        kw["kappa_z"] = 2.0 * math.pi / cfg.grid.Lz
    return cfg.replace(modules=tuple(
        m for m in cfg.modules if m.name != "gravity") + (
        pt.Gravity(gravz_profile=profile, **kw),))


def compare_gravity(torch, pt, fr, shape, errs):
    """Phase 2: every library of the template under gravity against its
    plain version, the profiles taken in turn across the chains: the four
    periodic builds (and the MHD one's H3 instances), the twelve shock and
    shear builds, the four z-ghosted builds with ss (with Ω, chi-const or
    del6 in turn, the sheared ones at Ω = 1 from t = T_SHEAR) and the four
    without ss."""
    profiles = tuple(GRAVITY)
    for i, (name, cfg) in enumerate((
            ("flagship", flagship(pt, shape)),
            ("forced hydro", forced_hydro(pt, shape)),
            ("entropy MHD", forced_entropy(pt, shape, True)),
            ("entropy hydro", forced_entropy(pt, shape, False)),
            ("flagship h3", template_cfg(pt, "flagship h3", shape)))):
        prof = profiles[i % 3]
        compare_template(torch, pt, fr, f"{name} under gravity {prof}",
                         with_gravity(pt, cfg, prof), errs, RTOL_FIELD)
    for i, label in enumerate(AUX_PATHS):
        prof = profiles[(i + 1) % 3]
        compare_aux_kernels(torch, pt, fr, f"{label} under gravity {prof}",
                            with_gravity(pt, aux_cfg(pt, label, shape),
                                         prof), errs, AUX_RTOL[label])
    extras = (dict(Omega=1.0), dict(chi=CHI), dict(hyper3=True), {})
    for i, (magnetic, shear) in enumerate(((False, False), (True, False),
                                           (False, True), (True, True))):
        for prof in ("linear-z", "sin-z"):
            kw = dict(extras[i], magnetic=magnetic)
            if shear:
                kw.update(Omega=1.0, shear=True)
            cfg = with_gravity(pt, pt.configs.conv_slab(shape, **kw), prof)
            if shear:
                cfg = cfg.replace(time=pt.TimeSpec(itorder=3,
                                                   tstart=T_SHEAR))
            compare_zg_cfg(torch, pt, fr, cfg, f"conv-slab {kw} under "
                           f"gravity {prof}", errs)
    for iso, kw in ISO_SETS.items():
        compare_zg_cfg(torch, pt, fr, with_gravity(pt, strat_cfg(
            pt, shape, **kw), "sin-z"), f"isothermal stratified {iso} "
            "under gravity sin-z", errs)


def with_terms(pt, cfg, profile):
    """``cfg`` with B_ext (B_EXT, its MHD sets) and the continuous forcing
    ``profile`` at k1_ff = 1 with its maximum at 0.1 (the 'xz' envelope
    over the box), on its Forcing module (whose kicks stay) or on a new one
    without kicks."""
    gs = cfg.grid
    ampl = 0.1 / ((gs.Lx / 2) ** 2 * (gs.Lz / 2) ** 2) if profile == "xz" \
        else 0.1
    kw = dict(lforcing_cont=True, iforcing_cont=profile, ampl_ff=ampl,
              k1_ff=1.0, fcont_box=(gs.x0, gs.x0 + gs.Lx, gs.z0,
                                    gs.z0 + gs.Lz))
    mods = tuple(dataclasses.replace(m, B_ext=B_EXT) if m.name == "magnetic"
                 else dataclasses.replace(m, **kw) if m.name == "forcing"
                 else m for m in cfg.modules)
    if cfg.module("forcing") is None:
        mods += (pt.Forcing(force=0.0, **kw),)
    return cfg.replace(modules=mods)


def compare_terms(torch, pt, fr, shape, errs, every=True):
    """Phase 2: every instance of the 24 libraries with the continuous
    forcing and, in the 12 MHD ones, B_ext against its plain version, the
    four profiles taken in turn: the periodic builds' five kernels with
    and without Ω, each also with del6; the aux builds' two with and
    without Ω and del6; the z-ghosted builds with ss with Ω, chi-const and
    del6 (the sheared ones at Ω = 1 from t = T_SHEAR), and those without
    ss with Ω and del6.  ``every=False``: the instances without Ω, del6
    and chi-const alone."""
    turn = iter(range(10 ** 6))

    def terms(cfg):
        return with_terms(pt, cfg, FCONT[next(turn) % 4])

    omegas = (0.0, 1.0) if every else (0.0,)
    flags = (False, True) if every else (False,)
    for name in TEMPLATE_PATHS:
        if name.endswith(" h3") and not every:
            continue
        for Omega in omegas:
            compare_template(torch, pt, fr,
                             f"{name}, Omega = {Omega:g}" + TERMS_LABEL,
                             terms(template_cfg(pt, name, shape,
                                                Omega=Omega)),
                             errs, RTOL_FIELD)
    for label in AUX_PATHS:
        for Omega in omegas:
            for hyper3 in flags:
                compare_aux_kernels(
                    torch, pt, fr, f"{label}, Omega = {Omega:g}"
                    + (", del6" if hyper3 else "") + TERMS_LABEL,
                    terms(aux_variant(pt, aux_cfg(pt, label, shape), Omega,
                                      hyper3)), errs, AUX_RTOL[label])
    for magnetic in (False, True):
        for shear in (False, True):
            for Omega in ((1.0,) if shear else omegas):
                for chi in ((0.0, CHI) if every else (0.0,)):
                    for hyper3 in flags:
                        kw = dict(magnetic=magnetic, Omega=Omega, chi=chi,
                                  hyper3=hyper3, shear=shear)
                        cfg = terms(pt.configs.conv_slab(shape, **kw))
                        if shear:
                            cfg = cfg.replace(time=pt.TimeSpec(
                                itorder=3, tstart=T_SHEAR))
                        compare_zg_cfg(torch, pt, fr, cfg,
                                       f"conv-slab {kw}" + TERMS_LABEL, errs)
    for iso, kw in ISO_SETS.items():
        sheared = kw.get("shear", True)
        for Omega in ((1.0,) if sheared else omegas):
            for hyper3 in flags:
                compare_zg_cfg(
                    torch, pt, fr, terms(strat_cfg(pt, shape, Omega,
                                                   hyper3=hyper3, **kw)),
                    f"isothermal stratified {iso}, Omega = {Omega:g}"
                    + (", del6" if hyper3 else "") + TERMS_LABEL,
                    errs)


def compare_upwind(torch, pt, fr, shape, errs):
    """Phase 2: every UPW instance of the 24 libraries, with lupw_lnrho,
    lupw_uu and (with ss) lupw_ss on, against its plain version: the
    periodic builds' five kernels, the aux builds' two (del6 off: no
    instance has both) and the z-ghosted builds' two, each with and
    without Ω, those with ss with and without chi-const too (the sheared
    ones at Ω = 1 from t = T_SHEAR)."""
    upwind = pt.configs.with_upwind
    for name in TEMPLATE_PATHS:
        if name.endswith(" h3"):
            continue
        for Omega in (0.0, 1.0):
            compare_template(torch, pt, fr,
                             f"{name}, Omega = {Omega:g}, upwind",
                             upwind(template_cfg(pt, name, shape,
                                                 Omega=Omega)),
                             errs, RTOL_FIELD)
    for label in AUX_PATHS:
        for Omega in (0.0, 1.0):
            compare_aux_kernels(
                torch, pt, fr, f"{label}, Omega = {Omega:g}, upwind",
                upwind(aux_variant(pt, aux_cfg(pt, label, shape), Omega,
                                   False)), errs, AUX_RTOL[label])
    for magnetic in (False, True):
        for shear in (False, True):
            for Omega in ((1.0,) if shear else (0.0, 1.0)):
                for chi in (0.0, CHI):
                    kw = dict(magnetic=magnetic, Omega=Omega, chi=chi,
                              shear=shear, upwind=True)
                    cfg = pt.configs.conv_slab(shape, **kw)
                    if shear:
                        cfg = cfg.replace(time=pt.TimeSpec(
                            itorder=3, tstart=T_SHEAR))
                    compare_zg_cfg(torch, pt, fr, cfg, f"conv-slab {kw}",
                                   errs)
    for iso, kw in ISO_SETS.items():
        for Omega in ((1.0,) if kw.get("shear", True) else (0.0, 1.0)):
            compare_zg_cfg(
                torch, pt, fr, upwind(strat_cfg(pt, shape, Omega, **kw)),
                f"isothermal stratified {iso}, Omega = {Omega:g}, upwind",
                errs)


def compare_shock_diffusion(torch, pt, fr, shape, errs):
    """Phase 2: every instance of the 8 builds with the shock slot, with
    D_sh, η_sh (MHD) and χ_sh (with ss) on (their SHK instances), against
    its plain version: with and without Ω and del6, and with the
    upwinding with and without Ω."""
    sd = pt.configs.with_shock_diffusion
    for label in AUX_PATHS:
        cfg = aux_cfg(pt, label, shape)
        if cfg.module("shock") is None:
            continue
        for Omega in (0.0, 1.0):
            for hyper3 in (False, True):
                compare_aux_kernels(
                    torch, pt, fr, f"{label}, Omega = {Omega:g}"
                    + (", del6" if hyper3 else "") + ", shock diffusion",
                    sd(aux_variant(pt, cfg, Omega, hyper3)), errs,
                    AUX_RTOL[label])
            compare_aux_kernels(
                torch, pt, fr, f"{label}, Omega = {Omega:g}, upwind, shock "
                "diffusion", pt.configs.with_upwind(sd(aux_variant(
                    pt, cfg, Omega, False))), errs, AUX_RTOL[label])


def random_fa(torch, shape, seed, device, nvar=7):
    """(nvar, *shape) noise: uu, lnrho and the fields after them (aa; ss;
    ss and aa)."""
    g = torch.Generator(device).manual_seed(seed)
    amp = torch.tensor([1e-2] * 3 + [5e-2] + [1e-2] * (nvar - 4),
                       device=device)
    return (amp[:, None, None, None] * torch.randn(
        (nvar,) + shape, generator=g, device=device)).contiguous()


def rel_err(a, b):
    """(max |a−b|, that over max |b|), per field, worst field."""
    worst = (0.0, 0.0)
    for c in range(a.shape[0]):
        d = float((a[c] - b[c]).abs().max())
        r = d / max(float(b[c].abs().max()), 1e-30)
        worst = max(worst, (d, r), key=lambda t: t[1])
    return worst


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def note_err(errs, name, d):
    """Keep the largest abs error ``d`` of kernel ``name`` against its
    plain version; ``errs`` holds every launch name (a misspelled one
    raises KeyError), None for one that no check has reached."""
    errs[name] = d if errs[name] is None else max(errs[name], d)


def compare_pairs(label, shape, pairs, errs, rtol):
    """Check each (kernel, plain) result pair; pairs: name -> list."""
    line = []
    for name, ps in pairs.items():
        for a, b in ps:
            d, r = rel_err(a, b)
            check(r <= rtol, f"{name} at {shape}: rel err {r}")
            if name in EXACT:
                check(bool((a == b).all()), f"{name} at {shape}: not exact")
            note_err(errs, name, d)
            line.append(f"{name} {r:.2e}")
    print(f"phase 2 {shape} {label}: kernel vs plain, worst field rel err: "
          + ", ".join(line), flush=True)


def compare_kernels(torch, pt, fr, shape, errs):
    """Phase 2: every kernel against its plain version on CUDA inputs."""
    dev = torch.device("cuda")
    model = pt.Model(flagship(pt, shape), device=dev)
    fa = random_fa(torch, shape, 1, dev)
    alpha, beta, _ = model.rk
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(model, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(model, fa)
    dt = 1.0 / dt1m_p
    c2 = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
    df2, f2 = fr.rhs_tail_defer(model, fa, df1_p, c2)
    df2_p, f2_p = fr.rhs_tail_defer_plain(model, fa, df1_p, c2)
    c3 = torch.stack((model._alpha[2], beta[2] * dt, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    f3k = fr.rhs_tail_last(model, f2_p, df2_p, c3, kick)
    f3k_p = fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, kick)
    f3 = fr.rhs_tail_last(model, f2_p, df2_p, c3, None)
    f3_p = fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, None)
    torch.cuda.synchronize()
    counts = {k: fr.LAUNCHES[k] for k in FLAGSHIP_KERNELS}
    check(counts == {"rhs_first": 1, "rhs_tail_defer": 1,
                     "rhs_tail_last": 2}, f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} max 1/dt rel err {dt_rel}")
    compare_pairs(f"flagship (max 1/dt rel err {dt_rel:.2e})", shape,
                  {"rhs_first": [(df1, df1_p)],
                   "rhs_tail_defer": [(df2, df2_p), (f2, f2_p)],
                   "rhs_tail_last": [(f3k, f3k_p), (f3, f3_p)]},
                  errs, RTOL_FIELD)


def compare_tail_kernels(torch, pt, fr, shape, errs):
    """Phase 2: K3′, K2L (with and without the kick) and K8's three
    variants against their plain versions on CUDA inputs."""
    dev = torch.device("cuda")
    model = pt.Model(flagship(pt, shape), device=dev)
    fa = random_fa(torch, shape, 1, dev)
    df1, dt1m = fr.rhs_first_plain(model, fa)
    _, beta, _ = model.rk
    dt = 1.0 / dt1m
    coef = torch.stack((model._alpha[2], beta[2] * dt, beta[1] * dt))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    fr.reset_launches()
    pairs = {
        "rhs_tail_mid": [
            (a, b) for a, b in zip(fr.rhs_tail_mid(model, fa, df1.clone(),
                                                   coef),
                                   fr.rhs_tail_mid_plain(model, fa,
                                                         df1.clone(), coef))],
        "rhs_tail_defer_last": [
            (fr.rhs_tail_defer_last(model, fa, df1, coef, k),
             fr.rhs_tail_defer_last_plain(model, fa, df1, coef, k))
            for k in (kick, None)],
        "rhs_first_fake": [(fr.rhs_first(model, fa, fake=True)[0],
                            fr.rhs_first_plain(model, fa, fake=True)[0])],
        "rhs_tail_defer_fake": list(zip(
            fr.rhs_tail_defer(model, fa, df1, coef, fake=True),
            fr.rhs_tail_defer_plain(model, fa, df1, coef, fake=True))),
        "rhs_tail_last_fake": [
            (fr.rhs_tail_last(model, fa, df1, coef, kick, fake=True),
             fr.rhs_tail_last_plain(model, fa, df1, coef, kick, fake=True))],
    }
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    check(counts == {"rhs_tail_mid": 1, "rhs_tail_defer_last": 2,
                     "rhs_first_fake": 1, "rhs_tail_defer_fake": 1,
                     "rhs_tail_last_fake": 1}, f"launch counts {counts}")
    compare_pairs("tail kernels and K8", shape, pairs, errs, RTOL_NEW)


def compare_template(torch, pt, fr, label, cfg, errs, rtol=RTOL_NEW):
    """Phase 2: the five instances of the flagship template that ``cfg``'s
    field layout selects (K1, K2, K3 with and without the kick, K3′, K2L
    with and without; or their hydro or entropy builds) against their
    plain versions on CUDA inputs, each field within ``rtol`` × its max."""
    dev = torch.device("cuda")
    model = pt.Model(cfg, device=dev)
    shape = cfg.grid.shape
    sfx = fr.launch_suffix(model)
    fa = random_fa(torch, shape, 1, dev, model.reg.nvar)
    alpha, beta, _ = model.rk
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(model, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(model, fa)
    dt = 1.0 / dt1m_p
    c2 = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
    c3 = torch.stack((model._alpha[2], beta[2] * dt, beta[1] * dt))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    df2_p, f2_p = fr.rhs_tail_defer_plain(model, fa, df1_p, c2)
    pairs = {
        "rhs_first": [(df1, df1_p)],
        "rhs_tail_defer": list(zip(fr.rhs_tail_defer(model, fa, df1_p, c2),
                                   (df2_p, f2_p))),
        "rhs_tail_last": [
            (fr.rhs_tail_last(model, f2_p, df2_p, c3, k),
             fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, k))
            for k in (kick, None)],
        "rhs_tail_mid": list(zip(
            fr.rhs_tail_mid(model, f2_p, df2_p.clone(), c3),
            fr.rhs_tail_mid_plain(model, f2_p, df2_p.clone(), c3))),
        "rhs_tail_defer_last": [
            (fr.rhs_tail_defer_last(model, fa, df1_p, c3, k),
             fr.rhs_tail_defer_last_plain(model, fa, df1_p, c3, k))
            for k in (kick, None)],
    }
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    want = {k + sfx: n for k, n in (("rhs_first", 1), ("rhs_tail_defer", 1),
                                    ("rhs_tail_last", 2), ("rhs_tail_mid", 1),
                                    ("rhs_tail_defer_last", 2))}
    check(counts == want, f"{label} launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} {shape} max 1/dt rel err {dt_rel}")
    compare_pairs(f"{label} (max 1/dt rel err {dt_rel:.2e})", shape,
                  {k + sfx: v for k, v in pairs.items()}, errs, rtol)


def compare_hyper3(torch, pt, fr, shape, errs):
    """Phase 2: the H3 instances of the four periodic builds (each kernel
    kind, with and without the kick) against their plain versions on CUDA
    inputs, without and with Ω = 1 (their Coriolis H3 instances), each
    field within 2e-5 × its max."""
    for name in TEMPLATE_PATHS:
        if not name.endswith(" h3"):
            continue
        for Omega in (0.0, 1.0):
            label = name + (f", Omega = {Omega:g}" if Omega else "")
            compare_template(torch, pt, fr, label,
                             template_cfg(pt, name, shape, Omega=Omega),
                             errs, RTOL_FIELD)


def with_safi(cfg):
    """``cfg`` with its Shear's advection as a shift between substeps
    (SAFI): the shear builds' kernels with the shear flow's nodes at 0."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, lshearadvection_as_shift=True)
        if m.name == "shear" else m for m in cfg.modules))


def with_mesh(cfg):
    """``cfg`` with the mesh flavour of del6 in place of the 'simplified'
    one on u and lnρ ('hyper3-mesh', diffrho_hyper3_mesh at
    configs.MESH_HYPER3; η₃ stays on A): the same H3 instances with the
    mesh weights dline_1/60 and the mesh rate in the CFL."""
    import pencil_tpu_torch.configs as configs
    c = configs.MESH_HYPER3
    new = {"viscosity": lambda m: dict(
               ivisc=tuple(v for v in m.ivisc if v != "hyper3-simplified")
               + ("hyper3-mesh",), nu_hyper3=0.0, nu_hyper3_mesh=c),
           "density": lambda m: dict(diffrho_hyper3=0.0,
                                     diffrho_hyper3_mesh=c)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name](m)) if m.name in new else m
        for m in cfg.modules))


def compare_shifts(torch, pt, ny):
    """Phase 2: the shear-periodic x faces' Fourier shift (on a view of a
    ghosted stack) and the SAFI shift at ``ny`` rows on the card against
    the CPU, within 1e-6 of each field's max (cuFFT's C2R once read the
    imaginary part of the Nyquist bin from 128 rows up)."""
    from pencil_tpu_torch.core.grid import make_grid
    from pencil_tpu_torch.physics.shear import fourier_shift_y
    g = torch.Generator().manual_seed(ny)
    slab = torch.randn((8, 14, ny + 6, 16), generator=g)[..., 0:3,
                                                          3:3 + ny, :]
    gs = pt.GridSpec(nx=8, ny=ny, nz=16, x0=-0.5, y0=-0.5, z0=-0.5,
                     Lx=1.0, Ly=1.0, Lz=1.0)
    shear = pt.Shear(lshearadvection_as_shift=True)
    a = torch.randn((7, 8, ny, 16), generator=g)
    worst = 0.0
    for what, fn in (
            ("x faces", lambda dev: fourier_shift_y(
                slab.to(dev), torch.tensor(0.555, device=dev), 1.0)),
            ("SAFI", lambda dev: shear.shift_advection(
                a.to(dev), make_grid(gs, dev), 1.0,
                torch.tensor(3e-3, device=dev)))):
        r = rel_err(fn(torch.device("cuda")).cpu(), fn(torch.device("cpu")))
        check(r[1] <= RTOL_NEW, f"{ny} rows, {what} shift rel err {r[1]}")
        worst = max(worst, r[1])
    print(f"phase 2 the Fourier shifts at {ny} rows: card vs CPU, worst "
          f"field rel err {worst:.2e}", flush=True)


def compare_safi_mesh(torch, pt, fr, shape, errs):
    """Phase 2: each shear build's two kernels with SAFI (the shear flow's
    nodes at 0: the twelve shear builds, their instances without and with
    del6, the latter in its mesh flavour) and every H3 instance with the
    mesh weights (the twelve aux builds, the eight z-ghosted builds with
    H3, the four periodic builds' five kernels) against their plain
    versions on CUDA inputs, each field within 2e-5 × its max."""
    for label, (make, _, _) in AUX_PATHS.items():
        cfg = aux_cfg(pt, label, shape)
        mesh = with_mesh(aux_variant(pt, cfg, 1.0, True))
        if make == "shear_box":
            compare_aux_kernels(torch, pt, fr, f"{label}, SAFI",
                                with_safi(cfg), errs, RTOL_FIELD)
            mesh = with_safi(mesh)
        compare_aux_kernels(torch, pt, fr, f"{label}, Omega = 1, mesh del6"
                            + (", SAFI" if make == "shear_box" else ""),
                            mesh, errs, RTOL_FIELD)
    for magnetic in (False, True):
        for shear in (False, True):
            cfg = pt.configs.conv_slab(shape, magnetic=magnetic,
                                       Omega=1.0, shear=shear)
            label = ("sheared " if shear else "") + (
                "magnetoconvection" if magnetic else "conv-slab")
            mesh = with_mesh(pt.configs.conv_slab(
                shape, magnetic=magnetic, Omega=1.0, shear=shear,
                hyper3=True))
            if shear:
                compare_zg_cfg(torch, pt, fr, with_safi(cfg),
                               f"{label}, SAFI", errs)
                mesh = with_safi(mesh)
            compare_zg_cfg(torch, pt, fr, mesh, f"{label}, mesh del6"
                           + (", SAFI" if shear else ""), errs)
    for iso, kw in ISO_SETS.items():
        sheared = kw.get("shear", True)
        cfg = strat_cfg(pt, shape, 1.0, **kw)
        if sheared:
            compare_zg_cfg(torch, pt, fr, with_safi(cfg),
                           f"isothermal stratified {iso}, SAFI", errs)
        mesh = with_mesh(strat_cfg(pt, shape, 1.0, hyper3=True, **kw))
        compare_zg_cfg(torch, pt, fr, with_safi(mesh) if sheared else mesh,
                       f"isothermal stratified {iso}, mesh del6"
                       + (", SAFI" if sheared else ""), errs)
    for name in TEMPLATE_PATHS:
        if name.endswith(" h3"):
            compare_template(torch, pt, fr, f"{name} mesh", with_mesh(
                template_cfg(pt, name, shape)), errs, RTOL_FIELD)


def shocked_fa(torch, pm, seed):
    """(nf, nx, ny, nz) on the card: a noisy shock-box state of the
    model's layout at urms ≈ 1 (lnρ 5e-2, s and A 1e-2) with its shock
    slot built by the pre-pass, so the shock term is live."""
    g = torch.Generator("cuda").manual_seed(seed)
    amp = torch.tensor([3 ** -0.5 if c[0] == "u" else 5e-2 if c == "lnrho"
                        else 0.0 if c == "shock" else 1e-2
                        for c in pm.reg.comp_names], device="cuda")
    fa = amp[:, None, None, None] * torch.randn(
        (pm.reg.nf,) + pm.cfg.grid.shape, generator=g, device="cuda")
    return pm._refresh_aux_fa(fa)


def aux_cfg(pt, label, shape):
    """The configuration of the aux path ``label`` (AUX_PATHS,
    SHOCK_DIFFUSION_PATHS or SHOCK_VARIANT_PATHS)."""
    import dataclasses
    if label in VISC_COUNTERPART:
        return pt.configs.viscosity_path(label, shape)
    make, kw, _ = (AUX_PATHS.get(label) or SHOCK_DIFFUSION_PATHS.get(label)
                   or SAFI_AUX_PATHS.get(label)
                   or SHOCK_VARIANT_PATHS[label])
    cfg = getattr(pt.configs, make)(shape, **kw)
    if label not in SHOCK_VARIANT_PATHS:
        return cfg
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, variant="highorder") if m.name == "shock"
        else m for m in cfg.modules))


def conv_slab_cfg(pt, label, shape):
    """The configuration of the conv-slab path ``label``
    (CONV_SLAB_PATHS), with the shock diffusivities where it ends in
    " sd"; or a path of VISC_COUNTERPART."""
    if label in VISC_COUNTERPART:
        return pt.configs.viscosity_path(label, shape)
    kw = CONV_SLAB_PATHS[label]
    if "Fgs" in str(kw.get("bcz")):
        # a black-body top that lets out the bottom's flux at the start
        kw = dict(kw, entropy=dict(sigmaSBt=pt.configs.fgs_sigma()))
    cfg = pt.configs.conv_slab(shape, **kw)
    return (pt.configs.with_shock_diffusion(cfg) if label.endswith(" sd")
            else cfg)


def wall_cfg(pt, name, shape):
    """The configuration of the z-wall case ``name`` (WALL_CASES):
    magnetoconvection with the case's bcz codes, keyword arguments and
    force_bound, and the flux walls' Entropy fields."""
    over, kw, force = WALL_CASES[name]
    cfg = pt.configs.conv_slab(shape, magnetic=True, bcz=over, **kw,
                               entropy=dict(WALL_FLUX, sigmaSBt=(
                                   pt.configs.fgs_sigma())))
    return cfg if force is None else cfg.replace(force_bound=force)


def compare_walls(torch, pt, shape, names):
    """Phase 2: the z fills of the cases ``names`` of WALL_CASES on the
    card against the CPU, on one stack made on the CPU (the initial lnρ
    and s with noise of 1e-2, noise of 1e-2 in u and A; uz offset to 0.5
    for 'e3', whose power law needs a positive field): the 3-axis fill,
    the chain's (``Model.zg_input`` and the kernels' ghosting of its
    layout) and the boundary planes that ``bc_writeback`` pins, each
    component within 1e-6 of its max."""
    from pencil_tpu_torch.parallel.halo import (
        ghosted_from_sheared_z_slabs, ghosted_from_z_slabs)
    cpu = torch.device("cpu")
    worst = {}
    for name in names:
        cfg = wall_cfg(pt, name, shape)
        models = {dev: pt.Model(cfg, device=dev) for dev in ("cuda", "cpu")}
        init = models["cpu"].init_state(0)["fields"]
        g = torch.Generator(cpu).manual_seed(7)

        def noise(n):
            return 1e-2 * torch.randn((n,) + shape, generator=g)

        fa = torch.cat([noise(3), init["lnrho"] + noise(1),
                        init["ss"] + noise(1), noise(3)])
        if name == "e3":
            fa[2] += 0.5
        out = {}
        for dev, m in models.items():
            x = fa.to(dev)
            body, zlo, zhi = m.zg_input(x.clone())
            chain = (ghosted_from_sheared_z_slabs if m.zg_xy
                     else ghosted_from_z_slabs)(body, zlo, zhi)
            out[dev] = [t.cpu() for t in (m.ghosted(x), chain,
                                          m.bc_writeback(x.clone()))]
        err = 0.0
        for a, b in zip(out["cuda"], out["cpu"]):
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite fill")
            for c in range(b.shape[0]):
                r = float((a[c] - b[c]).abs().max()) / max(
                    float(b[c].abs().max()), 1e-30)
                err = max(err, r)
        check(err <= RTOL_NEW, f"{shape} z-wall {name}: card against the "
              f"CPU rel err {err}")
        worst[name] = err
    print(f"phase 2 {shape} z-wall fills on the card against the CPU, "
          f"worst component rel err: " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()), flush=True)


def aux_variant(pt, cfg, Omega, hyper3):
    """``cfg`` with Ω about z and with or without del6 hyper-diffusion at
    ν₃ = η₃ = D₃ = 5e-3·dx⁵: the instance (ROT, H3) that its build
    launches."""
    import dataclasses
    h3 = 5e-3 * cfg.grid.dx ** 5 if hyper3 else 0.0
    ivisc = tuple(v for v in cfg.module("viscosity").ivisc
                  if v != "hyper3-simplified") + (
        ("hyper3-simplified",) if hyper3 else ())
    new = {"hydro": dict(Omega=Omega), "density": dict(diffrho_hyper3=h3),
           "magnetic": dict(eta_hyper3=h3),
           "viscosity": dict(ivisc=ivisc, nu_hyper3=h3)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name]) if m.name in new else m
        for m in cfg.modules))


def aux_input(torch, pm, seed):
    """The first kernel's input of an aux path on the card: the shear
    boxes' x/y-ghosted stack (sheared_fg), the shocked boxes' state
    (shocked_fa)."""
    return (sheared_fg if pm.mode == "zroll" else shocked_fa)(torch, pm, seed)


def compare_aux_kernels(torch, pt, fr, label, cfg, errs, rtol):
    """Phase 2: the first and update kernel of an aux path's build (K4/K5,
    K1s/K5w and their other layouts' K4n/K5n, K4h/K5h, K4hn/K5hn,
    K1sh/K5wh) against their plain versions on CUDA inputs."""
    pm = pt.Model(cfg, device="cuda")
    zroll = pm.mode == "zroll"
    first, upd = ((fr.rhs_zroll, fr.rhs_zroll_upd) if zroll
                  else (fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd))
    first_p, upd_p = ((fr.rhs_zroll_plain, fr.rhs_zroll_upd_plain) if zroll
                      else (fr.rhs_wrap_shock_plain,
                            fr.rhs_wrap_shock_upd_plain))
    names = fr.aux_kernels(pm)
    shape = cfg.grid.shape
    fg = aux_input(torch, pm, 1)
    nvar = pm.reg.nvar
    if pm.reg.nf > nvar:
        check(float(fg[nvar].max()) > 0.0, "shock slot not positive")
    fr.reset_launches()
    df, dt1m = first(pm, fg)
    df_p, dt1m_p = first_p(pm, fg)
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    fg2 = aux_input(torch, pm, 2)
    df2, f2 = upd(pm, fg2, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    check(counts == dict.fromkeys(names, 1), f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} {names[0]} max 1/dt rel err {dt_rel}")
    compare_pairs(f"{label} (max 1/dt rel err {dt_rel:.2e})", shape,
                  {names[0]: [(df, df_p)],
                   names[1]: [(df2, df2_p), (f2, f2_p)]},
                  errs, rtol)


def stratified_fa(torch, pm, seed):
    """(5, nx, ny, nz) on the card, or (8, ...) with Magnetic: the
    piecew-poly lnρ and s with noise, noisy velocities and a noisy vector
    potential; without ss (the isothermal stratified layer, 4 or 7) the
    hydrostatic lnρ with noise; with the shock slot a positive profile of
    1e-3 last (ν_sh·shock of the size of ν), which the kernels only
    read."""
    g = torch.Generator("cuda").manual_seed(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape

    def noise(sh):
        return 1e-2 * torch.randn(sh, generator=g, device="cuda")

    parts = [noise((3,) + shape), (f["lnrho"] + noise(shape))[None]]
    if "ss" in pm.reg.slots:
        parts.append((f["ss"] + noise(shape))[None])
    if "aa" in pm.reg.slots:
        parts.append(noise((3,) + shape))
    if "shock" in pm.reg.slots:
        parts.append(1e-3 * torch.rand((1,) + shape, generator=g,
                                       device="cuda"))
    return torch.cat(parts).contiguous()


def zg_input(torch, pm, seed):
    """A z-ghosted kernel's input on the card from stratified_fa
    (``Model.zg_input``): with Shear the x/y-ghosted stack with the x
    faces shifted by deltay at t = T_SHEAR, and its z slabs."""
    sdy = (pm.deltay(torch.full((), T_SHEAR, device="cuda"))
           if pm.shear is not None else None)
    return pm.zg_input(stratified_fa(torch, pm, seed), sdy)


def compare_zghost_kernels(torch, pt, fr, shape, errs, magnetic=False,
                           Omega=0.0, chi=0.0, hyper3=False, shear=False):
    """Phase 2: K6 and K7 (K6m and K7m with ``magnetic``; their Coriolis
    instances with ``Omega``, their CHI instances with ``chi``, their H3
    instances with ``hyper3``; K6s/K7s or K6ms/K7ms with ``shear``)
    against their plain versions on CUDA inputs: the interior stack (with
    Shear ghosted in x and y, the faces shifted), its boundary planes
    pinned, and its z-halo slabs."""
    label = ("sheared " if shear else "") + (
        "magnetoconvection" if magnetic else "conv-slab") + (
        f", chi = {chi:g}" if chi else "") + (", del6" if hyper3 else "") + (
        f", Omega = {Omega:g}" if Omega else "")
    compare_zg_cfg(torch, pt, fr, pt.configs.conv_slab(
        shape, magnetic=magnetic, Omega=Omega, chi=chi, hyper3=hyper3,
        shear=shear), label, errs)


def compare_zg_cfg(torch, pt, fr, cfg, label, errs):
    """Phase 2: the first and update kernel of ``cfg``'s z-ghosted build
    and instance against their plain versions (``compare_zghost_kernels``;
    the isothermal stratified layer's with ``strat_cfg``)."""
    shape = cfg.grid.shape
    pm = pt.Model(cfg, device="cuda")
    first, upd = fr.zg_kernels(pm)
    first_p, upd_p = fr.zg_plain(pm)
    inp = zg_input(torch, pm, 1)
    fr.reset_launches()
    df, dt1m = fr.rhs_zg(pm, *inp)
    df_p, dt1m_p = first_p(pm, *inp)
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    inp2 = zg_input(torch, pm, 2)
    df2, f2 = fr.rhs_zg_upd(pm, *inp2, df_p.clone(), coef)
    df2_p, f2_p = upd_p(pm, *inp2, df_p.clone(), coef)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    check(counts == {first: 1, upd: 1}, f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} {label} {first} max 1/dt rel err "
          f"{dt_rel}")
    compare_pairs(f"{label} (max 1/dt rel err {dt_rel:.2e})", shape,
                  {first: [(df, df_p)], upd: [(df2, df2_p), (f2, f2_p)]},
                  errs, RTOL_FIELD)


def with_visc(pt, cfg):
    """``cfg`` with every flavour of Viscosity that its build takes beside
    its own (visx taken): 'nu-simplified', 'rho-nu-const' and the bulk
    ζ = VISC_ZETA in every build, 'shock-simple' with the shock slot,
    'nu-cspeed' on the z-walled builds with ss, and diffrho = ν."""
    visc = cfg.module("viscosity")
    add = ("nu-simplified", "rho-nu-const", "rho-nu-const-bulk")
    if cfg.module("shock") is not None:
        add += ("shock-simple",)
    if cfg.module("entropy") is not None and not all(cfg.grid.periodic):
        add += ("nu-cspeed",)
    return pt.configs.with_viscosity(cfg, tuple(visc.ivisc) + add,
                                     zeta=VISC_ZETA, diffrho=visc.nu)


def with_aniso(pt, cfg):
    """``cfg`` (with 'hyper3-simplified' at ν₃) with
    'hyper3_nu-const_aniso' at ν₃ⱼ = (ν₃, ν₃, ν₃/2) in its place, then
    every flavour of ``with_visc``."""
    visc = cfg.module("viscosity")
    h3 = visc.nu_hyper3
    cfg = pt.configs.with_viscosity(
        cfg, tuple(v for v in visc.ivisc if v != "hyper3-simplified")
        + ("hyper3_nu-const_aniso",), nu_aniso_hyper3=(h3, h3, h3 / 2))
    return with_visc(pt, cfg)


def with_hydro_omega(cfg, Omega):
    """``cfg`` with its Hydro's Ω set (the ROT instances)."""
    import dataclasses
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, Omega=Omega) if m.name == "hydro" else m
        for m in cfg.modules))


def compare_visc(torch, pt, fr, shape, errs):
    """Phase 2: every build's instances with Viscosity's other flavours
    and diffrho (visx taken) against their plain versions, at each build's
    bound of phase 2: the periodic builds' base, ROT and UPW instances and
    their H3 ones with the anisotropic del6; the aux builds' base, UPW and
    (with the slot) SHK instances and their H3 ones with the anisotropic
    del6; the z-ghosted builds' base and UPW instances, CHI (with ss), H3
    with the anisotropic del6 (without the slot) and SHK (with it)."""
    wpu = pt.configs.with_upwind
    wsd = pt.configs.with_shock_diffusion

    def refused(label, c):
        # the instances built without the terms (they would spill)
        why = pt.model.gate_reason(c)
        if why is not None:
            print(f"phase 2 {shape} {label}: refused on the card ({why})",
                  flush=True)
        return why is not None

    for name in TEMPLATE_PATHS:
        rtol = RTOL_FIELD if name.startswith("entropy") else RTOL_NEW
        cfg = template_cfg(pt, name, shape)
        if name.endswith(" h3"):
            compare_template(torch, pt, fr, f"{name}, aniso del6 and visx",
                             with_aniso(pt, cfg), errs, RTOL_FIELD)
            continue
        for what, c in (("visx", cfg),
                        ("visx, Omega = 1", with_hydro_omega(cfg, 1.0)),
                        ("visx, upwind", wpu(cfg))):
            label = f"{name}, {what}"
            if not refused(label, with_visc(pt, c)):
                compare_template(torch, pt, fr, label, with_visc(pt, c),
                                 errs, rtol)
    for label in AUX_PATHS:
        base = aux_cfg(pt, label, shape)
        Omega = base.module("hydro").Omega
        cfg = aux_variant(pt, base, Omega, False)
        variants = {"visx": cfg, "visx, upwind": wpu(cfg),
                    "aniso del6 and visx": aux_variant(pt, base, Omega,
                                                       True)}
        if cfg.module("shock") is not None:
            variants["visx, shock diffusion"] = wsd(cfg)
        for what, c in variants.items():
            c = with_aniso(pt, c) if what.startswith("aniso") \
                else with_visc(pt, c)
            if not refused(f"{label}, {what}", c):
                compare_aux_kernels(torch, pt, fr, f"{label}, {what}", c,
                                    errs, AUX_RTOL[label])
    for build, bkw in ZG_SS_BUILDS.items():
        shock = "shock" in bkw
        variants = {"visx": {}, "visx, upwind": dict(upwind=True),
                    "visx, chi-const": dict(chi=CHI)}
        if shock:
            variants["visx, shock diffusion"] = {}
        else:
            variants["aniso del6 and visx"] = dict(hyper3=True)
        for what, kw in variants.items():
            c = pt.configs.conv_slab(shape, **bkw, **kw)
            c = wsd(c) if what.endswith("diffusion") else c
            c = with_aniso(pt, c) if what.startswith("aniso") \
                else with_visc(pt, c)
            compare_zg_cfg(torch, pt, fr, c, f"{build}, {what}", errs)
    for iso, kw in ISO_SETS.items():
        Omega = 1.0 if kw.get("shear", True) else 0.0
        for what, h3 in (("visx", False), ("aniso del6 and visx", True)):
            c = strat_cfg(pt, shape, Omega, hyper3=h3, **kw)
            c = with_aniso(pt, c) if h3 else with_visc(pt, c)
            compare_zg_cfg(torch, pt, fr, c,
                           f"isothermal stratified {iso}, {what}", errs)
        compare_zg_cfg(torch, pt, fr, with_visc(pt, pt.configs.with_upwind(
            strat_cfg(pt, shape, Omega, **kw))),
            f"isothermal stratified {iso}, visx, upwind", errs)


def visc_rate(torch, model, fa):
    """The largest diffusive CFL rate of Viscosity's other flavours and
    diffrho on the state ``fa``: ν of 'nu-simplified', D, and at each
    point ν/ρ, ζ/ρ and 'nu-cspeed''s μ_T = ν T^c; 0 without them."""
    visc, den, eos = (model.cfg.module("viscosity"),
                      model.cfg.module("density"), model.eos)
    vt = visc.terms()
    lnrho = fa[model.reg.slice("lnrho")][0]
    r1 = float(torch.exp(-lnrho).max())
    rates = [vt["nu-simplified"], den.diffrho, vt["rho-nu-const"] * r1,
             vt["rho-nu-const-bulk"] * r1]
    if vt["nu-cspeed"] > 0.0:
        lnTT = (eos.lnTT0 + eos.gamma / eos.cp * fa[model.reg.slice("ss")][0]
                + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
        rates.append(vt["nu-cspeed"] * float(
            torch.exp(visc.nu_cspeed * lnTT).max()))
    return max(rates)


def run_visc_paths(torch, pt, fr, smi, shape, launches, base):
    """Phase 3: each path of VISC_COUNTERPART at 256³, through the runner
    of its chain, its ms/step printed beside that of its counterpart with
    'nu-const' (``base``: label -> that path's result, of this call); and
    two steps of each on the card against the CPU at 64³.  Returns label
    -> the path's result."""
    out = {}
    for label, other in VISC_COUNTERPART.items():
        cfg = pt.configs.viscosity_path(label, shape)
        mode = pt.model.fused_mode(cfg)[0]
        if mode == "wrap":
            out[label] = run_flagship(torch, pt, fr, smi, shape, launches,
                                      name=label, cfg=cfg)
            ms, ms0 = out[label][2], base[other][2]
        elif mode == "zghost":
            out[label] = run_conv_slab(torch, pt, fr, smi, shape, launches,
                                       label, nwin=VARIANT_WINDOWS)
            ms, ms0 = out[label][2], base[other][2]
        else:
            out[label] = run_aux_box(torch, pt, fr, smi, shape, launches,
                                     label)
            ms, ms0 = out[label][3], base[other][3]
        print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms:.4f} ms/step, "
              f"{other} (nu-const) {ms0:.4f} ms/step in this call "
              f"({(ms / ms0 - 1) * 100:+.2f} %)", flush=True)
    n64 = (N_MAIN // 4,) * 3
    for label in VISC_COUNTERPART:
        cfg = pt.configs.viscosity_path(label, n64)
        if label.startswith("shear"):
            compare_steps(torch, pt, label, cfg, t0=T_SHEAR, phase="3")
        else:
            compare_steps(torch, pt, label, cfg, phase="3", uu_noise=(
                0.1 if label.startswith("shock") else 1e-2
                if "conv" in label or "magneto" in label else 0.0))
    return out


def time_visc_turns(torch, fr, smi, label, path, other, opath):
    """Phase 4: the kernels of the path ``label`` timed in turns (A, B, B,
    A, 20 launches a turn) with those of its counterpart with 'nu-const'
    ``other``, each on its own path's final state at 256³ (phase 2 and
    phase 3's steps check them against their plain versions)."""
    if label.startswith(("flagship", "forced")):
        time_term_turns(torch, fr, smi, label, path, other, opath)
        return
    if path[0] == label:        # run_aux_box's (label, model, state, ms)
        calls, variants = {}, {}
        for lab, model, state, _ in (path, opath):
            first, upd, _, _, fg, df1, coef = aux_kernel_inputs(
                torch, fr, model, state)
            variants[lab] = model
            calls[id(model)] = (lambda m, k=first, g=fg: k(m, g),
                                lambda m, k=upd, g=fg, d=df1, c=coef:
                                k(m, g, d, c))
        times = in_turns(torch, variants, {
            "first": lambda m: calls[id(m)][0](m),
            "update": lambda m: calls[id(m)][1](m)})
        print_turns(f"phase 4 {label} against {other} at 256^3 on {smi}",
                    times)
        return
    time_zg_turns(torch, fr, smi, path, opath)


def with_cooling(pt, cfg):
    """``cfg`` with the Entropy fields of CHI3_COOLING."""
    return pt.configs.with_module(cfg, "entropy", **CHI3_COOLING)


def chi3_path_cfg(pt, label, shape):
    """The configuration of the path ``label`` of CHI3_COUNTERPART or of
    its counterpart: (a) forced_entropy with del6, χ₃ and Newtonian
    cooling, (b) conv_slab with del6 and χ₃ (CONV_SLAB_PATHS)."""
    if label == "entropy MHD h3 chi3 cooled":
        return pt.configs.forced_entropy(shape, hyper3=True, chi_hyper3=True,
                                         tau_cool=CHI3_COOLING["tau_cool"])
    if label in TEMPLATE_PATHS:
        return template_cfg(pt, label, shape)
    return conv_slab_cfg(pt, label, shape)


def compare_chi3(torch, pt, fr, shape, errs):
    """Phase 2: every H3 instance of the 12 builds with ss with each
    flavour of Entropy's hyper-diffusion of s against its plain version,
    the first flavour beside the cooling terms (the periodic builds' five
    kernels with and without the kick, the aux builds' first and update
    kernel, the z-ghosted builds' K6/K7 and their CHI H3 instances), and
    every kernel of the 8 periodic builds with ss with the cooling terms
    alone (their base instances), at each build's bound of phase 2."""
    wc = pt.configs.with_chi_hyper3

    def flavoured(cfg, flavour):
        cfg = wc(cfg, flavour)
        return with_cooling(pt, cfg) if flavour is True else cfg

    for name in ("entropy MHD", "entropy hydro"):
        compare_template(torch, pt, fr, f"{name}, cooling",
                         with_cooling(pt, template_cfg(pt, name, shape)), errs,
                         RTOL_FIELD)
        for flavour in CHI3_FLAVOURS:
            compare_template(
                torch, pt, fr, f"{name} h3, chi3 {flavour}",
                flavoured(template_cfg(pt, name + " h3", shape), flavour),
                errs, RTOL_FIELD)
    for label in AUX_PATHS:
        base = aux_cfg(pt, label, shape)
        if base.module("entropy") is None:
            continue
        Omega = base.module("hydro").Omega
        compare_aux_kernels(
            torch, pt, fr, f"{label}, cooling",
            with_cooling(pt, aux_variant(pt, base, Omega, False)), errs,
            AUX_RTOL[label])
        for flavour in CHI3_FLAVOURS:
            compare_aux_kernels(
                torch, pt, fr, f"{label}, del6, chi3 {flavour}",
                flavoured(aux_variant(pt, base, Omega, True), flavour),
                errs, AUX_RTOL[label])
    for build, bkw in ZG_SS_BUILDS.items():
        if "shock" in bkw:
            continue        # no H3 instance beside the walled slot
        for flavour in CHI3_FLAVOURS:
            compare_zg_cfg(torch, pt, fr, flavoured(pt.configs.conv_slab(
                shape, **bkw, hyper3=True), flavour),
                f"{build}, del6, chi3 {flavour}", errs)
        compare_zg_cfg(torch, pt, fr, pt.configs.conv_slab(
            shape, **bkw, hyper3=True, chi=CHI, chi_hyper3=True),
            f"{build}, chi-const, del6, chi3", errs)


def run_chi3_paths(torch, pt, fr, smi, shape, launches, base):
    """Phase 3: the two paths of CHI3_COUNTERPART at 256³, through the
    runner of each chain, each one's ms/step and the card's busy ms per
    step printed beside its counterpart's (``base``: label -> that path's
    result, of this call); and two steps of each on the card against the
    CPU at 64³.  Returns label -> the path's result."""
    out = {}
    for label, other in CHI3_COUNTERPART.items():
        if label in CONV_SLAB_PATHS:
            out[label] = run_conv_slab(torch, pt, fr, smi, shape, launches,
                                       label, nwin=VARIANT_WINDOWS)
        else:
            out[label] = run_flagship(torch, pt, fr, smi, shape, launches,
                                      name=label, cfg=chi3_path_cfg(
                                          pt, label, shape))
        busy = {}
        for lab, (model, state) in ((label, out[label][:2]),
                                    (other, base[other][:2])):
            step = model.make_step()
            busy[lab] = device_busy(torch, lambda: step(state), 3)[0]
        ms, ms0 = out[label][2], base[other][2]
        print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms:.4f} ms/step, "
              f"the card busy {busy[label]:.4f} ms/step; {other} "
              f"{ms0:.4f} ms/step, busy {busy[other]:.4f} ms/step in this "
              f"call ({(ms / ms0 - 1) * 100:+.2f} %, busy "
              f"{(busy[label] / busy[other] - 1) * 100:+.2f} %)",
              flush=True)
    n64 = (N_MAIN // 4,) * 3
    for label in CHI3_COUNTERPART:
        compare_steps(torch, pt, label, chi3_path_cfg(pt, label, n64),
                      phase="3", uu_noise=1e-2 if "conv" in label else 0.0)
    return out


def time_chi3_turns(torch, fr, smi, paths, base):
    """Phase 4: each CHI3_COUNTERPART path's kernels timed in turns (A, B,
    B, A, 20 launches a turn) with its counterpart's, each on its own
    path's final state at 256³ (phase 2 and phase 3's steps check them
    against their plain versions)."""
    for label, path in paths.items():
        other = CHI3_COUNTERPART[label]
        if label in CONV_SLAB_PATHS:
            time_zg_turns(torch, fr, smi, path, base[other])
        else:
            time_term_turns(torch, fr, smi, label, path, other, base[other])


def compare_zg_shock(torch, pt, fr, shape, errs, every=True):
    """Phase 2: the z-ghosted builds with the shock slot (K6k/K7k,
    K6mk/K7mk) against their plain versions, with and without the shock
    diffusivities (SHK) and, where ``every``, Ω = 1 (ROT), chi-const (CHI)
    and the upwinding (UPW): every instance."""
    flags = (False, True) if every else (False,)
    for magnetic in (False, True):
        for Omega in (0.0, 1.0) if every else (0.0,):
            for chi in (0.0, CHI) if every else (0.0,):
                for upwind in flags:
                    for sd in (False, True):
                        cfg = pt.configs.conv_slab(
                            shape, magnetic=magnetic, Omega=Omega, chi=chi,
                            upwind=upwind, shock=True)
                        compare_zg_cfg(
                            torch, pt, fr,
                            pt.configs.with_shock_diffusion(cfg) if sd
                            else cfg,
                            "shocked " + ("magnetoconvection" if magnetic
                                          else "conv-slab")
                            + (f", Omega = {Omega:g}" if Omega else "")
                            + (f", chi = {chi:g}" if chi else "")
                            + (", upwind" if upwind else "")
                            + (", shock diffusion" if sd else ""), errs)


def compare_heatcond(torch, pt, fr, shape, errs):
    """Phase 2: Entropy's other conduction and cooling terms on the six
    z-ghosted builds with ss against their plain versions: each flavour
    set of HEATCOND_SETS on each build's first and update kernel, and the
    sets of the base and the CHI instances (K-profile; Kramers) also on
    their UPW, H3 and (with the shock slot) SHK twins, the Kramers set
    also with Ω = 1 (ROT; the sheared builds always), so every instance
    that the terms reach runs them."""
    base, chi, _ = HEATCOND_SETS
    for build, bkw in ZG_SS_BUILDS.items():
        shock = "shock" in bkw
        twins = [{}, dict(upwind=True)] + ([] if shock else
                                           [dict(hyper3=True)])
        for label, kw in HEATCOND_SETS.items():
            for twin in (twins if label in (base, chi) else [{}]):
                for sd in ((False, True) if shock and label != base
                           else (False,)):
                    cfg = pt.configs.conv_slab(shape, **bkw, **kw, **twin)
                    compare_zg_cfg(
                        torch, pt, fr,
                        pt.configs.with_shock_diffusion(cfg) if sd else cfg,
                        f"{build}, {label}" + "".join(
                            f", {k}" for k in twin)
                        + (", shock diffusion" if sd else ""), errs)
            if label == chi and "shear" not in bkw:
                compare_zg_cfg(torch, pt, fr, pt.configs.conv_slab(
                    shape, **bkw, **kw, Omega=1.0),
                    f"{build}, {label}, Omega = 1", errs)


def conduction_rate(torch, fr, model, fa):
    """The largest conductive CFL rate γK/(ρcp) of the conduction
    flavours that ``model`` runs on the state ``fa`` (K-const's, K(z)'s of
    'K-profile', Kramers' clipped K, 'chi-cspeed''s γχT^c); 0 without
    them."""
    ent, eos = model.cfg.module("entropy"), model.eos
    if ent is None:
        return 0.0
    lnrho = fa[3]
    lnTT = (eos.lnTT0 + eos.gamma / eos.cp * fa[4]
            + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
    rates = [0.0]
    if ent.conduction:
        rates.append(ent.hcond0 * float(torch.exp(-lnrho).max()) / eos.cp
                     * eos.gamma)
    kprof = fr.kprof_vector(model)
    if kprof is not None:
        rates.append(float((kprof[0] * torch.exp(-lnrho)).max())
                     / eos.cp * eos.gamma)
    if ent.kramers:
        n = ent.nkramers
        k = ent.hcond0_kramers * torch.exp(-(2.0 * n + 1.0) * lnrho
                                           + 6.5 * n * lnTT)
        if ent.chimax_kramers > 0.0:
            k = k.clamp(ent.chimin_kramers * eos.cp,
                        ent.chimax_kramers * eos.cp)
        rates.append(float(k.max()) / eos.cp * eos.gamma)
    if ent.cspeed_conduction:
        rates.append(eos.gamma * ent.chi
                     * float(torch.exp(ent.chi_cspeed * lnTT).max()))
    return max(rates)


def compare_steps(torch, pt, label, cfg, nsteps=2, uu_noise=0.0, t0=None,
                  phase="2b"):
    """Phase 2b: full steps on the card against the CPU (plain versions),
    same fields, made on the CPU, and, when forced, the same forcing
    draws; ``uu_noise`` > 0 replaces the initial velocity with noise of
    that amplitude, ``t0`` the start time; ``phase`` the phase that
    prints the line (3: a main path at 256³)."""
    cpu = torch.device("cpu")
    shape = cfg.grid.shape
    fields = dict(pt.Model(cfg, device=cpu).init_state(5)["fields"])
    g = torch.Generator(cpu).manual_seed(9)
    if uu_noise:
        fields["uu"] = uu_noise * torch.randn((3,) + shape, generator=g)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(nsteps)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = pt.Model(cfg, device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        s = model.init_state(5, overrides=fields)
        if t0 is not None:
            s["t"] = torch.full((), t0, device=dev)
        step = model.make_step()
        for _ in range(nsteps):
            s = step(s)
        out[dev] = s
    dt_rel = abs(float(out["cuda"]["dt"]) / float(out["cpu"]["dt"]) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} step dt rel err {dt_rel}")
    worst = 0.0
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        r = float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        check(r <= RTOL_FIELD, f"{label} step field {k} rel err {r}")
        worst = max(worst, r)
    print(f"phase {phase} {shape} {label}: {nsteps} steps on the card vs "
          f"the CPU: worst field rel err {worst:.2e}, dt rel err "
          f"{dt_rel:.2e}", flush=True)


def sheared_fg(torch, pm, seed):
    """(nf, nx+6, ny+6, nz) on the card: noisy shear-box fields of the
    model's layout (u, lnρ 1e-2, A 1e-4) and a positive shock slot where
    it has one, ghosted in x and y with the x faces shifted by deltay at t
    = T_SHEAR."""
    g = torch.Generator("cuda").manual_seed(seed)
    shape = pm.cfg.grid.shape
    nvar = pm.reg.nvar
    amp = torch.tensor([1e-4 if c[0] == "a" else 1e-2
                        for c in pm.reg.comp_names[:nvar]], device="cuda")
    parts = [amp[:, None, None, None] * torch.randn(
        (nvar,) + shape, generator=g, device="cuda")]
    if pm.reg.nf > nvar:
        parts.append(1e-3 * torch.rand((1,) + shape, generator=g,
                                       device="cuda"))
    sdy = pm.deltay(torch.full((), T_SHEAR, device="cuda"))
    return pm.ghosted(torch.cat(parts), (0, 1), sdy)


def time_ms(torch, fn, n, warm=True):
    """Mean ms of fn() over n calls, by CUDA events, after one warm-up call
    where ``warm``."""
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def urms(torch, fa):
    return float(fa[0:3].pow(2).sum(0).mean().sqrt())


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr
    # every library compiles in the background, the longest first; each
    # kernel's first call waits for its own library only, so phase 2 takes
    # the builds in the order they finish: the aux builds, the z-ghosted,
    # then the periodic ones
    _build.start()

    # ---- phase 1: device and toolchain --------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"phase 1: device {name}; nvidia-smi: {smi}", flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    check(STRAT_PATHS["NEMPI box"]["b_ext"][1] == pt.configs.NEMPI_B0,
          "the NEMPI box's B0 is not configs.NEMPI_B0")

    def mark(what):
        print(f"chip_smoke: {what} ended at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    mark("phase 1")
    if sys.argv[1:] == ["--only", "visc"]:
        return visc_only(torch, pt, fr, _build, smi, mark)
    if sys.argv[1:] == ["--only", "chi3"]:
        return chi3_only(torch, pt, fr, _build, smi, mark)
    # ---- phase 2: kernels against their plain versions ----------------
    # every instance checked, also those no phase-3 path runs (the
    # z-ghosted builds' CHI and H3 instances together)
    errs = dict.fromkeys(fr.LAUNCHES)
    for shape in ((64, 64, 64), (32, 64, 128), (16, 24, 40), EDGE_SHAPE):
        for label in AUX_PATHS:
            compare_aux_kernels(torch, pt, fr, label,
                                aux_cfg(pt, label, shape), errs,
                                AUX_RTOL[label])
    mark("phase 2, the aux builds")
    # the new aux builds' other instances: with and without Ω and del6
    for shape in ((64, 64, 64), EDGE_SHAPE):
        for label in NEW_AUX_PATHS:
            for Omega in (0.0, 1.0):
                for hyper3 in (False, True):
                    compare_aux_kernels(
                        torch, pt, fr, f"{label}, Omega = {Omega:g}, "
                        f"{'with' if hyper3 else 'without'} del6",
                        aux_variant(pt, aux_cfg(pt, label, shape), Omega,
                                    hyper3), errs, AUX_RTOL[label])
    mark("phase 2, the aux builds' instances")
    for shape in ((64, 64, 64), (32, 64, 128), (16, 24, 40), EDGE_SHAPE,
                  (32, 32, 32)):
        for magnetic in (False, True):
            for Omega in (0.0, 1.0):
                for chi in (0.0, CHI):
                    compare_zghost_kernels(torch, pt, fr, shape, errs,
                                           magnetic, Omega, chi)
    # their H3 instances: alone at 64³, with and without Ω and chi-const
    # at the edge shape
    for magnetic in (False, True):
        compare_zghost_kernels(torch, pt, fr, (64, 64, 64), errs, magnetic,
                               hyper3=True)
        for Omega in (0.0, 1.0):
            for chi in (0.0, CHI):
                compare_zghost_kernels(torch, pt, fr, EDGE_SHAPE, errs,
                                       magnetic, Omega, chi, True)
    # the shear builds (Ω = 1): with and without chi-const and del6
    for shape in ((64, 64, 64), EDGE_SHAPE):
        for magnetic in (False, True):
            for chi in (0.0, CHI):
                for hyper3 in (False, True):
                    compare_zghost_kernels(torch, pt, fr, shape, errs,
                                           magnetic, 1.0, chi, hyper3,
                                           shear=True)
    # the builds without ss: each set with and without Ω (the sheared ones
    # at Ω = 1, the input at t = T_SHEAR) and with and without del6
    for shape in ((64, 64, 64), (32, 32, 32), (16, 24, 40), EDGE_SHAPE):
        for iso, kw in ISO_SETS.items():
            for Omega in ((1.0,) if kw.get("shear", True) else (0.0, 1.0)):
                for hyper3 in (False, True):
                    compare_zg_cfg(
                        torch, pt, fr,
                        strat_cfg(pt, shape, Omega, hyper3=hyper3, **kw),
                        f"isothermal stratified {iso}, Omega = {Omega:g}"
                        + (", del6" if hyper3 else ""), errs)
    mark("phase 2, the z-ghosted builds")
    for shape in ((64, 64, 64), EDGE_SHAPE):
        compare_gravity(torch, pt, fr, shape, errs)
    mark("phase 2, every build under gravity")
    compare_terms(torch, pt, fr, EDGE_SHAPE, errs)
    compare_terms(torch, pt, fr, (64, 64, 64), errs, every=False)
    mark("phase 2, every build with B_ext and the continuous forcing")
    compare_upwind(torch, pt, fr, EDGE_SHAPE, errs)
    compare_shock_diffusion(torch, pt, fr, EDGE_SHAPE, errs)
    mark("phase 2, the UPW instances and the shock diffusivities")
    for shape in ((64, 64, 64), EDGE_SHAPE):
        compare_zg_shock(torch, pt, fr, shape, errs)
    for shape in ((32, 64, 128), (16, 24, 40)):
        compare_zg_shock(torch, pt, fr, shape, errs, every=False)
    mark("phase 2, the z-ghosted builds with the shock slot")
    compare_heatcond(torch, pt, fr, (32, 32, 32), errs)
    mark("phase 2, Entropy's conduction and cooling flavours")
    compare_visc(torch, pt, fr, (32, 32, 32), errs)
    mark("phase 2, Viscosity's flavours and diffrho")
    compare_chi3(torch, pt, fr, (32, 32, 32), errs)
    mark("phase 2, Entropy's hyper-diffusion and cooling")
    compare_walls(torch, pt, (32, 32, 32), WALL_CASES)
    compare_walls(torch, pt, (128, 128, 16), WALL_FFT_CASES)
    mark("phase 2, the z-wall codes' fills")
    for ny in (64, 128, 256):
        compare_shifts(torch, pt, ny)
    for shape in ((64, 64, 64), EDGE_SHAPE):
        compare_safi_mesh(torch, pt, fr, shape, errs)
    mark("phase 2, SAFI and the mesh flavour of del6")
    for shape in ((64, 64, 64), (32, 64, 128), EDGE_SHAPE):
        compare_template(torch, pt, fr, "forced hydro",
                         forced_hydro(pt, shape), errs)
        compare_template(torch, pt, fr, "flagship with Omega = 1",
                         with_omega(pt, flagship(pt, shape), 1.0), errs)
        for magnetic, label in ((True, "entropy MHD"),
                                (False, "entropy hydro")):
            compare_template(torch, pt, fr, label,
                             forced_entropy(pt, shape, magnetic), errs,
                             RTOL_FIELD)
        compare_template(
            torch, pt, fr, "entropy MHD, K-const and chi-const, Omega = 1",
            forced_entropy(pt, shape, True, Omega=1.0, entropy=dict(
                iheatcond=("chi-const", "K-const"), chi=5e-3, hcond0=4e-3)),
            errs, RTOL_FIELD)
        compare_template(
            torch, pt, fr, "entropy hydro, K-const alone, Omega = 1",
            forced_entropy(pt, shape, False, Omega=1.0, entropy=dict(
                iheatcond=("K-const",), hcond0=4e-3)), errs, RTOL_FIELD)
        compare_hyper3(torch, pt, fr, shape, errs)
        compare_kernels(torch, pt, fr, shape, errs)
        compare_tail_kernels(torch, pt, fr, shape, errs)
    libs = _build.build()
    built = ("found built (no nvcc run)" if _build.build_seconds is None
             else f"built in {_build.build_seconds:.1f} s")
    print(f"phase 2: kernels {built}, each "
          "library's nvcc ended at: " + ", ".join(
              f"{k} {t:.1f} s" for k, t in sorted(
                  _build.build_times.items(), key=lambda kv: kv[1]))
          + " -> " + ", ".join(p.name for p in libs.values()), flush=True)
    mark("phase 2")
    n32 = (32, 32, 32)
    for order in (3, 2, 4):
        compare_steps(torch, pt, f"flagship rk{order}",
                      flagship(pt, n32, itorder=order))
        compare_steps(torch, pt, f"forced hydro rk{order}",
                      forced_hydro(pt, n32, itorder=order))
        compare_steps(torch, pt, f"entropy MHD rk{order}",
                      forced_entropy(pt, n32, True, order))
        compare_steps(torch, pt, f"entropy hydro rk{order}",
                      forced_entropy(pt, n32, False, order))
    for path in TEMPLATE_PATHS:
        if path.endswith(" h3"):
            compare_steps(torch, pt, path, template_cfg(pt, path, n32))
    for order in (2, 4):
        compare_steps(torch, pt, f"flagship h3 rk{order}",
                      template_cfg(pt, "flagship h3", n32, order))
    compare_steps(torch, pt, "flagship h3, Omega = 1",
                  template_cfg(pt, "flagship h3", n32, Omega=1.0))
    compare_steps(torch, pt, "forced hydro, Omega = 1",
                  forced_hydro(pt, n32, Omega=1.0))
    compare_steps(torch, pt, "flagship, Omega = 1",
                  with_omega(pt, flagship(pt, n32), 1.0))
    compare_steps(torch, pt, "shock box", pt.configs.shock_box(n32),
                  uu_noise=0.1)
    # conv-slab: velocity noise 1e-2, not the configuration's 1e-3, whose
    # velocity after 3 steps is the residual of the O(1) hydrostatic
    # balance and sits below its float32 floor (tests/test_torch_zghost.py,
    # UU_AMPL); the shear box from t = T_SHEAR
    compare_steps(torch, pt, "conv-slab", pt.configs.conv_slab(n32),
                  uu_noise=1e-2)
    for label, kw in (("magnetoconvection", dict(magnetic=True)),
                      ("conv-slab, Omega = 1", dict(Omega=1.0)),
                      ("magnetoconvection, Omega = 1",
                       dict(magnetic=True, Omega=1.0)),
                      ("conv-slab chi", dict(chi=CHI)),
                      ("magnetoconvection chi", dict(magnetic=True, chi=CHI)),
                      ("magnetoconvection chi, Omega = 1",
                       dict(magnetic=True, Omega=1.0, chi=CHI)),
                      ("conv-slab h3", dict(hyper3=True)),
                      ("magnetoconvection h3", dict(magnetic=True,
                                                    hyper3=True)),
                      ("magnetoconvection chi h3, Omega = 1",
                       dict(magnetic=True, Omega=1.0, chi=CHI,
                            hyper3=True)),
                      ("forced conv-slab", dict(forcing=FORCE))):
        compare_steps(torch, pt, label, pt.configs.conv_slab(n32, **kw),
                      uu_noise=1e-2)
    for label in ("sheared conv-slab", "sheared magnetoconvection"):
        compare_steps(torch, pt, label, conv_slab_cfg(pt, label, n32),
                      uu_noise=1e-2, t0=T_SHEAR)
    # the isothermal stratified layer: its sets' initial velocity (1e-3)
    # sits beside the O(1) pressure and gravity forces, so noise of 1e-2,
    # as the conv-slab's
    for iso, kw in dict(ISO_SETS, **{
            "forced MHD": dict(shear=False, forcing=FORCE)}).items():
        compare_steps(torch, pt, f"isothermal stratified {iso}",
                      strat_cfg(pt, n32, **kw), uu_noise=1e-2)
    # the paths under gravity: the stratified shearing box with an energy
    # equation, MHD and hydro, and forced stratified turbulence in a
    # periodic box, MHD and hydro
    for label in ("stratified MRI box ent", "stratified shear hydro ent"):
        compare_steps(torch, pt, label, strat_cfg(pt, n32,
                                                  **STRAT_PATHS[label]),
                      uu_noise=1e-2)
    for label, kw in GRAV_WRAP_PATHS.items():
        compare_steps(torch, pt, label, pt.configs.strat_box(n32, **kw),
                      uu_noise=1e-2)
    for label, (make, kw) in TERM_WRAP_PATHS.items():
        compare_steps(torch, pt, label, getattr(pt.configs, make)(n32, **kw))
    compare_steps(torch, pt, "NEMPI box", strat_cfg(
        pt, n32, **STRAT_PATHS["NEMPI box"]), uu_noise=1e-2)
    compare_steps(torch, pt, "shear box", pt.configs.shear_box(n32),
                  t0=T_SHEAR)
    sb = pt.configs.shear_box(n32)
    compare_steps(torch, pt, "forced shear box",
                  sb.replace(modules=sb.modules + (
                      pt.Forcing(force=0.07, kf=3.0),)), t0=T_SHEAR)
    for label in NEW_AUX_PATHS:
        shear = AUX_PATHS[label][0] == "shear_box"
        compare_steps(torch, pt, label, aux_cfg(pt, label, n32),
                      uu_noise=0.0 if shear else 0.1,
                      t0=T_SHEAR if shear else None)
    compare_steps(torch, pt, "flagship upwind",
                  pt.configs.flagship(n32, upwind=True))
    compare_steps(torch, pt, "conv-slab upwind",
                  conv_slab_cfg(pt, "conv-slab upwind", n32), uu_noise=1e-2)
    for label in SHOCK_DIFFUSION_PATHS:
        compare_steps(torch, pt, label, aux_cfg(pt, label, n32),
                      uu_noise=0.1)
    for label in ZG_SHOCK_COUNTERPART:
        compare_steps(torch, pt, label, conv_slab_cfg(pt, label, n32),
                      uu_noise=1e-2)
    for label in SHOCK_VARIANT_PATHS:
        compare_steps(torch, pt, label, aux_cfg(pt, label, n32),
                      uu_noise=0.1)
    # SAFI, the mesh flavour and the mean removal: the forced flagship's
    # mean comes out before the kick, which then follows K3 (no kick in
    # K3); the SAFI paths from t = T_SHEAR
    compare_steps(torch, pt, "flagship, mean momenta removed",
                  pt.configs.flagship(n32, remove_mean_momenta=True))
    compare_steps(torch, pt, "flagship mesh",
                  pt.configs.flagship(n32, hyper3="mesh"))
    for label in SAFI_AUX_PATHS:
        compare_steps(torch, pt, label, aux_cfg(pt, label, n32),
                      t0=T_SHEAR)
    compare_steps(torch, pt, "SAFI stratified MRI box",
                  strat_cfg(pt, n32, **STRAT_PATHS["SAFI stratified MRI "
                                                   "box"]),
                  uu_noise=SAFI_UU_NOISE)
    compare_steps(torch, pt, "SAFI sheared conv-slab",
                  conv_slab_cfg(pt, "SAFI sheared conv-slab", n32),
                  uu_noise=SAFI_UU_NOISE, t0=T_SHEAR)
    for label in HEATCOND_PATHS:
        compare_steps(torch, pt, label, conv_slab_cfg(pt, label, n32),
                      uu_noise=1e-2)
    for label, kw in WALL_STEPS.items():
        if "Fgs" in str(kw["bcz"]):
            kw = dict(kw, entropy=dict(sigmaSBt=pt.configs.fgs_sigma()))
        compare_steps(torch, pt, label, pt.configs.conv_slab(n32, **kw),
                      uu_noise=1e-2)

    mark("phase 2b")
    # ---- phase 3: the main paths at 256³ ------------------------------
    shape = (N_MAIN,) * 3
    launches, timings, bounds = {}, {}, {}
    fl = run_flagship(torch, pt, fr, smi, shape, launches)
    hy = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="forced hydro")
    em = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="entropy MHD")
    eh = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="entropy hydro")
    h3 = {name: run_flagship(torch, pt, fr, smi, shape, launches, name=name)
          for name in TEMPLATE_PATHS if name.endswith(" h3")}
    grav = {label: run_flagship(torch, pt, fr, smi, shape, launches,
                                name=label, cfg=pt.configs.strat_box(
                                    shape, **kw))
            for label, kw in GRAV_WRAP_PATHS.items()}
    terms = {label: run_flagship(torch, pt, fr, smi, shape, launches,
                                 name=label, cfg=getattr(pt.configs, make)(
                                     shape, **kw))
             for label, (make, kw) in TERM_WRAP_PATHS.items()}
    mark("phase 3, the periodic builds at order 3")
    zg, zm = (run_conv_slab(torch, pt, fr, smi, shape, launches, label)
              for label in ("conv-slab", "magnetoconvection"))
    zc, zmc, zh, zmh, zs, zms, zf = (
        run_conv_slab(torch, pt, fr, smi, shape, launches, label,
                      nwin=VARIANT_WINDOWS)
        for label in ("conv-slab chi", "magnetoconvection chi",
                      "conv-slab h3", "magnetoconvection h3",
                      "sheared conv-slab", "sheared magnetoconvection",
                      "forced conv-slab"))
    strat = {label: run_conv_slab(torch, pt, fr, smi, shape, launches,
                                  label, nwin=VARIANT_WINDOWS)
             for label in STRAT_PATHS}
    mark("phase 3, the z-ghosted builds")
    aux = {label: run_aux_box(torch, pt, fr, smi, shape, launches, label)
           for label in AUX_PATHS}
    mark("phase 3, the aux builds")
    fu = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="flagship upwind",
                      cfg=pt.configs.flagship(shape, upwind=True))
    zu = run_conv_slab(torch, pt, fr, smi, shape, launches,
                       "conv-slab upwind", nwin=VARIANT_WINDOWS)
    sd = {label: run_aux_box(torch, pt, fr, smi, shape, launches, label)
          for label in SHOCK_DIFFUSION_PATHS}
    mark("phase 3, upwinding and the shock diffusivities")
    zk = {label: run_conv_slab(torch, pt, fr, smi, shape, launches, label,
                               nwin=VARIANT_WINDOWS)
          for label in ZG_SHOCK_COUNTERPART}
    hi = {label: run_aux_box(torch, pt, fr, smi, shape, launches, label)
          for label in SHOCK_VARIANT_PATHS}
    mark("phase 3, the shock slot between walls and the 'highorder' "
         "profile")
    # SAFI at 256³ (the stratified MRI box with it is among ``strat``):
    # each path's dt beside the dt its counterpart without SAFI sets on the
    # same state, and two steps on the card against the CPU
    safi = {label: run_aux_box(torch, pt, fr, smi, shape, launches, label)
            for label in SAFI_AUX_PATHS}
    zsafi = run_conv_slab(torch, pt, fr, smi, shape, launches,
                          "SAFI sheared conv-slab", nwin=VARIANT_WINDOWS)
    for label, model, state in ((*safi["SAFI shear box"][:3],),
                                (zsafi[3], *zsafi[:2]),
                                ("SAFI stratified MRI box",
                                 *strat["SAFI stratified MRI box"][:2])):
        print_safi_dt(torch, pt, fr, smi, label, model, state)
    # two steps of each SAFI path on the card against the CPU: the shear
    # box with the full width's 256 rows along y (its x faces and its
    # shift, which cuFFT reads otherwise from 128 rows up), 64 in x and z
    # (at 256³ the CPU's plain chain took ~150 s), the z-walled two at 128³
    compare_steps(torch, pt, "SAFI shear box", aux_cfg(
        pt, "SAFI shear box", (64, N_MAIN, 64)), t0=T_SHEAR, phase="3")
    n128 = (N_MAIN // 2,) * 3
    compare_steps(torch, pt, "SAFI stratified MRI box", strat_cfg(
        pt, n128, **STRAT_PATHS["SAFI stratified MRI box"]),
        uu_noise=SAFI_UU_NOISE, phase="3")
    compare_steps(torch, pt, "SAFI sheared conv-slab", conv_slab_cfg(
        pt, "SAFI sheared conv-slab", n128), uu_noise=SAFI_UU_NOISE,
        t0=T_SHEAR, phase="3")
    mark("phase 3, SAFI, the mesh flavour and the mean removal")
    hc = {label: run_conv_slab(torch, pt, fr, smi, shape, launches, label,
                               nwin=VARIANT_WINDOWS)
          for label in HEATCOND_PATHS}
    for path in hc.values():
        print_heatcond_dt(torch, pt, fr, smi, *path)
    mark("phase 3, Entropy's conduction and cooling flavours")
    walls = {label: run_conv_slab(torch, pt, fr, smi, shape, launches,
                                  label, nwin=VARIANT_WINDOWS)
             for label in WALL_PATHS}
    mark("phase 3, the z-wall paths")
    visc = run_visc_paths(torch, pt, fr, smi, shape, launches, {
        "flagship": fl, "forced hydro h3": h3["forced hydro h3"],
        "hydro shock box ent": aux["hydro shock box ent"],
        "conv-slab": zg, "magnetoconvection": zm,
        "shear box": aux["shear box"]})
    mark("phase 3, Viscosity's flavours and diffrho")
    cbase = {"entropy MHD h3": h3["entropy MHD h3"], "conv-slab h3": zh}
    chi3 = run_chi3_paths(torch, pt, fr, smi, shape, launches, cbase)
    mark("phase 3, Entropy's hyper-diffusion and cooling")
    for order in (4, 2):
        for path in TEMPLATE_PATHS:
            run_flagship(torch, pt, fr, smi, shape, launches, itorder=order,
                         name=path)
    run_simulate(torch, pt, fr, smi, shape)
    run_outputs(torch, pt, fr, smi, shape)
    mark("phase 3, the run driver's outputs")
    run_rundir(torch, pt, fr, smi, shape)
    mark("phase 3, the run directories")
    k8 = run_fake_chain(torch, pt, fr, smi, shape, launches,
                        float(fl[1]["dt"]))

    mark("phase 3")
    # ---- phase 4: kernels and the plain chains, timed at 256³ ---------
    time_flagship(torch, fr, smi, fl, errs, timings, bounds)
    time_tails(torch, fr, fl, errs, timings, bounds)
    for path in (hy, em, eh, *h3.values()):
        time_flagship(torch, fr, smi, path, errs, timings, bounds)
        time_tails(torch, fr, path, errs, timings, bounds)
    for path in h3.values():
        time_h3_instances(torch, pt, fr, smi, path)
    base = {"flagship": fl, "forced hydro": hy}
    for label, path in grav.items():
        time_gravity_turns(torch, fr, smi, label, path,
                           GRAV_COUNTERPART[label],
                           base[GRAV_COUNTERPART[label]])
    for label, path in terms.items():
        time_term_turns(torch, fr, smi, label, path,
                        TERM_COUNTERPART[label],
                        base[TERM_COUNTERPART[label]])
    mark("phase 4, the periodic builds")
    for lib in _build.LIBRARIES:
        for inst, a in fr.flagship_attrs(lib).items():
            check(a["local_bytes"] == 0,
                  f"{inst}: {a['local_bytes']} B of local memory")
            print(f"phase 4 {inst} on {smi}: {a['registers']} registers, "
                  f"{a['local_bytes']} B local, shared {a['static_smem']} B "
                  f"static + {a['dynamic_smem']} B dynamic per block, "
                  f"{a['blocks_per_sm']} block(s) per SM", flush=True)
    print(f"phase 4 K8 chain at 256^3 on {smi}: {k8:.4f} ms/step, the "
          f"flagship's kernel chain {fl[2]:.4f} ms/step", flush=True)
    mark("phase 4, the attributes")
    time_conv_slab(torch, fr, smi, zg, errs, timings, bounds)
    time_conv_slab(torch, fr, smi, zm, errs, timings, bounds)
    time_conv_slab(torch, fr, smi, zc, errs, timings, bounds, full=False)
    time_conv_slab(torch, fr, smi, zmc, errs, timings, bounds, full=False)
    time_conv_slab(torch, fr, smi, zh, errs, timings, bounds, full=False)
    time_conv_slab(torch, fr, smi, zmh, errs, timings, bounds, full=False)
    for path in (zs, zms):
        time_conv_slab(torch, fr, smi, path, errs, timings, bounds,
                       full=False)
        print_split(torch, fr, smi, path)
    time_zg_turns(torch, fr, smi, zs, zg)
    time_zg_turns(torch, fr, smi, zms, zm)
    print_split(torch, fr, smi, zf)
    zpaths = {path[3]: path for path in (zg, zm, zs, zms)}
    for label, path in strat.items():
        if label in TERM_COUNTERPART:
            continue        # timed in turns with its counterpart below
        time_conv_slab(torch, fr, smi, path, errs, timings, bounds,
                       full=False)
        print_split(torch, fr, smi, path)
        if label in STRAT_COUNTERPART:
            time_zg_turns(torch, fr, smi, path,
                          zpaths[STRAT_COUNTERPART[label]])
    time_zg_turns(torch, fr, smi, strat["NEMPI box"],
                  strat[TERM_COUNTERPART["NEMPI box"]])
    mark("phase 4, the z-ghosted builds")
    for box in aux.values():
        time_aux_box(torch, fr, smi, box, errs, timings, bounds)
    for label in NEW_AUX_PATHS:
        time_aux_turns(torch, fr, smi, aux[label],
                       aux[AUX_COUNTERPART[label]])
    mark("phase 4, the aux builds")
    time_flagship(torch, fr, smi, fu, errs, timings, bounds,
                  label="flagship upwind")
    time_term_turns(torch, fr, smi, "flagship upwind", fu, "flagship", fl)
    time_conv_slab(torch, fr, smi, zu, errs, timings, bounds, full=False)
    time_zg_turns(torch, fr, smi, zu, zg)
    for label, box in sd.items():
        time_aux_box(torch, fr, smi, box, errs, timings, bounds)
        time_aux_turns(torch, fr, smi, box, aux[OPTION_COUNTERPART[label]])
    zbase = {"conv-slab": zg, "magnetoconvection chi": zmc}
    for label, path in zk.items():
        time_conv_slab(torch, fr, smi, path, errs, timings, bounds,
                       full=False)
        if not label.endswith(" sd"):
            print_split(torch, fr, smi, path)
        time_zg_turns(torch, fr, smi, path,
                      zbase[ZG_SHOCK_COUNTERPART[label]])
    for box in hi.values():
        time_prepass_turns(torch, smi, box, aux["shock box"])
        time_aux_turns(torch, fr, smi, box, aux["shock box"])
    for label, box in safi.items():
        time_aux_box(torch, fr, smi, box, errs, timings, bounds)
        time_aux_turns(torch, fr, smi, box, aux[SAFI_COUNTERPART[label]])
        time_safi_shift(torch, smi, box[1], box[2], label)
    time_conv_slab(torch, fr, smi, zsafi, errs, timings, bounds, full=False)
    print_split(torch, fr, smi, zsafi)
    time_zg_turns(torch, fr, smi, zsafi, zs)
    time_zg_turns(torch, fr, smi, strat["SAFI stratified MRI box"],
                  strat["stratified MRI box"])
    counterpart = {path[3]: path for path in (zg, zc, zm, zmc)}
    for label, path in hc.items():
        time_heatcond_turns(torch, fr, smi, path, [
            counterpart[o] for o in HEATCOND_COUNTERPART[label]], errs)
    parents = {path[3]: path for path in (zm, *hc.values())}
    for label, path in walls.items():
        time_wall_path(torch, fr, smi, path, parents[WALL_COUNTERPART[label]],
                       errs)
    vbase = {"flagship": fl, "forced hydro h3": h3["forced hydro h3"],
             "hydro shock box ent": aux["hydro shock box ent"],
             "conv-slab": zg, "magnetoconvection": zm,
             "shear box": aux["shear box"]}
    for label, path in visc.items():
        other = VISC_COUNTERPART[label]
        time_visc_turns(torch, fr, smi, label, path, other, vbase[other])
    time_chi3_turns(torch, fr, smi, chi3, cbase)

    mark("phase 4")
    unchecked = [k for k in KERNEL_NAMES if errs[k] is None]
    check(not unchecked, f"kernels never held against their plain versions "
          f"in this run: {unchecked}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timings[k][0],
         "plain_ms": timings[k][1], "bytes_per_point": bounds[k][0],
         "bound_ms": bounds[k][1], "bound_by": bounds[k][2],
         "library_ms": timings[k][2]}
        for k in KERNEL_NAMES]}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(smi, flush=True)
    check(name == torch.cuda.get_device_name(0), "the device name was lost")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def visc_only(torch, pt, fr, _build, smi, mark):
    """``chip_smoke.py --only visc``: the checks and paths of Viscosity's
    other flavours and diffrho alone (phase 2's compare_visc, every
    instance's registers and local bytes, the six paths and their
    counterparts at 256³, their kernels in turns), a quicker run for
    work on those terms; it prints no kernels line and no result."""
    errs = dict.fromkeys(fr.LAUNCHES)
    compare_visc(torch, pt, fr, (32, 32, 32), errs)
    mark("phase 2, Viscosity's flavours and diffrho")
    for lib in _build.LIBRARIES:
        for inst, a in fr.flagship_attrs(lib).items():
            check(a["local_bytes"] == 0,
                  f"{inst}: {a['local_bytes']} B of local memory")
            print(f"phase 4 {inst} on {smi}: {a['registers']} registers, "
                  f"{a['local_bytes']} B local", flush=True)
    shape = (N_MAIN,) * 3
    launches = {}
    base = {
        "flagship": run_flagship(torch, pt, fr, smi, shape, launches),
        "forced hydro h3": run_flagship(torch, pt, fr, smi, shape, launches,
                                        name="forced hydro h3"),
        "hydro shock box ent": run_aux_box(torch, pt, fr, smi, shape,
                                           launches, "hydro shock box ent"),
        "conv-slab": run_conv_slab(torch, pt, fr, smi, shape, launches,
                                   "conv-slab", nwin=VARIANT_WINDOWS),
        "magnetoconvection": run_conv_slab(
            torch, pt, fr, smi, shape, launches, "magnetoconvection",
            nwin=VARIANT_WINDOWS),
        "shear box": run_aux_box(torch, pt, fr, smi, shape, launches,
                                 "shear box")}
    visc = run_visc_paths(torch, pt, fr, smi, shape, launches, base)
    mark("phase 3, Viscosity's flavours and diffrho")
    for label, path in visc.items():
        other = VISC_COUNTERPART[label]
        time_visc_turns(torch, fr, smi, label, path, other, base[other])
    mark("phase 4, Viscosity's flavours and diffrho")
    print(smi, flush=True)
    return 0


def chi3_only(torch, pt, fr, _build, smi, mark):
    """``chip_smoke.py --only chi3``: the checks and paths of Entropy's
    hyper-diffusion and cooling alone (phase 2's compare_chi3, every
    instance's registers and local bytes, the two paths and their
    counterparts at 256³ with two steps of each at 64³ against the CPU,
    their kernels in turns), a quicker run for work on those terms; it
    prints no kernels line and no result."""
    errs = dict.fromkeys(fr.LAUNCHES)
    compare_chi3(torch, pt, fr, (32, 32, 32), errs)
    mark("phase 2, Entropy's hyper-diffusion and cooling")
    for lib in _build.LIBRARIES:
        for inst, a in fr.flagship_attrs(lib).items():
            check(a["local_bytes"] == 0,
                  f"{inst}: {a['local_bytes']} B of local memory")
            print(f"phase 4 {inst} on {smi}: {a['registers']} registers, "
                  f"{a['local_bytes']} B local", flush=True)
    shape = (N_MAIN,) * 3
    launches = {}
    base = {
        "entropy MHD h3": run_flagship(torch, pt, fr, smi, shape, launches,
                                       name="entropy MHD h3"),
        "conv-slab h3": run_conv_slab(torch, pt, fr, smi, shape, launches,
                                      "conv-slab h3", nwin=VARIANT_WINDOWS)}
    paths = run_chi3_paths(torch, pt, fr, smi, shape, launches, base)
    mark("phase 3, Entropy's hyper-diffusion and cooling")
    time_chi3_turns(torch, fr, smi, paths, base)
    mark("phase 4, Entropy's hyper-diffusion and cooling")
    print(smi, flush=True)
    return 0


def print_safi_dt(torch, pt, fr, smi, label, model, state):
    """Phase 3: the dt that the SAFI path's state sets, beside the dt that
    the same configuration without SAFI sets on the same state (its first
    kernel's CFL maximum on the same input): SAFI drops |S x|/Δy from
    the CFL."""
    cfg = model.cfg.replace(modules=tuple(
        dataclasses.replace(m, lshearadvection_as_shift=False)
        if m.name == "shear" else m for m in model.cfg.modules))
    plain = pt.Model(cfg, device="cuda")
    dts = []
    for m in (model, plain):
        if m.mode == "zroll":
            sdy = m.deltay(state["t"])
            _, dt1m = fr.rhs_zroll(m, m.ghosted(m._refresh_aux_fa(
                state["_fa"], sdy), (0, 1), sdy))
        else:
            sdy = m.deltay(state["t"] + m.rk[2][0] * state["dt"])
            _, dt1m = fr.rhs_zg(m, *m.zg_input(state["_fa"].clone(), sdy))
        dts.append(float(m._new_dt(dt1m, state["dt"])))
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: dt {dts[0]:.6e} with SAFI, "
          f"{dts[1]:.6e} without it on the same state (x "
          f"{dts[0] / dts[1]:.4f})", flush=True)


def print_heatcond_dt(torch, pt, fr, smi, model, state, ms_step, label):
    """Phase 3: the dt that a conduction path's state sets, beside the dt
    that its K-const counterpart (``conv_slab`` with the same Magnetic and
    the default conduction and cooling) sets on the same state: each
    first kernel's CFL maximum on the same input."""
    mag = model.cfg.module("magnetic") is not None
    kconst = pt.Model(pt.configs.conv_slab(model.cfg.grid.shape,
                                           magnetic=mag), device="cuda")
    dts = []
    for m in (model, kconst):
        _, dt1m = fr.rhs_zg(m, *m.zg_input(state["_fa"].clone()))
        dts.append(float(m._new_dt(dt1m, state["dt"])))
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: dt {dts[0]:.6e}, the "
          f"K-const set's on the same state {dts[1]:.6e} (x "
          f"{dts[0] / dts[1]:.4f})", flush=True)


def time_heatcond_turns(torch, fr, smi, path, others, errs):
    """Phase 4: a conduction path's K6/K7 (HEATCOND_PATHS) checked against
    their plain versions on the stratified noisy input at 256³, the plain
    versions timed once, then the kernels timed in turns with those of its
    counterparts (``others``: K-const, and chi-const beside the CHI
    instances) on that one input."""
    model, _, _, label = path
    first, upd = fr.zg_kernels(model)
    first_p, upd_p = fr.zg_plain(model)
    inp = zg_input(torch, model, 3)
    df1, dt1m = first_p(model, *inp)
    coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
    df, d1 = fr.rhs_zg(model, *inp)
    dt_rel = abs(float(d1) / float(dt1m) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} {first} at 256^3: dt rel err "
          f"{dt_rel}")
    pairs = {first: [(df, df1)],
             upd: [(a, b) for a, b in zip(
                 fr.rhs_zg_upd(model, *inp, df1.clone(), coef),
                 upd_p(model, *inp, df1.clone(), coef))]}
    compare_pairs(f"{label} at 256^3 (max 1/dt rel err {dt_rel:.2e})",
                  (N_MAIN,) * 3, pairs, errs, RTOL_FIELD)
    del df, pairs
    scratch = df1.clone()
    plain = {first: time_ms(torch, lambda: first_p(model, *inp), PLAIN_CALLS,
                            warm=False),
             upd: time_ms(torch, lambda: upd_p(model, *inp, scratch, coef),
                          PLAIN_CALLS, warm=False)}
    variants = {label: model, **{o[3]: o[0] for o in others}}
    times = in_turns(torch, variants, {
        "K6": lambda m: fr.rhs_zg(m, *inp),
        "K7": lambda m: fr.rhs_zg_upd(m, *inp, scratch, coef)})
    print_turns(f"phase 4 {label} ({first}, {upd}) against "
                + ", ".join(o[3] for o in others)
                + f" at 256^3 on {smi}, one input (plain versions: "
                + ", ".join(f"{k} {t:.4f} ms" for k, t in plain.items())
                + ")", times)


def time_wall_path(torch, fr, smi, path, parent, errs):
    """Phase 4: a z-wall path's K6/K7 (WALL_PATHS) checked against their
    plain versions on the stratified noisy input at 256³ (of its layout:
    the vacuum exterior's x/y-ghosted slabs), the plain versions timed
    once, the kernels timed in turns with its parent set's, each on its
    own input (``time_zg_turns``), and the step's split, the z fills'
    device and host ms among the parts (``print_split``)."""
    model, _, _, label = path
    first, upd = fr.zg_kernels(model)
    first_p, upd_p = fr.zg_plain(model)
    inp = zg_input(torch, model, 3)
    df1, dt1m = first_p(model, *inp)
    coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
    df, d1 = fr.rhs_zg(model, *inp)
    dt_rel = abs(float(d1) / float(dt1m) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} {first} at 256^3: dt rel err "
          f"{dt_rel}")
    pairs = {first: [(df, df1)],
             upd: [(a, b) for a, b in zip(
                 fr.rhs_zg_upd(model, *inp, df1.clone(), coef),
                 upd_p(model, *inp, df1.clone(), coef))]}
    compare_pairs(f"{label} at 256^3 (max 1/dt rel err {dt_rel:.2e})",
                  (N_MAIN,) * 3, pairs, errs, RTOL_FIELD)
    del df, pairs
    scratch = df1.clone()
    plain = {first: time_ms(torch, lambda: first_p(model, *inp), PLAIN_CALLS,
                            warm=False),
             upd: time_ms(torch, lambda: upd_p(model, *inp, scratch, coef),
                          PLAIN_CALLS, warm=False)}
    print(f"phase 4 {label} plain versions at 256^3 on {smi}: "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in plain.items()),
          flush=True)
    del inp, df1, scratch
    time_zg_turns(torch, fr, smi, path, parent)
    print_split(torch, fr, smi, path)


def time_safi_shift(torch, smi, model, state, label):
    """Phase 4: one substep's SAFI shift of the evolved fields and the df
    carry at 256³ (``Model._safi_shift``): its device ms (CUDA events, 20
    calls), its kernels and busy ms (torch.profiler) and the host's ms to
    issue it."""
    nvar = model.reg.nvar
    f = state["_fa"][:nvar]
    df = f.clone()
    dt = state["dt"]

    def shift():
        return model._safi_shift(0, dt, f, df)

    ms = time_ms(torch, shift, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        shift()
    host = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    busy, nkern = device_busy(torch, shift, 3)
    print(f"phase 4 {label} SAFI shift of {nvar} fields and their df at "
          f"256^3 on {smi}: {ms:.4f} ms a substep (CUDA events), the card "
          + (f"busy {busy:.4f} ms in {nkern} kernels" if busy else
             "busy: not measured (torch.profiler recorded none)")
          + f", the host {host:.4f} ms to issue it", flush=True)


def sheared_rate(model):
    """max |S·x| of the model's background shear flow, which the CFL
    holds; 0 without Shear and under SAFI, which shifts the fields
    instead."""
    shear = model.cfg.module("shear")
    if shear is None or shear.lshearadvection_as_shift:
        return 0.0
    return abs(shear.S) * float(model.grid.x.abs().max())


def timed_steps(torch, fr, model, base):
    """The packed state of init_state(0), WARM untimed steps, then TIMED
    steps under the sync debug mode "error", the launch counts set to 0
    just before the timed steps and read just after.  Only the loop holds
    a state, so the peak counts what a step needs.  Returns (urms at the
    start, state, ms/step, peak bytes above ``base``, launches)."""
    state = model.pack_state(model.init_state(0))
    u0 = urms(torch, state["_fa"])
    step = model.make_step()
    for _ in range(WARM):
        state = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    e0.record()
    for _ in range(TIMED):
        state = step(state)
    e1.record()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    return (u0, state, e0.elapsed_time(e1) / TIMED,
            torch.cuda.max_memory_allocated() - base, launches)


def check_launches(label, counts, launches):
    """Exactly the path's kernels, each its number of times per step; the
    JSON line takes each kernel's count from the first path that runs
    it."""
    per_step = PER_STEP[label]
    want = {k: n * TIMED for k, n in per_step.items()}
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{label} launches {got}: need {per_step} per step")
    for k in per_step:
        launches.setdefault(k, counts[k])


def run_flagship(torch, pt, fr, smi, shape, launches, itorder=3,
                 name="flagship", cfg=None):
    """Phase 3: one of the flagship template's paths (TEMPLATE_PATHS: the
    forced-MHD flagship, forced hydro on the 4-field build, non-isothermal
    turbulence on the 8- and 5-field builds) at a 2N-RK order, or the
    path ``name`` of ``cfg`` (GRAV_WRAP_PATHS: the same chains under
    gravity)."""
    label = name if itorder == 3 else f"{name} rk{itorder}"
    cfg = cfg or template_cfg(pt, name, shape, itorder)
    base = torch.cuda.memory_allocated()
    model = pt.Model(cfg, device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches(label, counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (model.reg.nvar,) + shape,
          f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    dt = float(state["dt"])
    # the u = 0, B = 0, s = 0 CFL limit: sound speed (cs0 = 1) and the
    # largest diffusive rate (ν = η = 5e-3; with the entropy field χγ =
    # 5e-3 · 5/3), plus the del6 rate max(ν₃, η₃, D₃)·dxyz₆/cdtv3
    tc, gs = cfg.time, cfg.grid
    dxyz2 = sum((1.0 / d) ** 2 for d in (gs.dx, gs.dy, gs.dz))
    dxyz6 = sum((1.0 / d) ** 6 for d in (gs.dx, gs.dy, gs.dz))
    ent = cfg.module("entropy")
    diffus = max(5e-3, ent.chi * model.eos.gamma if ent else 0.0)
    dif3 = max(fr.hyper3_coefficients(cfg)) * dxyz6 / tc.cdtv3
    dt_est = 1.0 / math.hypot(math.sqrt(dxyz2) / tc.cdt,
                              diffus * dxyz2 / tc.cdtv + dif3)
    check(0.5 * dt_est < dt <= dt_est,
          f"dt {dt} not CFL-limited (estimate {dt_est})")
    u1 = urms(torch, fa)
    check(u1 > u0, f"urms did not grow: {u0} -> {u1}")
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(CFL estimate {dt_est:.6e}), urms {u0:.3e} -> {u1:.3e}, "
          f"launches per step {PER_STEP[label]}", flush=True)
    return model, state, ms_step


def guarded_runs(torch, prun):
    """A context in which every ``Run._advance`` call (a chunk of steps)
    runs under the sync debug mode "error": no output may sit inside a
    step."""
    advance = prun.Run._advance

    def guarded(self, state, k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return advance(self, state, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    @contextlib.contextmanager
    def ctx():
        prun.Run._advance = guarded
        try:
            yield
        finally:
            prun.Run._advance = advance

    return ctx()


def run_simulate(torch, pt, fr, smi, shape):
    """Phase 3, through the run loop: simulate(forced_entropy) for 40
    steps with a row every 10 and a checkpoint every 20, every chunk of
    steps under the sync debug mode "error"; then 20 steps, a checkpoint
    and a resumed run of 20 more in a second directory, which must give
    the first run's fields bit for bit."""
    from pencil_tpu_torch import run as prun
    from pencil_tpu_torch.io.timeseries import read_time_series
    columns = ("it", "t", "dt", "urms", "umax", "u2m", "rhom", "rhomin",
               "rhomax", "ssm", "TTm", "csm", "ethm", "brms", "bmax", "b2m",
               "jrms", "jmax", "abm")
    cfg = pt.configs.forced_entropy(shape)
    params = prun.RunParams(it1=10, isave=20, print_columns=columns)
    with guarded_runs(torch, prun):
        with tempfile.TemporaryDirectory() as tmp:
            fr.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                whole = prun.simulate(cfg, nt=40, datadir=tmp, params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in fr.LAUNCHES.items() if v}
            print(out.getvalue(), end="", flush=True)
            check(counts == dict.fromkeys(ENT_KERNELS[:3], 40),
                  f"simulate launches {counts}")
            rows = read_time_series(os.path.join(tmp, "time_series.dat"))
            check(list(rows) == list(columns), f"columns {list(rows)}")
            its = [int(v) for v in rows["it"]]
            check(its == [0, 1, 10, 20, 30, 40], f"rows {its}")
            check(all(math.isfinite(v) for vs in rows.values() for v in vs),
                  "non-finite value in time_series.dat")
            check(rows["urms"][-1] > rows["urms"][0]
                  and rows["ssm"][-1] > rows["ssm"][0],
                  "urms and the mean entropy must grow")
            check(os.path.exists(os.path.join(tmp, "COMPLETED")),
                  "no COMPLETED")
            line = [ln for ln in out.getvalue().splitlines()
                    if ln.startswith("Wall clock time/timestep/meshpoint")]
            check(len(line) == 1, "no wall-clock line")
            us = float(line[0].split("=")[1])
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(io.StringIO()):
                prun.simulate(cfg, nt=20, datadir=tmp, params=params)
                again = prun.simulate(cfg, nt=20, datadir=tmp, params=params,
                                      resume=True)
            rows2 = read_time_series(os.path.join(tmp, "time_series.dat"))
    its2 = [int(v) for v in rows2["it"]]
    check(int(again["it"]) == 40 and its2 == [0, 1, 10, 20, 21, 30, 40],
          f"resumed run: it {int(again['it'])}, rows {its2}")
    for k, v in whole["fields"].items():
        check(v.is_cuda and torch.equal(again["fields"][k], v),
              f"restart: field {k} differs")
    check(torch.equal(again["t"], whole["t"]), "restart: t differs")
    print(f"phase 3 {N_MAIN}^3 simulate(forced_entropy, nt=40, it1=10, "
          f"isave=20) on {smi}: wall clock {us:.4e} microsec per step and "
          f"meshpoint ({wall:.2f} s with the model's set-up), rows "
          f"{its}, COMPLETED, launches {counts}; 20 steps + resume "
          f"from var.npz + 20 steps: the same fields bit for bit",
          flush=True)


# the README quickstart's plane and phi averages: one name of each suffix
# with a file (the x-averages, suffix myz, have none in the JAX writer)
OUTPUT_AVERAGES = ("uxmz", "bymz", "rhomy", "uzmx", "bzmxy", "uxmxz")
OUTPUT_PHI = ("uzmphi", "bzmphi")
# the columns of helical MHD turbulence beside the run's basic ones
OUTPUT_COLUMNS = (
    "it", "t", "dt", "urms", "umax", "u2m", "brms", "bmax", "b2m", "jrms",
    "jmax", "abm", "ux2m", "uy2m", "uz2m", "uxm", "uym", "uzm", "uxmax",
    "uymax", "uzmax", "uxmin", "uymin", "uzmin", "uxuym", "uxuzm", "uyuzm",
    "divum", "divu2m", "orms", "oum", "omax", "o2m", "ekin", "EEK", "Marms",
    "Mamax", "bx2m", "by2m", "bz2m", "arms", "a2m", "axm", "aym", "azm",
    "amax", "jbm", "j2m", "vA2m", "vArms", "vAmax", "bmx", "bmy", "bmz",
    "bm2", "emag", "EEM", "epsK", "epsM")


def quickstart(pt, shape):
    """The README quickstart's configuration: forced MHD with γ = 1.0001."""
    return pt.Config(
        grid=pt.GridSpec(nx=shape[0], ny=shape[1], nz=shape[2]), fused=True,
        modules=(pt.EosIdealGas(gamma=1.0001), pt.Density(),
                 pt.Hydro(init="gaussian-noise", ampl=1e-3),
                 pt.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pt.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pt.Forcing(force=0.07, kf=3.0)))


def simulate_counted(torch, prun, fr, model, nt, datadir, params):
    """simulate(model) from seed 0, its stdout captured; returns (state,
    wall µs per step and point as the run prints it, launches, peak
    device bytes, stdout)."""
    fr.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = prun.simulate(model, nt=nt, datadir=datadir, params=params)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("Wall clock time/timestep/meshpoint")]
    check(len(line) == 1, "no wall-clock line")
    return (state, float(line[0].split("=")[1]), counts,
            torch.cuda.max_memory_allocated(), out.getvalue())


def fortran_records(raw):
    """The payloads of a file of Fortran unformatted records."""
    out, off = [], 0
    while off < len(raw):
        n = int(np.frombuffer(raw[off:off + 4], np.int32)[0])
        out.append(raw[off + 4:off + 4 + n])
        off += 8 + n
    return out


def run_outputs(torch, pt, fr, smi, shape):
    """Phase 3, the run driver's outputs at full width: the README
    quickstart's configuration through simulate on K1-K3, (a) 40 steps with
    rows every 10 (the helical-MHD columns among them), a checkpoint every
    20, 4 spectra of u and B, plane averages every 10, 2 phi-average dumps,
    4 slices of ux and bz in xy and xz, 2 downsampled snapshots, and the
    same 40 steps with none of them; (b) 20 steps with the time average,
    3 sound probes and timing.dat, which take one step a call.  Every chunk
    runs under the sync debug mode "error"; K1-K3 launch once a step with
    and without outputs.  Checks each file's records and values, Parseval
    on the final velocity, and prints the wall µs per step and point with
    and without outputs, each evaluator's device ms and the peak device
    memory."""
    from pencil_tpu_torch import run as prun
    from pencil_tpu_torch.io import averages, spectra
    from pencil_tpu_torch.io.diagnostics import make_diagnostics
    from pencil_tpu_torch.post import read
    cfg = quickstart(pt, shape)
    model = pt.Model(cfg, device="cuda")
    # the time cadences from this run's dt (two steps, CFL-limited and
    # nearly constant over 40): spectra and slices at it = 10, 20, 30, 40,
    # phi averages and downsampled snapshots at 20 and 40
    st = model.make_multi_step(2)(model.init_state(0))
    dt = float(st["dt"])
    del st
    npoints = shape[0] * shape[1] * shape[2]
    out_params = dict(
        it1=10, isave=20, print_columns=OUTPUT_COLUMNS, dspec=5 * dt,
        power_fields=("kin", "mag"), aver_names=OUTPUT_AVERAGES, it1d=10,
        phiaver_names=OUTPUT_PHI, d2davg=15 * dt, dvid=5 * dt,
        slice_fields=("ux", "bz"), slice_planes=("xy", "xz"),
        downsampl=(2, 2, 2), dsnap_down=15 * dt)
    want = dict.fromkeys(FLAGSHIP_KERNELS, 40)
    with guarded_runs(torch, prun), tempfile.TemporaryDirectory() as tmp:
        plain_dir, out_dir = (os.path.join(tmp, d) for d in ("plain", "out"))
        _, us_plain, counts, peak_plain, _ = simulate_counted(
            torch, prun, fr, model, 40, plain_dir, prun.RunParams(
                it1=10, isave=20, print_columns=OUTPUT_COLUMNS))
        check(counts == want, f"run without outputs: launches {counts}")
        state, us_out, counts, peak_out, text = simulate_counted(
            torch, prun, fr, model, 40, out_dir,
            prun.RunParams(**out_params))
        check(counts == want, f"run with outputs: launches {counts}")
        print(text.splitlines()[0] + "\n" + text.splitlines()[-2],
              flush=True)
        # the files, their records and values
        ts = read.ts(out_dir)
        check(list(ts.it) == [0, 1, 10, 20, 30, 40], f"rows {list(ts.it)}")
        check(ts.keys == list(OUTPUT_COLUMNS), "columns")
        check(all(np.isfinite(getattr(ts, k)).all() for k in ts.keys),
              "non-finite column")
        nk = max(shape) // 2
        for pf in ("kin", "mag"):
            pw = read.power(pf, out_dir)
            check(len(pw.t) == 4 and pw.spec.shape == (4, nk)
                  and np.isfinite(pw.spec).all(),
                  f"power_{pf}.dat: times {pw.t}, {pw.spec.shape}")
        sizes = {"uxmz": shape[2], "bymz": shape[2], "rhomy": shape[1],
                 "uzmx": shape[0], "bzmxy": shape[0] * shape[1],
                 "uxmxz": shape[0] * shape[2]}
        planes = {}
        for n in OUTPUT_AVERAGES:
            planes.setdefault(averages._suffix_of(n), []).append(n)
        for names in planes.values():
            av = read.aver(out_dir, names, sizes)
            check(len(av.t) == 4 and all(
                getattr(av, n).shape == (4, sizes[n])
                and np.isfinite(getattr(av, n)).all() for n in names),
                f"averages {names}: times {av.t}")
        phi = sorted(f for f in os.listdir(os.path.join(out_dir, "averages"))
                     if f.startswith("PHIAVG"))
        check(phi == ["PHIAVG1", "PHIAVG2"], f"phi averages {phi}")
        for f in phi:
            with open(os.path.join(out_dir, "averages", f), "rb") as fh:
                rec = fortran_records(fh.read())
            nr, nz, nc, _ = np.frombuffer(rec[0], np.int32)
            data = np.frombuffer(rec[2], np.float32)
            check((nr, nz, nc) == (shape[0] // 2, shape[2], 2)
                  and data.size == nr * nz * nc and np.isfinite(data).all()
                  and rec[3][4:] == b"uzmphi,bzmphi", f"{f}")
        for fld in ("ux", "bz"):
            for plane in ("xy", "xz"):
                sl = read.slices(fld, plane, out_dir)
                check(sl.data.shape[0] == 4 and np.isfinite(sl.data).all(),
                      f"slice {fld} {plane}: {sl.data.shape}")
        down = sorted(f for f in os.listdir(out_dir) if f.startswith("VARd"))
        check(down == ["VARd1.npz", "VARd2.npz"], f"snapshots {down}")
        for f in down:
            with np.load(os.path.join(out_dir, f)) as z:
                check(z["uu"].shape == (3,) + tuple(n // 2 for n in shape)
                      and all(np.isfinite(z[k]).all() for k in z.files),
                      f"{f}")
        check(os.path.exists(os.path.join(out_dir, "COMPLETED")),
              "no COMPLETED")
        # Parseval: Σ_k ½|û|² over every wavevector is ½<u²>; the shells
        # stop at n/2 and leave out the corners of the cube
        uu = state["fields"]["uu"]
        fk = torch.fft.fftn(uu, dim=(-3, -2, -1)) / npoints
        total = float((0.5 * torch.abs(fk) ** 2).double().sum())
        u2m = float(make_diagnostics(model, ("u2m",))(state)["u2m"])
        check(abs(total - 0.5 * u2m) <= 1e-4 * 0.5 * u2m,
              f"Parseval: {total} against 0.5 u2m {0.5 * u2m}")
        shells = float(spectra.shell_spectrum(uu).double().sum())
        check(shells <= total * (1 + 1e-4),
              f"shell sum {shells} above the sum over every mode {total}")
        # (b) the outputs that take one step a call
        b_dir = os.path.join(tmp, "b")
        probes = ((0.1, -0.2, 0.3), (1.0, 2.0, -3.0), (-3.0, 0.0, 3.1))
        b_params = prun.RunParams(
            it1=10, isave=20, print_columns=("it", "t", "dt", "urms"),
            tavg=10 * dt, sound_points=probes, sound_fields=("ux", "lnrho"),
            it_timing=1)
        _, us_b, counts, peak_b, _ = simulate_counted(
            torch, prun, fr, model, 20, b_dir, b_params)
        check(counts == dict.fromkeys(FLAGSHIP_KERNELS, 20),
              f"one step a call: launches {counts}")
        timing = open(os.path.join(b_dir, "timing.dat")).read().splitlines()
        check([ln.split()[0] for ln in timing]
              == [str(i) for i in range(1, 21)], "timing.dat rows")
        sound = np.loadtxt(os.path.join(b_dir, "sound.dat"))
        check(sound.shape == (20, 1 + 3 * 2) and np.isfinite(sound).all(),
              f"sound.dat {sound.shape}")
        with np.load(os.path.join(b_dir, "timeavg.npz")) as z:
            check(sorted(z.files) == ["aa", "lnrho", "t", "uu"]
                  and all(np.isfinite(z[k]).all() for k in z.files),
                  "timeavg.npz")
    # each evaluator's device time on the final state; the time average
    # and the probes in a run with no other output
    with tempfile.TemporaryDirectory() as tmp:
        run = prun.Run(model, datadir=os.path.join(tmp, "a"), quiet=True,
                       params=prun.RunParams(**out_params))
        one = prun.Run(model, datadir=os.path.join(tmp, "b"), quiet=True,
                       params=dataclasses.replace(b_params, isave=0))
        t = float(state["t"])
        ev = {
            "spectrum kin": lambda: spectra.shell_spectrum(uu),
            "spectrum mag": lambda: spectra.shell_spectrum(
                averages.ghosted_pencils(model, state).bb()),
            "averages (6 names)": lambda: run.averages(state),
            "phi averages (2 names)": lambda: run.phiavg(state),
            "slice capture (ux, bz in xy, xz)": lambda: run.slices.capture(
                model, state),
            "time-average update": lambda: one._write_outputs(
                state, 1, t, dt),
            "sound row (3 probes, 2 fields: gather, copy, a line written)":
                lambda: one._write_sound(state, t),
        }
        ms = {k: time_ms(torch, fn, 5) for k, fn in ev.items()}
    print(f"phase 3 {N_MAIN}^3 simulate(quickstart, nt=40, it1=10, isave=20) "
          f"on {smi}: wall clock {us_out:.4e} microsec per step and "
          f"meshpoint with the outputs ({len(OUTPUT_COLUMNS)} columns, "
          f"4 spectra kin+mag, 4 records of {len(OUTPUT_AVERAGES)} "
          f"averages, 2 phi dumps, 4 slices, 2 VARd), {us_plain:.4e} "
          f"without; peak device memory {peak_out / 2**30:.3f} GiB with, "
          f"{peak_plain / 2**30:.3f} GiB without; launches {want}; "
          f"Parseval: sum over every mode {total:.6e}, 0.5 u2m "
          f"{0.5 * u2m:.6e}, shell sum {shells:.6e}", flush=True)
    print(f"phase 3 {N_MAIN}^3 simulate(quickstart, nt=20) with tavg, "
          f"3 sound probes, it_timing=1 on {smi}: wall clock {us_b:.4e} "
          f"microsec per step and meshpoint, peak {peak_b / 2**30:.3f} GiB; "
          f"20 rows of timing.dat and sound.dat, timeavg.npz finite",
          flush=True)
    print(f"phase 4 {N_MAIN}^3 output evaluators on {smi}, device ms a call "
          "(CUDA events, 5 calls after one): " + "; ".join(
              f"{k} {v:.4f}" for k, v in ms.items()), flush=True)


# the run directories of phase 3 run_rundir: label -> (the writer in
# pencil_tpu_torch.compat.samples, the path of PER_STEP its chain takes)
# label -> (the compat.samples writer, the path whose launches a step it
# runs, the writer's keyword arguments, its size: None for N_MAIN); the
# imposed-field and ABC-flow directories (the loader's B_ext and
# lforcing_cont) and the Kramers convection directory (the loader's
# iheatcond 'kramers', the CHI instances K6/K7 chi) at 128³, which is
# enough to drive the loader and the CLI
RUNDIRS = {"helical MHD (helical-MHDturb)": ("helical_mhdturb", "flagship",
                                             {}, None),
           "convection (conv-slab)": ("conv_slab", "conv-slab", {}, None),
           "imposed-field MHD (helical-MHDturb, B_ext)": (
               "helical_mhdturb", "flagship", dict(b_ext=(0.0, 0.0, 0.1)),
               128),
           "ABC-flow dynamo (helical-MHDturb, lforcing_cont)": (
               "helical_mhdturb", "flagship", dict(fcont=("ABC", 0.1, 1.0)),
               128),
           "Kramers convection (conv-slab, iheatcond='kramers')": (
               "conv_slab", "conv-slab kramers", dict(heatcond="kramers"),
               128)}
RUNDIR_NT = 20


def run_rundir(torch, pt, fr, smi, shape):
    """Phase 3, the run-directory entry point at full width: each run
    directory of RUNDIRS written into a temporary directory, then
    ``start``, ``run --nt 20`` and ``export`` through
    ``pencil_tpu_torch.__main__.main`` in this process (the reference's
    random stream replayed for the noise and, with the k.dat, the forcing;
    every chunk of steps under the sync debug mode "error"; the launch
    counts set to 0 just before ``run`` and read just after); the final
    state against the same configuration through Model.make_step from the
    same replayed fields; the exported var.dat read back through the C++
    codec, bit for bit the run's final fields.  The directory is deleted
    after each."""
    from pencil_tpu_torch import run as prun
    from pencil_tpu_torch.__main__ import main as cli
    from pencil_tpu_torch.compat import io_dist, samples
    from pencil_tpu_torch.compat.rundir import load_rundir
    from pencil_tpu_torch.io.snapshot import load_snapshot
    from pencil_tpu_torch.io.timeseries import read_time_series
    check(io_dist.native_lib() is not None, "the C++ var.dat codec did not "
          "build")
    for label, (writer, path, kw, n) in RUNDIRS.items():
        size = n or shape[0]
        with tempfile.TemporaryDirectory() as tmp:
            d = getattr(samples, writer)(os.path.join(tmp, "run"),
                                         (size,) * 3, nt=RUNDIR_NT, it1=10,
                                         **kw)
            secs = {}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                cli(["start", d])
                torch.cuda.synchronize()
                secs["start"] = time.perf_counter() - t0
                with guarded_runs(torch, prun):
                    fr.reset_launches()
                    t0 = time.perf_counter()
                    cli(["run", d, "--nt", str(RUNDIR_NT)])
                    torch.cuda.synchronize()
                    secs["run"] = time.perf_counter() - t0
                    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
                t0 = time.perf_counter()
                cli(["export", d])
                secs["export"] = time.perf_counter() - t0
            per_step = PER_STEP[path]
            check(counts == {k: n * RUNDIR_NT for k, n in per_step.items()},
                  f"{label}: launches {counts}, need {per_step} per step")
            if writer == "helical_mhdturb" and not kw:
                check(secs["start"] < 60.0,
                      f"{label}: start took {secs['start']:.1f} s")
            datadir = os.path.join(d, "data")
            rows = read_time_series(os.path.join(datadir, "time_series.dat"))
            check(all(math.isfinite(v) for vs in rows.values() for v in vs)
                  and len(rows["t"]) == 4, f"{label}: time_series.dat")
            cfg, info = load_rundir(d)
            model = pt.Model(cfg, device="cuda")
            check(model.mode == ("wrap" if path == "flagship" else "zghost"),
                  f"{label}: chain {model.mode}")
            if "b_ext" in kw:
                check(cfg.module("magnetic").B_ext == kw["b_ext"],
                      f"{label}: B_ext not loaded")
            if "fcont" in kw:
                check(fr.fcont_tensor(model) is not None
                      and model.forcing is None,
                      f"{label}: the continuous forcing not loaded")
            cli_state = load_snapshot(os.path.join(datadir, "var.npz"),
                                      model)
            check(int(cli_state["it"]) == RUNDIR_NT, f"{label}: it")
            ref = model.init_state(0, overrides=info["init_overrides"])
            step = model.make_step()
            for _ in range(RUNDIR_NT):
                ref = step(ref)
            worst = {}
            for k, v in ref["fields"].items():
                d_max = float((cli_state["fields"][k] - v).abs().max())
                worst[k] = d_max / float(v.abs().max())
                check(worst[k] <= RTOL_FIELD, f"{label}: {k} {worst[k]}")
            vf = io_dist.read_var(os.path.join(datadir, "proc0", "var.dat"))
            fa = model.reg.stack(cli_state["fields"]).cpu().numpy()
            check(np.array_equal(vf.f[:, 3:-3, 3:-3, 3:-3], fa),
                  f"{label}: var.dat read back differs")
            del model, cli_state, ref, step, fa, vf
            torch.cuda.empty_cache()
        print(out.getvalue(), end="", flush=True)
        print(f"phase 3 {size}^3 run directory, {label} on {smi}: "
              f"python -m pencil_tpu_torch start {secs['start']:.2f} s, "
              f"run --nt {RUNDIR_NT} {secs['run']:.2f} s, export "
              f"{secs['export']:.2f} s; launches per step {per_step}; no "
              "sync inside a chunk; the CLI's state against make_step from "
              "the same replayed fields: worst |diff|/max "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + "; var.dat read back by the C++ codec: bit for bit",
              flush=True)


def run_fake_chain(torch, pt, fr, smi, shape, launches, dt):
    """Phase 3: the K8 chain, the flagship's loads and stores with the
    RHS replaced by f·1.0000001, at the flagship's final dt (the fake K1
    reports no CFL rate).  Returns its ms/step."""
    base = torch.cuda.memory_allocated()
    model = pt.Model(flagship(pt, shape, dt=dt), device="cuda",
                     fake_rhs=True)
    _, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches("K8 chain", counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (7,) + shape, f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    print(f"phase 3 {N_MAIN}^3 K8 chain on {smi}: {ms_step:.4f} ms/step, "
          f"peak {peak / 2**30:.3f} GiB, fixed dt {dt:.6e}, launches per "
          f"step {PER_STEP['K8 chain']}", flush=True)
    return ms_step


# windows of TIMED steps of the conv-slab path in phase 3: its step is
# bound by the host's issue rate, which varies from run to run; its CHI
# and H3 instances' paths, whose kernels phase 4 times in turns, take
# fewer
CONV_SLAB_WINDOWS = 5
VARIANT_WINDOWS = 3


def run_conv_slab(torch, pt, fr, smi, shape, launches, label,
                  nwin=CONV_SLAB_WINDOWS):
    """Phase 3: a conv-slab path (CONV_SLAB_PATHS): stratified
    convection, non-periodic z, or magnetoconvection on K6m/K7m, with
    chi-const conduction beside K-const on their CHI instances, with del6
    hyper-diffusion on their H3 instances, in the shearing box on
    K6s/K7s or K6ms/K7ms, or forced, the kick after the step; or a path
    of the isothermal stratified layer (STRAT_PATHS) on the builds without
    ss; the step timed in ``nwin`` windows one after the other, the
    launches counted
    in the first, the card's busy time from torch.profiler's kernel
    records."""
    from pencil_tpu_torch.physics.pencils import Pencils
    base = torch.cuda.memory_allocated()
    cfg = (pt.configs.strat_box(shape, **STRAT_PATHS[label])
           if label in STRAT_PATHS
           else conv_slab_cfg(pt, label, shape))
    model = pt.Model(cfg, device="cuda")
    magnetic = "aa" in model.reg.slots
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches(label, counts, launches)
    step = model.make_step()
    windows, issue = [ms_step], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(nwin - 1):
        torch.cuda.set_sync_debug_mode("error")
        e0.record()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            state = step(state)
        issue.append((time.perf_counter() - t0) * 1e3 / TIMED)
        e1.record()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        windows.append(e0.elapsed_time(e1) / TIMED)
    ms_step = sorted(windows)[len(windows) // 2]
    busy, nkern = device_busy(torch, lambda: step(state), 3)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {len(windows)} windows "
          f"of {TIMED} steps: " + ", ".join(f"{w:.4f}" for w in windows)
          + f" ms/step; median {ms_step:.4f}, spread "
          f"{max(windows) - min(windows):.4f} ms "
          f"({(max(windows) / min(windows) - 1) * 100:.2f} %); the host "
          f"issued windows 2-{nwin} in "
          + ", ".join(f"{w:.4f}" for w in issue) + " ms/step; the card "
          + (f"busy {busy:.4f} ms a step in {nkern} kernels ("
             f"{busy / ms_step * 100:.1f} % of the step)"
             if busy else "busy: not measured (torch.profiler recorded "
             "none)"), flush=True)
    fa = state["_fa"]
    check(tuple(fa.shape) == (model.reg.nf,) + shape,
          f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    # the components with the code 'a' at both walls (uz, and with
    # Magnetic's perfect conductor A_x and A_y) are 0 on them (forced, the
    # kick after the writeback moves u off them, as JAX's does)
    comps = model.reg.comp_names
    for c in (() if model.forcing is not None else
              [comps.index(bc.comp) for bc in model.cfg.bcz
               if bc.low == bc.high == "a"]):
        check(bool((fa[c][:, :, [0, -1]] == 0).all()),
              f"{model.reg.comp_names[c]} not 0 on the walls")
    dt = float(state["dt"])
    # CFL bounds on the dt that the final state sets (one more step, out
    # of the timed window): 1/dt = max over points of the root sum of the
    # advective and diffusive rates, so it lies between the larger of
    # their maxima and the root sum of their maxima (with Magnetic the
    # latter holds the largest Alfvén speed too; with del6 the diffusive
    # rate holds the constant dxyz₆ one; with Shear both hold |S·x|/Δy at
    # the x faces).  The advective maximum is at least its u = 0 value at
    # the point of the largest cs² and at an x face with the smallest
    # (``adv_lo``), and at most the sum of the maxima (``adv_b``)
    dt_next = float(model.make_step()(state)["dt"])
    cfg, eos, ent = model.cfg, model.eos, model.cfg.module("entropy")
    tc, gs = cfg.time, cfg.grid
    inv = [1.0 / d for d in (gs.dx, gs.dy, gs.dz)]
    dxyz2 = sum(i * i for i in inv)
    lnrho = fa[3]
    # the sound speed: with ss at each point, isothermal cs0²
    cs2 = (eos.cs20 * torch.exp(eos.gamma / eos.cp * fa[4]
                                + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
           if ent is not None else torch.full((), eos.cs20, device="cuda"))
    # the shear flow's rate (none under SAFI) and the mesh flavours'
    # constant root join the advective rate
    shear_rate = sheared_rate(model) * inv[1] + float(
        fr.kernel_params(model).hmesh)
    umax = sum(fa[a].abs().max() * inv[a] for a in range(3)) + shear_rate
    adv = float((umax + torch.sqrt(cs2.max() * dxyz2)) / tc.cdt)
    adv_lo = max(shear_rate + float(torch.sqrt(cs2.min() * dxyz2)),
                 float(torch.sqrt(cs2.max() * dxyz2))) / tc.cdt
    va2 = 0.0
    if magnetic:
        pen = Pencils(model.ghosted(fa), model.grid, model.reg, cfg, eos,
                      ghosted=True)
        bb = pen.bb()
        va2 = float((sum((bb[a] * inv[a]) ** 2 for a in range(3))
                     * pen.rho1()).max())
        del pen, bb
    adv_b = float((umax + torch.sqrt(cs2.max() * dxyz2 + va2)) / tc.cdt)
    chik = conduction_rate(torch, fr, model, fa)
    mag = cfg.module("magnetic")
    dxyz6 = sum(i ** 6 for i in inv)
    # with the shock slot the largest shock diffusivity, ν_sh, D_sh, η_sh
    # or γχ_sh, times the largest shock of the next step's first pre-pass
    shock = 0.0
    if "shock" in model.reg.slots:
        sl = model.reg.slice("shock")
        d_sh, e_sh, c_sh = fr.shock_coefficients(cfg, model.reg)
        vt = cfg.module("viscosity").terms()
        shock = max(vt["nu-shock"], vt["shock-simple"], d_sh, e_sh,
                    eos.gamma * c_sh) * float(
            model._refresh_aux_fa(fa)[sl].max())
    # nu-const's ν, and the largest rate of the other flavours and diffrho
    dif = max(cfg.module("viscosity").terms()["nu-const"],
              visc_rate(torch, model, fa), mag.eta if mag else 0.0, chik,
              ent.chi * eos.gamma if ent is not None and ent.chi_conduction
              else 0.0, shock) \
        * dxyz2 / tc.cdtv \
        + max(fr.hyper3_coefficients(cfg)) * dxyz6 / tc.cdtv3
    check(1.0 / math.hypot(adv_b, dif) * (1 - 1e-5) <= dt_next
          <= 1.0 / max(adv_lo, dif) * (1 + 1e-5),
          f"dt {dt_next} outside the CFL bounds ({adv_lo}-{adv_b}, {dif})")
    u1 = urms(torch, fa)
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    names = fr.zg_kernels(model)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(advective 1/dt {adv:.4e}, with the largest Alfvén speed "
          f"{adv_b:.4e}, diffusive {dif:.4e}), "
          f"urms {u0:.3e} -> {u1:.3e}, launches "
          f"{ {k: counts[k] for k in names} }", flush=True)
    return model, state, ms_step, label


def run_aux_box(torch, pt, fr, smi, shape, launches, label):
    """Phase 3: an aux path (AUX_PATHS): the sheared, rotating box, MHD or
    hydro, with or without the shock slot, or the shocked periodic box,
    MHD or hydro; the card's busy time of one step from torch.profiler."""
    from pencil_tpu_torch.physics.pencils import Pencils
    base = torch.cuda.memory_allocated()
    model = pt.Model(aux_cfg(pt, label, shape), device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches(label, counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (model.reg.nf,) + shape,
          f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    dt = float(state["dt"])
    step = model.make_step()
    busy, nkern = device_busy(torch, lambda: step(state), 3)
    # CFL bounds on the dt that the final state sets (one more step, out
    # of the timed window).  1/dt is the max over points of the root sum
    # of the advective and diffusive rates: at an x face, where |S·x| is
    # largest, both are at least their u = B = 0, shock = 0 values; no
    # point exceeds the sums of the fields' maxima
    dt_next = float(step(state)["dt"])
    cfg, eos = model.cfg, model.eos
    tc, gs = cfg.time, cfg.grid
    inv = [1.0 / d for d in (gs.dx, gs.dy, gs.dz)]
    dxyz2 = sum(i * i for i in inv)
    dxyz6 = sum(i ** 6 for i in inv)
    sdy = model.deltay(state["t"])
    fg = model.ghosted(model._refresh_aux_fa(fa, sdy), shear_dy=sdy)
    pen = Pencils(fg, model.grid, model.reg, cfg, eos, ghosted=True)
    va2, shock = 0.0, 0.0
    # the squared sound speed, cs0² but with ss (γ = 5/3) at each point
    cs2_lo = cs2_hi = eos.cs20
    if "ss" in model.reg.slots:
        cs2 = pen.cs2()
        cs2_lo, cs2_hi = float(cs2.min()), float(cs2.max())
        del cs2
    if "aa" in model.reg.slots:
        bb = pen.bb()
        va2 = float((sum((bb[a] * inv[a]) ** 2 for a in range(3))
                     * pen.rho1()).max())
        del bb
    if "shock" in model.reg.slots:
        shock = float(pen.field("shock").max())
    del fg, pen
    vis, mag = cfg.module("viscosity"), cfg.module("magnetic")
    eta, eta3 = (mag.eta, mag.eta_hyper3) if mag else (0.0, 0.0)
    nu, nu_shock, nu3 = vis.coefficients()
    ent = cfg.module("entropy")
    chig = ent.chi * eos.gamma if ent is not None else 0.0
    # the largest shock diffusivity per unit shock: ν_sh, D_sh, η_sh, γχ_sh
    d_sh, e_sh, c_sh = fr.shock_coefficients(cfg, model.reg)
    nu_shock = max(nu_shock, vis.terms()["shock-simple"], d_sh, e_sh,
                   eos.gamma * c_sh)
    # Viscosity's other flavours and diffrho: their largest rate
    nu = max(nu, visc_rate(torch, model, fa))
    # the shear flow's rate (none under SAFI) and the mesh flavours'
    # constant root join the advective rate
    shear_rate = sheared_rate(model)
    mesh = float(fr.kernel_params(model).hmesh)
    sound = math.sqrt(cs2_lo * dxyz2)
    umax = sum(float(fa[a].abs().max()) * inv[a] for a in range(3))
    adv_lo = (shear_rate * inv[1] + sound + mesh) / tc.cdt
    adv_hi = (umax + shear_rate * inv[1]
              + math.sqrt(cs2_hi * dxyz2 + va2) + mesh) / tc.cdt
    dif3 = max(nu3, eta3,
               cfg.module("density").diffrho_hyper3) * dxyz6 / tc.cdtv3
    dif_lo = max(nu, eta, chig) * dxyz2 / tc.cdtv + dif3
    dif_hi = max(nu, eta, chig, nu_shock * shock) * dxyz2 / tc.cdtv + dif3
    check(1.0 / math.hypot(adv_hi, dif_hi) * (1 - 1e-5) <= dt_next
          <= 1.0 / math.hypot(adv_lo, dif_lo) * (1 + 1e-5),
          f"{label} dt {dt_next} outside the CFL bounds ({adv_lo}-{adv_hi}, "
          f"{dif_lo}-{dif_hi})")
    u1 = urms(torch, fa)
    if model.forcing is not None:
        check(u1 > u0, f"{label} urms did not grow: {u0} -> {u1}")
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(1/dt bounds: advective {adv_lo:.4e}-{adv_hi:.4e}, diffusive "
          f"{dif_lo:.4e}-{dif_hi:.4e}), max shock {shock:.3e}, urms "
          f"{u0:.3e} -> {u1:.3e}, launches per step {PER_STEP[label]}; the "
          "card " + (f"busy {busy:.4f} ms a step in {nkern} kernels "
                     f"(idle {(1 - busy / ms_step) * 100:.1f} %)" if busy
                     else "busy: not measured (torch.profiler recorded "
                     "none)"), flush=True)
    return label, model, state, ms_step


def time_pairs(torch, kname, kern, plain, errs, timings, bounds, inputs,
               fresh=None, library=None):
    """Check one kernel against its plain version, then time both, and
    set its bound from the bytes of ``inputs`` and of its outputs (each
    read or written once) and its operations (OPS) at 256³.  ``fresh``
    gives the (kernel, plain) calls of the check when the timed calls
    update their input in place; ``library`` is one PyTorch call that
    computes the same function, timed as a yardstick where there is
    one."""
    ck, cp = fresh or (kern, plain)
    got, want = ck(), cp()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.ndim == 0:
            r = 0.0 if float(a) == float(b) else abs(float(a) / float(b) - 1)
            check(r <= RTOL_DT, f"{kname} at 256^3: dt rel err {r}")
            continue
        d, r = rel_err(a, b)
        check(r <= RTOL_FIELD, f"{kname} at 256^3: rel err {r}")
        if kname in EXACT:
            check(bool((a == b).all()), f"{kname} at 256^3: not exact")
        note_err(errs, kname, d)
    npts = N_MAIN ** 3
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *got)
                 if t is not None)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = OPS[kname] * npts / PEAK_F32_S * 1e3
    bounds[kname] = (nbytes / npts, max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    del got, want
    timings[kname] = (time_ms(torch, kern, 20),
                      time_ms(torch, plain, PLAIN_CALLS, warm=False),
                      library and time_ms(torch, library, 20))
    print(f"phase 4 {kname} at 256^3: kernel {timings[kname][0]:.4f} ms,"
          f" plain {timings[kname][1]:.4f} ms, library call "
          f"{timings[kname][2] and round(timings[kname][2], 4)} ms, bound "
          f"{bounds[kname][1]:.4f} ms ({bounds[kname][2]}: "
          f"{bounds[kname][0]:.2f} B and {OPS[kname]} operations per point)",
          flush=True)


def time_flagship(torch, fr, smi, fl, errs, timings, bounds, label=None):
    """K1-K3, or K1h-K3h, checked and timed on the main path's final
    state, and the plain chain's step; ``label`` names a path outside
    TEMPLATE_PATHS."""
    model, state, ms_step = fl
    sfx = fr.launch_suffix(model)
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    zc = model.grid.z
    df1, _ = fr.rhs_first_plain(model, fa)
    df2, f2 = fr.rhs_tail_defer_plain(model, fa, df1, c2)
    calls = {
        "rhs_first": (lambda: fr.rhs_first(model, fa),
                      lambda: fr.rhs_first_plain(model, fa), [fa]),
        "rhs_tail_defer": (lambda: fr.rhs_tail_defer(model, fa, df1, c2),
                           lambda: fr.rhs_tail_defer_plain(model, fa, df1, c2),
                           [fa, df1, c2]),
        "rhs_tail_last": (
            lambda: fr.rhs_tail_last(model, f2, df2, c3, kick),
            lambda: fr.rhs_tail_last_plain(model, f2, df2, c3, kick),
            [f2, df2, c3, kick, zc]),
    }
    for kname, (kern, plain, inputs) in calls.items():
        time_pairs(torch, kname + sfx, kern, plain, errs, timings, bounds,
                   inputs)
    del df1, df2, f2
    plain_chain = (fr.rhs_first_plain, fr.rhs_tail_defer_plain,
                   fr.rhs_tail_mid_plain, fr.rhs_tail_last_plain,
                   fr.rhs_tail_defer_last_plain)
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(
        torch, lambda: model._fused_step(plain_state, plain_chain),
        PLAIN_CALLS, warm=False)
    name = label or {v: k for k, v in TEMPLATE_PATHS.items()}[sfx]
    print(f"phase 4 {name} plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step)", flush=True)


def time_tails(torch, fr, fl, errs, timings, bounds):
    """K3′, K2L and K8's three variants (K3′h and K2Lh) checked and timed
    on the flagship's (forced hydro's) final state."""
    model, state, _ = fl
    sfx = fr.launch_suffix(model)
    fa = state["_fa"]
    _, beta, _ = model.rk
    dt_t = state["dt"]
    coef = torch.stack((model._alpha[2], beta[2] * dt_t, beta[1] * dt_t))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    zc = model.grid.z
    df1, _ = fr.rhs_first_plain(model, fa)
    # K3′ writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, "rhs_tail_mid" + sfx,
        lambda: fr.rhs_tail_mid(model, fa, scratch, coef),
        lambda: fr.rhs_tail_mid_plain(model, fa, scratch, coef), errs,
        timings, bounds, [fa, df1, coef],
        fresh=(lambda: fr.rhs_tail_mid(model, fa, df1.clone(), coef),
               lambda: fr.rhs_tail_mid_plain(model, fa, df1.clone(), coef)))
    del scratch
    calls = {
        "rhs_tail_defer_last": (
            lambda: fr.rhs_tail_defer_last(model, fa, df1, coef, kick),
            lambda: fr.rhs_tail_defer_last_plain(model, fa, df1, coef, kick),
            [fa, df1, coef, kick, zc]),
        "rhs_first_fake": (
            lambda: fr.rhs_first(model, fa, fake=True),
            lambda: fr.rhs_first_plain(model, fa, fake=True), [fa],
            # its function, f·1.0000001, is one PyTorch call
            lambda: torch.mul(fa, fr.FAKE_FACTOR)),
        "rhs_tail_defer_fake": (
            lambda: fr.rhs_tail_defer(model, fa, df1, coef, fake=True),
            lambda: fr.rhs_tail_defer_plain(model, fa, df1, coef, fake=True),
            [fa, df1, coef]),
        "rhs_tail_last_fake": (
            lambda: fr.rhs_tail_last(model, fa, df1, coef, kick, fake=True),
            lambda: fr.rhs_tail_last_plain(model, fa, df1, coef, kick,
                                           fake=True),
            [fa, df1, coef, kick, zc]),
    }
    if sfx:      # K8 is built for the isothermal MHD layout only
        calls = {"rhs_tail_defer_last" + sfx: calls["rhs_tail_defer_last"]}
    for kname, (kern, plain, inputs, *library) in calls.items():
        time_pairs(torch, kname, kern, plain, errs, timings, bounds, inputs,
                   library=library[0] if library else None)


def time_conv_slab(torch, fr, smi, zg, errs, timings, bounds, full=True):
    """K6/K7 (K6m/K7m; their CHI or H3 instances; K6s/K7s, K6ms/K7ms)
    checked and timed on the stratified noisy input of phase 2 at 256³
    (``zg_input``), not on the main path's state: there uz's tendency is
    the small residual of the O(1) pressure and gravity forces, and the
    f32 rounding of those forces alone reaches 2e-5 of its max.  With
    ``full`` then the Coriolis and chi-const instances in turns with these
    (``time_zg_instances``) and the step's split (``print_split``)."""
    model, state, ms_step, label = zg
    first, upd = fr.zg_kernels(model)
    first_p, upd_p = fr.zg_plain(model)
    fa = state["_fa"]
    inp = zg_input(torch, model, 3)
    _, beta, _ = model.rk
    df1, dt1m = first_p(model, *inp)
    coef = torch.stack((model._alpha[1], beta[1] / dt1m))
    prof = fr.zg_profiles(model)
    time_pairs(torch, first, lambda: fr.rhs_zg(model, *inp),
               lambda: first_p(model, *inp), errs, timings, bounds,
               [*inp, *prof])
    # K7 writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, upd,
        lambda: fr.rhs_zg_upd(model, *inp, scratch, coef),
        lambda: upd_p(model, *inp, scratch, coef), errs,
        timings, bounds, [*inp, *prof, df1, coef],
        fresh=(lambda: fr.rhs_zg_upd(model, *inp, df1.clone(), coef),
               lambda: upd_p(model, *inp, df1.clone(), coef)))
    del df1, scratch, inp
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(torch, lambda: model._zghost_step(
        plain_state, (first_p, upd_p)), PLAIN_CALLS, warm=False)
    print(f"phase 4 {label} plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step)", flush=True)
    if not full:
        return
    time_zg_instances(torch, fr, smi, model)
    print_split(torch, fr, smi, zg)


def print_split(torch, fr, smi, zg):
    """A conv-slab path's step split: its kernels, its three z-halo
    fills, with Shear its three x/y fills with the shifted faces, the
    boundary-plane writeback, forced the kick, and the glue (the axpy,
    dt, the RK coefficients), on the card and on the host, from one
    torch.profiler trace (``conv_slab_split``)."""
    model, state, ms_step, label = zg
    dev, host, lost = conv_slab_split(torch, fr, model, state, 3)
    busy = sum(d for d, _ in dev.values())
    head = f"phase 4 {label} step split at 256^3 on {smi} (3 steps)"
    if not busy:
        print(f"{head}: device time not measured (torch.profiler recorded "
              f"none)", flush=True)
        return
    print(f"{head}: device ms a step from torch.profiler's records under "
          f"each part's range, in so many kernels a step, and the host's "
          f"ms to issue the part (perf_counter, a run without the "
          f"profiler): "
          + "; ".join(f"{k} {d:.4f} ms in {c:g} kernels, host {host[k]:.4f}"
                      for k, (d, c) in dev.items())
          + f"; the card busy {busy:.4f} ms of the {ms_step:.4f} ms step "
          f"(idle {(1 - busy / ms_step) * 100:.1f} %), the host "
          f"{host['step']:.4f} ms to issue it"
          + (f"; {lost} device records matched no launch" if lost else ""),
          flush=True)


def in_turns(torch, variants, kernels):
    """ms of each kernel of each variant, timed in turns kernel by kernel:
    the variants in order, then in reverse (A, B, ..., B, A), 20 launches
    a turn, so that a variant and the one it is compared with run close
    in time.  ``variants``: label -> model; ``kernels``: name ->
    fn(model).  Returns {(name, label): [ms, ms]}."""
    order = list(variants) + list(variants)[::-1]
    times = {}
    for name, fn in kernels.items():
        for label in order:
            times.setdefault((name, label), []).append(
                time_ms(torch, lambda: fn(variants[label]), 20))
    return times


def print_turns(head, times):
    print(f"{head}, in turns: " + "; ".join(
        f"{name} {label}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
        for (name, label), ts in times.items()), flush=True)


def time_zg_turns(torch, fr, smi, sheared, parent):
    """K6s/K7s (K6ms/K7ms) of the sheared path ``sheared`` timed in turns
    with K6/K7 (K6m/K7m) of its unsheared ``parent`` path, each on its own
    stratified input at 256³; phase 2 and time_conv_slab check them
    against their plain versions."""
    variants, inputs = {}, {}
    for model, _, _, label in (sheared, parent):
        inp = zg_input(torch, model, 3)
        df1, dt1m = fr.zg_plain(model)[0](model, *inp)
        coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
        variants[label], inputs[model] = model, (inp, df1, coef)
    times = in_turns(torch, variants, {
        "K6": lambda m: fr.rhs_zg(m, *inputs[m][0]),
        "K7": lambda m: fr.rhs_zg_upd(m, *inputs[m][0], *inputs[m][1:])})
    print_turns(f"phase 4 {sheared[3]} against {parent[3]} at 256^3 on "
                f"{smi}", times)


def time_zg_instances(torch, fr, smi, model):
    """The Coriolis, chi-const and H3 instances of ``model``'s z-ghosted
    build (its configuration with Ω = 1, with χ = CHI, with both, with
    del6, with all three) timed against the plain ones on one stratified
    input at 256³, in turns; phase 2 checks them against their plain
    versions."""
    cfg = model.cfg

    import pencil_tpu_torch.configs as pc
    magnetic = cfg.module("magnetic") is not None

    def variant(Omega, chi, hyper3=False):
        return type(model)(pc.conv_slab(cfg.grid.shape, magnetic=magnetic,
                                        Omega=Omega, chi=chi, hyper3=hyper3),
                           device="cuda")

    variants = {"Omega = 0": model, "Omega = 1": variant(1.0, 0.0),
                f"chi = {CHI:g}": variant(0.0, CHI),
                f"Omega = 1, chi = {CHI:g}": variant(1.0, CHI),
                "del6": variant(0.0, 0.0, True),
                f"Omega = 1, chi = {CHI:g}, del6": variant(1.0, CHI, True)}
    first, upd = fr.zg_kernels(model)
    inp = model.z_slabs(stratified_fa(torch, model, 3))
    df1, dt1m = fr.rhs_zg_plain(model, *inp)
    coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
    times = in_turns(torch, variants, {
        first: lambda m: fr.rhs_zg(m, *inp),
        upd: lambda m: fr.rhs_zg_upd(m, *inp, df1, coef)})
    print_turns(f"phase 4 {first}, {upd} and their Coriolis, chi-const "
                f"and del6 instances at 256^3 on {smi}", times)


def time_gravity_turns(torch, fr, smi, label, path, other, base):
    """K1, K2 and K3 with the kick of a periodic path under gravity timed
    in turns (A, B, B, A) with the same instances launched by its
    counterpart without gravity ``base`` (a null g_z), both on the
    gravity path's final state at 256³; phase 2 and 2b check them against
    their plain versions."""
    model, state, _ = path
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    df1, _ = fr.rhs_first_plain(model, fa)
    times = in_turns(torch, {label: model, other: base[0]}, {
        "K1": lambda m: fr.rhs_first(m, fa),
        "K2": lambda m: fr.rhs_tail_defer(m, fa, df1, c2),
        "K3 kick": lambda m: fr.rhs_tail_last(m, fa, df1, c3, kick)})
    print_turns(f"phase 4 {label} (g_z read) against {other} (no gravity) "
                f"at 256^3 on {smi}", times)


def time_term_turns(torch, fr, smi, label, path, other, base):
    """K1, K2 and K3 (with the kick where the path kicks) of a periodic
    path with B_ext, the continuous forcing or the upwinding (its UPW
    instances) timed in turns (A, B, B, A) with the instances launched by
    its counterpart without the term ``base`` (B_ext = 0, a null fcont, no
    lupw flag), both on the path's final state at 256³, and the byte
    bound of each: the field fcont adds 12 B a point to what a kernel
    reads; phase 2 and 2b check them against their plain versions."""
    model, state, _ = path
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos) \
        if model.forcing is not None else None
    df1, _ = fr.rhs_first_plain(model, fa)
    times = in_turns(torch, {label: model, other: base[0]}, {
        "K1": lambda m: fr.rhs_first(m, fa),
        "K2": lambda m: fr.rhs_tail_defer(m, fa, df1, c2),
        "K3": lambda m: fr.rhs_tail_last(m, fa, df1, c3, kick)})
    print_turns(f"phase 4 {label} against {other} at 256^3 on {smi}", times)
    fcont = fr.fcont_tensor(model)
    extra = 0 if fcont is None else fcont.numel() * fcont.element_size()
    npts = fa[0].numel()
    word = fa.element_size() * fa.shape[0]
    # bytes a point: K1 reads f, writes df; K2 reads f and df1, writes df2
    # and f2; K3 reads f and df2, writes f3
    for name, nbuf in (("K1", 2), ("K2", 4), ("K3", 3)):
        nbytes = nbuf * word * npts + extra
        print(f"phase 4 {label} {name} at 256^3 on {smi}: bytes bound "
              f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms ({nbytes / npts:.2f} "
              "B a point), in turns " + ", ".join(
                  f"{t:.4f}" for t in times[(name, label)]) + " ms",
              flush=True)


def time_h3_instances(torch, pt, fr, smi, path):
    """The H3 instances of a periodic build, each kernel kind with and
    without Ω = 1, timed against the same instances without H3 on the
    main path's final state at 256³, in turns; phase 2 checks them
    against their plain versions."""
    model, state, _ = path
    name = {v: k for k, v in TEMPLATE_PATHS.items()}[fr.launch_suffix(model)]
    base = name[:-3]
    variants = {f"{v}Omega = {om:g}": pt.Model(template_cfg(
        pt, base + h3, model.cfg.grid.shape, Omega=om), device="cuda")
        for om in (0.0, 1.0) for h3, v in (("", ""), (" h3", "h3, "))}
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, beta[1] * dt_t))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    df1, _ = fr.rhs_first_plain(model, fa)
    scratch = df1.clone()
    times = in_turns(torch, variants, {
        "K1": lambda m: fr.rhs_first(m, fa),
        "K2": lambda m: fr.rhs_tail_defer(m, fa, df1, c2),
        "K3 kick": lambda m: fr.rhs_tail_last(m, fa, df1, c3, kick),
        "K3'": lambda m: fr.rhs_tail_mid(m, fa, scratch, c3),
        "K2L kick": lambda m: fr.rhs_tail_defer_last(m, fa, df1, c3, kick)})
    print_turns(f"phase 4 {base} kernels with and without H3 at 256^3 on "
                f"{smi}", times)


def zg_parts(model):
    """The conv-slab step's parts: the step's call -> its name in the
    split (K6/K7, with aa K6m/K7m, with Shear K6s/K7s or K6ms/K7ms and
    the x/y fills with the shifted faces, with the shock slot K6k/K7k or
    K6mk/K7mk and the shock pre-passes, forced the kick)."""
    sfx = ("m" if "aa" in model.reg.slots else "") + (
        "s" if model.zg_xy else "") + (
        "i" if "ss" not in model.reg.slots else "") + (
        "k" if "shock" in model.reg.slots else "")
    parts = {"rhs_zg": "K6" + sfx, "rhs_zg_upd": f"K7{sfx} x2",
             "z_slabs": "z_slabs x3", "bc_writeback": "bc_writeback"}
    if "shock" in model.reg.slots:
        parts["_refresh_aux_fa"] = "shock pre-pass x3"
    if model.zg_xy:
        parts["ghosted"] = "x/y fills x3"
    if model.forcing is not None:
        parts["_kick_after"] = "kick"
    if model.safi:
        parts["_safi_shift"] = "SAFI shift x3"
    return parts


def conv_slab_split(torch, fr, model, state, n):
    """The conv-slab step from ``state`` split into its parts
    (``zg_parts``), each under a torch.profiler range: ({part: (device ms,
    kernels)}, {part: host ms}, device records whose launch was not
    found), each a step's mean over n steps.  A device record belongs to
    the innermost range in which the host launched it (the runtime call
    that shares its correlation id, else the op it is linked to); "glue"
    (the axpy, dt, RK coefficients, the copy of the input) is what the
    step's range launched outside every part.  Of ``Model.ghosted``'s
    calls only the x/y fills with shifted faces are a part of their own
    (``bc_writeback`` fills its axis through it too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    names = zg_parts(model)
    parts = list(names.values())
    spent = dict.fromkeys(parts + ["step"], 0.0)

    def ranged(name, fn, when=None):
        def run(*a):
            if when is not None and not when(*a):
                return fn(*a)
            t0 = time.perf_counter()
            with record_function(name):
                out = fn(*a)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    # instance attributes shadow the methods that _zghost_step calls
    methods = [m for m in ("z_slabs", "bc_writeback", "ghosted",
                           "_kick_after", "_refresh_aux_fa", "_safi_shift")
               if m in names]
    for m in methods:
        setattr(model, m, ranged(names[m], getattr(model, m), (
            lambda fa, axes=(0, 1, 2), sdy=None: tuple(axes) == (0, 1))
            if m == "ghosted" else None))
    kernels = (ranged(names["rhs_zg"], fr.rhs_zg),
               ranged(names["rhs_zg_upd"], fr.rhs_zg_upd))
    step = ranged("step", lambda: model._zghost_step(state, kernels))
    try:
        step()
        torch.cuda.synchronize()
        spent.update(dict.fromkeys(spent, 0.0))
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        host = {k: v * 1e3 / n for k, v in spent.items()}
        host["glue"] = host["step"] - sum(host[k] for k in parts)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    finally:
        for m in methods:
            delattr(model, m)
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
              if e.name in spent]
    runtime = {e.id: e.time_range.start for e in cpu
               if e.name.startswith("cu")}
    ops = {e.id: e.time_range.start for e in cpu
           if not e.name.startswith("cu")}
    dev = {k: [0.0, 0] for k in parts + ["glue"]}
    lost = 0
    for e in device_records(torch, events):
        t = runtime.get(e.id,
                        ops.get(getattr(e, "linked_correlation_id", 0)))
        inner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        if not inner:
            lost += 1
            continue
        name = min(inner, key=lambda r: r[1] - r[0])[2]
        d = dev["glue" if name == "step" else name]
        d[0] += e.device_time_total / 1e3 / n
        d[1] += 1 / n
    return {k: tuple(v) for k, v in dev.items()}, host, lost


def device_records(torch, events):
    """The device's kernel, copy and fill records among torch.profiler's
    events (without the ranges it mirrors on the device)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(torch, fn, n):
    """(ms of device time per call, kernels per call) of fn() over n
    calls, from torch.profiler's kernel records; (0, 0) where it records
    none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = device_records(torch, prof.events())
    busy = sum(e.device_time_total for e in kernels)
    return busy / 1e3 / n, len(kernels) // n


def aux_kernel_inputs(torch, fr, model, state):
    """(first, update, their plain versions, input, df1, coef) of an aux
    path's kernels on its final state, its shock slot rebuilt (and, for
    the shear boxes, its x/y ghosts filled) as a step does."""
    fa = state["_fa"]
    if model.mode == "zroll":
        kern = (fr.rhs_zroll, fr.rhs_zroll_upd, fr.rhs_zroll_plain,
                fr.rhs_zroll_upd_plain)
        sdy = model.deltay(state["t"])
        fg = model.ghosted(model._refresh_aux_fa(fa, sdy), (0, 1), sdy)
    else:
        kern = (fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd,
                fr.rhs_wrap_shock_plain, fr.rhs_wrap_shock_upd_plain)
        fg = model._refresh_aux_fa(fa)
    df1, dt1m = kern[2](model, fg)
    coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
    return (*kern, fg, df1, coef)


def time_aux_box(torch, fr, smi, box, errs, timings, bounds):
    """K4/K5 (shear box), K1s/K5w (shock box) or those of their other
    layouts (the instances that the path launches: UPW, SHK) checked and
    timed on the main path's final state, then the plain chain's step and
    the parts of the step around the kernels."""
    label, model, state, ms_step = box
    fa = state["_fa"]
    names = fr.aux_kernels(model)
    first, upd, first_p, upd_p, fg, df1, coef = aux_kernel_inputs(
        torch, fr, model, state)
    sdy = model.deltay(state["t"])
    time_pairs(torch, names[0], lambda: first(model, fg),
               lambda: first_p(model, fg), errs, timings, bounds, [fg])
    # K5/K5w write the new df over df_prev: checked on fresh copies of
    # df1, timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, names[1], lambda: upd(model, fg, scratch, coef),
        lambda: upd_p(model, fg, scratch, coef), errs, timings, bounds,
        [fg, df1, coef],
        fresh=(lambda: upd(model, fg, df1.clone(), coef),
               lambda: upd_p(model, fg, df1.clone(), coef)))
    del df1, scratch, fg
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(torch, lambda: model._aux_step(
        plain_state, (first_p, upd_p)), PLAIN_CALLS, warm=False)
    line = (f"phase 4 {label} plain chain at 256^3 on {smi}: "
            f"{plain_ms:.4f} ms/step (kernel chain {ms_step:.4f} ms/step)")
    if model.reg.nf > model.reg.nvar:
        from pencil_tpu_torch.physics.pencils import Pencils
        aux_ms = time_ms(torch, lambda: model._refresh_aux_fa(fa, sdy), 20)
        # the pre-pass's two largest parts: its full ghost fill and ∇·u
        fill3_ms = time_ms(torch, lambda: model.ghosted(fa, shear_dy=sdy),
                           20)
        fg = model.ghosted(fa, shear_dy=sdy)
        divu_ms = time_ms(torch, lambda: Pencils(
            fg, model.grid, model.reg, model.cfg, model.eos,
            ghosted=True).divu(), 20)
        del fg
        line += (f"; one shock pre-pass {aux_ms:.4f} ms, of which its "
                 f"{model.reg.nf}-slot ghost fill {fill3_ms:.4f} ms and the "
                 f"divergence {divu_ms:.4f} ms")
    if sdy is not None:
        fill_ms = time_ms(torch, lambda: model.ghosted(fa, (0, 1), sdy), 20)
        line += f", one x/y fill with shifted faces {fill_ms:.4f} ms"
    print(line, flush=True)


def time_aux_turns(torch, fr, smi, box, other):
    """The first and update kernel of a new aux build timed in turns (A,
    B, B, A, 20 launches a turn) with those of its MHD or shock-slot
    counterpart ``other``, each on its own path's final state at 256³;
    phase 2 and time_aux_box check them against their plain versions."""
    paths = {}
    for label, model, state, _ in (box, other):
        first, upd, _, _, fg, df1, coef = aux_kernel_inputs(
            torch, fr, model, state)
        names = fr.aux_kernels(model)
        paths[label] = ((names[0], lambda m=model, g=fg, k=first: k(m, g)),
                        (names[1], lambda m=model, g=fg, d=df1, c=coef,
                         k=upd: k(m, g, d, c)))
    order = [box[0], other[0], other[0], box[0]]
    times = {}
    for kind in (0, 1):
        for label in order:
            name, fn = paths[label][kind]
            times.setdefault(name, []).append(time_ms(torch, fn, 20))
    print(f"phase 4 {box[0]} against {other[0]} at 256^3 on {smi}, in "
          f"turns ({box[0]}, {other[0]}, {other[0]}, {box[0]}): "
          + "; ".join(f"{name} " + ", ".join(f"{t:.4f}" for t in ts)
                      + " ms" for name, ts in times.items()), flush=True)


def time_prepass_turns(torch, smi, box, other):
    """The shock pre-pass of the aux path ``box`` (the 'highorder'
    profile) timed in turns (A, B, B, A, 20 calls a turn) with that of
    ``other`` (the 'original' one), each on its own path's final state at
    256³."""
    paths = {label: (model, state) for label, model, state, _ in (box, other)}
    times = {}
    for label in (box[0], other[0], other[0], box[0]):
        model, state = paths[label]
        times.setdefault(label, []).append(time_ms(
            torch, lambda: model._refresh_aux_fa(state["_fa"]), 20))
    print(f"phase 4 the shock pre-pass of {box[0]} against {other[0]} at "
          f"256^3 on {smi}, in turns: " + "; ".join(
              f"{label} " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
              for label, ts in times.items()), flush=True)


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        # a failure stops the nvcc runs still going
        build = sys.modules.get("pencil_tpu_torch.ops._build")
        if build is not None:
            build.cancel()
    sys.exit(rc)
