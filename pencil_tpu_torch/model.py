"""Model assembly and the time step (counterpart of ``pencil_tpu/model.py``).

These module sets run as chains of fused kernels, f32, at any 2N-RK order
of ``RK_TABLES`` (1-4; dt comes from substep 1 and serves every substep):

* The flagship — ideal-gas EOS, lnρ density, hydro (with optional
  Coriolis), 'nu-const' viscosity, resistive-gauge magnetic, optional
  helical forcing — on a fully periodic grid, as the JAX package's wrap
  mode (model.py:650-703): K1 evaluates df1 = RHS(f0) and the CFL maximum
  (dt stays on the device); then

    order 1: a torch axpy, and the forcing kick after the step;
    order 2: K2L: f = f1 + β₁Δt·(α₁df1 + RHS(f1)) with f1 = f0 + β₀Δt·df1
             rebuilt from raw f0 and df1, and the kick;
    order 3: K2 (the rebuilt f1, writes df2 and f2), then K3 with the kick;
    order 4: K2, K3′ twice (df ← α·df + RHS(f), f ← f + βΔt·df), K3.

  ``Model(..., fake_rhs=True)`` runs K8 in place of K1-K3 (order 3 with a
  fixed ``TimeSpec.dt`` only: K8 reports no CFL rate): the same loads and
  stores with RHS(f) = f·1.0000001, the memory floor of the chain, wrong
  physics by design.

* Forced hydro turbulence — the flagship without magnetic (``configs.
  forced_hydro``), forcing and Coriolis optional — on the same chain of
  the same template built for 4 fields (uu, lnρ): K1h, then K2Lh, K2h and
  K3h, or K2h, 2×K3′h and K3h, by order (the wrappers pick the library by
  the field layout, so the chain is one code path).

* Non-isothermal forced turbulence — either of the two sets above with
  an entropy field (``configs.forced_entropy``: γ ≠ 1, 'chi-const' or
  'K-const' conduction, viscous and Ohmic heating; no layer profiles) — on
  the same chain of the template built for 8 fields (uu, lnρ, s, A: K1e,
  K2e, K3e, K3′e, K2Le) or 5 (uu, lnρ, s: K1he … K2Lhe).

  Each of these four sets may add del6 hyper-diffusion ('hyper3-simplified'
  viscosity, η₃, D₃): the wrappers then launch the H3 instances of the
  same kernels.  Every set of every chain may add Magnetic's imposed
  field B_ext (its MHD sets) and Forcing's continuous forcing
  (``lforcing_cont``): every kernel but K8 adds B_ext to B = ∇×A and the
  profile, a device field built once a model, to du/dt.  Each may add
  Gravity, any of its z profiles, as may the aux sets below: 'sin-z' has
  a periodic hydrostatic state, so a triply periodic box holds a
  stratified layer (``configs.strat_box(n, periodic=True,
  shear=False)``).  Every kernel but K8's reads g_z(z) as a vector.

* Stratified convection — the EOS with an entropy slot, lnρ density,
  hydro (with optional Coriolis), gravity, 'nu-const' viscosity,
  entropy, and magnetoconvection, the same with resistive-gauge magnetic —
  with a non-periodic z axis, as the JAX package's zghost mode
  (model.py:704-775, :891): a z-only ghost fill cuts the z-halo slabs
  (``z_slabs``) for K6 (df1 and the CFL maximum), which wraps x and y
  itself, f1 = f0 + β₀Δt·df1 as a torch axpy; then per substep
  ``z_slabs`` and K7 (df ← α·df + RHS(f), f ← f + βΔt·df); then
  ``bc_writeback`` pins the boundary planes that value-setting BCs fix.
  With Magnetic the wrappers launch K6m and K7m, the 8-field build; with
  'chi-const' conduction beside K-const either build's CHI instances, and
  with del6 hyper-diffusion ('hyper3-simplified', η₃, D₃) its H3
  instances.  With Shear (the stratified shearing box) the kernels are
  K6s/K7s and K6ms/K7ms, which read the stack ghosted in x and y with the
  x faces shifted by deltay at t0 + c·dt (``zg_input``) and the z slabs
  of that stack.  With forcing (forced convection) the kick follows the
  writeback, as JAX's ``after_timestep`` gives it.  The isothermal
  stratified layer — the flagship's or forced hydro's modules under
  gravity, with or without Shear (the stratified isothermal shearing
  box, the MRI box with Magnetic) — runs the same chain on the builds
  without ss: K6i/K7i, K6mi/K7mi, K6si/K7si and K6msi/K7msi.  Every
  z-ghosted build reads g_z(z) as a vector, so any z profile of Gravity
  runs on each (the stratified shearing box with an energy equation,
  ``configs.strat_box(n, entropy=True)``, g_z = −Ω²z on K6ms/K7ms), and
  each of these sets runs without Gravity too (g_z = 0: unstratified
  boxes between z walls).  Stratified convection and magnetoconvection
  with the Shock module's slot (``configs.conv_slab(n, shock=True)``:
  'nu-shock', optionally the shock diffusivities, chi-const, Ω, forcing
  and upwinding; its bcz gives the slot a code) rebuild the slot before
  each kernel, as the aux chains below do (its z ghosts by that code, the
  pre-pass's own fill by bc_sym), and run K6k/K7k and K6mk/K7mk, which
  read it with its z slabs; without a bcz code for the slot the model is
  refused (the JAX package's fused and jnp paths fill its ghosts
  differently there).  Every z-ghosted set with ss takes Entropy's
  other conduction and cooling terms ('K-profile', 'kramers' and
  'chi-cspeed' conduction, one CHI-instance flavour at a time, Newtonian
  cooling, uniform heating and cooling, the cooling layer's five
  profiles) on the instances it runs; the other sets refuse them.

* The sheared, rotating MHD box with shock viscosity and hyper-diffusion
  — the flagship's modules with Coriolis, 'nu-shock' and
  'hyper3-simplified' viscosity, hyper-resistivity and lnρ
  hyper-diffusion, plus Shear and Shock, optional forcing — on a fully
  periodic grid whose x faces are shear-periodic, as the JAX package's
  zroll mode (model.py:576-730): each substep runs the shock pre-pass
  (``_refresh_aux_fa``) and ``fill_ghosts`` in x and y with the
  Fourier-shifted x faces, then K4 (and a torch axpy) or K5; the forcing
  kick follows the step, as JAX's ``after_timestep`` gives it.

* The shocked periodic box — the same modules without Shear, with
  optional forcing — on a plain periodic grid, as the JAX package's wrap
  mode with an aux module (model.py:433-445, :704-730): each substep runs
  the shock pre-pass, then K1s (and a torch axpy) or K5w, which fetch
  their halos by index wrap (no ghost fill); the forcing kick follows the
  step.

  Both chains take the other isothermal layouts of these sets, each on a
  build of its own: the shocked box without Magnetic (supersonic hydro
  turbulence: K1sh, K5wh), the shear box without the shock slot (K4n,
  K5n), and the hydro shear box with and without it (K4h, K5h; K4hn,
  K5hn); and all four of those with an entropy field: the three hydro
  ones (K1she, K5whe; K4he, K5he; K4hne, K5hne) and the MHD ones (the
  shocked box: K1se, K5wse; the shear box with and without the shock
  slot: K4e, K5e; K4ne, K5ne).  Without the shock slot a substep has no
  pre-pass.

The shear sets of the zroll and zghost chains take SAFI (Shear's
``lshearadvection_as_shift``, JAX model.py:809-822): their kernels run
with the shear flow's x nodes at 0, so that the RHS holds no −S x ∂f/∂y
and the CFL no |S x|/Δy, and after each substep ``_safi_shift`` moves the
evolved fields (and the df carry, but after the last substep) by the
flow over that substep's time, a Fourier phase (``Shear.
shift_advection``, torch.fft on the card); the shock slot is rebuilt from
the shifted state.  Every H3 instance takes the mesh flavour of del6
('hyper3-mesh' viscosity, ``diffrho_hyper3_mesh``) on u and lnρ, each
field with weights of its own.  Hydro's ``lremove_mean_momenta`` runs on
every chain after the writeback and before the kick (JAX's after-step
hooks, Hydro before Forcing): the flagship chain's last kernel then does
not kick, and the kick follows the removal.

``fused_gate`` decides whether a configuration runs one of the chains.  On
a CUDA device a configuration outside the gate raises; on the CPU it runs
the eager 2N-RK path built from the same plain module code (the
counterpart of the JAX package's jnp path).  A model runs on the card
unless the caller passes ``device="cpu"``; with no card it raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.config import Config
from .core.device import require_device
from .core.farray import Registry
from .core.grid import make_grid
from .integrate.timestep import RK_TABLES
from .ops.boundary import (BC_REGISTRY, COLUMN_CODES, DEEP_CODES,
                           ENTROPY_CODES, FORCE_BOUND, REFUSED, bc_sym)
from .ops.fused_rhs import (hyper3_terms, rhs_first, rhs_plain,
                            rhs_tail_defer, rhs_tail_defer_last,
                            rhs_tail_last, rhs_tail_mid, rhs_wrap_shock,
                            rhs_wrap_shock_upd, rhs_zg, rhs_zg_upd,
                            rhs_zroll, rhs_zroll_upd, upwind_flags,
                            viscosity_refusals, zg_entropy_options)
from .ops.stencil import NGHOST
from .parallel.halo import fill_ghosts
from .physics.base import ModuleBase
from .physics.forcing import FCONT_PROFILES
from .physics.pencils import Pencils

# Fixed RHS evaluation order (reference calc_all_pencils order,
# src/equ.f90:766-814).
MODULE_ORDER = (
    "eos", "density", "hydro", "hydro_kinematic", "gravity", "shear",
    "viscosity", "magnetic", "pscalar", "cosmicray", "dust", "neutrals",
    "chemistry", "chiral", "polymer", "heatflux", "lorenz_gauge", "ascalar",
    "interstellar", "radiation", "entropy", "temperature", "testfield",
    "border", "forcing", "initial_condition", "shock",
)

# f-array slot order — the reference's registration sequence (uu, lnrho,
# ss, aa, ...), so the stacked state lines up with the JAX package's.
REGISTRATION_ORDER = (
    "hydro", "density", "entropy", "temperature", "magnetic", "pscalar",
    "cosmicray", "dust", "neutrals", "chemistry", "chiral", "polymer",
    "heatflux", "lorenz_gauge", "ascalar", "testfield",
)

# the module sets the fused kernels implement: the flagship and forced hydro
# (forcing and gravity are optional) on a fully periodic grid, stratified
# convection and magnetoconvection, with or without Shear or Shock, with z
# non-periodic and x, y periodic (forcing and gravity are optional), and
# the shearing box and the shocked box (forcing and gravity are optional)
# on a fully periodic grid; Magnetic's B_ext and Forcing's continuous
# forcing ride on every set as terms of the template
HYDRO_MODULES = frozenset(("eos", "density", "hydro", "viscosity"))
FLAGSHIP_MODULES = HYDRO_MODULES | {"magnetic"}
# the same two with an entropy field (non-isothermal turbulence)
ENT_HYDRO_MODULES = HYDRO_MODULES | {"entropy"}
ENT_MHD_MODULES = FLAGSHIP_MODULES | {"entropy"}
WRAP_SETS = (FLAGSHIP_MODULES, HYDRO_MODULES, ENT_MHD_MODULES,
             ENT_HYDRO_MODULES)
CONVSLAB_MODULES = frozenset(("eos", "density", "hydro", "gravity",
                              "viscosity", "entropy"))
# stratified convection and magnetoconvection, and the isothermal
# stratified layer, hydro and MHD, each also in a shearing box (Ω and
# forcing optional in all)
ENT_ZGHOST_SETS = (CONVSLAB_MODULES, CONVSLAB_MODULES | {"magnetic"},
                   CONVSLAB_MODULES | {"shear"},
                   CONVSLAB_MODULES | {"magnetic", "shear"})
ISO_ZGHOST_SETS = tuple(base | {"gravity"} | shear
                        for base in (HYDRO_MODULES, FLAGSHIP_MODULES)
                        for shear in (set(), {"shear"}))
# stratified convection and magnetoconvection with the Shock module's
# slot: ν_sh and the shock diffusivities between walls (Ω and forcing
# optional)
SHOCK_ZGHOST_SETS = (CONVSLAB_MODULES | {"shock"},
                     CONVSLAB_MODULES | {"magnetic", "shock"})
ZGHOST_SETS = ENT_ZGHOST_SETS + ISO_ZGHOST_SETS + SHOCK_ZGHOST_SETS
# the same with Gravity optional: a z-walled set without it runs the
# z-ghosted chain with g_z = 0 (unstratified boxes between walls)
ZGHOST_FREE_SETS = tuple(s - {"gravity"} for s in ZGHOST_SETS)
# the shearing box, MHD or hydro, each with or without the shock slot, and
# the shocked periodic box, MHD or hydro (forcing optional in all; each
# also with an entropy field)
ZROLL_SETS = tuple(base | {"shear"} | shock
                   for base in (FLAGSHIP_MODULES, HYDRO_MODULES,
                                ENT_HYDRO_MODULES, ENT_MHD_MODULES)
                   for shock in ({"shock"}, set()))
SHOCKBOX_SETS = (FLAGSHIP_MODULES | {"shock"}, HYDRO_MODULES | {"shock"},
                 ENT_HYDRO_MODULES | {"shock"}, ENT_MHD_MODULES | {"shock"})


def _order_key(order):
    def key(m):
        return order.index(m.name) if m.name in order else len(order)
    return key


def _unported_bcs(cfg: Config):
    """The BC mnemonics of ``cfg`` that the port does not implement."""
    return sorted({code for bcs in (cfg.bcx, cfg.bcy, cfg.bcz) for bc in bcs
                   for code in (bc.low, bc.high)
                   if code and code not in BC_REGISTRY})


def _bcz_codes(cfg: Config, codes):
    """The mnemonics of ``codes`` that ``cfg``'s bcz uses, sorted."""
    return sorted({c for bc in cfg.bcz for c in (bc.low, bc.high)
                   if c in codes})


def _shock_options(cfg: Config):
    """The options in use that only the kernels of the sets with the
    Shock module's slot implement, each reading that slot: nu-shock and
    the shock diffusivities of lnρ, A and s."""
    visc, den = cfg.module("viscosity"), cfg.module("density")
    mag, ent = cfg.module("magnetic"), cfg.module("entropy")
    return [name for name, on in (
        ("Viscosity nu-shock", visc is not None and visc.coefficients()[1]),
        ("Viscosity 'shock-simple'",
         visc is not None and visc.terms()["shock-simple"] > 0.0),
        ("Density diffrho_shock", den is not None and den.diffrho_shock > 0),
        ("Magnetic eta_shock", mag is not None and mag.eta_shock > 0),
        ("Entropy chi_shock", ent is not None and "shock" in ent.iheatcond
         and ent.chi_shock > 0)) if on]


def _hyper3_names(cfg: Config):
    """The del6 coefficients in use, named: each field's 'simplified' or
    mesh flavour."""
    return [name for name, c in hyper3_terms(cfg) if c > 0.0]


def _hyper3_twice(cfg: Config):
    """Why ``cfg`` is outside the kernels for taking both flavours of
    del6 on one field ('hyper3-simplified' and 'hyper3-mesh' of u,
    diffrho_hyper3 and diffrho_hyper3_mesh of lnρ: each field has one
    weight and one coefficient in the H3 instances), or None."""
    visc, den = cfg.module("viscosity"), cfg.module("density")
    both = []
    if visc is not None and visc.coefficients()[2] > 0.0 \
            and visc.mesh_coefficient() > 0.0:
        both.append("Viscosity 'hyper3-simplified' with 'hyper3-mesh'")
    if den is not None and den.diffrho_hyper3 > 0.0 \
            and den.diffrho_hyper3_mesh > 0.0:
        both.append("Density diffrho_hyper3 with diffrho_hyper3_mesh")
    if both:
        return (f"options {both} (both flavours of del6 on one field: no "
                "kernel instance has them)")
    return None


def _upwind_with_hyper3(cfg: Config):
    """The upwinding flags in use beside a del6 coefficient, named with
    those coefficients, or None: no kernel instance has both (upwinding
    and hyper-diffusion damp the same grid-scale noise)."""
    upw = [name for name, on in zip(("lupw_lnrho", "lupw_uu", "lupw_ss"),
                                    upwind_flags(cfg)) if on]
    hyper = _hyper3_names(cfg)
    if upw and hyper:
        return (f"options {upw} (upwinding) with {hyper} (del6 "
                "hyper-diffusion): no kernel instance has both")
    return None


def _hyper3_with_walled_shock(cfg: Config):
    """The del6 coefficients in use beside the Shock module on a z-walled
    grid, named, or None: the z-ghosted builds with the shock slot have no
    H3 instance."""
    hyper = _hyper3_names(cfg)
    if hyper and cfg.module("shock") is not None \
            and not all(cfg.grid.periodic):
        return (f"options {hyper} (del6 hyper-diffusion) with the Shock "
                "module on a z-walled grid: no kernel instance has both")
    return None


def _visx_names(cfg: Config):
    """Viscosity's other flavours and Density's diffrho in use (the terms
    every instance takes behind PcParams.visx), named."""
    visc, den = cfg.module("viscosity"), cfg.module("density")
    t = visc.terms() if visc is not None else {}
    names = [f"Viscosity {k!r}" for k in (
        "nu-simplified", "rho-nu-const", "rho-nu-const-bulk",
        "hyper3_nu-const_aniso", "shock-simple", "nu-cspeed")
        if k in t and (any(t[k]) if isinstance(t[k], tuple) else t[k] > 0)]
    if den is not None and den.diffrho > 0.0:
        names.append("Density diffrho")
    return names


def _visx_spills(cfg: Config, free, wrap):
    """Why ``cfg`` is outside the kernels for launching the instance that
    is built without Viscosity's other flavours and diffrho (it would
    spill with them: ``visx_spills`` in csrc/fused_rhs.cu), or None."""
    names = _visx_names(cfg)
    if names and wrap and free == HYDRO_MODULES and any(upwind_flags(cfg)):
        return (f"options {names} with upwinding on the 4-field hydro "
                "build (its K1 UPW, at 128 registers, would spill)")
    return None


# the conduction flavours that the CHI instances take, one at a time
CHI_TERMS = ("chi-const", "kramers", "chi-cspeed", "chi-therm")


def fused_mode(cfg: Config):
    """(mode, None) with mode 'wrap' (the flagship and forced-hydro chain,
    with or without an entropy field, each with or without del6
    hyper-diffusion), 'zghost' (stratified convection and
    magnetoconvection, each with or without Shear, forcing, Ω, chi-const
    and del6 hyper-diffusion, or with the Shock module's slot, forcing, Ω
    and chi-const, and the isothermal stratified layer, hydro or MHD, with
    or without Shear, forcing, Ω and del6), 'zroll' (the
    shearing box, MHD or hydro, with or without the shock slot, each also
    with an entropy field) or 'wrap_aux' (the shocked periodic box, MHD or
    hydro, each also with an entropy field), gravity (any z profile of
    Gravity) optional in every periodic set and part of the z-ghosted
    ones and optional there too (the z-walled sets without it: g_z = 0);
    Magnetic's B_ext on every MHD set and continuous forcing on every set;
    the upwinding (lupw_lnrho, lupw_uu, lupw_ss) on every set, but not
    beside a del6 coefficient; either flavour of del6 ('simplified' or
    mesh) on each of u and lnρ, but not both on one field; SAFI on the
    shear sets; lremove_mean_momenta on every set; nu-shock and the shock
    diffusivities
    (diffrho_shock, eta_shock, chi_shock) on the sets with the Shock
    module's slot; Entropy's 'K-profile', 'kramers', 'chi-cspeed',
    tau_cool, heat_uniform and cool_uniform on the z-ghosted sets with
    ss (one of chi-const, 'kramers' and 'chi-cspeed'); Viscosity's
    'nu-simplified', 'rho-nu-const', the bulk ζ and Density's diffrho on
    every set, 'shock-simple' on the sets with the shock slot,
    'hyper3_nu-const_aniso' as the del6 of u and 'nu-cspeed' on the
    z-ghosted sets with ss (``viscosity_refusals`` names the rest); or
    (None, why ``cfg`` is outside all of these sets).
    The module set is tested before any option of it, so a set that no
    chain takes is refused for its modules; Entropy's layer profiles
    outside the z-ghosted sets, the upwinding beside del6, del6 beside a
    z-walled Shock, both flavours of del6 on one field, the shock
    terms without the slot, Entropy's other conduction and cooling terms
    outside the z-ghosted sets and two CHI-instance flavours at once are
    refused for those options, and SAFI outside the shear sets is named
    with the module set."""
    names = [m.name for m in cfg.modules]
    if not cfg.fused:
        return None, "fused=False"
    if cfg.time.itorder not in RK_TABLES:
        return None, (f"itorder={cfg.time.itorder} (the kernels implement "
                      f"the 2N-RK orders {sorted(RK_TABLES)})")
    bad = _unported_bcs(cfg)
    if bad:
        return None, f"BC mnemonics {bad} (not ported)"
    mods = set(names)
    periodic = tuple(cfg.grid.periodic)
    if len(mods) == len(names):
        full = periodic == (True, True, True)
        unforced = mods - {"forcing"}
        extra = _shock_options(cfg)
        # gravity rides on every chain as its g_z(z) vector: optional on
        # the periodic sets, part of the z-ghosted ones
        free = unforced - {"gravity"}
        zghost = free in ZGHOST_FREE_SETS and periodic == (True, True,
                                                           False)
        wrap = free in WRAP_SETS and full
        aux = full and (free in ZROLL_SETS or free in SHOCKBOX_SETS)
        if not (zghost or wrap or aux):
            return None, _outside(names, periodic, cfg)
        ent = cfg.module("entropy")
        if not zghost and ent is not None and (ent.cool != 0.0
                                               or ent.luminosity != 0.0):
            return None, ("options ['Entropy.cool/luminosity'] (the layer "
                          "profiles: only the conv-slab kernels implement "
                          "them)")
        # Entropy's other conduction and cooling terms: the z-ghosted
        # builds with ss only, one CHI-instance term at a time
        if ent is not None and not zghost and zg_entropy_options(ent):
            return None, (f"options {zg_entropy_options(ent)} (only the "
                          "kernels of the z-ghosted sets with ss implement "
                          "them)")
        if ent is not None and sum((ent.chi_conduction, ent.kramers,
                                    ent.cspeed_conduction)) > 1:
            return None, ("options iheatcond "
                          f"{[k for k in ent.iheatcond if k in CHI_TERMS]} "
                          "(the CHI instances have one of chi-const, "
                          "'kramers' and 'chi-cspeed')")
        both = (_upwind_with_hyper3(cfg) or _hyper3_with_walled_shock(cfg)
                or _hyper3_twice(cfg))
        if both:
            return None, both
        visc = viscosity_refusals(cfg, zghost and ent is not None)
        if visc:
            return None, f"options {visc}"
        spill = _visx_spills(cfg, free, wrap)
        if spill:
            return None, spill
        columns = _bcz_codes(cfg, COLUMN_CODES)
        if zghost and columns and "shock" in mods:
            return None, (f"BC mnemonics {columns} with the Shock module's "
                          "slot on a z-walled grid (their ghost columns "
                          "need the x/y-ghosted slabs, which no z-ghosted "
                          "build with the slot reads)")
        # nu-shock and the shock diffusivities read the Shock module's slot
        if aux and ("shock" in mods or not extra):
            return ("zroll" if free in ZROLL_SETS else "wrap_aux"), None
        if extra and "shock" not in mods and free in ZROLL_SETS:
            return None, (f"options {extra} without the Shock module, "
                          "whose slot they read")
        if extra and "shock" not in mods:
            return None, (f"options {extra} (only the kernels of the sets "
                          "with the Shock module's slot implement them)")
        return ("wrap" if wrap else "zghost"), None
    return None, _outside(names, periodic, cfg)


def _outside(names, periodic, cfg):
    """The refusal of a module set (with the grid's periodicity) that no
    chain takes, naming SAFI where the set's Shear has it (the shear
    sets' kernels alone take it)."""
    shear = cfg.module("shear")
    safi = ("Shear lshearadvection_as_shift (SAFI) with "
            if shear is not None and shear.lshearadvection_as_shift else "")
    return (f"{safi}modules {sorted(names)} with periodic={periodic} (the "
            f"kernels implement {sorted(FLAGSHIP_MODULES)} and "
            f"{sorted(HYDRO_MODULES)}, each with or without 'entropy', on "
            f"a periodic grid, {sorted(CONVSLAB_MODULES)} with or without "
            "'entropy', 'gravity', 'magnetic' and 'shear', and with "
            "'entropy' also with 'shock' in place of 'shear', with a "
            "non-periodic z, "
            f"{sorted(FLAGSHIP_MODULES | {'shear'})} and "
            f"{sorted(HYDRO_MODULES | {'shear'})}, each with or without "
            "'shock' and with or without 'entropy', and these with "
            "'shock' in place of 'shear' on a periodic grid, the periodic "
            "ones with optional gravity, all with optional forcing)")


def gate_reason(cfg: Config):
    """Why ``cfg`` is outside the fused kernel chains, or None."""
    return fused_mode(cfg)[1]


def fused_gate(cfg: Config, device) -> bool:
    """True when ``cfg`` runs a fused kernel chain on ``device``; False
    when it runs the eager path (CPU only).  Raises NotImplementedError for
    a configuration outside the gate on any other device: a GPU never
    silently runs the plain path."""
    reason = gate_reason(cfg)
    if reason is None:
        return True
    if torch.device(device).type != "cpu":
        raise NotImplementedError(
            f"pencil_tpu_torch: no fused kernels for this configuration on "
            f"{device}: {reason}")
    return False


def _check_bcs(cfg: Config, problems):
    gs = cfg.grid
    if not (gs.periodic[0] and gs.periodic[1]):
        problems.append("non-periodic x or y (only z may be non-periodic)")
    for axis, bcs in enumerate((cfg.bcx, cfg.bcy, cfg.bcz)):
        if gs.periodic[axis] and any(
                code not in ("p", "") for bc in bcs
                for code in (bc.low, bc.high)):
            problems.append(f"physical BCs on periodic axis {'xyz'[axis]}")
    bad = _unported_bcs(cfg)
    if bad:
        problems.append("BC mnemonics " + ", ".join(
            f"{c!r} ({REFUSED[c]})" if c in REFUSED else repr(c)
            for c in bad))
    for side, prof in enumerate(cfg.force_bound):
        if prof not in FORCE_BOUND:
            problems.append(
                f"force_bound {prof!r} of the {('low', 'high')[side]} wall "
                f"(ported: {list(FORCE_BOUND)}; 'uxy_sin-cos' raises in the "
                "JAX package on a z wall)")
    for bc in cfg.bcz:
        for code in {bc.low, bc.high}:
            if code in ENTROPY_CODES and bc.comp != "ss":
                problems.append(f"BC {code!r} on {bc.comp!r} (ss only)")
            elif code == "c1" and bc.comp not in ("ss", "ax", "ay", "az"):
                problems.append(f"BC 'c1' on {bc.comp!r} (the heat flux on "
                                "ss and the potential field on A only)")
            elif code == "hs" and bc.comp not in ("lnrho", "ss"):
                problems.append(f"BC 'hs' on {bc.comp!r} (lnrho and ss "
                                "only)")
    if _bcz_codes(cfg, ("hs",)):
        grav = cfg.module("gravity")
        if grav is None or grav.gravz == 0.0 \
                or grav.gravz_profile != "const":
            problems.append("BC 'hs' without Gravity of a constant gravz "
                            "≠ 0 ('const' profile)")


def _check_supported(cfg: Config):
    """What the port does not implement on any device."""
    gs = cfg.grid
    problems = []
    if cfg.mesh.shape != (1, 1, 1):
        problems.append(f"mesh {cfg.mesh.shape} (one device only)")
    if cfg.dtype != "float32":
        problems.append(f"dtype {cfg.dtype}")
    _check_bcs(cfg, problems)
    if gs.nghost != 3:
        problems.append(f"nghost={gs.nghost}")
    if cfg.time.itorder not in RK_TABLES:
        problems.append(f"itorder={cfg.time.itorder}")
    if not all(isinstance(m, ModuleBase) for m in cfg.modules):
        problems.append("modules that are not pencil_tpu_torch modules")
    elif not {"eos", "density", "hydro"} <= {m.name for m in cfg.modules}:
        problems.append("a module set without eos, density and hydro")
    else:
        visc = cfg.module("viscosity")
        if cfg.module("shock") is not None:
            for axis, bcs in enumerate((cfg.bcx, cfg.bcy, cfg.bcz)):
                codes = {(bc.low, bc.high) for bc in bcs
                         if bc.comp == "shock"}
                if not gs.periodic[axis] and codes != {("s", "s")}:
                    xyz = "xyz"[axis]
                    problems.append(
                        f"Shock on the non-periodic {xyz} axis without the "
                        f"BC 's' for its 'shock' slot in bc{xyz} (add "
                        "BC('shock', 's'): the reference gives the slot a "
                        "code, the chains on the card fill its ghosts by "
                        "that code and the eager path and the pre-pass by "
                        "the symmetric closure, and without one the JAX "
                        "package's fused and jnp paths fill them "
                        "differently)")
        if visc is not None and cfg.module("shock") is None:
            for k in ("nu-shock", "shock-simple"):
                if visc.terms()[k] > 0.0:
                    problems.append(f"Viscosity {k!r} without the Shock "
                                    "module")
        forcing = cfg.module("forcing")
        if forcing is not None and forcing.lforcing_cont \
                and forcing.iforcing_cont not in FCONT_PROFILES:
            problems.append(f"Forcing iforcing_cont="
                            f"{forcing.iforcing_cont!r} (ported: "
                            f"{sorted(set(FCONT_PROFILES) - {''})})")
    if problems:
        raise NotImplementedError("pencil_tpu_torch: " + "; ".join(problems))


def _slots_of(m):
    r = Registry()
    m.register(r)
    return set(r.finalize().slots)


class Model:
    def __init__(self, cfg: Config, device="cuda", fake_rhs=False):
        """``device``: the card by default (a RuntimeError if none is
        present); ``"cpu"`` runs the plain PyTorch path.  ``fake_rhs``: run
        the K8 memory floor in place of K1-K3 (the MHD flagship chain at
        itorder 3 with a fixed ``TimeSpec.dt`` only: K8 reports no CFL
        rate, so an adaptive dt would be dtmax) — a measurement mode whose
        physics is wrong by design."""
        _check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.fused = fused_gate(cfg, self.device)
        self.mode = fused_mode(cfg)[0] if self.fused else None
        self.fake_rhs = bool(fake_rhs)
        if self.fake_rhs and (self.mode != "wrap" or cfg.time.itorder != 3
                              or cfg.module("magnetic") is None
                              or cfg.module("entropy") is not None
                              or cfg.module("gravity") is not None):
            raise NotImplementedError(
                "pencil_tpu_torch: fake_rhs (K8) runs on the MHD "
                "flagship's fused 2N-RK3 chain only")
        if self.fake_rhs and not cfg.time.dt > 0:
            raise NotImplementedError(
                "pencil_tpu_torch: fake_rhs (K8) needs a fixed "
                "TimeSpec.dt > 0 (its K1 reports no CFL rate)")
        self.modules = tuple(sorted(cfg.modules, key=_order_key(MODULE_ORDER)))
        self.reg = Registry()
        for m in sorted(cfg.modules, key=_order_key(REGISTRATION_ORDER)):
            m.register(self.reg)
        self.reg.finalize()
        self.bc_axes = (cfg.bcx, cfg.bcy, cfg.bcz)
        # the z-ghosted kernels' input layout: x/y-ghosted slabs with Shear
        # and where a z BC writes ghost columns that no wrap gives; the
        # planes z_slabs cuts at each end of z: g + 1, or 2g + 1 where a
        # code reads 7
        self.zg_xy = cfg.module("shear") is not None \
            or bool(_bcz_codes(cfg, COLUMN_CODES))
        self._zdepth = 2 * NGHOST + 1 if _bcz_codes(cfg, DEEP_CODES) \
            else NGHOST + 1
        self._nonperiodic = tuple(a for a in range(3)
                                  if not cfg.grid.periodic[a])
        comps = self.reg.comp_names[: self.reg.ncom]
        for axis in self._nonperiodic:
            named = [bc.comp for bc in self.bc_axes[axis]]
            if sorted(named) != sorted(comps):
                raise NotImplementedError(
                    f"pencil_tpu_torch: the non-periodic {'xyz'[axis]} axis "
                    f"needs one BC for each of {comps}, got {named}")
        require_device(self.device)
        self.dtype = torch.float32
        self.eos = cfg.module("eos")
        self.grid = make_grid(cfg.grid, self.device, self.dtype)
        # the z coordinates of the planes that z_slabs cuts
        zgh, w = self.grid.zgh, self._zdepth
        self._zgh_cut = np.concatenate([zgh[:NGHOST + w],
                                        zgh[NGHOST + cfg.grid.nz - w:]])
        self.rk = RK_TABLES[cfg.time.itorder]
        self.shear = cfg.module("shear")
        # SAFI: the shear advection as a shift after each substep
        self.safi = bool(self.shear is not None
                         and self.shear.lshearadvection_as_shift)
        hydro = cfg.module("hydro")
        # Hydro's lremove_mean_momenta, run after each step
        self._mean_remover = hydro if hydro.lremove_mean_momenta else None
        # farray-level auxiliaries built in a pre-pass (the shock profile)
        self._aux_modules = tuple(m for m in self.modules
                                  if hasattr(m, "compute_aux"))
        forcing = cfg.module("forcing")
        self.forcing = forcing if forcing is not None and forcing.force != 0.0 \
            else None
        self._ftables = (self.forcing.tables(cfg.grid, self.device,
                                             self.dtype,
                                             shear=cfg.module("shear"))
                         if self.forcing is not None else None)
        # the random stream of init_state and of the forcing draws
        self.generator = torch.Generator(self.device)
        # hook: a zero-argument callable returning one step's forcing draws
        # (shell index, phase, e-vector) in place of the generator's
        self.forcing_draws = None
        dev = dict(dtype=self.dtype, device=self.device)
        self._alpha = torch.tensor(self.rk[0], **dev)
        self._zero = torch.zeros((), **dev)
        self._dt1_floor = torch.tensor(1.0 / cfg.time.dtmax, **dev)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, overrides: Dict = None) -> Dict:
        """``overrides``: field name → array replacing the module-generated
        initial condition (the tests pass the JAX package's fields).  A
        module's "+name" key is added to field ``name`` after the
        overrides, as JAX's cross-field contributions are
        (pencil_tpu/model.py:215-231, :283); a module whose slots are all
        overridden contributes none."""
        overrides = overrides or {}
        self.generator.manual_seed(seed)
        gs = self.cfg.grid
        fields, additive = {}, []
        for m in self.modules:
            if _slots_of(m) <= set(overrides):
                continue
            for name, arr in m.init_fields(self.grid, gs, self.generator,
                                           cfg=self.cfg).items():
                if name.startswith("+"):
                    additive.append((name[1:], arr))
                else:
                    fields[name] = arr
        for name, arr in overrides.items():
            fields[name] = torch.as_tensor(arr, dtype=self.dtype,
                                           device=self.device).clone()
        for name, arr in additive:
            if name in self.reg.slots:
                fields[name] = fields[name] + arr
        for name, slot in self.reg.slots.items():
            if name not in fields:
                # a slot no module initialises (the shock profile) starts
                # at zero, as in the JAX package (model.py:234-240)
                shape = ((slot.ncomp,) if slot.ncomp > 1 else ()) + gs.shape
                fields[name] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
        fields = {k: fields[k] for k in self.reg.slots}
        if self._nonperiodic:
            # value-setting BCs pin the boundary planes from the start
            # (JAX model.py:332-338)
            fields = self.reg.unstack(
                self.bc_writeback(self.reg.stack(fields)))
        dev = dict(dtype=self.dtype, device=self.device)
        return {
            "fields": fields,
            "t": torch.tensor(self.cfg.time.tstart, **dev),
            "dt": torch.tensor(self.cfg.time.dt if self.cfg.time.dt > 0
                               else 1e-4, **dev),
            "it": torch.tensor(0, dtype=torch.int32, device=self.device),
        }

    def pack_state(self, state: Dict) -> Dict:
        """Swap the per-field dict for the stacked ``_fa`` tensor, so a hot
        loop carries one tensor.  No-op outside the fused chain, whose
        eager path needs the dict for the forcing hook."""
        if "_fa" in state or not self.fused:
            return state
        st = dict(state)
        st["_fa"] = self.reg.stack(st.pop("fields"))
        return st

    def unpack_state(self, state: Dict) -> Dict:
        """Inverse of pack_state (no-op on an unpacked state)."""
        if "_fa" not in state:
            return state
        st = dict(state)
        st["fields"] = self.reg.unstack(st.pop("_fa"))
        return st

    # ------------------------------------------------------------------
    def ghosted(self, fa, axes=(0, 1, 2), shear_dy=None):
        """The communicated components of ``fa`` with ghost zones along
        ``axes``: wrap on periodic axes, the BCs on the others, and x faces
        shifted by ``shear_dy`` when it is given."""
        return fill_ghosts(fa[: self.reg.ncom], self.cfg.grid, self.bc_axes,
                           self.reg, self.grid, self.cfg, self.eos, axes,
                           shear_dy=shear_dy)

    def z_slabs(self, fa):
        """(fa, zlo, zhi): the z-halo slabs (ncom, X, Y, g) below z = 0
        and above z = nz − 1 of ``fa``'s communicated components (X, Y its
        x/y extent, ghosted or not), cut from a z-only ``fill_ghosts`` of
        the planes at each end of z that the bcz codes read (g + 1, or
        2g + 1 with 'e2', 's0d' or '1s'/'d1s'/'n1s'; the whole stack where
        nz is below twice that), with the full grid's z coordinates at the
        matching planes; the boundary planes that value-setting BCs pin
        ('a', 'set', 'cT', 'c1' on A, 's0d', ...) are written into ``fa``
        itself, in place, as ``bc_writeback`` writes them (a no-op on a
        state that ``init_state`` or a step made).  The 3-axis fill's z
        ghosts are these slabs with x and y wrapped (JAX's ``_fetch_zg``
        split), or, from an x/y-ghosted ``fa``, these slabs as they are."""
        g, n, nz = NGHOST, self.reg.ncom, fa.shape[3]
        w = self._zdepth
        if nz < 2 * w:
            fw = fill_ghosts(fa[:n], self.cfg.grid, self.bc_axes, self.reg,
                             self.grid, self.cfg, self.eos, axes=(2,))
        else:
            fw = fill_ghosts(
                torch.cat([fa[:n, ..., :w], fa[:n, ..., nz - w:]], dim=3),
                self.cfg.grid, self.bc_axes, self.reg, self.grid, self.cfg,
                self.eos, axes=(2,), zgh=self._zgh_cut)
        mz = fw.shape[3]
        fa[:n, ..., :1].copy_(fw[..., g:g + 1])
        fa[:n, ..., nz - 1:].copy_(fw[..., mz - g - 1:mz - g])
        return (fa, fw[..., :g].contiguous(), fw[..., mz - g:].contiguous())

    def zg_input(self, fa, sdy=None):
        """(body, zlo, zhi), the z-ghosted kernels' input from ``fa``:
        ``z_slabs(fa)``, which pins ``fa``'s boundary planes in place; or,
        with Shear or a bcz code that writes ghost columns no wrap gives
        ('pot', 'pwd', 'pfe', 'div': ``zg_xy``), the stack ghosted in x and
        y (with Shear its x faces shifted by ``sdy``) and ``z_slabs`` of
        that new stack, whose z BCs then act over the whole ghosted x/y
        extent, as JAX's 3-axis fill does (``fa`` is not written)."""
        return self.z_slabs(self.ghosted(fa, (0, 1), sdy) if self.zg_xy
                            else fa)

    def deltay(self, t):
        """The shear-periodic y offset at device time ``t``, or None
        without Shear (JAX physics/shear.py:45-46)."""
        if self.shear is None:
            return None
        gs = self.cfg.grid
        return self.shear.deltay(t, gs.Lx, gs.Ly)

    def _make_halo1(self, shear_dy):
        """Ghost fill of one interior scalar: the periodic wrap, then on
        each non-periodic axis the symmetric closure ``bc_sym`` about the
        boundary plane (JAX model.py:368-395; the reference's shock ghosts
        by bc 's')."""
        gs = self.cfg.grid

        def halo1(x):
            xg = fill_ghosts(x[None], gs, ((), (), ()), self.reg,
                             self.grid, self.cfg, None,
                             shear_dy=shear_dy)[0]
            for axis in self._nonperiodic:
                for side in (0, 1):
                    bc_sym(xg, axis, side, 0.0, None)
            return xg

        return halo1

    def apply_aux(self, fg, shear_dy=None):
        """Write each aux module's slot, ghost-filled, into the ghosted
        stack ``fg`` in place and return it (the eager path; JAX
        model.py:397-409).  The state itself keeps its old slot."""
        halo1 = self._make_halo1(shear_dy)
        pen = Pencils(fg, self.grid, self.reg, self.cfg, self.eos,
                      ghosted=True)
        for m in self._aux_modules:
            for aname, interior in m.compute_aux(pen, halo1).items():
                fg[self.reg.slice(aname)] = halo1(interior)[None]
        return fg

    def _refresh_aux_fa(self, f, shear_dy=None):
        """The stack of all slots, a new tensor: the evolved fields, the
        first nvar rows of ``f`` (which may hold the aux slots too), and
        each aux slot rebuilt from them (the fused chains' pre-pass; JAX
        model.py:411-428).  The aux modules read the evolved fields
        alone, so only those are ghosted, each by its own BCs."""
        nvar = self.reg.nvar
        evolved = self.reg.comp_names[:nvar]
        bcs = tuple(tuple(bc for bc in axis if bc.comp in evolved)
                    for axis in self.bc_axes)
        pen = Pencils(fill_ghosts(f[:nvar], self.cfg.grid, bcs, self.reg,
                                  self.grid, self.cfg, self.eos,
                                  shear_dy=shear_dy),
                      self.grid, self.reg, self.cfg, self.eos, ghosted=True)
        halo1 = self._make_halo1(shear_dy)
        aux = {}
        for m in self._aux_modules:
            aux.update(m.compute_aux(pen, halo1))
        del pen
        return torch.cat([f[:nvar]] + [
            aux[s.name][None] for s in self.reg.slots.values()
            if s.start >= nvar])

    def _refreshed(self, f, shear_dy=None):
        """A kernel's input stack: ``_refresh_aux_fa`` where the layout
        has aux slots, else ``f`` itself."""
        if self.reg.nf > self.reg.nvar:
            return self._refresh_aux_fa(f, shear_dy)
        return f

    def _with_aux(self, fa, f_new):
        """The stack after a step: the evolved fields ``f_new`` and, where
        the layout has them, the aux slots of ``fa`` (the last
        pre-pass's)."""
        if self.reg.nf > self.reg.nvar:
            return torch.cat([f_new, fa[self.reg.nvar:]])
        return f_new

    def bc_writeback(self, fa):
        """Copy the BC-applied boundary planes of every non-periodic axis
        into ``fa``, in place, and return it: value-setting BCs ('a',
        'set', 'cT', 'c1' on A, 's0d', ...) pin the state itself, not only
        its ghosted copy (JAX model.py:962-996).  Every ported BC sets the
        boundary plane of a column from that column alone, or ('c1' on A)
        from whole interior planes, never from ghost columns, so ghosting
        that one axis gives the JAX package's planes; the ghost columns
        that 'pot' and 'div' write in a 3-axis fill lie outside them."""
        g = NGHOST
        for axis in self._nonperiodic:
            fg = self.ghosted(fa, (axis,))
            n = fa.shape[1 + axis]
            for pos_f, pos_g in ((0, g), (n - 1, n - 1 + g)):
                fa[: self.reg.ncom].narrow(1 + axis, pos_f, 1).copy_(
                    fg.narrow(1 + axis, pos_g, 1))
        return fa

    def _draws(self, state=None, dt=None):
        """One step's forcing draws: the hook's, in replay mode the step's
        (it, end time) from ``state`` and ``dt`` (JAX model.py:924-933
        passes the starting it and t + dt), else the generator's."""
        if self.forcing_draws is not None:
            return self.forcing_draws()
        if self.forcing.sequence is not None:
            return state["it"], state["t"] + dt
        return self.forcing.draw(self._ftables, self.generator)

    def _new_dt(self, dt1m, dt_prev):
        """dt from substep 1's CFL maximum, as device tensor ops
        (JAX model.py:738-748)."""
        tc = self.cfg.time
        if tc.dt > 0:
            return torch.full((), tc.dt, dtype=self.dtype, device=self.device)
        dt = 1.0 / torch.maximum(dt1m, self._dt1_floor)
        if tc.ddt > 0:
            dt = torch.minimum(dt, tc.ddt * dt_prev)
        return dt

    def _finish(self, state: Dict, fa, dt) -> Dict:
        """The state after one step from ``state``: ``fa`` packed or
        unpacked as ``state`` was."""
        out = {"t": state["t"] + dt, "dt": dt, "it": state["it"] + 1}
        if "_fa" in state:
            out["_fa"] = fa
        else:
            out["fields"] = self.reg.unstack(fa)
        return out

    def _safi_shift(self, isub, dt, f, df):
        """(f, df) after substep ``isub`` of a step of length ``dt``: with
        SAFI the evolved rows ``f`` shifted by the background flow over
        dtsub = (c_{isub+1} − c_isub)·dt (c_nsub = 1), and the df carry
        too on every substep but the last (JAX model.py:809-822: the
        reference's advance_shear with the true time increment of the
        substep, RK3: dt·(1/3, 5/12, 1/4)), each a new tensor; without SAFI
        both as they are."""
        if not self.safi:
            return f, df
        cstage = self.rk[2]
        last = isub == len(cstage) - 1
        dtsub = ((1.0 if last else cstage[isub + 1]) - cstage[isub]) * dt
        Ly = self.cfg.grid.Ly
        f = self.shear.shift_advection(f, self.grid, Ly, dtsub)
        if not last:
            df = self.shear.shift_advection(df, self.grid, Ly, dtsub)
        return f, df

    def _remove_mean_momenta(self, fa):
        """``fa`` with the volume-mean momentum taken out of its u rows
        (Hydro's lremove_mean_momenta), a new stack; ``fa`` itself where
        the option is off."""
        if self._mean_remover is None:
            return fa
        sl = self.reg.slice("uu")
        uu = self._mean_remover.remove_mean_momenta(
            fa[sl], fa[self.reg.slice("lnrho")][0])
        return torch.cat([fa[: sl.start], uu, fa[sl.stop:]])

    def _after_step(self, fa, dt, state=None):
        """``fa`` after the after-step hooks of the step from ``state``,
        in the JAX order (model.py:924-933, Hydro before Forcing): the
        mean momenta removed, then the forcing kick."""
        return self._kick_after(self._remove_mean_momenta(fa), dt, state)

    def _kick_after(self, fa, dt, state=None):
        """``fa`` with the forcing kick added to its u rows after the step
        from ``state`` (JAX model.py:924-933), for the chains whose kernels
        do not kick; ``fa`` itself when the run is unforced."""
        if self.forcing is None:
            return fa
        sl = self.reg.slice("uu")
        uu = self.forcing.after_timestep({"uu": fa[sl]}, self.grid,
                                         self._ftables,
                                         self._draws(state, dt), dt,
                                         self.eos)["uu"]
        return torch.cat([fa[: sl.start], uu, fa[sl.stop:]])

    def _fused_step(self, state: Dict, kernels=None):
        """One 2N-RK step of the flagship chain at the order of ``self.rk``
        (JAX model.py:650-703), MHD or hydro: the wrappers launch the
        library of the state's field layout.  ``kernels`` = (first, defer,
        mid, last, defer_last) lets a measurement time the plain versions
        through the same chain."""
        first, defer, mid, last, defer_last = kernels or (
            rhs_first, rhs_tail_defer, rhs_tail_mid, rhs_tail_last,
            rhs_tail_defer_last)
        fake = {"fake": True} if self.fake_rhs else {}
        alpha, beta, _ = self.rk
        nsub = len(alpha)
        fa = state["_fa"] if "_fa" in state else self.reg.stack(
            state["fields"])
        df, dt1m = first(self, fa, **fake)
        dt = self._new_dt(dt1m, state["dt"])
        if nsub == 1:
            return self._finish(state, self._after_step(
                fa + beta[0] * dt * df, dt, state), dt)
        # the last kernel kicks, unless the mean momenta come out before
        # the kick (JAX's kick_ok, model.py:657-661)
        kick_in_kernel = self.forcing is not None \
            and self._mean_remover is None
        f = fa
        for isub in range(1, nsub):
            coef = torch.stack((self._alpha[isub], beta[isub] * dt,
                                beta[0] * dt if isub == 1 else self._zero))
            if isub < nsub - 1:
                if isub == 1:
                    df, f = defer(self, fa, df, coef, **fake)
                else:
                    df, f = mid(self, f, df, coef)
                continue
            kick = None
            if kick_in_kernel:
                kick = self.forcing.kick_vector(
                    self._ftables, self._draws(state, dt), dt, self.eos)
            if isub == 1:
                f = defer_last(self, fa, df, coef, kick)
            else:
                f = last(self, f, df, coef, kick, **fake)
        if not kick_in_kernel:
            f = self._after_step(f, dt, state)
        return self._finish(state, f, dt)

    def _zghost_step(self, state: Dict, kernels=(rhs_zg, rhs_zg_upd)):
        """One 2N-RK step as the zghost chain (JAX model.py:411-460,
        :704-775, :891, :924-933): K6 and a torch axpy, then K7 per
        substep, each on a fresh ``zg_input`` (with Shear the x faces
        shifted by deltay at t0 + c·dt: substep 1 with the old dt, the
        others with the new one; under SAFI each substep's update followed
        by ``_safi_shift``), then the boundary-plane writeback and the
        after-step hooks (the mean removal, the forcing kick).  Where the
        state has the shock slot, each substep
        first rebuilds it from the substep's state (``_refresh_aux_fa``,
        its ghosts by the z BCs), the kernels read it with its z slabs, and
        the update keeps it out of the RK sum: the state's slot is the last
        pre-pass's.  No tensor of ``state`` is written.  ``kernels`` lets
        a measurement time the plain versions through the same chain."""
        first, upd = kernels
        alpha, beta, cstage = self.rk
        nvar = self.reg.nvar
        fa = state["_fa"] if "_fa" in state else self.reg.stack(
            state["fields"])
        shear = self.shear is not None

        def sdy(isub, dt):
            return self.deltay(state["t"] + cstage[isub] * dt) if shear \
                else None

        # z_slabs pins the boundary planes of its argument in place: K6
        # reads a copy (in the x/y-ghosted layout that one; with the shock
        # slot the pre-pass's new stack), the axpy (as JAX's) the caller's
        # stack, which stays as it was
        src = self._refreshed(fa)
        if src is fa and not self.zg_xy:
            src = fa.clone()
        df, dt1m = first(self, *self.zg_input(src, sdy(0, state["dt"])))
        dt = self._new_dt(dt1m, state["dt"])
        f_new, df = self._safi_shift(0, dt, fa[:nvar] + beta[0] * dt * df,
                                     df)
        for isub in range(1, len(alpha)):
            fa = self._refreshed(f_new)
            coef = torch.stack((self._alpha[isub], beta[isub] * dt))
            df, f_new = upd(self, *self.zg_input(fa, sdy(isub, dt)), df,
                            coef)
            f_new, df = self._safi_shift(isub, dt, f_new, df)
        fa = self._with_aux(fa, f_new)
        return self._finish(state, self._after_step(self.bc_writeback(fa),
                                                    dt, state), dt)

    def _aux_step(self, state: Dict, kernels=None):
        """One 2N-RK step of the zroll chain (JAX model.py:576-730) or the
        wrap_aux chain (model.py:433-445, :704-730).  Where the state has
        the shock slot, each substep rebuilds it; zroll then fills the x/y
        ghosts with the x faces shifted by deltay at t0 + c·dt (substep 1
        with the old dt, the others with the new one), while wrap_aux's
        kernels fetch their halos by index wrap.  K4/K1s and a torch axpy,
        then K5/K5w per substep, under SAFI each update followed by
        ``_safi_shift``; the after-step hooks (the mean removal, the
        forcing kick) follow the step.  The
        state's shock slot is the last pre-pass's.  No tensor of
        ``state`` is written.  ``kernels`` = (first, upd) lets a
        measurement time the plain versions through the same chain."""
        wrap = self.mode == "wrap_aux"
        first, upd = kernels or ((rhs_wrap_shock, rhs_wrap_shock_upd) if wrap
                                 else (rhs_zroll, rhs_zroll_upd))
        nvar = self.reg.nvar

        def kernel_input(fa, sdy):
            return fa if wrap else self.ghosted(fa, (0, 1), sdy)

        alpha, beta, cstage = self.rk
        fa = state["_fa"] if "_fa" in state else self.reg.stack(
            state["fields"])
        t0, dt = state["t"], state["dt"]
        sdy = None if wrap else self.deltay(t0 + cstage[0] * dt)
        df, dt1m = first(self, kernel_input(self._refreshed(fa, sdy), sdy))
        dt = self._new_dt(dt1m, state["dt"])
        f_new, df = self._safi_shift(0, dt, fa[:nvar] + beta[0] * dt * df,
                                     df)
        for isub in range(1, len(alpha)):
            sdy = None if wrap else self.deltay(t0 + cstage[isub] * dt)
            fa = self._refreshed(f_new, sdy)
            coef = torch.stack((self._alpha[isub], beta[isub] * dt))
            df, f_new = upd(self, kernel_input(fa, sdy), df, coef)
            f_new, df = self._safi_shift(isub, dt, f_new, df)
        fa = self._with_aux(fa, f_new)
        return self._finish(state, self._after_step(fa, dt, state), dt)

    def _eager_step(self, state: Dict):
        """One 2N-RK step from the plain RHS (under SAFI each substep's
        update followed by ``_safi_shift``), the boundary-plane writeback,
        the mean removal and the kick applied after the substeps (CPU only;
        JAX model.py:733-822, :891, :924-933).  With a non-periodic axis, shear
        or an aux module the RHS reads a ghosted stack; the aux slots are
        written into that stack only, so the state keeps its own."""
        alpha, beta, cstage = self.rk
        nvar = self.reg.nvar
        fa = self.reg.stack(state["fields"])
        ghosted = bool(self._nonperiodic or self.shear is not None
                       or self._aux_modules)
        df = None
        dt = state["dt"]
        for isub in range(len(alpha)):
            f = fa
            if ghosted:
                sdy = self.deltay(state["t"] + cstage[isub] * dt)
                f = self.ghosted(fa, shear_dy=sdy)
                if self._aux_modules:
                    f = self.apply_aux(f, sdy)
            dfa, dt1m = rhs_plain(self, f, want_dt1=isub == 0,
                                  ghosted=ghosted)
            if isub == 0:
                dt = self._new_dt(dt1m, state["dt"])
                df = dfa
            else:
                df = alpha[isub] * df + dfa
            upd, df = self._safi_shift(isub, dt,
                                       fa[:nvar] + beta[isub] * dt * df, df)
            fa = torch.cat([upd, fa[nvar:]]) if fa.shape[0] > nvar else upd
        fields = self.reg.unstack(self._remove_mean_momenta(
            self.bc_writeback(fa)))
        if self.forcing is not None:
            fields = self.forcing.after_timestep(
                fields, self.grid, self._ftables, self._draws(state, dt), dt,
                self.eos)
        return {"fields": fields, "t": state["t"] + dt, "dt": dt,
                "it": state["it"] + 1}

    def _local_step(self, state: Dict) -> Dict:
        if self.mode == "wrap":
            return self._fused_step(state)
        if self.mode == "zghost":
            return self._zghost_step(state)
        if self.mode in ("zroll", "wrap_aux"):
            return self._aux_step(state)
        return self._eager_step(state)

    def make_step(self):
        """One full step per call; dt stays on the device."""
        return self._local_step

    def make_multi_step(self, k: int):
        """k steps per call, carrying the packed state between them."""
        def stepk(state):
            s = self.pack_state(state)
            for _ in range(k):
                s = self._local_step(s)
            return self.unpack_state(s)

        return stepk
