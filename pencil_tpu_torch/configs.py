"""Named configurations of the port, shared by its tests and
``chip_smoke.py``.  Each builder takes the package whose classes it uses
(``pencil_tpu_torch`` or ``pencil_tpu``), so the tests build the same
configuration in both.
"""
from __future__ import annotations

import dataclasses
import math
import sys

import torch

# the upwinding flag of each module that advects a field
UPWIND_FLAGS = {"density": "lupw_lnrho", "hydro": "lupw_uu",
                "entropy": "lupw_ss"}


def with_upwind(cfg):
    """``cfg`` (of either package) with the advection of every field it
    has upwinded: lupw_lnrho, lupw_uu and, with ss, lupw_ss."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **{UPWIND_FLAGS[m.name]: True})
        if m.name in UPWIND_FLAGS else m for m in cfg.modules))


def with_viscosity(cfg, ivisc, **coeffs):
    """``cfg`` (of either package) with the viscosity flavours ``ivisc``
    in place of its own, each keyword a coefficient of the Viscosity
    module (``nu``, ``zeta``, ``nu_shock``, ``nu_hyper3``,
    ``nu_aniso_hyper3``, ``nu_cspeed``, ...) but ``diffrho``, Density's
    Fickian mass diffusion, which goes to the Density module."""
    den = {k: coeffs.pop(k) for k in ("diffrho",) if k in coeffs}
    new = {"viscosity": dict(coeffs, ivisc=tuple(ivisc)), "density": den}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name]) if m.name in new else m
        for m in cfg.modules))


def with_shock_diffusion(cfg, coef=1.0):
    """``cfg`` (of either package) with the shock diffusivities at
    ``coef``: D_sh of lnρ (``diffrho_shock``), with Magnetic the shock
    resistivity η_sh (``eta_shock``) and with ss shock heat conduction
    χ_sh (iheatcond 'shock' with ``chi_shock``)."""
    new = {"density": lambda m: dict(diffrho_shock=coef),
           "magnetic": lambda m: dict(eta_shock=coef),
           "entropy": lambda m: dict(iheatcond=tuple(m.iheatcond)
                                     + ("shock",), chi_shock=coef)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name](m)) if m.name in new else m
        for m in cfg.modules))


def conv_slab(n, fused=True, pkg=None, magnetic=False, Omega=0.0, chi=0.0,
              hyper3=False, shear=False, forcing=0.0, upwind=False,
              shock=False, safi=False, heatcond="K-const", chi_cspeed=None,
              tau_cool=0.0, cooling_profile="gaussian", entropy=None,
              bcz=None):
    """Stratified convection in the style of the Pencil Code's conv-slab
    sample: a stable layer (mpoly1 = 3) from z0 to z1, an unstable one
    (mpoly0 = 1) from z1 to z2 and an isothermal one above, under constant
    gravity, with K-const conduction, a heating layer at the bottom, a
    cooling layer at the top and viscous heating; unforced; 5 fields (uu,
    lnrho, ss).  x and y are periodic; z has physical boundaries.  ``n``
    is an int (a cube) or (nx, ny, nz).

    ``magnetic`` makes it magnetoconvection: the vector potential with
    η = 4e-3 (magnetic Prandtl number ν/η = 1), a weak gaussian-noise seed
    field of amplitude 1e-4, the Lorentz force and Ohmic heating; 8 fields
    (uu, lnrho, ss, aa), with the perfect-conductor walls A_x = A_y = 0,
    ∂A_z/∂z = 0 ('a', 'a', 's').  ``Omega`` > 0 adds the Coriolis force of
    a rotation about z (rotating convection).  ``chi`` > 0 adds
    'chi-const' conduction with that χ beside K-const, the Pencil Code's
    usual stand-in for turbulent heat diffusion (χ = 4e-3 = ν, a Prandtl
    number of 1, is the value this repository runs).  ``hyper3`` adds del6
    hyper-diffusion of u, lnρ and (with Magnetic) A with ν₃ = D₃ = η₃ =
    5e-3·dx⁵ ('hyper3-simplified', ``diffrho_hyper3``, ``eta_hyper3``), as
    in ``flagship``: hyper-diffusive convection, ν and η unchanged;
    ``hyper3="mesh"`` the mesh flavour on u and lnρ in its place (as
    ``_hyper3`` sets it).  ``shear`` puts the slab in a shearing box:
    Shear with Keplerian shear q = 3/2 at the rotation rate ``Omega``
    (which must be > 0; the Coriolis force of that Ω is on too), its
    background flow S·x along y with S = −qΩ and shear-periodic x faces;
    the stratified shearing box of convection-driven dynamo runs in a
    rotating, sheared slab with z walls (Käpylä, Korpi & Brandenburg 2008,
    A&A 491, 353); ``safi`` advects by that flow as a shift after each
    substep (``lshearadvection_as_shift``).  ``forcing``
    > 0 adds helical forcing of that amplitude at kf = 3, kicked after
    each step: forced convection (with ``magnetic`` forced
    magnetoconvection).  ``upwind`` upwinds the advection of lnρ, u and s
    (``lupw_lnrho``, ``lupw_uu``, ``lupw_ss``: 5th-order upwinding, the
    reference's der6_upwind), ν, χ and K unchanged.  ``shock`` adds the
    Shock module (its 'original' profile) and shock viscosity 'nu-shock'
    with ν_sh = 1 beside ν, and the slot's z BC 's' last in bcz (the
    reference gives every f-array slot a code): supersonic stratified
    convection and, with ``magnetic``, magnetoconvection with shocks
    (``with_shock_diffusion`` adds the shock diffusion of lnρ, s and A).
    ``heatcond`` picks the conductivity: "K-const" (K = hcond0 = 8e-3,
    the default), "K-profile" (K ∝ m + 1 in each polytropic layer, 8e-3
    in the unstable one: the conductivity with which the piecewise
    polytrope is in flux balance) or "kramers" (K = K₀T^6.5/ρ², n = 1,
    no clip, K₀ = ``KRAMERS_K0``, with which K at z2 on the initial state
    is 8e-3: convection whose unstable layer's depth sets itself, as in
    Käpylä et al. 2017, ApJL 845, L23); ``chi_cspeed`` turns ``chi``'s
    'chi-const' into 'chi-cspeed', χT^c with c = ``chi_cspeed``.
    ``tau_cool`` > 0 adds Newtonian cooling of T towards the top layer's
    temperature on that time; ``cooling_profile`` shapes the cooling
    layer ('gaussian' at the top, 'step', 'step2', 'cubic_step' at z2 or
    'lin-z'); ``entropy`` holds further Entropy fields (e.g.
    ``heat_uniform``, ``cool_uniform``, ``chimax_kramers``, or the flux
    walls' ``sigmaSBt``, ``chi_t``, ``Fbot``).  ``bcz`` maps a component
    to its z codes, a string 'low:high' (its values kept) or a tuple
    (codes, lval, hval), in place of the default's; the order stays the
    default's (e.g. ``{"ax": "pot", "ay": "pot", "az": "pot"}``, a vacuum
    exterior; ``{"lnrho": "a2:hs", "ss": "c1:Fgs"}``, a hydrostatic
    density top and a black-body top, ``fgs_sigma()`` giving σ_SBt).
    The values are this configuration's own, not the sample's
    start.in/run.in.

    The bottom c1 flux follows the run-directory loader's rule
    (pencil_tpu/compat/rundir.py:2400-2406):
    −γ·gravz/((mpoly1+1)(γ−1)cp) = 0.625; the top cT holds cs² = cs2cool.
    The bcz order matters: lnrho before ss, whose c1/cT read lnρ's ghosts.
    """
    if shear and not Omega > 0.0:
        raise ValueError("conv_slab: shear=True needs Omega > 0 "
                         "(S = -q Omega)")
    if safi and not shear:
        raise ValueError("conv_slab: safi=True needs shear=True")
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz, x0=-0.5, y0=-0.5, z0=-0.68,
                        Lx=1.0, Ly=1.0, Lz=1.0, periodic=(True, True, False))
    den, visc, eta3 = _hyper3(pkg, grid, hyper3)
    gamma, cp, gravz, mpoly1, cs2cool = 5.0 / 3.0, 1.0, -1.0, 3.0, 1.0
    lval = -gamma * gravz / ((mpoly1 + 1.0) * (gamma - 1.0) * cp)
    bcz_over = bcz
    bcz = (pkg.BC.parse("ux", "s"), pkg.BC.parse("uy", "s"),
           pkg.BC.parse("uz", "a"), pkg.BC.parse("lnrho", "a2"),
           pkg.BC.parse("ss", "c1:cT", lval=lval, hval=cs2cool))
    mag = ()
    if magnetic:
        bcz += (pkg.BC.parse("ax", "a"), pkg.BC.parse("ay", "a"),
                pkg.BC.parse("az", "s"))
        mag = (pkg.Magnetic(eta=4e-3, init="gaussian-noise", ampl=1e-4,
                            **eta3),)
    if shock:
        bcz += (pkg.BC.parse("shock", "s"),)
        visc = dict(visc, ivisc=tuple(visc["ivisc"]) + ("nu-shock",),
                    nu_shock=1.0)
    bcz = _override_bcz(pkg, bcz, bcz_over)
    if heatcond not in ("K-const", "K-profile", "kramers"):
        raise ValueError(f"conv_slab: heatcond={heatcond!r} (K-const, "
                         "K-profile or kramers)")
    heat = dict(iheatcond=(heatcond,), hcond0=8e-3)
    if heatcond == "kramers":
        heat = dict(iheatcond=("kramers",), hcond0_kramers=KRAMERS_K0)
    if chi > 0.0:
        heat = dict(heat, chi=chi, iheatcond=heat["iheatcond"] + (
            "chi-const" if chi_cspeed is None else "chi-cspeed",))
        if chi_cspeed is not None:
            heat["chi_cspeed"] = chi_cspeed
    if tau_cool:
        heat.update(tau_cool=tau_cool,
                    TTref_cool=cs2cool / ((gamma - 1.0) * cp))
    heat.update(cooling_profile=cooling_profile, **(entropy or {}))
    cfg = pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=3), fused=fused, bcz=bcz,
        modules=(pkg.EosIdealGas(gamma=gamma, cs0=1.0, cp=cp),
                 pkg.Density(init="piecew-poly", **den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3, Omega=Omega),
                 pkg.Gravity(gravz_profile="const", gravz=gravz),
                 *((pkg.Shear(Omega=Omega, qshear=1.5,
                              lshearadvection_as_shift=safi),)
                   if shear else ()),
                 pkg.Viscosity(nu=4e-3, **visc),
                 pkg.Entropy(init="piecew-poly", z1=-0.5, z2=0.0, mpoly0=1.0,
                             mpoly1=mpoly1, mpoly2=0.0, isothtop=1,
                             **heat, luminosity=5e-3, wheat=0.1, cool=15.0,
                             wcool=0.2, cs2cool=cs2cool),
                 *mag,
                 *((pkg.Forcing(force=forcing, kf=3.0),) if forcing else ()),
                 *((pkg.Shock(),) if shock else ())))
    return with_upwind(cfg) if upwind else cfg


def _override_bcz(pkg, bcz, bcz_over):
    """``bcz`` with the components of ``bcz_over`` (component → 'low:high'
    or (codes, lval, hval)) given their codes; raises for a component
    ``bcz`` lacks."""
    bcz_over = dict(bcz_over or {})
    comps = [bc.comp for bc in bcz]
    unknown = sorted(set(bcz_over) - set(comps))
    if unknown:
        raise ValueError(f"bcz override of {unknown}: the components are "
                         f"{comps}")
    out = []
    for bc in bcz:
        over = bcz_over.get(bc.comp)
        if over is None:
            out.append(bc)
            continue
        code, lval, hval = (over, bc.lval, bc.hval) \
            if isinstance(over, str) else over
        out.append(pkg.BC.parse(bc.comp, code, lval=lval, hval=hval))
    return tuple(out)


def fgs_sigma():
    """σ_SBt of a black-body top ('Fgs') for ``conv_slab(n,
    heatcond="kramers")``: the flux that its bottom 'c1' lets in on the
    initial state, K(z₀)·0.625 with Kramers' K = K₀T^6.5/ρ², over T⁴ at
    the top, both at the end planes z₀ and z₀ + Lz of the piecewise
    polytrope (the same at every n)."""
    from .physics.stratification import piecew_poly_profiles
    cfg = conv_slab(8, heatcond="kramers")
    gs, eos = cfg.grid, cfg.module("eos")
    ent = cfg.module("entropy")
    z = torch.tensor([gs.z0, gs.z0 + gs.Lz], dtype=torch.float64)
    lnrho, ss = piecew_poly_profiles(
        z, gs, eos, gravz=cfg.module("gravity").gravz, z1=ent.z1, z2=ent.z2,
        mpoly0=ent.mpoly0, mpoly1=ent.mpoly1, mpoly2=ent.mpoly2,
        isothtop=ent.isothtop, width=ent.width)
    cs2 = eos.cs20 * torch.exp(eos.gamma * ss / eos.cp
                               + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
    TT = (cs2 / ((eos.gamma - 1.0) * eos.cp)).tolist()
    rho = torch.exp(lnrho).tolist()
    c1 = next(bc for bc in cfg.bcz if bc.comp == "ss").lval
    flux = KRAMERS_K0 * TT[0] ** 6.5 / rho[0] ** 2 * c1
    return flux / TT[1] ** 4


# conv_slab's Kramers conductivity K = K₀T^6.5/ρ² (n = 1): K₀ such that K
# at z2 = 0 on the initial state, where T = cs20/((γ − 1)cp) = 1.5 and
# lnρ = γ·gravz·(z2 − ztop)/cs20 = 1.6/3 (the isothermal top layer from
# ztop = 0.32), equals the K-const run's hcond0 = 8e-3
KRAMERS_K0 = 8e-3 * math.exp(2.0 * (5.0 / 3.0) * 0.32) / 1.5 ** 6.5


def strat_box(n, fused=True, pkg=None, magnetic=True, shear=True,
              Omega=1.0, forcing=0.0, hyper3=False, entropy=False,
              periodic=False, b_ext=None, safi=False):
    """The isothermal stratified layer: a box x, y, z ∈ [−2, 2] (Lx = Ly
    = Lz = 4), x and y periodic, z walls, isothermal gas (γ = 1, cs0 = 1)
    in hydrostatic balance (``Density(init='isothermal')``), so the scale
    height is H = cs0/Ω = 1; gaussian-noise velocity of amplitude 1e-3,
    ν = 5e-3; 4 fields (uu, lnrho), or 7 (uu, lnrho, aa) with
    ``magnetic``: η = 5e-3 and a gaussian-noise seed A of 1e-3, the
    perfect-conductor walls A_x = A_y = 0, ∂A_z/∂z = 0 ('a', 'a', 's').
    u has stress-free walls with u_z = 0 ('s', 's', 'a') and lnρ the
    linear extrapolation 'a2'.  ``n`` is an int (a cube) or (nx, ny, nz).

    ``shear`` (the default) makes it the vertically stratified isothermal
    shearing box: vertical gravity g_z = −Ω²z ('linear-z'), Keplerian
    shear q = 3/2 at the rotation rate ``Omega`` (which must be > 0) with
    its Coriolis force; with ``magnetic`` the MRI box of Stone, Hawley,
    Gammie & Balbus 1996 (ApJ 463, 656); ``safi`` advects by the shear
    flow as a shift after each substep (``lshearadvection_as_shift``),
    as the MRI boxes of Johansen, Youdin & Klahr 2009 (ApJ 697, 1269) do.
    Without it, constant gravity
    g_z = −1 and no rotation: isothermal stratified turbulence, forced
    with ``forcing`` > 0 (helical forcing of that amplitude at kf = 3,
    kicked after each step), the set-up of the negative effective
    magnetic pressure runs (Brandenburg, Kemel, Kleeorin, Mitra &
    Rogachevskii 2011, ApJ 740, L50), whose horizontal imposed field
    ``b_ext`` = (0, B0, 0) adds (``Magnetic.B_ext``; this repository runs
    B0 = ``NEMPI_B0`` = 0.01, below equipartition with the forced flow).
    ``hyper3`` adds del6 hyper-diffusion of u, lnρ and (with Magnetic) A
    with ν₃ = D₃ = η₃ = 5e-3·dx⁵, as ``conv_slab`` does (``"mesh"``: the
    mesh flavour on u and lnρ).

    ``entropy`` gives the gas an energy equation: an ideal gas with γ =
    5/3 (cs0 = 1, cp = 1) and an entropy field with 'chi-const'
    conduction, χ = ν = 5e-3, viscous (and with Magnetic Ohmic) heating,
    as ``forced_entropy`` has; 5 fields (uu, lnrho, ss) or 8 with aa.  It
    starts in the isothermal hydrostatic state with the matching ss =
    −(cp − cv)(lnρ − lnρ0) (the additive '+ss' of Density 'isothermal'),
    where T = T0; ss has the wall BC 'a2', as lnρ.  With the shear the
    vertically stratified shearing box with an energy equation.

    ``periodic`` makes z periodic (no z walls, no bcz) under the periodic
    gravity g_z = −sin(κz) with κ = π/2, one period over Lz = 4
    (``Gravity('sin-z')``), whose hydrostatic state Φ = −cos(κz)/κ holds
    a stratified layer in a triply periodic box: forced stratified
    turbulence with ``shear=False`` and ``forcing`` > 0 (``shear=True``
    raises: the shear box's x faces and a z wall-less layer are not this
    configuration).

    The values are this configuration's own, not a reference sample's."""
    if periodic and shear:
        raise ValueError("strat_box: periodic=True takes shear=False "
                         "(the sheared box has z walls)")
    if shear and not Omega > 0.0:
        raise ValueError("strat_box: shear=True needs Omega > 0 "
                         "(S = -q Omega, g_z = -Omega^2 z)")
    if safi and not shear:
        raise ValueError("strat_box: safi=True needs shear=True")
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz, x0=-2.0, y0=-2.0, z0=-2.0,
                        Lx=4.0, Ly=4.0, Lz=4.0,
                        periodic=(True, True, periodic))
    den, visc, eta3 = _hyper3(pkg, grid, hyper3)
    bcz = (pkg.BC.parse("ux", "s"), pkg.BC.parse("uy", "s"),
           pkg.BC.parse("uz", "a"), pkg.BC.parse("lnrho", "a2"))
    if entropy:
        bcz += (pkg.BC.parse("ss", "a2"),)
    mag = ()
    if magnetic:
        bcz += (pkg.BC.parse("ax", "a"), pkg.BC.parse("ay", "a"),
                pkg.BC.parse("az", "s"))
        mag = (_magnetic(pkg, b_ext, eta=5e-3, init="gaussian-noise",
                         ampl=1e-3, **eta3),)
    elif b_ext is not None:
        raise ValueError("strat_box: b_ext needs magnetic=True")
    if periodic:
        rot = (pkg.Gravity(gravz_profile="sin-z", gravz=-1.0,
                           kappa_z=math.pi / 2.0),)
    elif shear:
        rot = (pkg.Gravity(gravz_profile="linear-z", gravz=-Omega ** 2),
               pkg.Shear(Omega=Omega, qshear=1.5,
                         lshearadvection_as_shift=safi))
    else:
        rot = (pkg.Gravity(gravz_profile="const", gravz=-1.0),)
    eos, ent = _energy(pkg, entropy, 5e-3)
    return pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=3), fused=fused,
        bcz=() if periodic else bcz,
        modules=(eos,
                 pkg.Density(init="isothermal", **den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3,
                           Omega=Omega if shear else 0.0),
                 *rot,
                 pkg.Viscosity(nu=5e-3, **visc),
                 *mag, *ent,
                 *((_forcing(pkg, forcing, grid),) if forcing else ())))


# the imposed field of the negative-effective-magnetic-pressure box
# (``strat_box(n, shear=False, forcing=0.05, b_ext=(0, NEMPI_B0, 0))``): a
# horizontal field well below equipartition with the forced flow
NEMPI_B0 = 0.01


def _forcing(pkg, force, grid, fcont=None):
    """The Forcing module: helical forcing of amplitude ``force`` at kf =
    3, kicked after each step, or with ``fcont`` = (profile, ampl_ff,
    k1_ff) the continuous forcing of that profile in the RHS alone (force
    = 0: no kick); the 'xz' envelope over ``grid``'s x and z extent, as
    the run-directory loader sets it."""
    if fcont is None:
        return pkg.Forcing(force=force, kf=3.0)
    prof, ampl, k1 = fcont
    return pkg.Forcing(force=0.0, kf=3.0, lforcing_cont=True,
                       iforcing_cont=prof, ampl_ff=ampl, k1_ff=k1,
                       fcont_box=(grid.x0, grid.x0 + grid.Lx, grid.z0,
                                  grid.z0 + grid.Lz))


def _magnetic(pkg, b_ext=None, **kw):
    """Magnetic with ``kw`` and, where ``b_ext`` is given, that imposed
    uniform field."""
    return pkg.Magnetic(**kw, **({} if b_ext is None else
                                 dict(B_ext=tuple(float(b) for b in b_ext))))


# the coefficient of the mesh flavours of del6 ('hyper3-mesh',
# diffrho_hyper3_mesh): the JAX Viscosity's default ν₃ᵐ, resolution-free
MESH_HYPER3 = 5.0


def _hyper3(pkg, gs, hyper3):
    """(Density, Viscosity, Magnetic keyword arguments) of del6
    hyper-diffusion with h3 = 5e-3·dx⁵ where ``hyper3``, else ({}, {}, {})
    and the viscosity's 'nu-const' alone: ν₃ = η₃ = D₃ = h3, the shear box's
    rule, which keeps the del6 CFL rate at about a third of the advective
    rate at every n on the 2π box.  ``hyper3="mesh"``: the mesh flavour
    on u and lnρ ('hyper3-mesh', ``diffrho_hyper3_mesh``, ν₃ᵐ = D₃ᵐ =
    ``MESH_HYPER3``) and η₃ = h3 on A (the Magnetic module has no mesh
    flavour, in JAX as here)."""
    if not hyper3:
        return {}, dict(ivisc=("nu-const",)), {}
    h3 = 5e-3 * gs.dx ** 5
    if hyper3 == "mesh":
        return (dict(diffrho_hyper3_mesh=MESH_HYPER3),
                dict(ivisc=("nu-const", "hyper3-mesh"),
                     nu_hyper3_mesh=MESH_HYPER3),
                dict(eta_hyper3=h3))
    return (dict(diffrho_hyper3=h3),
            dict(ivisc=("nu-const", "hyper3-simplified"), nu_hyper3=h3),
            dict(eta_hyper3=h3))


def shear_box(n, fused=True, pkg=None, magnetic=True, shock=True,
              entropy=False, safi=False, hyper3=True,
              remove_mean_momenta=False):
    """A sheared, rotating MHD box with shock viscosity and
    hyper-diffusion, the accretion-disk set-up of shearing-box MRI users:
    a unit cube centred on the origin, fully periodic with shear-periodic
    x faces (Keplerian shear q = 3/2, Ω = 1, Coriolis on), isothermal gas
    (cs = 1), ν = η = 5e-4, shock viscosity ν_sh = 1, and del6
    hyper-diffusion of u, A and lnρ; unforced; 8 slots (uu, lnrho, aa and
    the shock profile).  ``n`` is an int (a cube) or (nx, ny, nz).  The
    values are this configuration's own, not a reference sample's.

    ``shock=False`` drops the Shock module and 'nu-shock': the shearing
    box as most MRI users run it (Hawley, Gammie & Balbus 1995); 7 fields.
    ``magnetic=False`` drops Magnetic and forces the flow instead
    (non-helical, amplitude 0.05 at kf = 3): the forced shear flow of the
    shear-dynamo studies (Yousef et al. 2008) without its field; 5 slots
    (uu, lnrho, shock), or 4 without the shock slot.  ``entropy`` makes
    the gas an ideal gas with γ = 5/3 (cs0 = 1, cp = 1) and an entropy
    field with 'chi-const' conduction, χ = ν = 5e-4, and viscous (with
    Magnetic also Ohmic) heating: the forced hydro shear flow with an
    energy equation, 6 slots (uu, lnrho, ss, shock), or 5 without the
    shock slot.

    The hyper-diffusivity h3 = 5e-3·(1/n)⁵ keeps the del6 CFL rate
    h3·dxyz6/cdtv3 (cdtv3 = 0.01) at about half the advective rate at
    every n, so the term shows at 16³ and stays stable at 256³.
    ``hyper3="mesh"`` puts the mesh flavour on u and lnρ in its place
    ('hyper3-mesh' and ``diffrho_hyper3_mesh`` at ``MESH_HYPER3``, the
    resolution-free normalisation of the reference's shearing-box runs),
    η₃ = h3 staying on A; ``hyper3=False`` drops del6.

    ``safi`` advects by the shear flow as a shift after each substep
    (``lshearadvection_as_shift``: SAFI, Johansen, Youdin & Klahr 2009,
    ApJ 697, 1269), exact, so the flow's |S x|/Δy leaves the CFL.
    ``remove_mean_momenta`` takes the volume-mean momentum out of u after
    each step (``lremove_mean_momenta``), the shearing box's guard against
    a mean wind.
    """
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz, x0=-0.5, y0=-0.5, z0=-0.5,
                        Lx=1.0, Ly=1.0, Lz=1.0)
    den, visc, eta3 = _hyper3(pkg, grid, hyper3)
    if shock:
        visc = dict(visc, ivisc=visc["ivisc"][:1] + ("nu-shock",)
                    + visc["ivisc"][1:], nu_shock=1.0)
    tail = ((pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-4,
                          **eta3),) if magnetic
            else (pkg.Forcing(force=0.05, kf=3.0, relhel=0.0),))
    eos, ent = _energy(pkg, entropy, 5e-4)
    return pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(eos,
                 pkg.Density(init="gaussian-noise", ampl=1e-2, **den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-2, Omega=1.0,
                           **_mean_removal(remove_mean_momenta)),
                 pkg.Shear(Omega=1.0, qshear=1.5,
                           lshearadvection_as_shift=safi),
                 pkg.Viscosity(nu=5e-4, **visc),
                 *tail, *ent,
                 *((pkg.Shock(),) if shock else ())))


def _mean_removal(on):
    """Hydro's keyword for ``lremove_mean_momenta`` where ``on``, else
    none (the configuration of before)."""
    return dict(lremove_mean_momenta=True) if on else {}


def _energy(pkg, entropy, chi):
    """(EOS, (Entropy,) or ()) of the shock and shear boxes: the
    isothermal gas (cs = 1), or with ``entropy`` an ideal gas with γ = 5/3
    (cs0 = 1, cp = 1) and 'chi-const' conduction with χ = ``chi``."""
    if not entropy:
        return pkg.EosIdealGas(gamma=1.0, cs0=1.0), ()
    return (pkg.EosIdealGas(gamma=5.0 / 3.0, cs0=1.0, cp=1.0),
            (pkg.Entropy(iheatcond=("chi-const",), chi=chi),))


def shock_box(n, fused=True, pkg=None, magnetic=True, entropy=False,
              shock_diffusion=False):
    """Supersonic forced MHD turbulence with shock viscosity, the Pencil
    Code's shock-capturing set-up (Haugen, Brandenburg & Mee 2004, MNRAS
    353, 947): the default 2π cube, fully periodic, isothermal gas
    (cs = 1), ν = η = 1e-3, shock viscosity ν_sh = 1, non-helical forcing
    (relhel = 0) of amplitude 0.2 at kf = 3; 8 slots (uu, lnrho, aa and the
    shock profile).  ``magnetic=False`` drops Magnetic: supersonic
    isothermal hydro turbulence with shock viscosity, the
    compressible-turbulence benchmark of Kritsuk et al. 2007 (ApJ 665,
    416); 5 slots (uu, lnrho, shock).  ``entropy`` makes the gas an ideal
    gas with γ = 5/3 (cs0 = 1, cp = 1) and an entropy field with
    'chi-const' conduction, χ = ν = 1e-3, and viscous (shock heating
    included) and Ohmic heating: supersonic turbulence with an energy
    equation, 6 slots without Magnetic (uu, lnrho, ss, shock), 9 with it.
    ``shock_diffusion`` completes the shock-capturing set beside ν_sh:
    shock diffusion of lnρ D_sh = 1 (``diffrho_shock``), with Magnetic
    the shock resistivity η_sh = 1 (``eta_shock``) and with ``entropy``
    shock heat conduction χ_sh = 1 (iheatcond 'shock' beside chi-const),
    each of the size of ν_sh, so each spreads a shock over the same few
    cells.  ``n`` is an int (a cube) or (nx, ny, nz).  The values are this
    configuration's own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    mag = ((pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=1e-3),)
           if magnetic else ())
    eos, ent = _energy(pkg, entropy, 1e-3)
    cfg = pkg.Config(
        grid=pkg.GridSpec(nx=nx, ny=ny, nz=nz),
        time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(eos,
                 pkg.Density(),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-2),
                 pkg.Viscosity(ivisc=("nu-const", "nu-shock"), nu=1e-3,
                               nu_shock=1.0),
                 *mag, *ent,
                 pkg.Shock(),
                 pkg.Forcing(force=0.2, kf=3.0, relhel=0.0)))
    return with_shock_diffusion(cfg) if shock_diffusion else cfg


def forced_hydro(n, fused=True, pkg=None, Omega=0.0, hyper3=False,
                 fcont=None):
    """Forced isothermal hydro turbulence, the flagship without Magnetic
    (BASELINE config 2): the default 2π cube, fully periodic, isothermal
    gas (cs = 1), ν = 5e-3, helical forcing of amplitude 0.07 at kf = 3;
    4 fields (uu, lnrho).  ``Omega`` > 0 adds the Coriolis force of a
    rotation about z; ``hyper3`` del6 hyper-diffusion of u and lnρ with
    ν₃ = D₃ = 5e-3·dx⁵ ('hyper3-simplified', ``diffrho_hyper3``), ν
    unchanged.  ``fcont`` = (profile, ampl_ff, k1_ff) drives the flow by
    continuous forcing of that profile in place of the kicks (force =
    0): ('RobertsFlow', a, 1) is the Roberts flow (Roberts 1972, Phil.
    Trans. R. Soc. A 271, 411), the steady helical columns of the
    Roberts-flow dynamo.  ``n`` is an int (a cube) or (nx, ny, nz).  The
    values are this repository's own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz)
    den, visc, _ = _hyper3(pkg, grid, hyper3)
    return pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(lupw_lnrho=False, **den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3, Omega=Omega),
                 pkg.Viscosity(nu=5e-3, **visc),
                 _forcing(pkg, 0.07, grid, fcont)))


def flagship(n, fused=True, pkg=None, itorder=3, dt=0.0, hyper3=False,
             b_ext=None, fcont=None, upwind=False,
             remove_mean_momenta=False):
    """Forced isothermal MHD turbulence, the package's headline workload
    (the configuration ``bench.py`` times): the default 2π cube, fully
    periodic, isothermal gas (cs = 1), ν = η = 5e-3, gaussian-noise u and A,
    helical forcing of amplitude 0.07 at kf = 3; 7 fields (uu, lnrho, aa).
    ``itorder`` is the 2N-RK order; ``dt`` > 0 fixes the time step;
    ``hyper3`` adds del6 hyper-diffusion of u, A and lnρ with ν₃ = η₃ =
    D₃ = 5e-3·dx⁵ ('hyper3-simplified', ``eta_hyper3``,
    ``diffrho_hyper3``: hyper-diffusive turbulence, a longer inertial
    range at a given n), ν and η unchanged.  ``b_ext`` = (Bx, By, Bz) adds
    an imposed uniform field (``Magnetic.B_ext``): forced MHD turbulence
    in an imposed field, as the imposed-field runs of the Pencil Code's
    users drive it.  ``fcont`` = (profile, ampl_ff, k1_ff) drives the flow
    by continuous forcing of that profile in place of the kicks (force =
    0): ('ABC', a, 1) is the ABC-flow dynamo (Galloway & Frisch 1986,
    Geophys. Astrophys. Fluid Dyn. 36, 53).  ``upwind`` upwinds the
    advection of lnρ and u (``lupw_lnrho``, ``lupw_uu``: 5th-order
    upwinding, the reference's der6_upwind, which damps the grid-scale
    wiggles of advection), ν and η unchanged.  ``hyper3="mesh"`` takes
    the mesh flavour of del6 on u and lnρ in place of h3 (``_hyper3``).
    ``remove_mean_momenta`` takes the volume-mean momentum out of u after
    each step, before the forcing kick (``lremove_mean_momenta``).  ``n``
    is an int (a cube) or (nx, ny, nz).  The values are this repository's
    own, not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz)
    den, visc, mag = _hyper3(pkg, grid, hyper3)
    cfg = pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=itorder, dt=dt), fused=fused,
        modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                 pkg.Density(lupw_lnrho=False, **den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3,
                           **_mean_removal(remove_mean_momenta)),
                 pkg.Viscosity(nu=5e-3, **visc),
                 _magnetic(pkg, b_ext, init="gaussian-noise", ampl=1e-4,
                           eta=5e-3, **mag),
                 _forcing(pkg, 0.07, grid, fcont)))
    return with_upwind(cfg) if upwind else cfg


def forced_entropy(n, magnetic=True, fused=True, pkg=None, Omega=0.0,
                   hyper3=False):
    """Non-isothermal forced turbulence, the flagship with an entropy
    field: the default 2π cube, fully periodic, an ideal gas with γ = 5/3
    (cs0 = 1, cp = 1), ν = 5e-3, thermal diffusion 'chi-const' with
    χ = 5e-3, viscous heating, helical forcing of amplitude 0.07 at
    kf = 3; with ``magnetic`` also A with η = 5e-3, the Lorentz force and
    Ohmic heating.  8 fields (uu, lnrho, ss, aa), or 5 (uu, lnrho, ss)
    without Magnetic.  ``Omega`` > 0 adds the Coriolis force of a rotation
    about z; ``hyper3`` del6 hyper-diffusion of u, lnρ and (with Magnetic)
    A with ν₃ = D₃ = η₃ = 5e-3·dx⁵, as in ``flagship``.  ``n`` is an int
    (a cube) or (nx, ny, nz).  The values are this repository's own (the
    flagship's, plus χ = ν), not a reference sample's."""
    pkg = pkg or sys.modules[__name__.rsplit(".", 1)[0]]
    nx, ny, nz = (n, n, n) if isinstance(n, int) else n
    grid = pkg.GridSpec(nx=nx, ny=ny, nz=nz)
    den, visc, eta3 = _hyper3(pkg, grid, hyper3)
    mag = (pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3,
                        **eta3),) if magnetic else ()
    return pkg.Config(
        grid=grid, time=pkg.TimeSpec(itorder=3), fused=fused,
        modules=(pkg.EosIdealGas(gamma=5.0 / 3.0, cs0=1.0, cp=1.0),
                 pkg.Density(**den),
                 pkg.Hydro(init="gaussian-noise", ampl=1e-3, Omega=Omega),
                 pkg.Viscosity(nu=5e-3, **visc),
                 pkg.Entropy(iheatcond=("chi-const",), chi=5e-3),
                 *mag,
                 pkg.Forcing(force=0.07, kf=3.0)))


# the paths of Viscosity's other flavours and Density's diffrho, each a
# configuration function of this module, its keyword arguments and the
# flavours (with_viscosity's) that replace its viscosity; a coefficient
# given as a callable of the grid spacing dx is evaluated at the run's n
VISCOSITY_PATHS = {
    # the momentum-conserving form with a constant dynamic viscosity, and
    # mass diffusion D = ν, on the flagship (K1-K3)
    "flagship rho-nu-const": ("flagship", {}, ("rho-nu-const",),
                              dict(nu=5e-3, diffrho=5e-3)),
    # ν∇²u with an anisotropic del6 whose z coefficient is half the
    # others' (the H3 instances of forced hydro)
    "forced hydro aniso": ("forced_hydro", dict(hyper3=True),
                           ("nu-simplified", "hyper3_nu-const_aniso"),
                           dict(nu_aniso_hyper3=lambda dx: (
                               5e-3 * dx ** 5, 5e-3 * dx ** 5,
                               2.5e-3 * dx ** 5))),
    # supersonic turbulence with an energy equation under bulk and simple
    # shock viscosities (K1she, K5whe)
    "shock box bulk": ("shock_box", dict(magnetic=False, entropy=True),
                       ("rho-nu-const", "rho-nu-const-bulk", "shock-simple"),
                       dict(nu=1e-3, zeta=1e-3, nu_shock=1.0)),
    # stratified convection with μ = const and mass diffusion (K6/K7)
    "conv-slab rho-nu-const": ("conv_slab", {}, ("rho-nu-const",),
                               dict(diffrho=4e-3)),
    # magnetoconvection with ν ∝ T^½ (K6m/K7m)
    "magnetoconvection nu-therm": ("conv_slab", dict(magnetic=True),
                                   ("nu-therm",), dict(nu_cspeed=0.5)),
    # the MHD shear box with μ = const beside ν_sh and mass diffusion
    # (K4/K5, their H3 instances)
    "shear box rho-nu-const": ("shear_box", {}, ("rho-nu-const", "nu-shock"),
                               dict(diffrho=5e-4)),
}


def viscosity_path(label, n, fused=True, pkg=None):
    """The configuration of VISCOSITY_PATHS[label] at ``n`` (an int or
    (nx, ny, nz)) in ``pkg``'s classes."""
    make, kw, ivisc, coeffs = VISCOSITY_PATHS[label]
    cfg = globals()[make](n, fused=fused, pkg=pkg, **kw)
    dx = cfg.grid.dx
    return with_viscosity(cfg, ivisc, **{
        k: v(dx) if callable(v) else v for k, v in coeffs.items()})

