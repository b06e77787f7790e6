"""Viscosity's other flavours and Density's Fickian ``diffrho`` in
pencil_tpu_torch against pencil_tpu on the CPU: 'nu-simplified',
'rho-nu-const', 'rho-nu-const-bulk' (ζ), 'hyper3_nu-const_aniso',
'shock-simple', 'hyper3-nu-const', 'hyper3-rho-nu-const-symm' and
'nu-cspeed'/'nu-therm', each under its JAX aliases, with 'nu-const' no
longer required.

Each flavour's Viscosity.rhs (force, heat pencil, CFL terms) and
Density's diffrho against the JAX modules on the same pencils; ``der5``,
``d5_raw`` and ``grad5divu`` against JAX's; two steps of the six paths of
``configs.VISCOSITY_PATHS`` through the port's fused chain (its kernels'
plain versions) and its eager path against the JAX fused step (Pallas in
interpret mode, one tile over the domain: PC_TX = PC_CX = nx) and the JAX
jnp path, and of 'hyper3-nu-const' and the symmetric flavour through the
eager path against the jnp path (the JAX fused path raises on the first);
the card's refusals, each by name; the two faults of the reference
(ROADMAP Queue 3).  At 8×8×16, inputs from numpy with a seed.  Bounds,
those of tests/test_fused.py: each field within 2e-5 × its max, dt within
1e-6 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.ops import stencil as jst
from pencil_tpu.parallel.halo import fill_ghosts as jax_fill_ghosts
from pencil_tpu.physics.base import TimestepAccum as JaxTimestepAccum
from pencil_tpu.physics.pencils import Pencils as JaxPencils
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import (conv_slab, flagship, forced_entropy,
                                      forced_hydro, shear_box, shock_box,
                                      viscosity_path, with_upwind,
                                      with_viscosity)
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops import stencil as st
from pencil_tpu_torch.physics.base import TimestepAccum
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_bext import evolved
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import assert_field_close, assert_states_close

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
NSTEPS = 2
TSTART = 0.37
UU_AMPL, AA_AMPL = 5e-2, 1e-2
H3 = 1e-5      # ν₃ of the del6 flavours on the 8×8×16 pencils

# each flavour set of the module tests, with its coefficients
FLAVOURS = {
    "nu-simplified": (("nu-simplified",), {}),
    "alias 0, 1": (("0", "1"), {}),
    "rho-nu-const": (("rho-nu-const",), {}),
    "bulk": (("rho_nu-const", "rho-nu-const-bulk"), dict(zeta=2e-3)),
    "aniso": (("hyper3_nu-const_aniso",),
              dict(nu_aniso_hyper3=(H3, 2 * H3, 0.5 * H3))),
    "shock alias": (("shock",), {}),
    "shock-simple": (("shock_simple", "nu-const"), {}),
    "hyper3-nu-const": (("hyper3-nu-const",), {}),
    "symm": (("hyper3-rho-nu-const-symm",), {}),
    "nu-therm": (("nu-therm",), dict(nu_cspeed=0.7)),
    "every flavour, reversed": (tuple(reversed((
        "nu-const", "simplified", "rho-nu-const", "rho-nu-const-bulk",
        "hyper3_nu-const_aniso", "nu-shock", "shock-simple",
        "hyper3-rho-nu-const-symm", "nu-cspeed", "hyper3-mesh"))),
        dict(zeta=2e-3, nu_aniso_hyper3=(H3, H3, H3))),
}


def _set_viscosity(cfg, ivisc, **kw):
    return with_viscosity(cfg, ivisc, nu=5e-3, nu_shock=0.5, nu_hyper3=H3,
                          **kw)


@pytest.fixture(scope="module")
def pencils():
    """(JAX cfg, the port's cfg, ghosted states of each) of the hydro
    shock box with ss (uu, lnrho, ss, shock), one noisy state with a
    positive shock slot at 8×8×16."""
    jm = pj.Model(shock_box(SHAPE, pkg=pj, magnetic=False, entropy=True,
                            fused=False))
    pm = pt.Model(shock_box(SHAPE, magnetic=False, entropy=True),
                  device="cpu")
    rng = np.random.default_rng(4)
    amp = np.array([UU_AMPL] * 3 + [5e-2, 1e-2], np.float32)
    fa = np.concatenate([
        amp[:, None, None, None] * rng.standard_normal((5,) + SHAPE),
        0.1 * rng.random((1,) + SHAPE)]).astype(np.float32)
    fg = jax_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                         jm.grid, jm.cfg, jm.eos)
    return jm, pm, fg, pm.ghosted(torch.tensor(fa))


def _module_run(model, fg, pens, pkg, name, ivisc, kw, ts_cls):
    cfg = _set_viscosity(model.cfg, ivisc, **kw)
    pen = pens(fg, model.grid, model.reg, cfg, model.eos)
    df, ts = {}, ts_cls()
    cfg.module(name).rhs(pen, df, ts)
    return df, ts, pen._cache.get("visc_heat")


def _close(got, want, what):
    if want is None:
        assert got is None, what
        return
    if isinstance(want, float):
        assert isinstance(got, float) and got == want, what
        return
    got, want = torch.as_tensor(got).numpy(), np.asarray(want)
    # a uniform rate: JAX's dline_1 is a field, the port's a scalar
    got = np.broadcast_to(got, want.shape)
    if want.ndim == 4:
        for c in range(want.shape[0]):
            assert_field_close(got[c], want[c], f"{what}[{c}]")
    else:
        assert_field_close(got, want, what)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_viscosity_rhs_matches_jax(pencils, flavour):
    """Each flavour set's force, heat pencil and CFL terms against the JAX
    module's on the same pencils, the port summing in the JAX order
    whatever the order of ``ivisc``."""
    jm, pm, fg, pg = pencils
    ivisc, kw = FLAVOURS[flavour]
    jdf, jts, jheat = _module_run(
        jm, fg, JaxPencils, pj, "viscosity", ivisc, kw, JaxTimestepAccum)
    pdf, pts, pheat = _module_run(
        pm, pg, lambda *a: Pencils(*a, ghosted=True), pt, "viscosity",
        ivisc, kw, TimestepAccum)
    _close(pdf["uu"], jdf["uu"], "fvisc")
    _close(pheat, jheat, "visc_heat")
    for acc in ("maxdiffus", "maxdiffus3", "advec2_hypermesh"):
        _close(getattr(pts, acc), getattr(jts, acc), acc)


@pytest.mark.parametrize("diffrho", (0.0, 3e-3))
def test_density_rhs_with_diffrho_matches_jax(pencils, diffrho):
    """Density's lnρ RHS with D(∇²lnρ + |∇lnρ|²) and its rate D, beside
    the shock diffusion (the module's order: diffrho first)."""
    jm, pm, fg, pg = pencils
    out = []
    for model, pens, pkg, ts_cls, g in (
            (jm, JaxPencils, pj, JaxTimestepAccum, fg),
            (pm, lambda *a: Pencils(*a, ghosted=True), pt, TimestepAccum,
             pg)):
        cfg = model.cfg.replace(modules=tuple(
            dataclasses.replace(m, diffrho=diffrho, diffrho_shock=0.3)
            if m.name == "density" else m for m in model.cfg.modules))
        df, ts = {}, ts_cls()
        cfg.module("density").rhs(pens(g, model.grid, model.reg, cfg,
                                       model.eos), df, ts)
        out.append((df["lnrho"], ts.maxdiffus))
    (jl, jd), (pl, pd) = out
    _close(pl, jl, "dlnrho")
    _close(pd, jd, "maxdiffus")


def test_der5_and_grad5divu_match_jax(pencils):
    """The 5th difference on each axis (ghosted, and wrapped where JAX
    slices a ghosted copy) and the symmetric flavour's grad5divu."""
    jm, pm, fg, pg = pencils
    for a in range(3):
        want = np.asarray(jst.der5(fg, a, None))
        got = st.der5(pg, a, wrap=False)
        crop = [slice(None)] + [slice(3, -3) if b != a else slice(None)
                                for b in range(3)]
        assert_field_close(got[tuple(crop)].numpy(),
                           want[tuple(crop)], f"der5 axis {a}")
        # the grid is periodic: the wrapped 5th difference of the interior
        # is the ghosted one
        wrapped = st.der5(pg[..., 3:-3, 3:-3, 3:-3], a)
        assert_field_close(wrapped.numpy(), want[tuple(crop)],
                           f"der5 wrapped axis {a}")
    jp = JaxPencils(fg, jm.grid, jm.reg, jm.cfg, jm.eos)
    pp = Pencils(pg, pm.grid, pm.reg, pm.cfg, pm.eos, ghosted=True)
    for a in range(3):
        _close(pp.d5_raw("uu", a), jp.d5_raw("uu", a), f"d5_raw {a}")
    _close(pp.grad5divu(), jp.grad5divu(), "grad5divu")


# ---- the paths --------------------------------------------------------------
def _sheared(pkg, cfg):
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))


def _path(label):
    def make(pkg, fused):
        cfg = viscosity_path(label, SHAPE, fused=fused, pkg=pkg)
        return _sheared(pkg, cfg) if label.startswith("shear") else cfg
    return make


# each path: (make(pkg, fused), the port's fused mode, whether JAX fuses)
RUNS = {label: (_path(label), mode, True) for label, mode in (
    ("flagship rho-nu-const", "wrap"), ("forced hydro aniso", "wrap"),
    ("shock box bulk", "wrap_aux"), ("conv-slab rho-nu-const", "zghost"),
    ("magnetoconvection nu-therm", "zghost"),
    ("shear box rho-nu-const", "zroll"))}
RUNS.update({
    # JAX's fused path raises on it: the eager path against the jnp path
    "flagship hyper3-nu-const": (lambda pkg, fused: with_viscosity(
        flagship(SHAPE, pkg=pkg, fused=fused),
        ("nu-const", "hyper3-nu-const"), nu_hyper3=H3), None, False),
    # the card refuses it: the eager path against both JAX paths
    "forced entropy symm": (lambda pkg, fused: with_viscosity(
        forced_entropy(SHAPE, pkg=pkg, fused=fused, magnetic=False),
        ("rho-nu-const", "hyper3-rho-nu-const-symm"), nu_hyper3=H3),
        None, True),
})


def start_overrides(slots, seed):
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32)}
    if "aa" in slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + SHAPE)) \
            .astype(np.float32)
    return over


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    """One path: NSTEPS steps of the JAX fused (where JAX fuses it) and
    jnp paths and of the port's fused chain (where the card takes it) and
    eager path, all from the JAX init with u (and A) replaced by numpy
    noise, the forced ones kicked with the JAX step's own draws."""
    make, mode, jax_fuses = RUNS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        fuses = (True, False) if jax_fuses else (False,)
        jms = {f: pj.Model(make(pj, f)) for f in fuses}
        pms = {f: pt.Model(make(pt, f), device="cpu")
               for f in ((True, False) if mode else (False,))}
        if mode:
            assert pms[True].mode == mode
            assert fr.kernel_params(pms[True]).visx == 1
        over = start_overrides(pms[False].reg.slots, 11)
        out = {}
        for fused, jm in jms.items():
            js = jm.init_state(5, overrides=over)
            fields = {k: np.asarray(v) for k, v in js["fields"].items()}
            draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
                     if pms[False].forcing is not None else None)
            step = jm.make_step()
            for _ in range(NSTEPS):
                js = step(js)
            out["jax_fused" if fused else "jax_jnp"] = js
        for fused, pm in pms.items():
            ps = pm.init_state(5, overrides=overrides_from_numpy(fields,
                                                                 pm.reg))
            if pm.forcing is not None:
                pm.forcing_draws = iter(draws).__next__
            step = pm.make_step()
            for _ in range(NSTEPS):
                ps = step(ps)
            out["chain" if fused else "eager"] = ps
    return out


def test_chain_matches_jax_fused(runs):
    """The port's chain (its eager path where the card refuses the
    flavour) against the JAX fused step, the shock slot too; JAX fuses
    every path but 'hyper3-nu-const' (test_jax_fused_hyper3_nu_const_
    reference_fault)."""
    if "jax_fused" not in runs:
        assert runs["eager"]["fields"]["uu"].shape[1:] == SHAPE
        return
    assert_states_close(runs["jax_fused"], runs.get("chain", runs["eager"]))


def test_eager_step_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["eager"]))


# ---- the modules, the gate and the reference ------------------------------
def test_viscosity_without_nu_const():
    """'rho-nu-const' alone builds and runs: nu-const's coefficient is 0
    (the kernels' ν), its own ν goes to the kernels' ν/ρ term."""
    visc = pt.Viscosity(ivisc=("rho-nu-const",), nu=5e-3)
    assert visc.coefficients() == (0.0, 0.0, 0.0)
    assert [k for k, c in visc.terms().items()
            if (any(c) if isinstance(c, tuple) else c > 0.0)] \
        == ["rho-nu-const"]
    cfg = with_viscosity(forced_hydro(SHAPE), ("rho-nu-const",), nu=5e-3)
    p = fr.kernel_params(pt.Model(cfg, device="cpu"))
    assert p.nu == 0.0 and p.nu_r == np.float32(5e-3) and p.visx == 1
    assert p.maxdif == 0.0 and p.dif == 0.0 and p.two_nu == 0.0
    p0 = fr.kernel_params(pt.Model(forced_hydro(SHAPE), device="cpu"))
    assert p0.visx == 0 and p0.nu_r == 0.0


@pytest.mark.parametrize("make, match", [
    (lambda: pt.Viscosity(ivisc=("nu-const", "nu-mixture")), "nu-mixture"),
    (lambda: pt.Viscosity(ivisc=("hyper3-sph",)), "hyper3-sph"),
    (lambda: pt.Viscosity(ivisc=("hyper3_cyl",)), "hyper3_cyl"),
    (lambda: pt.Viscosity(limplicit_viscosity=True), "limplicit_viscosity"),
    (lambda: pt.Viscosity(ivisc=("nu-const", "nu-const")), "nu-const"),
    (lambda: pt.Density(diffrho_hyper3_aniso=(1e-9, 0.0, 0.0)),
     "diffrho_hyper3_aniso"),
    (lambda: pt.Density(lhyper3_polar=True), "lhyper3_polar")])
def test_refused_on_every_device_by_name(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make()


# the card's refusals: each configuration and what its refusal names (the
# flavour; for the instances built without the terms, the spill)
CARD_REFUSED = {
    "hyper3-nu-const": lambda: with_viscosity(
        flagship(SHAPE), ("nu-const", "hyper3-nu-const"), nu=5e-3,
        nu_hyper3=H3),
    "hyper3-rho-nu-const-symm": lambda: with_viscosity(
        forced_entropy(SHAPE), ("hyper3-rho-nu-const-symm",),
        nu_hyper3=H3),
    "nu-cspeed": lambda: with_viscosity(forced_entropy(SHAPE),
                                        ("nu-const", "nu-cspeed"), nu=5e-3),
    "hyper3_nu-const_aniso": lambda: with_viscosity(
        flagship(SHAPE, hyper3=True),
        ("nu-const", "hyper3-simplified", "hyper3_nu-const_aniso"),
        nu=5e-3, nu_hyper3=H3, nu_aniso_hyper3=(H3, H3, H3)),
    "K1 UPW, at 128 registers, would spill": lambda: with_upwind(
        with_viscosity(forced_hydro(SHAPE), ("nu-const",), nu=5e-3,
                       diffrho=1e-3)),
}


@pytest.mark.parametrize("name", sorted(CARD_REFUSED))
def test_card_refuses_by_name(name):
    """On the card each raises NotImplementedError naming the flavour (or
    the instance that would spill), before any launch; on the CPU the
    eager path runs it."""
    cfg = CARD_REFUSED[name]()
    assert name in gate_reason(cfg)
    with pytest.raises(NotImplementedError, match=name):
        fused_gate(cfg, "cuda")
    with pytest.raises(NotImplementedError, match=name):
        pt.Model(cfg, device="cuda")
    assert pt.Model(cfg, device="cpu").mode is None


def test_every_build_takes_the_terms():
    """The flavours on which every build is parameterised pass the gate on
    each chain's sets: 'nu-simplified', 'rho-nu-const', the bulk ζ and
    diffrho on a periodic, an aux and a z-walled set, 'nu-cspeed' on the
    z-walled sets with ss."""
    flav = ("nu-simplified", "rho-nu-const", "rho-nu-const-bulk")
    for cfg in (flagship(SHAPE), shock_box(SHAPE),
                conv_slab(SHAPE, magnetic=True)):
        new = with_viscosity(cfg, flav + tuple(
            v for v in cfg.module("viscosity").ivisc if v == "nu-shock"),
            nu=5e-3, zeta=1e-3, diffrho=1e-3)
        assert gate_reason(new) is None
    assert gate_reason(with_viscosity(conv_slab(SHAPE, shock=True),
                                      ("nu-cspeed", "nu-shock"),
                                      nu=4e-3)) is None
    # beside del6 at order 2 on the entropy MHD build, and on the MHD
    # shear box with ss and del6 (the instances at 255 registers)
    assert gate_reason(with_viscosity(
        forced_entropy(SHAPE, hyper3=True), ("rho-nu-const",), nu=5e-3)
        .replace(time=pt.TimeSpec(itorder=2))) is None
    assert gate_reason(with_viscosity(shear_box(SHAPE, entropy=True),
                                      ("rho-nu-const", "nu-shock"))) is None


def test_jax_fused_hyper3_nu_const_reference_fault():
    """A fault of the reference (ROADMAP Queue 3): JAX's fused step raises
    on 'hyper3-nu-const', whose d5_raw slices a wrapped tile
    (pencil_tpu/physics/viscosity.py:165-166); its jnp path runs."""
    cfg = RUNS["flagship hyper3-nu-const"][0](pj, True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jm = pj.Model(cfg)
        with pytest.raises(TypeError, match="incompatible shapes"):
            jm.make_step()(jm.init_state(5))


def test_jax_log_density_drops_the_aniso_hyper3():
    """A fault of the reference (ROADMAP Queue 3): JAX's log-density
    branch has no diffrho_hyper3_aniso term, so Model.rhs with and without
    it agree bit for bit (the port refuses the option on lnρ)."""
    out = []
    for aniso in ((0.0, 0.0, 0.0), (1e-3, 1e-3, 1e-3)):
        cfg = flagship(SHAPE, pkg=pj, fused=False)
        cfg = cfg.replace(modules=tuple(
            dataclasses.replace(m, diffrho_hyper3_aniso=aniso)
            if m.name == "density" else m for m in cfg.modules))
        jm = pj.Model(cfg)
        rng = np.random.default_rng(2)
        fa = jnp.asarray((1e-2 * rng.standard_normal((7,) + SHAPE))
                         .astype(np.float32))
        out.append(np.asarray(jm.rhs(fa, jm.grid, 0.0)[0]))
    assert np.array_equal(out[0], out[1])
