"""Entropy's other heat-conduction and cooling flavours on the z-walled
sets in pencil_tpu_torch against pencil_tpu: 'K-profile' (K ∝ m + 1 in
each polytropic layer, a K(z) vector of every z-ghosted build with ss),
'kramers' (K = K₀T^6.5n/ρ^2n, clipped) and 'chi-cspeed' (χT^c) as
parameters of the CHI instances, Newtonian cooling (tau_cool), uniform
heating and cooling, and the z cooling profiles 'step', 'step2',
'cubic_step' and 'lin-z' (``conv_slab(n, heatcond=..., chi_cspeed=...,
tau_cool=..., cooling_profile=..., entropy=...)``).

The plain versions of K6/K7 and K6m/K7m (their base and CHI instances)
against the zghost Pallas kernels traced for those module sets, in
interpret mode with one tile over the domain (PC_TX = PC_CX = nx; ROADMAP
Queue 3); two steps of the port's zghost chain against the JAX fused
(zghost) and jnp paths; each term shown to act and each Kramers clip to
bind; the ``dtchi`` column against JAX's evaluator; the gate; the
configuration function.  At 8×8×16, inputs from numpy with a seed,
velocity and vector-potential noise of 1e-2.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, the CFL maximum
and dt within 1e-6 relative.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.diagnostics import make_diagnostics as jax_diagnostics
from pencil_tpu_torch.configs import KRAMERS_K0, conv_slab
from pencil_tpu_torch.io.diagnostics import make_diagnostics
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_zghost_chi import start_states
from test_torch_zghost_mhd import (RTOL_DT, RTOL_FIELD, assert_field_close,
                                   assert_states_close, ghosted_input,
                                   z_split)

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
NSTEPS = 2
CHI = 4e-3
TAU = 0.5
# Kramers' clip: K/(ρcp) spans 4.7e-3 (at z2) to 2.3e-2 (at the top) on
# the initial state, so both ends bind
KMIN, KMAX = 6e-3, 1.5e-2
UNIFORM = dict(heat_uniform=0.3, cool_uniform=0.2)
# the module sets: conv_slab keyword arguments, the flavours that reach the
# same instance together, the hydro and the magnetic set
CASES = {
    "kprofile": dict(heatcond="K-profile", tau_cool=TAU,
                     cooling_profile="step", entropy=UNIFORM),
    "kramers": dict(heatcond="kramers", cooling_profile="step2",
                    entropy=dict(zcool=0.1, chimin_kramers=KMIN,
                                 chimax_kramers=KMAX)),
    "mag_cspeed": dict(magnetic=True, chi=CHI, chi_cspeed=0.5,
                       heatcond="K-profile", cooling_profile="cubic_step"),
    "mag_kramers": dict(magnetic=True, heatcond="kramers", tau_cool=TAU,
                        cooling_profile="lin-z", entropy=UNIFORM),
}


def tiled(mp):
    mp.setenv("PC_TX", str(SHAPE[0]))
    mp.setenv("PC_CX", str(SHAPE[0]))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One module set: its JAX models (fused and jnp) and the port's, the
    JAX K6 and K7 (interpret mode) on one ghosted input each, and two
    steps of each path from the same state."""
    kw = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        tiled(mp)
        jm = pj.Model(conv_slab(SHAPE, pkg=pj, **kw))
        jnp_m = pj.Model(conv_slab(SHAPE, fused=False, pkg=pj, **kw))
        pm = pt.Model(conv_slab(SHAPE, **kw), device="cpu")
        assert pm.mode == "zghost"
        assert jm._fused_mode(None, None, SHAPE[2]) == "zghost"
        fg = ghosted_input(jm, pm, seed=5)
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(SHAPE, False, False, True)(jnp.asarray(fg),
                                                            z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = ghosted_input(jm, pm, seed=6)
        df2, f2, _ = jm._fused_rhs(SHAPE, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
        # the JAX jnp path's RHS on the same inputs (its Model.rhs fills
        # the same ghosts), and K7's update from it
        jdf1, jdt1, _ = jnp_m.rhs(jnp.asarray(fg[:, 3:-3, 3:-3, 3:-3]),
                                  jnp_m.grid, 0.0)
        jrhs2 = np.asarray(jnp_m.rhs(jnp.asarray(fg2[:, 3:-3, 3:-3, 3:-3]),
                                     jnp_m.grid, 0.0)[0])
        jdf2 = np.float32(alpha[1]) * np.asarray(df1) + jrhs2
        jf2 = fg2[:pm.reg.nvar, 3:-3, 3:-3, 3:-3] \
            + np.float32(beta[1] * dt) * jdf2
        steps = {}
        for name, m in (("fused", jm), ("jnp", jnp_m)):
            js, ps = start_states(m, pm, 11)
            jstep, pstep = m.make_step(), pm.make_step()
            for _ in range(NSTEPS):
                js, ps = jstep(js), pstep(ps)
            steps[name] = (js, ps)
    pallas = dict(df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
                  df2=np.asarray(df2), f2=np.asarray(f2))
    jnp_rhs = dict(df1=np.asarray(jdf1), dt1max=float(jnp.max(jdt1)),
                   df2=jdf2, f2=jf2)
    return dict(name=request.param, pm=pm, jnp_m=jnp_m, fg=fg, fg2=fg2,
                dt=np.float32(dt), pallas=pallas, jnp_rhs=jnp_rhs,
                steps=steps)


def reference(case):
    """What the port's K6/K7 plain versions are held to: the Pallas
    kernels, but with 'K-profile' the JAX jnp path's RHS, from which the
    Pallas kernels part (``test_pallas_k_profile_parts_from_jnp``)."""
    return case["jnp_rhs" if "K-profile" in case["pm"].cfg.module(
        "entropy").iheatcond else "pallas"]


def test_rhs_zg_matches_jax(case):
    """K6's (K6m's) plain version, base or CHI instance with the case's
    flavours, against the Pallas K6 (with 'K-profile' the jnp RHS): df,
    and the max 1/dt with their per-point rates."""
    pm, ref = case["pm"], reference(case)
    assert fr.zg_kernels(pm)[0].endswith("_chi") == (
        "kramers" in case["name"] or "cspeed" in case["name"])
    df, dt1m = fr.rhs_zg(pm, *z_split(case["fg"]))
    np.testing.assert_allclose(float(dt1m), ref["dt1max"], rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], ref["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_matches_jax(case):
    """K7's (K7m's) plain version against the Pallas K7 (with 'K-profile'
    the update from the jnp RHS): df (written over df_prev) and f."""
    pm, ref = case["pm"], reference(case)
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(case["dt"])))
    df_prev = torch.tensor(case["pallas"]["df1"])
    df, f = fr.rhs_zg_upd(pm, *z_split(case["fg2"]), df_prev, coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], ref["df2"][c], f"df[{c}]")
        assert_field_close(f[c], ref["f2"][c], f"f[{c}]")


def test_pallas_k_profile_parts_from_jnp(case):
    """A fault of the reference (ROADMAP Queue 3): with 'K-profile' the
    JAX Pallas K6 parts from the JAX jnp RHS on the same input by more
    than the bound in ds of the hydro set (2.3e-5 × its max at 8×8×16),
    where the port's plain version agrees with the jnp RHS within a tenth
    of it.  K(z) and dK/dz, which the port forms bit for bit as the jnp
    path does, are a difference over 1e-3·Δz, which turns an ulp of K
    into ~1e-5 of dK/dz; the Pallas body rounds K otherwise.  Every other
    field, and every flavour without 'K-profile', agree with the Pallas
    kernels within the bound."""
    pm = case["pm"]
    df = fr.rhs_zg(pm, *z_split(case["fg"]))[0].numpy()
    pallas, jrhs = case["pallas"]["df1"], case["jnp_rhs"]["df1"]
    ss = pm.reg.slice("ss").start
    for c in range(pm.reg.nvar):
        bound = RTOL_FIELD * np.abs(jrhs[c]).max()
        assert np.abs(df[c] - jrhs[c]).max() <= bound / 10, c
        if c != ss or "K-profile" not in pm.cfg.module(
                "entropy").iheatcond:
            assert_field_close(df[c], pallas[c], f"df[{c}]")
    if case["name"] == "kprofile":
        assert np.abs(pallas[ss] - jrhs[ss]).max() \
            > RTOL_FIELD * np.abs(jrhs[ss]).max()


@pytest.mark.parametrize("path", ("fused", "jnp"))
def test_step_matches_jax(case, path):
    """Two steps of the port's zghost chain against the JAX fused zghost
    step (Pallas in interpret mode) and the JAX jnp path."""
    assert_states_close(*case["steps"][path])


def test_dtchi_matches_jax(case):
    """The dtchi column on the state after the steps, against JAX's
    evaluator on the same state: K(z)/(ρcp) where hcond0 > 0 ('K-profile'
    cases, whatever the other flavours), else Kramers' clipped K/(ρcp)."""
    js, ps = case["steps"]["jnp"]
    want = float(jax_diagnostics(case["jnp_m"], ("dtchi",))(js)["dtchi"])
    got = float(make_diagnostics(case["pm"], ("dtchi",))(ps)["dtchi"])
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


# dtchi of the flavours the cases above do not read: K-const, chi-const,
# and 'chi-cspeed' without K-const (hcond0 = 0)
DTCHI = {"kconst": dict(), "chiconst": dict(chi=CHI, entropy=dict(
    hcond0=0.0, iheatcond=("chi-const",))),
    "cspeed": dict(chi=CHI, chi_cspeed=0.5, entropy=dict(
        hcond0=0.0, iheatcond=("chi-cspeed",)))}


@pytest.mark.parametrize("name", sorted(DTCHI))
def test_dtchi_of_the_other_flavours_matches_jax(name):
    jm = pj.Model(conv_slab(SHAPE, fused=False, pkg=pj, **DTCHI[name]))
    pm = pt.Model(conv_slab(SHAPE, **DTCHI[name]), device="cpu")
    js, ps = start_states(jm, pm, 3)
    want = float(jax_diagnostics(jm, ("dtchi",))(js)["dtchi"])
    got = float(make_diagnostics(pm, ("dtchi",))(ps)["dtchi"])
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


# each term against the same steps without it: (conv_slab keyword
# arguments with, without)
TERMS = {
    "K-profile": (dict(heatcond="K-profile"), dict()),
    "kramers": (dict(heatcond="kramers"), dict()),
    "kramers clip": (CASES["kramers"], dict(CASES["kramers"], entropy=dict(
        zcool=0.1))),
    "chi-cspeed": (dict(chi=CHI, chi_cspeed=0.5), dict(chi=CHI)),
    "tau_cool": (dict(tau_cool=TAU), dict()),
    "heat_uniform": (dict(entropy=dict(heat_uniform=0.3)), dict()),
    "cool_uniform": (dict(entropy=dict(cool_uniform=0.2)), dict()),
    "step": (dict(cooling_profile="step"), dict()),
    "step2": (dict(cooling_profile="step2", entropy=dict(zcool=0.1)),
              dict()),
    "cubic_step": (dict(cooling_profile="cubic_step"), dict()),
    "lin-z": (dict(cooling_profile="lin-z"), dict()),
}


def port_steps(kw, start):
    pm = pt.Model(conv_slab(SHAPE, **kw), device="cpu")
    ps = pm.init_state(11, overrides=start)
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    return ps["fields"]


@pytest.fixture(scope="module")
def start():
    """The conv-slab's initial state with velocity noise of 1e-2."""
    pm = pt.Model(conv_slab(SHAPE), device="cpu")
    fields = dict(pm.init_state(11)["fields"])
    rng = np.random.default_rng(11)
    fields["uu"] = torch.tensor(
        1e-2 * rng.standard_normal((3,) + SHAPE), dtype=torch.float32)
    return fields


@pytest.mark.parametrize("term", sorted(TERMS))
def test_term_acts(term, start):
    """The steps with the term leave s more than 100× the parity bound
    away from those without it: no term can be silently off."""
    on, off = (port_steps(kw, start) for kw in TERMS[term])
    b = on["ss"]
    diff = float((off["ss"] - b).abs().max())
    assert diff > 100 * RTOL_FIELD * float(b.abs().max()), (term, diff)


def test_kramers_clips_bind():
    """On the initial state K/(ρcp) of the clipped case lies below χ_min
    and above χ_max somewhere, so both ends of the clip act."""
    pm = pt.Model(conv_slab(SHAPE, **CASES["kramers"]), device="cpu")
    f = pm.init_state(0)["fields"]
    eos, ent = pm.eos, pm.cfg.module("entropy")
    lnTT = eos.lnTT0 + eos.gamma / eos.cp * f["ss"] \
        + (eos.gamma - 1.0) * (f["lnrho"] - eos.lnrho0)
    chi = ent.hcond0_kramers * torch.exp(-3.0 * f["lnrho"] + 6.5 * lnTT) \
        / eos.cp
    assert float(chi.min()) < KMIN < KMAX < float(chi.max())


def test_kramers_k0_sets_k_at_z2():
    """K₀ of conv_slab's 'kramers' gives K = K₀T^6.5/ρ² = 8e-3 at z2 = 0 on
    the initial state, the K-const run's hcond0."""
    pm = pt.Model(conv_slab((4, 4, 101), heatcond="kramers"), device="cpu")
    f = pm.init_state(0)["fields"]
    iz = int(torch.argmin(pm.grid.z.abs()))
    assert abs(float(pm.grid.z[iz])) < 1e-6
    eos = pm.eos
    lnTT = eos.lnTT0 + eos.gamma / eos.cp * f["ss"][0, 0, iz] \
        + (eos.gamma - 1.0) * (f["lnrho"][0, 0, iz] - eos.lnrho0)
    K = KRAMERS_K0 * math.exp(6.5 * float(lnTT)
                              - 2.0 * float(f["lnrho"][0, 0, iz]))
    assert abs(K / 8e-3 - 1.0) < 1e-5


# the six z-ghosted builds with ss: conv_slab keyword arguments, library
BUILDS = {"conv": (dict(), "fused_rhs_zg"),
          "mag": (dict(magnetic=True), "fused_rhs_zg_mag"),
          "shear": (dict(shear=True, Omega=0.5), "fused_rhs_zg_shear"),
          "mag_shear": (dict(magnetic=True, shear=True, Omega=0.5),
                        "fused_rhs_zg_mag_shear"),
          "shock": (dict(shock=True), "fused_rhs_zg_shock"),
          "mag_shock": (dict(magnetic=True, shock=True),
                        "fused_rhs_zg_mag_shock")}
# each option: conv_slab keyword arguments, whether it runs the CHI
# instances
OPTIONS = {"K-profile": (dict(heatcond="K-profile"), False),
           "kramers": (dict(heatcond="kramers"), True),
           "chi-cspeed": (dict(chi=CHI, chi_cspeed=0.5), True),
           "tau_cool": (dict(tau_cool=TAU), False),
           "uniform": (dict(entropy=UNIFORM), False),
           "cubic_step": (dict(cooling_profile="cubic_step"), False)}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_gate_admits_each_option_on_the_six_builds(build):
    """Each option runs the zghost chain on the card, on the set's own
    build (the 9-slot one too: its instances keep 0 local bytes with the
    terms, PERF.md §6), the CHI instances for 'kramers' and 'chi-cspeed',
    the base ones otherwise; K(z) reaches the kernels as a (2, nz)
    vector, null without 'K-profile'."""
    base, lib = BUILDS[build]
    for name, (kw, chi) in OPTIONS.items():
        cfg = conv_slab(8, **base, **kw)
        assert fused_mode(cfg) == ("zghost", None), name
        assert fused_gate(cfg, "cuda") is True
        pm = pt.Model(cfg, device="cpu")
        assert fr.zg_library(pm) == lib
        assert fr.zg_kernels(pm) == tuple(
            k + ("_chi" if chi else "") for k in fr.ZG_KERNELS[lib]), name
        kprof = fr.kprof_vector(pm)
        assert (kprof is None) == (name != "K-profile")
        if kprof is not None:
            assert tuple(kprof.shape) == (2, 8)
            p = fr.kernel_params(pm)
            assert p.hcond0 == 0.0 and p.cpchi == 0.0


def test_kernel_params_of_the_chi_term():
    """The CHI instances' term: chi-const without the exponential; Kramers
    with c = K₀, q = (−(2n+1), 6.5n), p = (−2n, 6.5n+1) and its clip
    [χ_min, χ_max]·cp; 'chi-cspeed' with c = cp·χ, q_T = c, p_T = 1 + c;
    Newtonian cooling and the uniform terms as they are."""
    f32 = np.float32

    def params(**kw):
        return fr.kernel_params(pt.Model(conv_slab(8, **kw), device="cpu"))

    p = params(chi=CHI)
    assert (p.kexp, p.kq_rho, p.kq_T, p.kp_rho, p.kp_T) == (0, 0, 0, 1, 1)
    p = params(**CASES["kramers"])
    assert p.kexp == 1 and p.cpchi == f32(KRAMERS_K0)
    assert (p.kq_rho, p.kq_T, p.kp_rho, p.kp_T) == (-3.0, 6.5, -2.0, 7.5)
    assert (p.kmin, p.kmax) == (f32(KMIN), f32(KMAX))
    assert p.maxdif == f32(4e-3)         # ν: Kramers' rate is per point
    p = params(chi=CHI, chi_cspeed=0.25)
    assert p.kexp == 1 and p.cpchi == f32(CHI)
    assert (p.kq_rho, p.kq_T, p.kp_rho, p.kp_T) == (0.0, 0.25, 1.0, 1.25)
    assert p.maxdif == f32(4e-3)
    p = params(tau_cool=TAU, entropy=UNIFORM)
    assert (p.tau_cool, p.ttref, p.heat_uniform, p.cool_uniform) == (
        f32(TAU), f32(1.5), f32(0.3), f32(0.2))
    assert p.cp_g == f32(0.6)
    p = params()
    assert (p.tau_cool, p.heat_uniform, p.cool_uniform, p.kexp) == (0,) * 4


# the periodic sets with ss and the Entropy fields of each option there
PERIODIC = {
    "entropy MHD": lambda: pt.configs.forced_entropy(8),
    "entropy hydro": lambda: pt.configs.forced_entropy(8, magnetic=False),
    "shock box ent": lambda: pt.configs.shock_box(8, entropy=True),
    "shear box ent": lambda: pt.configs.shear_box(8, entropy=True)}
# (Newtonian cooling and the uniform heating and cooling run on every
# build with ss: tests/test_torch_chi_hyper3.py)
PERIODIC_OPTIONS = {
    "'K-profile'": dict(iheatcond=("K-profile",), hcond0=4e-3),
    "'kramers'": dict(iheatcond=("kramers",), hcond0_kramers=1e-3),
    "'chi-cspeed'": dict(iheatcond=("chi-cspeed",))}


@pytest.mark.parametrize("label", sorted(PERIODIC))
def test_periodic_entropy_sets_refuse_each_option(label):
    """Outside the z-ghosted builds each option is refused by name on the
    card, before any mode is admitted; on the CPU the set runs the eager
    path."""
    cfg = PERIODIC[label]()
    assert gate_reason(cfg) is None
    for name, over in PERIODIC_OPTIONS.items():
        c = cfg.replace(modules=tuple(
            dataclasses.replace(m, **over) if m.name == "entropy" else m
            for m in cfg.modules))
        assert name in gate_reason(c), (label, name)
        with pytest.raises(NotImplementedError, match=name.strip("'")):
            fused_gate(c, "cuda")
        assert fused_gate(c, "cpu") is False


def test_two_chi_terms_are_refused_on_the_card():
    """The CHI instances have one of chi-const, 'kramers' and
    'chi-cspeed': two at once are refused by name."""
    cfg = conv_slab(8, heatcond="kramers", chi=CHI)
    assert "kramers" in gate_reason(cfg)
    with pytest.raises(NotImplementedError, match="chi-const"):
        fused_gate(cfg, "cuda")


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_conv_slab_defaults_to_k_const(pkg):
    """``heatcond="K-const"`` is conv_slab's default, in both packages: the
    configuration of before; 'K-profile' keeps hcond0, 'kramers' sets K₀
    and no hcond0."""
    for mag in (False, True):
        cfg = conv_slab(8, pkg=pkg, magnetic=mag)
        assert cfg == conv_slab(8, pkg=pkg, magnetic=mag, heatcond="K-const")
        ent = cfg.module("entropy")
        assert ent.iheatcond == ("K-const",) and ent.hcond0 == 8e-3
        assert ent.tau_cool == 0.0 and ent.cooling_profile == "gaussian"
    ent = conv_slab(8, pkg=pkg, heatcond="K-profile").module("entropy")
    assert ent.iheatcond == ("K-profile",) and ent.hcond0 == 8e-3
    ent = conv_slab(8, pkg=pkg, heatcond="kramers").module("entropy")
    assert ent.iheatcond == ("kramers",) and ent.hcond0 == 0.0
    assert ent.hcond0_kramers == KRAMERS_K0 and ent.nkramers == 1.0
    with pytest.raises(ValueError):
        conv_slab(8, pkg=pkg, heatcond="chit")
