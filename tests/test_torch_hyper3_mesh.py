"""The mesh flavour of del6 hyper-diffusion in pencil_tpu_torch against
pencil_tpu: 'hyper3-mesh' viscosity and ``diffrho_hyper3_mesh``
(ν₃ᵐ·π⁻⁵ Σ_a δ⁶_a f·dline_1_a/60, whose rate ν₃ᵐ·π⁻⁵·√Σ dline_1² joins the
advective CFL), η₃ staying 'simplified' on A (``hyper3="mesh"`` of the
configuration functions): the plain versions of the H3 instances with
the mesh weights on the periodic (K1, K3′), aux (K1s/K5w) and z-ghosted
(K6/K7) builds against the Pallas kernels traced with the mesh flavour,
steps of the wrap and zghost chains against the JAX fused step, the
kernel constants, and the gate.

The JAX side runs as tests/test_fused.py runs it on the CPU: the Pallas
kernels in interpret mode, one tile over the domain for the z-walled set
(PC_TX = PC_CX = nx), JAX's forcing draws injected through
``Model.forcing_draws``.  Bounds, those of tests/test_fused.py: each
field within 2e-5 × its max, the CFL maximum and dt within 1e-6
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.integrate.timestep import cfl_dt1 as j_cfl_dt1
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu.physics.base import TimestepAccum as JTimestepAccum
from pencil_tpu_torch import configs
from pencil_tpu_torch.core.grid import inverse_spacings
from pencil_tpu_torch.integrate.timestep import cfl_dt1
from pencil_tpu_torch.model import fused_gate, fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.base import TimestepAccum
from pencil_tpu_torch.physics.viscosity import PI5_1
from test_torch_model import jax_forcing_draws

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
NSTEPS = 2
G = 3

# the mesh sets: name -> (configuration function, keyword arguments,
# shape, mode)
SETS = {
    "flagship": (configs.flagship, {}, (8, 8, 16), "wrap"),
    "shock_box": (configs.shock_box, {}, (8, 8, 16), "wrap_aux"),
    "conv_slab": (configs.conv_slab, {}, (8, 8, 16), "zghost"),
}


def mesh_cfg(pkg, case, fused=True):
    """The set ``case`` with the mesh flavour on u and lnρ and η₃ on A;
    the shocked box (which has no del6 of its own) with them added."""
    make, kw, shape, _ = SETS[case]
    if case != "shock_box":
        return make(shape, fused=fused, pkg=pkg, hyper3="mesh", **kw)
    cfg = make(shape, fused=fused, pkg=pkg, **kw)
    c = configs.MESH_HYPER3
    new = {"viscosity": lambda m: dict(ivisc=tuple(m.ivisc)
                                       + ("hyper3-mesh",),
                                       nu_hyper3_mesh=c),
           "density": lambda m: dict(diffrho_hyper3_mesh=c),
           "magnetic": lambda m: dict(eta_hyper3=5e-3 * cfg.grid.dx ** 5)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name](m)) if m.name in new else m
        for m in cfg.modules))


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy(pm, seed):
    """Numpy noise about the configuration's own fields (u, lnρ 1e-2, A
    and s 1e-3), the shock slot built by the pre-pass where there is one
    (so that ν_sh is live)."""
    rng = np.random.default_rng(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    parts = []
    for name, slot in pm.reg.slots.items():
        base = f[name].numpy().reshape((slot.ncomp,) + shape)
        amp = 0.0 if name == "shock" else 1e-2 if name in (
            "uu", "lnrho") else 1e-3
        parts.append(base + amp * rng.standard_normal(base.shape))
    fa = torch.tensor(np.concatenate(parts).astype(np.float32))
    if pm.reg.nf > pm.reg.nvar:
        fa = pm._refresh_aux_fa(fa)
    return fa.numpy()


# ---- the kernels' plain versions against the Pallas kernels -----------------
@pytest.fixture(scope="module", params=sorted(SETS))
def kernels(request):
    """The first and update kernel of the JAX package traced with the mesh
    flavour (interpret mode) on numpy inputs, as numpy: wrap mode (K1/K3′,
    K1s/K5w) or zghost (K6/K7, the input from the 3-axis fill)."""
    case = request.param
    shape = SETS[case][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(mesh_cfg(pj, case))
        pm = pt.Model(mesh_cfg(pt, case), device="cpu")
        zg = pm.mode == "zghost"

        def inp(seed):
            fa = noisy(pm, seed)
            return np.asarray(j_fill_ghosts(
                jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid,
                jm.cfg, jm.eos)) if zg else fa

        z = jm.grid.z
        fa, fa2 = inp(5), inp(6)
        ncom = jm.reg.ncom
        df1, dt1 = jm._fused_rhs(shape, False, not zg, zg)(
            jnp.asarray(fa[:ncom] if not zg else fa), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        df2, f2, _ = jm._fused_rhs(shape, True, not zg, zg)(
            jnp.asarray(fa2[:ncom] if not zg else fa2), z, df1, alpha[1],
            beta[1] * dt)
    return dict(pm=pm, case=case, fa=fa, fa2=fa2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def port_first(pm, fa):
    if pm.mode == "wrap":
        return fr.rhs_first(pm, torch.tensor(fa))
    if pm.mode == "wrap_aux":
        return fr.rhs_wrap_shock(pm, torch.tensor(fa))
    t = torch.tensor(fa)
    return fr.rhs_zg(pm, t[..., G:-G, G:-G, G:-G].contiguous(),
                     t[..., G:-G, G:-G, :G].contiguous(),
                     t[..., G:-G, G:-G, -G:].contiguous())


def port_update(pm, fa, df_prev, coef):
    if pm.mode == "wrap":
        return fr.rhs_tail_mid(pm, torch.tensor(fa), df_prev, coef)
    if pm.mode == "wrap_aux":
        return fr.rhs_wrap_shock_upd(pm, torch.tensor(fa), df_prev, coef)
    t = torch.tensor(fa)
    return fr.rhs_zg_upd(pm, t[..., G:-G, G:-G, G:-G].contiguous(),
                         t[..., G:-G, G:-G, :G].contiguous(),
                         t[..., G:-G, G:-G, -G:].contiguous(), df_prev,
                         coef)


def test_first_kernel_matches_pallas(kernels):
    """K1's, K1s's and K6's H3 plain versions with the mesh weights: df,
    and the max 1/dt with the mesh rate after the wave-speed root."""
    pm = kernels["pm"]
    df, dt1m = port_first(pm, kernels["fa"])
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_update_kernel_matches_pallas(kernels):
    """K3′'s, K5w's and K7's H3 plain versions with the mesh weights: df
    (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = port_update(pm, kernels["fa2"], df_prev, coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


# ---- steps against the JAX fused step ---------------------------------------
@pytest.mark.parametrize("case", ("flagship", "conv_slab"))
def test_mesh_step_matches_jax_fused(case, monkeypatch):
    """The wrap chain (forced, JAX's draws) and the zghost chain with the
    mesh flavour against the JAX fused step, 2 steps; the port's dt is
    JAX's, the mesh rate in it."""
    shape = SETS[case][2]
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    jm = pj.Model(mesh_cfg(pj, case))
    pm = pt.Model(mesh_cfg(pt, case), device="cpu")
    fa = noisy(pm, 11)
    init = {k: fa[pm.reg.slice(k)] if pm.reg.slots[k].ncomp > 1
            else fa[pm.reg.slice(k)][0] for k in pm.reg.slots}
    js = jm.init_state(11, overrides=init)
    ps = pm.init_state(11, overrides=init)
    if pm.forcing is not None:
        pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                                  NSTEPS)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]),
                               rtol=RTOL_DT)
    for k, v in js["fields"].items():
        assert_field_close(ps["fields"][k], v, k)


# ---- the rate, the constants and the gate -----------------------------------
def test_mesh_rate_joins_the_advective_cfl():
    """advec_mesh squares each module's rate into advec2_hypermesh, whose
    root joins the advective rate after the wave-speed root, as JAX's
    TimestepAccum and cfl_dt1 do; the kernels' constant hmesh is that
    root for D₃ᵐ then ν₃ᵐ."""
    cfg = configs.flagship((8, 8, 16), hyper3="mesh")
    pm = pt.Model(cfg, device="cpu")
    jm = pj.Model(configs.flagship((8, 8, 16), pkg=pj, hyper3="mesh"))
    d1 = [float(v) for v in pm.grid.dline_1()]
    rate = [c * PI5_1 * np.sqrt(sum(v * v for v in d1)) for c in (5.0, 5.0)]
    ts, jts = TimestepAccum(), JTimestepAccum()
    ts.advec(torch.tensor(0.25))
    jts.advec(jnp.float32(0.25))
    for r in rate:
        ts.advec_mesh(torch.tensor(r, dtype=torch.float32))
        jts.advec_mesh(jnp.float32(r))
    got = float(cfl_dt1(ts, pm.grid, cfg.time))
    want = float(np.max(j_cfl_dt1(jts, jm.grid, jm.cfg.time)))
    np.testing.assert_allclose(got, want, rtol=RTOL_DT)
    np.testing.assert_allclose(got, (0.25 + np.hypot(*rate)) / cfg.time.cdt,
                               rtol=1e-6)
    p = fr.kernel_params(pm)
    np.testing.assert_allclose(p.hmesh, np.hypot(*rate), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(SETS))
def test_mesh_constants_and_instances(case):
    """The H3 instance runs with the mesh weights dline_1/60 on u and lnρ,
    Δ⁻⁶ on A, the coefficients ν₃ᵐ·π⁻⁵ and D₃ᵐ·π⁻⁵, and the constant
    diffusive rate of η₃ alone; on the card and on the CPU."""
    cfg = mesh_cfg(pt, case)
    mode, why = fused_mode(cfg)
    assert why is None and mode == SETS[case][3]
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    p = fr.kernel_params(pm)
    f32 = np.float32
    inv = np.array(inverse_spacings(cfg.grid), f32)
    for h in (p.h6u, p.h6l):
        np.testing.assert_array_equal(list(h), inv / f32(60.0))
    assert p.nu3 == f32(configs.MESH_HYPER3 * PI5_1) == p.diff3
    mag = cfg.module("magnetic")
    eta3 = mag.eta_hyper3 if mag is not None else 0.0
    assert p.eta3 == f32(eta3) and (p.dif3 > 0.0) == (eta3 > 0.0)
    assert p.hmesh > 0.0
    names = (fr.zg_kernels(pm) if pm.mode == "zghost"
             else (fr.launch_suffix(pm),))
    assert any("_h3" in n for n in names) or pm.mode == "wrap_aux"


def test_both_flavours_on_one_field_are_refused_by_name():
    """'hyper3-mesh' beside 'hyper3-simplified' (and diffrho_hyper3 beside
    diffrho_hyper3_mesh) has no kernel instance: refused on the card,
    naming both, and the eager path on the CPU, which sums the two as JAX
    does."""
    cfg = configs.flagship(8, hyper3=True)
    cfg = cfg.replace(modules=tuple(
        dataclasses.replace(m, ivisc=tuple(m.ivisc) + ("hyper3-mesh",))
        if m.name == "viscosity" else m for m in cfg.modules))
    why = fused_mode(cfg)[1]
    assert "'hyper3-simplified' with 'hyper3-mesh'" in why
    assert fused_gate(cfg, "cpu") is False
    with pytest.raises(NotImplementedError, match="hyper3-mesh"):
        fused_gate(cfg, "cuda")
    den = configs.flagship(8, hyper3=True)
    den = den.replace(modules=tuple(
        dataclasses.replace(m, diffrho_hyper3_mesh=5.0)
        if m.name == "density" else m for m in den.modules))
    assert "diffrho_hyper3_mesh" in fused_mode(den)[1]


def test_mesh_beside_upwinding_is_refused_by_name():
    """No instance has both the upwinding and del6, the mesh flavour
    included: refused, naming the mesh coefficients."""
    cfg = configs.with_upwind(configs.flagship(8, hyper3="mesh"))
    why = fused_mode(cfg)[1]
    assert "nu_hyper3_mesh" in why and "diffrho_hyper3_mesh" in why
