"""The Shock module's slot between z walls in pencil_tpu_torch against
pencil_tpu on the CPU: stratified convection and magnetoconvection with
ν_sh (``conv_slab(n, shock=True)``), each with and without chi-const and
the shock diffusivities, on the z-ghosted builds with the shock slot
(K6k/K7k, K6mk/K7mk).  Their plain versions against the zghost Pallas
kernels traced with the slot; the first kernel's plain version against
the JAX RHS; 2 steps of the port's chain (the plain versions) and eager
path against the JAX fused step (Pallas in interpret mode) and the JAX
jnp path; the gate, which takes these sets, the library and instance
each runs, and the refusal of a z-walled Shock whose slot has no BC; and
the reference fault that refusal guards: without a BC for the slot the
JAX fused path wraps its z ghosts while the jnp path closes them
symmetrically, and the two part.

At 8×8×16 with velocity noise of 5e-2 (a live shock profile) and
vector-potential noise of 1e-2 from numpy with a seed.  The JAX fused side
runs one tile over the domain (PC_TX = PC_CX = nx: the JAX Gravity module
sizes its vector from the global grid).  The JAX jnp path keeps the shock
slot at its initial zeros, the fused chains hold their last pre-pass: the
jnp comparisons leave the slot out.  Bounds, those of tests/test_fused.py:
each field within 2e-5 × its max, dt and the CFL maximum within 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as jax_fill_ghosts
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, with_shock_diffusion
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_bext import evolved, first_plain
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import (RTOL_DT, RTOL_FIELD, assert_field_close,
                                   assert_states_close, z_split)

torch.set_num_threads(1)

NSTEPS = 2
SHAPE = (8, 8, 16)
UU_AMPL, AA_AMPL = 5e-2, 1e-2
CHI = 4e-3

# each set: conv_slab keyword arguments, the library and the launch
# names (first, update) it takes; a set ending in "_sd" adds the shock
# diffusivities (with_shock_diffusion)
SETS = {
    "conv": (dict(), "fused_rhs_zg_shock",
             ("rhs_zg_shock", "rhs_zg_upd_shock")),
    "conv_sd": (dict(), "fused_rhs_zg_shock",
                ("rhs_zg_shock_sd", "rhs_zg_upd_shock_sd")),
    "conv_chi": (dict(chi=CHI), "fused_rhs_zg_shock",
                 ("rhs_zg_shock_chi", "rhs_zg_upd_shock_chi")),
    "conv_chi_sd": (dict(chi=CHI), "fused_rhs_zg_shock",
                    ("rhs_zg_shock_chi_sd", "rhs_zg_upd_shock_chi_sd")),
    "mag": (dict(magnetic=True), "fused_rhs_zg_mag_shock",
            ("rhs_zg_mag_shock", "rhs_zg_upd_mag_shock")),
    "mag_sd": (dict(magnetic=True), "fused_rhs_zg_mag_shock",
               ("rhs_zg_mag_shock_sd", "rhs_zg_upd_mag_shock_sd")),
    "mag_chi": (dict(magnetic=True, chi=CHI), "fused_rhs_zg_mag_shock",
                ("rhs_zg_mag_shock_chi", "rhs_zg_upd_mag_shock_chi")),
    "mag_chi_sd": (dict(magnetic=True, chi=CHI), "fused_rhs_zg_mag_shock",
                   ("rhs_zg_mag_shock_chi_sd",
                    "rhs_zg_upd_mag_shock_chi_sd")),
}


def make(pkg, case, fused=True, shape=SHAPE, **extra):
    cfg = conv_slab(shape, pkg=pkg, fused=fused, shock=True,
                    **SETS[case][0], **extra)
    return with_shock_diffusion(cfg) if case.endswith("_sd") else cfg


def start_overrides(slots, seed, shape=SHAPE):
    """Seeded numpy noise for u and (where the set has it) A."""
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    aa = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(np.float32)
    if "aa" in slots:
        over["aa"] = aa
    return over


def run_all(make_cfg, nsteps=NSTEPS, seed=13, shape=SHAPE):
    """The states after ``nsteps`` steps of the JAX fused and jnp paths
    and of the port's fused chain and eager path, all from the JAX init
    with u (and A) replaced by numpy noise, a forced set kicked with the
    JAX step's own draws; ``make_cfg(pkg, fused)``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jms = {fused: pj.Model(make_cfg(pj, fused)) for fused in (True, False)}
        pms = {fused: pt.Model(make_cfg(pt, fused), device="cpu")
               for fused in (True, False)}
        assert pms[False].mode is None
        over = start_overrides(pms[True].reg.slots, seed, shape)
        out = {}
        for fused, jm in jms.items():
            js = jm.init_state(5, overrides=over)
            fields = {k: np.asarray(v) for k, v in js["fields"].items()}
            draws = (jax_forcing_draws(jm, js["key"], nsteps)
                     if pms[fused].forcing is not None else None)
            step = jm.make_step()
            for _ in range(nsteps):
                js = step(js)
            out["jax_fused" if fused else "jax_jnp"] = js
        for fused, pm in pms.items():
            ps = pm.init_state(5, overrides=overrides_from_numpy(fields,
                                                                 pm.reg))
            if pm.forcing is not None:
                pm.forcing_draws = iter(draws).__next__
            step = pm.make_step()
            for _ in range(nsteps):
                ps = step(ps)
            out["chain" if fused else "eager"] = ps
        out["model"] = pms[True]
    return out


@pytest.fixture(scope="module", params=sorted(SETS))
def runs(request):
    out = run_all(lambda pkg, fused: make(pkg, request.param, fused))
    pm = out["model"]
    assert pm.mode == "zghost"
    assert fr.zg_library(pm) == SETS[request.param][1]
    assert fr.zg_kernels(pm) == SETS[request.param][2]
    return out


def test_zghost_shock_chain_matches_jax_fused(runs):
    """The port's chain against the JAX fused zghost step, the shock slot
    too (the last pre-pass of both)."""
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_zghost_shock_chain_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["chain"]))


def test_zghost_shock_eager_step_matches_jax_jnp_path(runs):
    """The port's eager path, whose pre-pass closes the slot's z ghosts
    by bc_sym as JAX's halo1 does."""
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["eager"]))


# ---- the kernels' plain versions --------------------------------------------------
def noisy_state(pm, rng):
    """(nf, nx, ny, nz) numpy: the conv-slab's initial lnρ and s with
    noise, noisy velocities, with Magnetic a noisy vector potential, and a
    positive shock profile of 1e-3 (ν_sh·shock of the size of ν)."""
    init = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    parts = [UU_AMPL * rng.standard_normal((3,) + shape),
             init["lnrho"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
             init["ss"].numpy()[None] + 1e-2 * rng.standard_normal(shape)]
    if "aa" in pm.reg.slots:
        parts.append(AA_AMPL * rng.standard_normal((3,) + shape))
    parts.append(1e-3 * rng.random((1,) + shape))
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module", params=("conv_sd", "mag_chi_sd", "mag"))
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced with the shock
    slot, on one input each ghosted by the JAX fill_ghosts (the slot's z
    ghosts by its BC 's'), every result kept as numpy."""
    case = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jm = pj.Model(make(pj, case))
        pm = pt.Model(make(pt, case), device="cpu")

        def ghosted(seed):
            fa = noisy_state(pm, np.random.default_rng(seed))
            return np.asarray(jax_fill_ghosts(
                jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid,
                jm.cfg, jm.eos))

        fg, fg2 = ghosted(5), ghosted(6)
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(SHAPE, False, False, True)(
            jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        df2, f2, _ = jm._fused_rhs(SHAPE, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_shock_matches_pallas(kernels):
    """K6k's (K6mk's) plain version on the interior stack of all nf slots
    and its z slabs: df and the max 1/dt over tiles, which holds ν_sh·shock
    and the shock diffusivities' rates."""
    pm = kernels["pm"]
    fa, zlo, zhi = z_split(kernels["fg"])
    assert fa.shape[0] == zlo.shape[0] == pm.reg.nf == pm.reg.nvar + 1
    df, dt1m = fr.rhs_zg(pm, fa, zlo, zhi)
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape[0] == pm.reg.nvar
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_shock_matches_pallas(kernels):
    """K7k's (K7mk's) plain version: df (written over df_prev) and f of
    the evolved fields."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *z_split(kernels["fg2"]), df_prev, coef)
    assert df is df_prev and f.shape[0] == pm.reg.nvar
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


@pytest.mark.parametrize("case", ("conv", "mag_chi_sd"))
def test_first_kernel_plain_with_shock_matches_jax_rhs(case):
    """The first kernel's plain version of the chain, its input made as
    the chain makes it (the pre-pass, the z slabs), against the JAX jnp
    path's RHS on the same state: df of every field and the CFL
    maximum."""
    jm = pj.Model(make(pj, case, fused=False))
    pm = pt.Model(make(pt, case), device="cpu")
    js = jm.init_state(9, overrides=start_overrides(pm.reg.slots, 9))
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    fa = pm.reg.stack(pm.init_state(
        9, overrides=overrides_from_numpy(fields, pm.reg))["fields"])
    df, dt1m = first_plain(pm, pm._refresh_aux_fa(fa), 0.0)
    jdf, jdt1, _ = jax.jit(lambda f: jm.rhs(f, jm.grid, 0.0))(
        jnp.asarray(fa.numpy()))
    np.testing.assert_allclose(float(dt1m), float(jnp.max(jdt1)),
                               rtol=RTOL_DT)
    jdf = np.asarray(jdf)
    assert df.shape == jdf.shape
    for c in range(df.shape[0]):
        assert_field_close(df[c], jdf[c], f"{case} df[{c}]")


def test_step_leaves_its_input_alone():
    """A step of the shocked chain writes no tensor of its input state;
    the new state's slot is the last pre-pass's, not the input's."""
    pm = pt.Model(make(pt, "mag_sd"), device="cpu")
    s0 = pm.pack_state(pm.init_state(0, overrides=start_overrides(
        pm.reg.slots, 3)))
    keep = s0["_fa"].clone()
    s1 = pm.make_step()(s0)
    assert torch.equal(s0["_fa"], keep)
    sl = pm.reg.slice("shock")
    assert float(s1["_fa"][sl].abs().max()) > 0.0
    assert not torch.equal(s1["_fa"][sl], keep[sl])


# ---- the gate -------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_takes_the_shocked_z_walled_sets(case):
    """Each set runs the zghost chain on the card and on the CPU, on its
    build and instance, with the constants of ν_sh and the shock
    diffusivities."""
    kw, lib, names = SETS[case]
    cfg = make(pt, case)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    assert fr.zg_library(pm) == lib and fr.zg_kernels(pm) == names
    assert names[0] in fr.LAUNCHES and names[1] in fr.LAUNCHES
    assert names[0] + " rot" in fr.library_instances(lib)
    p = fr.kernel_params(pm)
    assert p.nu_shock == 1.0
    sd = 1.0 if case.endswith("_sd") else 0.0
    assert p.diffrho_shock == p.chi_shock == sd
    assert p.eta_shock == (sd if kw.get("magnetic") else 0.0)
    assert p.cpchi == np.float32(pm.eos.cp * kw.get("chi", 0.0))


def test_upwinding_and_rotation_take_their_instances():
    """Ω and the upwinding on the shocked sets: the ROT instances (picked
    on the card) and the UPW ones, beside chi-const and SHK."""
    pm = pt.Model(make(pt, "mag_chi_sd", Omega=0.5, upwind=True),
                  device="cpu")
    assert fr.zg_kernels(pm) == ("rhs_zg_mag_shock_chi_upw_sd",
                                 "rhs_zg_upd_mag_shock_chi_upw_sd")
    inst = fr.library_instances("fused_rhs_zg_mag_shock")
    assert inst["rhs_zg_mag_shock_chi_upw_sd rot"] == 16 + 64 + 128 + 256
    assert not any("_h3" in k for k in inst)
    assert len(inst) == 32


def test_del6_beside_a_walled_shock_is_refused():
    """No z-ghosted build with the shock slot has the del6 terms: the gate
    and the kernel constants refuse them by name."""
    cfg = make(pt, "conv", hyper3=True)
    reason = gate_reason(cfg)
    assert "del6" in reason and "Shock" in reason, reason
    with pytest.raises(NotImplementedError, match="del6"):
        pt.Model(cfg, device="cuda")
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode is None
    with pytest.raises(NotImplementedError, match="del6"):
        fr.kernel_params(pm)


def _without_shock_bc(cfg):
    return cfg.replace(bcz=tuple(bc for bc in cfg.bcz if bc.comp != "shock"))


@pytest.mark.parametrize("case, code", (
    ("conv", None), ("mag", None), ("conv", "a"), ("mag", "a2"),
    ("conv", "s:a")), ids=("conv", "mag", "conv-a", "mag-a2", "conv-s:a"))
def test_walled_shock_without_its_bc_is_refused_on_every_device(case, code):
    """A Shock on a z-walled grid whose bcz gives the slot no code, or a
    code other than 's' on either wall, raises on the CPU and on the card,
    naming the slot and the BC to add: the chains on the card fill the
    slot's z ghosts by its code, the eager path and the pre-pass by the
    symmetric closure, which is 's'."""
    cfg = _without_shock_bc(make(pt, case))
    if code is not None:
        cfg = cfg.replace(bcz=cfg.bcz + (pt.BC.parse("shock", code),))
    for dev in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError,
                           match=r"'shock' slot.*BC\('shock', 's'\)"):
            pt.Model(cfg, device=dev)


def test_halo1_closes_the_slot_symmetrically_between_walls():
    """The pre-pass's halo1 on the z-walled grid: the x/y wrap, then the
    symmetric closure about each wall (JAX's halo1)."""
    pm = pt.Model(make(pt, "conv"), device="cpu")
    jm = pj.Model(make(pj, "conv"))
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    got = pm._make_halo1(None)(torch.tensor(x)).numpy()
    want = np.asarray(jm._make_halo1(jm.grid)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    g = 3
    np.testing.assert_array_equal(got[..., g - 1], got[..., g + 1])
    np.testing.assert_array_equal(got[..., -g], got[..., -g - 2])


# ---- the reference fault ----------------------------------------------------------
def test_jax_paths_part_without_a_bc_for_the_slot():
    """The reference fault behind the refusal (ROADMAP Queue 3): without a
    bcz code for the shock slot, JAX's fused zghost path wraps the slot's
    z ghosts (fill_ghosts wraps every axis first,
    pencil_tpu/parallel/halo.py:108, and apply_axis_bcs fills only the
    components bcz lists, pencil_tpu/ops/boundary.py:1178) while its jnp
    path closes them by bc_sym (pencil_tpu/model.py:368-395): after 2
    steps the two part by more than the 2e-5 bound in u.  With the code
    's' they agree (the chain tests above)."""
    def cfg(pkg, fused):
        return _without_shock_bc(make(pj, "conv", fused=fused))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        over = start_overrides({"uu"}, 13)
        states = {}
        for fused in (True, False):
            jm = pj.Model(cfg(pj, fused))
            js = jm.init_state(5, overrides=over)
            step = jm.make_step()
            for _ in range(NSTEPS):
                js = step(js)
            states[fused] = js
    u_fused = np.asarray(states[True]["fields"]["uu"], np.float64)
    u_jnp = np.asarray(states[False]["fields"]["uu"], np.float64)
    err = np.abs(u_fused - u_jnp).max() / np.abs(u_jnp).max()
    assert err > RTOL_FIELD, err
