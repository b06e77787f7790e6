"""Magnetoconvection and rotating convection (the conv-slab with Magnetic,
with Ω, and with both) in pencil_tpu_torch against pencil_tpu: the plain
versions of K6m/K7m (the 8-field z-ghosted build) and of the Coriolis
instances of K6/K7 against the zghost Pallas kernels traced for those
module sets, on the interior stack and the z-halo slabs cut from the JAX
package's ghosted stack; 3 steps of the port's zghost chain against the
JAX fused (zghost) and jnp paths; the z-only fill of the vector
potential's walls; the gate and the library each set takes; the state
converters on the 8-field state.

The JAX side runs as tests/test_torch_zghost.py runs it: the Pallas
kernels in interpret mode, with one tile over the whole domain (PC_TX =
PC_CX = nx; the JAX Gravity module sizes its acceleration from the global
grid, so its fused path fails on a smaller tile).  Inputs come from numpy
with a seed.  Velocity noise is 1e-2 (tests/test_torch_zghost.py,
UU_AMPL: at the configuration's 1e-3 the velocity sits below its float32
floor), and the vector potential gets noise of 1e-2 too, so that the
Lorentz force, u×B and the Ohmic heat are of the size of the other terms.
Bounds, those of tests/test_fused.py: each field within 2e-5 × its max,
the CFL maximum and dt within 1e-6 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.snapshot import save_snapshot
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                              snapshot_from_jax)
from pencil_tpu_torch.configs import conv_slab, strat_box
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.parallel.halo import ghosted_from_z_slabs

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (16, 16, 32))
SHAPE_IDS = ("16^3", "16x16x32")
OMEGA = 0.5
# the module sets these tests cover: conv_slab keyword arguments
CASES = {"mag": dict(magnetic=True), "rot": dict(Omega=OMEGA),
         "mag_rot": dict(magnetic=True, Omega=OMEGA)}
NSTEPS = 3
UU_AMPL = 1e-2
AA_AMPL = 1e-2


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def z_split(fg):
    """(fa, zlo, zhi) of a 3-axis ghosted stack: its interior and its z
    ghosts over the interior x and y, as the z-ghosted kernels take them."""
    g = 3
    body = torch.tensor(fg[:, g:-g, g:-g])
    return (body[..., g:-g].contiguous(), body[..., :g].contiguous(),
            body[..., -g:].contiguous())


def noisy_fields(pm, rng):
    """(nvar, nx, ny, nz) numpy: the conv-slab's initial lnρ and s with
    noise, noisy velocities and, with Magnetic, a noisy vector potential."""
    init = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    parts = [UU_AMPL * rng.standard_normal((3,) + shape),
             init["lnrho"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
             init["ss"].numpy()[None] + 1e-2 * rng.standard_normal(shape)]
    if "aa" in pm.reg.slots:
        parts.append(AA_AMPL * rng.standard_normal((3,) + shape))
    return np.concatenate(parts).astype(np.float32)


def ghosted_input(jm, pm, seed):
    """A noisy conv-slab stack ghosted by the JAX fill_ghosts (numpy)."""
    fa = noisy_fields(pm, np.random.default_rng(seed))
    fg = j_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                       jm.grid, jm.cfg, jm.eos)
    return np.asarray(fg)


@pytest.fixture(scope="module",
                params=[(s, c) for s in SHAPES for c in CASES],
                ids=[f"{i}-{c}" for i in SHAPE_IDS for c in CASES])
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for one module
    set on one ghosted input each, every result kept as numpy."""
    shape, case = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(conv_slab(shape, pkg=pj, **CASES[case]))
        pm = pt.Model(conv_slab(shape, **CASES[case]), device="cpu")
        fg = ghosted_input(jm, pm, seed=5)
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, False, True)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = ghosted_input(jm, pm, seed=6)
        df2, f2, _ = jm._fused_rhs(shape, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_matches_pallas(kernels):
    """K6m's plain version (K6's with Ω): df and the max 1/dt over tiles,
    the Alfvén speed and η in the CFL maximum with Magnetic."""
    pm = kernels["pm"]
    df, dt1m = fr.rhs_zg(pm, *z_split(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape[0] == pm.reg.nvar
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_matches_pallas(kernels):
    """K7m's plain version (K7's with Ω): df (written over df_prev) and
    f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *z_split(kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def run_both(shape, case, jax_fused, seed):
    """The JAX package (fused or jnp path) and the port's zghost chain
    (plain K6/K7 or K6m/K7m on the CPU), NSTEPS steps from the JAX init
    (piecew-poly lnρ and s) with u and A replaced by numpy noise."""
    jm = pj.Model(conv_slab(shape, fused=jax_fused, pkg=pj, **CASES[case]))
    pm = pt.Model(conv_slab(shape, **CASES[case]), device="cpu")
    assert pm.mode == "zghost"
    if jax_fused:
        assert jm._fused_mode(None, None, shape[2]) == "zghost"
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    if "aa" in pm.reg.slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(
            np.float32)
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    for k, v in fields.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


def assert_states_close(js, ps):
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=RTOL_DT)
    assert int(ps["it"]) == int(js["it"])
    assert sorted(ps["fields"]) == sorted(js["fields"])
    for k, b in js["fields"].items():
        assert_field_close(ps["fields"][k], b, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_zghost_step_matches_jax_fused(shape, case, monkeypatch):
    """The port's zghost chain against the JAX fused zghost step, 3 steps."""
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    assert_states_close(*run_both(shape, case, True, seed=11))


@pytest.mark.parametrize("case", CASES)
def test_zghost_step_matches_jax_jnp_path(case):
    """The port's zghost chain against the JAX jnp path, 3 steps at 16³."""
    assert_states_close(*run_both((16, 16, 16), case, False, seed=12))


@pytest.mark.parametrize("case", ("default",) + tuple(CASES))
def test_fused_mode_takes_the_zg_build_of_the_layout(case):
    """Each conv-slab set runs the zghost chain on the card and on the CPU,
    the 8-field layout on fused_rhs_zg_mag, with the kernel constants of
    its terms: η and the Ohmic heat, max(ν, η) as the CFL's constant
    diffusivity, Ω about z."""
    cfg = conv_slab(8, **CASES.get(case, {}))
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    mag = "mag" in case
    lib = fr.zg_library(pm)
    assert lib == ("fused_rhs_zg_mag" if mag else "fused_rhs_zg")
    assert fr.ZG_KERNELS[lib] == (("rhs_zg_mag", "rhs_zg_upd_mag") if mag
                                  else ("rhs_zg", "rhs_zg_upd"))
    p = fr.kernel_params(pm)
    eta = cfg.module("magnetic").eta if mag else 0.0
    nu = cfg.module("viscosity").nu
    f32 = np.float32
    assert p.eta == f32(eta) and p.eta_heat == f32(eta)
    assert p.maxdif == f32(max(nu, eta)) and p.two_nu == f32(2.0 * nu)
    assert list(p.om) == [0.0, 0.0, f32(OMEGA) if "rot" in case else 0.0]
    assert pm.reg.comp_names == (
        ["ux", "uy", "uz", "lnrho", "ss"] + (["ax", "ay", "az"] if mag
                                             else []))


def test_chi_const_is_admitted():
    """chi-const in magnetoconvection with Ω runs the zghost chain on the
    8-field build's CHI instances (the conv-slab's own case:
    tests/test_torch_entropy_box.py): cp·χ in the kernel constants, χγ in
    the CFL's constant diffusivity, the launch names with _chi."""
    cfg = conv_slab(8, magnetic=True, Omega=OMEGA)
    cfg = cfg.replace(modules=tuple(
        dataclasses.replace(m, iheatcond=("K-const", "chi-const"), chi=1e-3)
        if m.name == "entropy" else m for m in cfg.modules))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert pm.mode == "zghost"
    assert fr.zg_library(pm) == "fused_rhs_zg_mag"
    assert fr.zg_kernels(pm) == ("rhs_zg_mag_chi", "rhs_zg_upd_mag_chi")
    p = fr.kernel_params(pm)
    f32 = np.float32
    assert p.cpchi == f32(pm.eos.cp * 1e-3)
    assert p.maxdif == f32(max(4e-3, 1e-3 * pm.eos.gamma))


def test_other_sets_stay_refused():
    """The isothermal hydro set under gravity with z walls and Shock (the
    isothermal sets with z walls, the case here first, run since the
    builds without ss, tests/test_torch_zghost_iso.py, and the set on a
    fully periodic grid, the case after that, since gravity on every
    chain, tests/test_torch_gravity_chains.py), and magnetoconvection with
    Shock (no z-ghosted build has the shock slot; forced
    magnetoconvection, the case here before, runs since the kick after the
    step,
    tests/test_torch_zghost_forced.py; η₃ since the H3 instances,
    tests/test_torch_zghost_hyper3.py), raise on the card, each for its
    module set: the set is tested before Entropy's layer profiles."""
    base = conv_slab(8, magnetic=True)
    shocked = base.replace(modules=base.modules + (pt.Shock(),))
    walled = strat_box(8, magnetic=False, shear=False)
    iso = walled.replace(modules=walled.modules + (pt.Shock(),))
    for cfg in (shocked, iso):
        reason = gate_reason(cfg)
        assert reason is not None and reason.startswith("modules "), reason
        assert "cool/luminosity" not in reason
        with pytest.raises(NotImplementedError):
            pt.Model(cfg, device="cuda")


def test_default_conv_slab_is_unchanged():
    """conv_slab(n) with its defaults: no Magnetic, no Ω, the five z BCs
    of before, in both packages."""
    for pkg in (pt, pj):
        cfg = conv_slab(8, pkg=pkg)
        assert cfg == conv_slab(8, pkg=pkg, magnetic=False, Omega=0.0)
        assert [m.name for m in cfg.modules] == [
            "eos", "density", "hydro", "gravity", "viscosity", "entropy"]
        # the Hydro of before, which named no Ω
        assert cfg.module("hydro") == pkg.Hydro(init="gaussian-noise",
                                                ampl=1e-3)
        assert [bc.comp for bc in cfg.bcz] == ["ux", "uy", "uz", "lnrho",
                                               "ss"]
    mag = conv_slab(8, magnetic=True)
    assert [(bc.comp, bc.low, bc.high) for bc in mag.bcz[5:]] == [
        ("ax", "a", "a"), ("ay", "a", "a"), ("az", "s", "s")]


def noisy_state(pm, seed):
    """(8, nx, ny, nz) torch: the conv-slab's initial lnρ and s with noise
    and noisy u and A, the walls' uz, A_x, A_y and the top s unpinned."""
    return torch.tensor(noisy_fields(pm, np.random.default_rng(seed)))


@pytest.mark.parametrize("shape", SHAPES + ((8, 12, 10),),
                         ids=SHAPE_IDS + ("8x12x10",))
def test_z_slabs_are_the_3_axis_fill_with_aa(shape):
    """Model.z_slabs on the 8-field stack gives the 3-axis fill's z ghosts
    and pinned boundary planes bit for bit, the three aa components (the
    walls' 'a', 'a', 's') included."""
    pm = pt.Model(conv_slab(shape, magnetic=True), device="cpu")
    fa = noisy_state(pm, 7)
    fg = pm.ghosted(fa)
    pinned, zlo, zhi = pm.z_slabs(fa.clone())
    assert zlo.shape == (8,) + shape[:2] + (3,)
    want = z_split(fg.numpy())
    for name, a, b in zip(("fa", "zlo", "zhi"), (pinned, zlo, zhi), want):
        assert torch.equal(a, b), name
    for c in (5, 6):                     # A_x, A_y pinned to 0 on both walls
        assert not bool((fa[c][..., [0, -1]] == 0).all())
        assert bool((pinned[c][..., [0, -1]] == 0).all())
    assert torch.equal(ghosted_from_z_slabs(pinned, zlo, zhi), fg)


def test_step_leaves_its_input_alone():
    """A magnetoconvection step on a packed stack whose walls are not
    pinned leaves that stack as it was, and gives the step of the same
    fields unpacked; A_x, A_y and uz stay 0 on the walls, all finite."""
    pm = pt.Model(conv_slab((8, 8, 16), magnetic=True, Omega=OMEGA),
                  device="cpu")
    s0 = pm.init_state(4)
    fa = noisy_state(pm, 9)
    before = fa.clone()
    packed = pm.make_step()({"_fa": fa, "t": s0["t"], "dt": s0["dt"],
                             "it": s0["it"]})
    assert torch.equal(fa, before)
    unpacked = pm.make_step()(dict(s0, fields=pm.reg.unstack(before)))
    out = packed["_fa"]
    assert torch.equal(out, pm.reg.stack(unpacked["fields"]))
    assert bool(torch.isfinite(out).all())
    for c in (2, 5, 6):
        assert bool((out[c][..., [0, -1]] == 0).all()), c


def test_jax_magnetoconvection_state_converts(tmp_path):
    """A JAX magnetoconvection state (uu, lnrho, ss, aa) crosses as numpy
    through overrides_from_numpy, and its var.npz through
    snapshot_from_jax, and starts the port's state bit for bit."""
    jm = pj.Model(conv_slab(8, pkg=pj, magnetic=True))
    pm = pt.Model(conv_slab(8, magnetic=True), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert list(over) == ["uu", "lnrho", "ss", "aa"]
    ps = pm.init_state(4, overrides=over)
    for k, v in fields.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    save_snapshot(tmp_path / "var.npz", js)
    snap = snapshot_from_jax(tmp_path / "var.npz", pm)
    assert list(snap["fields"]) == list(pm.reg.slots)
    for k, v in fields.items():
        np.testing.assert_array_equal(snap["fields"][k].numpy(), v, k)
    assert float(snap["t"]) == float(js["t"])
    pm.make_step()(snap)                      # it steps on from there
    with pytest.raises(KeyError):
        overrides_from_numpy({k: v for k, v in fields.items() if k != "aa"},
                             pm.reg)
