"""The stratified shearing box (the conv-slab with Shear, hydro and MHD:
``conv_slab(n, Omega=0.5, shear=True[, magnetic=True])``) in
pencil_tpu_torch against pencil_tpu: the plain versions of K6s/K7s and
K6ms/K7ms (the z-ghosted shear builds) against the zghost Pallas kernels
traced with Shear, on the x/y-ghosted body and the z-halo slabs cut from
the JAX package's 3-axis fill with the shifted x faces; the sheared
slabs against that fill, corners included; 3 steps of the port's zghost
chain against the JAX fused (zghost) and jnp paths; a step that leaves
its input alone; the gate, the libraries and launch names; a JAX state
of the set through the converters.

The JAX side runs as tests/test_torch_zghost_mhd.py runs it: the Pallas
kernels in interpret mode with one tile over the whole domain (PC_TX =
PC_CX = nx; the JAX Gravity module sizes its acceleration from the
global grid, ROADMAP Queue 3), inputs from numpy with a seed, velocity
and vector-potential noise of 1e-2.  Shear parity starts at t = 0.37,
where deltay = 0.2775·Ly is not a whole number of cells (at t =
0 the shifted faces are plain wraps).  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, the CFL maximum
and dt within 1e-6 relative.
"""
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
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.model import fused_gate, fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.parallel.halo import ghosted_from_sheared_z_slabs
from test_torch_zghost_mhd import (AA_AMPL, UU_AMPL, assert_field_close,
                                   assert_states_close, noisy_fields)

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
OMEGA = 0.5
TSTART = 0.37
NSTEPS = 3
G = 3
# the sheared sets: conv_slab keyword arguments
CASES = {"shear": dict(Omega=OMEGA, shear=True),
         "mag_shear": dict(Omega=OMEGA, shear=True, magnetic=True)}
# the kernels' cases: (shape, set, chi-const and del6 on)
KERNEL_CASES = (((16, 16, 16), "shear", False),
                ((16, 16, 32), "mag_shear", False),
                ((16, 16, 32), "shear", True),
                ((16, 16, 16), "mag_shear", True))
KERNEL_IDS = tuple(f"{'x'.join(map(str, s))}-{c}{'-chi-h3' if x else ''}"
                   for s, c, x in KERNEL_CASES)


def sheared_cfg(pkg, shape, case, extra=False, fused=True):
    """The sheared set ``case`` at ``shape`` from t = TSTART; ``extra``
    adds chi-const (χ = 4e-3) and del6 hyper-diffusion."""
    cfg = conv_slab(shape, fused=fused, pkg=pkg,
                    **dict(CASES[case], **(dict(chi=4e-3, hyper3=True)
                                           if extra else {})))
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))


def jax_sdy(jm, t=TSTART):
    return jm.cfg.module("shear").deltay(jnp.float32(t), jm.cfg.grid.Lx,
                                         jm.cfg.grid.Ly)


def jax_sheared_fill(jm, fa):
    """The JAX 3-axis fill of ``fa`` (numpy) with the x faces shifted by
    deltay at TSTART, as numpy."""
    return np.asarray(j_fill_ghosts(
        jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
        jm.eos, shear_dy=jax_sdy(jm)))


def zg_split(fg):
    """(body, zlo, zhi) of a 3-axis ghosted stack as the sheared z-ghosted
    kernels take them: x and y ghosted, z interior, and the z ghosts over
    the whole ghosted x and y."""
    t = torch.tensor(fg)
    return (t[..., G:-G].contiguous(), t[..., :G].contiguous(),
            t[..., -G:].contiguous())


@pytest.fixture(scope="module", params=KERNEL_CASES, ids=KERNEL_IDS)
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for one
    sheared set, each on a noisy stack filled with the shifted faces,
    every result kept as numpy."""
    shape, case, extra = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(sheared_cfg(pj, shape, case, extra))
        pm = pt.Model(sheared_cfg(pt, shape, case, extra), device="cpu")
        fg = jax_sheared_fill(jm, noisy_fields(pm, np.random.default_rng(5)))
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, False, True)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = jax_sheared_fill(jm, noisy_fields(pm,
                                                np.random.default_rng(6)))
        df2, f2, _ = jm._fused_rhs(shape, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2), extra=extra)


def test_rhs_zg_shear_matches_pallas(kernels):
    """K6s's (K6ms's) plain version: df with −S·x·∂f/∂y on every field,
    −S·u_x on u_y (−S·A_y on A_x), and the max 1/dt with |S·x|/Δy."""
    pm = kernels["pm"]
    first = fr.zg_kernels(pm)[0]
    assert "_shear" in first and first.endswith(
        "_chi_h3" if kernels["extra"] else "_shear")
    df, dt1m = fr.rhs_zg(pm, *zg_split(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape == (pm.reg.nvar,) + pm.cfg.grid.shape
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_shear_upd_matches_pallas(kernels):
    """K7s's (K7ms's) plain version: df (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *zg_split(kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", ((16, 16, 16), (16, 16, 32), (8, 12, 10)),
                         ids=("16^3", "16x16x32", "8x12x10"))
def test_sheared_slabs_are_the_3_axis_fill(shape, case):
    """Model.zg_input with the shifted faces (the x/y fill, then a z-only
    fill of its end planes) joined in z is the port's 3-axis fill with
    shear_dy bit for bit and JAX's within 1e-6 of each field's max, the
    ghost corners beside the shifted faces included; the input stays as
    it was."""
    pm = pt.Model(sheared_cfg(pt, shape, case), device="cpu")
    jm = pj.Model(sheared_cfg(pj, shape, case, fused=False))
    fa = noisy_fields(pm, np.random.default_rng(7))
    before = torch.tensor(fa)
    t = torch.tensor(fa)
    sdy = pm.deltay(torch.tensor(TSTART))
    body, zlo, zhi = pm.zg_input(t, sdy)
    assert torch.equal(t, before)
    nx, ny, nz = shape
    assert body.shape == (pm.reg.nvar, nx + 2 * G, ny + 2 * G, nz)
    assert zlo.shape == zhi.shape == body.shape[:3] + (G,)
    fg = ghosted_from_sheared_z_slabs(body, zlo, zhi)
    assert torch.equal(fg, pm.ghosted(t, shear_dy=sdy))
    want = jax_sheared_fill(jm, fa)
    # the shift moves the faces by a fraction of a cell: not a wrap
    assert not np.array_equal(want[:, :G, G:-G, G:-G], fa[:, -G:])
    for c in range(pm.reg.nvar):
        assert_field_close(fg[c], want[c], f"fg[{c}]", rtol=1e-6)


def test_step_leaves_its_input_alone():
    """A sheared (MHD) step on a packed stack whose walls are not pinned
    leaves that stack as it was, and gives the step of the same fields
    unpacked; uz, A_x and A_y stay 0 on the walls, all finite."""
    pm = pt.Model(sheared_cfg(pt, (8, 8, 16), "mag_shear"), device="cpu")
    s0 = pm.init_state(4)
    fa = torch.tensor(noisy_fields(pm, np.random.default_rng(9)))
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


def run_both(shape, case, jax_fused, seed):
    """The JAX package (fused or jnp path) and the port's zghost chain
    (plain K6s/K7s or K6ms/K7ms on the CPU), NSTEPS steps from t = TSTART
    and the JAX init with u and A replaced by numpy noise."""
    jm = pj.Model(sheared_cfg(pj, shape, case, fused=jax_fused))
    pm = pt.Model(sheared_cfg(pt, shape, case), device="cpu")
    assert pm.mode == "zghost"
    if jax_fused:
        assert jm._fused_mode(None, jax_sdy(jm), shape[2]) == "zghost"
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    if "aa" in pm.reg.slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + shape)).astype(
            np.float32)
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    assert float(ps["t"]) == float(js["t"]) == np.float32(TSTART)
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


@pytest.mark.parametrize("case", CASES)
def test_sheared_step_matches_jax_fused(case, monkeypatch):
    """The port's zghost chain with Shear against the JAX fused zghost
    step, 3 steps at 16×16×32."""
    shape = (16, 16, 32)
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    assert_states_close(*run_both(shape, case, True, seed=11))


@pytest.mark.parametrize("case", CASES)
def test_sheared_step_matches_jax_jnp_path(case):
    """The port's zghost chain with Shear against the JAX jnp path, 3
    steps at 16³."""
    assert_states_close(*run_both((16, 16, 16), case, False, seed=12))


@pytest.mark.parametrize("case", CASES)
def test_shear_acts(case):
    """Shear moves the step: the same 2 steps without it differ in uu by
    more than a tenth of its max (the terms are live, not zeros)."""
    shape = (8, 8, 16)
    with_s = pt.Model(sheared_cfg(pt, shape, case), device="cpu")
    kw = {k: v for k, v in CASES[case].items() if k != "shear"}
    without = pt.Model(conv_slab(shape, **kw).replace(
        time=pt.TimeSpec(itorder=3, tstart=TSTART)), device="cpu")
    fields = with_s.reg.unstack(torch.tensor(
        noisy_fields(with_s, np.random.default_rng(3))))
    out = [m.make_multi_step(2)(m.init_state(0, overrides=fields))
           for m in (with_s, without)]
    ref = out[1]["fields"]["uu"]
    gap = float((out[0]["fields"]["uu"] - ref).abs().max())
    assert gap > 0.1 * float(ref.abs().max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("extra", (False, True), ids=("plain", "chi-h3"))
def test_gate_takes_the_sheared_builds(case, extra):
    """Each sheared set (and with chi-const and del6) runs the zghost chain
    on the card and on the CPU, on fused_rhs_zg_shear or
    fused_rhs_zg_mag_shear, under the launch names with _shear, with the
    shear rate S = −qΩ and the x nodes x0 + ½dx among the kernel
    constants."""
    cfg = sheared_cfg(pt, 8, case, extra)
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    mag = "mag" in case
    lib = fr.zg_library(pm)
    assert lib == ("fused_rhs_zg_mag_shear" if mag else "fused_rhs_zg_shear")
    base = ("rhs_zg_mag_shear", "rhs_zg_upd_mag_shear") if mag else (
        "rhs_zg_shear", "rhs_zg_upd_shear")
    assert fr.ZG_KERNELS[lib] == base
    sfx = "_chi_h3" if extra else ""
    assert fr.zg_kernels(pm) == tuple(k + sfx for k in base)
    assert all(k in fr.LAUNCHES for k in fr.zg_kernels(pm))
    p = fr.kernel_params(pm)
    f32 = np.float32
    assert p.S == f32(-1.5 * OMEGA)
    assert list(p.om) == [0.0, 0.0, f32(OMEGA)]
    gs = cfg.grid
    assert p.x0 == f32(gs.x0 + 0.5 * gs.dx) and p.dx == f32(gs.dx)
    assert [m.name for m in cfg.modules][3:6] == ["gravity", "shear",
                                                  "viscosity"]
    with pytest.raises(ValueError):
        conv_slab(8, shear=True)


def test_jax_sheared_state_converts(tmp_path):
    """A JAX sheared magnetoconvection state crosses as numpy through
    overrides_from_numpy, and its var.npz through snapshot_from_jax, and
    starts the port's state bit for bit, t included."""
    jm = pj.Model(sheared_cfg(pj, 8, "mag_shear", fused=False))
    pm = pt.Model(sheared_cfg(pt, 8, "mag_shear"), device="cpu")
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    over = overrides_from_numpy(fields, pm.reg)
    assert list(over) == ["uu", "lnrho", "ss", "aa"]
    save_snapshot(tmp_path / "var.npz", js)
    snap = snapshot_from_jax(tmp_path / "var.npz", pm)
    for k, v in fields.items():
        np.testing.assert_array_equal(snap["fields"][k].numpy(), v, k)
    assert float(snap["t"]) == float(js["t"]) == np.float32(TSTART)
    out = pm.make_step()(snap)                 # it steps on from there
    assert all(bool(torch.isfinite(v).all()) for v in out["fields"].values())
