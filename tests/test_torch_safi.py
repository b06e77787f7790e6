"""SAFI (``lshearadvection_as_shift``: the shear advection as an exact
Fourier shift after each substep) and ``Sshear`` in pencil_tpu_torch
against pencil_tpu: ``Shear.shift_advection`` against JAX's, the plain
versions of K4/K5, K6s/K7s and K6msi/K7msi with SAFI against the Pallas
kernels traced with it, the SAFI steps of the zroll chain (MHD with and
without the shock slot, hydro) and of the z-ghosted shear chains against
the JAX fused step, the shifts each substep makes, pure shear (Ω = 0,
``Sshear``), and the gate.

The JAX side runs as tests/test_torch_shear.py runs it: the Pallas
kernels in interpret mode, the z-walled sets with one tile over the whole
domain (PC_TX = PC_CX = nx: the JAX Gravity module sizes its vector from
the global grid, ROADMAP Queue 3).  Runs start at t = 0.37, where the
shear-periodic faces are not plain wraps.  Bounds: each field within 2e-5
× its max, dt and the CFL maximum within 1e-6 relative (those of
tests/test_fused.py); the shift alone within 1e-6 of the field's max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab, shear_box, strat_box
from pencil_tpu_torch.model import fused_gate, fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
RTOL_SHIFT = 1e-6
TSTART = 0.37
NSTEPS = 2
G = 3


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def timed(cfg, pkg):
    return dataclasses.replace(cfg, time=pkg.TimeSpec(itorder=3,
                                                      tstart=TSTART))


# the SAFI sets: name -> (configuration function, keyword arguments, shape)
SETS = {
    "shear_box": (shear_box, {}, (8, 16, 8)),
    "shear_box_ns": (shear_box, dict(shock=False), (8, 16, 8)),
    "hydro_shear_box": (shear_box, dict(magnetic=False), (8, 16, 8)),
    "sheared_conv_slab": (conv_slab, dict(Omega=0.5, shear=True),
                          (8, 8, 16)),
    "mri_box": (strat_box, {}, (8, 8, 16)),
}


def safi_cfg(pkg, case, fused=True):
    """The SAFI set ``case`` of ``pkg`` from t = TSTART, unforced (the
    hydro shear box's forcing dropped)."""
    make, kw, shape = SETS[case]
    cfg = make(shape, fused=fused, pkg=pkg, safi=True, **kw)
    cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                    if m.name != "forcing"))
    return timed(cfg, pkg)


def noisy(pm, seed):
    """Numpy noise of the model's evolved fields (u, lnρ 1e-2 about the
    configuration's own lnρ and ss, A 1e-3) and a positive shock slot
    where the layout has one."""
    rng = np.random.default_rng(seed)
    f = pm.init_state(0)["fields"]
    parts = []
    for name, slot in pm.reg.slots.items():
        if name == "shock":
            parts.append(1e-3 * rng.random((1,) + pm.cfg.grid.shape))
            continue
        base = f[name].numpy().reshape((slot.ncomp,) + pm.cfg.grid.shape)
        amp = 1e-3 if name == "aa" else 1e-2
        parts.append(base + amp * rng.standard_normal(base.shape))
    return np.concatenate(parts).astype(np.float32)


# ---- the shift --------------------------------------------------------------
@pytest.mark.parametrize("shape", ((16, 32, 16), (64, 256, 64)),
                         ids=("16x32x16", "64x256x64"))
def test_shift_advection_matches_jax(shape):
    """Shear.shift_advection against JAX's (shear.py:84-95) at each RK3
    substep's dtsub of a dt of 0.0123 and of 0.37, where the phase reaches
    hundreds of radians at 256 rows: the phase is formed in f32 in JAX's
    order."""
    kw = dict(nx=shape[0], ny=shape[1], nz=shape[2], x0=-0.5, y0=-0.5,
              z0=-0.5, Lx=1.0, Ly=1.0, Lz=1.0)
    jm = pj.Model(pj.Config(grid=pj.GridSpec(**kw), modules=(
        pj.EosIdealGas(gamma=1.0), pj.Density(), pj.Hydro(),
        pj.Shear(lshearadvection_as_shift=True))))
    pm = pt.Model(pt.Config(grid=pt.GridSpec(**kw), modules=(
        pt.EosIdealGas(gamma=1.0), pt.Density(), pt.Hydro(),
        pt.Shear(lshearadvection_as_shift=True))), device="cpu")
    a = np.random.default_rng(1).standard_normal((2,) + shape).astype(
        np.float32)
    for dt in (0.0123, 0.37):
        for frac in (1.0 / 3.0, 5.0 / 12.0, 0.25):
            want = np.asarray(jm.cfg.module("shear").shift_advection(
                jnp.asarray(a), jm.grid, jm.cfg.grid,
                frac * jnp.float32(dt)))
            got = pm.shear.shift_advection(
                torch.tensor(a), pm.grid, pm.cfg.grid.Ly,
                frac * torch.tensor(dt, dtype=torch.float32))
            assert got.dtype == torch.float32
            assert_field_close(got, want, (dt, frac), rtol=RTOL_SHIFT)
            # a shift of several cells, not the identity
            assert np.abs(want - a).max() > 0.01 * np.abs(a).max()


# ---- the kernels' plain versions against the Pallas kernels -----------------
@pytest.fixture(scope="module", params=("shear_box", "sheared_conv_slab",
                                        "mri_box"))
def kernels(request):
    """The first and update kernel of the JAX package traced with SAFI
    (interpret mode, one tile over the domain) on inputs ghosted with the
    shifted x faces, as numpy: zroll (K4/K5) or zghost (K6s/K7s,
    K6msi/K7msi)."""
    case = request.param
    shape = SETS[case][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(safi_cfg(pj, case))
        pm = pt.Model(safi_cfg(pt, case), device="cpu")
        zg = pm.mode == "zghost"
        sdy = jm.cfg.module("shear").deltay(jnp.float32(TSTART),
                                            jm.cfg.grid.Lx, jm.cfg.grid.Ly)
        assert jm._fused_mode(None, sdy, shape[2]) == pm.mode

        def fill(seed):
            return np.asarray(j_fill_ghosts(
                jnp.asarray(noisy(pm, seed)), jm.cfg.grid, jm.bc_axes,
                jm.reg, jm.grid, jm.cfg, jm.eos,
                axes=(0, 1, 2) if zg else (0, 1), shear_dy=sdy))

        z = jm.grid.z
        fg, fg2 = fill(5), fill(6)
        df1, dt1 = jm._fused_rhs(shape, False, False, zg)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        df2, f2, _ = jm._fused_rhs(shape, True, False, zg)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def port_input(pm, fg):
    """The port's kernel input from a JAX fill: the x/y-ghosted stack, and
    for the z-ghosted builds its z slabs (the z ghosts over the ghosted x
    and y)."""
    t = torch.tensor(fg)
    if pm.mode != "zghost":
        return (t,)
    return (t[..., G:-G].contiguous(), t[..., :G].contiguous(),
            t[..., -G:].contiguous())


def test_first_kernel_matches_pallas(kernels):
    """K4's, K6s's or K6msi's plain version with SAFI: df without the
    −S·x·∂f/∂y terms and the max 1/dt without |S·x|/Δy; the kernel's
    shear-flow nodes are 0 (the flow S·x is 0) and S stays for the
    stretching terms."""
    pm = kernels["pm"]
    first = fr.rhs_zg if pm.mode == "zghost" else fr.rhs_zroll
    df, dt1m = first(pm, *port_input(pm, kernels["fg"]))
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")
    p = fr.kernel_params(pm)
    assert p.x0 == p.dx == 0.0 and p.S == np.float32(pm.shear.S)


def test_update_kernel_matches_pallas(kernels):
    """K5's, K7s's or K7msi's plain version with SAFI: df (written over
    df_prev) and f, the same sum as the JAX step's jnp lines under
    SAFI."""
    pm = kernels["pm"]
    upd = fr.rhs_zg_upd if pm.mode == "zghost" else fr.rhs_zroll_upd
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = upd(pm, *port_input(pm, kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


# ---- steps against the JAX fused step ---------------------------------------
def run_both(case, seed=11):
    """NSTEPS SAFI steps of the JAX fused step (Pallas interpret mode, the
    shift in jnp) and of the port's chain from the same noisy fields."""
    jm = pj.Model(safi_cfg(pj, case))
    pm = pt.Model(safi_cfg(pt, case), device="cpu")
    assert pm.mode in ("zroll", "zghost") and pm.safi
    fa = noisy(pm, seed)
    over = {k: fa[pm.reg.slice(k)] if pm.reg.slots[k].ncomp > 1
            else fa[pm.reg.slice(k)][0] for k in pm.reg.slots}
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    jstep, pstep = jax.jit(jm.make_step()), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


def assert_steps_close(js, ps):
    """dt, t and the evolved fields.  The JAX SAFI step keeps its state's
    shock slot as it was (its pre-pass writes a local copy), the port's
    chain the last pre-pass's, as its chain without SAFI does: the slot
    is rebuilt before every kernel, so no step reads the state's."""
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]),
                               rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=RTOL_DT)
    for k, v in js["fields"].items():
        if k != "shock":
            assert_field_close(ps["fields"][k], v, k)


@pytest.mark.parametrize("case", sorted(SETS))
def test_safi_step_matches_jax_fused(case, monkeypatch):
    """The zroll chain (MHD with and without the shock slot, hydro) and
    the z-ghosted shear chains (the sheared conv-slab, the stratified MRI
    box) with SAFI against the JAX fused step, 2 steps."""
    shape = SETS[case][2]
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    assert_steps_close(*run_both(case))


def test_safi_shifts_each_substep(monkeypatch):
    """Each substep shifts the evolved fields by its own dtsub = (c_{i+1}
    − c_i)·dt (RK3: dt·(1/3, 5/12, 1/4)), and the df carry too on every
    substep but the last; the shock slot is not shifted."""
    pm = pt.Model(safi_cfg(pt, "shear_box"), device="cpu")
    calls = []
    shift = type(pm.shear).shift_advection

    def record(self, arr, grid, Ly, dtsub):
        calls.append((arr.shape[0], float(dtsub)))
        return shift(self, arr, grid, Ly, dtsub)

    monkeypatch.setattr(type(pm.shear), "shift_advection", record)
    s = pm.make_step()(pm.init_state(2))
    dt = float(s["dt"])
    nvar = pm.reg.nvar
    want = [(nvar, dt / 3.0), (nvar, dt / 3.0), (nvar, 5.0 * dt / 12.0),
            (nvar, 5.0 * dt / 12.0), (nvar, dt / 4.0)]
    assert [c[0] for c in calls] == [w[0] for w in want]
    np.testing.assert_allclose([c[1] for c in calls], [w[1] for w in want],
                               rtol=1e-6)


def test_safi_packed_multi_step_bit_identical_to_dict_step():
    """Under SAFI the packed multi-step is the dict step bit for bit, and
    a step leaves its input alone."""
    pm = pt.Model(shear_box(8, safi=True), device="cpu")
    a = pm.init_state(3)
    before = {k: v.clone() for k, v in a["fields"].items()}
    a1 = pm.make_step()(a)
    for k, v in before.items():
        assert torch.equal(a["fields"][k], v), k
    a2 = pm.make_step()(a1)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a2[key], b[key]), key
    for k in a2["fields"]:
        assert torch.equal(a2["fields"][k], b["fields"][k]), k


def test_safi_drops_the_shear_from_the_cfl():
    """The same state sets a longer dt under SAFI: the shear's |S·x|/Δy,
    the largest advective rate of the box, leaves the CFL."""
    dts = []
    for safi in (False, True):
        pm = pt.Model(shear_box(16, safi=safi, hyper3=False), device="cpu")
        dts.append(float(pm.make_step()(pm.init_state(1))["dt"]))
    assert dts[1] > 1.2 * dts[0]


# ---- pure shear -------------------------------------------------------------
def pure_shear(pkg, fused=True):
    """The hydro shear box without rotation: Sshear = −1.2, Ω = 0, no
    Coriolis, unforced."""
    cfg = shear_box(8, fused=fused, pkg=pkg, magnetic=False, shock=False)
    return timed(cfg.replace(modules=tuple(
        pkg.Shear(Omega=0.0, Sshear=-1.2) if m.name == "shear"
        else pkg.Hydro(init="gaussian-noise", ampl=1e-2) if m.name == "hydro"
        else m for m in cfg.modules if m.name != "forcing")), pkg)


def test_sshear_matches_jax():
    """Sshear overrides −qΩ, deltay follows it, and 2 steps of the pure
    shear flow (Ω = 0) on the port's zroll chain match the JAX jnp path
    (the JAX fused step of a shear box without the shock slot takes the
    wrap tails, a reference fault, ROADMAP Queue 3)."""
    jm = pj.Model(pure_shear(pj, fused=False))
    pm = pt.Model(pure_shear(pt), device="cpu")
    assert pm.shear.S == jm.cfg.module("shear").S == -1.2
    assert pm.mode == "zroll" and fr.kernel_params(pm).S == np.float32(-1.2)
    assert list(fr.kernel_params(pm).om) == [0.0, 0.0, 0.0]
    gs = jm.cfg.grid
    t = jnp.float32(1.2345)
    assert float(pm.deltay(torch.tensor(1.2345))) == float(
        jm.cfg.module("shear").deltay(t, gs.Lx, gs.Ly))
    js = jm.init_state(4)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(4, overrides=overrides_from_numpy(fields, pm.reg))
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    assert_steps_close(js, ps)


# ---- the gate ---------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_takes_safi_on_the_shear_builds(case):
    """Every SAFI set runs its shear build's chain on the card and on the
    CPU, under its build's launch names."""
    cfg = safi_cfg(pt, case)
    mode, why = fused_mode(cfg)
    assert why is None and mode in ("zroll", "zghost")
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True


def test_safi_outside_the_shear_sets_is_refused_by_name():
    """SAFI beside the walled-shock builds (the shocked conv-slab in a
    shearing box) has no kernels: refused on the card, naming SAFI and the
    module set; the CPU runs the eager path."""
    cfg = conv_slab(8, shock=True, Omega=0.5)
    cfg = cfg.replace(modules=cfg.modules + (
        pt.Shear(Omega=0.5, lshearadvection_as_shift=True),))
    why = fused_mode(cfg)[1]
    assert "lshearadvection_as_shift" in why and "'shock'" in why
    assert fused_gate(cfg, "cpu") is False
    with pytest.raises(NotImplementedError, match="lshearadvection_as_shift"):
        fused_gate(cfg, "cuda")


# ---- the Nyquist bin --------------------------------------------------------
@pytest.mark.parametrize("which", ("x_faces", "safi"))
def test_shifts_hand_irfft_a_real_nyquist_bin(which, monkeypatch):
    """The shear-periodic x faces' shift and the SAFI shift pass the
    inverse FFT a spectrum whose Nyquist bin is real, the bin that
    numpy's, pocketfft's and the JAX package's irfft read as real: a shift
    makes it complex, and cuFFT's C2R reads its imaginary part too (at 256
    rows the card's shifted faces parted from the CPU's by 1e-2 of their
    max, and the shear box's fields after 2 steps at 256³ by 1.5e-2).
    The result stays numpy's in float64 within the f32 phase's error."""
    from pencil_tpu_torch.physics.shear import fourier_shift_y
    seen = []
    irfft = torch.fft.irfft

    def spy(spec, n=None, dim=-1, **kw):
        seen.append(float(spec.narrow(dim, n // 2, 1).imag.abs().max()))
        return irfft(spec, n=n, dim=dim, **kw)

    monkeypatch.setattr(torch.fft, "irfft", spy)
    ny = 64
    a = np.random.default_rng(3).standard_normal((2, 4, ny, 8)).astype(
        np.float32)
    f32 = np.float32
    if which == "x_faces":
        got = fourier_shift_y(torch.tensor(a), torch.tensor(0.555), 1.0)
        shift = np.full((a.shape[1],), f32(0.555))
    else:
        pm = pt.Model(shear_box((4, ny, 8), safi=True), device="cpu")
        dtsub = torch.tensor(0.0123, dtype=torch.float32)
        got = pm.shear.shift_advection(torch.tensor(a), pm.grid, 1.0, dtsub)
        shift = (f32(pm.shear.S) * pm.grid.x.numpy()) * dtsub.numpy()
    assert seen == [0.0]
    # the phase formed in f32 as the port forms it, the rest in float64
    k = np.arange(ny // 2 + 1, dtype=f32)        # j/Ly, Ly = 1
    theta = ((f32(-2.0 * np.pi) * k)[None, :] * shift[:, None]).astype(
        np.float64)
    want = np.fft.irfft(np.fft.rfft(a.astype(np.float64), axis=2)
                        * np.exp(1j * theta)[None, :, :, None], n=ny,
                        axis=2)
    assert_field_close(got, want, which, rtol=RTOL_SHIFT)
