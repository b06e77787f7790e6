"""Hyper-diffusive convection (the conv-slab and magnetoconvection with
del6 hyper-diffusion of u, lnρ and A, ``hyper3=True`` of
``configs.conv_slab``: ν₃ = D₃ = η₃ = 5e-3·dx⁵) in pencil_tpu_torch against
pencil_tpu: the plain versions of the H3 instances of K6/K7 and K6m/K7m
(with chi-const and Ω on the magnetic set) against the zghost Pallas
kernels traced for those module sets at 8×16×24; 3 steps of the port's
zghost chain against the JAX fused (zghost) step at 16³ and 8×16×24 and
against the jnp path at 16³; the dxyz₆ rate in dt; the terms shown to
act; the gate, the launch names and the configuration function's
default.

The JAX side runs as tests/test_torch_zghost_chi.py runs it: the Pallas
kernels in interpret mode with one tile over the whole domain (PC_TX =
PC_CX = nx; ROADMAP Queue 3), inputs from numpy with a seed, velocity and
vector-potential noise of 1e-2.  Bounds, those of tests/test_fused.py:
each field within 2e-5 × its max, the CFL maximum and dt within 1e-6
relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.model import fused_gate, fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops.stencil import NGHOST
from test_torch_march_builds import _Recorder, recorded  # noqa: F401
from test_torch_zghost_chi import start_states
from test_torch_zghost_mhd import (assert_field_close, assert_states_close,
                                   ghosted_input, z_split)

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (8, 16, 24))
SHAPE_IDS = ("16^3", "8x16x24")
CHI = 4e-3
OMEGA = 0.5
# the module sets these tests cover: conv_slab keyword arguments
CASES = {"h3": dict(hyper3=True), "mag_h3": dict(magnetic=True, hyper3=True),
         "mag_chi_h3_rot": dict(magnetic=True, hyper3=True, chi=CHI,
                                Omega=OMEGA)}
NSTEPS = 3


@pytest.fixture(scope="module", params=sorted(CASES))
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for one module
    set with del6 hyper-diffusion on one ghosted input each at 8×16×24,
    every result kept as numpy."""
    shape, case = SHAPES[1], request.param
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
    return dict(case=case, pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_h3_matches_pallas(kernels):
    """K6's (K6m's) H3 plain version: df with D₃ del6 lnρ, ν₃ del6 u (and
    η₃ del6 A), and the max 1/dt with the dxyz₆ rate."""
    pm = kernels["pm"]
    assert fr.zg_kernels(pm)[0].endswith("_h3")
    df, dt1m = fr.rhs_zg(pm, *z_split(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape[0] == pm.reg.nvar
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_h3_matches_pallas(kernels):
    """K7's (K7m's) H3 plain version: df (written over df_prev) and f."""
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


def test_del6_terms_and_rate_act(kernels):
    """On the same input the set without hyper-diffusion leaves u, lnρ
    (and A) far outside the bound, and its CFL maximum lacks the dxyz₆
    rate max(ν₃, η₃, D₃)·dxyz₆/cdtv3, which the kernel constants carry as
    dif3, rounded to f32 as the plain version rounds it."""
    pm = kernels["pm"]
    kw = dict(CASES[kernels["case"]], hyper3=False)
    plain = pt.Model(conv_slab(pm.cfg.grid.shape, **kw), device="cpu")
    inp = z_split(kernels["fg"])
    df, dt1m = fr.rhs_zg(pm, *inp)
    df0, dt1m0 = fr.rhs_zg(plain, *inp)
    names = pm.reg.comp_names
    for c in range(pm.reg.nvar):
        if names[c] == "ss":     # no del6 term of its own
            continue
        err = float((df[c] - df0[c]).abs().max())
        assert err > 100 * RTOL_FIELD * float(df[c].abs().max()), names[c]
    assert float(dt1m) > (1 + 100 * RTOL_DT) * float(dt1m0)
    p, gs, tc = fr.kernel_params(pm), pm.cfg.grid, pm.cfg.time
    h3 = 5e-3 * gs.dx ** 5
    dxyz6 = sum((1.0 / d) ** 6 for d in (gs.dx, gs.dy, gs.dz))
    assert p.dif3 == pytest.approx(h3 * dxyz6 / tc.cdtv3, rel=1e-6)
    assert fr.kernel_params(plain).dif3 == 0.0


def run_both(shape, case, jax_fused, seed):
    """The JAX package (fused or jnp path) and the port's zghost chain
    (plain H3 instances on the CPU), NSTEPS steps from the JAX init with
    u and A replaced by numpy noise."""
    jm = pj.Model(conv_slab(shape, fused=jax_fused, pkg=pj, **CASES[case]))
    pm = pt.Model(conv_slab(shape, **CASES[case]), device="cpu")
    assert pm.mode == "zghost"
    if jax_fused:
        assert jm._fused_mode(None, None, shape[2]) == "zghost"
    js, ps = start_states(jm, pm, seed)
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    return js, ps


@pytest.mark.parametrize("case", ("h3", "mag_h3"))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_h3_step_matches_jax_fused(shape, case, monkeypatch):
    """The port's zghost chain with del6 hyper-diffusion against the JAX
    fused zghost step, 3 steps."""
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    assert_states_close(*run_both(shape, case, True, seed=11))


@pytest.mark.parametrize("case", ("h3", "mag_h3"))
def test_h3_step_matches_jax_jnp_path(case):
    """The port's zghost chain with del6 hyper-diffusion against the JAX
    jnp path, 3 steps at 16³."""
    assert_states_close(*run_both((16, 16, 16), case, False, seed=12))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_mode_takes_the_h3_instances(case):
    """Each set with hyper3=True runs the zghost chain on the card and on
    the CPU, on its layout's z-ghosted build, with ν₃ = D₃ (= η₃ with
    Magnetic) = 5e-3·dx⁵ in the kernel constants and its launch names
    with _h3 (after _chi where chi-const is on)."""
    cfg = conv_slab(8, **CASES[case])
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    mag = "mag" in case
    lib = fr.zg_library(pm)
    assert lib == ("fused_rhs_zg_mag" if mag else "fused_rhs_zg")
    sfx = ("_chi" if "chi" in case else "") + "_h3"
    assert fr.zg_kernels(pm) == tuple(k + sfx for k in fr.ZG_KERNELS[lib])
    assert all(k in fr.LAUNCHES for k in fr.zg_kernels(pm))
    p = fr.kernel_params(pm)
    h3 = np.float32(5e-3 * cfg.grid.dx ** 5)
    assert (p.nu3, p.diff3) == (h3, h3)
    assert p.eta3 == (h3 if mag else 0.0)
    assert p.nu == np.float32(4e-3) and p.hcond0 > 0.0


@pytest.mark.parametrize("magnetic", (False, True), ids=("hydro", "mhd"))
def test_wrappers_launch_the_h3_instances(recorded, magnetic):  # noqa: F811
    """K6 and K7 (K6m and K7m) with del6 launch pc_rhs_first and
    pc_rhs_tail_mid of their build, which picks the H3 instance from the
    coefficients, counted under the launch names with _h3; one K6 and two
    K7 a step."""
    shape = (16, 16, 32)
    pm = pt.Model(conv_slab(shape, magnetic=magnetic, hyper3=True),
                  device="cpu")
    lib = "fused_rhs_zg_mag" if magnetic else "fused_rhs_zg"
    first, upd = (k + "_h3" for k in fr.ZG_KERNELS[lib])
    nv = pm.reg.nvar
    fa = torch.zeros((nv,) + shape)
    slab = torch.zeros((nv,) + shape[:2] + (NGHOST,))
    fr.rhs_zg(pm, fa, slab, slab)
    fr.rhs_zg_upd(pm, fa, slab, slab, torch.zeros_like(fa), torch.zeros(2))
    assert recorded == [(lib, "pc_rhs_first"), (lib, "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 1})


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_conv_slab_defaults_to_no_hyper3(pkg):
    """``hyper3=False`` is conv_slab's default, in both packages: the
    configuration of before; ``hyper3=True`` adds 'hyper3-simplified' with
    ν₃ = 5e-3·dx⁵, D₃ and (with Magnetic) η₃ of the same value, ν, η and
    the rest unchanged."""
    for mag in (False, True):
        cfg = conv_slab(8, pkg=pkg, magnetic=mag)
        assert cfg == conv_slab(8, pkg=pkg, magnetic=mag, hyper3=False)
        assert cfg.module("viscosity").ivisc == ("nu-const",)
        h = conv_slab(8, pkg=pkg, magnetic=mag, hyper3=True)
        h3 = 5e-3 * (1.0 / 8) ** 5
        visc = h.module("viscosity")
        assert visc.ivisc == ("nu-const", "hyper3-simplified")
        assert visc.nu_hyper3 == h3 and visc.nu == 4e-3
        assert h.module("density").diffrho_hyper3 == h3
        if mag:
            assert h.module("magnetic").eta_hyper3 == h3
            assert h.module("magnetic").eta == 4e-3
        assert [m.name for m in h.modules] == [m.name for m in cfg.modules]
        assert h.bcz == cfg.bcz and h.grid == cfg.grid
