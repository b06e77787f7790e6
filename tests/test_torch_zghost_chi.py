"""Convection with chi-const conduction (the conv-slab and
magnetoconvection with 'chi-const' beside K-const, χ = 4e-3, ``chi=`` of
``configs.conv_slab``) in pencil_tpu_torch against pencil_tpu: the plain
versions of the CHI instances of K6/K7 and K6m/K7m (with Ω on the
magnetic set) against the zghost Pallas kernels traced for those module
sets; 3 steps of the port's zghost chain against the JAX fused (zghost)
and jnp paths; the term shown to act; the gate, the launch names and the
configuration function's default.

The JAX side runs as tests/test_torch_zghost_mhd.py runs it: the Pallas
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
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_zghost_mhd import (AA_AMPL, UU_AMPL, assert_field_close,
                                   assert_states_close, ghosted_input,
                                   z_split)

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (16, 16, 32))
SHAPE_IDS = ("16^3", "16x16x32")
CHI = 4e-3
OMEGA = 0.5
# the module sets these tests cover: conv_slab keyword arguments
CASES = {"chi": dict(chi=CHI), "mag_chi": dict(magnetic=True, chi=CHI),
         "mag_chi_rot": dict(magnetic=True, chi=CHI, Omega=OMEGA)}
NSTEPS = 3


@pytest.fixture(scope="module", params=sorted(CASES))
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) traced for one module
    set with chi-const on one ghosted input each at 16×16×32, every result
    kept as numpy (the steps below run at 16³ too)."""
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
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_chi_matches_pallas(kernels):
    """K6's (K6m's) CHI plain version: df with cp·χ(∇²lnT + ∇lnT·(∇lnT +
    ∇lnρ)) in ds, and the max 1/dt with χγ among the diffusivities."""
    pm = kernels["pm"]
    assert fr.zg_kernels(pm)[0].endswith("_chi")
    df, dt1m = fr.rhs_zg(pm, *z_split(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    assert df.shape[0] == pm.reg.nvar
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_chi_matches_pallas(kernels):
    """K7's (K7m's) CHI plain version: df (written over df_prev) and f."""
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
    (plain CHI instances on the CPU), NSTEPS steps from the JAX init with
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


def start_states(jm, pm, seed):
    """The JAX init (piecew-poly lnρ and s) with u and A replaced by numpy
    noise, in both packages, bit for bit."""
    shape = pm.cfg.grid.shape
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
    return js, ps


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_chi_step_matches_jax_fused(shape, case, monkeypatch):
    """The port's zghost chain with chi-const against the JAX fused
    zghost step, 3 steps."""
    monkeypatch.setenv("PC_TX", str(shape[0]))
    monkeypatch.setenv("PC_CX", str(shape[0]))
    assert_states_close(*run_both(shape, case, True, seed=11))


@pytest.mark.parametrize("case", CASES)
def test_chi_step_matches_jax_jnp_path(case):
    """The port's zghost chain with chi-const against the JAX jnp path, 3
    steps at 16³."""
    assert_states_close(*run_both((16, 16, 16), case, False, seed=12))


@pytest.mark.parametrize("case", CASES)
def test_chi_term_shows(case):
    """The same 3 steps without chi-const leave s (and u, which its
    buoyancy drives) more than 100× the parity bound away: the term
    cannot be silently off."""
    kw = CASES[case]
    out = {}
    for chi in (kw["chi"], 0.0):
        pm = pt.Model(conv_slab((16, 16, 16), **{**kw, "chi": chi}),
                      device="cpu")
        ps = start_states(pj.Model(conv_slab((16, 16, 16), pkg=pj,
                                             **{**kw, "chi": chi})),
                          pm, 11)[1]
        for _ in range(NSTEPS):
            ps = pm.make_step()(ps)
        out[chi] = ps["fields"]
    for k in ("ss", "uu"):
        b = out[kw["chi"]][k]
        diff = float((out[0.0][k] - b).abs().max())
        assert diff > 100 * RTOL_FIELD * float(b.abs().max()), (k, diff)


@pytest.mark.parametrize("case", CASES)
def test_fused_mode_takes_the_chi_instances(case):
    """Each set with chi-const runs the zghost chain on the card and on the
    CPU, on its layout's z-ghosted build, with cp·χ in the kernel
    constants and χγ in the CFL's constant diffusivity (JAX's
    ``ts.diffus(chi*gamma)``, rounded to f32 once, as the plain version's
    maximum rounds it), its launch names with _chi."""
    cfg = conv_slab(8, **CASES[case])
    assert fused_mode(cfg) == ("zghost", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    mag = "mag" in case
    lib = fr.zg_library(pm)
    assert lib == ("fused_rhs_zg_mag" if mag else "fused_rhs_zg")
    assert fr.zg_kernels(pm) == tuple(k + "_chi" for k in fr.ZG_KERNELS[lib])
    p = fr.kernel_params(pm)
    f32 = np.float32
    gamma = pm.eos.gamma
    assert p.cpchi == f32(pm.eos.cp * CHI)
    assert p.maxdif == f32(max(4e-3, 4e-3 if mag else 0.0, CHI * gamma))
    assert p.hcond0 > 0.0
    plain = pt.Model(conv_slab(8, magnetic=mag), device="cpu")
    assert fr.kernel_params(plain).cpchi == 0.0
    assert fr.zg_kernels(plain) == fr.ZG_KERNELS[lib]


def test_hyper3_on_the_conv_slab_stays_refused():
    """Of del6 hyper-diffusion on the z-ghosted sets, which JAX fuses, the
    H3 instances take 'hyper3-simplified', η₃ and D₃
    (tests/test_torch_zghost_hyper3.py) and the 'hyper3-mesh' flavour in
    place of 'hyper3-simplified' (tests/test_torch_hyper3_mesh.py), beside
    the set with chi-const that the zghost chain runs; both flavours on u
    at once stay refused on the card, named."""
    cfg = conv_slab(8, magnetic=True, chi=CHI, hyper3=True)
    assert gate_reason(cfg) is None
    assert fr.zg_kernels(pt.Model(cfg, device="cpu")) == (
        "rhs_zg_mag_chi_h3", "rhs_zg_upd_mag_chi_h3")

    def visc(*ivisc):
        return cfg.replace(modules=tuple(
            pt.Viscosity(ivisc=("nu-const",) + ivisc, nu=4e-3,
                         nu_hyper3=1e-9) if m.name == "viscosity"
            else m for m in cfg.modules))

    mesh = visc("hyper3-mesh")
    assert gate_reason(mesh) is None
    assert fr.zg_kernels(pt.Model(mesh, device="cpu")) == (
        "rhs_zg_mag_chi_h3", "rhs_zg_upd_mag_chi_h3")
    with pytest.raises(NotImplementedError, match="hyper3-mesh"):
        fused_gate(visc("hyper3-simplified", "hyper3-mesh"), "cuda")


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
def test_conv_slab_defaults_to_no_chi(pkg):
    """``chi=0.0`` is conv_slab's default, in both packages: K-const alone,
    the configuration of before; ``chi`` > 0 adds 'chi-const' after it."""
    for mag in (False, True):
        cfg = conv_slab(8, pkg=pkg, magnetic=mag)
        assert cfg == conv_slab(8, pkg=pkg, magnetic=mag, chi=0.0)
        assert cfg.module("entropy").iheatcond == ("K-const",)
        ent = conv_slab(8, pkg=pkg, magnetic=mag, chi=CHI).module("entropy")
        assert ent.iheatcond == ("K-const", "chi-const")
        assert ent.chi == CHI and ent.hcond0 == cfg.module("entropy").hcond0
