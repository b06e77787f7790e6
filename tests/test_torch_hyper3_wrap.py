"""Hyper-diffusive turbulence in pencil_tpu_torch against pencil_tpu: the
four periodic sets of the flagship template (forced MHD, forced hydro and
both with an entropy field) with del6 hyper-diffusion of u, A and lnρ
('hyper3-simplified' ν₃, η₃, D₃ = 5e-3·dx⁵, ``hyper3=True`` of the
configuration functions), which run the H3 instances of the template's
kernels.  Here: 3 steps of the port's wrap chain against the JAX fused
step at 16³ and 16×16×32 (forced MHD and forced hydro; the entropy sets
and order 2 in test_torch_hyper3_entropy_steps.py) and against the JAX
jnp path at 16³ (all four sets, and the flagship at order 4); each of the
three terms shown to act; the gate and the configurations' defaults.
The plain versions of the H3 instances of every kernel kind against the
Pallas kernels are in test_torch_hyper3_kernels.py and
test_torch_hyper3_hydro_kernels.py (with Ω on the flagship's step), so
that the interpret-mode Pallas calls spread over workers.

The JAX side runs as tests/test_fused.py runs it on the CPU, with JAX's
forcing draws injected through ``Model.forcing_draws``.  Inputs come from
numpy with a seed: velocity and vector-potential noise of 1e-2.  Bounds,
those of tests/test_fused.py: each field within 2e-5 × its max, the CFL
maximum and dt within 1e-6 relative.  The JAX fused flagship step fails
at order 4 (ROADMAP Queue 3): order 4 is held to the JAX jnp path.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch import configs
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import jax_forcing_draws
from test_torch_rk_orders import assert_field_close

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
NSTEPS = 3
# the four periodic sets: (configuration function, keyword arguments)
SETS = {"mhd": (configs.flagship, {}),
        "hydro": (configs.forced_hydro, {}),
        "ent_mhd": (configs.forced_entropy, dict(magnetic=True)),
        "ent_hydro": (configs.forced_entropy, dict(magnetic=False))}
SUFFIX = {"mhd": "_h3", "hydro": "_hydro_h3", "ent_mhd": "_ent_h3",
          "ent_hydro": "_hydro_ent_h3"}


def config(pkg, case, shape=(16, 16, 16), itorder=3, fused=True,
           hyper3=True, Omega=0.0):
    """The set ``case`` with del6 hyper-diffusion (``hyper3``) at a 2N-RK
    order, with Ω about z where ``Omega`` is not 0."""
    build, kw = SETS[case]
    cfg = build(shape, fused=fused, pkg=pkg, hyper3=hyper3, **kw)
    mods = tuple(dataclasses.replace(m, Omega=Omega)
                 if m.name == "hydro" and Omega else m for m in cfg.modules)
    return dataclasses.replace(cfg, modules=mods, time=dataclasses.replace(
        cfg.time, itorder=itorder))


def fields(pm, seed):
    """The set's fields as numpy, the same for both packages: noise of
    1e-2 in u and A, layered lnρ and s with noise of 1e-3."""
    rng = np.random.default_rng(seed)
    shape = pm.cfg.grid.shape
    z = pm.grid.z.numpy()

    def noise(ampl, *lead):
        return (ampl * rng.standard_normal(lead + shape)).astype(np.float32)

    out = {"uu": noise(1e-2, 3),
           "lnrho": (0.05 * np.sin(z)[None, None, :]
                     + noise(1e-3)).astype(np.float32)}
    if "ss" in pm.reg.slots:
        out["ss"] = (0.02 * np.cos(z)[None, None, :]
                     + noise(1e-3)).astype(np.float32)
    if "aa" in pm.reg.slots:
        out["aa"] = noise(1e-2, 3)
    return out


# ---- the wrap chain against the JAX steps ----------------------------------
def run_both(case, shape=(16, 16, 16), itorder=3, jax_fused=True,
             Omega=0.0, seed=11):
    """The JAX step (fused or jnp) and the port's wrap chain (plain
    kernels on the CPU), NSTEPS forced steps from the same numpy fields
    with JAX's forcing draws."""
    jm = pj.Model(config(pj, case, shape, itorder, jax_fused, Omega=Omega))
    pm = pt.Model(config(pt, case, shape, itorder, Omega=Omega),
                  device="cpu")
    assert pm.mode == "wrap"
    init = fields(pm, seed)
    js = jm.init_state(seed, overrides=init)
    ps = pm.init_state(seed, overrides=init)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              NSTEPS)).__next__
    jstep = jax.jit(jm.make_step())
    for _ in range(NSTEPS):
        js, ps = jstep(js), pm.make_step()(ps)
    return js, ps


def assert_states_close(js, ps):
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=RTOL_DT)
    assert int(ps["it"]) == int(js["it"])
    assert sorted(ps["fields"]) == sorted(js["fields"])
    for k, b in js["fields"].items():
        assert_field_close(ps["fields"][k], b, k)


SHAPES = ((16, 16, 16), (16, 16, 32))
SHAPE_IDS = ("16^3", "16x16x32")


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("case", ("hydro", "mhd"))
def test_h3_step_matches_jax_fused(case, shape):
    """Forced MHD and forced hydro with hyper-diffusion, 3 forced steps at
    order 3 (K1, K2, K3 with the kick, their H3 instances) against the JAX
    fused step."""
    assert_states_close(*run_both(case, shape))


@pytest.mark.parametrize("case", sorted(SETS))
def test_h3_step_matches_jax_jnp_path(case):
    """Each set with hyper-diffusion, 3 forced steps at order 3 against
    the JAX jnp path at 16³."""
    assert_states_close(*run_both(case, jax_fused=False, seed=12))


def test_h3_flagship_rk4_matches_jax_jnp_path():
    """The flagship with hyper-diffusion at order 4 (K1, K2, 2×K3′, K3)
    against the JAX jnp path (the JAX fused flagship step fails at order
    4), 3 forced steps."""
    assert_states_close(*run_both("mhd", itorder=4, jax_fused=False))


# ---- each term acts ---------------------------------------------------------
# each del6 coefficient with the field it acts on first
TERMS = {"nu3": ("viscosity", "nu_hyper3", "uu"),
         "diff3": ("density", "diffrho_hyper3", "lnrho"),
         "eta3": ("magnetic", "eta_hyper3", "aa")}


def port_run(cfg, seed=11):
    """NSTEPS unforced steps of the port's wrap chain from numpy fields."""
    cfg = dataclasses.replace(cfg, modules=tuple(
        m for m in cfg.modules if m.name != "forcing"))
    pm = pt.Model(cfg, device="cpu")
    s = pm.init_state(seed, overrides=fields(pm, seed))
    for _ in range(NSTEPS):
        s = pm.make_step()(s)
    return s


@pytest.mark.parametrize("case", sorted(SETS))
def test_each_h3_term_shows(case):
    """With one of ν₃, D₃, η₃ off, the field it acts on ends more than
    100× the parity bound away from the run with all three; without any,
    every field and dt do.  So none of the terms can be silently off."""
    cfg = config(pt, case)
    ref = port_run(cfg)
    bound = 100 * RTOL_FIELD
    for term, (module, field, acted) in TERMS.items():
        if acted not in ref["fields"]:
            continue
        off = port_run(dataclasses.replace(cfg, modules=tuple(
            dataclasses.replace(m, **{field: 0.0}) if m.name == module
            else m for m in cfg.modules)))
        b = ref["fields"][acted]
        diff = float((off["fields"][acted] - b).abs().max())
        assert diff > bound * float(b.abs().max()), (term, diff)
    plain = port_run(config(pt, case, hyper3=False))
    for k, b in ref["fields"].items():
        diff = float((plain["fields"][k] - b).abs().max())
        assert diff > bound * float(b.abs().max()), (k, diff)
    assert abs(float(plain["dt"]) / float(ref["dt"]) - 1.0) > 100 * RTOL_DT


# ---- the gate and the configurations' defaults -----------------------------
@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_admits_hyper3_on_the_wrap_sets(case):
    """Each periodic set with hyper-diffusion, with and without Ω, runs the
    wrap chain on the card and on the CPU, its launch names with _h3; the
    kernel constants carry ν₃, D₃ (η₃ with Magnetic) and the del6 rate
    max(ν₃, η₃, D₃)·dxyz₆/cdtv3 as JAX's CFL forms it."""
    for Omega in (0.0, 1.0):
        cfg = config(pt, case, (8, 8, 8), Omega=Omega)
        assert fused_mode(cfg) == ("wrap", None)
        assert gate_reason(cfg) is None
        for dev in ("cpu", "cuda"):
            assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert fr.launch_suffix(pm) == SUFFIX[case]
    f32 = np.float32
    h3 = 5e-3 * (2 * np.pi / 8) ** 5
    p = fr.kernel_params(pm)
    assert p.nu3 == f32(h3) and p.diff3 == f32(h3)
    assert p.eta3 == (f32(h3) if "aa" in pm.reg.slots else 0.0)
    inv6 = f32(8 / (2 * np.pi)) ** 2 * (f32(8 / (2 * np.pi)) ** 2) ** 2
    assert p.dif3 == f32(h3) * ((inv6 + inv6) + inv6) / f32(0.01)
    assert fr.launch_suffix(pt.Model(config(pt, case, (8, 8, 8),
                                            hyper3=False), device="cpu")) \
        == SUFFIX[case][:-3]


def test_other_hyper3_flavours_stay_refused():
    """The flavours of the JAX modules that the port lacks ('nu-mixture',
    which needs chemistry, the polar 'hyper3-sph' and the polar and
    anisotropic diffusion of lnρ) raise as the port's Viscosity or Density
    is built, with their names; nu-shock on a periodic set without the
    Shock module stays outside the wrap chain, named."""
    for flavour in ("nu-mixture", "hyper3-sph"):
        with pytest.raises(NotImplementedError, match=flavour):
            pt.Viscosity(ivisc=("nu-const", flavour), nu=5e-3)
    for kw in (dict(lhyper3_polar=True),
               dict(diffrho_hyper3_aniso=(1e-9, 0.0, 0.0))):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            pt.Density(diffrho_hyper3=1e-9, **kw)
    cfg = config(pt, "mhd", (8, 8, 8))
    shocked = dataclasses.replace(cfg, modules=tuple(
        pt.Viscosity(ivisc=("nu-const", "nu-shock"), nu=5e-3, nu_shock=1.0)
        if m.name == "viscosity" else m for m in cfg.modules))
    assert "nu-shock" in gate_reason(shocked)
    with pytest.raises(NotImplementedError, match="nu-shock"):
        fused_gate(shocked, "cuda")


@pytest.mark.parametrize("case", sorted(SETS))
def test_mesh_flavour_takes_the_h3_instances(case):
    """'hyper3-mesh' and diffrho_hyper3_mesh (``hyper3="mesh"``: η₃ stays
    on A), once refused as the modules were built, run each periodic
    set's H3 instances on the card and on the CPU, with ν₃ᵐ·π⁻⁵ and
    D₃ᵐ·π⁻⁵ for coefficients and the mesh rate in the CFL."""
    cfg = config(pt, case, (8, 8, 8), hyper3="mesh")
    assert fused_mode(cfg) == ("wrap", None)
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    assert fr.launch_suffix(pm) == SUFFIX[case]
    p = fr.kernel_params(pm)
    pi5 = np.float32(configs.MESH_HYPER3 / 306.0196847852814)
    assert p.nu3 == pi5 == p.diff3 and p.hmesh > 0.0
    assert (p.dif3 > 0.0) == ("aa" in pm.reg.slots)


@pytest.mark.parametrize("pkg", (pt, pj), ids=("port", "jax"))
@pytest.mark.parametrize("name", ("flagship", "forced_hydro",
                                  "forced_entropy"))
def test_configs_default_to_no_hyper3(name, pkg):
    """``hyper3=False`` is each configuration function's default, in both
    packages: the configuration of before, with 'nu-const' alone and no
    hyper coefficient; ``hyper3=True`` sets ν₃ = η₃ = D₃ = 5e-3·dx⁵."""
    build = getattr(configs, name)
    cfg = build(16, pkg=pkg)
    assert cfg == build(16, pkg=pkg, hyper3=False)
    assert cfg.module("viscosity").ivisc == ("nu-const",)
    assert cfg.module("density").diffrho_hyper3 == 0.0
    mag = cfg.module("magnetic")
    assert mag is None or mag.eta_hyper3 == 0.0
    h3 = build(16, pkg=pkg, hyper3=True)
    want = 5e-3 * (2 * np.pi / 16) ** 5
    assert h3.module("viscosity").ivisc == ("nu-const", "hyper3-simplified")
    np.testing.assert_allclose(h3.module("viscosity").nu_hyper3, want,
                               rtol=1e-12)
    assert h3.module("density").diffrho_hyper3 \
        == h3.module("viscosity").nu_hyper3
    if h3.module("magnetic") is not None:
        assert h3.module("magnetic").eta_hyper3 \
            == h3.module("viscosity").nu_hyper3
