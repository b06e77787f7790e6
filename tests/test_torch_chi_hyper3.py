"""Entropy's hyper-diffusion and its cooling terms in pencil_tpu_torch
against pencil_tpu on the CPU: χ₃ (``chi_hyper3``, Δ⁻⁶-scaled), its mesh
flavour (``chi_hyper3_mesh``) and its anisotropic flavour
(``chi_hyper3_aniso``), which the H3 instances of the 12 builds with ss
take as s's own del6 (coefficient ``PcParams.chi3``, weights ``h6s``),
and Newtonian cooling (``tau_cool``) and the uniform heating and cooling
(``heat_uniform``, ``cool_uniform``), which every build with ss takes.

Here: the eager RHS with each option against the JAX package's Model.rhs
(its jnp path); the plain versions of the H3 instances with χ₃ (K1e, K2e,
K3e with Newtonian and uniform cooling; K6, K7) against the Pallas kernels
traced with them in interpret mode, one tile over the domain (PC_TX =
PC_CX = nx); the kernel constants; the gate, which admits each flavour on
the 12 builds' sets and the cooling on the 8 periodic ones, and refuses
by name what no instance takes.  Two steps of the paths are in
test_torch_chi_hyper3_steps.py, so that xdist spreads the interpret-mode
calls.  At 8×8×16, inputs from numpy with a seed.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, the CFL maximum
within 1e-6 relative.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch import configs
from pencil_tpu_torch.core.grid import inverse_spacings
from pencil_tpu_torch.integrate.timestep import pow6
from pencil_tpu_torch.model import fused_gate, fused_mode, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.viscosity import PI5_1
from test_torch_zghost_mhd import assert_field_close

torch.set_num_threads(1)

RTOL_DT = 1e-6
SHAPE = (8, 8, 16)
G = 3
H3 = 5e-3 * (2 * np.pi / SHAPE[0]) ** 5     # configs' h3 on the 2π box

# each option of the eager RHS: the Entropy fields it sets
OPTIONS = {
    "chi_hyper3": dict(chi_hyper3=H3),
    "chi_hyper3_mesh": dict(chi_hyper3_mesh=configs.MESH_HYPER3),
    "chi_hyper3_aniso": dict(chi_hyper3_aniso=(H3, 2 * H3, 0.5 * H3)),
    "tau_cool": dict(tau_cool=0.5, TTref_cool=1.2),
    "uniform": dict(heat_uniform=0.1, cool_uniform=0.1),
}


# ``cfg`` (of either package) with Entropy's fields replaced
with_entropy = functools.partial(configs.with_module, name="entropy")


def noisy(pm, seed):
    """Numpy noise about the configuration's own fields (u, lnρ and s
    1e-2, A 1e-3: s's noise makes T vary, so the cooling acts), the shock
    slot built by the pre-pass where there is one."""
    rng = np.random.default_rng(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    parts = []
    for name, slot in pm.reg.slots.items():
        base = f[name].numpy().reshape((slot.ncomp,) + shape)
        amp = 0.0 if name == "shock" else 1e-3 if name == "aa" else 1e-2
        parts.append(base + amp * rng.standard_normal(base.shape))
    fa = torch.tensor(np.concatenate(parts).astype(np.float32))
    if pm.reg.nf > pm.reg.nvar:
        fa = pm._refresh_aux_fa(fa)
    return fa.numpy()


# ---- the eager RHS against JAX's --------------------------------------------
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_eager_rhs_matches_jax_model_rhs(option):
    """The port's eager RHS of forced MHD with ss and del6 (its composed
    modules, ``rhs_plain``) with each option against JAX's Model.rhs: df
    of every field (ds with the term, in JAX's place) and the max 1/dt
    (χ₃ and the anisotropic rate among the hyper-diffusivities, χ₃ᵐ's
    root after the wave speed)."""
    over = OPTIONS[option]
    jm = pj.Model(with_entropy(configs.forced_entropy(
        SHAPE, pkg=pj, hyper3=True, fused=False), **over))
    pm = pt.Model(with_entropy(configs.forced_entropy(
        SHAPE, hyper3=True, fused=False), **over), device="cpu")
    fa = noisy(pm, 3)
    jdf, jdt1, _ = jax.jit(lambda f: jm.rhs(f, jm.grid, 0.0))(
        jnp.asarray(fa))
    pdf, pdt1 = fr.rhs_plain(pm, torch.tensor(fa))
    np.testing.assert_allclose(float(pdt1), float(jnp.max(jdt1)),
                               rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(pdf[c].numpy(), np.asarray(jdf[c]), f"df[{c}]")


# ---- the H3 instances' plain versions against the Pallas kernels -----------
KSETS = {
    # K1e, K2e, K3e with χ₃, Newtonian and uniform cooling
    "forced_entropy": lambda pkg: with_entropy(configs.forced_entropy(
        SHAPE, pkg=pkg, hyper3=True, chi_hyper3=True, tau_cool=0.5),
        heat_uniform=0.05, cool_uniform=0.05),
    # K6, K7 with χ₃
    "conv_slab": lambda pkg: configs.conv_slab(SHAPE, pkg=pkg, hyper3=True,
                                               chi_hyper3=True),
}


@pytest.fixture(scope="module", params=sorted(KSETS))
def kernels(request):
    """The JAX package's kernels traced with χ₃ (interpret mode) on numpy
    inputs, numpy results: wrap mode's first, deferred tail and last
    tail (K1e, K2e, K3e), or zghost's first and update (K6, K7) on the
    3-axis fill."""
    case = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jm = pj.Model(KSETS[case](pj))
        pm = pt.Model(KSETS[case](pt), device="cpu")
        zg = pm.mode == "zghost"

        def inp(seed):
            fa = noisy(pm, seed)
            return np.asarray(j_fill_ghosts(
                jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid,
                jm.cfg, jm.eos)) if zg else fa

        z = jm.grid.z
        fa, fa2 = inp(5), inp(6)
        alpha, beta, _ = jm.rk
        df1, dt1 = jm._fused_rhs(SHAPE, False, not zg, zg)(jnp.asarray(fa),
                                                           z)
        dt = np.float32(1.0 / float(jnp.max(dt1)))
        out = dict(pm=pm, fa=fa, fa2=fa2, df1=np.asarray(df1),
                   dt1max=float(jnp.max(dt1)), dt=dt)
        if zg:
            df2, f2, _ = jm._fused_rhs(SHAPE, True, False, True)(
                jnp.asarray(fa2), z, df1, alpha[1], beta[1] * dt)
            out.update(df2=np.asarray(df2), f2=np.asarray(f2))
            return out
        out["coef2"] = np.array([alpha[1], beta[1] * dt, beta[0] * dt],
                                np.float32)
        out["coef3"] = np.array([alpha[2], beta[2] * dt, 0.0], np.float32)
        df2, f2 = jm._fused_rhs(SHAPE, True, True, False, True, False,
                                False)(jnp.asarray(fa), z, df1, alpha[1],
                                       beta[1] * dt, cprev=beta[0] * dt)
        out.update(df2=np.asarray(df2), f2=np.asarray(f2))
        out["f3"] = np.asarray(jm._fused_rhs(
            SHAPE, True, True, False, False, True, False)(
            f2, z, df2, alpha[2], beta[2] * dt))
    return out


def _zsplit(fg):
    t = torch.tensor(fg)[..., G:-G, G:-G, :]
    return (t[..., G:-G].contiguous(), t[..., :G].contiguous(),
            t[..., -G:].contiguous())


def test_first_kernel_with_chi3_matches_pallas(kernels):
    """K1e's and K6's H3 plain versions with χ₃ (K1e with the cooling
    terms too): df of every field and the max 1/dt with χ₃ in the del6
    rate."""
    pm = kernels["pm"]
    if pm.mode == "zghost":
        assert fr.zg_kernels(pm)[0] == "rhs_zg_h3"
        df, dt1m = fr.rhs_zg(pm, *_zsplit(kernels["fa"]))
    else:
        assert fr.launch_suffix(pm) == "_ent_h3"
        df, dt1m = fr.rhs_first(pm, torch.tensor(kernels["fa"]))
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(pm.reg.nvar):
        assert_field_close(df[c], kernels["df1"][c], f"df1[{c}]")


def test_tail_kernels_with_chi3_match_pallas(kernels):
    """K2e's and K3e's H3 plain versions (df2 and f2 from raw f0 and df1;
    f3), or K7's (df written over df_prev, and f)."""
    pm = kernels["pm"]
    if pm.mode == "zghost":
        alpha, beta, _ = pm.rk
        coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                            beta[1] * torch.tensor(kernels["dt"])))
        df_prev = torch.tensor(kernels["df1"])
        df, f = fr.rhs_zg_upd(pm, *_zsplit(kernels["fa2"]), df_prev, coef)
        assert df is df_prev
        pairs = (("df2", df), ("f2", f))
    else:
        df2, f2 = fr.rhs_tail_defer(pm, torch.tensor(kernels["fa"]),
                                    torch.tensor(kernels["df1"]),
                                    torch.tensor(kernels["coef2"]))
        f3 = fr.rhs_tail_last(pm, torch.tensor(kernels["f2"]),
                              torch.tensor(kernels["df2"]),
                              torch.tensor(kernels["coef3"]))
        pairs = (("df2", df2), ("f2", f2), ("f3", f3))
    for name, got in pairs:
        for c in range(pm.reg.nvar):
            assert_field_close(got[c], kernels[name][c], f"{name}[{c}]")


# ---- the constants ----------------------------------------------------------
def test_kernel_constants_of_each_flavour():
    """χ₃: coefficient χ₃, weights Δ⁻⁶, χ₃ in the del6 rate; the mesh
    flavour: χ₃ᵐπ⁻⁵ with dline_1/60 and its root in hmesh; the anisotropic
    one: 1 with χ₃ⱼΔⱼ⁻⁶ and Σχ₃ⱼΔⱼ⁻⁶/ΣΔⱼ⁻⁶ in the del6 rate.  Without any,
    chi3 = 0 and the instance of before (no _h3 without another del6)."""
    f32 = np.float32
    inv = np.array(inverse_spacings(pt.GridSpec(*SHAPE)), f32)
    inv6 = pow6(inv)
    dxyz6 = (inv6[0] + inv6[1]) + inv6[2]
    cdtv3 = f32(pt.TimeSpec().cdtv3)
    d = {}
    for flavour in (True, "mesh", "aniso"):
        pm = pt.Model(configs.forced_entropy(SHAPE, chi_hyper3=flavour),
                      device="cpu")
        d[flavour] = (fr.kernel_params(pm), fr.launch_suffix(pm))
    p, sfx = d[True]
    assert sfx == "_ent_h3" and p.chi3 == f32(H3)
    np.testing.assert_array_equal(list(p.h6s), inv6)
    np.testing.assert_allclose(p.dif3, f32(H3) * dxyz6 / cdtv3, rtol=1e-6)
    p, _ = d["mesh"]
    assert p.chi3 == f32(configs.MESH_HYPER3 * PI5_1) and p.dif3 == 0.0
    np.testing.assert_array_equal(list(p.h6s), inv / f32(60.0))
    np.testing.assert_allclose(
        p.hmesh, configs.MESH_HYPER3 * PI5_1 * np.sqrt((inv ** 2).sum()),
        rtol=1e-6)
    p, _ = d["aniso"]
    chia = np.array((H3, H3, 0.5 * H3), f32)
    assert p.chi3 == 1.0
    np.testing.assert_array_equal(list(p.h6s), chia * inv6)
    np.testing.assert_allclose(
        p.dif3, (chia * inv6).sum() / dxyz6 * dxyz6 / cdtv3, rtol=1e-5)
    pm = pt.Model(configs.forced_entropy(SHAPE), device="cpu")
    assert fr.kernel_params(pm).chi3 == 0.0 and fr.launch_suffix(pm) == "_ent"


# ---- the gate ---------------------------------------------------------------
# the 8 periodic builds' sets with ss and their chains' modes
PERIODIC_SS = {
    "fused_rhs_ent": (lambda: configs.forced_entropy(SHAPE), "wrap"),
    "fused_rhs_hydro_ent": (
        lambda: configs.forced_entropy(SHAPE, magnetic=False), "wrap"),
    "fused_rhs_shock_ent": (lambda: configs.shock_box(SHAPE, entropy=True),
                            "wrap_aux"),
    "fused_rhs_shock_hydro_ent": (
        lambda: configs.shock_box(SHAPE, magnetic=False, entropy=True),
        "wrap_aux"),
    "fused_rhs_shear_ent": (lambda: configs.shear_box(SHAPE, entropy=True),
                            "zroll"),
    "fused_rhs_shear_ent_ns": (
        lambda: configs.shear_box(SHAPE, entropy=True, shock=False),
        "zroll"),
    "fused_rhs_shear_hydro_ent": (
        lambda: configs.shear_box(SHAPE, magnetic=False, entropy=True),
        "zroll"),
    "fused_rhs_shear_hydro_ent_ns": (
        lambda: configs.shear_box(SHAPE, magnetic=False, entropy=True,
                                  shock=False), "zroll"),
}
# and the 4 z-ghosted builds with ss and H3 instances
ZG_SS = {
    "fused_rhs_zg": (lambda: configs.conv_slab(SHAPE), "zghost"),
    "fused_rhs_zg_mag": (lambda: configs.conv_slab(SHAPE, magnetic=True),
                         "zghost"),
    "fused_rhs_zg_shear": (lambda: configs.conv_slab(
        SHAPE, shear=True, Omega=0.5), "zghost"),
    "fused_rhs_zg_mag_shear": (lambda: configs.conv_slab(
        SHAPE, magnetic=True, shear=True, Omega=0.5), "zghost"),
}


def _library(pm):
    if pm.mode == "zghost":
        return fr.zg_library(pm)
    if pm.mode == "wrap":
        return fr.flagship_library(pm)
    return fr.aux_library(pm)


@pytest.mark.parametrize("lib", sorted(PERIODIC_SS) + sorted(ZG_SS))
def test_gate_admits_each_flavour_on_the_builds_with_ss(lib):
    """χ₃, χ₃ᵐ and χ₃ⱼ each pass the gate on the card and the CPU on each
    of the 12 builds' sets with ss, which then launch their H3 instances
    (launch names with _h3; the aux builds' under their own names); on
    the 8 periodic ones Newtonian cooling and the uniform heating and
    cooling pass too, beside χ₃."""
    make, mode = {**PERIODIC_SS, **ZG_SS}[lib]
    for flavour in (True, "mesh", "aniso"):
        cfg = configs.with_chi_hyper3(make(), flavour)
        assert fused_mode(cfg) == (mode, None), flavour
        for dev in ("cpu", "cuda"):
            assert fused_gate(cfg, dev) is True
        pm = pt.Model(cfg, device="cpu")
        assert _library(pm) == lib and fr.kernel_params(pm).chi3 > 0.0
        if mode == "zghost":
            assert fr.zg_kernels(pm)[0].endswith("_h3")
        elif mode == "wrap":
            assert fr.launch_suffix(pm).endswith("_h3")
    if lib in PERIODIC_SS:
        cfg = with_entropy(configs.with_chi_hyper3(make()), tau_cool=0.5,
                           TTref_cool=1.5, heat_uniform=0.1,
                           cool_uniform=0.05)
        assert fused_mode(cfg) == (mode, None)
        assert fused_gate(cfg, "cuda") is True
        p = fr.kernel_params(pt.Model(cfg, device="cpu"))
        assert (p.tau_cool, p.heat_uniform) == (np.float32(0.5),
                                                np.float32(0.1))


# the card's refusals beside χ₃, with what each names
REFUSED = {
    "chi_hyper3 with chi_hyper3_mesh": lambda: with_entropy(
        configs.forced_entropy(SHAPE, chi_hyper3=True), chi_hyper3_mesh=5.0),
    "chi_hyper3_mesh with chi_hyper3_aniso": lambda: with_entropy(
        configs.conv_slab(SHAPE, chi_hyper3="mesh"),
        chi_hyper3_aniso=(H3, H3, H3)),
    "lupw_ss": lambda: with_entropy(
        configs.shock_box(SHAPE, entropy=True, magnetic=False),
        chi_hyper3=H3, lupw_ss=True),
    "Shock module on a z-walled grid": lambda: configs.conv_slab(
        SHAPE, shock=True, chi_hyper3=True),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_card_refuses_by_name(name):
    """Two flavours of s's del6 at once (one weight vector a field), χ₃
    beside upwinding and χ₃ beside the walled shock slot (no instance has
    both): refused on the card by name, before any launch; the eager path
    on the CPU."""
    cfg = REFUSED[name]()
    why = gate_reason(cfg)
    assert name in why and "chi_hyper3" in why, why
    with pytest.raises(NotImplementedError, match=name):
        fused_gate(cfg, "cuda")
    with pytest.raises(NotImplementedError, match="chi_hyper3"):
        pt.Model(cfg, device="cuda")
    assert pt.Model(cfg, device="cpu").mode is None


@pytest.mark.parametrize("name", ("hyper3-sph", "hyper3_sph", "hyper3-cyl",
                                  "hyper3_cyl"))
def test_polar_flavours_are_refused_on_every_device(name):
    """The polar hyper-diffusion of s needs curvilinear coordinates: the
    port's Entropy refuses it by name whatever the device; the other
    flavours' names are taken as JAX takes them (their coefficients pick
    their terms)."""
    with pytest.raises(NotImplementedError, match=name):
        pt.Entropy(iheatcond=("K-const", name), chi_hyper3=H3)
    ent = pt.Entropy(iheatcond=("K-const", "hyper3", "hyper3-mesh",
                                "hyper3_aniso"), chi_hyper3=H3)
    assert ent.chi_hyper3 == H3
