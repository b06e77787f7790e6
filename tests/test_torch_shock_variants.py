"""Every switch of the Shock module in pencil_tpu_torch against pencil_tpu
on the CPU: the smoothing stages (``max_filter_axes``, ``smooth_7pt``
with binomial and 'gaussian' weights, an inactive axis cropped), the
profile ``Shock.compute_aux`` for each switch (the 'original' and
'highorder' variants, ``ishock_max`` 1-3, ``lgaussian_smooth``,
``lconvergence_only=False``, ``shock_div_pow=2``, ``lmax_shock=False``)
on a periodic grid (the shocked box) and a z-walled one (the shocked
conv-slab, the slot closed by bc_sym at the walls), and the 'highorder'
profile along whole chains: the shocked box (K1s/K5w) and the shocked
conv-slab and magnetoconvection (K6k/K7k, K6mk/K7mk), 2 steps of the
port's chain on the kernels' plain versions and of its eager path against
the JAX fused step (Pallas in interpret mode, one tile over the domain)
and the JAX jnp path.

Inputs are numpy noise with a seed at 8×8×16 (velocity 5e-2: a live shock
profile).  Bounds: the stages and the profile within 1e-6 of the JAX
result's max; the chains as tests/test_fused.py, each field within 2e-5
× its max (the slot against the fused step only: the JAX jnp path keeps
its zeros), dt within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu.ops.smooth as jsmooth
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as jax_fill_ghosts
from pencil_tpu.physics.pencils import Pencils as JaxPencils
from pencil_tpu_torch.configs import conv_slab, shock_box, with_shock_diffusion
from pencil_tpu_torch.model import fused_gate
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops import smooth
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_bext import evolved
from test_torch_zghost_mhd import assert_states_close
from test_torch_zghost_shock import run_all

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
RTOL_AUX = 1e-6

# the switches of JAX's Shock: keyword arguments of Shock
SWITCHES = {
    "original": {},
    "lmax_shock_off": dict(lmax_shock=False),
    "div_pow_2": dict(shock_div_pow=2.0),
    "abs_divu": dict(lconvergence_only=False),
    "highorder": dict(variant="highorder"),
    "highorder_r2": dict(variant="highorder", ishock_max=2),
    "highorder_r3": dict(variant="highorder", ishock_max=3),
    "highorder_gaussian": dict(variant="highorder", lgaussian_smooth=True),
    "highorder_abs_pow": dict(variant="highorder", lconvergence_only=False,
                              shock_div_pow=2.0),
}
# the grids: the shocked periodic box and the shocked conv-slab
GRIDS = {"periodic": lambda pkg: shock_box(SHAPE, pkg=pkg, fused=False),
         "walled": lambda pkg: conv_slab(SHAPE, pkg=pkg, fused=False,
                                         shock=True, magnetic=True)}


def assert_close(got, want, what, rtol=RTOL_AUX):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err)


# ---- the stages ---------------------------------------------------------------------
ACTIVE = ((True, True, True), (True, False, True), (False, True, False))


@pytest.mark.parametrize("radius", (1, 2, 3))
@pytest.mark.parametrize("active", ACTIVE, ids=("xyz", "xz", "y"))
def test_max_filter_axes_matches_jax(radius, active):
    """The running maximum over ±radius along the active axes, an
    inactive axis centre-cropped: equal to JAX's, value for value."""
    fg = np.random.default_rng(radius).standard_normal(
        (2, 14, 12, 20)).astype(np.float32)
    got = smooth.max_filter_axes(torch.tensor(fg), radius, active).numpy()
    want = np.asarray(jsmooth.max_filter_axes(jnp.asarray(fg), radius,
                                              active))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lgaussian", (False, True),
                         ids=("binomial", "gaussian"))
@pytest.mark.parametrize("active", ACTIVE, ids=("xyz", "xz", "y"))
def test_smooth_7pt_matches_jax(lgaussian, active):
    """The separable 7-point smoothing with the reference's weights
    (src/sub.f90 smoothing_kernel), each active axis shrinking by 6."""
    fg = np.random.default_rng(7).random((14, 12, 20)).astype(np.float32)
    got = smooth.smooth_7pt(torch.tensor(fg), active, lgaussian).numpy()
    want = np.asarray(jsmooth.smooth_7pt(jnp.asarray(fg), active,
                                         lgaussian))
    assert_close(got, want, "smooth_7pt")
    # normalised weights: a constant field stays itself
    ones = torch.ones((14, 12, 20))
    torch.testing.assert_close(smooth.smooth_7pt(ones, active, lgaussian),
                               torch.ones_like(torch.tensor(got)))


def test_max_filter_is_the_all_axes_case():
    fg = torch.tensor(np.random.default_rng(3).standard_normal(
        (10, 10, 12)).astype(np.float32))
    assert torch.equal(smooth.max_filter(fg, 2),
                       smooth.max_filter_axes(fg, 2, (True,) * 3))


# ---- the profile ------------------------------------------------------------------
def _with_shock(cfg, pkg, kw):
    return cfg.replace(modules=tuple(
        pkg.Shock(**kw) if m.name == "shock" else m for m in cfg.modules))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_compute_aux_matches_jax(switch, grid):
    """Shock.compute_aux with one switch set, on pencils of one noisy
    state ghosted by each package's fill (on the walled grid with the z
    BCs), with each model's halo1 (on the walled grid its symmetric
    closure at the walls): the profile within 1e-6 of JAX's max."""
    kw = SWITCHES[switch]
    jm = pj.Model(_with_shock(GRIDS[grid](pj), pj, kw))
    pm = pt.Model(_with_shock(GRIDS[grid](pt), pt, kw), device="cpu")
    assert pm.cfg.module("shock") == pt.Shock(**kw)
    rng = np.random.default_rng(11)
    fa = pm.reg.stack(pm.init_state(0)["fields"]).numpy()
    fa[:3] = 0.1 * rng.standard_normal((3,) + SHAPE)
    fa[3] += 1e-2 * rng.standard_normal(SHAPE).astype(np.float32)
    fa = fa.astype(np.float32)
    jfg = jax_fill_ghosts(jnp.asarray(fa[: jm.reg.ncom]), jm.cfg.grid,
                          jm.bc_axes, jm.reg, jm.grid, jm.cfg, jm.eos)
    want = jm.cfg.module("shock").compute_aux(
        JaxPencils(jfg, jm.grid, jm.reg, jm.cfg, jm.eos),
        jm._make_halo1(jm.grid))["shock"]
    got = pm.cfg.module("shock").compute_aux(
        Pencils(pm.ghosted(torch.tensor(fa)), pm.grid, pm.reg, pm.cfg,
                pm.eos, ghosted=True), pm._make_halo1(None))["shock"]
    assert float(np.asarray(want).max()) > 0.0
    assert_close(got.numpy(), want, f"{switch} on the {grid} grid")


def test_switches_move_the_profile():
    """Each switch changes the profile of the same state (so the tests
    above hold each one, not the default twice)."""
    pm = pt.Model(GRIDS["walled"](pt), device="cpu")
    rng = np.random.default_rng(2)
    fa = pm.reg.stack(pm.init_state(0)["fields"])
    fa[:3] = torch.tensor(0.1 * rng.standard_normal((3,) + SHAPE),
                          dtype=torch.float32)
    pen = Pencils(pm.ghosted(fa), pm.grid, pm.reg, pm.cfg, pm.eos,
                  ghosted=True)
    halo1 = pm._make_halo1(None)
    prof = {k: pt.Shock(**kw).compute_aux(pen, halo1)["shock"]
            for k, kw in SWITCHES.items()}
    for k, v in prof.items():
        if k != "original":
            assert not torch.equal(v, prof["original"]), k


def test_shock_refuses_what_it_lacks():
    with pytest.raises(NotImplementedError, match="variant"):
        pt.Shock(variant="lower-order")
    with pytest.raises(NotImplementedError, match="ishock_max"):
        pt.Shock(variant="highorder", ishock_max=4)


# ---- 'highorder' along the chains -------------------------------------------------
def _highorder(make):
    def cfg(pkg, fused):
        c = make(pkg, fused)
        return _with_shock(c, pkg, dict(variant="highorder"))
    return cfg


CHAINS = {
    "shock_box": (_highorder(lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused)), "wrap_aux"),
    "conv_slab": (_highorder(lambda pkg, fused: conv_slab(
        SHAPE, pkg=pkg, fused=fused, shock=True)), "zghost"),
    "magnetoconvection_chi_sd": (_highorder(lambda pkg, fused:
        with_shock_diffusion(conv_slab(SHAPE, pkg=pkg, fused=fused,
                                       shock=True, magnetic=True,
                                       chi=4e-3))), "zghost"),
}


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chains(request):
    make, mode = CHAINS[request.param]
    out = run_all(make)
    assert out["model"].mode == mode
    assert out["model"].cfg.module("shock").variant == "highorder"
    return out


def test_highorder_chain_matches_jax_fused(chains):
    assert_states_close(chains["jax_fused"], chains["chain"])


def test_highorder_chain_matches_jax_jnp_path(chains):
    assert_states_close(evolved(chains["jax_jnp"]), evolved(chains["chain"]))


def test_highorder_eager_step_matches_jax_jnp_path(chains):
    assert_states_close(evolved(chains["jax_jnp"]), evolved(chains["eager"]))


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_highorder_takes_the_same_kernels(case):
    """The profile is built before the kernels: the 'highorder' variant
    runs the build and instance of the 'original' one on the card."""
    make, _ = CHAINS[case]
    cfg = make(pt, True)
    assert fused_gate(cfg, "cuda")
    plain = _with_shock(cfg, pt, {})
    ho, og = (pt.Model(c, device="cpu") for c in (cfg, plain))
    if ho.mode == "zghost":
        assert fr.zg_kernels(ho) == fr.zg_kernels(og)
    else:
        assert fr.aux_kernels(ho) == fr.aux_kernels(og)
