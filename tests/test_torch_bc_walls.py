"""The z-wall boundary conditions of pencil_tpu_torch against pencil_tpu's
``BC_REGISTRY``: every ported code on both walls, its fill as the z-walled
chains cut it (``Model.z_slabs`` and the chain's ghosting), the boundary
planes it pins, and the codes that stay refused.

Each case puts one code (or one set of codes) into the bcz of
``configs.conv_slab((8, 8, 16), magnetic=True)`` and fills the same seeded
numpy stack in both packages: every ghost cell, corners included, within
1e-6 of each field's max, the bound of tests/test_torch_boundary.py (a
fill copies and applies formulas; the FFT codes round as two FFTs do).
The stack is the conv-slab's initial lnρ and s with noise of 1e-2, and
noise of 1e-2 in u and A (uz of the 'e3' case offset to 0.5: a power law
needs a positive field).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.configs import conv_slab, fgs_sigma
from pencil_tpu_torch.model import fused_mode
from pencil_tpu_torch.ops import boundary as tb
from pencil_tpu_torch.parallel.halo import (fill_ghosts,
                                            ghosted_from_sheared_z_slabs,
                                            ghosted_from_z_slabs)

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
RTOL = 1e-6
SIGMA = fgs_sigma()
FLUX = dict(sigmaSBt=SIGMA, chi_t=2e-3, chit_prof1=0.5, chit_prof2=1.5,
            hcondbot=1e-3, hcondtop=2e-3, Fbot=0.02, Ftop=0.01)
# name: (bcz override, conv_slab keyword arguments, force_bound)
CASES = {
    "der": ({"ux": ("der", 0.5, -0.3)}, {}, None),
    "0": ({"uy": "0"}, {}, None),
    "cop": ({"ux": "cop"}, {}, None),
    "e1": ({"uy": "e1"}, {}, None),
    "e2": ({"ux": "e2"}, {}, None),
    "e3": ({"uz": "e3"}, {}, None),
    "s0d": ({"ux": "s0d", "uy": "s0d"}, {}, None),
    "1s": ({"uy": "1s"}, {}, None),
    "d1s": ({"ux": ("d1s", 0.01, -0.02)}, {}, None),
    "n1s": ({"uy": ("n1s", 0.1, 0.2)}, {}, None),
    "v": ({"ux": "v"}, {}, None),
    "v3": ({"uy": "v3"}, {}, None),
    "out": ({"uz": "out"}, {}, None),
    "ouf": ({"uz": "ouf"}, {}, None),
    "ubs": ({"uz": "ubs"}, {}, None),
    "nil": ({"ux": "nil"}, {}, None),
    "StS": ({"lnrho": "StS"}, {}, None),
    "none": ({"uy": "none"}, {}, None),
    "ism": ({"lnrho": ("ism", 0.9, 0.9), "ss": ("ism", 0.5, 0.5)}, {},
            None),
    "cdz": ({"lnrho": "cdz"}, {}, None),
    "sT": ({"ss": "sT"}, {}, None),
    "c2": ({"ss": ("c2", 1.2, 0.0)}, {}, None),
    "ctz": ({"ss": "ctz"}, {}, None),
    "cT2": ({"ss": ("cT2", 0.0, 1.1)}, {}, None),
    "ce": ({"ss": "ce"}, {}, None),
    "hs": ({"lnrho": "a2:hs", "ss": "c1:hs"}, {}, None),
    "div": ({"uz": ("div", 0.1, -0.1)}, {}, None),
    "pot": ({"ax": "pot", "ay": "pot", "az": "pot"}, {}, None),
    "pwd_pfe": ({"ux": "pwd", "uy": "pfe"}, {}, None),
    "c1_aa": ({"ax": "c1", "ay": "c1", "az": "c1"}, {}, None),
    "c1_aa_nil": ({"ax": "c1", "ay": "nil", "az": "nil"}, {}, None),
    "Fgs": ({"lnrho": "a2:hs", "ss": "c1:Fgs"}, dict(
        heatcond="kramers", entropy=FLUX), None),
    "Fgs_kconst": ({"ss": "Fgs"}, dict(entropy=FLUX), None),
    "Fct": ({"ss": "Fct"}, dict(entropy=FLUX), None),
    "Fct_kramers": ({"ss": "Fct"}, dict(heatcond="kramers", entropy=FLUX),
                    None),
    "g": ({"ux": "g", "ss": "g"}, {}, ("", "cT")),
}


def configs(name):
    over, kw, force = CASES[name]

    def cfg(pkg):
        c = conv_slab(SHAPE, magnetic=True, pkg=pkg, bcz=over, **kw)
        return c if force is None else c.replace(force_bound=force)

    return cfg(pj), cfg(None)


def stack(pm, name, seed=3):
    """(8, nx, ny, nz) float32: the initial lnρ and s with noise, and
    noise in u and A, from a numpy seed."""
    rng = np.random.default_rng(seed)
    init = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    fa = np.concatenate([
        1e-2 * rng.standard_normal((3,) + shape),
        init["lnrho"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
        init["ss"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
        1e-2 * rng.standard_normal((3,) + shape)]).astype(np.float32)
    if name == "e3":
        fa[2] += 0.5
    return fa


def assert_rel(a, b, what, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    for c in range(a.shape[0]):
        err = np.abs(a[c] - b[c]).max()
        assert err <= rtol * max(np.abs(b[c]).max(), 1e-30), (what, c, err)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jc, pc = configs(request.param)
    jm, pm = pj.Model(jc), pt.Model(pc, device="cpu")
    return request.param, jm, pm, stack(pm, request.param)


def test_fill_matches_jax(case):
    """The 3-axis fill with the case's codes on both walls against JAX's
    ``fill_ghosts``, each component by JAX's ``BC_REGISTRY`` function."""
    name, jm, pm, fa = case
    got = fill_ghosts(torch.tensor(fa), pm.cfg.grid, pm.bc_axes, pm.reg,
                      pm.grid, pm.cfg, pm.eos).numpy()
    want = np.asarray(j_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes,
                                    jm.reg, jm.grid, jm.cfg, jm.eos))
    assert np.isfinite(got).all()
    assert_rel(got, want, name)


def test_chain_fill_is_the_3_axis_fill(case):
    """``zg_input`` (``z_slabs`` of the chain's layout) and the kernels'
    ghosting give the 3-axis fill, ghost columns and corners included;
    the boundary planes it pins are ``bc_writeback``'s, and the caller's
    stack is left alone."""
    name, jm, pm, fa = case
    want = pm.ghosted(torch.tensor(fa)).numpy()
    src = torch.tensor(fa)
    body, zlo, zhi = pm.zg_input(src)
    ghost = ghosted_from_sheared_z_slabs if pm.zg_xy \
        else ghosted_from_z_slabs
    got = ghost(body, zlo, zhi).numpy()
    assert_rel(got, want, name)
    pinned = pm.bc_writeback(torch.tensor(fa)).numpy()
    inner = body.numpy()[:, 3:-3, 3:-3] if pm.zg_xy else body.numpy()
    np.testing.assert_array_equal(inner, pinned)
    if pm.zg_xy:
        np.testing.assert_array_equal(src.numpy(), fa)


def test_writeback_matches_jax(case):
    """The boundary planes the codes pin, written into the state as JAX's
    ``bc_writeback`` writes them."""
    name, jm, pm, fa = case
    got = pm.bc_writeback(torch.tensor(fa)).numpy()
    want = np.asarray(jm.bc_writeback(jnp.asarray(fa), jm.grid, 0.0))
    assert_rel(got, want, name)


def test_layout_and_depth_follow_the_codes():
    """'pot', 'pwd', 'pfe' and 'div' take the x/y-ghosted layout, 'e2',
    's0d' and the one-sided family a cut of 2g + 1 planes; the default
    conv-slab and magnetoconvection keep theirs."""
    for name in CASES:
        pm = pt.Model(configs(name)[1], device="cpu")
        codes = {c for bc in pm.cfg.bcz for c in (bc.low, bc.high)}
        assert pm.zg_xy == bool(codes & tb.COLUMN_CODES), name
        assert pm._zdepth == (7 if codes & tb.DEEP_CODES else 4), name
    for kw in ({}, dict(magnetic=True)):
        pm = pt.Model(conv_slab(SHAPE, **kw), device="cpu")
        assert (pm.zg_xy, pm._zdepth) == (False, 4)


def test_short_stack_fills_whole():
    """With nz below twice the cut's depth z_slabs fills the whole stack:
    's0d' on a 8×8×10 grid."""
    cfg = conv_slab((8, 8, 10), magnetic=True, bcz={"ux": "s0d"})
    pm = pt.Model(cfg, device="cpu")
    fa = stack(pm, "s0d")
    body, zlo, zhi = pm.zg_input(torch.tensor(fa))
    assert_rel(ghosted_from_z_slabs(body, zlo, zhi).numpy(),
               pm.ghosted(torch.tensor(fa)).numpy(), "short")


def test_potential_field_writes_zero_ghost_columns():
    """JAX's 'pot' (boundary.py:968) leaves zeros in the x/y ghost columns
    of its ghost planes, which no wrap gives: the port's 3-axis fill keeps
    them, and the chain runs the x/y-ghosted layout."""
    jc, pc = configs("pot")
    pm = pt.Model(pc, device="cpu")
    fg = pm.ghosted(torch.tensor(stack(pm, "pot"))).numpy()
    ax = pm.reg.comp_names.index("ax")
    assert np.all(fg[ax, :3, :, :3] == 0.0)
    assert np.abs(fg[ax, 3:-3, 3:-3, :3]).max() > 0.0
    assert pm.zg_xy and fused_mode(pc)[0] == "zghost"


def test_jax_registry_binds_the_filter_to_pot():
    """JAX's registry, a dict literal, binds 'pot', 'pwd' and 'pfe' to the
    first ``bc_aa_pot`` (:968), the filter; 'c1' on A reaches the second
    (:1094) at call time.  The port keeps that binding."""
    from pencil_tpu.ops import boundary as jb
    for code in ("pot", "pwd", "pfe"):
        assert jb.BC_REGISTRY[code].__code__.co_firstlineno == 968
        assert tb.BC_REGISTRY[code] is tb.bc_aa_pot
    assert jb.bc_aa_pot.__code__.co_firstlineno == 1094


@pytest.mark.parametrize("code", sorted(tb.REFUSED))
def test_refused_code_names_itself(code):
    """Each code of JAX's registry that stays out raises on parsing,
    naming the code and why; a configuration built with it is refused on
    every device."""
    with pytest.raises(KeyError, match=repr(code)):
        pt.BC.parse("ux", code)
    cfg = conv_slab(SHAPE)
    bcz = (tb.BC("ux", code, code),) + cfg.bcz[1:]
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match=repr(code)):
            pt.Model(cfg.replace(bcz=bcz), device=device)


@pytest.mark.parametrize("code", ("cT", "c1"))
@pytest.mark.parametrize("comp", ("TT", "lnTT"))
def test_temperature_codes_on_a_temperature_slot_raise(code, comp):
    """'cT' and 'c1' on TT or lnTT need the temperature module."""
    pm = pt.Model(conv_slab(SHAPE), device="cpu")
    ctx = tb.BCContext(None, pm.reg, pm.grid, pm.cfg, pm.eos)
    ctx.comp = comp
    with pytest.raises(NotImplementedError, match=repr(code)):
        tb.BC_REGISTRY[code](torch.zeros(14, 14, 22), 2, 0, 0.0, ctx)


@pytest.mark.parametrize("device", ("cpu", "cuda"))
def test_refusals_of_configurations(device):
    """force_bound 'uxy_sin-cos' (JAX raises a TypeError on a z wall),
    'hs' without a constant gravz, an entropy code on u: each refused on
    every device, naming it; 'pot' beside the walled Shock slot refused on
    the card, whose builds with the slot read no x/y-ghosted slabs."""
    base = conv_slab(SHAPE, bcz={"ux": "g"})
    with pytest.raises(NotImplementedError, match="uxy_sin-cos"):
        pt.Model(base.replace(force_bound=("uxy_sin-cos", "")),
                 device=device)
    hs = conv_slab(SHAPE, bcz={"lnrho": "a2:hs"})
    nograv = hs.replace(modules=tuple(m for m in hs.modules
                                      if m.name != "gravity"))
    with pytest.raises(NotImplementedError, match="'hs'"):
        pt.Model(nograv, device=device)
    with pytest.raises(NotImplementedError, match="'sT' on 'ux'"):
        pt.Model(conv_slab(SHAPE, bcz={"ux": "sT"}), device=device)
    shock = conv_slab(SHAPE, magnetic=True, shock=True,
                      bcz={"ax": "pot", "ay": "pot", "az": "pot"})
    mode, why = fused_mode(shock)
    assert mode is None and "'pot'" in why
    if device == "cuda":
        with pytest.raises(NotImplementedError, match="'pot'"):
            pt.Model(shock, device=device)


def test_jax_force_bound_uxy_sin_cos_fault():
    """A fault of the reference (ROADMAP Queue 3): 'g' with force_bound
    'uxy_sin-cos' on a z wall adds the interior y to a ghosted plane and
    raises a TypeError in JAX's fill (boundary.py:948)."""
    jc, _ = configs("g")
    jm = pj.Model(jc.replace(force_bound=("uxy_sin-cos", "uxy_sin-cos")))
    fa = jnp.zeros((8,) + SHAPE, jnp.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        j_fill_ghosts(fa, jm.cfg.grid, jm.bc_axes, jm.reg, jm.grid, jm.cfg,
                      jm.eos)
