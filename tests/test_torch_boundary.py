"""Non-periodic z in pencil_tpu_torch against pencil_tpu: the ghosted grid,
the ghosted stencils, the BC registry subset, ``fill_ghosts``,
``bc_writeback``, the piecew-poly initial condition and the pointwise CFL
rate of K-const conduction.

The same numpy inputs go through both packages.  A ghost fill copies and
applies pointwise formulas, so it must agree to 1e-6 of each field's max.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.ops import stencil as js
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.integrate.timestep import cfl_dt1
from pencil_tpu_torch.ops import stencil as ts
from pencil_tpu_torch.parallel.halo import fill_ghosts
from pencil_tpu_torch.physics.base import TimestepAccum

torch.set_num_threads(1)

SHAPES = ((16, 16, 16), (16, 16, 32))
IDS = ("16^3", "16x16x32")
# the fill also on an axis shorter than the ghost width (ny = 2)
FILL_SHAPES = SHAPES + ((8, 2, 12),)


def models(shape):
    return (pj.Model(conv_slab(shape, pkg=pj)),
            pt.Model(conv_slab(shape), device="cpu"))


def stratified_fields(pm, seed):
    """(5, nx, ny, nz) float32: the piecew-poly lnρ and s with noise, and
    noisy velocities, from a numpy seed."""
    rng = np.random.default_rng(seed)
    init = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    fa = np.concatenate([
        1e-2 * rng.standard_normal((3,) + shape),
        init["lnrho"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
        init["ss"].numpy()[None] + 1e-2 * rng.standard_normal(shape)])
    return fa.astype(np.float32)


def assert_rel(a, b, rtol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    for c in range(a.shape[0]):
        err = np.abs(a[c] - b[c]).max()
        assert err <= rtol * max(np.abs(b[c]).max(), 1e-30), (what, c, err)


def test_timestep_accum_takes_a_pointwise_rate():
    """A tensor diffusivity (K-const conduction's χ) through diffus and
    cfl_dt1: the elementwise max with ν, as jnp.maximum gives."""
    ts_ = TimestepAccum()
    chi = torch.tensor([[[1e-3, 5e-3, 2e-2]]])
    ts_.diffus(4e-3)
    ts_.diffus(chi)
    assert torch.equal(ts_.maxdiffus, torch.tensor([[[4e-3, 5e-3, 2e-2]]]))
    ts_.advec(torch.zeros_like(chi))
    grid = pt.make_grid(pt.GridSpec(nx=4, ny=4, nz=4), "cpu")
    dt1 = cfl_dt1(ts_, grid, pt.TimeSpec())
    assert dt1.shape == chi.shape and bool((dt1 > 0).all())
    only_chi = TimestepAccum()
    only_chi.diffus(chi)
    assert torch.equal(only_chi.maxdiffus, chi)


@pytest.mark.parametrize("periodic", ((True, True, False), (True, True, True)),
                         ids=("nonperiodic_z", "periodic"))
def test_ghosted_grid_matches_jax(periodic):
    spec = dict(nx=8, ny=10, nz=12, x0=-0.5, y0=-0.5, z0=-0.68, Lx=1.0,
                Ly=1.0, Lz=1.0, periodic=periodic)
    jg = pj.make_grid(pj.GridSpec(**spec))
    tg = pt.make_grid(pt.GridSpec(**spec), "cpu")
    for ours, theirs in (("xgh", "x"), ("ygh", "y"), ("zgh", "z"),
                         ("dx_1", "dx_1"), ("dy_1", "dy_1"), ("dz_1", "dz_1")):
        np.testing.assert_array_equal(getattr(tg, ours),
                                      np.asarray(getattr(jg, theirs)))
    np.testing.assert_array_equal(tg.z.numpy(), np.asarray(jg.z)[3:-3])


@pytest.mark.parametrize("axis", (0, 1, 2))
@pytest.mark.parametrize("op", ("der", "der2"))
def test_ghosted_derivatives_match_jax(op, axis):
    f = np.random.default_rng(axis).standard_normal((2, 10, 12, 14)).astype(
        np.float32)
    got = getattr(ts, op)(torch.tensor(f), axis, wrap=False).numpy()
    want = np.asarray(getattr(js, op)(jnp.asarray(f), axis))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("ax1,ax2", list(itertools.combinations(range(3), 2)))
def test_ghosted_bidiag_matches_jax(ax1, ax2):
    f = np.random.default_rng(7 + ax1 + ax2).standard_normal(
        (2, 10, 12, 14)).astype(np.float32)
    rest = tuple({0, 1, 2} - {ax1, ax2})
    got = ts.derij_bidiag(ts.i(torch.tensor(f), rest), ax1, ax2,
                          wrap=False).numpy()
    want = np.asarray(js.derij_bidiag(js.i(jnp.asarray(f), rest), ax1, ax2))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_bc_parse_matches_jax_and_rejects_unported():
    for comp, code in (("uz", "a"), ("lnrho", "a2"), ("ss", "c1:cT"),
                       ("ux", "set:s")):
        a = pt.BC.parse(comp, code, lval=0.625, hval=1.0)
        b = pj.BC.parse(comp, code, lval=0.625, hval=1.0)
        assert (a.comp, a.low, a.high, a.lval, a.hval) \
            == (b.comp, b.low, b.high, b.lval, b.hval)
    for code in ("c3", "s:nfr", "nonsense"):
        with pytest.raises(KeyError):
            pt.BC.parse("ux", code)


@pytest.mark.parametrize("shape", FILL_SHAPES, ids=IDS + ("8x2x12",))
def test_fill_ghosts_matches_jax(shape):
    """The conv-slab bcz on the same random stack: every ghost cell,
    corners included, within 1e-6 of each field's max."""
    jm, pm = models(shape)
    fa = stratified_fields(pm, seed=1)
    got = fill_ghosts(torch.tensor(fa), pm.cfg.grid, pm.bc_axes, pm.reg,
                      pm.grid, pm.cfg, pm.eos).numpy()
    want = np.asarray(j_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes,
                                    jm.reg, jm.grid, jm.cfg, jm.eos))
    assert_rel(got, want, 1e-6, "fill_ghosts")
    # the input is untouched and the interior is a copy
    np.testing.assert_array_equal(got[:, 3:-3, 3:-3, 4:-4],
                                  fa[:, :, :, 1:-1])


def test_bc_set_and_writeback_match_jax():
    """'set' (with a value) and 'a' pin the boundary planes; bc_writeback
    copies them into the state as the JAX package's does."""
    shape = (8, 8, 12)

    def cfg(pkg):
        base = conv_slab(shape, pkg=pkg)
        bcz = (pkg.BC.parse("ux", "set", lval=0.1, hval=-0.2),) + base.bcz[1:]
        return base.replace(bcz=bcz)

    jm, pm = pj.Model(cfg(pj)), pt.Model(cfg(pt), device="cpu")
    fa = stratified_fields(pm, seed=2)
    got = pm.bc_writeback(torch.tensor(fa)).numpy()
    want = np.asarray(jm.bc_writeback(jnp.asarray(fa), jm.grid, 0.0))
    assert_rel(got, want, 1e-6, "bc_writeback")
    assert np.all(got[0, :, :, 0] == np.float32(0.1))
    assert np.all(got[2, :, :, [0, -1]] == 0.0)


def test_piecew_poly_init_matches_jax():
    jm, pm = models((16, 16, 32))
    js_ = jm.init_state(0)["fields"]
    ps = pm.init_state(0)["fields"]
    for k in ("lnrho", "ss"):
        a = ps[k].numpy().astype(np.float64)
        b = np.asarray(js_[k], np.float64)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), k
    # stable-unstable-isothermal: cs² rises with depth, lnρ falls upward
    lnrho = ps["lnrho"][0, 0]
    assert bool((lnrho[1:] < lnrho[:-1]).all())
