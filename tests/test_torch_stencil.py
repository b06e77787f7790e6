"""Periodic stencils of pencil_tpu_torch against pencil_tpu.ops.stencil.

The port wraps every axis; the JAX operators run in their own wrap mode
(jnp.roll) or on a ghosted copy (np.pad mode='wrap').  Same f32 inputs,
same paired term order, so the results agree to the last few ulps.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pencil_tpu.ops import stencil as js
from pencil_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)

SHAPE = (2, 8, 10, 12)   # distinct extents catch axis mix-ups
ATOL = 1e-6              # × max |result|: f32 rounding of a 7-term sum


def field(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE).astype(np.float32)


def ghosted(f, axes):
    pad = [(0, 0)] * f.ndim
    for a in axes:
        pad[f.ndim - 3 + a] = (3, 3)
    return np.pad(f, pad, mode="wrap")


def assert_close(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= ATOL * np.abs(b).max()


def test_fd_weights_match():
    offs = tuple(range(-3, 4))
    for k in (1, 2):
        assert ts.fd_weights(offs, k) == pytest.approx(
            js.fd_weights(offs, k), abs=0.0)


@pytest.mark.parametrize("axis", (0, 1, 2))
@pytest.mark.parametrize("op", ("der", "der2"))
def test_der_matches_jax(op, axis):
    f = field(axis)
    inv = np.float32(1.7)
    got = getattr(ts, op)(torch.tensor(f), axis, torch.tensor(inv)).numpy()
    jfn = getattr(js, op)
    # JAX wrap mode (rolls) and JAX ghosted mode (slices) on the same field
    assert_close(got, jfn(jnp.asarray(f), axis, jnp.asarray(inv), wrap=True))
    assert_close(got, jfn(jnp.asarray(ghosted(f, (axis,))), axis,
                          jnp.asarray(inv)))


@pytest.mark.parametrize("ax1,ax2", list(itertools.combinations(range(3), 2)))
def test_derij_bidiag_matches_jax(ax1, ax2):
    f = field(10 + ax1 + ax2)
    got = ts.derij_bidiag(torch.tensor(f), ax1, ax2).numpy()
    # ax1 ghosted and ax2 ghosted, and ax1 ghosted with ax2 rolled
    assert_close(got, js.derij_bidiag(jnp.asarray(ghosted(f, (ax1, ax2))),
                                      ax1, ax2))
    assert_close(got, js.derij_bidiag(jnp.asarray(ghosted(f, (ax1,))),
                                      ax1, ax2, wrap2=True))


def test_constant_field_gives_exact_zero():
    """The paired form exists so constants cancel exactly in f32."""
    f = torch.full(SHAPE, 1.2345678, dtype=torch.float32)
    inv = torch.tensor(1.0e3)
    for axis in range(3):
        assert torch.count_nonzero(ts.der(f, axis, inv)) == 0
        assert torch.count_nonzero(ts.der2(f, axis, inv)) == 0
    for ax1, ax2 in itertools.combinations(range(3), 2):
        assert torch.count_nonzero(ts.derij_bidiag(f, ax1, ax2, inv, inv)) == 0


def test_derivatives_of_a_sine_are_sixth_order():
    """A resolved mode: ∂x sin(kx) = k cos(kx) to 6th-order accuracy."""
    n = 32
    x = (np.arange(n) + 0.5) * (2 * np.pi / n)
    f = torch.tensor(np.sin(3 * x)[None, :, None, None] * np.ones((1, n, 2, 2)),
                     dtype=torch.float32)
    inv = torch.tensor(n / (2 * np.pi), dtype=torch.float32)
    d1 = ts.der(f, 0, inv)[0, :, 0, 0].numpy()
    d2 = ts.der2(f, 0, inv)[0, :, 0, 0].numpy()
    np.testing.assert_allclose(d1, 3 * np.cos(3 * x), atol=2e-3)
    np.testing.assert_allclose(d2, -9 * np.sin(3 * x), atol=2e-2)


def test_pencils_mixed_derivatives_agree():
    """Pencils.dij (all components) and dij_comp (one component, the
    graddiv pattern) are the same bidiagonal derivative, symmetric in its
    two axes."""
    import pencil_tpu_torch as pt
    from pencil_tpu_torch.physics.pencils import Pencils
    model = pt.Model(pt.Config(grid=pt.GridSpec(nx=8, ny=10, nz=12),
                               modules=(pt.EosIdealGas(), pt.Density(),
                                        pt.Hydro())), device="cpu")
    f = torch.tensor(np.random.default_rng(2).standard_normal(
        (4, 8, 10, 12)).astype(np.float32))
    pen = Pencils(f, model.grid, model.reg, model.cfg, model.eos)
    for a, b in itertools.combinations(range(3), 2):
        full = pen.dij("uu", a, b)
        assert torch.equal(full, pen.dij("uu", b, a))
        for comp in range(3):
            assert torch.equal(full[comp], pen.dij_comp("uu", comp, a, b))
