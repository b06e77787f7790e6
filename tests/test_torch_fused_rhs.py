"""The fused RHS kernels of pencil_tpu_torch against the Pallas kernels of
pencil_tpu they replace.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode through ``Model._fused_rhs`` with the
flags the flagship step uses (model.py:438-444, :690-695).  The same numpy
inputs go through both.  Bounds are those the JAX package holds between
its own fused and jnp paths (test_fused.py:75-84): each field within
2e-5 × its max, dt within 1e-6 relative.

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.ops import fused_rhs as fr

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (16, 16, 32))


def flagship_kwargs(shape):
    """One kwargs dict for both packages' flagship configuration."""
    def kw(pkg):
        return dict(
            grid=pkg.GridSpec(nx=shape[0], ny=shape[1], nz=shape[2]),
            time=pkg.TimeSpec(itorder=3),
            fused=True,
            modules=(pkg.EosIdealGas(gamma=1.0, cs0=1.0),
                     pkg.Density(lupw_lnrho=False),
                     pkg.Hydro(init="gaussian-noise", ampl=1e-3),
                     pkg.Viscosity(ivisc=("nu-const",), nu=5e-3),
                     pkg.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                     pkg.Forcing(force=0.07, kf=3.0)))
    return kw


def random_fa(shape, seed):
    """(7, nx, ny, nz) float32 state: uu, lnrho, aa of realistic size."""
    rng = np.random.default_rng(seed)
    amp = np.array([1e-2] * 3 + [5e-2] + [1e-2] * 3, np.float32)
    return (amp[:, None, None, None]
            * rng.standard_normal((7,) + shape)).astype(np.float32)


def jax_draws(forcing_key, nk):
    """The (idx, phase, e) draws Forcing.kick_coeffs makes from its key."""
    k_idx, k_phase, k_e = jax.random.split(forcing_key, 3)
    idx = jax.random.randint(k_idx, (), 0, nk)
    phase = jax.random.uniform(k_phase, (), minval=-jnp.pi, maxval=jnp.pi)
    e = jax.random.normal(k_e, (3,), dtype=jnp.float32)
    return (torch.tensor([int(idx)]), torch.tensor(np.asarray(phase)),
            torch.tensor(np.asarray(e)))


def assert_field_close(a, b, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= RTOL_FIELD * max(np.abs(b).max(), 1e-30), (what, err)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def chain(request):
    """One pass of the three-kernel chain through the JAX Pallas kernels
    (interpret mode), with every intermediate kept as numpy."""
    shape = request.param
    kw = flagship_kwargs(shape)
    jm = pj.Model(pj.Config(**kw(pj)))
    pm = pt.Model(pt.Config(**kw(pt)), device="cpu")
    fa = random_fa(shape, seed=3)
    z = jm.grid.z
    alpha, beta, _ = jm.rk
    df1, dt1 = jm._fused_rhs(shape, False, True, False)(jnp.asarray(fa), z)
    dt = 1.0 / jnp.max(dt1)
    df2, f2 = jm._fused_rhs(shape, True, True, False, True, False, False)(
        jnp.asarray(fa), z, df1, alpha[1], beta[1] * dt, cprev=beta[0] * dt)
    forcing = jm.cfg.module("forcing")
    fkey = jax.random.PRNGKey(5)
    kick = forcing.kick_coeffs(fkey, dt, jm.cfg, jm.eos, jnp.float32)
    kv = jnp.concatenate([kick[0], kick[1].reshape(1), kick[2], kick[3],
                          kick[4].reshape(1), jnp.zeros((1,))])
    last = {}
    for with_kick in (False, True):
        last[with_kick] = jm._fused_rhs(
            shape, True, True, False, False, True, with_kick)(
            f2, z, df2, alpha[2], beta[2] * dt, kick=kick if with_kick else None)
    return dict(
        pm=pm, fa=fa, df1=np.asarray(df1), dt1max=float(jnp.max(dt1)),
        dt=np.float32(dt), df2=np.asarray(df2), f2=np.asarray(f2),
        kv=np.asarray(kv), draws=jax_draws(fkey, forcing_shell_size(forcing)),
        f3={k: np.asarray(v) for k, v in last.items()})


def forcing_shell_size(forcing):
    from pencil_tpu.physics.forcing import shell_vectors
    return len(shell_vectors(forcing.kf, forcing.dk))


def coef(pm, isub, dt, cprev):
    alpha, beta, _ = pm.rk
    dt = torch.tensor(dt)
    return torch.stack((torch.tensor(alpha[isub], dtype=torch.float32),
                        beta[isub] * dt,
                        beta[isub - 1] * dt if cprev else torch.tensor(0.0)))


def test_rhs_first_matches_pallas(chain):
    df, dt1m = fr.rhs_first(chain["pm"], torch.tensor(chain["fa"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), chain["dt1max"], rtol=RTOL_DT)
    for c in range(7):
        assert_field_close(df[c], chain["df1"][c], f"df1[{c}]")


def test_rhs_tail_defer_matches_pallas(chain):
    pm = chain["pm"]
    df2, f2 = fr.rhs_tail_defer(pm, torch.tensor(chain["fa"]),
                                torch.tensor(chain["df1"]),
                                coef(pm, 1, chain["dt"], cprev=True))
    for c in range(7):
        assert_field_close(df2[c], chain["df2"][c], f"df2[{c}]")
        assert_field_close(f2[c], chain["f2"][c], f"f2[{c}]")


@pytest.mark.parametrize("with_kick", (False, True), ids=("nokick", "kick"))
def test_rhs_tail_last_matches_pallas(chain, with_kick):
    pm = chain["pm"]
    kick = torch.tensor(chain["kv"]) if with_kick else None
    f3 = fr.rhs_tail_last(pm, torch.tensor(chain["f2"]),
                          torch.tensor(chain["df2"]),
                          coef(pm, 2, chain["dt"], cprev=False), kick)
    for c in range(7):
        assert_field_close(f3[c], chain["f3"][with_kick][c], f"f3[{c}]")


def test_kick_vector_matches_jax(chain):
    """The port's kick coefficients from JAX's own draws (the draws hook)
    equal JAX's kick_coeffs."""
    pm = chain["pm"]
    kv = pm.forcing.kick_vector(pm._ftables, chain["draws"],
                                torch.tensor(chain["dt"]), pm.eos)
    np.testing.assert_allclose(kv.numpy(), chain["kv"], rtol=1e-6, atol=1e-7)
