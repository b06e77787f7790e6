"""The flagship template's RHS phase, as far as the CPU can hold it: the
flagship step at 32³ against the JAX package, the forcing kick from the
per-axis factors the kernels hoist out of their march, and chip_smoke's
tables.

The flagship template (csrc/fused_rhs.cu) forms sin and cos of the kick's
phase θ = k·x + φ = A + B + C once per x plane (A), once per row (B) and
once per thread (C) and combines them at each point by angle addition;
the helical amplitudes rotate by C once per thread.  Here the same factors
are built with plain PyTorch at a non-cubic shape and held to the module's
own kick, cos θ and sin θ at every point.  The bound is 5e-6 of the
kick's maximum, not 1e-6: θ reaches ~17 here, where float32 resolves 1e-6,
and the module rounds θ once while the factors round A, B and C (measured:
1.7e-6 to 2.6e-6 over six draws; against a float64 θ the module's own kick
is off by up to 1.3e-6 and the factored one by up to 2.2e-6).  The plain
version of K3 forms the same factors and agrees within 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import flagship, initial_fields, jax_forcing_draws

torch.set_num_threads(1)


def test_flagship_32_matches_jax_jnp_path():
    """Three forced steps at order 3 of the port's fused chain at 32³ on
    the CPU against the JAX jnp path, from the same numpy-seeded fields and
    the same forcing draws: each field within 2e-5 of its max, dt within
    1e-6."""
    nsteps = 3
    jm = pj.Model(flagship(pj, n=32, fused=False))
    pm = pt.Model(flagship(pt, n=32), device="cpu")
    assert pm.mode == "wrap" and pm.cfg.time.itorder == 3
    fields = initial_fields(jm.cfg.grid.shape, 21, pm.grid.z.numpy())
    js = jm.init_state(21, overrides=fields)
    ps = pm.init_state(21, overrides=fields)
    pm.forcing_draws = iter(jax_forcing_draws(jm, js["key"],
                                              nsteps)).__next__
    jstep, pstep = jax.jit(jm.make_step()), pm.make_step()
    for _ in range(nsteps):
        js, ps = jstep(js), pstep(ps)
    assert int(ps["it"]) == int(js["it"]) == nsteps
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=1e-6)
    for k, b in js["fields"].items():
        a = ps["fields"][k].numpy().astype(np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, k
        err = np.abs(a - b).max()
        assert err <= 2e-5 * np.abs(b).max(), (k, err, np.abs(b).max())


# ---- the hoisted kick -------------------------------------------------------
SHAPE = (12, 20, 10)


def shaped_model():
    cfg = flagship(pt)
    nx, ny, nz = SHAPE
    return pt.Model(cfg.replace(grid=pt.GridSpec(nx=nx, ny=ny, nz=nz)),
                    device="cpu")


def hoisted_kick(pm, kick):
    """duu (3, nx, ny, nz) of the kick vector from per-axis factors, formed
    as pc_flagship forms them: sin/cos of A per plane, of B per row, of C
    per thread with the rotated amplitudes U, V; cos(A+B) and sin(A+B) and
    the sum at each point."""
    gs = pm.cfg.grid
    f32 = torch.float32
    x0, y0 = fr._node0(gs)
    xg = x0 + gs.dx * torch.arange(gs.nx, dtype=f32)
    yg = y0 + gs.dy * torch.arange(gs.ny, dtype=f32)
    A = kick[0] * xg + kick[3]
    B = kick[1] * yg
    C = kick[2] * pm.grid.z
    sA, cA = torch.sin(A)[:, None, None], torch.cos(A)[:, None, None]
    sB, cB = torch.sin(B)[None, :, None], torch.cos(B)[None, :, None]
    sC, cC = torch.sin(C), torch.cos(C)
    Pc = cA * cB - sA * sB
    Qs = sA * cB + cA * sB
    out = []
    for i in range(3):
        a, b = kick[4 + i], kick[7 + i]
        U = (a * cC - b * sC)[None, None, :]
        V = (a * sC + b * cC)[None, None, :]
        out.append(kick[10] * (Pc * U - Qs * V))
    return torch.stack(out)


@pytest.fixture(scope="module")
def kicked():
    pm = shaped_model()
    g = torch.Generator().manual_seed(4)
    draws = (torch.randint(0, 20, (1,), generator=g),
             torch.rand((), generator=g) * 6.0 - 3.0,
             torch.randn(3, generator=g))
    dt = torch.tensor(3e-2)
    kick = pm.forcing.kick_vector(pm._ftables, draws, dt, pm.eos)
    zero = {"uu": torch.zeros((3,) + SHAPE)}
    want = pm.forcing.after_timestep(zero, pm.grid, pm._ftables, draws, dt,
                                     pm.eos)["uu"]
    return pm, kick, want


RTOL_KICK = 5e-6


def test_hoisted_kick_is_forcings_kick(kicked):
    pm, kick, want = kicked
    got = hoisted_kick(pm, kick)
    assert got.shape == want.shape == (3,) + SHAPE
    assert float(want.abs().max()) > 0.0
    for i in range(3):
        err = float((got[i] - want[i]).abs().max())
        assert err <= RTOL_KICK * float(want.abs().max()), (i, err)


def test_plain_kick_is_the_hoisted_kick(kicked):
    """K3's plain version adds the same kick to the u rows and leaves the
    other fields alone."""
    pm, kick, _ = kicked
    fa = torch.zeros((7,) + SHAPE)
    got = fr._kicked(pm, fa, kick)
    want = hoisted_kick(pm, kick)
    assert float((got[:3] - want).abs().max()) \
        <= 1e-6 * float(want.abs().max())
    assert not got[3:].any()


# ---- chip_smoke's tables ----------------------------------------------------
@pytest.mark.parametrize("kernel", cs.KERNEL_NAMES)
def test_every_kernel_has_its_tables(kernel):
    """Each kernel of the JSON line has an operation count, the TPU kernel
    it replaces, its source and a launch counter."""
    assert cs.OPS[kernel] > 0
    assert cs.REPLACES[kernel].startswith("pencil_tpu/ops/fused_rhs.py:")
    assert cs.SOURCES[kernel].startswith("pencil_tpu_torch/csrc/")
    assert kernel in fr.LAUNCHES


def test_flagship_operation_counts_follow_the_kernels():
    """The bound counts what the kernels do: the diagonal pairs factored
    (14 operations a mixed derivative, not 23) in every build of the
    flagship template, the conv-slab's too, the kick without its hoisted
    sin/cos and amplitudes."""
    assert cs.DMIX_FACTORED == 14 and cs.DMIX == 23
    assert cs.KICK_OPS == 21
    assert cs.FLAGSHIP_RHS == 21 * cs.D1 + 18 * cs.D2 \
        + 12 * cs.DMIX_FACTORED + 174
    assert cs.OPS["rhs_tail_last"] - cs.OPS["rhs_tail_mid"] == cs.KICK_OPS
    # the shock builds of the same template sum the same way; their del6
    # is summed as a second derivative is (13 a scaled 6th difference),
    # then 2 sums, the coefficient's product and the join per component
    assert cs.SHOCKBOX_RHS == 24 * cs.D1 + 18 * cs.D2 \
        + 12 * cs.DMIX_FACTORED + 198
    assert cs.SHEARBOX_RHS == cs.SHOCKBOX_RHS + 21 * cs.D2 + 14 + 14 \
        + 15 + 22
    # the conv-slab's K6 and K7 are the template's z-ghosted build: its
    # six mixed derivatives are factored too
    assert cs.CONVSLAB_RHS == 15 * cs.D1 + 15 * cs.D2 \
        + 6 * cs.DMIX_FACTORED + 204
    assert set(cs.SOURCES.values()) == {"pencil_tpu_torch/csrc/fused_rhs.cu"}
