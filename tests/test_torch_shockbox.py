"""The shocked periodic MHD box in pencil_tpu_torch against pencil_tpu: K1s
and K5w's plain versions against the wrap-fetch Pallas kernels with the
shock slot, three forced steps of the wrap_aux chain and of the eager path
against the JAX fused (wrap mode with an aux module) and jnp paths, the
packed step, and the gate.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode; 16³ is a shape where the JAX package itself
takes the wrap mode (ny % 8 == 0, nx >= 4).  Both packages start from the
same numpy fields with urms ≈ 1e-1, so the shock profile and its viscosity
are live, and see the same forcing draws (JAX's, injected through
``Model.forcing_draws``).  Bounds are those of tests/test_fused.py: each
field within 2e-5 × its max, dt within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import shock_box
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_model import jax_forcing_draws

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
N = 16
NSTEPS = 3
URMS = 1e-1


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def noisy_fa(shape, seed):
    """An 8-slot stack (uu, lnrho, aa, shock) of numpy noise, urms ≈ URMS,
    with a positive shock slot."""
    rng = np.random.default_rng(seed)
    amp = np.array([URMS / np.sqrt(3.0)] * 3 + [1e-2] + [1e-3] * 3)
    fa = amp[:, None, None, None] * rng.standard_normal((7,) + shape)
    shock = 5e-2 * rng.random((1,) + shape)
    return np.concatenate([fa, shock]).astype(np.float32)


# ---- K1s and K5w against the Pallas kernels --------------------------------
@pytest.fixture(scope="module")
def kernels():
    """K1s and K5w of the JAX package (wrap fetch, interpret mode) on the
    raw 8-slot state, every result kept as numpy."""
    shape = (N, N, N)
    jm = pj.Model(shock_box(N, pkg=pj))
    pm = pt.Model(shock_box(N), device="cpu")
    assert jm._fused_mode(None, None, N) == "wrap" and jm._aux_modules
    fa, fa2 = noisy_fa(shape, 6), noisy_fa(shape, 7)
    z = jm.grid.z
    df1, dt1 = jm._fused_rhs(shape, False, True, False)(jnp.asarray(fa), z)
    alpha, beta, _ = jm.rk
    dt = 1.0 / jnp.max(dt1)
    df2, f2, _ = jm._fused_rhs(shape, True, True, False)(
        jnp.asarray(fa2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fa=fa, fa2=fa2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_wrap_shock_matches_pallas(kernels):
    """K1s's plain version: df and the max 1/dt over tiles."""
    df, dt1m = fr.rhs_wrap_shock(kernels["pm"], torch.tensor(kernels["fa"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(7):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_wrap_shock_upd_matches_pallas(kernels):
    """K5w's plain version: df (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_wrap_shock_upd(pm, torch.tensor(kernels["fa2"]), df_prev,
                                  coef)
    assert df is df_prev
    assert tuple(f.shape) == (7, N, N, N)
    for c in range(7):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def test_shock_term_is_live(kernels):
    """On these inputs ν_sh·shock exceeds ν everywhere it matters: dropping
    the shock slot moves df by far more than the parity bound."""
    pm, fa = kernels["pm"], kernels["fa"].copy()
    df, _ = fr.rhs_wrap_shock(pm, torch.tensor(fa))
    fa[7] = 0.0
    df0, _ = fr.rhs_wrap_shock(pm, torch.tensor(fa))
    err = float((df[:3] - df0[:3]).abs().max())
    assert err > 100 * RTOL_FIELD * float(df[:3].abs().max())


# ---- three forced steps against the JAX paths -------------------------------
def initial_fields(jm, seed):
    rng = np.random.default_rng(seed)
    shape = jm.cfg.grid.shape
    return {
        "uu": (URMS / np.sqrt(3.0)
               * rng.standard_normal((3,) + shape)).astype(np.float32),
        "lnrho": (1e-2 * rng.standard_normal(shape)).astype(np.float32),
        "aa": (1e-3 * rng.standard_normal((3,) + shape)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX fused (wrap mode with the shock slot, Pallas interpret) and
    jnp paths, NSTEPS steps each from the same initial fields; numpy
    results and the forcing draws each step made."""
    out = {}
    for fused in (True, False):
        jm = pj.Model(shock_box(N, fused=fused, pkg=pj))
        if fused:
            assert jm._fused_mode(None, None, N) == "wrap"
        js = jm.init_state(5, overrides=initial_fields(jm, 11))
        init = {k: np.asarray(v) for k, v in js["fields"].items()}
        draws = jax_forcing_draws(jm, js["key"], NSTEPS)
        step = jax.jit(jm.make_step())
        for _ in range(NSTEPS):
            js = step(js)
        out[fused] = dict(init=init, draws=draws, t=float(js["t"]),
                          dt=float(js["dt"]), it=int(js["it"]),
                          fields={k: np.asarray(v)
                                  for k, v in js["fields"].items()})
    return out


def run_port(ref, fused):
    pm = pt.Model(shock_box(N, fused=fused), device="cpu")
    assert pm.mode == ("wrap_aux" if fused else None)
    ps = pm.init_state(5, overrides=overrides_from_numpy(ref["init"], pm.reg))
    pm.forcing_draws = iter(ref["draws"]).__next__
    step = pm.make_step()
    for _ in range(NSTEPS):
        ps = step(ps)
    return ps


def assert_steps_close(ps, ref):
    np.testing.assert_allclose(float(ps["dt"]), ref["dt"], rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), ref["t"], rtol=RTOL_DT)
    assert int(ps["it"]) == ref["it"]
    for k in ("uu", "lnrho", "aa"):
        assert_field_close(ps["fields"][k], ref["fields"][k], k)


def test_wrap_aux_step_matches_jax_fused(jax_runs):
    """The port's wrap_aux chain (plain K1s/K5w on the CPU, the kick after
    the step) against the JAX fused step; the state's shock slot is the
    last pre-pass's in both."""
    ref = jax_runs[True]
    ps = run_port(ref, fused=True)
    assert_steps_close(ps, ref)
    shock = ref["fields"]["shock"]
    nu, nu_shock, _ = pt.Model(shock_box(8), device="cpu").cfg.module(
        "viscosity").coefficients()
    assert nu_shock * np.abs(shock).max() > 10 * nu
    assert_field_close(ps["fields"]["shock"], shock, "shock")


def test_eager_step_matches_jax_jnp_path(jax_runs):
    """fused=False: the port's eager path against the JAX jnp path.  The
    jnp path writes the shock into its ghosted copy only, so the state
    keeps its initial (zero) shock slot: held with the bound as an
    absolute value."""
    ref = jax_runs[False]
    ps = run_port(ref, fused=False)
    assert_steps_close(ps, ref)
    err = np.abs(ps["fields"]["shock"].numpy() - ref["fields"]["shock"])
    assert err.max() <= RTOL_FIELD


def test_packed_multi_step_bit_identical_to_dict_step():
    """The packed state takes the kick on its u rows: a chunked multi-step
    equals the dict step bit for bit, forcing draws included."""
    pm = pt.Model(shock_box(8), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_registry_layout_matches_jax():
    pm = pt.Model(shock_box(8), device="cpu")
    jm = pj.Model(shock_box(8, pkg=pj))
    assert pm.reg.comp_names == jm.reg.comp_names == [
        "ux", "uy", "uz", "lnrho", "ax", "ay", "az", "shock"]
    assert (pm.reg.nvar, pm.reg.ncom, pm.reg.nf) == (7, 8, 8)
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


# ---- the gate ----------------------------------------------------------------
@pytest.mark.parametrize("forced", (True, False), ids=("forced", "unforced"))
def test_gate_accepts_shock_box(forced):
    cfg = shock_box(16)
    if not forced:
        cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                        if m.name != "forcing"))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap_aux"


def test_fake_rhs_outside_the_flagship_raises():
    with pytest.raises(NotImplementedError):
        pt.Model(shock_box(8), fake_rhs=True, device="cpu")
