"""Continuous forcing (``Forcing(lforcing_cont=True)``) in pencil_tpu_torch
against pencil_tpu on the CPU: the profile of each of the four ported
kinds ('ABC', 'RobertsFlow', 'cosx*cosy*cosz', 'xz') against JAX's
``Forcing.fcont``; 3 steps of the flagship's wrap chain driven by each
(``configs.flagship(n, fcont=...)``, force = 0: the ABC-flow dynamo and
its kin), through the port's fused chain on the plain versions of K1-K3
against the JAX fused step (Pallas in interpret mode) and the JAX jnp
path, and through the eager path against the jnp path; the field the
kernels read (``fcont_tensor``); the gate; the ``ufm`` and ``rufm``
columns.  The aux and z-ghosted chains with forcing are in
tests/test_torch_fcont_chains.py.

The JAX fused flagship runs its default tiles: they agree with the jnp
path with each profile.  Velocity and vector-potential noise of 1e-2 from
numpy with a seed; bounds, those of tests/test_fused.py: each field
within 2e-5 × its max, dt within 1e-6 relative; the columns within
tests/test_torch_run.py's.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.diagnostics import make_diagnostics as jax_diagnostics
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import flagship, forced_entropy, forced_hydro
from pencil_tpu_torch.io.diagnostics import make_diagnostics
from pencil_tpu_torch.model import fused_mode
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_zghost_mhd import AA_AMPL, UU_AMPL, assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
# each profile: fcont = (profile, ampl_ff, k1_ff); the 'xz' envelope
# reaches (L/2)⁴ ≈ 97 on the 2π box, so its amplitude is smaller
PROFILES = {"ABC": ("ABC", 0.1, 1.0), "RobertsFlow": ("RobertsFlow", 0.1,
                                                      1.0),
            "cosx*cosy*cosz": ("cosx*cosy*cosz", 0.1, 1.0),
            "xz": ("xz", 1e-3, 1.0)}


def start(jm, pm, seed):
    """(JAX state, port state): the JAX init with u and A replaced by
    seeded numpy noise, the same fields in the port."""
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32)}
    if "aa" in pm.reg.slots:
        over["aa"] = (AA_AMPL * rng.standard_normal((3,) + SHAPE)).astype(
            np.float32)
    js = jm.init_state(seed, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    return js, pm.init_state(seed, overrides=overrides_from_numpy(
        fields, pm.reg))


def steps(model, state):
    step = model.make_step()
    for _ in range(NSTEPS):
        state = step(state)
    return state


@pytest.fixture(scope="module", params=sorted(PROFILES))
def runs(request):
    """The flagship driven by one profile: the JAX fused and jnp paths'
    states after NSTEPS steps, and the port's fused chain's and eager
    path's from the same start."""
    prof = PROFILES[request.param]
    out = {}
    for name, pkg, fused in (("jax_fused", pj, True), ("jax_jnp", pj, False),
                             ("chain", pt, True), ("eager", pt, False)):
        cfg = flagship(SHAPE, pkg=pkg, fused=fused, fcont=prof)
        m = pj.Model(cfg) if pkg is pj else pt.Model(cfg, device="cpu")
        jm = m if pkg is pj else pj.Model(flagship(SHAPE, pkg=pj,
                                                   fcont=prof))
        pm = m if pkg is pt else pt.Model(flagship(SHAPE, fcont=prof),
                                          device="cpu")
        js, ps = start(jm, pm, 3)
        out[name] = steps(m, js if pkg is pj else ps)
    assert pt.Model(flagship(SHAPE, fcont=prof), device="cpu").mode == "wrap"
    return out


def test_chain_with_fcont_matches_jax_fused(runs):
    """The port's wrap chain (plain K1-K3) against the JAX fused step."""
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_chain_with_fcont_matches_jax_jnp_path(runs):
    """The port's wrap chain against the JAX jnp path."""
    assert_states_close(runs["jax_jnp"], runs["chain"])


def test_eager_step_with_fcont_matches_jax_jnp_path(runs):
    """The port's eager path against the JAX jnp path."""
    assert_states_close(runs["jax_jnp"], runs["eager"])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_fcont_profile_matches_jax(name):
    """The port's Forcing.fcont against JAX's on the model grid, each
    component within 2e-5 × the profile's max, and not zero."""
    prof = PROFILES[name]
    jm = pj.Model(flagship(SHAPE, pkg=pj, fcont=prof))
    pm = pt.Model(flagship(SHAPE, fcont=prof), device="cpu")
    want = np.asarray(jm.cfg.module("forcing").fcont(jm.grid))
    got = pm.cfg.module("forcing").fcont(pm.grid).numpy()
    assert got.shape == want.shape == (3,) + SHAPE
    bound = 2e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    assert np.abs(want).max() > 0.0


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_kernel_field_is_the_profile(name):
    """fcont_tensor, the field every kernel reads, is Forcing.fcont on the
    interior grid, contiguous (3, nx, ny, nz), built once a model."""
    pm = pt.Model(flagship(SHAPE, fcont=PROFILES[name]), device="cpu")
    t = fr.fcont_tensor(pm)
    assert t.is_contiguous() and tuple(t.shape) == (3,) + SHAPE
    assert torch.equal(t, pm.cfg.module("forcing").fcont(pm.grid))
    assert fr.fcont_tensor(pm) is t


@pytest.mark.parametrize("profile", ("", "nothing"))
def test_inert_profile_adds_nothing(profile):
    """'' and 'nothing' are inert (JAX forcing.py:78-82): no field for the
    kernels (a null pointer: the kernels skip the term), zeros in the plain
    RHS, and a step equal to the unforced one."""
    cfg = forced_hydro(SHAPE, fcont=(profile, 0.1, 1.0))
    pm = pt.Model(cfg, device="cpu")
    assert fr.fcont_tensor(pm) is None
    base = pt.Model(cfg.replace(modules=cfg.modules[:-1]), device="cpu")
    fields = pm.init_state(1)["fields"]
    a = pm.make_multi_step(2)(pm.init_state(1, overrides=fields))
    b = base.make_multi_step(2)(base.init_state(1, overrides=fields))
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_unknown_profile_raises_before_any_launch():
    """A profile the port lacks is refused when the model is built, on
    every device, before any kernel."""
    cfg = flagship(SHAPE, fcont=("tidal", 0.1, 1.0))
    for dev in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="iforcing_cont"):
            pt.Model(cfg, device=dev)
    with pytest.raises(NotImplementedError, match="iforcing_cont"):
        pt.Forcing(lforcing_cont=True, iforcing_cont="tidal",
                   ampl_ff=1.0).fcont(
            pt.Model(flagship(SHAPE), device="cpu").grid)


@pytest.mark.parametrize("make", (
    lambda **kw: flagship(SHAPE, **kw),
    lambda **kw: forced_hydro(SHAPE, **kw),
    lambda **kw: forced_entropy(SHAPE).replace(modules=forced_entropy(
        SHAPE).modules[:-1] + flagship(SHAPE, **kw).modules[-1:])),
    ids=("mhd", "hydro", "entropy"))
def test_gate_takes_fcont_as_the_set_without_it(make):
    """Continuous forcing runs on every chain: with it a set takes the
    chain it takes without it, and its launch names are the same."""
    plain, forced = make(), make(fcont=("ABC", 0.1, 1.0))
    assert fused_mode(forced) == fused_mode(plain) == ("wrap", None)
    pm, fm = (pt.Model(c, device="cpu") for c in (plain, forced))
    assert fr.launch_suffix(pm) == fr.launch_suffix(fm)
    assert fr.fcont_tensor(fm) is not None and fm.forcing is None


def test_fcont_drives_the_flow():
    """The Roberts flow from rest: after 3 steps u follows the profile,
    u ≈ t·f (ν∇²f and (u·∇)u are small parts at k = 1), and lnρ, which
    the solenoidal profile does not compress, moves at second order in u
    only (the pressure of (u·∇)u)."""
    prof = ("RobertsFlow", 0.1, 1.0)
    pm = pt.Model(forced_hydro(SHAPE, fcont=prof), device="cpu")
    zero = {"uu": np.zeros((3,) + SHAPE, np.float32),
            "lnrho": np.zeros(SHAPE, np.float32)}
    st = steps(pm, pm.init_state(0, overrides=zero))
    f = pm.cfg.module("forcing").fcont(pm.grid)
    u = st["fields"]["uu"]
    t = float(st["t"])
    assert float((u - t * f).abs().max()) < 0.05 * t * float(f.abs().max())
    assert float(st["fields"]["lnrho"].abs().max()) < float(
        u.abs().max()) ** 2


# ---- the columns --------------------------------------------------------------
@pytest.fixture(scope="module")
def both_rows():
    """ufm and rufm on one noisy state of the flagship driven by 'ABC',
    from the JAX evaluator and from the port's, with the rms of the terms
    each averages."""
    prof = PROFILES["ABC"]
    jm = pj.Model(flagship(16, pkg=pj, fcont=prof))
    pm = pt.Model(flagship(16, fcont=prof), device="cpu")
    rng = np.random.default_rng(8)
    shape = (16, 16, 16)
    fields = {"uu": 1e-2 * rng.standard_normal((3,) + shape),
              "lnrho": 5e-2 * rng.standard_normal(shape),
              "aa": 1e-2 * rng.standard_normal((3,) + shape)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    js = jm.init_state(2, overrides=fields)
    ps = pm.init_state(2, overrides=fields)
    names = ("ufm", "rufm")
    want = {k: float(v) for k, v in jax_diagnostics(jm, names)(js).items()}
    got = {k: float(v) for k, v in make_diagnostics(pm, names)(ps).items()}
    pen = Pencils(pm.ghosted(pm.reg.stack(ps["fields"])), pm.grid, pm.reg,
                  pm.cfg, pm.eos, ghosted=True)
    uf = (pen.uu() * pm.cfg.module("forcing").fcont(pm.grid)).sum(0)
    rms = {"ufm": float(torch.sqrt((uf ** 2).mean())),
           "rufm": float(torch.sqrt(((pen.rho() * uf) ** 2).mean()))}
    return want, got, rms


@pytest.mark.parametrize("name", ("ufm", "rufm"))
def test_fcont_column_matches_jax(both_rows, name):
    """<u·f> and <ρu·f>, means of zero-mean noise, within 1e-6 of their
    terms' rms (tests/test_torch_run.py's SIGNED bound)."""
    want, got, rms = both_rows
    assert abs(got[name] - want[name]) <= 1e-6 * rms[name], name
    assert want[name] != 0.0


def test_fcont_column_is_zero_without_the_forcing():
    pm = pt.Model(flagship(SHAPE), device="cpu")
    got = make_diagnostics(pm, ("ufm", "rufm"))(pm.init_state(0))
    assert all(float(v) == 0.0 for v in got.values())
