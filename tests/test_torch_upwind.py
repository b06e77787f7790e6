"""Upwinding of the advection (``lupw_lnrho``, ``lupw_uu``, ``lupw_ss``:
the reference's der6_upwind) in pencil_tpu_torch against pencil_tpu on
the CPU: ``Pencils.ugrad(name, upwind=True)`` and the upwinding of u
against JAX's, each module's RHS with its flag against the JAX module's,
and 3 steps of seven sets with every flag they have on, through the
port's fused chain on its kernels' plain versions and through its eager
path, against the JAX fused step (Pallas in interpret mode) and the JAX
jnp path; the gate, which takes the flags on every set and refuses them
beside del6 hyper-diffusion on the card.

The sets: the flagship (``flagship(n, upwind=True)``), forced hydro,
``forced_entropy``, the shocked box, the sheared box (from t = 0.37,
del6 off: no kernel instance has both), the conv-slab
(``conv_slab(n, upwind=True)``) and the stratified MRI box, at 8×8×16
with velocity noise of 5e-2 and vector-potential noise of 1e-2 from numpy
with a seed (the upwinding scales with |u|), the forced ones kicked with
the JAX step's own draws.  The JAX fused side runs one tile over the
whole domain (PC_TX = PC_CX = nx): the z-walled sets under gravity need
it (ROADMAP Queue 3), the others take it as well.  The JAX jnp path keeps
the shock slot at its initial zeros, the fused chains hold their last
pre-pass: the jnp comparisons leave the slot out.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as jax_fill_ghosts
from pencil_tpu.physics.base import TimestepAccum as JaxTimestepAccum
from pencil_tpu.physics.pencils import Pencils as JaxPencils
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import (conv_slab, flagship, forced_entropy,
                                      forced_hydro, shear_box, shock_box,
                                      strat_box, with_upwind)
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.base import TimestepAccum
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_bext import evolved
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import assert_field_close, assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
TSTART = 0.37
UU_AMPL, AA_AMPL = 5e-2, 1e-2


def without_hyper3(cfg):
    """``cfg`` without its del6 hyper-diffusion (ν₃, η₃, D₃ = 0)."""
    new = {"viscosity": lambda m: dict(
        ivisc=tuple(v for v in m.ivisc if v != "hyper3-simplified"),
        nu_hyper3=0.0),
        "magnetic": lambda m: dict(eta_hyper3=0.0),
        "density": lambda m: dict(diffrho_hyper3=0.0)}
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, **new[m.name](m)) if m.name in new else m
        for m in cfg.modules))


def _sheared(pkg, cfg):
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART))


# each set with its flags on: (make(pkg, fused), the port's mode)
SETS = {
    "flagship": (lambda pkg, fused: flagship(SHAPE, pkg=pkg, fused=fused,
                                             upwind=True), "wrap"),
    "forced_hydro": (lambda pkg, fused: with_upwind(forced_hydro(
        SHAPE, pkg=pkg, fused=fused)), "wrap"),
    "forced_entropy": (lambda pkg, fused: with_upwind(forced_entropy(
        SHAPE, pkg=pkg, fused=fused)), "wrap"),
    "shock_box": (lambda pkg, fused: with_upwind(shock_box(
        SHAPE, pkg=pkg, fused=fused)), "wrap_aux"),
    "shear_box": (lambda pkg, fused: _sheared(pkg, with_upwind(
        without_hyper3(shear_box(SHAPE, pkg=pkg, fused=fused)))), "zroll"),
    "conv_slab": (lambda pkg, fused: conv_slab(SHAPE, pkg=pkg, fused=fused,
                                               upwind=True), "zghost"),
    "strat_box": (lambda pkg, fused: with_upwind(strat_box(
        SHAPE, pkg=pkg, fused=fused)), "zghost"),
}


def start_overrides(reg_slots, seed):
    """Seeded numpy noise for u and (where the set has it) A."""
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32)}
    aa = (AA_AMPL * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    if "aa" in reg_slots:
        over["aa"] = aa
    return over


@pytest.fixture(scope="module", params=sorted(SETS))
def runs(request):
    """One set: the states after NSTEPS steps of the JAX fused and jnp
    paths and of the port's fused chain and eager path, all from the JAX
    init with u (and A) replaced by numpy noise."""
    make, mode = SETS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jms = {fused: pj.Model(make(pj, fused)) for fused in (True, False)}
        pms = {fused: pt.Model(make(pt, fused), device="cpu")
               for fused in (True, False)}
        assert pms[True].mode == mode and pms[False].mode is None
        assert any(fr.kernel_params(pms[True]).upw)
        over = start_overrides(pms[True].reg.slots, 11)
        out = {}
        for fused, jm in jms.items():
            js = jm.init_state(5, overrides=over)
            fields = {k: np.asarray(v) for k, v in js["fields"].items()}
            draws = (jax_forcing_draws(jm, js["key"], NSTEPS)
                     if pms[fused].forcing is not None else None)
            step = jm.make_step()
            for _ in range(NSTEPS):
                js = step(js)
            out["jax_fused" if fused else "jax_jnp"] = js
        for fused, pm in pms.items():
            ps = pm.init_state(5, overrides=overrides_from_numpy(fields,
                                                                 pm.reg))
            if pm.forcing is not None:
                pm.forcing_draws = iter(draws).__next__
            step = pm.make_step()
            for _ in range(NSTEPS):
                ps = step(ps)
            out["chain" if fused else "eager"] = ps
    return out


def test_upwind_chain_matches_jax_fused(runs):
    """The port's chain against the JAX fused step, the shock slot too."""
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_upwind_chain_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["chain"]))


def test_upwind_eager_step_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["eager"]))


# ---- the pencils and the modules ------------------------------------------------
@pytest.fixture(scope="module")
def pencils():
    """(JAX Pencils, the port's Pencils, the JAX model, the port's model)
    of forced_entropy with every lupw flag on, on one noisy ghosted state
    at 8×8×16."""
    jm = pj.Model(with_upwind(forced_entropy(SHAPE, pkg=pj, fused=False)))
    pm = pt.Model(with_upwind(forced_entropy(SHAPE, pkg=pt)), device="cpu")
    rng = np.random.default_rng(4)
    amp = np.array([UU_AMPL] * 3 + [5e-2, 1e-2] + [AA_AMPL] * 3, np.float32)
    fa = (amp[:, None, None, None] * rng.standard_normal((8,) + SHAPE)) \
        .astype(np.float32)
    fg = jax_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                         jm.grid, jm.cfg, jm.eos)
    return (JaxPencils(fg, jm.grid, jm.reg, jm.cfg, jm.eos),
            Pencils(pm.ghosted(torch.tensor(fa)), pm.grid, pm.reg, pm.cfg,
                    pm.eos, ghosted=True), jm, pm)


@pytest.mark.parametrize("name", ("lnrho", "ss"))
@pytest.mark.parametrize("upwind", (False, True), ids=("plain", "upwind"))
def test_ugrad_matches_jax(pencils, name, upwind):
    """u·∇f, and with ``upwind`` less Σ_a |u_a|·δ⁶_a f/(60Δ_a), within 2e-5
    of its max; the upwinding moves it."""
    jp, pp, _, _ = pencils
    want = np.asarray(jp.ugrad(name, upwind=upwind))
    got = pp.ugrad(name, upwind=upwind).numpy()
    assert_field_close(got, want, f"ugrad({name}, upwind={upwind})")
    if upwind:
        assert np.abs(got - pp.ugrad(name).numpy()).max() > 1e-3 * np.abs(
            got).max()


def test_upwinding_of_u_matches_jax(pencils):
    """Hydro's term Σ_a |u_a|·δ⁶_a u/(60Δ_a) (JAX hydro.py:161-167), each
    component."""
    jp, pp, _, _ = pencils
    uu = jp.uu()
    want = np.asarray(sum(
        jnp.abs(uu[a])[None] * jp.d6_raw("uu", a) * jp._inv(a) / 60.0
        for a in range(3)))
    got = pp.upwind("uu", pp.uu()).numpy()
    for c in range(3):
        assert_field_close(got[c], want[c], f"upwinding of u[{c}]")


@pytest.mark.parametrize("module", ("density", "hydro", "entropy"))
def test_module_rhs_with_upwinding_matches_jax(pencils, module):
    """Each module's RHS with its lupw flag on (alone: no other module's
    terms) against the JAX module's on the same pencils; its CFL terms
    too (upwinding adds none)."""
    jp, pp, jm, pm = pencils
    jmod, pmod = jm.cfg.module(module), pm.cfg.module(module)
    jdf, pdf = {}, {}
    jts, pts = JaxTimestepAccum(), TimestepAccum()
    jmod.rhs(jp, jdf, jts)
    pmod.rhs(pp, pdf, pts)
    assert set(jdf) == set(pdf)
    for k, w in jdf.items():
        w, g = np.asarray(w), pdf[k].numpy()
        for c in range(w.shape[0] if w.ndim == 4 else 1):
            assert_field_close(g[c] if w.ndim == 4 else g,
                               w[c] if w.ndim == 4 else w, f"{module} {k}")
    for acc in ("maxadvec", "advec_cs2", "maxdiffus"):
        w, g = getattr(jts, acc), getattr(pts, acc)
        if isinstance(w, float):
            assert isinstance(g, float) and g == w, acc
        else:
            assert_field_close(torch.as_tensor(g).numpy(), np.asarray(w),
                               acc)


# ---- the gate -------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_takes_upwinding_on_every_set(case):
    """Every set with its flags on runs its fused chain on the card and on
    the CPU, and launches the UPW instances (launch names with _upw)."""
    make, mode = SETS[case]
    cfg = make(pt, True)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    pm = pt.Model(cfg, device="cpu")
    names = (fr.zg_kernels(pm) if mode == "zghost"
             else fr.aux_kernels(pm) if mode in ("zroll", "wrap_aux")
             else tuple(k + fr.launch_suffix(pm) for k in (
                 "rhs_first", "rhs_tail_defer", "rhs_tail_last")))
    assert all(k.endswith("_upw") and k in fr.LAUNCHES for k in names)


@pytest.mark.parametrize("case", ("flagship", "conv_slab", "shear_box"))
def test_card_refuses_upwinding_beside_hyper3(case):
    """lupw flags beside a del6 coefficient: no kernel instance has both,
    so the card refuses the configuration before any launch, naming
    both; the CPU runs the eager path."""
    cfg = {"flagship": flagship(SHAPE, hyper3=True, upwind=True),
           "conv_slab": conv_slab(SHAPE, hyper3=True, upwind=True),
           "shear_box": with_upwind(shear_box(SHAPE))}[case]
    reason = gate_reason(cfg)
    assert "lupw_lnrho" in reason and "hyper3" in reason
    with pytest.raises(NotImplementedError, match="hyper3"):
        fused_gate(cfg, "cuda")
    with pytest.raises(NotImplementedError, match="lupw"):
        pt.Model(cfg, device="cuda")
    assert pt.Model(cfg, device="cpu").mode is None
