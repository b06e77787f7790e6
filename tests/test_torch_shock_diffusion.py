"""The shock diffusivities (Density ``diffrho_shock``, Magnetic
``eta_shock``, Entropy ``chi_shock`` with iheatcond 'shock') in
pencil_tpu_torch against pencil_tpu on the CPU: each module's RHS and its
CFL rate on pencils with a live shock slot against the JAX module's, the
first kernel's plain version of each shock-slot chain against the JAX
RHS, and 3 steps of the shocked box (MHD and hydro, each with and
without ss: ``shock_box(n, shock_diffusion=True)``) and of the sheared
box with the shock slot, through the port's fused chain on its kernels'
plain versions and through its eager path, against the JAX fused step
(Pallas in interpret mode) and the JAX jnp path; the gate, which takes
them on the sets with the shock slot and refuses them elsewhere on the
card, where (as in JAX) they do nothing on the CPU.

At 8×8×16 with velocity noise of 5e-2 (a live shock profile) and
vector-potential noise of 1e-2 from numpy with a seed, the forced sets
kicked with the JAX step's own draws, the sheared box from t = 0.37.  The
JAX fused side runs one tile over the whole domain (PC_TX = PC_CX = nx),
as tests/test_torch_fcont_chains.py does.  The JAX jnp path keeps the
shock slot at its initial zeros, the fused chains hold their last
pre-pass: the jnp comparisons leave the slot out.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, dt and the CFL
maximum within 1e-6 relative.
"""
import dataclasses

import jax
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
from pencil_tpu_torch.configs import (flagship, forced_entropy, shear_box,
                                      shock_box, with_shock_diffusion)
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.physics.base import TimestepAccum
from pencil_tpu_torch.physics.pencils import Pencils
from test_torch_bext import evolved, first_plain
from test_torch_model import jax_forcing_draws
from test_torch_zghost_mhd import (RTOL_DT, assert_field_close,
                                   assert_states_close)

torch.set_num_threads(1)

NSTEPS = 3
SHAPE = (8, 8, 16)
TSTART = 0.37
UU_AMPL, AA_AMPL = 5e-2, 1e-2


# each set with the shock diffusivities on: (make(pkg, fused), the port's
# mode, its library)
SETS = {
    "shock_box": (lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused, shock_diffusion=True), "wrap_aux",
        "fused_rhs_shock"),
    "hydro_shock_box": (lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused, magnetic=False, shock_diffusion=True),
        "wrap_aux", "fused_rhs_shock_hydro"),
    "shock_box_ent": (lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused, entropy=True, shock_diffusion=True),
        "wrap_aux", "fused_rhs_shock_ent"),
    "hydro_shock_box_ent": (lambda pkg, fused: shock_box(
        SHAPE, pkg=pkg, fused=fused, magnetic=False, entropy=True,
        shock_diffusion=True), "wrap_aux", "fused_rhs_shock_hydro_ent"),
    "shear_box": (lambda pkg, fused: with_shock_diffusion(shear_box(
        SHAPE, pkg=pkg, fused=fused)).replace(
            time=pkg.TimeSpec(itorder=3, tstart=TSTART)), "zroll",
        "fused_rhs_shear"),
}


def start_overrides(slots, seed):
    """Seeded numpy noise for u and (where the set has it) A."""
    rng = np.random.default_rng(seed)
    over = {"uu": (UU_AMPL * rng.standard_normal((3,) + SHAPE))
            .astype(np.float32)}
    aa = (AA_AMPL * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    if "aa" in slots:
        over["aa"] = aa
    return over


@pytest.fixture(scope="module", params=sorted(SETS))
def runs(request):
    """One set: the states after NSTEPS steps of the JAX fused and jnp
    paths and of the port's fused chain and eager path, all from the JAX
    init with u (and A) replaced by numpy noise."""
    make, mode, lib = SETS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        jms = {fused: pj.Model(make(pj, fused)) for fused in (True, False)}
        pms = {fused: pt.Model(make(pt, fused), device="cpu")
               for fused in (True, False)}
        assert pms[True].mode == mode and pms[False].mode is None
        assert fr.aux_library(pms[True]) == lib
        p = fr.kernel_params(pms[True])
        assert p.diffrho_shock == 1.0
        assert p.eta_shock == (1.0 if "aa" in pms[True].reg.slots else 0.0)
        assert p.chi_shock == (1.0 if "ss" in pms[True].reg.slots else 0.0)
        over = start_overrides(pms[True].reg.slots, 13)
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


def test_shock_diffusion_chain_matches_jax_fused(runs):
    """The port's chain against the JAX fused step, the shock slot too."""
    assert_states_close(runs["jax_fused"], runs["chain"])


def test_shock_diffusion_chain_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["chain"]))


def test_shock_diffusion_eager_step_matches_jax_jnp_path(runs):
    assert_states_close(evolved(runs["jax_jnp"]), evolved(runs["eager"]))


@pytest.mark.parametrize("case", sorted(SETS))
def test_first_kernel_plain_with_shock_diffusion_matches_jax_rhs(case):
    """The first kernel's plain version of each chain against the JAX jnp
    path's RHS on the same state: df of every field and the CFL maximum,
    which holds the shock diffusivities' rates."""
    make, _, _ = SETS[case]
    jm = pj.Model(make(pj, False))
    pm = pt.Model(make(pt, True), device="cpu")
    js = jm.init_state(9, overrides=start_overrides(pm.reg.slots, 9))
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    fa = pm.reg.stack(pm.init_state(
        9, overrides=overrides_from_numpy(fields, pm.reg))["fields"])
    t = jm.cfg.time.tstart
    df, dt1m = first_plain(pm, fa, t)
    jdf, jdt1, _ = jax.jit(lambda f: jm.rhs(f, jm.grid, t))(
        jnp.asarray(fa.numpy()))
    np.testing.assert_allclose(float(dt1m), float(jnp.max(jdt1)),
                               rtol=RTOL_DT)
    jdf = np.asarray(jdf)
    assert df.shape == jdf.shape
    for c in range(df.shape[0]):
        assert_field_close(df[c], jdf[c], f"{case} df[{c}]")


# ---- the modules ------------------------------------------------------------------
@pytest.fixture(scope="module")
def pencils():
    """(JAX Pencils, the port's Pencils, the JAX model, the port's model)
    of the shocked MHD box with ss and the shock diffusivities, on one
    noisy ghosted state at 8×8×16 with a positive shock slot."""
    def cfg(pkg):
        return shock_box(SHAPE, pkg=pkg, fused=False, entropy=True,
                         shock_diffusion=True)

    jm, pm = pj.Model(cfg(pj)), pt.Model(cfg(pt), device="cpu")
    assert pm.reg.comp_names[-1] == "shock"
    rng = np.random.default_rng(4)
    amp = np.array([UU_AMPL] * 3 + [5e-2, 1e-2] + [AA_AMPL] * 3, np.float32)
    fa = (amp[:, None, None, None] * rng.standard_normal((8,) + SHAPE))
    shock = 0.05 * np.abs(rng.standard_normal((1,) + SHAPE))
    fa = np.concatenate([fa, shock]).astype(np.float32)
    fg = jax_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                         jm.grid, jm.cfg, jm.eos)
    return (JaxPencils(fg, jm.grid, jm.reg, jm.cfg, jm.eos),
            Pencils(pm.ghosted(torch.tensor(fa)), pm.grid, pm.reg, pm.cfg,
                    pm.eos, ghosted=True), jm, pm)


@pytest.mark.parametrize("module", ("density", "magnetic", "entropy"))
def test_module_rhs_with_shock_diffusion_matches_jax(pencils, module):
    """Each module's RHS with its shock diffusivity on (alone: no other
    module's terms) against the JAX module's on the same pencils, and its
    CFL rate D_sh·shock, η_sh·shock, γχ_sh·shock; each moves the RHS."""
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
    assert_field_close(pts.maxdiffus.numpy(), np.asarray(jts.maxdiffus),
                       f"{module} maxdiffus")
    # without the diffusivity the module's own field moves
    off = {"density": dict(diffrho_shock=0.0),
           "magnetic": dict(eta_shock=0.0),
           "entropy": dict(chi_shock=0.0)}[module]
    odf = {}
    pp2 = Pencils(pp.f, pp.grid, pp.reg, pp.cfg, pp.eos, ghosted=True)
    dataclasses.replace(pmod, **off).rhs(pp2, odf, TimestepAccum())
    key = {"density": "lnrho", "magnetic": "aa", "entropy": "ss"}[module]
    assert float((odf[key] - pdf[key]).abs().max()) > 0.0


# ---- the gate -------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SETS))
def test_gate_takes_shock_diffusion_on_the_shock_slot_sets(case):
    make, mode, lib = SETS[case]
    cfg = make(pt, True)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert fr.aux_kernels(pt.Model(cfg, device="cpu")) == tuple(
        k + "_sd" for k in fr.AUX_KERNELS[lib])


# sets without the shock slot, each with the shock diffusivities its
# modules have: the card refuses them before any launch
REFUSED = {
    "flagship": (lambda: with_shock_diffusion(flagship(SHAPE)),
                 "Density diffrho_shock"),
    "forced_entropy": (lambda: with_shock_diffusion(forced_entropy(SHAPE)),
                       "Entropy chi_shock"),
    "shear_box_ns": (lambda: with_shock_diffusion(shear_box(
        SHAPE, shock=False)), "without the Shock module"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_card_refuses_shock_diffusion_without_the_slot(case):
    make, what = REFUSED[case]
    cfg = make()
    assert what in gate_reason(cfg)
    with pytest.raises(NotImplementedError, match="shock"):
        fused_gate(cfg, "cuda")
    with pytest.raises(NotImplementedError, match="shock"):
        pt.Model(cfg, device="cuda")


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_shock_diffusion_without_the_slot_does_nothing_on_the_cpu(case):
    """As in JAX, a shock diffusivity without the Shock module's slot adds
    nothing: the eager step (the CPU's path for a set the gate refuses)
    equals the eager step of the same set without it, bit for bit."""
    make, _ = REFUSED[case]
    cfg = make()
    plain = with_shock_diffusion(cfg, 0.0).replace(fused=False)
    if cfg.module("entropy") is not None:
        plain = plain.replace(modules=tuple(
            dataclasses.replace(m, iheatcond=tuple(
                v for v in m.iheatcond if v != "shock"))
            if m.name == "entropy" else m for m in plain.modules))
    out = []
    for c in (cfg, plain):
        pm = pt.Model(c, device="cpu")
        assert pm.mode is None
        out.append(pm.make_step()(pm.init_state(3)))
    for k, v in out[1]["fields"].items():
        assert torch.equal(out[0]["fields"][k], v), k
    assert torch.equal(out[0]["dt"], out[1]["dt"])
