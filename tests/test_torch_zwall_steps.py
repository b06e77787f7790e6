"""Steps of the z-walled chain with the new z-wall codes, pencil_tpu_torch
against pencil_tpu: magnetoconvection with a vacuum exterior (ax, ay, az
'pot' at both walls: the x/y-ghosted layout, its K6ms/K7ms at S = 0),
Kramers convection with a black-body top and a hydrostatic density top
(ss 'c1:Fgs', lnρ 'a2:hs', σ_SBt from ``configs.fgs_sigma``: the CHI
instances of K6/K7) and the conv-slab with 's0d' on ux and uy (a cut of
2g + 1 planes).

Two steps at 8×8×16 from the JAX init with u and A replaced by numpy
noise of 1e-2, the port's chain (its kernels' plain versions on the CPU)
against the JAX fused zghost step (Pallas in interpret mode, one tile
over the domain: ROADMAP Queue 3) and the JAX jnp path.  Bounds, those of
tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import conv_slab, fgs_sigma
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_zghost_chi import start_states
from test_torch_zghost_mhd import assert_states_close

torch.set_num_threads(1)

SHAPE = (8, 8, 16)
NSTEPS = 2
CASES = {
    "vacuum": dict(magnetic=True, bcz={"ax": "pot", "ay": "pot",
                                       "az": "pot"}),
    "radiative": dict(heatcond="kramers", bcz={"lnrho": "a2:hs",
                                               "ss": "c1:Fgs"},
                      entropy=dict(sigmaSBt=fgs_sigma())),
    "s0d": dict(bcz={"ux": "s0d", "uy": "s0d"}),
}
# the build each set runs and its launch names' suffix
BUILDS = {"vacuum": ("fused_rhs_zg_mag_shear", ""),
          "radiative": ("fused_rhs_zg", "_chi"), "s0d": ("fused_rhs_zg", "")}


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request):
    """(name, port model, {path: (JAX state, port state)}) after NSTEPS
    steps of each JAX path and the port's chain from the same state."""
    kw = CASES[request.param]
    pm = pt.Model(conv_slab(SHAPE, **kw), device="cpu")
    assert pm.mode == "zghost"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(SHAPE[0]))
        mp.setenv("PC_CX", str(SHAPE[0]))
        for path, fused in (("fused", True), ("jnp", False)):
            jm = pj.Model(conv_slab(SHAPE, fused=fused, pkg=pj, **kw))
            if fused:
                assert jm._fused_mode(None, None, SHAPE[2]) == "zghost"
            js, ps = start_states(jm, pm, 11)
            jstep, pstep = jm.make_step(), pm.make_step()
            for _ in range(NSTEPS):
                js, ps = jstep(js), pstep(ps)
            out[path] = (js, ps)
    return request.param, pm, out


@pytest.mark.parametrize("path", ("fused", "jnp"))
def test_step_matches_jax(steps, path):
    name, pm, out = steps
    js, ps = out[path]
    for v in ps["fields"].values():
        assert torch.isfinite(v).all()
    assert_states_close(js, ps)


def test_set_runs_its_build(steps):
    """The vacuum set runs the MHD shear build with S = 0 on the x/y-
    ghosted slabs, the others their own builds; the cut is 2g + 1 planes
    deep with 's0d'."""
    name, pm, _ = steps
    lib, sfx = BUILDS[name]
    assert fr.zg_library(pm) == lib
    assert fr.zg_kernels(pm)[0].endswith(sfx) or not sfx
    assert fr.kernel_params(pm).S == 0.0
    assert pm.zg_xy == (name == "vacuum")
    assert pm._zdepth == (7 if name == "s0d" else 4)


def test_step_leaves_its_input_alone(steps):
    """z_slabs and bc_writeback act in place; a step does not write into
    the state it is given."""
    name, pm, out = steps
    ps = out["jnp"][1]
    before = {k: v.clone() for k, v in ps["fields"].items()}
    pm.make_step()(ps)
    for k, v in before.items():
        assert torch.equal(ps["fields"][k], v), k


def test_radiative_top_balances_the_bottom_flux():
    """σ_SBt·T⁴ at the top equals the flux that the bottom 'c1' lets in,
    K(z₀)·0.625 with Kramers' K, on the initial state's end planes."""
    pm = pt.Model(conv_slab(SHAPE, **CASES["radiative"]), device="cpu")
    f = pm.init_state(0)["fields"]
    eos, ent = pm.eos, pm.cfg.module("entropy")
    lnrho, ss = f["lnrho"][0, 0].double(), f["ss"][0, 0].double()
    cs2 = eos.cs20 * torch.exp(eos.gamma * ss / eos.cp
                               + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
    TT = cs2 / ((eos.gamma - 1.0) * eos.cp)
    K = ent.hcond0_kramers * TT[0] ** 6.5 / torch.exp(lnrho[0]) ** 2
    np.testing.assert_allclose(float(ent.sigmaSBt * TT[-1] ** 4),
                               float(K * 0.625), rtol=1e-5)
