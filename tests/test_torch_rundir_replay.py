"""The replayed forcing (``Forcing(sequence=...)``, what the run-directory
loader makes of a k.dat) through each chain that kicks, in
pencil_tpu_torch against the JAX jnp path, 3 steps from the same fields:
the flagship's wrap chain (the kick inside K3), the sheared conv-slab's
zghost chain and the forced hydro shear box's zroll chain (the kick after
the step, the kx shift of the shearing frame at each step's end time, from
t = 0.37).  Both pick the row of the step's ``it``; the sequence is shorter
than the run, so the last steps reuse its last row.

Bounds, those of tests/test_fused.py: each field within 2e-5 × its max, dt
within 1e-6 relative.  Velocity noise of 1e-2 (the conv-slab's 1e-3 sits
below its float32 floor after a few steps, tests/test_torch_zghost.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.physics.forcing import shell_vectors
from test_torch_zghost_mhd import assert_states_close

torch.set_num_threads(1)

NSTEPS = 3
TSTART = 0.37


def _sequence(nrows, seed):
    rng = np.random.default_rng(seed)
    kk = shell_vectors(3.0, 0.5)
    return tuple((*kk[rng.integers(len(kk))], float(rng.uniform(-3, 3)),
                  float(rng.uniform(0, 6))) for _ in range(nrows))


def _replayed(cfg, seq):
    """``cfg`` with its Forcing in replay mode (as the loader makes it)."""
    return cfg.replace(modules=tuple(
        dataclasses.replace(m, force=0.05, sequence=seq, kav=3.05,
                            cs0eff=1.0)
        if m.name == "forcing" else m for m in cfg.modules))


def _config(pkg, case):
    fused = pkg is pt
    if case == "flagship":
        return pt.configs.flagship(8, fused=fused, pkg=pkg), "wrap"
    if case == "conv_shear":
        cfg = pt.configs.conv_slab((8, 8, 16), fused=fused, pkg=pkg,
                                   Omega=0.5, shear=True, forcing=0.05)
        mode = "zghost"
    else:
        cfg = pt.configs.shear_box(8, fused=fused, pkg=pkg, magnetic=False,
                                   shock=False)
        mode = "zroll"
    return cfg.replace(time=pkg.TimeSpec(itorder=3, tstart=TSTART)), mode


@pytest.mark.parametrize("case", ("flagship", "conv_shear", "shear_box"))
def test_replayed_forcing_matches_the_jax_jnp_path(case):
    seq = _sequence(NSTEPS - 1, seed=len(case))
    jcfg, _ = _config(pj, case)
    pcfg, mode = _config(pt, case)
    jm = pj.Model(_replayed(jcfg, seq))
    pm = pt.Model(_replayed(pcfg, seq), device="cpu")
    assert pm.mode == mode and pm.forcing.sequence == seq
    rng = np.random.default_rng(5)
    shape = pcfg.grid.shape
    over = {"uu": (1e-2 * rng.standard_normal((3,) + shape))
            .astype(np.float32)}
    js = jm.init_state(1, overrides=over)
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(1, overrides=overrides_from_numpy(fields, pm.reg))
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(NSTEPS):
        js, ps = jstep(js), pstep(ps)
    assert_states_close(js, ps)
    # the kick acts: the unforced step ends elsewhere
    unforced = pt.Model(pcfg.replace(modules=tuple(
        m for m in pcfg.modules if m.name != "forcing")), device="cpu")
    us = unforced.init_state(1, overrides=overrides_from_numpy(fields,
                                                               pm.reg))
    for _ in range(NSTEPS):
        us = unforced.make_step()(us)
    du = float((ps["fields"]["uu"] - us["fields"]["uu"]).abs().max())
    assert du > 1e-3 * float(us["fields"]["uu"].abs().max())
