"""Hyper-diffusive non-isothermal turbulence (both entropy sets of the
flagship template with ``hyper3=True``: del6 hyper-diffusion of u, lnρ
and, with Magnetic, A, on the H3 instances of the 8- and 5-field builds)
in pencil_tpu_torch against the JAX fused step, 3 forced steps at 16³ and
16×16×32, and the flagship with hyper-diffusion at order 2 (K1, K2L with
the kick).  The other sets' steps, the terms' effect and the gate are in
test_torch_hyper3_wrap.py.  Each field within 2e-5 × its max, dt within
1e-6 relative.
"""
import pytest
import torch

from test_torch_hyper3_wrap import (SHAPE_IDS, SHAPES, assert_states_close,
                                    run_both)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("case", ("ent_hydro", "ent_mhd"))
def test_h3_entropy_step_matches_jax_fused(case, shape):
    """Both entropy sets with hyper-diffusion, 3 forced steps at order 3
    (K1e/K1he, K2, K3 with the kick: their H3 instances, the viscous and
    Ohmic heating and chi-const beside the del6 terms) against the JAX
    fused step."""
    assert_states_close(*run_both(case, shape))


def test_h3_flagship_rk2_matches_jax_fused():
    """The flagship with hyper-diffusion at order 2 (K1, K2L with the
    kick) against the JAX fused step, 3 forced steps."""
    assert_states_close(*run_both("mhd", itorder=2))
