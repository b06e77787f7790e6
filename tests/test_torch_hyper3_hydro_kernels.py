"""The H3 instances of the 4- and 5-field builds of the flagship template
(forced hydro with hyper-diffusion, without and with an entropy field;
plain versions on the CPU) against the Pallas kernels they replace, in
interpret mode: the tests of test_torch_hyper3_kernels.py on these two
sets, and the rotating flagship with hyper-diffusion (the Coriolis H3
instances) against the JAX fused step.  Each field within 2e-5 × its
max, the CFL maximum and dt within 1e-6 relative.
"""
import pytest
import torch

from test_torch_hyper3_kernels import (  # noqa: F401  (collected here too)
    build_kernels, test_rhs_first_h3_matches_pallas,
    test_rhs_tail_defer_h3_matches_pallas,
    test_rhs_tail_defer_last_h3_matches_pallas,
    test_rhs_tail_last_h3_matches_pallas,
    test_rhs_tail_mid_h3_matches_pallas)
from test_torch_hyper3_wrap import assert_states_close, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=("hydro", "ent_hydro"))
def kernels(request):
    return build_kernels(request.param)


def test_h3_rotating_flagship_matches_jax_fused():
    """The flagship with hyper-diffusion and Ω = 1 (the Coriolis H3
    instances) against the JAX fused step, 3 forced steps."""
    assert_states_close(*run_both("mhd", Omega=1.0))
