"""The 5-field entropy instances of the flagship template (K1he, K2he,
K3he, K3′he, K2Lhe: forced hydro with an entropy field; plain versions on
the CPU) against the Pallas kernels they replace, in interpret mode: the
tests of test_torch_entropy_box.py on the set without Magnetic, at 16³
with K-const conduction added and at 8×8×16.  Each field within 2e-5 × its
max, the CFL maximum within 1e-6 relative.
"""
import pytest
import torch

from test_torch_entropy_box import (  # noqa: F401  (collected here too)
    K_AND_CHI, build_kernels, test_rhs_first_ent_matches_pallas,
    test_rhs_tail_defer_ent_matches_pallas,
    test_rhs_tail_defer_last_ent_matches_pallas,
    test_rhs_tail_last_ent_matches_pallas,
    test_rhs_tail_mid_ent_matches_pallas)

torch.set_num_threads(1)

CASES = {"hydro-16-K": (False, (16, 16, 16), K_AND_CHI),
         "hydro-8x8x16": (False, (8, 8, 16), None)}


@pytest.fixture(scope="module", params=sorted(CASES))
def kernels(request):
    return build_kernels(*CASES[request.param])
