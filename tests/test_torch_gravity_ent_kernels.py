"""The entropy builds of the flagship template (K1e … K2Le, K1he …
K2Lhe) under gravity against the wrap-mode Pallas kernels traced for the
same sets: the tests of tests/test_torch_gravity_wrap_kernels.py on the
MHD set with ss under 'linear-z' and on the stratified hydro set with ss
in a periodic box under 'sin-z' (``strat_box(n, periodic=True,
shear=False, magnetic=False, entropy=True)``), so that two workers share
the interpret-mode Pallas calls.  Each field within 2e-5 × its max, the
CFL maximum within 1e-6 relative.
"""
import pytest
import torch

from test_torch_gravity_wrap_kernels import (  # noqa: F401  (collected here)
    build_wrap_kernels, test_rhs_first_under_gravity_matches_pallas,
    test_rhs_tails_under_gravity_match_pallas)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=("ent_mhd-linear", "ent_hydro-sin"))
def wrap_kernels(request):
    return build_wrap_kernels(request.param)
