"""Three steps of the MHD shearing box with an entropy field and without
the shock slot (``shear_box(n, entropy=True, shock=False)``, 8 fields) in
pencil_tpu_torch against the JAX fused zroll step (Pallas interpret mode)
at 16³ and 8×16×24, with Ω and del6 hyper-diffusion as the configuration
has them; and each MHD layout with ss (``shock_box(n, entropy=True)``,
``shear_box(n, entropy=True[, shock=False])``) through the port's eager
path against the JAX jnp path at 16³.  The other fused steps, the
inputs, bounds and helpers are those of
tests/test_torch_aux_mhd_entropy_steps.py.

The JAX fused shear box without an aux slot takes the wrap mode's tail
kernels for its later substeps (a fault of the reference, ROADMAP Queue 3,
tests/test_torch_shear_layouts.py::
test_jax_fused_shear_box_without_aux_reference_fault): it is held against
the JAX fused step with that predicate answered as the zroll mode would
(``zroll_tails``), and against the jnp path.
"""
import pytest
import torch

from test_torch_aux_mhd_entropy_steps import (case_id, check_port_steps,
                                              jax_steps)

torch.set_num_threads(1)

# (layout, shape, JAX path)
CASES = [("mhd_shear_ns", shape, True)
         for shape in ((16, 16, 16), (8, 16, 24))] + [
    (lay, (16, 16, 16), False) for lay in ("mhd_shock", "mhd_shear",
                                           "mhd_shear_ns")]


@pytest.fixture(scope="module", params=CASES, ids=map(case_id, CASES))
def case(request):
    return jax_steps(*request.param)


def test_step_matches_jax(case):
    """The port's steps against JAX's (``check_port_steps``)."""
    check_port_steps(case)
