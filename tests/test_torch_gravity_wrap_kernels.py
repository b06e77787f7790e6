"""The periodic builds of the flagship template under gravity in
pencil_tpu_torch against pencil_tpu: the plain versions of K1, K2, K3 and
K2L (with and without the kick) and K3′ against the wrap-mode Pallas
kernels traced for the same set, in interpret mode with one tile over the
domain (PC_TX = PC_CX = nx, ROADMAP Queue 3), at 8×8×16: forced
stratified MHD in a periodic box under 'sin-z' (``strat_box(n,
periodic=True, shear=False)``) and forced hydro under constant gravity
here, the builds with ss in tests/test_torch_gravity_ent_kernels.py.
Each field within 2e-5 × its max, the CFL maximum within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import forced_entropy, forced_hydro, strat_box
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_entropy_box import pallas_calls
from test_torch_gravity_chains import RTOL_DT, with_gravity
from test_torch_zghost_mhd import assert_field_close

torch.set_num_threads(1)


# each set: its builder, and the profile put in place of its own (None:
# the builder's own gravity)
WRAP = {"mhd-sin": (lambda pkg, s: strat_box(s, pkg=pkg, periodic=True,
                                             shear=False, forcing=0.05),
                    None),
        "hydro-const": (lambda pkg, s: forced_hydro(s, pkg=pkg), "const"),
        "ent_mhd-linear": (lambda pkg, s: forced_entropy(s, pkg=pkg),
                           "linear-z"),
        "ent_hydro-sin": (lambda pkg, s: strat_box(
            s, pkg=pkg, periodic=True, shear=False, magnetic=False,
            entropy=True, forcing=0.05), None)}


@pytest.fixture(scope="module", params=("mhd-sin", "hydro-const"))
def wrap_kernels(request):
    return build_wrap_kernels(request.param)


def build_wrap_kernels(case):
    """Every wrap-mode call shape of the JAX package (interpret mode) for a
    periodic set under gravity at 8×8×16, one tile over the domain."""
    make, prof = WRAP[case]
    shape = (8, 8, 16)

    def cfg(pkg):
        c = make(pkg, shape)
        return c if prof is None else with_gravity(pkg, c, prof)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        out = pallas_calls(cfg(pj), cfg(pt))
    assert out["pm"].mode == "wrap"
    assert fr.gravity_vector(out["pm"]) is not None
    return out


def test_rhs_first_under_gravity_matches_pallas(wrap_kernels):
    """K1's (K1h's, K1e's, K1he's) plain version under gravity: df and the
    max 1/dt."""
    k = wrap_kernels
    df, dt1m = fr.rhs_first(k["pm"], torch.tensor(k["fa"]))
    np.testing.assert_allclose(float(dt1m), k["dt1max"], rtol=RTOL_DT)
    for c in range(k["nvar"]):
        assert_field_close(df[c], k["df1"][c], f"df1[{c}]")


def test_rhs_tails_under_gravity_match_pallas(wrap_kernels):
    """K2, K3 and K2L (with and without the kick) and K3′ under gravity."""
    k = wrap_kernels
    pm = k["pm"]
    df2, f2 = fr.rhs_tail_defer(pm, torch.tensor(k["fa"]),
                                torch.tensor(k["df1"]),
                                torch.tensor(k["coef2"]))
    got = {"df2": df2, "f2": f2}
    for kicked in (False, True):
        kick = torch.tensor(k["kick"]) if kicked else None
        got["last", kicked] = fr.rhs_tail_last(
            pm, torch.tensor(k["f2"]), torch.tensor(k["df2"]),
            torch.tensor(k["coef3"]), kick)
        coef = k["coef3"].copy()
        coef[2] = k["coef2"][1]
        got["defer_last", kicked] = fr.rhs_tail_defer_last(
            pm, torch.tensor(k["fa2"]), torch.tensor(k["df1"]),
            torch.tensor(coef), kick)
    got["mid"] = fr.rhs_tail_mid(pm, torch.tensor(k["fa2"]),
                                 torch.tensor(k["df1"]),
                                 torch.tensor(k["coef3"]))
    want = {"df2": k["df2"], "f2": k["f2"], "mid": k["mid"]}
    for kicked in (False, True):
        for name in ("last", "defer_last"):
            want[name, kicked] = k[name, not kicked]
    for name, a in got.items():
        for i, (x, y) in enumerate(zip(a, want[name]) if name == "mid"
                                   else [(a, want[name])]):
            for c in range(k["nvar"]):
                assert_field_close(x[c], y[c], f"{name} {i} [{c}]")
