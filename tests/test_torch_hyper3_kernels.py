"""The H3 instances of the flagship template (del6 hyper-diffusion of u,
A and lnρ: the four periodic sets with ``hyper3=True``; plain versions on
the CPU) against the Pallas kernels they replace, traced for those sets
in interpret mode: every kernel kind (K1, K2, K3 with and without the
kick, K3′, K2L with and without) of forced MHD and of forced MHD with an
entropy field at 8×8×16.  The 4- and 5-field sets run the same tests from
test_torch_hyper3_hydro_kernels.py, so that two workers share the
interpret-mode Pallas calls.  Each field within 2e-5 × its max, the CFL
maximum within 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.ops import fused_rhs as fr
from test_torch_entropy_box import pallas_calls
from test_torch_hyper3_wrap import RTOL_DT, SUFFIX, config
from test_torch_rk_orders import assert_field_close

torch.set_num_threads(1)


KSHAPE = (8, 8, 16)


@pytest.fixture(scope="module", params=("mhd", "ent_mhd"))
def kernels(request):
    return build_kernels(request.param)


def build_kernels(case):
    """Every wrap-mode call shape of the JAX package (interpret mode)
    traced for one set with hyper-diffusion at 8×8×16, on numpy inputs;
    numpy results."""
    out = pallas_calls(config(pj, case, KSHAPE), config(pt, case, KSHAPE))
    out["case"] = case
    return out


def test_rhs_first_h3_matches_pallas(kernels):
    """K1's H3 plain version: df of every field with ν₃ del6 u, D₃ del6
    lnρ (and η₃ del6 A), and the max 1/dt with the del6 rate added to the
    diffusive one."""
    pm = kernels["pm"]
    assert fr.launch_suffix(pm) == SUFFIX[kernels["case"]]
    df, dt1m = fr.rhs_first(pm, torch.tensor(kernels["fa"]))
    assert df.shape == kernels["fa"].shape and dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(kernels["nvar"]):
        assert_field_close(df[c], kernels["df1"][c], f"df1[{c}]")


def test_rhs_tail_defer_h3_matches_pallas(kernels):
    """K2's H3 plain version: df2 and f2 from raw f0 and df1."""
    df2, f2 = fr.rhs_tail_defer(kernels["pm"], torch.tensor(kernels["fa"]),
                                torch.tensor(kernels["df1"]),
                                torch.tensor(kernels["coef2"]))
    for c in range(kernels["nvar"]):
        assert_field_close(df2[c], kernels["df2"][c], f"df2[{c}]")
        assert_field_close(f2[c], kernels["f2"][c], f"f2[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_last_h3_matches_pallas(kernels, kicked):
    """K3's H3 plain version, with and without the helical kick."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    f3 = fr.rhs_tail_last(kernels["pm"], torch.tensor(kernels["f2"]),
                          torch.tensor(kernels["df2"]),
                          torch.tensor(kernels["coef3"]), kick)
    for c in range(kernels["nvar"]):
        assert_field_close(f3[c], kernels["last", not kicked][c], f"f3[{c}]")


@pytest.mark.parametrize("kicked", (False, True), ids=("unforced", "kick"))
def test_rhs_tail_defer_last_h3_matches_pallas(kernels, kicked):
    """K2L's H3 plain version: f rebuilt from raw f0 and df1, updated and
    kicked."""
    kick = torch.tensor(kernels["kick"]) if kicked else None
    coef = kernels["coef3"].copy()
    coef[2] = kernels["coef2"][1]
    f = fr.rhs_tail_defer_last(kernels["pm"], torch.tensor(kernels["fa2"]),
                               torch.tensor(kernels["df1"]),
                               torch.tensor(coef), kick)
    for c in range(kernels["nvar"]):
        assert_field_close(f[c], kernels["defer_last", not kicked][c],
                           f"f[{c}]")


def test_rhs_tail_mid_h3_matches_pallas(kernels):
    """K3′'s H3 plain version against the ``kernel_upd`` call: df (written
    over df_prev) and f."""
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_tail_mid(kernels["pm"], torch.tensor(kernels["fa2"]),
                            df_prev, torch.tensor(kernels["coef3"]))
    assert df is df_prev
    for c in range(kernels["nvar"]):
        assert_field_close(df[c], kernels["mid"][0][c], f"df[{c}]")
        assert_field_close(f[c], kernels["mid"][1][c], f"f[{c}]")
