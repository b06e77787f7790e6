"""2N low-storage Runge–Kutta tables and the CFL rule (counterpart of
``pencil_tpu/integrate/timestep.py:1-100``).

Reference src/timestep.f90: Williamson (1980) 2N-RK3 coefficients
α=(0,−5/9,−153/128), β=(1/3,15/16,8/15), update f += β·dt·df.
"""
from __future__ import annotations

import torch

_CK_A = (
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
)
_CK_B = (
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
)
_CK_C = (
    0.0,
    1432997174477.0 / 9575080441755.0,
    2526269341429.0 / 6820363962896.0,
    2006345519317.0 / 3224310063776.0,
    2802321613138.0 / 2924317926251.0,
)

# itorder -> (alpha, beta, stage_time_fraction)
RK_TABLES = {
    1: ((0.0,), (1.0,), (0.0,)),
    2: ((0.0, -0.5), (0.5, 1.0), (0.0, 0.5)),
    3: ((0.0, -5.0 / 9.0, -153.0 / 128.0),
        (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0),
        (0.0, 1.0 / 3.0, 0.75)),
    4: (_CK_A, _CK_B, _CK_C),  # 5-stage 2N-RK4 (Carpenter & Kennedy)
}


def dxyz2(grid):
    """Σ_a Δ_a⁻² in the working precision."""
    return grid.dx1 ** 2 + grid.dy1 ** 2 + grid.dz1 ** 2


def pow6(x):
    """x⁶ as x²·x⁴, the product order of JAX's integer_pow."""
    x2 = x * x
    return x2 * (x2 * x2)


def dxyz6(grid):
    """Σ_a Δ_a⁻⁶ in the working precision."""
    return pow6(grid.dx1) + pow6(grid.dy1) + pow6(grid.dz1)


def _zero(v):
    return not torch.is_tensor(v) and v == 0.0


def cfl_dt1(ts, grid, time_cfg):
    """Pointwise inverse timestep (reference src/equ.f90:1100-1151; JAX
    integrate/timestep.py:49-100):

        maxadvec   = Σ advec_lin + √advec_cs2 + √advec2_hypermesh
        dt1_advec  = maxadvec/cdt
        dt1_diffus = maxdiffus·dxyz₂/cdtv + maxdiffus3·dxyz₆/cdtv3
        dt1_max    = √(dt1_advec² + dt1_diffus²)

    The wave-speed root is added LINEARLY to the velocity advection; the
    advective and diffusive classes combine as a root sum of squares.
    """
    adv = ts.maxadvec
    if not isinstance(ts.advec_cs2, float):
        adv = adv + torch.sqrt(ts.advec_cs2)
    if not isinstance(ts.advec2_hypermesh, float):
        adv = adv + torch.sqrt(ts.advec2_hypermesh)
    dt1_a = adv / time_cfg.cdt
    if _zero(ts.maxdiffus) and _zero(ts.maxdiffus3):
        return dt1_a
    dif = 0.0
    if not _zero(ts.maxdiffus):
        dif = ts.maxdiffus * dxyz2(grid) / time_cfg.cdtv
    if not _zero(ts.maxdiffus3):
        dif = dif + ts.maxdiffus3 * dxyz6(grid) / time_cfg.cdtv3
    return torch.sqrt(dt1_a ** 2 + dif ** 2)
