"""The flagship step's three fused RHS kernels and their plain versions
(counterpart of ``pencil_tpu/ops/fused_rhs.py``, wrap mode).

Each wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the hand-written kernel of ``csrc/fused_rhs.cu``, or
raises; a CPU tensor runs the plain PyTorch version beside it.  There is no
fallback from a kernel to its plain version.

  rhs_first        K1  df = RHS(f), max of the CFL 1/dt
  rhs_tail_defer   K2  f1 = f0 + cprev·df1 rebuilt from raw f0 and df1;
                       df2 = α·df1 + RHS(f1), f2 = f1 + βΔt·df2
  rhs_tail_last    K3  f3 = f2 + βΔt·(α·df2 + RHS(f2)), plus the helical
                       forcing kick on u when a kick vector is given

``coef`` = [α, βΔt, cprev] and ``kick`` (12,) are device tensors, so no
launch needs a host copy of dt.  Every wrapper returns fresh output
tensors: a kernel must never write into a buffer another block reads halos
from.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.grid import inverse_spacings
from ..integrate.timestep import cfl_dt1
from ..physics.base import TimestepAccum
from ..physics.pencils import Pencils
from . import _build
from .stencil import BIDIAG, BIDIAG_TAPS, paired_weights

# Nothing here should reach cuDNN or a matmul, but a stencil written as a
# conv3d would silently drop to TF32 on Hopper and lose f32 parity.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# Launches of each kernel: a wrapper adds one where it launches, and
# nowhere else, so a run can show that its main path went through them.
LAUNCHES = {"rhs_first": 0, "rhs_tail_defer": 0, "rhs_tail_last": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain PyTorch versions ---------------------------------------------
def rhs_plain(model, f, want_dt1=True):
    """(df, max 1/dt) of the composed module set on the periodic stack f.
    The max is None when ``want_dt1`` is false."""
    reg = model.reg
    pen = Pencils(f[: reg.ncom], model.grid, reg, model.cfg, model.eos)
    df = {}
    ts = TimestepAccum()
    for m in model.modules:
        m.rhs(pen, df, ts)
    parts = []
    for name, slot in reg.slots.items():
        if slot.kind != "pde":
            continue
        d = df.get(name)
        if d is None:
            d = torch.zeros((slot.ncomp,) + f.shape[1:], dtype=f.dtype,
                            device=f.device)
        elif d.ndim == 3:
            d = d[None]
        parts.append(d)
    dfa = torch.cat(parts, dim=0)
    if not want_dt1:
        return dfa, None
    return dfa, cfl_dt1(ts, model.grid, model.cfg.time).max()


def rhs_first_plain(model, fa):
    """K1's plain version: (df, 0-d max of 1/dt)."""
    return rhs_plain(model, fa)


def rhs_tail_defer_plain(model, fa, df1, coef):
    """K2's plain version: (df2, f2)."""
    alpha, bdt, cprev = coef[0], coef[1], coef[2]
    f1 = fa + cprev * df1
    dfa, _ = rhs_plain(model, f1, want_dt1=False)
    dfn = alpha * df1 + dfa
    return dfn, f1 + bdt * dfn


def rhs_tail_last_plain(model, fa, df2, coef, kick=None):
    """K3's plain version: f3, kicked when ``kick`` is given."""
    alpha, bdt = coef[0], coef[1]
    dfa, _ = rhs_plain(model, fa, want_dt1=False)
    f3 = fa + bdt * (alpha * df2 + dfa)
    if kick is None:
        return f3
    # angle-addition form, as the kernel: θ = k·x + φ = A + B + C
    gs, grid = model.cfg.grid, model.grid
    x0, y0 = _node0(gs)
    ar = {n: torch.arange(n, dtype=fa.dtype, device=fa.device)
          for n in (gs.nx, gs.ny)}
    A = kick[0] * (x0 + gs.dx * ar[gs.nx])[:, None, None] + kick[3]
    B = kick[1] * (y0 + gs.dy * ar[gs.ny])[None, :, None]
    C = kick[2] * grid.zg
    cA, sA = torch.cos(A), torch.sin(A)
    cB, sB = torch.cos(B), torch.sin(B)
    cC, sC = torch.cos(C), torch.sin(C)
    P = cA * cB - sA * sB                      # cos(A+B)
    Q = sA * cB + cA * sB                      # sin(A+B)
    iuu = model.reg.slice("uu").start
    kicked = []
    for c in range(3):
        a, b = kick[4 + c], kick[7 + c]
        U = a * cC - b * sC
        V = a * sC + b * cC
        kicked.append(f3[iuu + c] + kick[10] * (P * U - Q * V))
    return torch.cat([f3[:iuu], torch.stack(kicked), f3[iuu + 3:]])


def _node0(gs):
    """First node of each periodic axis: x0 + ½dx."""
    return gs.x0 + 0.5 * gs.dx, gs.y0 + 0.5 * gs.dy


# ---- the kernels --------------------------------------------------------
class PcParams(ctypes.Structure):
    """Mirror of ``struct PcParams`` in csrc/fused_rhs.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("isothermal", ctypes.c_int),
        ("w1", ctypes.c_float * 3), ("w2", ctypes.c_float * 3),
        ("wm", ctypes.c_float * 12),
        ("inv", ctypes.c_float * 3), ("invsq", ctypes.c_float * 3),
        ("nu", ctypes.c_float), ("eta", ctypes.c_float),
        ("cs20", ctypes.c_float), ("gm1", ctypes.c_float),
        ("lnrho0", ctypes.c_float),
        ("dxyz2", ctypes.c_float), ("cdt", ctypes.c_float),
        ("dif", ctypes.c_float),
        ("x0", ctypes.c_float), ("y0", ctypes.c_float),
        ("dx", ctypes.c_float), ("dy", ctypes.c_float),
    ]


# the kernel's fixed field layout: the flagship registry order
_LAYOUT = {"uu": slice(0, 3), "lnrho": slice(3, 4), "aa": slice(4, 7)}


def kernel_params(model) -> PcParams:
    """The kernel constants of ``model``, rounded to f32 in the same order
    as the plain version computes them; built once per model."""
    p = model.__dict__.get("_pc_params")
    if p is not None:
        return p
    reg, cfg, gs = model.reg, model.cfg, model.cfg.grid
    if reg.nvar != 7 or reg.ncom != 7 or any(
            reg.slice(k) != v for k, v in _LAYOUT.items()):
        raise NotImplementedError("fused kernels: flagship field layout only")
    f32 = np.float32
    inv = np.array(inverse_spacings(gs), f32)
    invsq = inv * inv
    dxyz2 = (invsq[0] + invsq[1]) + invsq[2]
    nu = cfg.module("viscosity").nu
    eta = cfg.module("magnetic").eta
    maxdiffus = max([v for v in (nu, eta) if v > 0.0], default=0.0)
    dif = f32(maxdiffus) * dxyz2 / f32(cfg.time.cdtv) if maxdiffus else f32(0)
    eos = model.eos
    x0, y0 = _node0(gs)
    wm = [sgn * c for c in BIDIAG for _, _, sgn in BIDIAG_TAPS]
    p = PcParams(
        nx=gs.nx, ny=gs.ny, nz=gs.nz, isothermal=int(eos.gamma == 1.0),
        w1=(ctypes.c_float * 3)(*paired_weights(1)),
        w2=(ctypes.c_float * 3)(*paired_weights(2)),
        wm=(ctypes.c_float * 12)(*wm),
        inv=(ctypes.c_float * 3)(*inv), invsq=(ctypes.c_float * 3)(*invsq),
        nu=max(nu, 0.0), eta=max(eta, 0.0),
        cs20=eos.cs20, gm1=eos.gamma - 1.0, lnrho0=eos.lnrho0,
        dxyz2=dxyz2, cdt=cfg.time.cdt, dif=dif,
        x0=x0, y0=y0, dx=gs.dx, dy=gs.dy)
    model.__dict__["_pc_params"] = p
    return p


def _nblocks(shape):
    lib = _build.load()
    t = (ctypes.c_int * 3)()
    lib.pc_tile_shape(ctypes.addressof(t))
    n = 1
    for s, b in zip(shape, t):
        n *= -(-s // b)
    return n


def _check(t, shape, what):
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous float32 tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _launch(name, fa, *args):
    with torch.cuda.device(fa.device):
        stream = torch.cuda.current_stream(fa.device).cuda_stream
        rc = getattr(_build.load(), "pc_" + name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"pc_{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _dispatch(fa):
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if fa.is_cuda:
        return True
    if fa.device.type != "cpu":
        raise NotImplementedError(f"no fused kernel for device {fa.device}")
    return False


def rhs_first(model, fa):
    """K1: replaces ``kernel`` + ``_dma_tile_wrap`` (fused_rhs.py:306, wrap
    mode).  Returns (df, 0-d max of 1/dt)."""
    if not _dispatch(fa):
        return rhs_first_plain(model, fa)
    p = kernel_params(model)
    _check(fa, (7, p.nx, p.ny, p.nz), "fa")
    df = torch.empty_like(fa)
    blk = torch.empty(_nblocks((p.nx, p.ny, p.nz)), dtype=fa.dtype,
                      device=fa.device)
    _launch("rhs_first", fa, ctypes.addressof(p), fa.data_ptr(),
            df.data_ptr(), blk.data_ptr())
    return df, torch.amax(blk)


def rhs_tail_defer(model, fa, df1, coef):
    """K2: replaces ``kernel_tail(defer_prev=True)`` (fused_rhs.py:379).
    Returns (df2, f2)."""
    if not _dispatch(fa):
        return rhs_tail_defer_plain(model, fa, df1, coef)
    p = kernel_params(model)
    shape = (7, p.nx, p.ny, p.nz)
    _check(fa, shape, "fa")
    _check(df1, shape, "df1")
    _check(coef, (3,), "coef")
    df2 = torch.empty_like(fa)
    f2 = torch.empty_like(fa)
    _launch("rhs_tail_defer", fa, ctypes.addressof(p), fa.data_ptr(),
            df1.data_ptr(), coef.data_ptr(), df2.data_ptr(), f2.data_ptr())
    return df2, f2


def rhs_tail_last(model, fa, df2, coef, kick=None):
    """K3: replaces ``kernel_tail(last=True, with_kick=...)``
    (fused_rhs.py:379, kick at :429-466).  Returns f3."""
    if not _dispatch(fa):
        return rhs_tail_last_plain(model, fa, df2, coef, kick)
    p = kernel_params(model)
    shape = (7, p.nx, p.ny, p.nz)
    _check(fa, shape, "fa")
    _check(df2, shape, "df2")
    _check(coef, (3,), "coef")
    if kick is not None:
        _check(kick, (12,), "kick")
    zc = model.grid.z
    _check(zc, (p.nz,), "z")
    f3 = torch.empty_like(fa)
    _launch("rhs_tail_last", fa, ctypes.addressof(p), fa.data_ptr(),
            df2.data_ptr(), coef.data_ptr(),
            None if kick is None else kick.data_ptr(), zc.data_ptr(),
            f3.data_ptr())
    return f3
