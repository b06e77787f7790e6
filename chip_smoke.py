#!/usr/bin/env python3
"""Drive the pencil_tpu_torch main paths on one NVIDIA GPU: the forced-MHD
flagship step (kernels K1-K3; K2L at 2N-RK order 2, K3′ at order 4; the
K8 memory floor), forced hydro turbulence on the same template's 4-field
build (K1h-K3h, K3′h, K2Lh), non-isothermal forced turbulence on its
entropy builds (K1e-K2Le with Magnetic, K1he-K2Lhe without) and through
the run loop (``simulate``: time_series.dat, checkpoints, a bit-exact
restart), stratified convection with a non-periodic z (kernels K6, K7),
the sheared, rotating MHD box with shock viscosity and hyper-diffusion
(kernels K4, K5) and the shocked periodic box (kernels K1s, K5w).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and toolchain: the card, its power limit, nvcc, the kernel
     build (one nvcc per csrc/*.cu, all at once);
  2. each fused kernel against its plain PyTorch version on the same CUDA
     inputs at 64³ and 32×64×128, the flagship template's instances also
     at 24×20×42, which breaks every edge of their x-march (each field
     within 2e-5 × its max, and within 1e-6 for K1s, K5w, K3′, K2L, K8,
     the hydro instances and K1-K3, K3′, K2L with Ω = 1, K8's K1 and K2
     variants bit for bit; the CFL maximum within 1e-6 relative; the
     shear-box input at t = 0.37 with a positive shock slot, the shock-box
     input at urms ≈ 1 with its shock slot from the pre-pass; the entropy
     instances within 2e-5, with chi-const alone, with K-const beside it
     and with K-const alone, the last two with Ω = 1), and three full
     steps of each path on the card against the same steps on the CPU at
     32³ (the flagship, forced hydro and both entropy sets at orders 2, 3
     and 4, the first two with Ω = 1 at order 3, the shear box unforced
     and forced);
  3. the main paths at 256³ through Model(cfg, device="cuda"),
     init_state(0) and make_step(), 3 warm-up and 20 timed steps under
     torch.cuda.set_sync_debug_mode("error"), the launch counts set to 0
     just before each path's timed steps and read just after: the
     flagship with exactly one launch of K1, K2, K3 per step, forced
     hydro with one of K1h, K2h, K3h, the conv-slab layer with one K6 and
     two K7, the shear box with one K4 and two K5, the shock box with one
     K1s and two K5w, the flagship at order 4 with K1, K2, two K3′ and K3,
     at order 2 with K1 and K2L (forced hydro and both entropy sets
     likewise with their builds), and the K8 chain (Model(fake_rhs=True))
     with one launch of each of its three variants; then
     simulate(forced_entropy(256), nt=40) with rows every 10 steps and a
     checkpoint every 20, every chunk of steps under the sync debug mode
     "error": the rows it = 0, 1, 10, 20, 30, 40 all finite, COMPLETED,
     40 launches each of K1e, K2e, K3e, and a second run of 20 steps, a
     new model resumed from its var.npz and 20 more steps that gives the
     first run's fields bit for bit;
  4. each kernel's time against its plain version, each plain chain's
     step time, and the K8 chain's step time beside the flagship's, at
     256³; for each instance of the flagship template (csrc/fused_rhs.cu,
     all four builds) its registers, local bytes, static and dynamic
     shared memory per block and resident blocks per SM.
The line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the exit code is then not 0.  Without a CUDA device the script
exits 1 and prints no result.  It imports no JAX.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

N_MAIN = 256
WARM, TIMED = 3, 20
RTOL_FIELD, RTOL_DT = 2e-5, 1e-6
# K1s, K5w, K3′, K2L, K8, the hydro instances and the Ω instances against
# their plain versions
RTOL_NEW = 1e-6
# K8's K1 and K2 variants round once per operation, as their plain versions
# do: they must agree bit for bit
EXACT = ("rhs_first_fake", "rhs_tail_defer_fake")
# the flagship instances' extra shape: nx below the x segment (64), ny not
# a multiple of the column's 8, nz neither of its 32 nor of 4
EDGE_SHAPE = (24, 20, 42)
FLAGSHIP_KERNELS = ("rhs_first", "rhs_tail_defer", "rhs_tail_last")
TAIL_KERNELS = ("rhs_tail_mid", "rhs_tail_defer_last")
# the flagship template's 4-field build (PC_MAG=0): K1h-K3h, K3′h, K2Lh
HYDRO_KERNELS = tuple(k + "_hydro" for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
# its builds with an entropy field (PC_ENT=1): K1e-K3e, K3′e, K2Le on 8
# fields, K1he-K3he, K3′he, K2Lhe on 5
ENT_KERNELS = tuple(k + "_ent" for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
HYDRO_ENT_KERNELS = tuple(k + "_hydro_ent"
                          for k in FLAGSHIP_KERNELS + TAIL_KERNELS)
FAKE_KERNELS = ("rhs_first_fake", "rhs_tail_defer_fake", "rhs_tail_last_fake")
ZROLL_KERNELS = ("rhs_zroll", "rhs_zroll_upd")
SHOCK_KERNELS = ("rhs_wrap_shock", "rhs_wrap_shock_upd")
ZGHOST_KERNELS = ("rhs_zg", "rhs_zg_upd")
KERNEL_NAMES = (FLAGSHIP_KERNELS + TAIL_KERNELS + FAKE_KERNELS
                + HYDRO_KERNELS + ENT_KERNELS + HYDRO_ENT_KERNELS
                + ZROLL_KERNELS + SHOCK_KERNELS + ZGHOST_KERNELS)
# the phase-3 paths on the flagship template: name -> launch suffix
TEMPLATE_PATHS = {"flagship": "", "forced hydro": "_hydro",
                  "entropy MHD": "_ent", "entropy hydro": "_hydro_ent"}
# launches of each kernel in one step of each phase-3 path
PER_STEP = {
    "flagship": dict.fromkeys(FLAGSHIP_KERNELS, 1),
    "flagship rk4": {"rhs_first": 1, "rhs_tail_defer": 1, "rhs_tail_mid": 2,
                     "rhs_tail_last": 1},
    "flagship rk2": {"rhs_first": 1, "rhs_tail_defer_last": 1},
    "K8 chain": dict.fromkeys(FAKE_KERNELS, 1),
    "conv-slab": {"rhs_zg": 1, "rhs_zg_upd": 2},
    "shear box": {"rhs_zroll": 1, "rhs_zroll_upd": 2},
    "shock box": {"rhs_wrap_shock": 1, "rhs_wrap_shock_upd": 2},
}
# the other template paths launch the flagship's kernels of their builds
for _name, _sfx in TEMPLATE_PATHS.items():
    for _order in ("", " rk4", " rk2"):
        PER_STEP[_name + _order] = {
            k + _sfx: n for k, n in PER_STEP["flagship" + _order].items()}
_FR = "pencil_tpu/ops/fused_rhs.py:"
REPLACES = {
    "rhs_first": _FR + "306", "rhs_tail_defer": _FR + "379",
    "rhs_tail_last": _FR + "379",
    # the JAX step's order-4 middle substeps build `kernel_upd` with the
    # wrap fetch (pencil_tpu/model.py:690), not a `kernel_tail` variant
    "rhs_tail_mid": _FR + "331", "rhs_tail_defer_last": _FR + "379",
    "rhs_first_fake": _FR + "127", "rhs_tail_defer_fake": _FR + "127",
    "rhs_tail_last_fake": _FR + "127",
    "rhs_zroll": _FR + "306", "rhs_zroll_upd": _FR + "331",
    "rhs_wrap_shock": _FR + "306", "rhs_wrap_shock_upd": _FR + "331",
    "rhs_zg": _FR + "317", "rhs_zg_upd": _FR + "349",
}
# the hydro build replaces the same calls, traced for the hydro set
REPLACES.update({k + sfx: REPLACES[k]
                 for k in FLAGSHIP_KERNELS + TAIL_KERNELS
                 for sfx in ("_hydro", "_ent", "_hydro_ent")})
SOURCES = {k: "pencil_tpu_torch/csrc/" + src for src, ks in (
    ("fused_rhs.cu", FLAGSHIP_KERNELS + TAIL_KERNELS + FAKE_KERNELS
     + HYDRO_KERNELS + ENT_KERNELS + HYDRO_ENT_KERNELS),
    ("zroll_rhs.cu", ZROLL_KERNELS + SHOCK_KERNELS),
    ("zghost_rhs.cu", ZGHOST_KERNELS)) for k in ks}

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet): device
# memory at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# Operations per grid point, counted from the kernels' sources (csrc/*.cu,
# stencil.cuh): a scaled paired first derivative is 9 (3 differences, 3
# products, 2 sums, the 1/dx), a scaled second or 6th difference 13, a
# bidiagonal mixed derivative 23 (12 products, 11 sums), the pointwise
# physics of each module as written, a transcendental, root or division
# counted as one; terms that this run's coefficients switch off are left
# out.  The update per field (df = α·df_prev + r, f = f + βΔt·df) is 4,
# the rebuilt f1 = f0 + cprev·df1 is 2, the angle-addition kick 53.
D1, D2, DMIX, UPD, REBUILD, KICK_OPS = 9, 13, 23, 4, 2, 53
FLAGSHIP_RHS = 21 * D1 + 18 * D2 + 12 * DMIX + 174
# the flagship's without the magnetic terms: the derivatives of u and lnρ
# only, the pointwise density, hydro and viscosity terms (no Coriolis at
# Ω = 0); its CFL maximum has no Alfvén speed (26 → 16)
HYDRO_RHS = 12 * D1 + 9 * D2 + 6 * DMIX + 115
# with the entropy field and chi-const conduction (K-const off): ∇s and
# the Laplacians of lnρ and s, then pointwise the equation of state (cs²,
# 1/T), the pressure force of ∇s, S², −u·∇s, ∇lnT and the conduction term,
# the viscous heat (70), with Magnetic the Ohmic heat (9), without it 1/ρ
# (2), which the magnetic terms otherwise hold
ENT_TERMS = 3 * D1 + 6 * D2 + 70
ENT_MHD_RHS = FLAGSHIP_RHS + ENT_TERMS + 9
ENT_HYDRO_RHS = HYDRO_RHS + ENT_TERMS + 2
SHOCKBOX_RHS = 24 * D1 + 18 * D2 + 12 * DMIX + 198
# plus del6 of 7 components (21 scaled 6th differences and their sums),
# the hyper-diffusive terms, Coriolis and the shear terms
SHEARBOX_RHS = SHOCKBOX_RHS + 21 * D2 + 14 + 14 + 15 + 22
CONVSLAB_RHS = 15 * D1 + 15 * D2 + 6 * DMIX + 204
OPS = {
    "rhs_first": FLAGSHIP_RHS + 26,
    "rhs_tail_defer": FLAGSHIP_RHS + 7 * (REBUILD + UPD),
    "rhs_tail_last": FLAGSHIP_RHS + 7 * UPD + KICK_OPS,
    "rhs_tail_mid": FLAGSHIP_RHS + 7 * UPD,
    "rhs_tail_defer_last": FLAGSHIP_RHS + 7 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_fake": 7,
    "rhs_tail_defer_fake": 7 * (REBUILD + 1 + UPD),
    "rhs_tail_last_fake": 7 * (1 + UPD) + KICK_OPS,
    "rhs_first_hydro": HYDRO_RHS + 16,
    "rhs_tail_defer_hydro": HYDRO_RHS + 4 * (REBUILD + UPD),
    "rhs_tail_last_hydro": HYDRO_RHS + 4 * UPD + KICK_OPS,
    "rhs_tail_mid_hydro": HYDRO_RHS + 4 * UPD,
    "rhs_tail_defer_last_hydro": HYDRO_RHS + 4 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_ent": ENT_MHD_RHS + 26,
    "rhs_tail_defer_ent": ENT_MHD_RHS + 8 * (REBUILD + UPD),
    "rhs_tail_last_ent": ENT_MHD_RHS + 8 * UPD + KICK_OPS,
    "rhs_tail_mid_ent": ENT_MHD_RHS + 8 * UPD,
    "rhs_tail_defer_last_ent": ENT_MHD_RHS + 8 * (REBUILD + UPD) + KICK_OPS,
    "rhs_first_hydro_ent": ENT_HYDRO_RHS + 16,
    "rhs_tail_defer_hydro_ent": ENT_HYDRO_RHS + 5 * (REBUILD + UPD),
    "rhs_tail_last_hydro_ent": ENT_HYDRO_RHS + 5 * UPD + KICK_OPS,
    "rhs_tail_mid_hydro_ent": ENT_HYDRO_RHS + 5 * UPD,
    "rhs_tail_defer_last_hydro_ent": (ENT_HYDRO_RHS + 5 * (REBUILD + UPD)
                                      + KICK_OPS),
    "rhs_zroll": SHEARBOX_RHS + 35, "rhs_zroll_upd": SHEARBOX_RHS + 7 * UPD,
    "rhs_wrap_shock": SHOCKBOX_RHS + 32,
    "rhs_wrap_shock_upd": SHOCKBOX_RHS + 7 * UPD,
    "rhs_zg": CONVSLAB_RHS + 19, "rhs_zg_upd": CONVSLAB_RHS + 5 * UPD,
}
# the shear-box comparisons start here, where deltay = 0.555·Ly is not a
# whole number of cells (at t = 0 the shifted faces are plain wraps)
T_SHEAR = 0.37


def flagship(pt, shape, itorder=3, dt=0.0):
    """configs.flagship at a 2N-RK order, with a fixed dt when ``dt`` >
    0."""
    return pt.configs.flagship(shape, itorder=itorder, dt=dt)


def forced_hydro(pt, shape, itorder=3, Omega=0.0):
    """configs.forced_hydro at a 2N-RK order."""
    cfg = pt.configs.forced_hydro(shape, Omega=Omega)
    return cfg.replace(time=pt.TimeSpec(itorder=itorder))


def forced_entropy(pt, shape, magnetic=True, itorder=3, Omega=0.0,
                   entropy=None):
    """configs.forced_entropy at a 2N-RK order; ``entropy`` = keyword
    arguments of another Entropy module in place of its chi-const one."""
    cfg = pt.configs.forced_entropy(shape, magnetic=magnetic, Omega=Omega)
    if entropy is not None:
        cfg = cfg.replace(modules=tuple(
            pt.Entropy(**entropy) if m.name == "entropy" else m
            for m in cfg.modules))
    return cfg.replace(time=pt.TimeSpec(itorder=itorder))


def template_cfg(pt, name, shape, itorder=3):
    """The configuration of the phase-3 path ``name`` (TEMPLATE_PATHS)."""
    if name == "flagship":
        return flagship(pt, shape, itorder=itorder)
    if name == "forced hydro":
        return forced_hydro(pt, shape, itorder)
    return forced_entropy(pt, shape, name == "entropy MHD", itorder)


def with_omega(pt, cfg, Omega):
    """cfg with Hydro(Omega=...) in place of its Hydro."""
    return cfg.replace(modules=tuple(
        pt.Hydro(init=m.init, ampl=m.ampl, Omega=Omega) if m.name == "hydro"
        else m for m in cfg.modules))


def random_fa(torch, shape, seed, device, nvar=7):
    """(nvar, *shape) noise: uu, lnrho and the fields after them (aa; ss;
    ss and aa)."""
    g = torch.Generator(device).manual_seed(seed)
    amp = torch.tensor([1e-2] * 3 + [5e-2] + [1e-2] * (nvar - 4),
                       device=device)
    return (amp[:, None, None, None] * torch.randn(
        (nvar,) + shape, generator=g, device=device)).contiguous()


def rel_err(a, b):
    """(max |a−b|, that over max |b|), per field, worst field."""
    worst = (0.0, 0.0)
    for c in range(a.shape[0]):
        d = float((a[c] - b[c]).abs().max())
        r = d / max(float(b[c].abs().max()), 1e-30)
        worst = max(worst, (d, r), key=lambda t: t[1])
    return worst


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def compare_pairs(label, shape, pairs, errs, rtol):
    """Check each (kernel, plain) result pair; pairs: name -> list."""
    line = []
    for name, ps in pairs.items():
        for a, b in ps:
            d, r = rel_err(a, b)
            check(r <= rtol, f"{name} at {shape}: rel err {r}")
            if name in EXACT:
                check(bool((a == b).all()), f"{name} at {shape}: not exact")
            errs[name] = max(errs[name], d)
            line.append(f"{name} {r:.2e}")
    print(f"phase 2 {shape} {label}: kernel vs plain, worst field rel err: "
          + ", ".join(line), flush=True)


def compare_kernels(torch, pt, fr, shape, errs):
    """Phase 2: every kernel against its plain version on CUDA inputs."""
    dev = torch.device("cuda")
    model = pt.Model(flagship(pt, shape), device=dev)
    fa = random_fa(torch, shape, 1, dev)
    alpha, beta, _ = model.rk
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(model, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(model, fa)
    dt = 1.0 / dt1m_p
    c2 = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
    df2, f2 = fr.rhs_tail_defer(model, fa, df1_p, c2)
    df2_p, f2_p = fr.rhs_tail_defer_plain(model, fa, df1_p, c2)
    c3 = torch.stack((model._alpha[2], beta[2] * dt, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    f3k = fr.rhs_tail_last(model, f2_p, df2_p, c3, kick)
    f3k_p = fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, kick)
    f3 = fr.rhs_tail_last(model, f2_p, df2_p, c3, None)
    f3_p = fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, None)
    torch.cuda.synchronize()
    counts = {k: fr.LAUNCHES[k] for k in FLAGSHIP_KERNELS}
    check(counts == {"rhs_first": 1, "rhs_tail_defer": 1,
                     "rhs_tail_last": 2}, f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} max 1/dt rel err {dt_rel}")
    compare_pairs(f"flagship (max 1/dt rel err {dt_rel:.2e})", shape,
                  {"rhs_first": [(df1, df1_p)],
                   "rhs_tail_defer": [(df2, df2_p), (f2, f2_p)],
                   "rhs_tail_last": [(f3k, f3k_p), (f3, f3_p)]},
                  errs, RTOL_FIELD)


def compare_tail_kernels(torch, pt, fr, shape, errs):
    """Phase 2: K3′, K2L (with and without the kick) and K8's three
    variants against their plain versions on CUDA inputs."""
    dev = torch.device("cuda")
    model = pt.Model(flagship(pt, shape), device=dev)
    fa = random_fa(torch, shape, 1, dev)
    df1, dt1m = fr.rhs_first_plain(model, fa)
    _, beta, _ = model.rk
    dt = 1.0 / dt1m
    coef = torch.stack((model._alpha[2], beta[2] * dt, beta[1] * dt))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    fr.reset_launches()
    pairs = {
        "rhs_tail_mid": [
            (a, b) for a, b in zip(fr.rhs_tail_mid(model, fa, df1.clone(),
                                                   coef),
                                   fr.rhs_tail_mid_plain(model, fa,
                                                         df1.clone(), coef))],
        "rhs_tail_defer_last": [
            (fr.rhs_tail_defer_last(model, fa, df1, coef, k),
             fr.rhs_tail_defer_last_plain(model, fa, df1, coef, k))
            for k in (kick, None)],
        "rhs_first_fake": [(fr.rhs_first(model, fa, fake=True)[0],
                            fr.rhs_first_plain(model, fa, fake=True)[0])],
        "rhs_tail_defer_fake": list(zip(
            fr.rhs_tail_defer(model, fa, df1, coef, fake=True),
            fr.rhs_tail_defer_plain(model, fa, df1, coef, fake=True))),
        "rhs_tail_last_fake": [
            (fr.rhs_tail_last(model, fa, df1, coef, kick, fake=True),
             fr.rhs_tail_last_plain(model, fa, df1, coef, kick, fake=True))],
    }
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    check(counts == {"rhs_tail_mid": 1, "rhs_tail_defer_last": 2,
                     "rhs_first_fake": 1, "rhs_tail_defer_fake": 1,
                     "rhs_tail_last_fake": 1}, f"launch counts {counts}")
    compare_pairs("tail kernels and K8", shape, pairs, errs, RTOL_NEW)


def compare_template(torch, pt, fr, label, cfg, errs, rtol=RTOL_NEW):
    """Phase 2: the five instances of the flagship template that ``cfg``'s
    field layout selects (K1, K2, K3 with and without the kick, K3′, K2L
    with and without; or their hydro or entropy builds) against their
    plain versions on CUDA inputs, each field within ``rtol`` × its max."""
    dev = torch.device("cuda")
    model = pt.Model(cfg, device=dev)
    shape = cfg.grid.shape
    sfx = fr.launch_suffix(model)
    fa = random_fa(torch, shape, 1, dev, model.reg.nvar)
    alpha, beta, _ = model.rk
    fr.reset_launches()
    df1, dt1m = fr.rhs_first(model, fa)
    df1_p, dt1m_p = fr.rhs_first_plain(model, fa)
    dt = 1.0 / dt1m_p
    c2 = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
    c3 = torch.stack((model._alpha[2], beta[2] * dt, beta[1] * dt))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                     model.eos)
    df2_p, f2_p = fr.rhs_tail_defer_plain(model, fa, df1_p, c2)
    pairs = {
        "rhs_first": [(df1, df1_p)],
        "rhs_tail_defer": list(zip(fr.rhs_tail_defer(model, fa, df1_p, c2),
                                   (df2_p, f2_p))),
        "rhs_tail_last": [
            (fr.rhs_tail_last(model, f2_p, df2_p, c3, k),
             fr.rhs_tail_last_plain(model, f2_p, df2_p, c3, k))
            for k in (kick, None)],
        "rhs_tail_mid": list(zip(
            fr.rhs_tail_mid(model, f2_p, df2_p.clone(), c3),
            fr.rhs_tail_mid_plain(model, f2_p, df2_p.clone(), c3))),
        "rhs_tail_defer_last": [
            (fr.rhs_tail_defer_last(model, fa, df1_p, c3, k),
             fr.rhs_tail_defer_last_plain(model, fa, df1_p, c3, k))
            for k in (kick, None)],
    }
    torch.cuda.synchronize()
    counts = {k: v for k, v in fr.LAUNCHES.items() if v}
    want = {k + sfx: n for k, n in (("rhs_first", 1), ("rhs_tail_defer", 1),
                                    ("rhs_tail_last", 2), ("rhs_tail_mid", 1),
                                    ("rhs_tail_defer_last", 2))}
    check(counts == want, f"{label} launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} {shape} max 1/dt rel err {dt_rel}")
    compare_pairs(f"{label} (max 1/dt rel err {dt_rel:.2e})", shape,
                  {k + sfx: v for k, v in pairs.items()}, errs, rtol)


def shocked_fa(torch, pm, seed):
    """(8, nx, ny, nz) on the card: a noisy shock-box state at urms ≈ 1 with
    its shock slot built by the pre-pass, so the shock term is live."""
    g = torch.Generator("cuda").manual_seed(seed)
    amp = torch.tensor([3 ** -0.5] * 3 + [5e-2] + [1e-2] * 3 + [0.0],
                       device="cuda")
    fa = amp[:, None, None, None] * torch.randn(
        (8,) + pm.cfg.grid.shape, generator=g, device="cuda")
    return pm._refresh_aux_fa(fa)


def compare_shock_kernels(torch, pt, fr, shape, errs):
    """Phase 2: K1s and K5w against their plain versions on CUDA inputs."""
    pm = pt.Model(pt.configs.shock_box(shape), device="cuda")
    fa = shocked_fa(torch, pm, 1)
    check(float(fa[7].max()) > 0.0, "shock slot not positive")
    fr.reset_launches()
    df, dt1m = fr.rhs_wrap_shock(pm, fa)
    df_p, dt1m_p = fr.rhs_wrap_shock_plain(pm, fa)
    coef = torch.stack((pm._alpha[1], pm.rk[1][1] / dt1m_p))
    fa2 = shocked_fa(torch, pm, 2)
    df2, f2 = fr.rhs_wrap_shock_upd(pm, fa2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_wrap_shock_upd_plain(pm, fa2, df_p.clone(), coef)
    torch.cuda.synchronize()
    counts = {k: fr.LAUNCHES[k] for k in SHOCK_KERNELS}
    check(counts == dict.fromkeys(SHOCK_KERNELS, 1),
          f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} K1s max 1/dt rel err {dt_rel}")
    compare_pairs(f"shock box (max 1/dt rel err {dt_rel:.2e})", shape,
                  {"rhs_wrap_shock": [(df, df_p)],
                   "rhs_wrap_shock_upd": [(df2, df2_p), (f2, f2_p)]},
                  errs, RTOL_NEW)


def stratified_fa(torch, pm, seed):
    """(5, nx, ny, nz) on the card: the piecew-poly lnρ and s with noise,
    and noisy velocities."""
    g = torch.Generator("cuda").manual_seed(seed)
    f = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape

    def noise(sh):
        return 1e-2 * torch.randn(sh, generator=g, device="cuda")

    return torch.cat([noise((3,) + shape), (f["lnrho"] + noise(shape))[None],
                      (f["ss"] + noise(shape))[None]]).contiguous()


def compare_zghost_kernels(torch, pt, fr, shape, errs):
    """Phase 2: K6 and K7 against their plain versions on CUDA inputs."""
    pm = pt.Model(pt.configs.conv_slab(shape), device="cuda")
    fg = pm.ghosted(stratified_fa(torch, pm, 1))
    fr.reset_launches()
    df, dt1m = fr.rhs_zg(pm, fg)
    df_p, dt1m_p = fr.rhs_zg_plain(pm, fg)
    alpha, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    fg2 = pm.ghosted(stratified_fa(torch, pm, 2))
    df2, f2 = fr.rhs_zg_upd(pm, fg2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_zg_upd_plain(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    counts = {k: fr.LAUNCHES[k] for k in ZGHOST_KERNELS}
    check(counts == {"rhs_zg": 1, "rhs_zg_upd": 1},
          f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} K6 max 1/dt rel err {dt_rel}")
    compare_pairs(f"conv-slab (max 1/dt rel err {dt_rel:.2e})", shape,
                  {"rhs_zg": [(df, df_p)],
                   "rhs_zg_upd": [(df2, df2_p), (f2, f2_p)]},
                  errs, RTOL_FIELD)


def compare_steps(torch, pt, label, cfg, nsteps=3, uu_noise=0.0, t0=None):
    """Phase 2b: full steps on the card against the CPU (plain versions),
    same fields and, when forced, the same forcing draws; ``uu_noise`` > 0
    replaces the initial velocity with noise of that amplitude, ``t0``
    the start time."""
    cpu = torch.device("cpu")
    shape = cfg.grid.shape
    fields = dict(pt.Model(cfg, device=cpu).init_state(5)["fields"])
    g = torch.Generator(cpu).manual_seed(9)
    if uu_noise:
        fields["uu"] = uu_noise * torch.randn((3,) + shape, generator=g)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(nsteps)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = pt.Model(cfg, device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        s = model.init_state(5, overrides=fields)
        if t0 is not None:
            s["t"] = torch.full((), t0, device=dev)
        step = model.make_step()
        for _ in range(nsteps):
            s = step(s)
        out[dev] = s
    dt_rel = abs(float(out["cuda"]["dt"]) / float(out["cpu"]["dt"]) - 1.0)
    check(dt_rel <= RTOL_DT, f"{label} step dt rel err {dt_rel}")
    worst = 0.0
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        r = float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        check(r <= RTOL_FIELD, f"{label} step field {k} rel err {r}")
        worst = max(worst, r)
    print(f"phase 2b {shape} {label}: {nsteps} steps on the card vs the "
          f"CPU: worst field rel err {worst:.2e}, dt rel err {dt_rel:.2e}",
          flush=True)


def sheared_fg(torch, pm, seed):
    """(8, nx+6, ny+6, nz) on the card: noisy shear-box fields and a
    positive shock slot, ghosted in x and y with the x faces shifted by
    deltay at t = T_SHEAR."""
    g = torch.Generator("cuda").manual_seed(seed)
    shape = pm.cfg.grid.shape
    amp = torch.tensor([1e-2] * 4 + [1e-4] * 3, device="cuda")
    fa = amp[:, None, None, None] * torch.randn(
        (7,) + shape, generator=g, device="cuda")
    shock = 1e-3 * torch.rand(shape, generator=g, device="cuda")
    sdy = pm.deltay(torch.full((), T_SHEAR, device="cuda"))
    return pm.ghosted(torch.cat([fa, shock[None]]), (0, 1), sdy)


def compare_zroll_kernels(torch, pt, fr, shape, errs):
    """Phase 2: K4 and K5 against their plain versions on CUDA inputs."""
    pm = pt.Model(pt.configs.shear_box(shape), device="cuda")
    fg = sheared_fg(torch, pm, 1)
    fr.reset_launches()
    df, dt1m = fr.rhs_zroll(pm, fg)
    df_p, dt1m_p = fr.rhs_zroll_plain(pm, fg)
    _, beta, _ = pm.rk
    coef = torch.stack((pm._alpha[1], beta[1] / dt1m_p))
    fg2 = sheared_fg(torch, pm, 2)
    df2, f2 = fr.rhs_zroll_upd(pm, fg2, df_p.clone(), coef)
    df2_p, f2_p = fr.rhs_zroll_upd_plain(pm, fg2, df_p.clone(), coef)
    torch.cuda.synchronize()
    counts = {k: fr.LAUNCHES[k] for k in ZROLL_KERNELS}
    check(counts == {"rhs_zroll": 1, "rhs_zroll_upd": 1},
          f"launch counts {counts}")
    dt_rel = abs(float(dt1m) / float(dt1m_p) - 1.0)
    check(dt_rel <= RTOL_DT, f"{shape} K4 max 1/dt rel err {dt_rel}")
    compare_pairs(f"shear box (max 1/dt rel err {dt_rel:.2e})", shape,
                  {"rhs_zroll": [(df, df_p)],
                   "rhs_zroll_upd": [(df2, df2_p), (f2, f2_p)]},
                  errs, RTOL_FIELD)


def time_ms(torch, fn, n):
    """Mean ms of fn() over n calls, by CUDA events after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def urms(torch, fa):
    return float(fa[0:3].pow(2).sum(0).mean().sqrt())


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    # ---- phase 1: device and toolchain --------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"phase 1: device {name}; nvidia-smi: {smi}", flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds}) -> "
          + ", ".join(p.name for p in libs.values()), flush=True)
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")

    # ---- phase 2: kernels against their plain versions ----------------
    errs = dict.fromkeys(KERNEL_NAMES, 0.0)
    for shape in ((64, 64, 64), (32, 64, 128), EDGE_SHAPE):
        compare_template(torch, pt, fr, "forced hydro",
                         forced_hydro(pt, shape), errs)
        compare_template(torch, pt, fr, "flagship with Omega = 1",
                         with_omega(pt, flagship(pt, shape), 1.0), errs)
        for magnetic, label in ((True, "entropy MHD"),
                                (False, "entropy hydro")):
            compare_template(torch, pt, fr, label,
                             forced_entropy(pt, shape, magnetic), errs,
                             RTOL_FIELD)
        compare_template(
            torch, pt, fr, "entropy MHD, K-const and chi-const, Omega = 1",
            forced_entropy(pt, shape, True, Omega=1.0, entropy=dict(
                iheatcond=("chi-const", "K-const"), chi=5e-3, hcond0=4e-3)),
            errs, RTOL_FIELD)
        compare_template(
            torch, pt, fr, "entropy hydro, K-const alone, Omega = 1",
            forced_entropy(pt, shape, False, Omega=1.0, entropy=dict(
                iheatcond=("K-const",), hcond0=4e-3)), errs, RTOL_FIELD)
    for shape in ((64, 64, 64), (32, 64, 128)):
        compare_kernels(torch, pt, fr, shape, errs)
        compare_tail_kernels(torch, pt, fr, shape, errs)
        compare_zghost_kernels(torch, pt, fr, shape, errs)
        compare_zroll_kernels(torch, pt, fr, shape, errs)
        compare_shock_kernels(torch, pt, fr, shape, errs)
    compare_kernels(torch, pt, fr, EDGE_SHAPE, errs)
    compare_tail_kernels(torch, pt, fr, EDGE_SHAPE, errs)
    n32 = (32, 32, 32)
    for order in (3, 2, 4):
        compare_steps(torch, pt, f"flagship rk{order}",
                      flagship(pt, n32, itorder=order))
        compare_steps(torch, pt, f"forced hydro rk{order}",
                      forced_hydro(pt, n32, itorder=order))
        compare_steps(torch, pt, f"entropy MHD rk{order}",
                      forced_entropy(pt, n32, True, order))
        compare_steps(torch, pt, f"entropy hydro rk{order}",
                      forced_entropy(pt, n32, False, order))
    compare_steps(torch, pt, "forced hydro, Omega = 1",
                  forced_hydro(pt, n32, Omega=1.0))
    compare_steps(torch, pt, "flagship, Omega = 1",
                  with_omega(pt, flagship(pt, n32), 1.0))
    compare_steps(torch, pt, "shock box", pt.configs.shock_box(n32),
                  uu_noise=0.1)
    # conv-slab: velocity noise 1e-2, not the configuration's 1e-3, whose
    # velocity after 3 steps is the residual of the O(1) hydrostatic
    # balance and sits below its float32 floor (tests/test_torch_zghost.py,
    # UU_AMPL); the shear box from t = T_SHEAR
    compare_steps(torch, pt, "conv-slab", pt.configs.conv_slab(n32),
                  uu_noise=1e-2)
    compare_steps(torch, pt, "shear box", pt.configs.shear_box(n32),
                  t0=T_SHEAR)
    sb = pt.configs.shear_box(n32)
    compare_steps(torch, pt, "forced shear box",
                  sb.replace(modules=sb.modules + (
                      pt.Forcing(force=0.07, kf=3.0),)), t0=T_SHEAR)

    # ---- phase 3: the main paths at 256³ ------------------------------
    shape = (N_MAIN,) * 3
    launches, timings, bounds = {}, {}, {}
    fl = run_flagship(torch, pt, fr, smi, shape, launches)
    hy = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="forced hydro")
    em = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="entropy MHD")
    eh = run_flagship(torch, pt, fr, smi, shape, launches,
                      name="entropy hydro")
    zg = run_conv_slab(torch, pt, fr, smi, shape, launches)
    sb = run_aux_box(torch, pt, fr, smi, shape, launches, "shear box")
    kb = run_aux_box(torch, pt, fr, smi, shape, launches, "shock box")
    for order in (4, 2):
        for path in TEMPLATE_PATHS:
            run_flagship(torch, pt, fr, smi, shape, launches, itorder=order,
                         name=path)
    run_simulate(torch, pt, fr, smi, shape)
    k8 = run_fake_chain(torch, pt, fr, smi, shape, launches,
                        float(fl[1]["dt"]))

    # ---- phase 4: kernels and the plain chains, timed at 256³ ---------
    time_flagship(torch, fr, smi, fl, errs, timings, bounds)
    time_tails(torch, fr, fl, errs, timings, bounds)
    for path in (hy, em, eh):
        time_flagship(torch, fr, smi, path, errs, timings, bounds)
        time_tails(torch, fr, path, errs, timings, bounds)
    for lib in ("fused_rhs", "fused_rhs_hydro", "fused_rhs_ent",
                "fused_rhs_hydro_ent"):
        for inst, a in fr.flagship_attrs(lib).items():
            print(f"phase 4 {inst} on {smi}: {a['registers']} registers, "
                  f"{a['local_bytes']} B local, shared {a['static_smem']} B "
                  f"static + {a['dynamic_smem']} B dynamic per block, "
                  f"{a['blocks_per_sm']} block(s) per SM", flush=True)
    print(f"phase 4 K8 chain at 256^3 on {smi}: {k8:.4f} ms/step, the "
          f"flagship's kernel chain {fl[2]:.4f} ms/step", flush=True)
    time_conv_slab(torch, fr, smi, zg, errs, timings, bounds)
    time_aux_box(torch, fr, smi, sb, errs, timings, bounds)
    time_aux_box(torch, fr, smi, kb, errs, timings, bounds)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timings[k][0],
         "plain_ms": timings[k][1], "bytes_per_point": bounds[k][0],
         "bound_ms": bounds[k][1], "bound_by": bounds[k][2],
         "library_ms": timings[k][2]}
        for k in KERNEL_NAMES]}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def timed_steps(torch, fr, model, base):
    """The packed state of init_state(0), WARM untimed steps, then TIMED
    steps under the sync debug mode "error", the launch counts set to 0
    just before the timed steps and read just after.  Only the loop holds
    a state, so the peak counts what a step needs.  Returns (urms at the
    start, state, ms/step, peak bytes above ``base``, launches)."""
    state = model.pack_state(model.init_state(0))
    u0 = urms(torch, state["_fa"])
    step = model.make_step()
    for _ in range(WARM):
        state = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    e0.record()
    for _ in range(TIMED):
        state = step(state)
    e1.record()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    return (u0, state, e0.elapsed_time(e1) / TIMED,
            torch.cuda.max_memory_allocated() - base, launches)


def check_launches(label, counts, launches):
    """Exactly the path's kernels, each its number of times per step; the
    JSON line takes each kernel's count from the first path that runs
    it."""
    per_step = PER_STEP[label]
    want = {k: n * TIMED for k, n in per_step.items()}
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{label} launches {got}: need {per_step} per step")
    for k in per_step:
        launches.setdefault(k, counts[k])


def run_flagship(torch, pt, fr, smi, shape, launches, itorder=3,
                 name="flagship"):
    """Phase 3: one of the flagship template's paths (TEMPLATE_PATHS: the
    forced-MHD flagship, forced hydro on the 4-field build, non-isothermal
    turbulence on the 8- and 5-field builds) at a 2N-RK order."""
    label = name if itorder == 3 else f"{name} rk{itorder}"
    cfg = template_cfg(pt, name, shape, itorder)
    base = torch.cuda.memory_allocated()
    model = pt.Model(cfg, device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches(label, counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (model.reg.nvar,) + shape,
          f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    dt = float(state["dt"])
    # the u = 0, B = 0, s = 0 CFL limit: sound speed (cs0 = 1) and the
    # largest diffusive rate (ν = η = 5e-3; with the entropy field χγ =
    # 5e-3 · 5/3)
    tc, gs = cfg.time, cfg.grid
    dxyz2 = sum((1.0 / d) ** 2 for d in (gs.dx, gs.dy, gs.dz))
    ent = cfg.module("entropy")
    diffus = max(5e-3, ent.chi * model.eos.gamma if ent else 0.0)
    dt_est = 1.0 / math.hypot(math.sqrt(dxyz2) / tc.cdt,
                              diffus * dxyz2 / tc.cdtv)
    check(0.5 * dt_est < dt <= dt_est,
          f"dt {dt} not CFL-limited (estimate {dt_est})")
    u1 = urms(torch, fa)
    check(u1 > u0, f"urms did not grow: {u0} -> {u1}")
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(CFL estimate {dt_est:.6e}), urms {u0:.3e} -> {u1:.3e}, "
          f"launches per step {PER_STEP[label]}", flush=True)
    return model, state, ms_step


def run_simulate(torch, pt, fr, smi, shape):
    """Phase 3, through the run loop: simulate(forced_entropy) for 40
    steps with a row every 10 and a checkpoint every 20, every chunk of
    steps under the sync debug mode "error"; then 20 steps, a checkpoint
    and a resumed run of 20 more in a second directory, which must give
    the first run's fields bit for bit."""
    from pencil_tpu_torch import run as prun
    from pencil_tpu_torch.io.timeseries import read_time_series
    columns = ("it", "t", "dt", "urms", "umax", "u2m", "rhom", "rhomin",
               "rhomax", "ssm", "TTm", "csm", "ethm", "brms", "bmax", "b2m",
               "jrms", "jmax", "abm")
    cfg = pt.configs.forced_entropy(shape)
    params = prun.RunParams(it1=10, isave=20, print_columns=columns)
    advance = prun.Run._advance

    def guarded(self, state, k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return advance(self, state, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    prun.Run._advance = guarded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fr.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                whole = prun.simulate(cfg, nt=40, datadir=tmp, params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in fr.LAUNCHES.items() if v}
            print(out.getvalue(), end="", flush=True)
            check(counts == dict.fromkeys(ENT_KERNELS[:3], 40),
                  f"simulate launches {counts}")
            rows = read_time_series(os.path.join(tmp, "time_series.dat"))
            check(list(rows) == list(columns), f"columns {list(rows)}")
            its = [int(v) for v in rows["it"]]
            check(its == [0, 1, 10, 20, 30, 40], f"rows {its}")
            check(all(math.isfinite(v) for vs in rows.values() for v in vs),
                  "non-finite value in time_series.dat")
            check(rows["urms"][-1] > rows["urms"][0]
                  and rows["ssm"][-1] > rows["ssm"][0],
                  "urms and the mean entropy must grow")
            check(os.path.exists(os.path.join(tmp, "COMPLETED")),
                  "no COMPLETED")
            line = [ln for ln in out.getvalue().splitlines()
                    if ln.startswith("Wall clock time/timestep/meshpoint")]
            check(len(line) == 1, "no wall-clock line")
            us = float(line[0].split("=")[1])
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(io.StringIO()):
                prun.simulate(cfg, nt=20, datadir=tmp, params=params)
                again = prun.simulate(cfg, nt=20, datadir=tmp, params=params,
                                      resume=True)
            rows2 = read_time_series(os.path.join(tmp, "time_series.dat"))
    finally:
        prun.Run._advance = advance
    its2 = [int(v) for v in rows2["it"]]
    check(int(again["it"]) == 40 and its2 == [0, 1, 10, 20, 21, 30, 40],
          f"resumed run: it {int(again['it'])}, rows {its2}")
    for k, v in whole["fields"].items():
        check(v.is_cuda and torch.equal(again["fields"][k], v),
              f"restart: field {k} differs")
    check(torch.equal(again["t"], whole["t"]), "restart: t differs")
    print(f"phase 3 {N_MAIN}^3 simulate(forced_entropy, nt=40, it1=10, "
          f"isave=20) on {smi}: wall clock {us:.4e} microsec per step and "
          f"meshpoint ({wall:.2f} s with the model's set-up), rows "
          f"{its}, COMPLETED, launches {counts}; 20 steps + resume "
          f"from var.npz + 20 steps: the same fields bit for bit",
          flush=True)


def run_fake_chain(torch, pt, fr, smi, shape, launches, dt):
    """Phase 3: the K8 chain, the flagship's loads and stores with the
    RHS replaced by f·1.0000001, at the flagship's final dt (the fake K1
    reports no CFL rate).  Returns its ms/step."""
    base = torch.cuda.memory_allocated()
    model = pt.Model(flagship(pt, shape, dt=dt), device="cuda",
                     fake_rhs=True)
    _, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches("K8 chain", counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (7,) + shape, f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    print(f"phase 3 {N_MAIN}^3 K8 chain on {smi}: {ms_step:.4f} ms/step, "
          f"peak {peak / 2**30:.3f} GiB, fixed dt {dt:.6e}, launches per "
          f"step {PER_STEP['K8 chain']}", flush=True)
    return ms_step


def run_conv_slab(torch, pt, fr, smi, shape, launches):
    """Phase 3, second path: stratified convection, non-periodic z."""
    base = torch.cuda.memory_allocated()
    model = pt.Model(pt.configs.conv_slab(shape), device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches("conv-slab", counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (5,) + shape, f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    check(bool((fa[2][:, :, [0, -1]] == 0).all()), "uz not 0 on the walls")
    dt = float(state["dt"])
    # CFL bounds on the dt that the final state sets (one more step, out
    # of the timed window): 1/dt = max over points of the root sum of the
    # advective and diffusive rates, so it lies between the larger of
    # their maxima and the root sum of their maxima
    dt_next = float(model.make_step()(state)["dt"])
    cfg, eos, ent = model.cfg, model.eos, model.cfg.module("entropy")
    tc, gs = cfg.time, cfg.grid
    dxyz2 = sum((1.0 / d) ** 2 for d in (gs.dx, gs.dy, gs.dz))
    lnrho, ss = fa[3], fa[4]
    cs2 = eos.cs20 * torch.exp(eos.gamma / eos.cp * ss
                               + (eos.gamma - 1.0) * (lnrho - eos.lnrho0))
    umax = sum(fa[a].abs().max() * (1.0 / d)
               for a, d in enumerate((gs.dx, gs.dy, gs.dz)))
    adv = float((umax + torch.sqrt(cs2.max() * dxyz2)) / tc.cdt)
    chi = ent.hcond0 * float(torch.exp(-lnrho).max()) / eos.cp * eos.gamma
    dif = max(cfg.module("viscosity").nu, chi) * dxyz2 / tc.cdtv
    check(1.0 / math.hypot(adv, dif) * (1 - 1e-5) <= dt_next
          <= 1.0 / max(adv, dif) * (1 + 1e-5),
          f"dt {dt_next} outside the CFL bounds ({adv}, {dif})")
    u1 = urms(torch, fa)
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 conv-slab on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(advective 1/dt {adv:.4e}, diffusive {dif:.4e}), "
          f"urms {u0:.3e} -> {u1:.3e}, launches "
          f"{ {k: counts[k] for k in ZGHOST_KERNELS} }", flush=True)
    return model, state, ms_step


def run_aux_box(torch, pt, fr, smi, shape, launches, label):
    """Phase 3: the sheared, rotating MHD box or the shocked periodic box,
    the two paths with a shock slot."""
    from pencil_tpu_torch.physics.pencils import Pencils
    make_cfg = (pt.configs.shear_box if label == "shear box"
                else pt.configs.shock_box)
    base = torch.cuda.memory_allocated()
    model = pt.Model(make_cfg(shape), device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check_launches(label, counts, launches)
    fa = state["_fa"]
    check(tuple(fa.shape) == (8,) + shape, f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    dt = float(state["dt"])
    # CFL bounds on the dt that the final state sets (one more step, out
    # of the timed window).  1/dt is the max over points of the root sum
    # of the advective and diffusive rates: at an x face, where |S·x| is
    # largest, both are at least their u = B = 0, shock = 0 values; no
    # point exceeds the sums of the fields' maxima
    dt_next = float(model.make_step()(state)["dt"])
    cfg, eos = model.cfg, model.eos
    tc, gs = cfg.time, cfg.grid
    inv = [1.0 / d for d in (gs.dx, gs.dy, gs.dz)]
    dxyz2 = sum(i * i for i in inv)
    dxyz6 = sum(i ** 6 for i in inv)
    sdy = model.deltay(state["t"])
    fg = model.ghosted(model._refresh_aux_fa(fa, sdy), shear_dy=sdy)
    pen = Pencils(fg, model.grid, model.reg, cfg, eos, ghosted=True)
    bb = pen.bb()
    va2 = float((sum((bb[a] * inv[a]) ** 2 for a in range(3))
                 * pen.rho1()).max())
    shock = float(pen.field("shock").max())
    del fg, pen, bb
    vis, mag = cfg.module("viscosity"), cfg.module("magnetic")
    nu, nu_shock, nu3 = vis.coefficients()
    shear = cfg.module("shear")
    shear_rate = (abs(shear.S) * float(model.grid.x.abs().max())
                  if shear else 0.0)
    sound = math.sqrt(eos.cs20 * dxyz2)
    umax = sum(float(fa[a].abs().max()) * inv[a] for a in range(3))
    adv_lo = (shear_rate * inv[1] + sound) / tc.cdt
    adv_hi = (umax + shear_rate * inv[1]
              + math.sqrt(eos.cs20 * dxyz2 + va2)) / tc.cdt
    dif3 = max(nu3, mag.eta_hyper3,
               cfg.module("density").diffrho_hyper3) * dxyz6 / tc.cdtv3
    dif_lo = max(nu, mag.eta) * dxyz2 / tc.cdtv + dif3
    dif_hi = max(nu, mag.eta, nu_shock * shock) * dxyz2 / tc.cdtv + dif3
    check(1.0 / math.hypot(adv_hi, dif_hi) * (1 - 1e-5) <= dt_next
          <= 1.0 / math.hypot(adv_lo, dif_lo) * (1 + 1e-5),
          f"{label} dt {dt_next} outside the CFL bounds ({adv_lo}-{adv_hi}, "
          f"{dif_lo}-{dif_hi})")
    u1 = urms(torch, fa)
    if model.forcing is not None:
        check(u1 > u0, f"{label} urms did not grow: {u0} -> {u1}")
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 {label} on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(1/dt bounds: advective {adv_lo:.4e}-{adv_hi:.4e}, diffusive "
          f"{dif_lo:.4e}-{dif_hi:.4e}), max shock {shock:.3e}, urms "
          f"{u0:.3e} -> {u1:.3e}, launches per step {PER_STEP[label]}",
          flush=True)
    return label, model, state, ms_step


def time_pairs(torch, kname, kern, plain, errs, timings, bounds, inputs,
               fresh=None, library=None):
    """Check one kernel against its plain version, then time both, and
    set its bound from the bytes of ``inputs`` and of its outputs (each
    read or written once) and its operations (OPS) at 256³.  ``fresh``
    gives the (kernel, plain) calls of the check when the timed calls
    update their input in place; ``library`` is one PyTorch call that
    computes the same function, timed as a yardstick where there is
    one."""
    ck, cp = fresh or (kern, plain)
    got, want = ck(), cp()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.ndim == 0:
            r = 0.0 if float(a) == float(b) else abs(float(a) / float(b) - 1)
            check(r <= RTOL_DT, f"{kname} at 256^3: dt rel err {r}")
            continue
        d, r = rel_err(a, b)
        check(r <= RTOL_FIELD, f"{kname} at 256^3: rel err {r}")
        if kname in EXACT:
            check(bool((a == b).all()), f"{kname} at 256^3: not exact")
        errs[kname] = max(errs[kname], d)
    npts = N_MAIN ** 3
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *got)
                 if t is not None)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = OPS[kname] * npts / PEAK_F32_S * 1e3
    bounds[kname] = (nbytes / npts, max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    del got, want
    timings[kname] = (time_ms(torch, kern, 20), time_ms(torch, plain, 3),
                      library and time_ms(torch, library, 20))
    print(f"phase 4 {kname} at 256^3: kernel {timings[kname][0]:.4f} ms,"
          f" plain {timings[kname][1]:.4f} ms, library call "
          f"{timings[kname][2] and round(timings[kname][2], 4)} ms, bound "
          f"{bounds[kname][1]:.4f} ms ({bounds[kname][2]}: "
          f"{bounds[kname][0]:.2f} B and {OPS[kname]} operations per point)",
          flush=True)


def time_flagship(torch, fr, smi, fl, errs, timings, bounds):
    """K1-K3, or K1h-K3h, checked and timed on the main path's final
    state, and the plain chain's step."""
    model, state, ms_step = fl
    sfx = fr.launch_suffix(model)
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    zc = model.grid.z
    df1, _ = fr.rhs_first_plain(model, fa)
    df2, f2 = fr.rhs_tail_defer_plain(model, fa, df1, c2)
    calls = {
        "rhs_first": (lambda: fr.rhs_first(model, fa),
                      lambda: fr.rhs_first_plain(model, fa), [fa]),
        "rhs_tail_defer": (lambda: fr.rhs_tail_defer(model, fa, df1, c2),
                           lambda: fr.rhs_tail_defer_plain(model, fa, df1, c2),
                           [fa, df1, c2]),
        "rhs_tail_last": (
            lambda: fr.rhs_tail_last(model, f2, df2, c3, kick),
            lambda: fr.rhs_tail_last_plain(model, f2, df2, c3, kick),
            [f2, df2, c3, kick, zc]),
    }
    for kname, (kern, plain, inputs) in calls.items():
        time_pairs(torch, kname + sfx, kern, plain, errs, timings, bounds,
                   inputs)
    del df1, df2, f2
    plain_chain = (fr.rhs_first_plain, fr.rhs_tail_defer_plain,
                   fr.rhs_tail_mid_plain, fr.rhs_tail_last_plain,
                   fr.rhs_tail_defer_last_plain)
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(
        torch, lambda: model._fused_step(plain_state, plain_chain), 3)
    name = {v: k for k, v in TEMPLATE_PATHS.items()}[sfx]
    print(f"phase 4 {name} plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step)", flush=True)


def time_tails(torch, fr, fl, errs, timings, bounds):
    """K3′, K2L and K8's three variants (K3′h and K2Lh) checked and timed
    on the flagship's (forced hydro's) final state."""
    model, state, _ = fl
    sfx = fr.launch_suffix(model)
    fa = state["_fa"]
    _, beta, _ = model.rk
    dt_t = state["dt"]
    coef = torch.stack((model._alpha[2], beta[2] * dt_t, beta[1] * dt_t))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    zc = model.grid.z
    df1, _ = fr.rhs_first_plain(model, fa)
    # K3′ writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, "rhs_tail_mid" + sfx,
        lambda: fr.rhs_tail_mid(model, fa, scratch, coef),
        lambda: fr.rhs_tail_mid_plain(model, fa, scratch, coef), errs,
        timings, bounds, [fa, df1, coef],
        fresh=(lambda: fr.rhs_tail_mid(model, fa, df1.clone(), coef),
               lambda: fr.rhs_tail_mid_plain(model, fa, df1.clone(), coef)))
    del scratch
    calls = {
        "rhs_tail_defer_last": (
            lambda: fr.rhs_tail_defer_last(model, fa, df1, coef, kick),
            lambda: fr.rhs_tail_defer_last_plain(model, fa, df1, coef, kick),
            [fa, df1, coef, kick, zc]),
        "rhs_first_fake": (
            lambda: fr.rhs_first(model, fa, fake=True),
            lambda: fr.rhs_first_plain(model, fa, fake=True), [fa],
            # its function, f·1.0000001, is one PyTorch call
            lambda: torch.mul(fa, fr.FAKE_FACTOR)),
        "rhs_tail_defer_fake": (
            lambda: fr.rhs_tail_defer(model, fa, df1, coef, fake=True),
            lambda: fr.rhs_tail_defer_plain(model, fa, df1, coef, fake=True),
            [fa, df1, coef]),
        "rhs_tail_last_fake": (
            lambda: fr.rhs_tail_last(model, fa, df1, coef, kick, fake=True),
            lambda: fr.rhs_tail_last_plain(model, fa, df1, coef, kick,
                                           fake=True),
            [fa, df1, coef, kick, zc]),
    }
    if sfx:      # K8 is built for the isothermal MHD layout only
        calls = {"rhs_tail_defer_last" + sfx: calls["rhs_tail_defer_last"]}
    for kname, (kern, plain, inputs, *library) in calls.items():
        time_pairs(torch, kname, kern, plain, errs, timings, bounds, inputs,
                   library=library[0] if library else None)


def time_conv_slab(torch, fr, smi, zg, errs, timings, bounds):
    """K6/K7 checked and timed on the stratified noisy input of phase 2 at
    256³, not on the main path's state: there uz's tendency is the small
    residual of the O(1) pressure and gravity forces, and the f32 rounding
    of those forces alone reaches 2e-5 of its max."""
    model, state, ms_step = zg
    fa = state["_fa"]
    fg = model.ghosted(stratified_fa(torch, model, 3))
    _, beta, _ = model.rk
    df1, dt1m = fr.rhs_zg_plain(model, fg)
    coef = torch.stack((model._alpha[1], beta[1] / dt1m))
    _, prof_c, prof_h = fr.zg_params(model)
    time_pairs(torch, "rhs_zg", lambda: fr.rhs_zg(model, fg),
               lambda: fr.rhs_zg_plain(model, fg), errs, timings, bounds,
               [fg, prof_c, prof_h])
    # K7 writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, "rhs_zg_upd", lambda: fr.rhs_zg_upd(model, fg, scratch, coef),
        lambda: fr.rhs_zg_upd_plain(model, fg, scratch, coef), errs, timings,
        bounds, [fg, prof_c, prof_h, df1, coef],
        fresh=(lambda: fr.rhs_zg_upd(model, fg, df1.clone(), coef),
               lambda: fr.rhs_zg_upd_plain(model, fg, df1.clone(), coef)))
    del df1, scratch, fg
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(torch, lambda: model._zghost_step(
        plain_state, (fr.rhs_zg_plain, fr.rhs_zg_upd_plain)), 3)
    ghost_ms = time_ms(torch, lambda: model.ghosted(fa), 20)
    print(f"phase 4 conv-slab plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step); one fill_ghosts "
          f"{ghost_ms:.4f} ms", flush=True)


def time_aux_box(torch, fr, smi, box, errs, timings, bounds):
    """K4/K5 (shear box) or K1s/K5w (shock box) checked and timed on the
    main path's final state, its shock slot rebuilt (and, for K4/K5, its
    x/y ghosts filled) as a step does."""
    label, model, state, ms_step = box
    fa = state["_fa"]
    if label == "shear box":
        names = ZROLL_KERNELS
        first, upd = fr.rhs_zroll, fr.rhs_zroll_upd
        first_p, upd_p = fr.rhs_zroll_plain, fr.rhs_zroll_upd_plain
        sdy = model.deltay(state["t"])
        fg = model.ghosted(model._refresh_aux_fa(fa, sdy), (0, 1), sdy)
    else:
        names = SHOCK_KERNELS
        first, upd = fr.rhs_wrap_shock, fr.rhs_wrap_shock_upd
        first_p, upd_p = fr.rhs_wrap_shock_plain, fr.rhs_wrap_shock_upd_plain
        sdy = None
        fg = model._refresh_aux_fa(fa)
    _, beta, _ = model.rk
    df1, dt1m = first_p(model, fg)
    coef = torch.stack((model._alpha[1], beta[1] / dt1m))
    time_pairs(torch, names[0], lambda: first(model, fg),
               lambda: first_p(model, fg), errs, timings, bounds, [fg])
    # K5/K5w write the new df over df_prev: checked on fresh copies of
    # df1, timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, names[1], lambda: upd(model, fg, scratch, coef),
        lambda: upd_p(model, fg, scratch, coef), errs, timings, bounds,
        [fg, df1, coef],
        fresh=(lambda: upd(model, fg, df1.clone(), coef),
               lambda: upd_p(model, fg, df1.clone(), coef)))
    del df1, scratch, fg
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(torch, lambda: model._aux_step(
        plain_state, (first_p, upd_p)), 3)
    from pencil_tpu_torch.physics.pencils import Pencils
    aux_ms = time_ms(torch, lambda: model._refresh_aux_fa(fa, sdy), 20)
    # the pre-pass's two largest parts: its full ghost fill and ∇·u
    fill3_ms = time_ms(torch, lambda: model.ghosted(fa, shear_dy=sdy), 20)
    fg = model.ghosted(fa, shear_dy=sdy)
    divu_ms = time_ms(torch, lambda: Pencils(
        fg, model.grid, model.reg, model.cfg, model.eos,
        ghosted=True).divu(), 20)
    del fg
    line = (f"phase 4 {label} plain chain at 256^3 on {smi}: "
            f"{plain_ms:.4f} ms/step (kernel chain {ms_step:.4f} ms/step); "
            f"one shock pre-pass {aux_ms:.4f} ms, of which its 8-slot "
            f"ghost fill {fill3_ms:.4f} ms and the divergence "
            f"{divu_ms:.4f} ms")
    if sdy is not None:
        fill_ms = time_ms(torch, lambda: model.ghosted(fa, (0, 1), sdy), 20)
        line += f", one x/y fill with shifted faces {fill_ms:.4f} ms"
    print(line, flush=True)


if __name__ == "__main__":
    sys.exit(main())
