#!/usr/bin/env python3
"""Drive the pencil_tpu_torch main paths on one NVIDIA GPU: the forced-MHD
flagship step (kernels K1-K3), stratified convection with a non-periodic z
(kernels K6, K7) and the sheared, rotating MHD box with shock viscosity
and hyper-diffusion (kernels K4, K5).

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and toolchain: the card, its power limit, nvcc, the kernel
     build (one nvcc per csrc/*.cu, all at once);
  2. each fused kernel against its plain PyTorch version on the same CUDA
     inputs at 64³ and 32×64×128 (each field within 2e-5 × its max, the
     CFL maximum within 1e-6 relative; the shear-box input at t = 0.37
     with a positive shock slot), and three full steps of each path on
     the card against the same steps on the CPU at 32³;
  3. the main paths at 256³ through Model(cfg, device="cuda"),
     init_state(0) and make_step(), 3 warm-up and 20 timed steps under
     torch.cuda.set_sync_debug_mode("error"), the launch counts set to 0
     just before each path's timed steps and read just after: the
     flagship with exactly one launch of K1, K2, K3 per step, the
     conv-slab layer with exactly one K6 and two K7 launches per step,
     then the shear box with exactly one K4 and two K5 launches per step;
  4. each kernel's time against its plain version, and each plain chain's
     step time, at 256³.
The line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the exit code is then not 0.  Without a CUDA device the script
exits 1 and prints no result.  It imports no JAX.
"""
import json
import math
import subprocess
import sys
import time

N_MAIN = 256
WARM, TIMED = 3, 20
RTOL_FIELD, RTOL_DT = 2e-5, 1e-6
FLAGSHIP_KERNELS = ("rhs_first", "rhs_tail_defer", "rhs_tail_last")
ZROLL_KERNELS = ("rhs_zroll", "rhs_zroll_upd")
ZGHOST_KERNELS = ("rhs_zg", "rhs_zg_upd")
KERNEL_NAMES = FLAGSHIP_KERNELS + ZROLL_KERNELS + ZGHOST_KERNELS
# launches of each zghost and zroll kernel in one step
ZGHOST_PER_STEP = {"rhs_zg": 1, "rhs_zg_upd": 2}
ZROLL_PER_STEP = {"rhs_zroll": 1, "rhs_zroll_upd": 2}
REPLACES = {
    "rhs_first": "pencil_tpu/ops/fused_rhs.py:306",
    "rhs_tail_defer": "pencil_tpu/ops/fused_rhs.py:379",
    "rhs_tail_last": "pencil_tpu/ops/fused_rhs.py:379",
    "rhs_zroll": "pencil_tpu/ops/fused_rhs.py:306",
    "rhs_zroll_upd": "pencil_tpu/ops/fused_rhs.py:331",
    "rhs_zg": "pencil_tpu/ops/fused_rhs.py:317",
    "rhs_zg_upd": "pencil_tpu/ops/fused_rhs.py:349",
}
SOURCES = {k: "pencil_tpu_torch/csrc/fused_rhs.cu" for k in FLAGSHIP_KERNELS}
SOURCES.update({k: "pencil_tpu_torch/csrc/zroll_rhs.cu"
                for k in ZROLL_KERNELS})
SOURCES.update({k: "pencil_tpu_torch/csrc/zghost_rhs.cu"
                for k in ZGHOST_KERNELS})
# the shear-box comparisons start here, where deltay = 0.555·Ly is not a
# whole number of cells (at t = 0 the shifted faces are plain wraps)
T_SHEAR = 0.37


def flagship(pt, shape, fused=True):
    """__graft_entry__._flagship_cfg, for the port."""
    return pt.Config(
        grid=pt.GridSpec(nx=shape[0], ny=shape[1], nz=shape[2]),
        time=pt.TimeSpec(itorder=3), fused=fused,
        modules=(pt.EosIdealGas(gamma=1.0, cs0=1.0),
                 pt.Density(lupw_lnrho=False),
                 pt.Hydro(init="gaussian-noise", ampl=1e-3),
                 pt.Viscosity(ivisc=("nu-const",), nu=5e-3),
                 pt.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pt.Forcing(force=0.07, kf=3.0)))


def random_fa(torch, shape, seed, device):
    g = torch.Generator(device).manual_seed(seed)
    amp = torch.tensor([1e-2] * 3 + [5e-2] + [1e-2] * 3, device=device)
    return (amp[:, None, None, None]
            * torch.randn((7,) + shape, generator=g, device=device)).contiguous()


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
    pairs = {"rhs_first": [(df1, df1_p)],
             "rhs_tail_defer": [(df2, df2_p), (f2, f2_p)],
             "rhs_tail_last": [(f3k, f3k_p), (f3, f3_p)]}
    line = []
    for name, ps in pairs.items():
        for a, b in ps:
            d, r = rel_err(a, b)
            check(r <= RTOL_FIELD, f"{name} at {shape}: rel err {r}")
            errs[name] = max(errs[name], d)
            line.append(f"{name} {r:.2e}")
    print(f"phase 2 {shape}: kernel vs plain, worst field rel err: "
          + ", ".join(line) + f"; max 1/dt rel err {dt_rel:.2e}", flush=True)


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
    line = []
    for name, a, b in (("rhs_zg", df, df_p), ("rhs_zg_upd", df2, df2_p),
                       ("rhs_zg_upd", f2, f2_p)):
        d, r = rel_err(a, b)
        check(r <= RTOL_FIELD, f"{name} at {shape}: rel err {r}")
        errs[name] = max(errs[name], d)
        line.append(f"{name} {r:.2e}")
    print(f"phase 2 {shape} conv-slab: kernel vs plain, worst field rel err: "
          + ", ".join(line) + f"; max 1/dt rel err {dt_rel:.2e}", flush=True)


def compare_zghost_steps(torch, pt, shape=(32, 32, 32), nsteps=3):
    """Phase 2b: conv-slab steps on the card against the CPU.  The
    velocity noise is 1e-2, not the configuration's 1e-3, whose velocity
    after 3 steps is the residual of the O(1) hydrostatic balance and
    sits below its float32 floor (tests/test_torch_zghost.py, UU_AMPL)."""
    fields = dict(pt.Model(pt.configs.conv_slab(shape)).init_state(
        5)["fields"])
    g = torch.Generator().manual_seed(5)
    fields["uu"] = 1e-2 * torch.randn((3,) + shape, generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        model = pt.Model(pt.configs.conv_slab(shape), device=dev)
        out[dev] = model.make_multi_step(nsteps)(
            model.init_state(5, overrides=fields))
    dt_rel = abs(float(out["cuda"]["dt"]) / float(out["cpu"]["dt"]) - 1.0)
    check(dt_rel <= RTOL_DT, f"conv-slab step dt rel err {dt_rel}")
    worst = 0.0
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        r = float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        check(r <= RTOL_FIELD, f"conv-slab step field {k} rel err {r}")
        worst = max(worst, r)
    print(f"phase 2b {shape} conv-slab: {nsteps} steps on the card vs the "
          f"CPU: worst field rel err {worst:.2e}, dt rel err {dt_rel:.2e}",
          flush=True)


def compare_steps(torch, pt, shape=(32, 32, 32), nsteps=3):
    """Phase 2b: full steps on the card against the CPU (plain versions),
    same fields and the same forcing draws."""
    cpu = torch.device("cpu")
    fields = {k: v for k, v in pt.Model(flagship(pt, shape)).init_state(
        5)["fields"].items()}
    g = torch.Generator(cpu).manual_seed(9)
    draws = [(torch.randint(0, 20, (1,), generator=g),
              torch.rand((), generator=g) * 6.0 - 3.0,
              torch.randn(3, generator=g)) for _ in range(nsteps)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = pt.Model(flagship(pt, shape), device=dev)
        it = iter([tuple(t.to(dev) for t in d) for d in draws])
        model.forcing_draws = it.__next__
        s = model.init_state(5, overrides=fields)
        step = model.make_step()
        for _ in range(nsteps):
            s = step(s)
        out[dev] = s
    dt_rel = abs(float(out["cuda"]["dt"]) / float(out["cpu"]["dt"]) - 1.0)
    check(dt_rel <= RTOL_DT, f"step dt rel err {dt_rel}")
    worst = 0.0
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        r = float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        check(r <= RTOL_FIELD, f"step field {k} rel err {r}")
        worst = max(worst, r)
    print(f"phase 2b {shape}: {nsteps} steps on the card vs the CPU: worst "
          f"field rel err {worst:.2e}, dt rel err {dt_rel:.2e}", flush=True)


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
    line = []
    for name, a, b in (("rhs_zroll", df, df_p), ("rhs_zroll_upd", df2, df2_p),
                       ("rhs_zroll_upd", f2, f2_p)):
        d, r = rel_err(a, b)
        check(r <= RTOL_FIELD, f"{name} at {shape}: rel err {r}")
        errs[name] = max(errs[name], d)
        line.append(f"{name} {r:.2e}")
    print(f"phase 2 {shape} shear box: kernel vs plain, worst field rel err: "
          + ", ".join(line) + f"; max 1/dt rel err {dt_rel:.2e}", flush=True)


def compare_zroll_steps(torch, pt, shape=(32, 32, 32), nsteps=3):
    """Phase 2b: shear-box steps on the card against the CPU, from
    t = T_SHEAR."""
    fields = pt.Model(pt.configs.shear_box(shape)).init_state(5)["fields"]
    out = {}
    for dev in ("cuda", "cpu"):
        model = pt.Model(pt.configs.shear_box(shape), device=dev)
        s = model.init_state(5, overrides=fields)
        s["t"] = torch.full((), T_SHEAR, device=dev)
        out[dev] = model.make_multi_step(nsteps)(s)
    dt_rel = abs(float(out["cuda"]["dt"]) / float(out["cpu"]["dt"]) - 1.0)
    check(dt_rel <= RTOL_DT, f"shear-box step dt rel err {dt_rel}")
    worst = 0.0
    for k, ref in out["cpu"]["fields"].items():
        a = out["cuda"]["fields"][k].cpu()
        r = float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        check(r <= RTOL_FIELD, f"shear-box step field {k} rel err {r}")
        worst = max(worst, r)
    print(f"phase 2b {shape} shear box: {nsteps} steps on the card vs the "
          f"CPU: worst field rel err {worst:.2e}, dt rel err {dt_rel:.2e}",
          flush=True)


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
    for shape in ((64, 64, 64), (32, 64, 128)):
        compare_kernels(torch, pt, fr, shape, errs)
        compare_zghost_kernels(torch, pt, fr, shape, errs)
        compare_zroll_kernels(torch, pt, fr, shape, errs)
    compare_steps(torch, pt)
    compare_zghost_steps(torch, pt)
    compare_zroll_steps(torch, pt)

    # ---- phase 3: the main paths at 256³ ------------------------------
    shape = (N_MAIN,) * 3
    launches, timings = {}, {}
    fl = run_flagship(torch, pt, fr, smi, shape, launches)
    zg = run_conv_slab(torch, pt, fr, smi, shape, launches)
    sb = run_shear_box(torch, pt, fr, smi, shape, launches)

    # ---- phase 4: kernels and the plain chains, timed at 256³ ---------
    time_flagship(torch, fr, smi, fl, errs, timings)
    time_conv_slab(torch, fr, smi, zg, errs, timings)
    time_shear_box(torch, fr, smi, sb, errs, timings)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timings[k][0],
         "plain_ms": timings[k][1]}
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


def run_flagship(torch, pt, fr, smi, shape, launches):
    """Phase 3, first path: the forced-MHD flagship."""
    cfg = flagship(pt, shape)
    base = torch.cuda.memory_allocated()
    model = pt.Model(cfg, device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    check(counts == dict(dict.fromkeys(KERNEL_NAMES, 0),
                         **dict.fromkeys(FLAGSHIP_KERNELS, TIMED)),
          f"launches {counts}: need exactly one of K1-K3 per step")
    launches.update({k: counts[k] for k in FLAGSHIP_KERNELS})
    fa = state["_fa"]
    check(tuple(fa.shape) == (7,) + shape, f"state shape {tuple(fa.shape)}")
    check(bool(torch.isfinite(fa).all()), "non-finite field")
    dt = float(state["dt"])
    # the u = 0, B = 0 CFL limit: sound speed and the viscous/resistive rate
    tc, gs = cfg.time, cfg.grid
    dxyz2 = sum((1.0 / d) ** 2 for d in (gs.dx, gs.dy, gs.dz))
    dt_est = 1.0 / math.hypot(math.sqrt(dxyz2) / tc.cdt,
                              5e-3 * dxyz2 / tc.cdtv)
    check(0.5 * dt_est < dt <= dt_est,
          f"dt {dt} not CFL-limited (estimate {dt_est})")
    u1 = urms(torch, fa)
    check(u1 > u0, f"urms did not grow: {u0} -> {u1}")
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 flagship on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(CFL estimate {dt_est:.6e}), urms {u0:.3e} -> {u1:.3e}, "
          f"launches {launches}", flush=True)
    return model, state, ms_step


def run_conv_slab(torch, pt, fr, smi, shape, launches):
    """Phase 3, second path: stratified convection, non-periodic z."""
    base = torch.cuda.memory_allocated()
    model = pt.Model(pt.configs.conv_slab(shape), device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    want = dict(dict.fromkeys(KERNEL_NAMES, 0),
                **{k: n * TIMED for k, n in ZGHOST_PER_STEP.items()})
    check(counts == want, f"launches {counts}: need one K6 and two K7 "
          "launches per step")
    launches.update({k: counts[k] for k in ZGHOST_KERNELS})
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


def run_shear_box(torch, pt, fr, smi, shape, launches):
    """Phase 3, third path: the sheared, rotating MHD box."""
    from pencil_tpu_torch.physics.pencils import Pencils
    base = torch.cuda.memory_allocated()
    model = pt.Model(pt.configs.shear_box(shape), device="cuda")
    u0, state, ms_step, peak, counts = timed_steps(torch, fr, model, base)
    want = dict(dict.fromkeys(KERNEL_NAMES, 0),
                **{k: n * TIMED for k, n in ZROLL_PER_STEP.items()})
    check(counts == want, f"launches {counts}: need one K4 and two K5 "
          "launches per step")
    launches.update({k: counts[k] for k in ZROLL_KERNELS})
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
    shear_rate = abs(cfg.module("shear").S) * float(model.grid.x.abs().max())
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
          f"dt {dt_next} outside the CFL bounds ({adv_lo}-{adv_hi}, "
          f"{dif_lo}-{dif_hi})")
    u1 = urms(torch, fa)
    ups = shape[0] * shape[1] * shape[2] / (ms_step * 1e-3)
    print(f"phase 3 {N_MAIN}^3 shear box on {smi}: {ms_step:.4f} ms/step, "
          f"{ups:.4e} updates/s, peak {peak / 2**30:.3f} GiB, dt {dt:.6e} "
          f"(1/dt bounds: advective {adv_lo:.4e}-{adv_hi:.4e}, diffusive "
          f"{dif_lo:.4e}-{dif_hi:.4e}), max shock {shock:.3e}, urms "
          f"{u0:.3e} -> {u1:.3e}, launches "
          f"{ {k: counts[k] for k in ZROLL_KERNELS} }", flush=True)
    return model, state, ms_step


def time_pairs(torch, kname, kern, plain, errs, timings, fresh=None):
    """Check one kernel against its plain version, then time both.
    ``fresh`` gives the (kernel, plain) calls of the check when the timed
    calls update their input in place."""
    ck, cp = fresh or (kern, plain)
    got, want = ck(), cp()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.ndim == 0:
            r = abs(float(a) / float(b) - 1.0)
            check(r <= RTOL_DT, f"{kname} at 256^3: dt rel err {r}")
            continue
        d, r = rel_err(a, b)
        check(r <= RTOL_FIELD, f"{kname} at 256^3: rel err {r}")
        errs[kname] = max(errs[kname], d)
    del got, want
    timings[kname] = (time_ms(torch, kern, 20), time_ms(torch, plain, 3))
    print(f"phase 4 {kname} at 256^3: kernel {timings[kname][0]:.4f} ms,"
          f" plain {timings[kname][1]:.4f} ms", flush=True)


def time_flagship(torch, fr, smi, fl, errs, timings):
    model, state, ms_step = fl
    fa = state["_fa"]
    alpha, beta, _ = model.rk
    dt_t = state["dt"]
    c2 = torch.stack((model._alpha[1], beta[1] * dt_t, beta[0] * dt_t))
    c3 = torch.stack((model._alpha[2], beta[2] * dt_t, model._zero))
    kick = model.forcing.kick_vector(model._ftables, model._draws(), dt_t,
                                     model.eos)
    df1, _ = fr.rhs_first_plain(model, fa)
    df2, f2 = fr.rhs_tail_defer_plain(model, fa, df1, c2)
    calls = {
        "rhs_first": (lambda: fr.rhs_first(model, fa),
                      lambda: fr.rhs_first_plain(model, fa)),
        "rhs_tail_defer": (lambda: fr.rhs_tail_defer(model, fa, df1, c2),
                           lambda: fr.rhs_tail_defer_plain(model, fa, df1, c2)),
        "rhs_tail_last": (
            lambda: fr.rhs_tail_last(model, f2, df2, c3, kick),
            lambda: fr.rhs_tail_last_plain(model, f2, df2, c3, kick)),
    }
    for kname, (kern, plain) in calls.items():
        time_pairs(torch, kname, kern, plain, errs, timings)
    del df1, df2, f2
    plain_chain = (fr.rhs_first_plain, fr.rhs_tail_defer_plain,
                   fr.rhs_tail_last_plain)
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(
        torch, lambda: model._fused_step(plain_state, plain_chain), 3)
    print(f"phase 4 flagship plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step)", flush=True)


def time_conv_slab(torch, fr, smi, zg, errs, timings):
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
    time_pairs(torch, "rhs_zg", lambda: fr.rhs_zg(model, fg),
               lambda: fr.rhs_zg_plain(model, fg), errs, timings)
    # K7 writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, "rhs_zg_upd", lambda: fr.rhs_zg_upd(model, fg, scratch, coef),
        lambda: fr.rhs_zg_upd_plain(model, fg, scratch, coef), errs, timings,
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


def time_shear_box(torch, fr, smi, sb, errs, timings):
    """K4/K5 checked and timed on the main path's final state, its shock
    slot rebuilt and its x/y ghosts filled as a step does."""
    model, state, ms_step = sb
    fa = state["_fa"]
    sdy = model.deltay(state["t"])
    fg = model.ghosted(model._refresh_aux_fa(fa, sdy), (0, 1), sdy)
    _, beta, _ = model.rk
    df1, dt1m = fr.rhs_zroll_plain(model, fg)
    coef = torch.stack((model._alpha[1], beta[1] / dt1m))
    time_pairs(torch, "rhs_zroll", lambda: fr.rhs_zroll(model, fg),
               lambda: fr.rhs_zroll_plain(model, fg), errs, timings)
    # K5 writes the new df over df_prev: checked on fresh copies of df1,
    # timed on one buffer that each call keeps updating in place
    scratch = df1.clone()
    time_pairs(
        torch, "rhs_zroll_upd",
        lambda: fr.rhs_zroll_upd(model, fg, scratch, coef),
        lambda: fr.rhs_zroll_upd_plain(model, fg, scratch, coef), errs,
        timings,
        fresh=(lambda: fr.rhs_zroll_upd(model, fg, df1.clone(), coef),
               lambda: fr.rhs_zroll_upd_plain(model, fg, df1.clone(), coef)))
    del df1, scratch, fg
    plain_state = {"_fa": fa.clone(), "t": state["t"], "dt": state["dt"],
                   "it": state["it"]}
    plain_ms = time_ms(torch, lambda: model._zroll_step(
        plain_state, (fr.rhs_zroll_plain, fr.rhs_zroll_upd_plain)), 3)
    aux_ms = time_ms(torch, lambda: model._refresh_aux_fa(fa, sdy), 20)
    fill_ms = time_ms(torch, lambda: model.ghosted(fa, (0, 1), sdy), 20)
    print(f"phase 4 shear-box plain chain at 256^3 on {smi}: {plain_ms:.4f} "
          f"ms/step (kernel chain {ms_step:.4f} ms/step); one shock "
          f"pre-pass {aux_ms:.4f} ms, one x/y fill with shifted faces "
          f"{fill_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
