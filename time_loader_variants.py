#!/usr/bin/env python3
"""Time the kernels of csrc/fused_rhs.cu built with other loader
settings, or from another copy of the source, against each other in one
process on one card.

    python3 time_loader_variants.py [VARIANT ...] [--n 256] [--reps 2]
                                    [--lib fused_rhs] [--zroll FILE]
                                    [--steps]

A VARIANT is ``[SOURCE][:NAME=VALUE,...]``: a fused_rhs.cu (default the
package's) and -D definitions for it, e.g. ``:PC_PD=1`` or
``old/fused_rhs.cu``.  A leading ``~`` marks a variant whose results are
wrong by design (a phase left out to time the rest alone): it is timed
only, and the agreement check, which stays as it is for every other
variant, is skipped for it and said so.  ``--lib`` names the template's
library whose definitions every variant is built with and whose
instances are timed:
``fused_rhs`` (the MHD flagship), ``fused_rhs_hydro``, ``fused_rhs_ent``,
``fused_rhs_hydro_ent`` (e.g. ``--lib fused_rhs_ent "" :PC_PD=1
:PC_OQLAG=0`` for the 8-field tails), ``fused_rhs_shock`` (K1s and K5w on
chip_smoke.py's shocked-box input) or ``fused_rhs_shear`` (K4 and K5 on
its sheared stack at t = 0.37).  ``--zroll FILE`` adds the 4×4×16
template of earlier commits as one more variant of a shock build, timed
under the same kernel names through its own interface: its K1s/K5w or
K4/K5 (write it first from git, e.g. ``git show
4a21894:pencil_tpu_torch/csrc/zroll_rhs.cu >
pencil_tpu_torch/_build/variants/zroll_rhs.cu``: the chip's copy of the
repository has no git).  ``--steps`` (with a shock build) also times
its box's whole step through each variant's kernels, from the box's
initial state: the shock pre-passes, fills and axpy included.  Each
variant is built with the package's nvcc
flags into pencil_tpu_torch/_build/variants/, all builds at once; then
every instance of each variant is checked against the plain PyTorch
version (K8's K1 and K2 variants bit for bit; K8 exists in ``fused_rhs``
only) and timed by CUDA events over 20 launches, the variants in turns
(v1, v2, ..., then again) ``--reps`` times, the SM clock and the power
draw sampled meanwhile.  Prints one line per kernel and variant and,
last, one JSON object.  Needs a CUDA device; imports no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

LIBS = ("fused_rhs", "fused_rhs_hydro", "fused_rhs_ent",
        "fused_rhs_hydro_ent", "fused_rhs_shock", "fused_rhs_shear")
ZROLL = "zroll"      # the spec under which --zroll is built and timed
_p = ctypes.c_void_p
# the 4×4×16 template's interface (zroll_rhs.cu of earlier commits)
ZROLL_SIGNATURES = {"pc_zr_tile_shape": [_p], "pc_rhs_zroll": [_p] * 5,
                    "pc_rhs_zroll_upd": [_p] * 7,
                    "pc_rhs_wrap_shock": [_p] * 5,
                    "pc_rhs_wrap_shock_upd": [_p] * 7}


class ZrParams(ctypes.Structure):
    """``struct ZrParams`` of the 4×4×16 template: a subset of PcParams's
    fields, by name, in its own order."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("isothermal", ctypes.c_int),
        ("w1", ctypes.c_float * 3), ("w2", ctypes.c_float * 3),
        ("w6", ctypes.c_float * 3), ("wm", ctypes.c_float * 12),
        ("inv", ctypes.c_float * 3), ("invsq", ctypes.c_float * 3),
        ("inv6", ctypes.c_float * 3),
        ("nu", ctypes.c_float), ("nu_shock", ctypes.c_float),
        ("nu3", ctypes.c_float), ("eta", ctypes.c_float),
        ("eta3", ctypes.c_float), ("diff3", ctypes.c_float),
        ("om", ctypes.c_float * 3), ("S", ctypes.c_float),
        ("cs20", ctypes.c_float), ("gm1", ctypes.c_float),
        ("lnrho0", ctypes.c_float),
        ("dxyz2", ctypes.c_float), ("cdt", ctypes.c_float),
        ("cdtv", ctypes.c_float), ("dif3", ctypes.c_float),
        ("x0", ctypes.c_float), ("dx", ctypes.c_float),
    ]


def build(specs, base="fused_rhs", zroll=None):
    """spec -> loaded library built with library ``base``'s definitions
    and the spec's own, and ZROLL -> the build of ``zroll``, all nvcc runs
    at once."""
    from pencil_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, spec in enumerate(specs):
        src, _, defs = spec.lstrip("~").partition(":")
        src = Path(src) if src else _build.sources()["fused_rhs"]
        flags = list(_build.LIBRARIES[base][1]) + [
            f"-D{d}" for d in defs.split(",") if d]
        jobs[spec] = (out_dir / f"v{i}.so", src, flags,
                      _build.SIGNATURES[base])
    if zroll:
        jobs[ZROLL] = (out_dir / "zroll.so", Path(zroll), [],
                       ZROLL_SIGNATURES)
    procs = {spec: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for spec, (so, src, flags, _) in jobs.items()}
    libs = {}
    for spec, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: nvcc failed\n{log}")
        so, _, _, sigs = jobs[spec]
        lib = ctypes.CDLL(str(so))
        for name, argtypes in sigs.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[spec] = lib
    return libs


def zroll_kernels(torch, fr, lib, model, names):
    """The two kernels of the 4×4×16 template under ``names`` (first,
    update) with the wrappers' interface: first(model, fa) -> (df, 1/dt
    max), upd(model, fa, df_prev, coef) -> (df, f), df written over
    df_prev."""
    pc = fr.kernel_params(model)
    p = ZrParams(**{n: getattr(pc, n) for n, _ in ZrParams._fields_})
    shape = (7, pc.nx, pc.ny, pc.nz)
    t = (ctypes.c_int * 3)()
    lib.pc_zr_tile_shape(ctypes.addressof(t))
    nblk = 1
    for s, b in zip(shape[1:], t):
        nblk *= -(-s // b)
    fn_first, fn_upd = (getattr(lib, "pc_" + k) for k in names)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def first(_, fa):
        df = fa.new_empty(shape)
        blk = fa.new_empty(nblk)
        rc = fn_first(ctypes.addressof(p), fa.data_ptr(), df.data_ptr(),
                      blk.data_ptr(), stream())
        assert rc == 0, rc
        return df, torch.amax(blk)

    def upd(_, fa, dfp, coef):
        f = fa.new_empty(shape)
        rc = fn_upd(ctypes.addressof(p), fa.data_ptr(), dfp.data_ptr(),
                    coef.data_ptr(), dfp.data_ptr(), f.data_ptr(), stream())
        assert rc == 0, rc
        return dfp, f

    return first, upd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=[""])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--lib", default="fused_rhs", choices=LIBS)
    ap.add_argument("--zroll")
    ap.add_argument("--steps", action="store_true",
                    help="with a shock build: time its box's whole step "
                    "(the shock pre-pass, fills and both kernels) per "
                    "variant too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_loader_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    aux = args.lib in fr.AUX_KERNELS
    if args.zroll and not aux:
        ap.error("--zroll takes a shock build's --lib")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build(args.variants, args.lib, args.zroll)
    shape = (args.n,) * 3
    # name -> the timed call; the check's call where the timed one
    # updates its input in place; the plain results; the bound (None: bit
    # for bit)
    if aux:
        shear = args.lib == "fused_rhs_shear"
        model = pt.Model((pt.configs.shear_box if shear
                          else pt.configs.shock_box)(shape), device="cuda")
        fa = (cs.sheared_fg if shear else cs.shocked_fa)(torch, model, 1)
        first, upd = fr.AUX_KERNELS[args.lib]
        df1, dt1m = getattr(fr, first + "_plain")(model, fa)
        coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
        scratch = df1.clone()
        calls = {first: lambda: getattr(fr, first)(model, fa),
                 upd: lambda: getattr(fr, upd)(model, fa, scratch, coef)}
        fresh = {upd: lambda: getattr(fr, upd)(model, fa, df1.clone(), coef)}
        want = {first: [df1],
                upd: list(getattr(fr, upd + "_plain")(model, fa, df1.clone(),
                                                      coef))}
        rtol = dict.fromkeys(calls, cs.RTOL_FIELD if shear else cs.RTOL_NEW)
    else:
        path = {"fused_rhs" + sfx: name
                for name, sfx in cs.TEMPLATE_PATHS.items()}[args.lib]
        model = pt.Model(cs.template_cfg(pt, path, shape), device="cuda")
        fa = cs.random_fa(torch, shape, 1, torch.device("cuda"),
                          model.reg.nvar)
        df1, dt1m = fr.rhs_first_plain(model, fa)
        _, beta, _ = model.rk
        dt = 1.0 / dt1m
        coef = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
        kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                         model.eos)
        scratch = df1.clone()
        calls = {
            "rhs_first": lambda: fr.rhs_first(model, fa),
            "rhs_first_fake": lambda: fr.rhs_first(model, fa, fake=True),
            "rhs_tail_defer": lambda: fr.rhs_tail_defer(model, fa, df1,
                                                        coef),
            "rhs_tail_defer_fake": lambda: fr.rhs_tail_defer(
                model, fa, df1, coef, fake=True),
            "rhs_tail_last": lambda: fr.rhs_tail_last(model, fa, df1, coef,
                                                      kick),
            "rhs_tail_last_fake": lambda: fr.rhs_tail_last(
                model, fa, df1, coef, kick, fake=True),
            "rhs_tail_mid": lambda: fr.rhs_tail_mid(model, fa, scratch,
                                                    coef),
            "rhs_tail_defer_last": lambda: fr.rhs_tail_defer_last(
                model, fa, df1, coef, kick),
        }
        fresh = {"rhs_tail_mid": lambda: fr.rhs_tail_mid(
            model, fa, df1.clone(), coef)}
        plain = {
            "rhs_first": lambda: fr.rhs_first_plain(model, fa),
            "rhs_first_fake": lambda: fr.rhs_first_plain(model, fa,
                                                         fake=True),
            "rhs_tail_defer": lambda: fr.rhs_tail_defer_plain(model, fa,
                                                              df1, coef),
            "rhs_tail_defer_fake": lambda: fr.rhs_tail_defer_plain(
                model, fa, df1, coef, fake=True),
            "rhs_tail_last": lambda: fr.rhs_tail_last_plain(
                model, fa, df1, coef, kick),
            "rhs_tail_last_fake": lambda: fr.rhs_tail_last_plain(
                model, fa, df1, coef, kick, fake=True),
            "rhs_tail_mid": lambda: fr.rhs_tail_mid_plain(
                model, fa, df1.clone(), coef),
            "rhs_tail_defer_last": lambda: fr.rhs_tail_defer_last_plain(
                model, fa, df1, coef, kick),
        }
        if args.lib != "fused_rhs":     # K8: the isothermal MHD build only
            calls = {k: fn for k, fn in calls.items() if "fake" not in k}
        want = {}
        for k in calls:
            w = plain[k]()
            want[k] = [t for t in (w if isinstance(w, tuple) else (w,))
                       if t.ndim]
        # chip_smoke's bounds: K1-K3 and the entropy builds 2e-5, the rest
        # 1e-6, K8's K1 and K2 variants bit for bit
        rtol = {k: None if k in ("rhs_first_fake", "rhs_tail_defer_fake")
                else cs.RTOL_FIELD if k in cs.FLAGSHIP_KERNELS
                or "ent" in args.lib else cs.RTOL_NEW for k in calls}
    variant_calls = {spec: dict(calls) for spec in libs}
    variant_fresh = {spec: fresh for spec in libs}
    if args.zroll:
        zfirst, zupd = zroll_kernels(torch, fr, libs[ZROLL], model,
                                     fr.AUX_KERNELS[args.lib])
        variant_calls[ZROLL] = {
            first: lambda: zfirst(model, fa),
            upd: lambda: zupd(model, fa, scratch, coef)}
        variant_fresh[ZROLL] = {upd: lambda: zupd(model, fa, df1.clone(),
                                                  coef)}
    if args.steps and aux:
        # the box's step from its initial state, through each variant's
        # kernels (the 4×4×16 template's through the chain's `kernels`)
        state = model.pack_state(model.init_state(0))
        for spec in libs:
            kern = (zfirst, zupd) if spec == ZROLL else None
            variant_calls[spec]["step"] = (
                lambda kern=kern: model._aux_step(state, kern))
        calls = dict(calls, step=None)

    def use(spec):
        if spec != ZROLL:
            _build._libs[args.lib] = libs[spec]

    print(f"time_loader_variants on {smi}, {shape}, {args.lib}",
          flush=True)
    for spec in libs:
        if spec.startswith("~"):
            print(f"variant {spec!r}: timed only, wrong by design, not "
                  f"checked", flush=True)
            continue
        use(spec)
        for k, fn in variant_calls[spec].items():
            if k == "step":
                continue
            got = variant_fresh[spec].get(k, fn)()
            got = [t for t in (got if isinstance(got, tuple) else (got,))
                   if t.ndim]
            for a, b in zip(got, want[k]):
                if rtol[k] is None:
                    cs.check(torch.equal(a, b), f"{spec} {k}: not exact")
                else:
                    cs.check(cs.rel_err(a, b)[1] <= rtol[k],
                             f"{spec} {k}: rel err {cs.rel_err(a, b)}")
        print(f"variant {spec or 'default'!r}: every kernel agrees with "
              f"its plain version", flush=True)
    times = {spec: {k: [] for k in calls} for spec in libs}
    # the SM clock and the power draw while the kernels run, every 100 ms
    sampler = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(args.reps):
        for spec in libs:
            use(spec)
            for k, fn in variant_calls[spec].items():
                times[spec][k].append(cs.time_ms(torch, fn,
                                                 5 if k == "step" else 20))
    mul = cs.time_ms(torch, lambda: torch.mul(fa, fr.FAKE_FACTOR), 20)
    sampler.terminate()
    samples = [tuple(float(v) for v in ln.split(","))
               for ln in sampler.communicate()[0].splitlines()
               if ln.count(",") == 1]
    clocks = sorted(c for c, _ in samples)
    load = {"samples": len(samples),
            "sm_mhz_min": clocks[0] if clocks else None,
            "sm_mhz_median": clocks[len(clocks) // 2] if clocks else None,
            "sm_mhz_max": clocks[-1] if clocks else None,
            "watts_max": max((w for _, w in samples), default=None)}
    print(f"under load: {load}", flush=True)
    for k in calls:
        for spec in libs:
            print(f"{k:22s} {spec or 'default':40s} "
                  + " ".join(f"{t:.4f}" for t in times[spec][k]) + " ms",
                  flush=True)
    print(f"torch.mul over the {fa.shape[0]} fields: {mul:.4f} ms",
          flush=True)
    print(json.dumps({"device": smi, "shape": shape, "lib": args.lib,
                      "torch_mul_ms": mul, "under_load": load,
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
