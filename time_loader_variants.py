#!/usr/bin/env python3
"""Time the flagship kernels of csrc/fused_rhs.cu built with other loader
settings, or from another copy of the source, against each other in one
process on one card.

    python3 time_loader_variants.py [VARIANT ...] [--n 256] [--reps 2]

A VARIANT is ``[SOURCE][:NAME=VALUE,...]``: a fused_rhs.cu (default the
package's) and -D definitions for it, e.g. ``:PC_PD=1`` or
``old/fused_rhs.cu``.  Each variant is built with the package's nvcc flags
into pencil_tpu_torch/_build/variants/, all builds at once; then every
flagship instance of each variant is checked against the plain PyTorch
version (K8's K1 and K2 variants bit for bit) and timed by CUDA events over
20 launches, the variants in turns (v1, v2, ..., then again) ``--reps``
times.  Prints one line per kernel and variant and, last, one JSON object.
Needs a CUDA device; imports no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path


def build(specs):
    """spec -> loaded library, all nvcc runs at once."""
    from pencil_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, spec in enumerate(specs):
        src, _, defs = spec.partition(":")
        src = Path(src) if src else _build.sources()["fused_rhs"]
        flags = [f"-D{d}" for d in defs.split(",") if d]
        so = out_dir / f"v{i}.so"
        procs[spec] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for spec, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.SIGNATURES["fused_rhs"].items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[spec] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=[""])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_loader_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build(args.variants)
    shape = (args.n,) * 3
    model = pt.Model(cs.flagship(pt, shape), device="cuda")
    fa = cs.random_fa(torch, shape, 1, torch.device("cuda"))
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
        "rhs_tail_defer": lambda: fr.rhs_tail_defer(model, fa, df1, coef),
        "rhs_tail_defer_fake": lambda: fr.rhs_tail_defer(model, fa, df1,
                                                         coef, fake=True),
        "rhs_tail_last": lambda: fr.rhs_tail_last(model, fa, df1, coef,
                                                  kick),
        "rhs_tail_last_fake": lambda: fr.rhs_tail_last(model, fa, df1, coef,
                                                       kick, fake=True),
        "rhs_tail_mid": lambda: fr.rhs_tail_mid(model, fa, scratch, coef),
        "rhs_tail_defer_last": lambda: fr.rhs_tail_defer_last(
            model, fa, df1, coef, kick),
    }
    plain = {
        "rhs_first": lambda: fr.rhs_first_plain(model, fa),
        "rhs_first_fake": lambda: fr.rhs_first_plain(model, fa, fake=True),
        "rhs_tail_defer": lambda: fr.rhs_tail_defer_plain(model, fa, df1,
                                                          coef),
        "rhs_tail_defer_fake": lambda: fr.rhs_tail_defer_plain(
            model, fa, df1, coef, fake=True),
        "rhs_tail_last": lambda: fr.rhs_tail_last_plain(model, fa, df1, coef,
                                                        kick),
        "rhs_tail_last_fake": lambda: fr.rhs_tail_last_plain(
            model, fa, df1, coef, kick, fake=True),
        "rhs_tail_defer_last": lambda: fr.rhs_tail_defer_last_plain(
            model, fa, df1, coef, kick),
    }
    exact = ("rhs_first_fake", "rhs_tail_defer_fake")
    want = {}
    for k, fn in plain.items():
        w = fn()
        want[k] = [t for t in (w if isinstance(w, tuple) else (w,))
                   if t.ndim]
    # K3' updates its df_prev in place: checked on a fresh copy
    want["rhs_tail_mid"] = list(fr.rhs_tail_mid_plain(model, fa,
                                                      df1.clone(), coef))
    print(f"time_loader_variants on {smi}, {shape}", flush=True)
    for spec, lib in libs.items():
        _build._libs["fused_rhs"] = lib
        for k, fn in calls.items():
            got = (fr.rhs_tail_mid(model, fa, df1.clone(), coef)
                   if k == "rhs_tail_mid" else fn())
            got = [t for t in (got if isinstance(got, tuple) else (got,))
                   if t.ndim]
            for a, b in zip(got, want[k]):
                if k in exact:
                    cs.check(torch.equal(a, b), f"{spec} {k}: not exact")
                else:
                    # chip_smoke's bounds: K1-K3 2e-5, the rest 1e-6
                    rtol = (cs.RTOL_FIELD if k in cs.FLAGSHIP_KERNELS
                            else cs.RTOL_NEW)
                    cs.check(cs.rel_err(a, b)[1] <= rtol,
                             f"{spec} {k}: rel err {cs.rel_err(a, b)}")
        print(f"variant {spec or 'default'!r}: every kernel agrees with "
              f"its plain version", flush=True)
    times = {spec: {k: [] for k in calls} for spec in libs}
    for _ in range(args.reps):
        for spec, lib in libs.items():
            _build._libs["fused_rhs"] = lib
            for k, fn in calls.items():
                times[spec][k].append(cs.time_ms(torch, fn, 20))
    mul = cs.time_ms(torch, lambda: torch.mul(fa, fr.FAKE_FACTOR), 20)
    for k in calls:
        for spec in libs:
            print(f"{k:22s} {spec or 'default':40s} "
                  + " ".join(f"{t:.4f}" for t in times[spec][k]) + " ms",
                  flush=True)
    print(f"torch.mul over the 7 fields: {mul:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "shape": shape, "torch_mul_ms": mul,
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
