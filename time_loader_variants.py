#!/usr/bin/env python3
"""Time the kernels of csrc/fused_rhs.cu built with other loader
settings, or from another copy of the source, against each other in one
process on one card.

    python3 time_loader_variants.py [VARIANT ...] [--n 256] [--reps 2]
                                    [--lib fused_rhs] [--parent-tree DIR]
                                    [--steps] [--bitwise]
    python3 time_loader_variants.py --option upwind|shock|safi|mesh ...
                                    [--lib all]
                                    [--n 256]
    python3 time_loader_variants.py --option heatcond|visc [--lib all]
                                    [--n 256] [--parent-tree DIR]

A VARIANT is ``[SOURCE][:NAME=VALUE,...]``: a fused_rhs.cu (default the
package's) and -D definitions for it, e.g. ``:PC_PD=1`` or
``old/fused_rhs.cu``.  A leading ``~`` marks a variant whose results are
wrong by design (a phase left out to time the rest alone): it is timed
only, and the agreement check, which stays as it is for every other
variant, is skipped for it and said so.  ``--lib`` names the template's
library whose definitions every variant is built with and whose
instances are timed (``--terms``: with B_ext and the continuous
forcing 'ABC' on, the periodic builds only):
``fused_rhs`` (the MHD flagship), ``fused_rhs_hydro``, ``fused_rhs_ent``,
``fused_rhs_hydro_ent`` (e.g. ``--lib fused_rhs_ent "" :PC_PD=1
:PC_OQLAG=0`` for the 8-field tails), ``fused_rhs_shock`` (K1s and K5w on
chip_smoke.py's shocked-box input), ``fused_rhs_shear`` (K4 and K5 on
its sheared stack at t = 0.37), ``fused_rhs_shock_ent``,
``fused_rhs_shear_ent`` and ``fused_rhs_shear_ent_ns`` (K1se/K5wse,
K4e/K5e and K4ne/K5ne on the same inputs of their layouts, with ss and
A), ``fused_rhs_zg`` (K6 and K7 on its
stratified conv-slab input, the interior and its z-halo slabs) or
``fused_rhs_zg_mag`` (K6m and K7m on the same with a noisy vector
potential) or ``fused_rhs_zg_shock`` and ``fused_rhs_zg_mag_shock``
(K6k/K7k and K6mk/K7mk on the same with a positive shock slot) or
``fused_rhs_zg_iso`` (K6i and K7i on the isothermal
stratified layer's hydro input, ``strat_box(n, magnetic=False,
shear=False)``: e.g. ``"" :PC_MINB2=1``, two blocks a SM).
``--parent-tree DIR`` (with a shock or a z-ghosted build) adds
another checkout's package as one more column, ``parent``, on the same
configuration (one it has no kernels for raises there): DIR holds an
unpacked ``git archive`` of an earlier commit (e.g. ``git archive
9dab6e0 pencil_tpu_torch | tar -x -C _archive/parent``, made where
git is at hand), whose ``pencil_tpu_torch`` is imported
beside this one and builds its own kernels from its own csrc/ into its
own _build/; the same kernels are timed through its own wrappers and
model, whatever template they had then (the 4×4×16 tiles of
zroll_rhs.cu up to 4a21894, of zghost_rhs.cu up to 9dab6e0; the latter on
its stack ghosted in all three axes).  ``--steps`` (with a shock or a
z-ghosted build) also times the path's whole step from its initial
state, through each variant's kernels and the parent's own
``make_step``: the shock pre-passes, fills and axpy included; each step
also under the sync debug mode "error", as chip_smoke.py times it ("step
sync-debug"), by the host's clock alone, the time to issue it ("step
host"), and by the card's busy time in torch.profiler's kernel records
("step device").  Each variant is
built with the package's nvcc flags into
pencil_tpu_torch/_build/variants/, all builds (and the parent's) at
once, and its instances' registers, local bytes, shared memory and
blocks per SM printed; then every
instance of each variant is checked against the plain PyTorch version
(K8's K1 and K2 variants bit for bit; K8 exists in ``fused_rhs``
only; with ``--bitwise`` each output also against the first variant's,
bit for bit) and timed by CUDA events over 20 launches, the variants in
turns
(v1, v2, ..., then again) ``--reps`` times, the SM clock and the power
draw sampled meanwhile.  Prints one line per kernel and variant and,
last, one JSON object.

``--option`` times one build's kernels (``--lib``, any of the
template's 24 libraries, or ``all``) with an option on against the same
kernels with it off, instead of variants: the upwinding (``upwind``:
lupw_lnrho, lupw_uu, lupw_ss, the UPW instances of every build), the
shock diffusivities (``shock``: diffrho_shock, eta_shock, chi_shock, the
SHK instances of the 8 builds with the shock slot), SAFI (``safi``: the
12 shear builds with the shear flow's nodes at 0, the same instances) or
the mesh flavour of del6 (``mesh``: every build with H3 instances, whose
configuration then has 'simplified' del6 of u, A and lnρ off and the
mesh flavour on u and lnρ on, the same H3 instances).  Each build runs
chip_smoke.py's configuration of it (the periodic builds'
TEMPLATE_PATHS sets, the shock and shear builds' AUX_PATHS sets without
del6, the z-ghosted builds' conv_slab and strat_box sets, the sheared
ones at Ω = 1 from t = T_SHEAR), as it is and through ``configs``'
``with_upwind`` or ``with_shock_diffusion``, on chip_smoke.py's noisy
inputs at n³.  Each kernel with the option on is checked against its
plain version (chip_smoke.py's bounds at 256³), then every kernel is
timed by CUDA events over 20 launches, off, on, on, off, and the
registers and local bytes of both instances printed
(``pc_flagship_attrs``).  One line per build, then one JSON object.

``--option heatcond`` times the first and update kernel of each of the
six z-ghosted builds with ss (``--lib`` one of them, or ``all``) under
Entropy's conduction flavours in turns on one input: K-const (the
build's configuration), 'K-profile', Newtonian cooling with the uniform
heating and cooling (the base instances), chi-const and 'kramers' (the
CHI instances); with ``--parent-tree DIR`` also the K-const and
chi-const configurations through DIR's package, its own kernels, in the
same turns.  Each flavour's kernels are checked against their plain
versions first; the registers and local bytes of each instance are
printed.

``--option visc`` times each build's kernels (``--lib`` one of the
template's 26 libraries, several joined by commas, or ``all``) with Viscosity's other flavours and
Density's diffrho off (the build's configuration: visx not taken) and on
(chip_smoke.py's ``with_visc``: every flavour that the build takes) and,
for fused_rhs, fused_rhs_shock_hydro_ent and fused_rhs_zg, each flavour
alone; with ``--parent-tree DIR`` also the build's configuration through
DIR's package and its own kernels, all in turns on one input.  Each state
with a flavour on is checked against its plain version first; the
registers and local bytes of the off and on instances are printed.

Needs a CUDA device; imports no JAX.
"""
import argparse
import concurrent.futures
import ctypes
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

LIBS = ("fused_rhs", "fused_rhs_hydro", "fused_rhs_ent",
        "fused_rhs_hydro_ent", "fused_rhs_shock", "fused_rhs_shear",
        "fused_rhs_shock_ent", "fused_rhs_shear_ent",
        "fused_rhs_shear_ent_ns", "fused_rhs_zg", "fused_rhs_zg_mag",
        "fused_rhs_zg_iso", "fused_rhs_zg_shock", "fused_rhs_zg_mag_shock")
PARENT = "parent"    # the column of --parent-tree
# the name its package is imported under
PARENT_PKG = "parent_pencil_tpu_torch"
# the configuration that runs each build with two kernels, with its
# keyword arguments, and the two wrappers that launch them
PATH_CONFIG = {"fused_rhs_shock": ("shock_box", {}),
               "fused_rhs_shear": ("shear_box", {}),
               "fused_rhs_shock_ent": ("shock_box", {"entropy": True}),
               "fused_rhs_shear_ent": ("shear_box", {"entropy": True}),
               "fused_rhs_shear_ent_ns": ("shear_box", {"entropy": True,
                                                        "shock": False}),
               "fused_rhs_zg": ("conv_slab", {}),
               "fused_rhs_zg_mag": ("conv_slab", {"magnetic": True}),
               "fused_rhs_zg_iso": ("strat_box", {"magnetic": False,
                                                  "shear": False}),
               "fused_rhs_zg_shock": ("conv_slab", {"shock": True}),
               "fused_rhs_zg_mag_shock": ("conv_slab", {"magnetic": True,
                                                        "shock": True})}
_SHOCK_W, _SHEAR_W = ("rhs_wrap_shock", "rhs_wrap_shock_upd"), (
    "rhs_zroll", "rhs_zroll_upd")
WRAPPERS = {"fused_rhs_shock": _SHOCK_W, "fused_rhs_shear": _SHEAR_W,
            "fused_rhs_shock_ent": _SHOCK_W, "fused_rhs_shear_ent": _SHEAR_W,
            "fused_rhs_shear_ent_ns": _SHEAR_W,
            "fused_rhs_zg": ("rhs_zg", "rhs_zg_upd"),
            "fused_rhs_zg_mag": ("rhs_zg", "rhs_zg_upd"),
            "fused_rhs_zg_iso": ("rhs_zg", "rhs_zg_upd"),
            "fused_rhs_zg_shock": ("rhs_zg", "rhs_zg_upd"),
            "fused_rhs_zg_mag_shock": ("rhs_zg", "rhs_zg_upd")}


def build(specs, base="fused_rhs"):
    """spec -> loaded library built with library ``base``'s definitions
    and the spec's own, all nvcc runs at once."""
    from pencil_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, spec in enumerate(specs):
        src, _, defs = spec.lstrip("~").partition(":")
        src = Path(src) if src else _build.sources()["fused_rhs"]
        flags = list(_build.LIBRARIES[base][1]) + [
            f"-D{d}" for d in defs.split(",") if d]
        jobs[spec] = (out_dir / f"v{i}.so", src, flags)
    procs = {spec: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for spec, (so, src, flags) in jobs.items()}
    libs = {}
    for spec, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(jobs[spec][0]))
        for name, argtypes in _build.SIGNATURES[base].items():
            if hasattr(lib, name):      # an older source may lack one
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[spec] = lib
    return libs


def load_parent(tree):
    """The package pencil_tpu_torch of the checkout ``tree``, imported as
    PARENT_PKG beside this one (it imports its own modules relatively)."""
    pkg = Path(tree).resolve() / "pencil_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        PARENT_PKG, pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_PKG] = mod
    spec.loader.exec_module(mod)
    for sub in ("configs", "ops._build", "ops.fused_rhs"):
        importlib.import_module(f"{PARENT_PKG}.{sub}")
    return mod


def kernel_pair(fr, model, names, inp, scratch, df1, coef, wrappers):
    """A two-kernel path's calls through ``fr``'s wrappers (their names
    ``wrappers``): launch name -> the timed call (the update into
    ``scratch``, in place), and the update's check on a fresh copy of
    df1."""
    first, upd = (getattr(fr, k) for k in wrappers)
    return ({names[0]: lambda: first(model, *inp),
             names[1]: lambda: upd(model, *inp, scratch, coef)},
            {names[1]: lambda: upd(model, *inp, df1.clone(), coef)})


def agree(cs, what, got, want, rtol):
    """Check a kernel's outputs against its plain version's: a 0-d CFL
    maximum within RTOL_DT relative, each field within ``rtol`` × its max
    (None: bit for bit)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.ndim == 0:
            r = abs(float(a) / float(b) - 1.0)
            cs.check(r <= cs.RTOL_DT, f"{what}: dt rel err {r}")
        elif rtol is None:
            cs.check(torch.equal(a, b), f"{what}: not exact")
        else:
            r = cs.rel_err(a, b)[1]
            cs.check(r <= rtol, f"{what}: rel err {r}")


def option_builds(pt, cs, fr, shape):
    """library -> (label, configuration) of every build of the template,
    found through the wrappers' own library lookup."""
    out = {}
    for name in cs.TEMPLATE_PATHS:
        if not name.endswith(" h3"):
            cfg = cs.template_cfg(pt, name, shape)
            out[fr.flagship_library(pt.Model(cfg, device="cpu"))] = (
                name, cfg)
    for label in cs.AUX_PATHS:
        cfg = cs.aux_cfg(pt, label, shape)
        cfg = cs.aux_variant(pt, cfg, cfg.module("hydro").Omega, False)
        if cfg.module("shear") is not None:
            cfg = cfg.replace(time=pt.TimeSpec(itorder=3,
                                               tstart=cs.T_SHEAR))
        out[fr.aux_library(pt.Model(cfg, device="cpu"))] = (label, cfg)
    for kw in ({}, dict(magnetic=True), dict(shear=True, Omega=1.0),
               dict(magnetic=True, shear=True, Omega=1.0), dict(shock=True),
               dict(magnetic=True, shock=True)):
        cfg = pt.configs.conv_slab(shape, **kw)
        if kw.get("shear"):
            cfg = cfg.replace(time=pt.TimeSpec(itorder=3,
                                               tstart=cs.T_SHEAR))
        out[fr.zg_library(pt.Model(cfg, device="cpu"))] = (
            f"conv-slab {kw}", cfg)
    for iso, kw in cs.ISO_SETS.items():
        cfg = cs.strat_cfg(pt, shape, **kw)
        out[fr.zg_library(pt.Model(cfg, device="cpu"))] = (
            f"isothermal stratified {iso}", cfg)
    return out


def option_kernels(torch, cs, fr, model, shape):
    """(kernel kind -> fn(model), kind -> (fn(model) of the check, plain
    fn(model))) of ``model``'s build on one noisy input at ``shape``: the
    periodic builds' K1, K2, K3 and K2L with the kick and K3′, the
    others' first and update kernel."""
    if model.mode == "wrap":
        fa = cs.random_fa(torch, shape, 1, torch.device("cuda"),
                          model.reg.nvar)
        df1, dt1m = fr.rhs_first_plain(model, fa)
        _, beta, _ = model.rk
        dt = 1.0 / dt1m
        c2 = torch.stack((model._alpha[1], beta[1] * dt, beta[0] * dt))
        c3 = torch.stack((model._alpha[2], beta[2] * dt, beta[1] * dt))
        kick = model.forcing.kick_vector(model._ftables, model._draws(), dt,
                                         model.eos)
        scratch = df1.clone()
        args = {"rhs_first": (fa,), "rhs_tail_defer": (fa, df1, c2),
                "rhs_tail_last": (fa, df1, c3, kick),
                "rhs_tail_defer_last": (fa, df1, c3, kick)}
        timed = {k: lambda m, k=k, a=a: getattr(fr, k)(m, *a)
                 for k, a in args.items()}
        checked = {k: (fn, lambda m, k=k, a=args[k]: getattr(
            fr, k + "_plain")(m, *a)) for k, fn in timed.items()}
        timed["rhs_tail_mid"] = lambda m: fr.rhs_tail_mid(m, fa, scratch, c3)
        checked["rhs_tail_mid"] = tuple(
            lambda m, fn=fn: fn(m, fa, df1.clone(), c3)
            for fn in (fr.rhs_tail_mid, fr.rhs_tail_mid_plain))
        return timed, checked
    if model.mode == "zghost":
        inp = cs.zg_input(torch, model, 3)
        first, upd = fr.rhs_zg, fr.rhs_zg_upd
        first_p, upd_p = fr.zg_plain(model)
    else:
        inp = (cs.aux_input(torch, model, 3),)
        first, upd = ((fr.rhs_zroll, fr.rhs_zroll_upd) if model.mode
                      == "zroll" else (fr.rhs_wrap_shock,
                                       fr.rhs_wrap_shock_upd))
        first_p, upd_p = (getattr(fr, k.__name__ + "_plain")
                          for k in (first, upd))
    df1, dt1m = first_p(model, *inp)
    coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
    scratch = df1.clone()
    timed = {"first": lambda m: first(m, *inp),
             "update": lambda m: upd(m, *inp, scratch, coef)}
    checked = {"first": (timed["first"], lambda m: first_p(m, *inp)),
               "update": (lambda m: upd(m, *inp, df1.clone(), coef),
                          lambda m: upd_p(m, *inp, df1.clone(), coef))}
    return timed, checked


# --option heatcond: the six z-ghosted builds with ss (conv_slab keyword
# arguments) and the conduction flavours timed on each (conv_slab keyword
# arguments; those that an older conv_slab also takes: its columns with
# --parent-tree)
ZG_SS = {"fused_rhs_zg": {}, "fused_rhs_zg_mag": {"magnetic": True},
         "fused_rhs_zg_shear": {"shear": True, "Omega": 1.0},
         "fused_rhs_zg_mag_shear": {"magnetic": True, "shear": True,
                                    "Omega": 1.0},
         "fused_rhs_zg_shock": {"shock": True},
         "fused_rhs_zg_mag_shock": {"magnetic": True, "shock": True}}
HEATCOND_STATES = {
    "K-const": {}, "K-profile": {"heatcond": "K-profile"},
    "cooling": {"tau_cool": 2.0, "entropy": {"heat_uniform": 1e-2,
                                             "cool_uniform": 2e-3}},
    "chi-const": {"chi": 4e-3}, "kramers": {"heatcond": "kramers"}}
PARENT_STATES = ("K-const", "chi-const")


def time_heatcond(args, smi):
    """The ``--option heatcond`` mode: each z-ghosted build with ss under
    each conduction flavour (and the parent's K-const and chi-const), its
    two kernels in turns on one input."""
    import torch
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    pp = load_parent(args.parent_tree) if args.parent_tree else None
    libs = list(ZG_SS) if args.lib == "all" else [args.lib]
    # only these libraries are timed: build them alone, in both packages
    for build in (_build, pp.ops._build) if pp else (_build,):
        build.LIBRARIES = {k: v for k, v in build.LIBRARIES.items()
                           if k in libs}
        build.start()
    shape = (args.n,) * 3
    result = {}
    for lib in libs:
        bkw = ZG_SS[lib]
        models = {name: pt.Model(pt.configs.conv_slab(shape, **bkw, **kw),
                                 device="cuda")
                  for name, kw in HEATCOND_STATES.items()}
        ref = models["K-const"]
        inp = cs.zg_input(torch, ref, 3)
        df1, dt1m = fr.zg_plain(ref)[0](ref, *inp)
        coef = torch.stack((ref._alpha[1], ref.rk[1][1] / dt1m))
        scratch = df1.clone()
        calls = {}
        for name, m in models.items():
            first_p, upd_p = fr.zg_plain(m)
            agree(cs, f"{lib} {name} first", fr.rhs_zg(m, *inp),
                  first_p(m, *inp), cs.RTOL_FIELD)
            agree(cs, f"{lib} {name} update",
                  fr.rhs_zg_upd(m, *inp, df1.clone(), coef),
                  upd_p(m, *inp, df1.clone(), coef), cs.RTOL_FIELD)
            calls[id(m)] = (
                lambda m=m: fr.rhs_zg(m, *inp),
                lambda m=m: fr.rhs_zg_upd(m, *inp, scratch, coef))
        if pp:
            pfr = pp.ops.fused_rhs
            for name in PARENT_STATES:
                pm = pp.Model(pp.configs.conv_slab(
                    shape, **bkw, **HEATCOND_STATES[name]), device="cuda")
                pinp = cs.zg_input(torch, pm, 3)
                models[f"{PARENT} {name}"] = pm
                calls[id(pm)] = (
                    lambda pm=pm, pinp=pinp: pfr.rhs_zg(pm, *pinp),
                    lambda pm=pm, pinp=pinp: pfr.rhs_zg_upd(
                        pm, *pinp, scratch, coef))
        times = cs.in_turns(torch, models, {
            "first": lambda m: calls[id(m)][0](),
            "update": lambda m: calls[id(m)][1]()})
        attrs = fr.flagship_attrs(lib)
        rot = " rot" if bkw.get("Omega") else ""
        regs = {name: {n: (attrs[n + rot]["registers"],
                           attrs[n + rot]["local_bytes"])
                       for n in fr.zg_kernels(m)}
                for name, m in models.items() if not name.startswith(PARENT)}
        result[lib] = {f"{kind} {state}": ts
                       for (kind, state), ts in times.items()}
        print(f"time_loader_variants --option heatcond {lib} at {shape} on "
              f"{smi}, in turns: " + "; ".join(
                  f"{kind} {state} " + ", ".join(f"{t:.4f}" for t in ts)
                  + " ms" for (kind, state), ts in times.items())
              + "; (registers, local bytes): " + "; ".join(
                  f"{state} " + ", ".join(f"{n} {r}" for n, r in r_.items())
                  for state, r_ in regs.items()), flush=True)
        del models, calls, inp, df1, scratch
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "shape": shape, "ms": result}),
          flush=True)
    return 0


def time_options(args, smi):
    """The ``--option`` mode: each build's kernels with each option on
    against the same kernels with it off."""
    import torch
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    _build.start()
    shape = (args.n,) * 3
    builds = option_builds(pt, cs, fr, shape)
    libs = list(_build.LIBRARIES) if args.lib == "all" else [args.lib]
    result = {}
    for option in args.option:
        turn = {"upwind": pt.configs.with_upwind,
                "shock": pt.configs.with_shock_diffusion,
                "safi": cs.with_safi, "mesh": cs.with_mesh}[option]
        for lib in libs:
            label, cfg = builds[lib]
            if option == "shock" and cfg.module("shock") is None:
                continue
            if option == "safi" and cfg.module("shear") is None:
                continue
            if option == "mesh":
                if lib in fr.ZG_SHOCK_LIBRARIES:
                    continue        # no H3 instance beside a walled shock
                cfg = cs.aux_variant(pt, cfg, cfg.module("hydro").Omega,
                                     True)
            models = {"off": pt.Model(cfg, device="cuda"),
                      "on": pt.Model(turn(cfg), device="cuda")}
            timed, checked = option_kernels(torch, cs, fr, models["on"],
                                            shape)
            for kind, (kern, plain) in checked.items():
                agree(cs, f"{lib} {option} {kind}", kern(models["on"]),
                      plain(models["on"]), cs.RTOL_FIELD)
            times = cs.in_turns(torch, models, timed)
            # each state's instances: those under the launch names its
            # kernels counted, with rotation where Ω ≠ 0, as
            # pc_flagship_attrs reports them
            attrs = fr.flagship_attrs(lib)
            regs = {}
            for state, m in models.items():
                fr.reset_launches()
                for fn in timed.values():
                    fn(m)
                launched = {k for k, v in fr.LAUNCHES.items() if v}
                rot = bool(m.cfg.module("hydro").Omega)
                regs[state] = {
                    n: (a["registers"], a["local_bytes"])
                    for n, a in attrs.items()
                    if n.split()[0] in launched
                    and set(n.split()[1:]) <= {"kick", "rot"}
                    and ("rot" in n.split()) == rot}
            result[f"{option} {lib}"] = {
                f"{kind} {state}": ts for (kind, state), ts in times.items()}
            print(f"time_loader_variants --option {option} {lib} ({label}) "
                  f"at {shape} on {smi}, in turns (off, on, on, off): "
                  + "; ".join(f"{kind} {state} " + ", ".join(
                      f"{t:.4f}" for t in ts) + " ms"
                      for (kind, state), ts in times.items())
                  + "; (registers, local bytes): " + "; ".join(
                      f"{state} " + ", ".join(f"{n} {r}" for n, r in
                                              regs[state].items())
                      for state in models), flush=True)
            del models, timed, checked
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "shape": shape, "ms": result}),
          flush=True)
    return 0


# --option visc: the builds whose flavours are also timed one at a time
VISC_SINGLE = ("fused_rhs", "fused_rhs_shock_hydro_ent", "fused_rhs_zg")


def visc_states(pt, cs, cfg, lib):
    """state -> configuration of one build for ``--option visc``: 'off'
    (the build's configuration: visx not taken), 'on' (chip_smoke.py's
    with_visc: every flavour the build takes) and, for VISC_SINGLE, each
    flavour alone beside the build's own viscosity."""
    out = {"off": cfg, "on": cs.with_visc(pt, cfg)}
    if lib not in VISC_SINGLE:
        return out
    visc = cfg.module("viscosity")
    own = tuple(visc.ivisc)
    singles = {"nu-simplified": ("nu-simplified",),
               "rho-nu-const": ("rho-nu-const",),
               "bulk": ("rho-nu-const-bulk",)}
    if cfg.module("shock") is not None:
        singles["shock-simple"] = ("shock-simple",)
    if cfg.module("entropy") is not None and not all(cfg.grid.periodic):
        singles["nu-cspeed"] = ("nu-cspeed",)
    for name, add in singles.items():
        out[name] = pt.configs.with_viscosity(cfg, own + add,
                                              zeta=cs.VISC_ZETA)
    out["diffrho"] = pt.configs.with_viscosity(cfg, own, diffrho=visc.nu)
    return out


def time_visc(args, smi):
    """The ``--option visc`` mode: each build's kernels with Viscosity's
    other flavours and diffrho off (visx not taken) and on, and (with
    ``--parent-tree``) the same configuration through the parent's own
    package, all in turns on one input; for VISC_SINGLE each flavour
    alone too."""
    import torch
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    pp = load_parent(args.parent_tree) if args.parent_tree else None
    libs = (list(_build.LIBRARIES) if args.lib == "all"
            else args.lib.split(","))
    for build in (_build, pp.ops._build) if pp else (_build,):
        build.LIBRARIES = {k: v for k, v in build.LIBRARIES.items()
                           if k in libs}
        build.start()
    # every library built before any is timed: nvcc on the host's cores
    # beside a timed launch loop slows the launches
    for build in (_build, pp.ops._build) if pp else (_build,):
        build.build()
    shape = (args.n,) * 3
    builds = option_builds(pt, cs, fr, shape)
    pbuilds = option_builds(pp, cs, pp.ops.fused_rhs, shape) if pp else {}
    result = {}
    for lib in libs:
        label, cfg = builds[lib]
        models = {k: pt.Model(c, device="cuda")
                  for k, c in visc_states(pt, cs, cfg, lib).items()}
        timed, checked = option_kernels(torch, cs, fr, models["off"], shape)
        for state, m in models.items():
            if state == "off":
                continue
            for kind, (kern, plain) in checked.items():
                agree(cs, f"{lib} visc {state} {kind}", kern(m), plain(m),
                      cs.RTOL_FIELD)
        calls = {id(m): timed for m in models.values()}
        if pp:
            pm = pp.Model(pbuilds[lib][1], device="cuda")
            ptimed, _ = option_kernels(torch, cs, pp.ops.fused_rhs, pm,
                                       shape)
            models = {PARENT: pm, **models}
            calls[id(pm)] = ptimed
        times = cs.in_turns(torch, models, {
            kind: (lambda m, kind=kind: calls[id(m)][kind](m))
            for kind in timed})
        attrs = fr.flagship_attrs(lib)
        regs = {}
        for state in ("off", "on"):
            m = models[state]
            fr.reset_launches()
            for fn in timed.values():
                fn(m)
            launched = {k for k, v in fr.LAUNCHES.items() if v}
            rot = bool(m.cfg.module("hydro").Omega)
            regs[state] = {
                n: (a["registers"], a["local_bytes"])
                for n, a in attrs.items()
                if n.split()[0] in launched
                and set(n.split()[1:]) <= {"kick", "rot"}
                and ("rot" in n.split()) == rot}
        result[lib] = {f"{kind} {state}": ts
                       for (kind, state), ts in times.items()}
        print(f"time_loader_variants --option visc {lib} ({label}) at "
              f"{shape} on {smi}, in turns ({', '.join(models)}, then "
              "back): " + "; ".join(
                  f"{kind} {state} " + ", ".join(f"{t:.4f}" for t in ts)
                  + " ms" for (kind, state), ts in times.items())
              + "; (registers, local bytes): " + "; ".join(
                  f"{state} " + ", ".join(f"{n} {r}" for n, r in
                                          regs[state].items())
                  for state in regs), flush=True)
        del models, timed, checked, calls
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "shape": shape, "ms": result}),
          flush=True)
    return 0


def host_ms(torch, fn, n):
    """Mean ms the host takes to issue fn() over n calls (after one
    warm-up), not waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=[""])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--lib", default="fused_rhs",
                    help=f"one of {', '.join(LIBS)}; with --option any "
                    "library of the template, or 'all'")
    ap.add_argument("--parent-tree", metavar="DIR")
    ap.add_argument("--terms", action="store_true",
                    help="with a periodic build: its configuration with "
                    "B_ext (the MHD builds) and the continuous forcing "
                    "'ABC' (chip_smoke.py's with_terms)")
    ap.add_argument("--bitwise", action="store_true",
                    help="also compare every output of each variant with "
                    "the first variant's, bit for bit")
    ap.add_argument("--steps", action="store_true",
                    help="with a shock or z-ghosted build: time its "
                    "path's whole step (the shock pre-pass, fills and "
                    "both kernels) per variant too")
    ap.add_argument("--option", nargs="+",
                    choices=("upwind", "shock", "safi", "mesh", "heatcond",
                             "visc"),
                    help="time each option on against off, in place of "
                    "variants")
    args = ap.parse_args()
    if not args.option and args.lib not in LIBS:
        ap.error(f"--lib: one of {', '.join(LIBS)}")
    if args.option and "heatcond" in args.option and (
            len(args.option) > 1 or args.lib not in (*ZG_SS, "all")):
        ap.error(f"--option heatcond: alone, --lib one of "
                 f"{', '.join(ZG_SS)} or all")
    import torch
    if not torch.cuda.is_available():
        print("time_loader_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import pencil_tpu_torch as pt
    import pencil_tpu_torch.configs  # noqa: F401  (pt.configs)
    from pencil_tpu_torch.ops import _build
    from pencil_tpu_torch.ops import fused_rhs as fr

    if args.option and "visc" in args.option and len(args.option) > 1:
        ap.error("--option visc: alone")
    if args.option == ["visc"]:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        return time_visc(args, smi)
    if args.option == ["heatcond"]:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        return time_heatcond(args, smi)
    two = args.lib in PATH_CONFIG      # a path of two kernels
    if args.terms and two:
        ap.error("--terms takes a periodic build's --lib")
    if (args.parent_tree or args.steps) and not two:
        ap.error("--parent-tree and --steps take a shock build's --lib or "
                 "a z-ghosted one")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.option:
        return time_options(args, smi)
    pp = load_parent(args.parent_tree) if args.parent_tree else None
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pbuild = pool.submit(pp.ops._build.build) if pp else None
        libs = build(args.variants, args.lib)
        if pbuild:
            pbuild.result()
    specs = list(libs) + ([PARENT] if pp else [])
    shape = (args.n,) * 3
    # each variant's instances: registers, local bytes, shared memory and
    # resident blocks per SM (pc_flagship_attrs)
    for spec, lib in libs.items():
        for inst, which in fr.library_instances(args.lib).items():
            a = (ctypes.c_int * len(fr.ATTR_KEYS))()
            rc = lib.pc_flagship_attrs(which, ctypes.addressof(a))
            if rc == 1 and which >= 128 and spec.lstrip("~").partition(
                    ":")[0]:
                # a variant of another source may predate the UPW and SHK
                # instances (an invalid value); the package's has them all
                print(f"variant {spec!r} {inst}: not built", flush=True)
                continue
            cs.check(rc == 0, f"{spec} {inst}: pc_flagship_attrs {rc}")
            print(f"variant {spec or 'default'!r} {inst} on {smi}: "
                  + ", ".join(f"{k} {v}" for k, v in zip(fr.ATTR_KEYS, a)),
                  flush=True)
    # name -> the timed call; the check's call where the timed one
    # updates its input in place; the plain results; the bound (None: bit
    # for bit)
    if two:
        names = fr.AUX_KERNELS.get(args.lib) or fr.ZG_KERNELS[args.lib]
        wrappers = WRAPPERS[args.lib]
        cfg, kw = PATH_CONFIG[args.lib]
        model = pt.Model(getattr(pt.configs, cfg)(shape, **kw),
                         device="cuda")
        if cfg in ("conv_slab", "strat_box"):
            fa = cs.stratified_fa(torch, model, 1)
            inp = model.z_slabs(fa)      # pins fa's walls in place
        else:
            fa = (cs.sheared_fg if cfg == "shear_box"
                  else cs.shocked_fa)(torch, model, 1)
            inp = (fa,)
        df1, dt1m = getattr(fr, wrappers[0] + "_plain")(model, *inp)
        coef = torch.stack((model._alpha[1], model.rk[1][1] / dt1m))
        scratch = df1.clone()
        calls, fresh = kernel_pair(fr, model, names, inp, scratch, df1, coef,
                                   wrappers)
        want = {names[0]: [df1],
                names[1]: list(getattr(fr, wrappers[1] + "_plain")(
                    model, *inp, df1.clone(), coef))}
        rtol = dict.fromkeys(calls, cs.RTOL_NEW if cfg == "shock_box"
                             else cs.RTOL_FIELD)
    else:
        path = {"fused_rhs" + sfx: name
                for name, sfx in cs.TEMPLATE_PATHS.items()}[args.lib]
        cfg = cs.template_cfg(pt, path, shape)
        if args.terms:
            cfg = cs.with_terms(pt, cfg, "ABC")
        model = pt.Model(cfg, device="cuda")
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
    if pp:
        # the parent's kernels through its own wrappers and model; its
        # zghost template read the stack ghosted in all three axes
        pmodel = pp.Model(getattr(pp.configs, cfg)(shape, **kw),
                          device="cuda")
        pinp = (inp if cfg != "conv_slab" else pmodel.z_slabs(fa.clone())
                if hasattr(pmodel, "z_slabs") else (pmodel.ghosted(fa),))
        variant_calls[PARENT], variant_fresh[PARENT] = kernel_pair(
            pp.ops.fused_rhs, pmodel, names, pinp, scratch, df1, coef,
            wrappers)
    if args.steps:
        # the path's step from its initial state, through each variant's
        # kernels, and the parent's own step
        steps = {spec: (model, model.make_step()) for spec in libs}
        if pp:
            steps[PARENT] = (pmodel, pmodel.make_step())
        for spec, (m, step) in steps.items():
            state = m.pack_state(m.init_state(0))

            def guarded(step=step, state=state):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return step(state)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            def run(step=step, state=state):
                return step(state)

            # the step as it is, under the sync debug mode "error" as
            # chip_smoke.py times it, the host's time to issue one (no
            # synchronize) and the card's busy time
            variant_calls[spec].update({
                "step": run, "step sync-debug": guarded, "step host": run,
                "step device": run})
        calls = dict(calls, **dict.fromkeys(
            ("step", "step sync-debug", "step host", "step device")))

    def use(spec):
        if spec in libs:
            _build._libs[args.lib] = libs[spec]

    print(f"time_loader_variants on {smi}, {shape}, {args.lib}",
          flush=True)
    first_out = {}      # --bitwise: the first checked variant's outputs
    for spec in specs:
        if spec.startswith("~"):
            print(f"variant {spec!r}: timed only, wrong by design, not "
                  f"checked", flush=True)
            continue
        use(spec)
        for k, fn in variant_calls[spec].items():
            if k.startswith("step"):
                continue
            got = variant_fresh[spec].get(k, fn)()
            got = tuple(t for t in (got if isinstance(got, tuple)
                                    else (got,)) if t.ndim)
            agree(cs, f"{spec} {k}", got, tuple(want[k]), rtol[k])
            if args.bitwise:
                ref = first_out.setdefault(k, got)
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                print(f"variant {spec or 'default'!r} {k}: "
                      + ("bit for bit the first variant's" if same else
                         "differs from the first variant's by "
                         + ", ".join(f"{float((a - b).abs().max()):.3e}"
                                     for a, b in zip(got, ref))),
                      flush=True)
        print(f"variant {spec or 'default'!r}: every kernel agrees with "
              f"its plain version", flush=True)
    times = {spec: {k: [] for k in calls} for spec in specs}
    # the SM clock and the power draw while the kernels run, every 100 ms
    sampler = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(args.reps):
        for spec in specs:
            use(spec)
            for k, fn in variant_calls[spec].items():
                times[spec][k].append(
                    host_ms(torch, fn, 5) if k == "step host"
                    else cs.device_busy(torch, fn, 5)[0]
                    if k == "step device"
                    else cs.time_ms(torch, fn, 5 if k.startswith("step")
                                    else 20))
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
        for spec in specs:
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
    try:
        rc = main()
    finally:
        # a failure stops the nvcc runs still going
        build = sys.modules.get("pencil_tpu_torch.ops._build")
        if build is not None:
            build.cancel()
    sys.exit(rc)
