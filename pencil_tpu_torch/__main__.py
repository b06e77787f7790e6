"""Command-line interface over a Pencil Code run directory (counterpart of
``pencil_tpu/__main__.py``; reference ``pc_start`` / ``pc_run``):

    python -m pencil_tpu_torch start  <rundir> [--seed S] [--device D]
    python -m pencil_tpu_torch run    <rundir> [--nt N] [--seed S] [--fresh]
                                               [--device D]
    python -m pencil_tpu_torch export <rundir> [--device D]

``start`` builds the initial condition (the reference's random stream
replayed for gaussian noise) and writes ``<rundir>/data/var.npz``; ``run``
time-steps from it (or from a fresh start with ``--fresh`` or without a
checkpoint), writing ``time_series.dat`` and the outputs that run.in and
the ``*aver.in`` files ask for, and polls ``data/RELOAD`` to re-read
run.in; ``export`` writes ``data/`` in the reference's layout (dim.dat,
grid.dat, var.dat, index.pro, param.nml).  ``--device`` is the card
(``cuda``) by default; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys


def _load(rundir):
    from .compat.rundir import load_print_in, load_rundir
    cfg, info = load_rundir(rundir)
    cols = load_print_in(rundir)
    return cfg, info, cols


def cmd_start(args):
    from .io.snapshot import save_snapshot
    from .model import Model
    cfg, info, _ = _load(args.rundir)
    model = Model(cfg, device=args.device)
    state = model.init_state(args.seed, overrides=info.get("init_overrides"))
    datadir = os.path.join(args.rundir, "data")
    os.makedirs(datadir, exist_ok=True)
    save_snapshot(os.path.join(datadir, "var.npz"), state, model=model)
    print(f"start: wrote {datadir}/var.npz "
          f"({cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz}, "
          f"{len(cfg.modules)} modules)")


def _run_params(rundir, info, cols, nt=0):
    """RunParams from the loader's ``info``, print.in's columns and the
    run directory's ``*aver.in`` files, as the JAX ``cmd_run`` reads them
    (pencil_tpu/__main__.py:31-64)."""
    from .run import RunParams

    def _aver_in(*names):
        out = []
        for nm in names:
            fp = os.path.join(rundir, nm)
            if os.path.exists(fp):
                with open(fp) as fh:
                    out += [ln.strip() for ln in fh
                            if ln.strip() and not ln.startswith("#")]
        return tuple(out)

    rp = info.get("run_pars", {})
    downs = rp.get("downsampl", ())
    downs = tuple(int(d) for d in (downs if isinstance(downs, list)
                                   else [downs])) if downs else ()
    return RunParams(
        nt=nt or info["nt"], it1=info["it1"], isave=info["isave"],
        dsnap=info["dsnap"], dvid=info["dvid"], print_columns=cols,
        it1d=int(rp.get("it1d", info["it1"])),
        aver_names=_aver_in("xyaver.in", "xzaver.in", "yzaver.in",
                            "zaver.in", "yaver.in"),
        phiaver_names=_aver_in("phiaver.in"),
        d2davg=float(rp.get("d2davg", info["dsnap"] or 0.0)),
        tavg=float(rp.get("tavg", 0.0)),
        downsampl=downs if any(d > 1 for d in downs) else (),
        dsnap_down=float(rp.get("dsnap_down", 0.0)))


def cmd_run(args):
    from .model import Model
    from .run import Run
    if args.sharded:
        raise NotImplementedError(
            "pencil_tpu_torch run --sharded: the port runs on one device")
    cfg, info, cols = _load(args.rundir)
    model = Model(cfg, device=args.device)
    datadir = os.path.join(args.rundir, "data")
    params = _run_params(args.rundir, info, cols, args.nt)
    run = Run(model, datadir=datadir, params=params, rundir=args.rundir)
    if os.path.exists(os.path.join(datadir, "var.npz")) and not args.fresh:
        state = run.resume()
    else:
        state = model.init_state(args.seed,
                                 overrides=info.get("init_overrides"))
    run.main_loop(state)


def cmd_export(args):
    from .compat.io_dist import export_state
    from .io.snapshot import load_snapshot
    from .model import Model
    cfg, _, _ = _load(args.rundir)
    model = Model(cfg, device=args.device)
    datadir = os.path.join(args.rundir, "data")
    state = load_snapshot(os.path.join(datadir, "var.npz"), model)
    out = os.path.join(datadir, "proc0")
    export_state(model, state, out)
    # the global files at the data directory's root (JAX __main__.py:89-99)
    for name in ("dim.dat", "grid.dat", "param.nml", "index.pro"):
        shutil.copy(os.path.join(out, name), os.path.join(datadir, name))
    print(f"export: reference-layout data dir at {datadir}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pencil_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("rundir")
        p.add_argument("--device", default="cuda",
                       help="cuda (the default) or cpu")

    p = sub.add_parser("start", help="generate initial condition (start.x)")
    common(p)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("run", help="time-step a run directory (run.x)")
    common(p)
    p.add_argument("--nt", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="not ported: raises NotImplementedError")
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing checkpoint")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("export", help="export data/ in reference layout")
    common(p)
    p.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
