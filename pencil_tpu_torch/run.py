"""Host-side run loop (counterpart of ``pencil_tpu/run.py``; reference
``src/run.f90`` Time_loop :519-869).

Everything that depends on data but is slow lives here, outside the step:
the output cadences (``it1`` diagnostics rows in ``time_series.dat``,
``isave`` rolling checkpoint ``var.npz``, ``dsnap`` snapshots
``VAR<N>.npz``), control-file polling (STOP, SAVE), POSIX signals, the
``dtmin`` abort with a crash dump, ``tmax`` and the wall-time limit.  The
steps between two diagnostics rows run as one ``make_multi_step`` chunk
with no host synchronisation inside; each row costs one device→host copy.

Ported of ``RunParams``: nt, it1, isave, dsnap, tmax, dtmin, max_walltime,
print_columns.  The other fields keep the JAX names and defaults, and
``Run`` raises ``NotImplementedError`` when one is set to another value
(averages, slices, spectra, time averages, downsampled snapshots, sound
probes, the particle stalker, timing.dat, a sharded run, RELOAD).
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Dict, Optional

import torch

from .io.diagnostics import make_diagnostics
from .io.snapshot import load_snapshot, save_snapshot
from .io.timeseries import _DEFAULT_FMT, TimeSeriesWriter
from .model import Model


@dataclasses.dataclass
class RunParams:
    """run.in-equivalent runtime parameters (reference &run_pars)."""

    nt: int = 100               # number of steps
    it1: int = 10               # diagnostics cadence (steps)
    it_timing: int = 0          # timing.dat cadence (0 = off)
    it1d: int = 0               # 1-D/2-D averages cadence (steps); 0 = off
    isave: int = 200            # rolling var.npz cadence (steps)
    dsnap: float = 0.0          # VAR<N> cadence (sim time); 0 = off
    dvid: float = 0.0           # video-slice cadence (sim time); 0 = off
    dspec: float = 0.0          # power-spectra cadence (sim time); 0 = off
    tmax: float = 1.0e37
    dtmin: float = 1.0e-10
    max_walltime: float = 0.0   # seconds; 0 = unlimited
    print_columns: tuple = ("it", "t", "dt", "urms", "umax", "rhom")
    aver_names: tuple = ()
    phiaver_names: tuple = ()
    d2davg: float = 0.0
    tavg: float = 0.0
    downsampl: tuple = ()
    dsnap_down: float = 0.0
    slice_fields: tuple = ("ux", "uz")
    slice_planes: tuple = ("xy", "xz")
    power_fields: tuple = ()
    sound_points: tuple = ()
    sound_fields: tuple = ("ux",)
    dstalk: float = 0.0
    npar_stalk: int = 0


# the fields whose features are not ported: any value but the default raises
UNPORTED = ("it_timing", "it1d", "dvid", "dspec", "aver_names",
            "phiaver_names", "d2davg", "tavg", "downsampl", "dsnap_down",
            "power_fields", "sound_points", "dstalk", "npar_stalk")


class Run:
    def __init__(self, model: Model, datadir="data",
                 params: Optional[RunParams] = None, sharded: bool = False,
                 quiet: bool = False, rundir=None):
        self.params = params or RunParams()
        defaults = RunParams()
        bad = [f for f in UNPORTED
               if getattr(self.params, f) != getattr(defaults, f)]
        if sharded:
            bad.append("sharded")
        if rundir is not None:
            bad.append("rundir (RELOAD)")
        if bad:
            raise NotImplementedError(
                f"pencil_tpu_torch.Run: not ported: {', '.join(bad)}")
        self.model = model
        self.datadir = str(datadir)
        self.quiet = quiet
        os.makedirs(self.datadir, exist_ok=True)
        cols = [c if isinstance(c, tuple)
                else (c, _DEFAULT_FMT.get(c, "E11.3"))
                for c in self.params.print_columns]
        self.ts_writer = TimeSeriesWriter(
            os.path.join(self.datadir, "time_series.dat"), cols)
        self.diag = make_diagnostics(model, [c[0] for c in cols],
                                     allow_unknown=True)
        self.step = model.make_step()
        self._stepk = {}            # chunk size → k-step function
        self._nsnap = 0
        self._tsnap_last = 0.0
        self._sigstop = False

    # ------------------------------------------------------------------
    def _control(self, name: str) -> bool:
        p = os.path.join(self.datadir, name)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False

    def _write_diag(self, state):
        """One row of time_series.dat, with one device→host copy for the
        whole row (each ``float()`` of a device scalar would be a
        synchronisation of its own)."""
        raw = self.diag(state)
        raw["it"] = state["it"]
        names = list(raw)
        row = torch.stack([raw[n].to(torch.float64) for n in names]).cpu()
        vals = dict(zip(names, row.tolist()))
        vals["it"] = int(vals["it"])
        self.ts_writer.append(vals)
        if not self.quiet:
            print(self.ts_writer.format_row(vals), flush=True)
        return vals

    def _checkpoint(self, state, name="var.npz"):
        save_snapshot(os.path.join(self.datadir, name), state,
                      model=self.model)

    def resume(self):
        """Restart from the rolling checkpoint (reference rsnap): the state
        on the model's device, the model's generator as it was."""
        return load_snapshot(os.path.join(self.datadir, "var.npz"),
                             self.model)

    def _advance(self, state, k):
        """k steps in one call (k = 1: the plain step).  The chunked
        functions are kept per k; at most three distinct k occur in a run
        (1, it1 − 1, it1)."""
        if k == 1:
            return self.step(state)
        if k not in self._stepk:
            self._stepk[k] = self.model.make_multi_step(k)
        return self._stepk[k](state)

    def _pick_chunk(self, p) -> int:
        """Steps per call of ``_advance``: the diagnostics cadence, aligned
        with the checkpoint cadence by their gcd.  The time-based cadence
        (dsnap) is checked at chunk boundaries, so its output can be at
        most it1 − 1 steps late, as the reference polls its control files
        only at the diagnostic interval."""
        chunk = max(1, p.it1)
        if p.isave:
            chunk = math.gcd(chunk, p.isave)
        return chunk

    def main_loop(self, state: Dict) -> Dict:
        """Run ``params.nt`` steps from ``state``.  While the loop runs,
        SIGTERM and SIGUSR1 behave like a STOP control file (reference
        signal_handling.f90 emergency_stop, polled run.f90:524-536); the
        handlers found on entry are put back on the way out."""
        self._sigstop = False

        def _emergency(_sig, _frm):
            self._sigstop = True
        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                old[sig] = signal.signal(sig, _emergency)
        except ValueError:
            pass    # not in the main thread: no trap
        try:
            return self._loop(state)
        finally:
            for sig, handler in old.items():
                signal.signal(sig, handler)

    def _loop(self, state: Dict) -> Dict:
        p = self.params
        t_wall0 = time.time()
        it0 = int(state["it"])
        if not self.quiet:
            print(self.ts_writer.header(), flush=True)
        self._tsnap_last = float(state["t"])
        if it0 == 0:
            # the reference prints the it = 0 row before stepping
            self._write_diag(state)
        completed = False
        gs = self.model.cfg.grid
        npoints = gs.nx * gs.ny * gs.nz
        chunk = self._pick_chunk(p)
        i = 0
        while i < p.nt:
            # run to the next diagnostics boundary: rows at it = 1, it1,
            # 2·it1, …, the step-by-step loop's cadence
            if chunk == 1:
                k = 1
            else:
                nxt = 1 if i == 0 else (i // chunk + 1) * chunk
                k = min(nxt - i, p.nt - i)
            state = self._advance(state, k)
            i += k
            it = it0 + i
            dt, t = torch.stack((state["dt"], state["t"])).tolist()
            # per-chunk guards, whatever the diagnostics cadence: a blow-up
            # poisons dt through the CFL (reference run.f90:843)
            if not math.isfinite(dt):
                self._checkpoint(state, "crash.npz")
                raise FloatingPointError(f"non-finite dt at it={it}")
            if i % p.it1 == 0 or i == 1:
                vals = self._write_diag(state)
                if not math.isfinite(vals.get("urms", 0.0)):
                    self._checkpoint(state, "crash.npz")
                    raise FloatingPointError(f"NaN diagnostics at it={it}")
            if dt < p.dtmin:
                self._checkpoint(state, "crash.npz")
                raise RuntimeError(f"dt={dt} < dtmin={p.dtmin} at it={it}")
            if p.isave and i % p.isave == 0:
                self._checkpoint(state)
            if p.dsnap > 0 and t - self._tsnap_last >= p.dsnap:
                self._nsnap += 1
                self._checkpoint(state, f"VAR{self._nsnap}.npz")
                self._tsnap_last = t
            if self._sigstop or self._control("STOP"):
                break
            if self._control("SAVE"):
                self._checkpoint(state)
            if t >= p.tmax:
                completed = True
                break
            if p.max_walltime and time.time() - t_wall0 > p.max_walltime:
                # checkpoint (below) and leave a RESUBMIT marker for the
                # queue wrapper (reference run.f90:853, :533)
                with open(os.path.join(self.datadir, "RESUBMIT"),
                          "w") as fh:
                    fh.write(f"{it}\n")
                break
            if i == 1 or i % p.it1 == 0:
                # heartbeat, so that a monitor can detect a hang
                # (reference run.f90:760-763)
                with open(os.path.join(self.datadir, "alive.info"),
                          "w") as fh:
                    fh.write(f"it={it} t={t:.6e} wall="
                             f"{time.time() - t_wall0:.1f}\n")
        else:
            completed = True
        self._checkpoint(state)
        elapsed = time.time() - t_wall0
        nsteps = int(state["it"]) - it0
        if not self.quiet and nsteps > 0:
            us_per_pt_step = elapsed * 1e6 / (nsteps * npoints)
            # the reference's universal metric (src/run.f90:945-951)
            print(f"Wall clock time/timestep/meshpoint [microsec] ="
                  f" {us_per_pt_step:.4e}", flush=True)
        if completed:
            open(os.path.join(self.datadir, "COMPLETED"), "w").close()
        return state


def simulate(cfg_or_model, nt=100, datadir="data", seed=0, resume=False,
             params: Optional[RunParams] = None, sharded=False, quiet=False,
             device="cuda"):
    """One-call entry: build the model (on the card unless
    ``device="cpu"``), initialise or resume, run ``nt`` steps."""
    model = cfg_or_model if isinstance(cfg_or_model, Model) \
        else Model(cfg_or_model, device=device)
    params = dataclasses.replace(params or RunParams(), nt=nt)
    run = Run(model, datadir=datadir, params=params, sharded=sharded,
              quiet=quiet)
    state = run.resume() if resume else model.init_state(seed)
    return run.main_loop(state)
