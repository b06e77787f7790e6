"""Host-side run loop (counterpart of ``pencil_tpu/run.py``; reference
``src/run.f90`` Time_loop :519-869).

Everything that depends on data but is slow lives here, outside the step:
the output cadences (``it1`` diagnostics rows in ``time_series.dat``,
``isave`` rolling checkpoint ``var.npz``, ``dsnap`` snapshots
``VAR<N>.npz``, ``it1d`` plane averages ``*averages.dat``, ``d2davg``
phi averages ``averages/PHIAVG<n>``, ``dvid`` slices
``slice_<field>_<plane>.npz``, ``dspec`` spectra ``power_<field>.dat``,
the ``tavg`` running average ``timeavg.npz``, ``dsnap_down`` downsampled
snapshots ``VARd<N>.npz``, ``sound_points`` probes ``sound.dat`` and
``it_timing`` clock marks ``timing.dat``), control-file polling (STOP,
SAVE, and with a run directory RELOAD, which re-reads run.in), POSIX
signals, the ``dtmin`` abort with a crash dump, ``tmax`` and the
wall-time limit.  The steps between two diagnostics rows run as one
``make_multi_step`` chunk with no host synchronisation inside; each output
is evaluated on the model's device after the chunk and copied to the host
in one go.

Every field of ``RunParams`` keeps the JAX name and default.  Not ported:
the particle stalker (``dstalk``, ``npar_stalk``) and a sharded run;
``Run`` raises ``NotImplementedError`` when one of them is asked for.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from .io.averages import (AveragesWriter, PhiAvgWriter, ghosted_pencils,
                          make_averages, make_phi_averages)
from .io.diagnostics import make_diagnostics
from .io.slices import SliceWriter
from .io.spectra import SpectrumWriter, shell_spectrum
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
UNPORTED = ("dstalk", "npar_stalk")


def to_host(tensors):
    """Numpy copies of ``tensors`` (on one device, one dtype) made by one
    device→host copy."""
    tensors = list(tensors)
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


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
        if bad:
            raise NotImplementedError(
                f"pencil_tpu_torch.Run: not ported: {', '.join(bad)}")
        self.model = model
        self.rundir = rundir        # enables RELOAD
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
        p = self.params
        self.averages = None
        self.aver_writer = None
        if p.aver_names:
            self.averages = make_averages(model, p.aver_names)
            self.aver_writer = AveragesWriter(self.datadir, p.aver_names)
        self.phiavg = None
        if p.phiaver_names:
            self.phiavg, rcyl, drcyl = make_phi_averages(model,
                                                         p.phiaver_names)
            self.phiavg_writer = PhiAvgWriter(
                self.datadir, p.phiaver_names, model.grid, model.cfg.grid,
                rcyl, drcyl)
        self._t2davg_last = 0.0
        self._tavg_fields = None    # running time average, on the device
        self._tsnap_down_last = 0.0
        self._nsnap_down = 0
        self.slices = None
        if p.dvid > 0:
            self.slices = SliceWriter(self.datadir, p.slice_fields,
                                      p.slice_planes)
        self._tvid_last = 0.0
        self._spec_writers = {}
        if p.dspec > 0 and p.power_fields:
            self._spec_writers = {
                pf: SpectrumWriter(os.path.join(self.datadir,
                                                f"power_{pf}.dat"))
                for pf in p.power_fields}
        self._tspec_last = 0.0
        self._sound = self._sound_probes() if p.sound_points else None

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

    def _write_spectra(self, state, t):
        """One record of each power_<field>.dat: "kin" the velocity's shell
        spectrum, "mag" B's from the ghost-filled stack, any other name its
        state field's."""
        fields = self.model.unpack_state(state)["fields"]
        specs = []
        for pf in self._spec_writers:
            if pf == "kin":
                field = fields["uu"]
            elif pf == "mag":
                field = ghosted_pencils(self.model, state).bb()
            else:
                field = fields[pf]
            specs.append(shell_spectrum(field))
        for w, ek in zip(self._spec_writers.values(), to_host(specs)):
            w.append(t, ek)

    def _sound_probes(self):
        """(slot, component or None, ix, iy, iz) of each sound field, the
        indices over all probes as device tensors (reference sound.in;
        the index int((x − x0)/dx) mod n of each axis, as JAX's)."""
        gs = self.model.cfg.grid
        idx = [(int((px - gs.x0) / gs.dx) % gs.nx,
                int((py - gs.y0) / gs.dy) % gs.ny,
                int((pz - gs.z0) / gs.dz) % gs.nz)
               for px, py, pz in self.params.sound_points]
        ix, iy, iz = (torch.tensor(v, device=self.model.device)
                      for v in zip(*idx))
        return [("uu" if f.startswith("u") else f,
                 "xyz".index(f[1]) if f in ("ux", "uy", "uz") else None,
                 ix, iy, iz) for f in self.params.sound_fields]

    def _write_sound(self, state, t):
        """One row of sound.dat: t, then each probe's sound fields (reference
        write_sound, src/diagnostics.f90:497-617); one gather a field over
        all probes, one copy to the host."""
        fields = self.model.unpack_state(state)["fields"]
        cols = []
        for slot, comp, ix, iy, iz in self._sound:
            arr = fields[slot] if comp is None else fields[slot][comp]
            cols.append(arr[ix, iy, iz])
        vals = to_host([torch.stack(cols, dim=1)])[0]    # (probe, field)
        row = [f"{t:.6e}"] + [f"{float(v):.6e}" for v in vals.ravel()]
        with open(os.path.join(self.datadir, "sound.dat"), "a") as fh:
            fh.write(" ".join(row) + "\n")

    def _reload(self, state):
        """RELOAD: re-read the run directory through the loader and rebuild
        the model and its step on the same device, keeping the state and
        the generator's stream; the old model stays when the slot set
        changed (JAX run.py:173-186)."""
        from .compat.rundir import load_rundir
        cfg, _ = load_rundir(self.rundir)
        new_model = Model(cfg, device=self.model.device)
        if list(new_model.reg.slots) != list(self.model.reg.slots):
            print("RELOAD: slot set changed; keeping old model", flush=True)
            return state
        new_model.generator.set_state(self.model.generator.get_state())
        self.model = new_model
        self.step = new_model.make_step()
        self._stepk = {}
        self.diag = make_diagnostics(new_model,
                                     [c[0] for c in self.ts_writer.columns],
                                     allow_unknown=True)
        if not self.quiet:
            print("RELOAD: run parameters re-read, step rebuilt", flush=True)
        return state

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
        """Steps per call of ``_advance``.  The per-step outputs (the time
        average, the sound probes, timing.dat) force one; otherwise the
        diagnostics cadence, aligned with the other step cadences (isave,
        it1d) by their gcd.  The time-based cadences (dsnap, dvid, dspec,
        d2davg, dsnap_down) are checked at chunk boundaries, so their
        outputs can be at most it1 − 1 steps late, as the reference polls
        its control files only at the diagnostic interval."""
        if p.tavg > 0 or p.sound_points or p.it_timing:
            return 1
        chunk = max(1, p.it1)
        for cad in (p.isave, p.it1d):
            if cad:
                chunk = math.gcd(chunk, cad)
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

    def _write_outputs(self, state, i, t, dt):
        """The outputs due after step ``i`` of the loop (at time ``t``, the
        step's ``dt``), in the JAX loop's order (pencil_tpu/run.py:
        341-408): plane averages, phi averages, the time average,
        downsampled snapshots, slices, spectra."""
        p = self.params
        if p.it1d and i % p.it1d == 0 and self.averages:
            prof = self.averages(state)
            self.aver_writer.append(t, dict(zip(prof, to_host(
                prof.values()))))
        if self.phiavg and p.d2davg > 0 \
                and t - self._t2davg_last >= p.d2davg:
            self.phiavg_writer.append(t, to_host([self.phiavg(state)])[0])
            self._t2davg_last = t
        if p.tavg > 0:
            # exponential time average with weight min(dt/tavg, 1)
            # (reference timeavg.f90:77-88), a + w·(cur − a) as written:
            # torch.lerp changes its formula at w ≥ 0.5
            w = min(dt / p.tavg, 1.0)
            cur = self.model.unpack_state(state)["fields"]
            if self._tavg_fields is None:
                self._tavg_fields = {k: v.clone() for k, v in cur.items()}
            else:
                self._tavg_fields = {k: a + w * (cur[k] - a)
                                     for k, a in self._tavg_fields.items()}
            if p.isave and i % p.isave == 0:
                np.savez(os.path.join(self.datadir, "timeavg.npz"), t=t,
                         **dict(zip(self._tavg_fields, to_host(
                             self._tavg_fields.values()))))
        if p.downsampl:
            dd = p.dsnap_down or p.dsnap
            if dd > 0 and t - self._tsnap_down_last >= dd:
                # downsampled snapshot VARd<N> (reference run.f90:163-183
                # ldownsampl + wsnap_down), strided on the device
                self._nsnap_down += 1
                sx, sy, sz = (list(p.downsampl) + [1, 1, 1])[:3]
                fields = self.model.unpack_state(state)["fields"]
                np.savez(os.path.join(
                    self.datadir, f"VARd{self._nsnap_down}.npz"), t=t,
                    **dict(zip(fields, to_host(
                        v[..., ::sx, ::sy, ::sz] for v in fields.values()))))
                self._tsnap_down_last = t
        if self.slices and p.dvid > 0 and t - self._tvid_last >= p.dvid:
            self.slices.capture(self.model, state)
            self._tvid_last = t
        if self._spec_writers and t - self._tspec_last >= p.dspec:
            self._write_spectra(state, t)
            self._tspec_last = t

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
            t_step0 = time.time()
            state = self._advance(state, k)
            i += k
            it = it0 + i
            # the copy waits for the chunk, so the clock below includes it
            dt, t = torch.stack((state["dt"], state["t"])).tolist()
            # per-chunk guards, whatever the diagnostics cadence: a blow-up
            # poisons dt through the CFL (reference run.f90:843)
            if not math.isfinite(dt):
                self._checkpoint(state, "crash.npz")
                raise FloatingPointError(f"non-finite dt at it={it}")
            if p.it_timing and it % p.it_timing == 0:
                # wall-clock marks at it_timing cadence (reference
                # messages.f90:482-544)
                with open(os.path.join(self.datadir, "timing.dat"),
                          "a") as fh:
                    fh.write(f"{it} {time.time() - t_wall0:.6f} step "
                             f"{time.time() - t_step0:.6f}\n")
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
            self._write_outputs(state, i, t, dt)
            if self._sigstop or self._control("STOP"):
                break
            if self._control("SAVE"):
                self._checkpoint(state)
            if self._control("RELOAD") and self.rundir:
                # reference RELOAD: re-read run.in (src/run.f90:543-580)
                state = self._reload(state)
            if self._sound is not None:
                self._write_sound(state, t)
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
        if self.slices:
            self.slices.flush()
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
