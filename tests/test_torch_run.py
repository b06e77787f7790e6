"""The port's run loop (``pencil_tpu_torch.run``: ``Run``, ``RunParams``,
``simulate``) and its outputs on the CPU, against the JAX package's:
``time_series.dat`` byte for byte against the JAX writer, every ported
diagnostics column against the JAX evaluator on the same state, the row
cadence, the control files, the guards, and the bit-exact restart from
``var.npz`` with the forcing draws included.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io.diagnostics import make_diagnostics as jax_diagnostics
from pencil_tpu.io.timeseries import TimeSeriesWriter as JaxWriter
from pencil_tpu.io.timeseries import parse_print_in as jax_parse_print_in
from pencil_tpu.run import RunParams as JaxRunParams
from pencil_tpu_torch.io.diagnostics import make_diagnostics
from pencil_tpu_torch.io.snapshot import load_snapshot, save_snapshot
from pencil_tpu_torch.io.timeseries import (TimeSeriesWriter, parse_print_in,
                                            read_time_series)
from pencil_tpu_torch.run import UNPORTED, Run, RunParams, simulate
from test_torch_entropy_box import config, ent_fields

torch.set_num_threads(1)

COLUMNS = ("it", "t", "dt", "urms", "umax", "u2m", "rhom", "rhomin", "rhomax",
           "ssm", "TTm", "csm", "ethm", "brms", "bmax", "b2m", "jrms", "jmax",
           "abm", "ekintot", "ethtot")
# units in the last place allowed on the extrema: one, and four on jmax,
# whose J = ∇∇·A − ∇²A is a difference of second derivatives that XLA may
# contract into fused multiply-adds and torch does not
MAXIMA = {"umax": 1, "bmax": 1, "jmax": 4, "rhomax": 1, "rhomin": 1}


def cfg8(**kw):
    return config(pt, n=8, **kw)


def its(datadir):
    return [int(v) for v in read_time_series(
        os.path.join(datadir, "time_series.dat"))["it"]]


# ---- time_series.dat ---------------------------------------------------------
def test_time_series_bytes_match_the_jax_writer(tmp_path):
    """The file a port run writes, against the JAX writer fed the same
    values: header and rows byte for byte, every ported column."""
    run = Run(pt.Model(cfg8(), device="cpu"), datadir=tmp_path / "a",
              params=RunParams(nt=4, it1=2, print_columns=COLUMNS),
              quiet=True)
    rows = []
    append = run.ts_writer.append
    run.ts_writer.append = lambda v: (rows.append(dict(v)), append(v))
    run.main_loop(run.model.init_state(0))
    assert [r["it"] for r in rows] == [0, 1, 2, 4]
    jw = JaxWriter(tmp_path / "jax.dat", run.ts_writer.columns)
    for r in rows:
        jw.append(r)
    mine = (tmp_path / "a" / "time_series.dat").read_bytes()
    assert mine == (tmp_path / "jax.dat").read_bytes()
    assert mine.startswith(b"#--it---------t----------dt-------urms---")
    assert all(np.isfinite(v).all() for v in read_time_series(
        tmp_path / "a" / "time_series.dat").values())


@pytest.mark.parametrize("val", (0.0, -1.25e-3, 3.14159e7, 1e-30, 12345678.9,
                                 float("nan")))
def test_writer_formats_as_the_jax_writer(tmp_path, val):
    """Formats with widths, overflow to asterisks, integers and negative
    values, against the JAX writer."""
    text = "it(I6)\nt(F8.3) ! a comment\ndt\nurms(E10.3)\nfoo(G9.2)\n# x\nbar"
    cols = parse_print_in(text)
    assert cols == jax_parse_print_in(text)
    vals = dict(it=7, t=val, dt=val, urms=val, foo=val, bar=val)
    a = TimeSeriesWriter(tmp_path / "a.dat", cols)
    b = JaxWriter(tmp_path / "b.dat", cols)
    for w in (a, b):
        w.append(vals)
        w.append(vals)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    assert a.header() == b.header()


# ---- the diagnostics against the JAX evaluator ------------------------------
@pytest.fixture(scope="module")
def both_rows():
    """Every ported column on one state of forced_entropy(16), from the
    JAX evaluator and from the port's."""
    jm = pj.Model(config(pj))
    pm = pt.Model(config(pt), device="cpu")
    fields = ent_fields((16, 16, 16), 5, pm.grid.z.numpy(), aa_ampl=1e-2)
    # a mean entropy well above the rounding of its cancelling parts
    fields["ss"] = fields["ss"] + np.float32(0.1)
    js = jm.init_state(2, overrides=fields)
    ps = pm.init_state(2, overrides=fields)
    want = {k: np.asarray(v) for k, v in
            jax_diagnostics(jm, COLUMNS)(js).items()}
    got = make_diagnostics(pm, COLUMNS)(ps)
    assert list(got) == list(COLUMNS)
    assert all(v.ndim == 0 for v in got.values())
    return want, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", COLUMNS)
def test_diagnostic_matches_jax(both_rows, name):
    """Means within 1e-6 relative (a staged mean, axis by axis, as JAX's);
    the maxima and minima within MAXIMA's units in the last place."""
    want, got = both_rows
    w, g = np.float32(want[name]), np.float32(got[name])
    if name in MAXIMA:
        ulp = float(np.spacing(np.abs(w)))
        assert abs(float(g) - float(w)) <= MAXIMA[name] * ulp, name
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0.0)
    if name not in ("it", "t"):
        assert w != 0.0, name               # the column is live


def test_unknown_diagnostics_raise_unless_allowed():
    """An unported name raises as JAX's unknown names do; with
    allow_unknown it prints 0, and so does a magnetic column without
    Magnetic."""
    pm = pt.Model(cfg8(magnetic=False), device="cpu")
    with pytest.raises(KeyError, match="nosuch"):
        make_diagnostics(pm, ("urms", "nosuch"))
    with pytest.raises(KeyError, match="brms"):
        make_diagnostics(pm, ("urms", "brms"))
    row = make_diagnostics(pm, ("urms", "nosuch", "brms"),
                           allow_unknown=True)(pm.init_state(0))
    assert float(row["nosuch"]) == 0.0 and float(row["brms"]) == 0.0
    assert float(row["urms"]) > 0.0


def test_box_volume_gives_a_degenerate_axis_weight_one():
    """The integrals weigh a one-point axis with 1, not its length."""
    from pencil_tpu_torch.io.diagnostics import _boxvol
    cfg = cfg8().replace(grid=pt.GridSpec(nx=8, ny=1, nz=8, Lx=2.0, Ly=5.0,
                                          Lz=3.0))

    class Pen:
        pass

    Pen.cfg = cfg
    assert _boxvol(Pen) == 6.0


# ---- RunParams ------------------------------------------------------------------
def test_run_params_mirror_jax():
    """All of the JAX fields, in order, with the same defaults."""
    mine = [(f.name, f.default) for f in dataclasses.fields(RunParams)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxRunParams)]
    assert mine == ref


@pytest.mark.parametrize("field", UNPORTED + ("sharded", "rundir"))
def test_unported_run_features_raise(tmp_path, field):
    """A field of RunParams whose feature is not ported raises when it is
    set, and so do a sharded run and RELOAD's rundir."""
    pm = pt.Model(cfg8(), device="cpu")
    default = getattr(RunParams(), field, None)
    value = {"sharded": True, "rundir": "."}.get(
        field, ("x",) if isinstance(default, tuple) else 1)
    kw = {field: value} if field in ("sharded", "rundir") else {
        "params": RunParams(**{field: value})}
    with pytest.raises(NotImplementedError, match=field):
        Run(pm, datadir=tmp_path, **kw)


# ---- the loop ---------------------------------------------------------------------
def test_row_cadence_and_outputs(tmp_path):
    """Rows at it = 0, 1, it1, 2·it1, … and at nt; the rolling checkpoint
    at isave and at the end; COMPLETED and the heartbeat."""
    s = simulate(cfg8(), nt=7, datadir=tmp_path, quiet=True, device="cpu",
                 params=RunParams(it1=3, isave=6))
    assert int(s["it"]) == 7 and "fields" in s
    assert its(tmp_path) == [0, 1, 3, 6]
    assert sorted(os.listdir(tmp_path)) == ["COMPLETED", "alive.info",
                                            "time_series.dat", "var.npz"]
    assert int(load_snapshot(tmp_path / "var.npz", device="cpu")["it"]) == 7


def test_simulate_defaults_to_the_card(tmp_path):
    """With no device named, simulate builds its model on the card; without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        s = simulate(cfg8(), nt=1, datadir=tmp_path, quiet=True)
        assert s["t"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA device.*device='cpu'"):
        simulate(cfg8(), nt=1, datadir=tmp_path, quiet=True)


def test_wall_clock_line_is_printed(tmp_path, capsys):
    simulate(cfg8(), nt=2, datadir=tmp_path, device="cpu",
             params=RunParams(it1=1))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("#--it-")
    assert out[-1].startswith(
        "Wall clock time/timestep/meshpoint [microsec] = ")
    assert len(out) == 1 + 3 + 1


def test_dsnap_writes_numbered_snapshots(tmp_path):
    simulate(cfg8(), nt=4, datadir=tmp_path, quiet=True, device="cpu",
             params=RunParams(it1=1, isave=0, dsnap=0.5))
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("VAR"))
    assert names[:2] == ["VAR1.npz", "VAR2.npz"]
    t1 = float(load_snapshot(tmp_path / "VAR1.npz", device="cpu")["t"])
    assert t1 >= 0.5


def test_stop_file_ends_the_run(tmp_path):
    """STOP is polled at each chunk boundary, removed, and ends the run
    with a checkpoint and no COMPLETED."""
    (tmp_path / "STOP").touch()
    s = simulate(cfg8(), nt=9, datadir=tmp_path, quiet=True, device="cpu",
                 params=RunParams(it1=3))
    assert int(s["it"]) == 1
    names = os.listdir(tmp_path)
    assert "STOP" not in names and "COMPLETED" not in names
    assert int(load_snapshot(tmp_path / "var.npz", device="cpu")["it"]) == 1


def test_sigusr1_stops_like_a_stop_file(tmp_path):
    """A signal during the loop ends the run at the next chunk boundary
    with a checkpoint; the handlers found on entry come back."""
    import signal
    before = signal.getsignal(signal.SIGUSR1)
    run = Run(pt.Model(cfg8(), device="cpu"), datadir=tmp_path, quiet=True,
              params=RunParams(nt=9, it1=3))
    advance = run._advance

    def advance_then_signal(state, k):
        os.kill(os.getpid(), signal.SIGUSR1)
        return advance(state, k)

    run._advance = advance_then_signal
    s = run.main_loop(run.model.init_state(0))
    assert int(s["it"]) == 1
    assert not (tmp_path / "COMPLETED").exists()
    assert (tmp_path / "var.npz").exists()
    assert signal.getsignal(signal.SIGUSR1) is before


def test_save_file_checkpoints(tmp_path):
    (tmp_path / "SAVE").touch()
    run = Run(pt.Model(cfg8(), device="cpu"), datadir=tmp_path, quiet=True,
              params=RunParams(nt=3, it1=3, isave=0))
    saved = []
    checkpoint = run._checkpoint
    run._checkpoint = lambda st, name="var.npz": (
        saved.append((int(st["it"]), name)), checkpoint(st, name))
    run.main_loop(run.model.init_state(0))
    assert saved == [(1, "var.npz"), (3, "var.npz")]
    assert not (tmp_path / "SAVE").exists()
    assert (tmp_path / "COMPLETED").exists()


def test_dtmin_raises_and_leaves_a_crash_dump(tmp_path):
    with pytest.raises(RuntimeError, match="dtmin"):
        simulate(cfg8(), nt=5, datadir=tmp_path, quiet=True, device="cpu",
                 params=RunParams(it1=2, dtmin=10.0))
    assert (tmp_path / "crash.npz").exists()
    assert not (tmp_path / "COMPLETED").exists()
    crash = load_snapshot(tmp_path / "crash.npz", device="cpu")
    assert int(crash["it"]) == 1 and float(crash["dt"]) < 10.0


def test_non_finite_state_raises_and_leaves_a_crash_dump(tmp_path):
    pm = pt.Model(cfg8(), device="cpu")
    state = pm.init_state(0)
    state["fields"]["lnrho"][0, 0, 0] = float("nan")
    run = Run(pm, datadir=tmp_path, quiet=True, params=RunParams(nt=4, it1=2))
    with pytest.raises(FloatingPointError):
        run.main_loop(state)
    assert (tmp_path / "crash.npz").exists()


def test_tmax_completes_and_walltime_asks_to_resubmit(tmp_path):
    s = simulate(cfg8(), nt=50, datadir=tmp_path / "a", quiet=True,
                 device="cpu", params=RunParams(it1=1, tmax=0.9))
    assert 0 < int(s["it"]) < 50 and float(s["t"]) >= 0.9
    assert (tmp_path / "a" / "COMPLETED").exists()
    s = simulate(cfg8(), nt=50, datadir=tmp_path / "b", quiet=True,
                 device="cpu", params=RunParams(it1=5, max_walltime=1e-9))
    assert int(s["it"]) == 1
    assert (tmp_path / "b" / "RESUBMIT").read_text() == "1\n"
    assert not (tmp_path / "b" / "COMPLETED").exists()


# ---- snapshots and restart -------------------------------------------------------
@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_restart_from_var_npz_is_bit_exact(tmp_path, magnetic):
    """4 forced steps, a checkpoint, a new model that resumes and takes 4
    more: the fields, t and dt of 8 steps in one go, bit for bit, the
    forcing draws included."""
    cfg = cfg8(magnetic=magnetic)
    whole = simulate(cfg, nt=8, datadir=tmp_path / "whole", quiet=True,
                     device="cpu", params=RunParams(it1=4, isave=4), seed=3)
    simulate(cfg, nt=4, datadir=tmp_path / "parts", quiet=True, device="cpu",
             params=RunParams(it1=4, isave=4), seed=3)
    again = simulate(cfg, nt=4, datadir=tmp_path / "parts", quiet=True,
                     device="cpu", params=RunParams(it1=4, isave=4),
                     resume=True)
    assert int(again["it"]) == 8
    for key in ("t", "dt"):
        assert torch.equal(again[key], whole[key]), key
    for k, v in whole["fields"].items():
        assert torch.equal(again["fields"][k], v), k
    assert its(tmp_path / "parts") == [0, 1, 4, 5, 8]
    # without the generator's state the forcing draws differ
    pm = pt.Model(cfg, device="cpu")
    st = load_snapshot(tmp_path / "whole" / "var.npz", device="cpu")
    assert int(st["it"]) == 8 and list(st["fields"]) == list(pm.reg.slots)


def test_snapshot_holds_the_jax_array_names(tmp_path):
    """field_<name>, t, dt, it, extra_json and key, written through a
    .tmp file; a packed state needs the model."""
    pm = pt.Model(cfg8(), device="cpu")
    state = pm.make_step()(pm.init_state(1))
    path = tmp_path / "sub" / "var.npz"
    save_snapshot(path, pm.pack_state(state), extra={"note": 1}, model=pm)
    assert not os.path.exists(str(path) + ".tmp")
    with np.load(path) as z:
        assert sorted(z.files) == ["dt", "extra_json", "field_aa",
                                   "field_lnrho", "field_ss", "field_uu",
                                   "it", "key", "t"]
        assert z["field_uu"].dtype == np.float32 and z["it"].dtype == np.int32
    draws = pm.forcing.draw(pm._ftables, pm.generator)
    back = load_snapshot(path, pm)
    assert back["extra"] == {"note": 1}
    for a, b in zip(pm.forcing.draw(pm._ftables, pm.generator), draws):
        assert torch.equal(a, b)            # the generator is where it was
    for k, v in state["fields"].items():
        assert torch.equal(back["fields"][k], v)
    with pytest.raises(ValueError, match="model"):
        save_snapshot(path, pm.pack_state(state))
    with pytest.raises(ValueError, match="model or a device"):
        load_snapshot(path)
