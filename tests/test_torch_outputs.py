"""The run driver's outputs in the port (``pencil_tpu_torch.io.spectra``,
``io.averages``, ``io.slices``, ``post.read`` and the output side of
``Run``) against the JAX package's on the CPU: the same state, made from
a numpy seed, through both packages' evaluators, the writers' files byte
for byte, the port's readers on the JAX writers' files, and both run
loops with every output on, file by file.

Bounds: a pointwise output (an average, a slice, a field) within 2e-5 of
the quantity's max (tests/test_fused.py's parity bound); a spectrum within
2e-6 × max_k E(k): both packages sum the same f32 |f̂|² into the same
shells, and their FFTs differ by rounding, a few units of f32's 6e-8 times
log2 N per mode (at most 4.2e-7 × max_k E(k) seen at 16×12×10).
"""
import os
import struct

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.io import averages as javer
from pencil_tpu.io import slices as jslices
from pencil_tpu.io import spectra as jspec
from pencil_tpu.io.snapshot import save_snapshot as jax_save_snapshot
from pencil_tpu.io.timeseries import TimeSeriesWriter as JaxTSWriter
from pencil_tpu.post import read as jread
from pencil_tpu.run import Run as JaxRun
from pencil_tpu.run import RunParams as JaxRunParams
from pencil_tpu_torch.configs import forced_entropy
from pencil_tpu_torch.io import averages as paver
from pencil_tpu_torch.io import slices as pslices
from pencil_tpu_torch.io import spectra as pspec
from pencil_tpu_torch.post import read as pread
from pencil_tpu_torch.run import Run, RunParams
from test_torch_entropy_box import ent_fields

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_SPEC = 2e-6
SHAPE = (8, 12, 10)          # unequal axes: a swapped axis shows


def cfg(pkg, shape=SHAPE, forcing=True):
    c = forced_entropy(shape, fused=False, pkg=pkg)
    if not forcing:
        c = c.replace(modules=tuple(m for m in c.modules
                                    if m.name != "forcing"))
    return c


def assert_pointwise(got, want, what, scale=None):
    """Within RTOL_FIELD of ``scale``, the max of the quantity on the grid
    (by default the max of ``want``): an average can vanish where its
    quantity does not (<B_z>_xy of a periodic A is zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = float(np.abs(want).max())
    scale = max(scale, 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL_FIELD * scale, (what, err, scale)


def assert_spectrum(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= RTOL_SPEC * float(np.abs(want).max()), (what, err)


@pytest.fixture(scope="module")
def models():
    """One state of the MHD entropy set in both packages, from numpy."""
    jm, pm = pj.Model(cfg(pj)), pt.Model(cfg(pt), device="cpu")
    fields = ent_fields(SHAPE, 5, pm.grid.z.numpy(), aa_ampl=1e-2)
    js = jm.init_state(2, overrides=fields)
    ps = pm.init_state(2, overrides=fields)
    return jm, js, pm, ps


# ---- spectra ----------------------------------------------------------------
def _red_field(seed):
    """A vector field with a large k = 1 mode over noise."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((3,) + (16, 12, 10)).astype(np.float32)
    x = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    u[0] += (5.0 * np.sin(x)[:, None, None]).astype(np.float32)
    return u


SPECTRA = {
    "shell-vector": lambda m, u, w: m.shell_spectrum(u, None),
    "shell-scalar": lambda m, u, w: m.shell_spectrum(u[1], None),
    "1d-x": lambda m, u, w: m.spectrum_1d(u, 0),
    "1d-y": lambda m, u, w: m.spectrum_1d(u, 1),
    "1d-z": lambda m, u, w: m.spectrum_1d(u[2], 2),
    "xy": lambda m, u, w: m.spectrum_xy(u),
    "helicity-energy": lambda m, u, w: m.helicity_spectrum(u, w, None)[0],
    "helicity": lambda m, u, w: m.helicity_spectrum(u, w, None)[1],
}


@pytest.mark.parametrize("case", SPECTRA)
def test_spectrum_matches_jax(case):
    import jax.numpy as jnp
    u = _red_field(1)
    w = u[::-1].copy()          # a second field, for the helicity
    want = np.asarray(SPECTRA[case](jspec, jnp.asarray(u), jnp.asarray(w)))
    got = SPECTRA[case](pspec, torch.tensor(u), torch.tensor(w))
    assert got.dtype == torch.float32
    assert_spectrum(got.numpy(), want, case)


def test_shell_spectrum_parseval():
    """The sum over every wavevector is 0.5<|u|²>; the shells stop at n/2
    and leave out the corners of the cube."""
    u = torch.tensor(_red_field(2))
    ek = pspec.shell_spectrum(u)
    energy = 0.5 * float((u.double() ** 2).sum(0).mean())
    assert ek.shape == (8,)
    assert float(ek.sum()) <= energy * (1 + 1e-6)
    fk = torch.fft.fftn(u.double(), dim=(-3, -2, -1)) / u[0].numel()
    assert float(0.5 * (fk.abs() ** 2).sum()) == pytest.approx(energy,
                                                               rel=1e-12)


# ---- averages -----------------------------------------------------------------
AVER_NAMES = ([f"{q}mz" for q in javer.QUANTS]
              + ["uxmy", "bymx", "rhomxy", "uzmxz", "bzmyz"])


@pytest.fixture(scope="module")
def both_averages(models):
    jm, js, pm, ps = models
    want = javer.make_averages(jm, AVER_NAMES)(js)
    got = paver.make_averages(pm, AVER_NAMES)(pm.pack_state(ps))
    pen = paver.ghosted_pencils(pm, ps)
    scale = {q: float(fn(pen).abs().max()) for q, fn in paver.QUANTS.items()}
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, scale)


@pytest.mark.parametrize("name", AVER_NAMES)
def test_average_matches_jax(both_averages, name):
    """One case per QUANTS entry (z profiles) and one per suffix."""
    want, got, scale = both_averages
    q, _ = paver.parse_aver_name(name)
    assert (q, _) == javer.parse_aver_name(name)
    assert_pointwise(got[name], want[name], name, scale[q])


def test_average_names_and_quants_mirror_jax():
    assert list(paver.QUANTS) == list(javer.QUANTS)
    assert paver.PLANE_FILES == javer.PLANE_FILES
    with pytest.raises(KeyError, match="nosuch"):
        paver.parse_aver_name("nosuchmz")


def test_phi_averages_match_jax(models):
    jm, js, pm, ps = models
    names = ("uzmphi", "bzmphi", "oum")
    jev, jr, jdr = javer.make_phi_averages(jm, names)
    pev, pr, pdr = paver.make_phi_averages(pm, names)
    assert np.array_equal(pr, jr) and pdr == jdr
    got = pev(ps)
    assert got.dtype == torch.float32 and got.shape == (3, 4, SHAPE[2])
    want = np.asarray(jev(js))
    for c, n in enumerate(names):
        assert_pointwise(got[c].numpy(), want[c], n)


@pytest.mark.parametrize("plane", tuple(jslices.PLANES))
def test_slice_capture_matches_jax(models, tmp_path, plane):
    jm, js, pm, ps = models
    jw = jslices.SliceWriter(tmp_path / "j", ("ux", "bz", "TT"), (plane,))
    pw = pslices.SliceWriter(tmp_path / "p", ("ux", "bz", "TT"), (plane,))
    jw.capture(jm, js)
    pw.capture(pm, pm.pack_state(ps))
    assert pw._t == jw._t
    assert list(pw._buf) == list(jw._buf)
    for key, frames in jw._buf.items():
        assert_pointwise(pw._buf[key][0], frames[0], key)
    jw.flush()
    pw.flush()
    for key in (f"{f}_{plane}" for f in ("ux", "bz", "TT")):
        t, data = pslices.read_slices(tmp_path / "p" / f"slice_{key}.npz")
        tj, dj = jslices.read_slices(tmp_path / "j" / f"slice_{key}.npz")
        assert np.array_equal(t, tj) and data.shape == dj.shape


# ---- the writers, byte for byte ----------------------------------------------
def test_spectrum_writer_bytes(tmp_path):
    ek = np.abs(np.random.default_rng(3).standard_normal(19)).astype(
        np.float32)
    for mod, name in ((jspec, "j.dat"), (pspec, "p.dat")):
        w = mod.SpectrumWriter(tmp_path / name)
        w.append(0.125, ek)
        w.append(1.5e-3, ek[::-1])
    assert (tmp_path / "p.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()
    t, spec = pspec.read_spectrum(tmp_path / "p.dat")
    assert list(t) == [0.125, 1.5e-3] and spec.shape == (2, 19)


def test_averages_writer_bytes(tmp_path):
    rng = np.random.default_rng(4)
    names = ("uxmz", "bymz", "rhomy", "uzmx", "bzmxy", "uxmxz")
    shapes = {"uxmz": (10,), "bymz": (10,), "rhomy": (12,), "uzmx": (8,),
              "bzmxy": (8, 12), "uxmxz": (8, 10)}
    vals = {n: rng.standard_normal(shapes[n]).astype(np.float32)
            for n in names}
    for mod, sub in ((javer, "j"), (paver, "p")):
        os.makedirs(tmp_path / sub)
        w = mod.AveragesWriter(tmp_path / sub, names)
        w.append(0.5, vals)
        w.append(1.25, vals)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) == sorted(
        javer.PLANE_FILES.values())
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    t, got = paver.read_averages(tmp_path / "p" / "xyaverages.dat",
                                 ["uxmz", "bymz"], {"uxmz": 10, "bymz": 10})
    assert list(t) == [0.5, 1.25] and got["bymz"].shape == (2, 10)
    # no file takes the x-averages: the JAX writer fails at its first
    # append, the port's where it is made
    with pytest.raises(KeyError):
        paver.AveragesWriter(tmp_path / "p", ("uxmyz",))
    with pytest.raises(KeyError):
        javer.AveragesWriter(tmp_path / "j", ("uxmyz",)).append(
            0.0, {"uxmyz": np.zeros((12, 10), np.float32)})


def test_phi_average_writer_bytes(tmp_path, models):
    jm, _, pm, _ = models
    names = ("uzmphi", "bzmphi")
    _, rcyl, drcyl = paver.make_phi_averages(pm, names)
    data = np.random.default_rng(5).standard_normal(
        (2, 4, SHAPE[2])).astype(np.float32)
    for mod, m, sub in ((javer, jm, "j"), (paver, pm, "p")):
        w = mod.PhiAvgWriter(tmp_path / sub, names, m.grid, m.cfg.grid, rcyl,
                             drcyl)
        w.append(0.25, data)
        w.append(0.5, data[::-1])
    for f in ("PHIAVG1", "PHIAVG2", "phiavg.list", "phiavg.files"):
        assert (tmp_path / "p" / "averages" / f).read_bytes() == \
            (tmp_path / "j" / "averages" / f).read_bytes(), f
    raw = (tmp_path / "p" / "averages" / "PHIAVG1").read_bytes()
    assert struct.unpack("<i4ii", raw[:24]) == (16, 4, SHAPE[2], 2, 1, 16)


# ---- post.read on the JAX writers' files --------------------------------------
def _jax_outputs(tmp_path, models):
    """Files from the JAX writers in one data directory."""
    jm, js, _, _ = models
    d = tmp_path / "data"
    os.makedirs(d)
    ts = JaxTSWriter(d / "time_series.dat",
                     [("it", "I9"), ("t", "E12.4"), ("urms", "E10.3")])
    ts.append({"it": 0, "t": 0.0, "urms": 1.5e-2})
    ts.append({"it": 10, "t": 0.25, "urms": 2.5e-2})
    jax_save_snapshot(str(d / "var.npz"), js)
    jax_save_snapshot(str(d / "VAR2.npz"), js)
    jax_save_snapshot(str(d / "VAR10.npz"), js)
    sw = jslices.SliceWriter(d, ("uz",), ("xz",))
    sw.capture(jm, js)
    sw.capture(jm, js)
    sw.flush()
    aw = javer.AveragesWriter(d, ("uxmz", "rhomz"))
    vals = javer.make_averages(jm, ("uxmz", "rhomz"))(js)
    aw.append(0.0, {k: np.asarray(v) for k, v in vals.items()})
    jspec.SpectrumWriter(d / "power_kin.dat").append(
        0.0, np.asarray(jspec.shell_spectrum(js["fields"]["uu"], None)))
    return d


READERS = {
    "ts": (lambda m, d: m.ts(d), ("t", "urms", "it")),
    "var": (lambda m, d: m.var("var.npz", d),
            ("uu", "lnrho", "ss", "aa", "t", "dt", "it")),
    "slices": (lambda m, d: m.slices("uz", "xz", d), ("t", "data")),
    "power": (lambda m, d: m.power("kin", d), ("t", "spec")),
}


@pytest.mark.parametrize("reader", sorted(READERS) + ["aver", "snapshots"])
def test_post_read_reads_the_jax_files(tmp_path, models, reader):
    d = _jax_outputs(tmp_path, models)
    if reader == "snapshots":
        assert pread.snapshots(d) == jread.snapshots(d)
        assert [os.path.basename(p) for p in pread.snapshots(d)] == [
            "VAR2.npz", "VAR10.npz"]
        return
    if reader == "aver":
        shape = {"uxmz": SHAPE[2], "rhomz": SHAPE[2]}
        got = pread.aver(d, ["uxmz", "rhomz"], shape)
        t, want = javer.read_averages(d / "xyaverages.dat",
                                      ["uxmz", "rhomz"], shape)
        assert np.array_equal(got.t, t)
        for k in want:
            assert np.array_equal(getattr(got, k), want[k])
        return
    fn, keys = READERS[reader]
    got, want = fn(pread, d), fn(jread, d)
    for k in keys:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == w.shape and np.array_equal(g, w), (reader, k)


def test_post_read_refuses_what_is_not_ported(tmp_path):
    """The HDF5 snapshot (the reference var.dat is read since its codec
    was ported)."""
    (tmp_path / "var.h5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="var.h5"):
        pread.var("var.h5", tmp_path)


# ---- both run loops with every output ----------------------------------------
RUN_SHAPE = (8, 8, 12)
RUN_KW = dict(
    nt=6, it1=2, isave=3, dspec=0.5, power_fields=("kin", "mag"),
    aver_names=("uxmz", "bymz", "rhomy", "uzmx", "bzmxy", "oummxz"), it1d=2,
    phiaver_names=("uzmphi", "bzmphi"), d2davg=0.7, dvid=0.6,
    slice_fields=("ux", "bz"), slice_planes=("xy", "xz", "yz"),
    tavg=0.8, downsampl=(2, 2, 3), dsnap_down=0.9,
    sound_points=((0.1, -0.2, 0.3), (1.0, 2.0, -3.0), (-3.0, 0.0, 3.1)),
    sound_fields=("ux", "lnrho"), it_timing=1,
    print_columns=(("it", "I9"), ("t", "E16.8"), ("dt", "E16.8"),
                   ("urms", "E16.8"), ("oum", "E16.8"), ("jbm", "E16.8"),
                   ("bmz", "E16.8"), ("epsK", "E16.8")))


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """6 unforced steps of the MHD entropy set at 8×8×12 in both run loops
    from one state, every ported output on."""
    base = tmp_path_factory.mktemp("runs")
    jm = pj.Model(cfg(pj, RUN_SHAPE, forcing=False))
    pm = pt.Model(cfg(pt, RUN_SHAPE, forcing=False), device="cpu")
    fields = ent_fields(RUN_SHAPE, 7, pm.grid.z.numpy(), aa_ampl=1e-2)
    JaxRun(jm, datadir=base / "j", params=JaxRunParams(**RUN_KW),
           quiet=True).main_loop(jm.init_state(1, overrides=fields))
    Run(pm, datadir=base / "p", params=RunParams(**RUN_KW),
        quiet=True).main_loop(pm.init_state(1, overrides=fields))
    return base / "j", base / "p"


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_runs_write_the_same_files(both_runs):
    jd, pd = both_runs
    assert _files(pd) == _files(jd)
    assert {"power_kin.dat", "power_mag.dat", "xyaverages.dat",
            "xzaverages.dat", "yzaverages.dat", "zaverages.dat",
            "yaverages.dat", "averages/PHIAVG1", "slice_bz_yz.npz",
            "timeavg.npz", "VARd1.npz", "sound.dat",
            "timing.dat"} <= set(_files(pd))
    for f in ("averages/phiavg.list", "averages/phiavg.files"):
        assert (pd / f).read_bytes() == (jd / f).read_bytes()


def test_runs_time_series_and_timing(both_runs):
    jd, pd = both_runs
    got, want = pread.ts(pd), jread.ts(jd)
    assert got.keys == want.keys and list(got.it) == [0, 1, 2, 4, 6]
    for k in want.keys:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=RTOL_FIELD, atol=0.0, err_msg=k)
    rows = [(pd / "timing.dat").read_text().split(),
            (jd / "timing.dat").read_text().split()]
    assert len(rows[0]) == len(rows[1]) == 6 * 4
    assert rows[0][0::4] == rows[1][0::4] == [str(i) for i in range(1, 7)]
    assert set(rows[0][2::4]) == {"step"}


@pytest.mark.parametrize("name", ("kin", "mag"))
def test_runs_spectra(both_runs, name):
    jd, pd = both_runs
    t, spec = pspec.read_spectrum(pd / f"power_{name}.dat")
    tj, specj = jspec.read_spectrum(jd / f"power_{name}.dat")
    assert len(t) == len(tj) >= 3
    np.testing.assert_allclose(t, tj, rtol=1e-5)
    for a, b in zip(spec, specj):
        assert_spectrum(a, b, name)


def test_runs_plane_and_phi_averages(both_runs):
    jd, pd = both_runs
    shapes = {"uxmz": 12, "bymz": 12, "rhomy": 8, "uzmx": 8, "bzmxy": 64,
              "oummxz": 96}
    groups = {"xyaverages.dat": ["uxmz", "bymz"], "xzaverages.dat":
              ["rhomy"], "yzaverages.dat": ["uzmx"], "zaverages.dat":
              ["bzmxy"], "yaverages.dat": ["oummxz"]}
    for f, names in groups.items():
        t, got = paver.read_averages(pd / f, names, shapes)
        tj, want = javer.read_averages(jd / f, names, shapes)
        assert len(t) == len(tj) == 3
        np.testing.assert_allclose(t, tj, rtol=1e-5)
        for n in names:
            for a, b in zip(got[n], want[n]):
                assert_pointwise(a, b, n)
    nphi = len([f for f in _files(pd) if f.startswith("averages/PHIAVG")])
    assert nphi == len([f for f in _files(jd)
                        if f.startswith("averages/PHIAVG")]) >= 2
    for k in range(1, nphi + 1):
        a, b = (_records((d / "averages" / f"PHIAVG{k}").read_bytes())
                for d in (pd, jd))
        assert len(a) == len(b) == 4
        assert a[0] == b[0] and a[3] == b[3]    # the sizes, the labels
        np.testing.assert_allclose(np.frombuffer(a[1], np.float32),
                                   np.frombuffer(b[1], np.float32),
                                   rtol=1e-5)   # t, r, z, dr, dz
        nr, nz, nc, _ = struct.unpack("<4i", a[0])
        da, db = (np.frombuffer(r, np.float32).reshape(nr, nz, nc)
                  for r in (a[2], b[2]))
        for c in range(nc):
            assert_pointwise(da[..., c], db[..., c], f"PHIAVG{k} {c}")


def _records(raw):
    """The payloads of a file of Fortran unformatted records."""
    out, off = [], 0
    while off < len(raw):
        n = struct.unpack("<i", raw[off:off + 4])[0]
        out.append(raw[off + 4:off + 4 + n])
        assert raw[off + 4 + n:off + 8 + n] == raw[off:off + 4]
        off += 8 + n
    return out


def test_runs_slices_time_averages_and_snapshots(both_runs):
    jd, pd = both_runs
    for f in _files(jd):
        if f.startswith("slice_"):
            t, data = pslices.read_slices(pd / f)
            tj, dataj = jslices.read_slices(jd / f)
            assert len(t) == len(tj) >= 3
            np.testing.assert_allclose(t, tj, rtol=1e-5)
            assert_pointwise(data, dataj, f)
        elif f == "timeavg.npz" or f.startswith("VARd"):
            with np.load(pd / f) as z, np.load(jd / f) as zj:
                assert sorted(z.files) == sorted(zj.files)
                np.testing.assert_allclose(z["t"], zj["t"], rtol=1e-5)
                for k in zj.files:
                    if k != "t":
                        assert z[k].dtype == np.float32
                        assert_pointwise(z[k], zj[k], f"{f} {k}")


def test_runs_sound_probes(both_runs):
    jd, pd = both_runs
    got = np.loadtxt(pd / "sound.dat")
    want = np.loadtxt(jd / "sound.dat")
    assert got.shape == want.shape == (6, 1 + 3 * 2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    for c in range(1, 7):
        assert_pointwise(got[:, c], want[:, c], f"sound column {c}")
