"""The builds of the flagship template (csrc/fused_rhs.cu) as far as the
CPU can hold them: the libraries and their -D definitions, the library
each shock-box, shear-box and conv-slab wrapper launches on a CUDA
tensor, and the ctypes mirror of the kernels' constants against the C
struct.

The kernels themselves run only on the card (tests/test_torch_gpu.py);
here a wrapper's launch is recorded instead of made, by replacing the
loader's entry point.
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import (conv_slab, flagship, shear_box,
                                     shock_box, with_shock_diffusion)
from pencil_tpu_torch.ops import _build
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.ops.stencil import NGHOST

SHAPE = (16, 16, 32)


def test_libraries_hold_the_shock_builds_and_no_zroll():
    """The shock builds are the flagship source with their -D
    definitions; the 4×4×16 template is gone from the build and from
    csrc/."""
    libs = _build.LIBRARIES
    assert libs["fused_rhs_shock"] == ("fused_rhs.cu", ("-DPC_SHOCK=1",))
    assert libs["fused_rhs_shear"] == ("fused_rhs.cu",
                                       ("-DPC_SHOCK=1", "-DPC_SHEAR=1"))
    assert "zroll_rhs" not in libs and "zroll_rhs" not in _build.SIGNATURES
    assert not (_build.CSRC / "zroll_rhs.cu").exists()
    for lib in ("fused_rhs_shock", "fused_rhs_shear"):
        assert set(_build.SIGNATURES[lib]) == {
            "pc_tile_shape", "pc_flagship_attrs", "pc_rhs_first",
            "pc_rhs_tail_mid"}


_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
name = {names}[tuple(a for a in args if a.startswith("-D"))]
with open({log!r}, "a") as f:
    f.write(f"start {{name}}\\n")
time.sleep(0.2)
with open({log!r}, "a") as f:
    f.write(f"end {{name}}\\n")
if name == "fused_rhs_zg":
    print("fake nvcc: refused")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").close()
"""


def test_build_starts_the_longest_first_one_per_cpu(tmp_path, monkeypatch):
    """The nvcc runs start in the background, the periodic builds first,
    then the z-ghosted ones with ss (with and without the shock slot),
    then the shock and shear builds, at most one
    per CPU at a time; waiting for one library does not wait for the
    rest, and a failed run raises with nvcc's output while the others
    are built (a fake nvcc that logs its runs)."""
    import sys
    log = tmp_path / "runs.log"
    nvcc = tmp_path / "nvcc"
    names = {defs: name for name, (_, defs) in _build.LIBRARIES.items()}
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, names=names,
                                      log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_job", None)
    monkeypatch.setattr(_build.os, "cpu_count", lambda: 2)
    job = _build.start()
    _build._wait(job, ["fused_rhs"])
    assert _build.library_path("fused_rhs").exists()
    with pytest.raises(RuntimeError, match="(?s)fused_rhs_zg .*fake nvcc: refused"):
        _build.build()
    runs = log.read_text().split()
    events = list(zip(runs[::2], runs[1::2]))
    started = [name for word, name in events if word == "start"]
    # two runs start together: their log lines may come in either order
    assert set(started[:4]) == {"fused_rhs", "fused_rhs_ent",
                                "fused_rhs_hydro_ent", "fused_rhs_hydro"}
    assert set(started[4:10]) == {"fused_rhs_zg_mag", "fused_rhs_zg",
                                  "fused_rhs_zg_mag_shear",
                                  "fused_rhs_zg_shear",
                                  "fused_rhs_zg_mag_shock",
                                  "fused_rhs_zg_shock"}
    assert sorted(started) == sorted(_build.LIBRARIES)
    at_once = peak = 0
    for word, _ in events:
        at_once += 1 if word == "start" else -1
        peak = max(peak, at_once)
    assert peak <= 2
    built = sorted(p.name.rsplit("_", 1)[0]
                   for p in (tmp_path / "build").iterdir())
    assert built == sorted(set(_build.LIBRARIES) - {"fused_rhs_zg"})


def test_libraries_hold_the_zg_build_and_no_zghost_template():
    """K6 and K7 are the flagship source built with PC_ZG=1 on the 5-field
    entropy-hydro layout, K6m and K7m the same on the 8-field entropy MHD
    layout (PC_MAG left at 1), each with the shock builds' four entry
    points, a Coriolis instance (+16), a del6 one (+32, launch names with
    _h3) and a chi-const one (+64, launch names with _chi) of both
    kernels, each with or without the others, and an upwinding one (+128,
    launch names with _upw) with or without Coriolis and chi-const, never
    beside del6; the 4x4x16 zghost template
    is gone from the build and from csrc/."""
    libs = _build.LIBRARIES
    assert libs["fused_rhs_zg"] == ("fused_rhs.cu", (
        "-DPC_MAG=0", "-DPC_ENT=1", "-DPC_ZG=1"))
    assert libs["fused_rhs_zg_mag"] == ("fused_rhs.cu", (
        "-DPC_ENT=1", "-DPC_ZG=1"))
    assert "zghost_rhs" not in libs and "zghost_rhs" not in _build.SIGNATURES
    assert not (_build.CSRC / "zghost_rhs.cu").exists()
    assert sorted(p.name for p in _build.CSRC.iterdir()) == [
        "fused_rhs.cu", "stencil.cuh"]
    for lib, (first, upd) in (("fused_rhs_zg", ("rhs_zg", "rhs_zg_upd")),
                              ("fused_rhs_zg_mag",
                               ("rhs_zg_mag", "rhs_zg_upd_mag"))):
        sig = _build.SIGNATURES[lib]
        assert set(sig) == set(_build.SIGNATURES["fused_rhs_shock"])
        # the slabs, the two profiles, K(z) of 'K-profile', g_z(z) and the
        # continuous forcing follow the stream
        assert len(sig["pc_rhs_first"]) == 5 + 7
        assert len(sig["pc_rhs_tail_mid"]) == 7 + 7
        assert fr.ZG_KERNELS[lib] == (first, upd)
        assert fr.library_instances(lib) == {
            first: 0, upd: 8, first + " rot": 16, upd + " rot": 24,
            first + "_h3": 32, upd + "_h3": 40, first + "_h3 rot": 48,
            upd + "_h3 rot": 56, first + "_chi": 64, upd + "_chi": 72,
            first + "_chi rot": 80, upd + "_chi rot": 88,
            first + "_chi_h3": 96, upd + "_chi_h3": 104,
            first + "_chi_h3 rot": 112, upd + "_chi_h3 rot": 120,
            first + "_upw": 128, upd + "_upw": 136,
            first + "_upw rot": 144, upd + "_upw rot": 152,
            first + "_chi_upw": 192, upd + "_chi_upw": 200,
            first + "_chi_upw rot": 208, upd + "_chi_upw rot": 216}
        for sfx in ("", "_chi", "_h3", "_chi_h3"):
            assert first + sfx in fr.LAUNCHES and upd + sfx in fr.LAUNCHES


@pytest.mark.parametrize("lib", sorted(fr.AUX_KERNELS))
def test_shock_builds_have_their_two_kernels(lib):
    """pc_flagship_attrs of a shock build: its first and update kernel,
    each without and with rotation (+16) and the del6 terms (+32), and
    with and without rotation the upwinding (+128); with the shock slot
    the shock diffusivities' twin of each (+256), counted under its
    launch name with the suffix _sd."""
    first, upd = fr.AUX_KERNELS[lib]
    want = {
        first: 0, upd: 8, first + " rot": 16, upd + " rot": 24,
        first + " h3": 32, upd + " h3": 40, first + " rot h3": 48,
        upd + " rot h3": 56, first + "_upw": 128, upd + "_upw": 136,
        first + "_upw rot": 144, upd + "_upw rot": 152}
    sds = ("",)
    if "_ns" not in lib:
        sds = ("", "_sd")
        for k, v in list(want.items()):
            name, _, rest = k.partition(" ")
            want[(name + "_sd " + rest).rstrip()] = v + 256
    assert fr.library_instances(lib) == want
    for upw in ("", "_upw"):
        for sd in sds:
            assert first + upw + sd in fr.LAUNCHES
            assert upd + upw + sd in fr.LAUNCHES


class _Recorder:
    """Stands in for a loaded library: records each entry point called."""

    def __init__(self, lib, calls):
        self.lib, self.calls = lib, calls

    def __getattr__(self, fn):
        def call(*args):
            # every wrapper passes each argument its entry point takes
            assert len(args) == len(_build.SIGNATURES[self.lib][fn]), fn
            if fn == "pc_tile_shape":
                out = (ctypes.c_int * 3).from_address(args[0])
                out[:] = [64, 8, 32]
            else:
                self.calls.append((self.lib, fn))
            return 0
        return call


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' launches, recorded, as if their tensors lay on the
    card: (library, entry point) of each."""
    calls = []
    monkeypatch.setattr(fr, "_dispatch", lambda t: True)
    monkeypatch.setattr(_build, "load",
                        lambda name="fused_rhs": _Recorder(name, calls))

    class _Dev:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: _Dev())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    fr.reset_launches()
    return calls


def test_shock_box_wrappers_launch_the_shock_build(recorded):
    """K1s and K5w launch pc_rhs_first and pc_rhs_tail_mid of
    fused_rhs_shock on the periodic 8-slot state, counted under their own
    names."""
    pm = pt.Model(shock_box(SHAPE), device="cpu")
    fa = torch.zeros((8,) + SHAPE)
    df = torch.zeros((7,) + SHAPE)
    coef = torch.zeros(2)
    fr.rhs_wrap_shock(pm, fa)
    fr.rhs_wrap_shock_upd(pm, fa, df, coef)
    assert recorded == [("fused_rhs_shock", "pc_rhs_first"),
                        ("fused_rhs_shock", "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               rhs_wrap_shock=1, rhs_wrap_shock_upd=1)
    with pytest.raises(NotImplementedError):
        fr.rhs_zroll(pm, fa)


def test_shear_box_wrappers_launch_the_shear_build(recorded):
    """K4 and K5 launch pc_rhs_first and pc_rhs_tail_mid of
    fused_rhs_shear on the x/y-ghosted stack; the shocked box's wrappers
    refuse a shear-box model."""
    pm = pt.Model(shear_box(SHAPE), device="cpu")
    g2 = 2 * NGHOST
    fg = torch.zeros((8, SHAPE[0] + g2, SHAPE[1] + g2, SHAPE[2]))
    df = torch.zeros((7,) + SHAPE)
    coef = torch.zeros(2)
    fr.rhs_zroll(pm, fg)
    fr.rhs_zroll_upd(pm, fg, df, coef)
    assert recorded == [("fused_rhs_shear", "pc_rhs_first"),
                        ("fused_rhs_shear", "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_zroll=1,
                               rhs_zroll_upd=1)
    with pytest.raises(NotImplementedError):
        fr.rhs_wrap_shock(pm, torch.zeros((8,) + SHAPE))
    with pytest.raises(ValueError):     # the unghosted state
        fr.rhs_zroll(pm, torch.zeros((8,) + SHAPE))


def test_conv_slab_wrappers_launch_the_zg_build(recorded):
    """K6 and K7 launch pc_rhs_first and pc_rhs_tail_mid of fused_rhs_zg
    on the interior stack and its z-halo slabs, counted under rhs_zg and
    rhs_zg_upd; the 3-axis ghosted stack of the parent's kernels is
    refused."""
    pm = pt.Model(conv_slab(SHAPE), device="cpu")
    fa = torch.zeros((5,) + SHAPE)
    slab = torch.zeros((5,) + SHAPE[:2] + (NGHOST,))
    df = torch.zeros((5,) + SHAPE)
    coef = torch.zeros(2)
    fr.rhs_zg(pm, fa, slab, slab)
    fr.rhs_zg_upd(pm, fa, slab, slab, df, coef)
    assert recorded == [("fused_rhs_zg", "pc_rhs_first"),
                        ("fused_rhs_zg", "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_zg=1,
                               rhs_zg_upd=1)
    g2 = 2 * NGHOST
    with pytest.raises(ValueError):
        fr.rhs_zg(pm, torch.zeros((5,) + tuple(n + g2 for n in SHAPE)),
                  slab, slab)
    with pytest.raises(ValueError):     # slabs of the wrong depth
        fr.rhs_zg(pm, fa, fa, fa)


def test_conv_slab_step_launches_one_k6_and_two_k7(recorded, monkeypatch):
    """The zghost chain at order 3 (as the card runs it): one K6 and two
    K7 per step, each on the z-only fill's slabs."""
    pm = pt.Model(conv_slab(SHAPE), device="cpu")
    state = pm.init_state(0)
    monkeypatch.setattr(fr, "_nblocks", lambda shape, lib: 1)
    monkeypatch.setattr(torch, "amax", lambda t: torch.ones(()))
    pm._zghost_step(state)
    assert recorded == [("fused_rhs_zg", "pc_rhs_first")] + [
        ("fused_rhs_zg", "pc_rhs_tail_mid")] * 2


def test_magnetoconvection_wrappers_launch_the_zg_mag_build(recorded):
    """K6m and K7m launch pc_rhs_first and pc_rhs_tail_mid of
    fused_rhs_zg_mag on the 8-field interior stack and its 8-field slabs,
    counted under rhs_zg_mag and rhs_zg_upd_mag; the 5-field stack and
    slabs are refused."""
    pm = pt.Model(conv_slab(SHAPE, magnetic=True), device="cpu")
    fa = torch.zeros((8,) + SHAPE)
    slab = torch.zeros((8,) + SHAPE[:2] + (NGHOST,))
    df = torch.zeros((8,) + SHAPE)
    coef = torch.zeros(2)
    fr.rhs_zg(pm, fa, slab, slab)
    fr.rhs_zg_upd(pm, fa, slab, slab, df, coef)
    assert recorded == [("fused_rhs_zg_mag", "pc_rhs_first"),
                        ("fused_rhs_zg_mag", "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0), rhs_zg_mag=1,
                               rhs_zg_upd_mag=1)
    with pytest.raises(ValueError):
        fr.rhs_zg(pm, fa[:5].contiguous(), slab[:5].contiguous(),
                  slab[:5].contiguous())
    with pytest.raises(ValueError):     # 5-field slabs
        fr.rhs_zg(pm, fa, slab[:5].contiguous(), slab[:5].contiguous())


@pytest.mark.parametrize("magnetic", (False, True), ids=("hydro", "mag"))
def test_rotating_conv_slab_step_launches_its_zg_build(recorded, monkeypatch,
                                                       magnetic):
    """The rotating conv-slab and rotating magnetoconvection at order 3:
    one K6 and two K7 (K6m, K7m) per step, of the build of the layout; the
    Coriolis instance is picked inside the library from Ω."""
    pm = pt.Model(conv_slab(SHAPE, magnetic=magnetic, Omega=1.0),
                  device="cpu")
    lib = "fused_rhs_zg_mag" if magnetic else "fused_rhs_zg"
    monkeypatch.setattr(fr, "_nblocks", lambda shape, lib: 1)
    monkeypatch.setattr(torch, "amax", lambda t: torch.ones(()))
    pm._zghost_step(pm.init_state(0))
    assert recorded == [(lib, "pc_rhs_first")] + [
        (lib, "pc_rhs_tail_mid")] * 2
    first, upd = fr.ZG_KERNELS[lib]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 2})


def test_libraries_hold_the_zg_shock_builds():
    """K6k/K7k and K6mk/K7mk are the flagship source built with PC_ZG=1
    and PC_SHOCK=1 on the conv-slab's layouts with the shock slot last,
    with the z-ghosted builds' entry points; each kernel has sixteen
    instances, with and without rotation (+16), chi-const (+64), the
    upwinding (+128) and the shock diffusivities (+256, launch names with
    _sd), and none with del6."""
    libs = _build.LIBRARIES
    assert libs["fused_rhs_zg_shock"] == ("fused_rhs.cu", (
        "-DPC_MAG=0", "-DPC_ENT=1", "-DPC_ZG=1", "-DPC_SHOCK=1"))
    assert libs["fused_rhs_zg_mag_shock"] == ("fused_rhs.cu", (
        "-DPC_ENT=1", "-DPC_ZG=1", "-DPC_SHOCK=1"))
    for lib, (first, upd) in (
            ("fused_rhs_zg_shock", ("rhs_zg_shock", "rhs_zg_upd_shock")),
            ("fused_rhs_zg_mag_shock", ("rhs_zg_mag_shock",
                                        "rhs_zg_upd_mag_shock"))):
        assert _build.SIGNATURES[lib] == _build.SIGNATURES["fused_rhs_zg"]
        assert fr.ZG_KERNELS[lib] == (first, upd)
        assert lib in fr.ZG_SHOCK_LIBRARIES and lib in fr.ZG_CHI_LIBRARIES
        want = {}
        for k, base in ((first, 0), (upd, 8)):
            for chi, c in (("", 0), ("_chi", 64)):
                for upw, u in (("", 0), ("_upw", 128)):
                    for sd, d in (("", 0), ("_sd", 256)):
                        name = k + chi + upw + sd
                        want[name] = base + c + u + d
                        want[name + " rot"] = base + c + u + d + 16
                        assert name in fr.LAUNCHES
        assert fr.library_instances(lib) == want


@pytest.mark.parametrize("sd", (False, True), ids=("nu_sh", "sd"))
@pytest.mark.parametrize("magnetic", (False, True), ids=("hydro", "mag"))
def test_shocked_conv_slab_step_launches_its_zg_shock_build(
        recorded, monkeypatch, magnetic, sd):
    """The shocked conv-slab and magnetoconvection at order 3: one K6k and
    two K7k (K6mk, K7mk) per step, or their SHK instances with the shock
    diffusivities, of the build of the layout, each on the stack of all
    slots after the pre-pass and its slabs."""
    cfg = conv_slab(SHAPE, magnetic=magnetic, shock=True)
    pm = pt.Model(with_shock_diffusion(cfg) if sd else cfg, device="cpu")
    lib = "fused_rhs_zg_mag_shock" if magnetic else "fused_rhs_zg_shock"
    monkeypatch.setattr(fr, "_nblocks", lambda shape, lib: 1)
    monkeypatch.setattr(torch, "amax", lambda t: torch.ones(()))
    pm._zghost_step(pm.init_state(0))
    assert recorded == [(lib, "pc_rhs_first")] + [
        (lib, "pc_rhs_tail_mid")] * 2
    first, upd = (k + ("_sd" if sd else "") for k in fr.ZG_KERNELS[lib])
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 2})


def test_zg_shock_wrappers_take_every_slot(recorded):
    """K6k and K7k take the interior stack of all 6 slots and slabs of 6
    components, and give df and f of the 5 evolved fields; the stack
    without the slot is refused."""
    pm = pt.Model(conv_slab(SHAPE, shock=True), device="cpu")
    fa = torch.zeros((6,) + SHAPE)
    slab = torch.zeros((6,) + SHAPE[:2] + (NGHOST,))
    df, _ = fr.rhs_zg(pm, fa, slab, slab)
    assert df.shape == (5,) + SHAPE
    df2, f2 = fr.rhs_zg_upd(pm, fa, slab, slab, torch.zeros((5,) + SHAPE),
                            torch.zeros(2))
    assert df2.shape == f2.shape == (5,) + SHAPE
    with pytest.raises(ValueError):
        fr.rhs_zg(pm, fa[:5].contiguous(), slab[:5].contiguous(),
                  slab[:5].contiguous())


def test_kernel_params_carry_the_conv_slab_terms():
    """kernel_params(conv_slab) holds what the retired ZgParams held but
    gravity, which the z profiles carry as the vector g_z(z): the cooling
    layer and its target cs², the heating layer's norm, K and ν, each the
    f32 of the value the plain version uses; and max(ν, ·) as the CFL's
    constant diffusivity."""
    pm = pt.Model(conv_slab(SHAPE), device="cpu")
    p = fr.kernel_params(pm)
    ent, eos = pm.cfg.module("entropy"), pm.eos
    f32 = np.float32
    prof_c, prof_h, gz = fr.zg_profiles(pm)
    assert torch.equal(gz, torch.full_like(pm.grid.z, f32(
        pm.cfg.module("gravity").gravz)))
    want = {"cool": ent.cool,
            "cs2c": ent.cs2c(eos), "heat_norm": ent.heat_norm(pm.cfg.grid),
            "hcond0": ent.hcond0, "nu": pm.cfg.module("viscosity").nu,
            "two_nu": 2.0 * pm.cfg.module("viscosity").nu,
            "maxdif": pm.cfg.module("viscosity").nu,
            "g_cp": eos.gamma / eos.cp, "gm1": eos.gamma - 1.0,
            "cpchi": 0.0}
    for name, v in want.items():
        assert getattr(p, name) == f32(v), name
    assert float(gz[0]) < 0.0 and p.cool > 0.0 and p.heat_norm > 0.0
    assert p.hcond0 > 0.0 and p.isothermal == 0
    want_c, want_h = ent.heat_cool_profiles(pm.grid.z, pm.cfg.grid)
    assert torch.equal(prof_c, want_c) and torch.equal(prof_h, want_h)


@pytest.mark.parametrize("case", ("magnetic_hyper3", "hyper3"))
def test_zg_build_refuses_what_it_has_no_terms_for(case):
    """The conv-slab set, with or without Magnetic, with 'hyper3-mesh'
    beside 'hyper3-simplified' on u: the z-ghosted builds' H3 instances
    have one weight a field, and the constants refuse the pair, naming it
    ('hyper3-simplified', the mesh flavour alone, Ω and chi-const they
    have: the H3, ROT and CHI instances, whose constants this set
    fills)."""
    cfg = conv_slab(SHAPE, magnetic=case.startswith("magnetic"),
                    hyper3=True)
    p = fr.kernel_params(pt.Model(cfg, device="cpu"))
    assert p.nu3 > 0.0 and p.diff3 > 0.0 and p.dif3 > 0.0
    assert (p.eta3 > 0.0) == case.startswith("magnetic")
    visc = cfg.module("viscosity")
    both = cfg.replace(modules=tuple(
        dataclasses.replace(visc, ivisc=visc.ivisc + ("hyper3-mesh",))
        if m.name == "viscosity" else m for m in cfg.modules))
    with pytest.raises(NotImplementedError, match="hyper3-mesh"):
        fr.kernel_params(pt.Model(both, device="cpu"))


@pytest.mark.parametrize("case", ("magnetic_hyper3", "hyper3"))
def test_zg_build_takes_the_mesh_flavour(case):
    """The conv-slab set, with or without Magnetic, with 'hyper3-mesh' and
    diffrho_hyper3_mesh (η₃ on A): the H3 instances with the mesh weights
    dline_1/60 on u and lnρ and the mesh rate in the CFL, the constant
    diffusive rate η₃'s alone."""
    mag = case.startswith("magnetic")
    pm = pt.Model(conv_slab(SHAPE, magnetic=mag, hyper3="mesh"),
                  device="cpu")
    p = fr.kernel_params(pm)
    assert all(k.endswith("_h3") for k in fr.zg_kernels(pm))
    assert p.hmesh > 0.0 and p.nu3 > 0.0 and p.diff3 > 0.0
    assert (p.dif3 > 0.0) == mag and (p.eta3 > 0.0) == mag
    assert list(p.h6u) == list(p.h6l) != list(p.inv6)


@pytest.mark.parametrize("magnetic", (True, False), ids=("mhd", "hydro"))
def test_zg_build_takes_chi_const(magnetic, recorded):
    """chi-const beside K-const in the conv-slab set, with or without
    Magnetic: the wrappers launch the same entry points of the same
    build, which picks its CHI instances from cp·χ > 0, counted under the
    launch names with _chi."""
    cfg = conv_slab(SHAPE, magnetic=magnetic, chi=4e-3)
    pm = pt.Model(cfg, device="cpu")
    lib = "fused_rhs_zg_mag" if magnetic else "fused_rhs_zg"
    assert fr.zg_library(pm) == lib
    assert fr.kernel_params(pm).cpchi == np.float32(4e-3)
    first, upd = (k + "_chi" for k in fr.ZG_KERNELS[lib])
    nv = pm.reg.nvar
    fa = torch.zeros((nv,) + SHAPE)
    slab = torch.zeros((nv,) + SHAPE[:2] + (NGHOST,))
    fr.rhs_zg(pm, fa, slab, slab)
    fr.rhs_zg_upd(pm, fa, slab, slab, torch.zeros_like(fa), torch.zeros(2))
    assert recorded == [(lib, "pc_rhs_first"), (lib, "pc_rhs_tail_mid")]
    assert fr.LAUNCHES == dict(dict.fromkeys(fr.LAUNCHES, 0),
                               **{first: 1, upd: 1})


def test_shock_library_follows_the_modules():
    """The build of the shock and shear chains follows the module set and
    the layout (``aux_library``, which took over from shock_library when
    the builds gained their other isothermal layouts, and their hydro and
    MHD layouts with an entropy field)."""
    want = {(shock_box, ()): "fused_rhs_shock",
            (shock_box, (("magnetic", False),)): "fused_rhs_shock_hydro",
            (shear_box, ()): "fused_rhs_shear",
            (shear_box, (("shock", False),)): "fused_rhs_shear_ns",
            (shear_box, (("magnetic", False),)): "fused_rhs_shear_hydro",
            (shear_box, (("magnetic", False), ("shock", False))):
                "fused_rhs_shear_hydro_ns",
            (shock_box, (("magnetic", False), ("entropy", True))):
                "fused_rhs_shock_hydro_ent",
            (shear_box, (("magnetic", False), ("entropy", True))):
                "fused_rhs_shear_hydro_ent",
            (shear_box, (("magnetic", False), ("shock", False),
                         ("entropy", True))): "fused_rhs_shear_hydro_ent_ns",
            (shock_box, (("entropy", True),)): "fused_rhs_shock_ent",
            (shear_box, (("entropy", True),)): "fused_rhs_shear_ent",
            (shear_box, (("shock", False), ("entropy", True))):
                "fused_rhs_shear_ent_ns"}
    for (make, kw), lib in want.items():
        pm = pt.Model(make(SHAPE, **dict(kw)), device="cpu")
        assert fr.aux_library(pm) == lib
    assert set(want.values()) == set(fr.AUX_KERNELS)
    with pytest.raises(NotImplementedError):
        fr.aux_library(pt.Model(flagship(SHAPE), device="cpu"))


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _struct_fields(source, name):
    """[(field, ctypes type)] of ``struct name`` in a C source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = decl.split(None, 1)
        for item in names.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*(?:\[(\d+)\])?\s*", item)
            t = _C_TYPES[ctype]
            out.append((m.group(1), t * int(m.group(2)) if m.group(2) else t))
    return out


def test_pcparams_mirrors_the_c_struct():
    """PcParams._fields_ has the fields of struct PcParams in fused_rhs.cu,
    by name, type and order: the kernels read the constants by offset."""
    src = (_build.CSRC / "fused_rhs.cu").read_text()
    want = _struct_fields(src, "PcParams")
    got = list(fr.PcParams._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, u) in zip(got, want):
        assert ctypes.sizeof(t) == ctypes.sizeof(u), name
        assert getattr(t, "_type_", t) == getattr(u, "_type_", u), name


@pytest.mark.parametrize("make, lib", ((shock_box, "fused_rhs_shock"),
                                       (shear_box, "fused_rhs_shear")))
def test_kernel_params_carry_the_shock_terms(make, lib):
    """The constants the shock builds read: ν_sh, the del6 coefficients
    and their CFL rate, the 6th-difference weights, the shear rate."""
    pm = pt.Model(make(SHAPE), device="cpu")
    p = fr.kernel_params(pm)
    vis = pm.cfg.module("viscosity")
    nu, nu_shock, nu3 = vis.coefficients()
    assert p.nu_shock == pytest.approx(nu_shock) and nu_shock > 0.0
    assert p.nu3 == pytest.approx(nu3, rel=1e-6)
    assert list(p.w6) == [15.0, -6.0, 1.0]
    if lib == "fused_rhs_shear":
        assert p.S == pytest.approx(pm.cfg.module("shear").S)
        assert p.dif3 > 0.0 and p.eta3 > 0.0 and p.diff3 > 0.0
        inv = [1.0 / d for d in (pm.cfg.grid.dx, pm.cfg.grid.dy,
                                 pm.cfg.grid.dz)]
        assert list(p.inv6) == pytest.approx([i ** 6 for i in inv],
                                             rel=1e-6)
        dxyz6 = sum(i ** 6 for i in inv)
        assert p.dif3 == pytest.approx(
            max(nu3, p.eta3, p.diff3) * dxyz6 / pm.cfg.time.cdtv3, rel=1e-5)
    else:
        assert p.S == 0.0 and p.dif3 == 0.0 and p.nu3 == 0.0
