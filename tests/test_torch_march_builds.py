"""The builds of the flagship template (csrc/fused_rhs.cu) as far as the
CPU can hold them: the libraries and their -D definitions, the library
each shock-box and shear-box wrapper launches on a CUDA tensor, and the
ctypes mirror of the kernels' constants against the C struct.

The kernels themselves run only on the card (tests/test_torch_gpu.py);
here a wrapper's launch is recorded instead of made, by replacing the
loader's entry point.
"""
import ctypes
import re

import pytest
import torch

import pencil_tpu_torch as pt
from pencil_tpu_torch.configs import flagship, shear_box, shock_box
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


@pytest.mark.parametrize("lib", sorted(fr.AUX_KERNELS))
def test_shock_builds_have_their_two_kernels(lib):
    """pc_flagship_attrs of a shock build: its first and update kernel,
    each without and with rotation (+16) and the del6 terms (+32)."""
    first, upd = fr.AUX_KERNELS[lib]
    assert fr.library_instances(lib) == {
        first: 0, upd: 8, first + " rot": 16, upd + " rot": 24,
        first + " h3": 32, upd + " h3": 40, first + " rot h3": 48,
        upd + " rot h3": 56}
    assert first in fr.LAUNCHES and upd in fr.LAUNCHES


class _Recorder:
    """Stands in for a loaded library: records each entry point called."""

    def __init__(self, lib, calls):
        self.lib, self.calls = lib, calls

    def __getattr__(self, fn):
        def call(*args):
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


def test_shock_library_follows_the_modules():
    assert fr.shock_library(pt.Model(shock_box(SHAPE), device="cpu")) \
        == "fused_rhs_shock"
    assert fr.shock_library(pt.Model(shear_box(SHAPE), device="cpu")) \
        == "fused_rhs_shear"
    with pytest.raises(NotImplementedError):
        fr.shock_library(pt.Model(flagship(SHAPE), device="cpu"))


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
