"""The port's public surface: no JAX behind it, configuration dataclasses
that mirror the JAX package's, the fused-kernel gate, the state converter
and the f32 precision settings."""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu_torch.compat.from_jax import (overrides_from_numpy,
                                              state_from_numpy, state_to_numpy)
from pencil_tpu_torch.model import fused_gate, gate_reason

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = textwrap.dedent("""
        import sys
        import pencil_tpu_torch
        import pencil_tpu_torch.compat.from_jax
        import pencil_tpu_torch.ops.fused_rhs
        import pencil_tpu_torch.configs
        import pencil_tpu_torch.run
        import pencil_tpu_torch.io.diagnostics
        import pencil_tpu_torch.io.snapshot
        import pencil_tpu_torch.io.timeseries
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'pencil_tpu')]
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PAIRS = [(pt.GridSpec, pj.GridSpec), (pt.TimeSpec, pj.TimeSpec),
         (pt.MeshSpec, pj.MeshSpec), (pt.Config, pj.Config),
         (pt.EosIdealGas, pj.EosIdealGas), (pt.Density, pj.Density),
         (pt.Hydro, pj.Hydro), (pt.Viscosity, pj.Viscosity),
         (pt.Magnetic, pj.Magnetic), (pt.Forcing, pj.Forcing),
         (pt.Gravity, pj.Gravity), (pt.Entropy, pj.Entropy), (pt.BC, pj.BC),
         (pt.Shear, pj.Shear), (pt.Shock, pj.Shock)]


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = type(f.default_factory()).__name__
        else:
            out[f.name] = None
    return out


@pytest.mark.parametrize("ours,theirs", PAIRS,
                         ids=[p[0].__name__ for p in PAIRS])
def test_config_fields_and_defaults_match_jax(ours, theirs):
    """Every field of a port dataclass exists in the JAX one with the same
    default; the configuration dataclasses carry all of the JAX fields."""
    mine, ref = _defaults(ours), _defaults(theirs)
    for name, default in mine.items():
        assert name in ref, name
        assert default == ref[name], name
    if ours in (pt.GridSpec, pt.TimeSpec, pt.MeshSpec, pt.Config):
        assert list(mine) == list(ref)
    if hasattr(ours, "name"):
        assert ours.name == theirs.name


def flagship(**over):
    kw = dict(
        grid=pt.GridSpec(nx=16, ny=16, nz=16), time=pt.TimeSpec(itorder=3),
        fused=True,
        modules=(pt.EosIdealGas(gamma=1.0, cs0=1.0), pt.Density(),
                 pt.Hydro(init="gaussian-noise", ampl=1e-3),
                 pt.Viscosity(nu=5e-3),
                 pt.Magnetic(init="gaussian-noise", ampl=1e-4, eta=5e-3),
                 pt.Forcing(force=0.07, kf=3.0)))
    kw.update(over)
    return pt.Config(**kw)


OUTSIDE = {
    "unfused": dict(fused=False),
    # RKF45 (itorder 5) has no 2N-RK table: outside every chain
    "rkf45": dict(time=pt.TimeSpec(itorder=5)),
    # the flagship under constant gravity (ROADMAP Queue 2 A): fused in
    # JAX, eager here on the CPU; the template has no gravity term
    "mhd_with_gravity": dict(modules=flagship().modules + (
        pt.Gravity(gravz_profile="const", gravz=-1.0),)),
    "twice_forced": dict(modules=flagship().modules + (pt.Forcing(),)),
}


def test_gate_accepts_the_flagship():
    assert gate_reason(flagship()) is None
    unforced = flagship(modules=flagship().modules[:-1])
    for dev in ("cpu", "cuda"):
        assert fused_gate(flagship(), dev) is True
        assert fused_gate(unforced, dev) is True


def test_gate_accepts_the_flagship_without_magnetic():
    """Hydro alone (the flagship's modules without Magnetic) runs the wrap
    chain on the hydro build of the flagship template."""
    cfg = flagship(modules=(pt.EosIdealGas(), pt.Density(), pt.Hydro(),
                            pt.Viscosity(nu=1e-3)))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True


@pytest.mark.parametrize("magnetic", (False, True), ids=("hydro", "mhd"))
def test_gate_accepts_an_entropy_slot(magnetic):
    """Forced hydro and the flagship with an entropy slot (non-isothermal)
    run the wrap chain on the entropy builds of the flagship template."""
    mag = (pt.Magnetic(eta=1e-3),) if magnetic else ()
    cfg = flagship(modules=(pt.EosIdealGas(), pt.Density(), pt.Hydro(),
                            pt.Viscosity(nu=1e-3), pt.Entropy(), *mag,
                            pt.Forcing()))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True
    assert pt.Model(cfg, device="cpu").mode == "wrap"


@pytest.mark.parametrize("itorder", (1, 2, 4), ids=("rk1", "rk2", "rk4"))
def test_gate_accepts_rk_orders(itorder):
    """Every 2N-RK order of RK_TABLES runs the flagship chain."""
    cfg = flagship(time=pt.TimeSpec(itorder=itorder))
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_gate_rejects_outside_configs_on_cuda(case):
    cfg = flagship(**OUTSIDE[case])
    assert gate_reason(cfg) is not None
    assert fused_gate(cfg, "cpu") is False           # CPU: the eager path
    with pytest.raises(NotImplementedError):
        fused_gate(cfg, torch.device("cuda"))
    with pytest.raises(NotImplementedError):
        pt.Model(cfg, device="cuda")                 # before any allocation


@pytest.mark.parametrize("over", [
    dict(mesh=pt.MeshSpec(1, 1, 2)),
    dict(grid=pt.GridSpec(nx=16, ny=16, nz=16, periodic=(True, True, False))),
    dict(dtype="float64"),
    dict(modules=(pt.EosIdealGas(), pt.Hydro())),
], ids=("mesh", "nonperiodic", "float64", "no_density"))
def test_unsupported_configs_raise_on_every_device(over):
    for dev in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError):
            pt.Model(flagship(**over), device=dev)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        pt.Density(lupw_lnrho=True)
    with pytest.raises(NotImplementedError):
        pt.Viscosity(ivisc=("nu-shock",))
    with pytest.raises(NotImplementedError):
        pt.Model(flagship(modules=(pt.EosIdealGas(), pt.Density(init="xjump"),
                                   pt.Hydro()), fused=False),
                 device="cpu").init_state(0)


def test_model_defaults_to_the_card():
    """With no device named, a model runs on the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert pt.Model(flagship()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device.*device='cpu'"):
        pt.Model(flagship())
    assert pt.Model(flagship(), device="cpu").device.type == "cpu"


def test_state_from_numpy_defaults_to_the_card():
    """The state converter, too, targets the card unless asked for the
    CPU."""
    kw = dict(fields={"lnrho": np.zeros((4, 4, 4), np.float32)}, t=0.0,
              dt=1e-3, it=0)
    if torch.cuda.is_available():
        assert state_from_numpy(**kw)["t"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA device.*device='cpu'"):
        state_from_numpy(**kw)
    assert state_from_numpy(**kw, device="cpu")["t"].device.type == "cpu"


def test_state_converter_round_trips():
    model = pt.Model(flagship(), device="cpu")
    state = model.init_state(3)
    state = model.make_step()(state)
    back = state_from_numpy(**state_to_numpy(state), device="cpu")
    for key in ("t", "dt", "it"):
        assert torch.equal(back[key], state[key])
    for k, v in state["fields"].items():
        assert torch.equal(back["fields"][k], v)
    with pytest.raises(ValueError):
        state_to_numpy(model.pack_state(state))


def test_state_converter_takes_jax_state():
    """A JAX package state crosses as numpy and steps in the port."""
    jm = pj.Model(pj.Config(
        grid=pj.GridSpec(nx=8, ny=8, nz=8),
        modules=(pj.EosIdealGas(), pj.Density(),
                 pj.Hydro(init="gaussian-noise", ampl=1e-3))))
    js = jm.init_state(0)
    st = state_from_numpy({k: np.asarray(v) for k, v in js["fields"].items()},
                          js["t"], js["dt"], js["it"], device="cpu")
    for k, v in js["fields"].items():
        np.testing.assert_array_equal(st["fields"][k].numpy(), np.asarray(v))
    pm = pt.Model(pt.Config(grid=pt.GridSpec(nx=8, ny=8, nz=8),
                            modules=(pt.EosIdealGas(), pt.Density(),
                                     pt.Hydro())), device="cpu")
    out = pm.make_step()(st)
    assert torch.isfinite(out["fields"]["uu"]).all()


def test_tf32_is_off():
    import pencil_tpu_torch.ops.fused_rhs  # noqa: F401  (sets the flags)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_registry_layout_matches_jax():
    pm = pt.Model(flagship(), device="cpu")
    jm = pj.Model(pj.Config(grid=pj.GridSpec(nx=16, ny=16, nz=16),
                            modules=(pj.EosIdealGas(), pj.Density(),
                                     pj.Hydro(), pj.Viscosity(),
                                     pj.Magnetic(), pj.Forcing())))
    assert pm.reg.comp_names == jm.reg.comp_names
    assert (pm.reg.nvar, pm.reg.ncom) == (jm.reg.nvar, jm.reg.ncom) == (7, 7)
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]
    np.testing.assert_array_equal(pm.grid.z.numpy(),
                                  np.asarray(jm.grid.z)[3:-3])


def test_conv_slab_registry_layout_matches_jax():
    """The 5-field layout (uu, lnrho, ss) and the module order."""
    from pencil_tpu_torch.configs import conv_slab
    pm = pt.Model(conv_slab(8), device="cpu")
    jm = pj.Model(conv_slab(8, pkg=pj))
    assert pm.reg.comp_names == jm.reg.comp_names \
        == ["ux", "uy", "uz", "lnrho", "ss"]
    assert (pm.reg.nvar, pm.reg.ncom, pm.reg.nf) == (5, 5, 5)
    assert [m.name for m in pm.modules] == [m.name for m in jm.modules]


def test_overrides_from_numpy_checks_the_layout():
    from pencil_tpu_torch.configs import conv_slab
    pm = pt.Model(conv_slab(8), device="cpu")
    good = {k: np.asarray(v) for k, v in pm.init_state(1)["fields"].items()}
    out = overrides_from_numpy(good, pm.reg)
    assert sorted(out) == ["lnrho", "ss", "uu"]
    assert all(v.dtype == np.float32 for v in out.values())
    with pytest.raises(KeyError):
        overrides_from_numpy({k: v for k, v in good.items() if k != "ss"},
                             pm.reg)
    with pytest.raises(ValueError):
        overrides_from_numpy(dict(good, ss=good["uu"]), pm.reg)
