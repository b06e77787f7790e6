"""Stratified convection (non-periodic z) in pencil_tpu_torch against
pencil_tpu: K6 and K7's plain versions against the zghost Pallas kernels
they replace, on the interior stack and the z-halo slabs cut from the
JAX package's ghosted stack (the split of its ``_fetch_zg``), the z-only
fill that cuts the slabs against the 3-axis fill, the whole step against
the JAX fused (zghost) and jnp paths, and the gate.

The JAX side runs as tests/test_fused.py runs it on the CPU, the Pallas
kernels in interpret mode, with one tile over the whole domain
(PC_TX = nx, PC_CX = nx): the JAX Gravity module sizes its acceleration
from the global grid shape (pencil_tpu/physics/gravity.py:160), so its
fused path fails on any tile smaller than the domain.  Bounds are those
of tests/test_fused.py: each field within 2e-5 × its max, dt within 1e-6
relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencil_tpu as pj
import pencil_tpu_torch as pt
from pencil_tpu.parallel.halo import fill_ghosts as j_fill_ghosts
from pencil_tpu_torch.compat.from_jax import overrides_from_numpy
from pencil_tpu_torch.configs import conv_slab
from pencil_tpu_torch.model import fused_gate, gate_reason
from pencil_tpu_torch.ops import fused_rhs as fr
from pencil_tpu_torch.parallel.halo import ghosted_from_z_slabs

torch.set_num_threads(1)

RTOL_FIELD = 2e-5
RTOL_DT = 1e-6
SHAPES = ((16, 16, 16), (16, 16, 32))
IDS = ("16^3", "16x16x32")
NSTEPS = 3
# Initial velocity noise of the step comparisons.  At the configuration's
# own 1e-3 the velocity after 3 steps is the small residual of the O(1)
# hydrostatic balance and sits below its float32 floor: within the JAX
# package alone, moving lnρ by one ulp on 30 % of the points moves uu by
# 5.2e-5 of its max over 3 steps (16³, seed 11), so a 2e-5 bound would
# measure roundoff, not the port.  At 1e-2 (test_fused.py's amplitude for
# the non-periodic case) the same roundoff is a tenth of the bound.
UU_AMPL = 1e-2


@pytest.fixture
def whole_domain_tile(monkeypatch):
    monkeypatch.setenv("PC_TX", "16")
    monkeypatch.setenv("PC_CX", "16")


def assert_field_close(a, b, what, rtol=RTOL_FIELD):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-30), (what, err)


def z_split(fg):
    """(fa, zlo, zhi) of a 3-axis ghosted stack: its interior and its z
    ghosts over the interior x and y, as the z-ghosted kernels take them."""
    g = 3
    body = torch.tensor(fg[:, g:-g, g:-g])
    return (body[..., g:-g].contiguous(), body[..., :g].contiguous(),
            body[..., -g:].contiguous())


def ghosted_input(jm, pm, seed):
    """A z-ghosted conv-slab stack (numpy): the piecew-poly profiles with
    noise, ghosted by the JAX fill_ghosts."""
    rng = np.random.default_rng(seed)
    init = pm.init_state(0)["fields"]
    shape = pm.cfg.grid.shape
    fa = np.concatenate([
        1e-2 * rng.standard_normal((3,) + shape),
        init["lnrho"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
        init["ss"].numpy()[None] + 1e-2 * rng.standard_normal(shape),
    ]).astype(np.float32)
    fg = j_fill_ghosts(jnp.asarray(fa), jm.cfg.grid, jm.bc_axes, jm.reg,
                       jm.grid, jm.cfg, jm.eos)
    return np.asarray(fg)


@pytest.fixture(scope="module", params=SHAPES, ids=IDS)
def kernels(request):
    """K6 and K7 of the JAX package (interpret mode) on one ghosted
    input, every result kept as numpy."""
    shape = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PC_TX", str(shape[0]))
        mp.setenv("PC_CX", str(shape[0]))
        jm = pj.Model(conv_slab(shape, pkg=pj))
        pm = pt.Model(conv_slab(shape), device="cpu")
        fg = ghosted_input(jm, pm, seed=5)
        z = jm.grid.z
        df1, dt1 = jm._fused_rhs(shape, False, False, True)(jnp.asarray(fg), z)
        alpha, beta, _ = jm.rk
        dt = 1.0 / jnp.max(dt1)
        fg2 = ghosted_input(jm, pm, seed=6)
        df2, f2, _ = jm._fused_rhs(shape, True, False, True)(
            jnp.asarray(fg2), z, df1, alpha[1], beta[1] * dt)
    return dict(pm=pm, fg=fg, fg2=fg2, df1=np.asarray(df1),
                dt1max=float(jnp.max(dt1)), dt=np.float32(dt),
                df2=np.asarray(df2), f2=np.asarray(f2))


def test_rhs_zg_matches_pallas(kernels):
    """K6's plain version: df and the max 1/dt over tiles."""
    df, dt1m = fr.rhs_zg(kernels["pm"], *z_split(kernels["fg"]))
    assert dt1m.ndim == 0
    np.testing.assert_allclose(float(dt1m), kernels["dt1max"], rtol=RTOL_DT)
    for c in range(5):
        assert_field_close(df[c], kernels["df1"][c], f"df[{c}]")


def test_rhs_zg_upd_matches_pallas(kernels):
    """K7's plain version: df (written over df_prev) and f."""
    pm = kernels["pm"]
    alpha, beta, _ = pm.rk
    coef = torch.stack((torch.tensor(alpha[1], dtype=torch.float32),
                        beta[1] * torch.tensor(kernels["dt"])))
    df_prev = torch.tensor(kernels["df1"])
    df, f = fr.rhs_zg_upd(pm, *z_split(kernels["fg2"]), df_prev, coef)
    assert df is df_prev
    for c in range(5):
        assert_field_close(df[c], kernels["df2"][c], f"df[{c}]")
        assert_field_close(f[c], kernels["f2"][c], f"f[{c}]")


def noisy_state(pm, seed):
    """(5, nx, ny, nz): the conv-slab's initial lnρ and s with noise and
    noisy velocities, the walls' uz and the top s unpinned."""
    rng = np.random.default_rng(seed)
    fa = pm.reg.stack(pm.init_state(0)["fields"])
    return fa + torch.tensor(
        1e-2 * rng.standard_normal(tuple(fa.shape)), dtype=fa.dtype)


@pytest.mark.parametrize("shape", SHAPES + ((8, 12, 10),),
                         ids=IDS + ("8x12x10",))
def test_z_slabs_are_the_3_axis_fill(shape):
    """Model.z_slabs (a z-only fill of the 4 planes at each end of z) gives
    the 3-axis fill's z ghosts over the interior x and y and its pinned
    boundary planes, bit for bit; joined and wrapped in x and y they are
    the whole 3-axis ghosted stack, its ghost corners included."""
    pm = pt.Model(conv_slab(shape), device="cpu")
    fa = noisy_state(pm, 7)
    fg = pm.ghosted(fa)
    pinned, zlo, zhi = pm.z_slabs(fa.clone())
    want = z_split(fg.numpy())
    for name, a, b in zip(("fa", "zlo", "zhi"), (pinned, zlo, zhi), want):
        assert torch.equal(a, b), name
    assert not torch.equal(pinned, fa)       # the walls' uz was not 0
    assert torch.equal(ghosted_from_z_slabs(pinned, zlo, zhi), fg)


def test_z_slabs_pin_in_place_what_bc_writeback_pins():
    """z_slabs writes the pinned boundary planes into its input, the same
    values bc_writeback writes, and leaves a pinned state as it is."""
    pm = pt.Model(conv_slab((8, 8, 16)), device="cpu")
    fa = noisy_state(pm, 8)
    want = pm.bc_writeback(fa.clone())
    got = fa.clone()
    assert pm.z_slabs(got)[0] is got
    assert torch.equal(got, want)
    again = got.clone()
    pm.z_slabs(again)
    assert torch.equal(again, got)


def test_step_leaves_its_input_alone():
    """A step on a packed stack whose walls are not pinned leaves that
    stack as it was, and gives the step of the same fields unpacked."""
    pm = pt.Model(conv_slab((8, 8, 16)), device="cpu")
    s0 = pm.init_state(4)
    fa = noisy_state(pm, 9)
    before = fa.clone()
    packed = pm.make_step()({"_fa": fa, "t": s0["t"], "dt": s0["dt"],
                             "it": s0["it"]})
    assert torch.equal(fa, before)
    unpacked = pm.make_step()(dict(s0, fields=pm.reg.unstack(before)))
    assert torch.equal(packed["_fa"], pm.reg.stack(unpacked["fields"]))


def run_both(shape, fused, seed, nsteps=NSTEPS, ampl_uu=UU_AMPL):
    """Both packages from the JAX init (piecew-poly lnρ and s) with the
    velocity replaced by numpy noise of amplitude ``ampl_uu``."""
    jm = pj.Model(conv_slab(shape, fused=fused, pkg=pj))
    pm = pt.Model(conv_slab(shape, fused=fused), device="cpu")
    if fused:
        assert jm._fused_mode(None, None, shape[2]) == "zghost"
        assert pm.mode == "zghost"
    else:
        assert pm.mode is None
    rng = np.random.default_rng(seed)
    uu = (ampl_uu * rng.standard_normal((3,) + shape)).astype(np.float32)
    js = jm.init_state(seed, overrides={"uu": uu})
    fields = {k: np.asarray(v) for k, v in js["fields"].items()}
    ps = pm.init_state(seed, overrides=overrides_from_numpy(fields, pm.reg))
    for k, v in fields.items():
        np.testing.assert_array_equal(ps["fields"][k].numpy(), v, k)
    jstep, pstep = jm.make_step(), pm.make_step()
    for _ in range(nsteps):
        js, ps = jstep(js), pstep(ps)
    return js, ps


def assert_states_close(js, ps):
    np.testing.assert_allclose(float(ps["dt"]), float(js["dt"]), rtol=RTOL_DT)
    np.testing.assert_allclose(float(ps["t"]), float(js["t"]), rtol=RTOL_DT)
    assert int(ps["it"]) == int(js["it"])
    for k, b in js["fields"].items():
        assert_field_close(ps["fields"][k], b, k)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_zghost_step_matches_jax_fused(shape, whole_domain_tile):
    """The port's zghost chain (plain K6/K7 on the CPU) against the JAX
    fused zghost step, 3 steps from JAX's initial fields."""
    js, ps = run_both(shape, fused=True, seed=11)
    assert_states_close(js, ps)


def test_eager_step_matches_jax_jnp_path():
    """fused=False: the port's eager path on ghosted stacks against the
    JAX jnp path, 3 steps."""
    js, ps = run_both((16, 16, 16), fused=False, seed=12)
    assert_states_close(js, ps)


def test_config_amplitude_within_float32_floor():
    """At the configuration's own velocity noise (1e-3) the port's gap to
    the JAX jnp path stays inside the spread that a one-ulp change of the
    initial lnρ causes within the JAX package itself."""
    shape = (16, 16, 16)
    js, ps = run_both(shape, fused=False, seed=13, ampl_uu=1e-3)
    jm = pj.Model(conv_slab(shape, fused=False, pkg=pj))
    j0 = jm.init_state(13, overrides={"uu": np.asarray(
        1e-3 * np.random.default_rng(13).standard_normal((3,) + shape),
        np.float32)})
    lnrho = np.asarray(j0["fields"]["lnrho"])
    j0["fields"]["lnrho"] = jnp.asarray(np.nextafter(lnrho, np.float32(9)))
    step = jm.make_step()
    for _ in range(NSTEPS):
        j0 = step(j0)
    ref = np.asarray(js["fields"]["uu"], np.float64)
    floor = np.abs(np.asarray(j0["fields"]["uu"], np.float64) - ref).max()
    gap = np.abs(ps["fields"]["uu"].numpy().astype(np.float64) - ref).max()
    assert gap <= floor, (gap, floor, np.abs(ref).max())
    for k in ("lnrho", "ss"):
        assert_field_close(ps["fields"][k], js["fields"][k], k)


def test_packed_multi_step_bit_identical_to_dict_step():
    pm = pt.Model(conv_slab((8, 8, 16)), device="cpu")
    a = pm.init_state(3)
    for _ in range(2):
        a = pm.make_step()(a)
    b = pm.make_multi_step(2)(pm.init_state(3))
    for key in ("t", "dt", "it"):
        assert torch.equal(a[key], b[key]), key
    for k in a["fields"]:
        assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_boundary_planes_stay_pinned():
    """uz = 0 on both walls and the top entropy at cs² = cs2cool after
    steps (the writeback); all fields finite."""
    pm = pt.Model(conv_slab((8, 8, 16)), device="cpu")
    s = pm.make_multi_step(3)(pm.init_state(0))
    f = s["fields"]
    assert all(bool(torch.isfinite(v).all()) for v in f.values())
    assert bool((f["uu"][2][:, :, [0, -1]] == 0).all())
    eos = pm.eos
    cs2_top = eos.cs20 * torch.exp(
        eos.gamma / eos.cp * f["ss"][:, :, -1]
        + (eos.gamma - 1.0) * (f["lnrho"][:, :, -1] - eos.lnrho0))
    torch.testing.assert_close(cs2_top, torch.ones_like(cs2_top),
                               rtol=1e-6, atol=0.0)


def test_gate_accepts_conv_slab():
    cfg = conv_slab(16)
    assert gate_reason(cfg) is None
    for dev in ("cpu", "cuda"):
        assert fused_gate(cfg, dev) is True


@pytest.mark.parametrize("case", ("unported_bc", "extra_module",
                                  "missing_module", "periodic_z"))
def test_gate_rejects_on_cuda(case):
    """Outside the conv-slab's module sets (the set alone, with
    Magnetic, with Shear or with Shock, each with optional forcing), or
    with a BC the port lacks, a CUDA configuration raises (no GPU needed:
    the gate raises first); the extra module is Shock in the sheared slab,
    which no z-ghosted build has (Shock in the unsheared slab, the case
    here before, runs since the z-ghosted builds with the shock slot,
    tests/test_torch_zghost_shock.py; forcing, the extra module before
    that, is admitted too), its slot given its BC, so that the set is
    what is refused; the missing one Viscosity (Gravity, the missing
    module here before, is optional since the z-walled sets without it
    run the chain)."""
    cfg = conv_slab(16)
    if case == "unported_bc":
        cfg = cfg.replace(bcz=cfg.bcz[:2] + (pt.BC("uz", "c3", "c3"),)
                          + cfg.bcz[3:])
    elif case == "extra_module":
        cfg = conv_slab(16, Omega=0.5, shear=True)
        cfg = cfg.replace(modules=cfg.modules + (pt.Shock(),),
                          bcz=cfg.bcz + (pt.BC("shock", "s", "s"),))
    elif case == "missing_module":
        cfg = cfg.replace(modules=tuple(m for m in cfg.modules
                                        if m.name != "viscosity"))
    else:
        cfg = cfg.replace(grid=pt.GridSpec(nx=16, ny=16, nz=16), bcz=())
    assert gate_reason(cfg) is not None
    with pytest.raises(NotImplementedError):
        fused_gate(cfg, "cuda")
    with pytest.raises(NotImplementedError):
        pt.Model(cfg, device="cuda")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        pt.Entropy(iheatcond=("chit",))
    with pytest.raises(NotImplementedError):
        pt.Entropy(cooling_profile="tanh")
    with pytest.raises(NotImplementedError):
        pt.Gravity(gravz_profile="central")
    with pytest.raises(NotImplementedError):
        pt.Model(conv_slab(16).replace(bcz=conv_slab(16).bcz[:4]),
                 device="cpu")
    with pytest.raises(NotImplementedError):
        pt.Model(conv_slab(16).replace(
            grid=pt.GridSpec(nx=16, ny=16, nz=16,
                             periodic=(False, True, False))), device="cpu")
