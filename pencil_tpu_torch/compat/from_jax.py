"""State carried between the JAX package and the port as numpy arrays.

The port's configurations have no weights: both packages build the same
configuration from the same kwargs, so the state is all that crosses —
the flagship's 7 fields (uu, lnrho, aa), forced hydro's 4 (uu, lnrho)
(the isothermal stratified layer's too),
the 8 and 5 of non-isothermal turbulence (uu, lnrho, ss, aa; uu, lnrho,
ss), stratified convection's 5 (uu, lnrho, ss), magnetoconvection's 8
(uu, lnrho, ss, aa), the shear and shock boxes' 8 slots (uu, lnrho, aa,
shock), or their other isothermal layouts: uu, lnrho, shock (the hydro
shock and shear boxes), uu, lnrho, aa (the shear box without the shock
slot) and uu, lnrho (the hydro shear box without it), always in the JAX
package's registration order.  This module imports no JAX; the caller
converts JAX arrays with ``np.asarray``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import require_device


def state_from_numpy(fields: Dict[str, np.ndarray], t, dt, it,
                     device="cuda") -> Dict:
    """The port's (unpacked) state from numpy fields and scalars, on the
    card unless ``device="cpu"`` (a RuntimeError if no card is present)."""
    device = require_device(device)
    dev = dict(dtype=torch.float32, device=device)
    return {
        "fields": {k: torch.tensor(np.asarray(v), **dev)
                   for k, v in fields.items()},
        "t": torch.tensor(float(t), **dev),
        "dt": torch.tensor(float(dt), **dev),
        "it": torch.tensor(int(it), dtype=torch.int32, device=device),
    }


def state_to_numpy(state: Dict) -> Dict:
    """Inverse of ``state_from_numpy``: keyword arguments for it."""
    if "fields" not in state:
        raise ValueError("unpack the state first (Model.unpack_state)")
    return {
        "fields": {k: v.detach().cpu().numpy()
                   for k, v in state["fields"].items()},
        "t": float(state["t"]),
        "dt": float(state["dt"]),
        "it": int(state["it"]),
    }


def overrides_from_numpy(fields: Dict[str, np.ndarray], reg) -> Dict:
    """Numpy fields (e.g. a JAX state's) → ``Model.init_state(overrides=)``
    for the registry ``reg``: one float32 array per slot, a scalar slot as
    (nx, ny, nz) and a vector slot as (ncomp, nx, ny, nz).  Raises if a
    slot is missing or has another shape."""
    out = {}
    for name, slot in reg.slots.items():
        if name not in fields:
            raise KeyError(f"no field {name!r} for the port's registry")
        arr = np.array(fields[name], np.float32)   # a writable copy
        want_vector = slot.ncomp > 1
        if arr.ndim != (4 if want_vector else 3) or (
                want_vector and arr.shape[0] != slot.ncomp):
            raise ValueError(f"field {name!r}: shape {arr.shape} does not "
                             f"fit a {slot.ncomp}-component slot")
        out[name] = arr
    return out


def snapshot_from_jax(npz_path, model) -> Dict:
    """A JAX ``var.npz`` (``pencil_tpu.io.snapshot.save_snapshot``) as the
    port's state on ``model``'s device: the fields (checked against the
    registry), t, dt and it.  The JAX PRNG ``key`` is dropped: the two
    packages draw different numbers from any seed, so a forced run goes on
    with ``model.generator`` as it stands (seed it first to repeat a
    run)."""
    with np.load(npz_path) as z:
        fields = {k[6:]: z[k] for k in z.files if k.startswith("field_")}
        over = overrides_from_numpy(fields, model.reg)
        return state_from_numpy(over, z["t"], z["dt"], z["it"],
                                device=model.device)
