"""Snapshots and bit-exact restart (counterpart of
``pencil_tpu/io/snapshot.py``; reference ``src/snapshot.f90`` wsnap/rsnap
and the persistent records of ``src/persist.f90``).

One ``.npz`` per snapshot with the JAX package's array names: every state
field as ``field_<name>``, ``t``, ``dt``, ``it``, optional ``extra_json``,
and ``key``.  All stochastic state of the port lives in
``Model.generator`` (the initial noise and the forcing draws), so ``key``
holds ``generator.get_state()`` and ``load_snapshot(path, model)`` puts it
back: a run restarted from a snapshot repeats the original bit for bit,
forcing draws included.  The file is written to ``<path>.tmp`` and renamed,
so a crash never leaves a torn checkpoint.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import require_device


def save_snapshot(path, state: Dict, extra: Optional[Dict] = None,
                  model=None):
    """Write ``state`` (packed or unpacked) to ``path``; with ``model`` its
    generator state goes along as ``key``."""
    if "fields" not in state:
        if model is None:
            raise ValueError("a packed state needs the model to unpack it")
        state = model.unpack_state(state)
    arrays = {f"field_{k}": v.detach().cpu().numpy()
              for k, v in state["fields"].items()}
    for k in ("t", "dt", "it"):
        arrays[k] = state[k].detach().cpu().numpy()
    if model is not None:
        arrays["key"] = model.generator.get_state().cpu().numpy()
    if extra:
        arrays["extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    tmp = str(path) + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_snapshot(path, model=None, device=None) -> Dict:
    """The state saved at ``path``, on ``model``'s device with its
    generator restored, or on ``device`` when no model is given."""
    if model is None and device is None:
        raise ValueError("load_snapshot needs a model or a device")
    device = model.device if model is not None else require_device(device)
    with np.load(path) as z:
        fields = {k[6:]: torch.tensor(z[k], device=device)
                  for k in z.files if k.startswith("field_")}
        state = {"fields": fields,
                 **{k: torch.tensor(z[k], device=device)
                    for k in ("t", "dt", "it")}}
        if "extra_json" in z.files:
            state["extra"] = json.loads(bytes(z["extra_json"].tobytes())
                                        .decode())
        if model is not None and "key" in z.files:
            key = z["key"]
            if key.dtype != np.uint8:
                raise ValueError(
                    f"{path}: 'key' is not a torch generator state (a JAX "
                    "snapshot? use compat.from_jax.snapshot_from_jax)")
            model.generator.set_state(torch.tensor(key))
    if model is not None:
        state["fields"] = {k: state["fields"][k] for k in model.reg.slots}
    return state
