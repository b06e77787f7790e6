"""State carried between the JAX package and the port as numpy arrays.

The flagship has no weights: both packages build the same configuration
from the same kwargs, so the state is all that crosses.  This module
imports no JAX; the caller converts JAX arrays with ``np.asarray``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_numpy(fields: Dict[str, np.ndarray], t, dt, it,
                     device="cpu") -> Dict:
    """The port's (unpacked) state from numpy fields and scalars."""
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
