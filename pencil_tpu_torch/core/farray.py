"""Field-array registry: named state slots in a stacked tensor (counterpart
of ``pencil_tpu/core/farray.py``).

Modules claim named slots (scalars or 3-vectors); the registry fixes their
order in the stacked ``fa`` of shape (nf, nx, ny, nz) and converts between
that layout and the dict of fields.  PDE slots come first, so ``fa[:nvar]``
is the evolved state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

_KIND_ORDER = {"pde": 0, "comm_aux": 1, "aux": 2}
_COMP_SUFFIX = ("x", "y", "z")


@dataclass(frozen=True)
class Slot:
    name: str
    ncomp: int
    kind: str
    start: int  # first component index in the stacked array


class Registry:
    """Built once per model composition."""

    def __init__(self):
        self._claims: List[Tuple[str, int, str, tuple]] = []
        self._finalized = False
        self.slots: Dict[str, Slot] = {}
        self.comp_names: List[str] = []
        self.nvar = 0          # number of evolved components
        self.ncom = 0          # evolved + communicated aux
        self.nf = 0            # total stacked components

    def register(self, name: str, ncomp: int = 1, kind: str = "pde",
                 comps: tuple = None):
        if self._finalized:
            raise RuntimeError("registry already finalized")
        if kind not in _KIND_ORDER:
            raise ValueError(f"unknown slot kind {kind!r}")
        if any(c[0] == name for c in self._claims):
            raise ValueError(f"duplicate field {name!r}")
        if comps is not None and len(comps) != ncomp:
            raise ValueError("comps length mismatch")
        self._claims.append((name, ncomp, kind, comps))

    def finalize(self):
        claims = sorted(
            enumerate(self._claims), key=lambda t: (_KIND_ORDER[t[1][2]], t[0])
        )
        pos = 0
        for _, (name, ncomp, kind, comps) in claims:
            self.slots[name] = Slot(name, ncomp, kind, pos)
            if ncomp == 1:
                self.comp_names.append(name)
            elif comps is not None:
                self.comp_names.extend(comps)
            else:
                for c in range(ncomp):
                    suffix = _COMP_SUFFIX[c] if ncomp == 3 else str(c + 1)
                    self.comp_names.append(name + suffix)
            pos += ncomp
            if kind == "pde":
                self.nvar = pos
        self.ncom = max(
            (s.start + s.ncomp for s in self.slots.values() if s.kind != "aux"),
            default=0,
        )
        self.nf = pos
        self._finalized = True
        return self

    def slice(self, name: str) -> slice:
        s = self.slots[name]
        return slice(s.start, s.start + s.ncomp)

    def stack(self, fields: Dict[str, torch.Tensor]) -> torch.Tensor:
        """dict-of-fields → (nf, nx, ny, nz). Vector fields are (3, nx, ny, nz)."""
        parts = []
        for name, slot in self.slots.items():
            arr = fields[name]
            if slot.ncomp == 1 and arr.ndim == 3:
                arr = arr[None]
            parts.append(arr)
        return torch.cat(parts, dim=0)

    def unstack(self, fa: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, slot in self.slots.items():
            a = fa[self.slice(name)]
            out[name] = a[0] if slot.ncomp == 1 else a
        return out
