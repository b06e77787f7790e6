"""time_series.dat writer with the reference's self-describing format
(counterpart of ``pencil_tpu/io/timeseries.py``; host code, the same
bytes for the same values).

Reference contract (``src/diagnostics.f90`` ``prints`` + ``print.in``):
columns are selected by name with an optional Fortran format spec
(``urms(F8.4)``, ``it(I9)``, ``dt(E10.3)``), the header line is
``#--it---t----dt---urms...`` with dashes padding each column to width, and
rows are fixed-width.  Post-processing tools parse exactly this.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

_SPEC_RE = re.compile(r"^\s*([A-Za-z0-9_]+)\s*(?:\(([A-Za-z0-9.]+)\))?")

_DEFAULT_FMT = {"it": "I9", "t": "E12.4", "dt": "E10.3"}


def parse_print_in(text: str) -> List[Tuple[str, str]]:
    """Parse print.in-style content: one ``name(FMT)`` per line; '!'/'#'
    comments stripped (reference rprint_list, src/register.f90:810)."""
    out = []
    for line in text.splitlines():
        line = line.split("!")[0].split("#")[0].strip()
        if not line:
            continue
        m = _SPEC_RE.match(line)
        if not m:
            continue
        name, fmt = m.group(1), m.group(2)
        if fmt is None:
            fmt = _DEFAULT_FMT.get(name, "E10.3")
        out.append((name, fmt))
    return out


def _fortran_format(val, fmt: str) -> str:
    kind = fmt[0].upper()
    body = fmt[1:]
    if kind == "I":
        w = int(body)
        return f"{int(val):{w}d}"
    if "." in body:
        w, d = (int(p) for p in body.split("."))
    else:
        w, d = int(body), 3
    if kind == "F":
        s = f"{float(val):{w}.{d}f}"
    elif kind in ("E", "G"):
        s = f"{float(val):{w}.{d}E}"
        # Fortran prints E+01 style with capital E; python matches close enough
    else:
        s = f"{float(val):{w}.{d}g}"
    if len(s) > w:
        # overflow: Fortran prints asterisks, keeping column alignment
        s = "*" * w
    return s


def _col_width(fmt: str) -> int:
    body = fmt[1:]
    return int(body.split(".")[0])


class TimeSeriesWriter:
    """Appends fixed-width rows; writes the header once per open file."""

    def __init__(self, path, columns: Sequence[Tuple[str, str]]):
        self.path = path
        self.columns = list(columns)
        self._header_written = False

    def header(self) -> str:
        parts = []
        for name, fmt in self.columns:
            w = _col_width(fmt)
            label = name      # never truncate (ref prints full names, e.g.
            pad = max(w - 1 - len(label), 0)   # conv-slab 'tot_ang_mom')
            parts.append("-" * (pad // 2 + pad % 2) + label + "-" * (pad // 2) + "-")
        return "#" + "".join(parts)[1:]

    def format_row(self, values: Dict[str, float]) -> str:
        return "".join(
            _fortran_format(values[name], fmt) for name, fmt in self.columns
        )

    def append(self, values: Dict[str, float]):
        with open(self.path, "a") as f:
            if not self._header_written:
                if f.tell() == 0:
                    f.write(self.header() + "\n")
                self._header_written = True
            f.write(self.format_row(values) + "\n")


def read_time_series(path) -> Dict[str, list]:
    """Read a time_series.dat (ours or the reference's) into name→list."""
    with open(path) as f:
        lines = f.readlines()
    names = None
    data: Dict[str, list] = {}
    for line in lines:
        if line.startswith("#"):
            names = [t for t in line.lstrip("#").replace("-", " ").split() if t]
            data = {n: [] for n in names}
            continue
        if names is None or not line.strip():
            continue
        vals = line.split()
        if len(vals) != len(names):
            # Fortran fixed-width rows can juxtapose columns with no space
            # before a minus sign ("3.739E+01-3.761E-01"): extract numbers
            vals = re.findall(
                r"[-+]?\d+\.?\d*(?:[EeDd][-+]?\d+)?", line)
            if len(vals) != len(names):
                continue
        for n, v in zip(names, vals):
            v = v.replace("D", "E").replace("d", "e")
            try:
                data[n].append(float(v))
            except ValueError:
                # Fortran 3-digit exponents drop the E ("8.988+306")
                m = re.fullmatch(r"([-+]?\d*\.?\d+)([+-]\d{3})", v)
                data[n].append(float(m.group(1) + "E" + m.group(2))
                               if m else float("nan"))
    return data
