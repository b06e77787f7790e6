"""Fortran namelist parser (the port's copy of
``pencil_tpu/compat/namelist.py``; reference ``src/param_io.f90``: start.in /
run.in are groups like ``&hydro_init_pars ... /``; values are Fortran
literals: T/F logicals, 1.e-3 reals, 'strings', repeat counts ``3*0.0`` and
comma-separated arrays; ``!`` comments)."""
from __future__ import annotations

import re
from typing import Any, Dict, List


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if not tok:
        return None
    if tok in ("T", ".true.", ".TRUE.", "t"):
        return True
    if tok in ("F", ".false.", ".FALSE.", "f"):
        return False
    if tok.startswith(("'", '"')):
        return tok.strip("'\"")
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        return tok


def _split_values(raw: str) -> List[str]:
    """Split a namelist RHS into value tokens, respecting quotes."""
    out, cur, q = [], "", None
    for ch in raw:
        if q:
            cur += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur += ch
        elif ch == ",":
            out.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur)
    return [t for t in (s.strip() for s in out) if t]


def parse_namelists(text: str) -> Dict[str, Dict[str, Any]]:
    """→ {group_name: {param: value-or-list}}."""
    # strip comments (! to EOL, but not inside quotes — good enough: quotes
    # in pencil namelists don't contain '!')
    lines = []
    for line in text.splitlines():
        q = False
        out = ""
        for ch in line:
            if ch in "'\"":
                q = not q
            if ch == "!" and not q:
                break
            out += ch
        lines.append(out)
    text = "\n".join(lines)

    groups: Dict[str, Dict[str, Any]] = {}
    for m in re.finditer(r"&(\w+)(.*?)(?:^|\s)/\s*$", text,
                         re.DOTALL | re.MULTILINE):
        gname = m.group(1).lower()
        body = m.group(2)
        # mask quoted strings so '=' or key-lookalikes inside them cannot
        # fool the assignment splitter (e.g. initaa='Ax=cosysinz')
        _strings: List[str] = []

        def _mask(sm, _s=_strings):
            _s.append(sm.group(0))
            return "\x00%d\x00" % (len(_s) - 1)

        body = re.sub(r"'[^']*'|\"[^\"]*\"", _mask, body)

        def _unmask(raw, _s=_strings):
            return re.sub(r"\x00(\d+)\x00",
                          lambda mm: _s[int(mm.group(1))], raw)
        params: Dict[str, Any] = {}
        # split into key=value chunks: find assignments; keys may be
        # array-indexed like initlnTT(2) (reference ninit-style arrays)
        for am in re.finditer(
                r"([A-Za-z]\w*(?:\(\d+\))?)\s*=\s*((?:[^=]|=(?=[^,\s]))*?)"
                r"(?=(?:,\s*)?[A-Za-z]\w*(?:\(\d+\))?\s*=|\Z)",
                body, re.DOTALL):
            key = am.group(1).lower()
            raw = _unmask(am.group(2).strip().rstrip(","))
            toks = _split_values(raw)
            vals: List[Any] = []
            for t in toks:
                rep = re.match(r"^(\d+)\*(.+)$", t)
                if rep:
                    vals.extend([_parse_value(rep.group(2))] * int(rep.group(1)))
                else:
                    vals.append(_parse_value(t))
            val = vals[0] if len(vals) == 1 else vals
            im = re.match(r"(\w+)\((\d+)\)$", key)
            if im:
                # name(i) = v → grow a list under 'name' (1-based index)
                key, idx = im.group(1), int(im.group(2))
                cur = params.get(key)
                if not isinstance(cur, list):
                    cur = [cur] if cur is not None else []
                while len(cur) < idx:
                    cur.append(None)
                cur[idx - 1] = val
                params[key] = cur
            else:
                params[key] = val
        groups[gname] = params
    return groups


def read_namelist_file(path) -> Dict[str, Dict[str, Any]]:
    with open(path) as f:
        return parse_namelists(f.read())
