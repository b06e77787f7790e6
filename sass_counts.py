#!/usr/bin/env python3
"""Count the issued instructions of the flagship template's kernels from
their SASS: for each instance, every loop of the compiled kernel (a
backward branch and its target) with its instructions split into FP32,
shared-memory loads, integer and address arithmetic, and the rest.

    python3 sass_counts.py [--lib fused_rhs | --so LIBRARY.so]
                           [--kernel K1 K3 ...] [--dump DIR]
                           [--skip K1:0x41c0-0x5100,0x58d0-0x5db0 ...]
    python3 sass_counts.py --from-dump DIR/STEM [--kernel ...] [--skip ...]

``--lib`` builds (or finds built) the package's library of that name;
``--so`` reads any library built from csrc/fused_rhs.cu, e.g. a variant
that time_loader_variants.py left in pencil_tpu_torch/_build/variants/.
The x-march is the largest loop of an instance; the loops inside it (the
rebuild loop of the DEFER instances) are listed with their own counts,
so that instructions per grid point = the march body outside its inner
loops + each inner loop's body times its trips.  ``--skip``
leaves address ranges of an instance out of every count: the paths that
the run in question never takes (the 4-byte row copies where nz is a
multiple of 4, the first plane's fill of the x taps), read off the dump's
forward branches.  ``--dump`` writes each instance's SASS there, as
DIR/<library stem>_<kernel>.sass; ``--from-dump DIR/STEM`` counts such
files again (no toolkit needed), e.g. with other ``--skip`` ranges.
Otherwise it needs cuobjdump (the CUDA toolkit); no card.  Prints one
line per loop and, last, one JSON object.
"""
import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

# template arguments FIRST, DEFER, LAST, KICK, FAKE, ROT of each instance
INSTANCES = {
    "K1": (1, 0, 0, 0, 0, 0), "K2": (0, 1, 0, 0, 0, 0),
    "K3": (0, 0, 1, 1, 0, 0), "K3nokick": (0, 0, 1, 0, 0, 0),
    "K3mid": (0, 0, 0, 0, 0, 0), "K2L": (0, 1, 1, 1, 0, 0),
    "K8-K1": (1, 0, 0, 0, 1, 0), "K8-K2": (0, 1, 0, 0, 1, 0),
    "K8-K3": (0, 0, 1, 1, 1, 0),
}
CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSET", "FSETP",
             "FCHK"},
    "lds": {"LDS"},
    "sts": {"STS"},
    "sfu": {"MUFU"},
    "global": {"LDG", "STG", "LDGSTS", "LDGDEPBAR", "DEPBAR", "LD", "ST",
               "LDL", "STL"},
    "control": {"BRA", "BRX", "BSSY", "BSYNC", "BREAK", "BAR", "EXIT", "RET",
                "CALL", "WARPSYNC", "NOP", "YIELD", "ERRBAR", "MEMBAR",
                "SYNCS", "BMOV"},
}
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?);")
TARGET = re.compile(r"\b(?:BRA|BRX)\b.*?(0x[0-9a-f]+|`\(\.L_[^)]*\))")


def classify(op):
    for cls, ops in CLASSES.items():
        if op in ops:
            return cls
    return "int"     # integer, address, move, predicate, conversion


def functions(so, cuobjdump):
    """Mangled name -> list of (address, text) of a library's kernels."""
    out = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur, labels = {}, None, {}
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_\S+):", line)
        if m:
            labels[(id(cur), m.group(1))] = len(cur)
            continue
        m = INSTR.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    for name, ins in funcs.items():       # labels -> addresses
        for k, (addr, text) in enumerate(ins):
            m = re.search(r"`\((\.L_[^)]*)\)", text)
            if m and (id(ins), m.group(1)) in labels:
                at = labels[(id(ins), m.group(1))]
                if at < len(ins):
                    ins[k] = (addr, text.replace(m.group(0),
                                                 hex(ins[at][0])))
    return funcs


def opcode(text):
    toks = text.split()
    if toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0].split(".")[0]


def loops(ins):
    """[(first address, last address)] of every backward branch, largest
    span first."""
    spans = []
    for addr, text in ins:
        m = TARGET.search(text)
        if m and m.group(1).startswith("0x"):
            t = int(m.group(1), 16)
            if t <= addr:
                spans.append((t, addr))
    return sorted(set(spans), key=lambda s: s[0] - s[1])


def counts(ins, lo, hi, holes=()):
    c = collections.Counter()
    holes = tuple(holes) + tuple(SKIP)
    for addr, text in ins:
        if lo <= addr <= hi and not any(a <= addr <= b for a, b in holes):
            c[classify(opcode(text))] += 1
    return c


SKIP = []     # address ranges left out of the instance being counted


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", default="fused_rhs")
    ap.add_argument("--so")
    ap.add_argument("--kernel", nargs="*", default=["K1", "K3", "K8-K1"])
    ap.add_argument("--dump")
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--from-dump")
    args = ap.parse_args()
    skips = {}
    for item in args.skip:
        kname, _, ranges = item.partition(":")
        skips[kname] = [tuple(int(v, 16) for v in r.split("-"))
                        for r in ranges.split(",") if r]
    if args.from_dump:
        so = Path(args.from_dump)
        funcs = {}
        for kname in args.kernel:
            key = "pc_flagshipI" + "".join(f"Lb{b}E"
                                           for b in INSTANCES[kname])
            path = so.with_name(f"{so.name}_{kname}.sass")
            if path.exists():
                funcs[key] = [(int(ln.split()[0], 16),
                               ln.split(None, 1)[1].strip())
                              for ln in path.read_text().splitlines()]
    else:
        from pencil_tpu_torch.ops import _build
        so = Path(args.so) if args.so else _build.build()[args.lib]
        cuobjdump = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
        funcs = functions(so, cuobjdump)
    result = {"library": str(so), "kernels": {}}
    for kname in args.kernel:
        key = "pc_flagshipI" + "".join(f"Lb{b}E" for b in INSTANCES[kname])
        match = [n for n in funcs if key in n]
        if not match:
            print(f"{kname}: no instance {key} in {so.name}", flush=True)
            continue
        ins = funcs[match[0]]
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            (Path(args.dump) / f"{so.stem}_{kname}.sass").write_text(
                "\n".join(f"{a:06x} {t}" for a, t in ins) + "\n")
        SKIP[:] = skips.get(kname, [])
        spans = loops(ins)
        total = counts(ins, 0, ins[-1][0])
        print(f"{kname} {match[0]}: {len(ins)} instructions "
              f"{dict(total)}, {len(spans)} loops", flush=True)
        entry = {"instructions": len(ins), "all": dict(total),
                 "skipped": SKIP[:], "loops": []}
        for lo, hi in spans:
            inner = [s for s in spans if s != (lo, hi)
                     and lo <= s[0] and s[1] <= hi]
            own = counts(ins, lo, hi, inner)
            whole = counts(ins, lo, hi)
            other = collections.Counter(
                opcode(t) for a, t in ins if lo <= a <= hi
                and not any(x <= a <= y for x, y in inner + SKIP)
                and classify(opcode(t)) == "int")
            print(f"  loop {lo:#x}-{hi:#x}: {sum(whole.values())} "
                  f"instructions, {len(inner)} loops inside; outside "
                  f"them {sum(own.values())}: {dict(own)}; its int "
                  f"opcodes {dict(other.most_common(12))}", flush=True)
            entry["loops"].append({
                "span": [lo, hi], "inside": len(inner),
                "own": dict(own), "whole": dict(whole)})
        result["kernels"][kname] = entry
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
