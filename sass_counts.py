#!/usr/bin/env python3
"""Count the issued instructions of the flagship template's kernels from
their SASS: for each instance, every loop of the compiled kernel (a
backward branch and its target) with its instructions split into FP32,
shared-memory loads, integer and address arithmetic, and the rest.

    python3 sass_counts.py [--lib fused_rhs | --so LIBRARY.so]
                           [--kernel K1 K3 ...] [--dump DIR]
                           [--skip K1:0x41c0-0x5100,0x58d0-0x5db0 ...]
    python3 sass_counts.py --from-dump DIR/STEM [--kernel ...] [--skip ...]
    python3 sass_counts.py --parent OLD/fused_rhs.cu [--libs LIB ...]

``--lib`` builds (or finds built) the package's library of that name
(K1s and K5w are instances of ``fused_rhs_shock``, K4 and K5 of
``fused_rhs_shear``, with rotation and the del6 terms as the shear box
runs them, the same names of ``fused_rhs_shock_hydro`` its K1sh and
K5wh, of ``fused_rhs_shear_ns``, ``fused_rhs_shear_hydro`` and
``fused_rhs_shear_hydro_ns`` their K4n/K5n, K4h/K5h and K4hn/K5hn, of
``fused_rhs_shock_hydro_ent``, ``fused_rhs_shear_hydro_ent`` and
``fused_rhs_shear_hydro_ent_ns`` K1she/K5whe, K4he/K5he and K4hne/K5hne,
of ``fused_rhs_shock_ent``, ``fused_rhs_shear_ent`` and
``fused_rhs_shear_ent_ns`` K1se/K5wse, K4e/K5e and K4ne/K5ne (9, 9 and 8
ring fields for ``--auto-skip``),
K6 and K7 of ``fused_rhs_zg``, the same names of
``fused_rhs_zg_mag`` its K6m and K7m, of ``fused_rhs_zg_shear`` and
``fused_rhs_zg_mag_shear`` their K6s/K7s and K6ms/K7ms (5 and 8 ring
fields), of ``fused_rhs_zg_iso``, ``fused_rhs_zg_iso_mag``,
``fused_rhs_zg_iso_shear`` and ``fused_rhs_zg_iso_mag_shear`` K6i/K7i,
K6mi/K7mi, K6si/K7si and K6msi/K7msi (4 and 7 ring fields), and K6rot,
K7rot their Coriolis
instances, K6chi, K7chi their chi-const ones, K6h3, K7h3 their del6 ones,
K6chih3, K7chih3 both, K6roth3, K7roth3 del6 with rotation and
K6rotchi, K7rotchi chi-const with rotation; K1h3, K2h3, K3h3, K3midh3
and K2Lh3 are the del6 instances of the four periodic builds);
``--so`` reads any library built from csrc/fused_rhs.cu, e.g. a variant
that time_loader_variants.py left in pencil_tpu_torch/_build/variants/,
or the 4×4×16 template of earlier commits that its ``--parent-tree``
built (the zroll_rhs library under that tree's _build/: kernels zr-K4,
zr-K5, zr-K1s, zr-K5w, whose one loop is the tile load).
The x-march is the largest loop of an instance; the loops inside it (the
rebuild loop of the DEFER instances) are listed with their own counts,
so that instructions per grid point = the march body outside its inner
loops + each inner loop's body times its trips.  ``--skip``
leaves address ranges of an instance out of every count: the paths that
the run in question never takes (the 4-byte row copies where nz is a
multiple of 4, the first plane's fill of the x taps), read off the dump's
forward branches; ``--auto-skip`` finds those two paths itself inside the
march loop: the 4-byte copies are the branch over the most copies
(LDGSTS) within the block that issues a plane's copies, the fill the
branch over 6 shared loads a field and no FP32.  ``--dump`` writes each
instance's SASS there, as
DIR/<library stem>_<kernel>.sass; ``--from-dump DIR/STEM`` counts such
files again (no toolkit needed), e.g. with other ``--skip`` ranges.
``--parent`` builds each library of ``--libs`` (default: every library)
from another copy of csrc/fused_rhs.cu, with that library's definitions,
into pencil_tpu_torch/_build/parent/, all nvcc runs at once, and compares
every instance of the template in the two builds instruction for
instruction (the constant-bank offsets of the kernel parameters, which
move where the parameter struct grows, left out); a library that the
old copy does not build (its ``#error``) is listed as new, and an
instance in one build only as "only in" that one.  For each instance
that differs it prints the instructions of its march (the largest loop)
and its local-memory instructions (LDL, STL) in both builds and, where a
CUDA device is at hand, each named instance's registers and local bytes
(``pc_flagship_attrs``) in both.
Otherwise it needs cuobjdump (the CUDA toolkit); no card.  Prints one
line per loop (per library with ``--parent``) and, last, one JSON object.
"""
import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

# template arguments FIRST, DEFER, LAST, KICK, FAKE, ROT, H3, CHI, UPW, SHK
# of each instance of pc_flagship (trailing false flags may be left out)
INSTANCES = {
    "K1": (1, 0, 0, 0, 0, 0, 0), "K2": (0, 1, 0, 0, 0, 0, 0),
    "K3": (0, 0, 1, 1, 0, 0, 0), "K3nokick": (0, 0, 1, 0, 0, 0, 0),
    "K3mid": (0, 0, 0, 0, 0, 0, 0), "K2L": (0, 1, 1, 1, 0, 0, 0),
    "K8-K1": (1, 0, 0, 0, 1, 0, 0), "K8-K2": (0, 1, 0, 0, 1, 0, 0),
    "K8-K3": (0, 0, 1, 1, 1, 0, 0),
    "K1s": (1, 0, 0, 0, 0, 0, 0), "K5w": (0, 0, 0, 0, 0, 0, 0),
    "K4": (1, 0, 0, 0, 0, 1, 1), "K5": (0, 0, 0, 0, 0, 1, 1),
    "K6": (1, 0, 0, 0, 0, 0, 0), "K7": (0, 0, 0, 0, 0, 0, 0),
    "K6rot": (1, 0, 0, 0, 0, 1, 0), "K7rot": (0, 0, 0, 0, 0, 1, 0),
    # the periodic builds' del6 instances, the z-ghosted builds' chi-const
    "K1h3": (1, 0, 0, 0, 0, 0, 1), "K2h3": (0, 1, 0, 0, 0, 0, 1),
    "K3h3": (0, 0, 1, 1, 0, 0, 1), "K3midh3": (0, 0, 0, 0, 0, 0, 1),
    "K2Lh3": (0, 1, 1, 1, 0, 0, 1),
    "K6chi": (1, 0, 0, 0, 0, 0, 0, 1), "K7chi": (0, 0, 0, 0, 0, 0, 0, 1),
    # the z-ghosted builds' del6 instances, alone and beside chi-const
    "K6h3": (1, 0, 0, 0, 0, 0, 1), "K7h3": (0, 0, 0, 0, 0, 0, 1),
    "K6chih3": (1, 0, 0, 0, 0, 0, 1, 1), "K7chih3": (0, 0, 0, 0, 0, 0, 1, 1),
    # with rotation too (the stratified MRI box with del6)
    "K6roth3": (1, 0, 0, 0, 0, 1, 1), "K7roth3": (0, 0, 0, 0, 0, 1, 1),
    # chi-const with rotation (the stratified shearing box with ss)
    "K6rotchi": (1, 0, 0, 0, 0, 1, 0, 1),
    "K7rotchi": (0, 0, 0, 0, 0, 1, 0, 1),
    # the upwinding (UPW) of every build: the periodic builds' five
    # kernels, the first and update kernel of the others (K1upw and
    # K3midupw are the shock builds' K1s/K5w and the shear builds' K4/K5
    # with it; K6upw and K7upw the z-ghosted builds', also with rotation
    # and beside chi-const)
    "K1upw": (1, 0, 0, 0, 0, 0, 0, 0, 1), "K2upw": (0, 1, 0, 0, 0, 0, 0, 0, 1),
    "K3upw": (0, 0, 1, 1, 0, 0, 0, 0, 1),
    "K3midupw": (0, 0, 0, 0, 0, 0, 0, 0, 1),
    "K2Lupw": (0, 1, 1, 1, 0, 0, 0, 0, 1),
    "K6upw": (1, 0, 0, 0, 0, 0, 0, 0, 1), "K7upw": (0, 0, 0, 0, 0, 0, 0, 0, 1),
    "K6rotupw": (1, 0, 0, 0, 0, 1, 0, 0, 1),
    "K7rotupw": (0, 0, 0, 0, 0, 1, 0, 0, 1),
    "K6chiupw": (1, 0, 0, 0, 0, 0, 0, 1, 1),
    "K7chiupw": (0, 0, 0, 0, 0, 0, 0, 1, 1),
    "K4upw": (1, 0, 0, 0, 0, 1, 0, 0, 1), "K5upw": (0, 0, 0, 0, 0, 1, 0, 0, 1),
    # the shock builds' shock diffusivities (SHK): K1s/K5w's and K4/K5's
    # twins (the latter with rotation and del6, as the shear box runs)
    "K1ssd": (1, 0, 0, 0, 0, 0, 0, 0, 0, 1),
    "K5wsd": (0, 0, 0, 0, 0, 0, 0, 0, 0, 1),
    "K4sd": (1, 0, 0, 0, 0, 1, 1, 0, 0, 1),
    "K5sd": (0, 0, 0, 0, 0, 1, 1, 0, 0, 1),
}
NFLAGS = 10      # the template arguments of pc_flagship
# MODE (0 first, 1 update) and WRAP of pc_shearbox, the 4x4x16 template
ZR_INSTANCES = {"zr-K4": (0, 0), "zr-K5": (1, 0), "zr-K1s": (0, 1),
                "zr-K5w": (1, 1)}


def mangled(kname):
    """The parts of mangled names that pick an instance: its NFLAGS
    arguments, then, while the last is false, the names of builds from
    before that flag (SHK, UPW, CHI, then H3: nine, eight, seven and six
    arguments)."""
    if kname in ZR_INSTANCES:
        mode, wrap = ZR_INSTANCES[kname]
        return [f"pc_shearboxILi{mode}ELb{wrap}E"]
    args = tuple(INSTANCES[kname]) + (0,) * (NFLAGS - len(INSTANCES[kname]))
    keys = []
    while True:
        keys.append("pc_flagshipI" + "".join(f"Lb{b}E" for b in args) + "E")
        if len(args) <= 6 or args[-1]:
            return keys
        args = args[:-1]
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


def auto_skip(ins, nfields):
    """The march loop's 4-byte row copies and first-plane x-tap fill, as
    address ranges (see the module's docstring)."""
    lo, hi = loops(ins)[0]
    fwd = []
    for addr, text in ins:
        m = TARGET.search(text)
        if lo <= addr <= hi and m and m.group(1).startswith("0x"):
            tgt = int(m.group(1), 16)
            if tgt > addr:
                body = [t for a, t in ins if addr < a < tgt]
                cls = collections.Counter(classify(opcode(t)) for t in body)
                copies = sum(opcode(t) == "LDGSTS" for t in body)
                fwd.append((addr, tgt, cls, copies))
    blocks = sorted((f for f in fwd if f[3]), key=lambda f: -f[3])
    outer = blocks[0]
    four_byte = [f for f in blocks[1:]
                 if outer[0] <= f[0] and f[1] <= outer[1]][0]
    # K8 reads only the centre tap: its march has no such fill
    fill = [f for f in fwd if f[2]["lds"] == 6 * nfields and not f[3]
            and not f[2]["fp32"]][:1]
    return [(f[0] + 0x10, f[1] - 0x10) for f in [four_byte] + fill]


def instance_key(name):
    """The template arguments of a pc_flagship instance in its mangled
    name (the parameter types after them may differ between commits),
    padded with false flags to NFLAGS, so that an instance of a build from
    before a flag was added has the key of its counterpart."""
    m = re.search(r"pc_flagshipI((?:Lb[01]E)+)E", name)
    if not m:
        return name
    return m.group(1) + "Lb0E" * (NFLAGS - m.group(1).count("Lb"))


def normalized(ins):
    """An instance's instructions without the constant-bank offsets."""
    return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", t)
            for _, t in ins]


def _shape(ins):
    """(instructions of the march, the largest loop; local-memory
    instructions) of an instance."""
    spans = loops(ins)
    march = sum(counts(ins, *spans[0]).values()) if spans else 0
    local = sum(opcode(t) in ("LDL", "STL") for _, t in ins)
    return march, local


def _attrs(so, lib, parent=False):
    """Instance name -> (registers, local bytes) of the library file ``so``
    built for ``lib``, or {} without a CUDA device; ``parent``: ``so`` is
    built from an older source, which may lack the UPW and SHK instances
    (indices from 128), and those it lacks are left out."""
    import ctypes
    from pencil_tpu_torch.ops import fused_rhs as fr
    try:
        dll = ctypes.CDLL(str(so))
        dll.pc_flagship_attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
        dll.pc_flagship_attrs.restype = ctypes.c_int
        out = {}
        for name, which in fr.library_instances(lib).items():
            a = (ctypes.c_int * len(fr.ATTR_KEYS))()
            if dll.pc_flagship_attrs(which, ctypes.addressof(a)) == 0:
                out[name] = (a[0], a[1])
            elif not (parent and which >= 128):
                return {}
        return out
    except OSError:
        return {}


def compare_parent(src, libs):
    """Each library of ``libs`` built from ``src`` against the package's
    build: per library, its instances and those whose instructions
    differ, with their march and local-memory instructions and (with a
    card) each instance's registers and local bytes in both builds."""
    from pencil_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    procs = {lib: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *_build.LIBRARIES[lib][1], "-o",
         str(out_dir / f"{lib}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for lib in libs}
    new = _build.build()
    result = {}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if "#error" not in log:
                raise RuntimeError(f"{lib} from {src}: nvcc failed\n{log}")
            result[lib] = {"instances": None, "differ": "new library"}
            print(f"{lib}: not built by {src} (its #error): new", flush=True)
            continue
        old_f = {instance_key(n): i for n, i in functions(
            out_dir / f"{lib}.so", cuobjdump).items()}
        new_f = {instance_key(n): i for n, i in functions(
            new[lib], cuobjdump).items()}
        differ = {}
        for key in sorted(set(old_f) | set(new_f)):
            if key not in old_f or key not in new_f:
                differ[key] = "only in " + ("parent" if key in old_f
                                            else "change")
                continue
            a, b = normalized(old_f[key]), normalized(new_f[key])
            if a != b:
                pairs = [(k, x, y) for k, (x, y) in enumerate(zip(a, b))
                         if x != y]
                first = pairs[0][0] if pairs else min(len(a), len(b))
                (ma, la), (mb, lb) = _shape(old_f[key]), _shape(new_f[key])
                differ[key] = (f"{len(a)} -> {len(b)} instructions, "
                               f"march {ma} -> {mb}, local-memory "
                               f"instructions {la} -> {lb}, "
                               f"{len(pairs)} differ, first at {first}: "
                               + "; ".join(f"{k}: {x} -> {y}"
                                           for k, x, y in pairs[:4]))
        old_a, new_a = (_attrs(out_dir / f"{lib}.so", lib, parent=True),
                        _attrs(new[lib], lib))
        attrs = {name: (old_a.get(name), r) for name, r in new_a.items()}
        result[lib] = {"instances": len(new_f), "differ": differ,
                       "registers_local": attrs}
        print(f"{lib}: {len(new_f)} functions, "
              + ("every one the parent's, instruction for instruction"
                 if not differ else f"differ: {differ}"), flush=True)
        if attrs:
            print(f"{lib}: (registers, local bytes) parent -> change: "
                  + ", ".join(f"{n} {o} -> {r}" for n, (o, r)
                              in attrs.items()), flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", default="fused_rhs")
    ap.add_argument("--so")
    ap.add_argument("--kernel", nargs="*", default=["K1", "K3", "K8-K1"])
    ap.add_argument("--dump")
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--from-dump")
    ap.add_argument("--auto-skip", type=int, metavar="FIELDS",
                    help="find the skipped paths of a march over FIELDS "
                    "ring fields (7 for the flagship, 8 with ss or shock, "
                    "9 with both)")
    ap.add_argument("--parent", help="another copy of csrc/fused_rhs.cu "
                    "(its headers beside it) to compare every build with")
    ap.add_argument("--libs", nargs="*")
    args = ap.parse_args()
    if args.parent:
        from pencil_tpu_torch.ops import _build
        libs = args.libs or list(_build.LIBRARIES)
        print(json.dumps({"parent": args.parent, "libraries":
                          compare_parent(args.parent, libs)}), flush=True)
        return 0
    skips = {}
    for item in args.skip:
        kname, _, ranges = item.partition(":")
        skips[kname] = [tuple(int(v, 16) for v in r.split("-"))
                        for r in ranges.split(",") if r]
    if args.from_dump:
        so = Path(args.from_dump)
        funcs = {}
        for kname in args.kernel:
            key = mangled(kname)[0]
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
        keys = mangled(kname)
        match = [n for key in keys for n in funcs if key in n]
        if not match:
            print(f"{kname}: no instance {keys} in {so.name}", flush=True)
            continue
        ins = funcs[match[0]]
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            (Path(args.dump) / f"{so.stem}_{kname}.sass").write_text(
                "\n".join(f"{a:06x} {t}" for a, t in ins) + "\n")
        SKIP[:] = (auto_skip(ins, args.auto_skip) if args.auto_skip
                   else skips.get(kname, []))
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
