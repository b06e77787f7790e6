"""Bit-exact re-implementation of the reference's machine-independent
random-number generators (the port's copy of
``pencil_tpu/compat/pencil_rng.py``; reference ``src/general.f90``):
``mars_ran`` / ``random_gen='nr_f90'`` (Park–Miller by Schrage combined
with a Marsaglia xorshift, per Numerical Recipes for F90) and ``ran0`` /
``'min_std'``.

The streams, the draw order of the reference's consumers and the API are
those of the JAX package's scalar code; ``draw(n)`` and ``gaunoise_vect``
are vectorised with numpy.  Both generators are linear recurrences once
their first step has run: the Schrage step of a state in [0, 2³¹−1) is the
Lehmer step d ← 16807·d mod (2³¹−1), and the xorshift (13, 17, 5) is a
linear map of the 32 state bits over GF(2).  So ``draw`` splits a stream
into lanes, starts each lane its length ahead of the previous one (a
modular power of 16807, a power of the 32×32 bit matrix) and steps all
lanes at once.  ``next()`` and the state after any ``draw`` are the scalar
code's, so a consumer may mix the two.

All arithmetic is 32-bit two's-complement integer (Fortran default
integer) and float32 (Fortran default real).

    python -m pencil_tpu_torch.compat.pencil_rng [N]

times ``gaunoise_vect`` of a 3-component field on an (N+6)³ ghosted box
(default N = 256) with each generator.
"""
from __future__ import annotations

import sys
import time

import numpy as np

_M32 = 0xFFFFFFFF
_IM = 2147483647
_IA = 16807
_IQ = 127773
_IR = 2836
# the draws that one lane-parallel block computes: 2048 lanes of 2048 steps
_BLOCK = 1 << 22


def _s32(x):
    """Interpret a masked 32-bit pattern as a signed int."""
    x &= _M32
    return x - 0x100000000 if x & 0x80000000 else x


def _schrage(d):
    """One Schrage step of a signed state (Fortran truncating division)."""
    k = d // _IQ if d >= 0 else -((-d) // _IQ)
    d = _IA * (d - k * _IQ) - _IR * k
    return d + _IM if d < 0 else d


def _lanes(n):
    """(lanes, steps per lane) of a block of ``n`` draws."""
    lanes = max(1, min(n, int(np.sqrt(n))))
    return lanes, -(-n // lanes)


def _lehmer(d0, n):
    """d_1 … d_n of d_{i+1} = 16807·d_i mod (2³¹−1) from 0 ≤ d0 < 2³¹−1,
    as int64."""
    lanes, steps = _lanes(n)
    jump = pow(_IA, steps, _IM)
    starts = np.empty(lanes, np.int64)
    d = int(d0)
    for j in range(lanes):
        starts[j] = d
        d = d * jump % _IM
    out = np.empty((steps, lanes), np.int64)
    cur = starts
    for i in range(steps):
        cur = cur * _IA % _IM
        out[i] = cur
    return out.T.reshape(-1)[:n]


def _xorshift(x):
    """One xorshift (13, 17, 5) step of a 32-bit state."""
    x ^= (x << 13) & _M32
    x ^= x >> 17
    x ^= (x << 5) & _M32
    return x


def _apply(cols, x):
    """The GF(2) matrix with columns ``cols`` applied to the bits of x."""
    y = 0
    k = 0
    while x:
        if x & 1:
            y ^= cols[k]
        x >>= 1
        k += 1
    return y


_XS_POW = {}


def _xorshift_power(steps):
    """The columns of the xorshift's matrix to the power ``steps``."""
    if steps not in _XS_POW:
        base = [_xorshift(1 << k) for k in range(32)]
        acc = [1 << k for k in range(32)]
        e = steps
        while e:
            if e & 1:
                acc = [_apply(base, c) for c in acc]
            base = [_apply(base, c) for c in base]
            e >>= 1
        _XS_POW[steps] = acc
    return _XS_POW[steps]


def _xorshifts(x0, n):
    """x_1 … x_n of the xorshift from x0, as uint32."""
    lanes, steps = _lanes(n)
    jump = _xorshift_power(steps)
    starts = np.empty(lanes, np.uint32)
    x = int(x0)
    for j in range(lanes):
        starts[j] = x
        x = _apply(jump, x)
    out = np.empty((steps, lanes), np.uint32)
    cur = starts
    for i in range(steps):
        cur = cur ^ (cur << np.uint32(13))
        cur = cur ^ (cur >> np.uint32(17))
        cur = cur ^ (cur << np.uint32(5))
        out[i] = cur
    return out.T.reshape(-1)[:n]


class MarsRan:
    """``mars_ran`` (random_gen='nr_f90', src/general.f90:625-676).

    State: rstate(1) Marsaglia xorshift (13, -17, 5), rstate(2)
    Park–Miller/Schrage.  ``seed_put`` replicates
    ``random_seed_wrapper(PUT=seed)``: put(2)==0 re-initializes via
    mars_ran(init=put(1)) (which consumes one draw), otherwise the state is
    restored verbatim.
    """

    def __init__(self, init: int = 1812):
        self._am = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0))
                              / np.float32(_IM))
        self.s1 = 0
        self.s2 = 0
        self._reinit(init)

    def _reinit(self, init1: int):
        self.s1 = (777755555 ^ abs(init1)) & _M32
        self.s2 = ((888889999 ^ abs(init1)) | 1) & _M32
        # Fortran: the initializing call falls through and returns a draw.

    def seed_put(self, seed):
        """random_seed_wrapper(PUT=...) semantics for nr_f90."""
        seed = list(seed)
        if len(seed) < 2 or seed[1] == 0:
            self._reinit(int(seed[0]))
            self.next()          # the init call consumes one draw
        else:
            self.s1 = int(seed[0]) & _M32
            self.s2 = int(seed[1]) & _M32

    def seed_get(self):
        return [_s32(self.s1), _s32(self.s2)]

    def next(self) -> np.float32:
        s1 = _xorshift(self.s1)
        self.s1 = s1
        s2 = _schrage(_s32(self.s2))
        self.s2 = s2 & _M32
        mixed = (_IM & (s1 ^ (s2 & _M32))) | 1
        return np.float32(self._am * np.float32(mixed))

    def draw(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        i = 0
        if n and not 0 <= _s32(self.s2) < _IM:
            out[0] = self.next()     # Schrage off its Lehmer range
            i = 1
        while i < n:
            k = min(_BLOCK, n - i)
            x = _xorshifts(self.s1, k)
            d = _lehmer(self.s2, k)
            mixed = (np.int64(_IM) & (x.astype(np.int64) ^ d)) | 1
            out[i:i + k] = self._am * mixed.astype(np.float32)
            self.s1 = int(x[-1])
            self.s2 = int(d[-1])
            i += k
        return out


class Ran0:
    """``ran0`` (random_gen='min_std', src/general.f90:601-623)."""

    _MASK = 123459876

    def __init__(self, seed: int = 1812):
        self.s = int(seed) & _M32

    def next(self) -> np.float32:
        d = _schrage(_s32(self.s ^ self._MASK))
        out = np.float32(np.float32(1.0 / _IM) * np.float32(d))
        self.s = (d ^ self._MASK) & _M32
        return out

    def draw(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        i = 0
        if n and not 0 <= _s32(self.s ^ self._MASK) < _IM:
            out[0] = self.next()     # Schrage off its Lehmer range
            i = 1
        scale = np.float32(1.0 / _IM)
        while i < n:
            k = min(_BLOCK, n - i)
            d = _lehmer(_s32(self.s ^ self._MASK), k)
            out[i:i + k] = scale * d.astype(np.float32)
            self.s = (int(d[-1]) ^ self._MASK) & _M32
            i += k
        return out


# ---------------------------------------------------------------------------
# Draw-order replications of reference consumers
# ---------------------------------------------------------------------------

def start_seed(seed0: int = 1812, iproc: int = 0) -> MarsRan:
    """State after start.x's seed PUT (src/start.f90:383-384):
    seed(1) = -((seed0-1812+1)*10 + iproc), seed(2:) = 0 → re-init + one
    consumed draw."""
    rng = MarsRan()
    rng.seed_put([-((seed0 - 1812 + 1) * 10 + iproc), 0])
    return rng


def gaunoise_vect(rng, ampl: float, mx: int, my: int, mz: int,
                  ncomp: int) -> np.ndarray:
    """Reference gaunoise_vect (src/initcond.f90:4351-4389): per (n, m)
    plane-line and component, Gaussian noise over the full ghosted x-line;
    even components draw fresh (r, p) and use sin, odd components reuse the
    previous (r, p) with cos.  Returns (ncomp, mx, my, mz) float32 (the
    *added* noise; caller adds to f).

    The stream of a block of z planes is drawn in one call, in the
    reference's (n, m, component pair, r/p, x) order, and the Box-Muller
    transform runs on contiguous copies of its r and p halves."""
    out = np.empty((ncomp, mx, my, mz), np.float32)
    two_pi = np.float32(2.0) * np.float32(np.pi)
    a = np.float32(ampl)
    npair = (ncomp + 1) // 2
    per_plane = my * npair * 2 * mx
    nb = max(1, _BLOCK // per_plane)
    for n0 in range(0, mz, nb):
        n1 = min(mz, n0 + nb)
        s = rng.draw((n1 - n0) * per_plane).reshape(n1 - n0, my, npair, 2,
                                                    mx)
        for q in range(npair):
            r = np.ascontiguousarray(s[:, :, q, 0, :])
            p = np.ascontiguousarray(s[:, :, q, 1, :])
            rad = np.sqrt(np.float32(-2.0) * np.log(r))
            ang = two_pi * p
            for i, fn in ((2 * q, np.sin), (2 * q + 1, np.cos)):
                if i < ncomp:
                    tmp = rad * fn(ang)
                    out[i, :, :, n0:n1] = (a * tmp).transpose(2, 1, 0)
    return out


def forcing_hel_sequence(rng, nsteps: int, kkx, kky, kkz):
    """Per-step helical-forcing draws (src/forcing.f90 fconst_coefs_hel
    :1578-1700, default flags: no lavoid_*, old_forcing_evector=F):
    fran(2) → phase = π(2·fran1 − 1), ik = int(nk·0.9999·fran2) + 1;
    then phi → rotation of the polarization vector.

    Returns (kk[nsteps, 3], phase[nsteps], phi[nsteps]) float32/float64.
    """
    nk = len(kkx)
    kk = np.empty((nsteps, 3), np.float64)
    phase = np.empty(nsteps, np.float64)
    phi = np.empty(nsteps, np.float64)
    pi32 = np.float32(np.pi)
    for i in range(nsteps):
        f1 = rng.next()
        f2 = rng.next()
        # all arithmetic in f32, as in a single-precision reference build
        phase[i] = pi32 * (np.float32(2.0) * f1 - np.float32(1.0))
        ik = int(np.float32(nk) * (np.float32(0.9999) * f2)) + 1  # 1-based
        kk[i] = (kkx[ik - 1], kky[ik - 1], kkz[ik - 1])
        phi[i] = rng.next() * np.float32(2.0) * pi32
    return kk, phase, phi


def read_k_dat(path):
    """Read the reference's k.dat wavevector-shell file (first line:
    nk, kav; then kkx, kky, kkz lists)."""
    with open(path) as fh:
        tok = fh.read().split()
    nk = int(tok[0])
    kav = float(tok[1])
    vals = [float(t) for t in tok[2:2 + 3 * nk]]
    kkx = np.asarray(vals[:nk])
    kky = np.asarray(vals[nk:2 * nk])
    kkz = np.asarray(vals[2 * nk:3 * nk])
    return nk, kav, kkx, kky, kkz


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 256
    m = n + 6
    for label, rng in (("MarsRan", start_seed(1812)),
                       ("Ran0", Ran0(-10))):
        t0 = time.perf_counter()
        f = gaunoise_vect(rng, 1e-3, m, m, m, 3)
        sec = time.perf_counter() - t0
        print(f"gaunoise_vect {label}, 3 components, {m}^3 ghosted "
              f"({4 * m ** 3} draws): {sec:.2f} s, max |f| "
              f"{float(np.abs(f).max()):.6e}", flush=True)


if __name__ == "__main__":
    main()
