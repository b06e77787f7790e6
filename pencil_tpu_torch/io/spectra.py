"""Shell-integrated power spectra (counterpart of
``pencil_tpu/io/spectra.py``; reference ``src/power_spectrum.f90``:
``power`` :308, ``powersnap`` driver src/run.f90:480,825; output files
``data/power_kin.dat`` etc. — one record of E(k) per dump, k-shells of unit
width in box-wavenumber units).

The transforms are ``torch.fft`` in complex64 on the field's device; the
shell sums are a ``torch.bincount`` with float32 weights (JAX's
``segment_sum``).  The
shell of each wavevector is built once per grid shape with numpy on the
host, exactly as JAX builds it (``np.rint`` of |k|, which rounds half to
even), and then kept on the device, so that both packages sum the same
wavevectors into the same shells.  The writer and reader are host code.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _kvec(n):
    """Integer wavenumbers of an axis of n points, in FFT order."""
    return np.fft.fftfreq(n) * n


@functools.lru_cache(maxsize=8)
def _shells(shape, device):
    """Flat shell index of every wavevector of a grid of ``shape``: 3-D
    shells of |k| for three axes, horizontal shells of |(k_x, k_y)| for
    two; on ``device``, with the number of bins it spans."""
    ks = [_kvec(n) for n in shape]
    if len(shape) == 3:
        kmag = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                       + ks[2][None, None, :] ** 2)
    else:
        kmag = np.sqrt(ks[0][:, None] ** 2 + ks[1][None, :] ** 2)
    shell = np.rint(kmag).astype(np.int32).ravel()
    return torch.as_tensor(shell, device=device), int(shell.max()) + 1


def _shell_sum(vals, shell, nbins, nk):
    """Sum of the rows of ``vals`` (a vector, or a matrix of one column per
    z plane) by shell, the first ``nk`` shells: the wavevectors of higher
    shells are dropped, as JAX's segment_sum drops segment ids past its
    ``num_segments``."""
    nbins = max(nbins, nk)
    if vals.ndim == 1:
        return torch.bincount(shell, weights=vals, minlength=nbins)[:nk]
    ncol = vals.shape[1]
    col = torch.arange(ncol, dtype=shell.dtype, device=shell.device)
    out = torch.bincount((shell[:, None] * ncol + col).reshape(-1),
                         weights=vals.reshape(-1), minlength=nbins * ncol)
    return out.reshape(-1, ncol)[:nk]


def shell_spectrum(field, spec=None):
    """E(k) shell-integrated over integer-k shells.

    field: (ncomp, nx, ny, nz) or (nx, ny, nz); returns (nk,) with
    nk = max(n)//2, normalised so that sum(E) is the mean energy 0.5<|f|²>
    of a vector field, but for the wavevectors past nk (Parseval)."""
    if field.ndim == 3:
        field = field[None]
    n = tuple(field.shape[1:])
    fk = torch.fft.fftn(field, dim=(-3, -2, -1)) / (n[0] * n[1] * n[2])
    pk = 0.5 * torch.sum(torch.abs(fk) ** 2, dim=0)
    shell, nbins = _shells(n, field.device)
    return _shell_sum(pk.reshape(-1), shell, nbins, max(n) // 2)


class SpectrumWriter:
    """Appends spectra in the reference format: a time line then the E(k)
    values, 8 a line (reference power_spectrum.f90 output; read by
    python/pencil/read/powers.py)."""

    def __init__(self, path):
        self.path = path

    def append(self, t, ek):
        ek = np.asarray(ek)
        with open(self.path, "a") as f:
            f.write(f"{float(t):.6e}\n")
            for i in range(0, len(ek), 8):
                f.write(" ".join(f"{v:.6e}" for v in ek[i:i + 8]) + "\n")


def read_spectrum(path):
    """Read back (times, spectra) from a power_*.dat file."""
    times, spectra, cur = [], [], []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) == 1 and (not cur or len(cur) > 0):
                if cur:
                    spectra.append(np.asarray(cur, np.float64))
                    cur = []
                times.append(float(vals[0]))
            else:
                cur.extend(float(v) for v in vals)
    if cur:
        spectra.append(np.asarray(cur, np.float64))
    return np.asarray(times), np.asarray(spectra)


def spectrum_1d(field, axis=0):
    """1-D power spectrum along one axis, averaged over the other two
    (reference ``power_1d`` :2964 — powerx/powery/powerz files):
    E(k_a) with nk = n_a//2, Parseval-normalised like shell_spectrum."""
    if field.ndim == 3:
        field = field[None]
    n = field.shape[1 + axis]
    fk = torch.fft.fft(field, dim=1 + axis) / n
    pk = 0.5 * torch.sum(torch.abs(fk) ** 2, dim=0)
    other = tuple(a for a in range(3) if a != axis)
    pk = torch.mean(pk, dim=other)
    k = np.abs(_kvec(n)).astype(np.int32)
    return _shell_sum(pk, torch.as_tensor(k, device=field.device),
                      int(k.max()) + 1, n // 2)


def spectrum_xy(field):
    """Horizontal shell spectrum per z plane (reference ``power_xy``
    :656): E(k_h, z) with k_h = |(k_x, k_y)| integer shells; (nk, nz)."""
    if field.ndim == 3:
        field = field[None]
    nx, ny, nz = field.shape[1:]
    fk = torch.fft.fft2(field, dim=(1, 2)) / (nx * ny)
    pk = 0.5 * torch.sum(torch.abs(fk) ** 2, dim=0)      # (nx, ny, nz)
    shell, nbins = _shells((nx, ny), field.device)
    return _shell_sum(pk.reshape(nx * ny, nz), shell, nbins, max(nx, ny) // 2)


def helicity_spectrum(vec, curl_vec, spec=None):
    """Shell spectra of energy and helicity (reference ``powerhel``
    :1024): for magnetic pass (aa, bb) → (E_M(k), H_M(k)) with H = shell
    Re(a·b*); for kinetic pass (oo, uu) likewise."""
    n = tuple(vec.shape[1:])
    norm = n[0] * n[1] * n[2]
    fa = torch.fft.fftn(vec, dim=(-3, -2, -1)) / norm
    fb = torch.fft.fftn(curl_vec, dim=(-3, -2, -1)) / norm
    e_dens = 0.5 * torch.sum(torch.abs(fb) ** 2, dim=0)
    h_dens = torch.sum(torch.real(fa * torch.conj(fb)), dim=0)
    shell, nbins = _shells(n, vec.device)
    nk = max(n) // 2
    return (_shell_sum(e_dens.reshape(-1), shell, nbins, nk),
            _shell_sum(h_dens.reshape(-1), shell, nbins, nk))
