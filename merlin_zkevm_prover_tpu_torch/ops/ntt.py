"""Number-theoretic transform over Goldilocks.

Reimplements the capability of the reference prover's `NTT_Goldilocks`:

  * ``ntt(a)``        — forward NTT, natural order in / natural order out
  * ``intt(a)``       — inverse NTT (includes the 1/N scale)
  * ``extend_pol(a)`` — low-degree extension: INTT -> coset-scale by
                        ``shift^i`` -> zero-pad -> NTT on the 2^n_bits_ext
                        domain.  Mirrors ``NTT_Goldilocks::extendPol``.

All transform axis 0 of an (N,), (N, C) or (N, ...) carrier tensor.

The public functions go through :mod:`.ntt_cuda` at every size: block
kernels on the GPU, their plain versions on the CPU, the same routing on
both.  The ``*_plain`` functions are a whole-length radix-2
decimation-in-time transform in plain tensor code (bit-reversal gather,
then log2 N butterfly stages); beyond the field ops and the bit-reversal table they share nothing with
the kernel pipeline and are its oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import ntt_cuda
from .goldilocks import GL, P, SHIFT


# ---------------------------------------------------------------------------
# Host-side tables (cached per size)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _twiddle_table(nbits: int, inverse: bool) -> np.ndarray:
    """Powers w^0 .. w^(N/2-1) of the 2^nbits-th root (or its inverse)."""
    root = gl.w(nbits) if not inverse else gl.w_inv(nbits)
    return gl.powers_np(root, max(1 << (nbits - 1), 1))


@functools.lru_cache(maxsize=None)
def _n_inv(nbits: int) -> int:
    return pow(1 << nbits, P - 2, P)


@functools.lru_cache(maxsize=None)
def _shift_powers(nbits: int, shift: int) -> np.ndarray:
    return gl.powers_np(shift, 1 << nbits)


# ---------------------------------------------------------------------------
# Plain whole-length transform
# ---------------------------------------------------------------------------


def _as_2d(a: GL):
    """View (N,) or (N, C...) as (N, C); returns (a2, restore_fn)."""
    shape = tuple(a.shape)
    n = shape[0]
    if a.ndim == 1:
        return a.reshape(n, 1), lambda x: x.reshape(x.shape[0])
    if a.ndim == 2:
        return a, lambda x: x
    return a.reshape(n, -1), lambda x: x.reshape(x.shape[0], *shape[1:])


def _nbits_of(n: int) -> int:
    nbits = int(n).bit_length() - 1
    assert (1 << nbits) == n, "NTT size must be a power of two"
    return nbits


def _ntt_2d(a: GL, nbits: int, inverse: bool) -> GL:
    """In-order radix-2 NTT over axis 0 of an (N, C) array."""
    n = 1 << nbits
    c = a.shape[1]
    if nbits == 0:
        return a
    perm = ntt_cuda._dev(a.device, ntt_cuda._bitrev, nbits)
    x = gl.canon(a).index_select(0, perm)
    table = _twiddle_table(nbits, inverse)  # np.uint64, length N/2
    for s in range(1, nbits + 1):
        m = 1 << (s - 1)  # half butterfly size
        stride = 1 << (nbits - s)
        xr = x.reshape(n // (2 * m), 2, m, c)
        u = xr[:, 0]
        v = xr[:, 1]
        if m > 1:
            tw = gl.from_u64(table[::stride][:m], a.device).reshape(1, m, 1)
            v = gl.mul(v, tw)
        x = torch.stack([gl.add(u, v), gl.sub(u, v)], dim=1).reshape(n, c)
    if inverse:
        x = gl.mul(x, _n_inv(nbits))
    return x


def ntt_plain(a: GL) -> GL:
    a2, restore = _as_2d(a)
    return restore(_ntt_2d(a2, _nbits_of(a2.shape[0]), inverse=False))


def intt_plain(a: GL) -> GL:
    a2, restore = _as_2d(a)
    return restore(_ntt_2d(a2, _nbits_of(a2.shape[0]), inverse=True))


def extend_pol_plain(a: GL, n_bits: int, n_bits_ext: int,
                     shift: int = SHIFT) -> GL:
    a2, restore = _as_2d(a)
    n, c = a2.shape
    assert n == 1 << n_bits
    coeffs = coset_scale(_ntt_2d(a2, n_bits, inverse=True), shift)
    padded = torch.cat(
        [coeffs, coeffs.new_zeros(((1 << n_bits_ext) - n, c))], dim=0)
    return restore(_ntt_2d(padded, n_bits_ext, inverse=False))


# ---------------------------------------------------------------------------
# Public API (kernels on the GPU, their plain versions on the CPU)
# ---------------------------------------------------------------------------


def ntt(a: GL) -> GL:
    """Forward NTT over axis 0 (natural order in and out)."""
    a2, restore = _as_2d(a)
    return restore(ntt_cuda.ntt_device(a2.contiguous(), inverse=False))


def intt(a: GL) -> GL:
    """Inverse NTT over axis 0, including the 1/N normalisation."""
    a2, restore = _as_2d(a)
    return restore(ntt_cuda.ntt_device(a2.contiguous(), inverse=True))


def coset_scale(coeffs: GL, shift: int = SHIFT) -> GL:
    """Multiply coefficient i by shift^i (evaluation-domain coset shift)."""
    a2, restore = _as_2d(coeffs)
    nbits = _nbits_of(a2.shape[0])
    pows = gl.from_u64(_shift_powers(nbits, shift % P), a2.device)
    return restore(gl.mul(a2, pows[:, None]))


# Memory plan for wide matrices (the zkEVM's 665-column cm1, 220-column
# const): a whole-matrix LDE holds several full-size intermediates (kernel
# A's output, the coefficients).  extend_pol_blocked runs the LDE in fixed
# 64-column blocks, so only one block's intermediates are live beside the
# output.  On the pipeline's sizes the kernels read each block's columns
# out of the input and write its result into the output in place: no
# slice is copied.
EXTEND_BLOCK_COLS = 64


def extend_pol_blocked(a: GL, n_bits: int, n_bits_ext: int,
                       shift: int = SHIFT,
                       block_cols: int = EXTEND_BLOCK_COLS) -> GL:
    """Column-blocked coset LDE: same result as extend_pol, bounded peak
    memory (one block's intermediates at a time)."""
    assert a.ndim == 2, "blocked extend expects an (N, C) matrix"
    n, c = a.shape
    assert n == 1 << n_bits
    if a.stride(1) != 1 and c > 1:
        a = a.contiguous()
    out = torch.empty((1 << n_bits_ext, c), dtype=torch.int64, device=a.device)
    for i in range(0, c, block_cols):
        ntt_cuda.extend_pol_device(a[:, i:i + block_cols], n_bits, n_bits_ext,
                                   shift, out=out[:, i:i + block_cols])
    return out


def extend_pol(a: GL, n_bits: int, n_bits_ext: int, shift: int = SHIFT) -> GL:
    """Low-degree extension onto the shifted 2^n_bits_ext domain.

    Equivalent to reference ``NTT_Goldilocks::extendPol(dst, src, NExt, N,
    ncols)``: interpolate the N evaluations, coset-shift the coefficients,
    zero-pad to NExt, and re-evaluate.
    """
    a2, restore = _as_2d(a)
    assert a2.shape[0] == 1 << n_bits
    if a2.shape[1] == 0:
        return restore(a2.new_zeros((1 << n_bits_ext, 0)))
    return restore(ntt_cuda.extend_pol_device(
        a2.contiguous(), n_bits, n_bits_ext, shift))


def eval_pol_coeffs(coeffs: GL, x) -> GL:
    """Horner evaluation of a coefficient-form polynomial at scalar x."""
    a2, _ = _as_2d(coeffs)
    out = torch.zeros((a2.shape[1],), dtype=torch.int64, device=a2.device)
    for i in range(a2.shape[0] - 1, -1, -1):
        out = gl.add(gl.mul(out, x), a2[i])
    return out
