"""Radix-2 FFT over the BN254 scalar field Fr (reference src/ffiasm/fft.c.hpp):
kernel B2 and its plain twin.

Counterpart of the reference's ``snark/fft.py``: the same in-order DIT
transform (a bit-reversal gather, then log2 n stages, twiddles root^k from
a table of n / 2 powers), natural order in and out, the inverse scaled by
1/n.  On a CUDA tensor the stages run in ``csrc/bn254_ntt.cu`` in passes
of up to ``NTT_TILE_BITS`` stages (``ntt_passes``: one launch a pass, each
pass's tiles in shared memory, the bit reversal in the first pass's loads
and 1/n in the inverse's last stores; the tables by the ``powers``
kernel); on the CPU ``_ntt_plain`` runs the reference's stages in the
plain arithmetic.  Used by the Groth16 prover's 3x (iFFT -> coset shift ->
FFT) pipeline (reference src/rapidsnark/groth16.c.hpp:49-204).  Elements
are Montgomery (n, 4) tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import bn254_cuda
from ..ops import bn254_field as bf
from ..ops import cuda_build
from ..ops.bn254_field import FR

# Fr multiplicative generator and 2-adicity (r - 1 = 2^28 * odd)
FR_GENERATOR = 5
FR_TWO_ADICITY = 28

# stages a pass: a tile of 2^NTT_TILE_BITS elements (32 KB) in shared
# memory (tools/bn254_times.py --ntt-tiles: 10 the fastest of 9 to 12; at
# most 12)
NTT_TILE_BITS = 10

LAUNCHES = {"pass": 0}
SHAPES: dict = {}   # launches by shape: (n, inverse)

_vp = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def w_fr(nbits: int) -> int:
    assert nbits <= FR_TWO_ADICITY
    return pow(FR_GENERATOR, (FR.mod - 1) >> nbits, FR.mod)


def _root(nbits: int, inverse: bool) -> int:
    root = w_fr(nbits)
    return pow(root, FR.mod - 2, FR.mod) if inverse else root


_TW_CACHE: dict = {}


def _twiddles(nbits: int, inverse: bool, device) -> torch.Tensor:
    """root^k for k < max(n / 2, 1), Montgomery (n / 2, 4), cached."""
    key = (nbits, inverse, str(device))
    if key not in _TW_CACHE:
        _TW_CACHE[key] = bn254_cuda.powers(
            _root(nbits, inverse), max(1 << (nbits - 1), 1), device=device)
    return _TW_CACHE[key]


def _nbits(a: torch.Tensor) -> int:
    n = a.shape[0]
    nbits = n.bit_length() - 1
    if a.ndim != 2 or a.shape[1] != bf.N_LIMBS or 1 << nbits != n:
        raise ValueError(f"fft: expected (2^k, 4) limbs, got {tuple(a.shape)}")
    return nbits


def _bitrev(nbits: int, device) -> torch.Tensor:
    idx = torch.arange(1 << nbits, device=device)
    rev = torch.zeros_like(idx)
    for b in range(nbits):
        rev |= ((idx >> b) & 1) << (nbits - 1 - b)
    return rev


def ntt_passes(nbits: int, k: int = None):
    """The passes of an NTT of 2^nbits elements, (s0, kp, cb) each: stages
    s0 + 1 .. s0 + kp on tiles of 2^(kp + cb) elements, cb of the index
    bits below s0 in a tile; ceil(nbits / k) passes of as even a size as
    can be, the larger first; a tile of 2^k elements where the bits below
    s0 allow."""
    k = k or NTT_TILE_BITS
    if nbits < 1:
        return []
    count = -(-nbits // k)
    out, s0 = [], 0
    for p in range(count):
        kp = nbits // count + (p < nbits % count)
        out.append((s0, kp, min(k - kp, s0)))
        s0 += kp
    return out


def _ntt_plain(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The reference's `_fft_core` in the plain arithmetic."""
    nbits = _nbits(a)
    n = 1 << nbits
    if nbits == 0:
        return a.clone()
    x = bf.to16(a[_bitrev(nbits, a.device)])
    table = bf.to16(_twiddles(nbits, inverse, a.device))
    for s in range(1, nbits + 1):
        m = 1 << (s - 1)
        tw = table[::1 << (nbits - s)][:m]
        xr = x.reshape(n // (2 * m), 2, m, bf.N16)
        u = xr[:, 0]
        v = bf.mul16(FR, xr[:, 1], tw)
        x = torch.stack([bf.add16(FR, u, v), bf.sub16(FR, u, v)],
                        dim=1).reshape(n, bf.N16)
    if inverse:
        x = bf.mul16(FR, x, bf.const16(FR, pow(n, FR.mod - 2, FR.mod),
                                       a.device))
    return bf.from16(x)


def _ntt(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    if not a.is_cuda:
        return _ntt_plain(a, inverse)
    nbits = _nbits(a)
    n = 1 << nbits
    if nbits == 0:
        return a.clone()
    a = a.contiguous()
    x = torch.empty_like(a)
    lib = cuda_build.lib()
    stream = _vp(cuda_build.stream_ptr())
    tw = _twiddles(nbits, inverse, a.device)
    scale = bf.const(FR, pow(n, FR.mod - 2, FR.mod), a.device) \
        if inverse else None
    passes = ntt_passes(nbits)
    for p, (s0, kp, cb) in enumerate(passes):
        last = p == len(passes) - 1
        cuda_build.check(lib.merlin_bn_fr_ntt_pass(
            _vp((a if p == 0 else x).data_ptr()), _vp(x.data_ptr()), nbits,
            s0, kp, cb, _vp(tw.data_ptr()),
            _vp(scale.data_ptr() if last and inverse else None), stream),
            "bn254 ntt pass")
        cuda_build.count(LAUNCHES, SHAPES, "pass", (n, inverse))
    return x


def fft(a: torch.Tensor) -> torch.Tensor:
    return _ntt(a, inverse=False)


def ifft(a: torch.Tensor) -> torch.Tensor:
    return _ntt(a, inverse=True)


def coset_scale(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """coeff[i] *= shift^i."""
    pows = bn254_cuda.powers(shift, coeffs.shape[0], device=coeffs.device)
    return bn254_cuda.mont_mul(FR, coeffs, pows)
