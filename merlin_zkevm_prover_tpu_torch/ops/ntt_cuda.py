"""Goldilocks NTT on the GPU: one CUDA block kernel and the pipeline around it.

Counterpart of the reference's ``ops/ntt_tpu.py``.  One CUDA kernel
(``csrc/ntt_gl.cu``) serves two wrappers and three TPU kernels, each wrapper
with its plain PyTorch twin of the same signature, each TPU kernel with its
own launch counter:

``ntt_block``  replaces ``_ntt_kernel_v3`` (``_ntt_call_v2``): a length
    L <= 512 transform along axis 0 of an (L, B) matrix, decimation in
    frequency (natural in, bit-reversed out) or in time (bit-reversed in,
    natural out), with the fused epilogues of the reference: ``zero_top``
    (only the lower L/2 input rows exist; the upper half is the LDE's zero
    padding), a separable scale ``u[row] * v[col]`` and a constant scale.
``ntt_block`` at L < 16  replaces ``_ntt_kernel_v2`` (same call, which the
    reference takes below length 16): the same contract, which the same
    kernel computes at every length from 2 up.  On the reference's paths
    these lengths are kernel A of the pipeline at n_bits 10 to 12 (DIF,
    unscaled, ``zero_top`` on the forward LDE).  Its launches are counted
    apart, under ``ntt_block_short``.
``ntt_short``  replaces ``_ntt_kernel`` (``_ntt_call``, ``_ntt_leading``):
    the unscaled decimation-in-time transform of a bit-reversed block, no
    epilogue.  FRI's fold INTT over (4, pol2N * 3) comes through here, and
    every transform outside the pipeline's sizes.

What bounds the kernel on this card: a length-L transform does
(L/2) log2 L butterflies of one 64-bit field multiply each per column and
moves 16 bytes per element, so at L = 512 it is a few multiplies per byte
and the integer multiply rate bounds it; short lengths (FRI's L = 4) are
bound by memory.  The design keeps a tile of L x (4096 / L) words in
shared memory, so every element crosses device memory once in and once out
whatever the number of stages, and columns are the fast axis of the tile,
so global loads and stores are coalesced.

Larger transforms factor as N = n1 * n2 with n2 = 2^min(9, nbits - 1), as
in the reference, so that its host tables carry across one to one:
kernel A (DIF over i1) -> ``_mid_gather`` (transpose, undo the bit
reversal of k1, bit-reverse i2, multiply by w_N^(k1 * rev(i2)); plain
tensor code here as it is XLA there) -> kernel B (DIT over i2 with the
epilogue).  Sizes outside ``PIPELINE_MIN_BITS..PIPELINE_MAX_BITS`` take the
four-step recursion over ``ntt_short``.

On a CPU tensor the wrappers run their plain versions, and only then; on a
CUDA tensor they launch the kernel or raise.  Everything else in this
module is the same code on both devices.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import cuda_build
from . import goldilocks as gl
from .goldilocks import GL, P, SHIFT

MAX_KERNEL_BITS = 9    # block length cap, kept so the reference's tables carry across
PIPELINE_MIN_BITS = 10
PIPELINE_MAX_BITS = 2 * MAX_KERNEL_BITS

SHORT_BLOCK_BITS = 3   # ntt_block at L <= 8 stands for the reference's v2 body

LAUNCHES = {"ntt_block": 0, "ntt_block_short": 0, "ntt_short": 0}


# ---------------------------------------------------------------------------
# Host tables (cached per size) and their device copies (cached per device)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bitrev(nbits: int) -> np.ndarray:
    n = 1 << nbits
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(nbits):
        rev |= ((idx >> b) & 1).astype(np.uint32) << (nbits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _stage_tables_np(nbits: int, inverse: bool) -> np.ndarray:
    """Concatenated per-stage twiddles, (2^nbits - 1,) uint64: the stage
    with half-size m = 2^(s-1) occupies [m-1, 2m-1) and holds w_{2m}^t."""
    n = 1 << nbits
    root = gl.w(nbits) if not inverse else gl.w_inv(nbits)
    full = gl.powers_np(root, n // 2 if n > 1 else 1)
    out = np.empty(max(n - 1, 1), dtype=np.uint64)
    out[0] = 1
    for s in range(1, nbits + 1):
        m = 1 << (s - 1)
        stride = n >> s
        out[m - 1: 2 * m - 1] = full[::stride][:m]
    return out


@functools.lru_cache(maxsize=None)
def _fourstep_twiddle_np(n1_bits: int, n2_bits: int, inverse: bool):
    """T[k1, i2] = w_N^(+-k1 * i2), (N1, N2) uint64."""
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    nbits = n1_bits + n2_bits
    w_n = gl.w(nbits) if not inverse else gl.w_inv(nbits)
    col = gl.powers_np(w_n, n1)  # w^k1
    t = np.empty((n1, n2), dtype=np.uint64)
    for k1 in range(n1):
        t[k1] = gl.powers_np(int(col[k1]), n2)
    return t


@functools.lru_cache(maxsize=None)
def _gather_twiddle_np(n1_bits: int, n2_bits: int, inverse: bool):
    """(N2, N1) table T[s, k1] = w_N^(k1 * rev2(s)): the four-step twiddle
    in the mid-gather's output layout."""
    t = _fourstep_twiddle_np(n1_bits, n2_bits, inverse)  # [k1, i2]
    return np.ascontiguousarray(t[:, _bitrev(n2_bits)].T)


@functools.lru_cache(maxsize=None)
def _sep_scale_np(nbits: int, n1_bits: int, base: int, with_ninv: bool):
    """u[k2], v[k1] with u[k2] * v[k1] = (1/N?) * base^(k2*n1 + k1)."""
    n1 = 1 << n1_bits
    n2 = 1 << (nbits - n1_bits)
    u = gl.powers_np(pow(base, n1, P), n2)
    if with_ninv:
        ninv = pow(1 << nbits, P - 2, P)
        u = (u.astype(object) * ninv % P).astype(np.uint64)
    v = gl.powers_np(base, n1)
    return u, v


@functools.lru_cache(maxsize=None)
def _mid_gather_idx_np(n1_bits: int, n2_bits: int) -> np.ndarray:
    """Flat (n2*n1,) row indices realising transpose + rev1-unreversal +
    rev2-reversal as ONE gather: out flat row s*n1 + k1 reads input flat
    row rev1(k1)*n2 + rev2(s)."""
    rev1 = _bitrev(n1_bits).astype(np.int64)
    rev2 = _bitrev(n2_bits).astype(np.int64)
    return (rev2[:, None] + (rev1[None, :] << n2_bits)).reshape(-1)


@functools.lru_cache(maxsize=None)
def _scale_shift_np(nbits: int, shift: int, with_ninv: bool):
    """(1/N?) * shift^i, length 2^nbits."""
    n = 1 << nbits
    v = gl.powers_np(shift, n)
    if with_ninv:
        ninv = pow(n, P - 2, P)
        v = (v.astype(object) * ninv % P).astype(np.uint64)
    return v


_DEV_TABLES = {}


def _dev(device, fn, *args, pick: Optional[int] = None) -> torch.Tensor:
    """Device copy of a cached host table (uint64 -> carrier, ints as is)."""
    key = (str(device), fn.__name__, args, pick)
    t = _DEV_TABLES.get(key)
    if t is None:
        arr = fn(*args)
        if pick is not None:
            arr = arr[pick]
        if arr.dtype == np.uint64:
            t = gl.from_u64(arr, device)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.int64))).to(device)
        _DEV_TABLES[key] = t
    return t


# ---------------------------------------------------------------------------
# The block transform: plain version, kernel launch, and the two wrappers
# ---------------------------------------------------------------------------


def _check_block(x: GL, tw: GL, log_l: int, zero_top: bool, u, v) -> int:
    if x.dtype != torch.int64 or x.ndim != 2:
        raise TypeError("ntt block: expected a 2-D int64 carrier")
    l = 1 << log_l
    if not 1 <= log_l <= MAX_KERNEL_BITS:
        raise ValueError(f"ntt block: length 2^{log_l} out of range")
    in_l = l // 2 if zero_top else l
    if x.shape[0] != in_l:
        raise ValueError(f"ntt block: expected {in_l} rows, got {x.shape[0]}")
    if tw.shape != (max(l - 1, 1),) or tw.device != x.device:
        raise ValueError("ntt block: bad twiddle table")
    if u is not None and (u.shape != (l,) or u.device != x.device):
        raise ValueError("ntt block: bad row scale")
    if v is not None and (v.shape != (x.shape[1],) or v.device != x.device):
        raise ValueError("ntt block: bad column scale")
    return l


def ntt_block_plain(x: GL, tw: GL, log_l: int, dif: bool,
                    zero_top: bool = False, u: Optional[GL] = None,
                    v: Optional[GL] = None,
                    const_scale: Optional[int] = None) -> GL:
    """Plain PyTorch block transform, same contract as :func:`ntt_block`."""
    l = _check_block(x, tw, log_l, zero_top, u, v)
    b = x.shape[1]
    x = gl.canon(x)
    if zero_top:
        x = torch.cat([x, torch.zeros_like(x)], dim=0)
    halves = [1 << s for s in range(log_l)]
    for m in (reversed(halves) if dif else halves):
        xr = x.reshape(l // (2 * m), 2, m, b)
        p, q = xr[:, 0], xr[:, 1]
        t = tw[m - 1: 2 * m - 1].reshape(1, m, 1)
        if dif:
            hi_ = gl.add(p, q)
            lo_ = gl.sub(p, q)
            if m > 1:
                lo_ = gl.mul(lo_, t)
        else:
            if m > 1:
                q = gl.mul(q, t)
            hi_ = gl.add(p, q)
            lo_ = gl.sub(p, q)
        x = torch.stack([hi_, lo_], dim=1).reshape(l, b)
    if u is not None:
        x = gl.mul(x, u[:, None])
    if v is not None:
        x = gl.mul(x, v[None, :])
    if const_scale is not None:
        x = gl.mul(x, const_scale)
    return x


def _launch_block(x: GL, tw: GL, log_l: int, dif: bool, zero_top: bool,
                  u: Optional[GL], v: Optional[GL],
                  const_scale: Optional[int]):
    """Launch the block kernel; returns (output, cudaGetLastError())."""
    l = _check_block(x, tw, log_l, zero_top, u, v)
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt block: unsupported device {x.device}")
    x = x.contiguous()
    tw = tw.contiguous()
    u = None if u is None else u.contiguous()
    v = None if v is None else v.contiguous()
    b = x.shape[1]
    out = torch.empty((l, b), dtype=torch.int64, device=x.device)
    lib = cuda_build.lib()
    with torch.cuda.device(x.device):
        code = lib.merlin_ntt_block(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(),
            None if u is None else u.data_ptr(),
            None if v is None else v.data_ptr(),
            0 if const_scale is None else int(const_scale) % P,
            0 if const_scale is None else 1,
            log_l, b, 1 if dif else 0, 1 if zero_top else 0,
            cuda_build.stream_ptr())
    return out, code


def ntt_block(x: GL, tw: GL, log_l: int, dif: bool, zero_top: bool = False,
              u: Optional[GL] = None, v: Optional[GL] = None,
              const_scale: Optional[int] = None) -> GL:
    """Length-2^log_l transform along axis 0 of (L or L/2, B) -> (L, B).

    `tw` is the stage table of `_stage_tables_np` for this length and
    direction.  Output canonical."""
    if x.device.type == "cpu":
        return ntt_block_plain(x, tw, log_l, dif, zero_top, u, v, const_scale)
    if x.shape[1] == 0:
        return x.new_zeros((1 << log_l, 0))
    out, code = _launch_block(x, tw, log_l, dif, zero_top, u, v, const_scale)
    LAUNCHES["ntt_block_short" if log_l <= SHORT_BLOCK_BITS else "ntt_block"] += 1
    cuda_build.check(code, "ntt_block launch")
    return out


def ntt_short_plain(x: GL, tw: GL, log_l: int) -> GL:
    """Plain PyTorch unscaled DIT transform of a bit-reversed (L, B) block."""
    return ntt_block_plain(x, tw, log_l, dif=False)


def ntt_short(x: GL, tw: GL, log_l: int) -> GL:
    """Unscaled DIT transform of a bit-reversed (L, B) block, L <= 512."""
    if x.device.type == "cpu":
        return ntt_short_plain(x, tw, log_l)
    if x.shape[1] == 0:
        return x.new_zeros((1 << log_l, 0))
    out, code = _launch_block(x, tw, log_l, False, False, None, None, None)
    LAUNCHES["ntt_short"] += 1
    cuda_build.check(code, "ntt_short launch")
    return out


# ---------------------------------------------------------------------------
# Four-step recursion over the short kernel
# ---------------------------------------------------------------------------


def _split(nbits: int):
    n2_bits = min(MAX_KERNEL_BITS, nbits - 1)
    return nbits - n2_bits, n2_bits


def _ntt_leading(x: GL, nbits: int, inverse: bool) -> GL:
    """Unscaled NTT over axis 0 of (L, B), L = 2^nbits <= 512, natural
    order in and out: one row gather, then the short kernel."""
    if nbits == 0:
        return x
    perm = _dev(x.device, _bitrev, nbits)
    tw = _dev(x.device, _stage_tables_np, nbits, inverse)
    return ntt_short(x.index_select(0, perm), tw, nbits)


def _ntt_rec(a2: GL, nbits: int, inverse: bool) -> GL:
    """Unscaled NTT over axis 0 of a 2-D (N, B) array; recursive four-step
    above the block length."""
    if nbits <= MAX_KERNEL_BITS:
        return _ntt_leading(a2, nbits, inverse)
    n, c = a2.shape
    n1_bits, n2_bits = _split(nbits)
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    # step A: column NTTs over i1
    y = _ntt_rec(a2.reshape(n1, n2 * c), n1_bits, inverse)
    # step B: twiddle w_N^(k1*i2)
    t = _dev(a2.device, _fourstep_twiddle_np, n1_bits, n2_bits, inverse)
    y = gl.mul(y.reshape(n1, n2, c), t[:, :, None])
    # step C: row NTTs over i2 (transpose so i2 leads)
    z = y.permute(1, 0, 2).reshape(n2, n1 * c)
    z = _ntt_rec(z, n2_bits, inverse)
    # output index k = k2*n1 + k1
    return z.reshape(n, c)


# ---------------------------------------------------------------------------
# The DIF -> gather -> DIT pipeline
# ---------------------------------------------------------------------------


def pipeline_ok(nbits: int) -> bool:
    return PIPELINE_MIN_BITS <= nbits <= PIPELINE_MAX_BITS


def _mid_gather(y: GL, n1_bits: int, n2_bits: int, c: int, inverse: bool) -> GL:
    """Fused transpose + k1 un-reversal + i2 bit-reversal + four-step
    twiddle between the DIF and DIT kernels:
    z[s, k1, c] = y[rev1(k1), rev2(s), c] * w_N^(k1 * rev2(s))."""
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    idx = _dev(y.device, _mid_gather_idx_np, n1_bits, n2_bits)
    z = y.reshape(n1 * n2, c).index_select(0, idx).reshape(n2, n1, c)
    t = _dev(y.device, _gather_twiddle_np, n1_bits, n2_bits, inverse)
    return gl.mul(z, t[:, :, None]).reshape(n2, n1 * c)


def _ntt_v2(a2: GL, nbits: int, inverse: bool, *,
            sep_scale_base: Optional[int] = None, with_ninv: bool = False,
            const_scale: Optional[int] = None, zero_top: bool = False) -> GL:
    """Length-2^nbits transform over axis 0 of (N, C) (or (N/2, C) input
    when zero_top) via the 3-pass DIF/DIT pipeline."""
    n = 1 << nbits
    c = a2.shape[1]
    n1_bits, n2_bits = _split(nbits)
    assert n1_bits <= MAX_KERNEL_BITS
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    dev = a2.device

    # kernel A: DIF over i1
    in_rows = n1 // 2 if zero_top else n1
    y = ntt_block(a2.reshape(in_rows, n2 * c),
                  _dev(dev, _stage_tables_np, n1_bits, inverse),
                  n1_bits, dif=True, zero_top=zero_top)
    # mid gather (transpose + un-rev + rev + four-step twiddle)
    z = _mid_gather(y, n1_bits, n2_bits, c, inverse)
    # kernel B: DIT over i2, fused scales
    u = v = None
    if sep_scale_base is not None:
        key = (nbits, n1_bits, sep_scale_base, with_ninv)
        u = _dev(dev, _sep_scale_np, *key, pick=0)
        v = _dev(dev, _sep_scale_np, *key, pick=1).repeat_interleave(c)
    out = ntt_block(z, _dev(dev, _stage_tables_np, n2_bits, inverse),
                    n2_bits, dif=False, u=u, v=v, const_scale=const_scale)
    return out.reshape(n, c)


def ntt_device(a2: GL, inverse: bool = False,
               scale: Optional[int] = None) -> GL:
    """NTT/INTT over axis 0 of an (N, C) array, natural order in and out.

    `scale`: per-element constant folded into the output; defaults to 1/N
    when inverse."""
    n = a2.shape[0]
    nbits = int(n).bit_length() - 1
    assert (1 << nbits) == n, "NTT size must be a power of two"
    if scale is None and inverse:
        scale = pow(n, P - 2, P)
    if pipeline_ok(nbits):
        cs = None if (scale is None or scale == 1) else int(scale)
        return _ntt_v2(a2, nbits, inverse, const_scale=cs)
    out = _ntt_rec(a2, nbits, inverse)
    if scale is not None and scale != 1:
        out = gl.mul(out, scale)
    return out


def extend_pol_device(a2: GL, n_bits: int, n_bits_ext: int,
                      shift: int = SHIFT) -> GL:
    """Coset LDE of an (N, C) array onto the shifted 2^n_bits_ext domain."""
    n, c = a2.shape
    assert n == 1 << n_bits
    n_ext = 1 << n_bits_ext
    if (n_bits_ext == n_bits + 1 and pipeline_ok(n_bits)
            and pipeline_ok(n_bits_ext)):
        # INTT with the (1/N) * shift^k scale fused into kernel B, then the
        # forward NTT at 2N: the padded input's (n1, n2*c) view is zero for
        # i1 >= n1/2, so the coefficients go in as they are with zero_top
        coeffs = _ntt_v2(a2, n_bits, True, sep_scale_base=shift,
                         with_ninv=True)
        return _ntt_v2(coeffs, n_bits_ext, False, zero_top=True)
    coeffs = ntt_device(a2, inverse=True, scale=1)
    sv = _dev(a2.device, _scale_shift_np, n_bits, shift, True)
    coeffs = gl.mul(coeffs, sv[:, None])
    padded = torch.cat([coeffs, coeffs.new_zeros((n_ext - n, c))], dim=0)
    return ntt_device(padded, inverse=False)
