"""Goldilocks NTT on the GPU: the block kernels and the pipeline around them.

Counterpart of the reference's ``ops/ntt_tpu.py``.  One CUDA source
(``csrc/ntt_gl.cu``) serves four wrappers and three TPU kernels, each
wrapper with its plain PyTorch twin of the same signature, each TPU kernel
with its own launch counter:

``ntt_block``  replaces ``_ntt_kernel_v3`` (``_ntt_call_v2``): a length
    L <= 512 transform along axis 0 of an (L, B) matrix, decimation in
    frequency (natural in, bit-reversed out) or in time (bit-reversed in,
    natural out), with the fused epilogues of the reference: ``zero_top``
    (only the lower L/2 input rows exist; the upper half is the LDE's zero
    padding), a separable scale ``u[row] * v[col]`` and a constant scale.
``ntt_block_cols`` / ``ntt_block_gather``  kernels A and B of the pipeline,
    the same transform with the pipeline's layouts: kernel A reads its
    (n1, n2 * c) block straight out of an (N, c) matrix that may be a column
    slice of a wider one; kernel B reads kernel A's output through the mid
    gather (transpose, both bit reversals and the four-step twiddle, in its
    load) and may write into a column slice.  Their launches count as
    ``ntt_block`` (and kernel B's also under ``SUB_LAUNCHES``).
``ntt_block`` at L < 16  replaces ``_ntt_kernel_v2`` (same call, which the
    reference takes below length 16): the same contract, which the register
    form of the kernel (one thread per column) computes at lengths 2 to 16.
    On the reference's paths these lengths are kernel A of the pipeline at
    n_bits 10 to 12 (DIF, unscaled, ``zero_top`` on the forward LDE).  Its
    launches are counted apart, under ``ntt_block_short``.
``ntt_short``  replaces ``_ntt_kernel`` (``_ntt_call``, ``_ntt_leading``):
    the unscaled decimation-in-time transform of a bit-reversed block, no
    epilogue.  FRI's fold INTT over (4, pol2N * 3) comes through here, and
    every transform outside the pipeline's sizes.

What bounds the kernels, and how they are laid out (register passes over a
shared-memory tile at L = 32 .. 512, one thread per column below): the
header of ``csrc/ntt_gl.cu``.

Larger transforms factor as N = n1 * n2 with n2 = 2^min(9, nbits - 1), as
in the reference, so that its host tables carry across one to one:
kernel A (DIF over i1) -> mid gather (transpose, undo the bit reversal of
k1, bit-reverse i2, multiply by w_N^(k1 * rev(i2))) -> kernel B (DIT over
i2 with the epilogue).  On the card the gather is kernel B's load, so one
transform is two launches and nothing between them; on the CPU it is
``_mid_gather``, plain tensor code as it is XLA in the reference.  Sizes
outside ``PIPELINE_MIN_BITS..PIPELINE_MAX_BITS`` take the four-step
recursion over ``ntt_short``.

On a CPU tensor the wrappers run their plain versions, and only then; on a
CUDA tensor they launch the kernel or raise.  Everything else in this
module is the same code on both devices.
"""

from __future__ import annotations

import ctypes
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
# kernel B launches with the mid gather in its load (also in LAUNCHES)
SUB_LAUNCHES = {"ntt_block_gather": 0}


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


class _NttArgs(ctypes.Structure):
    """``struct NttArgs`` of ``csrc/ntt_gl.cu``, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("x_rs", ctypes.c_longlong),
                ("x_ld", ctypes.c_longlong),
                ("out", ctypes.c_void_p), ("o_rs", ctypes.c_longlong),
                ("o_ld", ctypes.c_longlong),
                ("b", ctypes.c_longlong), ("c", ctypes.c_longlong),
                ("tw", ctypes.c_void_p), ("u", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("v_div", ctypes.c_longlong),
                ("gtw", ctypes.c_void_p), ("g_n1_bits", ctypes.c_longlong),
                ("cscale", ctypes.c_ulonglong),
                ("use_cscale", ctypes.c_longlong),
                ("log_l", ctypes.c_longlong), ("dif", ctypes.c_longlong),
                ("zero_top", ctypes.c_longlong)]


_TENSOR_FIELDS = ("x", "out", "tw", "u", "v", "gtw")


def _fields(x: GL, x_rs: int, x_ld: int, out: GL, o_rs: int, o_ld: int,
            b: int, c: int, tw: GL, log_l: int, dif: bool,
            zero_top: bool = False, u: Optional[GL] = None,
            v: Optional[GL] = None, v_div: int = 1,
            const_scale: Optional[int] = None, gtw: Optional[GL] = None,
            g_n1_bits: int = 0) -> dict:
    """The fields of one launch's ``NttArgs``, tensors in place of their
    pointers.  Strides are in words, from tensor views whose extents cover
    every word the kernel touches."""
    return dict(x=x, x_rs=x_rs, x_ld=x_ld, out=out, o_rs=o_rs, o_ld=o_ld,
                b=b, c=c, tw=tw, u=u, v=v, v_div=v_div, gtw=gtw,
                g_n1_bits=g_n1_bits,
                cscale=0 if const_scale is None else int(const_scale) % P,
                use_cscale=0 if const_scale is None else 1,
                log_l=log_l, dif=int(dif), zero_top=int(zero_top))


def _launch(f: dict) -> int:
    """One launch of the block kernel on the card of ``f["x"]``; returns
    cudaGetLastError()."""
    dev = f["x"].device
    for k in _TENSOR_FIELDS:
        t = f[k]
        if t is not None and (t.device != dev or t.dtype != torch.int64):
            raise ValueError("ntt block: operands on different devices or "
                             "not int64")
    if dev.type != "cuda":
        raise RuntimeError(f"ntt block: unsupported device {dev}")
    for k in ("tw", "u", "v", "gtw"):
        if f[k] is not None and not f[k].is_contiguous():
            raise ValueError("ntt block: tables must be contiguous")
    args = _NttArgs(**{k: (None if f[k] is None else f[k].data_ptr())
                       if k in _TENSOR_FIELDS else f[k] for k in f})
    with torch.cuda.device(dev):
        return cuda_build.lib().merlin_ntt_block(ctypes.addressof(args),
                                                 cuda_build.stream_ptr())


def _count(log_l: int) -> None:
    LAUNCHES["ntt_block_short" if log_l <= SHORT_BLOCK_BITS else "ntt_block"] += 1


def _rows_view(x: GL) -> GL:
    """`x` itself if its columns are unit-stride (a column slice of a
    wider matrix is), else a contiguous copy."""
    return x if x.stride(1) == 1 or x.shape[1] <= 1 else x.contiguous()


def _block_fields(x: GL, tw: GL, log_l: int, dif: bool, zero_top: bool,
                  u: Optional[GL], v: Optional[GL],
                  const_scale: Optional[int]) -> dict:
    """A plain (L or L/2, B) block into a new (L, B) output."""
    l = _check_block(x, tw, log_l, zero_top, u, v)
    x = _rows_view(x)
    tw, u, v = (None if t is None else t.contiguous() for t in (tw, u, v))
    b = x.shape[1]
    out = torch.empty((l, b), dtype=torch.int64, device=x.device)
    return _fields(x, x.stride(0), 0, out, b, 0, b, b, tw, log_l, dif,
                   zero_top, u, v, 1, const_scale)


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
    f = _block_fields(x, tw, log_l, dif, zero_top, u, v, const_scale)
    code = _launch(f)
    _count(log_l)
    cuda_build.check(code, "ntt_block launch")
    return f["out"]


def ntt_short_plain(x: GL, tw: GL, log_l: int) -> GL:
    """Plain PyTorch unscaled DIT transform of a bit-reversed (L, B) block."""
    return ntt_block_plain(x, tw, log_l, dif=False)


def ntt_short(x: GL, tw: GL, log_l: int) -> GL:
    """Unscaled DIT transform of a bit-reversed (L, B) block, L <= 512."""
    if x.device.type == "cpu":
        return ntt_short_plain(x, tw, log_l)
    if x.shape[1] == 0:
        return x.new_zeros((1 << log_l, 0))
    f = _block_fields(x, tw, log_l, False, False, None, None, None)
    code = _launch(f)
    LAUNCHES["ntt_short"] += 1
    cuda_build.check(code, "ntt_short launch")
    return f["out"]


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
    z[s, k1, c] = y[rev1(k1), rev2(s), c] * w_N^(k1 * rev2(s)).
    Plain tensor code: the CPU's route, which kernel B's load replaces on
    the card."""
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    idx = _dev(y.device, _mid_gather_idx_np, n1_bits, n2_bits)
    z = y.reshape(n1 * n2, c).index_select(0, idx).reshape(n2, n1, c)
    t = _dev(y.device, _gather_twiddle_np, n1_bits, n2_bits, inverse)
    return gl.mul(z, t[:, :, None]).reshape(n2, n1 * c)


def _check_cols(x: GL, n1_bits: int, n2_bits: int, zero_top: bool) -> int:
    if x.dtype != torch.int64 or x.ndim != 2:
        raise TypeError("ntt block: expected a 2-D int64 carrier")
    if not (1 <= n1_bits <= MAX_KERNEL_BITS and 0 <= n2_bits <= 30):
        raise ValueError("ntt block: pipeline split out of range")
    rows = (1 << n1_bits) // (2 if zero_top else 1) << n2_bits
    if x.shape[0] != rows:
        raise ValueError(f"ntt block: expected {rows} rows, got {x.shape[0]}")
    return x.shape[1]


def ntt_block_cols_plain(x: GL, n1_bits: int, n2_bits: int, inverse: bool,
                         zero_top: bool = False) -> GL:
    """Plain version of :func:`ntt_block_cols`."""
    c = _check_cols(x, n1_bits, n2_bits, zero_top)
    in_rows = (1 << n1_bits) // (2 if zero_top else 1)
    tw = _dev(x.device, _stage_tables_np, n1_bits, inverse)
    return ntt_block_plain(x.contiguous().reshape(in_rows, (c << n2_bits)),
                           tw, n1_bits, dif=True, zero_top=zero_top)


def _cols_fields(x: GL, n1_bits: int, n2_bits: int, inverse: bool,
                 zero_top: bool) -> dict:
    """Kernel A: row i1 of the (n1, n2 * c) view starts at row i1 * n2 of
    `x`, column i2 * c + cc is word cc of row i2; into a new contiguous
    (n1, n2 * c) output."""
    c = x.shape[1]
    n2 = 1 << n2_bits
    x = _rows_view(x)
    out = torch.empty((1 << n1_bits, n2 * c), dtype=torch.int64,
                      device=x.device)
    return _fields(x, n2 * x.stride(0), x.stride(0), out, n2 * c, c, n2 * c, c,
                   _dev(x.device, _stage_tables_np, n1_bits, inverse),
                   n1_bits, True, zero_top)


def ntt_block_cols(x: GL, n1_bits: int, n2_bits: int, inverse: bool,
                   zero_top: bool = False) -> GL:
    """Kernel A of the pipeline: the DIF over i1 of the (n1, n2 * c) view of
    an (N, c) matrix `x` (N/2 rows with `zero_top`), which may be a column
    slice of a wider matrix (unit column stride).  Returns the contiguous
    (n1, n2 * c) block, rows in bit-reversed order."""
    if x.device.type == "cpu":
        return ntt_block_cols_plain(x, n1_bits, n2_bits, inverse, zero_top)
    if _check_cols(x, n1_bits, n2_bits, zero_top) == 0:
        return x.new_zeros((1 << n1_bits, 0))
    f = _cols_fields(x, n1_bits, n2_bits, inverse, zero_top)
    code = _launch(f)
    _count(n1_bits)
    cuda_build.check(code, "ntt_block_cols launch")
    return f["out"]


def _check_gather(y: GL, n1_bits: int, n2_bits: int, c: int, u, v, out):
    n = 1 << (n1_bits + n2_bits)
    if y.dtype != torch.int64 or y.shape != (1 << n1_bits, c << n2_bits):
        raise ValueError("ntt block: kernel B expects kernel A's "
                         f"({1 << n1_bits}, {c << n2_bits}) block")
    if not (0 <= n1_bits <= 30 and 1 <= n2_bits <= MAX_KERNEL_BITS):
        raise ValueError("ntt block: pipeline split out of range")
    if u is not None and (u.shape != (1 << n2_bits,) or u.device != y.device):
        raise ValueError("ntt block: bad row scale")
    if v is not None and (v.shape != (1 << n1_bits,) or v.device != y.device):
        raise ValueError("ntt block: bad column-group scale")
    if out is not None and (out.shape != (n, c) or out.device != y.device
                            or out.dtype != torch.int64
                            or (c > 1 and out.stride(1) != 1)):
        raise ValueError(f"ntt block: out must be an ({n}, {c}) int64 view "
                         "with unit column stride")


def ntt_block_gather_plain(y: GL, n1_bits: int, n2_bits: int, c: int,
                           inverse: bool, u: Optional[GL] = None,
                           v: Optional[GL] = None,
                           const_scale: Optional[int] = None,
                           out: Optional[GL] = None) -> GL:
    """Plain version of :func:`ntt_block_gather`: ``_mid_gather``, then the
    plain block transform with v[k1] repeated over each group's c words."""
    _check_gather(y, n1_bits, n2_bits, c, u, v, out)
    z = _mid_gather(y, n1_bits, n2_bits, c, inverse)
    res = ntt_block_plain(
        z, _dev(y.device, _stage_tables_np, n2_bits, inverse), n2_bits,
        dif=False, u=u, v=None if v is None else v.repeat_interleave(c),
        const_scale=const_scale).reshape(1 << (n1_bits + n2_bits), c)
    if out is None:
        return res
    out.copy_(res)
    return out


def _gather_fields(y: GL, n1_bits: int, n2_bits: int, c: int,
                   inverse: bool, u: Optional[GL], v: Optional[GL],
                   const_scale: Optional[int], out: GL) -> dict:
    """Kernel B: input row s, column k1 * c + cc reads word cc of y's flat
    row rev1(k1) * n2 + rev2(s), times T[s, k1]; output row k2, column
    k1 * c + cc is word cc of out's row k2 * n1 + k1."""
    n1 = 1 << n1_bits
    dev = y.device
    return _fields(y.contiguous(), c, c << n2_bits, out, n1 * out.stride(0),
                   out.stride(0), n1 * c, c,
                   _dev(dev, _stage_tables_np, n2_bits, inverse), n2_bits,
                   False, False, None if u is None else u.contiguous(),
                   None if v is None else v.contiguous(), c, const_scale,
                   _dev(dev, _gather_twiddle_np, n1_bits, n2_bits, inverse),
                   n1_bits)


def ntt_block_gather(y: GL, n1_bits: int, n2_bits: int, c: int,
                     inverse: bool, u: Optional[GL] = None,
                     v: Optional[GL] = None,
                     const_scale: Optional[int] = None,
                     out: Optional[GL] = None) -> GL:
    """Kernel B of the pipeline with the mid gather in its load: the DIT
    over i2 of z = _mid_gather(y), times u[k2] * v[k1] * const_scale, as the
    natural-order (N, c) result, written into `out` when given (an (N, c)
    view with unit column stride, e.g. a column slice) and returned."""
    if y.device.type == "cpu":
        return ntt_block_gather_plain(y, n1_bits, n2_bits, c, inverse, u, v,
                                      const_scale, out)
    _check_gather(y, n1_bits, n2_bits, c, u, v, out)
    if out is None:
        out = torch.empty((1 << (n1_bits + n2_bits), c), dtype=torch.int64,
                          device=y.device)
    if c == 0:
        return out
    f = _gather_fields(y, n1_bits, n2_bits, c, inverse, u, v, const_scale, out)
    code = _launch(f)
    _count(n2_bits)
    SUB_LAUNCHES["ntt_block_gather"] += 1
    cuda_build.check(code, "ntt_block_gather launch")
    return out


def _ntt_v2(a2: GL, nbits: int, inverse: bool, *,
            sep_scale_base: Optional[int] = None, with_ninv: bool = False,
            const_scale: Optional[int] = None, zero_top: bool = False,
            out: Optional[GL] = None) -> GL:
    """Length-2^nbits transform over axis 0 of (N, C) (or (N/2, C) input
    when zero_top) via the DIF -> gather -> DIT pipeline: two launches on
    the card.  `a2` and `out` may be column slices of wider matrices."""
    n1_bits, n2_bits = _split(nbits)
    assert n1_bits <= MAX_KERNEL_BITS
    # kernel A: DIF over i1
    y = ntt_block_cols(a2, n1_bits, n2_bits, inverse, zero_top)
    # kernel B: mid gather in its load, DIT over i2, fused scales
    u = v = None
    if sep_scale_base is not None:
        key = (nbits, n1_bits, sep_scale_base, with_ninv)
        u = _dev(a2.device, _sep_scale_np, *key, pick=0)
        v = _dev(a2.device, _sep_scale_np, *key, pick=1)
    return ntt_block_gather(y, n1_bits, n2_bits, a2.shape[1], inverse, u=u,
                            v=v, const_scale=const_scale, out=out)


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
                      shift: int = SHIFT, out: Optional[GL] = None) -> GL:
    """Coset LDE of an (N, C) array onto the shifted 2^n_bits_ext domain,
    written into `out` when given ((2^n_bits_ext, C), unit column stride).
    On the pipeline's sizes `a2` and `out` may be column slices of wider
    matrices: the kernels read and write them in place."""
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
        return _ntt_v2(coeffs, n_bits_ext, False, zero_top=True, out=out)
    coeffs = ntt_device(a2.contiguous(), inverse=True, scale=1)
    sv = _dev(a2.device, _scale_shift_np, n_bits, shift, True)
    coeffs = gl.mul(coeffs, sv[:, None])
    padded = torch.cat([coeffs, coeffs.new_zeros((n_ext - n, c))], dim=0)
    res = ntt_device(padded, inverse=False)
    if out is None:
        return res
    out.copy_(res)
    return out
