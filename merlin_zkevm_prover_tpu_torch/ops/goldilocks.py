"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on one 64-bit word.

Every field element is one ``torch.int64`` word read as unsigned: PyTorch's
``uint64`` tensors have no ``add``, ``>>`` or ``<``, while ``int64`` has all
of them and wraps modulo 2^64 exactly like the unsigned type.  Two rules
follow and are used throughout:

  * an unsigned compare is a signed compare after flipping the top bit of
    both sides (``_ult``);
  * ``>>`` on ``int64`` is arithmetic, so a logical shift masks afterwards
    (``_lsr32``).

All functions are plain elementwise tensor code that broadcasts over any
shape and runs on whatever device its operands lie on.  Functions that
create tensors take an explicit ``device``; ``device=None`` means the GPU and
raises when there is none.

Semantics mirror the reference prover's Goldilocks library API
(`Goldilocks::add/sub/mul/inv/exp/shift/w`): all results are canonical
(< p) at op boundaries, and all inputs must be canonical except where a
function says otherwise.  The two-adic root-of-unity table W and the coset
shift follow the reference conventions (W[k] = g^((p-1)/2^k) with g = 7;
shift = 49 = 7^2).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Field constants (host-side python ints)
# ---------------------------------------------------------------------------

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1  # 2^64 mod p
GENERATOR = 7  # smallest generator of the multiplicative group
TWO_ADICITY = 32

# W[k] = primitive 2^k-th root of unity, W[k] = W[k+1]^2.
_W = [0] * (TWO_ADICITY + 1)
_W[TWO_ADICITY] = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
for _k in range(TWO_ADICITY - 1, -1, -1):
    _W[_k] = (_W[_k + 1] * _W[_k + 1]) % P
assert _W[0] == 1 and _W[1] == P - 1 and _W[2] == 1 << 48

# Coset generator used for the extended (LDE) evaluation domain,
# `Goldilocks::shift()` in the reference.
SHIFT = 49
SHIFT_INV = pow(SHIFT, P - 2, P)

_MASK32 = 0xFFFFFFFF
_TOP = -(1 << 63)  # the int64 whose only set bit is bit 63

GL = torch.Tensor  # a (batched) field element: int64 carrier, canonical < p
GLLike = Union[torch.Tensor, int]


def w(nbits: int) -> int:
    """Primitive 2^nbits-th root of unity as a python int."""
    return _W[nbits]


def w_inv(nbits: int) -> int:
    return pow(_W[nbits], P - 2, P)


# ---------------------------------------------------------------------------
# Devices and host <-> device conversions
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; there is no silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def _to_signed(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def from_u64(x, device=None) -> GL:
    """numpy uint64 array (or python ints / lists) -> int64 carrier tensor."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(resolve_device(device))


def to_u64(x: GL) -> np.ndarray:
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def const(value: int, shape=(), device=None) -> GL:
    """Broadcastable constant."""
    return torch.full(tuple(shape), _to_signed(value % P), dtype=torch.int64,
                      device=resolve_device(device))


def zeros(shape, device=None) -> GL:
    return torch.zeros(tuple(shape), dtype=torch.int64,
                       device=resolve_device(device))


def ones(shape, device=None) -> GL:
    return torch.ones(tuple(shape), dtype=torch.int64,
                      device=resolve_device(device))


def _coerce(x: GLLike) -> GLLike:
    """Python-int operands become int64 scalars PyTorch broadcasts itself."""
    if isinstance(x, torch.Tensor):
        return x
    return _to_signed(int(x) % P)


# ---------------------------------------------------------------------------
# Unsigned helpers on the int64 carrier
# ---------------------------------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit words (any operands)."""
    return (a ^ _TOP) < (b ^ _TOP)


def _lsr32(a):
    """Logical right shift by 32 (``>>`` alone would smear the sign bit)."""
    return (a >> 32) & _MASK32


def _canon(s: GL) -> GL:
    """One conditional subtract of p: any word in [0, 2^64) -> [0, p).

    As int64, the words in [p, 2^64) are exactly -2^32 < s < 0, and
    s - p == s + EPSILON (mod 2^64)."""
    ge = (s < 0) & (s > -(1 << 32))
    return torch.where(ge, s + EPSILON, s)


def canon(a: GL) -> GL:
    """Public form of the conditional subtract (input range [0, 2^64))."""
    return _canon(a)


# ---------------------------------------------------------------------------
# Field ops (inputs canonical, outputs canonical)
# ---------------------------------------------------------------------------


def add(a: GL, b: GLLike) -> GL:
    b = _coerce(b)
    s = a + b
    c = _ult(s, a).to(torch.int64)
    # carry => value = s + 2^64 == s + EPSILON (mod p); cannot re-wrap:
    # a, b < p so the wrapped s < 2^64 - 2^33 + 2
    s = s + c * EPSILON
    return _canon(s)


def sub(a: GL, b: GLLike) -> GL:
    b = _coerce(b)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    d = a - b
    brw = _ult(a, b).to(torch.int64)
    # borrow => true value = wrapped - 2^64 + p = wrapped - EPSILON
    return d - brw * EPSILON


def neg(a: GL) -> GL:
    # p - a, except 0 -> 0
    return torch.where(a == 0, a, _to_signed(P) - a)


def _reduce128(lo, hi) -> GL:
    """Reduce lo + 2^64 * hi (any two 64-bit words) mod p, canonical.

    Uses 2^64 = EPSILON and 2^96 = -1 (mod p)."""
    hi_lo = hi & _MASK32
    hi_hi = _lsr32(hi)
    b0 = _ult(lo, hi_hi).to(torch.int64)
    # borrow adds p = 2^64 - EPSILON; lo - hi_hi + 2^64 > EPSILON, no re-wrap
    t0 = lo - hi_hi - b0 * EPSILON
    t1 = (hi_lo << 32) - hi_lo  # hi_lo * EPSILON < 2^64
    s = t0 + t1
    c = _ult(s, t0).to(torch.int64)
    # carry => wrapped s < t1 <= 2^64 - 2^33 + 1, so + EPSILON cannot wrap
    s = s + c * EPSILON
    return _canon(s)


def mul(a: GL, b: GLLike) -> GL:
    """Field product.  Correct for any 64-bit operands; output canonical.

    There is no 64x64 -> 128 multiply in PyTorch: the operands are split
    into 32-bit halves whose products wrap modulo 2^64, which is the
    unsigned product's low word, and every carry is an unsigned compare."""
    b = _coerce(b)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.int64, device=a.device)
    al = a & _MASK32
    ah = _lsr32(a)
    bl = b & _MASK32
    bh = _lsr32(b)
    p00 = al * bl
    p01 = al * bh
    p10 = ah * bl
    p11 = ah * bh
    mid = p01 + p10
    midc = _ult(mid, p01).to(torch.int64)
    lo = p00 + (mid << 32)
    c0 = _ult(lo, p00).to(torch.int64)
    hi = p11 + _lsr32(mid) + (midc << 32) + c0
    return _reduce128(lo, hi)


def sqr(a: GL) -> GL:
    return mul(a, a)


def mul_small(a: GL, c: int) -> GL:
    """Multiply by a small (< 2^32) host constant."""
    if c == 0:
        return torch.zeros_like(a)
    if c == 1:
        return a
    assert 0 < c < (1 << 32)
    pl = (a & _MASK32) * c          # < 2^64
    ph = _lsr32(a) * c              # < 2^64, weight 2^32
    lo = pl + ((ph & _MASK32) << 32)
    carry = _ult(lo, pl).to(torch.int64)
    hi = _lsr32(ph) + carry         # < 2^32
    return _reduce128(lo, hi)


def pow7(a: GL) -> GL:
    a2 = mul(a, a)
    a3 = mul(a2, a)
    a4 = mul(a2, a2)
    return mul(a3, a4)


def exp(a: GL, e: int) -> GL:
    """a^e for a static host exponent (square and multiply)."""
    e = e % (P - 1) if e >= P - 1 else e
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a: GL) -> GL:
    """Fermat inverse a^(p-2).  Prefer batch_inverse for arrays."""
    return exp(a, P - 2)


def is_zero(a: GL) -> torch.Tensor:
    return a == 0


def eq(a: GL, b: GL) -> torch.Tensor:
    return a == b


def select(pred, a: GL, b: GL) -> GL:
    return torch.where(pred, a, b)


def ult(a: GL, b: GL) -> torch.Tensor:
    """Unsigned order of two carriers (sorting keys, range checks)."""
    return _ult(a, b)


def sort_key(a: GL) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of ``a``."""
    return a ^ _TOP


# ---------------------------------------------------------------------------
# Bulk helpers
# ---------------------------------------------------------------------------


def concat(parts, axis=0) -> GL:
    return torch.cat(list(parts), dim=axis)


def stack(parts, axis=0) -> GL:
    return torch.stack(list(parts), dim=axis)


def batch_inverse(a: GL, axis: int = -1) -> GL:
    """Montgomery batch inversion along `axis`; zero inputs give zero outputs.

    Mirrors Polinomial::batchInverse of the reference: one Fermat inversion
    of the total product, the rest from prefix and suffix products
    (log-depth scans, see ops.scan_utils)."""
    from .scan_utils import prefix_prod

    if axis != 0:
        return torch.movedim(
            batch_inverse(torch.movedim(a, axis, 0).contiguous(), 0), 0, axis)
    if a.shape[0] == 0:
        return a
    z = is_zero(a)
    aa = torch.where(z, torch.ones_like(a), a)  # avoid 0 poisoning products
    pe = prefix_prod(aa, mul, inclusive=False)
    se = prefix_prod(aa, mul, reverse=True, inclusive=False)
    tinv = inv(mul(pe[-1:], aa[-1:]))
    out = mul(mul(pe, se), tinv)
    return torch.where(z, torch.zeros_like(a), out)


def sum_axis0(a: GL) -> GL:
    """Exact modular sum over axis 0 via log-depth halving."""
    n = a.shape[0]
    if n == 0:
        return torch.zeros(a.shape[1:], dtype=torch.int64, device=a.device)
    m = 1 << max((n - 1).bit_length(), 0)
    if m != n:
        pad = torch.zeros((m - n,) + tuple(a.shape[1:]), dtype=torch.int64,
                          device=a.device)
        a = torch.cat([a, pad], dim=0)
    while m > 1:
        m //= 2
        a = add(a[:m], a[m:])
    return a[0]


def powers_np(base: int, n: int, start: int = 1) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    cur = start % P
    b = base % P
    for i in range(n):
        out[i] = cur
        cur = (cur * b) % P
    return out


def powers(base: int, n: int, start: int = 1, device=None) -> GL:
    """[start, start*base, ..., start*base^(n-1)] (host-computed)."""
    return from_u64(powers_np(base, n, start), device)
