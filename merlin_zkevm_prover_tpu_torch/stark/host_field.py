"""Host (python-int) Goldilocks / GF(p^3) arithmetic + small NTTs.

Used by the verifier and transcript glue, where sizes are tiny (query
groups, final FRI polynomial) and latency is dominated by transcript
sequencing, not arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..ops.goldilocks import P, SHIFT, w, w_inv

F3 = Tuple[int, int, int]


def as3(x) -> F3:
    if isinstance(x, tuple):
        return x
    if isinstance(x, list):
        return tuple(x)
    return (int(x) % P, 0, 0)


def add3(a: F3, b: F3) -> F3:
    return tuple((x + y) % P for x, y in zip(as3(a), as3(b)))


def sub3(a: F3, b: F3) -> F3:
    return tuple((x - y) % P for x, y in zip(as3(a), as3(b)))


def mul3(a: F3, b: F3) -> F3:
    a0, a1, a2 = as3(a)
    b0, b1, b2 = as3(b)
    d0 = a0 * b0
    d1 = a0 * b1 + a1 * b0
    d2 = a0 * b2 + a1 * b1 + a2 * b0
    d3 = a1 * b2 + a2 * b1
    d4 = a2 * b2
    return ((d0 + d3) % P, (d1 + d3 + d4) % P, (d2 + d4) % P)


def pow3(a: F3, e: int) -> F3:
    r: F3 = (1, 0, 0)
    a = as3(a)
    while e:
        if e & 1:
            r = mul3(r, a)
        e >>= 1
        a = mul3(a, a)
    return r


def inv3(a: F3) -> F3:
    return pow3(a, P**3 - 2)


def div3(a: F3, b: F3) -> F3:
    return mul3(a, inv3(b))


def ntt_host(vals: List[F3], root: int) -> List[F3]:
    n = len(vals)
    if n == 1:
        return list(vals)
    even = ntt_host(vals[0::2], root * root % P)
    odd = ntt_host(vals[1::2], root * root % P)
    out: List[F3] = [None] * n
    wcur = 1
    for k in range(n // 2):
        t = mul3(odd[k], (wcur, 0, 0))
        out[k] = add3(even[k], t)
        out[k + n // 2] = sub3(even[k], t)
        wcur = wcur * root % P
    return out


def intt_host(vals: List[F3]) -> List[F3]:
    n = len(vals)
    nbits = n.bit_length() - 1
    assert 1 << nbits == n
    out = ntt_host(list(vals), w_inv(nbits))
    ninv = pow(n, P - 2, P)
    return [mul3(v, (ninv, 0, 0)) for v in out]
