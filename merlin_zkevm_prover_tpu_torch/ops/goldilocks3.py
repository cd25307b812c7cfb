"""Cubic extension field GF(p^3) = GF(p)[x] / (x^3 - x - 1) over Goldilocks.

Matches the reference `Goldilocks3` semantics (FIELD_EXTENSION = 3).  The
irreducible polynomial x^3 - x - 1 is pinned by the Karatsuba multiplication
of the reference (mulAddElement_adim3):

    c0 = a0*b0 + a1*b2 + a2*b1
    c1 = a0*b1 + a1*b0 + a1*b2 + a2*b1 + a2*b2
    c2 = a0*b2 + a1*b1 + a2*b0 + a2*b2

Elements are GL3 named tuples of three int64 carrier tensors; everything
broadcasts over arbitrary shapes like the base field ops.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from . import goldilocks as gl
from .goldilocks import GL, P


class GL3(NamedTuple):
    c0: GL
    c1: GL
    c2: GL

    @property
    def shape(self):
        return self.c0.shape

    @property
    def device(self):
        return self.c0.device

    def __getitem__(self, idx):
        return GL3(self.c0[idx], self.c1[idx], self.c2[idx])

    def reshape(self, *shape):
        return GL3(
            self.c0.reshape(*shape), self.c1.reshape(*shape), self.c2.reshape(*shape)
        )


GL3Like = Union[GL3, GL, int]


def from_u64(a, device=None) -> GL3:
    """numpy array with trailing dim 3 -> GL3."""
    a = np.asarray(a, dtype=np.uint64)
    assert a.shape[-1] == 3
    return GL3(
        gl.from_u64(a[..., 0], device), gl.from_u64(a[..., 1], device),
        gl.from_u64(a[..., 2], device)
    )


def to_u64(x: GL3) -> np.ndarray:
    return np.stack([gl.to_u64(x.c0), gl.to_u64(x.c1), gl.to_u64(x.c2)], axis=-1)


def zeros(shape, device=None) -> GL3:
    return GL3(gl.zeros(shape, device), gl.zeros(shape, device),
               gl.zeros(shape, device))


def ones(shape, device=None) -> GL3:
    return GL3(gl.ones(shape, device), gl.zeros(shape, device),
               gl.zeros(shape, device))


def from_base(a: GL) -> GL3:
    return GL3(a, torch.zeros_like(a), torch.zeros_like(a))


def const(c0: int, c1: int = 0, c2: int = 0, shape=(), device=None) -> GL3:
    return GL3(gl.const(c0, shape, device), gl.const(c1, shape, device),
               gl.const(c2, shape, device))


def _coerce(x: GL3Like, like: GL3) -> GL3:
    if isinstance(x, GL3):
        return x
    if isinstance(x, torch.Tensor):
        return from_base(x)
    return const(x, device=like.c0.device)


def add(a: GL3, b: GL3Like) -> GL3:
    b = _coerce(b, a)
    return GL3(gl.add(a.c0, b.c0), gl.add(a.c1, b.c1), gl.add(a.c2, b.c2))


def sub(a: GL3, b: GL3Like) -> GL3:
    b = _coerce(b, a)
    return GL3(gl.sub(a.c0, b.c0), gl.sub(a.c1, b.c1), gl.sub(a.c2, b.c2))


def neg(a: GL3) -> GL3:
    return GL3(gl.neg(a.c0), gl.neg(a.c1), gl.neg(a.c2))


def mul(a: GL3, b: GL3Like) -> GL3:
    """6-mul Karatsuba form, identical to reference mulAddElement_adim3."""
    b = _coerce(b, a)
    A = gl.mul(gl.add(a.c0, a.c1), gl.add(b.c0, b.c1))
    B = gl.mul(gl.add(a.c0, a.c2), gl.add(b.c0, b.c2))
    C = gl.mul(gl.add(a.c1, a.c2), gl.add(b.c1, b.c2))
    D = gl.mul(a.c0, b.c0)
    E = gl.mul(a.c1, b.c1)
    F = gl.mul(a.c2, b.c2)
    G = gl.sub(D, E)
    c0 = gl.sub(gl.add(C, G), F)
    c1 = gl.sub(gl.sub(gl.sub(gl.add(A, C), E), E), D)
    c2 = gl.sub(B, G)
    return GL3(c0, c1, c2)


def mul_base(a: GL3, b: GL) -> GL3:
    return GL3(gl.mul(a.c0, b), gl.mul(a.c1, b), gl.mul(a.c2, b))


def sqr(a: GL3) -> GL3:
    return mul(a, a)


def exp(a: GL3, e: int) -> GL3:
    if e == 0:
        return GL3(torch.ones_like(a.c0), torch.zeros_like(a.c1),
                   torch.zeros_like(a.c2))
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def _host_gl3_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    d0, d1 = a0 * b0, a0 * b1 + a1 * b0
    d2 = a0 * b2 + a1 * b1 + a2 * b0
    d3, d4 = a1 * b2 + a2 * b1, a2 * b2
    return ((d0 + d3) % P, (d1 + d3 + d4) % P, (d2 + d4) % P)


def _host_gl3_pow(a, e):
    r = (1, 0, 0)
    while e:
        if e & 1:
            r = _host_gl3_mul(r, a)
        e >>= 1
        a = _host_gl3_mul(a, a)
    return r


# Frobenius: phi(a0 + a1 x + a2 x^2) = a0 + a1 x^p + a2 x^(2p); the images of
# x and x^2 under phi (and phi^2) are fixed field constants.
_XP = _host_gl3_pow((0, 1, 0), P)
_X2P = _host_gl3_mul(_XP, _XP)
_XP2 = _host_gl3_pow((0, 1, 0), P * P)
_X2P2 = _host_gl3_mul(_XP2, _XP2)


def _lincomb(a: GL3, ximg, x2img) -> GL3:
    """a0 + a1 * ximg + a2 * x2img with host-constant GL3 coefficients."""
    out0 = gl.add(a.c0, gl.add(gl.mul(a.c1, ximg[0]), gl.mul(a.c2, x2img[0])))
    out1 = gl.add(gl.mul(a.c1, ximg[1]), gl.mul(a.c2, x2img[1]))
    out2 = gl.add(gl.mul(a.c1, ximg[2]), gl.mul(a.c2, x2img[2]))
    return GL3(out0, out1, out2)


def frobenius(a: GL3) -> GL3:
    return _lincomb(a, _XP, _X2P)


def frobenius2(a: GL3) -> GL3:
    return _lincomb(a, _XP2, _X2P2)


def inv(a: GL3) -> GL3:
    """Inverse in GF(p^3) via the norm map: a^-1 = a^(p+p^2) / N(a).

    N(a) = a^(1+p+p^2) lies in the base field; the Frobenius powers are
    closed-form linear maps on coefficients, so this costs ~20 base muls plus
    one base-field inversion.
    """
    t = mul(frobenius(a), frobenius2(a))  # a^(p+p^2)
    n = mul(a, t)  # norm, base-field element (c1 = c2 = 0)
    ninv = gl.inv(n.c0)
    return mul_base(t, ninv)


def is_zero(a: GL3) -> torch.Tensor:
    return gl.is_zero(a.c0) & gl.is_zero(a.c1) & gl.is_zero(a.c2)


def is_one(a: GL3) -> torch.Tensor:
    return (a.c0 == 1) & gl.is_zero(a.c1) & gl.is_zero(a.c2)


def eq(a: GL3, b: GL3) -> torch.Tensor:
    return gl.eq(a.c0, b.c0) & gl.eq(a.c1, b.c1) & gl.eq(a.c2, b.c2)


def select(pred, a: GL3, b: GL3) -> GL3:
    return GL3(
        gl.select(pred, a.c0, b.c0),
        gl.select(pred, a.c1, b.c1),
        gl.select(pred, a.c2, b.c2),
    )


def stack(parts, axis=0) -> GL3:
    return GL3(
        gl.stack([p.c0 for p in parts], axis=axis),
        gl.stack([p.c1 for p in parts], axis=axis),
        gl.stack([p.c2 for p in parts], axis=axis),
    )


def concat(parts, axis=0) -> GL3:
    return GL3(
        gl.concat([p.c0 for p in parts], axis=axis),
        gl.concat([p.c1 for p in parts], axis=axis),
        gl.concat([p.c2 for p in parts], axis=axis),
    )


def sum_axis0(a: GL3) -> GL3:
    return GL3(gl.sum_axis0(a.c0), gl.sum_axis0(a.c1), gl.sum_axis0(a.c2))


def broadcast_to(a: GL3, shape) -> GL3:
    return GL3(a.c0.expand(shape), a.c1.expand(shape), a.c2.expand(shape))


def prefix_prod(a: GL3, reverse: bool = False, inclusive: bool = True) -> GL3:
    """Prefix product along axis 0 (see ops.scan_utils)."""
    from .scan_utils import prefix_prod as _pp

    return _pp(a, mul, reverse=reverse, inclusive=inclusive)


def powers_scan(base: GL3, n: int) -> GL3:
    """[1, base, base^2, ..., base^(n-1)] for a device scalar base.

    Scan form of the reference's sequential power loops (LEv/LpEv)."""
    tiled = GL3(base.c0.reshape(()).expand(n), base.c1.reshape(()).expand(n),
                base.c2.reshape(()).expand(n))
    return prefix_prod(tiled, inclusive=False)


def batch_inverse_parallel(a: GL3) -> GL3:
    """Montgomery batch inversion via prefix scans (no zeros allowed).

    inv(a[i]) = prefix_excl[i] * suffix_excl[i] * inv(total) — the parallel
    form of reference Polinomial::batchInverseParallel.
    """
    pe = prefix_prod(a, inclusive=False)
    se = prefix_prod(a, reverse=True, inclusive=False)
    p_last = mul(pe[-1:], a[-1:])  # total product
    tinv = inv(p_last)
    return mul(mul(pe, se), tinv)


def batch_inverse(a: GL3, axis: int = 0) -> GL3:
    """Montgomery batch inversion along axis 0 (GF(p^3) variant); zero
    inputs give zero outputs."""
    if axis != 0:
        raise NotImplementedError
    z = is_zero(a)
    one = GL3(torch.ones_like(a.c0), torch.zeros_like(a.c1),
              torch.zeros_like(a.c2))
    out = batch_inverse_parallel(select(z, one, a))
    zero = GL3(torch.zeros_like(a.c0), torch.zeros_like(a.c1),
               torch.zeros_like(a.c2))
    return select(z, zero, out)
