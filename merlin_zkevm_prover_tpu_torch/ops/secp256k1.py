"""secp256k1 field and curve arithmetic (reference src/ffiasm fec/fnec).

The reference implements the base field (Fec), scalar field (Fnec) and
Jacobian point arithmetic in generated x86-64 Montgomery assembly
(fec.asm/fnec.asm, 8,876 lines each) plus curve helpers in
src/ecrecover/ecrecover.cpp:42-63 (mulPointEc, addPointEcJacobian).
Host-side python-int implementation here: executor call volumes are a few
points per transaction, far off the proving hot path; the EC checks that
must be *proven* run through the Arith SM (sm_arith_eq2-4 equations), not
through this module.
"""

from __future__ import annotations

from typing import Optional, Tuple

# field / curve parameters
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7

Point = Optional[Tuple[int, int]]  # affine; None = infinity


def inv_p(x: int) -> int:
    return pow(x, P - 2, P)


def inv_n(x: int) -> int:
    return pow(x, N - 2, N)


def sqrt_p(x: int) -> Optional[int]:
    """Square root mod p (p % 4 == 3); None if x is a non-residue."""
    r = pow(x % P, (P + 1) // 4, P)
    return r if r * r % P == x % P else None


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def add(p1: Point, p2: Point) -> Point:
    """Affine point addition (reference AddPointEc semantics)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 % P * inv_p(2 * y1 % P) % P
    else:
        lam = (y2 - y1) % P * inv_p((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def dbl(p1: Point) -> Point:
    return add(p1, p1)


def mul(k: int, pt: Point) -> Point:
    """Scalar multiplication (double-and-add, reference mulPointEc)."""
    k %= N
    acc: Point = None
    base = pt
    while k:
        if k & 1:
            acc = add(acc, base)
        base = dbl(base)
        k >>= 1
    return acc


def mul2(k1: int, p1: Point, k2: int, p2: Point) -> Point:
    """k1*P1 + k2*P2 with a shared double chain (Shamir's trick — the
    reference ECRecover's double-scalar multiplication)."""
    k1 %= N
    k2 %= N
    p12 = add(p1, p2)
    acc: Point = None
    for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
        acc = dbl(acc)
        b1 = (k1 >> i) & 1
        b2 = (k2 >> i) & 1
        if b1 and b2:
            acc = add(acc, p12)
        elif b1:
            acc = add(acc, p1)
        elif b2:
            acc = add(acc, p2)
    return acc
