"""ECRecover — Ethereum signature recovery (reference src/ecrecover/
ecrecover.cpp:42-63 and ECRecoverPrecalc, main_executor.cpp:244-259).

Given (digest, r, s, v) recover the signer address:
  R = lift_x(r, v), u1 = -digest/s? — the standard recovery:
  Q = r^{-1} (s*R - digest*G); address = keccak256(Q)[12:].

Used by the executor fast path; the provable path runs the same EC math
through the Arith SM inside the ROM's ecrecover zkASM routine.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..ops import secp256k1 as ec
from ..utils.keccak import keccak256

ECR_NO_ERROR = 0
ECR_R_IS_ZERO = 1
ECR_R_IS_TOO_BIG = 2
ECR_S_IS_ZERO = 3
ECR_S_IS_TOO_BIG = 4
ECR_V_INVALID = 5
ECR_NO_SQRT_Y = 6
ECR_INFINITY = 7

# EIP-2: upper bound for s in transaction signatures
_S_MAX = ec.N // 2


def ecrecover(digest: int, r: int, s: int, v: int,
              precompiled: bool = False) -> Tuple[int, int]:
    """Returns (address, error).  `precompiled` relaxes the EIP-2 s bound
    (the ecrecover precompile accepts any s < n, reference
    ecrecover.cpp top-of-function checks)."""
    if r == 0:
        return 0, ECR_R_IS_ZERO
    if r >= ec.N:
        return 0, ECR_R_IS_TOO_BIG
    if s == 0:
        return 0, ECR_S_IS_ZERO
    s_max = ec.N - 1 if precompiled else _S_MAX
    if s > s_max:
        return 0, ECR_S_IS_TOO_BIG
    if v not in (27, 28, 0, 1):
        return 0, ECR_V_INVALID
    parity = (v - 27) if v >= 27 else v

    x = r  # (recovery with r + n overflow is rejected by r < n above)
    y2 = (pow(x, 3, ec.P) + ec.B) % ec.P
    y = ec.sqrt_p(y2)
    if y is None:
        return 0, ECR_NO_SQRT_Y
    if y % 2 != parity:
        y = ec.P - y

    r_inv = ec.inv_n(r)
    u1 = (-digest) % ec.N * r_inv % ec.N
    u2 = s * r_inv % ec.N
    q = ec.mul2(u1, (ec.GX, ec.GY), u2, (x, y))
    if q is None:
        return 0, ECR_INFINITY
    qx, qy = q
    h = keccak256(qx.to_bytes(32, "big") + qy.to_bytes(32, "big"))
    return int.from_bytes(h[12:], "big"), ECR_NO_ERROR


def sign_for_test(digest: int, priv: int, k: int) -> Tuple[int, int, int]:
    """Deterministic-k ECDSA signing (tests only)."""
    pt = ec.mul(k, (ec.GX, ec.GY))
    r = pt[0] % ec.N
    s = ec.inv_n(k) * ((digest + r * priv) % ec.N) % ec.N
    v = 27 + (pt[1] % 2)
    if s > _S_MAX:
        s = ec.N - s
        v = 27 + (1 - (v - 27))
    return r, s, v
