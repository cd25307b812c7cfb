"""Arith SM (reference src/sm/arith/arith_executor.cpp + sm_arith_eq*.cpp).

Operands are decomposed into 16 x 16-bit limbs; each action spans 32 rows.
Equation selectors (reference ArithAction selEq0-3, arith_executor.cpp:18-60):
  eq0 (selEq0): x1*y1 + x2 - y2*2^256 - y3 = 0        (256-bit mul/add)
  eq1 (selEq1): s*x2 - s*x1 - y2 + y1 + p*q0 - p*2^258 = 0   (EC add slope)
  eq2 (selEq2): 2*s*y1 - 3*x1^2 + p*q0 - p*2^258 = 0         (EC dbl slope)
  eq3 (selEq3): s^2 - x1 - x2 - x3 + p*q1 - p*2^258 = 0      (EC x3)
  eq4 (selEq3): s*x1 - s*x3 - y1 - y3 + p*q2 - p*2^258 = 0   (EC y3)

Quotients are offset-encoded exactly as the reference
(arith_executor.cpp:113-183): q = -(pq / p) + 2^258, so every committed q
limb stays a positive 16-bit value.  The committed carry[0..2] columns are
the running base-2^16 carries of the limb-space residual chains
(arith_executor.cpp:228-262): carry0 serves eq0/eq1/eq2, carry1 eq3,
carry2 eq4; resultEq0/1/2 flag the last row of each active equation.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

FPEC = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
P_GL = 0xFFFFFFFF00000001
TWO258 = 1 << 258
ROWS_PER_ACTION = 32
N_LIMBS = 16


def limbs16(v: int, n: int = N_LIMBS) -> List[int]:
    """Reference scalar2ba16 (utils/scalar.cpp:514-536): 16-bit limbs,
    except the last one is 20 bits wide (holds q's 2^258 offset)."""
    assert v < (1 << (16 * (n - 1) + 20)), "limbs16 overflow"
    return [(v >> (16 * i)) & (0xFFFF if i < n - 1 else 0xFFFFF)
            for i in range(n)]


P_LIMBS = limbs16(FPEC)


def _conv(a: List[int], b: List[int], k: int) -> int:
    """Coefficient k of the limb-space product a(x)*b(x)."""
    lo = max(0, k - len(b) + 1)
    hi = min(k, len(a) - 1)
    return sum(a[i] * b[k - i] for i in range(lo, hi + 1))


class ArithExecutor:
    VEC_COLS = ["x1", "y1", "x2", "y2", "x3", "y3", "s", "q0", "q1", "q2"]
    COLUMNS = (
        [f"{c}_{i}" for c in VEC_COLS for i in range(N_LIMBS)]
        + [f"selEq{k}" for k in range(4)]
        + [f"carry{k}" for k in range(3)]
        + [f"resultEq{k}" for k in range(3)]
    )

    def execute(self, actions: List[dict], n: int) -> Dict[str, np.ndarray]:
        if len(actions) * ROWS_PER_ACTION > n:
            raise ValueError("arith SM overflow")
        pols = {c: np.zeros(n, dtype=np.uint64) for c in self.COLUMNS}
        row = 0
        for act in actions:
            vals = self._prepare(dict(act))
            lv = {c: limbs16(vals[c]) for c in self.VEC_COLS}
            for r in range(ROWS_PER_ACTION):
                for c in self.VEC_COLS:
                    for i in range(N_LIMBS):
                        pols[f"{c}_{i}"][row + r] = lv[c][i]
                for k in range(4):
                    if vals[f"selEq{k}"]:
                        pols[f"selEq{k}"][row + r] = 1
            # carry chains (reference arith_executor.cpp:228-262): one
            # residual chain per active equation; the committed value at
            # step r is the carry *into* that step.
            eq_ids: List[int] = []
            if vals["selEq0"]:
                eq_ids.append(0)
            if vals["selEq1"]:
                eq_ids.append(1)
            if vals["selEq2"]:
                eq_ids.append(2)
            if vals["selEq3"]:
                eq_ids += [3, 4]
            eq_to_carry = {0: 0, 1: 0, 2: 0, 3: 1, 4: 2}
            carry = [0, 0, 0]
            for r in range(ROWS_PER_ACTION):
                for eq in eq_ids:
                    ci = eq_to_carry[eq]
                    pols[f"carry{ci}"][row + r] = carry[ci] % P_GL
                    v = self._eq_step(eq, lv, r)
                    q, rem = divmod(v + carry[ci], 1 << 16)
                    assert rem == 0, (
                        f"arith eq{eq} residual non-zero at step {r}")
                    carry[ci] = q
            for k in range(3):
                if vals[f"selEq{k}"]:
                    pols[f"resultEq{k}"][row + ROWS_PER_ACTION - 1] = 1
            row += ROWS_PER_ACTION
        return pols

    @staticmethod
    def _eq_step(eq: int, lv: Dict[str, List[int]], k: int) -> int:
        """Limb-space residual coefficient k of equation eq (the exact
        integer the reference's generated sm_arith_eq{eq}.cpp returns
        via fr.toS64)."""
        x1, y1, x2, y2 = lv["x1"], lv["y1"], lv["x2"], lv["y2"]
        x3, y3, s = lv["x3"], lv["y3"], lv["s"]
        q0, q1, q2 = lv["q0"], lv["q1"], lv["q2"]

        def at(v, i):  # direct limb term; absent above limb 15
            return v[i] if i < len(v) else 0

        if eq == 0:
            # x1*y1 - 2^256*y2 + x2 - y3
            v = _conv(x1, y1, k) + at(x2, k) - at(y3, k)
            if k >= 16:
                v -= y2[k - 16]
            return v
        # p*2^258 limbs: 4*p_limb[i] at index 16+i
        pofs = 4 * P_LIMBS[k - 16] if k >= 16 else 0
        if eq == 1:
            return (_conv(s, x2, k) - _conv(s, x1, k) - at(y2, k)
                    + at(y1, k) + _conv(P_LIMBS, q0, k) - pofs)
        if eq == 2:
            return (2 * _conv(s, y1, k) - 3 * _conv(x1, x1, k)
                    + _conv(P_LIMBS, q0, k) - pofs)
        if eq == 3:
            return (_conv(s, s, k) - at(x1, k) - at(x2, k) - at(x3, k)
                    + _conv(P_LIMBS, q1, k) - pofs)
        if eq == 4:
            return (_conv(s, x1, k) - _conv(s, x3, k) - at(y1, k)
                    - at(y3, k) + _conv(P_LIMBS, q2, k) - pofs)
        raise ValueError(f"bad eq {eq}")

    @staticmethod
    def _prepare(act: dict) -> dict:
        """Validate the action and derive s/q0/q1/q2 exactly as the
        reference does (arith_executor.cpp:103-183): q = -(pq/p) + 2^258
        with C-style truncated division (pq is always an exact multiple
        of p, so the sign convention never actually matters)."""
        # normalize legacy format
        if "selEq0" not in act:
            eq = act.get("eq", 0)
            act["selEq0"] = 1 if eq == 0 else 0
            act["selEq1"] = 1 if eq == 1 else 0
            act["selEq2"] = 1 if eq == 2 else 0
            act["selEq3"] = 1 if eq in (1, 2) else 0
        x1, y1 = act["x1"], act["y1"]
        x2, y2 = act["x2"], act["y2"]
        x3, y3 = act.get("x3", 0), act.get("y3", 0)
        s = q0 = q1 = q2 = 0
        if act["selEq0"]:
            if x1 * y1 + x2 != (y2 << 256) + y3:
                raise ValueError("arith eq0 check failed")
        if act["selEq1"]:
            s = (y2 - y1) % FPEC * pow((x2 - x1) % FPEC, FPEC - 2, FPEC) \
                % FPEC
            pq0 = s * x2 - s * x1 - y2 + y1
            assert pq0 % FPEC == 0, "arith eq1 check failed"
            q0 = -(pq0 // FPEC) + TWO258
        elif act["selEq2"]:
            s = 3 * x1 * x1 % FPEC * pow(2 * y1 % FPEC, FPEC - 2, FPEC) \
                % FPEC
            pq0 = s * 2 * y1 - 3 * x1 * x1
            assert pq0 % FPEC == 0, "arith eq2 check failed"
            q0 = -(pq0 // FPEC) + TWO258
        if act["selEq3"]:
            pq1 = s * s - x1 - x2 - x3
            assert pq1 % FPEC == 0, "arith x3 check failed"
            q1 = -(pq1 // FPEC) + TWO258
            pq2 = s * x1 - s * x3 - y1 - y3
            assert pq2 % FPEC == 0, "arith y3 check failed"
            q2 = -(pq2 // FPEC) + TWO258
        assert 0 <= q0 < (1 << 259) and 0 <= q1 < (1 << 259) \
            and 0 <= q2 < (1 << 259)
        return {
            "x1": x1, "y1": y1, "x2": x2, "y2": y2, "x3": x3, "y3": y3,
            "s": s, "q0": q0, "q1": q1, "q2": q2,
            "selEq0": act["selEq0"], "selEq1": act["selEq1"],
            "selEq2": act["selEq2"], "selEq3": act["selEq3"],
        }
