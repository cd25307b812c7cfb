"""Binary SM (reference src/sm/binary/binary_executor.cpp).

Each 256-bit operation occupies 16 rows (STEPS), two bytes per row
(little-endian): row j carries bytes 2j (freeIn*[0]) and 2j+1
(freeIn*[1]).  Eight 32-bit accumulator registers a[0..7]/b/c fill via
the FACTOR tables (register j accumulates at rows 2j, 2j+1 of each
16-row block; factor 1 then 2^16).  Carry chains run byte-by-byte
through cIn/cMiddle/cOut with opcode-specific semantics
(binary_executor.cpp:150-310); lCout/lOpcode latch the previous row's
carry/opcode; resultBinOp (type-1 actions) or resultValidRange (type-2
range checks from sWR/hashPDigest) is set on the row after the action.

Opcodes: 0 ADD, 1 SUB, 2 LT, 3 SLT, 4 EQ, 5 AND, 6 OR, 7 XOR.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

STEPS = 16
REGISTERS = 8
M256 = (1 << 256) - 1


def byte_op(opcode: int, cin: int, last_byte: int, a: int, b: int,
            c: int = 0) -> Tuple[int, int]:
    """(cOut, useCarry) for one byte step — the reference's switch
    (binary_executor.cpp:150-310).  `c` is only read by AND."""
    if opcode == 0:                       # ADD
        return (a + b + cin) >> 8, 0
    if opcode == 1:                       # SUB
        return (1 if a - cin < b else 0), 0
    if opcode == 2:                       # LT
        cout = 1 if a < b else (cin if a == b else 0)
        return cout, (1 if last_byte else 0)
    if opcode == 3:                       # SLT: sign at the top byte
        if last_byte:
            sa, sb = a >> 7, b >> 7
            if sa > sb:
                cout = 1
            elif sa < sb:
                cout = 0
            else:
                cout = 1 if a < b else (cin if a == b else 0)
            return cout, 1
        cout = 1 if a < b else (cin if a == b else 0)
        return cout, 0
    if opcode == 4:                       # EQ: carry = "differ so far"
        cout = 0 if (a == b and cin == 0) else 1
        if last_byte:
            return 1 - cout, 1
        return cout, 0
    if opcode == 5:                       # AND: carry = "any nonzero byte"
        return (0 if (c == 0 and cin == 0) else 1), 0
    return 0, 0                           # OR / XOR


class BinaryExecutor:
    COLUMNS = (
        [f"freeInA{k}" for k in range(2)]
        + [f"freeInB{k}" for k in range(2)]
        + [f"freeInC{k}" for k in range(2)]
        + [f"a{j}" for j in range(REGISTERS)]
        + [f"b{j}" for j in range(REGISTERS)]
        + [f"c{j}" for j in range(REGISTERS)]
        + ["opcode", "cIn", "cMiddle", "cOut", "lCout", "lOpcode",
           "useCarry", "resultBinOp", "resultValidRange"]
    )

    def execute(self, actions: List[dict], n: int) -> Dict[str, np.ndarray]:
        if len(actions) * STEPS > n:
            raise ValueError("binary SM overflow")
        pols = {c: np.zeros(n, dtype=np.uint64) for c in self.COLUMNS}
        for i, act in enumerate(actions):
            self._check(act)
            a_by = [(act["a"] >> (8 * k)) & 0xFF for k in range(32)]
            b_by = [(act["b"] >> (8 * k)) & 0xFF for k in range(32)]
            c_by = [(act["c"] >> (8 * k)) & 0xFF for k in range(32)]
            opcode = act["opcode"]
            for j in range(STEPS):
                idx = i * STEPS + j
                nxt = (idx + 1) % n
                reset = j == 0
                last = j == STEPS - 1
                pols["opcode"][idx] = opcode
                cin0 = int(pols["cIn"][idx])
                free_c = [c_by[2 * j], c_by[2 * j + 1]]
                use_carry = 0
                couts = [0, 0]
                for k in range(2):
                    cin = cin0 if k == 0 else couts[0]
                    ba, bb = a_by[2 * j + k], b_by[2 * j + k]
                    bc = c_by[2 * j + k]
                    last_byte = last and k == 1
                    # LT/SLT/EQ override freeInC on reset/last rows
                    # (the c registers hold the 0/1 result, its bytes
                    # come from positions 15 / 0)
                    if opcode in (2, 3, 4):
                        if reset and k == 0:
                            free_c[0] = c_by[STEPS - 1]
                        if last_byte:
                            free_c[1] = c_by[0]
                            use_carry = 1
                    cout, _ = byte_op(opcode, cin, 1 if last_byte else 0,
                                      ba, bb, bc)
                    couts[k] = cout
                if opcode == 3 and last:
                    use_carry = 1
                for k in range(2):
                    pols[f"freeInA{k}"][idx] = a_by[2 * j + k]
                    pols[f"freeInB{k}"][idx] = b_by[2 * j + k]
                    pols[f"freeInC{k}"][idx] = free_c[k]
                pols["cMiddle"][idx] = couts[0]
                pols["cOut"][idx] = couts[1]
                pols["useCarry"][idx] = use_carry

                next_reset = nxt % STEPS == 0
                pols["cIn"][nxt] = 0 if next_reset else couts[1]
                pols["lCout"][nxt] = couts[1]
                pols["lOpcode"][nxt] = opcode
                self._advance(pols, idx, nxt, reset, last, use_carry)
            if act.get("type", 1) == 1:
                pols["resultBinOp"][(i + 1) * STEPS % n] = 1
            else:
                pols["resultValidRange"][(i + 1) * STEPS % n] = 1
        # idle tail + wrap: propagate the (all-zero) register transitions
        for idx in range(len(actions) * STEPS, n):
            nxt = (idx + 1) % n
            self._advance(pols, idx, nxt, idx % STEPS == 0, False, 0)
        return pols

    @staticmethod
    def _advance(pols, idx: int, nxt: int, reset: bool, last: bool,
                 use_carry: int) -> None:
        """Register accumulation (binary_executor.cpp:312-345): register
        (idx//2)%8 absorbs this row's two bytes at factor 1 / 2^16."""
        reg = (idx // 2) % REGISTERS
        factor = 1 if idx % 2 == 0 else 1 << 16
        for name, fa in (("a", "freeInA"), ("b", "freeInB")):
            for j in range(REGISTERS):
                v = 0 if reset else int(pols[f"{name}{j}"][idx])
                if j == reg:
                    v += int(pols[f"{fa}0"][idx]) * factor \
                        + 256 * int(pols[f"{fa}1"][idx]) * factor
                pols[f"{name}{j}"][nxt] = v
        c0 = 0 if reset else int(pols["c0"][idx])
        if reg == 0:
            c0 += int(pols["freeInC0"][idx]) * factor \
                + 256 * int(pols["freeInC1"][idx]) * factor
        pols["c0"][nxt] = int(pols["cOut"][idx]) if use_carry else c0
        for j in range(1, REGISTERS):
            if last and use_carry:
                pols[f"c{j}"][nxt] = 0
                continue
            v = 0 if reset else int(pols[f"c{j}"][idx])
            if j == reg:
                v += int(pols["freeInC0"][idx]) * factor \
                    + 256 * int(pols["freeInC1"][idx]) * factor
            pols[f"c{j}"][nxt] = v

    @staticmethod
    def _check(act: dict):
        """Semantic validation before committing the trace."""
        a, b, c, opcode = act["a"], act["b"], act["c"], act["opcode"]
        if opcode == 0:
            ok = c == (a + b) & M256
        elif opcode == 1:
            ok = c == (a - b) & M256
        elif opcode == 2:
            ok = c == (1 if a < b else 0)
        elif opcode == 3:
            sa = a - (1 << 256) if a >> 255 else a
            sb = b - (1 << 256) if b >> 255 else b
            ok = c == (1 if sa < sb else 0)
        elif opcode == 4:
            ok = c == (1 if a == b else 0)
        elif opcode == 5:
            ok = c == (a & b)
        elif opcode == 6:
            ok = c == (a | b)
        elif opcode == 7:
            ok = c == (a ^ b)
        else:
            raise ValueError(f"bad binary opcode {opcode}")
        if not ok:
            raise ValueError(
                f"binary action inconsistent: op={opcode} a={hex(a)} "
                f"b={hex(b)} c={hex(c)}")
