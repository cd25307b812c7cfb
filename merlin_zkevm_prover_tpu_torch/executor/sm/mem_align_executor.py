"""MemAlign SM (reference src/sm/mem_align/mem_align_executor.cpp).

Handles unaligned 256-bit reads/writes across two 32-byte memory words:
each action spans 32 rows holding the byte decomposition of m0, m1, the
value v, and the written words w0/w1 with the offset selectors.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

ROWS_PER_ACTION = 32
MASK256 = (1 << 256) - 1


def _bytes_be(v: int) -> List[int]:
    return [(v >> (8 * (31 - i))) & 0xFF for i in range(32)]


class MemAlignExecutor:
    COLUMNS = (
        ["inM0", "inM1", "inV", "wr256", "wr8", "offset",
         "resultRd", "resultWr256", "resultWr8", "selM1"]
        + [f"m0_{i}" for i in range(8)]
        + [f"m1_{i}" for i in range(8)]
        + [f"w0_{i}" for i in range(8)]
        + [f"w1_{i}" for i in range(8)]
        + [f"v_{i}" for i in range(8)]
    )

    def execute(self, actions: List[dict], n: int) -> Dict[str, np.ndarray]:
        if len(actions) * ROWS_PER_ACTION > n:
            raise ValueError("memAlign SM overflow")
        pols = {c: np.zeros(n, dtype=np.uint64) for c in self.COLUMNS}
        row = 0
        for act in actions:
            self._check(act)
            words = {
                "m0": act["m0"], "m1": act["m1"], "v": act["v"],
                "w0": act.get("w0", 0), "w1": act.get("w1", 0),
            }
            for r in range(ROWS_PER_ACTION):
                i = row + r
                pols["offset"][i] = act["offset"]
                pols["wr256"][i] = 1 if act.get("wr256") else 0
                pols["wr8"][i] = 1 if act.get("wr8") else 0
                for wname in ("m0", "m1", "w0", "w1", "v"):
                    limbs = [(words[wname] >> (32 * k)) & 0xFFFFFFFF
                             for k in range(8)]
                    for k in range(8):
                        pols[f"{wname}_{k}"][i] = limbs[k]
            last = row + ROWS_PER_ACTION - 1
            if act.get("wr256"):
                pols["resultWr256"][last] = 1
            elif act.get("wr8"):
                pols["resultWr8"][last] = 1
            else:
                pols["resultRd"][last] = 1
            row += ROWS_PER_ACTION
        return pols

    @staticmethod
    def _check(act: dict):
        off = act["offset"]
        m = _bytes_be(act["m0"]) + _bytes_be(act["m1"])
        if act.get("wr256"):
            vb = _bytes_be(act["v"])
            out = list(m)
            out[off:off + 32] = vb
            w = out[:32], out[32:]
            w0 = int.from_bytes(bytes(w[0]), "big")
            w1 = int.from_bytes(bytes(w[1]), "big")
            if w0 != act.get("w0", 0) or w1 != act.get("w1", 0):
                raise ValueError("memAlign wr256 check failed")
        elif act.get("wr8"):
            out = list(m)
            out[off] = act["v"] & 0xFF
            w0 = int.from_bytes(bytes(out[:32]), "big")
            if w0 != act.get("w0", 0):
                raise ValueError("memAlign wr8 check failed")
        else:
            got = int.from_bytes(bytes(m[off:off + 32]), "big")
            if got != act["v"]:
                raise ValueError("memAlign read check failed")
