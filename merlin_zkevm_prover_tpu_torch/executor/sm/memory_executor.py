"""Memory SM (reference src/sm/memory/memory_executor.cpp).

Sorts the Main SM's memory accesses by (addr, step) and fills the Mem.*
columns: addr, step, mOp, mWr, val[8], lastAccess — the access-ordered
trace whose constraints enforce read-after-write consistency.

Two kinds of synthetic rows keep mem.pil satisfiable:

  * padding rows after the last access keep addr at lastAddr+1 and
    increment step by 1 per row, so the increment plookup
    (mem.pil:16 `... in STEP+1`) sees value 1 everywhere
    (reference memory_executor.cpp:89-104);
  * bridge rows (mOp=0, this framework's reduced-domain extension)
    split address jumps >= the domain size into hops that fit the STEP
    range table.  mem.pil gates the Main<->Mem permutation on Mem.mOp
    (main.pil:752), constrains mOp=0 rows to mWr=0 and val continuity
    only — so extra non-access rows are legal at any position.  The
    reference never needs them because its 2^23 table covers the full
    address space; a reduced domain does not.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class MemoryExecutor:
    COLUMNS = ["addr", "step", "mOp", "mWr", "lastAccess"] + \
        [f"val{i}" for i in range(8)]

    def execute(self, accesses: List[dict], n: int) -> Dict[str, np.ndarray]:
        ordered = sorted(accesses, key=lambda a: (a["addr"], a["step"]))
        self._validate(ordered)

        # materialize rows, inserting bridge rows for addr jumps >= n
        rows: List[tuple] = []  # (addr, step, mOp, mWr, last, val|None)
        max_hop = n - 1
        prev_addr = None
        for i, acc in enumerate(ordered):
            if prev_addr is not None and acc["addr"] - prev_addr > max_hop:
                a = prev_addr
                while acc["addr"] - a > max_hop:
                    a += max_hop
                    rows.append((a, 0, 0, 0, 1, None))
            last = (i + 1 == len(ordered)
                    or ordered[i + 1]["addr"] != acc["addr"])
            rows.append((acc["addr"], acc["step"], 1,
                         1 if acc["wr"] else 0, 1 if last else 0,
                         acc["value"]))
            prev_addr = acc["addr"]
        if len(rows) > n:
            raise ValueError(f"memory SM overflow: {len(rows)} > {n}")

        pols = {c: np.zeros(n, dtype=np.uint64) for c in self.COLUMNS}
        for i, (addr, step, mop, mwr, last, val) in enumerate(rows):
            pols["addr"][i] = addr
            pols["step"][i] = step
            pols["mOp"][i] = mop
            pols["mWr"][i] = mwr
            pols["lastAccess"][i] = last
            if val is not None:
                for k in range(8):
                    pols[f"val{k}"][i] = val[k]
        # padding: addr pinned one past the last used address, step
        # incrementing so every non-lastAccess increment is 1
        pad_addr = (rows[-1][0] + 1) if rows else 1
        pad_step = (rows[-1][1] + 1) if rows else 0
        for i in range(len(rows), n):
            pols["addr"][i] = pad_addr
            pols["step"][i] = pad_step
            pad_step += 1
        # the cyclic wrap closes the access chain: the final domain row
        # must flag lastAccess (mem.pil:30 (lastAccess-1)*LLAST == 0)
        pols["lastAccess"][n - 1] = 1
        return pols

    @staticmethod
    def _validate(ordered: List[dict]):
        current: Dict[int, List[int]] = {}
        for acc in ordered:
            if acc["wr"]:
                current[acc["addr"]] = list(acc["value"])
            else:
                expect = current.get(acc["addr"], [0] * 8)
                if list(acc["value"]) != expect:
                    raise ValueError(
                        f"memory read inconsistency at addr={acc['addr']}"
                    )
