"""A wide test circuit whose programs are of the zkEVM's kind of size.

Committed sums of products over many committed columns: with the default
widths, step 4's program has some 3,400 expression nodes and the
evaluation map 191 entries, above both of the reference's thresholds
(``MERLIN_VM_MIN_NODES`` 3000, ``MERLIN_STEP5_MATRIX_MIN`` 128), where the
smoke circuit's programs have 2, 45 and 146 instructions.  Steps 2 and 3
are empty (no plookup, permutation or connection).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops.goldilocks import P
from ..stark.air import AIR


def build_wide_air(n_bits: int = 4, n_base: int = 150, n_sums: int = 40,
                   terms: int = 40, seed: int = 9,
                   device=None) -> Tuple[AIR, np.ndarray]:
    """Returns (air, satisfying trace (N, n_base + n_sums)): each sum column
    equals the sum of `terms` seeded products of two base columns.  The
    trace's field arithmetic runs on `device` (None: the card, raising
    when there is none; "cpu": the CPU)."""
    air = AIR("wide", n_bits)
    rng = np.random.default_rng(seed)
    base = [air.committed(f"a{j}") for j in range(n_base)]
    sums = [air.committed(f"s{k}") for k in range(n_sums)]
    vals = rng.integers(0, P, (air.n, n_base), dtype=np.uint64)
    cols = gl.from_u64(vals.T.copy(), device)
    svals = torch.zeros((n_sums, air.n), dtype=torch.int64, device=cols.device)
    for k in range(n_sums):
        e = None
        for x, y in rng.integers(0, n_base, (terms, 2)):
            t = base[x] * base[y]
            e = t if e is None else e + t
            svals[k] = gl.add(svals[k], gl.mul(cols[x], cols[y]))
        air.constraint(sums[k] - e)
    return air, np.concatenate([vals, gl.to_u64(svals).T], axis=1)
