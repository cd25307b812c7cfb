"""Small self-contained test circuit exercising every argument type.

Used by the test suite, the multi-chip dry-run, and benchmarks as the
minimal "model": fibonacci transition constraints, public inputs, a
plookup range check, a permutation argument and a connection
(copy-constraint) argument — one of each structure the zkEVM circuits use
(reference PIL features compiled by pil-stark; SURVEY §2.2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.goldilocks import P, w as gl_w
from ..stark.air import AIR


def build_smoke_air(n_bits: int = 5, seed: int = 42) -> Tuple[AIR, np.ndarray]:
    """Returns (air, satisfying trace (N, 7))."""
    n = 1 << n_bits
    air = AIR("smoke", n_bits)
    a = air.committed("a")
    b = air.committed("b")
    v = air.committed("v")       # range-checked column
    p1 = air.committed("p1")     # permutation of p2
    p2 = air.committed("p2")
    w0 = air.committed("w0")     # copy-constrained to w1
    w1 = air.committed("w1")

    islast = np.zeros(n, dtype=np.uint64)
    islast[n - 1] = 1
    c_islast = air.constant("ISLAST", islast)
    table = air.constant("TABLE", np.arange(n, dtype=np.uint64))

    air.constraint((1 - c_islast) * (a.next() - b))
    air.constraint((1 - c_islast) * (b.next() - (a + b)))

    air.public("a0", a, 0)
    air.public("b0", b, 0)
    air.public("alast", a, n - 1)

    air.lookup([v], [table])
    air.permutation([p1], [p2])

    wn = gl_w(n_bits)
    xs = []
    cur = 1
    for _ in range(n):
        xs.append(cur)
        cur = cur * wn % P
    s0 = air.constant("S0", np.array([(7 * x) % P for x in xs], dtype=np.uint64))
    s1 = air.constant("S1", np.array(xs, dtype=np.uint64))
    air.connection([w0, w1], [s0, s1])

    rng = np.random.default_rng(seed)
    trace = np.zeros((n, 7), dtype=np.uint64)
    trace[0, 0] = 1
    trace[0, 1] = 1
    for i in range(1, n):
        trace[i, 0] = trace[i - 1, 1]
        trace[i, 1] = (int(trace[i - 1, 0]) + int(trace[i - 1, 1])) % P
    trace[:, 2] = rng.integers(0, n, n)
    perm = rng.permutation(n)
    trace[:, 4] = rng.integers(0, P, n, dtype=np.uint64)
    trace[:, 3] = trace[perm, 4]
    trace[:, 5] = rng.integers(0, P, n, dtype=np.uint64)
    trace[:, 6] = trace[:, 5]
    return air, trace


def smoke_const_values(air: AIR) -> np.ndarray:
    return np.stack(air.const_values, axis=1) if air.const_values else \
        np.zeros((air.n, 0), dtype=np.uint64)
