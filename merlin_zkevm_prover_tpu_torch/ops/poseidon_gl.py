"""Poseidon permutation over Goldilocks (width 12), plain PyTorch and host forms.

Re-creates the capability of the reference `PoseidonGoldilocks` API:

  * ``permute(state)``        — the raw 30-round permutation, batched
  * ``linear_hash(rows)``     — sponge over arbitrary-width rows (rate 8,
                                capacity chained from the previous digest)
  * ``merkelize(source)``     — full Poseidon binary Merkle tree
  * ``permute_host(list12)``  — pure-python scalar permutation (transcript)

Round structure: each of the 30 rounds adds per-lane constants, applies x^7
to all lanes (full rounds: first 4 and last 4) or lane 0 only (22 partial
rounds), then multiplies by the circulant-plus-diagonal MDS matrix.

The tensor forms live in :mod:`.poseidon_cuda` and are re-exported here
under the reference's names (its ``poseidon_gl.permute`` and
``permute_tpu`` are one function here): ``permute``, ``linear_hash``,
``node_hash``, ``merkle_nodes`` and ``merkelize`` are the dispatching
wrappers (CUDA kernels for a tensor on the GPU, the plain versions for one
on the CPU).  This module adds the python-int host forms.
"""

from __future__ import annotations

from typing import List, Sequence

from .goldilocks import P
from .poseidon_constants import (
    CAPACITY,
    HASH_SIZE,
    MDS,
    N_PARTIAL_ROUNDS,
    RATE,
    ROUND_CONSTANTS,
    WIDTH,
)
from .poseidon_cuda import (  # noqa: F401  (re-exported)
    _HALF_F,
    N_ROUNDS,
    linear_hash,
    merkelize,
    merkle_nodes,
    node_hash,
    permute,
)


# ---------------------------------------------------------------------------
# Host (python-int) forms — used by the Fiat-Shamir transcript and the
# verifier, which are tiny and irreducibly sequential.
# ---------------------------------------------------------------------------


# mds_host(v): the MDS product of 12 python ints, reduced mod P, written out
# term by term (no loop: the verifier's Merkle paths and the recursion
# circuit's Poseidon witnesses spend most of their time here)
mds_host = eval("lambda v: [" + ", ".join(
    "(" + " + ".join(f"{MDS[x][y]} * v[{y}]" for y in range(WIDTH)) + f") % {P}"
    for x in range(WIDTH)) + "]")


def _pow7(x: int) -> int:
    x2 = x * x % P
    return x2 * x2 % P * x2 % P * x % P


def permute_host(state: Sequence[int]) -> List[int]:
    st = [s % P for s in state]
    for r in range(N_ROUNDS):
        st = [(st[s] + ROUND_CONSTANTS[r * WIDTH + s]) % P for s in range(WIDTH)]
        if r < _HALF_F or r >= _HALF_F + N_PARTIAL_ROUNDS:
            st = [_pow7(s) for s in st]
        else:
            st[0] = _pow7(st[0])
        st = mds_host(st)
    return st


def hash_host(inputs: Sequence[int]) -> List[int]:
    return permute_host(list(inputs))[:HASH_SIZE]


def linear_hash_host(values: Sequence[int]) -> List[int]:
    size = len(values)
    if size <= CAPACITY:
        return list(values) + [0] * (CAPACITY - size)
    digest = [0] * CAPACITY
    for off in range(0, size, RATE):
        chunk = list(values[off : off + RATE])
        chunk += [0] * (RATE - len(chunk))
        digest = permute_host(chunk + digest)[:CAPACITY]
    return digest
