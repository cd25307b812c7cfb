"""Fiat-Shamir transcript over Goldilocks (host-side, sequential).

Exact semantics of the reference `Transcript`
(src/starkpil/transcript/transcript.cpp:4-89, transcript.hpp:8-10):
pending buffer of 8 felts, 4-felt chained state, 12-felt output window from
one Poseidon permutation of [pending(8) | state(4)]; challenge squeezes
consume the window front-to-back; query-index derivation packs 63 bits per
squeezed felt, LSB first.

The transcript moves only 4-felt roots and small eval vectors, so it stays
on the host as python ints — the device round-trip per STARK stage is a few
hundred bytes.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import poseidon_gl
from ..ops.goldilocks import P

PENDING_SIZE = 8
OUT_SIZE = 12
STATE_SIZE = 4


class Transcript:
    def __init__(self):
        self.state = [0] * STATE_SIZE
        self.pending: List[int] = []
        self.out: List[int] = []
        self.out_cursor = 0

    def put(self, values: Sequence[int]) -> None:
        for v in values:
            self._add1(int(v) % P)

    def _squeeze(self) -> None:
        inputs = self.pending + [0] * (PENDING_SIZE - len(self.pending))
        inputs += self.state
        self.out = poseidon_gl.permute_host(inputs)
        self.out_cursor = OUT_SIZE
        self.pending = []
        self.state = self.out[:STATE_SIZE]

    def _add1(self, v: int) -> None:
        self.pending.append(v)
        self.out_cursor = 0
        if len(self.pending) == PENDING_SIZE:
            self._squeeze()

    def get_field(self) -> List[int]:
        """A GF(p^3) challenge: three sequential base-field squeezes."""
        return [self.get_fields1() for _ in range(3)]

    def get_fields1(self) -> int:
        if self.out_cursor == 0:
            self._squeeze()
        res = self.out[(OUT_SIZE - self.out_cursor) % OUT_SIZE]
        self.out_cursor -= 1
        return res

    def get_permutations(self, n: int, n_bits: int) -> List[int]:
        """n query indices of n_bits each, 63 usable bits per squeezed felt."""
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 63 + 1
        fields = [self.get_fields1() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                bit = (fields[cur_field] >> cur_bit) & 1
                if bit:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
