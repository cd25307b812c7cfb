"""Poseidon-Goldilocks Merkle tree over committed-polynomial matrices.

Mirrors the reference `MerkleTreeGL`: leaves are rows of `width` felts
hashed with the rate-8 sponge, internal nodes are
Poseidon([left4|right4|0^4])[:4], node storage is level-by-level bottom-up
with the root last, and query proofs walk sibling digests up the tree.

The build is a device computation (`poseidon_gl.merkelize`); the
(2h-1, 4) node array is fetched to the host once, and proof extraction is
host-side indexing over it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import poseidon_gl
from ..ops.goldilocks import GL

HASH_SIZE = 4


class MerkleTreeGL:
    """source: (height, width) carrier tensor.  nodes: (2*height - 1, 4)
    numpy uint64 on the host after merkelize."""

    def __init__(self, source: GL):
        self.source = source
        self.height, self.width = source.shape
        self._nodes_host = None

    def merkelize(self) -> None:
        # The node array is only ever read on the host (root absorption and
        # query sibling paths): fetch it once, keep no device copy.
        self._nodes_host = gl.to_u64(poseidon_gl.merkelize(self.source))

    def root(self) -> List[int]:
        assert self._nodes_host is not None
        return [int(v) for v in self._nodes_host[-1]]

    # ---- host-side query proofs (small; operate on fetched numpy) ----

    def _siblings(self, idx: int) -> List[List[int]]:
        nodes = self._nodes_host
        siblings = []
        offset = 0
        n = self.height
        i = idx
        while n > 1:
            sib = i ^ 1
            siblings.append([int(v) for v in nodes[offset + sib]])
            offset += n
            n //= 2
            i >>= 1
        return siblings

    def get_group_proofs(self, idxs: Sequence[int]
                         ) -> List[Tuple[np.ndarray, List[List[int]]]]:
        """(row values, sibling path) for every queried row; the rows of all
        queries come off the device in one fetch."""
        if len(idxs) == 0:
            return []
        sel = torch.as_tensor(list(idxs), dtype=torch.int64,
                              device=self.source.device)
        rows = gl.to_u64(self.source.index_select(0, sel))
        return [(rows[k], self._siblings(int(i))) for k, i in enumerate(idxs)]

    def get_group_proof(self, idx: int) -> Tuple[np.ndarray, List[List[int]]]:
        """Returns (row values (width,), sibling path [[4 felts], ...])."""
        return self.get_group_proofs([idx])[0]

    @staticmethod
    def verify_proof(root: List[int], idx: int, row_values, siblings) -> bool:
        leaf = poseidon_gl.linear_hash_host([int(v) for v in row_values])
        h = leaf
        i = idx
        for sib in siblings:
            if i & 1:
                h = poseidon_gl.permute_host(list(sib) + list(h) + [0, 0, 0, 0])[:4]
            else:
                h = poseidon_gl.permute_host(list(h) + list(sib) + [0, 0, 0, 0])[:4]
            i >>= 1
        return h == list(root)
