"""Recursion orchestration: proof -> verifier circuit -> plonk12c proof.

Native equivalent of the reference chain
`zkEVM STARK -> c12a -> recursive1 -> recursive2` (reference
src/prover/prover.cpp:394-949, src/config/config.hpp:26-28):

  * `RecursiveStage([(info, const_root)])` — a reusable stage that proves
    "I verified one (or two) inner proofs" as a plonk12c STARK.  The inner
    publics and inner const roots become the outer proof's publics, so the
    chain is binding: the outer statement commits to *which* circuit was
    verified (the reference appends verkey constRoots to publics the same
    way, prover.cpp:747-781).
  * one inner proof  = c12a / recursive1 role (compress + normalize shape);
  * two inner proofs = recursive2 role (aggregate pair).

The first `prove` builds the proving context (compile + const tree); later
proofs with the same shape refill the witness only.  Each stage proves on
the GPU unless it is given ``device="cpu"``; the circuit build, the
lowering and the witness fill are host python.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..stark.compiler import StarkInfo, compile_air
from ..stark.proof import StarkProof
from ..stark.prover import StarkProver
from ..utils.timer import TimerLog
from .gates import Circuit
from .plonk import Layout, circuit_to_air, fill_trace, plan_layout
from .verifier_circuit import add_stark_verifier


def build_verifier_circuit(
    inners: List[Tuple[StarkInfo, List[int], StarkProof]]
) -> Circuit:
    """Circuit verifying each (info, const_root, proof); publics are
    [proof0.publics..., const_root0..., proof1.publics..., const_root1...].
    """
    c = Circuit()
    for info, const_root, proof in inners:
        pubs = [c.public_input(int(v)) for v in proof.publics]
        rootw = [c.public_input(int(v)) for v in const_root]
        add_stark_verifier(c, info, proof, pubs, rootw)
    return c


class RecursiveStage:
    """Reusable prover for one recursion stage shape."""

    def __init__(self, name: str, n_bits: Optional[int] = None,
                 n_queries: int = 8, fri_fold_bits: int = 2,
                 final_bits: Optional[int] = None, device=None):
        self.name = name
        self.n_bits = n_bits
        self.n_queries = n_queries
        self.fri_fold_bits = fri_fold_bits
        self.final_bits = final_bits
        self.device = device
        self.info: Optional[StarkInfo] = None
        self.prover: Optional[StarkProver] = None
        self.lay: Optional[Layout] = None
        self._circuit_stats: Optional[dict] = None   # of the last circuit

    def const_root(self) -> List[int]:
        assert self.prover is not None
        return self.prover.const_tree.root()

    def prove(self, inners: List[Tuple[StarkInfo, List[int], StarkProof]],
              timer: Optional[TimerLog] = None) -> StarkProof:
        """Prove the stage over `inners`.  `timer` gets a span for each host
        piece (RECURSION_CIRCUIT; RECURSION_LOWER, RECURSION_COMPILE and
        RECURSION_SETUP on the first proof, RECURSION_REFILL after it)
        beside the prover's own."""
        tlog = timer or TimerLog(f"recursion:{self.name}", quiet=True)
        with tlog.span("RECURSION_CIRCUIT"):
            c = build_verifier_circuit(inners)
        self._circuit_stats = c.stats()
        if self.prover is None:
            with tlog.span("RECURSION_LOWER"):
                air, trace, lay = circuit_to_air(c, self.name, self.n_bits)
            self.lay = lay
            with tlog.span("RECURSION_COMPILE"):
                self.info = compile_air(
                    air, n_queries=self.n_queries,
                    fri_fold_bits=self.fri_fold_bits,
                    final_bits=self.final_bits,
                )
            with tlog.span("RECURSION_SETUP"):
                const_values = (
                    np.stack(air.const_values, axis=1)
                    if air.const_values else np.zeros((air.n, 0), np.uint64)
                )
                self.prover = StarkProver(self.info, const_values,
                                          device=self.device)
        else:
            with tlog.span("RECURSION_REFILL"):
                lay2 = plan_layout(c, self.lay.n_bits)
                assert (lay2.n_pub_rows, lay2.n_gate_rows,
                        lay2.n_pos_rows) == \
                    (self.lay.n_pub_rows, self.lay.n_gate_rows,
                     self.lay.n_pos_rows), "circuit shape changed across proofs"
                trace = fill_trace(c, self.lay)
        return self.prover.prove(trace, timer=tlog)
