"""Coarse checkpoint/resume artifacts.

The reference has no mid-proof checkpointing (Fiat-Shamir sequencing);
its resume points are dumped executor traces re-proved by the
`zkProverTest` harness (reference prover.cpp:441-446 `zkevmCmPolsAfterExecutor`,
test/prover/main.cpp:7-40).  Same model here: save the stage-1 trace +
publics after execution, re-prove from the dump without the executor.
The ``.npz`` layout is the JAX package's, so a file written by either
package loads in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .proof import StarkProof
from .prover import StarkProver


def save_commit_trace(path: str, trace: np.ndarray,
                      publics: Optional[np.ndarray] = None) -> None:
    np.savez_compressed(
        path, trace=trace.astype(np.uint64),
        publics=(publics if publics is not None
                 else np.zeros(0, dtype=np.uint64)).astype(np.uint64),
    )


def load_commit_trace(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    data = np.load(path)
    pub = data["publics"]
    return data["trace"], (pub if pub.size else None)


def prove_from_checkpoint(prover: StarkProver, path: str) -> StarkProof:
    """Re-prove from a saved trace (the reference zkProverTest flow)."""
    trace, publics = load_commit_trace(path)
    return prover.prove(trace, publics)
