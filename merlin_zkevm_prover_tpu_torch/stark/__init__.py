"""STARK engine: AIR front-end, compiler, prover, FRI, verifier."""

from .air import AIR, Expr, challenge
from .compiler import StarkInfo, compile_air
from .merkle_tree import MerkleTreeGL
from .proof import StarkProof, TreeOpening
from .prover import StarkProver
from .transcript import Transcript
from .verifier import VerifyError, verify

__all__ = [
    "AIR",
    "Expr",
    "challenge",
    "StarkInfo",
    "compile_air",
    "MerkleTreeGL",
    "StarkProof",
    "TreeOpening",
    "StarkProver",
    "Transcript",
    "VerifyError",
    "verify",
]
