"""Final SNARK stage: Groth16 or fflonk over the recursiveF verifier R1CS.

Reference flow (prover.cpp:788-949): recursiveF STARK -> circom final
witness -> rapidsnark Groth16 (or fflonk).  Here: StarkProverBN128 proof ->
build_final_r1cs (recursion/final_circuit.py) -> snark/setup + groth16, or
snark/r1cs_to_plonk + fflonk.

The proving key depends only on the R1CS shape, which depends only on the
recursiveF StarkInfo — one setup serves every final proof.  The key and
the proof's FFTs and MSMs live on `device` (``None``: the GPU).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..snark import groth16
from ..snark.setup import setup
from ..stark.compiler import StarkInfo
from ..stark.proof import StarkProof
from ..utils.timer import TimerLog
from .final_circuit import build_final_r1cs


class FinalStage:
    """Reusable final-SNARK context for one recursiveF circuit shape.

    `protocol` selects the SNARK; the reference picks by the zkey's
    protocol ID (prover.cpp:59,887: 1 = groth16, 10 = fflonk).  With
    `keep_r1cs`, the last proof's R1CS and witness stay in ``r1cs``, and
    for fflonk each constraint's PLONK gates in ``plonk_gates``."""

    def __init__(self, info: StarkInfo, const_root_fr: int,
                 setup_seed: int = 1234, protocol: str = "groth16",
                 device=None, keep_r1cs: bool = False):
        assert protocol in ("groth16", "fflonk")
        self.info = info
        self.const_root_fr = int(const_root_fr)
        self.setup_seed = setup_seed
        self.protocol = protocol
        self.device = device
        self.keep_r1cs = keep_r1cs
        self.r1cs = None
        self.plonk_gates = None
        self.key = None
        self.toxic = None
        self.stats: Dict[str, int] = {}
        self.setup_spans: Dict[str, float] = {}   # Groth16 setup's pieces

    def _prove_fflonk(self, r1cs, witness, rand: Optional[bytes] = None,
                      timer: Optional[TimerLog] = None) -> Dict:
        """fflonk over `r1cs`: the PLONK form (span FINAL_PLONK), the key
        (FINAL_SETUP, first proof only), the proof (FINAL_PROVE) and its
        check (FINAL_VERIFY).  Raises ValueError before any of them when
        the PLONK form's 4n domain exceeds Fr's two-adicity."""
        from ..snark.fflonk import (check_domain, fflonk_prove, fflonk_setup,
                                    fflonk_verify)
        from ..snark.r1cs_to_plonk import (constraint_gates, domain_size,
                                           r1cs_to_plonk)

        tlog = timer or TimerLog("final", quiet=True)
        per = constraint_gates(r1cs)
        gates = r1cs.n_public + int(per.sum())
        n = domain_size(gates)
        self.stats.update(plonk_gates=gates, plonk_n=n)
        if self.keep_r1cs:
            self.plonk_gates = per
        check_domain(n)
        with tlog.span("FINAL_PLONK"):
            cs, av, bv, cv = r1cs_to_plonk(r1cs, witness)
        assert cs.n == n, "PLONK size differs from its count"
        if self.key is None:
            with tlog.span("FINAL_SETUP"):
                self.key = fflonk_setup(cs, seed=self.setup_seed,
                                        device=self.device)
        else:
            assert self.key.cs.n == n, "PLONK shape changed across proofs"
        # r1cs_to_plonk's lists run to n; rows n-2 and n-1 are the padding
        # it reserves for the prover's blinding, so the wires end at n-2 (the
        # JAX FinalStage passes them whole and fails fflonk_prove's length
        # assertion)
        with tlog.span("FINAL_PROVE"):
            proof = fflonk_prove(self.key, av[:n - 2], bv[:n - 2], cv[:n - 2],
                                 rand=rand)
        with tlog.span("FINAL_VERIFY"):
            assert fflonk_verify(self.key, proof), \
                "final fflonk proof fails verification"
        proof["verified"] = True
        return proof

    def prove(self, proof: StarkProof, r: Optional[int] = None,
              s: Optional[int] = None, rand: Optional[bytes] = None,
              timer: Optional[TimerLog] = None) -> Dict:
        """Returns the final SNARK proof dict, checked (``verified``):
        Groth16 {pi_a, pi_b, pi_c, publics} by the pairing, `r` and `s`
        fixing the blinding (drawn from `secrets` when None), spans
        FINAL_R1CS, FINAL_SETUP (first proof only), FINAL_PROVE and
        FINAL_PAIRING of `timer` (the setup's pieces in ``setup_spans``); fflonk {C1, C2, W1, W2, evals, publics},
        points as affine python ints, `rand` the blinding's seed bytes
        (``os.urandom`` when None), spans as ``_prove_fflonk``'s."""
        from ..snark.pairing import groth16_verify, make_vk

        tlog = timer or TimerLog("final", quiet=True)
        with tlog.span("FINAL_R1CS"):
            r1cs, witness = build_final_r1cs(self.info, self.const_root_fr,
                                             proof)
        self.stats = {"constraints": len(r1cs.a), "n_vars": r1cs.n_vars,
                      "n_public": r1cs.n_public}
        if self.keep_r1cs:
            self.r1cs = (r1cs, witness)
        if self.protocol == "fflonk":
            return self._prove_fflonk(r1cs, witness, rand=rand, timer=tlog)
        if self.key is None:
            pieces = TimerLog("final setup", quiet=True)
            with tlog.span("FINAL_SETUP"):
                self.key, self.toxic = setup(r1cs, seed=self.setup_seed,
                                             device=self.device, timer=pieces)
            self.setup_spans = pieces.as_dict()
        else:
            assert self.key.n_vars == r1cs.n_vars, \
                "R1CS shape changed across proofs"
        self.stats["domain_bits"] = self.key.domain_bits
        with tlog.span("FINAL_PROVE"):
            g16 = groth16.prove(self.key, witness, r=r, s=s)
        g16["publics"] = witness[1: r1cs.n_public + 1]
        # native pairing check (the reference CI's snarkjs-ffv role)
        with tlog.span("FINAL_PAIRING"):
            vk = make_vk(self.toxic, r1cs.n_public)
            assert groth16_verify(vk, g16), "final Groth16 proof fails pairing"
        g16["verified"] = True
        return g16
