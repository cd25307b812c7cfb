"""The port's STARK slice as a whole, against golden proofs written by the
JAX prover.

Tolerance: none.  Goldilocks arithmetic is exact and Fiat-Shamir is
deterministic, so the port's proof of a trace must equal the reference's
proof of that trace in every field, word for word.

A JAX proof costs minutes to hours of XLA compilation on the CPU, so the
reference proofs are kept as files under ``tests/data/``, written by
``write_golden`` below, which runs the JAX prover only when asked:

    MERLIN_WRITE_GOLDEN=1 MERLIN_STEP_MAX_NODES=12 MERLIN_STEP5_MATRIX_MIN=0 \
        python tests/test_torch_stark_e2e.py 5 10 11 13

The two ``MERLIN_STEP*`` settings are the reference's own: they make its
prover evaluate the step programs in 12-node chunks and step 5 in the matrix
form, which compiles in minutes where the default route takes hours of CPU
time, and gives the same proof (the reference's tests/test_staged_prover.py
drives the same route).  The committed files were written that way.

Every run of this file then checks, with no JAX compile, that the port's
CPU proof equals each golden proof, that both verifiers accept, and that
tampered proofs and a bad witness are rejected.  ``chip_smoke.py`` reads the
same files to tie the GPU's result to the reference's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# n_bits -> compile_air settings (5: those of tests/test_stark_e2e.py; 10 and
# 11: the LDE's first pass runs block transforms of length 2, 4 and 8, the
# reference's v2 block kernel, on the 27-column cm3 section; 13: the
# smallest size whose two LDE lengths both split into block transforms of
# length 16 and more)
SETTINGS = {
    5: dict(n_queries=6, final_bits=3, fri_fold_bits=2),
    10: dict(n_queries=8),
    11: dict(n_queries=8),
    13: dict(n_queries=8),
}
SEED = 42
PROOF_FIELDS = ("roots", "evals", "fri_roots", "final_pol", "queries_step0",
                "queries_fri", "publics")


def golden_path(n_bits: int) -> str:
    return os.path.join(DATA, f"torch_smoke_proof_nbits{n_bits}.json")


def write_golden(n_bits: int) -> None:
    """Prove the smoke circuit with the JAX prover and save the proof."""
    if os.environ.get("MERLIN_WRITE_GOLDEN") != "1":
        raise RuntimeError("set MERLIN_WRITE_GOLDEN=1 to run the JAX prover")
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64 on)
    from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu.stark import StarkProver, compile_air, verify

    air, trace = build_smoke_air(n_bits=n_bits, seed=SEED)
    info = compile_air(air, **SETTINGS[n_bits])
    prover = StarkProver(info, np.stack(air.const_values, axis=1))
    proof = prover.prove(trace)
    assert verify(info, prover.const_tree.root(), proof)
    doc = {
        "writer": "merlin_zkevm_prover_tpu.stark.StarkProver (JAX, CPU)",
        "reference_env": {k: os.environ[k] for k in sorted(os.environ)
                          if k.startswith("MERLIN_STEP")},
        "circuit": "build_smoke_air", "n_bits": n_bits, "seed": SEED,
        "compile_air": SETTINGS[n_bits],
        "const_root": prover.const_tree.root(),
        "proof": json.loads(proof.to_json()),
    }
    os.makedirs(DATA, exist_ok=True)
    with open(golden_path(n_bits), "w") as f:
        json.dump(doc, f, separators=(",", ":"))


def load_golden(n_bits: int):
    with open(golden_path(n_bits)) as f:
        return json.load(f)


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        write_golden(int(arg))
    sys.exit(0)


from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import (  # noqa: E402
    StarkProof,
    StarkProver,
    VerifyError,
    compile_air,
    verify,
)


def _prove(n_bits: int, break_witness: bool = False):
    air, trace = build_smoke_air(n_bits=n_bits, seed=SEED)
    if break_witness:
        trace = trace.copy()
        trace[3, 0] = (int(trace[3, 0]) + 1) % P  # break a' = b at row 2
    info = compile_air(air, **SETTINGS[n_bits])
    prover = StarkProver(info, np.stack(air.const_values, axis=1), device="cpu")
    return info, prover, prover.prove(trace)


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def proven(request):
    n_bits = request.param
    info, prover, proof = _prove(n_bits)
    return n_bits, info, prover, proof, load_golden(n_bits)


def test_const_root_equals_golden(proven):
    _, _, prover, _, golden = proven
    assert prover.const_tree.root() == golden["const_root"]


@pytest.mark.parametrize("field", PROOF_FIELDS)
def test_proof_field_equals_golden(proven, field):
    """Exact equality (tolerance zero) of every proof field."""
    _, _, _, proof, golden = proven
    ref = StarkProof.from_json(json.dumps(golden["proof"]))
    assert getattr(proof, field) == getattr(ref, field)


def test_port_verifies_own_proof(proven):
    _, info, prover, proof, _ = proven
    assert verify(info, prover.const_tree.root(), proof)


def test_port_verifies_golden_proof(proven):
    _, info, _, _, golden = proven
    ref = StarkProof.from_json(json.dumps(golden["proof"]))
    assert verify(info, golden["const_root"], ref)


def test_reference_verifier_accepts_port_proof():
    """The JAX package's verifier is host python-int code (no XLA compile);
    it must accept the port's n_bits = 5 proof."""
    from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_build
    from merlin_zkevm_prover_tpu.stark import StarkProof as RefProof
    from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile
    from merlin_zkevm_prover_tpu.stark import verify as ref_verify

    _, prover, proof = _prove(5)
    air, _ = ref_build(n_bits=5, seed=SEED)
    info = ref_compile(air, **SETTINGS[5])
    assert ref_verify(info, prover.const_tree.root(),
                      RefProof.from_json(proof.to_json()))


def _tampered(proof, kind):
    bad = StarkProof.from_json(proof.to_json())
    if kind == "public":
        bad.publics[0] = (bad.publics[0] + 1) % P
    elif kind == "eval":
        bad.evals[0][0] = (bad.evals[0][0] + 1) % P
    elif kind == "query":
        v = bad.queries_step0[0]["cm1"].values
        v[0] = (v[0] + 1) % P
    return bad


@pytest.mark.parametrize("kind", ["public", "eval", "query"])
def test_tampered_proof_rejected(proven, kind):
    _, info, prover, proof, _ = proven
    with pytest.raises(VerifyError):
        verify(info, prover.const_tree.root(), _tampered(proof, kind))


def test_invalid_witness_rejected():
    """A trace violating the fibonacci transition cannot produce a valid
    proof: the quotient is not a polynomial, so some check fails."""
    info, prover, proof = _prove(5, break_witness=True)
    with pytest.raises(VerifyError):
        verify(info, prover.const_tree.root(), proof)
