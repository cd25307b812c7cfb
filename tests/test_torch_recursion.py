"""The port's recursion chain (recursion/gates, plonk, verifier_circuit,
recursive) against the JAX package's.

Tolerance: none.  The recursion modules are python-int host code, and the
proofs are Goldilocks arithmetic with deterministic Fiat-Shamir, so every
comparison is exact equality of python ints and uint64 arrays.

The two proofs of this file are compared with golden files that the JAX
prover writes, since a JAX proof of a plonk12c circuit costs many minutes of
XLA compilation on the CPU:

    MERLIN_WRITE_GOLDEN=1 MERLIN_STEP_MAX_NODES=12 MERLIN_STEP5_MATRIX_MIN=0 \
        python tests/test_torch_recursion.py plonk12c recursive1

``plonk12c`` is the Poseidon-preimage circuit of the JAX package's
tests/test_recursion.py proven with ``n_queries=3, fri_fold_bits=2,
final_bits=4``; ``recursive1`` is a ``RecursiveStage("recursive1",
n_queries=2, final_bits=4, fri_fold_bits=3)`` over the golden ``n_bits = 5``
smoke proof of tests/data/torch_smoke_proof_nbits5.json (a 2^14-row
plonk12c STARK).  ``chip_smoke.py`` proves both on the card and holds them
against the same files.
"""

import copy
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
INNER_NBITS = 5  # the golden smoke proof the verifier circuit checks
INNER_SEED = 42
INNER_SETTINGS = dict(n_queries=6, final_bits=3, fri_fold_bits=2)
PLONK12C_SETTINGS = dict(n_queries=3, fri_fold_bits=2, final_bits=4)
RECURSIVE1_SETTINGS = dict(n_queries=2, final_bits=4, fri_fold_bits=3)
PROOF_FIELDS = ("roots", "evals", "fri_roots", "final_pol", "queries_step0",
                "queries_fri", "publics")


def golden_path(kind: str) -> str:
    return os.path.join(DATA, f"torch_{kind}_proof.json")


def preimage_circuit(Circuit):
    """The Poseidon-preimage circuit of tests/test_recursion.py: one
    permutation of 12 witnesses, four outputs exposed as publics."""
    c = Circuit()
    pre = [c.witness(i + 5) for i in range(12)]
    out = c.poseidon(pre)
    for j in range(4):
        c.expose(out[j])
    return c


def _inner_golden():
    with open(os.path.join(DATA, f"torch_smoke_proof_nbits{INNER_NBITS}.json")) as f:
        return json.load(f)


def write_golden(kind: str) -> None:
    """Prove with the JAX package on the CPU and save the proof."""
    if os.environ.get("MERLIN_WRITE_GOLDEN") != "1":
        raise RuntimeError("set MERLIN_WRITE_GOLDEN=1 to run the JAX prover")
    import tests.conftest  # noqa: F401  (JAX on the CPU, x64 on)
    from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu.recursion.gates import Circuit
    from merlin_zkevm_prover_tpu.recursion.plonk import circuit_to_air
    from merlin_zkevm_prover_tpu.recursion.recursive import RecursiveStage
    from merlin_zkevm_prover_tpu.stark import (StarkProof, StarkProver,
                                               compile_air, verify)

    t0 = time.time()
    if kind == "plonk12c":
        air, trace, lay = circuit_to_air(preimage_circuit(Circuit), "p12c_test")
        info = compile_air(air, **PLONK12C_SETTINGS)
        prover = StarkProver(info, np.stack(air.const_values, axis=1))
        proof = prover.prove(trace)
        const_root = prover.const_tree.root()
        assert verify(info, const_root, proof)
        settings = PLONK12C_SETTINGS
    elif kind == "recursive1":
        golden = _inner_golden()
        air, _ = build_smoke_air(n_bits=INNER_NBITS, seed=INNER_SEED)
        inner = (compile_air(air, **INNER_SETTINGS), golden["const_root"],
                 StarkProof.from_json(json.dumps(golden["proof"])))
        stage = RecursiveStage("recursive1", **RECURSIVE1_SETTINGS)
        proof = stage.prove([inner])
        const_root = stage.const_root()
        assert verify(stage.info, const_root, proof)
        lay = stage.lay
        settings = RECURSIVE1_SETTINGS
    else:
        raise ValueError(kind)
    doc = {
        "writer": "merlin_zkevm_prover_tpu.recursion (JAX, CPU)",
        "reference_env": {k: os.environ[k] for k in sorted(os.environ)
                          if k.startswith("MERLIN_STEP")},
        "circuit": kind, "compile_air": settings,
        "layout": [lay.n_bits, lay.n_pub_rows, lay.n_gate_rows, lay.n_pos_rows],
        "seconds": time.time() - t0,
        "const_root": const_root,
        "proof": json.loads(proof.to_json()),
    }
    os.makedirs(DATA, exist_ok=True)
    with open(golden_path(kind), "w") as f:
        json.dump(doc, f, separators=(",", ":"))


def load_golden(kind: str):
    with open(golden_path(kind)) as f:
        return json.load(f)


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        write_golden(arg)
    sys.exit(0)


import merlin_zkevm_prover_tpu.recursion.gates as ref_gates  # noqa: E402
import merlin_zkevm_prover_tpu.recursion.plonk as ref_plonk  # noqa: E402
import merlin_zkevm_prover_tpu.recursion.recursive as ref_recursive  # noqa: E402
from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_smoke  # noqa: E402
from merlin_zkevm_prover_tpu.stark import StarkProof as RefProof  # noqa: E402
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile  # noqa: E402
from merlin_zkevm_prover_tpu.stark import verify as ref_verify  # noqa: E402

from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion import gates, plonk  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion import recursive  # noqa: E402
from merlin_zkevm_prover_tpu_torch.recursion.recursive import (  # noqa: E402
    RecursiveStage,
    build_verifier_circuit,
)
from merlin_zkevm_prover_tpu_torch.utils.timer import TimerLog  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import (  # noqa: E402
    StarkProof,
    StarkProver,
    VerifyError,
    compile_air,
    verify,
)


def every_gate_circuit(Circuit):
    """A circuit that calls every gate builder of `Circuit` once or more."""
    c = Circuit()
    x = c.witness(P - 3)
    y = c.public_input(1 << 40)
    z = c.lc([(3, x), (5, y), (1, c.add(x, y))], k=7)
    w = c.affine(c.sub(z, y), P - 2, c.mul(x, y))
    w = c.mul_add(w, c.mul_const(x, 11), c.add_const(y, 13))
    c.assert_eq(c.expose(w), w)
    c.assert_zero(c.sub(w, w))
    bit = c.is_zero(c.sub(x, x))
    c.select(bit, x, y)
    c.inv(y)
    c.decompose_canonical_64(c.witness(P - 1))
    c.decompose_bits(c.const(0b1011), 4)
    a3 = (x, y, z)
    b3 = c.add3(a3, c.const3((2, 3, 4)))
    m3 = c.mul3(a3, c.inv3(b3))
    m3 = c.mul3_const(c.sub3(m3, a3), (P - 1, 9, 1 << 63))
    c.assert_eq3(c.select3(bit, m3, a3), m3)
    c.mul3_base(m3, w)
    c.poseidon([c.const(i) for i in range(12)])
    return c


CIRCUITS = {"preimage": preimage_circuit, "every_gate": every_gate_circuit}


def _gates(c):
    return [(g.ql, g.qr, g.qo, g.qm, g.qc, g.a, g.b, g.c) for g in c.gates]


def _blocks(c):
    return [(b.states, b.cubes) for b in c.pos_blocks]


def _same_circuit(port, ref):
    assert port.stats() == ref.stats()
    assert port.values == ref.values
    assert _gates(port) == _gates(ref)
    assert _blocks(port) == _blocks(ref)
    assert port.public_wires == ref.public_wires


def _same_layout(port, ref):
    assert (port.n_bits, port.n_pub_rows, port.n_gate_rows, port.n_pos_rows) \
        == (ref.n_bits, ref.n_pub_rows, ref.n_gate_rows, ref.n_pos_rows)


# ---------------------------------------------------------------------------
# (a) gates and the plonk12c lowering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuit_wires_and_stats_equal_reference(name):
    _same_circuit(CIRCUITS[name](gates.Circuit), CIRCUITS[name](ref_gates.Circuit))


def test_preimage_circuit_computes_poseidon():
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_gl import permute_host

    c = preimage_circuit(gates.Circuit)
    outs = [c.val(w) for w in c.pos_blocks[0].states[-1][:4]]
    assert outs == permute_host([i + 5 for i in range(12)])[:4]
    assert [c.val(w) for w in c.public_wires] == outs


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_plan_layout_equals_reference(name):
    port = CIRCUITS[name](gates.Circuit)
    ref = CIRCUITS[name](ref_gates.Circuit)
    _same_layout(plonk.plan_layout(port), ref_plonk.plan_layout(ref))
    _same_layout(plonk.plan_layout(port, 9), ref_plonk.plan_layout(ref, 9))


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuit_to_air_equals_reference(name):
    """Same trace, same constant columns, same compiled AIR."""
    air, trace, lay = plonk.circuit_to_air(CIRCUITS[name](gates.Circuit), name)
    r_air, r_trace, r_lay = ref_plonk.circuit_to_air(
        CIRCUITS[name](ref_gates.Circuit), name)
    _same_layout(lay, r_lay)
    assert trace.dtype == r_trace.dtype == np.uint64
    np.testing.assert_array_equal(trace, r_trace)
    assert air.cm_names == r_air.cm_names
    assert air.const_names == r_air.const_names
    assert air.publics == r_air.publics
    assert len(air.constraints) == len(r_air.constraints)
    assert len(air.connections) == len(r_air.connections) == 1
    for col, r_col in zip(air.const_values, r_air.const_values):
        np.testing.assert_array_equal(col, r_col)
    info = compile_air(air, **PLONK12C_SETTINGS)
    r_info = ref_compile(r_air, **PLONK12C_SETTINGS)
    for key in ("n_bits_ext", "fri_step_bits", "n_cm", "section_widths",
                "n_constants", "q_deg", "ev_map", "publics"):
        assert getattr(info, key) == getattr(r_info, key), key


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_fill_trace_equals_reference(name):
    port = CIRCUITS[name](gates.Circuit)
    ref = CIRCUITS[name](ref_gates.Circuit)
    lay = plonk.plan_layout(port, 8)
    got = plonk.fill_trace(port, lay)
    np.testing.assert_array_equal(got, ref_plonk.fill_trace(
        ref, ref_plonk.plan_layout(ref, 8)))
    # the refill path gives the trace circuit_to_air built
    _, trace, _ = plonk.circuit_to_air(port, name, 8)
    np.testing.assert_array_equal(got, trace)


# ---------------------------------------------------------------------------
# (b) the verifier circuit over the golden n_bits = 5 proof
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inner():
    """(port inner, reference inner): (info, const_root, proof) each."""
    golden = _inner_golden()
    air, _ = build_smoke_air(n_bits=INNER_NBITS, seed=INNER_SEED)
    r_air, _ = ref_smoke(n_bits=INNER_NBITS, seed=INNER_SEED)
    doc = json.dumps(golden["proof"])
    return ((compile_air(air, **INNER_SETTINGS), golden["const_root"],
             StarkProof.from_json(doc)),
            (ref_compile(r_air, **INNER_SETTINGS), golden["const_root"],
             RefProof.from_json(doc)))


@pytest.fixture(scope="module")
def verifier_circuits(inner):
    port, ref = inner
    return (build_verifier_circuit([port]),
            ref_recursive.build_verifier_circuit([ref]))


def test_verifier_circuit_equals_reference(verifier_circuits):
    port, ref = verifier_circuits
    _same_circuit(port, ref)
    assert port.stats()["poseidon_blocks"] > 20
    _same_layout(plonk.plan_layout(port), ref_plonk.plan_layout(ref))


def test_verifier_circuit_publics(inner, verifier_circuits):
    (_, const_root, proof), _ = inner
    port, _ = verifier_circuits
    assert [port.val(w) for w in port.public_wires] == \
        list(proof.publics) + list(const_root)


def test_verifier_circuit_trace_equals_reference(verifier_circuits):
    port, ref = verifier_circuits
    lay = plonk.plan_layout(port)
    np.testing.assert_array_equal(
        plonk.fill_trace(port, lay),
        ref_plonk.fill_trace(ref, ref_plonk.plan_layout(ref)))


def _tamper(proof, kind):
    bad = copy.deepcopy(proof)
    if kind == "eval":
        bad.evals[0][0] = (bad.evals[0][0] + 1) % P
    elif kind == "query":
        v = bad.queries_step0[0]["cm1"].values
        v[0] = (v[0] + 1) % P
    elif kind == "final_pol":
        bad.final_pol[0][0] = (bad.final_pol[0][0] + 1) % P
    return bad


@pytest.mark.parametrize("kind", ["eval", "query", "final_pol"])
def test_verifier_circuit_rejects_tampered_proof(inner, kind):
    """A changed proof fails while its witness is built."""
    (info, const_root, proof), _ = inner
    with pytest.raises(AssertionError):
        build_verifier_circuit([(info, const_root, _tamper(proof, kind))])


# ---------------------------------------------------------------------------
# (c) the plonk12c proof of the Poseidon-preimage circuit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plonk12c():
    air, trace, _ = plonk.circuit_to_air(preimage_circuit(gates.Circuit),
                                         "p12c_test")
    info = compile_air(air, **PLONK12C_SETTINGS)
    prover = StarkProver(info, np.stack(air.const_values, axis=1), device="cpu")
    return info, prover.const_tree.root(), prover.prove(trace)


def test_plonk12c_const_root_equals_golden(plonk12c):
    assert plonk12c[1] == load_golden("plonk12c")["const_root"]


@pytest.mark.parametrize("field", PROOF_FIELDS)
def test_plonk12c_proof_field_equals_golden(plonk12c, field):
    ref = StarkProof.from_json(json.dumps(load_golden("plonk12c")["proof"]))
    assert getattr(plonk12c[2], field) == getattr(ref, field)


def test_plonk12c_proof_verifies(plonk12c):
    info, const_root, proof = plonk12c
    assert verify(info, const_root, proof)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[0] = (bad.publics[0] + 1) % P
    with pytest.raises(VerifyError):
        verify(info, const_root, bad)


def test_reference_verifier_accepts_port_plonk12c_proof(plonk12c):
    _, const_root, proof = plonk12c
    r_air, _, _ = ref_plonk.circuit_to_air(preimage_circuit(ref_gates.Circuit),
                                           "p12c_test")
    assert ref_verify(ref_compile(r_air, **PLONK12C_SETTINGS), const_root,
                      RefProof.from_json(proof.to_json()))


# ---------------------------------------------------------------------------
# (d) recursive1 over the golden n_bits = 5 proof.  Its CPU proof takes about
# two minutes on one thread, so the proving cases are `slow`; chip_smoke.py
# makes the same comparison with the golden file on the card.
# ---------------------------------------------------------------------------


def test_recursive1_layout_equals_golden(verifier_circuits):
    """The stage's circuit lowers to the golden file's 2^14-row layout."""
    lay = plonk.plan_layout(verifier_circuits[0])
    assert lay.n_bits == 14
    assert [lay.n_bits, lay.n_pub_rows, lay.n_gate_rows, lay.n_pos_rows] == \
        load_golden("recursive1")["layout"]


class _TraceProver:
    """Stands in for StarkProver: keeps its arguments and returns the trace
    it is asked to prove, inside one span of the caller's timer."""

    def __init__(self, info, const_values, device=None):
        self.info, self.const_values, self.device = info, const_values, device

    def prove(self, trace, timer=None):
        with timer.span("STARK_STEP_1"):
            return trace


def test_recursive_stage_spans_and_refill(inner, verifier_circuits,
                                          monkeypatch):
    """RecursiveStage.prove times each host piece in the caller's timer,
    passes `device` to its prover, and on a second proof refills the
    witness into the first proof's layout: the same trace as the lowering's
    and as the JAX package's."""
    monkeypatch.setattr(recursive, "StarkProver", _TraceProver)
    stage = RecursiveStage("recursive1", device="cpu", **RECURSIVE1_SETTINGS)
    first, again = TimerLog(quiet=True), TimerLog(quiet=True)
    trace = stage.prove([inner[0]], timer=first)
    assert [k for k, _ in first.spans] == [
        "RECURSION_CIRCUIT", "RECURSION_LOWER", "RECURSION_COMPILE",
        "RECURSION_SETUP", "STARK_STEP_1"]
    assert stage.prover.device == "cpu"
    assert stage._circuit_stats == verifier_circuits[0].stats()
    _air, ref_trace, _lay = ref_plonk.circuit_to_air(
        verifier_circuits[1], "recursive1")
    assert np.array_equal(trace, ref_trace)
    prover = stage.prover
    assert np.array_equal(stage.prove([inner[0]], timer=again), trace)
    assert stage.prover is prover
    assert [k for k, _ in again.spans] == [
        "RECURSION_CIRCUIT", "RECURSION_REFILL", "STARK_STEP_1"]


@pytest.fixture(scope="module")
def recursive1(inner):
    stage = RecursiveStage("recursive1", device="cpu", **RECURSIVE1_SETTINGS)
    proof = stage.prove([inner[0]])
    return stage, proof


@pytest.mark.slow
def test_recursive1_const_root_equals_golden(recursive1):
    stage, _ = recursive1
    assert stage.lay.n_bits == 14
    assert stage.const_root() == load_golden("recursive1")["const_root"]


@pytest.mark.slow
@pytest.mark.parametrize("field", PROOF_FIELDS)
def test_recursive1_proof_field_equals_golden(recursive1, field):
    ref = StarkProof.from_json(json.dumps(load_golden("recursive1")["proof"]))
    assert getattr(recursive1[1], field) == getattr(ref, field)


@pytest.mark.slow
def test_recursive1_proof_verifies(recursive1):
    stage, proof = recursive1
    assert verify(stage.info, stage.const_root(), proof)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[-1] = (bad.publics[-1] + 1) % P
    with pytest.raises(VerifyError):
        verify(stage.info, stage.const_root(), bad)


@pytest.mark.slow
def test_recursive1_refill_gives_the_same_proof(inner, recursive1):
    """A second proof through the stage refills the witness only."""
    stage, proof = recursive1
    prover = stage.prover
    again = stage.prove([inner[0]])
    assert stage.prover is prover
    assert again.to_json() == proof.to_json()


@pytest.mark.slow
def test_recursive2_binds_both_children(recursive1):
    """recursive2 over two recursive1 proofs verifies; its publics are the
    children's publics, each followed by the recursive1 const root."""
    stage1, p1 = recursive1
    root1 = stage1.const_root()
    stage2 = RecursiveStage("recursive2", device="cpu", **RECURSIVE1_SETTINGS)
    p2 = stage2.prove([(stage1.info, root1, p1)] * 2)
    assert verify(stage2.info, stage2.const_root(), p2)
    assert p2.publics == (list(p1.publics) + root1) * 2
    p2.publics[0] = (p2.publics[0] + 1) % P
    with pytest.raises(VerifyError):
        verify(stage2.info, stage2.const_root(), p2)
