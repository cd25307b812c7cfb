"""The port's large-circuit path against the JAX package and against the
port's small-circuit path: the matrix forms of step 5, whole proofs with
steps 2-4 on the VM, and the host modules around the prover (checkpoint,
pil_importer, zkin).

Tolerance: none.  The VM path computes the same field elements as the
chunked path, so a proof of a trace is the same proof whichever path the
prover takes, and the JAX prover's golden proofs (tests/data/) hold both.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_build  # noqa: E402
from merlin_zkevm_prover_tpu.ops import goldilocks as jgl  # noqa: E402
from merlin_zkevm_prover_tpu.ops import goldilocks3 as jgl3  # noqa: E402
from merlin_zkevm_prover_tpu.stark import StarkProof as RefProof  # noqa: E402
from merlin_zkevm_prover_tpu.stark import checkpoint as jcheckpoint  # noqa: E402
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile  # noqa: E402
from merlin_zkevm_prover_tpu.stark import device_core as jcore  # noqa: E402
from merlin_zkevm_prover_tpu.stark import pil_importer as jpil  # noqa: E402
from merlin_zkevm_prover_tpu.stark import zkin as jzkin  # noqa: E402
from merlin_zkevm_prover_tpu_torch import convert  # noqa: E402
from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.models.wide import build_wide_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import goldilocks3 as gl3  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import (  # noqa: E402
    AIR,
    StarkInfo,
    StarkProof,
    StarkProver,
    compile_air,
    verify,
)
from merlin_zkevm_prover_tpu_torch.stark import checkpoint  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import device_core as core  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import pil_importer, zkin  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import prover as prover_mod  # noqa: E402
from test_torch_vm import high_degree_air  # noqa: E402

P = gl.P
CPU = "cpu"
N_BITS = 5
SETTINGS = dict(n_queries=6, final_bits=3, fri_fold_bits=2)
SEED = 42
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      f"torch_smoke_proof_nbits{N_BITS}.json")
PROOF_FIELDS = ("roots", "evals", "fri_roots", "final_pol", "queries_step0",
                "queries_fri", "publics")
LARGE_PATH = {"MERLIN_VM_MIN_NODES": "0", "MERLIN_STEP5_MATRIX_MIN": "0"}


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _prover(info, const_vals, env=None):
    """A CPU prover built with the two thresholds of `env` set (the large
    path at 0) and restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        return StarkProver(info, const_vals, device=CPU)


# ---------------------------------------------------------------------------
# Step 5 as weighted column sums
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step5_inputs():
    air, rair = build_smoke_air(n_bits=N_BITS, seed=SEED)[0], \
        ref_build(n_bits=N_BITS, seed=SEED)[0]
    info, rinfo = compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS)
    n_ext = info.n_ext
    secs = {}
    for i, k in enumerate(("cm1", "cm2", "cm3")):
        secs[f"{k}_2ns"] = _rand((n_ext, info.section_widths[f"{k}_n"]), 20 + i)
    secs["cm4_2ns"] = _rand((n_ext, info.section_widths["cm4_2ns"]), 23)
    for m in secs.values():               # the edge words in the first rows
        m[:6] = np.resize(np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32,
                                    P - (1 << 32)], dtype=np.uint64),
                          (6, m.shape[1]))
    d = dict(secs=secs, const=_rand((n_ext, info.n_constants), 30),
             ch=_rand((8, 3), 31), pub=_rand((info.n_publics,), 32),
             x_2ns=gl.powers_np(gl.w(info.n_bits_ext), n_ext, start=gl.SHIFT),
             zi=_rand((n_ext,), 33), evals=_rand((len(info.ev_map), 3), 34),
             xi=[int(v) for v in _rand((3,), 35)])
    return info, rinfo, d


def _port_args(d):
    return ({k: gl.from_u64(v, CPU) for k, v in d["secs"].items()},
            gl.from_u64(d["const"], CPU))


def _ref_args(d):
    return ({k: jgl.from_u64(v) for k, v in d["secs"].items()},
            jgl.from_u64(d["const"]))


def test_step5_evals_matrix(step5_inputs):
    info, rinfo, d = step5_inputs
    secs, const = _port_args(d)
    xi = gl3.const(*d["xi"], device=CPU)
    got = gl3.to_u64(core.step5_evals_matrix(info, secs, const, xi))
    rsecs, rconst = _ref_args(d)
    # compiled once, as the reference prover runs it (7 s here against 34 s
    # op by op; step5_fri_matrix is the other way round)
    want = jgl3.to_u64(jax.jit(functools.partial(
        jcore.step5_evals_matrix, rinfo))(rsecs, rconst, jgl3.const(*d["xi"])))
    assert got.shape == (len(info.ev_map), 3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, gl3.to_u64(core.step5_evals(info, secs, const, xi)))
    # k_chunk bounds only the width of a gathered block
    assert np.array_equal(got, gl3.to_u64(core.step5_evals_matrix(
        info, secs, const, xi, k_chunk=2)))


def test_step5_fri_matrix(step5_inputs):
    info, rinfo, d = step5_inputs
    secs, const = _port_args(d)
    args = (gl3.from_u64(d["ch"], CPU), gl.from_u64(d["pub"], CPU),
            gl.from_u64(d["x_2ns"], CPU), gl.from_u64(d["zi"], CPU),
            gl3.from_u64(d["evals"], CPU), gl3.const(*d["xi"], device=CPU))
    got = gl3.to_u64(core.step5_fri_matrix(info, secs, const, *args))
    rsecs, rconst = _ref_args(d)
    want = jgl3.to_u64(jcore.step5_fri_matrix(
        rinfo, rsecs, rconst, jgl3.from_u64(d["ch"]), jgl.from_u64(d["pub"]),
        jgl.from_u64(d["x_2ns"]), jgl.from_u64(d["zi"]),
        jgl3.from_u64(d["evals"]), jgl3.const(*d["xi"])))
    assert got.shape == (info.n_ext, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, gl3.to_u64(core.step5_fri_pol(info, secs, const,
                                                             *args)))
    assert np.array_equal(got, gl3.to_u64(core.step5_fri_matrix(
        info, secs, const, *args, k_chunk=1)))


# ---------------------------------------------------------------------------
# Whole proofs on the large path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vm_proof():
    golden = _golden()
    air, trace = build_smoke_air(n_bits=N_BITS, seed=golden["seed"])
    info = compile_air(air, **golden["compile_air"])
    prover = _prover(info, np.stack(air.const_values, axis=1), LARGE_PATH)
    return info, prover, trace, prover.prove(trace), golden


def test_large_path_was_taken(vm_proof):
    _, prover, _, _, _ = vm_proof
    assert prover._vm2 is not None and prover._vm3 is not None
    assert prover._vm4 is not None and prover._step5_matrix
    assert not hasattr(prover, "_step4_spans")


def test_default_path_without_the_settings(vm_proof, monkeypatch):
    info, _, _, _, golden = vm_proof
    for k in LARGE_PATH:
        monkeypatch.delenv(k, raising=False)
    air, _ = build_smoke_air(n_bits=N_BITS, seed=golden["seed"])
    prover = StarkProver(info, np.stack(air.const_values, axis=1), device=CPU)
    assert prover._vm2 is None and prover._vm3 is None and prover._vm4 is None
    assert not prover._step5_matrix and prover._step4_spans


@pytest.mark.parametrize("field", PROOF_FIELDS)
def test_large_path_proof_equals_golden(vm_proof, field):
    _, prover, _, proof, golden = vm_proof
    assert prover.const_tree.root() == golden["const_root"]
    ref = StarkProof.from_json(json.dumps(golden["proof"]))
    assert getattr(proof, field) == getattr(ref, field)


def test_large_path_proof_verifies(vm_proof):
    info, prover, _, proof, _ = vm_proof
    assert verify(info, prover.const_tree.root(), proof)


def test_high_degree_vm_proof_equals_chunked_proof():
    """Step 3's nested ims read earlier ims: the ordered VM program and the
    chunked evaluator (with pending values) give the same proof."""
    air, trace = high_degree_air(AIR)
    info = compile_air(air, **SETTINGS)
    const = np.zeros((air.n, 0), dtype=np.uint64)
    vm_prover = _prover(info, const, LARGE_PATH)
    assert vm_prover._vm3 is not None and vm_prover._vm4 is not None
    assert vm_prover._vm2 is None          # no plookup: an empty step 2
    chunked = _prover(info, const, {"MERLIN_VM_MIN_NODES": "1000000",
                                    "MERLIN_STEP5_MATRIX_MIN": "1000000"})
    assert chunked._vm3 is None and not chunked._step5_matrix
    a, b = vm_prover.prove(trace), chunked.prove(trace)
    assert a.to_json() == b.to_json()
    assert verify(info, vm_prover.const_tree.root(), a)


def wide_air(n_bits=4, n_base=150, n_sums=40, terms=40, seed=9):
    """models/wide.py's circuit with its trace in python ints: 40 committed
    sums of 40 products each over 150 committed columns.  Step 4's program
    has some 3,400 expression nodes (> MERLIN_VM_MIN_NODES = 3000), the
    evaluation map 191 entries (> MERLIN_STEP5_MATRIX_MIN = 128); steps 2
    and 3 are empty."""
    air = AIR("wide", n_bits)
    rng = np.random.default_rng(seed)
    base = [air.committed(f"a{j}") for j in range(n_base)]
    sums = [air.committed(f"s{k}") for k in range(n_sums)]
    vals = rng.integers(0, P, (air.n, n_base), dtype=np.uint64)
    svals = np.zeros((air.n, n_sums), dtype=object)
    for k in range(n_sums):
        e = None
        for x, y in rng.integers(0, n_base, (terms, 2)):
            t = base[x] * base[y]
            e = t if e is None else e + t
            svals[:, k] += vals[:, x].astype(object) * vals[:, y].astype(object)
        air.constraint(sums[k] - e)
    return air, np.concatenate([vals, (svals % P).astype(np.uint64)], axis=1)


def test_build_wide_air_equals_python_ints():
    air, trace = build_wide_air(device="cpu")
    ref_air, ref_trace = wide_air()
    np.testing.assert_array_equal(trace, ref_trace)
    assert compile_air(air, **SETTINGS).step42ns == \
        compile_air(ref_air, **SETTINGS).step42ns


def test_wide_circuit_takes_the_large_path_by_default(monkeypatch):
    """No setting: the program sizes alone send step 4 to the VM and step 5
    to the matrix forms, as the zkEVM's circuit goes; the proof equals the
    small path's and verifies."""
    for k in LARGE_PATH:
        monkeypatch.delenv(k, raising=False)
    air, trace = build_wide_air(device="cpu")
    info = compile_air(air, **SETTINGS)
    const = np.zeros((air.n, 0), dtype=np.uint64)
    prover = StarkProver(info, const, device=CPU)
    assert prover._vm4 is not None and prover._step5_matrix
    assert len(prover._vm4.code) > 6000
    small = _prover(info, const, {"MERLIN_VM_MIN_NODES": "1000000",
                                  "MERLIN_STEP5_MATRIX_MIN": "1000000"})
    assert small._vm4 is None and not small._step5_matrix
    a, b = prover.prove(trace), small.prove(trace)
    assert a.to_json() == b.to_json()
    assert verify(info, prover.const_tree.root(), a)


@pytest.mark.parametrize("device,want", [
    ("cpu", {"MERLIN_VM_MIN_NODES": 3000, "MERLIN_STEP5_MATRIX_MIN": 128}),
    ("cuda", {"MERLIN_VM_MIN_NODES": 0, "MERLIN_STEP5_MATRIX_MIN": 0}),
])
def test_route_thresholds_by_device_and_environment(monkeypatch, device,
                                                    want):
    """The CPU keeps the reference's thresholds, the card takes the
    large-circuit path always; either name in the environment wins."""
    for k in LARGE_PATH:
        monkeypatch.delenv(k, raising=False)
    assert prover_mod.route_thresholds(torch.device(device)) == want
    monkeypatch.setenv("MERLIN_VM_MIN_NODES", "7")
    assert prover_mod.route_thresholds(torch.device(device)) == \
        {**want, "MERLIN_VM_MIN_NODES": 7}


@pytest.mark.parametrize("rows,cols", [(1 << 17, 42), (1 << 18, 21),
                                       (1 << 21, 2), (1 << 22, 1),
                                       (1 << 24, 1)])
def test_step5_block_cols_fit_the_budget(rows, cols):
    assert core.step5_block_cols(rows) == cols
    live = core.STEP5_LIVE_BLOCKS * rows * 8
    assert cols == 1 or cols * live <= core.STEP5_BLOCK_BYTES < (cols + 1) * live


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_gives_the_direct_proof(vm_proof, tmp_path):
    _, prover, trace, proof, _ = vm_proof
    path = str(tmp_path / "ckpt.npz")
    publics = np.array(proof.publics, dtype=np.uint64)
    checkpoint.save_commit_trace(path, trace, publics)
    assert checkpoint.prove_from_checkpoint(prover, path).to_json() == \
        proof.to_json()


@pytest.mark.parametrize("with_publics", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_packages(tmp_path, writer, with_publics):
    trace = _rand((32, 7), 50)
    publics = _rand((3,), 51) if with_publics else None
    path = str(tmp_path / "ckpt.npz")
    save, load = ((jcheckpoint.save_commit_trace, checkpoint.load_commit_trace)
                  if writer == "jax" else
                  (checkpoint.save_commit_trace, jcheckpoint.load_commit_trace))
    save(path, trace, publics)
    t, p = load(path)
    assert t.dtype == np.uint64 and np.array_equal(t, trace)
    if with_publics:
        assert p.dtype == np.uint64 and np.array_equal(p, publics)
    else:
        assert p is None


# ---------------------------------------------------------------------------
# pil_importer
# ---------------------------------------------------------------------------


def _cm(i, nxt=False):
    return {"op": "cm", "id": i, "next": nxt}


def _const(i, nxt=False):
    return {"op": "const", "id": i, "next": nxt}


def _small_pil():
    """A compiled-PIL (pilcom JSON) dict: three committed and three
    constant polynomials, a polIdentity (with hex and decimal numbers, an
    exp reference with next, neg and a public), a plookup with selectors, a
    permutation, a connection and two publics (the last at the last row)."""
    deg = 16
    refs = {
        "Main.a": {"type": "cmP", "id": 0, "polDeg": deg},
        "Main.bc": {"type": "cmP", "id": 1, "polDeg": deg, "isArray": True,
                    "len": 2},
        "Main.L1": {"type": "constP", "id": 0, "polDeg": deg},
        "Main.S": {"type": "constP", "id": 1, "polDeg": deg, "isArray": True,
                   "len": 2},
    }
    expressions = [
        # 0: a + b
        {"op": "add", "values": [_cm(0), _cm(1)]},
        # 1: (1 - L1) * (a' - exp0)
        {"op": "mul", "values": [
            {"op": "sub", "values": [{"op": "number", "value": "1"},
                                     _const(0)]},
            {"op": "sub", "values": [_cm(0, True), {"op": "exp", "id": 0}]}]},
        # 2: L1 * (c - 0x10 * public0) + -(exp0' - exp0')
        {"op": "add", "values": [
            {"op": "mul", "values": [_const(0), {"op": "sub", "values": [
                _cm(2), {"op": "mul", "values": [
                    {"op": "number", "value": "0x10"},
                    {"op": "public", "id": 0}]}]}]},
            {"op": "neg", "values": [{"op": "sub", "values": [
                {"op": "exp", "id": 0, "next": True},
                {"op": "exp", "id": 0, "next": True}]}]}]},
        _cm(0), _cm(1), _cm(2), _const(1), _const(2),
        # 8: a * b
        {"op": "mul", "values": [_cm(0), _cm(1)]},
    ]
    return {
        "nCommitments": 3, "nConstants": 3, "references": refs,
        "expressions": expressions,
        "polIdentities": [{"e": 1}, {"e": 2}],
        "plookupIdentities": [{"f": [3], "t": [5], "selF": 6, "selT": None}],
        "permutationIdentities": [{"f": [3, 4], "t": [4, 3], "selF": None,
                                   "selT": None}],
        "connectionIdentities": [{"pols": [3, 4], "connections": [6, 7]}],
        "publics": [
            {"polType": "cmP", "polId": 2, "idx": 0, "id": 0, "name": "p0"},
            {"polType": "cmP", "polId": 0, "idx": deg - 1, "id": 1,
             "name": "p1"},
        ],
    }


@pytest.fixture(scope="module", params=[None, 3])
def imported(request):
    """The same PIL through both packages, at its declared degree and on a
    reduced domain (n_bits 3)."""
    pil = _small_pil()
    air = pil_importer.import_pil(pil, name="small", n_bits=request.param)
    rair = jpil.import_pil(pil, name="small", n_bits=request.param)
    return air, rair, compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS)


def test_import_pil_air_equals_reference(imported):
    air, rair, _, _ = imported
    assert air.n_bits == rair.n_bits
    assert air.cm_names == rair.cm_names == ["Main.a", "Main.bc[0]",
                                             "Main.bc[1]"]
    assert air.const_names == rair.const_names
    assert air.publics == rair.publics
    assert (len(air.lookups), len(air.permutations), len(air.connections)) \
        == (1, 1, 1)


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(StarkInfo)])
def test_import_pil_stark_info_equals_reference(imported, field):
    _, _, info, rinfo = imported
    carried = convert.stark_info_from_fields(convert.info_fields_of(rinfo))
    assert getattr(info, field) == getattr(carried, field)


def _num(v):
    return {"op": "number", "value": str(v)}


def _sum(terms):
    e = terms[0]
    for t in terms[1:]:
        e = {"op": "add", "values": [e, t]}
    return e


def _jmpn_pil():
    """A compiled-PIL dict with the JMPN decomposition identity of the
    zkEVM's main.pil at a declared degree of 2^4: isNeg * 2^13 + op0 =
    sum(bit_j * 2^(4 + j)) + lJmpnCondValue, beside an identity with the
    same powers of two that does not read lJmpnCondValue."""
    deg = 16
    refs = {
        "Main.op0": {"type": "cmP", "id": 0, "polDeg": deg},
        "Main.isNeg": {"type": "cmP", "id": 1, "polDeg": deg},
        "Main.bits": {"type": "cmP", "id": 2, "polDeg": deg, "isArray": True,
                      "len": 3},
        "Main.lJmpnCondValue": {"type": "cmP", "id": 5, "polDeg": deg},
        "Global.L1": {"type": "constP", "id": 0, "polDeg": deg},
    }
    decomposition = {"op": "sub", "values": [
        _sum([{"op": "mul", "values": [_cm(1), _num(1 << 13)]}, _cm(0)]),
        _sum([{"op": "mul", "values": [_cm(2 + j), _num(1 << (4 + j))]}
              for j in range(3)] + [_cm(5)])]}
    other = {"op": "mul", "values": [_const(0), {"op": "sub", "values": [
        _cm(0), {"op": "mul", "values": [_cm(2), _num(1 << 5)]}]}]}
    return {"nCommitments": 6, "nConstants": 1, "references": refs,
            "expressions": [decomposition, other],
            "polIdentities": [{"e": 0}, {"e": 1}], "publics": []}


@pytest.fixture(scope="module")
def imported_jmpn():
    """The JMPN PIL through both packages with reparam_jmpn, on a reduced
    domain (n_bits 3)."""
    pil = _jmpn_pil()
    air = pil_importer.import_pil(pil, name="jmpn", n_bits=3,
                                  reparam_jmpn=True)
    rair = jpil.import_pil(pil, name="jmpn", n_bits=3, reparam_jmpn=True)
    return air, compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS)


def _numbers(e, out):
    if e.kind == "number":
        out.add(e.value)
    for a in e.args:
        _numbers(a, out)
    return out


def test_import_pil_reparam_jmpn_rewrites_only_the_decomposition(
        imported_jmpn):
    air = imported_jmpn[0]
    decomposition, other = air.constraints
    assert {1 << 12, 1 << 3, 1 << 4, 1 << 5} <= _numbers(decomposition, set())
    assert not {1 << 13, 1 << 6} & _numbers(decomposition, set())
    assert 1 << 5 in _numbers(other, set())
    plain = pil_importer.import_pil(_jmpn_pil(), name="jmpn", n_bits=3)
    assert 1 << 13 in _numbers(plain.constraints[0], set())


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(StarkInfo)])
def test_import_pil_reparam_jmpn_stark_info_equals_reference(imported_jmpn,
                                                             field):
    _, info, rinfo = imported_jmpn
    carried = convert.stark_info_from_fields(convert.info_fields_of(rinfo))
    assert getattr(info, field) == getattr(carried, field)


# ---------------------------------------------------------------------------
# zkin
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_proofs():
    doc = _golden()["proof"]
    return StarkProof.from_json(json.dumps(doc)), RefProof.from_json(json.dumps(doc))


def test_proof_to_jproof_equals_reference(golden_proofs):
    proof, rproof = golden_proofs
    assert zkin.proof_to_jproof(proof) == jzkin.proof_to_jproof(rproof)


def test_jproof_to_proof_equals_reference(golden_proofs):
    proof, rproof = golden_proofs
    j = jzkin.proof_to_jproof(rproof)
    got = zkin.jproof_to_proof(j, name="smoke", publics=proof.publics)
    want = jzkin.jproof_to_proof(j, name="smoke", publics=rproof.publics)
    assert got.to_json() == want.to_json() == proof.to_json()


def test_proof2zkin_stark_equals_reference(golden_proofs):
    proof, rproof = golden_proofs
    assert zkin.proof2zkin_stark(zkin.proof_to_jproof(proof)) == \
        jzkin.proof2zkin_stark(jzkin.proof_to_jproof(rproof))


def test_joinzkin_and_files_equal_reference(golden_proofs, tmp_path):
    proof, _ = golden_proofs
    z = zkin.proof2zkin_stark(zkin.proof_to_jproof(proof))
    z1 = dict(z, publics=[str(i) for i in range(zkin.N_PUBLICS)])
    z2 = dict(z, publics=[str(100 + i) for i in range(zkin.N_PUBLICS)])
    vk = {"constRoot": [1, 2, 3, 4]}
    steps = len(proof.queries_fri) + 1
    got = zkin.joinzkin(z1, z2, vk, steps)
    assert got == jzkin.joinzkin(z1, z2, vk, steps)
    path = str(tmp_path / "zkin.json")
    zkin.dump_zkin(got, path)
    assert jzkin.load_zkin(path) == got == zkin.load_zkin(path)
