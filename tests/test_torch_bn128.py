"""The port's BN254 field, Poseidon-BN254, arity-16 tree, Fr transcript and
BN128-committed STARK (recursiveF) against the JAX package's.

Tolerance: none.  Every value is a field element, so every comparison is
exact equality of python ints.  The kernels' plain twins run here (the CPU);
chip_smoke.py holds the kernels against the same twins on the card.  The
JAX side is host python (ops/poseidon_bn254.py, stark/merkle_bn128.py, the
verifier) and the golden proof tests/data/torch_bn128_proof.json, which
tests/test_torch_snark.py's writer makes.
"""

import json
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

import merlin_zkevm_prover_tpu.ops.bn254_field as ref_bf  # noqa: E402
import merlin_zkevm_prover_tpu.ops.poseidon_bn254 as ref_pos  # noqa: E402
import merlin_zkevm_prover_tpu.stark.merkle_bn128 as ref_tree  # noqa: E402
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile  # noqa: E402
from merlin_zkevm_prover_tpu.stark import verify as ref_verify  # noqa: E402
from merlin_zkevm_prover_tpu.stark.proof import StarkProof as RefProof  # noqa: E402
from merlin_zkevm_prover_tpu.stark.prover_bn128 import (  # noqa: E402
    MerkleTreeBN128GL as RefTreeGL,
    TranscriptBN128Adapter as RefTranscript,
)
from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_smoke  # noqa: E402

from merlin_zkevm_prover_tpu_torch import convert  # noqa: E402
from merlin_zkevm_prover_tpu_torch.models.smoke import (  # noqa: E402
    build_smoke_air,
    smoke_const_values,
)
from merlin_zkevm_prover_tpu_torch.ops import bn254_field as bf  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import poseidon_bn254 as pos  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import poseidon_bn254_cuda as pbc  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P as GL_P  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import (  # noqa: E402
    MerkleTreeGL,
    StarkProof,
    StarkProver,
    VerifyError,
    compile_air,
    verify,
)
from merlin_zkevm_prover_tpu_torch.stark.merkle_bn128 import (  # noqa: E402
    MerkleTreeBN128,
    TranscriptBN128,
)
from merlin_zkevm_prover_tpu_torch.stark.prover_bn128 import (  # noqa: E402
    MerkleTreeBN128GL,
    StarkProverBN128,
    TranscriptBN128Adapter,
)
from merlin_zkevm_prover_tpu_torch.stark.transcript import Transcript  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
BN128_SETTINGS = dict(n_queries=2, final_bits=2, fri_fold_bits=1)
PROOF_FIELDS = ("roots", "evals", "fri_roots", "final_pol", "queries_step0",
                "queries_fri", "publics")
R = bf.R_MOD
Q = bf.Q
GL_EDGE = [0, 1, GL_P - 1, GL_P, (1 << 64) - 1, 1 << 63, (1 << 32) - 1]


def edge_ints(m):
    """0, 1, m - 1, m - 2, and 2^64 - 1 in each limb."""
    return [0, 1, m - 1, m - 2] + [((1 << 64) - 1) << (64 * i) for i in
                                   range(3)] + [((1 << 64) - 1) << 192]


def fr_tensor(vals):
    return bf.from_u64(bf.ints_to_limbs(vals), "cpu")


def gl_rows(h, w, seed):
    """(h, w) 64-bit words, the edge words rotated across the first rows."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 64, (h, w), dtype=np.uint64)
    for j in range(min(h, len(GL_EDGE))):
        rows[j] = np.resize(np.roll(np.array(GL_EDGE, dtype=np.uint64), j), w)
    return rows


# ---------------------------------------------------------------------------
# (a) the field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx", [bf.FQ, bf.FR], ids=["fq", "fr"])
def test_field_ops_match_python_ints(ctx):
    m = ctx.mod
    rnd = random.Random(7)
    vals = [v % m for v in edge_ints(m)] + [rnd.randrange(m) for _ in range(40)]
    other = vals[::-1]
    a, b = bf.from_int(ctx, vals, "cpu"), bf.from_int(ctx, other, "cpu")
    assert list(bf.to_int(ctx, a)) == vals
    assert list(bf.to_int(ctx, bf.mont_mul(ctx, a, b))) == \
        [x * y % m for x, y in zip(vals, other)]
    assert list(bf.to_int(ctx, bf.add(ctx, a, b))) == \
        [(x + y) % m for x, y in zip(vals, other)]
    assert list(bf.to_int(ctx, bf.sub(ctx, a, b))) == \
        [(x - y) % m for x, y in zip(vals, other)]
    assert list(bf.to_int(ctx, bf.neg(ctx, a))) == [(-x) % m for x in vals]
    assert list(bf.to_int(ctx, bf.inv(ctx, a[:6]))) == \
        [pow(x, m - 2, m) for x in vals[:6]]
    # every value is canonical: below m in each limb's reading
    assert all(v < m for v in bf.limbs_to_ints(bf.mont_mul(ctx, a, b)))


@pytest.mark.parametrize("ctx", [bf.FQ, bf.FR], ids=["fq", "fr"])
def test_to_mont_takes_any_256_bit_value(ctx):
    """mont_mul(a, b) for a anywhere in [0, 2^256) and canonical b (the
    leaf kernel's conversion of a packed row)."""
    m = ctx.mod
    big = [(1 << 256) - 1, m, m + 1, 5 * m + 3, 1 << 255]
    got = bf.limbs_to_ints(bf.from_mont(ctx, bf.to_mont(ctx, fr_tensor(big))))
    assert got == [v % m for v in big]


@pytest.mark.parametrize("ctx_name", ["FQ", "FR"])
def test_limb_regrouping_matches_reference(ctx_name):
    """The same Montgomery residues in both packages: the reference's
    from_int / to_int through convert's limb regrouping."""
    ref_ctx, ctx = getattr(ref_bf, ctx_name), getattr(bf, ctx_name)
    vals = [v % ctx.mod for v in edge_ints(ctx.mod)] + [123456789 ** 5]
    ref_limbs = np.asarray(ref_bf.from_int(ref_ctx, vals))
    port = convert.bn254_from_limbs16(ref_limbs)
    assert torch.equal(port, bf.from_int(ctx, vals, "cpu"))
    assert np.array_equal(convert.bn254_to_limbs16(port), ref_limbs)
    assert list(ref_bf.to_int(ref_ctx, jnp.asarray(
        convert.bn254_to_limbs16(port)))) == vals


def test_kernel_header_constants():
    """csrc/bn254.cuh's moduli, -m^-1 mod 2^64, R^2 and R mod m."""
    src = open(os.path.join(ROOT, "merlin_zkevm_prover_tpu_torch", "csrc",
                            "bn254.cuh")).read()
    for name, ctx in (("FqP", bf.FQ), ("FrP", bf.FR)):
        body = src[src.index(f"struct {name}"):]
        body = body[:body.index("};")]
        consts = dict(re.findall(r"(\w+) = (0x[0-9a-f]+)ull", body))

        def word4(prefix):
            return sum(int(consts[f"{prefix}{i}"], 16) << (64 * i)
                       for i in range(4))

        assert word4("M") == ctx.mod
        assert int(consts["NINV"], 16) == ctx.ninv64
        assert word4("R2_") == ctx.r2
        assert word4("ONE") == ctx.r


# ---------------------------------------------------------------------------
# (b) Poseidon-BN254 and the leaf / node twins of kernel B1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", range(2, 18))
def test_permute_t_twin_matches_reference(t):
    rnd = random.Random(t)
    states = [[rnd.randrange(R) for _ in range(t)],
              [(R - 1 - i) % R for i in range(t)],
              [edge_ints(R)[i % 8] % R for i in range(t)]]
    got = pbc.permute_plain(fr_tensor([v for s in states for v in s]
                                      ).reshape(3, t, 4))
    assert bf.limbs_to_ints(got.reshape(-1, 4)) == \
        [v for s in states for v in ref_pos.permute_t(s)]


def test_host_poseidon_matches_reference():
    """The port's host python copy (transcript, verifier, tree model)."""
    rnd = random.Random(3)
    st = [rnd.randrange(R) for _ in range(17)]
    assert pos.permute(st) == ref_pos.permute(st) == ref_pos.permute_t(st)
    for n in (0, 1, 15, 16, 17, 33, 35):
        vals = [rnd.randrange(R) for _ in range(n)]
        assert pos.linear_hash(vals) == ref_pos.linear_hash(vals)
        assert pos.hash16(vals[:16]) == ref_pos.hash16(vals[:16])


@pytest.mark.parametrize("w", [0, 1, 2, 3, 4, 5, 24, 47, 105])
def test_leaf_hash_twin_matches_reference(w):
    rows = gl_rows(9, w, w)
    got = bf.limbs_to_ints(pbc.leaf_hash(bf.from_u64(rows, "cpu")))
    assert got == [ref_tree.leaf_hash([int(v) for v in r]) for r in rows]


@pytest.mark.parametrize("w", [5, 6, 24, 45, 47, 48, 49, 50, 95, 105, 665])
def test_sponge_plan_matches_reference_leaf(w):
    """Kernel B1's launches for a width-w row (pbc.sponge_plan: the full
    chunks at t = 17, the last at its own t, the capacity carried), run in
    python ints, give the reference's leaf and read every element once."""
    for row in gl_rows(2, w, w):
        vals = [int(v) for v in row]
        els = [sum(v << (64 * i) for i, v in enumerate(vals[k:k + 3]))
               for k in range(0, w, 3)]
        cap, used = 0, 0
        for t, first, n_chunks in pbc.sponge_plan(w):
            assert first == used
            for c in range(n_chunks):
                chunk = els[first + c * (t - 1):first + (c + 1) * (t - 1)]
                assert len(chunk) == t - 1
                cap = pos.permute_t([cap] + chunk)[0]
                used += t - 1
        assert used == len(els)
        assert cap == ref_tree.leaf_hash(vals)


def test_mul64_products_recount():
    """The kernels' lazy schedule against a full CIOS product (36 64-bit
    products) for every product, width by width."""
    for t in range(2, 18):
        assert pbc.mul64_products(t) < 36 * pbc.mont_products(t)
    assert pbc.mul64_products(17) == 120768
    assert 36 * pbc.mont_products(17) == 186048


def test_node_hash_twin_matches_reference():
    rnd = random.Random(5)
    level = [v % R for v in edge_ints(R)] + [rnd.randrange(R) for _ in range(25)]
    got = bf.limbs_to_ints(pbc.node_hash(fr_tensor(level)))
    assert got == [ref_pos.hash16(level[i:i + 16]) for i in range(0, 33, 16)]


@pytest.fixture(scope="module")
def tree_case():
    """A tree of 290 rows of width 24: three levels, a ragged last group in
    each (290 = 18 x 16 + 2, 19 = 16 + 3)."""
    rows = gl_rows(290, 24, 11)
    port = MerkleTreeBN128GL(bf.from_u64(rows, "cpu"))
    port.merkelize()
    ref = ref_tree.MerkleTreeBN128([[int(v) for v in r] for r in rows])
    return rows, port, ref


def test_tree_twin_levels_and_root_match_reference(tree_case):
    _, port, ref = tree_case
    assert [bf.limbs_to_ints(lv) for lv in port._levels] == ref.levels
    assert port.root() == [ref.root()]


def test_tree_group_proofs_match_reference(tree_case):
    rows, port, ref = tree_case
    idxs = [0, 17, 287, 289]
    got = port.get_group_proofs(idxs)
    for idx, (row, groups) in zip(idxs, got):
        assert (row, groups) == ref.get_group_proof(idx)
        assert MerkleTreeBN128GL.verify_proof(port.root(), idx, row, groups)
        assert RefTreeGL.verify_proof(port.root(), idx, row, groups)
    assert port.get_group_proof(289) == ref.get_group_proof(289)
    # the last group of the leaf level pads with 0 past the end
    assert got[-1][1][0][2:] == [0] * 14
    row, groups = got[1]
    bad = list(row)
    bad[0] ^= 1
    assert not MerkleTreeBN128GL.verify_proof(port.root(), 17, bad, groups)


def test_transcript_matches_reference():
    """put / get_field / get_permutations, an index spanning two fields."""
    port, ref = TranscriptBN128Adapter(), RefTranscript()
    for t in (port, ref):
        t.put([11, 22, R + 5, (1 << 64) - 1])
    for _ in range(5):
        assert port.get_field() == ref.get_field()
    for t in (port, ref):
        t.put(list(range(40)))
    assert port.get_field_fr() == ref.get_field_fr()
    # 32 indices of 17 bits: 544 bits, three fields, indices across both cuts
    assert port.get_permutations(32, 17) == ref.get_permutations(32, 17)
    assert isinstance(TranscriptBN128(), TranscriptBN128)


# ---------------------------------------------------------------------------
# (c) the seam, and recursiveF at n_bits = 3 against the golden proof
# ---------------------------------------------------------------------------


def test_seam_defaults_are_the_goldilocks_scheme():
    assert StarkProver.tree_cls is MerkleTreeGL
    assert StarkProver.transcript_cls is Transcript
    assert StarkProverBN128.tree_cls is MerkleTreeBN128GL
    assert StarkProverBN128.transcript_cls is TranscriptBN128Adapter
    assert issubclass(StarkProverBN128, StarkProver)


def _golden():
    with open(os.path.join(DATA, "torch_bn128_proof.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def bn128_proof():
    g = _golden()
    air, trace = build_smoke_air(n_bits=g["n_bits"], seed=g["seed"])
    info = compile_air(air, **BN128_SETTINGS)
    prover = StarkProverBN128(info, smoke_const_values(air), device="cpu")
    return info, prover.const_tree.root(), prover.prove(trace)


def test_bn128_const_root_equals_golden(bn128_proof):
    assert bn128_proof[1] == _golden()["const_root"]


@pytest.mark.parametrize("field", PROOF_FIELDS)
def test_bn128_proof_field_equals_golden(bn128_proof, field):
    ref = StarkProof.from_json(json.dumps(_golden()["proof"]))
    assert getattr(bn128_proof[2], field) == getattr(ref, field)


def test_bn128_proof_verifies_and_a_tampered_one_is_rejected(bn128_proof):
    info, root, proof = bn128_proof
    kw = dict(tree_cls=MerkleTreeBN128GL, transcript_cls=TranscriptBN128Adapter)
    assert verify(info, root, proof, **kw)
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[0] = (bad.publics[0] + 1) % GL_P
    with pytest.raises(VerifyError):
        verify(info, root, bad, **kw)
    bad = StarkProof.from_json(proof.to_json())
    bad.queries_step0[0]["cm1"].values[0] ^= 1
    with pytest.raises(VerifyError):
        verify(info, root, bad, **kw)
    # the Goldilocks scheme does not accept it
    with pytest.raises(Exception):
        verify(info, root, proof)


def test_reference_verifier_accepts_the_port_bn128_proof(bn128_proof):
    _, root, proof = bn128_proof
    g = _golden()
    air, _ = ref_smoke(n_bits=g["n_bits"], seed=g["seed"])
    ref_info = ref_compile(air, **BN128_SETTINGS)
    ref_proof = RefProof.from_json(proof.to_json())
    kw = dict(tree_cls=RefTreeGL, transcript_cls=RefTranscript)
    assert ref_verify(ref_info, root, ref_proof, **kw)
    ref_proof.publics[0] = (ref_proof.publics[0] + 1) % GL_P
    with pytest.raises(Exception):
        ref_verify(ref_info, root, ref_proof, **kw)
