"""The port's Poseidon-Goldilocks (plain PyTorch path on the CPU) against
the python-int host forms, the JAX plain path and the Pallas permutation and
row-sponge kernels in interpret mode.  All comparisons are exact (tolerance
zero)."""

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

from merlin_zkevm_prover_tpu.ops import goldilocks as jgl
from merlin_zkevm_prover_tpu.ops import poseidon_gl as jpg
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
from merlin_zkevm_prover_tpu_torch.ops import poseidon_cuda
from merlin_zkevm_prover_tpu_torch.ops import poseidon_gl as pg
from merlin_zkevm_prover_tpu_torch.stark.merkle_tree import MerkleTreeGL

P = gl.P
CPU = "cpu"
EDGE = [0, 1, (1 << 32) - 1, 1 << 32, P - (1 << 32), P - 1]


def _ints(x):
    return [int(v) for v in x]


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    a.reshape(-1)[:len(EDGE)] = EDGE[:a.size]
    return a


def test_constants_match_reference():
    from merlin_zkevm_prover_tpu.ops import poseidon_constants as jc
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_constants as c

    assert c.ROUND_CONSTANTS == jc.ROUND_CONSTANTS and c.MDS == jc.MDS


def test_permute_matches_host_and_reference():
    st = _rand((12, 6), 1)
    got = gl.to_u64(pg.permute(gl.from_u64(st, CPU)))
    for i in range(6):
        assert _ints(got[:, i]) == pg.permute_host(_ints(st[:, i]))
    want = jgl.to_u64(jpg.permute(jgl.from_u64(st)))
    assert np.array_equal(got, want)
    plain = gl.to_u64(poseidon_cuda.permute_plain(gl.from_u64(st, CPU)))
    assert np.array_equal(plain, want)
    one = gl.to_u64(pg.permute(gl.from_u64(st[:, 0], CPU)))
    assert np.array_equal(one, got[:, 0])
    assert pg.permute_host(_ints(st[:, 2])) == jpg.permute_host(_ints(st[:, 2]))
    assert pg.hash_host(_ints(st[:, 3])) == jpg.hash_host(_ints(st[:, 3]))


def test_permute_takes_any_word():
    """Words in [p, 2^64) are read modulo p, as the kernel and the
    reference's permute_tpu read them; edge words in every lane."""
    st = _rand((12, 9), 3)
    for i in range(12):
        st[i, :8] = np.roll(np.array(EDGE + [P, (1 << 64) - 1], dtype=np.uint64), i)
    got = gl.to_u64(pg.permute(gl.from_u64(st, CPU)))
    for k in range(9):
        assert _ints(got[:, k]) == pg.permute_host(_ints(st[:, k]))


def test_permute_matches_pallas_kernel_interpret(monkeypatch):
    """The TPU permutation kernel (`_permute_kernel` through `permute_tpu`),
    run under the Pallas interpreter with the batch tile shrunk as the
    reference's own tests do, at B = 16 and at B = 130 (not a multiple of
    128).  Both batches pad to the same tiles, so the interpreter compiles
    once (about two minutes on a CPU) and runs twice."""
    from merlin_zkevm_prover_tpu.ops import poseidon_tpu as pt

    if not pt.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(pt, "R_SUB", 1)
    monkeypatch.setattr(pt, "BLOCK_B", 128)
    pt._permute_call.cache_clear()
    states, wants = [], []
    try:
        for batch in (16, 130):
            st = _rand((12, batch), 20 + batch)
            for i in range(12):
                st[i, :len(EDGE)] = np.roll(np.array(EDGE, dtype=np.uint64), i)
            states.append(st)
            wants.append(jgl.to_u64(pt.permute_tpu(jgl.from_u64(st),
                                                   interpret=True)))
    finally:
        pt._permute_call.cache_clear()
    for st, want in zip(states, wants):
        got = gl.to_u64(poseidon_cuda.permute(gl.from_u64(st, CPU)))
        assert np.array_equal(got, want)
        assert _ints(got[:, -1]) == pg.permute_host(_ints(st[:, -1]))


@pytest.mark.parametrize("width", [3, 4, 5, 8, 9, 21])
def test_linear_hash_matches_host(width):
    rows = _rand((7, width), width)
    got = gl.to_u64(pg.linear_hash(gl.from_u64(rows, CPU)))
    for i in range(7):
        assert _ints(got[i]) == pg.linear_hash_host(_ints(rows[i]))
    assert pg.linear_hash_host(_ints(rows[0])) == jpg.linear_hash_host(_ints(rows[0]))


@pytest.mark.parametrize("width", [3, 9, 21])
def test_linear_hash_matches_reference_plain_path(width):
    rows = _rand((7, width), 40 + width)
    got = gl.to_u64(pg.linear_hash(gl.from_u64(rows, CPU)))
    assert np.array_equal(got, jgl.to_u64(jpg.linear_hash(jgl.from_u64(rows))))


def test_linear_hash_matches_pallas_kernel_interpret(monkeypatch):
    """The TPU row-sponge kernel, run under the Pallas interpreter with the
    batch tile shrunk as the reference's own tests do."""
    from merlin_zkevm_prover_tpu.ops import poseidon_tpu as pt

    if not pt.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(pt, "R_SUB", 1)
    monkeypatch.setattr(pt, "BLOCK_B", 128)
    pt._linear_hash_call.cache_clear()
    try:
        rows = _rand((10, 21), 9)
        want = jgl.to_u64(pt.linear_hash_tpu(jgl.from_u64(rows), interpret=True))
    finally:
        pt._linear_hash_call.cache_clear()
    got = gl.to_u64(poseidon_cuda.linear_hash(gl.from_u64(rows, CPU)))
    assert np.array_equal(got, want)


def test_node_hash_matches_host_and_reference():
    l, r = _rand((5, 4), 2), _rand((5, 4), 3)
    got = gl.to_u64(pg.node_hash(gl.from_u64(l, CPU), gl.from_u64(r, CPU)))
    for i in range(5):
        assert _ints(got[i]) == pg.permute_host(_ints(l[i]) + _ints(r[i]) + [0] * 4)[:4]
    assert np.array_equal(
        got, jgl.to_u64(jpg.node_hash(jgl.from_u64(l), jgl.from_u64(r))))


def _host_tree(src):
    level = [pg.linear_hash_host(_ints(r)) for r in src]
    nodes = list(level)
    while len(level) > 1:
        level = [pg.permute_host(level[i] + level[i + 1] + [0] * 4)[:4]
                 for i in range(0, len(level), 2)]
        nodes += level
    return np.array(nodes, dtype=np.uint64)


@pytest.mark.parametrize("height", [1, 2, 4, 8, 16, 32, 64])
def test_merkelize_matches_host_tree(height):
    src = _rand((height, 5), height)
    got = gl.to_u64(pg.merkelize(gl.from_u64(src, CPU)))
    assert got.shape == (2 * height - 1, 4)
    assert np.array_equal(got, _host_tree(src))


@pytest.mark.parametrize("height", [2, 16])
def test_merkelize_matches_reference(height):
    src = _rand((height, 9), 70 + height)
    got = gl.to_u64(pg.merkelize(gl.from_u64(src, CPU)))
    assert np.array_equal(got, jgl.to_u64(jpg.merkelize(jgl.from_u64(src))))
    up = gl.to_u64(pg.merkle_nodes(gl.from_u64(got[:height], CPU)))
    assert np.array_equal(up, got[height:])


def test_merkle_tree_openings_verify():
    src = _rand((16, 6), 5)
    tree = MerkleTreeGL(gl.from_u64(src, CPU))
    tree.merkelize()
    root = tree.root()
    for (row, sib), idx in zip(tree.get_group_proofs([0, 7, 15]), [0, 7, 15]):
        assert np.array_equal(row, src[idx])
        assert MerkleTreeGL.verify_proof(root, idx, row, sib)
        assert not MerkleTreeGL.verify_proof(root, idx ^ 1, row, sib)
    row, sib = tree.get_group_proof(3)
    assert MerkleTreeGL.verify_proof(root, 3, row, sib)


def test_wrappers_reject_bad_operands():
    with pytest.raises(TypeError):
        poseidon_cuda.linear_hash(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.linear_hash(torch.zeros((8,), dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon_cuda.node_hash(torch.zeros((4, 4), dtype=torch.int64),
                                torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        poseidon_cuda.permute(torch.zeros((12, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.permute(torch.zeros((8, 3), dtype=torch.int64))
    assert poseidon_cuda.LAUNCHES == {"permute": 0, "linear_hash": 0,
                                      "node_hash": 0}
