"""The port's Poseidon-Goldilocks (plain PyTorch path on the CPU) against
the python-int host forms, the JAX plain path and the Pallas permutation and
row-sponge kernels in interpret mode; python-int models of the CUDA
permutation body (its linear layer and rounds, step for step, each
intermediate range-checked) against the dense MDS and permute_host; the
node-hash level plan.  All comparisons are exact (tolerance zero)."""

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


# ---------------------------------------------------------------------------
# Python-int models of the CUDA permutation body (csrc/poseidon_gl.cu), step
# for step, each intermediate checked against the C type that holds it.
# ---------------------------------------------------------------------------

M64 = (1 << 64) - 1
EPS = (1 << 32) - 1
HALF_EDGE = [0, 1, (1 << 32) - 1, 1 << 32, P - 1, P, P + 1, (1 << 64) - 1]


def _i64(v):
    """A word the kernel holds in a uint64_t as a two's-complement integer:
    the true intermediate must fit, so that wrapping mod 2^64 is exact."""
    assert -(1 << 63) <= v < (1 << 63), v
    return v


def _circ_half_model(x, k):
    """pg_circ_half: x[12] < 2^32 -> the circulant product, step for step."""
    assert all(0 <= v < 1 << 32 for v in x)
    S, T, D0, D1 = [0] * 3, [0] * 3, [0] * 3, [0] * 3
    for u in range(3):
        x0, x1, x2, x3 = (x[(4 * u + 9 * v) % 12] for v in range(4))
        a, b = _i64(x0 + x2), _i64(x1 + x3)
        S[u], T[u] = _i64(a + b), _i64(a - b)
        D0[u], D1[u] = _i64(x0 - x2), _i64(x1 - x3)
    ss = _i64(S[0] + S[1] + S[2])
    sh = [_i64(k["PG_KS"] * _i64(ss + S[(u + 2) % 3])) for u in range(3)]

    def f3(p):
        return _i64(p[0] + p[1] + p[2]), _i64(p[0] - p[2]), _i64(p[1] - p[2])

    def i3(dc, e0, e1):
        q2 = _i64(_i64(dc - e0) - e1)
        return [_i64(q2 + _i64(3 * e0)), _i64(q2 + _i64(3 * e1)), q2]

    def eis(a, b, c, d):
        return (_i64(_i64(c * a) - _i64(d * b)),
                _i64(_i64(d * a) + _i64((c - d) * b)))

    tdc, te0, te1 = f3(T)
    th = i3(_i64(k["PG_KT_DC"] * tdc), *eis(te0, te1, k["PG_KT_E0"], k["PG_KT_E1"]))
    adc, a0, a1 = f3(D0)
    bdc, b0, b1 = f3(D1)
    g0 = _i64(_i64(k["PG_KD_DC0"] * adc) - _i64(k["PG_KD_DC1"] * bdc))
    g1 = _i64(_i64(k["PG_KD_DC1"] * adc) + _i64(k["PG_KD_DC0"] * bdc))
    k0, k1 = (k["PG_KD_E00"], k["PG_KD_E01"]), (k["PG_KD_E10"], k["PG_KD_E11"])
    q00, q01 = eis(a0, a1, *k0)
    q11a, q11b = eis(b0, b1, *k1)
    q01a, q01b = eis(a0, a1, *k1)
    q10a, q10b = eis(b0, b1, *k0)
    d0h = i3(g0, _i64(q00 - q11a), _i64(q01 - q11b))
    d1h = i3(g1, _i64(q01a + q10a), _i64(q01b + q10b))
    y = [0] * 12
    for u in range(3):
        p_, m_ = _i64(sh[u] + th[u]), _i64(sh[u] - th[u])
        y[(4 * u) % 12] = _i64(p_ + d0h[u])
        y[(4 * u + 18) % 12] = _i64(p_ - d0h[u])
        y[(4 * u + 9) % 12] = _i64(m_ + d1h[u])
        y[(4 * u + 27) % 12] = _i64(m_ - d1h[u])
    assert all(0 <= v < 1 << 40 for v in y)
    return y


def _reduce96_model(lo, hi):
    """gl_reduce96_lazy: lo any word, hi < 2^32 -> a lazy word."""
    assert 0 <= lo <= M64 and 0 <= hi < 1 << 32
    t1 = (hi << 32) - hi
    s = lo + t1
    if s > M64:
        s = (s & M64) + EPS
        assert s <= M64                    # no second carry
    assert s % P == (lo + (hi << 64)) % P
    return s


def _fold_model(al, ah):
    """pg_fold: al, ah < 2^43 -> lazy al + 2^32 ah."""
    assert 0 <= al < 1 << 43 and 0 <= ah < 1 << 43
    l = al + ((ah << 32) & M64)
    carry = l > M64
    l &= M64
    h = (ah >> 32) + carry
    assert h < (1 << 11) + 1
    return _reduce96_model(l, h)


def _mds_rc_model(s, rc):
    """pg_mds_rc: s lazy, rc canonical -> lazy M s + rc."""
    k = poseidon_cuda.mds_block_constants()
    lo, hi = [v & EPS for v in s], [v >> 32 for v in s]
    ylo, yhi = _circ_half_model(lo, k), _circ_half_model(hi, k)
    ylo[0] += k["PG_MDS_DIAG0"] * lo[0]
    yhi[0] += k["PG_MDS_DIAG0"] * hi[0]
    return [_fold_model(ylo[i] + (rc[i] & EPS), yhi[i] + (rc[i] >> 32))
            for i in range(12)]


def _group_mds_rc_model(s, rc):
    """pg_group_mds_rc, lane by lane: lane i sums CIRC[d] x_{i+d} from the
    shuffled halves."""
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_constants import MDS_CIRC, MDS_DIAG
    out = []
    for i in range(12):
        al, ah = rc[i] & EPS, rc[i] >> 32
        for d in range(12):
            j = (i + d) % 12
            al += MDS_CIRC[d] * (s[j] & EPS)
            ah += MDS_CIRC[d] * (s[j] >> 32)
        if i == 0:
            al += MDS_DIAG[0] * (s[0] & EPS)
            ah += MDS_DIAG[0] * (s[0] >> 32)
        assert al <= M64 and ah <= M64
        out.append(_fold_model(al, ah))
    return out


def _mul_lazy_model(a, b):
    """gl_mul_lazy: a * b and __umul64hi, then gl_reduce128_lazy."""
    lo, hi = (a * b) & M64, (a * b) >> 64
    hh, hl = hi >> 32, hi & EPS
    t0 = lo - hh
    if t0 < 0:
        t0 = t0 + (1 << 64) - EPS
        assert 0 <= t0                     # no second borrow
    s = t0 + (hl << 32) - hl
    if s > M64:
        s = (s & M64) + EPS
        assert s <= M64
    assert s % P == a * b % P
    return s


def _pow7_model(a):
    a2 = _mul_lazy_model(a, a)
    a3 = _mul_lazy_model(a2, a)
    a4 = _mul_lazy_model(a2, a2)
    return _mul_lazy_model(a3, a4)


def _group_partial_round_model(s, rc):
    """pg_group_partial_round on every lane: row sums of the lanes before the
    S-box, then lane 0's change M[i][0] (x7_0 - x_0) added on the halves,
    wrapping mod 2^64."""
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_constants import MDS

    x7 = _pow7_model(s[0])
    dl, dh = (x7 & EPS) - (s[0] & EPS), (x7 >> 32) - (s[0] >> 32)
    assert -(1 << 32) < dl < 1 << 32 and -(1 << 32) < dh < 1 << 32
    out = []
    for i in range(12):
        al = sum(MDS[i][j] * (s[j] & EPS) for j in range(12)) + (rc[i] & EPS)
        ah = sum(MDS[i][j] * (s[j] >> 32) for j in range(12)) + (rc[i] >> 32)
        wl, wh = (al + MDS[i][0] * dl) & M64, (ah + MDS[i][0] * dh) & M64
        assert (wl, wh) == (al + MDS[i][0] * dl, ah + MDS[i][0] * dh)  # true sums
        out.append(_fold_model(wl, wh))
    return out


def _lazy_words(seed, n):
    rng = np.random.default_rng(seed)
    vecs = [[int(v) for v in rng.integers(0, 1 << 63, 12, dtype=np.uint64) * 2
             + rng.integers(0, 2, 12, dtype=np.uint64)] for _ in range(n)]
    vecs.append([(1 << 64) - 1] * 12)      # every half 2^32 - 1
    vecs.append([P + i for i in range(12)])  # words in [p, 2^64)
    vecs += [[HALF_EDGE[(i + j) % len(HALF_EDGE)] for i in range(12)]
             for j in range(len(HALF_EDGE))]
    return vecs


def test_mds_block_constants_match_kernel_source():
    """The constants compiled into poseidon_gl.cu are the ones derived from
    MDS_CIRC."""
    import re
    from pathlib import Path

    src = (Path(poseidon_cuda.__file__).parent.parent / "csrc"
           / "poseidon_gl.cu").read_text()
    got = {m.group(1): int(m.group(2).strip("()")) for m in re.finditer(
        r"#define (PG_K\w+|PG_MDS_DIAG0) (\(?-?\d+\)?)", src)}
    circ = re.search(r"PG_CIRC\[PG_WIDTH\] = \{([^}]*)\}", src).group(1)
    got["PG_CIRC"] = [int(v) for v in circ.split(",")]
    assert got == poseidon_cuda.mds_block_constants()


@pytest.mark.parametrize("form", ["frequency", "group"])
def test_linear_layer_model_matches_dense_mds(form):
    """(i) The kernel's linear layer, modelled step for step in python ints
    with every intermediate range-checked, equals the dense MDS product on
    random lazy words, on all-ones halves and on words in [p, 2^64)."""
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_constants import MDS

    model = _mds_rc_model if form == "frequency" else _group_mds_rc_model
    rc = pg.ROUND_CONSTANTS[12:24]
    for s in _lazy_words(11, 20):
        got = model(s, rc)
        want = [(sum(MDS[i][j] * s[j] for j in range(12)) + rc[i]) % P
                for i in range(12)]
        assert all(0 <= v <= M64 for v in got)
        assert [v % P for v in got] == want


@pytest.mark.parametrize("form", ["thread", "group"])
@pytest.mark.parametrize("full", [True, False])
def test_round_model_matches_permute_host(full, form):
    """(ii) One full or partial round with deferred canonicalisation (lazy
    words, the next round's constants folded into the linear layer), as one
    thread runs it and as a group of threads does (one lane each; a partial
    round corrects the row sums for lane 0's S-box), against the rounds of
    permute_host."""
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_constants import (
        MDS, ROUND_CONSTANTS)

    r = 2 if full else 10
    rc, rc_next = ROUND_CONSTANTS[12 * r:12 * r + 12], ROUND_CONSTANTS[12 * r + 12:12 * r + 24]
    for s in _lazy_words(12, 10):
        # host: round r on the canonical state
        st = [(v + rc[i]) % P for i, v in enumerate(s)]
        st = [pow(v, 7, P) for v in st] if full else [pow(st[0], 7, P)] + st[1:]
        want = [(sum(MDS[x][y] * st[y] for y in range(12)) + rc_next[x]) % P
                for x in range(12)]
        # kernel: s + RC[r] was folded into the previous linear layer, as
        # a lazy word: the largest word congruent to it
        lazy = [(v + c) % P + (P if (v + c) % P <= M64 - P else 0)
                for v, c in zip(s, rc)]
        if not full and form == "group":
            got = _group_partial_round_model(lazy, rc_next)
        else:
            lazy = ([_pow7_model(v) for v in lazy] if full
                    else [_pow7_model(lazy[0])] + lazy[1:])
            mds = _mds_rc_model if form == "thread" else _group_mds_rc_model
            got = mds(lazy, rc_next)
        assert all(0 <= v <= M64 for v in got)
        assert [v % P for v in got] == want


def test_add_lazy_model_and_canon():
    """gl_add_lazy (any word plus a canonical constant) and the final
    gl_canon on the edge words."""
    for a in HALF_EDGE + [(1 << 64) - 2]:
        for c in (0, 1, P - 1, P - (1 << 32)):
            s = a + c
            if s > M64:
                s = (s & M64) + EPS
            assert s <= M64 and s % P == (a + c) % P
            assert (s - P if s >= P else s) == (a + c) % P


def test_level_plan_covers_every_level_once():
    """(iii) For every power of two h from 2 to 2^18 the plan hashes each
    level exactly once, bottom-up, reading each level where the (2h-1, 4)
    layout puts it; "top" only at the end."""
    for k in range(1, 19):
        h = 1 << k
        plan = poseidon_cuda._level_plan(h)
        levels, want, off, n = [], [], 0, h
        while n > 1:
            want.append((off, n // 2))
            off += n
            n //= 2
        for idx, (kind, off, pairs) in enumerate(plan):
            if kind == "top":
                assert idx == len(plan) - 1
                assert pairs <= poseidon_cuda.TOP_MAX_PAIRS
                while pairs >= 1:
                    levels.append((off, pairs))
                    off += 2 * pairs
                    pairs //= 2
            else:
                assert kind == poseidon_cuda._node_kernel(pairs)
                assert pairs > poseidon_cuda.TOP_MAX_PAIRS
                levels.append((off, pairs))
        assert levels == want
    assert poseidon_cuda._level_plan(1) == []
