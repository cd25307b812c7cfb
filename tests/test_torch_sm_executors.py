"""The port's secondary state machines (executor/sm/) against the JAX
package's: the Arith, Binary, Memory and MemAlign columns (host numpy in
both) and the PoseidonG columns (kernel S1's plain version here,
``device="cpu"``).

Tolerance: none.  Every column compares word for word; a bad trace must
raise the same exception in both packages.
"""

import copy
import os
import random
import sys

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merlin_zkevm_prover_tpu.executor import sm as jax_sm  # noqa: E402
from merlin_zkevm_prover_tpu.executor.sm import \
    poseidon_g_executor as jax_pge  # noqa: E402
from merlin_zkevm_prover_tpu_torch.executor import sm  # noqa: E402
from merlin_zkevm_prover_tpu_torch.executor.sm import \
    poseidon_g_executor as pge  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.poseidon_gl import permute_host  # noqa: E402

M256 = (1 << 256) - 1
FPEC = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _columns(name, actions, n):
    """(port columns, JAX columns) of one SM on copies of the actions."""
    got = getattr(sm, name)().execute(copy.deepcopy(actions), n)
    want = getattr(jax_sm, name)().execute(copy.deepcopy(actions), n)
    return got, want


def _same_columns(name, actions, n):
    got, want = _columns(name, actions, n)
    assert list(got) == list(want)
    for col in want:
        assert got[col].dtype == want[col].dtype, col
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    return got


def _same_error(name, actions, n):
    errors = []
    for pkg in (sm, jax_sm):
        with pytest.raises(Exception) as e:
            getattr(pkg, name)().execute(copy.deepcopy(actions), n)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Binary
# ---------------------------------------------------------------------------


def _binary_actions(rng, count):
    ops = [lambda a, b: (a + b) & M256, lambda a, b: (a - b) & M256,
           lambda a, b: int(a < b),
           lambda a, b: int((a - (1 << 256) if a >> 255 else a)
                            < (b - (1 << 256) if b >> 255 else b)),
           lambda a, b: int(a == b), lambda a, b: a & b, lambda a, b: a | b,
           lambda a, b: a ^ b]
    acts = []
    for i in range(count):
        op = i % 8
        a = rng.choice([0, M256, rng.getrandbits(256), rng.getrandbits(64)])
        b = rng.choice([a, 1, M256, rng.getrandbits(256)])
        acts.append({"a": a, "b": b, "c": ops[op](a, b), "opcode": op})
    return acts


JAX_BINARY = [
    {"a": M256, "b": 5, "c": (M256 + 5) & M256, "opcode": 0},
    {"a": 3, "b": 5, "c": (3 - 5) & M256, "opcode": 1},
    {"a": 3, "b": 5, "c": 1, "opcode": 2},
    {"a": M256, "b": 1, "c": 1, "opcode": 3},
    {"a": 7, "b": 7, "c": 1, "opcode": 4},
    {"a": 0b1100, "b": 0b1010, "c": 0b1000, "opcode": 5},
    {"a": 0b1100, "b": 0b1010, "c": 0b1110, "opcode": 6},
    {"a": 0b1100, "b": 0b1010, "c": 0b0110, "opcode": 7},
]


def test_binary_columns_match_the_jax_package():
    _same_columns("BinaryExecutor", JAX_BINARY, 256)
    _same_columns("BinaryExecutor", _binary_actions(random.Random(1), 24), 512)
    _same_error("BinaryExecutor", [{"a": 1, "b": 1, "c": 3, "opcode": 0}], 64)
    _same_error("BinaryExecutor", [{"a": 1, "b": 1, "c": 2, "opcode": 9}], 64)
    _same_error("BinaryExecutor", JAX_BINARY, 64)          # overflow


# ---------------------------------------------------------------------------
# Arith
# ---------------------------------------------------------------------------


def _ec_add(p1, p2):
    (x1, y1), (x2, y2) = p1, p2
    s = (y2 - y1) * pow(x2 - x1, FPEC - 2, FPEC) % FPEC
    x3 = (s * s - x1 - x2) % FPEC
    return s, x3, (s * (x1 - x3) - y1) % FPEC


def _arith_actions(rng):
    acts = []
    for _ in range(3):
        x1, y1, x2 = (rng.getrandbits(256) for _ in range(3))
        prod = x1 * y1 + x2
        acts.append({"x1": x1, "y1": y1, "x2": x2, "y2": prod >> 256,
                     "y3": prod & M256, "eq": 0})
    s = 3 * GX * GX * pow(2 * GY, FPEC - 2, FPEC) % FPEC
    x3 = (s * s - 2 * GX) % FPEC
    acts.append({"x1": GX, "y1": GY, "x2": GX, "y2": GY, "x3": x3,
                 "y3": (s * (GX - x3) - GY) % FPEC, "eq": 2})
    g2 = (x3, acts[-1]["y3"])
    _, x3b, y3b = _ec_add((GX, GY), g2)
    acts.append({"x1": GX, "y1": GY, "x2": g2[0], "y2": g2[1], "x3": x3b,
                 "y3": y3b, "eq": 1})
    acts.append({"x1": 5, "y1": 7, "x2": 0, "y2": 0, "y3": 35,
                 "selEq0": 1, "selEq1": 0, "selEq2": 0, "selEq3": 0})
    return acts


def test_arith_columns_match_the_jax_package():
    acts = _arith_actions(random.Random(2))
    _same_columns("ArithExecutor", acts, 256)
    bad = dict(acts[0], y3=acts[0]["y3"] + 1)
    _same_error("ArithExecutor", [bad], 64)
    _same_error("ArithExecutor", [dict(acts[3], y3=acts[3]["y3"] + 1)], 64)
    _same_error("ArithExecutor", acts, 64)                  # overflow


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------


def _memory_accesses(rng, count, n):
    acc, cur = [], {}
    for step in range(count):
        addr = rng.choice([0, 1, 5, 17, 3 * n + 2, rng.randrange(9 * n, 12 * n)])
        if rng.random() < 0.5 or addr not in cur:
            cur[addr] = [rng.getrandbits(32) for _ in range(8)]
            acc.append({"addr": addr, "step": step, "wr": True,
                        "value": list(cur[addr])})
        else:
            acc.append({"addr": addr, "step": step, "wr": False,
                        "value": list(cur[addr])})
    rng.shuffle(acc)
    return acc


def test_memory_columns_match_the_jax_package():
    jax_case = [
        {"addr": 5, "step": 2, "wr": False, "value": [9] + [0] * 7},
        {"addr": 5, "step": 1, "wr": True, "value": [9] + [0] * 7},
        {"addr": 3, "step": 0, "wr": True, "value": [7] + [0] * 7},
    ]
    _same_columns("MemoryExecutor", jax_case, 16)
    _same_columns("MemoryExecutor", _memory_accesses(random.Random(3), 40, 64),
                  256)
    _same_error("MemoryExecutor",
                [{"addr": 1, "step": 0, "wr": False, "value": [1] + [0] * 7}],
                16)
    _same_error("MemoryExecutor", _memory_accesses(random.Random(4), 40, 64),
                16)                                         # overflow


# ---------------------------------------------------------------------------
# MemAlign
# ---------------------------------------------------------------------------


def _mem_align_actions(rng):
    acts = []
    for off in (0, 5, 31, rng.randrange(32)):
        m0, m1 = rng.getrandbits(256), rng.getrandbits(256)
        full = bytearray(m0.to_bytes(32, "big") + m1.to_bytes(32, "big"))
        acts.append({"m0": m0, "m1": m1, "offset": off,
                     "v": int.from_bytes(bytes(full[off:off + 32]), "big")})
        v = rng.getrandbits(256)
        w = bytearray(full)
        w[off:off + 32] = v.to_bytes(32, "big")
        acts.append({"m0": m0, "m1": m1, "offset": off, "v": v, "wr256": 1,
                     "w0": int.from_bytes(bytes(w[:32]), "big"),
                     "w1": int.from_bytes(bytes(w[32:]), "big")})
        b = rng.getrandbits(8)
        w = bytearray(full)
        w[off] = b
        acts.append({"m0": m0, "m1": m1, "offset": off, "v": b, "wr8": 1,
                     "w0": int.from_bytes(bytes(w[:32]), "big")})
    return acts


def test_mem_align_columns_match_the_jax_package():
    acts = _mem_align_actions(random.Random(5))
    _same_columns("MemAlignExecutor", acts, 512)
    for k in range(3):
        bad = dict(acts[k])
        bad["v" if k == 0 else "w0"] = bad.get("v" if k == 0 else "w0") + 1
        _same_error("MemAlignExecutor", [bad], 64)
    _same_error("MemAlignExecutor", acts, 64)               # overflow


# ---------------------------------------------------------------------------
# PoseidonG (S1's plain version)
# ---------------------------------------------------------------------------

N_PG = 31 * 8 + 5          # 8 slots and 5 dead rows


def _pg_inputs(rng, count):
    """States of 12, 16 and 17 words (every permutation id), edge words
    p and 2^64 - 1 in the first."""
    out = []
    for i in range(count):
        st = [int(v) for v in rng.integers(0, 1 << 64, 12, dtype=np.uint64)]
        if i == 0:
            st[:3] = [P, (1 << 64) - 1, P - 1]
        digest = permute_host(st)[:4]
        out.append([st, st + digest, st + digest + [1 + i % 4]][i % 3]
                   if i > 3 else st + digest + [1 + i])
    return out


def _same_pg(inputs, n):
    want = jax_pge.PoseidonGExecutor().execute(copy.deepcopy(inputs), n)
    got = pge.PoseidonGExecutor().execute(inputs, n, device="cpu")
    assert list(got) == list(want)
    for col in want:
        assert got[col].dtype == torch.int64 and got[col].shape == (n,)
        np.testing.assert_array_equal(gl.to_u64(got[col]), want[col],
                                      err_msg=col)
    return got


def test_poseidon_g_columns_match_the_jax_package():
    rng = np.random.default_rng(6)
    inputs = _pg_inputs(rng, 6)            # 6 filled slots, 2 padding slots
    got = _same_pg(inputs, N_PG)
    for pid, col in ((1, "result1"), (2, "result2"), (3, "result3")):
        assert int(got[col].sum()) >= 1, col
    # dead rows zero, the padding slots the zero state's trace
    assert all(int(got[c][31 * 8:].abs().sum()) == 0 for c in got)
    zero_trace = [[0] * 12]
    for r in range(30):
        zero_trace.append(pge._round(zero_trace[-1], r))
    for r in range(31):
        assert [int(gl.to_u64(got[c])[31 * 7 + r]) for c in
                pge.PoseidonGExecutor.STATE_COLS] == zero_trace[r]
    # every slot filled, none, and the array form
    _same_pg(_pg_inputs(rng, 8), N_PG)
    _same_pg([], N_PG)
    arr = np.array([x + permute_host(x)[:4] + [3] for x in
                    (inp[:12] for inp in _pg_inputs(rng, 5))], dtype=np.uint64)
    for width in (12, 16, 17):
        want = jax_pge.PoseidonGExecutor().execute(
            [[int(v) for v in row] for row in arr[:, :width]], N_PG)
        got = pge.PoseidonGExecutor().execute(arr[:, :width], N_PG,
                                              device="cpu")
        for col in want:
            np.testing.assert_array_equal(gl.to_u64(got[col]), want[col])


def test_poseidon_g_trace_plain_matches_round():
    """round_trace_plain's rows are _round's, the python-int rounds."""
    rng = np.random.default_rng(7)
    states = rng.integers(0, 1 << 64, (12, 3), dtype=np.uint64)
    states[0, 0] = P
    out = gl.to_u64(pge.round_trace(gl.from_u64(states, "cpu"), 31 * 3 + 2))
    for k in range(3):
        st = [int(v) % P for v in states[:, k]]
        for r in range(31):
            assert [int(v) for v in out[:12, 31 * k + r]] == st
            assert [int(v) for v in out[12:, 31 * k + r]] == \
                permute_host([int(v) for v in states[:, k]])[:4]
            if r < 30:
                st = pge._round(st, r)
    assert not out[:, 93:].any()
    assert pge.LAUNCHES == {"round_trace": 0}


def _pg_error(inputs, n=N_PG):
    errors = []
    for run in (lambda: jax_pge.PoseidonGExecutor().execute(
                    copy.deepcopy(inputs), n),
                lambda: pge.PoseidonGExecutor().execute(inputs, n,
                                                        device="cpu")):
        with pytest.raises(Exception) as e:
            run()
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    return errors[0][0]


def test_poseidon_g_raises_as_the_jax_package():
    rng = np.random.default_rng(8)
    good = _pg_inputs(rng, 5)
    # overflow: more inputs than n // 31 slots
    assert _pg_error(_pg_inputs(rng, 9)) is ValueError
    # a changed digest word
    bad = copy.deepcopy(good)
    bad[2][13] += 1
    assert _pg_error(bad) is ValueError
    # a digest word at p (compared raw: never equal to a canonical word)
    st = [1] * 12
    d = permute_host(st)[:4]
    assert _pg_error(good[:2] + [st + [d[0] + P] + d[1:]]) is ValueError
    assert _pg_error(good[:2] + [st + [P] + d[1:]]) is ValueError
    # an unknown permutation id; of two failing inputs the first decides
    assert _pg_error(good[:1] + [st + d + [5]]) is KeyError
    assert _pg_error(good[:1] + [st + d + [0]] + bad[2:3]) is KeyError
    assert _pg_error(good[:1] + bad[2:3] + [st + d + [7]]) is ValueError
    # the array form raises alike
    arr = np.array([st + d + [2], st + [d[0] ^ 1] + d[1:] + [2]],
                   dtype=np.uint64)
    with pytest.raises(ValueError):
        pge.PoseidonGExecutor().execute(arr, N_PG, device="cpu")
    with pytest.raises(ValueError):
        pge.PoseidonGExecutor().execute(np.zeros((2, 13), np.uint64), N_PG,
                                        device="cpu")


# ---------------------------------------------------------------------------
# S1's geometry: slot counts at the edges of a warp's runs, dead rows
# ---------------------------------------------------------------------------

EDGE_SLOTS = (1, 31, 32, 33, 65)
EDGE_DEAD = (0, 1, 30)


def _edge_inputs(slots):
    rng = np.random.default_rng(100 + slots)
    st = rng.integers(0, 1 << 64, (slots, 12), dtype=np.uint64)
    st[0, :3] = [P, (1 << 64) - 1, P - 1]
    return st


@pytest.mark.parametrize("dead", EDGE_DEAD)
@pytest.mark.parametrize("slots", EDGE_SLOTS)
def test_poseidon_g_edge_geometry_matches_the_jax_package(slots, dead):
    """Every slot filled, n = 31 S + dead (odd n among them): round_trace
    (S1's plain version here) and PoseidonGExecutor.execute against the
    JAX package's columns."""
    n = 31 * slots + dead
    st = _edge_inputs(slots)
    inputs = [[int(v) for v in row] for row in st]
    want = jax_pge.PoseidonGExecutor().execute(copy.deepcopy(inputs), n)
    trace = gl.to_u64(pge.round_trace(gl.from_u64(st.T.copy(), "cpu"), n))
    for i, col in enumerate(pge.PoseidonGExecutor.COLUMNS[:pge.TRACE_COLS]):
        np.testing.assert_array_equal(trace[i], want[col], err_msg=col)
    got = pge.PoseidonGExecutor().execute(inputs, n, device="cpu")
    for col in want:
        np.testing.assert_array_equal(gl.to_u64(got[col]), want[col],
                                      err_msg=col)
    assert not trace[:, 31 * slots:].any()


def _conflicts(words):
    """The most distinct 64-bit words of one half-warp's shared-memory
    access that fall in one bank pair (16 pairs of 4-byte banks)."""
    pairs = {}
    for w in set(words):
        pairs.setdefault(w % 16, set()).add(w)
    return max((len(v) for v in pairs.values()), default=1)


def _model_trace(trace, slots, n, run):
    """A python-int transcription of pg_trace_kernel's staging and stores,
    on the rows a slot computes (taken from the plain trace): each lane's
    run of slots, each row staged at ``pool_word``'s place after each step;
    the line of the half-warp's lane at row 15 (found by arithmetic, as the
    kernel finds it) and the general loop's lines; at each slot's end the
    digest lines of the loop over a half's lanes and of the general loop.
    Returns the output, the number of times each word was written and the
    worst bank conflict of a half-warp's pool writes and of a store's pool
    reads.  A read that finds another row in its pool entry (one
    overwritten while it waited) fails."""
    s_rows = 31 * slots
    tri = 16 * 17
    out = np.zeros((16, n), dtype=np.uint64)
    writes = np.zeros((16, n), dtype=np.int64)
    worst = 1
    pool = {}

    def put_line(half, at, dead, sl, e, store):
        """lane e of a half stores row `at`'s 12 state words"""
        for c in range(12):
            if dead:
                v = 0
            else:
                w = (c // 2) * tri + pge.pool_word(sl, e, c % 2)
                assert pool[half, w] == (c, at)
                store.setdefault(c, []).append(w)
                v = trace[c, at]
            out[c, at] = v
            writes[c, at] += 1

    def put_digest(at, h, v):
        out[12 + h, at] = v
        writes[12 + h, at] += 1

    rows = 31 * run
    inv = pow(rows % 16, 7, 16)
    for t0 in range(0, -(-slots // run), 32):
        lo = [(t0 + j) * rows for j in range(32)]
        hi = [max(lo[j], min(lo[j] + rows, s_rows)) for j in range(32)]
        dig = {}
        for i in range(run):
            base = [lo[j] + 31 * i for j in range(32)]
            live = [base[j] < hi[j] for j in range(32)]
            for r in range(31):
                tau = i * 31 + r
                f = [(base[j] + r) % 16 for j in range(32)]
                for c in range(12):
                    for half in (0, 16):
                        words = []
                        for j in range(half, half + 16):
                            if live[j]:
                                w = (c // 2) * tri + pge.pool_word(
                                    tau % (16 - f[j]), f[j], c % 2)
                                pool[half, w] = (c, base[j] + r)
                                words.append(w)
                        worst = max(worst, _conflicts(words))
                for half in (0, 16):
                    j15 = half + ((15 - tau - lo[half] % 16) * inv) % 16
                    if live[j15]:
                        assert f[j15] == 15
                    if tau >= 15 and lo[j15] + 31 * i < s_rows:
                        store = {}
                        for e in range(16):
                            put_line(half, lo[j15] + tau - 15 + e, False,
                                     (tau + 1) % (16 - e), e, store)
                        worst = max([worst] + [_conflicts(w) for w in store.values()])
                    for src in range(half, half + 16):
                        if not (live[src] and (tau < 15 if f[src] == 15 else
                                               base[src] + r + 1 == hi[src])):
                            continue
                        src_row = lo[src] + tau
                        fs = src_row % 16
                        store = {}
                        for e in range(16):
                            at = src_row - fs + e
                            if at < lo[src] or at >= n or hi[src] <= at < s_rows:
                                continue
                            dead = at >= hi[src]
                            put_line(half, at, dead,
                                     0 if dead else (tau - fs + e) % (16 - e), e,
                                     store)
                        worst = max([worst] + [_conflicts(w) for w in store.values()])
            for j in range(32):
                if live[j]:
                    dig[j, i] = [int(v) for v in trace[:4, base[j] + 30]]
            for half in (0, 16):
                for src in range(half, half + 16):
                    sb = base[src]
                    sx1 = 15 - sb % 16
                    if sb >= s_rows:
                        continue
                    if i > 0 or sx1 == 15:
                        for e in range(16):
                            at = sb + sx1 - 15 + e
                            for h in range(4):
                                put_digest(at, h, dig[src, i - (at < sb)][h])
                    if sx1 + 16 <= 30:
                        for e in range(16):
                            for h in range(4):
                                put_digest(sb + sx1 + 1 + e, h, dig[src, i][h])
                for src in range(half, half + 16):
                    if not live[src]:
                        continue
                    sb = base[src]
                    x1 = 15 - sb % 16
                    second = x1 + 16 <= 30
                    tail = sb + 31 == hi[src] and (sb + 31) % 16 != 0
                    for q in range(3):
                        if not ((q == 0 and i == 0 and x1 != 15) or
                                (tail and q == 1 + second)):
                            continue
                        for e in range(16):
                            at = sb + x1 + 16 * q - 15 + e
                            if at < lo[src] or at >= n or hi[src] <= at < s_rows:
                                continue
                            for h in range(4):
                                put_digest(at, h, 0 if at >= hi[src] else
                                           dig[src, i - (at < sb)][h])
    z0 = min(n, -(-s_rows // 16) * 16)
    writes[:, z0:] += 1
    return out, writes, worst


@pytest.mark.parametrize("run", (1, 3, 9))
@pytest.mark.parametrize("dead", EDGE_DEAD)
@pytest.mark.parametrize("slots", EDGE_SLOTS)
def test_trace_kernel_store_model(slots, dead, run):
    """The transcription of S1's stores writes every word of the plain
    trace exactly once, the dead rows as zero; no row is overwritten in its
    pool before its line is stored, and no pool write or read meets a bank
    conflict."""
    n = 31 * slots + dead
    st = _edge_inputs(slots)
    trace = gl.to_u64(pge.round_trace_plain(gl.from_u64(st.T.copy(), "cpu"),
                                            n))
    out, writes, worst = _model_trace(trace, slots, n, run)
    np.testing.assert_array_equal(out, trace)
    assert (writes == 1).all()
    assert worst == 1


def test_trace_pools_fill_their_array():
    """pool_word: the two columns' pools of a pair fill its 17 x 16 array
    without meeting, and row f's pool has 16 - f entries."""
    words = [pge.pool_word(s, f, odd) for f in range(16)
             for s in range(16 - f) for odd in (0, 1)]
    assert sorted(words) == list(range(16 * 17))
