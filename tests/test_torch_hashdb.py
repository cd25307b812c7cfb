"""The port's state DB (hashdb/smt.py, database.py, hashdb.py,
state_manager.py, hashdb64.py) against the JAX package's.

Tolerance: none.  Roots, node words, modes, siblings and values compare as
python ints; ``Smt64.build`` runs K1's plain version (``device="cpu"``)
and must give the JAX build's root and write the same nodes, each hash
mapped to its 12 raw input words.
"""

import dataclasses
import os
import random
import sys

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merlin_zkevm_prover_tpu.hashdb import database as jax_database  # noqa: E402
from merlin_zkevm_prover_tpu.hashdb import hashdb as jax_hashdb  # noqa: E402
from merlin_zkevm_prover_tpu.hashdb import hashdb64 as jax_h64  # noqa: E402
from merlin_zkevm_prover_tpu.hashdb import smt as jax_smt  # noqa: E402
from merlin_zkevm_prover_tpu.hashdb import state_manager as jax_sm  # noqa: E402
from merlin_zkevm_prover_tpu_torch.hashdb import database, hashdb  # noqa: E402
from merlin_zkevm_prover_tpu_torch.hashdb import hashdb64 as h64  # noqa: E402
from merlin_zkevm_prover_tpu_torch.hashdb import smt, state_manager  # noqa: E402
from merlin_zkevm_prover_tpu_torch.hashdb.smt import ZERO4  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P  # noqa: E402

M64 = (1 << 64) - 1


def _shared_keys(rng, n, shared_bits=60):
    """n distinct keys; every other one shares its first `shared_bits`
    interleaved path bits (bits 0 .. shared_bits / 4 - 1 of each word) with
    a common base, so that the tree has runs of one-sided branches; some
    words at or above p."""
    base = [rng.getrandbits(64) for _ in range(4)]
    low = shared_bits // 4
    keys = set()
    while len(keys) < n:
        if len(keys) % 2 == 0:
            k = tuple((base[j] & ((1 << low) - 1)) |
                      (rng.getrandbits(64 - low) << low) for j in range(4))
        else:
            k = tuple(rng.getrandbits(64) for _ in range(4))
        if len(keys) % 7 == 3:
            k = (P + rng.getrandbits(20),) + k[1:]
        keys.add(k)
    return sorted(keys, key=lambda k: rng.random())


# ---------------------------------------------------------------------------
# the binary SMT
# ---------------------------------------------------------------------------


def _set_fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _smt_script(rng):
    """(key, value) writes covering every set mode: inserts into an empty
    tree, beside a leaf (keys sharing path bits: insertFound deep), updates,
    deletes that collapse a branch (deleteFound), that leave a branch
    (deleteNotFound), of the last key (deleteLast) and of absent keys
    (zeroToZero)."""
    keys = _shared_keys(rng, 10, shared_bits=12) + [(1, 0, 0, 0), (3, 0, 0, 0)]
    w = [(k, rng.getrandbits(256)) for k in keys]
    w += [(keys[2], rng.getrandbits(100)), (keys[0], 0), (keys[5], 0),
          ((9, 9, 9, 9), 0), (keys[1], rng.getrandbits(64))]
    w += [(k, 0) for k in keys]
    w += [(keys[3], 7), (keys[3], 0)]
    return w


def test_smt_set_and_get_sequence_matches_the_jax_package():
    rng = random.Random(21)
    port, ref = smt.Smt(), jax_smt.Smt()
    pdb, jdb = database.Database(), jax_database.Database()
    proot = jroot = ZERO4
    modes = set()
    keys = []
    for key, value in _smt_script(rng):
        got = port.set(pdb, proot, key, value)
        want = ref.set(jdb, jroot, key, value)
        assert _set_fields(got) == _set_fields(want)
        modes.add(got.mode)
        proot, jroot = got.new_root, want.new_root
        keys.append(key)
        for k in keys[-3:] + [(5, 5, 5, 5)]:
            assert _set_fields(port.get(pdb, proot, k)) == \
                _set_fields(ref.get(jdb, jroot, k))
    assert modes == {"update", "insertFound", "insertNotFound", "deleteFound",
                     "deleteNotFound", "deleteLast", "zeroToZero"}
    assert proot == ZERO4


def test_smt_key_helpers_match_the_jax_package():
    rng = random.Random(22)
    for _ in range(20):
        key = tuple(rng.getrandbits(64) for _ in range(4))
        n = rng.randrange(0, 257)
        assert smt.split_key(key) == jax_smt.split_key(key)
        rkey = smt.remove_key_bits(key, n)
        assert rkey == jax_smt.remove_key_bits(key, n)
        assert smt.join_key(smt.split_key(key)[:n], rkey) == key
        v = rng.getrandbits(256)
        assert smt.scalar2fea(v) == jax_smt.scalar2fea(v)
        assert smt.fea2scalar(smt.scalar2fea(v)) == v


# ---------------------------------------------------------------------------
# HashDB and StateManager
# ---------------------------------------------------------------------------


def _hashdb_flow(mod_hashdb, backend):
    h = mod_hashdb.HashDB(backend=backend)
    out = []
    r = ZERO4
    for k, v in [((1, 0, 0, 0), 5), ((3, 0, 0, 0), 7), ((0, 1, 0, 0), 9),
                 ((1, 0, 0, 0), 0)]:
        res = h.set("b", 0, r, k, v)
        r = res.new_root
        out.append((res.mode, r, res.proof_hash_counter))
    out.append(_set_fields(h.get(r, (3, 0, 0, 0))))
    h.set_program((9, 9, 9, 9), b"\x60\x00")
    h.load_program_db({(8, 8, 8, 8): b"\x01\x02"})
    h.load_db({(7, 7, 7, 7): list(range(12))})
    out += [h.get_program((9, 9, 9, 9)), h.get_program((8, 8, 8, 8)),
            h.db.read_node((7, 7, 7, 7)), h.get_program((1, 1, 1, 1))]
    h.state_manager.set_old_state_root("u", ZERO4)
    h.state_manager.write("u", 0, "ab", [1, 2])
    h.semi_flush("u", r, "database")
    out += [h.flush("u"), h.flush(), h.get_flush_status()]
    h.purge("u")
    h.close()
    return out


def test_hashdb_flow_matches_the_jax_package(tmp_path):
    assert _hashdb_flow(hashdb, ":memory:") == \
        _hashdb_flow(jax_hashdb, ":memory:")
    port = _hashdb_flow(hashdb, str(tmp_path / "port.db"))
    assert port == _hashdb_flow(jax_hashdb, str(tmp_path / "jax.db"))
    # the nodes reached the sqlite file
    again = database.Database(str(tmp_path / "port.db"), use_cache=False)
    assert again.read_node((7, 7, 7, 7)) == list(range(12))


def _state_manager_flow(mod):
    sm = mod.StateManager()
    sm.set_old_state_root("b", (1, 2, 3, 4))
    sm.begin_tx("b")
    sm.write("b", 0, "k0", [1, 2, 3])
    sm.write("b", 2, "k2", [4])
    sm.set_new_state_root("b", 1, (5, 6, 7, 8))
    b = sm.get_batch("b")
    snap = (b.old_root, b.current_root,
            [(t.old_root, t.new_root, t.writes) for t in b.txs])

    class _Db:
        def __init__(self, db_mod):
            self.db = db_mod.Database()
            self.multi = self.db.multi

        def flush(self):
            return self.db.flush()

    db = _Db(database if mod is state_manager else jax_database)
    flushed = sm.flush("b", db)
    sm.set_old_state_root("c", ZERO4)
    sm.purge("c")
    stored = db.db._conn_obj.execute(
        "SELECT hash, data FROM nodes ORDER BY hash").fetchall()
    return snap, flushed, stored, sm.get_batch("b"), sm.get_batch("c"), \
        sm.flush("none", db)


def test_state_manager_flow_matches_the_jax_package():
    assert _state_manager_flow(state_manager) == _state_manager_flow(jax_sm)


def test_database_caches_match_the_jax_package():
    for kw in ({}, {"use_cache": False}, {"use_assoc_cache": True}):
        port, ref = database.Database(**kw), jax_database.Database(**kw)
        for db in (port, ref):
            db.write_node((1, 2, 3, 4), list(range(12)))
            db.write_node((5, 6, 7, 8), [1] * 12, persistent=False)
        for k in ((1, 2, 3, 4), (5, 6, 7, 8), (0, 0, 0, 1)):
            assert port.read_node(k) == ref.read_node(k)
        assert port.get_flush_status() == ref.get_flush_status()
    assert database.key_str((1, P, M64, 0)) == \
        jax_database.key_str((1, P, M64, 0))


# ---------------------------------------------------------------------------
# Smt64: the bulk rebuild on K1 (its plain version here)
# ---------------------------------------------------------------------------


def _pairs(rng, keys):
    return {k: rng.getrandbits(256) | 1 for k in keys}


@pytest.mark.parametrize("n", [0, 1, 2, 3, 25, 300])
def test_smt64_build_matches_the_jax_build(n):
    rng = random.Random(100 + n)
    pairs = _pairs(rng, _shared_keys(rng, n))
    jdb = jax_h64.Database64()
    want = jax_h64.Smt64(jdb).build(pairs)
    db = h64.Database64()
    tree = h64.Smt64(db, device="cpu")
    got = tree.build(pairs)
    assert got == tuple(want)
    assert db.node_dict() == jdb.nodes
    assert db.node_count() == len(jdb.nodes)
    if n == 0:
        assert got == ZERO4
    if n == 1:      # a single key: the root is its leaf
        assert db.read_node(got)[8:] == [1, 0, 0, 0]
    for k, v in list(pairs.items())[:4]:
        assert tree.get(got, k).value == v
    assert tree.get(got, (2, 2, 2, 2)).value == 0
    assert set(tree.spans) == {"pairs_s", "collect_s", "sort_levels_s",
                               "hash_s", "store_s"}


def test_smt64_update_and_delete_over_an_old_root():
    rng = random.Random(7)
    keys = _shared_keys(rng, 40, shared_bits=24)
    pairs = _pairs(rng, keys)
    jdb = jax_h64.Database64()
    jtree = jax_h64.Smt64(jdb)
    db = h64.Database64()
    tree = h64.Smt64(db, device="cpu")
    jroot, root = jtree.build(pairs), tree.build(pairs)
    assert root == tuple(jroot)
    # updates, fresh inserts (sharing the old keys' prefix), deletes, and a
    # delete of an absent key
    writes = {keys[0]: 5, keys[1]: 0, keys[2]: 0, keys[3]: (1 << 256) - 1}
    writes.update(_pairs(rng, _shared_keys(random.Random(8), 6, 24)))
    writes[(4, 4, 4, 4)] = 0
    jroot, root = jtree.build(writes, jroot), tree.build(writes, root)
    assert root == tuple(jroot)
    assert db.node_dict() == jdb.nodes
    # the binary SMT agrees
    sdb, s, sroot = database.Database(), smt.Smt(), ZERO4
    merged = {**pairs, **writes}
    for k, v in merged.items():
        sroot = s.set(sdb, sroot, k, v).new_root
    assert sroot == root
    for k in list(merged)[:8]:
        assert tree.get(root, k).value == merged[k]
    # delete everything: the empty tree
    assert tree.build({k: 0 for k in merged}, root) == ZERO4
    assert jtree.build({k: 0 for k in merged}, jroot) == ZERO4


def test_smt64_old_root_with_a_missing_node_raises():
    db = h64.Database64()
    with pytest.raises(KeyError):
        h64.Smt64(db, device="cpu").build({(1, 2, 3, 4): 5}, (9, 9, 9, 9))


def test_database64_node_store():
    """Single and bulk node writes: the newest write of a hash wins, reads
    of absent hashes give None, and hashes that share a first word are
    told apart."""
    db = h64.Database64()
    db.write_node((1, 2, 3, 4), list(range(12)))
    hashes = np.array([[1, 2, 3, 4], [1, 9, 9, 9], [5, 5, 5, 5],
                       [1, 9, 9, 9]], dtype=np.uint64)
    values = np.arange(48, dtype=np.uint64).reshape(4, 12)
    db.write_nodes(hashes, values)
    assert db.read_node((1, 2, 3, 4)) == list(range(12))
    assert db.read_node((1, 9, 9, 9)) == list(range(36, 48))
    assert db.read_node((1, 9, 9, 8)) is None
    db.write_node((5, 5, 5, 5), [7] * 12)
    assert db.read_node((5, 5, 5, 5)) == [7] * 12
    got = db.read_nodes(np.array([[5, 5, 5, 5], [1, 2, 3, 4], [1, 9, 9, 9]],
                                 dtype=np.uint64))
    assert got.tolist() == [[7] * 12, list(range(12)), list(range(36, 48))]
    with pytest.raises(KeyError):
        db.read_nodes(np.array([[0, 0, 0, 1]], dtype=np.uint64))
    for i in range(12):          # enough blocks to merge them
        db.write_nodes(np.array([[100 + i, 0, 0, 0]], dtype=np.uint64),
                       np.full((1, 12), i, dtype=np.uint64))
    assert len(db._blocks) <= h64._MAX_BLOCKS
    assert db.node_count() == 3 + 12
    assert db.node_dict()[(1, 9, 9, 9)] == list(range(36, 48))
    assert db.read_node((111, 0, 0, 0)) == [11] * 12


def _sm64_flow(mod, **kw):
    sm = mod.StateManager64(**kw)
    u = "batchA"
    r0, rA, rB, rC = ZERO4, (10, 0, 0, 1), (20, 0, 0, 2), (30, 0, 0, 3)
    sm.set_old_state_root(u, 0, r0)
    sm.write(u, 0, (1, 1, 1, 1), 111)
    sm.set_new_state_root(u, 0, rA)
    sm.set_old_state_root(u, 0, rA)            # a sub-state later reverted
    sm.write(u, 0, (2, 2, 2, 2), 222)
    sm.set_new_state_root(u, 0, rB)
    sm.set_old_state_root(u, 0, rA)            # the path taken instead
    sm.write(u, 0, (3, 3, 3, 3), 333)
    sm.delete_node(u, 0, (1, 1, 1, 1))
    sm.set_new_state_root(u, 0, rC)
    sm.set_old_state_root(u, 1, rC)            # a second tx
    sm.write(u, 1, (4, 4, 4, 4), 444)
    sm.set_new_state_root(u, 1, rA)
    sm.set_old_state_root(u, 0, r0, mod.PERSISTENCE_TEMPORARY)
    sm.write(u, 0, (9, 9, 9, 9), 999, mod.PERSISTENCE_TEMPORARY)
    sm.set_new_state_root(u, 0, rA, mod.PERSISTENCE_TEMPORARY)
    sm.semi_flush(u, rA)
    reads = [sm.read(u, (k,) * 4) for k in (1, 2, 3, 4, 9, 5)]
    flushed = sm.flush_batch(u)
    version = sm.db.latest_version
    root = [r for r, v in sm.db.version_by_root.items() if v == version][0]
    out = [reads, flushed, version, tuple(root), dict(sm.db.kv_latest),
           [sm.db.read_kv(version, (k,) * 4) for k in (1, 2, 3, 4)],
           sm.smt.get(root, (3, 3, 3, 3)).value, sm.flush_batch("none")]
    # the simple facade
    r1 = sm.set("f", ZERO4, (5, 6, 7, 8), 100)
    r2 = sm.set("f", ZERO4, (8, 7, 6, 5), 200)
    out += [tuple(r1), tuple(r2), sm.get("f", r2, (5, 6, 7, 8)).value,
            tuple(sm.flush("f")), tuple(sm.flush("f")),
            sm.db.get_flush_status()]
    sm.cancel_batch("f")
    errors = []
    for bad in (lambda: sm.set_new_state_root("fresh", 0, rA),
                lambda: sm.write("nobatch", 0, (1, 1, 1, 1), 1),
                lambda: sm.set_old_state_root(u, 0, r0, 7)):
        with pytest.raises(mod.StateManagerError) as e:
            bad()
        errors.append(str(e.value))
    return out + errors


def test_state_manager64_substate_chain_matches_the_jax_package():
    got = _sm64_flow(h64, device="cpu")
    assert got == _sm64_flow(jax_h64)
    reads, kv = got[0], got[4]
    assert reads == [0, 222, 333, 444, None, None]   # temporary: unread
    assert kv == {(3, 3, 3, 3): 333, (4, 4, 4, 4): 444}


def test_database64_versioned_kv_matches_the_jax_package():
    out = []
    for mod in (h64, jax_h64):
        db = mod.Database64()
        k = (7, 7, 7, 7)
        db.write_version((1, 0, 0, 0), 1)
        db.write_kv(1, k, 100)
        db.write_version((2, 0, 0, 0), 2)
        db.write_kv(2, k, 200)
        db.write_kv(3, k, 0)
        db.programs[(1, 1, 1, 1)] = b"\x00"
        out.append([db.read_kv(1, k), db.read_kv(2, k), db.read_kv(3, k),
                    db.read_kv(0, k), db.read_kv(1, (0, 0, 0, 0)),
                    db.read_version((2, 0, 0, 0)), dict(db.kv_latest),
                    db.flush(), db.get_flush_status(), db.latest_version])
    assert out[0] == out[1]
