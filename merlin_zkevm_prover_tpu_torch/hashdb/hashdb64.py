"""HashDB64 — the batched key-value state tree (reference src/hashdb64/:
Smt64, Database64, StateManager64).

The reference's second-generation state DB defers tree building: writes
accumulate as raw (key, value) pairs per batch, and the Merkle tree is
(re)built once per flush instead of per set — trading per-write hashing
for one bulk rebuild (smt_64.hpp:56-85, database_64.hpp page store).
Node encodings (leaf capacity [1,0,0,0], branch [0,0,0,0], value-node
hashing) are identical to hashdb/smt.py, so roots agree with the binary
SMT.

``Smt64.build`` hashes the rebuilt tree level by level on the card: one
launch of the batched permutation (kernel K1, ``ops.poseidon_gl.permute``
on a ``(12, B)`` lane-major state) for every value node, one for every
leaf, then one per branch level from the deepest to the root.  The trie's
shape comes from the keys in numpy, without a python call per key or per
node: the interleaved 256-bit paths (``smt.split_key``) as four words a
key, MSB first, sorted; each key's leaf level from the longest common
prefix with its neighbours; at level L one branch for each maximal run of
keys sharing L path bits (one-sided branches ``H(0 | right)`` included, as
the JAX package's recursive build makes them).  The leaves under the old
root are read the same way, a tree level at a time.  ``Database64`` keeps
bulk-written nodes in sorted arrays (``_NodeBlock``) and single writes in a
dict; ``read_node`` and ``write_node`` behave as the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import goldilocks as gl
from ..ops import poseidon_gl
from .smt import ZERO4, SmtGetResult, join_key, split_key

Key4 = Tuple[int, int, int, int]

_U = np.uint64
_M32 = _U(0xFFFFFFFF)
_M64 = (1 << 64) - 1
# bit-reversed bytes, for the paths' MSB-first words
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], dtype=np.uint8)
# bulk blocks kept apart before they are merged into one
_MAX_BLOCKS = 8


class _NodeBlock:
    """Nodes written together: hashes (m, 4) and their 12 raw words
    (m, 12), kept in write order, and an index sorted by the hash's first
    word (``h0``; ``rows``: the row of each) that holds, of equal hashes,
    the last written.  ``collide`` marks a block in which two different
    hashes share a first word (the index sorted by all four words then)."""

    def __init__(self, hashes: np.ndarray, values: np.ndarray):
        self.hashes, self.values = hashes, values
        m = len(hashes)
        order = np.argsort(hashes[:, 0], kind="stable")
        h0 = hashes[order, 0]
        same0 = h0[1:] == h0[:-1]
        self.collide = False
        drop = same0
        if same0.any():
            pairs = np.flatnonzero(same0)
            equal = (hashes[order[pairs]] == hashes[order[pairs + 1]]).all(
                axis=1)
            if not equal.all():
                self.collide = True
                order = np.lexsort((np.arange(m), hashes[:, 3], hashes[:, 2],
                                    hashes[:, 1], hashes[:, 0]))
                h0 = hashes[order, 0]
                drop = (hashes[order[1:]] == hashes[order[:-1]]).all(axis=1)
        keep = np.ones(m, dtype=bool)
        keep[:-1] = ~drop                 # the last of equal hashes stays
        self.rows = order[keep]
        self.h0 = np.ascontiguousarray(h0[keep])

    def __len__(self) -> int:
        return len(self.rows)

    def live(self):
        """The indexed nodes: (hashes, values)."""
        return self.hashes[self.rows], self.values[self.rows]

    def find(self, q: np.ndarray) -> np.ndarray:
        """Row of each hash of q (k, 4), -1 where absent.  The queries are
        searched in sorted order (each search starts where the last one
        ended)."""
        if not len(self.h0) or not len(q):
            return np.full(len(q), -1, dtype=np.int64)
        sort = np.argsort(q[:, 0])
        pos = np.empty(len(q), dtype=np.int64)
        pos[sort] = np.searchsorted(self.h0, q[sort, 0])
        pos = np.minimum(pos, len(self.h0) - 1)
        rows = self.rows[pos]
        hit = (self.hashes[rows] == q).all(axis=1)
        out = np.where(hit, rows, -1)
        if self.collide:
            for k in np.flatnonzero(~hit & (self.h0[pos] == q[:, 0])):
                j = pos[k]
                while j < len(self.h0) and self.h0[j] == q[k, 0]:
                    if (self.hashes[self.rows[j]] == q[k]).all():
                        out[k] = self.rows[j]
                        break
                    j += 1
        return out


class Database64:
    """Raw node/program/keyvalue store (reference database_64.hpp roles):
    versioned KV pages (key -> [(version, value)] history), a version
    table (consolidated state root -> version), a program store, and the
    flush-id pipeline the remote sender thread exposes through
    getFlushStatus (database_64.hpp multiWrite/senderSem roles — here the
    'send' is immediate, so storedFlushId tracks flushId).

    Nodes: single writes (``write_node``) go to a dict, bulk writes
    (``write_nodes``) to sorted array blocks; the newest write of a hash
    wins, as in the JAX package's one dict."""

    def __init__(self):
        self._pending: Dict[Key4, List[int]] = {}
        self._blocks: List[_NodeBlock] = []
        self.programs: Dict[Key4, bytes] = {}
        self.kv_latest: Dict[Key4, int] = {}  # consolidated key -> value
        # versioned KV model
        self.kv_history: Dict[Key4, List[Tuple[int, int]]] = {}
        self.version_by_root: Dict[Key4, int] = {}
        self.latest_version: int = 0
        # flush pipeline counters (reference getFlushStatus fields)
        self.flush_id: int = 0
        self.stored_flush_id: int = 0
        self.last_sent_flush_id: int = 0

    def read_node(self, h: Key4) -> Optional[List[int]]:
        h = tuple(h)
        v = self._pending.get(h)
        if v is not None:
            return v
        q = np.array([h], dtype=np.uint64)
        for blk in reversed(self._blocks):
            i = int(blk.find(q)[0])
            if i >= 0:
                return blk.values[i].tolist()
        return None

    def write_node(self, h: Key4, v: List[int]) -> None:
        self._pending[tuple(h)] = list(v)

    # -- bulk node access (the tree build's) ------------------------------
    def _seal(self) -> None:
        """Move the single writes into a block (the newest)."""
        if self._pending:
            hashes = np.array(list(self._pending), dtype=np.uint64)
            values = np.array(list(self._pending.values()), dtype=np.uint64)
            self._pending = {}
            self._append(_NodeBlock(hashes.reshape(-1, 4),
                                    values.reshape(len(hashes), -1)))

    def _append(self, blk: _NodeBlock) -> None:
        self._blocks.append(blk)
        if len(self._blocks) > _MAX_BLOCKS:
            self._merge()

    def _merge(self) -> None:
        if len(self._blocks) > 1:
            live = [b.live() for b in self._blocks]
            self._blocks = [_NodeBlock(np.concatenate([h for h, _ in live]),
                                       np.concatenate([v for _, v in live]))]

    def write_nodes(self, hashes: np.ndarray, values: np.ndarray) -> None:
        """Write m nodes at once: hashes (m, 4), values (m, 12) uint64."""
        self._seal()
        if len(hashes):
            self._append(_NodeBlock(np.asarray(hashes, dtype=np.uint64),
                                    np.asarray(values, dtype=np.uint64)))

    def read_nodes(self, hashes: np.ndarray) -> np.ndarray:
        """The 12 words of each of the nodes hashes (k, 4); raises KeyError
        if one is missing."""
        self._seal()
        q = np.asarray(hashes, dtype=np.uint64).reshape(-1, 4)
        out = np.zeros((len(q), 12), dtype=np.uint64)
        need = np.arange(len(q))
        for blk in reversed(self._blocks):
            if not len(need):
                break
            i = blk.find(q[need])
            hit = i >= 0
            out[need[hit]] = blk.values[i[hit]]
            need = need[~hit]
        if len(need):
            raise KeyError(f"missing node {tuple(q[need[0]].tolist())}")
        return out

    def node_dict(self) -> Dict[Key4, List[int]]:
        """Every node, hash -> its 12 words (python ints)."""
        self._seal()
        self._merge()
        if not self._blocks:
            return {}
        hashes, values = self._blocks[0].live()
        return dict(zip(map(tuple, hashes.tolist()), values.tolist()))

    def node_count(self) -> int:
        self._seal()
        self._merge()
        return len(self._blocks[0]) if self._blocks else 0

    # -- versioned KV (reference Database64::writeKV/readKV/writeVersion) --
    def write_version(self, root: Key4, version: int) -> None:
        self.version_by_root[tuple(root)] = version
        self.latest_version = max(self.latest_version, version)

    def read_version(self, root: Key4) -> Optional[int]:
        return self.version_by_root.get(tuple(root))

    def write_kv(self, version: int, key: Key4, value: int) -> None:
        self.kv_history.setdefault(tuple(key), []).append((version, value))
        if value == 0:
            self.kv_latest.pop(tuple(key), None)
        else:
            self.kv_latest[tuple(key)] = value

    def read_kv(self, version: int, key: Key4) -> Optional[int]:
        """Value of key at the given version (latest write <= version)."""
        hist = self.kv_history.get(tuple(key))
        if not hist:
            return None
        best = None
        for v, val in hist:
            if v <= version and (best is None or v > best[0]):
                best = (v, val)
        return best[1] if best else None

    def flush(self) -> Tuple[int, int]:
        """Advance the flush pipeline; returns (flushId, lastSentFlushId).
        The in-process store persists synchronously, so stored/sent ids
        trail flushId by zero."""
        self.flush_id += 1
        self.stored_flush_id = self.flush_id
        self.last_sent_flush_id = self.flush_id
        return self.flush_id, self.last_sent_flush_id

    def get_flush_status(self) -> dict:
        return {
            "storedFlushId": self.stored_flush_id,
            "storingFlushId": self.flush_id,
            "lastFlushId": self.flush_id,
            "pendingToFlushNodes": 0,
            "pendingToFlushProgram": 0,
            "storingNodes": 0,
            "storingProgram": 0,
        }


@dataclass
class Tx64:
    """Uncommitted writes of one batch tx (StateManager64 sub-state)."""

    writes: Dict[Key4, int] = field(default_factory=dict)
    old_root: Key4 = ZERO4
    new_root: Key4 = ZERO4


# ---------------------------------------------------------------------------
# The trie's shape from the keys (numpy, no python call per key)
# ---------------------------------------------------------------------------


def _spread16(x: np.ndarray) -> np.ndarray:
    """Bits 0..15 of each word to bits 0, 4, .., 60."""
    x = (x | (x << _U(24))) & _U(0x000000FF000000FF)
    x = (x | (x << _U(12))) & _U(0x000F000F000F000F)
    x = (x | (x << _U(6))) & _U(0x0303030303030303)
    return (x | (x << _U(3))) & _U(0x1111111111111111)


def _path_words(keys: np.ndarray) -> np.ndarray:
    """(N, 4) keys -> (4, N): the 256 interleaved path bits (path[4i + j]
    = bit i of key[j]), 64 a word, path bit 0 the MSB of word 0, so that
    the words' lexicographic order is the paths' order."""
    out = np.empty((4, len(keys)), dtype=np.uint64)
    for w in range(4):
        m = np.zeros(len(keys), dtype=np.uint64)
        for j in range(4):
            chunk = (keys[:, j] >> _U(16 * w)) & _U(0xFFFF)
            m |= _spread16(chunk) << _U(j)
        out[w] = _REV8[m.view(np.uint8)].view(np.uint64).byteswap()
    return out


def _path_order(words: np.ndarray) -> np.ndarray:
    """Stable sort of the paths (4, N): by the first word, then the runs
    that share it by all four."""
    order = np.argsort(words[0], kind="stable")
    w0 = words[0, order]
    tie = w0[1:] == w0[:-1]
    if tie.any():
        pos = np.zeros(len(order), dtype=bool)
        pos[1:] |= tie
        pos[:-1] |= tie
        idx = np.flatnonzero(pos)
        sub = order[idx]
        order[idx] = sub[np.lexsort((words[3, sub], words[2, sub],
                                     words[1, sub], words[0, sub]))]
    return order


def _bit_length(x: np.ndarray) -> np.ndarray:
    hi = (x >> _U(32)).astype(np.float64)
    lo = (x & _M32).astype(np.float64)
    return np.where(hi > 0, 32 + np.frexp(hi)[1], np.frexp(lo)[1])


def _common_prefix(words: np.ndarray) -> np.ndarray:
    """Path bits shared by each pair of neighbours of sorted, distinct
    paths (4, N): (N - 1,)."""
    x = words[:, 1:] ^ words[:, :-1]
    first = np.argmax(x != 0, axis=0)
    xv = x[first, np.arange(x.shape[1])]
    return (64 * first + 64 - _bit_length(xv)).astype(np.int64)


def _remove_key_bits(keys: np.ndarray, level: np.ndarray) -> np.ndarray:
    """smt.remove_key_bits of each key at its level (N,)."""
    out = np.empty_like(keys)
    for j in range(4):
        n = ((level + 3 - j) // 4).astype(np.uint64)
        out[:, j] = np.where(n >= 64, _U(0), keys[:, j] >> np.minimum(n, _U(63)))
    return out


def _join_key(rkeys: np.ndarray, acc: np.ndarray, level: int) -> np.ndarray:
    """smt.join_key of leaves at `level`, acc holding their path bits."""
    out = np.empty_like(rkeys)
    for j in range(4):
        n = (level + 3 - j) // 4
        out[:, j] = acc[:, j] | (rkeys[:, j] << _U(n) if n < 64 else _U(0))
    return out


def _words8(values: np.ndarray) -> np.ndarray:
    """Python-int values (object array) -> (N, 8) 32-bit words
    (smt.scalar2fea)."""
    out = np.empty((len(values), 8), dtype=np.uint64)
    for k in range(4):
        c = ((values >> (64 * k)) & _M64).astype(np.uint64)
        out[:, 2 * k] = c & _M32
        out[:, 2 * k + 1] = c >> _U(32)
    return out


class Smt64:
    """Bulk-rebuild sparse Merkle tree with smt.py-compatible hashing.

    ``device``: where the permutations run (None: the card, raising when
    there is none; "cpu": K1's plain version).  ``spans`` holds the host
    seconds of the last build's pieces."""

    permute = staticmethod(poseidon_gl.permute)

    def __init__(self, db: Database64, device=None):
        self.db = db
        self.device = device
        self.spans: Dict[str, float] = {}

    # -- hashing (identical conventions to hashdb/smt.py) --
    def _hash(self, rows: np.ndarray) -> np.ndarray:
        """Permute each 12-word row (m, 12) on the device: (m, 4)."""
        if not len(rows):
            return np.zeros((0, 4), dtype=np.uint64)
        t0 = time.time()
        dev = gl.resolve_device(self.device)
        st = gl.from_u64(rows, dev).T.contiguous()     # (12, m) lane-major
        out = gl.to_u64(self.permute(st)[:4].T.contiguous())
        self.spans["hash_s"] += time.time() - t0
        return out

    # -- bulk tree build --
    def build(self, pairs: Dict[Key4, int], old_root: Key4 = ZERO4) -> Key4:
        """Insert/update all (key, value) pairs over old_root in one bulk
        rebuild; value 0 deletes.  Returns the new root."""
        self.spans = {"hash_s": 0.0}
        t0 = time.time()
        keys = np.array(list(pairs), dtype=np.uint64).reshape(-1, 4)
        values = np.fromiter(pairs.values(), dtype=object, count=len(pairs))
        words, deleted = _words8(values), values == 0
        t1 = time.time()
        old_keys, old_words = self._collect_leaves(tuple(old_root))
        self.spans.update(pairs_s=t1 - t0, collect_s=time.time() - t1)
        return self._build(np.concatenate([old_keys, keys]),
                           np.concatenate([old_words, words]),
                           np.concatenate([np.zeros(len(old_keys), dtype=bool),
                                           deleted]))

    def _build(self, keys, words, deleted) -> Key4:
        """The tree of the leaves (keys, words); of equal keys the last
        counts, and a deleted last removes the key."""
        t0 = time.time()
        paths = _path_words(keys)
        order = _path_order(paths)
        paths = paths[:, order]
        keep = np.ones(len(order), dtype=bool)
        keep[:-1] = ~(paths[:, 1:] == paths[:, :-1]).all(axis=0)
        keep &= ~deleted[order]
        order, paths = order[keep], paths[:, keep]
        keys, words = keys[order], words[order]
        b = len(keys)
        if b == 0:
            self.spans.update(sort_levels_s=time.time() - t0, store_s=0.0)
            return ZERO4
        lcp = _common_prefix(paths)
        level = np.zeros(b, dtype=np.int64)
        if b > 1:
            level[:-1] = lcp + 1
            level[1:] = np.maximum(level[1:], lcp + 1)
        zeros4 = np.zeros((b, 4), dtype=np.uint64)
        ones4 = zeros4.copy()
        ones4[:, 0] = 1
        value_rows = np.concatenate([words, zeros4], axis=1)
        value_h = self._hash(value_rows)
        leaf_rows = np.concatenate([_remove_key_bits(keys, level), value_h,
                                    ones4], axis=1)
        leaf_h = self._hash(leaf_rows)
        hashes, rows = [value_h, leaf_h], [value_rows, leaf_rows]
        root = leaf_h[0]
        if b > 1:
            # level L: a branch for each run of neighbours sharing L bits;
            # its children are the level-(L + 1) runs, single keys (their
            # leaves) or nothing
            starts = np.zeros(0, dtype=np.int64)
            level_h = np.zeros((0, 4), dtype=np.uint64)
            for lv in range(int(lcp.max()), -1, -1):
                edge = np.diff(np.concatenate(
                    ([0], (lcp >= lv).astype(np.int8), [0])))
                s = np.flatnonzero(edge == 1)
                e = np.flatnonzero(edge == -1) + 1
                split = np.full(len(s), -1, dtype=np.int64)
                at = np.flatnonzero(lcp == lv)
                split[np.searchsorted(s, at, side="right") - 1] = at + 1
                one_sided = split < 0
                bit = (paths[lv >> 6, s[one_sided]] >> _U(63 - (lv & 63))) & _U(1)
                split[one_sided] = np.where(bit == 1, s[one_sided],
                                            e[one_sided])
                child = []
                for lo, hi in ((s, split), (split, e)):
                    h = np.zeros((len(s), 4), dtype=np.uint64)
                    single = hi - lo == 1
                    h[single] = leaf_h[lo[single]]
                    run = hi - lo >= 2
                    h[run] = level_h[np.searchsorted(starts, lo[run])]
                    child.append(h)
                branch_rows = np.concatenate(
                    [child[0], child[1], np.zeros((len(s), 4), np.uint64)],
                    axis=1)
                level_h = self._hash(branch_rows)
                starts = s
                hashes.append(level_h)
                rows.append(branch_rows)
            root = level_h[0]
        t1 = time.time()
        self.db.write_nodes(np.concatenate(hashes), np.concatenate(rows))
        self.spans.update(sort_levels_s=t1 - t0 - self.spans["hash_s"],
                          store_s=time.time() - t1)
        return tuple(int(v) for v in root)

    def _collect_leaves(self, root: Key4):
        """The leaves under root: keys (k, 4) and their values' 32-bit words
        (k, 8), read a tree level at a time."""
        keys = [np.zeros((0, 4), dtype=np.uint64)]
        words = [np.zeros((0, 8), dtype=np.uint64)]
        frontier = np.array([root], dtype=np.uint64).reshape(-1, 4)
        frontier = frontier[(frontier != 0).any(axis=1)]
        acc = np.zeros_like(frontier)       # the path bits above each node
        lv = 0
        while len(frontier):
            nodes = self.db.read_nodes(frontier)
            leaf = nodes[:, 8] == 1         # leaf: [rkey4 | valueHash4 | 1 0 0 0]
            if leaf.any():
                keys.append(_join_key(nodes[leaf, 0:4], acc[leaf], lv))
                words.append(self.db.read_nodes(nodes[leaf, 4:8])[:, :8] & _M32)
            br, acc = nodes[~leaf], acc[~leaf]
            right = acc.copy()
            right[:, lv % 4] |= _U(1 << (lv // 4))
            left_h, right_h = br[:, 0:4], br[:, 4:8]
            lz, rz = (left_h != 0).any(axis=1), (right_h != 0).any(axis=1)
            frontier = np.concatenate([left_h[lz], right_h[rz]])
            acc = np.concatenate([acc[lz], right[rz]])
            lv += 1
        return np.concatenate(keys), np.concatenate(words)

    def get(self, root: Key4, key: Key4) -> SmtGetResult:
        res = SmtGetResult(root=tuple(root), key=tuple(key))
        path = split_key(key)
        r = tuple(root)
        level = 0
        while r != ZERO4:
            node = self.db.read_node(r)
            if node[8] == 1:
                rkey = tuple(node[0:4])
                leaf_key = join_key(path[:level], rkey)
                vnode = self.db.read_node(tuple(node[4:8]))
                value = sum((int(x) & 0xFFFFFFFF) << (32 * i)
                            for i, x in enumerate(vnode[0:8]))
                if leaf_key == tuple(key):
                    res.value = value
                return res
            r = tuple(node[0:4]) if path[level] == 0 else tuple(node[4:8])
            level += 1
        return res


# Persistence classes (reference persistence.hpp)
PERSISTENCE_CACHE = 0      # batch-lifetime, consolidated on flush
PERSISTENCE_DATABASE = 1   # durable
PERSISTENCE_TEMPORARY = 2  # dropped at flush
PERSISTENCE_SIZE = 3


@dataclass
class TxSubState64:
    """One executor checkpoint between two state roots; a tx that reverts
    leaves dangling sub-states which flush() later prunes (reference
    state_manager_64.hpp TxSubState64)."""

    old_state_root: Key4 = ZERO4
    new_state_root: Key4 = ZERO4
    previous_sub_state: int = 0
    valid: bool = False
    writes: Dict[Key4, int] = field(default_factory=dict)


@dataclass
class TxPersistenceState64:
    old_state_root: Key4 = ZERO4
    new_state_root: Key4 = ZERO4
    current_sub_state: int = 0
    sub_states: List[TxSubState64] = field(default_factory=list)


@dataclass
class TxState64:
    persistence: List[TxPersistenceState64] = field(
        default_factory=lambda: [TxPersistenceState64()
                                 for _ in range(PERSISTENCE_SIZE)])


@dataclass
class BatchState64:
    old_state_root: Key4 = ZERO4
    current_state_root: Key4 = ZERO4
    current_tx: int = 0
    tx_states: List[TxState64] = field(default_factory=list)


class StateManagerError(Exception):
    """ZKR_STATE_MANAGER analog: inconsistent root/sub-state bookkeeping."""


class StateManager64:
    """Per-batch, per-tx sub-state accumulation with revert-aware
    consolidation (reference state_manager_64.cpp).

    The executor opens a sub-state per checkpoint (setOldStateRoot),
    writes key/values into it, and closes it (setNewStateRoot).  A
    reverted tx leaves orphan sub-states; flush() walks BACKWARD from
    each tx's final root to its old root marking the surviving chain
    valid (state_manager_64.cpp flush:66-110), prunes the rest, bulk-
    rebuilds the tree from the surviving writes, and consolidates the
    version/KV view in Database64."""

    def __init__(self, db: Optional[Database64] = None, device=None):
        self.db = db or Database64()
        self.smt = Smt64(self.db, device)
        self.state: Dict[str, BatchState64] = {}
        self.batches: Dict[str, Tx64] = {}  # simple-facade bookkeeping

    # -- reference API ---------------------------------------------------
    def set_old_state_root(self, batch_uuid: str, tx: int, root: Key4,
                           persistence: int = PERSISTENCE_CACHE) -> None:
        self._set_state_root(batch_uuid, tx, tuple(root), True, persistence)

    def set_new_state_root(self, batch_uuid: str, tx: int, root: Key4,
                           persistence: int = PERSISTENCE_CACHE) -> None:
        self._set_state_root(batch_uuid, tx, tuple(root), False, persistence)

    def _set_state_root(self, batch_uuid: str, tx: int, root: Key4,
                        is_old: bool, persistence: int) -> None:
        if not 0 <= persistence < PERSISTENCE_SIZE:
            raise StateManagerError(f"invalid persistence {persistence}")
        bs = self.state.get(batch_uuid)
        if bs is None:
            if not is_old:
                raise StateManagerError(
                    "setNewStateRoot before any setOldStateRoot")
            bs = BatchState64(old_state_root=root)
            self.state[batch_uuid] = bs
        bs.current_state_root = root
        if tx >= len(bs.tx_states):
            if not is_old:
                raise StateManagerError(f"tx {tx} does not exist yet")
            while len(bs.tx_states) <= tx:
                bs.tx_states.append(TxState64())
            bs.current_tx = tx
        ps = bs.tx_states[tx].persistence[persistence]
        if is_old:
            if not ps.sub_states:
                if ps.current_sub_state != 0:
                    raise StateManagerError("currentSubState != 0 at open")
                ps.old_state_root = root
            sub = TxSubState64(old_state_root=root,
                               previous_sub_state=ps.current_sub_state)
            ps.sub_states.append(sub)
            ps.current_sub_state = len(ps.sub_states) - 1
        else:
            if not ps.sub_states:
                raise StateManagerError("setNewStateRoot with no sub-state")
            ps.sub_states[ps.current_sub_state].new_state_root = root
            ps.new_state_root = root

    def write(self, batch_uuid: str, tx: int, key: Key4, value: int,
              persistence: int = PERSISTENCE_CACHE) -> None:
        bs = self.state.get(batch_uuid)
        if bs is None or tx >= len(bs.tx_states):
            raise StateManagerError("write before setOldStateRoot")
        ps = bs.tx_states[tx].persistence[persistence]
        if not ps.sub_states:
            raise StateManagerError("write with no open sub-state")
        ps.sub_states[ps.current_sub_state].writes[tuple(key)] = value

    def delete_node(self, batch_uuid: str, tx: int, key: Key4,
                    persistence: int = PERSISTENCE_CACHE) -> None:
        self.write(batch_uuid, tx, key, 0, persistence)

    def read(self, batch_uuid: str, key: Key4) -> Optional[int]:
        """Latest uncommitted value of key across the batch's sub-states
        (newest first), falling back to the consolidated KV view."""
        bs = self.state.get(batch_uuid)
        key = tuple(key)
        if bs is not None:
            for txs in reversed(bs.tx_states):
                for ps in txs.persistence[:2]:
                    for sub in reversed(ps.sub_states):
                        if key in sub.writes:
                            return sub.writes[key]
        return self.db.kv_latest.get(key)

    def semi_flush(self, batch_uuid: str, new_root: Key4,
                   persistence: int = PERSISTENCE_CACHE) -> None:
        """Mark the running tx's final root (reference semiFlush: called
        at tx end so flush() knows each tx's terminal state)."""
        bs = self.state.get(batch_uuid)
        if bs is None:
            return
        bs.current_state_root = tuple(new_root)

    def _resolve_valid_chain(self, ps: TxPersistenceState64) -> List[int]:
        """Backward walk newStateRoot -> oldStateRoot marking the valid
        sub-state chain (reference flush, state_manager_64.cpp)."""
        if not ps.sub_states:
            return []
        cur = ps.current_sub_state
        if ps.sub_states[cur].new_state_root != ps.new_state_root:
            raise StateManagerError("current sub-state root mismatch")
        chain = []
        while True:
            ps.sub_states[cur].valid = True
            chain.append(cur)
            if cur == 0:
                if ps.sub_states[0].old_state_root != ps.old_state_root:
                    raise StateManagerError("chain does not reach oldRoot")
                break
            prev = ps.sub_states[cur].previous_sub_state
            if ps.sub_states[prev].new_state_root == \
                    ps.sub_states[cur].old_state_root:
                cur = prev
                continue
            # a revert broke the chain: search an earlier matching substate
            for i in range(cur):
                if ps.sub_states[i].new_state_root == \
                        ps.sub_states[cur].old_state_root:
                    prev = i
                    break
            else:
                raise StateManagerError("broken sub-state chain")
            cur = prev
        return list(reversed(chain))

    def flush_batch(self, batch_uuid: str) -> Tuple[int, int]:
        """Consolidate a batch: resolve valid sub-state chains per tx,
        apply surviving writes in order, bulk-rebuild the tree, record the
        consolidated root version, and advance the flush pipeline.
        Returns (flushId, lastSentFlushId)."""
        bs = self.state.pop(batch_uuid, None)
        if bs is None:
            return self.db.flush()
        writes: Dict[Key4, int] = {}
        for txs in bs.tx_states:
            for persistence in range(PERSISTENCE_SIZE):
                ps = txs.persistence[persistence]
                if persistence == PERSISTENCE_TEMPORARY:
                    ps.sub_states.clear()
                    ps.current_sub_state = 0
                    continue
                if not ps.sub_states:
                    continue
                for idx in self._resolve_valid_chain(ps):
                    writes.update(ps.sub_states[idx].writes)
        if writes:
            new_root = self.smt.build(writes, bs.old_state_root)
            version = self.db.latest_version + 1
            self.db.write_version(new_root, version)
            for k, v in writes.items():
                self.db.write_kv(version, k, v)
        return self.db.flush()

    def cancel_batch(self, batch_uuid: str) -> None:
        self.state.pop(batch_uuid, None)
        self.batches.pop(batch_uuid, None)

    # -- simple facade (used by the hashdb service fast path) -------------
    def set(self, batch_uuid: str, old_root: Key4, key: Key4,
            value: int) -> Key4:
        tx = self.batches.setdefault(batch_uuid, Tx64(old_root=old_root))
        if not tx.writes:
            tx.old_root = tuple(old_root)
        tx.writes[tuple(key)] = value
        # the reference computes the running root eagerly for the executor
        tx.new_root = self.smt.build(tx.writes, tx.old_root)
        return tx.new_root

    def get(self, batch_uuid: str, root: Key4, key: Key4) -> SmtGetResult:
        return self.smt.get(root, key)

    def flush(self, batch_uuid: str) -> Key4:
        """Consolidate the facade batch: apply writes to the KV view."""
        tx = self.batches.pop(batch_uuid, None)
        if tx is None:
            return ZERO4
        version = self.db.latest_version + 1
        self.db.write_version(tx.new_root, version)
        for k, v in tx.writes.items():
            self.db.write_kv(version, k, v)
        self.db.flush()
        return tx.new_root
