"""Sparse Merkle tree over Goldilocks quads (reference src/hashdb/smt.cpp).

Node encoding, bit-exact with the reference:
  * branch:  H([left0..3 | right0..3 | 0,0,0,0])            (capacity zero)
  * leaf:    H([rkey0..3 | valueHash0..3 | 1,0,0,0])        (capacity one)
  * valueHash = H([v0..v7 | 0,0,0,0]) with the 256-bit value split into
    8 32-bit felts (scalar2fea, reference src/utils/scalar.hpp:38-66)
  * path bits interleave the four key felts: path[4i+j] = bit i of key[j]
    (Smt::splitKey, smt.cpp:1001-1019); a leaf at level L stores the
    remaining key with the first L interleaved bits removed
    (Smt::removeKeyBits, smt.cpp:1052-1075).

set/get follow the reference's iterative shape (smt.cpp:10-802): descend
recording the sibling nodes per level, dispatch on the action mode
(update / insertFound / insertNotFound / deleteFound / deleteNotFound /
deleteLast / zeroToZero), then climb rehashing the mutated path.  The
result carries the full action metadata (mode, siblings, insKey/insValue,
isOld0, proofHashCounter) that the Storage SM micro-ROM executor replays.

This tree stays on the host and hashes through ``native.poseidon_permute``
(the shared C routine, a few microseconds a permutation): each ``set``
climbs a chain of single permutations, each needing the one below it, so
there is no batch to give the card, and one kernel launch a hash (with its
copy back before the next can start) would cost more than the C routine.
The bulk rebuild, which has whole tree levels to hash at once, is
``hashdb64.Smt64.build`` on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .. import native

ZERO4 = (0, 0, 0, 0)


def scalar2fea(value: int) -> List[int]:
    """256-bit scalar -> 8 felts of 32 bits each."""
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def fea2scalar(fea: List[int]) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(fea))


def split_key(key: Tuple[int, int, int, int]) -> List[int]:
    """Interleaved path bits: path[4i+j] = bit i of key[j]."""
    path = []
    for i in range(64):
        for j in range(4):
            path.append((key[j] >> i) & 1)
    return path


def remove_key_bits(key: Tuple[int, int, int, int], n_bits: int):
    """Strip the first n_bits interleaved path bits from the key."""
    full = n_bits // 4
    out = []
    for j in range(4):
        n = full + (1 if full * 4 + j < n_bits else 0)
        out.append(key[j] >> n)
    return tuple(out)


def join_key(bits: List[int], rkey) -> Tuple[int, int, int, int]:
    """Inverse of remove_key_bits for a used path prefix."""
    n = [0, 0, 0, 0]
    accs = [0, 0, 0, 0]
    for i, b in enumerate(bits):
        if b:
            accs[i % 4] |= 1 << n[i % 4]
        n[i % 4] += 1
    return tuple((rkey[j] << n[j]) | accs[j] for j in range(4))


def _hash_save(db, a8, c4):
    v = list(a8) + list(c4)
    h = tuple(native.poseidon_permute(v)[:4])
    db.write_node(h, v)
    return h


def _hash_branch(db, left, right):
    return _hash_save(db, list(left) + list(right), [0, 0, 0, 0])


def _hash_leaf(db, rkey, value_hash):
    return _hash_save(db, list(rkey) + list(value_hash), [1, 0, 0, 0])


def _hash_value(db, value: int):
    return _hash_save(db, scalar2fea(value), [0, 0, 0, 0])


def _unique_sibling(node: List[int]) -> int:
    """Index of the only non-zero 4-felt group, or -1
    (Smt::getUniqueSibling, smt.cpp:1139-1155)."""
    found = 0
    idx = -1
    for i in range(0, len(node), 4):
        if any(node[i:i + 4]):
            found += 1
            idx = i // 4
    return idx if found == 1 else -1


@dataclass
class SmtSetResult:
    old_root: Tuple[int, ...] = ZERO4
    new_root: Tuple[int, ...] = ZERO4
    key: Tuple[int, ...] = ZERO4
    new_value: int = 0
    old_value: int = 0
    mode: str = ""
    ins_key: Tuple[int, ...] = ZERO4
    ins_value: int = 0
    is_old0: bool = True
    siblings: Dict[int, List[int]] = field(default_factory=dict)
    proof_hash_counter: int = 0

    @property
    def b_is_set(self):
        return True


@dataclass
class SmtGetResult:
    root: Tuple[int, ...] = ZERO4
    key: Tuple[int, ...] = ZERO4
    value: int = 0
    ins_key: Tuple[int, ...] = ZERO4
    ins_value: int = 0
    is_old0: bool = True
    siblings: Dict[int, List[int]] = field(default_factory=dict)
    proof_hash_counter: int = 0

    @property
    def b_is_set(self):
        return False


class Smt:
    """Stateless SMT engine over a node database."""

    def _is_leaf(self, node_value: List[int]) -> bool:
        return node_value[8] == 1

    def _read(self, db, root):
        v = db.read_node(tuple(root))
        if v is None:
            raise KeyError(f"SMT node not found: {root}")
        return list(v)

    # ------------------------------------------------------------------
    def get(self, db, root, key) -> SmtGetResult:
        res = SmtGetResult(root=tuple(root), key=tuple(key))
        keys = split_key(key)
        siblings: Dict[int, List[int]] = {}
        acc_key: List[int] = []
        level = 0
        r = tuple(root)
        found_key = None
        found_value = 0
        while r != ZERO4 and found_key is None:
            v = self._read(db, r)
            siblings[level] = v
            if self._is_leaf(v):
                value_v = self._read(db, tuple(v[4:8]))
                found_value = fea2scalar(value_v[0:8])
                found_key = join_key(acc_key, tuple(v[0:4]))
            else:
                r = tuple(v[keys[level] * 4: keys[level] * 4 + 4])
                acc_key.append(keys[level])
                level += 1
        level -= 1
        if acc_key:
            acc_key.pop()

        if found_key is not None:
            if found_key == tuple(key):
                res.value = found_value
            else:
                res.ins_key = found_key
                res.ins_value = found_value
                res.is_old0 = False
        # keep siblings only above the leaf level (smt.cpp:957-963)
        for lvl in list(siblings):
            if lvl > level:
                del siblings[lvl]
        res.siblings = siblings
        if tuple(root) != ZERO4:
            res.proof_hash_counter = len(siblings)
            if res.value != 0 or not res.is_old0:
                res.proof_hash_counter += 2
        return res

    # ------------------------------------------------------------------
    def set(self, db, old_root, key, value: int) -> SmtSetResult:
        res = SmtSetResult(old_root=tuple(old_root), key=tuple(key),
                           new_value=value)
        keys = split_key(key)
        siblings: Dict[int, List[int]] = {}
        acc_key: List[int] = []
        level = 0
        phc = 0
        r = tuple(old_root)
        new_root = tuple(old_root)
        found_key = None
        found_rkey = ZERO4
        found_value = 0
        found_value_hash = ZERO4
        old_value = 0
        ins_key = ZERO4
        ins_value = 0
        is_old0 = True
        mode = ""

        # ---- descend ----
        while r != ZERO4 and found_key is None:
            v = self._read(db, r)
            siblings[level] = v
            if self._is_leaf(v):
                found_value_hash = tuple(v[4:8])
                value_v = self._read(db, found_value_hash)
                found_value = fea2scalar(value_v[0:8])
                found_rkey = tuple(v[0:4])
                found_key = join_key(acc_key, found_rkey)
            else:
                r = tuple(v[keys[level] * 4: keys[level] * 4 + 4])
                acc_key.append(keys[level])
                level += 1
        level -= 1
        if acc_key:
            acc_key.pop()

        if tuple(old_root) != ZERO4:
            phc = min(len(siblings), level + 1)
            if found_value:
                phc += 2

        # ---- dispatch on mode ----
        if value != 0:
            if found_key is not None:
                if found_key == tuple(key):
                    mode = "update"
                    old_value = found_value
                    new_val_h = _hash_value(db, value)
                    new_leaf = _hash_leaf(db, found_rkey, new_val_h)
                    phc += 2
                    if level >= 0:
                        self._put(siblings[level], keys[level], new_leaf)
                    else:
                        new_root = new_leaf
                else:
                    mode = "insertFound"
                    level2 = level + 1
                    found_keys = split_key(found_key)
                    while keys[level2] == found_keys[level2]:
                        level2 += 1
                    old_leaf = _hash_leaf(
                        db, remove_key_bits(found_key, level2 + 1),
                        found_value_hash)
                    ins_key, ins_value, is_old0 = \
                        found_key, found_value, False
                    new_val_h = _hash_value(db, value)
                    new_leaf = _hash_leaf(
                        db, remove_key_bits(key, level2 + 1), new_val_h)
                    node = [0] * 8
                    node[keys[level2] * 4: keys[level2] * 4 + 4] = new_leaf
                    node[found_keys[level2] * 4:
                         found_keys[level2] * 4 + 4] = old_leaf
                    r2 = _hash_branch(db, node[0:4], node[4:8])
                    phc += 4
                    level2 -= 1
                    while level2 != level:
                        node = [0] * 8
                        node[keys[level2] * 4: keys[level2] * 4 + 4] = r2
                        r2 = _hash_branch(db, node[0:4], node[4:8])
                        phc += 1
                        level2 -= 1
                    if level >= 0:
                        self._put(siblings[level], keys[level], r2)
                    else:
                        new_root = r2
            else:
                mode = "insertNotFound"
                new_val_h = _hash_value(db, value)
                new_leaf = _hash_leaf(
                    db, remove_key_bits(key, level + 1), new_val_h)
                phc += 2
                if level >= 0:
                    self._put(siblings[level], keys[level], new_leaf)
                else:
                    new_root = new_leaf
        else:
            if found_key is not None and found_key == tuple(key):
                old_value = found_value
                if level >= 0:
                    self._put(siblings[level], keys[level], ZERO4)
                    ukey = _unique_sibling(siblings[level])
                    if ukey >= 0:
                        sib = self._read(
                            db, tuple(siblings[level]
                                      [ukey * 4: ukey * 4 + 4]))
                        siblings[level + 1] = sib
                        if self._is_leaf(sib):
                            mode = "deleteFound"
                            val_h = tuple(sib[4:8])
                            phc += 2
                            ins_key = join_key(acc_key + [ukey],
                                               tuple(sib[0:4]))
                            ins_value = fea2scalar(
                                self._read(db, val_h)[0:8])
                            is_old0 = False
                            while ukey >= 0 and level >= 0:
                                level -= 1
                                if level >= 0:
                                    ukey = _unique_sibling(siblings[level])
                            old_leaf = _hash_leaf(
                                db, remove_key_bits(ins_key, level + 1),
                                val_h)
                            phc += 1
                            if level >= 0:
                                self._put(siblings[level], keys[level],
                                          old_leaf)
                            else:
                                new_root = old_leaf
                        else:
                            mode = "deleteNotFound"
                    else:
                        mode = "deleteNotFound"
                else:
                    mode = "deleteLast"
                    new_root = ZERO4
            else:
                mode = "zeroToZero"
                if found_key is not None:
                    ins_key, ins_value, is_old0 = \
                        found_key, found_value, False

        # ---- truncate below the work level, then climb rehashing ----
        for lvl in list(siblings):
            if lvl > level:
                del siblings[lvl]
        while level >= 0:
            node = siblings[level]
            new_root = _hash_save(db, node[0:8], node[8:12])
            phc += 1
            level -= 1
            if level >= 0:
                self._put(siblings[level], keys[level], new_root)

        res.new_root = tuple(new_root)
        res.mode = mode
        res.old_value = old_value
        res.ins_key = tuple(ins_key)
        res.ins_value = ins_value
        res.is_old0 = is_old0
        res.siblings = siblings
        res.proof_hash_counter = phc
        return res

    @staticmethod
    def _put(node: List[int], bit: int, h) -> None:
        node[bit * 4: bit * 4 + 4] = list(h)
