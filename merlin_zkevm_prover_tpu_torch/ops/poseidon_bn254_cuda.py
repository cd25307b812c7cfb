"""Poseidon over BN254 Fr (every width t = 2..17) and the arity-16 BN128
Merkle tree: kernel B1 and its plain twins.

The JAX package computes these on the host in python ints
(``ops/poseidon_bn254.py:69-182``, ``stark/merkle_bn128.py:22-60, 97-98``);
it has no Pallas kernel for them.  At recursiveF's width (four trees of
about 2^20 rows, widths 24, 105, 6 and 47: some 6 million permutations) the
host would take hours, so the port builds the trees on the card through two
hand-written kernels in ``csrc/poseidon_bn254.cu``:

``leaf_hash``  one thread per row of the row-major (H, W) Goldilocks matrix.
    A row of width <= 4 is its own leaf: ``sum_i w_i 2^(64 i) mod r`` (the
    words kernel).  A wider row is packed three words per Fr element (below
    2^192 < r) and sponge-hashed: 16-wide chunks at t = 17 with the
    capacity carried, the last chunk at t = pending + 1 with that width's
    own tables (``merkleTreeBN128.cpp:88-141``).  The sponge kernel is
    compiled for each t, so the full chunks take one launch at t = 17 and
    the last chunk a second at its own t (one launch where the row has a
    single chunk), the capacity passed between them in Montgomery form.
``node_hash``  one thread per node: ``hash16`` of its 16 children, the
    children past a level's end read as 0 (``get_group_proof`` pads the
    same way).

Both read the round constants, the sparse partial-round vectors and the two
matrices of every width from one device table in Montgomery form
(``_device_tables``).  The values at the kernels' interfaces are plain
canonical Fr integers as ``(n, 4)`` int64 limbs, the form the host tree and
the transcript read.  Bound: operations.  A t = 17 permutation is 5,168
Montgomery products in the reference's schedule (``mont_products``: 8 full
rounds of 17 S-boxes, 3 products each, and 8 dense 17 x 17 mixes; 68
partial rounds of one S-box and 33 products), 36 64-bit products each in
the CIOS loop.  The kernels reduce each output of a dense mix, and each
dot product of a partial round, once (``mul64_products`` counts the 64-bit
products they make: 120,768 at t = 17 against 186,048); the bytes moved
are a few hundred a row.

Each wrapper takes the plain twin only for a CPU tensor; on a CUDA tensor
it launches its kernel or raises.  ``LAUNCHES`` counts kernel launches.
The plain twins run the same schedule in the plain 16-bit-limb arithmetic
of ``bn254_field``, vectorised over rows: each mix is one batched product
and a tree of modular adds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import bn254_field as bf
from . import cuda_build
from .bn254_field import FR
from .poseidon_bn254 import _all_t_tables
from .poseidon_bn254_constants import N_ROUNDS_F

ARITY = 16
T_MAX = 17
LAUNCHES = {"leaf": 0, "node": 0}
SHAPES: dict = {}   # launches by shape: leaf (h, w), node n


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def tables(t: int) -> Tuple[List[int], List[int], List[List[int]],
                            List[List[int]], int]:
    """(C, S, M, P, partial rounds) of width t as python ints (the t = 17
    tables equal the inline ones: the loader asserts it)."""
    return _all_t_tables()[t]


def mul64_products(t: int) -> int:
    """64-bit products of one width-t permutation in the kernels' schedule:
    an S-box is three CIOS products of 36; an output of a dense mix t
    double-width products of 16 and one reduction of 20; a partial round an
    S-box, a dot product of t (t * 16 + 20) and t - 1 CIOS updates."""
    n_p = tables(t)[4]
    return (N_ROUNDS_F * t * 3 * 36 + N_ROUNDS_F * t * (16 * t + 20)
            + n_p * (3 * 36 + 16 * t + 20 + (t - 1) * 36))


def mont_products(t: int) -> int:
    """Montgomery products of one width-t permutation in the optimized
    schedule: the S-boxes (3 products each) and the mixes, the dense ones
    t^2 products each, a partial round 2t - 1."""
    n_p = tables(t)[4]
    return N_ROUNDS_F * t * 3 + N_ROUNDS_F * t * t + n_p * (3 + 2 * t - 1)


@functools.lru_cache(maxsize=None)
def _flat_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Every width's tables, Montgomery form, as one (N, 4) uint64 array,
    and a (18, 5) int32 array of (C, S, M, P offsets, partial rounds) by t.
    M and P are stored as written, entry [j][i] at (j * t + i)."""
    vals: List[int] = []
    meta = np.zeros((T_MAX + 1, 5), dtype=np.int32)
    for t in range(2, T_MAX + 1):
        c, s, m, p, n_p = tables(t)
        meta[t, 0] = len(vals)
        vals += c
        meta[t, 1] = len(vals)
        vals += s
        meta[t, 2] = len(vals)
        vals += [x for row in m for x in row]
        meta[t, 3] = len(vals)
        vals += [x for row in p for x in row]
        meta[t, 4] = n_p
    mont = [(v % FR.mod) * FR.r % FR.mod for v in vals]
    return bf.ints_to_limbs(mont), meta


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    data, meta = _flat_tables()
    return (bf.from_u64(data, device),
            torch.from_numpy(meta.reshape(-1).copy()).to(device))


@functools.lru_cache(maxsize=None)
def _tables16(t: int, device: torch.device) -> Dict[str, object]:
    c, s, m, p, n_p = tables(t)

    def mat(rows):
        return bf.ints_to16(FR, [x for row in rows for x in row],
                            device).reshape(t, t, bf.N16)

    return {"c": bf.ints_to16(FR, c, device), "s": bf.ints_to16(FR, s, device),
            "m": mat(m), "p": mat(p), "n_p": n_p}


# ---------------------------------------------------------------------------
# Plain twins (16-bit limbs, Montgomery form inside)
# ---------------------------------------------------------------------------


def _sum16(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over dim -2 of (..., k, 16) by a tree of adds."""
    while x.shape[-2] > 1:
        k = x.shape[-2]
        head = bf.add16(FR, x[..., :k // 2 * 2:2, :], x[..., 1:k // 2 * 2:2, :])
        x = torch.cat([head, x[..., k // 2 * 2:, :]], dim=-2)
    return x[..., 0, :]


def _mix16(st: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j mat[j][i] * st[j] for (..., t, 16) states."""
    return _sum16(bf.mul16(FR, st[..., :, None, :], mat).transpose(-2, -3))


def _sbox16(x: torch.Tensor) -> torch.Tensor:
    x2 = bf.sqr16(FR, x)
    return bf.mul16(FR, bf.sqr16(FR, x2), x)


def permute16(st: torch.Tensor) -> torch.Tensor:
    """The width-t permutation (t = st.shape[-2]) of Montgomery-form
    (..., t, 16) states: the schedule of ``poseidon_bn254.permute_t``."""
    t = st.shape[-2]
    tb = _tables16(t, st.device)
    c, s = tb["c"], tb["s"]
    half_f = N_ROUNDS_F // 2
    st = bf.add16(FR, st, c[:t])
    for r in range(half_f - 1):
        st = bf.add16(FR, _sbox16(st), c[(r + 1) * t:(r + 2) * t])
        st = _mix16(st, tb["m"])
    st = bf.add16(FR, _sbox16(st), c[half_f * t:(half_f + 1) * t])
    st = _mix16(st, tb["p"])
    c0 = (half_f + 1) * t
    for r in range(tb["n_p"]):
        s0 = bf.add16(FR, _sbox16(st[..., 0, :]), c[c0 + r])
        st = torch.cat([s0[..., None, :], st[..., 1:, :]], dim=-2)
        base = (2 * t - 1) * r
        prods = bf.mul16(FR, torch.cat(
            [st, s0[..., None, :].expand(st.shape[:-2] + (t - 1, bf.N16))],
            dim=-2), s[base:base + 2 * t - 1])
        st = torch.cat([_sum16(prods[..., :t, :])[..., None, :],
                        bf.add16(FR, st[..., 1:, :], prods[..., t:, :])],
                       dim=-2)
    c1 = c0 + tb["n_p"]
    for r in range(half_f - 1):
        st = bf.add16(FR, _sbox16(st), c[c1 + r * t:c1 + (r + 1) * t])
        st = _mix16(st, tb["m"])
    return _mix16(_sbox16(st), tb["m"])


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """(..., t, 4) plain canonical Fr states -> the permuted states, plain."""
    st = bf.mul16(FR, bf.to16(state), _r2_16(state.device))
    return bf.from16(bf.mul16(FR, permute16(st), _one16(state.device)))


@functools.lru_cache(maxsize=None)
def _r2_16(device) -> torch.Tensor:
    return bf.to16(bf.from_u64(bf.ints_to_limbs([FR.r2]), device))[0]


@functools.lru_cache(maxsize=None)
def _one16(device) -> torch.Tensor:
    return bf.to16(bf.from_u64(bf.ints_to_limbs([1]), device))[0]


def _words16(rows: torch.Tensor) -> torch.Tensor:
    """(H, k <= 4) GL words -> (H, 16) limbs of sum_i w_i 2^(64 i)."""
    pad = rows.new_zeros((rows.shape[0], bf.N_LIMBS - rows.shape[1]))
    return bf.to16(torch.cat([rows, pad], dim=1))


def leaf_hash_plain(rows: torch.Tensor) -> torch.Tensor:
    """(H, W) GL words -> (H, 4) plain canonical Fr leaves."""
    h, w = rows.shape
    dev = rows.device
    if w <= 4:
        x = _words16(rows)
        for _ in range(5):           # 2^256 / r < 6
            x = bf._cond_sub(FR, x)
        return bf.from16(x)
    n_fr = -(-w // 3)
    packed = torch.stack([_words16(rows[:, 3 * k:3 * k + 3])
                          for k in range(n_fr)], dim=1)
    packed = bf.mul16(FR, packed, _r2_16(dev))          # to Montgomery
    acc = torch.zeros((h, bf.N16), dtype=torch.int64, device=dev)
    for off in range(0, n_fr, ARITY):
        chunk = packed[:, off:off + ARITY]
        acc = permute16(torch.cat([acc[:, None, :], chunk], dim=1))[:, 0]
    return bf.from16(bf.mul16(FR, acc, _one16(dev)))


def node_hash_plain(level: torch.Tensor) -> torch.Tensor:
    """(n, 4) plain canonical Fr -> (ceil(n / 16), 4): hash16 of each group
    of 16, zero past the end."""
    n = level.shape[0]
    groups = -(-n // ARITY)
    x = torch.cat([level, level.new_zeros((groups * ARITY - n, 4))])
    st = bf.mul16(FR, bf.to16(x).reshape(groups, ARITY, bf.N16),
                  _r2_16(level.device))
    st = torch.cat([st.new_zeros((groups, 1, bf.N16)), st], dim=1)
    return bf.from16(bf.mul16(FR, permute16(st)[:, 0], _one16(level.device)))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 carrier, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-dim tensor, "
                         f"got {tuple(t.shape)}")


def leaf_hash(rows: torch.Tensor) -> torch.Tensor:
    """(H, W) GL words (int64 carrier) -> (H, 4) plain canonical Fr
    leaves (``merkle_bn128.leaf_hash`` of every row)."""
    if not rows.is_cuda:
        return leaf_hash_plain(rows)
    _check(rows, "leaf_hash", 2)
    h, w = rows.shape
    out = torch.empty((h, 4), dtype=torch.int64, device=rows.device)
    if h == 0:
        return out
    lib = cuda_build.lib()
    vp = ctypes.c_void_p
    stream = vp(cuda_build.stream_ptr())
    if w <= 4:
        cuda_build.check(lib.merlin_bn_poseidon_words(
            vp(rows.data_ptr()), h, w, vp(out.data_ptr()), stream),
            "bn254 leaf words")
        cuda_build.count(LAUNCHES, SHAPES, "leaf", (h, w))
        return out
    data, meta = _device_tables(rows.device)
    cap = None
    plan = sponge_plan(w)
    for k, (t, first, n_chunks) in enumerate(plan):
        final = k == len(plan) - 1
        dst = out if final else torch.empty((h, 4), dtype=torch.int64,
                                            device=rows.device)
        cuda_build.check(lib.merlin_bn_poseidon_sponge(
            vp(rows.data_ptr()), h, w, t, first, n_chunks,
            vp(cap.data_ptr() if cap is not None else 0), int(final),
            vp(data.data_ptr()), vp(meta.data_ptr()), vp(dst.data_ptr()),
            stream), "bn254 leaf sponge")
        cuda_build.count(LAUNCHES, SHAPES, "leaf", (h, w))
        cap = dst
    return out


def sponge_plan(w: int) -> List[Tuple[int, int, int]]:
    """The sponge launches of a width-w row (w > 4): (t, first element,
    chunks) for the full 16-element chunks at t = 17 (when the row has
    more than one chunk) and for the last chunk at its own t."""
    n_fr = -(-w // 3)
    n_full = (n_fr - 1) // ARITY
    last = [(n_fr - ARITY * n_full + 1, ARITY * n_full, 1)]
    return ([(ARITY + 1, 0, n_full)] if n_full else []) + last


def node_hash(level: torch.Tensor) -> torch.Tensor:
    """(n, 4) plain canonical Fr -> (ceil(n / 16), 4) parents."""
    if not level.is_cuda:
        return node_hash_plain(level)
    _check(level, "node_hash", 2)
    n = level.shape[0]
    out = torch.empty((-(-n // ARITY), 4), dtype=torch.int64,
                      device=level.device)
    if n == 0:
        return out
    data, meta = _device_tables(level.device)
    lib = cuda_build.lib()
    vp = ctypes.c_void_p
    cuda_build.check(lib.merlin_bn_poseidon_node(
        vp(level.data_ptr()), n, vp(data.data_ptr()), vp(meta.data_ptr()),
        vp(out.data_ptr()), vp(cuda_build.stream_ptr())), "bn254 node hash")
    cuda_build.count(LAUNCHES, SHAPES, "node", n)
    return out


def merkelize(rows: torch.Tensor) -> List[torch.Tensor]:
    """Every level of the arity-16 tree over the rows, leaves first, the
    root (1, 4) last (``MerkleTreeBN128``'s levels), on the rows' device."""
    levels = [leaf_hash(rows)]
    while levels[-1].shape[0] > 1:
        levels.append(node_hash(levels[-1]))
    return levels
