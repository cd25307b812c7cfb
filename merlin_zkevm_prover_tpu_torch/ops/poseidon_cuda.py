"""Poseidon-Goldilocks permutation and Merkle commitment: CUDA kernels and
their plain twins.

Counterpart of the reference's ``ops/poseidon_tpu.py``.  Three kernels, all
in ``csrc/poseidon_gl.cu``, each with a plain PyTorch twin here
(``permute_plain``, which the other two plain versions call, and
``linear_hash_plain``, ``node_hash_plain``):

``permute``  replaces ``_permute_kernel`` (``_permute_call``,
    ``permute_tpu``): the 30-round permutation of a batch of states in the
    reference's lane-major ``(12, B)`` layout.  One thread per state, the
    state in registers; thread ``k`` reads word ``i`` at ``i * B + k``, so
    every load and store of a warp is coalesced.  Bound: 96 bytes in and 96
    out per permutation against thousands of 32-bit multiply-adds, so the
    card's integer multiply rate bounds it, not its memory.  The kernel runs
    the same dense-MDS rounds as the two below.

``linear_hash``  replaces ``_linear_hash_kernel`` (``_linear_hash_call``,
    ``linear_hash_tpu``).  One thread per row of the row-major (H, W)
    matrix, the 12-word state in registers, the whole rate-8 sponge in the
    kernel: the row is read once and 4 words are written.  No transpose
    pass: the LDE's output is hashed as it stands.  Bound: each row costs
    ceil(W/8) permutations, each of 472 64-bit field multiplies in the
    S-boxes and, as the kernel does it, a dense 12 x 12 small-coefficient
    MDS in all 30 rounds (8,700 32-bit multiply-adds), against 8*W bytes
    read, so the card's integer multiply rate bounds it, not its memory.
    The sparse factorisation of the 22 partial rounds' matrices would cut
    the MDS work and is later work; the bound that ``chip_smoke.py``
    computes already assumes it.  The thread-per-row read of a row-major matrix is uncoalesced
    (neighbouring threads are W words apart); the rows of a warp share
    cache lines across successive chunks, which L1/L2 absorb.  Staging a
    tile of rows through shared memory is later work.

``node_hash``  replaces ``_node_hash_kernel`` (``_node_hash_call``,
    ``node_hash_tpu``; ``merkle_nodes_tpu`` drives it level by level).  One
    thread per pair; a tree level reads ``nodes[2i]``, ``nodes[2i+1]`` of
    the level below in place and writes the level above into the same
    ``(2h-1, 4)`` array, so no ``[0::2]`` / ``[1::2]`` copies exist.  Every
    level goes through the kernel, whatever its size.  Bound: one
    permutation per 96 bytes moved, so operations again.

Each wrapper takes the plain version only for a CPU tensor; on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from . import goldilocks as gl
from .goldilocks import GL, P
from .poseidon_constants import (
    CAPACITY,
    HASH_SIZE,
    MDS_CIRC,
    MDS_DIAG,
    N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    RATE,
    ROUND_CONSTANTS,
    WIDTH,
)

N_ROUNDS = N_FULL_ROUNDS + N_PARTIAL_ROUNDS
_HALF_F = N_FULL_ROUNDS // 2
_MASK32 = 0xFFFFFFFF

LAUNCHES = {"permute": 0, "linear_hash": 0, "node_hash": 0}

_constants_set = False


def _lib():
    """Kernel library with the round constants uploaded once."""
    global _constants_set
    lib = cuda_build.lib()
    if not _constants_set:
        rc = np.ascontiguousarray(_rc_np().reshape(-1))
        circ = np.asarray(MDS_CIRC, dtype=np.uint32)
        assert all(d == 0 for d in MDS_DIAG[1:])
        cuda_build.check(
            lib.merlin_poseidon_set_constants(
                rc.ctypes.data_as(ctypes.c_void_p),
                circ.ctypes.data_as(ctypes.c_void_p), int(MDS_DIAG[0])),
            "poseidon constants upload")
        _constants_set = True
    return lib


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 carrier, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def _pad_narrow(rows: GL) -> GL:
    """Rows of width <= 4 are their own digest, zero-padded (no hashing)."""
    pad = CAPACITY - rows.shape[1]
    if pad == 0:
        return rows.clone()
    return torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], dim=1)


# ---------------------------------------------------------------------------
# permute (its plain version is the one the other two plain versions call)
# ---------------------------------------------------------------------------


def _mds(state: GL) -> GL:
    """Circulant MDS on a (12, B) canonical state.

    out = sum_d CIRC[d] * roll(state, -d) (+ DIAG[0] * state on lane 0),
    summed on the 32-bit halves: the coefficients add up to less than 2^9,
    so each half-sum stays below 2^41, then one 128-bit reduction."""
    lo = state & _MASK32
    hi = (state >> 32) & _MASK32
    acc_l = lo * MDS_CIRC[0]
    acc_h = hi * MDS_CIRC[0]
    for d in range(1, WIDTH):
        acc_l = acc_l + torch.roll(lo, -d, dims=0) * MDS_CIRC[d]
        acc_h = acc_h + torch.roll(hi, -d, dims=0) * MDS_CIRC[d]
    acc_l[0] = acc_l[0] + lo[0] * MDS_DIAG[0]
    acc_h[0] = acc_h[0] + hi[0] * MDS_DIAG[0]
    low = acc_l + ((acc_h & _MASK32) << 32)
    carry = gl.ult(low, acc_l).to(torch.int64)
    high = ((acc_h >> 32) & _MASK32) + carry
    return gl._reduce128(low, high)


@functools.lru_cache(maxsize=None)
def _rc_np() -> np.ndarray:
    return np.array(
        [[ROUND_CONSTANTS[r * WIDTH + s] % P for s in range(WIDTH)]
         for r in range(N_ROUNDS)],
        dtype=np.uint64,
    )


def permute_plain(state: GL) -> GL:
    """Plain PyTorch 30-round permutation; state is (12, batch) or (12,),
    words in [0, 2^64); output canonical."""
    assert state.shape[0] == WIDTH
    squeeze = state.ndim == 1
    st = gl.canon(state.reshape(WIDTH, -1))
    rc = gl.from_u64(_rc_np(), st.device)
    for r in range(N_ROUNDS):
        st = gl.add(st, rc[r][:, None])
        if r < _HALF_F or r >= _HALF_F + N_PARTIAL_ROUNDS:
            st = gl.pow7(st)
        else:
            st = torch.cat([gl.pow7(st[:1]), st[1:]], dim=0)
        st = _mds(st)
    return st.reshape(WIDTH) if squeeze else st


def permute(state: GL) -> GL:
    """The 30-round Poseidon permutation of a (12, batch) or (12,) state,
    words in [0, 2^64); output canonical, same shape."""
    if state.dtype != torch.int64:
        raise TypeError(f"permute: expected int64 carrier, got {state.dtype}")
    if state.ndim not in (1, 2) or state.shape[0] != WIDTH:
        raise ValueError(f"permute: expected (12,) or (12, B), got "
                         f"{tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise RuntimeError(f"permute: unsupported device {state.device}")
    st = state.reshape(WIDTH, -1).contiguous()
    out = torch.empty_like(st)
    if st.shape[1]:
        lib = _lib()
        with torch.cuda.device(st.device):
            code = lib.merlin_permute(st.data_ptr(), out.data_ptr(),
                                      st.shape[1], cuda_build.stream_ptr())
        LAUNCHES["permute"] += 1
        cuda_build.check(code, "permute launch")
    return out.reshape(state.shape)


# ---------------------------------------------------------------------------
# linear_hash
# ---------------------------------------------------------------------------


def linear_hash_plain(rows: GL) -> GL:
    """Plain PyTorch rate-8 sponge over each row: (n_rows, width) -> (n, 4).

    Matches the reference ``PoseidonGoldilocks::linear_hash``: rows of
    width <= 4 come back zero-padded without hashing; otherwise the row is
    absorbed in rate-8 chunks (zero-padded), the capacity of every chunk
    after the first being the first 4 lanes of the previous permutation."""
    _check(rows, "linear_hash", 2)
    n_rows, width = rows.shape
    if width <= CAPACITY:
        return _pad_narrow(rows)
    n_chunks = -(-width // RATE)
    pad = n_chunks * RATE - width
    if pad:
        rows = torch.cat([rows, rows.new_zeros((n_rows, pad))], dim=1)
    xs = rows.reshape(n_rows, n_chunks, RATE).permute(1, 2, 0)
    digest = rows.new_zeros((CAPACITY, n_rows))
    for ci in range(n_chunks):
        digest = permute_plain(torch.cat([xs[ci], digest], dim=0))[:CAPACITY]
    return digest.T.contiguous()


def linear_hash(rows: GL) -> GL:
    _check(rows, "linear_hash", 2)
    if rows.device.type == "cpu":
        return linear_hash_plain(rows)
    if rows.device.type != "cuda":
        raise RuntimeError(f"linear_hash: unsupported device {rows.device}")
    n_rows, width = rows.shape
    if width <= CAPACITY:
        return _pad_narrow(rows)
    rows = rows.contiguous()
    out = torch.empty((n_rows, HASH_SIZE), dtype=torch.int64, device=rows.device)
    if n_rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(rows.device):
        code = lib.merlin_linear_hash(rows.data_ptr(), out.data_ptr(), n_rows,
                                      width, cuda_build.stream_ptr())
    LAUNCHES["linear_hash"] += 1
    cuda_build.check(code, "linear_hash launch")
    return out


# ---------------------------------------------------------------------------
# node_hash and the tree levels
# ---------------------------------------------------------------------------


def node_hash_plain(left: GL, right: GL) -> GL:
    """Plain PyTorch pair hash: permute([left4 | right4 | 0^4])[:4]."""
    _check(left, "node_hash left", 2)
    _check(right, "node_hash right", 2)
    n = left.shape[0]
    state = torch.cat([left.T, right.T, left.new_zeros((CAPACITY, n))], dim=0)
    return permute_plain(state)[:HASH_SIZE].T.contiguous()


def _launch_node_hash(left_ptr: int, right_ptr: int, stride: int,
                      out_ptr: int, n: int, device) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.merlin_node_hash(left_ptr, right_ptr, stride, out_ptr, n,
                                    cuda_build.stream_ptr())
    LAUNCHES["node_hash"] += 1
    cuda_build.check(code, "node_hash launch")


def node_hash(left: GL, right: GL) -> GL:
    _check(left, "node_hash left", 2)
    _check(right, "node_hash right", 2)
    if left.shape != right.shape or left.shape[1] != HASH_SIZE:
        raise ValueError("node_hash: expected two (n, 4) digest arrays")
    if left.device != right.device:
        raise ValueError("node_hash: operands on different devices")
    if left.device.type == "cpu":
        return node_hash_plain(left, right)
    if left.device.type != "cuda":
        raise RuntimeError(f"node_hash: unsupported device {left.device}")
    left, right = left.contiguous(), right.contiguous()
    n = left.shape[0]
    out = torch.empty((n, HASH_SIZE), dtype=torch.int64, device=left.device)
    if n:
        _launch_node_hash(left.data_ptr(), right.data_ptr(), HASH_SIZE,
                          out.data_ptr(), n, left.device)
    return out


def merkle_levels_(nodes: GL, h: int) -> GL:
    """Fill rows [h, 2h-1) of the (2h-1, 4) node array from its h leaves,
    in place: level by level, bottom-up, root last (the reference
    MerkleTreeGL layout).  One kernel launch per level on the GPU."""
    _check(nodes, "merkle nodes", 2)
    assert nodes.shape == (max(2 * h - 1, 0), HASH_SIZE) and nodes.is_contiguous()
    assert h >= 1 and (h & (h - 1)) == 0, "tree height must be a power of two"
    if nodes.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"merkle: unsupported device {nodes.device}")
    off, n = 0, h
    while n > 1:
        half = n // 2
        if nodes.device.type == "cpu":
            lvl = nodes[off:off + n]
            nodes[off + n:off + n + half] = node_hash_plain(lvl[0::2], lvl[1::2])
        else:
            base = nodes.data_ptr() + off * HASH_SIZE * 8
            _launch_node_hash(base, base + HASH_SIZE * 8, 2 * HASH_SIZE,
                              nodes.data_ptr() + (off + n) * HASH_SIZE * 8,
                              half, nodes.device)
        off += n
        n = half
    return nodes


def merkle_nodes(leaves: GL) -> GL:
    """All tree levels above the given (h, 4) leaf digests: (h-1, 4),
    bottom-up with the root last."""
    h = leaves.shape[0]
    if h <= 1:
        return leaves.new_zeros((0, HASH_SIZE))
    nodes = torch.empty((2 * h - 1, HASH_SIZE), dtype=torch.int64,
                        device=leaves.device)
    nodes[:h] = leaves
    return merkle_levels_(nodes, h)[h:]


def merkelize(source: GL) -> GL:
    """Full tree of a (height, width) source matrix: (2h-1, 4) node array."""
    h = source.shape[0]
    nodes = torch.empty((2 * h - 1, HASH_SIZE), dtype=torch.int64,
                        device=source.device)
    nodes[:h] = linear_hash(source)
    return merkle_levels_(nodes, h)
