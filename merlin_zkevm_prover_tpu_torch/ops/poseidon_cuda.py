"""Poseidon-Goldilocks permutation and Merkle commitment: CUDA kernels and
their plain twins.

Counterpart of the reference's ``ops/poseidon_tpu.py``.  The kernels are in
``csrc/poseidon_gl.cu``; each has a plain PyTorch twin here
(``permute_plain``, which the other plain versions call,
``linear_hash_plain`` and ``node_hash_plain``).

The one-thread-per-state kernels share one permutation body: words stay
lazy (any word in ``[0, 2^64)``) between rounds and are canonicalised once
where they are written; each round constant is folded into the previous
round's linear layer; the circulant MDS is computed in the frequency domain
on the 32-bit halves, with adds and small constants
(``mds_block_constants`` derives them from ``MDS_CIRC``) in place of a dense
12 x 12 product.  Bound: 96 bytes in
and out per permutation against 1,652 32-bit multiply-adds in the S-boxes'
products alone, so the card's integer multiply rate bounds every Poseidon
kernel, not its memory.

``permute``  replaces ``_permute_kernel`` (``_permute_call``,
    ``permute_tpu``): the 30-round permutation of a batch of states in the
    reference's lane-major ``(12, B)`` layout.  One thread per state; thread
    ``k`` reads word ``i`` at ``i * B + k``, so every load and store of a
    warp is coalesced.

``linear_hash``  replaces ``_linear_hash_kernel`` (``_linear_hash_call``,
    ``linear_hash_tpu``).  One thread per row of the row-major (H, W)
    matrix, the whole rate-8 sponge in the kernel: the row is read once and
    4 words are written.  The read is not coalesced (neighbouring threads
    are W words apart), but the rows of a warp share cache lines across
    successive chunks, and on the card the kernel takes no longer per
    permutation than ``permute``, whose loads are coalesced: the arithmetic,
    not the load pattern, sets its time.

``node_hash``  replaces ``_node_hash_kernel`` (``_node_hash_call``,
    ``node_hash_tpu``; ``merkle_nodes_tpu`` drives it level by level).  A
    tree level reads ``nodes[2i]``, ``nodes[2i+1]`` of the level below in
    place and writes the level above into the same ``(2h-1, 4)`` array.  A
    small level holds too few pairs to fill the card, so its time is one
    permutation's latency; ``_level_plan`` picks, per level, one of three
    kernels: one thread per pair above ``GROUP_MAX_PAIRS`` pairs, one state
    spread over a group of 16 threads (a lane each, the MDS through warp
    shuffles) up to it, and, from ``TOP_MAX_PAIRS`` pairs up to the root, one
    block that hashes all those levels in one launch.

Each wrapper takes the plain version only for a CPU tensor; on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches and nothing else (``node_hash`` counts a launch of any of its three
kernels; ``NODE_HASH_LAUNCHES`` counts them apart).
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
NODE_HASH_LAUNCHES = {"pair": 0, "group": 0, "top": 0}

# Thresholds of the node-hash dispatch, from the per-level times on an H100
# (PERF.md, K3): a level of more than GROUP_MAX_PAIRS pairs takes one thread
# per pair, a smaller one a group of 16 threads per pair; the levels from
# TOP_MAX_PAIRS pairs up to the root take one launch together.
GROUP_MAX_PAIRS = 4096
TOP_MAX_PAIRS = 16

_constants_set = False


def _lib():
    """Kernel library with the round constants uploaded once."""
    global _constants_set
    lib = cuda_build.lib()
    if not _constants_set:
        rc = np.ascontiguousarray(_rc_np().reshape(-1))
        cuda_build.check(lib.merlin_poseidon_set_constants(
            rc.ctypes.data_as(ctypes.c_void_p)), "poseidon constants upload")
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


def mds_block_constants() -> dict:
    """The frequency-domain block constants of the MDS circulant, as
    ``csrc/poseidon_gl.cu`` names them, derived from ``MDS_CIRC`` in python
    ints.

    With c(z) = sum_k CIRC[k] z^-k and the CRT index map m = (4u + 9v) mod 12,
    c becomes a polynomial in u (mod u^3 - 1) and v (mod v^4 - 1).  Its
    blocks at v = 1 (S), v = -1 (T) and v = +-i (D) are taken with the
    inverse transforms' normalisation folded in: S / 4 must have the form
    KS (1 + u + u^2) + KS u; T's 3-point transform / 12 and D's / 6 must be
    integers.  Also the circulant and the diagonal term (only on M[0][0]),
    which the kernels hold as they are.  Raises if the form does not hold
    (another matrix would need another kernel)."""
    cp = [MDS_CIRC[(-m) % WIDTH] for m in range(WIDTH)]
    s_, t_, d0, d1 = [], [], [], []
    for u in range(3):
        x0, x1, x2, x3 = (cp[(4 * u + 9 * v) % WIDTH] for v in range(4))
        s_.append(x0 + x1 + x2 + x3)
        t_.append(x0 - x1 + x2 - x3)
        d0.append(x0 - x2)
        d1.append(x1 - x3)

    def f3(p):
        return p[0] + p[1] + p[2], p[0] - p[2], p[1] - p[2]

    def exact(v, d):
        if v % d:
            raise ValueError(f"MDS block constant {v}/{d} is not an integer")
        return v // d

    ks = exact(s_[0], 4)
    if s_ != [4 * ks, 8 * ks, 4 * ks]:
        raise ValueError(f"MDS S block {s_} is not 4 KS (1, 2, 1)")
    tdc, te0, te1 = (exact(v, 12) for v in f3(t_))
    adc, a0, a1 = (exact(v, 6) for v in f3(d0))
    bdc, b0, b1 = (exact(v, 6) for v in f3(d1))
    if any(MDS_DIAG[1:]):
        raise ValueError("MDS diagonal term off M[0][0]")
    return {"PG_CIRC": list(MDS_CIRC), "PG_KS": ks, "PG_KT_DC": tdc, "PG_KT_E0": te0, "PG_KT_E1": te1,
            "PG_KD_DC0": adc, "PG_KD_DC1": bdc, "PG_KD_E00": a0,
            "PG_KD_E01": a1, "PG_KD_E10": b0, "PG_KD_E11": b1,
            "PG_MDS_DIAG0": MDS_DIAG[0]}


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


def _node_kernel(pairs: int) -> str:
    """The kernel for one level of `pairs` pairs hashed on its own."""
    return "pair" if pairs > GROUP_MAX_PAIRS else "group"


def _level_plan(h: int) -> list:
    """The launches that fill the levels above `h` leaves, in order:
    ``(kind, off, pairs)``, where ``off`` is the node row of the level read
    and ``pairs`` the pairs hashed out of it.  ``kind`` "pair" or "group"
    hashes that one level; "top" hashes it and every level above it, up to
    the root, in one launch."""
    plan, off, n = [], 0, h
    while n > 1:
        pairs = n // 2
        if pairs <= TOP_MAX_PAIRS:
            plan.append(("top", off, pairs))
            break
        plan.append((_node_kernel(pairs), off, pairs))
        off += n
        n = pairs
    return plan


def _launch_node_hash(kind: str, left_ptr: int, right_ptr: int, stride: int,
                      out_ptr: int, n: int, device) -> None:
    """One launch of the "pair" or "group" kernel over `n` pairs."""
    lib = _lib()
    fn = lib.merlin_node_hash if kind == "pair" else lib.merlin_node_hash_group
    with torch.cuda.device(device):
        code = fn(left_ptr, right_ptr, stride, out_ptr, n,
                  cuda_build.stream_ptr())
    LAUNCHES["node_hash"] += 1
    NODE_HASH_LAUNCHES[kind] += 1
    cuda_build.check(code, f"node_hash ({kind}) launch")


def _launch_merkle_top(level_ptr: int, n: int, device) -> None:
    """One launch that hashes the level of `n` digests at `level_ptr` and
    every level above it into the rows that follow it."""
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.merlin_merkle_top(level_ptr, n, cuda_build.stream_ptr())
    LAUNCHES["node_hash"] += 1
    NODE_HASH_LAUNCHES["top"] += 1
    cuda_build.check(code, "node_hash (top) launch")


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
        _launch_node_hash(_node_kernel(n), left.data_ptr(), right.data_ptr(),
                          HASH_SIZE, out.data_ptr(), n, left.device)
    return out


def merkle_levels_(nodes: GL, h: int) -> GL:
    """Fill rows [h, 2h-1) of the (2h-1, 4) node array from its h leaves,
    in place: level by level, bottom-up, root last (the reference
    MerkleTreeGL layout).  On the GPU the launches of ``_level_plan(h)``."""
    _check(nodes, "merkle nodes", 2)
    assert nodes.shape == (max(2 * h - 1, 0), HASH_SIZE) and nodes.is_contiguous()
    assert h >= 1 and (h & (h - 1)) == 0, "tree height must be a power of two"
    if nodes.device.type == "cpu":
        off, n = 0, h
        while n > 1:
            lvl = nodes[off:off + n]
            nodes[off + n:off + n + n // 2] = node_hash_plain(lvl[0::2], lvl[1::2])
            off += n
            n //= 2
        return nodes
    if nodes.device.type != "cuda":
        raise RuntimeError(f"merkle: unsupported device {nodes.device}")
    row = HASH_SIZE * 8
    for kind, off, pairs in _level_plan(h):
        base = nodes.data_ptr() + off * row
        if kind == "top":
            _launch_merkle_top(base, 2 * pairs, nodes.device)
        else:
            _launch_node_hash(kind, base, base + row, 2 * HASH_SIZE,
                              base + 2 * pairs * row, pairs, nodes.device)
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
