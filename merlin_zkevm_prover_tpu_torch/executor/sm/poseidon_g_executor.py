"""PoseidonG SM (reference src/sm/poseidon_g/poseidon_g_executor.cpp).

Each hash occupies 31 rows: the input row followed by one row per round
(30 rounds); columns in0..in7/hashType/cap1..3 carry the rolling state and
hash0..3 pin the result across the slot.  Unused rows repeat the
all-zeros-input round trace (reference :227-292).

The JAX package fills these columns in python ints, one permutation and 30
rounds a hash (``executor/sm/poseidon_g_executor.py:25, 55-76``).  Here the
whole trace is one launch of kernel S1 (``csrc/poseidon_gl.cu``
``pg_trace_kernel``) over every slot at once, the padding slots launched as
inputs of zeros, the dead rows zeroed by the same launch;
``round_trace_plain`` is its plain PyTorch version (the 30 rounds over all
slots at once).  ``round_trace`` takes the plain version only for a tensor
on the CPU; on a CUDA tensor it launches S1 or raises.  ``LAUNCHES`` counts
S1's launches and nothing else.  The result flags are a scatter, the digest
check one comparison on the device.

S1 is bound by its bytes: 16 words written a row and 12 read a slot (1.07
GB at ``2^23`` rows, its 118 S-boxes a slot a tenth of that time).  Its
stores decide its speed: a slot writes 31 rows a column, so rows stored as
computed land 31 words apart across a warp and fill each 128-B line over 16
rounds, with a gigabyte of lines open at once.  S1 gives each lane a
contiguous run of ``run`` slots (``trace_plan``: as few as lets every lane
be resident at once, and odd), stages each row in shared memory until its
line is complete and lets its warp store the line: consecutive lanes on
consecutive words, whole lines.  The rows wait in pools that the 16 lanes
of a half-warp share (816 bytes a lane instead of a 1.5 KB ring, so 8 warps
fit an SM); ``pool_word`` is where a row waits, and the tests count the
bank conflicts of those accesses.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from ...ops import cuda_build
from ...ops import goldilocks as gl
from ...ops import poseidon_cuda
from ...ops.goldilocks import P
from ...ops.poseidon_constants import (
    CAPACITY,
    MDS,
    N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    ROUND_CONSTANTS,
    WIDTH,
)

SLOT_ROWS = N_FULL_ROUNDS + N_PARTIAL_ROUNDS + 1  # 31
TRACE_COLS = WIDTH + CAPACITY                     # 12 state + 4 digest words

LAUNCHES = {"round_trace": 0}
LINE = 16  # 64-bit words in a 128-B line


def _round(state: List[int], r: int) -> List[int]:
    """Round r of the permutation in python ints (the JAX package's
    ``_round``): the trace row that follows ``state``."""
    st = [(state[s] + ROUND_CONSTANTS[r * WIDTH + s]) % P for s in range(12)]
    if r < N_FULL_ROUNDS // 2 or r >= N_FULL_ROUNDS // 2 + N_PARTIAL_ROUNDS:
        st = [pow(x, 7, P) for x in st]
    else:
        st[0] = pow(st[0], 7, P)
    return [sum(MDS[x][y] * st[y] for y in range(12)) % P for x in range(12)]


def _check_states(states: torch.Tensor, n: int) -> int:
    if states.dtype != torch.int64:
        raise TypeError(f"round_trace: expected int64 carrier, got "
                        f"{states.dtype}")
    if states.ndim != 2 or states.shape[0] != WIDTH:
        raise ValueError(f"round_trace: expected (12, S), got "
                         f"{tuple(states.shape)}")
    slots = states.shape[1]
    if n < slots * SLOT_ROWS:
        raise ValueError(f"round_trace: {slots} slots need {slots * SLOT_ROWS}"
                         f" rows, n = {n}")
    return slots


def round_trace_plain(states: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch round trace: (12, S) words in [0, 2^64) -> (16, n).

    Slot k's rows are k * 31 .. k * 31 + 30: row 0 the input reduced mod
    p, row r + 1 the state after round r; rows 12..15 carry the digest
    (row 30's first four words) on all 31 rows; rows past 31 * S are
    zero."""
    slots = _check_states(states, n)
    out = torch.zeros((TRACE_COLS, n), dtype=torch.int64, device=states.device)
    slot_rows = out[:, :slots * SLOT_ROWS].view(TRACE_COLS, slots, SLOT_ROWS)
    st = gl.canon(states)
    slot_rows[:WIDTH, :, 0] = st
    rc = gl.from_u64(poseidon_cuda._rc_np(), states.device)
    for r in range(SLOT_ROWS - 1):
        st = gl.add(st, rc[r][:, None])
        if r < N_FULL_ROUNDS // 2 or r >= N_FULL_ROUNDS // 2 + N_PARTIAL_ROUNDS:
            st = gl.pow7(st)
        else:
            st = torch.cat([gl.pow7(st[:1]), st[1:]], dim=0)
        st = poseidon_cuda._mds(st)
        slot_rows[:WIDTH, :, r + 1] = st
    slot_rows[WIDTH:] = st[:CAPACITY, :, None]
    return out


def pool_word(s: int, f: int, odd: int) -> int:
    """S1's pools (``csrc/poseidon_gl.cu`` ``pg_pool_word``): the word, in
    a column pair's 17 x 16 array, of entry ``s`` (in ``[0, 16 - f)``) of
    the pool that holds row ``f`` of a line, for the pair's even or odd
    column.  A row staged at step ``tau`` takes entry ``tau % (16 - f)``."""
    return LINE * (LINE - s) + LINE - 1 - f if odd else LINE * s + f


def trace_plan(slots: int, device: torch.device, run: int = 0) -> Dict[str, int]:
    """S1's launch for `slots` >= 1 slots on `device` (the card), as the
    library plans it (``csrc/poseidon_gl.cu`` ``pg_trace_plan``): `run`
    slots a lane (odd; 0: the fewest that lets every lane be resident at
    once, made odd), the blocks that cover them and their threads."""
    buf = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        cuda_build.check(poseidon_cuda._lib().merlin_poseidon_trace_plan(
            slots, run, buf), "round_trace plan")
    return dict(zip(("run", "blocks", "threads"), buf))


def round_trace(states: torch.Tensor, n: int) -> torch.Tensor:
    """The PoseidonG round trace of every slot (S1 on the card):
    (12, S) lane-major words in [0, 2^64) -> (16, n) canonical, the
    layout of ``round_trace_plain``."""
    slots = _check_states(states, n)
    if states.device.type == "cpu":
        return round_trace_plain(states, n)
    if states.device.type != "cuda":
        raise RuntimeError(f"round_trace: unsupported device {states.device}")
    if not slots:
        return torch.zeros((TRACE_COLS, n), dtype=torch.int64,
                           device=states.device)
    return _launch_trace(states.contiguous(), n)


def _launch_trace(st: torch.Tensor, n: int, run: int = 0) -> torch.Tensor:
    """One launch of S1 on a contiguous CUDA (12, S) state, S >= 1, with
    `run` slots a lane (``trace_plan``; 0: the library's choice)."""
    slots = st.shape[1]
    out = torch.empty((TRACE_COLS, n), dtype=torch.int64, device=st.device)
    with torch.cuda.device(st.device):
        code = poseidon_cuda._lib().merlin_poseidon_trace(
            st.data_ptr(), out.data_ptr(), slots, n, run,
            cuda_build.stream_ptr())
    LAUNCHES["round_trace"] += 1
    cuda_build.check(code, "round_trace launch")
    return out


Inputs = Union[Sequence[Sequence[int]], np.ndarray]


def _as_matrix(inputs: Inputs):
    """The inputs as a (B, 17) object matrix of python ints and each
    input's length (words past the 17th are not read, as in the JAX
    package).  A list of lists is flattened without a python loop over its
    inputs."""
    if isinstance(inputs, np.ndarray):
        if inputs.ndim != 2 or inputs.shape[1] not in (12, 16, 17):
            raise ValueError("PoseidonG inputs: expected a (B, 12), (B, 16) "
                             f"or (B, 17) array, got {inputs.shape}")
        b, w = inputs.shape
        mat = np.zeros((b, 17), dtype=object)
        mat[:, :w] = inputs.astype(object)
        return mat, np.full(b, w, dtype=np.int64)
    b = len(inputs)
    lens = np.fromiter(map(len, inputs), dtype=np.int64, count=b)
    if b and lens.min() < WIDTH:
        raise ValueError("PoseidonG inputs: a state has fewer than 12 words")
    flat = np.fromiter(itertools.chain.from_iterable(inputs), dtype=object,
                       count=int(lens.sum()))
    rows = np.repeat(np.arange(b), lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    keep = cols < 17
    mat = np.zeros((b, 17), dtype=object)
    mat[rows[keep], cols[keep]] = flat[keep]
    return mat, lens


class PoseidonGExecutor:
    STATE_COLS = ["in0", "in1", "in2", "in3", "in4", "in5", "in6", "in7",
                  "hashType", "cap1", "cap2", "cap3"]
    COLUMNS = STATE_COLS + ["hash0", "hash1", "hash2", "hash3",
                            "result1", "result2", "result3"]

    # permutation-id -> result flag column (reference
    # poseidon_g_permutation.hpp: 1 = Main Kin0 key hash, 2 = Main Kin1,
    # 3 = Storage SMT node hash, 4 = PaddingPG — no committed flag)
    RESULT_COLS = {1: "result1", 2: "result2", 3: "result3", 4: None}

    def execute(self, inputs: Inputs, n: int,
                device=None) -> Dict[str, torch.Tensor]:
        """inputs: 12-felt states, optionally 16/17 words with the expected
        hash and the permutation id (reference input[i][12..16]), as a list
        of lists or a (B, 12|16|17) array of words.  Returns the 19 columns
        as int64 tensors of length n on the device (the card unless
        ``device="cpu"``).  Raises ValueError on overflow or on an expected
        hash (compared as raw words) that differs from the digest, KeyError
        on an unknown permutation id: the error of the first input that
        fails, as the JAX package's loop raises."""
        dev = gl.resolve_device(device)
        max_hashes = n // SLOT_ROWS
        if len(inputs) > max_hashes:
            raise ValueError(
                f"PoseidonG overflow: {len(inputs)} > {max_hashes}"
            )
        mat, lens = _as_matrix(inputs)
        b = len(lens)
        states = np.zeros((WIDTH, max_hashes), dtype=np.uint64)
        if b:
            states[:, :b] = (mat[:, :WIDTH] % P).astype(np.uint64).T
        trace = round_trace(gl.from_u64(states, dev), n)

        # the first input whose expected hash differs, then the first whose
        # permutation id is unknown (ids default to 1)
        bad_hash = np.zeros(b, dtype=bool)
        checked = np.flatnonzero(lens >= 16)
        if len(checked):
            expect = mat[checked, WIDTH:WIDTH + CAPACITY]
            in_range = ((expect >= 0) & (expect < 1 << 64)).all(axis=1)
            words = np.where(in_range[:, None], expect, 0).astype(np.uint64)
            digest = trace[WIDTH:, checked * SLOT_ROWS].T
            differs = (digest != gl.from_u64(words, dev)).any(dim=1)
            bad_hash[checked] = ~in_range | differs.cpu().numpy()
        perm = np.where(lens >= 17, mat[:, 16], 1)
        ids = np.zeros(b, dtype=np.int64)
        known = np.zeros(b, dtype=bool)
        for pid in self.RESULT_COLS:
            hit = perm == pid
            ids[hit] = pid
            known |= hit
        first_hash = int(np.argmax(bad_hash)) if bad_hash.any() else b
        first_id = int(np.argmax(~known)) if not known.all() else b
        if first_hash < b and first_hash <= first_id:
            raise ValueError("PoseidonG digest mismatch")
        if first_id < b:
            raise KeyError(perm[first_id])

        pols = {c: trace[i] for i, c in enumerate(self.COLUMNS[:TRACE_COLS])}
        for pid, col in self.RESULT_COLS.items():
            if col is None:
                continue
            flag = torch.zeros(n, dtype=torch.int64, device=dev)
            rows = torch.from_numpy(np.flatnonzero(ids == pid) * SLOT_ROWS)
            flag[rows.to(dev)] = 1
            pols[col] = flag
        return pols
