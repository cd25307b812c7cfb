"""Lower a gate circuit to a 24-column plonkish AIR ("plonk12c").

The reference compresses each STARK into a 12-wire plonk circuit with
custom Poseidon gates (c12a — reference src/starkpil/starkC12a/,
config.hpp:26-28); this is the framework-native equivalent, emitted
directly as an AIR for the existing STARK engine:

  columns:     w0..w11 (wires) + k0..k11 (Poseidon cube intermediates)
  gates:       4 generic plonk gates per row over wire triples
               (qL,qR,qO,qM,qC per slot — 20 selector constants)
  poseidon:    one permutation = 31 consecutive rows; per-row constants
               C0..C11 hold the round constants; qPosF/qPosP select
               full/partial round transition constraints (degree 4 via the
               committed cube columns k_j = (w_j + C_j)^3)
  copies:      plonk sigma permutation over w0..w11 via a 12-column
               connection argument (compiler chains the 12-factor grand
               product through im pols)
  publics:     packed 12 per row at the top, pinned with row selectors

All constraints have degree <= 4, so the STARK uses blowup 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import accumulate, repeat
from typing import Optional, Tuple

import numpy as np

from ..ops.goldilocks import P, w as gl_w
from ..ops.poseidon_constants import MDS, ROUND_CONSTANTS, WIDTH
from ..stark.air import AIR
from .gates import Circuit

N_ROUNDS = 30
HALF_F = 4
N_PARTIAL = 22
BLOCK_ROWS = N_ROUNDS + 1


@dataclass
class Layout:
    n_bits: int
    n_pub_rows: int
    n_gate_rows: int
    n_pos_rows: int

    @property
    def n(self):
        return 1 << self.n_bits

    @property
    def gate_base(self):
        return self.n_pub_rows

    @property
    def pos_base(self):
        return self.n_pub_rows + self.n_gate_rows


def plan_layout(c: Circuit, n_bits: Optional[int] = None) -> Layout:
    n_pub_rows = -(-len(c.public_wires) // WIDTH)
    n_gate_rows = -(-len(c.gates) // 4)
    n_pos_rows = BLOCK_ROWS * len(c.pos_blocks)
    total = n_pub_rows + n_gate_rows + n_pos_rows
    need_bits = max(3, (total - 1).bit_length() if total > 1 else 1)
    if n_bits is None:
        n_bits = need_bits
    assert (1 << n_bits) >= total, (
        f"circuit needs {total} rows > 2^{n_bits}")
    return Layout(n_bits, n_pub_rows, n_gate_rows, n_pos_rows)


def _slot_map(c: Circuit, lay: Layout) -> np.ndarray:
    """All copy-relevant slots as (m, 3) rows (wire, row, col < 12), in
    placement order: the publics, each gate's a, b, c, each Poseidon
    block's states."""
    n_pub, n_g = len(c.public_wires), len(c.gates)
    i = np.arange(n_pub, dtype=np.int64)
    pub = np.stack([np.array(c.public_wires, dtype=np.int64).reshape(n_pub),
                    i // WIDTH, i % WIDTH], axis=1)
    g = np.arange(n_g, dtype=np.int64)
    abc = np.array([(gate.a, gate.b, gate.c) for gate in c.gates],
                   dtype=np.int64).reshape(n_g, 3)
    gates = np.stack([abc.reshape(-1),
                      np.repeat(lay.gate_base + g // 4, 3),
                      (3 * (g % 4)[:, None] + np.arange(3)).reshape(-1)],
                     axis=1)
    states = np.array([blk.states for blk in c.pos_blocks],
                      dtype=np.int64).reshape(len(c.pos_blocks), BLOCK_ROWS,
                                              WIDTH)
    rows = (lay.pos_base + BLOCK_ROWS * np.arange(len(c.pos_blocks))[:, None]
            + np.arange(BLOCK_ROWS))
    pos = np.stack([states.reshape(-1),
                    np.repeat(rows.reshape(-1), WIDTH),
                    np.tile(np.arange(WIDTH), rows.size)], axis=1)
    return np.concatenate([pub, gates, pos]).astype(np.int64, copy=False)


def _block_rows(c: Circuit, lay: Layout, k: int) -> np.ndarray:
    """(blocks, k) trace rows of each Poseidon block's first k rows."""
    return (lay.pos_base + BLOCK_ROWS * np.arange(len(c.pos_blocks))[:, None]
            + np.arange(k))


def fill_trace(c: Circuit, lay: Layout,
               slots: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 24) uint64 witness trace for the circuit under this layout
    (`slots`: _slot_map's, when the caller has it)."""
    n = lay.n
    if slots is None:
        slots = _slot_map(c, lay)
    values = np.array(c.values, dtype=np.uint64)
    trace = np.zeros((n, 2 * WIDTH), dtype=np.uint64)
    trace[slots[:, 1], slots[:, 2]] = values[slots[:, 0]]
    if c.pos_blocks:
        cubes = np.array([blk.cubes for blk in c.pos_blocks], dtype=np.int64)
        trace[_block_rows(c, lay, N_ROUNDS)[:, :, None],
              WIDTH + np.arange(WIDTH)] = values[cubes]
    return trace


def circuit_to_air(c: Circuit, name: str,
                   n_bits: Optional[int] = None) -> Tuple[AIR, np.ndarray,
                                                          Layout]:
    """Build the plonk12c AIR + satisfying trace for a circuit."""
    lay = plan_layout(c, n_bits)
    n = lay.n
    air = AIR(name, lay.n_bits)

    w_cols = [air.committed(f"w{j}") for j in range(WIDTH)]
    cube_cols = [air.committed(f"k{j}") for j in range(WIDTH)]

    # ---- publics (packed 12 per row) ----
    for i in range(len(c.public_wires)):
        air.public(f"pub{i}", w_cols[i % WIDTH], i // WIDTH)

    # ---- constant columns ----
    q_pos_f = np.zeros(n, dtype=np.uint64)
    q_pos_p = np.zeros(n, dtype=np.uint64)
    c_cols = np.zeros((n, WIDTH), dtype=np.uint64)
    rows = _block_rows(c, lay, N_ROUNDS)
    full = np.array([r < HALF_F or r >= HALF_F + N_PARTIAL
                     for r in range(N_ROUNDS)])
    q_pos_f[rows[:, full]] = 1
    q_pos_p[rows[:, ~full]] = 1
    c_cols[rows] = np.array([v % P for v in ROUND_CONSTANTS[:N_ROUNDS * WIDTH]],
                            dtype=np.uint64).reshape(N_ROUNDS, WIDTH)

    qsel = np.zeros((n, 4, 5), dtype=np.uint64)  # [row, slot, (L,R,O,M,C)]
    first = 4 * lay.gate_base                     # gate g: row base + g // 4
    qsel.reshape(4 * n, 5)[first:first + len(c.gates)] = np.array(
        [(gate.ql % P, gate.qr % P, gate.qo % P, gate.qm % P, gate.qc % P)
         for gate in c.gates], dtype=np.uint64).reshape(len(c.gates), 5)

    # sigma columns: S_c[r] = k_{c'} * w^{r'} for the cycle successor, the
    # identity's k_c * w^r where a wire has one slot
    wn = gl_w(lay.n_bits)
    xs = list(accumulate(repeat(wn, n - 1), lambda a, b: a * b % P,
                         initial=1))
    ks = [pow(7, j, P) for j in range(WIDTH)]
    ident = np.empty((n, WIDTH), dtype=np.uint64)
    for j in range(WIDTH):
        ident[:, j] = [x * ks[j] % P for x in xs]
    slots = _slot_map(c, lay)
    # each wire's slots in placement order (a stable sort by wire), each
    # slot pointing at the next one of its wire, the last at the first
    order = np.argsort(slots[:, 0], kind="stable")
    wid = slots[order, 0]
    at = np.arange(len(order))
    first_of = np.r_[True, wid[1:] != wid[:-1]]
    last_of = np.r_[wid[1:] != wid[:-1], True]
    nxt = np.where(last_of, np.maximum.accumulate(np.where(first_of, at, 0)),
                   at + 1)
    cyc = ~(first_of & last_of)
    src, dst = slots[order[cyc]], slots[order[nxt[cyc]]]
    s_cols = ident.copy()
    s_cols[src[:, 1], src[:, 2]] = ident[dst[:, 1], dst[:, 2]]

    e_pos_f = air.constant("qPosF", q_pos_f)
    e_pos_p = air.constant("qPosP", q_pos_p)
    e_c = [air.constant(f"C{j}", c_cols[:, j]) for j in range(WIDTH)]
    e_q = [[air.constant(f"q{nm}{s}", qsel[:, s, qi])
            for qi, nm in enumerate("LROMC")] for s in range(4)]
    e_s = [air.constant(f"S{j}", s_cols[:, j]) for j in range(WIDTH)]

    # ---- constraints ----
    for s in range(4):
        ql, qr, qo, qm, qc = e_q[s]
        a, b, o = w_cols[3 * s], w_cols[3 * s + 1], w_cols[3 * s + 2]
        air.constraint(ql * a + qr * b + qo * o + qm * a * b + qc)

    a_of = [w_cols[j] + e_c[j] for j in range(WIDTH)]
    q_pos = e_pos_f + e_pos_p
    for j in range(WIDTH):
        air.constraint(q_pos * (cube_cols[j] - a_of[j] * a_of[j] * a_of[j]))
    sbox_full = [cube_cols[j] * cube_cols[j] * a_of[j] for j in range(WIDTH)]
    for k in range(WIDTH):
        acc = None
        for j in range(WIDTH):
            term = MDS[k][j] * sbox_full[j]
            acc = term if acc is None else acc + term
        air.constraint(e_pos_f * (w_cols[k].next() - acc))
    sbox_part = [sbox_full[0]] + a_of[1:]
    for k in range(WIDTH):
        acc = None
        for j in range(WIDTH):
            term = MDS[k][j] * sbox_part[j]
            acc = term if acc is None else acc + term
        air.constraint(e_pos_p * (w_cols[k].next() - acc))

    air.connection(w_cols, e_s)

    trace = fill_trace(c, lay, slots)
    return air, trace, lay
