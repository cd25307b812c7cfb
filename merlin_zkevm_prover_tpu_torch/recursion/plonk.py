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
from typing import Dict, List, Optional, Tuple

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


def _slot_map(c: Circuit, lay: Layout) -> List[Tuple[int, int, int]]:
    """All copy-relevant slots as (wire, row, col<12), in placement order."""
    slots: List[Tuple[int, int, int]] = []
    for i, pw in enumerate(c.public_wires):
        slots.append((pw, i // WIDTH, i % WIDTH))
    for g, gate in enumerate(c.gates):
        row = lay.gate_base + g // 4
        s = g % 4
        slots.append((gate.a, row, 3 * s))
        slots.append((gate.b, row, 3 * s + 1))
        slots.append((gate.c, row, 3 * s + 2))
    for bi, blk in enumerate(c.pos_blocks):
        base = lay.pos_base + BLOCK_ROWS * bi
        for r, st in enumerate(blk.states):
            for j, wid in enumerate(st):
                slots.append((wid, base + r, j))
    return slots


def fill_trace(c: Circuit, lay: Layout) -> np.ndarray:
    """(N, 24) uint64 witness trace for the circuit under this layout."""
    n = lay.n
    trace = np.zeros((n, 2 * WIDTH), dtype=np.uint64)
    for wid, row, col in _slot_map(c, lay):
        trace[row, col] = c.values[wid]
    for bi, blk in enumerate(c.pos_blocks):
        base = lay.pos_base + BLOCK_ROWS * bi
        for r, cubes in enumerate(blk.cubes):
            for j, wid in enumerate(cubes):
                trace[base + r, WIDTH + j] = c.values[wid]
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
    for bi in range(len(c.pos_blocks)):
        base = lay.pos_base + BLOCK_ROWS * bi
        for r in range(N_ROUNDS):
            full = r < HALF_F or r >= HALF_F + N_PARTIAL
            (q_pos_f if full else q_pos_p)[base + r] = 1
            for j in range(WIDTH):
                c_cols[base + r, j] = ROUND_CONSTANTS[r * WIDTH + j] % P

    qsel = np.zeros((n, 4, 5), dtype=np.uint64)  # [row, slot, (L,R,O,M,C)]
    for g, gate in enumerate(c.gates):
        row = lay.gate_base + g // 4
        s = g % 4
        qsel[row, s] = (gate.ql % P, gate.qr % P, gate.qo % P,
                        gate.qm % P, gate.qc % P)

    # sigma columns: S_c[r] = k_{c'} * w^{r'} for the cycle successor
    wn = gl_w(lay.n_bits)
    xs = np.empty(n, dtype=np.uint64)
    cur = 1
    for r in range(n):
        xs[r] = cur
        cur = cur * wn % P
    ks = [pow(7, j, P) for j in range(WIDTH)]
    s_cols = np.empty((n, WIDTH), dtype=np.uint64)
    for j in range(WIDTH):
        s_cols[:, j] = (xs.astype(object) * ks[j] % P).astype(np.uint64)
    wire_slots: Dict[int, List[Tuple[int, int]]] = {}
    for wid, row, col in _slot_map(c, lay):
        wire_slots.setdefault(wid, []).append((row, col))
    for wid, slots in wire_slots.items():
        if len(slots) < 2:
            continue
        for i, (r, col) in enumerate(slots):
            r2, c2 = slots[(i + 1) % len(slots)]
            s_cols[r, col] = ks[c2] * int(xs[r2]) % P

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

    trace = fill_trace(c, lay)
    return air, trace, lay
