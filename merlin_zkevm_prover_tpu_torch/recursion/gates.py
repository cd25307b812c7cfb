"""Arithmetic-circuit builder for the recursion stages.

The reference expresses its recursion circuits in circom and ships compiled
witness calculators (reference src/starkpil/*/witness/,
src/prover/prover.cpp:558-611).  This framework builds the circuits
natively: a `Circuit` records plonk-style gates over Goldilocks with eager
witness evaluation, plus whole-Poseidon-permutation blocks that lower to
one AIR row per round — the same idea as the reference's c12a circuit
(12-wire plonk with custom Poseidon gates, reference config.hpp:26-28).

Gate semantics (3 wires a, b, c per gate):

    qL*a + qR*b + qO*c + qM*a*b + qC = 0

GF(p^3) values are triples of wires; `mul3` mirrors stark/host_field.py
(x^3 = x + 1 reduction) so in-circuit verification is gate-for-gate equal
to the host verifier semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.goldilocks import P
from ..ops.poseidon_constants import ROUND_CONSTANTS, WIDTH
from ..ops.poseidon_gl import mds_host

N_ROUNDS = 30

W3 = Tuple[int, int, int]  # three wire ids


@dataclass
class Gate:
    ql: int
    qr: int
    qo: int
    qm: int
    qc: int
    a: int
    b: int
    c: int


@dataclass
class PoseidonBlock:
    """states[r][j] wire ids for r = 0..30; cubes[r][j] for r = 0..29."""

    states: List[List[int]]
    cubes: List[List[int]]


class Circuit:
    def __init__(self):
        self.values: List[int] = []
        self.gates: List[Gate] = []
        self.pos_blocks: List[PoseidonBlock] = []
        self.public_wires: List[int] = []
        self._const_cache: Dict[int, int] = {}
        self.zero = self.witness(0)
        self._pin(self.zero, 0)
        self._const_cache[0] = self.zero
        self.one = self.const(1)

    # ------------------------------------------------------------------
    # wires
    # ------------------------------------------------------------------
    def witness(self, v: int) -> int:
        self.values.append(int(v) % P)
        return len(self.values) - 1

    def _pin(self, w: int, v: int) -> None:
        # qL*w + qC = 0  with qL=1, qC=-v
        self.gates.append(Gate(1, 0, 0, 0, (-v) % P, w, self.zero, self.zero))

    def const(self, v: int) -> int:
        v = int(v) % P
        if v not in self._const_cache:
            w = self.witness(v)
            self._pin(w, v)
            self._const_cache[v] = w
        return self._const_cache[v]

    def public_input(self, v: int) -> int:
        w = self.witness(v)
        self.public_wires.append(w)
        return w

    def expose(self, w: int) -> int:
        """Expose an existing wire's value as the next public input."""
        pw = self.public_input(self.values[w])
        self.assert_eq(pw, w)
        return pw

    def val(self, w: int) -> int:
        return self.values[w]

    # ------------------------------------------------------------------
    # base-field ops
    # ------------------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        c = self.witness((self.values[a] + self.values[b]) % P)
        self.gates.append(Gate(1, 1, P - 1, 0, 0, a, b, c))
        return c

    def sub(self, a: int, b: int) -> int:
        c = self.witness((self.values[a] - self.values[b]) % P)
        self.gates.append(Gate(1, P - 1, P - 1, 0, 0, a, b, c))
        return c

    def mul(self, a: int, b: int) -> int:
        c = self.witness(self.values[a] * self.values[b] % P)
        self.gates.append(Gate(0, 0, P - 1, 1, 0, a, b, c))
        return c

    def mul_const(self, a: int, k: int) -> int:
        k = int(k) % P
        c = self.witness(self.values[a] * k % P)
        self.gates.append(Gate(k, 0, P - 1, 0, 0, a, self.zero, c))
        return c

    def add_const(self, a: int, k: int) -> int:
        k = int(k) % P
        if k == 0:
            return a
        c = self.witness((self.values[a] + k) % P)
        self.gates.append(Gate(1, 0, P - 1, 0, k, a, self.zero, c))
        return c

    def affine(self, a: int, k: int, b: int) -> int:
        """k*a + b."""
        c = self.witness((self.values[a] * k + self.values[b]) % P)
        self.gates.append(Gate(k % P, 1, P - 1, 0, 0, a, b, c))
        return c

    def mul_add(self, a: int, b: int, d: int) -> int:
        """a*b + d (two gates)."""
        return self.add(self.mul(a, b), d)

    def lc(self, terms: Sequence[Tuple[int, int]], k: int = 0) -> int:
        """sum(coef * wire) + k, chained through affine gates."""
        terms = [(int(cf) % P, w) for cf, w in terms if int(cf) % P != 0]
        if not terms:
            return self.const(k)
        acc = None
        for cf, w in terms:
            if acc is None:
                acc = self.mul_const(w, cf) if cf != 1 else w
            else:
                acc = self.affine(w, cf, acc)
        if k % P:
            acc = self.add_const(acc, k)
        return acc

    def assert_zero(self, a: int) -> None:
        assert self.values[a] % P == 0, "assert_zero fails on witness"
        self.gates.append(Gate(1, 0, 0, 0, 0, a, self.zero, self.zero))

    def assert_eq(self, a: int, b: int) -> None:
        assert self.values[a] == self.values[b], "assert_eq fails on witness"
        self.gates.append(Gate(1, P - 1, 0, 0, 0, a, b, self.zero))

    def assert_bool(self, a: int) -> None:
        assert self.values[a] in (0, 1)
        # a*a - a = 0
        self.gates.append(Gate(P - 1, 0, 0, 1, 0, a, a, self.zero))

    def inv(self, a: int) -> int:
        v = self.values[a]
        assert v != 0, "inverse of zero"
        iv = self.witness(pow(v, P - 2, P))
        # a * iv = 1
        self.gates.append(Gate(0, 0, 0, 1, P - 1, a, iv, self.zero))
        return iv

    def is_zero(self, a: int) -> int:
        """Returns boolean wire z = (a == 0)."""
        v = self.values[a]
        z = self.witness(1 if v == 0 else 0)
        iv = self.witness(0 if v == 0 else pow(v, P - 2, P))
        # a*iv = 1 - z ; a*z = 0
        self.gates.append(Gate(0, 0, 0, 1, 0, a, z, self.zero))
        one_minus_z = self.sub(self.one, z)
        self.gates.append(Gate(0, 0, P - 1, 1, 0, a, iv, one_minus_z))
        self.assert_bool(z)
        return z

    def select(self, bit: int, x: int, y: int) -> int:
        """bit ? x : y  =  y + bit*(x - y)."""
        return self.mul_add(bit, self.sub(x, y), y)

    def decompose_bits(self, a: int, n_bits: int) -> List[int]:
        """Boolean-constrained little-endian bits with recomposition check."""
        v = self.values[a]
        bits = []
        for i in range(n_bits):
            b = self.witness((v >> i) & 1)
            self.assert_bool(b)
            bits.append(b)
        recomposed = self.lc([(1 << i, b) for i, b in enumerate(bits)])
        self.assert_eq(recomposed, a)
        return bits

    def decompose_canonical_64(self, a: int) -> List[int]:
        """64-bit decomposition with the canonicity check value < p
        (p - 1 = 2^64 - 2^32: value < p  <=>  hi32 all-ones implies lo32 == 0),
        making the bit pattern unique — required for sound in-circuit query
        derivation (transcript.get_permutations semantics)."""
        bits = self.decompose_bits(a, 64)
        hi_all = bits[32]
        for b in bits[33:]:
            hi_all = self.mul(hi_all, b)
        lo = self.lc([(1 << i, b) for i, b in enumerate(bits[:32])])
        lo_zero = self.is_zero(lo)
        # hi_all * (1 - lo_zero) == 0
        bad = self.mul(hi_all, self.sub(self.one, lo_zero))
        self.assert_zero(bad)
        return bits

    # ------------------------------------------------------------------
    # Poseidon permutation (one block = 31 AIR rows)
    # ------------------------------------------------------------------
    def poseidon(self, state: Sequence[int]) -> List[int]:
        assert len(state) == WIDTH
        states = [list(state)]
        cubes: List[List[int]] = []
        values = self.values
        st = [values[w] for w in state]
        half_f = 4
        n_partial = 22
        for r in range(N_ROUNDS):
            a = [(st[j] + ROUND_CONSTANTS[r * WIDTH + j]) % P
                 for j in range(WIDTH)]
            cube_vals = [x * x % P * x % P for x in a]
            # the round's 12 cube wires, then its 12 state wires, as
            # witness() would number them (the values are reduced already)
            cubes.append(list(range(len(values), len(values) + WIDTH)))
            values.extend(cube_vals)
            full = r < half_f or r >= half_f + n_partial
            if full:
                sbox = [cube_vals[j] * cube_vals[j] % P * a[j] % P
                        for j in range(WIDTH)]
            else:
                sbox = [cube_vals[0] * cube_vals[0] % P * a[0] % P] + a[1:]
            st = mds_host(sbox)
            states.append(list(range(len(values), len(values) + WIDTH)))
            values.extend(st)
        self.pos_blocks.append(PoseidonBlock(states, cubes))
        return states[-1]

    # ------------------------------------------------------------------
    # GF(p^3) helpers (triples of wires); mirrors stark/host_field.py
    # ------------------------------------------------------------------
    def const3(self, v) -> W3:
        if isinstance(v, int):
            v = (v, 0, 0)
        return (self.const(v[0]), self.const(v[1]), self.const(v[2]))

    def as3(self, w) -> W3:
        if isinstance(w, tuple):
            return w
        return (w, self.zero, self.zero)

    def add3(self, a: W3, b: W3) -> W3:
        a, b = self.as3(a), self.as3(b)
        return tuple(self.add(x, y) for x, y in zip(a, b))

    def sub3(self, a: W3, b: W3) -> W3:
        a, b = self.as3(a), self.as3(b)
        return tuple(self.sub(x, y) for x, y in zip(a, b))

    def mul3(self, a: W3, b: W3) -> W3:
        a0, a1, a2 = self.as3(a)
        b0, b1, b2 = self.as3(b)
        d0 = self.mul(a0, b0)
        d1 = self.add(self.mul(a0, b1), self.mul(a1, b0))
        d2 = self.add(self.add(self.mul(a0, b2), self.mul(a1, b1)),
                      self.mul(a2, b0))
        d3 = self.add(self.mul(a1, b2), self.mul(a2, b1))
        d4 = self.mul(a2, b2)
        return (self.add(d0, d3), self.add(self.add(d1, d3), d4),
                self.add(d2, d4))

    def mul3_base(self, a: W3, b: int) -> W3:
        a = self.as3(a)
        return tuple(self.mul(x, b) for x in a)

    def mul3_const(self, a: W3, k) -> W3:
        """a * constant GF(p^3) element (host ints)."""
        from ..stark.host_field import mul3 as hmul3

        if isinstance(k, int):
            k = (k, 0, 0)
        a0, a1, a2 = self.as3(a)
        k0, k1, k2 = k
        # linear in the wire components: out_i = sum_j coef_ij * a_j
        # derived from mul3 with constant b
        out0 = self.lc([(k0, a0), ((k2) % P, a1), ((k1) % P, a2)])
        out1 = self.lc([((k1) % P, a0), ((k0 + k2) % P, a1),
                        ((k1 + k2) % P, a2)])
        out2 = self.lc([((k2) % P, a0), ((k1) % P, a1), ((k0 + k2) % P, a2)])
        # cross-check witness against host semantics
        want = hmul3(tuple(self.values[x] for x in self.as3(a)), k)
        got = tuple(self.values[x] for x in (out0, out1, out2))
        assert got == want, "mul3_const coefficient derivation broken"
        return (out0, out1, out2)

    def inv3(self, a: W3) -> W3:
        from ..stark.host_field import inv3 as hinv3, mul3 as hmul3

        a = self.as3(a)
        av = tuple(self.values[x] for x in a)
        iv = hinv3(av)
        ivw = tuple(self.witness(x) for x in iv)
        prod = self.mul3(a, ivw)
        one3 = self.const3(1)
        for x, y in zip(prod, one3):
            self.assert_eq(x, y)
        return ivw

    def assert_eq3(self, a: W3, b: W3) -> None:
        a, b = self.as3(a), self.as3(b)
        for x, y in zip(a, b):
            self.assert_eq(x, y)

    def select3(self, bit: int, x: W3, y: W3) -> W3:
        x, y = self.as3(x), self.as3(y)
        return tuple(self.select(bit, u, v) for u, v in zip(x, y))

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {
            "wires": len(self.values),
            "gates": len(self.gates),
            "poseidon_blocks": len(self.pos_blocks),
            "publics": len(self.public_wires),
        }
