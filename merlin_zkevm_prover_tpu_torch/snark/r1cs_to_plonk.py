"""R1CS -> 3-wire PLONK constraint-system conversion for the fflonk
final stage (reference: the final circuit ships as a circom-generated
fflonk zkey, prover.cpp:887; here the native R1CS is PLONKized instead).

Each R1CS constraint (sum a_i w_i)(sum b_i w_i) = (sum c_i w_i) becomes:

  * addition-chain gates reducing each linear combination to one wire
    (gate: qL x + qR y + qO z = 0 with qL/qR the coefficients), and
  * one multiplication gate  la * lb - lc = 0.

Wire values are PLONK cells; equal R1CS signals across cells are linked
through the sigma copy-constraint permutation (cells holding the same
signal form one cycle).  Publics occupy the first rows' a-cells
(snarkjs convention: row j exposes public j via qL=1 + PI).

The same gates, cells and values as the JAX package's ``r1cs_to_plonk``,
built over numpy arrays instead of one python call a gate (a final R1CS
has 14 million constraints): the entries of each matrix are read once
into (linear combination, signal, coefficient id) columns, a chain's
gates and fresh signals are placed by prefix sums, and only the fresh
signals' values are python ints (a prefix sum of coefficient x witness
products within each chain).  ``constraint_gates`` and ``plonk_size``
count the gates without building them.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from ..ops import bn254_field as bf
from .fflonk import FR, PlonkCS


def _entries(rows: List[Dict[int, int]], uniq: Dict[int, int]):
    """(linear combination, signal, coefficient id) of every entry, in
    the dicts' order; `uniq` maps each distinct coefficient to its id."""
    lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
    n = int(lens.sum())
    lc = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    sig = np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64,
                      count=n)
    def values():
        return itertools.chain.from_iterable(map(dict.values, rows))

    for v in dict.fromkeys(values()):       # the few distinct ones
        uniq.setdefault(v, len(uniq))
    cid = np.fromiter(map(uniq.__getitem__, values()), dtype=np.int64,
                      count=n)
    return lc, sig, cid


class _LC:
    """One matrix's linear combinations (the JAX ``_lc_terms`` split):
    the terms (signal != 0, coefficient != 0) sorted by combination and
    signal, their count ``t``, the constant's coefficient id (-1: none),
    the single-term identities (``x`` itself: no gate) and the gates of
    each combination's addition chain."""

    def __init__(self, lc, sig, cid, n_cons: int, zero: np.ndarray,
                 one: np.ndarray):
        keep = ~zero[cid]
        lc, sig, cid = lc[keep], sig[keep], cid[keep]
        is_c = sig == 0
        self.const_id = np.full(n_cons, -1, dtype=np.int64)
        self.const_id[lc[is_c]] = cid[is_c]
        tl, ts, tc = lc[~is_c], sig[~is_c], cid[~is_c]
        if tl.size > 1 and not bool(np.all(
                (tl[1:] > tl[:-1]) | ((tl[1:] == tl[:-1]) & (ts[1:] > ts[:-1])))):
            order = np.lexsort((ts, tl))
            tl, ts, tc = tl[order], ts[order], tc[order]
        self.tl, self.ts, self.tc = tl, ts, tc
        self.t = np.bincount(tl, minlength=n_cons).astype(np.int64)
        self.first = np.cumsum(self.t) - self.t
        f = np.minimum(self.first, max(tl.size - 1, 0))
        first_one = one[tc[f]] if tl.size else np.zeros(n_cons, dtype=bool)
        self.ident = (self.t == 1) & (self.const_id < 0) & first_one
        self.gates = np.where(self.t >= 2, self.t - 1,
                              ((self.t == 1) & ~self.ident).astype(np.int64))


def _split(r1cs):
    """The three matrices' _LC and the distinct coefficients mod r."""
    uniq: Dict[int, int] = {}
    ents = [_entries(rows, uniq) for rows in (r1cs.a, r1cs.b, r1cs.c)]
    table = [int(v) % FR for v in uniq]
    zero = np.array([v == 0 for v in table], dtype=bool)
    one = np.array([v == 1 for v in table], dtype=bool)
    n_cons = len(r1cs.a)
    return [_LC(*e, n_cons, zero, one) for e in ents], table


def _main(lcs) -> np.ndarray:
    """Whether each constraint has its multiplication gate (not when all
    three sides are constants)."""
    return ~((lcs[0].t == 0) & (lcs[1].t == 0) & (lcs[2].t == 0))


def _chain_gates(rows: List[Dict[int, int]]):
    """(terms, chain gates) of each linear combination of one matrix,
    counted from the dicts' lengths and keys when no coefficient is 0 mod
    r (None otherwise: _LC reads every entry).  A final R1CS has some 10^8
    entries and a few thousand distinct coefficients."""
    values = itertools.chain.from_iterable(map(dict.values, rows))
    if any(int(v) % FR == 0 for v in dict.fromkeys(values)):
        return None
    lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
    has0 = np.fromiter(map(dict.__contains__, rows, itertools.repeat(0)),
                       dtype=bool, count=len(rows))
    t = lens - has0
    single = np.nonzero((t == 1) & ~has0)[0]
    coef = np.fromiter(itertools.chain.from_iterable(
        map(dict.values, map(rows.__getitem__, single.tolist()))),
        dtype=object, count=single.size)
    ident = np.zeros(len(rows), dtype=bool)
    ident[single] = coef % FR == 1
    return t, np.where(t >= 2, t - 1, ((t == 1) & ~ident).astype(np.int64))


def constraint_gates(r1cs) -> np.ndarray:
    """The PLONK gates each constraint turns into (chains and the
    multiplication gate), without building them."""
    counts = [_chain_gates(rows) for rows in (r1cs.a, r1cs.b, r1cs.c)]
    if None in counts:
        counts = [(x.t, x.gates) for x in _split(r1cs)[0]]
    (ta, ga), (tb, gb), (tc, gc) = counts
    return ga + gb + gc + ~((ta == 0) & (tb == 0) & (tc == 0))


def domain_size(n_gates: int) -> int:
    """The power of two r1cs_to_plonk pads to: at least 8, two rows
    reserved for the prover's blinding."""
    n = 8
    while n < n_gates + 2:
        n *= 2
    return n


def plonk_size(r1cs) -> Tuple[int, int]:
    """(gates, n) of r1cs_to_plonk(r1cs), counted without building it."""
    gates = r1cs.n_public + int(constraint_gates(r1cs).sum())
    return gates, domain_size(gates)


class _Values:
    """A growing table of distinct selector values (python ints mod r)."""

    def __init__(self, table: List[int]):
        self.vals = list(table)
        self.index = {v: i for i, v in enumerate(self.vals)}

    def id(self, v: int) -> int:
        v %= FR
        if v not in self.index:
            self.index[v] = len(self.vals)
            self.vals.append(v)
        return self.index[v]


def r1cs_to_plonk(r1cs, witness: List[int]
                  ) -> Tuple[PlonkCS, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (cs, a_vals, b_vals, c_vals) with the witness placed: the
    values as (n, 4) uint64 plain limbs, row for row the JAX package's
    lists (``convert.plonk_cs_to_reference`` and
    ``plonk_values_to_reference`` give those back).

    `witness` is the full R1CS assignment [1, publics..., privates...];
    fresh signals are allocated for linear-chain intermediates.
    """
    lcs, table = _split(r1cs)
    n_cons = len(r1cs.a)
    n_public = r1cs.n_public
    wit = [int(v) % FR for v in witness]
    n_wit = len(wit)
    main = _main(lcs)
    ga, gb, gc = (x.gates for x in lcs)
    per = ga + gb + gc + main
    off = n_public + np.cumsum(per) - per            # first gate row
    chains = ga + gb + gc
    fresh0 = n_wit + np.cumsum(chains) - chains      # first fresh signal
    n = domain_size(n_public + int(per.sum()))

    vt = _Values(table)
    zero_id, one_id, neg1_id = vt.id(0), vt.id(1), vt.id(-1)
    q = np.full((5, n), zero_id, dtype=np.int64)     # qL qR qM qO qC
    sig = np.full((3, n), -1, dtype=np.int64)        # a, b, c cells
    rows_pub = np.arange(n_public)
    q[0, rows_pub] = one_id
    sig[0, rows_pub] = rows_pub + 1

    tab = np.empty(len(vt.vals), dtype=object)
    tab[:] = vt.vals
    wit_obj = np.empty(n_wit, dtype=object)
    wit_obj[:] = wit
    fresh_vals = np.zeros(int(chains.sum()), dtype=object)
    out_sig, out_const = [], []
    starts = (np.zeros_like(ga), ga, ga + gb)
    for m, x in enumerate(lcs):
        cnst = np.where(x.const_id >= 0, x.const_id, zero_id)
        if x.tl.size:
            pos = np.arange(x.tl.size) - x.first[x.tl]
            tt = x.t[x.tl]
            live = (tt >= 2) | ((tt == 1) & ~x.ident[x.tl])
            # fresh values: the prefix sums of coef * witness in each chain
            li = np.nonzero(live)[0]
            prod = tab[x.tc[li]] * wit_obj[x.ts[li]]
            cum = np.cumsum(prod) if li.size else prod
            lc_first = np.searchsorted(li, x.first[x.tl[li]])
            base = np.where(lc_first > 0, cum[np.maximum(lc_first - 1, 0)], 0)
            gate = pos[li] >= np.where(tt[li] >= 2, 1, 0)
            e = li[gate]
            lce = x.tl[e]
            two = tt[e] >= 2
            j = np.where(two, pos[e] - 1, 0)
            last = j == np.where(two, tt[e] - 2, 0)
            row = off[lce] + starts[m][lce] + j
            fresh = fresh0[lce] + starts[m][lce] + j
            f = x.first[lce]
            q[0, row] = np.where(two & (j > 0), one_id, x.tc[f])
            q[1, row] = np.where(two, x.tc[e], zero_id)
            q[3, row] = neg1_id
            q[4, row] = np.where(last, cnst[lce], zero_id)
            sig[0, row] = np.where(two & (j > 0), fresh - 1, x.ts[f])
            sig[1, row] = np.where(two, x.ts[e], -1)
            sig[2, row] = fresh
            out = (cum[gate] - base[gate]) + np.where(last, tab[cnst[lce]], 0)
            fresh_vals[fresh - n_wit] = out % FR
        o = np.full(n_cons, -1, dtype=np.int64)
        has = x.t > 0
        o[has] = fresh0[has] + starts[m][has] + x.gates[has] - 1
        o[x.ident] = x.ts[x.first[x.ident]]
        out_sig.append(o)
        out_const.append(cnst)

    # the multiplication gates; constant sides fold into selectors (a
    # constant must never occupy a free, copy-unconstrained cell)
    sa, sb, sc = out_sig
    ka, kb, kc = out_const
    all_const = (sa < 0) & (sb < 0) & (sc < 0)
    for ci in np.nonzero(all_const)[0]:
        assert tab[ka[ci]] * tab[kb[ci]] % FR == tab[kc[ci]], \
            "inconsistent R1CS row"
    ci = np.nonzero(main)[0]
    row = off[ci] + per[ci] - 1
    sa, sb, sc, ka, kb, kc = sa[ci], sb[ci], sc[ci], ka[ci], kb[ci], kc[ci]
    has_c = sc >= 0
    q[3, row] = np.where(has_c, neg1_id, zero_id)
    neg = {k: vt.id(-vt.vals[k]) for k in np.unique(kc[~has_c]).tolist()}
    neg_of = np.full(len(table) + 3, zero_id, dtype=np.int64)
    neg_of[list(neg)] = list(neg.values())
    q[4, row] = np.where(has_c, zero_id, neg_of[kc])
    both = (sa < 0) & (sb < 0)
    for k in np.nonzero(both)[0]:
        q[4, row[k]] = vt.id(vt.vals[ka[k]] * vt.vals[kb[k]])
    only_b = (sa < 0) & (sb >= 0)
    only_a = (sa >= 0) & (sb < 0)
    q[1, row[only_b]] = ka[only_b]
    q[0, row[only_a]] = kb[only_a]
    q[2, row[(sa >= 0) & (sb >= 0)]] = one_id
    sig[0, row] = sa
    sig[1, row] = sb
    sig[2, row] = sc

    # sigma: cells holding the same signal form one rotation cycle, in the
    # order of their cell index (column-major: a, then b, then c cells)
    flat = sig.reshape(-1)
    cells = np.nonzero(flat >= 0)[0]
    order = np.argsort(flat[cells], kind="stable")
    cs_ = cells[order]
    s_ = flat[cs_]
    first = np.ones(cs_.size, dtype=bool)
    first[1:] = s_[1:] != s_[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(cs_.size), 0))
    nxt = np.empty_like(cs_)
    if cs_.size:
        same = np.zeros(cs_.size, dtype=bool)
        same[:-1] = ~first[1:]
        nxt[:-1] = cs_[1:]
        nxt = np.where(same, nxt, cs_[run_start])
    sigma = np.arange(3 * n, dtype=np.int64)
    sigma[cs_] = nxt

    vals = bf.ints_to_limbs(vt.vals)
    qs = [vals[q[k]] for k in range(5)]
    wlimbs = bf.ints_to_limbs(wit + fresh_vals.tolist())
    cells_v = []
    for k in range(3):
        v = np.zeros((n, bf.N_LIMBS), dtype=np.uint64)
        live = sig[k] >= 0
        v[live] = wlimbs[sig[k][live]]
        cells_v.append(v)
    cs = PlonkCS(n=n, qL=qs[0], qR=qs[1], qM=qs[2], qO=qs[3], qC=qs[4],
                 sigma=sigma, n_public=n_public)
    return cs, cells_v[0], cells_v[1], cells_v[2]
