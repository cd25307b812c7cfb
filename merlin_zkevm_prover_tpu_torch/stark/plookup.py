"""Plookup h1/h2 and grand-product z — device-side, static shapes.

Reimplements the semantics of the reference `Polinomial::calculateH1H2` and
`Polinomial::calculateZ`:

  * calculateH1H2 — the reference builds a hash table keyed on t-values,
    attributes each f occurrence to the *last* row of t holding that value,
    then emits the multiset f ∪ t ordered by t-row with h1/h2 as the
    even/odd interleave.  Here: a stable lexicographic sort of t (ties keep
    row order, which h1/h2 depend on), a vectorized binary search of f into
    sorted t (upper bound = last occurrence), a bincount of multiplicities,
    and a searchsorted over the cumulative counts to materialize the merged
    sequence.

  * calculateZ — z[i] = prod_{j<i} num[j]/den[j].  Both cumulative products
    are log-depth scans and the denominator prefix inverses come from one
    Fermat inversion of the total product
    (inv(prefix_excl[i]) = suffix_incl[i] * inv(total)).
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from ..ops import goldilocks as gl
from ..ops import goldilocks3 as gl3
from ..ops.goldilocks import GL
from ..ops.goldilocks3 import GL3

Value = Union[GL, GL3]


def _key_limbs(v: Value) -> List[torch.Tensor]:
    """Most-significant-first key list for lexicographic compare: int64
    words whose signed order is the field elements' unsigned order."""
    if isinstance(v, GL3):
        return [gl.sort_key(v.c2), gl.sort_key(v.c1), gl.sort_key(v.c0)]
    return [gl.sort_key(v)]


def _lex_less(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    """a < b lexicographically, vectorized over matching shapes."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _lex_eq(a, b) -> torch.Tensor:
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        eq = eq & (x == y)
    return eq


def _gather(limbs: List[torch.Tensor], idx: torch.Tensor) -> List[torch.Tensor]:
    return [l.index_select(0, idx) for l in limbs]


def _sort_perm(limbs: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by (keys ascending, original index ascending):
    stable sorts from the least significant key to the most."""
    perm = None
    for key in reversed(limbs):
        k = key if perm is None else key.index_select(0, perm)
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm.index_select(0, order)
    return perm


def _upper_bound(sorted_limbs, query_limbs, n: int) -> torch.Tensor:
    """Vectorized binary search: count of sorted entries <= query."""
    lo = torch.zeros_like(query_limbs[0])
    hi = torch.full_like(query_limbs[0], n)
    for _ in range(max(n.bit_length(), 1)):
        # a converged lane (lo == hi) stays put: sorted[lo] > query there,
        # and at lo == n the clamped probe n-1 steps lo back to n
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        mid_vals = _gather(sorted_limbs, mid)
        # sorted[mid] <= query  <=>  not (query < sorted[mid])
        le = ~_lex_less(query_limbs, mid_vals)
        lo = torch.where(le, mid + 1, lo)
        hi = torch.where(le, hi, mid)
    return lo  # index of first element > query == upper bound


def _select_rows(v: Value, idx: torch.Tensor) -> Value:
    if isinstance(v, GL3):
        return GL3(
            _select_rows(v.c0, idx), _select_rows(v.c1, idx), _select_rows(v.c2, idx)
        )
    return v.index_select(0, idx)


def calculate_h1h2(f: Value, t: Value) -> Tuple[Value, Value, torch.Tensor]:
    """Returns (h1, h2, ok) for one plookup set; f, t are (N,) GL or GL3.

    ok is a scalar bool tensor: False iff some f value is absent from t (the
    reference exits the process in that case).
    """
    n = f.shape[0]
    dev = f.device
    t_limbs = _key_limbs(t)
    # sort t by (key asc, original index asc)
    s_idx = _sort_perm(t_limbs)
    s_limbs = _gather(t_limbs, s_idx)

    f_limbs = _key_limbs(f)
    ub = _upper_bound(s_limbs, f_limbs, n)          # first index > f value
    pos = torch.clamp(ub - 1, 0, n - 1)             # last occurrence if present
    found = _lex_eq(_gather(s_limbs, pos), f_limbs)
    ok = torch.all(found)
    attr_t_row = s_idx.index_select(0, pos)         # original t row (last occ.)

    counts = 1 + torch.bincount(attr_t_row, minlength=n)
    cum = torch.cumsum(counts, dim=0)               # inclusive, total = 2N
    slots = torch.arange(2 * n, dtype=torch.int64, device=dev)
    merged_id = torch.searchsorted(cum, slots, right=True)
    merged = _select_rows(t, merged_id)
    h1 = _select_rows(merged, torch.arange(0, 2 * n, 2, device=dev))
    h2 = _select_rows(merged, torch.arange(1, 2 * n, 2, device=dev))
    return h1, h2, ok


def calculate_z(num: GL3, den: GL3) -> GL3:
    """z[i] = prod_{j<i} num[j]/den[j]; z[0] = 1.  (N,) GL3 in/out.

    The total product must be 1 for a satisfied argument; the wrap-around
    constraint z'*den - z*num == 0 at row N-1 enforces it in-proof.
    """
    pnum_excl = gl3.prefix_prod(num, inclusive=False)
    sden = gl3.prefix_prod(den, reverse=True)     # inclusive suffix of den
    tinv = gl3.inv(sden[0:1])                     # 1 / total(den), (1,)
    # inv(prefix_den_excl[i]) = suffix_den_incl[i] * inv(total)
    inv_pref_den_excl = gl3.mul(sden, tinv)       # broadcasts (1,) -> (N,)
    return gl3.mul(pnum_excl, inv_pref_den_excl)
