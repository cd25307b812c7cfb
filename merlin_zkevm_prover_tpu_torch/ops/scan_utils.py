"""Prefix products over field-element tensors and tuples of them.

The combine is any associative, commutative product of two values with the
scan axis leading (Goldilocks or GF(p^3) products).  The scan is the
log-depth doubling form: step d multiplies element i by element i - d, so
a length-N scan is ceil(log2 N) whole-array products, each one batch of
elementwise tensor ops.  Field arithmetic is exact, so the values equal a
sequential loop's whatever the association order.
"""

from __future__ import annotations

from typing import Callable

import torch


def _map(f, a):
    """Apply f to a tensor, or to every leaf of a (named) tuple of them."""
    if isinstance(a, torch.Tensor):
        return f(a)
    return type(a)(*[_map(f, x) for x in a])


def _map2(f, a, b):
    if isinstance(a, torch.Tensor):
        return f(a, b)
    return type(a)(*[_map2(f, x, y) for x, y in zip(a, b)])


def _leaf(a) -> torch.Tensor:
    while not isinstance(a, torch.Tensor):
        a = next(iter(a))  # GL3 indexes rows, so take the leaf by iteration
    return a


def prefix_prod(a, mul: Callable, reverse: bool = False,
                inclusive: bool = True):
    """Prefix combine along axis 0.

    `a` is an (N, ...) tensor or a tuple of such; returns the same
    structure.  Exclusive scans start from the multiplicative identity
    (1 in the first leaf, 0 in the others: the GF(p^3) one)."""
    n = _leaf(a).shape[0]
    if n == 0:
        return a
    if reverse:
        a = _map(lambda x: torch.flip(x, dims=(0,)), a)
    d = 1
    while d < n:
        head = _map(lambda x: x[:d], a)
        tail = mul(_map(lambda x: x[d:], a), _map(lambda x: x[:-d], a))
        a = _map2(lambda h, t: torch.cat([h, t], dim=0), head, tail)
        d *= 2
    if not inclusive:
        first = [True]

        def sh(x):
            one = torch.ones_like(x[:1]) if first[0] else torch.zeros_like(x[:1])
            first[0] = False
            return torch.cat([one, x[:-1]], dim=0)

        a = _map(sh, a)
    if reverse:
        a = _map(lambda x: torch.flip(x, dims=(0,)), a)
    return a
