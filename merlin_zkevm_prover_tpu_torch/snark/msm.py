"""Pippenger multi-scalar multiplication: kernel B3 and its plain twin.

Counterpart of the reference's ``snark/msm.py`` (a sort-based jnp
formulation of reference src/ffiasm/multiexp.c.hpp:36-100).  Both versions
here cut the scalars into c-bit digits by window, sort the (window, digit)
keys with ``torch.sort`` (digit 0 is skipped), sum each bucket's points,
reduce each window's buckets to sum_b b * B_b, and combine the windows,
most significant first, with c doublings a step.

On a CUDA tensor the arithmetic runs in ``csrc/bn254_msm.cu``: the
buckets are summed by ``sum_by_key`` (a bucket cut into ranges of at most
``SUM_RANGE`` sorted entries, one thread sums a range, and the partial
sums are summed the same way until each bucket is one point: a witness's
scalars are often 0 or 1, so one bucket can hold half the points); one
thread a segment of ``2^SEG_BITS`` buckets runs the running sum, one
thread a window joins the segments, one thread the windows.  The plain
twin (``msm_plain``) sums a bucket as a tree of pairs (``run_sums_plain``)
and a window as sum_k 2^k (sum of the buckets with bit k set, the odd
nodes of level k of a tree over the buckets): the same
point, reached by another projective form, so results compare after
``to_affine``.

``sum_by_key`` also sums Fr values, with the same kernel over Fr
addition: the Groth16 setup's coefficient products by signal and the
prover's by constraint.  ``LAUNCHES`` counts B3's launches and ``SHAPES``
records them by shape.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops import bn254_field as bf
from ..ops.bn254_field import FR
from ..ops import cuda_build
from . import curve
from .curve import F2, Fq2El, Point

SEG_BITS = 6      # buckets a thread of the running sum: 2^SEG_BITS
# digit entries (points x windows) sorted at once: larger MSMs run their
# windows in groups (a fflonk commitment at n = 2^24 has 151 million
# points and 22 windows)
MSM_GROUP_ENTRIES = 1 << 28

LAUNCHES = {"digits": 0, "sum_ranges": 0, "bucket_reduce": 0,
            "window_reduce": 0, "window_combine": 0}
# launches by shape: sum_ranges (group, values, ranges, gathered), the
# others (group, points, c); group "Fr", "G1" or "G2"
SHAPES: dict = {}

_vp = ctypes.c_void_p


def pick_window(n: int) -> int:
    """Pippenger window size for n points (the reference's choice)."""
    return max(2, min(12, n.bit_length() - 1))


def window_digits(scalars: torch.Tensor, c: int, w: int, bits: int
                  ) -> torch.Tensor:
    """(n,) digit of window w: bits [w c, min((w + 1) c, bits)) of each
    (n, 4) plain scalar, read from its 64-bit limbs."""
    lo, hi = w * c, min((w + 1) * c, bits)
    width = hi - lo
    limb, off = lo // 64, lo % 64
    d = (scalars[:, limb] >> off) & ((1 << (64 - off)) - 1)
    if off + width > 64 and limb + 1 < scalars.shape[1]:
        d = d | (scalars[:, limb + 1] << (64 - off))
    return d & ((1 << width) - 1)


def _digit_keys(scalars: torch.Tensor, c: int, nw: int, bits: int
                ) -> torch.Tensor:
    """(n * nw,) keys w * 2^c + digit of entry w * n + i, -1 for digit 0."""
    out = []
    for w in range(nw):
        d = window_digits(scalars, c, w, bits)
        out.append(torch.where(d == 0, torch.full_like(d, -1), (w << c) | d))
    return torch.cat(out)


def _sorted_entries(keys: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonzero-digit entries sorted by key: (keys, point indices)."""
    ent = torch.nonzero(keys >= 0).reshape(-1)
    k_sorted, order = torch.sort(keys[ent])
    return k_sorted, ent[order] % n


# ---------------------------------------------------------------------------
# Sums by key (kernel bn_sum_ranges), over Fr values (F None) or points
# (F1, F2) as (E, W) words: 4 a value, pack's 12 or 24 a point
# ---------------------------------------------------------------------------


def group_name(F) -> str:
    return "Fr" if F is None else "G2" if F is curve.F2 else "G1"


def sum_range(F) -> int:
    """Entries one thread sums: an Fr addition is cheap, a point one is not."""
    return 256 if F is None else 32


def identity_words(F, rows: int, device) -> torch.Tensor:
    """(rows, W): 0 or the point at infinity."""
    if F is None:
        return torch.zeros((rows, bf.N_LIMBS), dtype=torch.int64, device=device)
    one = curve.pack(F, curve.infinity(F, (1,), device))
    return one.expand(rows, one.shape[-1]).clone()


def ranges(keys: torch.Tensor, max_len: int):
    """Cut the runs of equal sorted keys into ranges of at most `max_len`
    entries: (starts, counts, the key of each range, the number of runs)."""
    e = keys.shape[0]
    first = torch.ones(e, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    run_start = torch.nonzero(first).reshape(-1)
    run_id = torch.cumsum(first.long(), 0) - 1
    pos = torch.arange(e, device=keys.device) - run_start[run_id]
    starts = torch.nonzero(first | (pos % max_len == 0)).reshape(-1)
    counts = torch.diff(starts, append=starts.new_tensor([e]))
    return starts, counts, keys[starts], run_start.shape[0]


def sum_ranges_plain(F, vals, idx, starts, counts) -> torch.Tensor:
    n_r = starts.shape[0]
    dev = vals.device
    rid = torch.repeat_interleave(torch.arange(n_r, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    k = starts[rid] + torch.arange(rid.shape[0], device=dev) - first[rid]
    j = idx[k] if idx is not None else k
    sums, rkeys = run_sums_plain(F, vals[j], rid)
    out = identity_words(F, n_r, dev)
    out[rkeys] = sums
    return out


def sum_ranges(F, vals: torch.Tensor, idx, starts: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """out[r] = the sum of vals[idx[k]] (vals[k] without idx) over the r-th
    range [starts[r], starts[r] + counts[r]) of positions."""
    if not vals.is_cuda:
        return sum_ranges_plain(F, vals, idx, starts, counts)
    vals = vals.contiguous()
    n_r = starts.shape[0]
    out = torch.empty((n_r, vals.shape[1]), dtype=torch.int64,
                      device=vals.device)
    if n_r == 0:
        return out
    idx = idx.contiguous() if idx is not None else None
    cuda_build.check(cuda_build.lib().merlin_bn_sum_ranges(
        0 if F is None else 1 + F.g2, _vp(vals.data_ptr()),
        _vp(idx.data_ptr() if idx is not None else None),
        _vp(starts.data_ptr()), _vp(counts.data_ptr()), n_r,
        _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())), "bn254 sum ranges")
    cuda_build.count(LAUNCHES, SHAPES, "sum_ranges",
                     (group_name(F), vals.shape[0], n_r, idx is not None))
    return out


def sum_by_key(F, vals: torch.Tensor, keys: torch.Tensor, idx, size: int
               ) -> torch.Tensor:
    """(size, W): out[k] = the sum of vals[idx[i]] (vals[i] without idx)
    over the positions i whose key is k, the identity where there is none;
    `keys` sorted, in [0, size).  Ranges are summed, then their sums,
    until each key is one sum."""
    out = identity_words(F, size, vals.device)
    src = vals
    while keys.shape[0]:
        starts, counts, rkeys, n_runs = ranges(keys, sum_range(F))
        src = sum_ranges(F, src, idx, starts, counts)
        idx, keys = None, rkeys
        if starts.shape[0] == n_runs:
            out[rkeys] = src
            break
    return out


def sum_by_key_unsorted(F, vals: torch.Tensor, keys: torch.Tensor,
                        size: int) -> torch.Tensor:
    """sum_by_key for keys in any order."""
    k_sorted, order = torch.sort(keys, stable=True)
    return sum_by_key(F, vals, k_sorted, order, size)


# ---------------------------------------------------------------------------
# Kernel path
# ---------------------------------------------------------------------------


def _packed(F, points) -> torch.Tensor:
    """(n, W) words of `points`: a Point, or words already packed (a table
    kept packed, whose leading rows are taken without a copy)."""
    return points if isinstance(points, torch.Tensor) else curve.pack(F, points)


def _msm_cuda(F, points, scalars: torch.Tensor, bits: int, c: int) -> Point:
    dev = scalars.device
    n = scalars.shape[0]
    nw = -(-bits // c)
    shape = (group_name(F), n, c)
    lib = cuda_build.lib()
    stream = _vp(cuda_build.stream_ptr())
    scalars = scalars.contiguous()
    pts = _packed(F, points)
    words = pts.shape[1]
    seg_bits = min(SEG_BITS, c)
    n_seg = 1 << (c - seg_bits)
    # windows a group: the keys of a group are sorted at once
    per = max(1, min(nw, MSM_GROUP_ENTRIES // max(n, 1)))
    wsums = torch.empty((nw, words), dtype=torch.int64, device=dev)
    for w0 in range(0, nw, per):
        g = min(per, nw - w0)
        keys = torch.empty(n * g, dtype=torch.int64, device=dev)
        cuda_build.check(lib.merlin_bn_msm_digits(
            _vp(scalars.data_ptr()), n, c, w0, g, bits, _vp(keys.data_ptr()),
            stream), "bn254 msm digits")
        cuda_build.count(LAUNCHES, SHAPES, "digits", shape)
        k_sorted, idx = _sorted_entries(keys, n)
        del keys
        buckets = sum_by_key(F, pts, k_sorted, idx, g << c)
        del k_sorted, idx
        partials = torch.empty((g * n_seg * 2, words), dtype=torch.int64,
                               device=dev)
        cuda_build.check(lib.merlin_bn_bucket_reduce(
            F.g2, _vp(buckets.data_ptr()), g, c, seg_bits,
            _vp(partials.data_ptr()), stream), "bn254 msm bucket reduce")
        cuda_build.count(LAUNCHES, SHAPES, "bucket_reduce", shape)
        cuda_build.check(lib.merlin_bn_window_reduce(
            F.g2, _vp(partials.data_ptr()), g, n_seg, seg_bits,
            _vp(wsums[w0:w0 + g].data_ptr()), stream),
            "bn254 msm window reduce")
        cuda_build.count(LAUNCHES, SHAPES, "window_reduce", shape)
        del buckets, partials
    out = torch.empty((1, words), dtype=torch.int64, device=dev)
    cuda_build.check(lib.merlin_bn_window_combine(
        F.g2, _vp(wsums.data_ptr()), nw, c, _vp(out.data_ptr()), stream),
        "bn254 msm window combine")
    cuda_build.count(LAUNCHES, SHAPES, "window_combine", shape)
    return curve.unpack(F, out[0])


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def _leaf_map(F, fn, *ps: Point) -> Point:
    if F is F2:
        return Point(*[Fq2El(fn(*[getattr(leaf, "c0") for leaf in leaves]),
                             fn(*[getattr(leaf, "c1") for leaf in leaves]))
                       for leaves in zip(*ps)])
    return Point(*[fn(*leaves) for leaves in zip(*ps)])


def run_sums_plain(F, x: torch.Tensor, keys: torch.Tensor):
    """Sum the (E, W) words of each run of equal sorted keys (Fr values or
    points, as sum_by_key): a tree of pairs within each run.  Returns (the
    sums, the runs' keys)."""
    if F is None:
        v = bf.to16(x)

        def take(t, i):
            return t[i]

        def add(a, b):
            return bf.add16(FR, a, b)

        def put(t, i, u):
            return t.index_put((i,), u)
    else:
        v = curve.split_point(F, curve.unpack(F, x))

        def take(p, i):
            return _leaf_map(F, lambda a: a[i], p)

        def add(a, b):
            return curve.add16(F, a, b)

        def put(p, i, u):
            return _leaf_map(F, lambda a, b: a.index_put((i,), b), p, u)
    while True:
        e = keys.shape[0]
        first = torch.ones(e, dtype=torch.bool, device=keys.device)
        first[1:] = keys[1:] != keys[:-1]
        if bool(first.all()):
            break
        run_start = torch.nonzero(first).reshape(-1)
        pos = torch.arange(e, device=keys.device) - \
            run_start[torch.cumsum(first.long(), 0) - 1]
        even = torch.nonzero(pos % 2 == 0).reshape(-1)
        partner = torch.clamp(even + 1, max=e - 1)
        has_next = (even + 1 < e) & (keys[partner] == keys[even])
        left = take(v, even)
        # an entry with a partner in its run adds it; a single one stays
        pair = torch.nonzero(has_next).reshape(-1)
        v = put(left, pair, add(take(left, pair), take(v, partner[pair])))
        keys = keys[even]
    if F is None:
        return bf.from16(v), keys
    return curve.pack(F, curve.join_point(F, v)), keys


def _tree_sum16(F, pts: Point) -> Point:
    """Sum over the last point axis (leaves (..., k, 16))."""
    while F.shape_of(pts.z)[-1] > 1:
        k = F.shape_of(pts.z)[-1]
        half = k // 2
        lo = _leaf_map(F, lambda a: a[..., 0:2 * half:2, :], pts)
        hi = _leaf_map(F, lambda a: a[..., 1:2 * half:2, :], pts)
        summed = curve.add16(F, lo, hi)
        if k % 2:
            rest = _leaf_map(F, lambda a: a[..., k - 1:k, :], pts)
            summed = _leaf_map(F, lambda a, b: torch.cat([a, b], dim=-2),
                               summed, rest)
        pts = summed
    return _leaf_map(F, lambda a: a[..., 0, :], pts)


def msm_plain(F, points, scalars: torch.Tensor, bits: int = 254,
              c: int = None) -> Point:
    n = scalars.shape[0]
    if c is None:
        c = pick_window(n)
    nw = -(-bits // c)
    dev = scalars.device
    k_sorted, idx = _sorted_entries(_digit_keys(scalars, c, nw, bits), n)
    sums, skeys = run_sums_plain(F, _packed(F, points)[idx], k_sorted)
    words = identity_words(F, nw << c, dev)
    words[skeys] = sums
    buckets = _leaf_map(F, lambda a: a.reshape(nw, 1 << c, bf.N16),
                        curve.split_point(F, curve.unpack(F, words)))
    # W_w = sum_k 2^k S_k, S_k = the sum of the buckets whose index has bit
    # k: the odd nodes of level k of a binary tree over the buckets (node j
    # of level k sums buckets j 2^k .. (j + 1) 2^k - 1)
    level, s_k = buckets, []
    for _ in range(c):
        odd = _leaf_map(F, lambda a: a[:, 1::2], level)
        s_k.append(_tree_sum16(F, odd))
        level = curve.add16(F, _leaf_map(F, lambda a: a[:, 0::2], level), odd)
    s = _leaf_map(F, lambda *a: torch.stack(a, dim=1), *s_k)      # (nw, c)
    wsum = _leaf_map(F, lambda a: a[:, c - 1], s)
    for k in range(c - 2, -1, -1):
        wsum = curve.add16(F, curve.double16(F, wsum),
                           _leaf_map(F, lambda a: a[:, k], s))
    empty = F.is_zero(wsum.z)
    top = int(torch.nonzero(~empty).max()) if bool((~empty).any()) else 0
    acc = _leaf_map(F, lambda a: a[top], wsum)     # the windows above: empty
    for w in range(top - 1, -1, -1):
        for _ in range(c):
            acc = curve.double16(F, acc)
        acc = curve.add16(F, acc, _leaf_map(F, lambda a: a[w], wsum))
    return curve.join_point(F, acc)


def msm(F, points, scalars: torch.Tensor, bits: int = 254,
        c: int = None) -> Point:
    """Sum of scalars[i] * points[i].

    points: Point with (N, ...) field leaves, or its (N, W) packed words
    (``curve.pack``); scalars: (N, 4) int64 limbs
    of plain integers (not Montgomery).  Returns one Point."""
    n = scalars.shape[0]
    if c is None:
        c = pick_window(n)
    if not scalars.is_cuda:
        return msm_plain(F, points, scalars, bits, c)
    return _msm_cuda(F, points, scalars, bits, c)
