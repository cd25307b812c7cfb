"""Pippenger multi-scalar multiplication: kernel B3 and its plain twins.

Counterpart of the reference's ``snark/msm.py`` (a sort-based jnp
formulation of reference src/ffiasm/multiexp.c.hpp:36-100).  ``msm_plain``
is the specification: unsigned c-bit digits by window, the (window, digit)
keys sorted with ``torch.sort`` (digit 0 skipped), each bucket's points
summed, each window's buckets reduced to sum_b b * B_b (as sum_k 2^k of
the buckets with bit k set), the windows combined, most significant
first, with c doublings a step.

On a CUDA tensor ``msm`` runs kernel B3 (``csrc/bn254_msm.cu``,
``bn254_msm_sums.cu``) over affine bases (``affine_bases``: the Groth16
key's points and fflonk's SRS are kept so; an x of all ones marks
infinity) with signed digits (``signed_digits_plain`` is the recoding's
twin: 2^(c-1) buckets a window): ``digit_counts`` counts every bucket's
entries; then for each group of windows ``digit_entries`` writes them in
bucket order (a counting sort: the point index with the digit's sign in
bit 31), ``bucket_ranges`` cuts each bucket into strided ranges of at
most ``sum_range`` entries, ``bucket_sums`` sums each range's affine
points by mixed additions and ``sum_by_key`` joins a bucket's ranges (a
witness's digit-1 bucket holds about half the points); last,
``reduce_windows`` reduces each window's buckets in one block (running
sums over segments, joined by a tree) and combines the windows in the
last block to finish.  Each step takes its plain twin on CPU tensors, so
``_msm_flow`` runs on the CPU too; ``msm`` on the CPU is ``msm_plain``.
Two projective forms of one point compare after ``to_affine``.

``sum_by_key`` also sums Fr values, with the same range-sum kernel over
Fr addition: the Groth16 setup's coefficient products by signal and the
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

# digit entries (points x windows) counted and placed at once: larger
# MSMs run their windows in groups (a fflonk commitment at n = 2^24 has
# 151 million points); an entry is 4 bytes
MSM_GROUP_ENTRIES = 1 << 28
# B3's window on the card: n.bit_length() - WINDOW_OFFSET, within
# [2, WINDOW_MAX] (tools/bn254_times.py --windows: c = 15 the fastest at
# 14,008,649 witness-shaped G1 scalars, 16 at 2^24 full ones)
WINDOW_OFFSET = 9
WINDOW_MAX = 16

LAUNCHES = {"affine": 0, "digits": 0, "scatter": 0, "bucket_sums": 0,
            "sum_ranges": 0, "reduce": 0}
# launches by shape: affine (group, points); digits, scatter (group,
# points, c); bucket_sums (group, entries, ranges); sum_ranges (group,
# values, ranges, gathered); reduce (group, windows, c); group "Fr", "G1"
# or "G2"
SHAPES: dict = {}

_vp = ctypes.c_void_p
# merlin_bn_msm_digits' modes (csrc/bn254_msm.cu DigitsMode)
DIGITS_COUNT, DIGITS_SCATTER, DIGITS_KEYS = 0, 1, 2


def pick_window(n: int) -> int:
    """Pippenger window size for n points (the reference's choice)."""
    return max(2, min(12, n.bit_length() - 1))


def window(n: int) -> int:
    """B3's window for n points on the card: the sum is the same point at
    any c; the reference's clamp at 12 only bounded its scan."""
    return max(2, min(WINDOW_MAX, n.bit_length() - WINDOW_OFFSET))


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
# Affine bases (kernel bn_to_affine)
# ---------------------------------------------------------------------------


def _packed(F, points) -> torch.Tensor:
    """(n, W) Jacobian words of `points`: a Point, words already packed (a
    table kept packed, whose leading rows are taken without a copy), or
    affine words (``affine_bases``)."""
    if not isinstance(points, torch.Tensor):
        return curve.pack(F, points)
    if points.shape[-1] == 2 * F.words:
        return jacobian_words(F, points)
    return points


def is_affine_inf(F, aff: torch.Tensor) -> torch.Tensor:
    """(n,) bool: the affine words that mark infinity (an x of all ones)."""
    return aff[:, 3] == -1


def jacobian_words(F, aff: torch.Tensor) -> torch.Tensor:
    """(n, 3 W) Jacobian words (Z = 1, infinity as ``curve.infinity``) of
    (n, 2 W) affine words."""
    n, k = aff.shape[0], F.words
    one = curve.pack(F, curve.infinity(F, (n,), aff.device))
    out = torch.cat([aff, one[:, :k]], dim=1)
    inf = is_affine_inf(F, aff)
    out[inf] = one[inf]
    return out


def affine_bases_plain(F, words: torch.Tensor) -> torch.Tensor:
    """Twin of bn_to_affine: (n, 2 W) words x, y (Montgomery) of (n, 3 W)
    Jacobian words, by ``curve.to_affine``; infinity an x of all ones and
    a y of zeros."""
    x, y, inf = curve.to_affine(F, curve.unpack(F, words))
    out = torch.cat([F.flat(x), F.flat(y)], dim=-1)
    out[inf, :F.words] = -1
    out[inf, F.words:] = 0
    return out


def affine_bases(F, points) -> torch.Tensor:
    """B3's bases, (n, 2 W) affine words, of a Point or (n, 3 W) Jacobian
    words (affine words are returned as they are): a chunked batch
    inversion, one Fermat inversion a chunk of 64 points."""
    if isinstance(points, torch.Tensor) and points.shape[-1] == 2 * F.words:
        return points
    words = _packed(F, points).contiguous()
    if not words.is_cuda:
        return affine_bases_plain(F, words)
    n = words.shape[0]
    out = torch.empty((n, 2 * F.words), dtype=torch.int64, device=words.device)
    if n:
        cuda_build.check(cuda_build.lib().merlin_bn_to_affine(
            F.g2, _vp(words.data_ptr()), n, _vp(out.data_ptr()),
            _vp(cuda_build.stream_ptr())), "bn254 to affine")
        cuda_build.count(LAUNCHES, SHAPES, "affine", (group_name(F), n))
    return out


# ---------------------------------------------------------------------------
# Signed digits and the counting sort (kernel bn_msm_digits)
# ---------------------------------------------------------------------------


def n_windows(bits: int, c: int) -> int:
    """Windows of B3's signed recoding: bits // c + 1 (the last takes the
    carry out of the top window, whose digit is then at most 2^(c-1))."""
    return bits // c + 1


def signed_digits_plain(scalars: torch.Tensor, c: int, bits: int,
                        upto: int = None) -> torch.Tensor:
    """(windows, n) signed digits of each (n, 4) plain scalar's bits below
    `bits`, low window first (the windows below `upto` where given): v =
    (bits of the window) + carry; digit v - 2^c and carry 1 where
    v > 2^(c-1), else v and carry 0 (``curve.signed_digits``' rule)."""
    half = 1 << (c - 1)
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64,
                        device=scalars.device)
    out = []
    for w in range(min(n_windows(bits, c), upto or n_windows(bits, c))):
        v = carry + (window_digits(scalars, c, w, bits) if w * c < bits
                     else 0)
        carry = (v > half).long()
        out.append(v - (carry << c))
    return torch.stack(out)


def digit_entries_plain(F, bases: torch.Tensor, scalars: torch.Tensor,
                        c: int, w0: int, g: int, bits: int):
    """The nonzero digits of windows w0 .. w0 + g - 1 in bucket order:
    (keys (w - w0) 2^(c-1) + |d| - 1, entries i | sign << 31), int64, by
    key then point index; none for a base at infinity."""
    d = signed_digits_plain(scalars, c, bits, w0 + g)[w0:]
    d = d * (~is_affine_inf(F, bases)).long()
    w, i = torch.nonzero(d, as_tuple=True)
    dv = d[w, i]
    keys = w * (1 << (c - 1)) + dv.abs() - 1
    entries = i | ((dv < 0).long() << 31)
    order = torch.argsort(keys * max(scalars.shape[0], 1) + i)
    return keys[order], entries[order]


def _as_u32(e: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 words that hold them."""
    return torch.where(e >= 1 << 31, e - (1 << 32), e).int()


def digit_counts(F, bases, scalars, c: int, w0: int, g: int, bits: int
                 ) -> torch.Tensor:
    """(g 2^(c-1),) int32: each bucket's nonzero digits in windows w0 ..
    w0 + g - 1."""
    size = g << (c - 1)
    if not scalars.is_cuda:
        keys, _ = digit_entries_plain(F, bases, scalars, c, w0, g, bits)
        return torch.bincount(keys, minlength=size).int()
    counts = torch.zeros(size, dtype=torch.int32, device=scalars.device)
    n = scalars.shape[0]
    cuda_build.check(cuda_build.lib().merlin_bn_msm_digits(
        DIGITS_COUNT, _vp(scalars.data_ptr()), _vp(bases.data_ptr()), bases.shape[1], n,
        c, w0, g, bits, _vp(counts.data_ptr()), _vp(None),
        _vp(cuda_build.stream_ptr())), "bn254 msm digits")
    cuda_build.count(LAUNCHES, SHAPES, "digits", (group_name(F), n, c))
    return counts


def digit_entries(F, bases, scalars, c: int, w0: int, g: int, bits: int,
                  first: torch.Tensor, total: int) -> torch.Tensor:
    """(total,) int32 entries (point index | sign << 31) in bucket order,
    bucket b's from first[b] (int32 ``digit_counts``' exclusive prefix sum);
    within a bucket in the order the kernel's atomics give them."""
    if not scalars.is_cuda:
        return _as_u32(digit_entries_plain(F, bases, scalars, c, w0, g,
                                           bits)[1])
    entries = torch.empty(total, dtype=torch.int32, device=scalars.device)
    if total == 0:
        return entries
    cursors = first.clone()
    n = scalars.shape[0]
    cuda_build.check(cuda_build.lib().merlin_bn_msm_digits(
        DIGITS_SCATTER, _vp(scalars.data_ptr()), _vp(bases.data_ptr()), bases.shape[1], n,
        c, w0, g, bits, _vp(cursors.data_ptr()), _vp(entries.data_ptr()),
        _vp(cuda_build.stream_ptr())), "bn254 msm scatter")
    cuda_build.count(LAUNCHES, SHAPES, "scatter", (group_name(F), n, c))
    return entries


def bucket_ranges(counts: torch.Tensor, first: torch.Tensor, max_len: int,
                  n_r: int = None):
    """Each bucket's entries [first, first + count) cut into k = ceil(count
    / max_len) ranges, range j taking entries j, j + k, j + 2k, ... (a
    warp's threads read neighbouring entries): (starts int64, counts int32,
    strides int32, the bucket of each range), the ranges in bucket order;
    n_r, the number of ranges, where the caller knows it."""
    nr = (counts + max_len - 1) // max_len
    n_r = int(nr.sum()) if n_r is None else n_r
    dev = counts.device
    rb = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), nr,
                                 output_size=n_r)
    j = torch.arange(n_r, device=dev) - (torch.cumsum(nr, 0) - nr)[rb]
    stride = nr[rb]
    return (first[rb] + j, ((counts[rb] - j + stride - 1) // stride).int(),
            stride.int(), rb)


# ---------------------------------------------------------------------------
# Bucket sums (kernel bn_msm_bucket_sums), then sum_by_key
# ---------------------------------------------------------------------------


def bucket_sums_plain(F, bases, entries, starts, counts, strides
                      ) -> torch.Tensor:
    """Twin of bn_msm_bucket_sums: each range's points (y negated for a
    negative digit) summed as run_sums_plain sums them."""
    dev = bases.device
    n_r = starts.shape[0]
    cnt = counts.long()
    rid = torch.repeat_interleave(torch.arange(n_r, device=dev), cnt)
    j = torch.arange(rid.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[rid]
    e = entries[starts[rid] + j * strides.long()[rid]].long() & 0xFFFFFFFF
    pts = jacobian_words(F, bases[e & 0x7FFFFFFF])
    neg = torch.nonzero(e >> 31).reshape(-1)
    if neg.numel():
        pts[neg] = curve.pack(F, curve.neg(F, curve.unpack(F, pts[neg])))
    out = identity_words(F, n_r, dev)
    if rid.numel():
        sums, rkeys = run_sums_plain(F, pts, rid)
        out[rkeys] = sums
    return out


def bucket_sums(F, bases, entries, starts, counts, strides) -> torch.Tensor:
    """(ranges, 3 W) Jacobian: each range's affine bases summed."""
    if not bases.is_cuda:
        return bucket_sums_plain(F, bases, entries, starts, counts, strides)
    n_r = starts.shape[0]
    out = torch.empty((n_r, 3 * F.words), dtype=torch.int64, device=bases.device)
    if n_r == 0:
        return out
    cuda_build.check(cuda_build.lib().merlin_bn_msm_bucket_sums(
        F.g2, _vp(bases.data_ptr()), _vp(entries.data_ptr()),
        _vp(starts.data_ptr()), _vp(counts.data_ptr()), _vp(strides.data_ptr()),
        n_r, _vp(out.data_ptr()), _vp(cuda_build.stream_ptr())),
        "bn254 msm bucket sums")
    cuda_build.count(LAUNCHES, SHAPES, "bucket_sums",
                     (group_name(F), entries.shape[0], n_r))
    return out


# ---------------------------------------------------------------------------
# Window reduce and combine (kernel bn_msm_reduce)
# ---------------------------------------------------------------------------


def window_sums_plain(F, buckets: torch.Tensor, c: int) -> torch.Tensor:
    """(g, 3 W): each window's sum_b (b + 1) B_b over its 2^(c-1) buckets,
    as the sum over j of the suffix sums sum_{b >= j} B_b (a Hillis-Steele
    scan, then a tree)."""
    half = 1 << (c - 1)
    s = _leaf_map(F, lambda a: a.reshape(-1, half, bf.N16),
                  curve.split_point(F, curve.unpack(F, buckets)))
    step = 1
    while step < half:
        summed = curve.add16(F, _leaf_map(F, lambda a: a[:, :half - step], s),
                             _leaf_map(F, lambda a: a[:, step:], s))
        s = _leaf_map(F, lambda a, b: torch.cat([a, b[:, half - step:]], dim=1),
                      summed, s)
        step *= 2
    return curve.pack(F, curve.join_point(F, _tree_sum16(F, s)))


def combine_windows_plain(F, wsums: torch.Tensor, c: int) -> torch.Tensor:
    """(1, 3 W): sum_w 2^(c w) W_w, from the top window that is not
    infinity."""
    p = curve.split_point(F, curve.unpack(F, wsums))
    live = torch.nonzero(~F.is_zero(p.z)).reshape(-1)
    top = int(live.max()) if live.numel() else 0
    acc = _leaf_map(F, lambda a: a[top:top + 1], p)
    for w in range(top - 1, -1, -1):
        for _ in range(c):
            acc = curve.double16(F, acc)
        acc = curve.add16(F, acc, _leaf_map(F, lambda a: a[w:w + 1], p))
    return curve.pack(F, curve.join_point(F, acc))


def reduce_windows(F, buckets: torch.Tensor, c: int) -> torch.Tensor:
    """(1, 3 W): sum_w 2^(c w) W_w, W_w = sum_b (b + 1) B_b over window w's
    2^(c-1) buckets of (windows 2^(c-1), 3 W) Jacobian words; one launch
    an MSM, a block a window."""
    nw = buckets.shape[0] >> (c - 1)
    if not buckets.is_cuda:
        return combine_windows_plain(F, window_sums_plain(F, buckets, c), c)
    dev = buckets.device
    wsums = torch.empty((nw, 3 * F.words), dtype=torch.int64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((1, 3 * F.words), dtype=torch.int64, device=dev)
    cuda_build.check(cuda_build.lib().merlin_bn_msm_reduce(
        F.g2, _vp(buckets.data_ptr()), c, nw, _vp(wsums.data_ptr()),
        _vp(counter.data_ptr()), _vp(out.data_ptr()),
        _vp(cuda_build.stream_ptr())), "bn254 msm reduce")
    cuda_build.count(LAUNCHES, SHAPES, "reduce", (group_name(F), nw, c))
    return out


def _msm_flow(F, bases: torch.Tensor, scalars: torch.Tensor, bits: int,
              c: int) -> Point:
    """B3 over (n, 2 W) affine bases: every window's digits counted at
    once, the entries placed and summed a group of windows at a time, the
    windows reduced and combined at once; each step launches its kernel on
    the card and takes its twin on the CPU."""
    dev = scalars.device
    n = scalars.shape[0]
    nw = n_windows(bits, c)
    half = 1 << (c - 1)
    per = max(1, min(nw, MSM_GROUP_ENTRIES // max(n, 1)))
    cnt_all = digit_counts(F, bases, scalars, c, 0, nw, bits).long()
    nr_all = (cnt_all + sum_range(F) - 1) // sum_range(F)
    groups = list(range(0, nw, per))
    # one host read for every group: its entries, ranges, longest bucket
    sizes = torch.stack([torch.stack([
        cnt_all[w0 * half:(w0 + per) * half].sum(),
        nr_all[w0 * half:(w0 + per) * half].sum(),
        nr_all[w0 * half:(w0 + per) * half].max()]) for w0 in groups]).tolist()
    buckets = identity_words(F, nw * half, dev)
    for w0, (total, n_r, most) in zip(groups, sizes):
        g = min(per, nw - w0)
        cnt = cnt_all[w0 * half:(w0 + g) * half]
        first = torch.cumsum(cnt, 0) - cnt
        entries = digit_entries(F, bases, scalars, c, w0, g, bits,
                                first.int(), total)
        starts, counts, strides, rb = bucket_ranges(cnt, first, sum_range(F),
                                                    n_r)
        partial = bucket_sums(F, bases, entries, starts, counts, strides)
        del entries
        if most > 1:
            buckets[w0 * half:(w0 + g) * half] = sum_by_key(
                F, partial, rb, None, g * half)
        else:
            buckets[w0 * half + rb] = partial
        del partial
    return curve.unpack(F, reduce_windows(F, buckets, c)[0])


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

    points: (N, 2 W) affine words (``affine_bases``), a Point with (N, ...)
    field leaves, or its (N, 3 W) packed words (``curve.pack``), made
    affine first on the card; scalars: (N, 4) int64 limbs of plain
    integers (not Montgomery).  Window c: by default ``pick_window`` on
    the CPU, ``window`` on the card.  Returns one Point."""
    n = scalars.shape[0]
    if not scalars.is_cuda:
        return msm_plain(F, points, scalars, bits, c or pick_window(n))
    if n == 0:
        return curve.infinity(F, (), scalars.device)
    return _msm_flow(F, affine_bases(F, points), scalars.contiguous(), bits,
                     c or window(n))
