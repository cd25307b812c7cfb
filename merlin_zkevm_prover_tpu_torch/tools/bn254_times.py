"""Holds, bounds and device times of the BN254 kernels B1-B4.

    python -m merlin_zkevm_prover_tpu_torch.tools.bn254_times [--out FILE]
        [--host-route ENTRIES DOMAIN] [--windows C ...] [--ntt-tiles K ...]
        [--fb-windows W ...] [--sort-routes] [--path-times]
        [--define NAME=VALUE ...]

Needs one CUDA card and nvcc.  Builds the kernels, prints their registers
and spills (``ptxas -v``), holds every kernel against its plain twin on the
card, exactly, on seeded data with edge values (field elements 0, 1,
m - 1, m - 2 and a word 2^64 - 1 in each limb; Goldilocks words 0, 1,
p - 1, p and 2^64 - 1; scalars 0, 1, r - 1 and repeated, negated and
infinite points), at small shapes and at every edge of the kernels'
control flow (rows of width 0 to 5, sponge chunks of 16 and 17 elements,
partial groups of a tree level, buckets longer than one range, NTTs of
every size from 2 to 2^12 and of 2^24), then times each kernel once at a
moderate shape (CUDA events, median of ``--runs``) beside its bound, and
times the Groth16 steps that run through B2 and B3 on the card
(``build_abc``, the setup's Lagrange table) beside the host route (numpy
over python ints) at ``--host-route`` sizes.  The first holds
(``small_holds``) include the three MSM shapes that once failed on the
card under the earlier unsigned-digit B3 (``early_fault_holds``):
G1 at 64 points and G2 at 12 against python ints, G1 at 3,000
witness-shaped scalars against ``msm_plain``, and ``hold_msm_path`` at
2^18 points.  ``--windows 12 13 14 15 16`` times B3 at each window c
(G1 at ``PATH_MSM`` witness-shaped scalars and at 2^20 full ones, each
held first); ``--sort-routes`` times one MSM's counting sort beside the
route through ``torch.sort`` (one launch writing every digit's 32-bit key
and entry, the compaction, the sort, the gather), at ``PATH_MSM`` and at
a fflonk commitment (``PATH_FFLONK_MSM``); ``--ntt-tiles 10 11 12``
times the NTT at 2^22 and 2^24 with passes of up to k stages (each held
first); ``--fb-windows 6 7 8 10`` times B4 at
each digit width (G1 and G2, full random scalars, each width held first);
``--path-times`` times B1, B2, B3 and B4 at the final hop's largest
shapes (``PATH_*``) beside their bounds: the kernels' schedule's, and
B1's with a full Montgomery product for every product, B3's with the
earlier count (unsigned digits, a complete addition an entry), B4's with
one complete addition a set bit.
``--define BN_POS_MIX_REGS=16`` builds the kernels from a copy of ``csrc/``
(under ``build/``) in which that ``#define`` has the given value, so that
a variant can be timed against the committed one in another process of
the same call.  Prints one JSON object.  ``chip_smoke.py`` uses the hold
and bound functions here at the final hop's own shapes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ..ops import bn254_cuda, cuda_build
from ..ops import bn254_field as bf
from ..ops import poseidon_bn254_cuda as pbc
from ..ops.bn254_field import FQ, FR
from ..ops.goldilocks import P as GL_P
from ..snark import curve, fft, msm
from ..snark.curve import F1, F2
from ..utils.timer import device_time_ms

# Peak rates of one H100 SXM as chip_smoke.py takes them: 3.35 TB/s and
# 16.75e12 32-bit multiply-adds a second, four of them a 64 x 64-bit product.
MEM_BYTES_PER_S = 3.35e12
IMAD32_PER_S = 33.5e12 / 2
IMAD_PER_MUL64 = 4
MUL64_PER_MONT = 36           # CIOS on four limbs: 4 x (4 + 1 + 4)
G1_ADD, G1_DBL = 16, 7        # Fq products of a complete add / a double
G1_MADD = 11                  # Fq products of B4's mixed addition
FQ2_MUL = 3                   # Fq products of one Fq2 product (Karatsuba)
GL_EDGE = [0, 1, GL_P - 1, GL_P, (1 << 64) - 1, 1 << 63, (1 << 32) - 1]


def bound_ms64(n_bytes: float, mul64: float):
    """(least ms, what bounds it) for `mul64` 64-bit products moving
    `n_bytes`."""
    t_mem = n_bytes / MEM_BYTES_PER_S
    t_ops = mul64 * IMAD_PER_MUL64 / IMAD32_PER_S
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def bound_ms(n_bytes: float, mont: float):
    """(least ms, what bounds it) for `mont` Montgomery products moving
    `n_bytes`."""
    return bound_ms64(n_bytes, mont * MUL64_PER_MONT)


def leaf_products(w: int) -> int:
    """Montgomery products of one leaf of a width-w row, every product a
    full CIOS product (``bound_leaf_cios``)."""
    if w <= 4:
        return 0
    n_fr = -(-w // 3)
    prods = n_fr + 1                      # into and out of Montgomery form
    for off in range(0, n_fr, pbc.ARITY):
        prods += pbc.mont_products(min(pbc.ARITY, n_fr - off) + 1)
    return prods


def leaf_mul64(w: int) -> int:
    """64-bit products of one leaf of a width-w row in the kernels'
    schedule (lazy mixes: pbc.mul64_products)."""
    if w <= 4:
        return 0
    n_fr = -(-w // 3)
    prods = (n_fr + 1) * MUL64_PER_MONT
    for off in range(0, n_fr, pbc.ARITY):
        prods += pbc.mul64_products(min(pbc.ARITY, n_fr - off) + 1)
    return prods


def bound_leaf(h: int, w: int):
    return bound_ms64(h * (w + 4) * 8, h * leaf_mul64(w))


def bound_leaf_cios(h: int, w: int):
    return bound_ms(h * (w + 4) * 8, h * leaf_products(w))


def bound_node(n: int):
    g = -(-n // pbc.ARITY)
    return bound_ms64((n + g) * 32, g * (pbc.mul64_products(17) +
                                         17 * MUL64_PER_MONT))


def bound_node_cios(n: int):
    g = -(-n // pbc.ARITY)
    return bound_ms((n + g) * 32, g * (pbc.mont_products(17) + 17))


def bound_ntt(n: int):
    log_n = n.bit_length() - 1
    return bound_ms(2 * n * 32 + n // 2 * 32, n // 2 * log_n)


def bound_mont_mul(n: int):
    return bound_ms(3 * n * 32, n)


def _point_products(F, adds: int, dbls: int, madds: int = 0) -> int:
    k = FQ2_MUL if F is F2 else 1
    return k * (G1_ADD * adds + G1_DBL * dbls + G1_MADD * madds)


def bound_msm_unsigned(F, scalars: torch.Tensor, c: int = None,
                       bits: int = 254):
    """The earlier B3's count: one complete addition a nonzero unsigned
    digit, two a bucket of the running sums, c doublings a window."""
    n = scalars.shape[0]
    c = c or msm.pick_window(n)
    nw = -(-bits // c)
    nonzero = sum(int((msm.window_digits(scalars, c, w, bits) != 0).sum())
                  for w in range(nw))
    words = 3 * (8 if F is F2 else 4)
    return bound_ms(n * (words + 4) * 8,
                    _point_products(F, nonzero + 2 * nw * (1 << c), nw * c))


def reduce_threads(half: int) -> int:
    """bn_msm_reduce's block for 2^(c-1) = half buckets a window, as the
    library launches it."""
    return cuda_build.lib().merlin_bn_msm_reduce_threads(half)


def msm_schedule(F, scalars: torch.Tensor, c: int, bits: int = 254) -> Dict:
    """The additions of B3's schedule on these scalars at window c: a mixed
    addition a nonzero signed digit but each range's first (ranges of at
    most sum_range entries a bucket), a complete addition a range joined
    into its bucket, two a bucket of the running sums, the tree's three and
    S 2^l doublings a join, c doublings and an addition a window to
    combine.  Counted window by window (no (windows, n) temporary)."""
    half, nw = 1 << (c - 1), msm.n_windows(bits, c)
    cap = msm.sum_range(F)
    entries = ranges = joins = 0
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64,
                        device=scalars.device)
    for w in range(nw):
        v = carry + (msm.window_digits(scalars, c, w, bits) if w * c < bits
                     else 0)
        carry = (v > half).long()
        d = (v - (carry << c)).abs()
        cnt = torch.bincount(d[d != 0] - 1, minlength=half)
        nr = (cnt + cap - 1) // cap
        entries += int(cnt.sum())
        ranges += int(nr.sum())
        joins += int((nr - 1).clamp(min=0).sum())
    threads = reduce_threads(half)
    s_bits = max(0, (half // threads).bit_length() - 1)
    levels = threads.bit_length() - 1
    tree_dbls = sum((threads >> (l + 1)) * (s_bits + l) for l in range(levels))
    return {"madds": entries - ranges, "adds": joins + nw * (
        2 * half + 3 * (threads - 1)) + nw, "dbls": nw * (tree_dbls + c),
        "entries": entries, "ranges": ranges}


# the windows merlin_bn_msm_digits accepts
MSM_WINDOWS = range(2, 25)


def msm_products(F, scalars: torch.Tensor, c: int, bits: int = 254) -> int:
    """Fq products of B3's schedule (msm_schedule) at window c."""
    sch = msm_schedule(F, scalars, c, bits)
    return _point_products(F, sch["adds"], sch["dbls"], sch["madds"])


def least_window(F, scalars: torch.Tensor, bits: int = 254) -> tuple:
    """(c, Fq products) of the window in MSM_WINDOWS whose schedule needs
    the fewest products on these scalars."""
    return min(((c, msm_products(F, scalars, c, bits)) for c in MSM_WINDOWS),
               key=lambda cp: cp[1])


def bound_msm(F, scalars: torch.Tensor, c: int = None, bits: int = 254):
    """B3's schedule on these scalars at window c, or where c is None at
    the window that needs the fewest products (least_window: the sum is
    the same point at any c); the bytes: each affine base and scalar read
    once."""
    prods = least_window(F, scalars, bits)[1] if c is None else \
        msm_products(F, scalars, c, bits)
    words = 2 * (8 if F is F2 else 4)
    return bound_ms(scalars.shape[0] * (words + 4) * 8, prods)


# Fq products of one inversion by Fermat's little theorem (about 254
# squarings and 127 products)
INV_PRODUCTS = 380


def bound_affine(F, n: int):
    """Batch-to-affine as the function needs it: one inversion for the
    whole batch (Montgomery's trick, three products a point), then z^-2,
    z^-3, x z^-2 and y z^-3 (four), so seven products a point (over Fq2
    three Fq products each); a Jacobian point read, an affine one
    written."""
    k = FQ2_MUL if F is F2 else 1
    words = 8 if F is F2 else 4
    return bound_ms(n * 5 * words * 8,
                    k * (7 * n + INV_PRODUCTS * (n > 0)))


def bound_powers(n: int):
    """One product an element, 32 bytes written."""
    return bound_ms(n * 32, n)


def bound_poly_eval(m: int):
    """Two products a coefficient (its power, its product), 32 bytes
    read."""
    return bound_ms(m * 32, 2 * m)


def _reduce_products(F, g: int, c: int) -> int:
    """Fq products of one bn_msm_reduce launch over g windows: two
    complete additions a bucket, the tree's three and S 2^l doublings a
    join, c doublings and an addition a window to combine."""
    half = 1 << (c - 1)
    threads = reduce_threads(half)
    s_bits = max(0, (half // threads).bit_length() - 1)
    levels = threads.bit_length() - 1
    tree_dbls = sum((threads >> (l + 1)) * (s_bits + l) for l in range(levels))
    return _point_products(F, g * (2 * half + 3 * (threads - 1) + 1),
                           g * (tree_dbls + c))


def bound_launches(kid: str, shapes: Dict) -> tuple:
    """The least ms of every B2 or B3 launch a run logged (the wrappers'
    SHAPES records: {kernel: {shape: launches}}), summed: each launch's
    bytes (its inputs read once, its outputs written once) against its
    products, counted on the run's shapes (entries and ranges as the
    data made them).  Returns (ms, launches counted)."""
    group = {"Fr": None, "G1": F1, "G2": F2}
    total, count = 0.0, 0

    def add(bound, times):
        nonlocal total, count
        total += bound[0] * times
        count += times

    if kid == "B2":
        for (n, _inv), k in shapes.get("pass", {}).items():
            passes = len(fft.ntt_passes(n.bit_length() - 1))
            add((bound_ntt(n)[0] / passes,), k)
        for (_f, n, one), k in shapes.get("mont_mul", {}).items():
            add(bound_ms((2 + (not one)) * n * 32, n), k)
        for n, k in shapes.get("mul_sub", {}).items():
            add(bound_ms(4 * n * 32, n), k)
        for (_b, n, _s), k in shapes.get("powers", {}).items():
            add(bound_powers(n), k)
        for (m, _st), k in shapes.get("poly_eval", {}).items():
            add(bound_poly_eval(m), k)
        return total, count
    for (g, n), k in shapes.get("affine", {}).items():
        add(bound_affine(group[g], n), k)
    for name in ("digits", "scatter"):
        for (g, n, _c), k in shapes.get(name, {}).items():
            add(bound_ms(n * 40, 0), k)
    for (g, e, r), k in shapes.get("bucket_sums", {}).items():
        F = group[g]
        w = 8 if F is F2 else 4
        add(bound_ms(e * (4 + 16 * w) + r * 24 * w,
                     _point_products(F, 0, 0, e - r)), k)
    for (g, vals, r, _gath), k in shapes.get("sum_ranges", {}).items():
        F = group[g]
        w = 4 if F is None else 3 * (8 if F is F2 else 4)
        adds = 0 if F is None else _point_products(F, vals - r, 0)
        add(bound_ms((vals + r) * w * 8, adds), k)
    for (g, windows, c), k in shapes.get("reduce", {}).items():
        F = group[g]
        w = 3 * (8 if F is F2 else 4)
        add(bound_ms(windows * (1 << (c - 1)) * w * 8,
                     _reduce_products(F, windows, c)), k)
    return total, count


def set_bits(scalars: torch.Tensor) -> int:
    """The set bits of (n, 4) plain scalar limbs, counted bit by bit (no
    (n, 256) temporary)."""
    return sum(int(((scalars >> k) & 1).sum()) for k in range(64))


def bound_fixed_base_set_bits(F, scalars: torch.Tensor):
    """The double-and-add count: one complete addition a set bit, 256
    doublings of the base."""
    adds = set_bits(scalars)
    words = 3 * (8 if F is F2 else 4)
    return bound_ms(scalars.shape[0] * (words + 4) * 8,
                    _point_products(F, adds, 256))


def digit_counts(scalars: torch.Tensor, w: int) -> torch.Tensor:
    """Nonzero signed digits of each (n, 4) plain scalar under B4's
    recoding (curve.signed_digits), vectorised: v = bits + carry, zero
    where v is 0 or 2^w."""
    half, mask = 1 << (w - 1), (1 << w) - 1
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64,
                        device=scalars.device)
    count = torch.zeros_like(carry)
    for j in range(curve.fixed_base_windows(w)):
        lo = w * j
        k, off = lo >> 6, lo & 63
        bits = torch.zeros_like(carry)
        if k < 4 and off + w <= 64:
            bits = (scalars[:, k] >> off) & mask
        elif k < 4:                       # the window crosses a limb
            bits = (scalars[:, k] >> off) & ((1 << (64 - off)) - 1)
            if k + 1 < 4:
                bits |= (scalars[:, k + 1] & ((1 << (off + w - 64)) - 1)) \
                    << (64 - off)
        v = bits + carry
        carry = (v > half).long()
        count += ((v != 0) & (v != (1 << w))).long()
    return count


def bound_fixed_base(F, scalars: torch.Tensor, w: int = None):
    """The kernel's walk: one mixed addition (11 products) a nonzero digit
    but a scalar's first; the scalars read, the points written and the
    base's table read once."""
    w = w or curve.FB_WINDOW
    nz = digit_counts(scalars, w)
    madds = int((nz - 1).clamp(min=0).sum())
    k = FQ2_MUL if F is F2 else 1
    words = 3 * (8 if F is F2 else 4)
    table = curve.fixed_base_windows(w) << (w - 1)
    return bound_ms(scalars.shape[0] * (words + 4) * 8 +
                    table * 2 * (words // 3) * 8, k * G1_MADD * madds)


# ---------------------------------------------------------------------------
# Seeded data
# ---------------------------------------------------------------------------


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def gl_rows(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(h, w) 64-bit words, the Goldilocks edge words across the first and
    last rows."""
    x = torch.randint(-(1 << 63), (1 << 63) - 1, (h, w), generator=gen,
                      device=device, dtype=torch.int64)
    edge = torch.tensor([_signed(v) for v in GL_EDGE], dtype=torch.int64,
                        device=device)
    for j in range(min(len(GL_EDGE), h)):
        row = torch.roll(edge, j).repeat(-(-w // len(GL_EDGE)))[:w]
        x[j] = row
        x[h - 1 - j] = row
    return x


def fr_edge_ints(ctx) -> List[int]:
    m = ctx.mod
    return [0, 1, m - 1, m - 2, (1 << 64) - 1, ((1 << 64) - 1) << 64,
            ((1 << 64) - 1) << 128, m >> 1]


def field_elems(ctx, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 4) canonical plain elements, the edge values at both ends."""
    words = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 4), generator=gen,
                          device=device, dtype=torch.int64)
    words[:, 3] &= (1 << 61) - 1          # below 2^253 < m
    edge = bf.from_u64(bf.ints_to_limbs(fr_edge_ints(ctx)), device)
    k = min(edge.shape[0], n)
    words[:k] = edge[:k]
    words[n - k:] = edge[:k]
    return words


# ---------------------------------------------------------------------------
# Holds: kernel against twin, exact
# ---------------------------------------------------------------------------


def _ends(x: torch.Tensor, cap: int) -> torch.Tensor:
    """The first and last `cap` rows (all of them when that is fewer)."""
    if x.shape[0] <= 2 * cap:
        return x
    return torch.cat([x[:cap], x[-cap:]])


def diff_words(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the 64-bit words read unsigned (0 for equal)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    au = a.cpu().numpy().view(np.uint64)
    bu = b.cpu().numpy().view(np.uint64)
    return int(np.max(np.where(au > bu, au - bu, bu - au)))


def hold_leaves(shapes, gen: torch.Generator, device, cap: int = 4096
                ) -> List[Dict]:
    """hold_leaf at every (h, w) of `shapes` with one plain call a width:
    the twin's cost is one batched permutation a sponge chunk whatever the
    rows, so the first and last `cap` rows of all heights of one width go
    through it together."""
    out = []
    for w in sorted({w for _h, w in shapes}):
        hs = sorted(h for h, w_ in shapes if w_ == w)
        rows, got = [], []
        for h in hs:
            x = gl_rows(h, w, gen, device)
            got.append(_ends(pbc.leaf_hash(x), cap))
            rows.append(_ends(x, cap))
            del x
        want = pbc.leaf_hash_plain(torch.cat(rows))
        at = 0
        for h, g in zip(hs, got):
            k = g.shape[0]
            out.append({"kernel": "B1 leaf", "shape": [h, w], "held_rows": k,
                        "max_abs_err": diff_words(g, want[at:at + k])})
            at += k
    return out


def hold_nodes(sizes, gen: torch.Generator, device, cap: int = 4096
               ) -> List[Dict]:
    """hold_node at every level size of `sizes`, one plain call for all:
    each level's groups of 16 (zero past its end; the first and last `cap`
    groups above 2 cap) stacked."""
    groups, got, meta = [], [], []
    for n in sorted(sizes):
        level = field_elems(FR, n, gen, device)
        out = pbc.node_hash(level)
        g = out.shape[0]
        padded = torch.cat([level, level.new_zeros((g * pbc.ARITY - n, 4))])
        grouped = padded.reshape(g, pbc.ARITY, 4)
        groups.append(_ends(grouped, cap))
        got.append(_ends(out, cap))
        meta.append((n, got[-1].shape[0]))
        del level, padded
    want = pbc.node_hash_plain(torch.cat(groups).reshape(-1, 4))
    res, at = [], 0
    for (n, k), g in zip(meta, got):
        res.append({"kernel": "B1 node", "shape": [n, 4], "held_nodes": k,
                    "max_abs_err": diff_words(g, want[at:at + k])})
        at += k
    return res


def hold_tree_host(rows: torch.Tensor) -> Dict:
    """The kernels' root of a tree against the host MerkleTreeBN128."""
    from ..stark.merkle_bn128 import MerkleTreeBN128

    levels = pbc.merkelize(rows)
    host = MerkleTreeBN128([[int(v) for v in r]
                            for r in rows.cpu().numpy().view(np.uint64)])
    root = bf.limbs_to_ints(levels[-1])[0]
    return {"kernel": "B1 tree", "shape": list(rows.shape),
            "levels": len(levels), "max_abs_err": 0 if root == host.root()
            else abs(root - host.root())}


def hold_mont_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> Dict:
    got = bn254_cuda.mont_mul(ctx, a, b)
    want = bn254_cuda.mont_mul_plain(ctx, a, b)
    return {"kernel": "B2 mont_mul", "field": ctx.name, "n": int(a.shape[0]),
            "max_abs_err": diff_words(got, want)}


def hold_ntt(a: torch.Tensor, inverse: bool) -> Dict:
    got = fft._ntt(a, inverse)
    want = fft._ntt_plain(a, inverse)
    return {"kernel": "B2 ntt", "n": int(a.shape[0]), "inverse": inverse,
            "max_abs_err": diff_words(got, want)}


def _bases(F, points) -> torch.Tensor:
    """Affine words of a Point or of packed Jacobian or affine words."""
    return msm.affine_bases(F, points)


def hold_msm(F, points, scalars: torch.Tensor, cap: int = 4096,
             check_ints=None, c: int = None) -> Dict:
    """msm (at window `c`, by default the card's) against msm_plain (at the
    reference's window for the held points: the same point at any c), both
    to affine, on the first and last `cap` points (all when fewer);
    `check_ints` also against a python-int sum.  `points` a Point or
    affine or Jacobian words."""
    n = scalars.shape[0]
    bases = _bases(F, points)
    if n > 2 * cap:
        sel = torch.cat([torch.arange(cap), torch.arange(n - cap, n)]).to(
            scalars.device)
        bases, scalars = bases[sel], scalars[sel]
    c = c or msm.window(scalars.shape[0])
    c_plain = msm.pick_window(scalars.shape[0])
    got = curve.affine_ints(F, _one(F, msm.msm(F, bases, scalars, c=c)))
    want = curve.affine_ints(F, _one(F, msm.msm_plain(F, bases, scalars,
                                                      c=c_plain)))
    out = {"kernel": "B3 msm", "group": "G2" if F is F2 else "G1", "n": n,
           "c": c, "plain_c": c_plain, "held_points": int(scalars.shape[0]),
           "max_abs_err": 0 if got == want else 1}
    if check_ints is not None:
        out["equal_to_python_ints"] = got == [check_ints]
        if not out["equal_to_python_ints"]:
            out["max_abs_err"] = 1
    return out


def hold_msm_path(F, n: int, c: int, gen: torch.Generator, device,
                  cap: int = 4096) -> Dict:
    """B3 at a path's point count `n` and window `c`: n affine bases and
    scalars, every scalar 0 but the first and last `cap` (witness-shaped,
    with repeated, negated and infinite bases and the edge scalars), so the
    kernels run the path's grid and windows; against msm_plain on those
    2 cap (at the reference's window for them).  Counts the range passes
    (the affine bucket sums
    and each sum_ranges pass after them): about a quarter of the scalars
    are 1, so the digit-1 bucket spans more than 32 * 32 entries and three
    passes."""
    m = min(n, 2 * cap)
    bases = _bases(F, points_table(F, m, gen, device)[0])
    s = scalars_like_witness(m, gen, device)
    lo = m // 2
    where = torch.cat([torch.arange(lo), torch.arange(n - (m - lo), n)]
                      ).to(device)
    src = torch.zeros(n, dtype=torch.int64, device=device)
    src[where] = torch.arange(m, device=device)
    full_bases = bases[src]
    full_s = torch.zeros((n, 4), dtype=torch.int64, device=device)
    full_s[where] = s
    del src
    before = msm.LAUNCHES["sum_ranges"] + msm.LAUNCHES["bucket_sums"]
    got = curve.affine_ints(F, _one(F, msm.msm(F, full_bases, full_s, c=c)))
    passes = msm.LAUNCHES["sum_ranges"] + msm.LAUNCHES["bucket_sums"] - before
    del full_bases, full_s
    c_plain = msm.pick_window(m)
    want = curve.affine_ints(F, _one(F, msm.msm_plain(F, bases, s,
                                                      c=c_plain)))
    return {"kernel": "B3 msm", "group": msm.group_name(F), "n": n, "c": c,
            "plain_c": c_plain, "held_points": m, "zero_scalars": n - m,
            "range_passes": passes,
            "max_abs_err": 0 if got == want else 1}


def affine_edge_bases(F, m: int, gen: torch.Generator, device) -> torch.Tensor:
    """(m, 3 W) Jacobian words of seeded points with Z not 1 (B4's sums),
    an infinity, a repeated point and its negation at the front."""
    pts, _ = points_table(F, m, gen, device)
    words = curve.pack(F, pts)
    if m > 3:
        words[3] = curve.pack(F, curve.infinity(F, (1,), device))[0]
    return words


def hold_affine(F, n: int, gen: torch.Generator, device, cap: int = 4096
                ) -> Dict:
    """bn_to_affine launched on n points (the first and last rows the
    edge bases, the rows between repeats of them), its first and last cap
    rows against the twin's."""
    m = min(n, 2 * cap)
    edge = affine_edge_bases(F, m, gen, device)
    if n > m:
        words = edge[torch.arange(n, device=device) % m]
        words[n - cap:] = edge[cap:]
    else:
        words = edge
    got = msm.affine_bases(F, words)
    sel = torch.cat([torch.arange(min(cap, n)),
                     torch.arange(max(n - cap, min(cap, n)), n)]).to(device)
    want = msm.affine_bases_plain(F, words[sel])
    return {"kernel": "B3 affine", "group": msm.group_name(F), "n": n,
            "held": int(sel.numel()),
            "max_abs_err": diff_words(got[sel], want)}


def hold_digits(F, n: int, c: int, gen: torch.Generator, device,
                w0: int = 0, g: int = None) -> Dict:
    """bn_msm_digits (the counts, then the scatter) on n witness-shaped
    scalars and bases with infinities, windows w0 .. w0 + g - 1 (all by
    default), against digit_entries_plain: the counts equal, and each
    bucket's entries equal once sorted by point index (the kernel's
    atomics give them in any order)."""
    nw = msm.n_windows(254, c)
    g = g or nw - w0
    s = scalars_like_witness(n, gen, device)
    bases = torch.zeros((n, 2 * F.words), dtype=torch.int64, device=device)
    bases[::97] = -1                          # every 97th at infinity
    bases[::97, F.words:] = 0
    cnt = msm.digit_counts(F, bases, s, c, w0, g, 254)
    first = torch.cumsum(cnt.long(), 0) - cnt.long()
    total = int(cnt.long().sum())
    got = msm.digit_entries(F, bases, s, c, w0, g, 254, first.int(), total)
    keys, want = msm.digit_entries_plain(F, bases, s, c, w0, g, 254)
    err = diff_words(cnt.long(), torch.bincount(keys, minlength=g << (c - 1)))
    if err == 0:
        e = got.long() & 0xFFFFFFFF
        kb = torch.repeat_interleave(
            torch.arange(cnt.shape[0], device=device), cnt.long())
        e = e[torch.argsort(kb * (1 << 31) + (e & 0x7FFFFFFF))]
        err = diff_words(e, want)
    return {"kernel": "B3 digits+scatter", "group": msm.group_name(F), "n": n,
            "c": c, "windows": [w0, g], "entries": total, "max_abs_err": err}


def hold_bucket_sums(F, n_entries: int, n_ranges: int, gen: torch.Generator,
                     device, cap: int = 4096) -> Dict:
    """bn_msm_bucket_sums at a logged (entries, ranges) shape: entries over
    a few thousand affine bases, none at infinity (the digit kernels never
    place one), the first three P, P and -P, so that ranges meet equal and
    opposite points; random signs, in buckets cut to about as many ranges;
    the first and last cap ranges against the twin's, affine."""
    pts = curve.pack(F, points_table(F, 2 * cap, gen, device)[0])
    fin = torch.nonzero(~msm.is_affine_inf(F, msm.affine_bases(F, pts))
                        ).reshape(-1)
    p0 = pts[fin[:1]]
    neg = curve.pack(F, curve.neg(F, curve.unpack(F, p0)))
    bases = msm.affine_bases(F, torch.cat([p0, p0, neg, pts[fin]]))
    m = bases.shape[0]
    idx = torch.randint(0, m, (n_entries,), generator=gen, device=device)
    idx[:64] = torch.tensor([0, 1, 2] * 21 + [0], device=device)
    sign = torch.randint(0, 2, (n_entries,), generator=gen, device=device)
    entries = msm._as_u32(idx | (sign << 31))
    # ranges = sum ceil(count / 32): about entries / 32 + one a bucket
    nb = max(1, min(n_entries, n_ranges - n_entries // msm.sum_range(F)))
    cuts = torch.sort(torch.randint(0, n_entries + 1, (nb - 1,),
                                    generator=gen, device=device)).values
    bounds = torch.cat([cuts.new_zeros(1), cuts, cuts.new_tensor([n_entries])])
    cnt = torch.diff(bounds)
    first = bounds[:-1]
    starts, counts, strides, _ = msm.bucket_ranges(cnt, first, msm.sum_range(F))
    got = msm.bucket_sums(F, bases, entries, starts, counts, strides)
    r = starts.shape[0]
    sel = torch.cat([torch.arange(min(cap, r)),
                     torch.arange(max(r - cap, min(cap, r)), r)]).to(device)
    want = msm.bucket_sums_plain(F, bases, entries, starts[sel], counts[sel],
                                 strides[sel])
    same = curve.affine_ints(F, curve.unpack(F, got[sel])) == \
        curve.affine_ints(F, curve.unpack(F, want))
    return {"kernel": "B3 bucket_sums", "group": msm.group_name(F),
            "n": n_entries, "ranges": n_ranges, "held_ranges": int(sel.numel()),
            "made_ranges": r, "max_abs_err": 0 if same else 1}


def hold_reduce(F, g: int, c: int, gen: torch.Generator, device) -> Dict:
    """bn_msm_reduce at a logged (windows, c) shape: random bucket points
    (some infinity, some repeated) against window_sums_plain and the
    windows' combine in python ints (sum_w 2^(c w) W_w from the top
    window), affine."""
    from ..snark import pairing as pr

    half = 1 << (c - 1)
    pts = affine_edge_bases(F, 512, gen, device)
    pick = torch.randint(0, 512, (g * half,), generator=gen, device=device)
    buckets = pts[pick]
    got = curve.affine_ints(F, curve.unpack(F, msm.reduce_windows(
        F, buckets, c)))[0]
    wsums = curve.affine_ints(F, curve.unpack(F, msm.window_sums_plain(
        F, buckets, c)))
    add, mul = (pr.g1_add, pr.g1_mul) if F is F1 else (pr.g2_add, pr.g2_mul)
    acc = None
    for w in range(g - 1, -1, -1):
        acc = add(mul(1 << c, acc) if acc is not None else None, wsums[w])
    if acc is not None and F is F2:
        acc = (tuple(acc[0]), tuple(acc[1]))
    same = got == acc
    return {"kernel": "B3 reduce", "group": msm.group_name(F), "windows": g,
            "c": c, "max_abs_err": 0 if same else 1}


# above this many elements a twin's (16-bit limb) temporaries outgrow the
# card's memory beside a phase's own: the holds take another reference
TWIN_MAX = 1 << 24


def hold_powers(base: int, n: int, start: int, device, cap: int = 4096
                ) -> Dict:
    """powers against its twin (up to TWIN_MAX elements) and, on the first
    and last cap, python ints."""
    got = bn254_cuda.powers(base, n, start, device)
    err = diff_words(got, bn254_cuda.powers_plain(base, n, start, device)) \
        if n <= TWIN_MAX else 0
    idx = sorted(set(range(min(cap, n))) | set(range(max(n - cap, 0), n)))
    want = [start * pow(base, i, FR.mod) % FR.mod for i in idx]
    if bf.to_int(FR, got[torch.tensor(idx, dtype=torch.long,
                                      device=device)]).tolist() != want:
        err = err or 1
    return {"kernel": "B2 powers", "n": n, "twin": n <= TWIN_MAX,
            "python_ints": len(idx), "max_abs_err": err}


def hold_poly_eval(m: int, gen: torch.Generator, device, stride: int = 1,
                   horner_max: int = 1 << 16) -> Dict:
    """B2's fused evaluation at a logged (coefficients, rows apart) shape
    against its twin (above TWIN_MAX: the kernels it fuses, the powers
    table, the products and B3's Fr range sum, each held at its own
    shapes) and, up to horner_max coefficients, the host Horner of
    fflonk.poly_eval; x seeded."""
    from ..snark import fflonk as ffl

    table = bf.to_mont(FR, field_elems(FR, m * stride, gen, device))
    coefs = table.reshape(m, stride, 4)[:, 0] if stride > 1 else table
    x = int(torch.randint(1, 1 << 62, (1,), generator=gen, device=device)) \
        << 190 | 12345
    got = bn254_cuda.poly_eval(coefs, x)
    if m <= TWIN_MAX:
        want = bn254_cuda.poly_eval_plain(coefs, x)
    else:
        prods = bn254_cuda.mont_mul(FR, coefs, bn254_cuda.powers(x, m,
                                                                 device=device))
        want = msm.sum_by_key(None, prods, torch.zeros(
            m, dtype=torch.int64, device=device), None, 1)[0]
    err = diff_words(got, want)
    out = {"kernel": "B2 poly_eval", "n": m, "stride": stride,
           "against": "twin" if m <= TWIN_MAX else "powers, mont_mul, sum_by_key"}
    if m <= horner_max:
        host = ffl.poly_eval(ffl.fr_ints(coefs), x)
        out["equal_to_host_horner"] = host == ffl.fr_ints(got[None])[0]
        err = err or (0 if out["equal_to_host_horner"] else 1)
    out["max_abs_err"] = err
    return out


def hold_sum_ranges(F, n_vals: int, n_ranges: int, gathered: bool,
                    gen: torch.Generator, device, cap: int = 4096) -> Dict:
    """bn_sum_ranges against its twin at a logged (values, ranges,
    gathered) shape, on min(values, 2 cap) seeded values (Fr elements or
    points with repeats) cut at random into as many ranges in the same
    proportion, read through a random permutation when the logged launch
    was; points compare affine."""
    m = min(n_vals, 2 * cap)
    r = max(1, min(m, round(m * n_ranges / max(n_vals, 1))))
    if F is None:
        vals = bf.to_mont(FR, field_elems(FR, m, gen, device))
    else:
        vals = curve.pack(F, points_table(F, m, gen, device)[0])
    cuts = torch.sort(torch.randperm(m - 1, generator=gen, device=device)
                      [:r - 1] + 1).values
    starts = torch.cat([cuts.new_zeros(1), cuts])
    counts = torch.diff(starts, append=starts.new_tensor([m]))
    idx = torch.randperm(m, generator=gen, device=device) if gathered \
        else None
    got = msm.sum_ranges(F, vals, idx, starts, counts)
    want = msm.sum_ranges_plain(F, vals, idx, starts, counts)
    if F is None:
        err = diff_words(got, want)
    else:
        err = 0 if curve.affine_ints(F, curve.unpack(F, got)) == \
            curve.affine_ints(F, curve.unpack(F, want)) else 1
    return {"kernel": "B3 sum_ranges", "group": msm.group_name(F),
            "n": n_vals, "ranges": n_ranges, "gathered": gathered,
            "held": m, "held_ranges": r, "max_abs_err": err}


def hold_fixed_base(F, base, scalars: torch.Tensor, cap: int = 4096) -> Dict:
    """B4 launched on all the scalars, its first and last `cap` results
    against the twin's on those scalars, affine."""
    n = scalars.shape[0]
    sel = torch.arange(n, device=scalars.device)
    sel = _ends(sel[:, None], cap)[:, 0]
    words = curve.scalar_mul_words(F, base, scalars)[sel]
    got = curve.affine_ints(F, curve.unpack(F, words))
    want = curve.affine_ints(F, curve.scalar_mul_table_plain(
        F, base, scalars[sel]))
    return {"kernel": "B4 fixed_base", "group": "G2" if F is F2 else "G1",
            "n": int(n), "held_scalars": int(sel.shape[0]),
            "max_abs_err": 0 if got == want else 1}


def meet_kinds(e: int, w: int) -> List[str]:
    """What B4's walk of e meets, window by window, for a base of order r:
    "equal" where the accumulator L P (L the lower digits' sum) is the
    point d 2^(w j) P it adds (the doubling), "opposite" where it is its
    negation (infinity)."""
    r, out, low = FR.mod, [], 0
    for j, d in enumerate(curve.signed_digits(e, w)):
        t = d << (w * j)
        if d and low % r:
            if (low - t) % r == 0:
                out.append("equal")
            elif (low + t) % r == 0:
                out.append("opposite")
        low += t
    return out


def meet_scalars(w: int) -> Dict[str, List[int]]:
    """Scalars below 2^256 whose walk meets +-the point it adds: k r (the
    last digit's addition gives infinity) and 2 d 2^(w j) - k r (the lower
    windows' sum d 2^(w j) - k r is the point), each kept where
    meet_kinds finds the case."""
    r = FR.mod
    out = {"equal": [], "opposite": []}
    cands = [k * r for k in (1, 2, 3)]
    for j in range(curve.fixed_base_windows(w)):
        for d in range(1, (1 << (w - 1)) + 1):
            cands += [e for e in ((2 * d << (w * j)) - k * r for k in (1, 2))
                      if 0 <= e < 1 << 256]
    for e in cands:
        for kind in set(meet_kinds(e, w)):
            out[kind].append(e)
    return out


def edge_scalars(w: int) -> List[int]:
    """B4's edge scalars at digit width w: 0, 1, r - 1, r, 2^k and r - 2^k
    at window edges, 2^256 - 1, a carry into the top window, every digit
    at +2^(w-1) and at -(2^(w-1) - 1), and the meet_scalars."""
    r, half = FR.mod, 1 << (w - 1)
    n_win = curve.fixed_base_windows(w)
    ks = sorted({0, 1, w - 1, w, 63, 64, 127, 128, 252, 253, 254, 255,
                 w * (n_win - 2), w * (n_win - 2) - 1})
    out = [0, 1, 2, r - 1, r, r + 1, (1 << 256) - 1]
    out += [1 << k for k in ks] + [(r - (1 << k)) % (1 << 256) for k in ks]
    out.append(((1 << w) - 1) << (w * (n_win - 2)))          # carry to the top
    out.append(sum(half << (w * j) for j in range(n_win - 1)) % (1 << 256))
    out.append(sum((half + 1) << (w * j) for j in range(n_win - 1))
               % (1 << 256))
    meet = meet_scalars(w)
    out += meet["equal"][:4] + meet["opposite"][:4]
    return out


def hold_fixed_base_edges(F, w: int, device, ints: bool = True) -> Dict:
    """B4 at the edge scalars against its twin and (`ints`) python ints,
    affine."""
    from ..snark import pairing as pr

    es = edge_scalars(w)
    s = bf.scalars_to_limbs(es, device)
    base = _one_gen(F, device)
    got = curve.affine_ints(F, curve.unpack(F, curve.scalar_mul_words(
        F, base, s, w=w)))
    want = curve.affine_ints(F, curve.scalar_mul_table_plain(F, base, s))
    meet = meet_scalars(w)
    out = {"kernel": "B4 fixed_base edges", "group": "G2" if F is F2 else "G1",
           "w": w, "scalars": len(es),
           "meet_equal": len(meet["equal"][:4]),
           "meet_opposite": len(meet["opposite"][:4]),
           "max_abs_err": 0 if got == want else 1}
    if ints:
        mul, gen_pt = (pr.g1_mul, pr.G1_GEN) if F is F1 else \
            (pr.g2_mul, pr.G2_GEN)
        want_i = [mul(e, gen_pt) for e in es]
        want_i = [None if p is None else (p if F is F1 else
                                          (tuple(p[0]), tuple(p[1])))
                  for p in want_i]
        out["equal_to_python_ints"] = got == want_i
        if got != want_i:
            out["max_abs_err"] = 1
    return out


def leaf_edge_widths() -> List[int]:
    """Row widths whose last sponge chunk has every width t = 2..17, alone
    (3 (t - 1) words, even t) or after a full chunk (3 (t + 15) - 1, the
    last element short of a word, odd t), and the widths 1-5, 47-49, 105
    and 665."""
    ws = {1, 2, 3, 4, 5, 47, 48, 49, 105, 665}
    for t in range(2, 18):
        ws.add(3 * (t - 1) if t % 2 == 0 else 3 * (t + 15) - 1)
    return sorted(ws)


def _rows(F, leaf, sel):
    if F is F2:
        return curve.Fq2El(leaf.c0[sel], leaf.c1[sel])
    return leaf[sel]


def _one(F, p):
    return curve.Point(*[curve._unsqueeze1(F, leaf) for leaf in p])


def scalars_like_witness(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Plain scalars shaped like a final witness: most 0 or 1, some small,
    some full, the edge values 0, 1, r - 1 at both ends."""
    kind = torch.randint(0, 8, (n,), generator=gen, device=device)
    full = field_elems(FR, n, gen, device)
    small = torch.zeros_like(full)
    small[:, 0] = torch.randint(0, 1 << 20, (n,), generator=gen, device=device)
    bit = torch.zeros_like(full)
    bit[:, 0] = kind & 1
    s = torch.where((kind < 5)[:, None], bit,
                    torch.where((kind < 6)[:, None], small, full))
    edge = bf.from_u64(bf.ints_to_limbs([0, 1, FR.mod - 1]), device)
    s[:3] = edge
    s[-3:] = edge
    return s


def points_table(F, n: int, gen: torch.Generator, device):
    """n seeded points [k_i] G with repeats (the same point twice, and its
    negation) at the front."""
    ks = field_elems(FR, n, gen, device)
    if n > 1:
        ks[1] = ks[0]
    pts = curve.scalar_mul_table(F, (curve.g1_generator(device) if F is F1
                                     else curve.g2_generator(device)), ks)
    if n > 2:
        neg = curve.neg(F, curve.Point(*[_rows(F, leaf, torch.tensor([0], device=device))
                                         for leaf in pts]))
        pts = curve.Point(*[_set_row(F, leaf, 2, nleaf)
                            for leaf, nleaf in zip(pts, neg)])
    return pts, ks


def _set_row(F, leaf, i, src):
    if F is F2:
        c0, c1 = leaf.c0.clone(), leaf.c1.clone()
        c0[i], c1[i] = src.c0[0], src.c1[0]
        return curve.Fq2El(c0, c1)
    out = leaf.clone()
    out[i] = src[0]
    return out


# ---------------------------------------------------------------------------


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def b1_b4_holds(dev, gen) -> List[Dict]:
    """B1 and B4 at the edges of their control flow."""
    out = hold_leaves([(37, w) for w in (0, 1, 3, 4, 5, 6, 24, 47, 48, 49,
                                         105)] + [(9000, 24)], gen, dev)
    out += hold_leaves([(130, w) for w in leaf_edge_widths()], gen, dev)
    out += hold_nodes([1, 15, 16, 17, 33, 300, 140000], gen, dev)
    out.append(hold_tree_host(gl_rows(300, 24, gen, dev)))
    for F in (F1, F2):
        out.append(hold_fixed_base(F, _one_gen(F, dev),
                                   field_elems(FR, 3000, gen, dev), 64))
        for w in (curve.FB_WINDOW, curve.FB_WINDOW_SMALL):
            out.append(hold_fixed_base_edges(F, w, dev))
    return out


def quick_holds(dev, gen) -> List[Dict]:
    """B1 and B4 at a few edges (a variant's check before its times)."""
    out = hold_leaves([(37, w) for w in (5, 24, 47, 48, 105)], gen, dev)
    out += hold_nodes([1, 17, 300], gen, dev)
    out.append(hold_fixed_base_edges(F1, curve.FB_WINDOW, dev))
    return out


def early_fault_holds(dev, gen) -> List[Dict]:
    """The three MSM shapes that once failed on the card under the earlier
    unsigned-digit B3 (cause not isolated): G1 at 64
    points and G2 at 12 against python-int sums, at c of None, 3 and 12,
    with a negated point in row 2; G1 at 3,000 witness-shaped scalars
    against msm_plain; hold_msm_path at 2^18 points."""
    from ..snark import pairing as pr

    out = []
    for F, n in ((F1, 64), (F2, 12)):
        pts, ks = points_table(F, n, gen, dev)
        s = field_elems(FR, n, gen, dev)
        s[:3] = bf.from_u64(bf.ints_to_limbs([0, 1, FR.mod - 1]), dev)
        ks_i, s_i = bf.limbs_to_ints(ks), bf.limbs_to_ints(s)
        total = (sum(k * e for k, e in zip(ks_i, s_i)) - ks_i[2] * s_i[2]
                 - ks_i[0] * s_i[2]) % FR.mod      # row 2 holds -[k_0] G
        mul = pr.g1_mul if F is F1 else pr.g2_mul
        gen_pt = pr.G1_GEN if F is F1 else pr.G2_GEN
        want = mul(total, gen_pt) if total else None
        if want is not None and F is F2:
            want = (tuple(want[0]), tuple(want[1]))
        for c in (None, 3, 12):
            out.append(hold_msm(F, pts, s, check_ints=want, c=c))
        out.append(hold_fixed_base(F, _one_gen(F, dev), s))
    pts, _ = points_table(F1, 3000, gen, dev)
    out.append(hold_msm(F1, pts, scalars_like_witness(3000, gen, dev)))
    for F in (F1, F2):
        out.append(hold_msm_path(F, 1 << 18, 12, gen, dev))
    return out


def b2_b3_edge_holds(dev, gen) -> List[Dict]:
    """B2 and B3's new launches at the edges of their control flow: NTTs of
    every size 2 .. 2^12 both ways (passes of one tile and of several, log2
    n a multiple of the tile's bits and not); powers and poly_eval at
    lengths around a thread's run and a block's; batch-to-affine around a
    chunk; the digit kernels at c 2, 3, 12, 13 and 16 (a window group
    alone); the reduce below, at and above a block's threads; the affine
    edges (infinity, a repeated point, a point meeting its negation in one
    bucket) through the whole MSM."""
    out = []
    for log_n in range(1, 13):
        a = bf.to_mont(FR, field_elems(FR, 1 << log_n, gen, dev))
        out.append(hold_ntt(a, False))
        out.append(hold_ntt(a, True))
    for n in (0, 1, 63, 64, 65, 16383, 16384, 16385, 100000):
        out.append(hold_powers(fft.w_fr(20), n, 7, dev))
        if n:
            out.append(hold_poly_eval(n, gen, dev))
    out.append(hold_poly_eval(5000, gen, dev, stride=4))
    for F in (F1, F2):
        for n in (1, 63, 64, 65, 3000):
            out.append(hold_affine(F, n, gen, dev))
        for c in (2, 3, 12, 13, 16):
            out.append(hold_digits(F, 3000, c, gen, dev))
        out.append(hold_digits(F, 3000, 13, gen, dev, w0=5, g=3))
        for c in (2, 4, 8, 9, 13):
            out.append(hold_reduce(F, 3, c, gen, dev))
        out.append(hold_bucket_sums(F, 20000, 900, gen, dev))
        out.append(hold_affine_edges(F, dev))
    return out


def hold_affine_edges(F, dev) -> Dict:
    """The MSM over affine bases at the edges pt_madd cannot take itself:
    a base at infinity, a repeated base (a bucket's sum meets the point it
    adds: the doubling), a base and its negation with equal digits (the
    sum meets infinity, the range restarts), at c 2, 3 and 13 against
    python ints."""
    from ..snark import pairing as pr

    ks = [11, 11, FR.mod - 11, 0, 5, 5, 5, FR.mod - 5, 3]
    es = [1, 1, 1, 1, 2, 2, 1, 1, FR.mod - 1]
    base = _one_gen(F, dev)
    pts = curve.scalar_mul_table(F, base, ks)
    s = bf.scalars_to_limbs(es, dev)
    total = sum(k * e for k, e in zip(ks, es)) % FR.mod
    mul, gen_pt = (pr.g1_mul, pr.G1_GEN) if F is F1 else (pr.g2_mul,
                                                         pr.G2_GEN)
    want = mul(total, gen_pt) if total else None
    if want is not None and F is F2:
        want = (tuple(want[0]), tuple(want[1]))
    got = [curve.affine_ints(F, _one(F, msm.msm(F, pts, s, c=c)))[0]
           for c in (2, 3, 13)]
    meet = [curve.affine_ints(F, _one(F, msm.msm(
        F, _bases(F, pts)[:3], bf.scalars_to_limbs([1, 1, 2], dev), c=c)))[0]
        for c in (2, 13)]
    ok = all(g == want for g in got) and meet == [None, None]
    return {"kernel": "B3 msm affine edges", "group": msm.group_name(F),
            "points": len(ks), "max_abs_err": 0 if ok else 1}


def small_holds(dev, gen) -> List[Dict]:
    """Every kernel at the edges of its control flow, the MSM shapes of
    early_fault_holds first."""
    out = early_fault_holds(dev, gen)
    out += b1_b4_holds(dev, gen)
    for ctx in (FQ, FR):
        a = field_elems(ctx, 64, gen, dev)
        b = torch.flip(a, [0]).contiguous()
        am, bm = bf.to_mont(ctx, a), bf.to_mont(ctx, b)
        out.append(hold_mont_mul(ctx, am, bm))
        out.append(hold_mont_mul(ctx, a, bm))        # any 256-bit a
    for F in (None, F1, F2):
        out.append(hold_sum_ranges(F, 3000, 40, True, gen, dev))
        out.append(hold_sum_ranges(F, 3000, 2900, False, gen, dev))
    x, y, z = (bf.to_mont(FR, field_elems(FR, 64, gen, dev)) for _ in range(3))
    out.append({"kernel": "B2 mul_sub", "n": 64, "max_abs_err": diff_words(
        bn254_cuda.mul_sub(x, y, z), bn254_cuda.mul_sub_plain(x, y, z))})
    out += b2_b3_edge_holds(dev, gen)
    a = bf.to_mont(FR, field_elems(FR, 1 << 24, gen, dev))
    out.append(hold_ntt(a, False))
    out.append(hold_ntt(a, True))
    return out


def _one_gen(F, dev):
    return curve.g1_generator(dev) if F is F1 else curve.g2_generator(dev)


def timings(dev, gen, runs: int) -> List[Dict]:
    out = []

    def entry(name, shape, fn, bound):
        ms = device_time_ms(fn, runs)
        out.append({"kernel": name, "shape": shape, "ms": ms,
                    "bound_ms": bound[0], "bound_by": bound[1]})

    rows = gl_rows(1 << 16, 105, gen, dev)
    entry("B1 leaf", [1 << 16, 105], lambda: pbc.leaf_hash(rows),
          bound_leaf(1 << 16, 105))
    lvl = field_elems(FR, 1 << 16, gen, dev)
    entry("B1 node", [1 << 16], lambda: pbc.node_hash(lvl), bound_node(1 << 16))
    a = bf.to_mont(FR, field_elems(FR, 1 << 20, gen, dev))
    entry("B2 ntt", [1 << 20], lambda: fft.fft(a), bound_ntt(1 << 20))
    pts, _ = points_table(F1, 1 << 16, gen, dev)
    bases = _bases(F1, pts)
    s = scalars_like_witness(1 << 16, gen, dev)
    entry("B3 msm G1", [1 << 16], lambda: msm.msm(F1, bases, s),
          bound_msm(F1, s))
    g = curve.g1_generator(dev)
    full = field_elems(FR, 1 << 16, gen, dev)
    entry("B4 fixed_base G1", [1 << 16],
          lambda: curve.scalar_mul_table(F1, g, full),
          bound_fixed_base(F1, full))
    return out


def fb_window_times(dev, gen, windows: List[int], runs: int,
                    n: int = 1 << 20) -> List[Dict]:
    """B4 at each digit width: held at the edge scalars first, then timed
    on n full random scalars in G1 and n / 4 in G2, table build apart
    (host, cached) and beside the bound of that width's walk."""
    out = []
    full = field_elems(FR, n, gen, dev)
    for w in windows:
        for F, m in ((F1, n), (F2, n // 4)):
            held = hold_fixed_base_edges(F, w, dev)
            base = _one_gen(F, dev)
            curve._FB_TABLES.clear()
            t0 = time.perf_counter()
            curve.fixed_base_table(F, base, w)
            table_s = time.perf_counter() - t0
            s = full[:m]
            out.append({"kernel": "B4 fixed_base", "w": w,
                        "group": held["group"], "n": m,
                        "held_max_abs_err": held["max_abs_err"],
                        "table_host_s": table_s,
                        "ms": device_time_ms(lambda: curve.scalar_mul_words(
                            F, base, s, w=w), runs),
                        "bound_ms": bound_fixed_base(F, s, w)[0]})
    return out


def _path_bases(F, n: int, gen, device, m: int = 1 << 14) -> torch.Tensor:
    """n affine bases: m seeded points repeated (a table of the path's
    size; the MSM's time does not depend on which points they are)."""
    base = _bases(F, points_table(F, m, gen, device)[0])
    return base[torch.arange(n, device=device) % m]


def digit_keys(F, bases, s, c: int, w0: int, g: int):
    """Every digit of windows w0 .. w0 + g - 1 in one launch of
    bn_msm_digits<DIGITS_KEYS>: (g n,) int32 keys (w - w0) 2^(c-1) + |d|
    - 1, -1 for a zero digit or a base at infinity, and entries (point
    index | sign << 31), at (w - w0) n + i."""
    n = s.shape[0]
    keys = torch.empty(g * n, dtype=torch.int32, device=s.device)
    entries = torch.empty(g * n, dtype=torch.int32, device=s.device)
    cuda_build.check(cuda_build.lib().merlin_bn_msm_digits(
        msm.DIGITS_KEYS, msm._vp(s.data_ptr()), msm._vp(bases.data_ptr()),
        bases.shape[1], n, c, w0, g, 254, msm._vp(keys.data_ptr()),
        msm._vp(entries.data_ptr()), msm._vp(cuda_build.stream_ptr())),
        "bn254 msm digit keys")
    return keys, entries


def sort_routes(F, bases, s, c: int, runs: int) -> Dict:
    """One MSM's entries brought into bucket order, every group of windows
    as _msm_flow groups them, two ways: the counting sort (the digit
    counts of every window, one host read of the groups' totals, a group's
    prefix sums and scatter) and the route through torch.sort (a group's
    keys and entries in one launch, the nonzero digits compacted, the keys
    sorted and the entries gathered by the sort's permutation; the bucket
    counts that bucket_ranges then needs timed apart, by bincount).  The
    first group is held both ways: the same entries in each bucket."""
    n = s.shape[0]
    nw, half = msm.n_windows(254, c), 1 << (c - 1)
    per = max(1, min(nw, msm.MSM_GROUP_ENTRIES // n))
    groups = [(w0, min(per, nw - w0)) for w0 in range(0, nw, per)]

    def counting(only=None):
        cnt_all = msm.digit_counts(F, bases, s, c, 0, nw, 254).long()
        totals = torch.stack([cnt_all[w0 * half:(w0 + g) * half].sum()
                              for w0, g in groups]).tolist()
        for (w0, g), total in zip(groups[:only], totals):
            cnt = cnt_all[w0 * half:(w0 + g) * half]
            out = msm.digit_entries(F, bases, s, c, w0, g, 254,
                                    (torch.cumsum(cnt, 0) - cnt).int(), total)
        return cnt, out

    def sorting(only=None):
        for w0, g in groups[:only]:
            keys, entries = digit_keys(F, bases, s, c, w0, g)
            live = torch.nonzero(keys >= 0).reshape(-1)
            k, order = torch.sort(keys[live])
            out = entries[live[order]]
        return k, out

    cnt, e_count = counting(1)
    k, e_sort = sorting(1)
    held = torch.equal(torch.bincount(k.long(), minlength=cnt.shape[0]), cnt)
    # compare each bucket's entries as a set: sort (bucket, entry) pairs
    key = torch.repeat_interleave(torch.arange(cnt.shape[0], device=s.device),
                                  cnt) << 32
    held = held and torch.equal(
        torch.sort(key | (e_count.long() & 0xFFFFFFFF))[0],
        torch.sort(key | (e_sort.long() & 0xFFFFFFFF))[0])
    del cnt, e_count, k, e_sort, key
    torch.cuda.empty_cache()
    g0 = groups[0][1]
    keys0 = digit_keys(F, bases, s, c, 0, g0)[0]
    k0 = torch.sort(keys0[keys0 >= 0])[0].long()
    del keys0
    return {"group": msm.group_name(F), "n": n, "c": c,
            "groups": len(groups), "windows_a_group": per, "held": held,
            "counting_sort_ms": device_time_ms(counting, runs),
            "torch_sort_route_ms": device_time_ms(sorting, runs),
            "bincount_ms_first_group": device_time_ms(
                lambda: torch.bincount(k0, minlength=g0 * half), runs)}


def sort_route_times(dev, gen, runs: int) -> List[Dict]:
    """sort_routes at the final hop's witness-shaped G1 MSM (PATH_MSM)
    and at a fflonk commitment of the 2^23-row prefix (PATH_FFLONK_MSM full
    random scalars), each at the card's window; beside each, the bound of
    the schedule at that window and at the least window (least_window)."""
    out = []
    for n, kind in ((PATH_MSM, "witness"), (PATH_FFLONK_MSM, "full")):
        s = scalars_like_witness(n, gen, dev) if kind == "witness" else \
            field_elems(FR, n, gen, dev)
        bases = _path_bases(F1, n, gen, dev)
        c, c_least = msm.window(n), least_window(F1, s)[0]
        out.append({**sort_routes(F1, bases, s, c, runs), "scalars": kind,
                    "bound_ms_at_c": bound_msm(F1, s, c)[0],
                    "bound_c": c_least,
                    "bound_ms": bound_msm(F1, s, c_least)[0]})
        del s, bases
        torch.cuda.empty_cache()
    return out


def msm_window_times(dev, gen, windows: List[int], runs: int) -> List[Dict]:
    """B3 at each window c: the path's witness-shaped G1 MSM (PATH_MSM
    points), 2^20 and 2^24 full random scalars in G1 (a fflonk commitment
    is 2^24 to 2^27) and 2^18 in G2, each held
    first at its shape (hold_msm_path, c) and timed beside the bound of
    the schedule at that c."""
    out = []
    shapes = [(F1, PATH_MSM, "witness"), (F1, 1 << 20, "full"),
              (F2, 1 << 18, "full"), (F1, 1 << 24, "full")]
    data = {}
    for F, n, kind in shapes:
        s = scalars_like_witness(n, gen, dev) if kind == "witness" else \
            field_elems(FR, n, gen, dev)
        data[(F, n)] = (_path_bases(F, n, gen, dev), s)
    for c in windows:
        for F, n, kind in shapes:
            held = hold_msm_path(F, n, c, gen, dev)
            bases, s = data[(F, n)]
            row = {"kernel": "B3 msm", "c": c, "group": msm.group_name(F),
                   "n": n, "scalars": kind,
                   "held_max_abs_err": held["max_abs_err"],
                   "ms": device_time_ms(lambda: msm.msm(F, bases, s, c=c),
                                        runs),
                   "bound_ms": bound_msm(F, s, c)[0]}
            out.append(row)
            torch.cuda.empty_cache()
    return out


def ntt_tile_times(dev, gen, tiles: List[int], runs: int) -> List[Dict]:
    """The NTT at 2^22 and 2^24 with passes of up to k stages (each size
    held first at that k, both ways) beside its bound."""
    out = []
    old = fft.NTT_TILE_BITS
    try:
        for log_n in (22, 24):
            a = bf.to_mont(FR, field_elems(FR, 1 << log_n, gen, dev))
            for k in tiles:
                fft.NTT_TILE_BITS = k
                held = max(hold_ntt(a, inv)["max_abs_err"]
                           for inv in (False, True))
                out.append({"kernel": "B2 ntt", "k": k, "n": 1 << log_n,
                            "passes": len(fft.ntt_passes(log_n)),
                            "held_max_abs_err": held,
                            "ms": device_time_ms(lambda: fft.fft(a), runs),
                            "bound_ms": bound_ntt(1 << log_n)[0]})
            del a
            torch.cuda.empty_cache()
    finally:
        fft.NTT_TILE_BITS = old
    return out


# The final hop's largest shapes (chip_smoke.py phase final): B1's leaf
# launch and node level, B2's NTT, B3's witness-shaped G1 MSM, B4's G1
# table.
PATH_LEAF = (1 << 20, 105)
PATH_NODE = 1 << 20
PATH_NTT = 1 << 24
PATH_MSM = 14_008_649
# a commitment of fflonk's 2^23-row prefix (chip_smoke.py phase fflonk):
# 9 n points
PATH_FFLONK_MSM = 9 << 23
PATH_FIXED_BASE = 14_008_649


def profile_by_kernel(fn) -> Dict:
    """One call of fn under torch.profiler: each bn_ kernel's device ms
    and launches, by kernel name."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\b(bn_\w+_kernel)\b", ev.key)
        name = m.group(1) if m else "other"
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        d = out.setdefault(name, {"ms": 0.0, "launches": 0})
        d["ms"] += us / 1e3
        d["launches"] += ev.count
    return out


def path_times(dev, gen, runs: int) -> List[Dict]:
    """B1, B2, B3 and B4 at the final hop's largest shapes beside their
    bounds (the kernels' schedule) and beside the counts of
    bound_*_cios, bound_msm_unsigned and bound_fixed_base_set_bits."""
    out = []
    h, w = PATH_LEAF
    rows = gl_rows(h, w, gen, dev)
    out.append({"kernel": "B1 leaf", "shape": [h, w],
                "ms": device_time_ms(lambda: pbc.leaf_hash(rows), runs),
                "bound_ms": bound_leaf(h, w)[0],
                "bound_ms_cios": bound_leaf_cios(h, w)[0]})
    del rows
    lvl = field_elems(FR, PATH_NODE, gen, dev)
    out.append({"kernel": "B1 node", "shape": [PATH_NODE],
                "ms": device_time_ms(lambda: pbc.node_hash(lvl), runs),
                "bound_ms": bound_node(PATH_NODE)[0],
                "bound_ms_cios": bound_node_cios(PATH_NODE)[0]})
    del lvl
    a = bf.to_mont(FR, field_elems(FR, PATH_NTT, gen, dev))
    out.append({"kernel": "B2 ntt", "shape": [PATH_NTT],
                "ms": device_time_ms(lambda: fft.fft(a), runs),
                "bound_ms": bound_ntt(PATH_NTT)[0]})
    out.append({"kernel": "B2 powers", "shape": [PATH_NTT],
                "ms": device_time_ms(lambda: bn254_cuda.powers(
                    fft.w_fr(24), PATH_NTT, 1, dev), runs),
                "bound_ms": bound_powers(PATH_NTT)[0]})
    out.append({"kernel": "B2 poly_eval", "shape": [PATH_NTT],
                "ms": device_time_ms(lambda: bn254_cuda.poly_eval(
                    a, 0x1234567 << 200 | 89), runs),
                "bound_ms": bound_poly_eval(PATH_NTT)[0]})
    del a
    torch.cuda.empty_cache()
    s = scalars_like_witness(PATH_MSM, gen, dev)
    bases = _path_bases(F1, PATH_MSM, gen, dev)
    c = msm.window(PATH_MSM)
    out.append({"kernel": "B3 msm", "group": "G1", "shape": [PATH_MSM],
                "c": c, "scalars": "witness",
                "ms": device_time_ms(lambda: msm.msm(F1, bases, s), runs),
                "bound_ms": bound_msm(F1, s)[0],
                "bound_c": least_window(F1, s)[0],
                "bound_ms_unsigned": bound_msm_unsigned(F1, s, 12)[0],
                "device_ms_by_kernel": profile_by_kernel(
                    lambda: msm.msm(F1, bases, s))})
    del s, bases
    torch.cuda.empty_cache()
    s = field_elems(FR, PATH_FIXED_BASE, gen, dev)
    g = curve.g1_generator(dev)
    out.append({"kernel": "B4 fixed_base", "group": "G1",
                "shape": [PATH_FIXED_BASE], "w": curve.FB_WINDOW,
                "ms": device_time_ms(lambda: curve.scalar_mul_words(F1, g, s),
                                     runs),
                "bound_ms": bound_fixed_base(F1, s)[0],
                "bound_ms_set_bits": bound_fixed_base_set_bits(F1, s)[0]})
    return out


# The final phase's counts (chip_smoke.py phase final, its logged shapes):
# A and B coefficient entries (build_abc's products), C's, and the domain.
PATH_AB_ENTRIES = 88_626_391
PATH_C_ENTRIES = 3_254_433
PATH_DOMAIN = 1 << 24


def host_route(dev, gen, entries: int, domain: int, distinct: int = 3000
               ) -> Dict:
    """The Groth16 steps that run on the card through B2 and B3, timed
    beside the host route (numpy over python ints, Montgomery's batched
    inversion) on the same inputs, at `entries` coefficient entries and a
    `domain`-point Lagrange table, on the host clock; each route from
    python ints to Montgomery limbs on the card, the results held equal.
    Scaled by entries and points to the final phase's counts."""
    from types import SimpleNamespace

    from ..snark import groth16
    from ..snark import setup as snark_setup

    rng = np.random.default_rng(2028)
    r_mod = FR.mod
    n_cons = entries // 6
    cons = np.sort(rng.integers(0, n_cons, entries))
    cons[:n_cons] = np.arange(n_cons)          # every constraint has one
    cons.sort()
    sig = rng.integers(0, n_cons, entries)
    table = [int(x) for x in rng.integers(1, 1 << 62, distinct)]
    table[:2] = [1, r_mod - 1]
    which = rng.integers(0, distinct, entries)
    witness = [int(a) << 190 | int(b) for a, b in
               zip(rng.integers(0, 1 << 62, n_cons),
                   rng.integers(0, 1 << 62, n_cons))]
    out = {"entries": entries, "constraints": n_cons, "domain": domain}

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # build_abc's A sums: sum over entries of coef * witness[signal], by
    # constraint
    def host_abc():
        prods = np.array(table, dtype=object)[which] * \
            np.array(witness, dtype=object)[sig] % r_mod
        starts = np.flatnonzero(np.diff(cons, prepend=-1))
        sums = np.add.reduceat(prods, starts) % r_mod
        return bf.from_int(FR, sums.tolist(), dev)

    key = SimpleNamespace(
        domain_bits=max((n_cons - 1).bit_length(), 1), device=dev,
        coefs=snark_setup.Coefs(
            torch.zeros(entries, dtype=torch.int64, device=dev),
            torch.from_numpy(cons).to(dev), torch.from_numpy(sig).to(dev),
            bf.from_u64(bf.ints_to_limbs(table), dev)[
                torch.from_numpy(which).to(dev)]))

    def card_abc():
        return groth16.build_abc(key, witness)[0]

    card_abc()
    want, out["abc_host_s"] = sync_time(host_abc)
    got, out["abc_card_s"] = sync_time(card_abc)
    out["abc_equal"] = torch.equal(got[:n_cons], want)
    # the setup's Lagrange table L_i(tau), i < domain
    tau = 0x1234567 << 200 | 0x89ABCDEF
    w = fft.w_fr(domain.bit_length() - 1)

    def host_lagrange():
        xs = [1] * domain
        for i in range(1, domain):
            xs[i] = xs[i - 1] * w % r_mod
        diffs = [(tau - x) % r_mod for x in xs]
        pre = [1] * (domain + 1)
        for i, d in enumerate(diffs):
            pre[i + 1] = pre[i] * d % r_mod
        inv = pow(pre[-1], r_mod - 2, r_mod)
        k = (pow(tau, domain, r_mod) - 1) * pow(domain, r_mod - 2, r_mod) \
            % r_mod
        lag = [0] * domain
        for i in range(domain - 1, -1, -1):
            lag[i] = k * xs[i] % r_mod * (inv * pre[i] % r_mod) % r_mod
            inv = inv * diffs[i] % r_mod
        return bf.from_int(FR, lag, dev)

    snark_setup.lagrange_evals(tau, domain, dev)
    want, out["lagrange_host_s"] = sync_time(host_lagrange)
    got, out["lagrange_card_s"] = sync_time(
        lambda: snark_setup.lagrange_evals(tau, domain, dev))
    out["lagrange_equal"] = torch.equal(got, want)
    # to the final phase: build_abc over A and B once a proof; the setup's
    # sums over A, B and C, its Lagrange table and the H scalars (as many
    # points again, the same batched inversion)
    per_entry = {r: out[f"abc_{r}_s"] / entries for r in ("host", "card")}
    per_point = {r: out[f"lagrange_{r}_s"] / domain for r in ("host", "card")}
    out["path_scaled_s"] = {
        r: {"build_abc": per_entry[r] * PATH_AB_ENTRIES,
            "setup_sums_and_tables": per_entry[r] * (
                PATH_AB_ENTRIES + PATH_C_ENTRIES) + 2 * per_point[r] *
            PATH_DOMAIN}
        for r in ("host", "card")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--host-route", type=int, nargs=2, default=[1 << 22, 1 << 20],
                    metavar=("ENTRIES", "DOMAIN"),
                    help="sizes of the host-route comparison (0 0: none)")
    ap.add_argument("--windows", type=int, nargs="*", default=[],
                    help="time B3 at these windows c")
    ap.add_argument("--ntt-tiles", type=int, nargs="*", default=[],
                    help="time the NTT with passes of up to these stages")
    ap.add_argument("--fb-windows", type=int, nargs="*", default=[],
                    help="time B4 at these digit widths")
    ap.add_argument("--sort-routes", action="store_true",
                    help="the counting sort beside the torch.sort route")
    ap.add_argument("--path-times", action="store_true",
                    help="time B1-B4 at the final hop's largest shapes")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--holds", choices=("all", "b1-b4", "b2-b3", "quick"),
                    default="all", help="which holds run before the times")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bn254_times: no CUDA device")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    t0 = time.time()
    cuda_build.lib()
    res = {k: v for k, v in cuda_build.resources(cuda_build.BUILD_LOG).items()
           if k.startswith("bn_")}
    holds = {"all": small_holds, "b1-b4": b1_b4_holds, "quick": quick_holds,
             "b2-b3": lambda d, g: early_fault_holds(d, g) + b2_b3_edge_holds(
                 d, g)}[args.holds](dev, gen)
    bad = [h for h in holds if h["max_abs_err"] != 0]
    doc = {"card": card(), "defines": args.define,
           "build_s": cuda_build.BUILD_SECONDS,
           "source_build_s": cuda_build.SOURCE_SECONDS,
           "kernels": res, "holds": holds, "mismatches": len(bad),
           "hold_s": time.time() - t0}
    if not args.no_times and not bad:
        doc["times"] = timings(dev, gen, args.runs)
    if args.windows and not bad:
        doc["windows"] = msm_window_times(dev, gen, args.windows, args.runs)
        bad += [x for x in doc["windows"] if x["held_max_abs_err"] != 0]
    if args.ntt_tiles and not bad:
        doc["ntt_tiles"] = ntt_tile_times(dev, gen, args.ntt_tiles, args.runs)
        bad += [x for x in doc["ntt_tiles"] if x["held_max_abs_err"] != 0]
    if args.fb_windows and not bad:
        doc["fb_windows"] = fb_window_times(dev, gen, args.fb_windows,
                                            args.runs)
        bad += [x for x in doc["fb_windows"] if x["held_max_abs_err"] != 0]
    if args.sort_routes and not bad:
        doc["sort_routes"] = sort_route_times(dev, gen, args.runs)
        bad = bad or not all(r["held"] for r in doc["sort_routes"])
    if args.path_times and not bad:
        doc["path_times"] = path_times(dev, gen, args.runs)
    if args.host_route[0] and not bad:
        doc["host_route"] = host_route(dev, gen, *args.host_route)
        if not (doc["host_route"]["abc_equal"] and
                doc["host_route"]["lagrange_equal"]):
            bad.append("host_route")
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
