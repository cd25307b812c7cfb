"""Device times of the Poseidon kernels at the sizes that set their block
sizes and the node-hash dispatch.

    python -m merlin_zkevm_prover_tpu_torch.tools.poseidon_times \\
        [--trees-only | --s1 [--s1-rows-bits 17 20 23]]
        [--define NAME=VALUE ...] [--out FILE]

Needs one CUDA card and nvcc.  Times (CUDA events, median, the card busy
and idle as in ``chip_smoke.py``): ``permute`` on ``(12, 270600)``,
``linear_hash`` on ``(2^18, 27)`` and ``(2^18, 665)``, one tree level of
``2^0 .. 2^17`` pairs through the pair and through the group kernel, the
top launch from ``2^1 .. 2^6`` digests, and whole trees
(``merkle_levels_``) of ``2^12 .. 2^18`` leaves.  These are the numbers
that set ``GROUP_MAX_PAIRS`` and ``TOP_MAX_PAIRS`` in
``ops/poseidon_cuda.py`` and the ``PG_*_THREADS`` block sizes in
``csrc/poseidon_gl.cu``.

``--trees-only`` times the whole trees alone, and sums them over the
trees of one ``n_bits = 17`` smoke proof (``PROOF_TREES``): K3's time per
proof as ``chip_smoke.py`` reads it.  It calls nothing but
``merkle_levels_``, so it also times an older checkout of the package once
this file and ``utils/timer.py`` are copied into it.

``--s1`` times kernel S1 (``round_trace``, the PoseidonG state machine's
round trace) and K1 (``permute``) on the same ``(12, n // 31)`` states at
``n = 2^17, 2^20, 2^23`` rows (``--s1-rows-bits``), each S1 output first
held against ``round_trace_plain``: ms per call and per million rows, with
each kernel's bound (S1: the 16 words it writes a row and the 12 it reads a
slot; K1: 24 words and 118 S-boxes a permutation), after S1's holds at
the edges of its geometry (``s1_edge_cases``).  At ``2^17`` rows S1's 16
MB output fits the card's 50 MB L2; at ``2^23`` (1.07 GB) it does not.
``--define PG_TRACE_WARPS=2`` times another block size.

``--define PG_LINEAR_HASH_THREADS=128`` builds the kernels from a copy of
``csrc/`` (under ``build/``) in which that ``#define`` has the given value,
so that another launch parameter can be timed against the committed one.
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import poseidon_cuda as pc
from ..utils.timer import device_time_ms

# Bounds as chip_smoke.py counts them: bytes over the H100's 3.35 TB/s, or
# 32-bit multiply-adds over 16.75e12/s (118 S-boxes of 14 a permutation).
MEM_BYTES_PER_S = 3.35e12
IMAD32_PER_S = 33.5e12 / 2
PERM_IMAD32 = (8 * 12 + 22) * (2 * 3 + 2 * 4)
S1_ROWS_BITS = (17, 20, 23)

# The Merkle trees of one n_bits = 17 smoke proof, {leaves: trees}
# (chip_smoke.py's prove line, tree_heights): the constant and four stage
# trees of the 2^18-row LDE, then FRI's three.
PROOF_TREES = {1 << 18: 5, 1 << 16: 1, 1 << 14: 1, 1 << 12: 1}


def _rnd_on(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    def rnd(*shape):
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev,
                             dtype=torch.int64)
    return rnd


def _both(fn, runs=7):
    """[busy card, idle card] device time of one call, ms."""
    return [device_time_ms(fn, runs), device_time_ms(fn, runs, prefill=False)]


def measure_trees() -> dict:
    """Each tree of PROOF_TREES filled through merkle_levels_, busy and
    idle, and their sum over one proof."""
    rnd = _rnd_on(torch.device("cuda"))
    trees = {}
    for h in sorted(PROOF_TREES):
        nodes = rnd(2 * h - 1, 4)
        trees[h] = _both(lambda: pc.merkle_levels_(nodes, h), 5)
    return {"tree_busy_idle": {f"2^{h.bit_length() - 1}": t
                               for h, t in trees.items()},
            "per_proof_busy_idle": [
                sum(n * trees[h][i] for h, n in PROOF_TREES.items())
                for i in (0, 1)]}


def measure() -> dict:
    dev = torch.device("cuda")
    rnd = _rnd_on(dev)
    both = _both
    out = {}
    st = rnd(12, (1 << 23) // 31)
    out["permute_12x270600"] = both(lambda: pc.permute(st))
    for w in (27, 665):
        x = rnd(1 << 18, w)
        out[f"linear_hash_2^18x{w}"] = both(lambda: pc.linear_hash(x),
                                            7 if w == 27 else 3)
    del st, x
    lvl, lvl_out = rnd(1 << 18, 4), rnd(1 << 17, 4)
    levels = {}
    for k in range(18):
        n = 1 << k
        for kind in ("pair", "group"):
            levels[f"{kind} {n}"] = both(lambda: pc._launch_node_hash(
                kind, lvl.data_ptr(), lvl.data_ptr() + 32, 8,
                lvl_out.data_ptr(), n, dev))
    out["level_busy_idle"] = levels
    top = {}
    for k in range(1, 7):
        n = 1 << k
        nodes = rnd(2 * n - 1, 4)
        top[f"from {n // 2} pairs"] = both(
            lambda: pc._launch_merkle_top(nodes.data_ptr(), n, dev))
    out["top_busy_idle"] = top
    return out | measure_trees()


def bound_ms(n_bytes: float, imad32: float):
    t_mem, t_ops = n_bytes / MEM_BYTES_PER_S, imad32 / IMAD32_PER_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def s1_edge_cases(dev, main_slots: int = (1 << 23) // 31, seed: int = 2033):
    """S1 at the edges of its geometry, against its plain version: G = the
    slots a block runs at ``main_slots``'s plan (its threads times the
    run); S = 1, G - 1, G, G + 1, 2G + 1; n = 31 S, 31 S + 1 and an odd n
    more than a line past 31 S; each by the library's own plan and with
    ``main_slots``'s run.  Yields (case, kernel output, plain output); the
    words p and 2^64 - 1 in the first slot."""
    from ..executor.sm import poseidon_g_executor as pge
    from ..ops import goldilocks as gl

    plan = pge.trace_plan(main_slots, dev)
    run = plan["run"]
    g = plan["threads"] * run
    rng = np.random.default_rng(seed)
    for s in (1, g - 1, g, g + 1, 2 * g + 1):
        words = rng.integers(0, 1 << 64, (12, s), dtype=np.uint64)
        words[:2, 0] = [gl.P, (1 << 64) - 1]
        st = gl.from_u64(words, dev)
        rows = 31 * s
        for n in (rows, rows + 1, rows + 17 + (rows + 18) % 2):
            want = pge.round_trace_plain(st, n)
            yield f"edge S = {s}, n = {n}", pge.round_trace(st, n), want
            yield (f"edge S = {s}, n = {n}, run {run}",
                   pge._launch_trace(st, n, run), want)


def measure_s1(rows_bits) -> dict:
    """S1 and K1 on the same seeded states at each 2^b rows, S1 held
    against its plain version first."""
    from ..executor.sm import poseidon_g_executor as pge

    dev = torch.device("cuda")
    edges = 0
    for what, got, want in s1_edge_cases(dev):
        if not torch.equal(got, want):
            raise AssertionError(f"round_trace {what} != its plain version")
        edges += 1
    rnd = _rnd_on(dev)
    out = {"edge_holds": edges}
    for b in rows_bits:
        n = 1 << b
        slots = n // pge.SLOT_ROWS
        st = rnd(12, slots)
        if not torch.equal(pge.round_trace(st, n),
                           pge.round_trace_plain(st, n)):
            raise AssertionError(f"round_trace at 2^{b} rows != its plain version")
        s1 = _both(lambda: pge.round_trace(st, n))
        k1 = _both(lambda: pc.permute(st))
        s1_bound = bound_ms(pge.TRACE_COLS * n * 8 + 12 * slots * 8,
                            slots * PERM_IMAD32)
        k1_bound = bound_ms(2 * 12 * slots * 8, slots * PERM_IMAD32)
        out[f"2^{b}"] = {
            "rows": n, "slots": slots, "s1_busy_idle": s1, "k1_busy_idle": k1,
            "plan": pge.trace_plan(slots, dev),
            "s1_ms_per_mrow": s1[0] * 1e6 / n, "k1_ms_per_mrow": k1[0] * 1e6 / n,
            "s1_bound_ms": s1_bound[0], "s1_bound_by": s1_bound[1],
            "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
            "s1_share_of_bound": s1_bound[0] / s1[0]}
        del st
        torch.cuda.empty_cache()
    return {"s1": out, "s1_launches": dict(pge.LAUNCHES),
            "resources": cuda_build.resources(cuda_build.BUILD_LOG).get(
                "pg_trace_kernel")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--trees-only", action="store_true")
    ap.add_argument("--s1", action="store_true")
    ap.add_argument("--s1-rows-bits", type=int, nargs="+",
                    default=list(S1_ROWS_BITS))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_times: no CUDA device")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    if args.s1:
        ms = measure_s1(args.s1_rows_bits)
    else:
        ms = measure_trees() if args.trees_only else measure()
    res = {"card": card, "defines": args.define, "ms": ms}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
