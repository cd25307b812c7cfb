"""Device times of the Poseidon kernels at the sizes that set their block
sizes and the node-hash dispatch.

    python -m merlin_zkevm_prover_tpu_torch.tools.poseidon_times \\
        [--trees-only] [--define NAME=VALUE ...] [--out FILE]

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

import torch

from ..ops import cuda_build
from ..ops import poseidon_cuda as pc
from ..utils.timer import device_time_ms

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--trees-only", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_times: no CUDA device")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    res = {"card": card, "defines": args.define,
           "ms": measure_trees() if args.trees_only else measure()}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
