"""Seconds per smoke proof on the card, several proofs in one process.

    python3 -m merlin_zkevm_prover_tpu_torch.tools.prove_times \\
        [n_bits] [--proofs N] [--out FILE]

Builds the smoke circuit (seed 42, 32 queries, as ``chip_smoke.py``'s
``prove`` phase), proves it once to warm up (kernel build, host tables,
the caching allocator), then N more times, each on the host clock up to
``torch.cuda.synchronize()``, and prints one JSON object: the card, every
``prove_s`` and their median, and the summed ``TimerLog`` spans of each
proof.  It calls only ``StarkProver`` and ``compile_air``, so it also runs
in an older checkout of the package once copied into it; comparing two
trees means running it from both, in turns, in one call.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models.smoke import build_smoke_air
from ..stark import StarkProver, compile_air
from ..utils.timer import TimerLog


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_bits", nargs="?", type=int, default=17)
    ap.add_argument("--proofs", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prove_times: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    air, trace = build_smoke_air(n_bits=args.n_bits, seed=42)
    info = compile_air(air, n_queries=32)
    prover = StarkProver(info, np.stack(air.const_values, axis=1))
    prover.prove(trace)
    torch.cuda.synchronize()
    times, spans = [], []
    for _ in range(args.proofs):
        tlog = TimerLog("prove_times", quiet=True)
        t0 = time.time()
        prover.prove(trace, timer=tlog)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        spans.append(tlog.as_dict())
    res = {"card": card, "n_bits": args.n_bits, "prove_s": times,
           "median_prove_s": statistics.median(times), "spans_s": spans}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
