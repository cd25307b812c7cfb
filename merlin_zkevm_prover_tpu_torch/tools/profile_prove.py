"""Where one smoke proof spends its time on the GPU.

    python3 -m merlin_zkevm_prover_tpu_torch.tools.profile_prove [n_bits]

Proves the smoke circuit once to warm up (kernel build, host tables), then
once under ``torch.profiler`` and once more with no profiler, and prints
JSON lines: the card, the wall time of the profiled and the unprofiled
proof, the summed device time of all kernels (on one stream they do not
overlap, so device time over wall time is the card's busy share), the
number of device events (kernels and copies), and the kernels that took most device time.
Needs a GPU; default n_bits is 17.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.smoke import build_smoke_air
from ..stark import StarkProver, compile_air, verify


def main() -> int:
    n_bits = int(sys.argv[1]) if len(sys.argv) > 1 else 17
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    air, trace = build_smoke_air(n_bits=n_bits, seed=42)
    info = compile_air(air, n_queries=32)
    prover = StarkProver(info, np.stack(air.const_values, axis=1))

    def prove():
        t0 = time.time()
        proof = prover.prove(trace)
        torch.cuda.synchronize()
        return proof, time.time() - t0

    proof, t_warm = prove()
    verify(info, prover.const_tree.root(), proof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = prove()
    _, t_plain = prove()

    rows = []
    for ev in prof.key_averages():
        # device-side events only: a host op's row repeats the time of the
        # kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    dev_s = sum(r[0] for r in rows) / 1e6
    print(json.dumps({
        "card": card, "n_bits": n_bits, "warmup_prove_s": t_warm,
        "profiled_prove_s": t_prof, "unprofiled_prove_s": t_plain,
        "device_time_s": dev_s,
        "device_busy_share_of_profiled": dev_s / t_prof if rows else None,
        "device_events": sum(r[1] for r in rows),
        "note": None if rows else "the profiler reported no device time",
    }))
    print(json.dumps({"top_device_time": [
        {"name": k[:80], "count": c, "device_ms": us / 1e3}
        for us, c, k in rows[:12]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
