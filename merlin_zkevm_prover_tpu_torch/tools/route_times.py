"""Seconds and peak memory per proof on each route of the prover, on the card.

    python3 -m merlin_zkevm_prover_tpu_torch.tools.route_times \\
        [--n-bits 17] [--proofs 2] [--circuits smoke,wide] [--out FILE]

A route is the pair of thresholds a ``StarkProver`` reads at construction
(``MERLIN_VM_MIN_NODES``, ``MERLIN_STEP5_MATRIX_MIN``), set in the
environment while it is built, and, for the matrix forms of step 5, the
memory budget of their gathered blocks (``device_core.STEP5_BLOCK_BYTES``):

  tree          the tree evaluator for steps 2-4, step 5 per entry
  vm            the VM for steps 2-4, step 5 per entry
  vm_matrix     the VM, step 5 as weighted column sums in blocks of the
                default budget
  vm_matrix_256m, vm_matrix_group
                the same with a 256 MiB budget, and with one block per
                gathered group whatever its size

For each circuit (the smoke circuit, seed 42; ``models/wide.py``, whose
programs are above both of the reference's thresholds) at ``n_bits``, 32
queries, every route is built, proves once to warm up, then ``--proofs``
times, each on the host clock up to ``torch.cuda.synchronize()`` with the
``TimerLog`` spans and each span's peak of allocated bytes; the routes run
in order, then again in reverse order.  Every proof must equal the first
route's.  Prints one JSON object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..models.smoke import build_smoke_air
from ..models.wide import build_wide_air
from ..stark import StarkProver, compile_air
from ..stark import device_core as core
from ..stark.prover import program_nodes
from ..utils.timer import TimerLog

NEVER = "1000000000"
ROUTES = {
    "tree": ({"MERLIN_VM_MIN_NODES": NEVER, "MERLIN_STEP5_MATRIX_MIN": NEVER},
             None),
    "vm": ({"MERLIN_VM_MIN_NODES": "0", "MERLIN_STEP5_MATRIX_MIN": NEVER},
           None),
    "vm_matrix": ({"MERLIN_VM_MIN_NODES": "0", "MERLIN_STEP5_MATRIX_MIN": "0"},
                  None),
    "vm_matrix_256m": ({"MERLIN_VM_MIN_NODES": "0",
                        "MERLIN_STEP5_MATRIX_MIN": "0"}, 1 << 28),
    "vm_matrix_group": ({"MERLIN_VM_MIN_NODES": "0",
                         "MERLIN_STEP5_MATRIX_MIN": "0"}, 1 << 50),
}


def build_prover(info, const_vals, env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return StarkProver(info, const_vals)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def run_route(info, const_vals, trace, name, proofs):
    env, block_bytes = ROUTES[name]
    default_bytes = core.STEP5_BLOCK_BYTES
    if block_bytes is not None:
        core.STEP5_BLOCK_BYTES = block_bytes
    try:
        prover = build_prover(info, const_vals, env)
        first = prover.prove(trace)
        torch.cuda.synchronize()
        runs = []
        for _ in range(proofs):
            tlog = TimerLog("route_times", quiet=True, peak_memory=True)
            t0 = time.time()
            prover.prove(trace, timer=tlog)
            torch.cuda.synchronize()
            runs.append({"prove_s": time.time() - t0,
                         "spans_s": tlog.as_dict(),
                         "span_peak_bytes": dict(tlog.peaks)})
        taken = {"vm": [k for k, p in ((2, prover._vm2), (3, prover._vm3),
                                       (4, prover._vm4)) if p is not None],
                 "step5_matrix": prover._step5_matrix,
                 "block_cols": [core.step5_block_cols(info.n),
                                core.step5_block_cols(info.n_ext)]}
    finally:
        core.STEP5_BLOCK_BYTES = default_bytes
    del prover
    torch.cuda.empty_cache()
    return first, taken, runs


def measure(circuit, n_bits, proofs, routes):
    if circuit == "smoke":
        air, trace = build_smoke_air(n_bits=n_bits, seed=42)
    else:
        air, trace = build_wide_air(n_bits=n_bits, device="cuda")
    info = compile_air(air, n_queries=32)
    const_vals = (np.stack(air.const_values, axis=1) if air.const_values
                  else np.zeros((air.n, 0), dtype=np.uint64))
    out = {"nodes": {"step2": program_nodes(info.step2prev),
                     "step3": program_nodes(info.step3prev),
                     "step4": program_nodes(info.step42ns)},
           "ev_map_entries": len(info.ev_map), "routes": {}}
    ref = None
    for name in routes + routes[::-1]:
        proof, taken, runs = run_route(info, const_vals, trace, name, proofs)
        if ref is None:
            ref = proof.to_json()
        elif proof.to_json() != ref:
            raise AssertionError(f"{circuit}: route {name} gave another proof")
        r = out["routes"].setdefault(name, {"taken": taken, "runs": []})
        r["runs"].extend(runs)
    for r in out["routes"].values():
        r["median_prove_s"] = statistics.median(x["prove_s"] for x in r["runs"])
        r["median_spans_s"] = {
            k: statistics.median(x["spans_s"][k] for x in r["runs"])
            for k in r["runs"][0]["spans_s"]}
        r["peak_bytes"] = max(max(x["span_peak_bytes"].values())
                              for x in r["runs"])
        r["span_peak_bytes"] = {
            k: max(x["span_peak_bytes"][k] for x in r["runs"])
            for k in r["runs"][0]["span_peak_bytes"]}
    out["same_proof_on_every_route"] = True
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-bits", type=int, default=17)
    ap.add_argument("--proofs", type=int, default=2)
    ap.add_argument("--circuits", default="smoke,wide")
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route_times: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    routes = args.routes.split(",")
    res = {"card": card, "n_bits": args.n_bits,
           "block_bytes_default": core.STEP5_BLOCK_BYTES,
           "live_blocks": core.STEP5_LIVE_BLOCKS, "circuits": {}}
    for circuit in args.circuits.split(","):
        res["circuits"][circuit] = measure(circuit, args.n_bits, args.proofs,
                                           routes)
    text = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    for circuit, c in res["circuits"].items():
        print(circuit, json.dumps({k: v for k, v in c.items()
                                   if k != "routes"}))
        for name, r in c["routes"].items():
            print(" ", name, json.dumps({k: r[k] for k in (
                "taken", "median_prove_s", "median_spans_s", "peak_bytes",
                "span_peak_bytes")}))
    print(text)


if __name__ == "__main__":
    main()
