"""Holds, bounds and device times of the fflonk kernels F1-F3, and fflonk
final proofs on the card.

    python -m merlin_zkevm_prover_tpu_torch.tools.fflonk_times
        [--log-n 21 24] [--queries 24] [--only F1 F2 F3 B3]
        [--define NAME=VALUE ...] [--no-times] [--out FILE]

Needs one CUDA card and nvcc.  Builds the kernels (``--define``: from a
copy of ``csrc/`` with those ``#define``s, one variant a process), prints
F1-F3's registers and spills (``ptxas -v``), holds each kernel of
``--only`` against its plain twin on the card, exactly, at the edges of
its control flow (scans of 1 to 4,097 rows of 1 to 1,024 chains, ragged
last rows, both operations and directions; inverses at n = 1, 255, 257
and blocks and a part, zeros at the ends of runs and blocks, a block of
zeros, the values 0, 1, r - 1; each quotient part below one block, at a
block and a point, with a whole block and seeded points held) and B3 at
full random scalars, times each kernel once at the shapes of a
``2^21``-row proof beside its bound and its twin (``--log-n`` with no
value stops there), then proves fflonk final circuits:
for each ``--log-n``, the longest prefix of a final R1CS whose PLONK form
fills ``n = 2^log_n`` (the final R1CS of the recursiveF proof of the
``n_bits = 3`` smoke circuit at ``--queries`` FRI queries: 24 give some 10
million gates), through ``FinalStage(protocol="fflonk")._prove_fflonk``:
setup, prove, verify and two tampered proofs, the spans, each kernel's
launches and device ms (``torch.profiler``), peak device memory and host
RSS.  Prints one JSON object.  ``chip_smoke.py`` uses the hold, bound and
prefix functions here at its own shapes.
"""

from __future__ import annotations

import argparse
import json
import re
import resource
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import bn254_cuda, cuda_build
from ..ops import bn254_fflonk_cuda as ffk
from ..ops import bn254_field as bf
from ..ops.bn254_field import FR
from ..snark import curve, msm
from ..snark import fflonk as pf
from ..snark.pairing import G1_GEN, g1_add, g1_mul
from ..snark.r1cs_to_plonk import constraint_gates, domain_size
from ..snark.setup import R1CS
from ..utils.timer import TimerLog, device_time_ms
from .bn254_times import (INV_PRODUCTS, bound_ms, card, diff_words,
                          field_elems, hold_msm)

# kernels of F1-F3 by the name torch.profiler gives them
KERNEL_OF = {"bn_fr_scan_kernel": "F1", "bn_fr_scan_carry_kernel": "F1",
             "bn_fr_inv_kernel": "F2", "bn_fflonk_quotient_kernel": "F3"}
# Montgomery products a point of each quotient part needs (X = root^i as
# one product a point, the cost of a table of powers)
QUOTIENT_PRODUCTS = {0: 5, 1: 11, 2: 14}


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def bound_scan(length: int, op: str):
    """Each element read and written once; a product an element for mul."""
    return bound_ms(2 * length * 32, length if op == "mul" else 0)


def bound_inv(n: int):
    """What the function needs: Montgomery's batch trick, three products an
    element and one inversion for the whole batch
    (``bn254_times.INV_PRODUCTS``); each element read and written once."""
    return bound_ms(2 * n * 32, 3 * n + INV_PRODUCTS * (n > 0))


def bound_inv_fermat(n: int):
    """An inversion an element by Fermat (the kernel's first design): 253
    squarings and the exponent's other set bits."""
    e = FR.mod - 2
    return bound_ms(2 * n * 32, n * (e.bit_length() - 1 + bin(e).count("1")))


def bound_quotient(part: int, n: int):
    cols = len(ffk.PART_COLUMNS[part]) + ffk.PART_OUTPUTS[part]
    return bound_ms(n * cols * 32, n * QUOTIENT_PRODUCTS[part])


# ---------------------------------------------------------------------------
# Holds: kernel against twin, exact
# ---------------------------------------------------------------------------


def _ends_idx(n: int, cap: int, device) -> torch.Tensor:
    """The first and last `cap` indices below n (all of them when fewer)."""
    if n <= 2 * cap:
        return torch.arange(n, device=device)
    return torch.cat([torch.arange(cap, device=device),
                      torch.arange(n - cap, n, device=device)])


def _mont_elems(n: int, gen, device, no_zero: bool = False) -> torch.Tensor:
    x = field_elems(FR, n, gen, device)
    if no_zero:
        x[(x == 0).all(dim=1)] = bf.from_u64(bf.ints_to_limbs([7]), device)
    return bf.to_mont(FR, x)


def hold_scan(length: int, k: int, op: str, backward: bool, gen, device,
              cap: int = 64) -> Dict:
    """F1 at a shape: the input the identity but on the first and last
    `cap` rows (seeded, edge values at both ends; no zero in a product),
    the kernel on all of it; the twin on those rows of the first and last
    `cap` chains; every row between must equal the row where the scan
    enters it."""
    rows = ffk.scan_rows(length, k)
    ident = bf.mont_one(FR, (), device) if op == "mul" else \
        torch.zeros(bf.N_LIMBS, dtype=torch.int64, device=device)
    rsel = _ends_idx(rows, cap, device)
    csel = _ends_idx(k, cap, device)
    x = ident.expand(length, bf.N_LIMBS).clone()
    grid = rsel[:, None] * k + torch.arange(k, device=device)[None]
    live = grid < length
    x[grid[live]] = _mont_elems(int(live.sum()), gen, device, op == "mul")
    got = ffk.scan(x, k, op, backward)
    sub = rsel[:, None] * k + csel[None]
    sub_live = sub < length
    xs = ident.expand(sub.numel(), bf.N_LIMBS).clone()
    xs[sub_live.reshape(-1)] = x[sub[sub_live]]
    want = ffk.scan_plain(xs, csel.numel(), op, backward).reshape(
        sub.shape + (bf.N_LIMBS,))
    err = diff_words(got[sub[sub_live]], want[sub_live])
    if rows > 2 * cap:
        entry = cap - 1 if not backward else rows - cap
        mid = torch.arange(cap, rows - cap, device=device)
        at = got[(mid[:, None] * k + csel[None]).reshape(-1)].reshape(
            mid.numel(), csel.numel(), bf.N_LIMBS)
        if not torch.equal(at, got[entry * k + csel][None].expand_as(at)):
            err = max(err, 1)
    return {"kernel": "F1 scan", "length": length, "k": k, "op": op,
            "backward": backward, "held_rows": int(rsel.numel()),
            "held_chains": int(csel.numel()), "max_abs_err": err}


def _block_idx(b: int, per: int, n: int, device) -> torch.Tensor:
    """The indices of block b of `per` elements or points, cut at n."""
    return torch.arange(b * per, min(n, (b + 1) * per), device=device)


def _inv_case(n: int, gen, device, cap: int = 4096,
              zero_slots: bool = True):
    """F2 over n seeded elements (0, 1, r - 1 ... at both ends): (the
    case's record, the kernel's held outputs, their inputs).  With
    `zero_slots`, in the first, a middle and the last block zeros at the
    first and last slot of the runs of threads 0, 1, T/2 and T - 1 (so at
    each block's first and last element), every element of the second
    block zero (when there are three or more), and 1 and r - 1 at the
    sixth and seventh element; held: the first and last `cap` elements and
    every element of those four blocks."""
    geo = ffk.geometry()
    T, R = geo["inv_threads"], geo["inv_run"]
    per = T * R
    nb = -(-n // per)
    a = _mont_elems(n, gen, device)
    blocks = sorted({0, nb // 2, nb - 1} | ({1} if nb >= 3 else set()))
    zeros = 0
    if zero_slots:
        slots = torch.tensor([b * per + t + r * T for b in {0, nb // 2, nb - 1}
                              for t in {0, 1, T // 2, T - 1}
                              for r in {0, R - 1}], device=device)
        a[slots[slots < n]] = 0
        if nb >= 3:
            a[_block_idx(1, per, n, device)] = 0
        if n > 6:
            a[5:7] = bf.to_mont(FR, bf.from_u64(bf.ints_to_limbs(
                [1, FR.mod - 1]), device))
        zeros = int((a == 0).all(dim=1).sum())
    got = ffk.inv(a)
    sel = torch.unique(torch.cat([_ends_idx(n, cap, device)] + [
        _block_idx(b, per, n, device) for b in blocks]))
    return ({"kernel": "F2 inv", "n": n, "held": int(sel.numel()),
             "zeros": zeros, "block": [T, R]}, got[sel], a[sel])


def inv_holds(sizes, gen, device, edges: bool = True) -> List[Dict]:
    """F2 at each of `sizes` (_inv_case) and, with `edges`, at the edges of
    its blocks: n = 1 (a value, then a zero), 255, 257, and three blocks
    and a part (a block of zeros only), and the values 0, 1, r - 1, 2.
    Every case's held elements go through one inv_plain call (its time is
    its launches', whatever the count)."""
    geo = ffk.geometry()
    per = geo["inv_threads"] * geo["inv_run"]
    cases = [_inv_case(n, gen, device) for n in sizes]
    if edges:
        cases.append(_inv_case(1, gen, device, zero_slots=False))
        cases += [_inv_case(n, gen, device) for n in (1, 255, 257,
                                                     3 * per + 77)]
        edge = bf.to_mont(FR, bf.from_u64(bf.ints_to_limbs(
            [0, 1, FR.mod - 1, 2]), device))
        cases.append(({"kernel": "F2 inv", "n": 4,
                       "values": "0, 1, r - 1, 2"}, ffk.inv(edge), edge))
    want = ffk.inv_plain(torch.cat([c[2] for c in cases]))
    out, k = [], 0
    for rec, got, a in cases:
        out.append({**rec, "max_abs_err": diff_words(
            got, want[k:k + a.shape[0]])})
        k += a.shape[0]
    return out


def quotient_inputs(part: int, n: int, gen, device):
    """Seeded columns of a part at n points (part 1's s1..s3 every fourth
    row of 4n evaluations, as the prover passes them) and its constants
    (the root of the domain, shift 4 on part 2)."""
    cols = {k: _mont_elems(4 * n if part == 1 and k[0] == "s" else n, gen,
                           device) for k in ffk.PART_COLUMNS[part]}
    if part == 1:
        for k in ("s1", "s2", "s3"):
            cols[k] = cols[k][::4]
    consts = dict(root=pf._find_w(1 << (n - 1).bit_length()),
                  beta=int(bf.to_int(FR, cols["a"][1:2])[0]),
                  gamma=int(bf.to_int(FR, cols["a"][2:3])[0]),
                  shift=4 if part == 2 and n >= 4 else 0)
    return cols, consts


def hold_quotient(part: int, n: int, gen, device, cap: int = 4096,
                  spread: int = 4096) -> Dict:
    """F3 part `part` over n points against the twin at the first and last
    `cap` points (z(omega X)'s wrap at the end included), every point of
    the middle block and `spread` seeded points over the whole domain."""
    geo = ffk.geometry()
    per = geo["quotient_threads"] * (geo["quotient_run"] if part else 1)
    cols, consts = quotient_inputs(part, n, gen, device)
    got = ffk.quotient(part, cols, **consts)
    sel = torch.unique(torch.cat([
        _ends_idx(n, cap, device), _block_idx(-(-n // per) // 2, per, n, device),
        torch.randint(0, n, (spread,), generator=gen, device=device)]))
    want = ffk.quotient_plain(part, cols, **consts, rows=sel)
    return {"kernel": "F3 quotient", "part": part, "n": n,
            "held": int(sel.numel()), "block": [geo["quotient_threads"],
                                                per // geo["quotient_threads"]],
            "s_rows_apart": 4 if part == 1 else 1,
            "max_abs_err": max(diff_words(g[sel], w) for g, w in zip(got, want))}


def quotient_edge_holds(gen, device) -> List[Dict]:
    """Every part at domains smaller than one block (8 and 1000 points)
    and at one block and a point."""
    geo = ffk.geometry()
    return [hold_quotient(part, n, gen, device) for part in (0, 1, 2)
            for n in (8, 1000, geo["quotient_threads"] * (
                geo["quotient_run"] if part else 1) + 1)]


def hold_msm_full(n: int, c: int, gen, device, cap: int = 4096) -> Dict:
    """B3 at a commitment's point count and window with full random
    scalars: n seeded points [k_i] G, every scalar full and random but
    zero outside the first and last `cap`, against msm_plain on those 2 cap
    (bn254_times.hold_msm)."""
    ks = field_elems(FR, n, gen, device)
    pts = curve.scalar_mul_words(curve.F1, curve.g1_generator(device), ks)
    s = torch.zeros((n, bf.N_LIMBS), dtype=torch.int64, device=device)
    sel = _ends_idx(n, cap, device)
    s[sel] = field_elems(FR, sel.numel(), gen, device)
    res = hold_msm(curve.F1, curve.unpack(curve.F1, pts), s, cap=cap, c=c)
    return {**res, "scalars": "full random, zero outside the ends",
            "zero_scalars": n - int(sel.numel())}


def hold_commit_full(srs: torch.Tensor, tau: int, m: int, gen, device) -> Dict:
    """B3 over the first m SRS points (tau^i G) with every scalar full and
    random: the MSM equals [sum_i s_i tau^i] G, the scalar summed in Fr on
    the card (B2's powers and products, B3's Fr range sum, each held
    against its twin) and multiplied on the host in python ints."""
    s = field_elems(FR, m, gen, device)
    got = curve.affine_ints(curve.F1, curve.Point(*[
        leaf[None] for leaf in msm.msm(curve.F1, srs[:m], s)]))[0]
    e = pf.poly_eval(bf.to_mont(FR, s), tau)
    want = g1_mul(e, G1_GEN) if e else None
    return {"kernel": "B3 msm", "group": "G1", "n": m,
            "c": msm.window(m), "scalars": "full random, every point",
            "against": "[sum s_i tau^i] G in python ints",
            "max_abs_err": 0 if got == want else 1}


def small_holds(dev, gen, only=("F1", "F2", "F3", "B3")) -> List[Dict]:
    """Every kernel of `only` at the edges of its control flow."""
    out = []
    if "F1" in only:
        for length, k in ((1, 1), (63, 1), (64, 1), (65, 1), (4097, 1),
                          (64 * 64 * 3 + 5, 1), (300, 3), (301, 4), (1027, 8),
                          (5000, 1024), (4096, 4096), (70, 64), (9, 1000)):
            for op in ffk.OPS:
                for backward in (False, True):
                    out.append(hold_scan(length, k, op, backward, gen, dev,
                                         200))
    if "F2" in only:
        out += inv_holds([70000], gen, dev)
    if "F3" in only:
        out += quotient_edge_holds(gen, dev)
        for part in (0, 1, 2):
            out.append(hold_quotient(part, 70000, gen, dev))
    if "B3" in only:
        out.append(hold_msm_full(20000, 12, gen, dev))
    return out


def timings(dev, gen, log_n: int = 21,
            only=("F1", "F2", "F3")) -> List[Dict]:
    """Each kernel of `only` once at the shapes of a 2^log_n-row proof
    (CUDA events, median of three), its bound, its twin on what a hold
    would take."""
    n = 1 << log_n
    out = []

    def entry(name, shape, fn, plain, bound, **extra):
        out.append({"kernel": name, "shape": shape,
                    "ms": device_time_ms(fn, 3),
                    "plain_ms": device_time_ms(plain, 1, prefill=False),
                    "bound_ms": bound[0], "bound_by": bound[1], **extra})

    x = _mont_elems(9 * n if "F1" in only else n, gen, dev, no_zero=True)
    xs = x[:2 * 4096]
    if "F1" in only:
        entry("F1 scan", [9 * n, 1, "add", "backward"],
              lambda: ffk.scan(x, 1, "add", True),
              lambda: ffk.scan_plain(xs, 1, "add", True),
              bound_scan(9 * n, "add"), plain_held=[xs.shape[0], 1])
        entry("F1 scan", [4 * n, n, "add", "backward"],
              lambda: ffk.scan(x[:4 * n], n, "add", True),
              lambda: ffk.scan_plain(x[:4 * 4096], 4096, "add", True),
              bound_scan(4 * n, "add"), plain_held=[4 * 4096, 4096])
        entry("F1 scan", [n, 1, "mul", "forward"],
              lambda: ffk.scan(x[:n], 1, "mul"),
              lambda: ffk.scan_plain(xs, 1, "mul"),
              bound_scan(n, "mul"), plain_held=[xs.shape[0], 1])
    if "F2" in only:
        fermat = bound_inv_fermat(n)
        entry("F2 inv", [n], lambda: ffk.inv(x[:n]),
              lambda: ffk.inv_plain(xs), bound_inv(n),
              plain_held=[xs.shape[0]], bound_ms_fermat=fermat[0],
              block=[ffk.geometry()[k] for k in ("inv_threads", "inv_run")])
    del x, xs
    if "F3" in only:
        for part, m in ((0, 4 * n), (1, n), (2, 4 * n)):
            cols, consts = quotient_inputs(part, m, gen, dev)
            rows = _ends_idx(m, 4096, dev)
            entry("F3 quotient", [part, m],
                  lambda: ffk.quotient(part, cols, **consts),
                  lambda: ffk.quotient_plain(part, cols, **consts, rows=rows),
                  bound_quotient(part, m), plain_held=[int(rows.numel())],
                  run=ffk.geometry()["quotient_run"] if part else 1)
            del cols
            torch.cuda.empty_cache()
    return out


def bound_launches(kid: str, shapes: dict):
    """(least ms, what bounds most of it) of F1's, F2's or F3's launches in
    a run's SHAPES record, each at its logged shape (F1 a scan's, whose
    carry launch belongs to it)."""
    terms = []
    if kid == "F1":
        terms = [(bound_scan(length, op), c) for (length, _k, op, _b), c in
                 shapes.get("scan", {}).items()]
    elif kid == "F2":
        terms = [(bound_inv(n), c) for n, c in shapes.get("inv", {}).items()]
    elif kid == "F3":
        terms = [(bound_quotient(part, n), c) for (part, n), c in
                 shapes.get("quotient", {}).items()]
    total = sum(b[0] * c for b, c in terms)
    by = {}
    for b, c in terms:
        by[b[1]] = by.get(b[1], 0.0) + b[0] * c
    return total, max(by, key=by.get) if by else "bytes"


# ---------------------------------------------------------------------------
# Final circuits
# ---------------------------------------------------------------------------


def prefix_r1cs(r1cs, witness, log_n: int, gates=None):
    """The longest prefix of `r1cs`'s constraints whose PLONK form has
    n = 2^log_n rows (None when the whole R1CS stays below it), with the
    same witness and publics; `gates`: constraint_gates(r1cs) when known."""
    gates = r1cs.n_public + np.cumsum(
        constraint_gates(r1cs) if gates is None else gates)
    m = int(np.searchsorted(gates, (1 << log_n) - 2, side="right"))
    if m == 0 or domain_size(int(gates[m - 1])) != 1 << log_n:
        return None
    return R1CS(n_vars=r1cs.n_vars, n_public=r1cs.n_public, a=r1cs.a[:m],
                b=r1cs.b[:m], c=r1cs.c[:m]), witness, m


def kernel_device_ms(prof) -> Dict:
    """Each bn_ kernel's device ms and launches in a profile, by name.

    Read from the profiler's raw events: key_averages() first builds a
    python object an event, which took 54 s over a Groth16 final hop's
    (NVIDIA H100 80GB HBM3, chip_smoke.py's phase final)."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"\b(bn_\w+_kernel)\b", ev.name())
        if not m:
            continue
        d = out.setdefault(m.group(1), {"ms": 0.0, "launches": 0})
        d["ms"] += ev.duration_ns() / 1e6
        d["launches"] += 1
    return out


def tampered(proof) -> Dict:
    """Two tampered copies: an evaluation and W1."""
    ev = dict(proof["evals"], a=(proof["evals"]["a"] + 1) % FR.mod)
    return {"eval": dict(proof, evals=ev),
            "W1": dict(proof, W1=g1_add(proof["W1"], G1_GEN))}


def prove_case(stage, r1cs, witness, rand: Optional[bytes] = None) -> Dict:
    """stage._prove_fflonk over (r1cs, witness) under torch.profiler:
    spans, peaks, host RSS, launches of F1-F3 and B2-B4, each bn_ kernel's
    device ms; the proof verifies, two tampered copies do not."""
    from torch.profiler import ProfilerActivity, profile

    from ..snark import curve as _curve
    from ..snark import fft as _fft

    counters = (ffk.LAUNCHES, bn254_cuda.LAUNCHES, _fft.LAUNCHES,
                msm.LAUNCHES, _curve.LAUNCHES)
    for d in counters:
        for k in d:
            d[k] = 0
    tlog = TimerLog("fflonk", quiet=True, peak_memory=True)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        proof = stage._prove_fflonk(r1cs, witness, rand=rand, timer=tlog)
        torch.cuda.synchronize()
    total = time.time() - t0
    launches = {"F": dict(ffk.LAUNCHES), "B2": {**bn254_cuda.LAUNCHES,
                                                 **_fft.LAUNCHES},
                "B3": dict(msm.LAUNCHES), "B4": dict(_curve.LAUNCHES)}
    rejected = {k: not pf.fflonk_verify(stage.key, bad)
                for k, bad in tampered(proof).items()}
    by_kernel = kernel_device_ms(prof)
    return {"constraints": len(r1cs.a), **stage.stats, "total_s": total,
            "spans_s": tlog.as_dict(), "span_peak_bytes": dict(tlog.peaks),
            "peak_memory_bytes": max(tlog.peaks.values()),
            "host_max_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "launches": launches, "device_ms_by_kernel": by_kernel,
            "device_ms": {g: sum(d["ms"] for k, d in by_kernel.items()
                                 if KERNEL_OF.get(k) == g)
                          for g in ("F1", "F2", "F3")},
            "verified": bool(proof["verified"]),
            "tampered_rejected": rejected, "proof": proof}


def final_r1cs(queries: int, device):
    """The final R1CS of the recursiveF proof of the n_bits = 3 smoke
    circuit at `queries` FRI queries, proven on the card."""
    from ..models.smoke import build_smoke_air, smoke_const_values
    from ..recursion.final_circuit import build_final_r1cs
    from ..stark.compiler import compile_air
    from ..stark.prover_bn128 import StarkProverBN128

    air, trace = build_smoke_air(n_bits=3, seed=3)
    info = compile_air(air, n_queries=queries, final_bits=2, fri_fold_bits=1)
    prover = StarkProverBN128(info, smoke_const_values(air), device=device)
    proof = prover.prove(trace)
    return build_final_r1cs(info, prover.const_tree.root()[0], proof)


def main(argv=None) -> int:
    from ..recursion.final import FinalStage

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, nargs="*", default=[21, 24])
    ap.add_argument("--queries", type=int, default=24)
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--only", nargs="*", default=["F1", "F2", "F3", "B3"],
                    help="the kernels to hold and time (B3: its full-scalar "
                    "hold)")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE: build from a copy of csrc/ with that "
                    "#define")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fflonk_times: no CUDA device")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2029)
    t0 = time.time()
    cuda_build.lib()
    doc = {"card": card(), "defines": args.define,
           "build_s": cuda_build.BUILD_SECONDS,
           "geometry": ffk.geometry(),
           "kernels": {k: v for k, v in cuda_build.resources(
               cuda_build.BUILD_LOG).items()
               if k.split("<")[0] in KERNEL_OF}}
    print(json.dumps({"phase": "build", "build_s": doc["build_s"],
                      "kernels": doc["kernels"]}), flush=True)
    holds = small_holds(dev, gen, args.only)
    bad = [h for h in holds if h["max_abs_err"] != 0]
    doc.update(holds=holds, mismatches=len(bad), hold_s=time.time() - t0)
    print(json.dumps({"phase": "holds", "mismatches": len(bad),
                      "bad": bad[:5]}), flush=True)
    if not args.no_times and not bad:
        doc["times"] = timings(dev, gen, only=args.only)
        print(json.dumps({"phase": "times", "times": doc["times"]}), flush=True)
    cases = []
    if args.log_n and not bad:
        t1 = time.time()
        r1cs, wit = final_r1cs(args.queries, dev)
        build_s = time.time() - t1
        for log_n in args.log_n:
            pre = prefix_r1cs(r1cs, wit, log_n)
            if pre is None:
                cases.append({"log_n": log_n, "skipped": "the R1CS is smaller"})
                continue
            stage = FinalStage(None, 0, protocol="fflonk", device=dev)
            res = prove_case(stage, pre[0], pre[1])
            res.pop("proof")
            srs_n = stage.key.srs_g1.shape[0]
            tau = int.from_bytes(pf.keccak256(
                b"fflonk-dev-srs" + stage.setup_seed.to_bytes(8, "big")),
                "big") % FR.mod
            res["commit_hold"] = hold_commit_full(
                stage.key.srs_g1, tau, min(srs_n, 1 << 22), gen, dev)
            if res["commit_hold"]["max_abs_err"]:
                bad.append(res["commit_hold"])
            del stage
            torch.cuda.empty_cache()
            cases.append({"log_n": log_n, "queries": args.queries,
                          "r1cs_build_s": build_s, "prefix_constraints": pre[2],
                          **res})
            print(json.dumps({"phase": "case", **cases[-1]}), flush=True)
            if not (res["verified"] and all(res["tampered_rejected"].values())):
                bad.append({"case": log_n})
    doc["cases"] = cases
    doc["seconds"] = time.time() - t0
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
