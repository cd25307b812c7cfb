"""Device times of the NTT block kernels and of the LDE pipeline around them.

    python -m merlin_zkevm_prover_tpu_torch.tools.ntt_times \\
        [--define NAME=VALUE ...] [--skip-split] [--kernels-only] [--out FILE]

Needs one CUDA card and nvcc.  Prints one JSON object (and writes it to
``--out``) with:

``lde_block_split``  one 64-column block of the ``2^17 -> 2^18`` coset LDE,
    as ``extend_pol_blocked`` runs it, split by CUDA events recorded around
    the pipeline's functions: the block kernels (``ntt_block`` and, where the
    package has them, ``ntt_block_cols`` / ``ntt_block_gather``), the mid
    gathers (``_mid_gather``), ``Tensor.repeat_interleave``, and the rest
    (the slice copies of ``extend_pol_blocked`` and whatever else runs
    between); medians over five runs of a two-block LDE, halved.  The card
    is kept busy ahead of each run, so the events time the card's work.
``lde_block_kernels``  every device kernel of one such two-block LDE by
    name (``torch.profiler``), with its count and device time.
``lde_2^17x665``  the whole ``(2^17, 665)`` LDE: host clock up to a
    synchronise, and device time, medians of three.
``transform_c``  the LDE and the transforms at the widths the smoke proof
    gives them (``c`` = 1, 2, 3, 7, 25, 27, 64), and, where the package
    fuses the mid gather into kernel B, the same transforms through kernel
    A, the plain ``_mid_gather`` and an unfused kernel B.
``kernels``  K4, K5 and K6 at the shapes of ``chip_smoke.py``'s rows, and
    kernels A and B of the pipeline at the smoke proof's widest LDE.

It only calls functions that the pipeline has had since it was first
ported, or checks that a newer one exists, so it also times an older
checkout of the package once this file is copied into it.
``--define NTT_LOG_TILE_WORDS=14`` builds the kernels from a copy of
``csrc/`` in which that ``#define`` has the given value.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import goldilocks as gl
from ..ops import ntt, ntt_cuda
from ..utils.timer import device_time_ms

# ~20 ms of GPU spin ahead of a split run: the host issues the whole LDE's
# launches while the card is still busy, so the events time the card
SPLIT_PREFILL_CYCLES = 40_000_000
WIDTHS = (1, 2, 3, 7, 25, 27, 64)


def _rnd_on(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    def rnd(*shape):
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev,
                             dtype=torch.int64)
    return rnd


class _Ranges:
    """CUDA events around named module functions, by category."""

    def __init__(self):
        self.pairs = {}
        self.saved = []

    def wrap(self, owner, name, category):
        if not hasattr(owner, name):
            return
        orig = getattr(owner, name)
        pairs = self.pairs.setdefault(category, [])

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kw)
            b.record()
            pairs.append((a, b))
            return out
        self.saved.append((owner, name, orig))
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved = []

    def take(self) -> dict:
        """{category: (summed ms, count)} since the last take."""
        out = {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
               for k, v in self.pairs.items()}
        for v in self.pairs.values():
            v.clear()
        return out


def lde_block_split(rnd) -> dict:
    nb, blocks = 17, 2
    cols = ntt.EXTEND_BLOCK_COLS
    mat = rnd(1 << nb, blocks * cols)
    ntt.extend_pol_blocked(mat, nb, nb + 1)      # warm-up: tables, build
    torch.cuda.synchronize()
    rng = _Ranges()
    for name in ("ntt_block", "ntt_block_cols", "ntt_block_gather"):
        rng.wrap(ntt_cuda, name, "block_kernels")
    rng.wrap(ntt_cuda, "_mid_gather", "mid_gather")
    rng.wrap(torch.Tensor, "repeat_interleave", "repeat_interleave")
    rng.wrap(ntt, "extend_pol_blocked", "total")
    runs = []
    try:
        for _ in range(5):
            torch.cuda._sleep(SPLIT_PREFILL_CYCLES)
            ntt.extend_pol_blocked(mat, nb, nb + 1)
            torch.cuda.synchronize()
            runs.append(rng.take())
    finally:
        rng.restore()
    cats = ("block_kernels", "mid_gather", "repeat_interleave")
    split = {}
    for k in cats + ("total",):
        split[k + "_ms"] = statistics.median(
            r.get(k, (0.0, 0))[0] for r in runs) / blocks
        split[k + "_calls"] = runs[0].get(k, (0.0, 0))[1] / blocks
    split["slice_copies_and_other_ms"] = statistics.median(
        r["total"][0] - sum(r.get(k, (0.0, 0))[0] for k in cats)
        for r in runs) / blocks

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ntt.extend_pol_blocked(mat, nb, nb + 1)
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        kernels.append({"name": ev.key[:100], "count": ev.count,
                        "device_ms": us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    return {"shape": [1 << nb, blocks * cols], "blocks": blocks,
            "per_block": split}, kernels


def lde_665(rnd) -> dict:
    nb, w = 17, 665
    mat = rnd(1 << nb, w)
    ntt.extend_pol_blocked(mat, nb, nb + 1)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.time()
        ntt.extend_pol_blocked(mat, nb, nb + 1)
        torch.cuda.synchronize()
        host.append((time.time() - t0) * 1e3)
    dev_ms = device_time_ms(lambda: ntt.extend_pol_blocked(mat, nb, nb + 1), 3)
    return {"host_clock_ms": statistics.median(host), "host_runs_ms": host,
            "device_ms": dev_ms}


def _ntt_v2_unfused(a2, nbits, inverse, *, sep_scale_base=None,
                    with_ninv=False, const_scale=None, zero_top=False):
    """The pipeline with the mid gather as plain tensor code between two
    unfused block kernels (the form before the gather was folded into
    kernel B), on the current kernels."""
    c = a2.shape[1]
    n1_bits, n2_bits = ntt_cuda._split(nbits)
    n1, n2 = 1 << n1_bits, 1 << n2_bits
    dev = a2.device
    in_rows = n1 // 2 if zero_top else n1
    y = ntt_cuda.ntt_block(a2.reshape(in_rows, n2 * c),
                           ntt_cuda._dev(dev, ntt_cuda._stage_tables_np,
                                         n1_bits, inverse),
                           n1_bits, dif=True, zero_top=zero_top)
    z = ntt_cuda._mid_gather(y, n1_bits, n2_bits, c, inverse)
    u = v = None
    if sep_scale_base is not None:
        key = (nbits, n1_bits, sep_scale_base, with_ninv)
        u = ntt_cuda._dev(dev, ntt_cuda._sep_scale_np, *key, pick=0)
        v = ntt_cuda._dev(dev, ntt_cuda._sep_scale_np, *key,
                          pick=1).repeat_interleave(c)
    out = ntt_cuda.ntt_block(z, ntt_cuda._dev(dev, ntt_cuda._stage_tables_np,
                                              n2_bits, inverse),
                             n2_bits, dif=False, u=u, v=v,
                             const_scale=const_scale)
    return out.reshape(1 << nbits, c)


def _lde_unfused(a2, nb):
    coeffs = _ntt_v2_unfused(a2, nb, True, sep_scale_base=gl.SHIFT,
                             with_ninv=True)
    return _ntt_v2_unfused(coeffs, nb + 1, False, zero_top=True)


def transform_c(rnd) -> dict:
    fused = hasattr(ntt_cuda, "ntt_block_gather")
    out = {}
    for c in WIDTHS:
        x17 = rnd(1 << 17, c)
        row = {"lde_2^17": device_time_ms(
            lambda: ntt_cuda.extend_pol_device(x17, 17, 18), 5)}
        if c == 3:
            x18 = rnd(1 << 18, c)
            row["intt_2^17"] = device_time_ms(
                lambda: ntt_cuda.ntt_device(x17, inverse=True), 5)
            row["ntt_2^18"] = device_time_ms(
                lambda: ntt_cuda.ntt_device(x18, inverse=False), 5)
        if fused:
            want = ntt_cuda.extend_pol_device(x17, 17, 18)
            got = _lde_unfused(x17, 17)
            if not torch.equal(got, want):
                raise AssertionError(f"unfused LDE differs at c = {c}")
            row["lde_2^17_unfused"] = device_time_ms(
                lambda: _lde_unfused(x17, 17), 5)
            if c == 3:
                p = pow(1 << 17, gl.P - 2, gl.P)
                row["intt_2^17_unfused"] = device_time_ms(
                    lambda: _ntt_v2_unfused(x17, 17, True, const_scale=p), 5)
                row["ntt_2^18_unfused"] = device_time_ms(
                    lambda: _ntt_v2_unfused(x18, 18, False), 5)
        out[str(c)] = row
    return out


def kernels(rnd, dev) -> dict:
    """{row: [device ms, equal to the plain version]}."""
    def tw(log_l, inverse):
        return ntt_cuda._dev(dev, ntt_cuda._stage_tables_np, log_l, inverse)

    x5, x6, x4 = rnd(512, 13824), rnd(4, 13824), rnd(4, 196608)
    t9, t3, t2 = tw(9, False), tw(3, False), tw(2, True)
    rows = {
        "K5 (512, 13824) dit": (ntt_cuda.ntt_block, ntt_cuda.ntt_block_plain,
                                (x5, t9, 9, False), {}),
        "K5 (512, 13824) dif": (ntt_cuda.ntt_block, ntt_cuda.ntt_block_plain,
                                (x5, t9, 9, True), {}),
        "K6 (8, 13824) from 4 rows, dif zero_top": (
            ntt_cuda.ntt_block, ntt_cuda.ntt_block_plain, (x6, t3, 3, True),
            {"zero_top": True}),
        "K4 (4, 196608)": (ntt_cuda.ntt_short, ntt_cuda.ntt_short_plain,
                           (x4, t2, 2), {}),
    }
    if hasattr(ntt_cuda, "ntt_block_gather"):
        # kernels A and B of the (2^17, 27) LDE's forward transform, and
        # kernel A of its inverse (L = 256)
        xa, xi, y = rnd(1 << 17, 27), rnd(1 << 17, 27), rnd(512, 13824)
        rows |= {
            "K5 kernel A (512, 13824) from 256 rows, zero_top": (
                ntt_cuda.ntt_block_cols, ntt_cuda.ntt_block_cols_plain,
                (xa, 9, 9, False, True), {}),
            "K5 kernel A (256, 13824), inverse": (
                ntt_cuda.ntt_block_cols, ntt_cuda.ntt_block_cols_plain,
                (xi, 8, 9, True), {}),
            "K5 gather B (512, 13824)": (
                ntt_cuda.ntt_block_gather, ntt_cuda.ntt_block_gather_plain,
                (y, 9, 9, 27, False), {}),
        }
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {"launch floor (one-word torch add)": [
        device_time_ms(lambda: one.add_(1), 7), True]}
    for name, (fn, plain, args, kw) in rows.items():
        out[name] = [device_time_ms(lambda: fn(*args, **kw), 7),
                     torch.equal(fn(*args, **kw), plain(*args, **kw))]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--skip-split", action="store_true",
                    help="leave out the LDE split and the (2^17, 665) LDE")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernel rows and nothing else")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ntt_times: no CUDA device")
    if args.define:
        cuda_build.CSRC = cuda_build.variant_csrc(args.define)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rnd = _rnd_on(dev)
    res = {"card": card, "defines": args.define}
    res["kernels_ms"] = kernels(rnd, dev)
    if not (args.skip_split or args.kernels_only):
        res["lde_block_split"], res["lde_block_kernels"] = lde_block_split(rnd)
        res["lde_2^17x665"] = lde_665(rnd)
    if not args.kernels_only:
        res["transform_c_ms"] = transform_c(rnd)
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
