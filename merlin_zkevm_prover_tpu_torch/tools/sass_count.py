"""SASS instruction counts of the Poseidon permutation body.

    python -m merlin_zkevm_prover_tpu_torch.tools.sass_count [--csrc DIR] [--out FILE]

Needs ``nvcc`` and ``cuobjdump`` (a CUDA toolkit; run it on the machine with
the card).  It compiles a probe that includes ``DIR/poseidon_gl.cu``
(default: this package's ``csrc``) for ``sm_90a`` and counts, with
``cuobjdump -sass``, the instructions of probe kernels that each load a
state, run one piece of the body and store the state:

  io       load and store only
  full     one full round
  partial  one partial round

so that one permutation is about ``io + 8 (full - io) + 22 (partial - io)``
instructions, and the instructions of each kind (IMAD.WIDE, IADD3, SHFL,
...) likewise.  A source without ``pg_full_round`` (the body before the
frequency-domain MDS: round constants added with ``gl_add``, ``gl_pow7``,
the dense ``pg_mds``) gets a probe of that body's round instead.  For the
current body it also counts the two ways of a 64 x 64 -> 128 bit product
(one chain of 32-bit partial products, three for a square, against the body's
``a * b`` with ``__umul64hi``) and the two linear
layers (frequency domain against a dense 12 x 12 circulant with the same
reduction).  It prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..ops.cuda_build import demangle

_CSRC = Path(__file__).resolve().parent.parent / "csrc"

_COMMON = r"""
#define PROBE_LOAD uint64_t s[PG_WIDTH]; \
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = p[i * 1024 + threadIdx.x];
#define PROBE_STORE for (int i = 0; i < PG_WIDTH; ++i) p[i * 1024 + threadIdx.x] = s[i];
__global__ void probe_io(uint64_t* p, int r) { PROBE_LOAD PROBE_STORE }
"""

_NEW = r"""
__global__ void probe_full(uint64_t* p, int r) {
    PROBE_LOAD pg_full_round(s, PG_RC + r * PG_WIDTH); PROBE_STORE }
__global__ void probe_partial(uint64_t* p, int r) {
    PROBE_LOAD pg_partial_round(s, PG_RC + r * PG_WIDTH); PROBE_STORE }
// the 128-bit product as one chain of 32 x 32 -> 64 bit partial products
// (t, u < 2^64 as gl_mul128's bounds once showed), three for a square
__device__ __forceinline__ uint64_t chain_mul(uint64_t a, uint64_t b, bool sq) {
    uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
    uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
    uint64_t p00 = (uint64_t)a0 * b0, p01 = (uint64_t)a0 * b1;
    uint64_t t = p01 + (p00 >> 32);
    uint64_t u = (sq ? p01 : (uint64_t)a1 * b0) + (uint32_t)t;
    uint64_t lo = (u << 32) | (uint32_t)p00;
    uint64_t hi = (uint64_t)a1 * b1 + (t >> 32) + (u >> 32);
    return gl_reduce128_lazy(lo, hi);
}
__global__ void probe_mul_chain(uint64_t* p, int r) {
    PROBE_LOAD s[0] = chain_mul(s[0], s[1], false); PROBE_STORE }
__global__ void probe_mul_umulhi(uint64_t* p, int r) {
    PROBE_LOAD s[0] = gl_mul_lazy(s[0], s[1]); PROBE_STORE }
__global__ void probe_sqr_chain(uint64_t* p, int r) {
    PROBE_LOAD s[0] = chain_mul(s[0], s[0], true); PROBE_STORE }
__global__ void probe_sqr_umulhi(uint64_t* p, int r) {
    PROBE_LOAD s[0] = gl_sqr_lazy(s[0]); PROBE_STORE }
__global__ void probe_mds_freq(uint64_t* p, int r) {
    PROBE_LOAD pg_mds_rc(s, PG_RC + r * PG_WIDTH); PROBE_STORE }
__global__ void probe_mds_dense(uint64_t* p, int r) {
    PROBE_LOAD
    const uint64_t* rc = PG_RC + r * PG_WIDTH;
    uint64_t lo[PG_WIDTH], hi[PG_WIDTH], out[PG_WIDTH];
    for (int j = 0; j < PG_WIDTH; ++j) { lo[j] = s[j] & 0xFFFFFFFFULL; hi[j] = s[j] >> 32; }
    for (int i = 0; i < PG_WIDTH; ++i) {
        uint64_t al = rc[i] & 0xFFFFFFFFULL, ah = rc[i] >> 32;
        for (int j = 0; j < PG_WIDTH; ++j) {
            uint64_t c = PG_CIRC[(j - i + PG_WIDTH) % PG_WIDTH];
            al += c * lo[j];
            ah += c * hi[j];
        }
        if (i == 0) { al += PG_MDS_DIAG0 * lo[0]; ah += PG_MDS_DIAG0 * hi[0]; }
        out[i] = pg_fold(al, ah);
    }
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = out[i];
    PROBE_STORE }
"""

_OLD = r"""
__global__ void probe_full(uint64_t* p, int r) {
    PROBE_LOAD
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_add(s[i], PG_RC[r * PG_WIDTH + i]);
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_pow7(s[i]);
    pg_mds(s);
    PROBE_STORE }
__global__ void probe_partial(uint64_t* p, int r) {
    PROBE_LOAD
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_add(s[i], PG_RC[r * PG_WIDTH + i]);
    s[0] = gl_pow7(s[0]);
    pg_mds(s);
    PROBE_STORE }
"""


def _tool(name: str) -> str:
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (PATH, CUDA_HOME, /usr/local/cuda)")


def sass_by_kernel(cubin: Path) -> dict:
    """{kernel name: Counter of opcodes (with modifiers)} from cuobjdump."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[m.group(1)] += 1
    return out


def count(csrc: Path) -> dict:
    src = (csrc / "poseidon_gl.cu").read_text()
    new = "pg_full_round" in src
    with tempfile.TemporaryDirectory() as tmp:
        probe = Path(tmp) / "probe.cu"
        probe.write_text(f'#include "{csrc / "poseidon_gl.cu"}"\n' + _COMMON
                         + (_NEW if new else _OLD))
        cubin = Path(tmp) / "probe.cubin"
        r = subprocess.run([_tool("nvcc"), "-cubin", "-gencode",
                            "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-Xptxas", "-v", "-I", str(csrc), str(probe), "-o",
                            str(cubin)], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode:
            raise RuntimeError("probe build failed:\n" + r.stdout)
        kernels = {demangle(k): v for k, v in sass_by_kernel(cubin).items()}
    io, full, part = kernels["probe_io"], kernels["probe_full"], kernels["probe_partial"]
    per_perm = collections.Counter()
    for op in set(io) | set(full) | set(part):
        per_perm[op] = io[op] + 8 * (full[op] - io[op]) + 22 * (part[op] - io[op])
    res = {
        "source": str(csrc / "poseidon_gl.cu"), "body": "current" if new else "dense",
        "per_permutation": sum(per_perm.values()),
        "per_permutation_by_op": dict(per_perm.most_common()),
        "full_round": sum(full.values()) - sum(io.values()),
        "partial_round": sum(part.values()) - sum(io.values()),
        "kernels": {k: sum(v.values()) for k, v in kernels.items()},
    }
    if new:
        res["kernels_by_op"] = {k: dict(v.most_common())
                                for k, v in kernels.items()
                                if k.startswith(("probe_mul", "probe_sqr",
                                                 "probe_mds"))}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_CSRC)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    res = count(args.csrc.resolve())
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
