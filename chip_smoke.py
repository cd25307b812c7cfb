#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``merlin_zkevm_prover_tpu_torch/csrc`` and runs
its phases, each of which raises on failure (nothing falls back to the CPU,
and the exit code is non-zero unless every phase passed):

  device   the card's name and power limit, versions, the kernel build
  kernels  every kernel against its plain PyTorch version on the card, exact
           equality, at the main paths' shapes and at edge shapes: permute at
           B = 1, 127, 128 and 270,600 with edge words in every lane;
           linear_hash at widths 5 to 665 with edge words (two of them in
           [p, 2^64)) across the first rows;
           node_hash at every boundary of its dispatch (1, 2, 3 pairs and
           each threshold -1, at, +1, through the wrapper and through each
           of its one-level kernels); Merkle levels of trees of 2^1 .. 2^18
           leaves, edge words in every lane, against the plain levels on
           the card; the block NTT at every L from 2 to 512 with each flag
           combination, edge words (p and 2^64 - 1 among them) across the
           first rows, a one-hot column, and on a column slice; the
           pipeline's kernel A reading a column slice in place and kernel B
           reading through the mid gather (into a column slice) at n_bits
           10 to 18 and c = 1, 3, 25, 64; blocked LDEs of 67 to 131 columns;
           the one-hot, impulse and Lagrange probes through ntt / intt /
           extend_pol, and on 64-column blocks (EXTEND_BLOCK_COLS) at the
           recursion stages' sizes: ntt and intt at n_bits 20 and 21,
           extend_pol_blocked 19 -> 20 and 20 -> 21 (the four-step route
           over ntt_short); the VM interpreter on the smoke circuit's three step
           programs at the n_bits 17 proof's domains (sections as column
           slices, edge words, p and 2^64 - 1 across their first rows), on a
           6,000-instruction random program, on a program whose
           destinations alias its operands, on the wide circuit's step-4
           program at 2^18 rows, on a 400-register program whose registers
           spill to device memory, and at n = 2^16 + 5 rows.  These holds
           run in a second process (``--kernel-holds``) while phase final
           builds its R1CS (host python, nothing launched on the card);
           their line comes just before final_holds'; K2 at (2^18, 665) is
           timed up front, on the card alone
  permute  K1's path: the batched permutation entry point
           (``ops.poseidon_gl.permute``) on a (12, 270600) state, the
           PoseidonG state machine's capacity at 2^23 rows; columns checked
           against the python-int permutation
  state    the PoseidonG state machine at 2^23 rows through
           PoseidonGExecutor.execute: 200,000 seeded inputs of 12, 16 and
           17 words (permutation ids 1-4; p and 2^64 - 1 in the first),
           their digests from K1, the other slots of the 270,600 padding;
           kernel S1 (round_trace) launched once, its 19 columns held
           against the plain version on the card, the first and last 64
           slots and the dead rows against the python-int rounds, raw
           words through S1 and its plain version, a changed digest must
           raise; then the state tree: Smt64.build of 2^20 seeded keys
           (some words at or above p) from the empty tree and of 4,096
           writes (updates, deletes, fresh keys) over its root, on K1 (its
           launches and device ms, the host seconds of each piece), held
           at kernels_check against the same builds on K1's plain version
           on the card, which the kernel-holds process runs (roots, node
           counts, a SHA-256 of the nodes); and a 2^12-key build's root
           against the binary SMT's sequential sets (hashdb.HashDB)
  golden   smoke proofs at n_bits 5, 10, 11 and 13 proven on the card equal,
           field by field, the proofs the JAX prover wrote (tests/data/); the
           n_bits 11 proof is K6's path (its LDE runs block lengths 4 and 8);
           each takes the card's default route, the large-circuit path, and
           the n_bits 13 proof is proven again on the small-circuit path
  commit   coset LDE + Poseidon Merkle tree of a seeded 2^17 x 665 matrix (the
           zkEVM's cm1 width), every 64-column block checked against the
           plain LDE, python-int openings; then one LDE block under
           torch.profiler, which must run the four block kernels and no other
           device kernel (the ``lde_block_split`` line: each kernel's device
           time and the block's, the difference being what runs between them)
  prove    the main path: one STARK proof of the smoke circuit at n_bits 17
           through the kernels, verified; it takes the card's default route,
           the large-circuit path (steps 2-4 on the VM, one vm_run launch
           each; step 5 as weighted column sums), and every transform of it
           takes kernel B's fused gather (the plain ``_mid_gather`` never
           runs on the card)
  prove_vm the same proof with the route forced while its StarkProver is
           built: MERLIN_VM_MIN_NODES=0 and MERLIN_STEP5_MATRIX_MIN=0 (the
           large-circuit path), then both at 10^9 (the small-circuit path:
           the tree evaluator, step 5 per entry); each must equal the
           ``prove`` phase's proof in every field and verify, the first
           reject a changed public; each span's peak of allocated bytes
  recursion the recursion chain (recursion/recursive.py), each stage a
           plonk12c STARK proven through the kernels on the large-circuit
           path: the Poseidon-preimage plonk12c proof and recursive1 over the
           golden n_bits 5 proof equal the JAX golden files
           (tests/data/torch_plonk12c_proof.json, torch_recursive1_proof.json);
           then, at the production settings (n_queries 32, fri_fold_bits 3,
           final_bits 4), recursive1 over the smoke circuit's n_bits 17
           proof with the same FRI settings, again by the witness-refill path
           over a second proof of the same StarkProver (another witness), and
           recursive2 over the two; each verifies, recursive2's publics bind
           both children and the recursive1 const root, a changed public is
           rejected.  One line a
           stage: layout, circuit, host seconds of each piece, spans, peak
           bytes, launches; then one 64-column block of recursive2's LDE
           under torch.profiler (the four-step route: K4 and the glue)
  final    the last hop (prover/backend.py gen_final_proof): recursiveF, the
           BN254-committed STARK (StarkProverBN128) of recursive2's verifier
           circuit at the same settings, every BN254 tree built by kernel B1
           on the card, verified with the BN128 tree and transcript, a
           changed public rejected; then FinalStage: the verifier R1CS, the
           Groth16 setup (B2's power and product kernels, B3's range sums,
           B4's point tables made affine by B3) and proof (B2's transforms,
           B3's range sums and five MSMs over the affine tables, B4 for the
           blinding), the pairing check, a proof
           with pi_a changed by one rejected.  One line: rows, gates,
           constraints, variables, domain bits, the host spans, each BN254
           kernel's launches and device ms (the phase runs under
           torch.profiler; each kernel's own device time, summed), peak
           device memory and host RSS
  final_holds  B1-B4 against their plain twins, exactly, at every distinct
           shape the final phase launched them at (the wrappers' SHAPES
           records; seeded, edge values across the first and last rows;
           above 8192 rows, elements or scalars on the first and last
           4096; B3's range sums on up to 8192 values at each logged
           proportion of ranges; each MSM at its full point count and
           window, every scalar 0 but the first and last 4096, against the
           twin on those 8192 (at the reference's window), its largest
           bucket over three range passes; B3's batch-to-affine at each
           logged shape, its signed-digit counts and scatter and affine
           bucket sums at the smallest and largest logged shape of each
           group and window, its window reduce at the most windows of
           each (the combine against python ints); B2's
           powers at each logged shape; B4 launched on all of a logged
           count's scalars, its first and last 512 results held); and, in
           a second process while phase final built its R1CS
           (``--edge-holds``, edge_holds): B2's NTT at
           every size 2 to 2^24 both ways; the affine edges (a base at
           infinity, a repeated base, a base and its negation in one
           bucket) through the MSM against python ints; one 2^12-row
           BN254 tree against the host MerkleTreeBN128; the edges: B4 in
           G1 and G2 at scalars 0, 1, r - 1, r, 2^k, r - 2^k, 2^256 - 1, a
           carry into the top window, digits at +-2^(w-1) and walks whose
           accumulator meets +-the point it adds, against the twin and
           python ints; B1's leaves at every last-chunk width t = 2..17
           and at row widths 1-5, 47-49, 105 and 665
  golden_final  the n_bits 3 recursiveF proof and its Groth16 proof (the
           golden file's setup seed and fixed blinding) proven on the card
           equal tests/data/torch_bn128_proof.json and
           torch_groth16_final.json in every field, the key's verifying
           points and its tables' end points too
  fflonk   fflonk as the final SNARK (FinalStage(protocol="fflonk"): the
           PLONK form of snark/r1cs_to_plonk.py, snark/fflonk.py on B2-B4
           and F1-F3): the JAX package's two golden fflonk proofs equal
           tests/data/torch_fflonk_*.json; FinalStage(protocol="fflonk")
           over the golden recursiveF proof (a 2^21-row PLONK form),
           verified, a changed evaluation and a changed W1 rejected; the
           production R1CS of phase final: its PLONK size counted, the
           refusal asserted when its 4n domain exceeds Fr's two-adicity,
           then the longest prefix of its constraints whose PLONK form
           fills 2^FFLONK_PREFIX_BITS rows proven and verified.  One line a
           case: spans, launches, each kernel's device ms (torch.profiler),
           peaks
  fflonk_holds  F1-F3 against their twins, exactly, at every distinct
           shape phase fflonk launched them at (F2 with zeros at the first
           and last slot of threads' runs and of blocks, a block of zeros,
           every element of four blocks held; F3 every point of a block,
           the ends and 4096 seeded points over the domain, part 1 reading
           s1..s3 four rows apart), and at the edges of their blocks (F2 at
           n = 1, 255, 257, three blocks and a part, the values 0, 1, r -
           1; F3 every part at 8, 1000 and a block and a point); B3 at
           full random scalars at every commitment's point count (against
           [sum s_i tau^i] G in python ints) and, at the largest, against
           msm_plain; B3's new launches as in final_holds; B2's NTT passes
           above 2^24, its powers at each logged length and fused poly_eval
           (against its twin, and the host Horner up to 2^16 coefficients)
           at each logged shape; B4 (the SRS) launched at every scalar
           count of the phase, full random scalars, its first and last 512
           results against its twin

Each path (permute, state's PoseidonG execute and tree builds, each golden
proof, prove, prove_vm, each recursion stage, the final hop, the golden
final hop, each fflonk case) is driven with every launch counter set to 0
just before it and read just after.  Each phase's line
carries ``t_s``, the seconds since the script started.

Output: one JSON object per line.  Early lines (phases
``poseidon_build``, ``ntt_build``, ``bn254_build``) give each kernel's
registers, stack and spills from the build log; the ``prove`` line gives the node-hash launches per kernel
variant.  The line before the last lists every
kernel (K1 to K6, and vm_run, round_trace (S1), B1-B4 and F1-F3, which
have no Pallas counterpart)
with its launches on its path, its launches in each recursion stage
(``recursion_launches``), its error against the plain version, its time,
the plain version's time and the card's bound for the same work (K2 to
K5 also summed over recursive2's own launches, K4 at its largest
recursion shape; B1-B4 at the largest shape of the final hop, their
launches in it and their device time per final proof).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports no JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s float32 outside the tensor cores, i.e. 33.5e12 multiply-add
# lanes/s on 128 FP32 lanes per SM.  The data sheet has no integer row; a
# Hopper SM has 64 INT32 lanes, half the FP32 lanes, so the peak 32-bit
# integer multiply-add rate is taken as 16.75e12 /s.  One 64x64 -> 128 bit
# product is four 32x32 -> 64 multiply-adds.
MEM_BYTES_PER_S = 3.35e12
IMAD32_PER_S = 33.5e12 / 2
IMAD_PER_MUL64 = 4
# Poseidon permutation, counted as the function needs it.  Its only products
# of two field elements are the S-boxes': x^7 = x^3 * x^4 with x^3 = x^2 * x,
# two squares (three 32-bit partial products each: lo*lo, lo*hi doubled,
# hi*hi) and two products (four each), on 12 lanes in the 8 full rounds and
# on one lane in the 22 partial rounds: 118 S-boxes of 14 multiply-adds.
# The linear layer is an integer matrix with entries below 2^6 (the kernel
# runs it in the frequency domain, whose constants, at most 16 in magnitude,
# shifts and adds can apply) and the reductions mod p shift and add, so
# neither is counted, nor is any add: the bound is below any algorithm's.
PERM_IMAD32 = (8 * 12 + 22) * (2 * 3 + 2 * 4)

# phase fflonk (c): the PLONK rows of the production R1CS's prefix
FFLONK_PREFIX_BITS = 23
LARGE_PATH_ENV = {"MERLIN_VM_MIN_NODES": "0", "MERLIN_STEP5_MATRIX_MIN": "0"}
SMALL_PATH_ENV = {"MERLIN_VM_MIN_NODES": "1000000000",
                  "MERLIN_STEP5_MATRIX_MIN": "1000000000"}


T_START = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.time() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, mul64: float, imad32: float = 0.0):
    t_mem = n_bytes / MEM_BYTES_PER_S
    t_ops = (mul64 * IMAD_PER_MUL64 + imad32) / IMAD32_PER_S
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def perm_bound_ms(n_perm: int, n_bytes: float):
    """Bound of `n_perm` Poseidon permutations moving `n_bytes`."""
    return bound_ms(n_bytes, 0, n_perm * PERM_IMAD32)


def call_bound_ms(kernel: str, a: dict):
    """Bound of one launch of a kernel wrapper, from its arguments by name."""
    if kernel == "linear_hash":
        h, w = a["rows"].shape
        return perm_bound_ms(h * -(-w // 8), h * (w + 4) * 8)
    if "y" in a:
        # kernel B with the mid gather in its load: kernel A's output in,
        # the (L, n1) gather table, the product by it, then the block
        y, n1, log_l = a["y"], 1 << a["n1_bits"], a["n2_bits"]
        l, b = 1 << log_l, y.shape[1]
        n_bytes = 2 * y.numel() * 8 + (l * n1 + l - 1) * 8
        mul64 = (l // 2) * (log_l - 1) * b + l * b
        for scale in ("u", "v", "const_scale"):
            if a[scale] is not None:
                mul64 += l * b
        n_bytes += (l * 8 if a["u"] is not None else 0) + (
            n1 * 8 if a["v"] is not None else 0)
        return bound_ms(n_bytes, mul64)
    if "n1_bits" in a:
        # kernel A: the (L or L/2, n2 * c) view of an (N, c) matrix
        x, log_l = a["x"], a["n1_bits"]
        l = 1 << log_l
        b = x.numel() // (l // 2 if a["zero_top"] else l)
        return bound_ms(x.numel() * 8 + l * b * 8 + (l - 1) * 8,
                        (l // 2) * (log_l - 1) * b)
    x, log_l = a["x"], a["log_l"]
    l, b = 1 << log_l, x.shape[1]
    n_bytes = (x.shape[0] + l) * b * 8 + (l - 1) * 8
    mul64 = (l // 2) * (log_l - 1) * b
    if kernel != "ntt_short":           # the block kernel's epilogues
        for scale in ("u", "v", "const_scale"):
            if a[scale] is not None:
                mul64 += l * b
        n_bytes += (l * 8 if a["u"] is not None else 0) + (
            b * 8 if a["v"] is not None else 0)
    return bound_ms(n_bytes, mul64)


def vm_programs(vm, info) -> dict:
    """The three step programs as the prover compiles them on the large
    path, by step."""
    return {
        2: vm.compile_program(info.step2prev, info, "n", ["cm1_n", "const"]),
        3: vm.compile_program_ordered(info.step3prev, info, "n",
                                      ["cm1_n", "cm2_n", "const"]),
        4: vm.compile_program([(("acc", 0), info.c_exp)], info, "ext",
                              ["cm1_2ns", "cm2_2ns", "cm3_2ns", "const"])}


def vm_code_bound_ms(vm, code: np.ndarray, n: int, pre_words: int,
                     n_out: int, pre_regs=(), typed: bool = True):
    """Bound of one run of `code` over n rows: the section words it loads
    (each column once, whatever its loads), its preloads and its outputs,
    once each; its products.  Typed (the count the function needs): which
    registers hold base values follows from the code (a load with dim != 3
    gives one, an ADD, SUB, MUL or NEG of base values gives one; registers
    start at 0, preloads, constants and LOADC count as extension values),
    and a MUL of two base values is one 64-bit product, a base value times
    an extension value (MUL, MULC) three, two extension values six.  Not
    typed: six for every MUL and MULC."""
    cols, n_mul, base = set(), 0, {}
    pre = set(pre_regs)
    for op, a, b, d in code.tolist():
        op &= 15
        if op in (vm.LOAD, vm.LOADR):
            cols |= {(a, (b >> 2) + j) for j in range(3 if b & 3 == 3 else 1)}
        ba = base.get(a, a not in pre)
        bb = base.get(b, b not in pre)
        if op == vm.MUL:
            n_mul += 6 if not typed else 1 if ba and bb else 3 if ba or bb else 6
        elif op == vm.MULC:
            n_mul += 3 if typed and ba else 6
        if op in (vm.ADD, vm.SUB, vm.MUL):
            base[d] = ba and bb
        elif op == vm.NEG:
            base[d] = ba
        elif op in (vm.LOAD, vm.LOADR):
            base[d] = b & 3 != 3
        else:
            base[d] = False
    words = len(cols) + pre_words + 3 * n_out
    return bound_ms(words * n * 8, n_mul * n)


def vm_bound_ms(vm, prog, n: int, typed: bool = True):
    """Bound of one run of the compiled `prog` over n rows (x and Zi are
    base-field preloads, one word a row)."""
    pre_words = sum(1 if kind in ("x", "Zi") else 3 for _r, kind in prog.preload)
    return vm_code_bound_ms(vm, prog.code, n, pre_words, len(prog.out_regs),
                            [r for r, _k in prog.preload], typed)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the field elements read as unsigned words (0 is
    the only acceptable value: the arithmetic is exact)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    au, bu = a.cpu().numpy().view(np.uint64), b.cpu().numpy().view(np.uint64)
    return int(np.max(np.where(au > bu, au - bu, bu - au)))


# phase state: the PoseidonG state machine at 2^PG_ROWS_BITS rows with
# PG_INPUTS hashes (the rest of its slots zero padding), the state tree of
# 2^TREE_KEYS_BITS keys then TREE_WRITES writes over it, and a
# 2^SMT_KEYS_BITS-key tree against the binary SMT
PG_ROWS_BITS = 23
PG_INPUTS = 200_000
TREE_KEYS_BITS = 20
TREE_WRITES = 4096
SMT_KEYS_BITS = 12


def pg_inputs(seed: int, count: int, dev):
    """`count` seeded PoseidonG inputs, of 12, 16 and 17 words in turn (the
    17-word ones with permutation ids 1-4 in turn), the words p and
    2^64 - 1 in two lanes of each of the first 24, their expected digests
    from K1 on the card.  Returns the inputs, their 12-word states and
    each input's permutation id (1 where it has none)."""
    from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_gl as pg

    rng = np.random.default_rng(seed)
    st = rng.integers(0, 1 << 64, (count, 12), dtype=np.uint64)
    for i in range(min(24, count)):
        st[i, i % 12] = gl.P
        st[i, (i + 5) % 12] = (1 << 64) - 1
    digest = gl.to_u64(pg.permute(gl.from_u64(st.T.copy(), dev))[:4]).T
    width = np.array((12, 16, 17))[np.arange(count) % 3]
    ids = np.where(width == 17, 1 + (np.arange(count) // 3) % 4, 1)
    full = np.concatenate([st, digest, ids[:, None].astype(np.uint64)],
                          axis=1).tolist()
    return [row[:w] for row, w in zip(full, width.tolist())], st, ids


def tree_case(seed: int, n_keys: int, n_writes: int):
    """Seeded state-tree data: `n_keys` keys of 4 random words (one in
    1,000 with a first word at or above p) with nonzero 256-bit values;
    then `n_writes` writes over them: a third updates, a third deletes
    (value 0) and the rest fresh keys."""
    from merlin_zkevm_prover_tpu_torch.ops.goldilocks import P

    rng = np.random.default_rng(seed)

    def values(n):
        raw = rng.bytes(32 * n)
        return [int.from_bytes(raw[i:i + 32], "little") | 1
                for i in range(0, 32 * n, 32)]

    keys = rng.integers(0, 1 << 64, (n_keys, 4), dtype=np.uint64)
    keys[::1000, 0] = np.uint64(P) + keys[::1000, 0] % np.uint64(1 << 20)
    key_list = list(map(tuple, keys.tolist()))
    pairs = dict(zip(key_list, values(n_keys)))
    third = n_writes // 3
    fresh = rng.integers(0, 1 << 64, (n_writes - 2 * third, 4),
                         dtype=np.uint64)
    writes = dict(zip(key_list[:third], values(third)))
    writes.update(dict.fromkeys(key_list[third:2 * third], 0))
    writes.update(zip(map(tuple, fresh.tolist()),
                      values(n_writes - 2 * third)))
    return pairs, writes


def tree_builds(dev, permute, pairs: dict, writes: dict):
    """Smt64.build of `pairs` from the empty tree, then of `writes` over
    its root, hashing with `permute` (K1's wrapper or its plain version,
    both on the card).  Returns one line a build: the root, the nodes it
    wrote (distinct hashes, and a SHA-256 of their hashes and words in
    write order), K1's launches and device ms from CUDA events around each
    call, the host seconds of the build and of its pieces."""
    from merlin_zkevm_prover_tpu_torch.hashdb import hashdb64 as h64
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_cuda as pc

    events = []

    def timed(x):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = permute(x)
        b.record()
        events.append((a, b, x.shape[1]))
        return out

    db = h64.Database64()
    tree = h64.Smt64(db, dev)
    tree.permute = timed
    root, lines = (0, 0, 0, 0), []
    for what, batch in (("keys", pairs), ("writes", writes)):
        events.clear()
        k1_before = pc.LAUNCHES["permute"]
        torch.cuda.synchronize()
        t0 = time.time()
        root = tree.build(batch, root)
        torch.cuda.synchronize()
        host_s = time.time() - t0
        blk = db._blocks[-1]
        lines.append({"build": what, "size": len(batch),
                      "root": [str(v) for v in root], "nodes": len(blk),
                      "nodes_sha256": hashlib.sha256(
                          blk.hashes.tobytes() + blk.values.tobytes()
                      ).hexdigest(),
                      "k1_launches": pc.LAUNCHES["permute"] - k1_before,
                      "permute_calls": len(events),
                      "permutations": sum(n for _a, _b, n in events),
                      "permute_device_ms": sum(a.elapsed_time(b)
                                               for a, b, _n in events),
                      "host_s": host_s, "spans": dict(tree.spans)})
    return lines


def edge_holds(dev) -> list:
    """final_holds' holds at the kernels' edges, which take no shape from
    the path: one 2^12-row BN254 tree against the host MerkleTreeBN128,
    B2's NTT at every size 2 to 2^24 both ways, B3's affine edges through
    the MSM against python ints, B4 at its edge scalars in G1 and G2 at
    both digit widths (in G1 at FB_WINDOW against python ints too), B1's
    leaves at every last-chunk width.  Returns [kernel id, result, seconds]
    a hold.  ``python3 chip_smoke.py --edge-holds`` runs it in a second
    process while phase final builds its R1CS on the host."""
    from merlin_zkevm_prover_tpu_torch.ops import bn254_field as bf
    from merlin_zkevm_prover_tpu_torch.snark import curve as bn_curve
    from merlin_zkevm_prover_tpu_torch.tools import bn254_times as bnt

    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    out, clock = [], [time.time()]

    def keep(kernel, res):
        out.append([kernel, res, round(time.time() - clock[0], 2)])
        clock[0] = time.time()

    keep("B1", bnt.hold_tree_host(bnt.gl_rows(1 << 12, 24, gen, dev)))
    for log_n in range(1, 25):
        a = bf.to_mont(bf.FR, bnt.field_elems(bf.FR, 1 << log_n, gen, dev))
        for inverse in (False, True):
            keep("B2", bnt.hold_ntt(a, inverse))
        del a
    torch.cuda.empty_cache()
    for F_ in (bn_curve.F1, bn_curve.F2):
        keep("B3", bnt.hold_affine_edges(F_, dev))
    for F_ in (bn_curve.F1, bn_curve.F2):
        for w_ in (bn_curve.FB_WINDOW, bn_curve.FB_WINDOW_SMALL):
            keep("B4", bnt.hold_fixed_base_edges(
                F_, w_, dev, ints=F_ is bn_curve.F1 and
                w_ == bn_curve.FB_WINDOW))
    for res in bnt.hold_leaves([(130, w_) for w_ in bnt.leaf_edge_widths()],
                               gen, dev):
        keep("B1", {**res, "edge": True})
    return out


def main(kernel_holds_only: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air
    from merlin_zkevm_prover_tpu_torch.ops import cuda_build
    from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl
    from merlin_zkevm_prover_tpu_torch.ops import ntt, ntt_cuda, vm_cuda
    from merlin_zkevm_prover_tpu_torch.ops.goldilocks3 import GL3
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_cuda as pc
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_gl as pg
    from merlin_zkevm_prover_tpu_torch.ops.poseidon_constants import CAPACITY
    from merlin_zkevm_prover_tpu_torch.stark import (
        MerkleTreeGL, StarkProof, StarkProver, VerifyError, compile_air, verify)
    from merlin_zkevm_prover_tpu_torch.stark import vm
    from merlin_zkevm_prover_tpu_torch.models.wide import build_wide_air
    from merlin_zkevm_prover_tpu_torch.recursion import recursive as rec
    from merlin_zkevm_prover_tpu_torch.recursion.gates import Circuit
    from merlin_zkevm_prover_tpu_torch.recursion.plonk import circuit_to_air
    from merlin_zkevm_prover_tpu_torch.tools import poseidon_times
    from merlin_zkevm_prover_tpu_torch.tools import vm_times as vmt
    from merlin_zkevm_prover_tpu_torch.utils.timer import TimerLog
    from merlin_zkevm_prover_tpu_torch.utils.timer import device_time_ms as time_ms
    from merlin_zkevm_prover_tpu_torch.models.smoke import smoke_const_values
    from merlin_zkevm_prover_tpu_torch.ops import bn254_cuda
    from merlin_zkevm_prover_tpu_torch.ops import bn254_field as bf
    from merlin_zkevm_prover_tpu_torch.ops import poseidon_bn254_cuda as pbc
    from merlin_zkevm_prover_tpu_torch.recursion.final import FinalStage
    from merlin_zkevm_prover_tpu_torch.snark import curve as bn_curve
    from merlin_zkevm_prover_tpu_torch.snark import fft as bn_fft
    from merlin_zkevm_prover_tpu_torch.snark import msm as bn_msm
    from merlin_zkevm_prover_tpu_torch.snark.pairing import (groth16_verify,
                                                             make_vk)
    from merlin_zkevm_prover_tpu_torch.stark.prover_bn128 import (
        MerkleTreeBN128GL, StarkProverBN128, TranscriptBN128Adapter)
    from merlin_zkevm_prover_tpu_torch.tools import bn254_times as bnt
    from merlin_zkevm_prover_tpu_torch.ops import bn254_fflonk_cuda as ffk
    from merlin_zkevm_prover_tpu_torch.snark import fflonk as ffl
    from merlin_zkevm_prover_tpu_torch.snark.setup import R1CS
    from merlin_zkevm_prover_tpu_torch.tools import fflonk_times as fft_
    from merlin_zkevm_prover_tpu_torch.executor.sm import \
        poseidon_g_executor as pge
    from merlin_zkevm_prover_tpu_torch.hashdb import hashdb64 as h64
    from merlin_zkevm_prover_tpu_torch.hashdb.hashdb import HashDB

    t_start = time.time()
    root_dir = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    P, SHIFT = gl.P, gl.SHIFT
    rng = np.random.default_rng(2026)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    def rnd(*shape) -> torch.Tensor:
        """Seeded canonical field elements on the card."""
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev,
                             dtype=torch.int64)

    # the edge operands and two words in [p, 2^64), which are read modulo p
    lane_vals = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - (1 << 32), P - 1,
                          P, (1 << 64) - 1], dtype=np.uint64)

    def edge_lanes(st: torch.Tensor) -> torch.Tensor:
        """Plant the edge words at the front of every lane of a (12, B)
        state, rotated from lane to lane."""
        k = min(len(lane_vals), st.shape[1])
        for i in range(st.shape[0]):
            st[i, :k] = gl.from_u64(np.roll(lane_vals, i)[:k], dev)
        return st

    def edge_rows(x: torch.Tensor) -> torch.Tensor:
        """Plant the edge words across row j of an (H, W) matrix, rotated
        by j, for the first rows (repeated along the row on the card)."""
        reps = -(-x.shape[1] // len(lane_vals))
        for j in range(min(len(lane_vals), x.shape[0])):
            x[j] = gl.from_u64(np.roll(lane_vals, j), dev).repeat(reps)[
                :x.shape[1]]
        return x

    # the BN254 kernels' counters, by kernel (B1-B4), and their shape
    # records
    bn_counters = {"B1": (pbc.LAUNCHES,),
                   "B2": (bn254_cuda.LAUNCHES, bn_fft.LAUNCHES),
                   "B3": (bn_msm.LAUNCHES,), "B4": (bn_curve.LAUNCHES,)}
    bn_shapes = (pbc.SHAPES, bn254_cuda.SHAPES, bn_fft.SHAPES, bn_msm.SHAPES,
                 bn_curve.SHAPES)

    def zero_counters() -> None:
        for counters in (pc.LAUNCHES, pc.NODE_HASH_LAUNCHES, ntt_cuda.LAUNCHES,
                         ntt_cuda.SUB_LAUNCHES, vm_cuda.LAUNCHES, ffk.LAUNCHES,
                         pge.LAUNCHES,
                         *[c for cs in bn_counters.values() for c in cs]):
            for k in counters:
                counters[k] = 0
        for shapes in (*bn_shapes, ffk.SHAPES):
            shapes.clear()

    def read_counters() -> dict:
        return {**pc.LAUNCHES, **ntt_cuda.LAUNCHES, **ntt_cuda.SUB_LAUNCHES,
                **vm_cuda.LAUNCHES}

    def read_bn_counters() -> dict:
        return {b: {k: v for c in cs for k, v in c.items()}
                for b, cs in bn_counters.items()}

    def took_large_path(prover) -> bool:
        return None not in (prover._vm2, prover._vm3, prover._vm4) and \
            prover._step5_matrix

    def route_prover(info, const_vals, large: bool):
        """A StarkProver built with both thresholds set for the large-circuit
        path (0) or the small-circuit one (10^9), restored afterwards;
        fails unless it took that path (the VM for steps 2-4 and the matrix
        forms for step 5, or neither)."""
        env = LARGE_PATH_ENV if large else SMALL_PATH_ENV
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            prover = StarkProver(info, const_vals)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        small = (prover._vm2, prover._vm3, prover._vm4) == (None,) * 3 and \
            not prover._step5_matrix
        if not (took_large_path(prover) if large else small):
            raise AssertionError("the prover did not take the "
                                 f"{'large' if large else 'small'}-circuit "
                                 "path")
        return prover

    def same_proof(what, proof, ref) -> None:
        for field in ("roots", "evals", "fri_roots", "final_pol",
                      "queries_step0", "queries_fri", "publics"):
            if getattr(proof, field) != getattr(ref, field):
                raise AssertionError(f"{what}: field {field} differs")

    def log_launches():
        """Log every launching call of the wrappers a proof runs, with its
        arguments by name, so that the proof's launches can be timed again
        one by one at the same shapes.  The data operand is logged by its
        shape only, so that the log keeps none of the proof's matrices
        alive (the kernels' time does not depend on the values); node_hash
        by its pair count.  Returns the log and a function that puts the
        wrappers back."""
        log = {k: [] for k in ("linear_hash", "node_hash", "ntt_short",
                               "ntt_block", "ntt_block_short", "merkle",
                               "mid_gather")}
        saved = []

        def wrap(mod, name, kernel_of):
            orig = getattr(mod, name)
            sig = inspect.signature(orig)
            saved.append((mod, name, orig))

            def logged(*args, **kw):
                call = sig.bind(*args, **kw)
                call.apply_defaults()
                kernel = kernel_of(call.arguments)
                if kernel is not None:
                    log[kernel].append((orig, {
                        k: tuple(v.shape) if k in ("rows", "x", "y", "nodes")
                        else None if k == "out" else v
                        for k, v in call.arguments.items()}))
                return orig(*args, **kw)
            setattr(mod, name, logged)

        wrap(pc, "linear_hash", lambda a: "linear_hash" if min(
            a["rows"].shape[0], a["rows"].shape[1] - CAPACITY) > 0 else None)
        wrap(ntt_cuda, "ntt_short",
             lambda a: "ntt_short" if a["x"].shape[1] else None)
        def block_kind(x, log_l):
            return None if not x.shape[1] else (
                "ntt_block_short" if log_l <= ntt_cuda.SHORT_BLOCK_BITS
                else "ntt_block")
        wrap(ntt_cuda, "ntt_block", lambda a: block_kind(a["x"], a["log_l"]))
        wrap(ntt_cuda, "ntt_block_cols",
             lambda a: block_kind(a["x"], a["n1_bits"]))
        wrap(ntt_cuda, "ntt_block_gather",
             lambda a: block_kind(a["y"], a["n2_bits"]))
        wrap(ntt_cuda, "_mid_gather",          # the plain gather: CPU only
             lambda a: "mid_gather" if a["y"].is_cuda else None)
        wrap(pc, "_launch_node_hash", lambda a: "node_hash")
        wrap(pc, "_launch_merkle_top", lambda a: "node_hash")
        wrap(pc, "merkle_levels_", lambda a: "merkle" if a["nodes"].is_cuda
             else None)

        def restore():
            for mod, name, orig in saved:
                setattr(mod, name, orig)
        return log, restore

    def per_proof(calls, kernel):
        """Device time and bound of a proof's logged launches of one
        kernel, each timed again at its shape on seeded data, summed."""
        ms = bound = 0.0
        for orig, a in calls:
            a = {k: rnd(*v) if k in ("rows", "x", "y") else v
                 for k, v in a.items()}
            ms += time_ms(lambda: orig(**a), 3)
            bound += call_bound_ms(kernel, a)[0]
        return ms, bound

    # ------------------------------------------------------------------ device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        raise RuntimeError("nvidia-smi failed: " + smi.stdout)
    print(card, flush=True)
    cuda_build.lib()
    pc._lib()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kernel_build_s": cuda_build.BUILD_SECONDS,
          "source_build_s": cuda_build.SOURCE_SECONDS,
          "kernel_sources": [s.name for s in cuda_build._sources()]})

    res = cuda_build.resources(cuda_build.BUILD_LOG)
    emit({"phase": "poseidon_build", "kernels": {
        k: v for k, v in sorted(res.items()) if k.startswith("pg_")}})
    emit({"phase": "ntt_build", "kernels": {
        k: v for k, v in sorted(res.items()) if k.startswith("ntt_")}})
    emit({"phase": "bn254_build", "kernels": {
        k: v for k, v in sorted(res.items()) if k.startswith("bn_")}})

    # ----------------------------------------------------------------- kernels
    checks = []
    worst = {"permute": 0, "linear_hash": 0, "node_hash": 0, "ntt_short": 0,
             "ntt_block": 0, "ntt_block_short": 0, "vm_run": 0,
             "round_trace": 0}

    check_clock = [time.time()]

    def hold(kernel: str, what: str, got, want, **extra) -> None:
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        # the seconds since the hold before: this hold's own, data included
        checks.append({"kernel": kernel, "case": what, "max_abs_err": err,
                       **extra, "s": round(time.time() - check_clock[0], 2)})
        check_clock[0] = time.time()
        if err != 0:
            raise AssertionError(f"{kernel} {what}: kernel != plain version "
                                 f"(max abs err {err})")

    B_PERM = (1 << 23) // 31        # PoseidonG capacity at 2^23 rows: 270,600
    H = 1 << 18

    def plain_levels_(forest: list) -> list:
        """The levels of every (2h-1, 4) node array in `forest` by the plain
        pair hash, on the card: one plain call per level depth for all the
        trees together."""
        offs, ns = [0] * len(forest), [(t.shape[0] + 1) // 2 for t in forest]
        while max(ns) > 1:
            live = [i for i, n in enumerate(ns) if n > 1]
            lvls = [forest[i][offs[i]:offs[i] + ns[i]] for i in live]
            out = pc.node_hash_plain(torch.cat([v[0::2] for v in lvls]),
                                     torch.cat([v[1::2] for v in lvls]))
            for i, part in zip(live, out.split([ns[i] // 2 for i in live])):
                forest[i][offs[i] + ns[i]:offs[i] + ns[i] + ns[i] // 2] = part
                offs[i] += ns[i]
                ns[i] //= 2
        return forest

    def tw(log_l, inverse):
        return ntt_cuda._dev(dev, ntt_cuda._stage_tables_np, log_l, inverse)

    def ntt_kind(log_l):
        return ("ntt_block_short" if log_l <= ntt_cuda.SHORT_BLOCK_BITS
                else "ntt_block")

    air17, trace17 = build_smoke_air(n_bits=17, seed=42)
    info17 = compile_air(air17, n_queries=32)
    vm_progs = vm_programs(vm, info17)

    def vm_case(step, progs=vm_progs, info_=info17):
        """The step program, its row count, its sections and its other
        run_program arguments, seeded."""
        prog = progs[step]
        n = info_.n if step < 4 else info_.n_ext
        secs = {}
        for name in prog.sections:
            w = info_.n_constants if name == "const" else \
                info_.section_widths[name.replace("_2ns", "_n")]
            secs[name] = edge_rows(rnd(n, w + 5))[:, 2:2 + w]
        kw = dict(challenges=GL3(rnd(8), rnd(8), rnd(8)),
                  publics=rnd(info_.n_publics), x=rnd(n), zi=rnd(n),
                  roll_k=1 if step < 4 else 1 << info_.blowup_bits)
        return prog, n, secs, kw

    def vm_args(step):
        """vm_run's arguments for the step program, seeded (vm_case)."""
        prog, n, secs, kw = vm_case(step)
        return (*vm._launch_inputs(prog, secs, n, kw["challenges"],
                                   kw["publics"], kw["x"], kw["zi"], None,
                                   None, None),
                list(prog.out_regs.values()), prog.n_regs, n, kw["roll_k"])

    rand_code = vmt.random_program(np.random.default_rng(2027), 6000, 32,
                                   (7, 2, 27, 6), 64)

    def random_case():
        """vm_run's arguments for `rand_code` at 2^18 rows, seeded."""
        n = 1 << 18
        secs = [edge_rows(rnd(n, w + 3))[:, 1:1 + w] for w in (7, 2, 27, 6)]
        return (rand_code, rnd(64, 3), secs, [(0, GL3(rnd(n), rnd(n), rnd(n)))],
                list(range(32)), 32, n, 4)

    def vm_more_cases():
        """The wide program (with its compiled program), the spill program
        and the ragged one: vm_run's arguments, seeded."""
        data = vmt.Data(dev, 2030)
        wide = vmt.step4_case(build_wide_air(n_bits=17, device=dev)[0], data)
        spill = vmt.random_case(data, 2000, 400, 1 << 16, 3, 2028)
        ragged = vmt.random_case(data, 1000, 24, (1 << 16) + 5, 37, 2029)
        return wide, spill, ragged

    def kernel_holds() -> dict:
        """K1-K6 and vm_run against their plain versions, exactly, at the
        edge shapes of phase kernels (this file's docstring); returns the
        VM plans of the wide, spill and ragged programs.
        ``python3 chip_smoke.py --kernel-holds`` runs it in a second
        process while phase final builds its R1CS on the host."""
        # K1: 1 and 127 leave a block partly idle, 128 fills one exactly
        for b in (1, 127, 128, B_PERM):
            st = edge_lanes(rnd(12, b))
            hold("permute", f"(12, {b})", pc.permute(st), pc.permute_plain(st))
        hold("permute", "(12,)", pc.permute(st[:, 5].clone()),
             pc.permute_plain(st[:, 5].clone()))

        # K2: the edge words, two of them in [p, 2^64), in every column of the
        # first rows, so that every chunk and the capacity carried between
        # chunks see them
        for w in (5, 8, 9, 21, 64):
            x = edge_rows(rnd(H, w))
            hold("linear_hash", f"({H}, {w})", pc.linear_hash(x),
                 pc.linear_hash_plain(x))
        x665 = edge_rows(rnd(H, 665))
        lh665 = pc.linear_hash(x665)
        hold("linear_hash", f"({H}, 665), plain on the first 4096 rows",
             lh665[:4096], pc.linear_hash_plain(x665[:4096]))
        del lh665
        # K3: every boundary of the dispatch, through the wrapper and through
        # each one-level kernel, edge words in every lane of both operands
        bounds = sorted({1, 2, 3, 1 << 17} | {
            t + d for t in (pc.TOP_MAX_PAIRS, pc.GROUP_MAX_PAIRS) for d in (-1, 0, 1)})
        for n in bounds:
            l = edge_lanes(rnd(4, n)).T.contiguous()
            r = edge_lanes(rnd(4, n)).flip(1).T.contiguous()
            want = pc.node_hash_plain(l, r)
            hold("node_hash", f"n = {n} ({pc._node_kernel(n)})", pc.node_hash(l, r), want)
            for kind in ("pair", "group"):
                out = torch.empty_like(want)
                pc._launch_node_hash(kind, l.data_ptr(), r.data_ptr(), 4,
                                     out.data_ptr(), n, dev)
                hold("node_hash", f"n = {n}, {kind} kernel", out, want)

        forest = []
        for k in range(1, 19):
            h = 1 << k
            nodes = torch.zeros((2 * h - 1, 4), dtype=torch.int64, device=dev)
            nodes[:h] = edge_lanes(rnd(4, h)).T
            forest.append(nodes)
        got = [pc.merkle_levels_(t.clone(), (t.shape[0] + 1) // 2) for t in forest]
        for k, g, want in zip(range(1, 19), got, plain_levels_(forest)):
            hold("node_hash", f"merkle levels, h = 2^{k}, edge words in every lane "
                 f"({len(pc._level_plan(1 << k))} launches)", g, want)
        del forest, got
        src = rnd(1 << 10, 9)
        hold("node_hash", "merkelize (1024, 9)", pc.merkelize(src),
             pc.merkelize(src.cpu()).to(dev))

        # the block transform at every length 2 .. 512 (2, 4 and 8: K6's
        # register form; 16: one thread per column; 32 .. 512: register passes
        # over the tile), each flag combination, the edge words (p and 2^64 - 1
        # among them) across the first rows and a one-hot column
        for log_l in range(1, ntt_cuda.MAX_KERNEL_BITS + 1):
            l, b = 1 << log_l, 1000      # b: not a multiple of any tile width
            x = edge_rows(rnd(l, b))
            x[:, 1] = 0
            x[1 % l, 1] = 1              # one-hot column
            u, v = rnd(l), rnd(b)
            for name, kw in (
                    ("dif, inverse", dict(dif=True, inverse=True)),
                    ("dif, zero_top", dict(dif=True, zero_top=True)),
                    ("dif, u v const_scale", dict(dif=True, u=u, v=v,
                                                  const_scale=3, inverse=True)),
                    ("dit, sep_scale", dict(dif=False, u=u, v=v, inverse=True)),
                    ("dit, const_scale", dict(dif=False, const_scale=pow(l, P - 2, P),
                                              inverse=True)),
                    ("dit, zero_top", dict(dif=False, zero_top=True)),
                    ("dit, canon", dict(dif=False))):
                kw = dict(kw)
                t = tw(log_l, kw.pop("inverse", False))
                xin = x[: l // 2] if kw.get("zero_top") else x
                hold(ntt_kind(log_l), f"L = {l}, {name}",
                     ntt_cuda.ntt_block(xin, t, log_l, **kw),
                     ntt_cuda.ntt_block_plain(xin, t, log_l, **kw))
            xs = x[:, 3:997]             # a column slice, read in place
            hold(ntt_kind(log_l), f"L = {l}, dif, column slice",
                 ntt_cuda.ntt_block(xs, tw(log_l, False), log_l, True),
                 ntt_cuda.ntt_block_plain(xs, tw(log_l, False), log_l, True))
        for log_l, b in ((2, (1 << 16) * 3), (5, 1000)):
            x = edge_rows(rnd(1 << log_l, b))
            hold("ntt_short", f"L = {1 << log_l}, B = {b}",
                 ntt_cuda.ntt_short(x, tw(log_l, True), log_l),
                 ntt_cuda.ntt_short_plain(x, tw(log_l, True), log_l))

        # the pipeline's kernels at every size it serves, at the widths the
        # proof gives them (1 and 3: the GL3 transforms; 25: the commit's last
        # block; 64: a full block): kernel A reading a column slice in place
        # (with and without zero_top), kernel B reading kernel A's output
        # through the mid gather, with the INTT's u[k2] v[k1] scale, and
        # writing into a column slice with a constant scale
        for nb in range(ntt_cuda.PIPELINE_MIN_BITS, ntt_cuda.PIPELINE_MAX_BITS + 1):
            n1_bits, n2_bits = ntt_cuda._split(nb)
            key = (nb, n1_bits, SHIFT, True)
            su = ntt_cuda._dev(dev, ntt_cuda._sep_scale_np, *key, pick=0)
            sv = ntt_cuda._dev(dev, ntt_cuda._sep_scale_np, *key, pick=1)
            for c in (1, 3, 25, 64):
                wide = edge_rows(rnd(1 << nb, c + 7))
                xa = wide[:, 3:3 + c]
                for zt in (False, True):
                    xin = xa[: (1 << nb) // 2] if zt else xa
                    hold(ntt_kind(n1_bits), f"kernel A n_bits = {nb}, c = {c}, "
                         f"column slice{', zero_top' if zt else ''}",
                         ntt_cuda.ntt_block_cols(xin, n1_bits, n2_bits, not zt, zt),
                         ntt_cuda.ntt_block_cols_plain(xin, n1_bits, n2_bits,
                                                       not zt, zt))
                y = edge_rows(rnd(1 << n1_bits, c << n2_bits))
                y[:, 1] = 0
                y[0, 1] = 1              # one-hot column of kernel A's output
                hold("ntt_block", f"gather B n_bits = {nb}, c = {c}, inverse, u v",
                     ntt_cuda.ntt_block_gather(y, n1_bits, n2_bits, c, True,
                                               u=su, v=sv),
                     ntt_cuda.ntt_block_gather_plain(y, n1_bits, n2_bits, c, True,
                                                     u=su, v=sv))
                wide.zero_()
                got = ntt_cuda.ntt_block_gather(y, n1_bits, n2_bits, c, False,
                                                const_scale=12345,
                                                out=wide[:, 3:3 + c])
                hold("ntt_block", f"gather B n_bits = {nb}, c = {c}, into a "
                     "column slice", got, ntt_cuda.ntt_block_gather_plain(
                         y, n1_bits, n2_bits, c, False, const_scale=12345))
                if bool(wide[:, :3].any()) or bool(wide[:, 3 + c:].any()):
                    raise AssertionError(f"gather B n_bits = {nb}, c = {c} wrote "
                                         "outside its column slice")
        del wide, xa, y, got
        for nb, w in ((10, 67), (12, 130), (14, 131)):
            x = edge_rows(rnd(1 << nb, w))
            hold(ntt_kind(ntt_cuda._split(nb + 1)[0]),
                 f"extend_pol_blocked ({1 << nb}, {w}) -> 2^{nb + 1}",
                 ntt.extend_pol_blocked(x, nb, nb + 1),
                 ntt.extend_pol_plain(x, nb, nb + 1))

        def lagrange0(n, xx):
            return (pow(xx, n, P) - 1) * pow(n * (xx - 1) % P, P - 2, P) % P

        for nb in (6, 11, 13, 15, 17):
            n = 1 << nb
            x = rnd(n, 8)
            x[:, 0] = 0
            x[0, 0] = 1                  # one-hot: INTT is 1/N everywhere
            x[:, 1] = 0
            x[0, 1] = 7                  # impulse: NTT is 7 everywhere
            kernel = ("ntt_short" if not ntt_cuda.pipeline_ok(nb)
                      else "ntt_block_short" if nb < 13 else "ntt_block")
            f, i_, e = ntt.ntt(x), ntt.intt(x), ntt.extend_pol(x, nb, nb + 1)
            hold(kernel, f"ntt n_bits = {nb}", f, ntt.ntt_plain(x))
            hold(kernel, f"intt n_bits = {nb}", i_, ntt.intt_plain(x))
            hold(kernel, f"extend_pol n_bits = {nb}", e,
                 ntt.extend_pol_plain(x, nb, nb + 1))
            if not bool((i_[:, 0] == gl.const(pow(n, P - 2, P), device=dev)).all()):
                raise AssertionError(f"one-hot INTT probe failed at n_bits {nb}")
            if not bool((f[:, 1] == 7).all()):
                raise AssertionError(f"impulse NTT probe failed at n_bits {nb}")
            col = gl.to_u64(e[:, 0])
            for j in (0, 1, 3, 191, 192, 193, 2 * n - 1):
                j %= 2 * n
                if int(col[j]) != lagrange0(n, SHIFT * pow(gl.w(nb + 1), j, P) % P):
                    raise AssertionError(f"Lagrange probe failed, n_bits {nb} row {j}")
        # above the pipeline's sizes: the four-step recursion over ntt_short
        # (2^19 = 1024 x 512, the 1024 again 2 x 512), one column
        x = rnd(1 << 19, 1)
        hold("ntt_short", "ntt n_bits = 19", ntt.ntt(x), ntt.ntt_plain(x))
        hold("ntt_short", "intt n_bits = 19", ntt.intt(x), ntt.intt_plain(x))
        x = rnd(1 << 18, 1)
        hold("ntt_short", "extend_pol n_bits = 18 -> 19", ntt.extend_pol(x, 18, 19),
             ntt.extend_pol_plain(x, 18, 19))
        # the recursion stages' LDEs (2^19 .. 2^21 rows) on the same route, on a
        # block of EXTEND_BLOCK_COLS columns as extend_pol_blocked feeds it, the
        # edge words across the first rows, and the probes in columns 0 and 1
        for nb in (19, 20, 21):
            n = 1 << nb
            x = edge_rows(rnd(n, ntt.EXTEND_BLOCK_COLS))
            x[:, 0] = 0
            x[0, 0] = 1                  # one-hot
            x[:, 1] = 0
            x[0, 1] = 7                  # impulse
            if nb >= 20:
                f, i_ = ntt.ntt(x), ntt.intt(x)
                hold("ntt_short", f"ntt n_bits = {nb}, {x.shape[1]} columns", f,
                     ntt.ntt_plain(x))
                hold("ntt_short", f"intt n_bits = {nb}, {x.shape[1]} columns", i_,
                     ntt.intt_plain(x))
                if not bool((i_[:, 0] == gl.const(pow(n, P - 2, P), device=dev)).all()):
                    raise AssertionError(f"one-hot INTT probe failed at n_bits {nb}")
                if not bool((f[:, 1] == 7).all()):
                    raise AssertionError(f"impulse NTT probe failed at n_bits {nb}")
            if nb < 21:
                e = ntt.extend_pol_blocked(x, nb, nb + 1)
                hold("ntt_short", f"extend_pol_blocked n_bits = {nb} -> {nb + 1}, "
                     f"{x.shape[1]} columns", e, ntt.extend_pol_plain(x, nb, nb + 1))
                col = gl.to_u64(e[:, 0])
                for j in (0, 1, 3, 191, 192, 193, 2 * n - 1):
                    if int(col[j]) != lagrange0(n, SHIFT * pow(gl.w(nb + 1), j, P) % P):
                        raise AssertionError(f"Lagrange probe failed, n_bits {nb} "
                                             f"row {j}")
        # the VM interpreter: the smoke circuit's three step programs at the
        # n_bits = 17 proof's domains (2^17 rows for steps 2 and 3, 2^18 for step
        # 4, whose loads rotate by 2^blowup_bits rows and wrap at the end), the
        # sections column slices of wider matrices with the edge words, p and
        # 2^64 - 1 among them, across their first rows
        for step in sorted(vm_progs):
            prog, n, secs, kw = vm_case(step)
            got = vm.run_program(prog, info17, secs, n, **kw)
            want = vm.run_program_plain(prog, info17, secs, n, **kw)
            for dest in prog.out_regs:
                hold("vm_run", f"step {step} program ({len(prog.code)} "
                     f"instructions, {prog.n_regs} registers, n = {n}), dest "
                     f"{dest}", torch.stack(got[dest]), torch.stack(want[dest]))
        del got, want, secs, kw
        # a seeded random program of the length the default threshold sends to
        # the VM (the step-4 program of tests/test_torch_stark_large.py's wide
        # circuit has 6,350 instructions over 31 registers), at 2^18 rows
        rand_args = random_case()
        for j, (g, w_) in enumerate(zip(vm_cuda.vm_run(*rand_args),
                                        vm_cuda.vm_run_plain(*rand_args))):
            hold("vm_run", f"random program (6000 instructions, 32 registers, "
                 f"n = {1 << 18}), register {j}", g, w_)
        del g, w_, rand_args
        # destinations that alias operands (the compiler never emits them)
        n = 1 << 17
        alias_sec = edge_rows(rnd(n, 6))[:, 1:]
        alias_code = np.array([
            (vm.LOAD, 0, (1 << 2) | 3, 0), (vm.LOADR, 0, (3 << 2) | 1, 1),
            (vm.ADD, 0, 1, 0), (vm.MUL, 1, 0, 0), (vm.SUB, 0, 2, 2),
            (vm.MULC, 2, 1, 2), (vm.ADDC, 2, 0, 3), (vm.SUBC, 3, 2, 3),
            (vm.CSUBC, 3, 1, 3), (vm.NEG, 3, 0, 3), (vm.LOADC, 2, 0, 1),
            (vm.MUL, 3, 3, 3), (vm.ADD, 3, 1, 1)], dtype=np.int32)
        alias = (alias_code, rnd(3, 3), [alias_sec],
                 [(2, GL3(rnd(n), rnd(n), rnd(n)))], [0, 1, 2, 3], 4, n, 3)
        for j, (g, w_) in enumerate(zip(vm_cuda.vm_run(*alias),
                                        vm_cuda.vm_run_plain(*alias))):
            hold("vm_run", f"aliasing program, n = {n}, register {j}", g, w_)
        # the wide circuit's step-4 program (its code depends on n_bits: the
        # proof's, 17) at 2^18 rows, 190 columns of cm1_2ns read as a column
        # slice with the edge words across the first rows; a program with more
        # registers than a block's shared memory holds (the spilled registers
        # run on the card, through FILL and SPILL); n not a multiple of the
        # block's rows, LOADR wrapping across the last block
        (wide_args, wide_prog), spill_args, ragged_args = vm_more_cases()
        vm_plans = {}
        for what, args_ in (("wide program", wide_args),
                            ("spill program", spill_args),
                            ("ragged program", ragged_args)):
            vm_plans[what] = vm_cuda._vm_fields(*args_)["plan"]
            for j, (g, w_) in enumerate(zip(vm_cuda.vm_run(*args_),
                                            vm_cuda.vm_run_plain(*args_))):
                hold("vm_run", f"{what} ({len(args_[0])} instructions, "
                     f"{args_[5]} registers, n = {args_[6]}), output {j}", g, w_)
        if vm_plans["spill program"]["slots_on"] >= vm_plans["spill program"]["words"]:
            raise AssertionError("the spill program's registers all fit on chip")
        if args_[6] % vm_plans["ragged program"]["rows"] == 0:
            raise AssertionError("the ragged program's n is a multiple of a "
                                 "block's rows")
        return vm_plans

    if kernel_holds_only:
        plans = kernel_holds()
        # phase state's tree builds again on K1's plain version
        tree_plain = tree_builds(dev, pc.permute_plain, *tree_case(
            2031, 1 << TREE_KEYS_BITS, TREE_WRITES))
        print(json.dumps({"cases": checks, "worst": worst, "vm_plans": plans,
                          "state_tree_plain": tree_plain}), flush=True)
        return 0
    # K2 at (2^18, 665) timed on the card alone (its hold is kernel_holds')
    x665 = edge_rows(rnd(H, 665))
    ms_lh665 = time_ms(lambda: pc.linear_hash(x665), 5)
    lh665_bound_ms = call_bound_ms("linear_hash", {"rows": x665})[0]
    del x665
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- permute
    perm_state = edge_lanes(rnd(12, B_PERM))
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    perm_out = pg.permute(perm_state)
    torch.cuda.synchronize()
    t_perm = time.time() - t0
    perm_launches = read_counters()
    if perm_launches["permute"] != 1:
        raise AssertionError(f"permute path: {perm_launches}")
    cols = sorted({0, 1, 7, 8, 127, 128, B_PERM - 1}
                  | {int(i) for i in rng.integers(0, B_PERM, 9)})
    got_cols = gl.to_u64(perm_out[:, cols])
    ins = gl.to_u64(perm_state[:, cols])
    for j in range(len(cols)):
        if [int(v) for v in got_cols[:, j]] != pg.permute_host(
                [int(v) for v in ins[:, j]]):
            raise AssertionError(f"permute path: column {cols[j]} differs "
                                 "from the python-int permutation")
    emit({"phase": "permute", "shape": [12, B_PERM], "host_clock_ms": t_perm * 1e3,
          "columns_checked": len(cols), "launches": perm_launches})
    del perm_out

    # ------------------------------------------------------------------- state
    # (a) the PoseidonG state machine at 2^23 rows through its entry point:
    # S1 once, its 19 columns held against the plain version on the card and
    # its first and last 64 slots and dead rows against python ints
    t_state = time.time()
    n_pg = 1 << PG_ROWS_BITS
    slots = n_pg // pge.SLOT_ROWS
    pg_in, pg_states, pg_ids = pg_inputs(2030, PG_INPUTS, dev)
    pg_ex = pge.PoseidonGExecutor()
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    pg_cols = pg_ex.execute(pg_in, n_pg)
    torch.cuda.synchronize()
    pg_clock = time.time() - t0
    pg_launches = dict(pge.LAUNCHES)
    if pg_launches["round_trace"] != 1 or read_counters()["permute"]:
        raise AssertionError(f"state: PoseidonG launches {pg_launches}")
    st_dev = torch.zeros((12, slots), dtype=torch.int64, device=dev)
    st_dev[:, :PG_INPUTS] = gl.from_u64((pg_states % np.uint64(P)).T.copy(),
                                        dev)
    check_clock[0] = time.time()
    pg_trace = torch.stack([pg_cols[c] for c in pge.PoseidonGExecutor.COLUMNS[
        :pge.TRACE_COLS]])
    hold("round_trace", f"path ({n_pg} rows, {slots} slots)", pg_trace,
         pge.round_trace_plain(st_dev, n_pg))
    del pg_trace
    for pid in (1, 2, 3):
        want = torch.zeros(n_pg, dtype=torch.int64, device=dev)
        want[torch.from_numpy(np.flatnonzero(pg_ids == pid) *
                              pge.SLOT_ROWS).to(dev)] = 1
        hold("round_trace", f"path result{pid}", pg_cols[f"result{pid}"], want)
    # the raw words (p and 2^64 - 1 unreduced) through S1 and its plain
    raw = gl.from_u64(pg_states[:4096].T.copy(), dev)
    hold("round_trace", "raw words, 4096 slots, 127,000 rows",
         pge.round_trace(raw, 127_000), pge.round_trace_plain(raw, 127_000))
    del raw
    # S1 at the edges of its geometry (poseidon_times.s1_edge_cases): G
    # slots a block at the main path's run, S = 1, G - 1, G, G + 1, 2G + 1;
    # n = 31 S, 31 S + 1 and an odd n past a line; the library's own plan
    # and the main path's run
    for what, got_, want_ in poseidon_times.s1_edge_cases(dev, slots):
        hold("round_trace", what, got_, want_)
    del got_, want_
    pg_plan = pge.trace_plan(slots, dev)
    ends = list(range(64)) + list(range(slots - 64, slots))
    rows = np.array([k * pge.SLOT_ROWS + r for k in ends
                     for r in range(pge.SLOT_ROWS)])
    rows_dev = torch.from_numpy(rows).to(dev)
    got = {c: gl.to_u64(v[rows_dev]) for c, v in pg_cols.items()}
    for i, k in enumerate(ends):
        st = [int(v) % P for v in pg_states[k]] if k < PG_INPUTS else [0] * 12
        trace_rows = [st]
        for r in range(pge.SLOT_ROWS - 1):
            trace_rows.append(pge._round(trace_rows[-1], r))
        for r in range(pge.SLOT_ROWS):
            j = i * pge.SLOT_ROWS + r
            row = [int(got[c][j]) for c in pge.PoseidonGExecutor.COLUMNS]
            flags = [int(r == 0 and k < PG_INPUTS and pg_ids[k] == pid)
                     for pid in (1, 2, 3)]
            if row != trace_rows[r] + trace_rows[-1][:4] + flags:
                raise AssertionError(f"state: PoseidonG slot {k} row {r} "
                                     "differs from the python-int rounds")
    dead = sum(int(v[slots * pge.SLOT_ROWS:].count_nonzero())
               for v in pg_cols.values())
    if dead:
        raise AssertionError(f"state: {dead} nonzero words in the dead rows")
    del pg_cols
    bad_in = list(pg_in)
    bad_in[4] = bad_in[4][:12] + [bad_in[4][12] ^ 1] + bad_in[4][13:]
    try:
        pg_ex.execute(bad_in, n_pg)
    except ValueError:
        pass
    else:
        raise AssertionError("state: a changed digest did not raise")
    del bad_in
    s1_ms = time_ms(lambda: pge.round_trace(st_dev, n_pg), 7)
    s1_plain_ms = time_ms(lambda: pge.round_trace_plain(st_dev, n_pg), 2)
    s1_bound = bound_ms(pge.TRACE_COLS * n_pg * 8 + 12 * slots * 8, 0,
                        slots * PERM_IMAD32)
    del st_dev
    torch.cuda.empty_cache()
    pg_line = {"n": n_pg, "inputs": PG_INPUTS, "slots": slots,
               "execute_host_ms": pg_clock * 1e3, "launches": pg_launches,
               "s1_ms": s1_ms, "s1_bound_ms": s1_bound[0],
               "s1_bound_by": s1_bound[1], "s1_plain_ms": s1_plain_ms,
               "python_int_slots": len(ends), "plan": pg_plan,
               "dead_rows": n_pg - slots * pge.SLOT_ROWS,
               "changed_digest_raised": True}
    s1_entry = {
        "name": "round_trace", "route": "cuda",
        "source": "merlin_zkevm_prover_tpu_torch/csrc/poseidon_gl.cu",
        "replaces": "merlin_zkevm_prover_tpu/executor/sm/"
                    "poseidon_g_executor.py:25, 55-76 (python ints)",
        "shape": [12, slots], "rows": n_pg, "launches": pg_launches[
            "round_trace"], "max_abs_err": worst["round_trace"],
        "ms": s1_ms, "plain_ms": s1_plain_ms, "bound_ms": s1_bound[0],
        "bound_by": s1_bound[1], "library_ms": None,
        "path": "executor.sm.poseidon_g_executor.PoseidonGExecutor.execute",
        "execute_host_ms": pg_clock * 1e3}

    # (b) the state tree: Smt64.build of 2^20 keys, then 4,096 writes over
    # its root, on K1; the same builds on K1's plain version (on the card,
    # in the kernel-holds process, while phase final builds its R1CS) must
    # give the same roots and nodes (held at kernels_check)
    zero_counters()
    tree_k1 = tree_builds(dev, pc.permute, *tree_case(
        2031, 1 << TREE_KEYS_BITS, TREE_WRITES))
    for b in tree_k1:
        if b["k1_launches"] != b["permute_calls"] or b["k1_launches"] < 3:
            raise AssertionError(f"state: tree build {b}")
    if read_counters()["permute"] != sum(b["k1_launches"] for b in tree_k1):
        raise AssertionError("state: K1 launched outside the builds")
    # (c) 2^12 keys: the root of the binary SMT's sequential sets (host)
    small, _ = tree_case(2032, 1 << SMT_KEYS_BITS, 0)
    t0 = time.time()
    hdb, smt_root = HashDB(), (0, 0, 0, 0)
    for k, v in small.items():
        smt_root = hdb.set("b", 0, smt_root, k, v).new_root
    smt_s = time.time() - t0
    hdb.close()
    k1_before = pc.LAUNCHES["permute"]
    small_root = h64.Smt64(h64.Database64()).build(small)
    if small_root != tuple(smt_root):
        raise AssertionError("state: Smt64 root != the binary SMT's root")
    tree_line = {"keys": 1 << TREE_KEYS_BITS, "writes": TREE_WRITES,
                 "k1": tree_k1,
                 "binary_smt": {"keys": len(small), "equal_roots": True,
                                "sets_host_s": smt_s,
                                "k1_launches": pc.LAUNCHES["permute"] -
                                k1_before}}
    emit({"phase": "state", "poseidon_g": pg_line, "tree": tree_line,
          "seconds": time.time() - t_state})

    # ------------------------------------------------------------------ golden
    golden_out = []
    golden_launches = {}
    for nb in (5, 10, 11, 13):
        with open(os.path.join(root_dir, "tests", "data",
                               f"torch_smoke_proof_nbits{nb}.json")) as fh:
            golden = json.load(fh)
        air, trace = build_smoke_air(n_bits=nb, seed=golden["seed"])
        info = compile_air(air, **golden["compile_air"])
        torch.cuda.synchronize()
        log, restore = log_launches()
        zero_counters()
        prover = StarkProver(info, np.stack(air.const_values, axis=1))
        proof = prover.prove(trace)
        torch.cuda.synchronize()
        golden_launches[nb] = read_counters()
        restore()
        if nb in (10, 11) and golden_launches[nb]["ntt_block_short"] <= 0:
            raise AssertionError(f"golden n_bits {nb}: no block NTT below "
                                 "length 16 was launched")
        ref = StarkProof.from_json(json.dumps(golden["proof"]))
        if prover.const_tree.root() != golden["const_root"]:
            raise AssertionError(f"golden n_bits {nb}: const root differs")
        same_proof(f"golden n_bits {nb}", proof, ref)
        verify(info, prover.const_tree.root(), proof)
        golden_out.append({"n_bits": nb, "equal": True, "verified": True,
                           "section_widths": info.section_widths,
                           "fri_step_bits": info.fri_step_bits,
                           "launches": golden_launches[nb]})
        if golden_launches[nb]["vm_run"] != 3 or not took_large_path(prover):
            raise AssertionError(f"golden n_bits {nb}: the default route on "
                                 "the card is not the large-circuit path")
        if nb == 13:
            # the small-circuit path: the same golden proof
            torch.cuda.synchronize()
            zero_counters()
            prover = route_prover(info, np.stack(air.const_values, axis=1),
                                  large=False)
            proof = prover.prove(trace)
            torch.cuda.synchronize()
            small_launches = read_counters()
            if small_launches["vm_run"] != 0:
                raise AssertionError("golden n_bits 13, small path: "
                                     f"{small_launches['vm_run']} VM launches")
            same_proof("golden n_bits 13, small path", proof, ref)
            verify(info, prover.const_tree.root(), proof)
            golden_out.append({"n_bits": nb, "path": "small (tree evaluator, "
                               "step 5 per entry)", "equal": True,
                               "verified": True, "launches": small_launches})
        if nb == 11:
            info11 = info
            k6_proof = per_proof(log["ntt_block_short"], "ntt_block_short")
        del log
    emit({"phase": "golden", "proofs": golden_out})

    def lde_block_split(blk: torch.Tensor, nb: int, pipeline: bool = True) -> dict:
        """One 64-column block of the LDE, read from and written into wide
        matrices as extend_pol_blocked does: every device kernel it runs
        (torch.profiler), which on the pipeline's sizes must be the four
        block kernels and nothing else, and its device time (CUDA events,
        the card kept busy ahead of it) beside theirs.  Above them
        (`pipeline` off) the block kernels are K4's launches and the other
        kernels the four-step recursion's plain PyTorch glue."""
        from torch.profiler import ProfilerActivity, profile

        out = torch.empty((1 << (nb + 1), blk.shape[1] + 3), dtype=torch.int64,
                          device=dev)[:, 1:1 + blk.shape[1]]

        def one_block():
            ntt_cuda.extend_pol_device(blk, nb, nb + 1, out=out)
        one_block()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_block()
            torch.cuda.synchronize()
        kernels = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            kernels.append({"name": ev.key, "count": ev.count,
                            "device_ms": us / 1e3})
        n_kernels = sum(k["count"] for k in kernels)
        foreign = [k["name"] for k in kernels
                   if not k["name"].startswith(("void ntt_tile_kernel",
                                                "void ntt_reg_kernel"))]
        if pipeline and (n_kernels != 4 or foreign):
            raise AssertionError(f"one LDE block ran {n_kernels} device "
                                 f"kernels, not the four block kernels: "
                                 f"{kernels}")
        kernels_ms = sum(k["device_ms"] for k in kernels
                         if k["name"] not in foreign)
        glue_ms = sum(k["device_ms"] for k in kernels if k["name"] in foreign)
        block_ms = time_ms(one_block, 7)
        return {"shape": [1 << nb, blk.shape[1]], "kernels": kernels,
                "device_kernels": n_kernels, "kernels_ms": kernels_ms,
                "other_kernels_ms": glue_ms, "block_ms": block_ms,
                "between_kernels_ms": block_ms - kernels_ms - glue_ms}

    # ------------------------------------------------------------------ commit
    NB, W = 17, 665
    before = dict(pc.LAUNCHES), dict(ntt_cuda.LAUNCHES)
    mat = rnd(1 << NB, W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    lde = ntt.extend_pol_blocked(mat, NB, NB + 1)
    torch.cuda.synchronize()
    t_lde = time.time() - t0
    t0 = time.time()
    tree = MerkleTreeGL(lde)
    tree.merkelize()
    torch.cuda.synchronize()
    t_merkle = time.time() - t0
    # every block of the LDE (each read from and written into its columns
    # of the wide matrices in place) against the plain whole-length LDE
    for i in range(0, W, ntt.EXTEND_BLOCK_COLS):
        blk = slice(i, min(W, i + ntt.EXTEND_BLOCK_COLS))
        hold("ntt_block", f"commit LDE ({1 << NB}, {W}), columns "
             f"{blk.start}..{blk.stop - 1}", lde[:, blk],
             ntt.extend_pol_plain(mat[:, blk].contiguous(), NB, NB + 1))
    root = tree.root()
    idxs = [int(i) for i in rng.integers(0, 1 << (NB + 1), 16)]
    for (row, sib), idx in zip(tree.get_group_proofs(idxs), idxs):
        if not MerkleTreeGL.verify_proof(root, idx, row, sib):
            raise AssertionError(f"commit: opening {idx} does not verify")
    felts = (1 << NB) * W
    block_split = lde_block_split(mat[:, 64:128], NB)
    emit({"phase": "commit", "shape": [1 << NB, W], "lde_ms": t_lde * 1e3,
          "merkle_ms": t_merkle * 1e3,
          "felts_per_s": felts / (t_lde + t_merkle),
          "openings_verified": len(idxs),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": {k: pc.LAUNCHES[k] - before[0][k] for k in pc.LAUNCHES}
          | {k: ntt_cuda.LAUNCHES[k] - before[1][k] for k in ntt_cuda.LAUNCHES}})
    emit({"phase": "lde_block_split", **block_split})
    del mat, lde, tree
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------- prove
    air, trace, info = air17, trace17, info17
    const_vals = np.stack(air.const_values, axis=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log, restore = log_launches()
    zero_counters()
    t0 = time.time()
    prover = StarkProver(info, const_vals)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    tlog = TimerLog("chip_smoke", quiet=True)
    t0 = time.time()
    proof = prover.prove(trace, timer=tlog)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    launches = read_counters()
    node_variants = dict(pc.NODE_HASH_LAUNCHES)
    restore()
    peak = torch.cuda.max_memory_allocated()
    if log["mid_gather"] or launches["ntt_block_gather"] <= 0:
        raise AssertionError("the proof's transforms did not all take kernel "
                             "B's fused gather")
    if launches["vm_run"] != 3 or not took_large_path(prover):
        raise AssertionError("the main path did not take the large-circuit "
                             "path, the card's default")
    for k in ("linear_hash", "node_hash", "ntt_short", "ntt_block"):
        if launches[k] <= 0:
            raise AssertionError(f"main path never launched kernel {k}")
        if len(log[k]) != launches[k]:
            raise AssertionError(f"{k}: {len(log[k])} of {launches[k]} "
                                 "launches logged")
    tree_heights = [a["h"] for _, a in log["merkle"]]
    if sum(len(pc._level_plan(h)) for h in tree_heights) != launches["node_hash"]:
        raise AssertionError("node_hash launches outside the proof's trees")
    node_launches = [("top", a["n"]) if "kind" not in a else (a["kind"], a["n"])
                     for _, a in log["node_hash"]]
    proof_times = {k: per_proof(log[k], k)
                   for k in ("linear_hash", "ntt_short", "ntt_block")}
    del log
    t0 = time.time()
    verify(info, prover.const_tree.root(), proof)
    t_verify = time.time() - t0
    bad = StarkProof.from_json(proof.to_json())
    bad.publics[0] = (bad.publics[0] + 1) % P
    try:
        verify(info, prover.const_tree.root(), bad)
    except VerifyError:
        pass
    else:
        raise AssertionError("a proof with a changed public was accepted")
    emit({"phase": "prove", "circuit": "smoke", "n_bits": info.n_bits,
          "n_bits_ext": info.n_bits_ext, "fri_step_bits": info.fri_step_bits,
          "n_queries": info.n_queries, "section_widths": info.section_widths,
          "setup_s": t_setup, "prove_s": t_prove, "verify_s": t_verify,
          "spans_s": tlog.as_dict(), "peak_memory_bytes": peak,
          "launches": launches, "node_hash_launches_per_variant": node_variants,
          "tree_heights": tree_heights, "verified": True,
          "tampered_rejected": True})

    # ---------------------------------------------------------------- prove_vm
    # the same proof with both routes forced by the two thresholds: the
    # large-circuit path (the card's default, so the same route as ``prove``)
    # and the small-circuit path; each span's peak of allocated bytes
    routes = {}
    for large in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.time()
        prover_r = route_prover(info, const_vals, large)
        torch.cuda.synchronize()
        t_setup_r = time.time() - t0
        tlog_r = TimerLog("chip_smoke_route", quiet=True, peak_memory=True)
        t0 = time.time()
        proof_r = prover_r.prove(trace, timer=tlog_r)
        torch.cuda.synchronize()
        t_prove_r = time.time() - t0
        launches_r = read_counters()
        what = "prove_vm" if large else "prove_vm, small path"
        if launches_r["vm_run"] != (3 if large else 0):
            raise AssertionError(f"{what}: {launches_r['vm_run']} VM launches")
        for k in ("linear_hash", "node_hash", "ntt_short", "ntt_block"):
            if launches_r[k] <= 0:
                raise AssertionError(f"{what} never launched kernel {k}")
        same_proof(f"{what} against prove", proof_r, proof)
        verify(info, prover_r.const_tree.root(), proof_r)
        routes[large] = {
            "env": LARGE_PATH_ENV if large else SMALL_PATH_ENV,
            "setup_s": t_setup_r, "prove_s": t_prove_r,
            "spans_s": tlog_r.as_dict(),
            "peak_memory_bytes": max(tlog_r.peaks.values()),
            "span_peak_bytes": dict(tlog_r.peaks), "launches": launches_r,
            "vm_launches": launches_r["vm_run"], "equal_to_prove_phase": True,
            "verified": True}
        if large:
            programs = {str(k): {"instructions": len(p.code),
                                 "registers": p.n_regs}
                        for k, p in ((2, prover_r._vm2), (3, prover_r._vm3),
                                     (4, prover_r._vm4))}
            bad = StarkProof.from_json(proof_r.to_json())
            bad.publics[0] = (bad.publics[0] + 1) % P
            try:
                verify(info, prover_r.const_tree.root(), bad)
            except VerifyError:
                pass
            else:
                raise AssertionError("prove_vm: a proof with a changed "
                                     "public was accepted")
        del prover_r, proof_r
    emit({"phase": "prove_vm", "circuit": "smoke", "n_bits": info.n_bits,
          "programs": programs, **routes[True], "tampered_rejected": True,
          "small_path": routes[False]})

    # --------------------------------------------------------------- recursion
    # The chain inner STARK -> recursive1 -> recursive2, each stage a plonk12c
    # STARK proven through the kernels above.  First two proofs tied to the
    # JAX package's golden files; then the production settings over a smoke
    # proof at n_bits 17.
    def run_stage(stage, inners, log_stage: bool = False):
        """stage.prove(inners), every launch counter at 0 just before and
        read just after, its host pieces read from the stage's spans;
        returns the proof, the stage's line and, with `log_stage`, the log
        of its kernel launches (log_launches)."""
        refill = stage.prover is not None
        tlog = TimerLog(f"chip_smoke:{stage.name}", quiet=True,
                        peak_memory=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log = restore = None
        if log_stage:
            log, restore = log_launches()
        zero_counters()
        t0 = time.time()
        try:
            out = stage.prove(inners, timer=tlog)
            torch.cuda.synchronize()
        finally:
            total = time.time() - t0
            launches_s = read_counters()
            if restore is not None:
                restore()
        spans = tlog.as_dict()
        host = {key: spans[span] for key, span in (
            ("build_verifier_circuit_s", "RECURSION_CIRCUIT"),
            ("circuit_to_air_s", "RECURSION_LOWER"),
            ("fill_trace_s", "RECURSION_REFILL"),
            ("compile_air_s", "RECURSION_COMPILE"),
            ("setup_s", "RECURSION_SETUP")) if span in spans}
        host["prove_s"] = total - sum(host.values())
        # K5 runs only where a transform falls in the pipeline's sizes, and
        # a plonk12c circuit has no step-2 program (no plookup)
        for k in ("linear_hash", "node_hash", "ntt_short"):
            if launches_s[k] <= 0:
                raise AssertionError(f"{stage.name}: never launched kernel {k}")
        pr_ = stage.prover
        vm_progs_ = [v for v in (pr_._vm2, pr_._vm3, pr_._vm4) if v is not None]
        if (pr_._vm3 is None or pr_._vm4 is None or not pr_._step5_matrix
                or (pr_._vm2 is None and stage.info.step2prev)
                or launches_s["vm_run"] != len(vm_progs_)):
            raise AssertionError(f"{stage.name}: not the large-circuit path")
        t0 = time.time()
        verify(stage.info, stage.const_root(), out)
        t_ver = time.time() - t0
        lay = stage.lay
        line = {
            "phase": "recursion", "stage": stage.name, "refill": refill,
            "inner_proofs": len(inners),
            "inner_n_bits": [i.n_bits for i, _r, _p in inners],
            "settings": {"n_queries": stage.n_queries,
                         "fri_fold_bits": stage.fri_fold_bits,
                         "final_bits": stage.final_bits},
            "layout": {"n_bits": lay.n_bits, "pub_rows": lay.n_pub_rows,
                       "gate_rows": lay.n_gate_rows,
                       "poseidon_rows": lay.n_pos_rows},
            "circuit": stage._circuit_stats,
            "n_bits_ext": stage.info.n_bits_ext,
            "fri_step_bits": stage.info.fri_step_bits,
            "section_widths": stage.info.section_widths,
            "host_s": {**host, "stage_prove_s": total, "verify_s": t_ver},
            "spans_s": spans, "peak_memory_bytes": max(tlog.peaks.values()),
            "span_peak_bytes": dict(tlog.peaks),
            "launches": launches_s, "verified": True}
        return out, line, log

    rec_lines = []
    # tie to the reference: the Poseidon-preimage plonk12c proof and
    # recursive1 over the golden n_bits 5 smoke proof
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_plonk12c_proof.json")) as fh:
        golden = json.load(fh)
    c = Circuit()
    pre = [c.witness(i + 5) for i in range(12)]
    for w_out in c.poseidon(pre)[:4]:
        c.expose(w_out)
    air_p, trace_p, _lay = circuit_to_air(c, "p12c_test")
    info_p = compile_air(air_p, **golden["compile_air"])
    torch.cuda.synchronize()
    zero_counters()
    prover_p = StarkProver(info_p, np.stack(air_p.const_values, axis=1))
    proof_p = prover_p.prove(trace_p)
    torch.cuda.synchronize()
    launches_p = read_counters()
    if prover_p.const_tree.root() != golden["const_root"]:
        raise AssertionError("plonk12c: const root differs from the golden file")
    same_proof("plonk12c", proof_p,
               StarkProof.from_json(json.dumps(golden["proof"])))
    verify(info_p, prover_p.const_tree.root(), proof_p)
    rec_lines.append({"phase": "recursion", "stage": "plonk12c (golden)",
                      "layout": golden["layout"], "circuit": c.stats(),
                      "equal_to_golden": True, "verified": True,
                      "launches": launches_p})
    emit(rec_lines[-1])
    del prover_p, proof_p

    with open(os.path.join(root_dir, "tests", "data",
                           "torch_recursive1_proof.json")) as fh:
        golden = json.load(fh)
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_smoke_proof_nbits5.json")) as fh:
        golden5 = json.load(fh)
    air5, _ = build_smoke_air(n_bits=5, seed=golden5["seed"])
    inner5 = (compile_air(air5, **golden5["compile_air"]), golden5["const_root"],
              StarkProof.from_json(json.dumps(golden5["proof"])))
    stage_g = rec.RecursiveStage("recursive1", **golden["compile_air"])
    proof_g, line, _ = run_stage(stage_g, [inner5])
    if [stage_g.lay.n_bits, stage_g.lay.n_pub_rows, stage_g.lay.n_gate_rows,
            stage_g.lay.n_pos_rows] != golden["layout"]:
        raise AssertionError("recursive1 (golden): layout differs")
    if stage_g.const_root() != golden["const_root"]:
        raise AssertionError("recursive1 (golden): const root differs")
    same_proof("recursive1 (golden)", proof_g,
               StarkProof.from_json(json.dumps(golden["proof"])))
    rec_lines.append({**line, "stage": "recursive1 (golden)",
                      "equal_to_golden": True})
    emit(rec_lines[-1])
    del stage_g, proof_g

    # full width: the production recursion settings over a smoke proof at
    # n_bits 17 whose own FRI takes the same settings.  (The ``prove``
    # phase's proof ends FRI on a 2^12-element polynomial, and the verifier
    # circuit checks its degree by a constant 2^12 x 2^12 INTT: some 25
    # million gates, a 2^23-row stage.)
    REC_SETTINGS = dict(n_queries=32, fri_fold_bits=3, final_bits=4)
    info_in = compile_air(air17, **REC_SETTINGS)
    prover_in = StarkProver(info_in, np.stack(air17.const_values, axis=1))
    root_in = prover_in.const_tree.root()
    proof_a = prover_in.prove(trace17)
    verify(info_in, root_in, proof_a)
    stage1 = rec.RecursiveStage("recursive1", **REC_SETTINGS)
    p1a, line, rec1_log = run_stage(stage1, [(info_in, root_in, proof_a)],
                                    log_stage=True)
    rec_lines.append(line)
    emit(line)
    # a second inner proof through the same StarkProver (another witness of
    # the same circuit), through the same stage: the witness-refill path
    _air_b, trace_b = build_smoke_air(n_bits=17, seed=43)
    proof_b = prover_in.prove(trace_b)
    verify(info_in, root_in, proof_b)
    prover1 = stage1.prover
    p1b, line, _ = run_stage(stage1, [(info_in, root_in, proof_b)])
    if stage1.prover is not prover1 or line["host_s"].get("circuit_to_air_s"):
        raise AssertionError("recursive1: the second proof did not take the "
                             "refill path")
    if p1b.roots == p1a.roots:
        raise AssertionError("recursive1: the refill proof repeats the first")
    rec_lines.append(line)
    emit(line)
    root1 = stage1.const_root()
    stage2 = rec.RecursiveStage("recursive2", **REC_SETTINGS)
    p2, line, rec_log = run_stage(
        stage2, [(stage1.info, root1, p1a), (stage1.info, root1, p1b)],
        log_stage=True)
    want = list(p1a.publics) + root1 + list(p1b.publics) + root1
    if p2.publics != want:
        raise AssertionError("recursive2: publics do not bind both children "
                             "and the recursive1 root")
    bad = StarkProof.from_json(p2.to_json())
    bad.publics[3] = (bad.publics[3] + 1) % P
    try:
        verify(stage2.info, stage2.const_root(), bad)
    except VerifyError:
        pass
    else:
        raise AssertionError("recursive2: a proof with a changed public was "
                             "accepted")
    rec_lines.append({**line, "publics_bind_children": True,
                      "tampered_rejected": True})
    emit(rec_lines[-1])
    rec_launches = {ln["stage"] + (" (refill)" if ln.get("refill") else ""):
                    ln["launches"] for ln in rec_lines}
    # recursive2's launches of K2, K4 and K5, each timed again at its shape
    rec_times = {k: per_proof(rec_log[k], k)
                 for k in ("linear_hash", "ntt_short", "ntt_block")}
    k4_shapes = sorted({(a["x"], a["log_l"]) for _o, a in rec_log["ntt_short"]},
                       key=lambda s: (-s[0][0] * s[0][1], s[1]))
    k4_big = max(rec_log["ntt_short"], key=lambda c: c[1]["x"][0] * c[1]["x"][1])
    rec_tree_heights = [a["h"] for _, a in rec_log["merkle"]]
    rec_nb = stage2.info.n_bits
    rec_info = stage2.info
    rec_vm = {step: p_ for step, p_ in ((2, stage2.prover._vm2),
                                        (3, stage2.prover._vm3),
                                        (4, stage2.prover._vm4))
              if p_ is not None}
    final_inner = (stage2.info, stage2.const_root(), p2)   # phase final
    del p1a, p1b, p2, bad, stage1, stage2, proof_a, proof_b, trace_b
    del prover_in
    torch.cuda.empty_cache()

    # every kernel of the recursion path against its plain version at the
    # shapes the stages gave it, on seeded data with the edge words (p and
    # 2^64 - 1 among them) across the first and the last rows: each distinct
    # launch of K2, K4 and K5 that recursive1 and recursive2 logged (K2 above
    # 8192 rows on its first and last 4096 rows), every tree height they
    # built through the dispatch, and recursive2's step programs at its
    # domains
    def hold_logged(stage_name, log_) -> None:
        seen = set()
        for kernel in ("linear_hash", "ntt_short", "ntt_block",
                       "ntt_block_short"):
            for orig, a in log_[kernel]:
                key = (orig.__name__,) + tuple(
                    (k, "tensor" if torch.is_tensor(v) else v)
                    for k, v in a.items())
                if key in seen:
                    continue
                seen.add(key)
                plain = getattr(sys.modules[orig.__module__],
                                orig.__name__ + "_plain")
                data = next(k for k in ("rows", "x", "y") if k in a)
                a = dict(a)
                a[data] = edge_rows(rnd(*a[data]))
                edge_rows(a[data][-len(lane_vals):])
                what = ", ".join([
                    f"recursion path, {stage_name}, {orig.__name__} "
                    f"{tuple(a[data].shape)}"] + [
                        f"{k}={v}" for k, v in a.items()
                        if isinstance(v, (bool, int)) and k != data])
                got = orig(**a)
                rows = a[data].shape[0]
                if kernel == "linear_hash" and rows > 8192:
                    for part in (slice(0, 4096), slice(rows - 4096, rows)):
                        hold(kernel, f"{what}, plain on rows {part.start}.."
                             f"{part.stop - 1}", got[part],
                             plain(rows=a[data][part]))
                else:
                    hold(kernel, what, got, plain(**a))
                del got, a

    check_clock[0] = time.time()
    hold_logged("recursive1", rec1_log)
    hold_logged("recursive2", rec_log)
    torch.cuda.empty_cache()
    heights = sorted({a["h"] for log_ in (rec1_log, rec_log)
                      for _o, a in log_["merkle"]})
    forest = []
    for h in heights:
        nodes = torch.zeros((2 * h - 1, 4), dtype=torch.int64, device=dev)
        nodes[:h] = edge_lanes(rnd(4, h)).T
        forest.append(nodes)
    got = [pc.merkle_levels_(t.clone(), h) for t, h in zip(forest, heights)]
    for h, g, want in zip(heights, got, plain_levels_(forest)):
        hold("node_hash", f"recursion path, merkle levels, h = {h}, edge "
             f"words in every lane ({len(pc._level_plan(h))} launches)",
             g, want)
    del forest, got, nodes, g, want
    torch.cuda.empty_cache()
    for step in sorted(rec_vm):
        prog, n, secs, kw = vm_case(step, rec_vm, rec_info)
        got = vm.run_program(prog, rec_info, secs, n, **kw)
        want = vm.run_program_plain(prog, rec_info, secs, n, **kw)
        for dest in prog.out_regs:
            hold("vm_run", f"recursion path, recursive2 step {step} program "
                 f"({len(prog.code)} instructions, {prog.n_regs} registers, "
                 f"n = {n}), dest {dest}", torch.stack(got[dest]),
                 torch.stack(want[dest]))
        del got, want, secs, kw
    rec_vm_shapes = {str(step): {"instructions": len(p_.code),
                                 "registers": p_.n_regs}
                     for step, p_ in rec_vm.items()}
    del rec1_log, rec_log, rec_vm
    torch.cuda.empty_cache()
    emit({"phase": "recursion_holds", "mismatches": 0,
          "recursive2_vm_programs": rec_vm_shapes,
          "cases": [c for c in checks
                    if c["case"].startswith("recursion path")]})
    # one 64-column block of recursive2's LDE, 2^20 -> 2^21, on the
    # four-step route: K4's launches beside the plain glue between them
    blk = rnd(1 << rec_nb, ntt.EXTEND_BLOCK_COLS + 3)[:, 1:-2]
    emit({"phase": "lde_block_split", "route": "four-step (_ntt_rec)",
          **lde_block_split(blk, rec_nb, pipeline=False)})
    del blk
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ final
    # The last hop of the chain (prover/backend.py gen_final_proof):
    # recursiveF, the BN254-committed STARK of the verifier circuit of the
    # recursion phase's recursive2 proof, at the production recursion
    # settings, then Groth16 over recursiveF's verifier R1CS.  Every BN254
    # tree is built by B1 on the card; the Groth16 setup and proof run B2,
    # B3 and B4.  The hop runs under torch.profiler (device activity only):
    # each BN254 kernel's own device time is summed by kernel.
    bn_kernel_of = {
        "bn_poseidon_words_kernel": "B1", "bn_poseidon_sponge_kernel": "B1",
        "bn_poseidon_node_kernel": "B1",
        "bn_fr_ntt_pass_kernel": "B2", "bn_mont_mul_kernel": "B2",
        "bn_fr_mul_sub_kernel": "B2", "bn_fr_powers_kernel": "B2",
        "bn_fr_poly_eval_kernel": "B2", "bn_to_affine_kernel": "B3",
        "bn_msm_digits_kernel": "B3", "bn_msm_bucket_sums_kernel": "B3",
        "bn_sum_ranges_kernel": "B3", "bn_msm_reduce_kernel": "B3",
        "bn_fixed_base_kernel": "B4"}

    def bn_device_ms(prof) -> dict:
        """Each BN254 kernel's device ms and launches in a profile, by
        kernel name; fails on a bn_ kernel this table does not name."""
        out = fft_.kernel_device_ms(prof)
        for k in out:
            if k not in bn_kernel_of:
                raise AssertionError(f"final: kernel {k} is not one of B1-B4")
        return out

    # Phase kernels' holds and the edge holds (edge_holds) run in two more
    # processes of this script while FINAL_R1CS runs: host python, no launch
    # on the card (and torch.profiler records this process's kernels only).
    # They are waited for as the span ends, before the setup's first launch,
    # so that no timed or traced launch shares the card with them.
    def start_holds(flag):
        out_, err_ = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag],
            cwd=root_dir, stdout=out_, stderr=err_)

        def stop():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

        atexit.register(stop)           # the hop may raise meanwhile
        return proc, out_, err_, stop

    def last_line(flag, started, timeout):
        """The JSON of the process's last line; raises unless it exited 0."""
        proc, out_, err_, stop = started
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            stop()
        out_.seek(0)
        err_.seek(0)
        if rc != 0:
            raise AssertionError(f"{flag}: exited with {rc}: " + err_.read(
                ).decode(errors="replace")[-3000:])
        return json.loads(out_.read().decode().splitlines()[-1])

    beside = {}     # flag -> that process's last line; "wait_s"

    class FinalLog(TimerLog):
        """TimerLog whose FINAL_R1CS span runs the two hold processes."""

        @contextlib.contextmanager
        def span(self, label: str):
            if label != "FINAL_R1CS":
                with super().span(label):
                    yield
                return
            started = {f: start_holds(f)
                       for f in ("--kernel-holds", "--edge-holds")}
            with super().span(label):
                yield
            t0 = time.time()
            for f, st_ in started.items():
                beside[f] = last_line(f, st_, 900)
            beside["wait_s"] = time.time() - t0

    def run_final_hop(info_in, root_in, proof_in):
        """recursiveF over one inner proof, then Groth16: returns the line
        of the phase (host spans, launches, peaks), the Groth16 stage and
        the BN254 launches by shape."""
        tlog = FinalLog("chip_smoke:final", quiet=True, peak_memory=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.time()
        with tlog.span("FINAL_CIRCUIT"):
            circ = rec.build_verifier_circuit([(info_in, root_in, proof_in)])
        with tlog.span("FINAL_LOWER"):
            air_f, trace_f, lay_f = circuit_to_air(circ, "recursiveF")
        with tlog.span("FINAL_COMPILE"):
            info_f = compile_air(air_f, **REC_SETTINGS)
        with tlog.span("FINAL_STARK_SETUP"):
            prover_f = StarkProverBN128(info_f, smoke_const_values(air_f))
        with tlog.span("FINAL_STARK_PROVE"):
            pf = prover_f.prove(trace_f)
            torch.cuda.synchronize()
        stark_launches = {**read_counters(), **{
            f"{b} {k}": v for b, d in read_bn_counters().items()
            for k, v in d.items()}}
        root_f = prover_f.const_tree.root()
        kw = dict(tree_cls=MerkleTreeBN128GL,
                  transcript_cls=TranscriptBN128Adapter)
        with tlog.span("FINAL_STARK_VERIFY"):
            verify(info_f, root_f, pf, **kw)
        bad = StarkProof.from_json(pf.to_json())
        bad.publics[0] = (bad.publics[0] + 1) % P
        try:
            verify(info_f, root_f, bad, **kw)
        except VerifyError:
            pass
        else:
            raise AssertionError("recursiveF: a proof with a changed public "
                                 "was accepted")
        del bad, trace_f, circ
        stage = FinalStage(info_f, root_f[0], keep_r1cs=True)
        for k in bn_curve.FB_TABLE_BUILDS:
            bn_curve.FB_TABLE_BUILDS[k] = 0
        g16 = stage.prove(pf, timer=tlog)
        torch.cuda.synchronize()
        total = time.time() - t0
        vk = make_vk(stage.toxic, stage.stats["n_public"])
        bad16 = dict(g16, pi_a=[int(g16["pi_a"][0]) + 1, int(g16["pi_a"][1])])
        if groth16_verify(vk, bad16) is not False:
            raise AssertionError("Groth16: a proof with pi_a changed by one "
                                 "was accepted")
        # read where the profiled window ends (make_vk reads the toxic
        # waste's values through B2)
        launches_f = read_bn_counters()
        shapes_f = {k: dict(v) for shapes in bn_shapes for k, v in shapes.items()}
        for b, d in launches_f.items():
            if sum(d.values()) <= 0:
                raise AssertionError(f"final: kernel {b} was never launched")
        if launches_f["B1"]["leaf"] <= 0 or launches_f["B1"]["node"] <= 0:
            raise AssertionError("final: a BN254 tree was not built by B1")
        spans = tlog.as_dict()
        line = {
            "phase": "final", "inner": "recursive2",
            "settings": REC_SETTINGS,
            "recursiveF": {"rows": 1 << info_f.n_bits, "n_bits": info_f.n_bits,
                           "n_bits_ext": info_f.n_bits_ext,
                           "fri_step_bits": info_f.fri_step_bits,
                           "section_widths": info_f.section_widths,
                           "layout": {"n_bits": lay_f.n_bits,
                                      "pub_rows": lay_f.n_pub_rows,
                                      "gate_rows": lay_f.n_gate_rows,
                                      "poseidon_rows": lay_f.n_pos_rows},
                           "circuit": circ_stats(lay_f, air_f)},
            "r1cs": stage.stats, "total_s": total, "spans_s": spans,
            # FINAL_SETUP's pieces, each ended by a synchronize, and B4's
            # tables built on the host within them
            "setup_spans_s": stage.setup_spans,
            "fixed_base_tables": dict(bn_curve.FB_TABLE_BUILDS),
            "span_peak_bytes": dict(tlog.peaks),
            "peak_memory_bytes": max(tlog.peaks.values()),
            "host_max_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "stark_launches": stark_launches, "launches": launches_f,
            "verified": True, "tampered_stark_rejected": True,
            "pairing_ok": True, "tampered_groth16_rejected": True,
            # the tampered pairing and the counters' reads after total_s
            "after_total_s": time.time() - t0 - total,
            # inside total_s: the wait for the hold processes after
            # FINAL_R1CS
            "holds_beside_wait_s": beside["wait_s"]}
        return line, stage, shapes_f

    def circ_stats(lay_, air_):
        return {"gate_rows": lay_.n_gate_rows, "poseidon_rows": lay_.n_pos_rows,
                "constants": len(air_.const_values)}

    import resource
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        final_line, final_stage, fin_shapes = run_final_hop(*final_inner)
        t_hop = time.time()
    t_exit = time.time()
    by_kernel = bn_device_ms(prof)
    del prof
    final_line["profiler_s"] = {"exit": t_exit - t_hop,
                                "read": time.time() - t_exit}
    bn_ids = ("B1", "B2", "B3", "B4")
    final_line["device_ms"] = {
        b: sum(d["ms"] for k, d in by_kernel.items() if bn_kernel_of[k] == b)
        for b in bn_ids}
    final_line["device_ms_by_kernel"] = by_kernel
    final_line["profiled_launches_equal_counters"] = {
        b: sum(d["launches"] for k, d in by_kernel.items()
               if bn_kernel_of[k] == b) ==
        sum(final_line["launches"][b].values()) for b in bn_ids}
    if not all(final_line["profiled_launches_equal_counters"].values()):
        raise AssertionError("final: torch.profiler's launches differ from "
                             "the counters: "
                             f"{final_line['profiled_launches_equal_counters']}")
    emit({**final_line, "launched_shapes": {
        k: sorted([[list(s_) if isinstance(s_, tuple) else s_, c_]
                   for s_, c_ in v.items()], key=str)
        for k, v in fin_shapes.items()}})
    final_key = final_stage.key
    prod_r1cs = final_stage.r1cs    # phase fflonk (c)
    del final_inner, final_stage
    torch.cuda.empty_cache()

    # ------------------------------------------------------- final_holds
    # B1-B4 against their plain twins, exactly, at every distinct shape the
    # final phase launched them at (fin_shapes, the wrappers' records), on
    # seeded data with the edge values across the first and the last rows
    # (bnt.gl_rows, field_elems, scalars_like_witness); where the twin is
    # too slow at full size, on the first and last 4096 rows, elements or
    # scalars.  Each MSM runs at its full point count and window with
    # every scalar 0 but the first and last 4096 (bnt.hold_msm_path).
    # Then one whole BN254 tree of 2^12 rows against the host
    # MerkleTreeBN128 (python ints).
    gen_bn = torch.Generator(device=dev)
    gen_bn.manual_seed(2027)
    bn_holds = []
    bn_worst = {"B1": 0, "B2": 0, "B3": 0, "B4": 0}

    hold_clock = [time.time()]

    def bn_hold(kernel, res, s_=None):
        # the seconds since the hold before: this hold's own, data included
        res = {**res, "kernel_id": kernel,
               "s": round(time.time() - hold_clock[0], 2) if s_ is None
               else s_}
        hold_clock[0] = time.time()
        bn_holds.append(res)
        bn_worst[kernel] = max(bn_worst[kernel], res["max_abs_err"])
        if res["max_abs_err"] != 0:
            raise AssertionError(f"final_holds: {res} differs from its plain "
                                 "twin")

    cap = 4096
    for res in bnt.hold_leaves(list(fin_shapes["leaf"]), gen_bn, dev, cap):
        bn_hold("B1", res)
    torch.cuda.empty_cache()
    for res in bnt.hold_nodes(list(fin_shapes["node"]), gen_bn, dev, cap):
        bn_hold("B1", res)
    for (field, n, scalar_b) in sorted(fin_shapes["mont_mul"]):
        ctx = bf.FQ if field == "fq" else bf.FR
        m_ = min(n, 2 * cap)
        a = bnt.field_elems(ctx, m_, gen_bn, dev)
        a[: m_ // 2, 3] |= -(1 << 63)        # any 256-bit a
        b = bf.to_mont(ctx, bnt.field_elems(ctx, 1 if scalar_b else m_,
                                            gen_bn, dev))
        b = b[0] if scalar_b else b
        res = bnt.hold_mont_mul(ctx, a, b)
        bn_hold("B2", {**res, "n": n, "held": m_})
    for n in sorted(fin_shapes["mul_sub"]):
        m_ = min(n, 2 * cap)
        x, y, z = (bf.to_mont(bf.FR, bnt.field_elems(bf.FR, m_, gen_bn, dev))
                   for _ in range(3))
        bn_hold("B2", {"kernel": "B2 mul_sub", "n": n, "held": m_,
                       "max_abs_err": bnt.diff_words(
                           bn254_cuda.mul_sub(x, y, z),
                           bn254_cuda.mul_sub_plain(x, y, z))})
    for (base, n, start) in sorted(fin_shapes["powers"]):
        bn_hold("B2", bnt.hold_powers(base, n, start, dev))
    group_of = {"Fr": None, "G1": bn_curve.F1, "G2": bn_curve.F2}

    def ends_by(shapes, key):
        """The logged shapes that differ in their control flow: for each
        key (group, window ...), the smallest and the largest; the launches
        between repeat them with other counts."""
        out = {}
        for sh in sorted(shapes):
            lo_hi = out.setdefault(key(sh), [sh, sh])
            lo_hi[1] = sh
        return sorted({s_ for v in out.values() for s_ in v})

    reduce_held: set = set()

    def b3_new_holds(shapes, gen_, hold_):
        """B3's batch-to-affine at every logged shape; its signed-digit
        counts and scatter (at most 2^27 entries of windows held), affine
        bucket sums and reduce at the smallest and largest logged shape of
        each group and window."""
        for (grp, n) in sorted(shapes.get("affine", {})):
            hold_("B3", bnt.hold_affine(group_of[grp], n, gen_, dev))
            torch.cuda.empty_cache()
        for (grp, n, c) in ends_by(shapes.get("digits", {}),
                                   lambda s_: (s_[0], s_[2])):
            g_ = max(1, min(bn_msm.n_windows(254, c), (1 << 27) // n))
            hold_("B3", bnt.hold_digits(group_of[grp], n, c, gen_, dev, g=g_))
            torch.cuda.empty_cache()
        for (grp, e, r) in ends_by(shapes.get("bucket_sums", {}),
                                   lambda s_: s_[0]):
            hold_("B3", bnt.hold_bucket_sums(group_of[grp], e, r, gen_, dev))
            torch.cuda.empty_cache()
        most = {}
        for (grp, g_, c) in shapes.get("reduce", {}):
            most[(grp, c)] = max(g_, most.get((grp, c), 0))
        for (grp, c), g_ in sorted(most.items()):
            if (grp, g_, c) not in reduce_held:     # final_holds' again
                reduce_held.add((grp, g_, c))
                hold_("B3", bnt.hold_reduce(group_of[grp], g_, c, gen_, dev))


    for (group, n_vals, n_ranges, gathered) in sorted(
            fin_shapes["sum_ranges"]):
        bn_hold("B3", bnt.hold_sum_ranges(group_of[group], n_vals, n_ranges,
                                          gathered, gen_bn, dev, cap))
    for (group, n, c) in sorted(fin_shapes["digits"]):
        res = bnt.hold_msm_path(group_of[group], n, c, gen_bn, dev, cap)
        bn_hold("B3", res)
        if res["range_passes"] < 3:
            raise AssertionError(f"final_holds: {res} held fewer than three "
                                 "range passes")
        torch.cuda.empty_cache()
    b3_new_holds(fin_shapes, gen_bn, bn_hold)
    # B4 launched at each logged scalar count, held on the first and last
    # 512 results: its twin's cost is sequential (254 doublings a result,
    # ~4 s) plus a tree of adds over scalars x 254 bits, launch-bound plain
    # arithmetic
    cap_pts = 512
    for (group, n) in sorted(fin_shapes["fixed_base"]):
        F_ = group_of[group]
        bn_hold("B4", bnt.hold_fixed_base(
            F_, bnt._one_gen(F_, dev), bnt.field_elems(bf.FR, n, gen_bn, dev),
            cap_pts))
        torch.cuda.empty_cache()
    # the edge process's holds (edge_holds): B4 at scalars 0, 1, r - 1, r,
    # 2^k, r - 2^k, 2^256 - 1, a carry into the top window, digits at
    # +-2^(w-1) and the walks that meet +-the point they add
    # (bnt.edge_scalars); B1's leaves at every last-chunk width t = 2..17
    # (alone or after a full chunk) and at widths 1-5, 47-49, 105, 665;
    # every NTT size from 2 to 2^24 both ways (the path's, logged in
    # fin_shapes["pass"], among them)
    for kid, res, s_ in beside["--edge-holds"]:
        if res["kernel"] == "B2 ntt":
            res["logged"] = (res["n"], res["inverse"]) in fin_shapes["pass"]
        bn_hold(kid, res, s_)
    kernel_res = beside["--kernel-holds"]
    for k, err in kernel_res["worst"].items():
        worst[k] = max(worst[k], err)
    checks[:0] = kernel_res["cases"]
    tree_plain = kernel_res["state_tree_plain"]
    if len(tree_plain) != len(tree_k1):
        raise AssertionError("state: the plain tree builds are missing")
    for a, b in zip(tree_k1, tree_plain):
        if [a[k] for k in ("root", "nodes", "nodes_sha256")] != \
                [b[k] for k in ("root", "nodes", "nodes_sha256")] or \
                b["k1_launches"]:
            raise AssertionError(f"state: tree build {a} != plain {b}")
    emit({"phase": "kernels_check", "mismatches": 0,
          "cases": kernel_res["cases"], "vm_plans": kernel_res["vm_plans"],
          "state_tree_plain": tree_plain,
          "linear_hash_2^18x665_ms": ms_lh665,
          "linear_hash_2^18x665_bound_ms": lh665_bound_ms})
    emit({"phase": "final_holds", "mismatches": 0, "holds": bn_holds,
          # the wait for both hold processes after FINAL_R1CS ended
          "beside_wait_s": beside["wait_s"]})

    # ---------------------------------------- times at the paths' shapes
    # Each entry: one launch at the largest shape its path gives it, and, for
    # the proofs' kernels, every launch of the proof timed again on its own
    # inputs and summed (per_proof_ms), beside the sum of their bounds.
    n_ext = info.n_ext
    wmax = max(info.section_widths.values())
    n2 = 1 << ntt_cuda.MAX_KERNEL_BITS
    entries = []

    def entry(name, replaces, shape, launches_, ms, plain_ms, bound, **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": "merlin_zkevm_prover_tpu_torch/csrc/" + (
                "poseidon_gl.cu" if name in ("permute", "linear_hash",
                                             "node_hash")
                else "vm_gl.cu" if name == "vm_run" else "ntt_gl.cu"),
            "replaces": "merlin_zkevm_prover_tpu/" + replaces,
            "shape": shape, "launches": launches_,
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "recursion_launches": {stage: l_[name] for stage, l_ in
                                   rec_launches.items()},
            **extra})

    def per_proof_keys(ms_bound):
        return {"per_proof_ms": ms_bound[0], "per_proof_bound_ms": ms_bound[1]}

    def rec_keys(kernel):
        """The recursive2 proof's launches of `kernel`, timed again."""
        return {"recursive2_per_proof_ms": rec_times[kernel][0],
                "recursive2_per_proof_bound_ms": rec_times[kernel][1]}

    # K1 on its path's state
    entry("permute", "ops/poseidon_tpu.py:317", [12, B_PERM], perm_launches["permute"],
          time_ms(lambda: pc.permute(perm_state), 7),
          time_ms(lambda: pc.permute_plain(perm_state), 2),
          perm_bound_ms(B_PERM, 2 * 12 * B_PERM * 8),
          path="ops.poseidon_gl.permute",
          state_tree_launches=[b["k1_launches"] for b in tree_k1],
          state_tree_device_ms=[b["permute_device_ms"] for b in tree_k1],
          state_tree_bound_ms=[perm_bound_ms(b["permutations"], b[
              "permutations"] * 24 * 8)[0] for b in tree_k1])
    del perm_state
    entries.append(s1_entry)

    x = rnd(n_ext, wmax)
    check_clock[0] = time.time()
    hold("linear_hash", f"main path ({n_ext}, {wmax})", pc.linear_hash(x),
         pc.linear_hash_plain(x))
    entry("linear_hash", "ops/poseidon_tpu.py:326", [n_ext, wmax],
          launches["linear_hash"], time_ms(lambda: pc.linear_hash(x), 7),
          time_ms(lambda: pc.linear_hash_plain(x), 2),
          call_bound_ms("linear_hash", {"rows": x}),
          **per_proof_keys(proof_times["linear_hash"]),
          **rec_keys("linear_hash"))

    # K3: the largest tree level (the pair kernel); per proof, every tree the
    # proof builds, filled again through the dispatch (merkle_levels_) on a
    # busy card (the kernels' time) and on an idle one (with the host's cost
    # of each launch); per level, each of the proof's launches at its size
    npairs = n_ext // 2
    l, r = rnd(npairs, 4), rnd(npairs, 4)
    hold("node_hash", f"main path ({npairs}, 4)", pc.node_hash(l, r),
         pc.node_hash_plain(l, r))
    trees = {}
    for h in sorted(set(tree_heights)):
        nodes = rnd(2 * h - 1, 4)
        trees[h] = (time_ms(lambda: pc.merkle_levels_(nodes, h), 5),
                    time_ms(lambda: pc.merkle_levels_(nodes, h), 5, prefill=False))
    lvl = rnd(2 * npairs, 4)
    lvl_out = torch.empty((npairs, 4), dtype=torch.int64, device=dev)
    per_level, per_level_idle = {}, {}
    for kind, n in sorted(set(node_launches)):
        if kind == "top":
            def level():
                pc._launch_merkle_top(lvl.data_ptr(), n, dev)
        else:
            def level():
                pc._launch_node_hash(kind, lvl.data_ptr(), lvl.data_ptr() + 32, 8,
                                     lvl_out.data_ptr(), n, dev)
        key = f"{kind} {n}" if kind != "top" else f"top from {n} digests"
        per_level[key] = time_ms(level, 7)
        per_level_idle[key] = time_ms(level, 7, prefill=False)

    def tree_bound(h):
        return sum(perm_bound_ms(h >> k, (h >> k) * 12 * 8)[0]
                   for k in range(1, h.bit_length()))
    for h in sorted(set(rec_tree_heights) - set(trees)):
        nodes = rnd(2 * h - 1, 4)
        trees[h] = (time_ms(lambda: pc.merkle_levels_(nodes, h), 5), None)
    del nodes
    entry("node_hash", "ops/poseidon_tpu.py:350", [npairs, 4], launches["node_hash"],
          time_ms(lambda: pc.node_hash(l, r), 7),
          time_ms(lambda: pc.node_hash_plain(l, r), 2),
          perm_bound_ms(npairs, npairs * 12 * 8),
          per_proof_ms=sum(trees[h][0] for h in tree_heights),
          per_proof_bound_ms=sum(tree_bound(h) for h in tree_heights),
          per_proof_idle_card_ms=sum(trees[h][1] for h in tree_heights),
          recursive2_per_proof_ms=sum(trees[h][0] for h in rec_tree_heights),
          recursive2_per_proof_bound_ms=sum(tree_bound(h)
                                            for h in rec_tree_heights),
          recursive2_trees_per_height={str(h): rec_tree_heights.count(h)
                                       for h in sorted(set(rec_tree_heights))},
          per_tree_ms={str(h): trees[h][0] for h in sorted(trees)},
          per_tree_idle_card_ms={str(h): trees[h][1] for h in sorted(trees)
                                 if trees[h][1] is not None},
          trees_per_height={str(h): tree_heights.count(h)
                            for h in sorted(set(tree_heights))},
          per_level_ms=per_level, per_level_idle_card_ms=per_level_idle,
          launches_per_level={
              (f"{k} {n}" if k != "top" else f"top from {n} digests"):
              node_launches.count((k, n)) for k, n in sorted(set(node_launches))},
          launches_per_variant=node_variants,
          thresholds={"GROUP_MAX_PAIRS": pc.GROUP_MAX_PAIRS,
                      "TOP_MAX_PAIRS": pc.TOP_MAX_PAIRS})
    del l, r, lvl, lvl_out

    # K4 on the recursion path: the largest of recursive2's launches (a
    # transform of an LDE block, outside the pipeline's sizes; held in
    # phase recursion_holds), timed
    o4, a4 = k4_big
    a4 = {k: rnd(*v) if k == "x" else v for k, v in a4.items()}
    k4_rec = {"recursion_shape": list(a4["x"].shape),
              "recursion_ms": time_ms(lambda: o4(**a4), 5),
              "recursion_plain_ms": time_ms(
                  lambda: ntt_cuda.ntt_short_plain(**a4), 2),
              "recursion_bound_ms": call_bound_ms("ntt_short", a4)[0],
              "recursion_shapes": [[list(sh), 1 << lg] for sh, lg in k4_shapes]}
    del a4

    # K4: FRI's first fold, INTT of length 4 over (4, pol2N * 3)
    fold = info.fri_step_bits[0] - info.fri_step_bits[1]
    b = (n_ext >> fold) * 3
    x = rnd(1 << fold, b)
    t = tw(fold, True)
    hold("ntt_short", f"main path ({1 << fold}, {b})",
         ntt_cuda.ntt_short(x, t, fold), ntt_cuda.ntt_short_plain(x, t, fold))
    entry("ntt_short", "ops/ntt_tpu.py:192", [1 << fold, b], launches["ntt_short"],
          time_ms(lambda: ntt_cuda.ntt_short(x, t, fold), 7),
          time_ms(lambda: ntt_cuda.ntt_short_plain(x, t, fold), 2),
          call_bound_ms("ntt_short", {"x": x, "log_l": fold}),
          **per_proof_keys(proof_times["ntt_short"]), **rec_keys("ntt_short"),
          **k4_rec)

    # K5: kernel B of the forward transform of the widest section's LDE
    log_l, b = ntt_cuda.MAX_KERNEL_BITS, (n_ext // n2) * wmax
    x = rnd(n2, b)
    t = tw(log_l, False)
    hold("ntt_block", f"main path ({n2}, {b})",
         ntt_cuda.ntt_block(x, t, log_l, False),
         ntt_cuda.ntt_block_plain(x, t, log_l, False))
    # the same block as the path runs it: kernel A of the forward LDE
    # (zero_top, reading the coefficients) and kernel B with the mid gather
    # in its load
    nb1 = info.n_bits_ext - log_l
    ya = rnd(n_ext // 2, wmax)
    yb = rnd(1 << nb1, b)
    fused = {}
    for what, fn, plain_fn, args in (
            ("kernel_a", ntt_cuda.ntt_block_cols, ntt_cuda.ntt_block_cols_plain,
             dict(x=ya, n1_bits=nb1, n2_bits=log_l, inverse=False,
                  zero_top=True)),
            ("gather_b", ntt_cuda.ntt_block_gather,
             ntt_cuda.ntt_block_gather_plain,
             dict(y=yb, n1_bits=nb1, n2_bits=log_l, c=wmax, inverse=False,
                  u=None, v=None, const_scale=None, out=None))):
        hold("ntt_block", f"main path {what} ({1 << log_l}, {b})",
             fn(**args), plain_fn(**args))
        fused[what + "_ms"] = time_ms(lambda: fn(**args), 7)
        fused[what + "_plain_ms"] = time_ms(lambda: plain_fn(**args), 2)
        fused[what + "_bound_ms"] = call_bound_ms("ntt_block", args)[0]
    entry("ntt_block", "ops/ntt_tpu.py:736", [n2, b], launches["ntt_block"],
          time_ms(lambda: ntt_cuda.ntt_block(x, t, log_l, False), 7),
          time_ms(lambda: ntt_cuda.ntt_block_plain(x, t, log_l, False), 2),
          call_bound_ms("ntt_block", dict(x=x, log_l=log_l, u=None, v=None,
                                          const_scale=None)),
          gather_b_launches=launches["ntt_block_gather"],
          **fused, **per_proof_keys(proof_times["ntt_block"]),
          **rec_keys("ntt_block"))
    del ya, yb

    # K6: kernel A of the n_bits 11 proof's widest LDE, n_bits 11 -> 12: the
    # INTT at L = 4 and the forward transform at L = 8 with zero_top
    c11 = max(info11.section_widths.values())
    k6 = {}
    for what, nb, inverse, zero_top in (("intt", info11.n_bits, True, False),
                                        ("lde", info11.n_bits_ext, False, True)):
        log_l, log_n2 = ntt_cuda._split(nb)
        l, b = 1 << log_l, (1 << log_n2) * c11
        x = rnd(l // 2 if zero_top else l, b)
        t = tw(log_l, inverse)
        hold("ntt_block_short", f"path ({l}, {b}), {what}",
             ntt_cuda.ntt_block(x, t, log_l, True, zero_top=zero_top),
             ntt_cuda.ntt_block_plain(x, t, log_l, True, zero_top=zero_top))
        k6[what] = (
            [l, b],
            time_ms(lambda: ntt_cuda.ntt_block(x, t, log_l, True,
                                               zero_top=zero_top), 7),
            time_ms(lambda: ntt_cuda.ntt_block_plain(
                x, t, log_l, True, zero_top=zero_top), 2),
            call_bound_ms("ntt_block_short", dict(
                x=x, log_l=log_l, u=None, v=None, const_scale=None)))
    shape, ms, plain_ms, bound = k6["lde"]
    entry("ntt_block_short", "ops/ntt_tpu.py:517", shape,
          golden_launches[11]["ntt_block_short"], ms, plain_ms, bound,
          path="golden proof, n_bits 11", input_rows=shape[0] // 2,
          intt_shape=k6["intt"][0], intt_ms=k6["intt"][1],
          intt_plain_ms=k6["intt"][2], intt_bound_ms=k6["intt"][3][0],
          **per_proof_keys(k6_proof))

    # vm_run: each program of the proof timed by its kernel launch alone on
    # the arguments its kernels_check case built (the step-4 program at
    # 2^18 rows is the entry's shape), launched once each per proof
    vm_times = {}
    for step in sorted(vm_progs):
        prog, n = vm_progs[step], info17.n if step < 4 else info17.n_ext
        args = vm_args(step)
        f = vm_cuda._vm_fields(*args)
        cuda_build.check(vm_cuda._launch(f), "vm_run launch")
        vm_times[step] = (time_ms(lambda: vm_cuda._launch(f), 7),
                          time_ms(lambda: vm_cuda.vm_run_plain(*args), 2),
                          vm_bound_ms(vm, prog, n), n)
    f = vm_cuda._vm_fields(*random_case())
    rand_ms = time_ms(lambda: vm_cuda._launch(f), 5)
    rand_bound = vm_code_bound_ms(vm, rand_code, 1 << 18, 3, 32, [0])
    rand_old = vm_code_bound_ms(vm, rand_code, 1 << 18, 3, 32, [0], typed=False)

    def vm_extra(args_, prog_=None):
        """Time, plan and bounds (typed, and the untyped count of six
        products a MUL) of one more program, from its kernels_check
        arguments."""
        f_ = vm_cuda._vm_fields(*args_)
        ms_ = time_ms(lambda: vm_cuda._launch(f_), 5)
        n_ = args_[6]
        if prog_ is not None:
            b_, old_ = vm_bound_ms(vm, prog_, n_), vm_bound_ms(vm, prog_, n_,
                                                               typed=False)
        else:
            pre_ = [r for r, _v in args_[3]]
            b_, old_ = (vm_code_bound_ms(vm, args_[0], n_, 3 * len(pre_),
                                         len(args_[4]), pre_, typed)
                        for typed in (True, False))
        return {"instructions": len(args_[0]), "registers": args_[5],
                "rows": n_, "ms": ms_, "bound_ms": b_[0], "bound_by": b_[1],
                "untyped_bound_ms": old_[0], "untyped_bound_by": old_[1],
                "words": f_["plan"]["words"], "words_on_chip":
                f_["plan"]["slots_on"], "block_rows": f_["plan"]["rows"]}

    (wide_args, wide_prog), spill_args, _ragged = vm_more_cases()
    wide_row = vm_extra(wide_args, wide_prog)
    spill_row = vm_extra(spill_args)
    del f, args, wide_args, spill_args, _ragged
    ms4, plain4, bound4, n4 = vm_times[4]
    prog4 = vm_progs[4]
    entry("vm_run", "stark/vm.py:532",
          [len(prog4.code), prog4.n_regs, n4], launches["vm_run"],
          ms4, plain4, bound4, path="prove (steps 2, 3 and 4)",
          pallas_kernel=False, note="the reference runs its VM as one "
          "lax.scan; no TPU kernel stands behind this one",
          shape_is="[instructions, registers, rows] of the step-4 program",
          untyped_bound_ms=vm_bound_ms(vm, prog4, n4, typed=False)[0],
          per_program={str(k): {"instructions": len(vm_progs[k].code),
                                "registers": vm_progs[k].n_regs, "rows": t[3],
                                "ms": t[0], "plain_ms": t[1],
                                "bound_ms": t[2][0], "bound_by": t[2][1]}
                       for k, t in vm_times.items()},
          random_program={"instructions": 6000, "registers": 32,
                          "rows": 1 << 18, "ms": rand_ms,
                          "bound_ms": rand_bound[0],
                          "bound_by": rand_bound[1],
                          "untyped_bound_ms": rand_old[0],
                          "untyped_bound_by": rand_old[1]},
          wide_program=wide_row, spill_program=spill_row,
          per_proof_ms=sum(t[0] for t in vm_times.values()),
          per_proof_bound_ms=sum(t[2][0] for t in vm_times.values()))

    # B1-B4: the final hop's kernels (no Pallas counterpart: the reference
    # runs these as host python ints or jnp limb scans), each at the
    # largest shape the final phase gave it; the plain twin timed on the
    # rows, points or scalars it was held on where the full shape does not
    # fit the twin (plain_held); launches: the final phase's
    bn_launches = final_line["launches"]

    def once_ms(fn):
        """One call timed by CUDA events, without a warm-up call: for the
        plain twins, launch-bound PyTorch with nothing to warm, some taking
        seconds."""
        torch.cuda.synchronize()
        a_ = torch.cuda.Event(enable_timing=True)
        b_ = torch.cuda.Event(enable_timing=True)
        a_.record()
        fn()
        b_.record()
        torch.cuda.synchronize()
        return a_.elapsed_time(b_)

    def bn_entry(kid, name, source, replaces, shape, ms, plain_ms, bound,
                 **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": "merlin_zkevm_prover_tpu_torch/csrc/" + source,
            "replaces": "merlin_zkevm_prover_tpu/" + replaces,
            "pallas_kernel": False, "shape": shape,
            "launches": sum(bn_launches[kid].values()),
            "launches_by_kernel": bn_launches[kid],
            "max_abs_err": bn_worst[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "per_final_proof_device_ms": final_line["device_ms"][kid],
            **extra})

    h1, w1 = max(fin_shapes["leaf"], key=lambda s: s[0] * max(s[1], 1))
    rows1 = bnt.gl_rows(h1, w1, gen_bn, dev)
    ends1 = bnt._ends(rows1, cap)
    n1 = max(fin_shapes["node"])
    lvl1 = bnt.field_elems(bf.FR, n1, gen_bn, dev)
    bn_entry("B1", "poseidon_bn254_leaf+node", "poseidon_bn254.cu",
             "ops/poseidon_bn254.py:69", [h1, w1],
             time_ms(lambda: pbc.leaf_hash(rows1), 1),
             once_ms(lambda: pbc.leaf_hash_plain(ends1)),
             bnt.bound_leaf(h1, w1), plain_held=[ends1.shape[0], w1],
             bound_ms_cios=bnt.bound_leaf_cios(h1, w1)[0],
             node_shape=[n1], node_ms=time_ms(lambda: pbc.node_hash(lvl1), 1),
             node_plain_ms=once_ms(lambda: pbc.node_hash_plain(
                 lvl1[:16 * cap])), node_plain_held=[16 * cap],
             node_bound_ms=bnt.bound_node(n1)[0],
             node_bound_ms_cios=bnt.bound_node_cios(n1)[0],
             also_replaces="merlin_zkevm_prover_tpu/stark/merkle_bn128.py:22")
    del rows1, ends1, lvl1
    torch.cuda.empty_cache()
    # B2: one NTT at the path's largest size (n2b = 2^24), the powers and
    # the fused poly_eval at that size; B3: the witness-shaped G1 MSM over
    # the final key's table A (14,008,649 points) at the card's window
    n2b = max(n for n, _inv in fin_shapes["pass"])
    a2 = bf.to_mont(bf.FR, bnt.field_elems(bf.FR, n2b, gen_bn, dev))
    x2 = 0x1234567 << 200 | 0x89ABCDEF
    w2 = bn_fft.w_fr(n2b.bit_length() - 1)
    bn_entry("B2", "bn254_ntt", "bn254_ntt.cu", "snark/fft.py:56", [n2b],
             time_ms(lambda: bn_fft.fft(a2), 3),
             once_ms(lambda: bn_fft._ntt_plain(a2, False)),
             bnt.bound_ntt(n2b), tile_bits=bn_fft.NTT_TILE_BITS,
             passes=len(bn_fft.ntt_passes(n2b.bit_length() - 1)),
             powers_shape=[n2b],
             powers_ms=time_ms(lambda: bn254_cuda.powers(w2, n2b, 1, dev), 3),
             powers_plain_ms=once_ms(lambda: bn254_cuda.powers_plain(
                 w2, n2b, 1, dev)),
             powers_bound_ms=bnt.bound_powers(n2b)[0],
             poly_eval_shape=[n2b],
             poly_eval_ms=time_ms(lambda: bn254_cuda.poly_eval(a2, x2), 3),
             poly_eval_plain_ms=once_ms(lambda: bn254_cuda.poly_eval_plain(
                 a2, x2)),
             poly_eval_bound_ms=bnt.bound_poly_eval(n2b)[0],
             mont_mul_ms=time_ms(lambda: bn254_cuda.mont_mul(bf.FR, a2, a2), 3),
             mont_mul_bound_ms=bnt.bound_mont_mul(n2b)[0],
             per_final_proof_bound_ms=bnt.bound_launches("B2", fin_shapes)[0])
    del a2
    torch.cuda.empty_cache()
    n3 = final_key.n_vars
    s3 = bnt.scalars_like_witness(n3, gen_bn, dev)
    pts3 = final_key.points_a
    sub3 = torch.cat([torch.arange(cap), torch.arange(n3 - cap, n3)]).to(dev)
    c3 = bn_msm.window(n3)
    # the bound at the window whose schedule needs the fewest products
    c3_least = bnt.least_window(bn_curve.F1, s3)[0]
    c3_plain = bn_msm.pick_window(2 * cap)
    jac3 = bn_msm.jacobian_words(bn_curve.F1, pts3)
    bn_entry("B3", "bn254_msm", "bn254_msm.cu", "snark/msm.py:57", [n3],
             time_ms(lambda: bn_msm.msm(bn_curve.F1, pts3, s3), 3),
             once_ms(lambda: bn_msm.msm_plain(bn_curve.F1, pts3[sub3],
                                                s3[sub3], c=c3_plain)),
             bnt.bound_msm(bn_curve.F1, s3, c3_least), plain_held=[2 * cap],
             c=c3, bound_c=c3_least,
             bound_ms_at_c=bnt.bound_msm(bn_curve.F1, s3, c3)[0],
             plain_c=c3_plain,
             bound_ms_unsigned=bnt.bound_msm_unsigned(bn_curve.F1, s3, 12)[0],
             group="G1", scalars="seeded, shaped like the final witness",
             also_source="merlin_zkevm_prover_tpu_torch/csrc/bn254_msm_sums.cu",
             affine_ms=time_ms(lambda: bn_msm.affine_bases(bn_curve.F1, jac3),
                               3),
             affine_bound_ms=bnt.bound_affine(bn_curve.F1, n3)[0],
             per_final_proof_bound_ms=bnt.bound_launches("B3", fin_shapes)[0])
    del s3, pts3, jac3
    torch.cuda.empty_cache()
    s4 = bnt.field_elems(bf.FR, n3, gen_bn, dev)
    sub4 = torch.cat([torch.arange(cap_pts), torch.arange(n3 - cap_pts, n3)]
                     ).to(dev)
    g1_ = bn_curve.g1_generator(dev)
    bn_entry("B4", "bn254_fixed_base", "bn254_fixed_base.cu",
             "snark/curve.py:269",
             [n3], time_ms(lambda: bn_curve.scalar_mul_table(bn_curve.F1, g1_,
                                                             s4), 2),
             once_ms(lambda: bn_curve.scalar_mul_table_plain(
                 bn_curve.F1, g1_, s4[sub4])),
             bnt.bound_fixed_base(bn_curve.F1, s4), plain_held=[2 * cap_pts],
             bound_ms_set_bits=bnt.bound_fixed_base_set_bits(bn_curve.F1, s4)[0],
             group="G1", w=bn_curve.FB_WINDOW)
    del s4, final_key
    torch.cuda.empty_cache()
    emit({"phase": "final_kernels", "kernels": entries[-4:]})

    # ------------------------------------------------------ golden_final
    # The JAX package's tiny final hop proven on the card: the recursiveF
    # proof of the n_bits 3 smoke circuit and its Groth16 proof with the
    # golden file's fixed blinding equal tests/data/torch_bn128_proof.json
    # and torch_groth16_final.json in every field (the key's verifying
    # points and its tables' end points too).
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_bn128_proof.json")) as fh:
        g_stark = json.load(fh)
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_groth16_final.json")) as fh:
        g_snark = json.load(fh)
    air3, trace3 = build_smoke_air(n_bits=g_stark["n_bits"], seed=g_stark["seed"])
    info3 = compile_air(air3, **g_stark["compile_air"])
    zero_counters()
    t0 = time.time()
    prover3 = StarkProverBN128(info3, smoke_const_values(air3))
    proof3 = prover3.prove(trace3)
    if prover3.const_tree.root() != g_stark["const_root"]:
        raise AssertionError("golden_final: recursiveF const root differs")
    same_proof("golden_final recursiveF", proof3,
               StarkProof.from_json(json.dumps(g_stark["proof"])))
    stage3 = FinalStage(info3, prover3.const_tree.root()[0],
                        setup_seed=g_snark["setup_seed"])
    g3 = stage3.prove(proof3, r=g_snark["r"], s=g_snark["s"])
    for k in ("pi_a", "pi_b", "pi_c", "publics"):
        if g3[k] != g_snark["proof"][k]:
            raise AssertionError(f"golden_final: Groth16 field {k} differs")
    key3 = stage3.key
    if stage3.stats["constraints"] != g_snark["n_constraints"] or \
            key3.n_vars != g_snark["n_vars"] or \
            key3.domain_bits != g_snark["domain_bits"]:
        raise AssertionError("golden_final: the R1CS shape differs")

    def one_point(F_, p_):
        a_ = bn_curve.affine_ints(F_, bn_curve.Point(*[
            bn_curve._unsqueeze1(F_, leaf) for leaf in p_]))[0]
        return json.loads(json.dumps(a_))

    for name, F_ in (("alpha1", bn_curve.F1), ("beta1", bn_curve.F1),
                     ("delta1", bn_curve.F1), ("beta2", bn_curve.F2),
                     ("delta2", bn_curve.F2)):
        if one_point(F_, getattr(key3, "vk_" + name)) != g_snark["vk"][name]:
            raise AssertionError(f"golden_final: vk {name} differs")
    for name, pts in g_snark["tables"].items():
        F_ = bn_curve.F2 if name == "points_b2" else bn_curve.F1
        table = getattr(key3, name)          # affine words (B3's bases)
        for i, want in pts.items():
            got = json.loads(json.dumps(bn_curve.affine_ints(
                F_, table[int(i):int(i) + 1])[0]))
            if got != want:
                raise AssertionError(f"golden_final: {name}[{i}] differs")
    emit({"phase": "golden_final", "seconds": time.time() - t0,
          "recursiveF_equal_to_golden": True, "groth16_equal_to_golden": True,
          "vk_and_table_ends_equal": True, "r1cs": stage3.stats,
          "launches": read_bn_counters()})
    root3 = prover3.const_tree.root()[0]
    del prover3, stage3, key3
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ fflonk
    # fflonk as the final SNARK (FinalStage(protocol="fflonk"): snark/
    # r1cs_to_plonk.py, snark/fflonk.py on B2-B4 and F1-F3).  (a) The JAX
    # package's two golden fflonk proofs (tests/data/torch_fflonk_n8.json,
    # torch_fflonk_plonk.json) proven on the card equal the files.  (b) The
    # golden tiny hop's recursiveF proof (proof3 above) through
    # FinalStage(protocol="fflonk").prove: a 2^21-row PLONK form, verified,
    # two tampered proofs rejected.  (c) Phase final's production R1CS: its
    # PLONK size counted; when its 4n domain exceeds Fr's two-adicity,
    # FinalStage's ValueError is asserted; then the longest prefix of its
    # constraints (the same witness and publics) whose PLONK form fills
    # n = 2^FFLONK_PREFIX_BITS is proven and verified.  (b) and (c) run
    # under torch.profiler with every counter set to 0 just before each and
    # read just after: spans, launches, each kernel's device ms, peaks.
    kernel_of = {**bn_kernel_of, **fft_.KERNEL_OF}
    ff_shapes: dict = {}         # every F1-F3 and B3 shape of the phase
    t_ff = time.time()

    def keep_shapes():
        for shapes in (ffk.SHAPES, bn_msm.SHAPES, bn_curve.SHAPES,
                       bn254_cuda.SHAPES, bn_fft.SHAPES):
            for k, v in shapes.items():
                rec_ = ff_shapes.setdefault(k, {})
                for s_, c_ in v.items():
                    rec_[s_] = rec_.get(s_, 0) + c_

    def same_fflonk(what, key_, proof_, doc):
        c0 = ffl.fr_ints(key_.c0_coefs)
        got = {"C0": key_.C0, "x2": key_.x2, "w": key_.w, "c0_len": len(c0),
               "c0_head": c0[:8], "c0_tail": c0[-8:]}
        if json.loads(json.dumps(got)) != doc["key"]:
            raise AssertionError(f"fflonk {what}: the key differs")
        p_ = {k: proof_[k] for k in ("C1", "C2", "W1", "W2", "publics")}
        p_["evals"] = dict(proof_["evals"])
        for k, v in json.loads(json.dumps(p_)).items():
            if v != doc["proof"][k]:
                raise AssertionError(f"fflonk {what}: field {k} differs")

    def fflonk_run(what, fn):
        """fn(tlog) -> (stage, proof) under the profiler, counters at 0:
        (stage, proof, the phase's line, the F1-F3 and B3 shapes)."""
        zero_counters()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        tlog = TimerLog("chip_smoke:fflonk", quiet=True, peak_memory=True)
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stage_, proof_ = fn(tlog)
            torch.cuda.synchronize()
        total = time.time() - t0
        launches_ = {"F": dict(ffk.LAUNCHES), **{
            b: d for b, d in read_bn_counters().items() if b != "B1"}}
        keep_shapes()
        shapes_ = {k: dict(v) for s_ in (ffk.SHAPES, bn_msm.SHAPES,
                                          bn_curve.SHAPES, bn254_cuda.SHAPES,
                                          bn_fft.SHAPES)
                   for k, v in s_.items()}
        by_kernel = fft_.kernel_device_ms(prof)
        del prof
        unknown = sorted(k for k in by_kernel if k not in kernel_of)
        if unknown:
            raise AssertionError(f"fflonk {what}: kernels {unknown} are not "
                                 "among B1-B4, F1-F3")
        for b, d in launches_.items():
            if sum(d.values()) <= 0:
                raise AssertionError(f"fflonk {what}: kernel {b} was never "
                                     "launched")
        for kid, keys_ in (("F1", ("scan",)), ("F2", ("inv",)),
                           ("F3", ("quotient",))):
            if sum(launches_["F"][k] for k in keys_) <= 0:
                raise AssertionError(f"fflonk {what}: {kid} was never "
                                     "launched")
        if not proof_["verified"]:
            raise AssertionError(f"fflonk {what}: not verified")
        rejected = {k: not ffl.fflonk_verify(stage_.key, bad)
                    for k, bad in fft_.tampered(proof_).items()}
        if not all(rejected.values()):
            raise AssertionError(f"fflonk {what}: a tampered proof was "
                                 f"accepted: {rejected}")
        ids = sorted({kernel_of[k] for k in by_kernel})
        counted = {b: sum(launches_[b].values()) for b in ("B2", "B3", "B4")}
        profiled = {b: sum(d["launches"] for k, d in by_kernel.items()
                           if kernel_of[k] == b) for b in counted}
        if profiled != counted:
            raise AssertionError(f"fflonk {what}: torch.profiler's launches "
                                 f"{profiled} differ from the counters "
                                 f"{counted}")
        line = {"case": what, "stats": dict(stage_.stats), "total_s": total,
                "spans_s": tlog.as_dict(), "span_peak_bytes": dict(tlog.peaks),
                "peak_memory_bytes": max(tlog.peaks.values()),
                "host_max_rss_bytes": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024,
                "launches": launches_,
                "device_ms": {b: sum(d["ms"] for k, d in by_kernel.items()
                                     if kernel_of[k] == b) for b in ids},
                "device_ms_by_kernel": by_kernel,
                "profiled_launches": {b: sum(
                    d["launches"] for k, d in by_kernel.items()
                    if kernel_of[k] == b) for b in ids},
                "bound_ms": {**{b: bnt.bound_launches(b, shapes_)[0]
                                for b in ("B2", "B3")},
                             **{f: fft_.bound_launches(f, shapes_)[0]
                                for f in ("F1", "F2", "F3")}},
                "verified": True, "tampered_rejected": rejected,
                "launched_shapes": {k: sorted(
                    [[list(s_) if isinstance(s_, tuple) else s_, c_]
                     for s_, c_ in v.items()], key=str)
                    for k, v in shapes_.items()}}
        return stage_, proof_, line, shapes_

    # (a) the golden fflonk proofs
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_fflonk_n8.json")) as fh:
        g_n8 = json.load(fh)
    with open(os.path.join(root_dir, "tests", "data",
                           "torch_fflonk_plonk.json")) as fh:
        g_pl = json.load(fh)
    zero_counters()
    t0 = time.time()
    circ = g_n8["circuit"]
    key_a = ffl.fflonk_setup(ffl.PlonkCS(**circ["cs"]), seed=g_n8["seed"],
                             device=dev)
    same_fflonk("n8 (golden)", key_a, ffl.fflonk_prove(
        key_a, circ["a"], circ["b"], circ["c"],
        rand=bytes.fromhex(g_n8["rand"])), g_n8)
    r1cs_a = R1CS(n_vars=g_pl["r1cs"]["n_vars"],
                  n_public=g_pl["r1cs"]["n_public"],
                  **{m: [{int(s_): int(k_) for s_, k_ in row}
                         for row in g_pl["r1cs"][m]] for m in "abc"})
    stage_a = FinalStage(None, 0, setup_seed=g_pl["seed"], protocol="fflonk")
    proof_a = stage_a._prove_fflonk(r1cs_a, g_pl["witness"],
                                    rand=bytes.fromhex(g_pl["rand"]))
    same_fflonk("plonk (golden)", stage_a.key, proof_a, g_pl)
    keep_shapes()
    del key_a, stage_a, proof_a, r1cs_a
    ff_lines = [{"case": "golden", "n8_equal_to_golden": True,
                 "plonk_equal_to_golden": True, "plonk_n": g_pl["n"],
                 "seconds": time.time() - t0}]

    # (b) the golden tiny hop through the user's entry point
    stage_b, proof_b, line_b, b_shapes = fflonk_run(
        "golden hop (FinalStage.prove)", lambda tlog: (lambda st: (
            st, st.prove(proof3, timer=tlog)))(
            FinalStage(info3, root3, protocol="fflonk")))
    ff_lines.append(line_b)
    del stage_b, proof_b, proof3
    torch.cuda.empty_cache()

    # (c) the production R1CS: its size, the refusal, the prefix
    r1cs_p, wit_p = prod_r1cs
    del prod_r1cs
    # one count of its PLONK gates, inside FinalStage's route (kept by
    # keep_r1cs); the route must refuse a 4n domain above Fr's two-adicity
    t0 = time.time()
    st = FinalStage(None, 0, protocol="fflonk", keep_r1cs=True)
    refused = None
    try:
        st._prove_fflonk(r1cs_p, wit_p)
    except ValueError as e:
        refused = str(e)
    n_p = st.stats["plonk_n"]
    line_c = {"case": "production R1CS", "constraints": len(r1cs_p.a),
              "plonk_gates": st.stats["plonk_gates"], "plonk_n": n_p,
              "plonk_log_n": n_p.bit_length() - 1, "count_s": time.time() - t0,
              "domain_4n_log": (4 * n_p).bit_length() - 1,
              "srs_points_needed": 9 * n_p + 32, "refused": refused}
    if 4 * n_p > 1 << ffl.TWO_ADICITY and (
            refused is None or "two-adicity" not in refused or
            st.key is not None):
        raise AssertionError("fflonk: the production R1CS was not refused "
                             f"before its setup: {refused}")
    per_p = st.plonk_gates
    del st
    t0 = time.time()
    pre = fft_.prefix_r1cs(r1cs_p, wit_p, FFLONK_PREFIX_BITS, per_p)
    del r1cs_p, wit_p, per_p
    if pre is None:
        raise AssertionError("fflonk: the production R1CS is smaller than "
                             f"2^{FFLONK_PREFIX_BITS} PLONK rows")
    r1cs_c, wit_c, m_c = pre
    del pre
    line_c["prefix_constraints"] = m_c
    line_c["prefix_s"] = time.time() - t0       # the cut, the full R1CS freed
    ff_lines.append(line_c)
    stage_c, proof_c, line_c2, _ = fflonk_run(
        f"production prefix (n = 2^{FFLONK_PREFIX_BITS})",
        lambda tlog: (lambda st: (st, st._prove_fflonk(r1cs_c, wit_c,
                                                       timer=tlog)))(
            FinalStage(None, 0, protocol="fflonk")))
    ff_lines.append({**line_c2, "prefix_constraints": m_c})
    del r1cs_c, wit_c, proof_c
    for line_ in ff_lines:
        emit({"phase": "fflonk", **line_})

    # ------------------------------------------------------- fflonk_holds
    # F1-F3 against their plain twins, exactly, at every distinct shape of
    # phase fflonk (the wrappers' SHAPES records): scans with the identity
    # between the first and last 64 rows, the twin on those rows of the
    # first and last 64 chains, the rows between checked equal to the row
    # the scan enters them by; inverses on the first and last 4096
    # elements and four whole blocks with zeros at the edges of runs and
    # blocks (seeded, edge values 0, 1, r - 1 at both ends); quotient parts
    # on the first and last 4096 points, a whole block and 4096 seeded
    # points; then F2 and F3 at the edges of their blocks.  B2's NTT
    # passes, powers and fused poly_eval, and B3's batch-to-affine, digit
    # kernels, bucket sums and reduce, at every logged shape. B3 at full
    # random scalars: at every distinct G1 point count of the phase (the
    # card's window), over the prefix key's SRS (tau^i G) with every scalar
    # full and random, against [sum s_i tau^i] G (the scalar in Fr on the
    # card, the point in python ints); at the largest, with full scalars on
    # the first and last 4096 points and zero between, against msm_plain on
    # those.
    ff_holds = []
    ff_worst = {"F1": 0, "F2": 0, "F3": 0, "B2": 0, "B3": 0, "B4": 0}

    hold_clock[0] = time.time()

    def ff_hold(kid, res):
        res = {**res, "kernel_id": kid,
               "s": round(time.time() - hold_clock[0], 2)}
        hold_clock[0] = time.time()
        ff_holds.append(res)
        ff_worst[kid] = max(ff_worst[kid], res["max_abs_err"])
        if res["max_abs_err"] != 0:
            raise AssertionError(f"fflonk_holds: {res} differs")

    gen_ff = torch.Generator(device=dev)
    gen_ff.manual_seed(2029)
    for (length, k, op, backward) in sorted(ff_shapes.get("scan", {})):
        ff_hold("F1", fft_.hold_scan(length, k, op, backward, gen_ff, dev))
    for res in fft_.inv_holds(sorted(ff_shapes.get("inv", {})), gen_ff, dev):
        ff_hold("F2", res)
    for (part, n) in sorted(ff_shapes.get("quotient", {})):
        ff_hold("F3", fft_.hold_quotient(part, n, gen_ff, dev))
        torch.cuda.empty_cache()
    for res in fft_.quotient_edge_holds(gen_ff, dev):
        ff_hold("F3", res)
    # B2: the NTT sizes above final_holds' 2^24, the powers and poly_eval
    for (n, inverse) in sorted(ff_shapes.get("pass", {})):
        if n > 1 << 24:
            a = bf.to_mont(bf.FR, bnt.field_elems(bf.FR, n, gen_ff, dev))
            ff_hold("B2", bnt.hold_ntt(a, inverse))
            del a
            torch.cuda.empty_cache()
    # powers: one base a logged length (the launches differ in their
    # length; the bases are data)
    for n, (base, start) in sorted({n: (b_, st) for (b_, n, st) in
                                    ff_shapes.get("powers", {})}.items()):
        ff_hold("B2", bnt.hold_powers(base, n, start, dev))
    for (m, stride) in sorted(ff_shapes.get("poly_eval", {})):
        ff_hold("B2", bnt.hold_poly_eval(m, gen_ff, dev, stride))
    torch.cuda.empty_cache()
    b3_new_holds(ff_shapes, gen_ff, ff_hold)
    srs_c = stage_c.key.srs_g1
    tau_c = int.from_bytes(ffl.keccak256(b"fflonk-dev-srs" + stage_c.setup_seed
                                         .to_bytes(8, "big")), "big") % bf.FR.mod
    g1_counts = sorted(n for (grp, n, _c) in ff_shapes.get("digits", {})
                       if grp == "G1")
    for n in g1_counts:
        ff_hold("B3", fft_.hold_commit_full(srs_c, tau_c, n, gen_ff, dev))
        torch.cuda.empty_cache()
    # B4 (the SRS) launched at every scalar count of the phase, full random
    # scalars, its first and last 512 results held against the twin
    for (grp, n) in sorted(ff_shapes.get("fixed_base", {})):
        F_ = bn_curve.F2 if grp == "G2" else bn_curve.F1
        ff_hold("B4", bnt.hold_fixed_base(
            F_, bnt._one_gen(F_, dev), bnt.field_elems(bf.FR, n, gen_ff, dev),
            512))
        torch.cuda.empty_cache()
    n_big = g1_counts[-1]
    s_big = torch.zeros((n_big, 4), dtype=torch.int64, device=dev)
    sel_big = fft_._ends_idx(n_big, 4096, dev)
    s_big[sel_big] = bnt.field_elems(bf.FR, sel_big.numel(), gen_ff, dev)
    ff_hold("B3", {**bnt.hold_msm(bn_curve.F1, srs_c[:n_big], s_big,
                                  c=bn_msm.window(n_big)),
        "scalars": "full random on the first and last 4096, zero between"})
    del s_big, sel_big, srs_c, stage_c
    torch.cuda.empty_cache()
    emit({"phase": "fflonk_holds", "mismatches": 0, "holds": ff_holds,
          "seconds": time.time() - t_ff})

    # F1-F3's entries: one launch at the largest shape phase fflonk (b)
    # gave each, the twin on what its hold takes; launches: (b)'s, and
    # (c)'s beside them.  B2-B4's entries gain their fflonk launches and
    # device ms.
    ff_b, ff_c = ff_lines[1], ff_lines[-1]
    fl_b = ff_b["launches"]["F"]
    for e in entries:
        kid = {"bn254_ntt": "B2", "bn254_msm": "B3",
               "bn254_fixed_base": "B4"}.get(e["name"])
        if kid:
            e["fflonk_launches"] = sum(ff_b["launches"][kid].values())
            e["fflonk_device_ms"] = ff_b["device_ms"].get(kid, 0.0)
            e["fflonk_prefix_launches"] = sum(ff_c["launches"][kid].values())
            e["fflonk_prefix_device_ms"] = ff_c["device_ms"].get(kid, 0.0)
            e["fflonk_prefix_launches_by_kernel"] = ff_c["launches"][kid]
            if kid in ("B2", "B3"):
                e["max_abs_err"] = max(e["max_abs_err"], ff_worst[kid])
                e["fflonk_bound_ms"] = ff_b["bound_ms"][kid]
                e["fflonk_prefix_bound_ms"] = ff_c["bound_ms"][kid]

    def ff_entry(kid, name, launches_, shape, ms, plain_ms, bound, **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": "merlin_zkevm_prover_tpu_torch/csrc/bn254_fflonk.cu",
            "replaces": "merlin_zkevm_prover_tpu/snark/fflonk.py:" + extra.pop(
                "line"),
            "pallas_kernel": False, "shape": shape, "launches": launches_,
            "max_abs_err": ff_worst[kid], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "per_fflonk_proof_device_ms": ff_b["device_ms"].get(kid, 0.0),
            "per_fflonk_proof_bound_ms": ff_b["bound_ms"][kid],
            "prefix_bound_ms": ff_c["bound_ms"][kid],
            "prefix_launches": sum(ff_c["launches"]["F"][k] for k in (
                ("scan", "scan_carry") if kid == "F1" else
                ("inv",) if kid == "F2" else ("quotient",))),
            "prefix_device_ms": ff_c["device_ms"].get(kid, 0.0), **extra})

    length1, k1, op1, bw1 = max(b_shapes["scan"], key=lambda s_: s_[0])
    x1 = fft_._mont_elems(length1, gen_ff, dev, no_zero=True)
    x1s = x1[:8192]
    ff_entry("F1", "bn_fr_scan", fl_b["scan"] + fl_b["scan_carry"],
             [length1, k1, op1, "backward" if bw1 else "forward"],
             time_ms(lambda: ffk.scan(x1, k1, op1, bw1), 3),
             once_ms(lambda: ffk.scan_plain(x1s, min(k1, 64), op1, bw1)),
             fft_.bound_scan(length1, op1), line="117",
             plain_held=[8192, min(k1, 64)],
             launches_by_kernel={"scan": fl_b["scan"],
                                 "scan_carry": fl_b["scan_carry"]})
    del x1, x1s
    n2_ = max(b_shapes["inv"])
    x2_ = fft_._mont_elems(n2_, gen_ff, dev)
    ff_entry("F2", "bn_fr_inv", fl_b["inv"], [n2_],
             time_ms(lambda: ffk.inv(x2_), 3),
             once_ms(lambda: ffk.inv_plain(x2_[:8192])),
             fft_.bound_inv(n2_), line="366", plain_held=[min(n2_, 8192)],
             bound_ms_fermat=fft_.bound_inv_fermat(n2_)[0],
             block=[ffk.geometry()[k] for k in ("inv_threads", "inv_run")])
    del x2_
    part3, n3_ = max(b_shapes["quotient"], key=lambda s_: (s_[1], s_[0]))
    cols3, consts3 = fft_.quotient_inputs(part3, n3_, gen_ff, dev)
    rows3 = fft_._ends_idx(n3_, 4096, dev)
    ff_entry("F3", "bn_fflonk_quotient", fl_b["quotient"], [part3, n3_],
             time_ms(lambda: ffk.quotient(part3, cols3, **consts3), 3),
             once_ms(lambda: ffk.quotient_plain(part3, cols3, **consts3,
                                                rows=rows3)),
             fft_.bound_quotient(part3, n3_), line="326",
             plain_held=[int(rows3.numel())],
             block=[ffk.geometry()["quotient_threads"],
                    ffk.geometry()["quotient_run"] if part3 else 1])
    del cols3, rows3
    torch.cuda.empty_cache()
    emit({"phase": "fflonk_kernels", "kernels": entries[-3:]})


    emit({"phase": "main_path_shapes_check", "mismatches": 0,
          "cases": [c for c in checks
                    if c["case"].startswith(("main path", "path",
                                             "recursion path"))]})
    emit({"phase": "done", "seconds": time.time() - t_start, "card": card})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--edge-holds"]:
        print(json.dumps(edge_holds(torch.device("cuda"))), flush=True)
        sys.exit(0)
    sys.exit(main(kernel_holds_only=sys.argv[1:] == ["--kernel-holds"]))
