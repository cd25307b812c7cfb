"""The port's expression-program VM (stark/vm.py, ops/vm_cuda.py) against
the JAX package's, at n_bits = 5.

Tolerance: none.  Compilation is host code and must give the same program
(code, registers, constant table, preloads, outputs); execution is exact
field arithmetic and must give the same words.  The interpreter kernel runs
only on the card; here a python-int transcription of csrc/vm_gl.cu runs on
the very launch arguments the wrapper builds (``_vm_fields``) and is held
against the plain interpreter.
"""

import numpy as np
import pytest
import torch

# the suite runs several workers side by side: one thread each
torch.set_num_threads(1)

from field_oracle import P, gl3_mul  # noqa: E402
from merlin_zkevm_prover_tpu.models.smoke import build_smoke_air as ref_build  # noqa: E402
from merlin_zkevm_prover_tpu.ops import goldilocks as jgl  # noqa: E402
from merlin_zkevm_prover_tpu.ops import goldilocks3 as jgl3  # noqa: E402
from merlin_zkevm_prover_tpu.stark import AIR as RefAIR  # noqa: E402
from merlin_zkevm_prover_tpu.stark import compile_air as ref_compile  # noqa: E402
from merlin_zkevm_prover_tpu.stark import device_core as jcore  # noqa: E402
from merlin_zkevm_prover_tpu.stark import vm as jvm  # noqa: E402
from merlin_zkevm_prover_tpu_torch.models.smoke import build_smoke_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import goldilocks as gl  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import goldilocks3 as gl3  # noqa: E402
from merlin_zkevm_prover_tpu_torch.ops import vm_cuda  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import AIR, compile_air  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import device_core as core  # noqa: E402
from merlin_zkevm_prover_tpu_torch.stark import vm  # noqa: E402
from merlin_zkevm_prover_tpu_torch.tools.vm_times import random_program  # noqa: E402

CPU = "cpu"
N_BITS = 5
SETTINGS = dict(n_queries=6, final_bits=3, fri_fold_bits=2)
_M64 = (1 << 64) - 1
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)]


def high_degree_air(air_cls, n_bits=N_BITS):
    """tests/test_staged_prover.py's degree-8 product circuit: the degree
    lowering gives nested cm3 ims whose expressions read earlier ims."""
    air = air_cls("highdeg", n_bits)
    rng = np.random.default_rng(7)
    cols = [air.committed(f"a{j}") for j in range(8)]
    prod = air.committed("prod")
    e = cols[0]
    for c in cols[1:]:
        e = e * c
    air.constraint(prod - e)
    vals = rng.integers(1, P, (air.n, 8), dtype=np.uint64)
    pv = np.ones(air.n, dtype=object)
    for j in range(8):
        pv = pv * vals[:, j].astype(object) % P
    return air, np.concatenate([vals, pv.astype(np.uint64)[:, None]], axis=1)


def _circuits(name):
    if name == "smoke":
        return (build_smoke_air(n_bits=N_BITS, seed=42)[0],
                ref_build(n_bits=N_BITS, seed=42)[0])
    return high_degree_air(AIR)[0], high_degree_air(RefAIR)[0]


@pytest.fixture(scope="module", params=["smoke", "highdeg"])
def infos(request):
    air, rair = _circuits(request.param)
    return request.param, compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS)


# the three step programs as the prover compiles them
STEPS = {
    2: lambda mod, info: mod.compile_program(info.step2prev, info, "n",
                                             ["cm1_n", "const"]),
    3: lambda mod, info: mod.compile_program_ordered(
        info.step3prev, info, "n", ["cm1_n", "cm2_n", "const"]),
    4: lambda mod, info: mod.compile_program(
        [(("acc", 0), info.c_exp)], info, "ext",
        ["cm1_2ns", "cm2_2ns", "cm3_2ns", "const"]),
}
SMOKE_SIZES = {2: (2, 2), 3: (45, 10), 4: (146, 6)}   # instructions, registers


@pytest.mark.parametrize("step", sorted(STEPS))
def test_program_equals_reference(infos, step):
    name, info, rinfo = infos
    got, want = STEPS[step](vm, info), STEPS[step](jvm, rinfo)
    assert np.array_equal(got.code, want.code)
    assert got.code.dtype == want.code.dtype == np.int32
    assert got.n_regs == want.n_regs
    assert got.consts == want.consts
    assert got.preload == want.preload
    assert got.out_regs == want.out_regs
    assert got.sections == want.sections
    if name == "smoke":
        assert (len(got.code), got.n_regs) == SMOKE_SIZES[step]


@pytest.mark.parametrize("step", sorted(STEPS))
def test_const_table_equals_reference(infos, step):
    """The table's derived entries, evaluated in order on the host in
    python ints, against the reference's device evaluation."""
    _, info, rinfo = infos
    prog, rprog = STEPS[step](vm, info), STEPS[step](jvm, rinfo)
    rng = np.random.default_rng(10 + step)
    ch = rng.integers(0, P, (8, 3), dtype=np.uint64)
    ch[0] = EDGE[3:]
    pub = rng.integers(0, P, (max(info.n_publics, 1),), dtype=np.uint64)
    ev = rng.integers(0, P, (len(info.ev_map), 3), dtype=np.uint64)
    got = vm.build_const_table(prog, gl3.from_u64(ch, CPU),
                               gl.from_u64(pub, CPU), gl3.from_u64(ev, CPU))
    lo, hi = jvm.build_const_table(rprog, jgl3.from_u64(ch), jgl.from_u64(pub),
                                   jgl3.from_u64(ev))
    want = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))
    assert np.array_equal(got, want)


def test_compile_program_refuses_a_pending_read():
    """The docstring fault of the reference (stark/vm.py:76): its
    compile_program promised that a cm leaf naming an earlier dest reads
    the dest's register, and never did.  The port's asserts; the ordered
    form compiles the same program."""
    info = compile_air(high_degree_air(AIR)[0], **SETTINGS)
    dests = {d[1] for d, _e in info.step3prev if d[0] == "cm"}
    assert len(info.step3prev) > 1 and dests
    with pytest.raises(AssertionError, match="compile_program_ordered"):
        vm.compile_program(info.step3prev, info, "n",
                           ["cm1_n", "cm2_n", "cm3_n", "const"])
    prog = vm.compile_program_ordered(info.step3prev, info, "n",
                                      ["cm1_n", "cm2_n", "const"])
    assert set(prog.out_regs) == {d for d, _e in info.step3prev}


# ---------------------------------------------------------------------------
# Values: step2_vm / step3_vm / step4_vm of both packages
# ---------------------------------------------------------------------------


def _edge(a: np.ndarray) -> np.ndarray:
    """Plant the edge words across the first rows, rotated by row."""
    for j in range(min(len(EDGE), a.shape[0])):
        a[j] = np.resize(np.roll(EDGE, j), a.shape[1:]) if a.ndim > 1 else EDGE[j]
    return a


def _inputs(info, seed):
    rng = np.random.default_rng(seed)
    n, n_ext = info.n, info.n_ext
    d = {}
    for k in ("cm1", "cm2", "cm3"):
        w = info.section_widths[f"{k}_n"]
        d[f"{k}_n"] = _edge(rng.integers(0, P, (n, w), dtype=np.uint64))
        d[f"{k}_2ns"] = _edge(rng.integers(0, P, (n_ext, w), dtype=np.uint64))
    d["const_n"] = _edge(rng.integers(0, P, (n, info.n_constants), dtype=np.uint64))
    d["const_2ns"] = _edge(rng.integers(0, P, (n_ext, info.n_constants),
                                        dtype=np.uint64))
    d["ch"] = rng.integers(0, P, (8, 3), dtype=np.uint64)
    d["pub"] = rng.integers(0, P, (info.n_publics,), dtype=np.uint64)
    d["x_n"] = gl.powers_np(gl.w(info.n_bits), n)
    d["x_2ns"] = gl.powers_np(gl.w(info.n_bits_ext), n_ext, start=gl.SHIFT)
    d["zi"] = _edge(rng.integers(1, P, (n_ext,), dtype=np.uint64))
    return d


def _port(d):
    return {k: (gl3.from_u64(v, CPU) if k == "ch" else gl.from_u64(v, CPU))
            for k, v in d.items()}


def _ref(d):
    return {k: (jgl3.from_u64(v) if k == "ch" else jgl.from_u64(v))
            for k, v in d.items()}


def _run_step(mod, step, info, prog, t):
    if step == 2:
        return mod.step2_vm(info, prog, {"cm1_n": t["cm1_n"]}, t["const_n"],
                            t["ch"], t["pub"], t["x_n"])
    if step == 3:
        return mod.step3_vm(info, prog, {"cm1_n": t["cm1_n"], "cm2_n": t["cm2_n"]},
                            t["const_n"], t["ch"], t["pub"], t["x_n"])
    secs = {k: t[k] for k in ("cm1_2ns", "cm2_2ns", "cm3_2ns")}
    return mod.step4_vm(info, prog, secs, t["const_2ns"], t["ch"], t["pub"],
                        t["x_2ns"], t["zi"])


@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_vm_equals_reference(step):
    """Smoke circuit only: the reference's VM cannot trace a program whose
    section list holds a zero-width section (vm.py:440; the high-degree
    circuit has no constants and no cm2), which the port's runs."""
    air, rair = _circuits("smoke")
    info, rinfo = compile_air(air, **SETTINGS), ref_compile(rair, **SETTINGS)
    d = _inputs(info, 30 + step)
    got = _run_step(core, step, info, STEPS[step](vm, info), _port(d))
    want = _run_step(jcore, step, rinfo, STEPS[step](jvm, rinfo), _ref(d))
    if step == 4:
        assert np.array_equal(gl.to_u64(got), jgl.to_u64(want))
        return
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(gl3.to_u64(got[k]), jgl3.to_u64(want[k])), k


def _as3(v):
    return v if isinstance(v, gl3.GL3) else gl3.from_base(v)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_vm_equals_tree_evaluator(infos, step):
    """The port's VM against the port's chunked tree evaluator (held
    against the reference's in test_torch_stark_modules.py): on the
    high-degree circuit, step 3's ims read earlier ims."""
    _, info, _ = infos
    t = _port(_inputs(info, 40 + step))
    got = _run_step(core, step, info, STEPS[step](vm, info), t)
    if step == 2:
        want = core.step2_exprs_chunk(info, 0, len(info.step2prev),
                                      {"cm1_n": t["cm1_n"]}, t["const_n"],
                                      t["ch"], t["pub"], t["x_n"])
    elif step == 3:
        want = core.step3_exprs_chunk(
            info, 0, len(info.step3prev),
            {"cm1_n": t["cm1_n"], "cm2_n": t["cm2_n"]}, t["const_n"],
            t["ch"], t["pub"], t["x_n"], {})
    else:
        secs = {k: t[k] for k in ("cm1_2ns", "cm2_2ns", "cm3_2ns")}
        acc = core.step4_chunk(info, 0, len(info.step42ns), secs,
                               t["const_2ns"], t["ch"], t["pub"], t["x_2ns"],
                               t["zi"], gl3.zeros((info.n_ext,), CPU))
        want = core.step4_finalize(info, acc, t["zi"])
        assert np.array_equal(gl.to_u64(got), gl.to_u64(want))
        return
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(gl3.to_u64(got[k]), gl3.to_u64(_as3(want[k]))), k


# ---------------------------------------------------------------------------
# The kernel's launch arguments, run by a python-int model of csrc/vm_gl.cu
# ---------------------------------------------------------------------------


def _words(t):
    """The whole storage under CPU tensor `t` as python words."""
    n = t.untyped_storage().nbytes() // 8
    return [v & _M64 for v in torch.as_strided(t, (n,), (1,), 0).tolist()]


def _model_launch(f):
    """vm_run_kernel on the fields `f`, block by block, thread by thread and
    row by row of each thread, in python ints: the shared register file
    (word w of block row t at w * rows + t; the code's register operands
    are such offsets), the spilled words ((w - slots_on) * n_pad + row,
    moved by FILL and SPILL) and the flags of the typed code; writes the
    output tensor as the kernel does.  A word the kernel would read before
    writing it is None and fails the run."""
    plan, n, k = f["plan"], f["n"], f["roll_k"]
    rows, nt = plan["rows"], plan["threads"]
    on, n_pad, rpt = plan["slots_on"], plan["n_pad"], plan["rows"] // plan["threads"]
    prog, ni = f["code"].tolist(), f["n_instr"]
    code = [prog[4 * i:4 * i + 4] for i in range(ni)]
    assert prog[4 * ni:4 * ni + 4] == [0] * 4          # the prefetched row
    outs = [prog[4 * (ni + 1) + 2 * o:4 * (ni + 1) + 2 * o + 2]
            for o in range(f["n_out"])]
    tab = [tuple(v & _M64 for v in row) for row in f["table"].tolist()]
    secs = [(_words(s), s.storage_offset(), rs, cs) for s, rs, cs in f["secs"]]
    pre = [(w, [(_words(t), t.storage_offset(), st) for t, st in comps])
           for w, comps in f["pre"]]
    spill = [None] * ((plan["words"] - on) * n_pad)
    assert tuple(f["spill"].shape) == (plan["words"] - on, n_pad)
    out = [[[None] * n for _ in range(3)] for _ in outs]

    def canon(x):
        return x - P if x >= P else x

    def add(a, b):
        return tuple((x + y) % P for x, y in zip(a, b))

    def sub(a, b):
        return tuple((x - y) % P for x, y in zip(a, b))

    def mul(a, b, ab, bb):
        if ab and bb:
            return (a[0] * b[0] % P, 0, 0)
        if ab or bb:
            s, v = (a[0], b) if ab else (b[0], a)
            return tuple(s * x % P for x in v)
        return gl3_mul(a, b)

    for blk in range(plan["blocks"]):
        row0 = blk * rows
        smem = [None] * (on * rows)
        for tid in range(nt):
            for j in range(rpt):
                t = tid + j * nt
                g = row0 + t
                ie = g % n
                ir = (ie + k) % n

                def word(w):                 # prologue and epilogue
                    return ("s", w * rows + t) if w < on else \
                        ("g", (w - on) * n_pad + g)

                def put(w, v):
                    where, i = word(w)
                    (smem if where == "s" else spill)[i] = v

                def get(w):
                    where, i = word(w)
                    return (smem if where == "s" else spill)[i]

                def rd(o, base):             # the loop: shared offsets
                    assert o + (1 if base else 2 * rows + 1) <= on * rows
                    return (smem[o + t], 0, 0) if base else \
                        (smem[o + t], smem[o + rows + t], smem[o + 2 * rows + t])

                for w in range(plan["words"]):
                    put(w, 0)
                for w, comps in pre:
                    for c, (words, o, st_) in enumerate(comps):
                        put(w + c, canon(words[o + ie * st_]))
                for fw, x, y, d in code:
                    op, ab = fw & vm_cuda.OP_MASK, fw & vm_cuda.A_BASE
                    bb, db = fw & vm_cuda.B_BASE, fw & vm_cuda.D_BASE
                    if op in (vm.ADD, vm.SUB):
                        u, q = rd(x, ab or db), rd(y, bb or db)
                        v = (add if op == vm.ADD else sub)(u, q)
                    elif op == vm.MUL:
                        v = mul(rd(x, ab), rd(y, bb), ab, bb)
                    elif op == vm.ADDC:
                        v = add(rd(x, ab or db), tab[y])
                    elif op == vm.SUBC:
                        v = sub(rd(x, ab or db), tab[y])
                    elif op == vm.CSUBC:
                        v = sub(tab[y], rd(x, ab or db))
                    elif op == vm.MULC:
                        v = mul(rd(x, ab), tab[y], ab, False)
                    elif op == vm.NEG:
                        v = sub((0, 0, 0), rd(x, ab or db))
                    elif op in (vm.LOAD, vm.LOADR):
                        words, o, rs, cs = secs[x]
                        base = o + (ir if op == vm.LOADR else ie) * rs + \
                            (y >> 2) * cs
                        v = tuple(canon(words[base + c * cs]) if c == 0
                                  or y & 3 == 3 else 0 for c in range(3))
                    elif op == vm.LOADC:
                        v = tab[x]
                    elif op == vm_cuda.FILL:
                        v = tuple(spill[(x + c) * n_pad + g] if c == 0 or not db
                                  else 0 for c in range(3))
                    else:                    # SPILL
                        assert op == vm_cuda.SPILL
                        u = rd(x, db)
                        for c in range(1 if db else 3):
                            spill[(d + c) * n_pad + g] = u[c]
                        continue
                    assert d + (1 if db else 2 * rows + 1) <= on * rows
                    smem[d + t] = v[0]
                    if not db:
                        smem[d + rows + t] = v[1]
                        smem[d + 2 * rows + t] = v[2]
                if g < n:
                    for o, (w, base) in enumerate(outs):
                        for c in range(3):
                            out[o][c][g] = 0 if c and base else get(w + c)
    for o in range(len(outs)):
        for c in range(3):
            f["out"][o, c] = gl.from_u64(out[o][c], CPU)


def _inplace_sections(info, names, n, seed):
    """Each section as a view of a wider matrix (a column slice, or the
    transpose of a column-major buffer), edge words and words in
    [p, 2^64) across the first rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for j, s in enumerate(names):
        w = info.n_constants if s == "const" else \
            info.section_widths[s.replace("_2ns", "_n")]
        a = rng.integers(0, 1 << 64, (n, w + 3), dtype=np.uint64)
        a[: min(n, 8), :] = np.resize(np.array(EDGE + [P, _M64], dtype=np.uint64),
                                      (min(n, 8), w + 3))
        wide = gl.from_u64(a, CPU)
        out[s] = wide[:, 2:2 + w] if j % 2 == 0 else \
            wide.T.contiguous().T[:, 1:1 + w]
    return out


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("n_bits", [3, 4])
def test_kernel_model_runs_the_wrapper_arguments(step, n_bits):
    air = build_smoke_air(n_bits=n_bits, seed=42)[0]
    info = compile_air(air, **SETTINGS)
    prog = STEPS[step](vm, info)
    n = info.n if step < 4 else info.n_ext
    secs = _inplace_sections(info, prog.sections, n, 60 + step)
    rng = np.random.default_rng(70 + step)
    ch = gl3.from_u64(rng.integers(0, P, (8, 3), dtype=np.uint64), CPU)
    pub = gl.from_u64(rng.integers(0, P, (info.n_publics,), dtype=np.uint64), CPU)
    x = gl.from_u64(rng.integers(0, 1 << 64, (n,), dtype=np.uint64), CPU)
    zi = gl.from_u64(rng.integers(0, P, (n,), dtype=np.uint64), CPU)
    roll_k = 1 if step < 4 else 1 << info.blowup_bits
    want = vm.run_program_plain(prog, info, secs, n, challenges=ch,
                                publics=pub, x=x, zi=zi, roll_k=roll_k)

    code, table, sections, preloads = vm._launch_inputs(
        prog, secs, n, ch, pub, x, zi, None, None, None)
    f = vm_cuda._vm_fields(code, table, sections, preloads,
                           list(prog.out_regs.values()), prog.n_regs, n, roll_k)
    for (s, rs, cs), view in zip(f["secs"], sections):      # read in place
        assert s.data_ptr() == view.data_ptr()
        assert (rs, cs) == view.stride()
    assert f["roll_k"] == roll_k % n and f["n_instr"] == len(prog.code)
    _model_launch(f)
    for dest, out in zip(prog.out_regs, vm_cuda._outputs(f)):
        assert np.array_equal(gl.to_u64(out),
                              gl3.to_u64(want[dest]).T), dest


def test_kernel_model_every_opcode_and_dst_aliasing():
    """A hand-written program with every opcode, a GL3 and a base load, a
    rotated load that wraps, and destinations equal to an operand (the
    compiler recycles registers after allocating, so its own code never
    aliases; the interpreters must not depend on that)."""
    n, roll_k = 8, 3
    rng = np.random.default_rng(80)
    a = rng.integers(0, 1 << 64, (n, 6), dtype=np.uint64)
    a[:, 4] = EDGE + [P, _M64]
    sec = gl.from_u64(a, CPU)[:, 1:]                     # (n, 5) column slice
    table = gl.from_u64(rng.integers(0, P, (3, 3), dtype=np.uint64), CPU)
    x = gl3.from_u64(rng.integers(0, P, (n, 3), dtype=np.uint64), CPU)
    code = np.array([
        (vm.LOAD, 0, (1 << 2) | 3, 0),    # r0 = GL3 of columns 1..3
        (vm.LOADR, 0, (3 << 2) | 1, 1),   # r1 = column 3 rotated, base
        (vm.ADD, 0, 1, 0),                # dst == a
        (vm.MUL, 1, 0, 0),                # dst == b
        (vm.SUB, 0, 2, 2),                # r2 is the preload, dst == b
        (vm.MULC, 2, 1, 2),
        (vm.ADDC, 2, 0, 3),
        (vm.SUBC, 3, 2, 3),
        (vm.CSUBC, 3, 1, 3),
        (vm.NEG, 3, 0, 3),
        (vm.LOADC, 2, 0, 1),
        (vm.MUL, 3, 3, 3),                # a == b == dst
        (vm.ADD, 3, 1, 1),
    ], dtype=np.int32)
    args = (code, table, [sec], [(2, x)], [0, 1, 2, 3], 4, n, roll_k)
    want = vm_cuda.vm_run_plain(*args)
    f = vm_cuda._vm_fields(*args)
    _model_launch(f)
    for w, g in zip(want, vm_cuda._outputs(f)):
        assert np.array_equal(gl.to_u64(w), gl.to_u64(g))
    # the same run through the wrapper (the plain twin on the CPU)
    for w, g in zip(want, vm_cuda.vm_run(*args)):
        assert np.array_equal(gl.to_u64(w), gl.to_u64(g))


@pytest.mark.parametrize("bad,match", [
    ((12, 0, 0, 0), "opcode"),
    ((vm.ADD, 0, 4, 0), "operand register"),
    ((vm.ADD, 0, 0, 4), "destination"),
    ((vm.MULC, 0, 3, 0), "constant row"),
    ((vm.LOADC, 3, 0, 0), "constant row"),
    ((vm.LOAD, 1, 0, 0), "section"),
    ((vm.LOAD, 0, (3 << 2) | 3, 0), "past the end"),
    ((vm.LOADR, 0, (5 << 2) | 1, 0), "past the end"),
])
def test_wrapper_refuses_bad_code(bad, match):
    sec = gl.zeros((4, 5), CPU)
    table = gl.zeros((3, 3), CPU)
    code = np.array([bad], dtype=np.int32)
    with pytest.raises(ValueError, match=match):
        vm_cuda.vm_run(code, table, [sec], [], [0], 4, 4, 1)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = dict(vm_cuda.LAUNCHES)
    code = np.array([(vm.LOADC, 0, 0, 0)], dtype=np.int32)
    out = vm_cuda.vm_run(code, gl.ones((1, 3), CPU), [], [], [0], 1, 4, 1)
    assert gl.to_u64(out[0]).tolist() == [[1] * 4] * 3
    assert vm_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# The wrapper's rewrite (typing, slots) and launch plan
# ---------------------------------------------------------------------------


def _random_args(seed, n_instr, n_regs, n, roll_k):
    """vm_run's arguments for a seeded random program over n rows: column
    slices with edge words and words in [p, 2^64) across their first rows,
    one preload."""
    rng = np.random.default_rng(seed)
    widths = (7, 2, 5)
    code = random_program(rng, n_instr, n_regs, widths, 4)
    secs = []
    for w in widths:
        a = rng.integers(0, 1 << 64, (n, w + 3), dtype=np.uint64)
        a[: min(n, 8)] = np.resize(np.array(EDGE + [P, _M64], dtype=np.uint64),
                                   (min(n, 8), w + 3))
        secs.append(gl.from_u64(a, CPU)[:, 1:1 + w])
    table = gl.from_u64(rng.integers(0, P, (4, 3), dtype=np.uint64), CPU)
    pre = gl3.from_u64(rng.integers(0, 1 << 64, (n, 3), dtype=np.uint64), CPU)
    return (code, table, secs, [(n_regs - 1, pre)], list(range(n_regs)),
            n_regs, n, roll_k)


@pytest.mark.parametrize("case", ["spill", "spill_all", "ragged"])
def test_kernel_model_spills_and_ragged_n(case):
    """Registers past a small on-chip budget (spilled words in device
    memory, brought in and out by FILL and SPILL in the same kernel), and n
    not a multiple of the block's rows with LOADR wrapping across the last
    block."""
    rows_min = 32 * vm_cuda._define("VM_ROWS_PER_THREAD")
    n = 2 * rows_min + 5
    args = _random_args(90 + len(case), 120, 12, n, 7)
    budget = {"spill": 8 * rows_min * 16,
              "spill_all": 8 * rows_min * vm_cuda.TEMP_WORDS}.get(
        case, vm_cuda.SMEM_BLOCK_MAX)
    f = vm_cuda._vm_fields(*args, budget=budget)
    plan = f["plan"]
    assert plan["blocks"] * plan["rows"] > n
    if case.startswith("spill"):
        assert plan["slots_on"] < plan["words"]
        assert (plan["regs_on"] == 0) == (case == "spill_all")
        ops = f["code"][:4 * f["n_instr"]].view(-1, 4)[:, 0] & vm_cuda.OP_MASK
        assert (ops == vm_cuda.FILL).any() and (ops == vm_cuda.SPILL).any()
    else:
        assert plan["slots_on"] == plan["words"]
    _model_launch(f)
    for w, g in zip(vm_cuda.vm_run_plain(*args), vm_cuda._outputs(f)):
        assert np.array_equal(gl.to_u64(w), gl.to_u64(g))


@pytest.mark.parametrize("widths,n,budget", [
    ([1, 1], 8, vm_cuda.SMEM_BLOCK_MAX),
    ([3] * 6, 1 << 18, vm_cuda.SMEM_BLOCK_MAX),
    ([1] * 29 + [3], 1 << 18, vm_cuda.SMEM_BLOCK_MAX),
    ([3] * 32, (1 << 16) + 5, vm_cuda.SMEM_BLOCK_MAX),
    ([3] * 400, 1 << 16, vm_cuda.SMEM_BLOCK_MAX),
    ([1, 3] * 50, 1000, 8 * 64 * 20),
    ([3] * 5, 77, vm_cuda.SMEM_BLOCK_MAX),
])
def test_vm_plan_covers_rows_within_shared_memory(widths, n, budget):
    """Every row is covered exactly once by (block, thread, row of the
    thread); the shared bytes stay within a block's 232,448 and the
    budget; every register is on chip or spilled, never both."""
    rpt = vm_cuda._define("VM_ROWS_PER_THREAD")
    for budget_ in (budget, 8 * 32 * rpt * 40):
        plan = vm_cuda._vm_plan(widths, n, budget_)
        rows, nt = plan["rows"], plan["threads"]
        assert rows == nt * rpt and nt % 32 == 0
        assert nt <= vm_cuda._define("VM_MAX_THREADS")
        assert plan["n_pad"] == plan["blocks"] * rows
        assert (plan["blocks"] - 1) * rows < n <= plan["n_pad"]
        if n < 4096:
            seen = sorted(b * rows + t + j * nt for b in range(plan["blocks"])
                          for t in range(nt) for j in range(rpt))
            assert seen == list(range(plan["n_pad"]))
        assert plan["smem_bytes"] <= min(232_448, budget_)
        spills = plan["regs_on"] < len(widths)
        assert plan["slots_on"] == sum(widths[:plan["regs_on"]]) + (
            vm_cuda.TEMP_WORDS if spills else 0)
        assert plan["words"] == sum(widths) + (vm_cuda.TEMP_WORDS if spills
                                               else 0)
        assert plan["smem_bytes"] == 8 * plan["slots_on"] * rows

        def cap(r):     # room for WARPS_PER_SM warps an SM of 233,472 bytes
            blocks = max(1, vm_cuda.WARPS_PER_SM * 32 * rpt // r)
            return min(budget_, 232_448, 233_472 // blocks - 1024)
        assert plan["smem_bytes"] <= cap(rows)
        if 8 * sum(widths) * 32 * rpt <= cap(32 * rpt):
            assert not spills


def test_vm_fields_allocates_outputs_only():
    """No (R, 3, n) register file: the outputs, and spilled words only
    when the file does not fit on chip."""
    n = 64
    args = _random_args(95, 60, 10, n, 3)
    f = vm_cuda._vm_fields(*args)
    tensors = {k: v for k, v in f.items() if isinstance(v, torch.Tensor)}
    assert tuple(f["out"].shape) == (10, 3, n)
    assert f["spill"].numel() == 0
    assert set(tensors) == {"code", "table", "out", "spill"}
    assert f["code"].numel() == 4 * (60 + 1) + 2 * 10
    f = vm_cuda._vm_fields(*args, budget=8 * 64 * 12)
    plan = f["plan"]
    assert 0 < plan["slots_on"] < plan["words"]
    assert tuple(f["spill"].shape) == (plan["words"] - plan["slots_on"],
                                       plan["n_pad"])


def _rewrite_case(name, step):
    """A step program with its vm_run arguments at a small size, the
    sections column slices with edge words."""
    if name == "smoke":
        info = compile_air(build_smoke_air(n_bits=4, seed=42)[0], **SETTINGS)
    else:
        from merlin_zkevm_prover_tpu_torch.models.wide import build_wide_air
        info = compile_air(build_wide_air(n_bits=3, device="cpu")[0],
                           **SETTINGS)
    prog = STEPS[step](vm, info)
    n = info.n if step < 4 else info.n_ext
    secs = _inplace_sections(info, prog.sections, n, 100 + step)
    rng = np.random.default_rng(110 + step)
    ch = gl3.from_u64(rng.integers(0, P, (8, 3), dtype=np.uint64), CPU)
    pub = gl.from_u64(rng.integers(0, P, (max(info.n_publics, 1),),
                                   dtype=np.uint64), CPU)
    x = gl.from_u64(rng.integers(0, 1 << 64, (n,), dtype=np.uint64), CPU)
    zi = gl.from_u64(rng.integers(0, P, (n,), dtype=np.uint64), CPU)
    code, table, sections, preloads = vm._launch_inputs(
        prog, secs, n, ch, pub, x, zi, None, None, None)
    return prog, (code, table, sections, preloads,
                  list(prog.out_regs.values()), prog.n_regs, n,
                  1 if step < 4 else 1 << info.blowup_bits)


@pytest.mark.parametrize("name,step", [("smoke", 2), ("smoke", 3),
                                       ("smoke", 4), ("wide", 4)])
def test_rewritten_code_equals_original(name, step):
    """The code the kernel is launched with (typed, over slots) through
    the plain interpreter equals the program itself: a wrong base flag
    would read or leave zeros where a component is not."""
    prog, args = _rewrite_case(name, step)
    code, table, sections, preloads, out_regs, n_regs, n, roll_k = args
    lay = vm_cuda._layout(np.ascontiguousarray(code), n_regs,
                          [r for r, _ in preloads], out_regs)
    got = vm_cuda.vm_run_plain(
        lay["code"], table, sections,
        [(s, v) for s, (_r, v) in zip(lay["pre"], preloads)],
        [s for s, _b in lay["out"]], len(lay["widths"]), n, roll_k)
    for w, g in zip(vm_cuda.vm_run_plain(*args), got):
        assert np.array_equal(gl.to_u64(w), gl.to_u64(g))
    op = lay["code"][:, 0]
    if name == "wide":
        # the wide circuit's products are of two base columns: one word a
        # register, one 64-bit product a MUL
        mul = (op & vm_cuda.OP_MASK) == vm.MUL
        assert ((op[mul] & vm_cuda.D_BASE) != 0).sum() >= 0.9 * mul.sum()
        assert sum(lay["widths"]) < 2 * n_regs
