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
    """vm_run_kernel on the fields `f`, thread by thread, in python ints;
    writes the register file as the kernel does."""
    n, k = f["n"], f["roll_k"]
    code = f["code"].tolist()
    tab = [tuple(v & _M64 for v in row) for row in f["table"].tolist()]
    secs = [(_words(s), s.storage_offset(), rs, cs) for s, rs, cs in f["secs"]]
    pre = [(r, [(_words(t), t.storage_offset(), st) for t, st in comps])
           for r, comps in f["pre"]]
    regs = [[[0] * n for _ in range(3)] for _ in range(f["n_regs"])]

    def canon(x):
        return x - P if x >= P else x

    def add(a, b):
        return tuple((x + y) % P for x, y in zip(a, b))

    def sub(a, b):
        return tuple((x - y) % P for x, y in zip(a, b))

    for i in range(n):
        r = {j: (0, 0, 0) for j in range(f["n_regs"])}
        for reg, comps in pre:
            r[reg] = tuple(canon(w[o + i * st]) for w, o, st in comps)
        i_rot = i + k - n if i + k >= n else i + k
        for op, a, b, dst in code:
            if op in (vm.ADD, vm.SUB, vm.MUL):
                v = {vm.ADD: add, vm.SUB: sub, vm.MUL: gl3_mul}[op](r[a], r[b])
            elif op == vm.ADDC:
                v = add(r[a], tab[b])
            elif op == vm.SUBC:
                v = sub(r[a], tab[b])
            elif op == vm.CSUBC:
                v = sub(tab[b], r[a])
            elif op == vm.MULC:
                v = gl3_mul(r[a], tab[b])
            elif op == vm.NEG:
                v = sub((0, 0, 0), r[a])
            elif op in (vm.LOAD, vm.LOADR):
                w, o, rs, cs = secs[a]
                base = o + (i_rot if op == vm.LOADR else i) * rs + (b >> 2) * cs
                v = (tuple(canon(w[base + j * cs]) for j in range(3))
                     if b & 3 == 3 else (canon(w[base]), 0, 0))
            else:  # LOADC
                v = tab[a]
            r[dst] = v
        for j in range(f["n_regs"]):
            for c in range(3):
                regs[j][c][i] = r[j][c]
    for j in range(f["n_regs"]):
        for c in range(3):
            f["regs"][j, c] = gl.from_u64(regs[j][c], CPU)


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
