"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``nvcc -c`` per source started together, then linked into one shared
library with a plain C interface under ``build/`` and loaded with
``ctypes``.  The library's name carries a hash of the sources, so an edit
rebuilds and an unchanged tree reuses what it built.  A build or load
failure raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None  # None until built or found in build/
BUILD_LOG = ""                         # nvcc / ptxas output of the last build
SOURCE_SECONDS: dict = {}              # seconds each source took to compile


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH and under CUDA_HOME / /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link; returns the library path."""
    global BUILD_SECONDS, BUILD_LOG
    out = BUILD_DIR / f"libmerlin_kernels_{_digest()}.so"
    log = out.with_suffix(".log")
    if out.exists():
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
            BUILD_LOG = log.read_text() if log.exists() else ""
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        out_f = open(obj.with_suffix(".out"), "w+")
        procs.append((src, cmd, obj, out_f, subprocess.Popen(
            cmd, stdout=out_f, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    failed = None
    pending = dict(enumerate(procs))
    while pending:                    # note when each compile ends
        for k, (src, _cmd, _obj, _f, p) in list(pending.items()):
            if p.poll() is not None:
                SOURCE_SECONDS[src.name] = time.time() - t0
                del pending[k]
        time.sleep(0.05)
    for src, cmd, obj, out_f, p in procs:
        out_f.seek(0)
        logs.append("$ " + " ".join(cmd) + "\n" + out_f.read())
        out_f.close()
        Path(out_f.name).unlink(missing_ok=True)
        objs.append(obj)
        if p.returncode != 0 and failed is None:
            failed = cmd
    BUILD_LOG = "\n".join(logs)
    if failed is not None:
        raise RuntimeError("kernel build failed:\n" + BUILD_LOG)
    tmp = BUILD_DIR / f"{out.stem}_{os.getpid()}.tmp.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    BUILD_LOG += "\n$ " + " ".join(cmd) + "\n" + r.stdout
    if r.returncode != 0:
        raise RuntimeError("kernel link failed:\n" + BUILD_LOG)
    log.write_text(BUILD_LOG)
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_SECONDS = time.time() - t0
    return out


def variant_csrc(defines) -> Path:
    """A copy of csrc/ (under build/) with each NAME=VALUE ``#define``
    rewritten in the one source that has it: the kernels of a variant, to
    be built by setting ``CSRC`` to it before the first ``lib()``."""
    tag = "_".join(d.replace("=", "") for d in defines)
    dst = BUILD_DIR / f"csrc_{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for d in defines:
        name, value = d.split("=", 1)
        hits = 0
        for src in sorted(dst.glob("*.cu*")):
            text, n = re.subn(rf"^#define {name} .*$",
                              f"#define {name} {value}", src.read_text(),
                              flags=re.M)
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise ValueError(f"no single #define {name} in csrc/")
    return dst


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            cdll.merlin_poseidon_set_constants.argtypes = [vp]
            cdll.merlin_poseidon_set_constants.restype = ci
            cdll.merlin_permute.argtypes = [vp, vp, ll, vp]
            cdll.merlin_permute.restype = ci
            cdll.merlin_poseidon_trace.argtypes = [vp, vp, ll, ll, ci, vp]
            cdll.merlin_poseidon_trace.restype = ci
            cdll.merlin_poseidon_trace_plan.argtypes = [ll, ci, vp]
            cdll.merlin_poseidon_trace_plan.restype = ci
            cdll.merlin_linear_hash.argtypes = [vp, vp, ll, ci, vp]
            cdll.merlin_linear_hash.restype = ci
            cdll.merlin_node_hash.argtypes = [vp, vp, ll, vp, ll, vp]
            cdll.merlin_node_hash.restype = ci
            cdll.merlin_node_hash_group.argtypes = [vp, vp, ll, vp, ll, vp]
            cdll.merlin_node_hash_group.restype = ci
            cdll.merlin_merkle_top.argtypes = [vp, ll, vp]
            cdll.merlin_merkle_top.restype = ci
            cdll.merlin_ntt_block.argtypes = [vp, vp]   # NttArgs*, stream
            cdll.merlin_ntt_block.restype = ci
            cdll.merlin_vm_run.argtypes = [vp, vp]      # VmArgs*, stream
            cdll.merlin_vm_run.restype = ci
            # the BN254 kernels (B1-B4)
            for name, args in (
                    ("merlin_bn_poseidon_words", [vp, ll, ci, vp, vp]),
                    ("merlin_bn_poseidon_sponge", [vp, ll, ci, ci, ci, ci, vp,
                                                   ci, vp, vp, vp, vp]),
                    ("merlin_bn_poseidon_node", [vp, ll, vp, vp, vp, vp]),
                    ("merlin_bn_fr_ntt_pass", [vp, vp, ci, ci, ci, ci, vp, vp,
                                               vp]),
                    ("merlin_bn_fr_powers", [vp, vp, vp, ll, vp, vp]),
                    ("merlin_bn_fr_poly_eval", [vp, ll, ll, vp, vp, vp, vp, vp,
                                                vp]),
                    ("merlin_bn_mont_mul", [ci, vp, vp, ll, ll, vp, vp]),
                    ("merlin_bn_fr_mul_sub", [vp, vp, vp, ll, vp, vp]),
                    ("merlin_bn_to_affine", [ci, vp, ll, vp, vp]),
                    ("merlin_bn_msm_digits", [ci, vp, vp, ci, ll, ci, ci, ci,
                                              ci, vp, vp, vp]),
                    ("merlin_bn_msm_bucket_sums", [ci, vp, vp, vp, vp, vp, ll,
                                                   vp, vp]),
                    ("merlin_bn_sum_ranges", [ci, vp, vp, vp, vp, ll, vp, vp]),
                    ("merlin_bn_msm_reduce", [ci, vp, ci, ci, vp, vp, vp,
                                              vp]),
                    ("merlin_bn_fixed_base", [ci, vp, vp, ll, ci, vp, vp]),
                    # the fflonk kernels (F1-F3)
                    ("merlin_bn_fr_scan", [vp, ll, ll, ll, ci, ci, vp, vp, vp]),
                    ("merlin_bn_fr_scan_carry", [vp, ll, ll, ll, ci, ci, vp, vp]),
                    ("merlin_bn_fr_scan_seg", []),
                    ("merlin_bn_fr_inv", [vp, ll, vp, vp]),
                    ("merlin_bn_fflonk_quotient", [vp, ci, vp]),
                    ("merlin_bn_fflonk_geometry", [ci])):
                fn = getattr(cdll, name)
                fn.argtypes = args
                fn.restype = ci
            cdll.merlin_bn_fr_poly_eval_blocks.argtypes = [ll]
            cdll.merlin_bn_fr_poly_eval_blocks.restype = ll
            cdll.merlin_bn_fr_run_threads.argtypes = []
            cdll.merlin_bn_fr_run_threads.restype = ci
            cdll.merlin_bn_msm_reduce_threads.argtypes = [ll]
            cdll.merlin_bn_msm_reduce_threads.restype = ci
            _lib = cdll
        return _lib


def _template_args(s: str, k: int):
    """The template arguments of a mangled name from s[k] == "I": (their
    plain forms, the index past the closing "E")."""
    k += 1
    out = []
    while s[k] != "E":
        lit = re.match(r"L[ib](\d+)E", s[k:])
        cls = re.match(r"(\d+)", s[k:])
        if lit:
            out.append(lit.group(1))
            k += lit.end()
        elif cls:
            n = int(cls.group(1))
            arg = s[k + cls.end():k + cls.end() + n]
            k += cls.end() + n
            if s[k:k + 1] == "I":
                sub, k = _template_args(s, k)
                arg += "<" + ",".join(sub) + ">"
            out.append(arg)
        else:
            raise ValueError(s[k:])
    return out, k + 1


def demangle(name: str) -> str:
    """The plain name of a mangled C++ function name (_Z<len><name>...),
    with the integer, bool and class arguments of a template kernel
    (``ntt_tile_kernel<9,1>``, ``bn_sum_ranges_kernel<Pt<Fq>>``)."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    end = m.end() + int(m.group(1))
    plain = name[m.end():end]
    if name[end:end + 1] != "I":
        return plain
    try:
        args, _ = _template_args(name, end)
    except (ValueError, IndexError):
        return plain
    return plain + "<" + ",".join(args) + ">"


def resources(build_log: str) -> dict:
    """Registers and spills of every kernel, from ptxas's ``-v`` lines in a
    build log: {plain name: {"registers", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}}."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(demangle(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def count(launches: dict, shapes: dict, name: str, key) -> None:
    """One launch of kernel `name` at the shape `key`: adds one to its
    counter and to its shape record (the shapes a run launched at, which
    a check then holds against the plain versions)."""
    launches[name] += 1
    rec = shapes.setdefault(name, {})
    rec[key] = rec.get(key, 0) + 1


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
