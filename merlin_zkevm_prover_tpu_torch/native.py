"""ctypes bindings for the native host routines (native/zkio.cpp).

The library is the repository's ``native/libzkio.so``, shared with the JAX
package (one source, one build; ``make -C native`` builds it on first use
when it is missing and a toolchain is present).  Every entry point has a
pure-python fallback so the package runs without it, at reduced host
speed: the Poseidon permutation falls back to ``ops.poseidon_gl.
permute_host`` and Keccak-f to ``utils.keccak.keccak_f``.  These are host
routines with host fallbacks; none of them stands in for a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libzkio.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.u64_to_u32pair.argtypes = [u64p, u32p, u32p, ctypes.c_size_t]
    lib.u32pair_to_u64.argtypes = [u32p, u32p, u64p, ctypes.c_size_t]
    lib.poseidon_gl_permute.argtypes = [u64p, u64p]
    lib.poseidon_gl_permute_batch.argtypes = [u64p, u64p, ctypes.c_uint64]
    lib.keccak_f1600.argtypes = [u64p]
    lib.write_pols_file.argtypes = [ctypes.c_char_p, u64p, ctypes.c_uint64]
    lib.write_pols_file.restype = ctypes.c_int
    lib.map_pols_file.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_uint64)]
    lib.map_pols_file.restype = u64p
    lib.unmap_pols_file.argtypes = [u64p, ctypes.c_uint64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------


def u64_to_u32pair(src: np.ndarray):
    """(..., ) u64 -> (lo, hi) u32 arrays."""
    lib = _load()
    flat = np.ascontiguousarray(src, dtype=np.uint64)
    if lib is None:
        return ((flat & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (flat >> np.uint64(32)).astype(np.uint32))
    lo = np.empty(flat.shape, dtype=np.uint32)
    hi = np.empty(flat.shape, dtype=np.uint32)
    lib.u64_to_u32pair(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        flat.size,
    )
    return lo, hi


def u32pair_to_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    lib = _load()
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    if lib is None:
        return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    out = np.empty(lo.shape, dtype=np.uint64)
    lib.u32pair_to_u64(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lo.size,
    )
    return out


def poseidon_permute(state: List[int]) -> List[int]:
    lib = _load()
    if lib is None:
        from .ops import poseidon_gl

        return poseidon_gl.permute_host(state)
    buf = np.array(state, dtype=np.uint64)
    out = np.empty(12, dtype=np.uint64)
    lib.poseidon_gl_permute(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return [int(v) for v in out]


def poseidon_permute_batch(states: np.ndarray) -> np.ndarray:
    """(n, 12) u64 -> (n, 12) u64 (OpenMP-parallel)."""
    lib = _load()
    states = np.ascontiguousarray(states, dtype=np.uint64)
    if lib is None:
        from .ops import poseidon_gl

        return np.array(
            [poseidon_gl.permute_host([int(v) for v in row])
             for row in states],
            dtype=np.uint64,
        )
    out = np.empty_like(states)
    lib.poseidon_gl_permute_batch(
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        states.shape[0],
    )
    return out


def keccak_f1600(state: List[int]) -> List[int]:
    lib = _load()
    if lib is None:
        from .utils.keccak import keccak_f

        return keccak_f(list(state))
    buf = np.array(state, dtype=np.uint64)
    lib.keccak_f1600(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return [int(v) for v in buf]


def write_pols(path: str, data: np.ndarray) -> None:
    lib = _load()
    flat = np.ascontiguousarray(data, dtype=np.uint64)
    if lib is None:
        flat.tofile(path)
        return
    rc = lib.write_pols_file(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        flat.size,
    )
    if rc != 0:
        raise IOError(f"write_pols_file failed rc={rc}")


def read_pols(path: str, shape=None) -> np.ndarray:
    """mmap-backed read of a raw u64 pols file (copied into numpy)."""
    lib = _load()
    if lib is None:
        out = np.fromfile(path, dtype=np.uint64)
    else:
        n = ctypes.c_uint64()
        p = lib.map_pols_file(path.encode(), ctypes.byref(n))
        if not p:
            raise IOError(f"map_pols_file failed: {path}")
        out = np.ctypeslib.as_array(p, shape=(n.value,)).copy()
        lib.unmap_pols_file(p, n)
    return out.reshape(shape) if shape is not None else out
