"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; host-side format conversion and graph
reordering — pure pointer-chasing the reference delegates to SparseArrays'
C routines — is C++ here (SURVEY.md §2.1: driven by the build plan, not by
reference native code, since the reference has none).

The shared library is built from ``bsr_pack.cpp`` with g++ on first use and
cached next to the source. Callers that need it raise when it cannot be
built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["bsr_pack_csr", "rcm_permutation", "native_available",
           "clos_route_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bsr_pack.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path(src: str, stem: str) -> str:
    """Library path keyed by a CONTENT hash of the source: git checkouts do
    not preserve mtimes, so an mtime check could load a stale (or
    foreign-arch) binary instead of rebuilding; a hash-keyed name can't."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"_{stem}_{h}.so")


def _build(src: str, stem: str) -> str:
    so = _so_path(src, stem)
    if not os.path.exists(so):
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", src, "-o", so],
            check=True, capture_output=True,
        )
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build(_SRC, "libbsrpack"))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

            lib.bsr_count.restype = ctypes.c_int32
            lib.bsr_count.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, i32p]
            lib.bsr_fill_f32.restype = None
            lib.bsr_fill_f32.argtypes = [f32p, i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, f32p, i32p]
            lib.bsr_fill_f64.restype = None
            lib.bsr_fill_f64.argtypes = [f64p, i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, f64p, i32p]
            lib.rcm_order.restype = None
            lib.rcm_order.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


_I32_MAX = np.iinfo(np.int32).max


def _check_int32(a, what: str):
    """The native ABI is int32; silently wrapping 64-bit indices would make
    the packer read out of bounds."""
    a = np.asarray(a)
    if a.size and int(a.max()) > _I32_MAX:
        raise OverflowError(
            f"{what} exceed int32 range (max {int(a.max())}); the native "
            "packer supports nnz/dims up to 2^31-1"
        )


def bsr_pack_csr(vals, cols, indptr, nrow, ncol, block_shape=(8, 128)):
    """CSR → (blocks, block_cols) BSR arrays via the native packer.

    Returns numpy arrays (caller moves them to device). Raises RuntimeError
    if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native packer unavailable (g++ build failed)")
    bm, bn = block_shape
    vals = np.ascontiguousarray(vals)
    _check_int32(cols, "column indices")
    _check_int32(indptr, "indptr")
    cols = np.ascontiguousarray(cols, np.int32)
    indptr = np.ascontiguousarray(indptr, np.int32)
    nbrow = -(-nrow // bm)
    counts = np.zeros(nbrow, np.int32)
    kmax = max(int(lib.bsr_count(cols, indptr, nrow, bm, bn, counts)), 1)

    blocks = np.zeros((nbrow, kmax, bm, bn), dtype=vals.dtype)
    block_cols = np.zeros((nbrow, kmax), np.int32)
    fill = lib.bsr_fill_f32 if vals.dtype == np.float32 else lib.bsr_fill_f64
    if vals.dtype not in (np.float32, np.float64):
        raise TypeError(f"native packer supports f32/f64, got {vals.dtype}")
    fill(vals, cols, indptr, nrow, bm, bn, kmax,
         blocks.reshape(-1), block_cols.reshape(-1))
    return blocks, block_cols


def rcm_permutation(cols, indptr, n) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized CSR pattern —
    reduces bandwidth so BSR rows touch fewer block-columns and
    row-partitions have thinner halos. Returns perm with
    ``A_reordered = A[perm][:, perm]``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    _check_int32(cols, "column indices")
    _check_int32(indptr, "indptr")
    cols = np.ascontiguousarray(cols, np.int32)
    indptr = np.ascontiguousarray(indptr, np.int32)
    perm = np.zeros(n, np.int32)
    lib.rcm_order(cols, indptr, n, perm)
    return perm


# ----------------------------------------------------------------------------
# Clos router (clos_route.cpp) — separate lazily-built library
# ----------------------------------------------------------------------------

_CLOS_SRC = os.path.join(_HERE, "clos_route.cpp")
_clos_lib = None
_clos_tried = False


def _load_clos():
    global _clos_lib, _clos_tried
    with _lock:
        if _clos_lib is not None or _clos_tried:
            return _clos_lib
        _clos_tried = True
        try:
            lib = ctypes.CDLL(_build(_CLOS_SRC, "libclosroute"))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.clos_route_c.restype = ctypes.c_int64
            lib.clos_route_c.argtypes = [i64p, ctypes.c_int64] + [i32p] * 5
            _clos_lib = lib
        except Exception:
            _clos_lib = None
        return _clos_lib


def clos_route_native(dest):
    """Native radix-128 Clos routing; same stage-array contract as
    sparse/routing.py::clos_route (which is ~50x slower at the 2^21
    domain). Returns None when the native library is unavailable."""
    lib = _load_clos()
    if lib is None:
        return None
    dest = np.ascontiguousarray(dest, np.int64)
    n = dest.shape[0]
    RADIX = 128
    if n % RADIX:
        raise ValueError(f"clos size must be a multiple of {RADIX}, got {n}")
    m = n // RADIX
    g1 = np.zeros((m, RADIX), np.int32)
    g5 = np.zeros((m, RADIX), np.int32)
    if m <= RADIX:
        g3 = np.zeros((RADIX, m), np.int32)
        g2 = g4 = np.zeros(1, np.int32)
    else:
        b = m // RADIX
        g2 = np.zeros((RADIX * b, RADIX), np.int32)
        g3 = np.zeros((RADIX * RADIX, b), np.int32)
        g4 = np.zeros((RADIX * b, RADIX), np.int32)
    stages = int(lib.clos_route_c(dest, n, g1.reshape(-1), g2.reshape(-1),
                                  g3.reshape(-1), g4.reshape(-1),
                                  g5.reshape(-1)))
    if stages < 0:
        raise ValueError(f"unsupported clos size {n}")
    if stages == 1:
        return [g1[:1]]
    if stages == 3:
        return [g1, g3, g5]
    return [g1, g2, g3, g4, g5]
