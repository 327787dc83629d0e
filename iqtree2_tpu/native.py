"""ctypes bindings for the native host runtime (native/iqtree2_native.cpp).

The .so is built from the committed source on first use with g++ (cached
next to the source, never committed); every entry point has a
pure-Python/numpy fallback so the package works without a toolchain.
Covered components (reference analogs in the .cpp):
  - pattern compression (alignment/alignment.cpp:1725)
  - bit-parallel Fitch scoring (tree/phylotreepars.cpp:32)
  - randomized stepwise-addition parsimony trees (tree/iqtree.cpp:746)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent.parent / "native" / "iqtree2_native.cpp"
_SO = _SRC.with_suffix(".so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("IQTREE2_TPU_DISABLE_NATIVE"):
            return None
        try:
            if not _SO.exists() or \
                    _SO.stat().st_mtime < _SRC.stat().st_mtime:
                # build under a private name and rename into place, so
                # processes building concurrently never load a partial file
                tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         "-o", str(tmp), str(_SRC)],
                        check=True, capture_output=True, timeout=120)
                    os.replace(tmp, _SO)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(_SO))
            i32p = ctypes.POINTER(ctypes.c_int32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            lib.it2_compress_patterns.restype = i64
            lib.it2_compress_patterns.argtypes = [i32p, i64, i64, i32p,
                                                  f64p, i32p]
            lib.it2_fitch_score.restype = ctypes.c_double
            lib.it2_fitch_score.argtypes = [u64p, f64p, i32p, i64, i64,
                                            i64, u64p]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.it2_stepwise_addition.restype = None
            lib.it2_stepwise_addition.argtypes = [u64p, i64p, i64, i64, i64,
                                                  i64, i64p, i64p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    return _load() is not None


def compress_patterns(codes: np.ndarray):
    """codes [L, nsites] int32 -> (patterns [nsites_unique, L] int,
    weights, site_to_pattern) or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    L, nsites = codes.shape
    out_p = np.empty((L, nsites), np.int32)
    out_w = np.empty(nsites, np.float64)
    out_s = np.empty(nsites, np.int32)
    n = lib.it2_compress_patterns(
        _ptr(codes, ctypes.c_int32), L, nsites,
        _ptr(out_p, ctypes.c_int32), _ptr(out_w, ctypes.c_double),
        _ptr(out_s, ctypes.c_int32))
    return out_p[:, :n].T.copy(), out_w[:n].copy(), out_s


def fitch_score(masks: np.ndarray, weights: np.ndarray,
                child_src: np.ndarray) -> float | None:
    """Weighted Fitch cost over a postorder schedule (native)."""
    lib = _load()
    if lib is None:
        return None
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    cs = np.ascontiguousarray(child_src, dtype=np.int32)
    L, P = masks.shape
    n_int = cs.shape[0]
    scratch = np.empty(((L + n_int), P), np.uint64)
    return float(lib.it2_fitch_score(
        _ptr(masks, ctypes.c_uint64), _ptr(w, ctypes.c_double),
        _ptr(cs, ctypes.c_int32), n_int, L, P,
        _ptr(scratch, ctypes.c_uint64)))


def stepwise_addition(masks: np.ndarray, weights: np.ndarray,
                      seq: list[int]) -> np.ndarray | None:
    """Insertion edges [len(seq) - 3, 2] (child, parent) of randomized
    stepwise addition in the order ``seq`` (the first three taxa form the
    start star), or None when native is unavailable or the pattern
    weights are not small non-negative integers (the Python version sums
    them as floats)."""
    lib = _load()
    if lib is None:
        return None
    w = np.asarray(weights, np.float64)
    if w.size and (w.min() < 0 or w.max() >= 2 ** 40
                   or not np.all(w == np.round(w))):
        return None
    wint = np.ascontiguousarray(w, dtype=np.int64)
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    L, P = masks.shape
    S = int(np.bitwise_or.reduce(masks, axis=None)).bit_length() if masks.size \
        else 0
    nwbits = int(wint.max()).bit_length() if wint.size else 0
    seq_a = np.ascontiguousarray(seq, dtype=np.int64)
    out = np.empty((max(L - 3, 0), 2), np.int64)
    lib.it2_stepwise_addition(
        _ptr(masks, ctypes.c_uint64), _ptr(wint, ctypes.c_int64), L, P,
        max(S, 1), nwbits, _ptr(seq_a, ctypes.c_int64),
        _ptr(out, ctypes.c_int64))
    return out
