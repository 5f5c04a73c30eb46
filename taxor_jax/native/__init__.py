"""Native (C++) host components.

The reference implements its host hot loops in C++ (-Ofast, OpenMP); this
rebuild keeps the device compute in JAX and uses C++ for the sequential
host loops that numpy cannot vectorize well: the syncmer scanner
(per-base state machine) and the XOR-filter peeling builder (the
reference's construct_ixf hot loop).

The shared library is compiled on first use with g++ -O3 into
<checkout>/.native_build (listed in .gitignore) and loaded via ctypes;
without a working compiler everything falls back to the numpy
implementations transparently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".native_build")
    os.makedirs(d, exist_ok=True)
    return d


_SOURCES = ("syncmer_scan.cpp", "xor_peel.cpp", "ref_baseline.cpp",
            "layout_dp.cpp")


def _compile() -> str | None:
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, s) for s in _SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libtaxor_native_{digest}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"  # concurrent builders never collide
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-std=c++17", *srcs, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.syncmer_scan.restype = ctypes.c_long
            lib.syncmer_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.pack_reads_2bit.restype = None
            lib.pack_reads_2bit.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_void_p,
            ]
            lib.ixf_build_bins.restype = ctypes.c_long
            lib.ixf_build_bins.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_ulonglong, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int,
            ]
            lib.ref_baseline_search.restype = ctypes.c_int
            lib.ref_baseline_search.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            lib.syncmer_scan_batch.restype = None
            lib.syncmer_scan_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.hll_union_band.restype = None
            lib.hll_union_band.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_int,
            ]
            lib.layout_dp.restype = ctypes.c_long
            lib.layout_dp.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.rearrange_chain.restype = None
            lib.rearrange_chain.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_int,
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB
