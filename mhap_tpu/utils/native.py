"""ctypes bindings for the native helper library (native/libmhapnative.so).

Runs ``make`` on first use in each process, so the library is always built
from the committed sources (``make`` does nothing when the build is
current; the toolchain is assumed present, there is no pip dependency).
Exposes:

* canonical MurmurHash3 (cross-check oracle for the JAX kernels)
* batched k-mer hashing on the host (golden generation)
* local Smith-Waterman with identity stats (EstimateROC adjudication; the
  replacement for the reference's libsswjni.so JNI library,
  reference main/EstimateROC.java:294-313)
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmhapnative.so")
CPU_BINARY = os.path.join(_BUILD_DIR, "mhap_cpu")


def build() -> None:
    """``make -C native`` under an exclusive file lock: concurrent test
    workers must not rebuild (and load) the same objects at once."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.murmur3_x64_128.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.murmur3_x64_128.restype = None
    lib.murmur3_x86_32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
    lib.murmur3_x86_32.restype = ctypes.c_uint32
    lib.mhap_kmer_hashes_128.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.mhap_kmer_hashes_128.restype = None
    lib.mhap_kmer_hashes_32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.mhap_kmer_hashes_32.restype = None
    lib.mhap_sw_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.mhap_sw_align.restype = ctypes.c_int
    lib.mhap_format_m4.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
    lib.mhap_format_m4.restype = ctypes.c_longlong
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.mhap_score_pair.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.mhap_score_pair.restype = ctypes.c_int
    return lib


def score_pair(s1, nk1, s2, nk2, k2=12, max_shift=0.2):
    """Stage-2 overlap info of one sketch pair by the C++ port
    (native/scorer.h).  s1, s2: [m, 2] (hash, pos) rows.  Returns
    (score, raw, a1, a2, b1, b2), zeros when the pair has no overlap --
    the tuple mhap_tpu.oracle.scorer.get_overlap_info returns."""
    out = np.zeros(6, np.float64)
    ok = _lib().mhap_score_pair(
        np.ascontiguousarray(s1[:, 0], np.int32),
        np.ascontiguousarray(s1[:, 1], np.int32), len(s1), nk1,
        np.ascontiguousarray(s2[:, 0], np.int32),
        np.ascontiguousarray(s2[:, 1], np.int32), len(s2), nk2,
        k2, max_shift, out)
    if not ok:
        return (0.0, 0.0, 0, 0, 0, 0)
    return (out[0], out[1], int(out[2]), int(out[3]), int(out[4]),
            int(out[5]))


def format_m4(qid, cid, err, raw, qrc, a1, a2, ql, crc, b1, b2, cl):
    """Bulk M4 line formatting (MatchResult.java:98-113) in C: ~0.1
    us/line vs ~1.1 for the Python %-format loop -- the host wall of
    repeat-heavy runs (tens of millions of lines).  Byte-identical
    output (tests/test_format_native.py).  Returns a list[str]."""
    n = len(qid)
    if n == 0:
        return []
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    cols = (i64(qid), i64(cid), f64(err), f64(raw), i32(qrc), i64(a1),
            i64(a2), i64(ql), i32(crc), i64(b1), i64(b2), i64(cl))
    buf = np.empty(n * 192, dtype=np.uint8)
    total = _lib().mhap_format_m4(
        *[c.ctypes.data for c in cols], n, buf.ctypes.data, buf.size)
    if total < 0:
        raise RuntimeError("mhap_format_m4 buffer overflow")
    return buf[:total].tobytes().decode("ascii").split("\n")


def murmur3_x64_128(data: bytes, seed: int = 0) -> tuple[int, int]:
    out = np.zeros(2, dtype=np.uint64)
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, dtype=np.uint8)
    _lib().murmur3_x64_128(buf.ctypes.data, len(data), seed & 0xFFFFFFFF, out.ctypes.data)
    return int(out[0]), int(out[1])


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, dtype=np.uint8)
    return int(_lib().murmur3_x86_32(buf.ctypes.data, len(data), seed & 0xFFFFFFFF))


def kmer_hashes_128(seq_ascii: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """All k-mer guava-murmur3_128 h1 values of an ASCII uint8 sequence."""
    seq_ascii = np.ascontiguousarray(seq_ascii, dtype=np.uint8)
    n = len(seq_ascii) - k + 1
    out = np.zeros(max(n, 0), dtype=np.uint64)
    if n > 0:
        _lib().mhap_kmer_hashes_128(seq_ascii.ctypes.data, len(seq_ascii), k, seed & 0xFFFFFFFF, out.ctypes.data)
    return out


def kmer_hashes_32(seq_ascii: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    seq_ascii = np.ascontiguousarray(seq_ascii, dtype=np.uint8)
    n = len(seq_ascii) - k + 1
    out = np.zeros(max(n, 0), dtype=np.uint32)
    if n > 0:
        _lib().mhap_kmer_hashes_32(seq_ascii.ctypes.data, len(seq_ascii), k, seed & 0xFFFFFFFF, out.ctypes.data)
    return out


def sw_align(query: bytes, ref: bytes, match: int = 2, mismatch: int = -2,
             gap_open: int = 2, gap_extend: int = 1, band: int = -1) -> dict:
    """Local affine-gap alignment; returns score/coords/identity stats."""
    q = np.frombuffer(query, dtype=np.uint8)
    r = np.frombuffer(ref, dtype=np.uint8)
    out = np.zeros(8, dtype=np.int64)
    rc = _lib().mhap_sw_align(q.ctypes.data, len(q), r.ctypes.data, len(r),
                              match, mismatch, gap_open, gap_extend, band,
                              out.ctypes.data)
    if rc != 0:
        raise RuntimeError("mhap_sw_align failed")
    score, qb, qe, rb, re_, matches, errors, length = (int(x) for x in out)
    identity = 1.0 - errors / length if length > 0 else 0.0
    return {
        "score": score, "q_begin": qb, "q_end": qe, "r_begin": rb,
        "r_end": re_, "matches": matches, "errors": errors,
        "length": length, "identity": identity,
    }
