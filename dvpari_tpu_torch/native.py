"""The port's native host backend: csrc/xsk233_native.cpp (sect233k1
point decode and scalar multiplication, the gnark R1CS row parser) and
csrc/zpoly_native.cpp (the OpenMP vanishing-polynomial product tree on
GMP), built with g++ at first use and loaded through ctypes.

Counterpart of dvpari_tpu/native/__init__.py, with its own copy of the
sources.  The build is one g++ command (no cmake, no ninja): `FLAGS`,
plus -mpclmul -msse4.1 when /proc/cpuinfo lists pclmul, linked against
the libgmp that utils/kronecker.py loads.  The library goes into the
gitignored dvpari_tpu_torch/build/, named by a hash of the sources and
the command, written to a temporary file and renamed into place, so
processes that build at once do not corrupt it.  A failed build or
link raises with the compiler's output: nothing falls back to python.
The python versions (utils/xsk233_host.py smul/decode,
r1cs/gnark.py:_parse_rows_numpy, utils/kronecker.py:vanishing_coeffs)
stay as the plain references for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from dvpari_tpu_torch.utils import kronecker

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_PKG, "csrc", f) for f in ("xsk233_native.cpp", "zpoly_native.cpp")]
BUILD_DIR = os.path.join(_PKG, "build")
FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall"]
PCLMUL_FLAGS = ["-mpclmul", "-msse4.1"]

_lib = None


def has_pclmul() -> bool:
    """Whether this host's CPU has the carry-less multiply (PCLMULQDQ)."""
    try:
        with open("/proc/cpuinfo") as f:
            return " pclmulqdq" in f.read()
    except OSError:
        return False


def command(out: str) -> "list[str]":
    """The g++ command that builds the library into `out`."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native host backend cannot be built")
    flags = FLAGS + (PCLMUL_FLAGS if has_pclmul() else [])
    return [cxx, *flags, "-o", out, *SOURCES, kronecker.gmp_path()]


def build() -> str:
    """Compile the sources once per content and command; returns the
    shared library's path."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(repr(command("")).encode())
    so = os.path.join(BUILD_DIR, f"libdvpari_native_{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(command(tmp), capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the native host backend:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i64, u8 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8
        lib.dv_pt_smul.argtypes = [vp, vp, u8, vp, vp]
        lib.dv_pt_smul.restype = None
        lib.dv_pt_decode.argtypes = [vp, vp, vp]
        lib.dv_pt_decode.restype = ctypes.c_int
        lib.dv_pt_decode_bulk.argtypes = [vp, i64, vp, vp]
        lib.dv_pt_decode_bulk.restype = i64
        lib.dv_r1cs_meta.argtypes = [vp, i64, i64, vp, vp]
        lib.dv_r1cs_meta.restype = ctypes.c_int
        lib.dv_r1cs_parse.argtypes = [vp, i64, i64] + [vp] * 7
        lib.dv_r1cs_parse.restype = ctypes.c_int
        lib.dv_zpoly_coeffs.argtypes = [vp, i64, vp, vp]
        lib.dv_zpoly_coeffs.restype = i64
        lib.omp_get_max_threads.argtypes = []
        lib.omp_get_max_threads.restype = ctypes.c_int
        _lib = lib
    return _lib


def omp_threads() -> int:
    """OpenMP's thread count for the library's parallel loops."""
    return int(load().omp_get_max_threads())


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"]
    return a.ctypes.data


def _words(v: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(32, "little"), dtype=np.uint64).copy()


def _int(w: np.ndarray) -> int:
    return int.from_bytes(w.tobytes(), "little")


def pt_smul(k: int, p):
    """[k]P for 0 <= k < 2^240 and an affine python-int point P (or
    None): the native double-and-add, affine result or None."""
    if not 0 <= k < 1 << 240:
        raise ValueError("scalar out of range [0, 2^240)")
    k30 = np.frombuffer(int(k).to_bytes(30, "little"), dtype=np.uint8).copy()
    xy = np.zeros(8, dtype=np.uint64)
    if p is not None:
        xy = np.concatenate([_words(p[0]), _words(p[1])])
    out = np.zeros(8, dtype=np.uint64)
    inf = np.zeros(1, dtype=np.uint8)
    load().dv_pt_smul(_ptr(k30), _ptr(xy), 1 if p is None else 0, _ptr(out), _ptr(inf))
    return None if inf[0] else (_int(out[:4]), _int(out[4:]))


def pt_decode(data: bytes):
    """One 30-byte record -> (point or None, is_valid), with the python
    decode's validity contract (utils/xsk233_host.py:decode)."""
    if len(data) != 30:
        raise ValueError(f"a point record is 30 bytes, got {len(data)}")
    raw = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    xy = np.zeros(8, dtype=np.uint64)
    inf = np.zeros(1, dtype=np.uint8)
    if not load().dv_pt_decode(_ptr(raw), _ptr(xy), _ptr(inf)):
        return None, False
    return (None if inf[0] else (_int(xy[:4]), _int(xy[4:]))), True


def pt_decode_bulk(data) -> "tuple[np.ndarray, np.ndarray]":
    """n concatenated 30-byte records -> (xy uint64[n, 8] affine words,
    inf uint8[n]); raises ValueError if any record is invalid."""
    raw = np.frombuffer(data, dtype=np.uint8)
    if len(raw) % 30:
        raise ValueError(f"{len(raw)} bytes is not a whole number of 30-byte records")
    raw = np.ascontiguousarray(raw)
    n = len(raw) // 30
    xy = np.zeros((n, 8), dtype=np.uint64)
    inf = np.zeros(n, dtype=np.uint8)
    bad = load().dv_pt_decode_bulk(_ptr(raw), n, _ptr(xy), _ptr(inf))
    if bad:
        raise ValueError(f"{bad} invalid point records")
    return xy, inf


def r1cs_parse_rows(data: bytes, rows_off: int):
    """The row section of a gnark R1CS dump, from the u32 row count at
    byte `rows_off`: (counts uint32[n_rows, 3], [(wire_ids, coeff_ids)
    uint32 arrays for L, R, O]), as r1cs/gnark.py:_parse_rows_numpy
    gives them; raises ValueError on a truncated dump."""
    lib = load()
    raw = np.frombuffer(data, dtype=np.uint8)
    n_rows = np.zeros(1, dtype=np.int64)
    terms = np.zeros(3, dtype=np.int64)
    if lib.dv_r1cs_meta(_ptr(raw), len(raw), rows_off, _ptr(n_rows), _ptr(terms)):
        raise ValueError("malformed gnark R1CS dump")
    counts = np.zeros((int(n_rows[0]), 3), dtype=np.uint32)
    mats = [(np.zeros(int(t), np.uint32), np.zeros(int(t), np.uint32)) for t in terms]
    lib.dv_r1cs_parse(_ptr(raw), len(raw), rows_off, _ptr(counts),
                      *(_ptr(a) for pair in mats for a in pair))
    return counts, mats


def zpoly_coeffs(domain_le: np.ndarray, p: int) -> np.ndarray:
    """prod (x - d_i) over GF(p) for the n reduced elements of
    `domain_le` (uint8[n, 32], little-endian): uint8[n + 1, 32]
    little-endian coefficients, low to high, monic."""
    dom = np.ascontiguousarray(domain_le, dtype=np.uint8)
    n = dom.shape[0]
    if n < 1 or dom.shape != (n, 32):
        raise ValueError(f"domain must be uint8[n >= 1, 32], got {dom.shape}")
    p_le = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint8).copy()
    out = np.zeros((n + 1, 32), dtype=np.uint8)
    rc = load().dv_zpoly_coeffs(_ptr(dom), n, _ptr(p_le), _ptr(out))
    if rc:
        raise RuntimeError(f"dv_zpoly_coeffs returned {rc}")
    return out
