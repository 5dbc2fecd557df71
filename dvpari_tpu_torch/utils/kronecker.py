"""Vanishing-polynomial coefficients at scale: Kronecker-substitution
product tree over GMP.

z_D(x) = prod_i (x - d_i) is a one-time domain precompute; the
reference budgets 2h+ for it at 2^23 via its native product tree
(reference: src/artifacts.rs:85-123, src/ec_fft.rs:241-282).  The
device (XLA) product tree in fftree/polyops.py is correct but its
batched-Karatsuba graph keeps O(3^depth) live temporaries and runs out
of HBM past ~2^16 leaves.  Here every tree node is packed into ONE big
integer -- 512 bits per coefficient, so a polynomial product IS an
integer product (Kronecker substitution) -- and libgmp multiplies those
with FFT-based arithmetic: asymptotically better than Karatsuba, on the
host, with O(n) memory.  Coefficients are re-reduced mod p after every
level so each slot stays below its 512-bit budget.

libgmp is loaded via ctypes (no headers needed; the mpz ABI has been
stable for decades).  Falls back to CPython's int multiply when libgmp
is unavailable -- same math, slower.

Counterpart of dvpari_tpu/utils/kronecker.py.  `vanishing_coeffs` is
the ctypes tree and the plain reference; `vanishing_coeffs_limbs` runs
the same tree in the port's native library (csrc/zpoly_native.cpp,
OpenMP over the nodes of a level), which links the libgmp found here
(`gmp_path`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np
import torch

from dvpari_tpu_torch.ops import fr

# 512 bits per coefficient slot.  A level multiply of reduced inputs
# yields coefficients < (n/2 + 1) * p^2 ~ 2^(461.4 + log2 n): the slot
# overflows at n ~ 2^50, so any domain below 2^48 leaves is safe with
# 2x margin (guarded in vanishing_coeffs).
PAD_BYTES = 64
PAD_BITS = 8 * PAD_BYTES


class _Mpz(ctypes.Structure):
    _fields_ = [
        ("_mp_alloc", ctypes.c_int),
        ("_mp_size", ctypes.c_int),
        ("_mp_d", ctypes.c_void_p),
    ]


_gmp = None
_gmp_tried = False


def _load_gmp():
    global _gmp, _gmp_tried
    if _gmp_tried:
        return _gmp
    _gmp_tried = True
    for name in ("libgmp.so.10", "libgmp.so", ctypes.util.find_library("gmp")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            mpz_p = ctypes.POINTER(_Mpz)
            lib.__gmpz_init2.argtypes = [mpz_p, ctypes.c_ulonglong]
            lib.__gmpz_clear.argtypes = [mpz_p]
            lib.__gmpz_import.argtypes = [
                mpz_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.__gmpz_export.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t, mpz_p,
            ]
            lib.__gmpz_export.restype = ctypes.c_void_p
            lib.__gmpz_mul.argtypes = [mpz_p, mpz_p, mpz_p]
            _gmp = lib
            return _gmp
        except OSError:
            continue
    return None


def gmp_path() -> str:
    """The file of the libgmp that _load_gmp() loaded, for the native
    library to link; raises when there is none."""
    if _load_gmp() is None:
        raise RuntimeError("libgmp not found (libgmp.so.10, libgmp.so): the native "
                           "vanishing-polynomial tree cannot be linked")
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libgmp.so"):
                return path
    raise RuntimeError("libgmp is loaded but its file is not in /proc/self/maps")


def _mul_bytes_gmp(a: bytes, b: bytes, out_len: int) -> bytes:
    """Little-endian byte-string multiply via libgmp (FFT for big sizes)."""
    lib = _load_gmp()
    za, zb, zc = _Mpz(), _Mpz(), _Mpz()
    lib.__gmpz_init2(za, 8 * len(a) + 64)
    lib.__gmpz_init2(zb, 8 * len(b) + 64)
    lib.__gmpz_init2(zc, 8 * (len(a) + len(b)) + 64)
    try:
        lib.__gmpz_import(za, len(a), -1, 1, 0, 0, a)
        lib.__gmpz_import(zb, len(b), -1, 1, 0, 0, b)
        lib.__gmpz_mul(zc, za, zb)
        buf = ctypes.create_string_buffer(out_len)
        count = ctypes.c_size_t(0)
        lib.__gmpz_export(buf, ctypes.byref(count), -1, 1, 0, 0, zc)
        assert count.value <= out_len, (count.value, out_len)
        return buf.raw  # zero-padded to out_len
    finally:
        lib.__gmpz_clear(za)
        lib.__gmpz_clear(zb)
        lib.__gmpz_clear(zc)


def _mul_bytes(a: bytes, b: bytes, out_len: int) -> bytes:
    if _load_gmp() is not None:
        return _mul_bytes_gmp(a, b, out_len)
    c = int.from_bytes(a, "little") * int.from_bytes(b, "little")
    return c.to_bytes(out_len, "little")


def _pack(coeffs: "list[int]") -> bytes:
    return b"".join(c.to_bytes(PAD_BYTES, "little") for c in coeffs)


def _unpack_reduce(data: bytes, ncoeff: int, p: int) -> "list[int]":
    return [
        int.from_bytes(data[PAD_BYTES * k : PAD_BYTES * (k + 1)], "little") % p
        for k in range(ncoeff)
    ]


def vanishing_coeffs(domain: "list[int]", p: int) -> "list[int]":
    """Coefficients (low-to-high, monic) of prod (x - d) over GF(p).

    Any domain size >= 1 (an odd node carries up a level unchanged)."""
    n = len(domain)
    assert 1 <= n < (1 << 48), "coefficient slots overflow past ~2^50 leaves"
    # leaf nodes: (x - d) packed as two coefficient slots; each node
    # tracks its leaf count (non-pow2 trees have ragged nodes)
    nodes = [(_pack([(p - d) % p, 1]), 1) for d in domain]
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            (da, ma), (db, mb) = nodes[i], nodes[i + 1]
            m = ma + mb
            prod = _mul_bytes(da, db, PAD_BYTES * (m + 2))
            # re-reduce every slot mod p: the 512-bit budget never overflows
            nxt.append((_pack(_unpack_reduce(prod, m + 1, p)), m))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return _unpack_reduce(nodes[0][0], n + 1, p)


def vanishing_coeffs_limbs(leaf_limbs) -> np.ndarray:
    """Fr limbs int32[20, n] (loose or canonical; array or tensor) ->
    canonical coefficient limbs int32[20, n + 1] of prod (x - d_i),
    through the native OpenMP tree, with the byte conversions done in
    numpy at both ends (no python int per coefficient)."""
    from dvpari_tpu_torch import native  # native imports this module

    canon = fr.strong_normalize(torch.as_tensor(leaf_limbs, dtype=torch.int32).cpu())
    out = native.zpoly_coeffs(fr.limbs_to_le_bytes(canon, 32), fr.P)
    wide = fr.limbs_from_be_bytes(out[:, ::-1])  # (22, n + 1), each value < P
    assert not wide[fr.NLIMB:].any()
    return np.ascontiguousarray(wide[: fr.NLIMB])
