"""Host-side (python-int) GF(2^233) arithmetic: the slow-but-obviously-
correct oracle the bit-sliced torch ops and the CUDA ladder are tested
against.  Reduction trinomial: x^233 + x^74 + 1.

Counterpart of dvpari_tpu/utils/gf2_host.py (kept as a copy: the port
imports nothing from the JAX package).
"""

from __future__ import annotations

M = 233
TRINOMIAL_K = 74


def clmul_int(a: int, b: int) -> int:
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        a <<= 1
        b >>= 1
    return acc


def reduce_int(v: int) -> int:
    while v.bit_length() > M:
        hi = v >> M
        v = (v ^ (hi << M)) ^ hi ^ (hi << TRINOMIAL_K)
    return v


def mul_int(a: int, b: int) -> int:
    return reduce_int(clmul_int(a, b))


def square_int(a: int) -> int:
    return mul_int(a, a)


def pow2k_int(a: int, k: int) -> int:
    for _ in range(k):
        a = square_int(a)
    return a


def inv_int(a: int) -> int:
    """a^(2^233 - 2) via Itoh-Tsujii; inv(0) = 0."""
    if a == 0:
        return 0
    # chain 1,2,3,6,7,14,28,29,58,116,232 for a^(2^k - 1)
    x1 = a
    x2 = mul_int(pow2k_int(x1, 1), x1)
    x3 = mul_int(pow2k_int(x2, 1), x1)
    x6 = mul_int(pow2k_int(x3, 3), x3)
    x7 = mul_int(pow2k_int(x6, 1), x1)
    x14 = mul_int(pow2k_int(x7, 7), x7)
    x28 = mul_int(pow2k_int(x14, 14), x14)
    x29 = mul_int(pow2k_int(x28, 1), x1)
    x58 = mul_int(pow2k_int(x29, 29), x29)
    x116 = mul_int(pow2k_int(x58, 58), x58)
    x232 = mul_int(pow2k_int(x116, 116), x116)
    return square_int(x232)


def sqrt_int(a: int) -> int:
    return pow2k_int(a, M - 1)


def trace_int(a: int) -> int:
    t = a
    acc = a
    for _ in range(M - 1):
        t = square_int(t)
        acc ^= t
    # trace lands in GF(2)
    assert acc in (0, 1)
    return acc


def halftrace_int(a: int) -> int:
    """H(a) = sum a^(2^(2i)), i=0..(m-1)/2; solves z^2 + z = a when Tr(a)=0."""
    t = a
    acc = a
    for _ in range((M - 1) // 2):
        t = square_int(square_int(t))
        acc ^= t
    return acc


def derive_trace_mask() -> int:
    """Bit i set iff Tr(x^i) = 1, so Tr(a) = parity(popcount(a & mask))."""
    mask = 0
    for i in range(M):
        if trace_int(1 << i):
            mask |= 1 << i
    return mask


# derive_trace_mask() baked as a constant (deriving it costs ~1 s at
# import); a test holds the two equal.
TRACE_MASK = (1 << 159) | 1


def trace_fast_int(a: int) -> int:
    return bin(a & TRACE_MASK).count("1") & 1
