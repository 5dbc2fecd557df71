"""sect233k1 on python ints: GF(2^233) = GF(2)[x]/(x^233 + x^74 + 1), the
Koblitz curve y^2 + x y = x^3 + 1, its base point G (SEC 2), [k]G and
the protocol's 30-byte point encoding (upstream: alpenlabs/dv-pari
src/curve.rs): bits 0..232 the affine x (little-endian), bit 233 the
lowest bit of y/x, the rest zero; infinity is 30 zero bytes."""

from __future__ import annotations

import functools

M = 233
K = 74
_MASK = (1 << M) - 1
GX = 0x17232BA853A7E731AF129F22FF4149563A419C26BF50A4C9D6EEFAD6126
GY = 0x1DB537DECE819B7F70F555A67C427A8CD9BF18AEB9B56E0C11056FAE6A3

# byte -> its bits spread to the even positions of 16 bits
_SPREAD = [sum(((b >> i) & 1) << (2 * i) for i in range(8)) for b in range(256)]


def _reduce(v: int) -> int:
    while v >> M:
        hi = v >> M
        v = (v & _MASK) ^ hi ^ (hi << K)
    return v


def mul(a: int, b: int) -> int:
    """Carry-less product, four bits of b a step, then the trinomial fold."""
    tab = [0] * 16
    for j in range(1, 16):
        tab[j] = tab[j >> 1] << 1 if j % 2 == 0 else tab[j - 1] ^ a
    acc = 0
    for s in range(M - M % 4, -1, -4):
        acc = (acc << 4) ^ tab[(b >> s) & 15]
    return _reduce(acc)


def sqr(a: int) -> int:
    out = 0
    for i, byte in enumerate(a.to_bytes(30, "little")):
        out |= _SPREAD[byte] << (16 * i)
    return _reduce(out)


def inv(a: int) -> int:
    """a^-1 by the extended Euclidean algorithm over GF(2)[x]."""
    assert a
    u, v = a, (1 << M) | (1 << K) | 1
    g1, g2 = 1, 0
    while u != 1:
        j = u.bit_length() - v.bit_length()
        if j < 0:
            u, v, g1, g2, j = v, u, g2, g1, -j
        u ^= v << j
        g1 ^= g2 << j
    return _reduce(g1)


def add(p, q):
    """Affine addition (None is infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if y1 != y2 or x1 == 0:
            return None  # q = -p, or the order-2 point doubled
        lam = x1 ^ mul(y1, inv(x1))
        x3 = sqr(lam) ^ lam
        return x3, sqr(x1) ^ mul(lam ^ 1, x3)
    lam = mul(y1 ^ y2, inv(x1 ^ x2))
    x3 = sqr(lam) ^ lam ^ x1 ^ x2
    return x3, mul(lam, x1 ^ x3) ^ x3 ^ y1


@functools.cache
def _g_doublings() -> tuple:
    out = [(GX, GY)]
    for _ in range(M - 1):
        out.append(add(out[-1], out[-1]))
    return tuple(out)


def mul_g(k: int):
    """[k]G for 0 <= k < 2^233: the sum of [2^i]G over the bits of k."""
    assert 0 <= k < 1 << M
    acc = None
    for i, p in enumerate(_g_doublings()[: k.bit_length()]):
        if (k >> i) & 1:
            acc = add(acc, p)
    return acc


def encode(p) -> bytes:
    if p is None:
        return bytes(30)
    x, y = p
    return (x | ((mul(y, inv(x)) & 1) << M)).to_bytes(30, "little")
