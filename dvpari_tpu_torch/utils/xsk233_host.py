"""Host-side (python-int) sect233k1 group oracle: points of order r on
the Koblitz curve y^2 + xy = x^3 + 1 over GF(2^233), cofactor 4,
r = R = the Fr modulus.

Counterpart of dvpari_tpu/utils/xsk233_host.py.  `smul_fast` and
`decode_fast` run in the port's native library (dvpari_tpu_torch/
native.py), which raises when it cannot be built: the verifier uses
them, and `smul` and `decode` stay as their plain references.
"""

from __future__ import annotations

from dvpari_tpu_torch import native
from dvpari_tpu_torch.utils import gf2_host as g

# Subgroup order = Fr modulus.
R = 3450873173395281893717377931138512760570940988862252126328087024741343

# SEC2 sect233k1 base point (order r).
GX = 0x17232BA853A7E731AF129F22FF4149563A419C26BF50A4C9D6EEFAD6126
GY = 0x1DB537DECE819B7F70F555A67C427A8CD9BF18AEB9B56E0C11056FAE6A3


def is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = g.mul_int(y, y) ^ g.mul_int(x, y)
    rhs = g.mul_int(g.mul_int(x, x), x) ^ 1
    return lhs == rhs


def neg(p):
    if p is None:
        return None
    x, y = p
    return (x, x ^ y)


def add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            if x1 == 0:
                return None  # the order-2 point doubles to infinity
            lam = x1 ^ g.mul_int(y1, g.inv_int(x1))
            x3 = g.mul_int(lam, lam) ^ lam
            y3 = g.mul_int(x1, x1) ^ g.mul_int(lam ^ 1, x3)
            return (x3, y3)
        return None  # q == -p
    lam = g.mul_int(y1 ^ y2, g.inv_int(x1 ^ x2))
    x3 = g.mul_int(lam, lam) ^ lam ^ x1 ^ x2
    y3 = g.mul_int(lam, x1 ^ x3) ^ x3 ^ y1
    return (x3, y3)


def smul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = add(acc, p)
        p = add(p, p)
        k >>= 1
    return acc


def smul_fast(k: int, p):
    """smul() in the native library: [k]P for 0 <= k < 2^240, p affine
    or None."""
    return native.pt_smul(k, p)


def encode(p) -> bytes:
    """30-byte compressed encoding; infinity = all-zero.

    Layout: bits 0..232 = x (little-endian), bit 233 = lsb(y/x),
    bits 234..239 = 0.
    """
    if p is None:
        return bytes(30)
    x, y = p
    lam_bit = g.mul_int(y, g.inv_int(x)) & 1
    v = x | (lam_bit << 233)
    return v.to_bytes(30, "little")


def in_subgroup(p) -> bool:
    """Order-r membership: x != 0, Tr(x) = 0, and the half is halvable.

    For a = 0 the group is cyclic of order 4r; P is in 2E iff Tr(x) = 0,
    and P in 4E (the prime subgroup) iff additionally one (equivalently,
    either) half Q of P satisfies Tr(x_Q) = 0, which reduces to
    Tr(y + (lam+1) x) = 0 with lam = halftrace(x) since
    Tr(sqrt(u)) = Tr(u).
    """
    if p is None:
        return True
    x, y = p
    if x == 0:
        return False
    if g.trace_fast_int(x) != 0:
        return False
    lam = g.halftrace_int(x)
    return g.trace_fast_int(y ^ g.mul_int(lam ^ 1, x)) == 0


def decode(data: bytes):
    """Returns (point, is_valid): infinity is all-zero, and a record is
    valid only if it decodes to a point of the prime-order subgroup."""
    assert len(data) == 30
    v = int.from_bytes(data, "little")
    if v == 0:
        return None, True
    if v >> 234:
        return None, False
    x = v & ((1 << 233) - 1)
    lam_bit = (v >> 233) & 1
    if x == 0:
        return None, False
    # y/x = z solves z^2 + z = x + x^-2  (curve eq divided by x^2)
    c = x ^ g.inv_int(g.mul_int(x, x))
    if g.trace_fast_int(c) != 0:
        return None, False
    z = g.halftrace_int(c)
    if z & 1 != lam_bit:
        z ^= 1
    y = g.mul_int(z, x)
    p = (x, y)
    if not is_on_curve(p) or not in_subgroup(p):
        return None, False
    return p, True


def decode_fast(data: bytes):
    """decode() in the native library: (point, is_valid)."""
    return native.pt_decode(data)
