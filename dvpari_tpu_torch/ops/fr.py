"""Fr, the sect233k1 scalar field (232-bit prime), as torch limb
arithmetic: layout, host conversions and byte codecs, normalisation,
field ops, batch inversion and polynomial evaluation.

Counterpart of dvpari_tpu/ops/fr.py (same layout, same steps, so the
same limbs): an element batch is `int32[20, *batch]`, 20 signed 12-bit
limbs, limb axis first.  Limbs are loose (|limb| <= 10000) until
strong_normalize canonicalises them.  Reduction uses 4p = 2^233 + c,
hence 2^240 = -D (mod p) with D = 128c only 12 limbs.  torch's int32
`*` wraps and its `>>` is arithmetic, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# The sect233k1 prime-subgroup order.
P = 3450873173395281893717377931138512760570940988862252126328087024741343

LIMB_BITS = 12
NLIMB = 20  # 20 * 12 = 240 bits >= 232
BASE = 1 << LIMB_BITS
MASK = BASE - 1

# 2^240 = -D (mod p) with D = 128 * (4p - 2^233), ~134 bits -> 12 limbs.
D_FOLD = (4 * P - (1 << 233)) << 7
assert 0 < D_FOLD and (-(1 << 240)) % P == D_FOLD
D_NLIMB = 12
assert D_FOLD < (1 << (LIMB_BITS * D_NLIMB))


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit in limbs"
    return out


D_LIMBS = _int_to_limbs(D_FOLD, D_NLIMB)

# Canonicalization offset: 2048p as 21 limbs with limbs 0..19 pushed into
# [9000, 2^15) so that adding it absorbs any loose negative limbs.
_LADDER_WIDTH = NLIMB + 1


def _canon_offset() -> np.ndarray:
    limbs = [int(v) for v in _int_to_limbs(2048 * P, _LADDER_WIDTH)]
    for i in range(_LADDER_WIDTH - 2, -1, -1):
        while limbs[i] < 9000:
            limbs[i] += BASE
            limbs[i + 1] -= 1
    assert all(9000 <= v < (1 << 15) for v in limbs[:-1]) and limbs[-1] >= 0
    assert sum(v << (LIMB_BITS * i) for i, v in enumerate(limbs)) == 2048 * P
    return np.array(limbs, dtype=np.int32)


CANON_OFFSET = _canon_offset()


# ---------------------------------------------------------------------------
# Host-side conversions (numpy)
# ---------------------------------------------------------------------------

def from_int(values) -> np.ndarray:
    """Python int / iterable of ints -> int32[20, *batch] canonical limbs
    (each value reduced mod P first).  Vectorised through little-endian
    bytes, so 2^18 scalars convert in well under a second."""
    if isinstance(values, (int, np.integer)):
        return _int_to_limbs(int(values) % P, NLIMB)
    values = list(values)
    n = len(values)
    raw = b"".join((int(v) % P).to_bytes(30, "little") for v in values)
    bits = np.unpackbits(
        np.frombuffer(raw, dtype=np.uint8).reshape(n, 30), axis=1, bitorder="little"
    )  # (n, 240), LSB first
    weights = (1 << np.arange(LIMB_BITS)).astype(np.int32)
    limbs = bits.reshape(n, NLIMB, LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(limbs.T)


def to_int(limbs):
    """int32[20] or int32[20, N] loose limbs (tensor or array) ->
    canonical int(s) mod P."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs, dtype=np.int64)
    if arr.ndim == 1:
        return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(NLIMB)) % P
    flat = arr.reshape(NLIMB, -1)
    return [
        sum(int(flat[i, j]) << (LIMB_BITS * i) for i in range(NLIMB)) % P
        for j in range(flat.shape[1])
    ]


_CONSTS: dict = {}


def _col(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constant limbs as an (L, 1, ..., 1) tensor beside `like`, made once
    per device (a fresh host-to-device copy per use would stall the
    stream in every carry pass)."""
    key = (limbs.tobytes(), like.dim(), like.device)
    hit = _CONSTS.get(key)
    if hit is None:
        shape = (len(limbs),) + (1,) * (like.dim() - 1)
        hit = torch.as_tensor(limbs, dtype=torch.int32, device=like.device).reshape(shape)
        _CONSTS[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Loose-limb normalisation (all shapes: int32[L, *batch], limb axis first)
# ---------------------------------------------------------------------------

def _carry_pass(v: torch.Tensor) -> torch.Tensor:
    """One width-preserving local carry pass (signed, arithmetic shift).

    The carry out of the top limb weighs 2^(12*width) =
    2^(12*off) * 2^240 = -2^(12*off) * D (mod p), so it folds back by
    subtracting the D-scaled carry at limb offset `off`.
    """
    off = v.shape[0] - NLIMB
    c = v >> LIMB_BITS
    v = v & MASK  # non-negative remainder, also for negative limbs
    v[1:] += c[:-1]
    v[off : off + D_NLIMB] += -c[-1] * _col(D_LIMBS, v)
    return v


def _fold_top(v: torch.Tensor) -> torch.Tensor:
    """Fold limbs >= NLIMB back through -D; input limbs must be small."""
    width = v.shape[0]
    if width <= NLIMB:
        return v
    lo, hi = v[:NLIMB], v[NLIMB:]
    n_hi = width - NLIMB
    out_width = max(NLIMB, n_hi + D_NLIMB)
    acc = torch.zeros((out_width, *v.shape[1:]), dtype=torch.int32, device=v.device)
    acc[:NLIMB] += lo
    for j in range(D_NLIMB):
        acc[j : j + n_hi] += hi * (-int(D_LIMBS[j]))
    return acc


def weak_normalize(v: torch.Tensor) -> torch.Tensor:
    """Any-width int32 limbs (|column| < 2^31) -> NLIMB loose limbs (<= ~8300)."""
    while v.shape[0] > NLIMB:
        v = _carry_pass(_carry_pass(_carry_pass(v)))
        v = _fold_top(v)
    return _carry_pass(_carry_pass(_carry_pass(v)))


def strong_normalize(a: torch.Tensor) -> torch.Tensor:
    """Fully-canonical limbs in [0, p): the unique representation.

    Adds 2048p (absorbing any negative loose limbs), extracts exact
    base-4096 digits over 21 limbs, then conditionally subtracts
    2048p, 1024p, ..., p.
    """
    v = weak_normalize(a)
    v = torch.cat([v, torch.zeros_like(v[:1])], dim=0) + _col(CANON_OFFSET, v)
    carry = torch.zeros(v.shape[1:], dtype=torch.int32, device=v.device)
    digs = []
    for i in range(_LADDER_WIDTH):
        s = v[i] + carry
        digs.append(s & MASK)
        carry = s >> LIMB_BITS
    v = torch.stack(digs, dim=0)  # canonical 21 digits; carry out == 0
    k = 2048
    while k >= 1:
        kp = _int_to_limbs(k * P, _LADDER_WIDTH)
        v = torch.where(_ge_const(v, kp)[None], _sub_const_borrow(v, kp), v)
        k //= 2
    return v[:NLIMB]


def _ge_const(v: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
    """Lexicographic >= compare of canonical digits against a constant."""
    c = _col(c_limbs, v)
    gt = v > c
    lt = v < c
    res = torch.zeros(v.shape[1:], dtype=torch.bool, device=v.device)
    decided = torch.zeros_like(res)
    for i in range(v.shape[0] - 1, -1, -1):
        res = res | (~decided & gt[i])
        decided = decided | gt[i] | lt[i]
    return res | ~decided  # all-equal -> >=


def _sub_const_borrow(v: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
    """v - c with borrow propagation (requires v >= c, canonical digits)."""
    borrow = torch.zeros(v.shape[1:], dtype=torch.int32, device=v.device)
    out = []
    for i in range(v.shape[0]):
        d = v[i] - int(c_limbs[i]) - borrow
        nb = (d < 0).to(torch.int32)
        out.append(d + nb * BASE)
        borrow = nb
    return torch.stack(out, dim=0)


P_LIMBS = _int_to_limbs(P, NLIMB)


# ---------------------------------------------------------------------------
# Byte codecs (numpy, vectorised)
# ---------------------------------------------------------------------------

def limbs_from_be_bytes(raw: np.ndarray) -> np.ndarray:
    """(n, nbytes) big-endian records -> UNREDUCED wide limbs int32[W, n];
    weak_normalize / strong_normalize reduce them mod P."""
    raw = np.asarray(raw, dtype=np.uint8)
    n, nbytes = raw.shape
    bits = np.unpackbits(raw[:, ::-1], axis=1, bitorder="little")  # LSB first
    width = -(-(8 * nbytes) // LIMB_BITS)
    bits = np.pad(bits, [(0, 0), (0, width * LIMB_BITS - 8 * nbytes)])
    weights = (1 << np.arange(LIMB_BITS)).astype(np.int32)
    limbs = bits.reshape(n, width, LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(limbs.T)


def limbs_to_le_bytes(canonical, width_bytes: int) -> np.ndarray:
    """Canonical limbs int32[20, n] (strong_normalize output) ->
    (n, width_bytes) little-endian records."""
    if isinstance(canonical, torch.Tensor):
        canonical = canonical.cpu().numpy()
    limbs = np.asarray(canonical)
    if limbs.ndim == 1:
        limbs = limbs[:, None]
    n = limbs.shape[1]
    sh = np.arange(LIMB_BITS, dtype=np.uint16)[None, :, None]
    bits = ((limbs.astype(np.uint16)[:, None, :] >> sh) & 1).astype(np.uint8)
    bits = bits.reshape(NLIMB * LIMB_BITS, n).T  # bit 12*limb + b, LSB first
    packed = np.packbits(bits, axis=1, bitorder="little")  # (n, 30)
    out = np.zeros((n, width_bytes), dtype=np.uint8)
    w = min(width_bytes, packed.shape[1])
    assert not packed[:, w:].any(), "value does not fit in record width"
    out[:, :w] = packed[:, :w]
    return out


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def zeros(batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((NLIMB, *batch_shape), dtype=torch.int32, device=device)


def ones(batch_shape=(), device="cpu") -> torch.Tensor:
    o = zeros(batch_shape, device)
    o[0] = 1
    return o


def const(value: int, ndim: int, device) -> torch.Tensor:
    """A python-int constant as canonical limbs shaped (20, 1, ..., 1)
    against an ndim-dimensional operand."""
    return torch.as_tensor(from_int(value), device=device).reshape(
        (NLIMB,) + (1,) * (ndim - 1)
    )


def broadcast_scalar(limbs, batch_shape) -> torch.Tensor:
    """int32[20] -> int32[20, *batch]."""
    a = torch.as_tensor(limbs, dtype=torch.int32)
    return a.reshape((NLIMB,) + (1,) * len(batch_shape)).expand(NLIMB, *batch_shape)


# ---------------------------------------------------------------------------
# Loose-limb arithmetic (the JAX package's formulas; results agree with
# it after strong_normalize)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return weak_normalize(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return weak_normalize(a - b)


def neg(b: torch.Tensor) -> torch.Tensor:
    return weak_normalize(-b)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook limb convolution.  Loose limbs (|limb| <= 10000) keep
    every 20-term column below 2^31, so it is exact in int32."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    out = torch.zeros((2 * NLIMB - 1, *shape), dtype=torch.int32, device=a.device)
    for i in range(NLIMB):
        out[i : i + NLIMB] += a[i] * b
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return weak_normalize(_conv(a, b))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a python-int constant."""
    return mul(a, const(c, a.dim(), a.device))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select over the batch shape (True -> a)."""
    return torch.where(mask[None], a, b)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent, left-to-right square-and-multiply."""
    if e == 0:
        return ones(a.shape[1:], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch: value == 0 mod p."""
    return torch.all(strong_normalize(a) == 0, dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


# ---------------------------------------------------------------------------
# Bulk helpers
# ---------------------------------------------------------------------------

_SUM_CHUNK = 250_000  # raw int32 limb sums stay exact while n * 8300 < 2^31


def sum_along(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum along a batch axis (axis counted in batch dims, 0-based)."""
    ax = axis + 1
    n = a.shape[ax]
    total = None
    for s in range(0, max(n, 1), _SUM_CHUNK):
        part = weak_normalize(
            a.narrow(ax, s, min(_SUM_CHUNK, n - s)).sum(dim=ax, dtype=torch.int32)
        )
        total = part if total is None else add(total, part)
    return total


def _shift_fill_one(u: torch.Tensor, s: int, ax: int, reverse: bool) -> torch.Tensor:
    """Shift by s along ax, filling the vacated slots with Fr one."""
    n = u.shape[ax]
    one = ones((1,) * (u.dim() - 1), u.device)
    shape = [1] * (u.dim() - 1)
    shape[ax - 1] = n
    idx = torch.arange(n, device=u.device).reshape(shape)
    if reverse:
        return select(idx >= n - s, one, torch.roll(u, -s, dims=ax))
    return select(idx < s, one, torch.roll(u, s, dims=ax))


def _scan_mul(v: torch.Tensor, ax: int, reverse: bool = False) -> torch.Tensor:
    """Inclusive product scan along axis `ax` (Hillis-Steele doubling:
    log2(n) full-width multiplies)."""
    s = 1
    n = v.shape[ax]
    while s < n:
        v = mul(v, _shift_fill_one(v, s, ax, reverse))
        s <<= 1
    return v


def _inv_few(a: torch.Tensor) -> torch.Tensor:
    """inv() of a handful of elements through python ints: one round
    trip instead of the ~350 dependent multiplies of a Fermat chain.
    Same values as inv(); inv(0) = 0."""
    vals = to_int(a.reshape(NLIMB, -1))
    out = from_int([pow(v, -1, P) if v else 0 for v in vals])
    return torch.as_tensor(out, device=a.device).reshape(a.shape)


def batch_inverse(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Montgomery-trick batched inversion along a batch axis: prefix and
    suffix product scans, one inversion per batch (_inv_few); zero
    entries map to zero."""
    ax = axis + 1
    zmask = is_zero(a)
    safe = select(zmask, ones(a.shape[1:], a.device), a)
    pref = _scan_mul(safe, ax)
    total = pref.narrow(ax, a.shape[ax] - 1, 1)
    inv_total = _inv_few(total)
    suf = _scan_mul(safe, ax, reverse=True)
    out = mul(
        mul(_shift_fill_one(pref, 1, ax, False), _shift_fill_one(suf, 1, ax, True)),
        inv_total,
    )
    return select(zmask, zeros(a.shape[1:], a.device), out)


def horner_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[:, i] * x^i (coeffs int32[20, n], x int32[20]),
    one multiply-add per coefficient."""
    acc = zeros((), coeffs.device)
    for i in range(coeffs.shape[1] - 1, -1, -1):
        acc = add(mul(acc, x), coeffs[:, i])
    return acc


def powers(x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] as int32[20, n] (log-depth scan)."""
    xb = torch.as_tensor(x, dtype=torch.int32)[:, None].expand(NLIMB, n).clone()
    xb[:, 0] = torch.as_tensor(from_int(1), device=xb.device)
    return _scan_mul(xb, 1)


def poly_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[:, i] x^i: Horner up to 64 coefficients, above that
    a powers scan and one wide sum (~2 log2 n full-width passes)."""
    n = coeffs.shape[-1]
    if n <= 64:
        return horner_eval(coeffs, x)
    return sum_along(mul(coeffs, powers(x, n)), axis=0)
