"""Fr, the sect233k1 scalar field (232-bit prime), as torch limb
arithmetic -- the part the MSM needs: layout, host conversions and
normalisation.

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


def _col(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constant limbs as an (L, 1, ..., 1) tensor beside `like`."""
    shape = (len(limbs),) + (1,) * (like.dim() - 1)
    return torch.as_tensor(limbs, dtype=torch.int32, device=like.device).reshape(shape)


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
