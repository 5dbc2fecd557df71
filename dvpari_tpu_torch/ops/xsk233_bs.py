"""Bit-sliced sect233k1 group law and tau-NAF ladder in torch.

Counterpart of dvpari_tpu/ops/xsk233_bs.py: a point batch is
`int32[3, 233, *cols]` (homogeneous X:Y:Z bit planes, 32 points per
word), Z == 0 is infinity, and the group add is masked-complete -- the
generic, doubling and infinity cases are all evaluated and combined with
per-element bit masks.  Same formulas, same table order and same fold
order as the JAX package, so the planes are bit-equal.

These are the plain versions; ops/msm_kernel.py runs the ladder and the
add as CUDA kernels and holds them against these.
"""

from __future__ import annotations

import numpy as np
import torch

from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops.tnaf import N_WINDOWS, TABLE_SIZE

M = F.M


# ---------------------------------------------------------------------------
# Point helpers: stacked int32[3, 233, *cols]
# ---------------------------------------------------------------------------

def infinity(cols, device) -> torch.Tensor:
    """(0 : 1 : 0) in every slot."""
    return torch.stack(
        [F.zeros(cols, device), F.ones(cols, device), F.zeros(cols, device)], dim=0
    )


def point_select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a & mask[None, None]) | (b & ~mask[None, None])


def frobenius(p: torch.Tensor, k: int = 1) -> torch.Tensor:
    """tau^k: square all three coordinates k times."""
    out = p.transpose(0, 1)  # (233, 3, *cols): one batched square
    for _ in range(k):
        out = F.square(out)
    return out.transpose(0, 1).contiguous()


def double(p: torch.Tensor) -> torch.Tensor:
    """Tangent doubling: S = XZ, T = X^2 + YZ,
    X3 = T(T + S)S, Y3 = X^4 S + T(T + S)^2, Z3 = S^3."""
    X, Y, Z = p[0], p[1], p[2]
    S = F.mul(X, Z)
    YZ = F.mul(Y, Z)
    X2 = F.square(X)
    S2 = F.square(S)
    T = X2 ^ YZ
    TpS = T ^ S
    X4 = F.square(X2)
    TT = F.mul(T, TpS)
    Z3 = F.mul(S2, S)
    X3 = F.mul(TT, S)
    Y3 = F.mul(X4, S) ^ F.mul(TT, TpS)
    return torch.stack([X3, Y3, Z3], dim=0)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Masked-complete addition; predicates are single int32 rows.

    W = Z1 Z2, U = Y1 Z2 + Y2 Z1, V = X1 Z2 + X2 Z1,
    N = U^2 W + U V W + V^3, X3 = N V, Z3 = V^3 W,
    Y3 = U (X1 V^2 Z2 + N) + V N + Y1 V^3 Z2.
    """
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    Wm = F.mul(Z1, Z2)
    U = F.mul(Y1, Z2) ^ F.mul(Y2, Z1)
    V = F.mul(X1, Z2) ^ F.mul(X2, Z1)
    V2 = F.square(V)
    U2 = F.square(U)
    V3 = F.mul(V2, V)
    UW = F.mul(U, Wm)
    U2W = F.mul(U2, Wm)
    UWV = F.mul(UW, V)
    V2Z2 = F.mul(V2, Z2)
    Z3 = F.mul(V3, Wm)
    V3Z2 = F.mul(V3, Z2)
    N = U2W ^ UWV ^ V3
    X3 = F.mul(N, V)
    X1V2Z2 = F.mul(X1, V2Z2)
    Y1V3Z2 = F.mul(Y1, V3Z2)
    Y3 = F.mul(U, X1V2Z2 ^ N) ^ F.mul(V, N) ^ Y1V3Z2
    generic = torch.stack([X3, Y3, Z3], dim=0)

    dbl = double(p)

    inf_p = F.is_zero_mask(Z1)
    inf_q = F.is_zero_mask(Z2)
    v_zero = F.is_zero_mask(V)
    u_zero = F.is_zero_mask(U)

    res = point_select(v_zero & ~u_zero, infinity(generic.shape[2:], p.device), generic)
    res = point_select(v_zero & u_zero, dbl, res)
    res = point_select(inf_q, p, res)
    res = point_select(inf_p, q, res)
    return res


def neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[0], p[0] ^ p[1], p[2]], dim=0)


def cneg(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Conditionally negate per element: Y ^= X & mask."""
    return torch.stack([p[0], p[1] ^ (p[0] & mask[None]), p[2]], dim=0)


# ---------------------------------------------------------------------------
# tau-NAF window table + ladder
# ---------------------------------------------------------------------------

def tnaf_table(p: torch.Tensor, add=add) -> torch.Tensor:
    """[inf, P, tP, t2P, t3P, P+-t2P, P+-t3P, tP+-t3P]: (11, 3, 233, *cols).

    The six sums run as one `add` over the columns laid side by side;
    `add` is the plain add here and the CUDA point add in
    ops/msm_kernel.py (same function, bit for bit).
    """
    tp = frobenius(p)
    t2p = frobenius(tp)
    t3p = frobenius(t2p)
    C = p.shape[-1]
    A = torch.cat([p, p, p, p, tp, tp], dim=-1)
    B = torch.cat([t2p, neg(t2p), t3p, neg(t3p), t3p, neg(t3p)], dim=-1)
    S = add(A, B)
    sums = [S[..., i * C : (i + 1) * C] for i in range(6)]
    inf = infinity(p.shape[2:], p.device)
    return torch.stack([inf, p, tp, t2p, t3p, *sums], dim=0)


def _table_pick(table: torch.Tensor, masks_w: torch.Tensor) -> torch.Tensor:
    """t = XOR_e table[e] & mask[e] -- digit masks are disjoint per bit."""
    t = table[0] & masks_w[0][None, None]
    for e in range(1, TABLE_SIZE):
        t = t ^ (table[e] & masks_w[e][None, None])
    return t


def ladder(idx_masks: torch.Tensor, neg_masks: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[k_i]P_i for all packed points.

    idx_masks: int32[N_WINDOWS, 11, *cols] one-hot digit bitmasks
    neg_masks: int32[N_WINDOWS, *cols] (bit set -> negate table entry)
    table:     int32[11, 3, 233, *cols] (or *cols = 1: one table for all)

    62 iterations of (tau^4 + masked table pick + complete add), MSB
    window first.
    """
    acc = infinity(idx_masks.shape[2:], idx_masks.device)
    for w in range(N_WINDOWS):
        acc = frobenius(acc, 4)
        wi = N_WINDOWS - 1 - w
        t = cneg(_table_pick(table, idx_masks[wi]), neg_masks[wi])
        acc = add(acc, t)
    return acc


def _fold_cols_core(flat: torch.Tensor, add) -> torch.Tensor:
    """Pairwise group-fold across the last axis: (3, 233, C) -> (3, 233, 1)."""
    while flat.shape[-1] > 1:
        C = flat.shape[-1]
        half = C // 2
        folded = add(flat[..., :half], flat[..., half : 2 * half])
        if C % 2:
            folded = torch.cat([folded, flat[..., 2 * half :]], dim=-1)
        flat = folded
    return flat


def fold_sum(p: torch.Tensor, add=add) -> torch.Tensor:
    """Group-sum every packed point: pairwise column fold + in-word bit
    fold.  Returns (3, 233) planes with the total in bit 0 of the word;
    the other bits carry slot-parallel partial sums, as in JAX."""
    flat = _fold_cols_core(p.reshape(3, M, -1), add)
    for sh in (16, 8, 4, 2, 1):
        flat = add(flat, F.shr(flat, sh))
    return flat[..., 0]


def fold_cols(p: torch.Tensor, add=add) -> torch.Tensor:
    """Column-only group fold (3, 233, k) -> (3, 233): no in-word fold."""
    return _fold_cols_core(p, add)[..., 0]


# ---------------------------------------------------------------------------
# Host-side packing (numpy uint32, the JAX package's layout)
# ---------------------------------------------------------------------------

def digit_masks(idx: np.ndarray, sgn: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Window codes int[N_WINDOWS, n] -> (one-hot digit masks
    uint32[N_WINDOWS, 11, n/32], negative masks uint32[N_WINDOWS, n/32]).
    n must be a multiple of 32 (pad idx with 0 = infinity digit)."""
    nw, n = idx.shape
    assert nw == N_WINDOWS and n % 32 == 0, (idx.shape,)
    onehot = idx[:, None, :] == np.arange(TABLE_SIZE)[None, :, None]
    oh = np.packbits(
        onehot.reshape(nw, TABLE_SIZE, n // 32, 32), axis=3, bitorder="little"
    ).view(np.uint32)[..., 0]
    ng = np.packbits(
        (sgn < 0).reshape(nw, n // 32, 32), axis=2, bitorder="little"
    ).view(np.uint32)[..., 0]
    return oh, ng


def pack_points(points: np.ndarray) -> np.ndarray:
    """Word-layout points uint32[3, 8, n] -> planes uint32[3, 233, ceil32(n)]
    (pads with (0:0:0), which the complete add treats as infinity)."""
    points = np.asarray(points, dtype=np.uint32)
    pad = -points.shape[-1] % 32
    if pad:
        points = np.concatenate([points, np.zeros((3, 8, pad), np.uint32)], axis=-1)
    return np.stack([F.pack_words(points[i]) for i in range(3)], axis=0)


def unpack_points(planes) -> np.ndarray:
    """Planes (3, 233, C) -> word-layout batch uint32[3, 8, 32*C]
    (transposed on the planes' device, see gf2bs.unpack_words)."""
    return F.unpack_words(planes)


def extract_point(planes, slot: int = 0) -> np.ndarray:
    """(3, 233) planes -> word-layout point uint32[3, 8] from bit `slot`."""
    bit = (F.to_u32(planes) >> np.uint32(slot)) & np.uint32(1)  # (3, 233)
    out = np.zeros((3, 8), dtype=np.uint32)
    for i in range(M):
        out[:, i // 32] |= bit[:, i] << np.uint32(i % 32)
    return out
