"""Bit-sliced GF(2^233) in torch: 233 bit-plane rows, 32 field elements
per 32-bit word.

Counterpart of dvpari_tpu/ops/gf2bs.py.  An element batch is
`int32[233, *cols]`: row i holds bit i of 32*prod(cols) elements
(element 32*c + j lives in bit j of column c).  Planes are int32, a
bit-exact view of the JAX package's uint32 planes: torch has no `~`,
`>>` or `<<` for uint32.  Every op here is bitwise, so the sign bit is
just bit 31 -- except a right shift, which must be made logical (see
shr).  Reduction trinomial: x^233 + x^74 + 1.

These are the plain versions the CPU tests hold against JAX and that
ops/msm_kernel.py holds the CUDA kernel against.
"""

from __future__ import annotations

import numpy as np
import torch

M = 233
WIDE = 2 * M - 1  # 465
K = 74  # x^233 = x^74 + 1


# ---------------------------------------------------------------------------
# Host conversions (numpy uint32, the JAX package's layout)
# ---------------------------------------------------------------------------

def pack_words(words: np.ndarray) -> np.ndarray:
    """Word layout uint32[8, n] -> bit-planes uint32[233, n/32].

    n must be a multiple of 32 (callers pad with zeros).
    """
    words = np.asarray(words, dtype=np.uint32)
    nw, n = words.shape
    assert nw == 8 and n % 32 == 0, (words.shape,)
    b8 = words.T.copy().view(np.uint8)  # (n, 32) bytes, LE
    bits = np.unpackbits(b8, axis=1, bitorder="little")  # (n, 256)
    bits = bits[:, :M].T  # (233, n)
    packed = np.packbits(
        bits.reshape(M, n // 32, 32), axis=2, bitorder="little"
    )  # (233, n/32, 4) uint8
    return packed.view(np.uint32)[..., 0].copy()


def unpack_words(planes) -> np.ndarray:
    """Bit-planes (..., 233, C) -> word layout uint32[..., 8, 32*C].

    A bit transpose done with torch ops on the planes' own device (a
    CUDA tensor stays on the card until the 8-word result comes back);
    numpy input is transposed on the CPU.
    """
    if not isinstance(planes, torch.Tensor):
        planes = torch.from_numpy(to_u32(planes).view(np.int32))
    *lead, m, c = planes.shape
    assert m == M, planes.shape
    sh = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = ((planes[..., None] >> sh) & 1).reshape(*lead, M, 32 * c)  # bit i of point n
    pad = bits.new_zeros((*lead, 256 - M, 32 * c))
    bits = torch.cat([bits, pad], dim=-2).reshape(*lead, 8, 32, 32 * c)
    words = bits[..., 0, :]
    for b in range(1, 32):
        words = words | (bits[..., b, :] << b)
    return words.cpu().numpy().view(np.uint32)


def to_int(planes) -> "list[int]":
    """Bit-plane batch (tensor or array) -> python ints (all 32*C slots)."""
    words = unpack_words(planes)
    return [
        sum(int(words[i, j]) << (32 * i) for i in range(8))
        for j in range(words.shape[1])
    ]


def to_u32(planes) -> np.ndarray:
    """int32 tensor / any integer array -> numpy uint32, bit for bit."""
    if isinstance(planes, torch.Tensor):
        return planes.detach().cpu().numpy().view(np.uint32)
    return np.asarray(planes).astype(np.uint32, copy=False)


# ---------------------------------------------------------------------------
# Core field ops (torch int32, shape (233, *cols))
# ---------------------------------------------------------------------------

def zeros(cols, device) -> torch.Tensor:
    return torch.zeros((M, *cols), dtype=torch.int32, device=device)


def ones(cols, device) -> torch.Tensor:
    """The constant 1 in every slot: plane 0 all-ones."""
    out = zeros(cols, device)
    out[0] = -1
    return out


def shr(x: torch.Tensor, sh: int) -> torch.Tensor:
    """Logical right shift of int32 words (uint32 `>>`): torch's int32
    `>>` is arithmetic, so the sign-extended top bits are masked off."""
    return (x >> sh) & ((1 << (32 - sh)) - 1)


def _reduce_wide(w: torch.Tensor) -> torch.Tensor:
    """Reduce int32[465, *cols] mod x^233 + x^74 + 1.

    bit 233+j folds to j and j+74; the second fold's overflow (bits
    307..464 -> 74+j >= 233) folds once more.
    """
    c = w[:M].clone()
    h = w[M:]  # 232 rows: bits 233..464
    c[: M - 1] ^= h
    c[K:] ^= h[: M - K]
    over = h[M - K :]  # 73 rows: bits 307..464, at 233+j after one fold
    c[: K - 1] ^= over
    c[K : 2 * K - 1] ^= over
    return c


def _xor_rows(r: torch.Tensor) -> torch.Tensor:
    """XOR-reduce over the leading axis (log-depth fold)."""
    while r.shape[0] > 1:
        half = r.shape[0] // 2
        folded = r[:half] ^ r[half : 2 * half]
        r = torch.cat([folded, r[2 * half :]], dim=0) if r.shape[0] % 2 else folded
    return r[0]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook bit-plane multiply: c[k] = XOR_{i+j=k} a[i] & b[j].

    All 233 x 233 partial products form one broadcast AND; the
    anti-diagonal sums come from a skew view (pad each row to 466, read
    the flat buffer with row stride 465, so element (i, k) is the
    product at (i, k - i) or zero padding), then a log-depth XOR fold.
    """
    cols = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand(M, *cols)
    b = b.expand(M, *cols)
    prod = a[:, None] & b[None, :]  # (233, 233, *cols): a[i] & b[j]
    pad = torch.zeros((M, M, *cols), dtype=prod.dtype, device=prod.device)
    skew = torch.cat([prod, pad], dim=1).reshape(M * 2 * M, *cols)
    skew = skew[: M * WIDE].reshape(M, WIDE, *cols)  # [i, k] = prod[i, k - i]
    return _reduce_wide(_xor_rows(skew))


def square(a: torch.Tensor) -> torch.Tensor:
    """Frobenius: interleave zero rows (bit i -> bit 2i) + fold."""
    w = torch.zeros((WIDE, *a.shape[1:]), dtype=a.dtype, device=a.device)
    w[0::2] = a
    return _reduce_wide(w)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        a = square(a)
    return a


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(2^233 - 2) via Itoh-Tsujii (gf2_host.inv_int's chain: 10
    multiplies, 232 squarings); inv(0) = 0."""
    x1 = a
    x2 = mul(pow2k(x1, 1), x1)
    x3 = mul(pow2k(x2, 1), x1)
    x6 = mul(pow2k(x3, 3), x3)
    x7 = mul(pow2k(x6, 1), x1)
    x14 = mul(pow2k(x7, 7), x7)
    x28 = mul(pow2k(x14, 14), x14)
    x29 = mul(pow2k(x28, 1), x1)
    x58 = mul(pow2k(x29, 29), x29)
    x116 = mul(pow2k(x58, 58), x58)
    x232 = mul(pow2k(x116, 116), x116)
    return square(x232)


# ---------------------------------------------------------------------------
# Per-element predicates (masks): int32[*cols], bit j = predicate of
# element 32*c + j.
# ---------------------------------------------------------------------------

def is_zero_mask(a: torch.Tensor) -> torch.Tensor:
    """~OR over rows: bit set iff the element is zero (log-depth fold)."""
    r = a
    while r.shape[0] > 1:
        half = r.shape[0] // 2
        folded = r[:half] | r[half : 2 * half]
        r = torch.cat([folded, r[2 * half :]], dim=0) if r.shape[0] % 2 else folded
    return ~r[0]


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element bit select (mask bit set -> a)."""
    return (a & mask[None]) | (b & ~mask[None])
