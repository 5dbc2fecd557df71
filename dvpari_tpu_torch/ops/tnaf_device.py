"""Device-side tau-adic NAF recoding in torch: canonical Fr limbs ->
bit-sliced ladder masks, without leaving the device.

Counterpart of dvpari_tpu/ops/tnaf_device.py, step for step: the same
Barrett partial reduction, the same 248-step digit scan on lazy
radix-2^24 limbs and the same window codes, so `oh`, `ng` and `ok` are
bit-equal to the JAX recode_masks on the same canonical limbs.
`lax.scan` becomes a Python loop.

 1. partmod: rho = k - q*DELTA with q_i = (k*|C_i| + 2^(E-1)) >> E,
    C_i = round(2^E conj(DELTA)_i / N(DELTA)); any integer q gives a
    correct rho (DELTA kills the prime subgroup).
 2. tau-NAF digit loop: 248 steps on (c, d) in two's-complement
    radix-2^24 limbs (7 limbs = 168 bits; |rho| < 2^122).
 3. width-4 window codes + one-hot digit masks, packed little-endian
    into 32-bit words (bit j = element 32g + j).

All arithmetic is exact int32: 12-bit-limb convolutions keep partial
sums < 2^31, and the scan keeps limbs near [0, 2^24).
"""

from __future__ import annotations

import torch

from dvpari_tpu_torch.ops.tnaf import (
    DELTA,
    N_DELTA,
    N_WINDOWS,
    TABLE_SIZE,
    TNAF_LEN,
    _zt_conj,
)

# Barrett shift: 21 whole 12-bit limbs; |q_dev - q_exact| <= 1.
_E = 252
assert _E % 12 == 0
_E_LIMB = _E // 12

_CONJ = _zt_conj(DELTA)


def _round_div(a: int, b: int) -> int:
    """round(a/b), b > 0, half away from zero."""
    return (2 * a + b) // (2 * b) if a >= 0 else -((-2 * a + b) // (2 * b))


_C = [_round_div((1 << _E) * c, N_DELTA) for c in _CONJ]
_C_SIGN = [1 if c >= 0 else -1 for c in _C]
_D_SIGN = [1 if d >= 0 else -1 for d in DELTA]


def _limbs12(x: int) -> "list[int]":
    """|x| as 12-bit limbs, minimal length."""
    x = abs(x)
    out = []
    while x:
        out.append(x & 0xFFF)
        x >>= 12
    return out or [0]


_C_LIMBS = [_limbs12(c) for c in _C]
_D_LIMBS = [_limbs12(d) for d in DELTA]

_RL = 7  # rho working width: 7 x 24-bit limbs
_R12 = 2 * _RL  # 14 twelve-bit limbs before pairing
_MASK24 = (1 << 24) - 1


def _conv(k_limbs, c_limbs: "list[int]") -> "list[torch.Tensor]":
    """Exact big-int product: 12-bit limb rows x constant 12-bit limbs
    -> unnormalised limb accumulators (values < 2^28.4)."""
    acc = [None] * (len(k_limbs) + len(c_limbs) - 1)
    for j, cj in enumerate(c_limbs):
        if cj == 0:
            continue
        for i, k in enumerate(k_limbs):
            t = k * cj
            acc[i + j] = t if acc[i + j] is None else acc[i + j] + t
    z = torch.zeros_like(k_limbs[0])
    return [z if a is None else a for a in acc]


def _carry_pass(acc: "list[torch.Tensor]", out_len: int) -> "list[torch.Tensor]":
    """Sequential signed carry normalisation to 12-bit limbs; result
    two's-complement mod 2^(12*out_len) (limbs in [0, 2^12))."""
    z = torch.zeros_like(acc[0])
    out = []
    carry = None
    for i in range(out_len):
        v = acc[i] if i < len(acc) else z
        if carry is not None:
            v = v + carry
        carry = v >> 12  # arithmetic: floor division by 4096
        out.append(v & 0xFFF)
    return out


def _partmod_limbs(canon: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Canonical Fr limbs (20, N) int32 -> rho = (c, d), each (RL, N)
    int32 in normalised two's-complement radix-2^24 limbs."""
    k = list(canon)

    q = []
    for ci_limbs, ci_sign in zip(_C_LIMBS, _C_SIGN):
        acc = _conv(k, ci_limbs)
        half_limb = (_E - 1) // 12  # + 2^(E-1): bit 251 = limb 20 bit 11
        acc[half_limb] = acc[half_limb] + (1 << ((_E - 1) % 12))
        norm = _carry_pass(acc, len(acc) + 2)
        q.append((norm[_E_LIMB:], ci_sign))  # magnitude limbs, sign

    (q0, s0), (q1, s1) = q
    d0_l, d1_l = _D_LIMBS
    sd0, sd1 = _D_SIGN

    # qd = q * DELTA in Z[tau] (mu = -1):
    #   qd0 = q0*D0 - 2*q1*D1,  qd1 = q0*D1 + q1*D0 - q1*D1
    def smul(ql, qs, dl, ds, coef):
        sgn = qs * ds * coef
        return [p * sgn for p in _conv(ql, dl)]

    def ladd(a, b):
        z = torch.zeros_like(a[0])
        return [
            (a[i] if i < len(a) else z) + (b[i] if i < len(b) else z)
            for i in range(max(len(a), len(b)))
        ]

    qd0 = ladd(smul(q0, s0, d0_l, sd0, 1), smul(q1, s1, d1_l, sd1, -2))
    qd1 = ladd(
        ladd(smul(q0, s0, d1_l, sd1, 1), smul(q1, s1, d0_l, sd0, 1)),
        smul(q1, s1, d1_l, sd1, -1),
    )

    # rho0 = k - qd0, rho1 = -qd1; normalise mod 2^(12*_R12).
    z = torch.zeros_like(k[0])
    rho0 = [
        (k[i] if i < len(k) else z) - (qd0[i] if i < len(qd0) else z)
        for i in range(_R12)
    ]
    rho1 = [-(qd1[i] if i < len(qd1) else z) for i in range(_R12)]
    rho0 = _carry_pass(rho0, _R12)
    rho1 = _carry_pass(rho1, _R12)

    def pair24(l12):
        limbs = [l12[2 * i] + (l12[2 * i + 1] << 12) for i in range(_RL)]
        # normalised mod 2^168; |rho| < 2^122, so sign-extending the top
        # limb recovers the exact integer: subtract 2^24 if bit 167.
        limbs[-1] = limbs[-1] - (((limbs[-1] >> 23) & 1) << 24)
        return torch.stack(limbs)

    return pair24(rho0), pair24(rho1)


def _norm24(limbs: torch.Tensor) -> torch.Tensor:
    """One full sequential borrow/carry pass (inputs within +-2^30/limb);
    result limbs in [0, 2^24), two's complement mod 2^(24*RL)."""
    out = []
    carry = None
    for i in range(_RL):
        v = limbs[i] if carry is None else limbs[i] + carry
        carry = v >> 24
        out.append(v & _MASK24)
    return torch.stack(out)


def _renorm_lazy(limbs: torch.Tensor) -> torch.Tensor:
    """One vectorised carry-extraction step: push each limb's overflow
    one limb up.  The top limb keeps its own overflow, so the value stays
    an exact plain integer (the halving identity needs that)."""
    t = limbs >> 24  # arithmetic: floor(l / 2^24), handles negatives
    t[-1] = 0  # `t` is a fresh tensor: the top limb keeps its overflow
    lo = limbs - (t << 24)
    carry_in = torch.cat([torch.zeros_like(t[:1]), t[:-1]], dim=0)
    return lo + carry_in


def _half_lazy(limbs: torch.Tensor) -> torch.Tensor:
    """Exact value/2 of an even number in lazy signed limbs: each odd
    limb bit drops one limb as +2^23."""
    odd_up = torch.cat([limbs[1:], torch.zeros_like(limbs[:1])], dim=0)
    return (limbs >> 1) + ((odd_up & 1) << 23)


def _tnaf_scan(c: torch.Tensor, d: torch.Tensor):
    """248 tau-NAF digit steps (ops/tnaf.py:tnaf_digits vectorised):
    returns (digits (TNAF_LEN, N) int32 in {-1,0,1}, ok (N,) bool)."""
    digits = []
    for _ in range(TNAF_LEN):
        u = torch.where((c[0] & 1) == 1, 2 - ((c[0] - 2 * d[0]) & 3), 0)
        cu = c.clone()
        cu[0] -= u
        h = _half_lazy(cu)  # (c - u) even -> exact
        c, d = _renorm_lazy(d - h), -h
        digits.append(u)
    c_end = _norm24(c)
    d_end = _norm24(d)
    ok = torch.all(c_end == 0, dim=0) & torch.all(d_end == 0, dim=0)
    return torch.stack(digits), ok


def _window_codes(digits: torch.Tensor):
    """(TNAF_LEN, N) digits -> (idx (62, N), sgn (62, N), valid ()).
    Branchless ops/tnaf.py:_window_code; `valid` confirms NAF adjacency."""
    w = digits.reshape(N_WINDOWS, 4, -1)
    d0, d1, d2, d3 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    i32 = torch.int32
    nz0, nz1, nz2, nz3 = ((d != 0).to(i32) for d in (d0, d1, d2, d3))
    cnt = nz0 + nz1 + nz2 + nz3
    t_single = 1 + nz1 + 2 * nz2 + 3 * nz3
    s_single = d0 + d1 + d2 + d3
    pair02 = (nz0 & nz2) == 1
    pair03 = (nz0 & nz3) == 1
    pair13 = (nz1 & nz3) == 1
    t_pair = torch.where(
        pair02,
        5 + (d0 != d2).to(i32),
        torch.where(pair03, 7 + (d0 != d3).to(i32), 9 + (d1 != d3).to(i32)),
    )
    s_pair = torch.where(pair02 | pair03, d0, d1)
    idx = torch.where(cnt == 0, 0, torch.where(cnt == 1, t_single, t_pair))
    sgn = torch.where(cnt == 0, 1, torch.where(cnt == 1, s_single, s_pair))
    bad = (cnt > 2) | ((cnt == 2) & ~(pair02 | pair03 | pair13))
    return idx, sgn, ~torch.any(bad)


def _pack_le32(bits: torch.Tensor) -> torch.Tensor:
    """(..., G, 32) int32 0/1 -> (..., G) int32 words, little-endian bit
    order (bit j = element 32g + j).  Built by OR: bit 31 is the int32
    sign bit, where an int32 sum would overflow."""
    sh = torch.arange(32, dtype=torch.int32, device=bits.device)
    r = bits << sh
    while r.shape[-1] > 1:
        half = r.shape[-1] // 2
        r = r[..., :half] | r[..., half:]
    return r[..., 0]


def recode_masks(canon: torch.Tensor):
    """Canonical Fr limbs (20, N) int32, N % 32 == 0 -> ladder operands
    (oh int32[N_WINDOWS, 11, N/32], ng int32[N_WINDOWS, N/32], ok () bool).
    `ok` is the algebraic self-check (scan terminated, windows valid)."""
    n = canon.shape[-1]
    assert n % 32 == 0, n
    c, d = _partmod_limbs(canon)
    digits, scan_ok = _tnaf_scan(c, d)
    idx, sgn, win_ok = _window_codes(digits)
    ar = torch.arange(TABLE_SIZE, dtype=torch.int32, device=canon.device)
    oh_bits = (idx[:, None, :] == ar[None, :, None]).to(torch.int32)
    oh = _pack_le32(oh_bits.reshape(N_WINDOWS, TABLE_SIZE, n // 32, 32))
    ng = _pack_le32((sgn < 0).to(torch.int32).reshape(N_WINDOWS, n // 32, 32))
    return oh, ng, torch.all(scan_ok) & win_ok
