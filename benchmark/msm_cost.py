"""The fixed work of a sect233k1 MSM of N points, and the least time an
H100 could take for it.

A frozen copy of the port's utils/roofline.py (`ladder_cost`,
`point_add_cost`, `bound` and the counts they rest on), taken when the
MSM ran as one bit-sliced tau-NAF ladder launch over C = ceil(N/32)
columns of 32 points, a window table of six complete adds over the
columns side by side, a pairwise column fold and five in-word folds
(ops/msm_kernel.py:msm_packed).  `msm_work(N)` is that schedule's count
with no doubling run: the yardstick whatever later implements the MSM.

Counts are 32-bit lane operations; `fused` are the two-input operations
a three-input LOP3 does together with another, so the fewest
instructions are lane_ops - fused.  Bytes are each input read once and
each output written once.  The INT32 peak is 132 SMs x 64 lanes x the
SM clock; device memory moves 3.35 TB/s (NVIDIA's H100 SXM data sheet).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

M = 233
WIDE = 465
K = 74  # x^233 = x^74 + 1
N_WINDOWS = 62
TABLE_SIZE = 11

H100_SMS = 132
H100_INT32_LANES_PER_SM = 64
H100_HBM_BYTES_PER_S = 3.35e12


@dataclass
class Cost:
    lane_ops: float
    hbm_bytes: float
    fused: float = 0.0

    def __add__(self, o):
        return Cost(self.lane_ops + o.lane_ops, self.hbm_bytes + o.hbm_bytes,
                    self.fused + o.fused)

    def scaled(self, k):
        return Cost(self.lane_ops * k, self.hbm_bytes * k, self.fused * k)

    @property
    def instructions(self) -> float:
        return self.lane_ops - self.fused


def _fold_inputs(rows) -> "list[int]":
    """Input words of each output word when product rows fold mod
    x^233 + x^74 + 1."""
    n = [0] * M
    todo = list(rows)
    while todo:
        r = todo.pop()
        if r < M:
            n[r] += 1
        else:
            todo += [r - M, r - M + K]
    return n


def _fold(rows) -> Cost:
    n = [k for k in _fold_inputs(rows) if k > 1]
    xors = sum(k - 1 for k in n)
    return Cost(xors, 0.0, xors - sum(k // 2 for k in n))


def schoolbook(n: int) -> Cost:
    """The n x n word carry-less product as n^2 ANDs and their XOR sums,
    each AND fused with an XOR."""
    return Cost(2 * n * n - (2 * n - 1), 0.0, n * n - (2 * n - 1))


def _xor_sums(terms: "list[int]") -> Cost:
    """Output words, each the XOR of terms[i] inputs, three-input XORs
    where they fit."""
    xors = sum(t - 1 for t in terms if t > 1)
    return Cost(xors, 0.0, xors - sum(t // 2 for t in terms if t > 1))


@functools.lru_cache(maxsize=None)
def product(n: int) -> Cost:
    """The fewest instructions for an n x n word carry-less product over
    schoolbook and Karatsuba: with h = ceil(n/2), l = n - h,
    C = P0 + x^h (P1 + P0 + P2) + x^2h P2, P0 = A0 B0, P2 = A1 B1,
    P1 = (A0 + A1)(B0 + B1), each product again the cheaper of the two."""
    best = schoolbook(n)
    if n > 1:
        h, l = (n + 1) // 2, n // 2
        terms = [0] * (2 * n - 1)
        for off, width in ((0, 2 * h - 1), (2 * h, 2 * l - 1), (h, 2 * h - 1),
                           (h, 2 * h - 1), (h, 2 * l - 1)):
            for i in range(off, off + width):
                terms[i] += 1
        k = (product(h).scaled(2) + product(l) + Cost(2 * l, 0.0) + _xor_sums(terms))
        if k.instructions < best.instructions:
            best = k
    return best


SCHOOLBOOK_MUL = schoolbook(M) + _fold(range(WIDE))
MUL = product(M) + _fold(range(WIDE))
SQR = _fold(range(0, WIDE, 2))
_PICK = Cost(3 * M * (2 * TABLE_SIZE - 1) + 2 * M, 0.0, 3 * M * (TABLE_SIZE - 1) + M)
_GENERIC_XORS = Cost(7 * M, 0.0, 2 * M)
_ZERO_MASKS = Cost(4 * M, 0.0, 4 * ((M - 1) // 2))
_SELECTS = Cost(4 * 3 * 3 * M, 0.0, 4 * 2 * 3 * M)


def generic(mul: Cost = MUL) -> Cost:
    """One complete add of a column: 17 multiplies and 2 squarings."""
    return mul.scaled(17) + SQR.scaled(2) + _GENERIC_XORS + _ZERO_MASKS + _SELECTS


def window(mul: Cost = MUL) -> Cost:
    """One ladder window of a column: 12 squarings, a table pick, an add."""
    return SQR.scaled(12) + _PICK + generic(mul)


def ladder_cost(cols: int, mul: Cost = MUL) -> Cost:
    """One ladder launch over `cols` columns, each with its own table,
    no doubling run."""
    words = (N_WINDOWS * TABLE_SIZE * cols + N_WINDOWS * cols
             + TABLE_SIZE * 3 * M * cols + 3 * M * cols)
    return window(mul).scaled(N_WINDOWS * cols) + Cost(0.0, 4.0 * words)


def point_add_cost(cols: int, mul: Cost = MUL) -> Cost:
    """One complete-add launch over `cols` columns, no doubling run."""
    return generic(mul).scaled(cols) + Cost(0.0, 4.0 * 3 * (3 * M * cols))


def msm_adds(n_points: int) -> "list[int]":
    """Column widths of the complete-add launches of one MSM: the table's
    six adds side by side, the column folds, the five in-word folds."""
    c = -(-n_points // 32)
    widths = [6 * c]
    while c > 1:
        widths.append(c // 2)
        c = c // 2 + c % 2
    return widths + [1] * 5


def msm_work(n_points: int, mul: Cost = MUL) -> Cost:
    c = -(-n_points // 32)
    total = ladder_cost(c, mul)
    for w in msm_adds(n_points):
        total = total + point_add_cost(w, mul)
    return total


def bound(cost: Cost, sm_clock_mhz: float) -> "tuple[float, str]":
    """(least seconds, "operations" or "bytes")."""
    t_ops = cost.instructions / (H100_SMS * H100_INT32_LANES_PER_SM * sm_clock_mhz * 1e6)
    t_bytes = cost.hbm_bytes / H100_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
