"""Operation and byte counts of the bit-sliced MSM kernels, and the least
time an H100 could take for them.

Two counts live here:

- `msm_bitsliced_cost` and its parts are copied from
  dvpari_tpu/utils/roofline.py: the JAX package's model of its own
  formulation (240-row aligned window passes and phase shifts per
  multiply), kept to compare the two packages' operation counts.
- `ladder_cost` and `point_add_cost` count what the CUDA kernels in
  csrc/bs_ladder.cu compute, formula by formula: a multiply is the
  233 x 233 schoolbook (one AND and one XOR per term) plus the
  trinomial fold, a squaring is the fold of the interleaved rows, and a
  complete add is the generic add (17 multiplies, 2 squarings, its XORs,
  zero tests and selects) plus, only where some lane of a column has
  P = Q, the doubling (7 multiplies, 3 squarings, 3 XOR passes).  The
  kernels skip the doubling elsewhere, so a launch's count takes the
  number of column-windows (or columns) whose doubling ran.  These give
  the bound that chip_smoke.py reports.

Counts are 32-bit lane operations per 32-point column.  `fused` counts
the two-input operations inside `lane_ops` that a three-input LOP3 does
together with another one (AND+XOR, XOR+XOR, OR+OR, a select's
AND/AND-NOT/OR), so the fewest instructions are lane_ops - fused.
Bytes are each input read once and each output written once.

The card's integer peak: 132 SMs x 64 INT32 lanes x the SM clock
(`nvidia-smi --query-gpu=clocks.max.sm`); device memory 3.35 TB/s.
"""

from __future__ import annotations

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
    lane_ops: float  # 32-bit lane operations
    hbm_bytes: float  # inputs read once + outputs written once
    fused: float = 0.0  # two-input ops within lane_ops merged into a LOP3

    def __add__(self, o):
        return Cost(self.lane_ops + o.lane_ops, self.hbm_bytes + o.hbm_bytes,
                    self.fused + o.fused)

    def scaled(self, k):
        return Cost(self.lane_ops * k, self.hbm_bytes * k, self.fused * k)

    @property
    def instructions(self) -> float:
        return self.lane_ops - self.fused


# ---------------------------------------------------------------------------
# The JAX package's cost model (copy)
# ---------------------------------------------------------------------------

def gf2bs_mul_cost(n_elems: int) -> Cost:
    """240 aligned window passes of AND+XOR over (240, C) planes + 8
    phase shifts + trinomial fold; n_elems = 32 * C."""
    C = max(n_elems // 32, 1)
    passes = 240 * 2 * 240 * C
    shifts = 8 * 2 * 472 * C
    fold = 6 * M * C
    return Cost(passes + shifts + fold, 0.0)


def gf2bs_square_cost(n_elems: int) -> Cost:
    C = max(n_elems // 32, 1)
    return Cost((2 * WIDE + 6 * M) * C, 0.0)


def bs_add_cost(n_elems: int) -> Cost:
    """Masked-complete add: 24 multiplies + 7 squares + predicates/selects."""
    mul24 = gf2bs_mul_cost(n_elems).scaled(24)
    sqr = gf2bs_square_cost(n_elems).scaled(7)
    masks = Cost(20 * M * max(n_elems // 32, 1), 0.0)
    return mul24 + sqr + masks


def _ladder_step(n_points: int) -> Cost:
    return (
        bs_add_cost(n_points)
        + gf2bs_square_cost(n_points).scaled(12)  # frobenius^4 x 3 coords
        + Cost(11 * 2 * 3 * M * max(n_points // 32, 1), 0.0)  # table pick
    )


def msm_bitsliced_cost(n_points: int) -> Cost:
    """Full tau-NAF bit-sliced MSM: table build (~6 adds + 3 frob) +
    62 x (frob^4 + pick + complete add) + fold (~one full-width add)."""
    table = bs_add_cost(n_points).scaled(6) + gf2bs_square_cost(n_points).scaled(9)
    fold = bs_add_cost(n_points)
    io = Cost(0.0, n_points * (3 * M / 8 + 62 * 12 / 8))  # planes + masks
    return _ladder_step(n_points).scaled(N_WINDOWS) + table + fold + io


# ---------------------------------------------------------------------------
# The CUDA kernels' own count (csrc/bs_ladder.cu), per 32-point column
# ---------------------------------------------------------------------------

GENERIC_MULS, GENERIC_SQRS = 17, 2  # the generic add
DOUBLE_MULS, DOUBLE_SQRS = 7, 3  # the doubling
FROB_SQRS = 12  # tau^4 of X, Y, Z per window


def fold_inputs(rows) -> "list[int]":
    """Input words of each of the 233 output words when the product rows
    `rows` (of 0..464) are folded mod x^233 + x^74 + 1."""
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
    """n words XORed into one: n - 1 XORs, ceil((n - 1) / 2) LOP3s."""
    n = [k for k in fold_inputs(rows) if k > 1]
    xors = sum(k - 1 for k in n)
    return Cost(xors, 0.0, xors - sum(k // 2 for k in n))


# 465 rows of n terms: n ANDs, n - 1 XORs, n instructions ((a & b) ^ c)
MUL = Cost(2 * M * M - WIDE, 0.0, M * M - WIDE) + _fold(range(WIDE))
SQR = _fold(range(0, WIDE, 2))  # the interleave only moves words
_PICK = Cost(3 * M * (2 * TABLE_SIZE - 1) + 2 * M, 0.0,
             3 * M * (TABLE_SIZE - 1) + M)  # 11 masked entries, then cneg
_GENERIC_XORS = Cost(7 * M, 0.0, 2 * M)  # U, V, N (two), X1 V^2 Z2 + N, Y3 (two)
_DOUBLE_XORS = Cost(3 * M, 0.0, 0.0)  # T, T + S, Y3
_ZERO_MASKS = Cost(4 * M, 0.0, 4 * ((M - 1) // 2))  # OR-reduce 4 elements, NOT
_SELECTS = Cost(4 * 3 * 3 * M, 0.0, 4 * 2 * 3 * M)  # 4 x (a & m) | (b & ~m)
GENERIC = (MUL.scaled(GENERIC_MULS) + SQR.scaled(GENERIC_SQRS) + _GENERIC_XORS
           + _ZERO_MASKS + _SELECTS)
DOUBLE = MUL.scaled(DOUBLE_MULS) + SQR.scaled(DOUBLE_SQRS) + _DOUBLE_XORS
WINDOW = SQR.scaled(FROB_SQRS) + _PICK + GENERIC  # a window whose doubling is skipped


def ladder_cost(cols: int, table_cols: int, doubles: int = 0) -> Cost:
    """One ladder launch over `cols` columns (32 points each) with a
    table of `table_cols` columns (cols, or 1 when shared), in which
    `doubles` column-windows ran the doubling."""
    words = (N_WINDOWS * TABLE_SIZE * cols + N_WINDOWS * cols
             + TABLE_SIZE * 3 * M * table_cols + 3 * M * cols)
    return (WINDOW.scaled(N_WINDOWS * cols) + DOUBLE.scaled(doubles)
            + Cost(0.0, 4.0 * words))


def point_add_cost(cols: int, doubles: int = 0) -> Cost:
    """One point-add launch over `cols` columns, `doubles` of which ran
    the doubling: two operands, one result."""
    return (GENERIC.scaled(cols) + DOUBLE.scaled(doubles)
            + Cost(0.0, 4.0 * 3 * (3 * M * cols)))


def int32_lane_ops_per_s(sm_clock_mhz: float) -> float:
    return H100_SMS * H100_INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def bound(cost: Cost, sm_clock_mhz: float) -> "tuple[float, str]":
    """(least seconds, "operations" or "bytes"): the larger of the fewest
    instructions over the INT32 peak and the bytes over the memory rate."""
    t_ops = cost.instructions / int32_lane_ops_per_s(sm_clock_mhz)
    t_bytes = cost.hbm_bytes / H100_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
