"""The frozen MSM work count against the port's utils/roofline.py and the
port's own launch schedule (replayed on meta tensors), and the product
count it charges a multiply."""

import random

import pytest
import torch

from benchmark import msm_cost


def _port_widths(n_points):
    """Column widths of every point_add launch of the port's msm_packed."""
    from dvpari_tpu_torch.ops import xsk233_bs as bs

    widths = []

    def add(a, b):
        widths.append(a.shape[-1])
        return a

    c = -(-n_points // 32)
    p = torch.empty((3, 233, c), dtype=torch.int32, device="meta")
    bs.tnaf_table(p, add=add)
    bs.fold_sum(torch.empty((3, 233, c), dtype=torch.int32, device="meta"), add=add)
    return c, widths


@pytest.mark.parametrize("m", [1 << 16, 1 << 18])
def test_msm_work_with_schoolbook_products_equals_the_ports_count(m):
    from dvpari_tpu_torch.utils import roofline as port

    school = msm_cost.SCHOOLBOOK_MUL
    for n in (m + 2, m, 4 * m):
        c, widths = _port_widths(n)
        assert widths == msm_cost.msm_adds(n)
        want = port.ladder_cost(c, c)
        for w in widths:
            want = want + port.point_add_cost(w)
        lad, plad = msm_cost.ladder_cost(c, school), port.ladder_cost(c, c)
        assert (lad.lane_ops, lad.hbm_bytes, lad.fused) == (plad.lane_ops, plad.hbm_bytes, plad.fused)
        got = msm_cost.msm_work(n, school)
        assert (got.lane_ops, got.hbm_bytes, got.fused) == (want.lane_ops, want.hbm_bytes, want.fused)
        assert msm_cost.bound(got, 1980.0) == port.bound(want, 1980.0)
        # the yardstick charges fewer operations, the same bytes
        least = msm_cost.msm_work(n)
        assert least.instructions < got.instructions and least.hbm_bytes == got.hbm_bytes


def _mul(a, b, ops):
    """The carry-less product of word vectors a, b (each word 32 lanes)
    by the formulation msm_cost.product counts, tallying two-input ANDs
    and XORs in ops."""
    n = len(a)
    if msm_cost.product(n) == msm_cost.schoolbook(n):
        out = [None] * (2 * n - 1)
        for i in range(n):
            for j in range(n):
                t = a[i] & b[j]
                ops[0] += 1
                if out[i + j] is None:
                    out[i + j] = t
                else:
                    out[i + j] ^= t
                    ops[0] += 1
        return out
    h = (n + 1) // 2
    a0, a1, b0, b1 = a[:h], a[h:], b[:h], b[h:]
    sa = [x ^ y for x, y in zip(a0, a1)] + a0[len(a1):]
    sb = [x ^ y for x, y in zip(b0, b1)] + b0[len(b1):]
    ops[0] += 2 * len(a1)
    p0, p2, p1 = _mul(a0, b0, ops), _mul(a1, b1, ops), _mul(sa, sb, ops)
    out = [None] * (2 * n - 1)
    for off, part in ((0, p0), (2 * h, p2), (h, p1), (h, p0), (h, p2)):
        for i, v in enumerate(part):
            if out[off + i] is None:
                out[off + i] = v
            else:
                out[off + i] ^= v
                ops[0] += 1
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 29, 58, 117, 233])
def test_product_count_is_a_working_formulation(n):
    """The counted formulation computes the product, with exactly the
    counted two-input operations."""
    rnd = random.Random(n)
    a = [rnd.getrandbits(32) for _ in range(n)]
    b = [rnd.getrandbits(32) for _ in range(n)]
    ops = [0]
    got = _mul(a, b, ops)
    want = [0] * (2 * n - 1)
    for i in range(n):
        for j in range(n):
            want[i + j] ^= a[i] & b[j]
    assert got == want
    assert ops[0] == msm_cost.product(n).lane_ops
    assert msm_cost.product(n).instructions <= msm_cost.schoolbook(n).instructions
