"""The PyTorch port's fixed-base ladder and MSM entry points on the CPU: plain
mulgen_packed against the JAX package's XLA twin of the Pallas kernel
(bit-equal), msm_limbs / mulgen_limbs at a ragged size against the
python-int host oracle, the port's copy of the cost model against the
JAX package's, and the CUDA kernels' own operation count against the
field's reduction and the kernel source.  Inputs are made with numpy
from a seed.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dvpari_tpu.ops import xsk233 as jxsk
from dvpari_tpu.ops import xsk233_bs as jbs
from dvpari_tpu.utils import roofline as jroofline
from dvpari_tpu.utils import xsk233_host as jhost
from dvpari_tpu_torch.ops import fr, msm_kernel, xsk233
from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import tnaf_device as td
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.utils import roofline
from dvpari_tpu_torch.utils import xsk233_host as host

SEED = 2718
G = (host.GX, host.GY)


def scalars(rng, n):
    return [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(n)]


@pytest.fixture(scope="module")
def masks_64():
    """Digit masks of 40 scalars (one zero) padded to 64 slots."""
    rng = np.random.default_rng(SEED)
    ks = scalars(rng, 40)
    ks[7] = 0
    oh, ng, ok = td.recode_masks(torch.from_numpy(fr.from_int(ks + [0] * 24)))
    assert bool(ok)
    return oh, ng


def test_plain_mulgen_matches_jax(masks_64):
    oh, ng = masks_64
    got = msm_kernel.mulgen_packed(oh, ng, xsk233.gen_table_planes(device="cpu"))
    want = jbs.mulgen_packed(
        jnp.asarray(F.to_u32(oh)), jnp.asarray(F.to_u32(ng)),
        jnp.asarray(jxsk._gen_table_planes()),
    )
    assert tuple(got.shape) == (3, 233, 2)
    np.testing.assert_array_equal(F.to_u32(got), np.asarray(want))


@pytest.fixture(scope="module")
def ragged_fanout():
    """n = 150 (not a multiple of 32) fixed-base fan-out on the CPU."""
    rng = np.random.default_rng(SEED + 1)
    es = scalars(rng, 150)
    es[0], es[1], es[2], es[100] = 1, 2, host.R - 1, 0
    proj, planes = xsk233.mulgen_limbs(fr.from_int(es), device="cpu")
    return es, proj, planes


def test_mulgen_limbs_vs_host(ragged_fanout):
    es, proj, planes = ragged_fanout
    assert proj.shape == (3, 8, 150) and tuple(planes.shape) == (3, 233, 5)
    got = xsk233.to_affine_int(proj)
    assert got[0] == G
    assert got[1] == host.add(G, G)
    assert got[2] == host.neg(G)
    assert got[100] is None
    assert got[149] == host.smul(es[149], G)  # the ragged tail's last slot
    padding = xsk233.to_affine_int(jbs.unpack_points(F.to_u32(planes))[..., 150:])
    assert padding == [None] * 10


def test_msm_limbs_vs_host(ragged_fanout):
    es, _, planes = ragged_fanout
    rng = np.random.default_rng(SEED + 2)
    ks = scalars(rng, 150)
    ks[3] = 0
    got = xsk233.msm_limbs(fr.from_int(ks), planes, device="cpu")
    want = host.smul(sum(k * e for k, e in zip(ks, es)) % host.R, G)
    assert xsk233.to_affine_int(got) == want
    assert host.encode(want) == jhost.encode(want)


def test_roofline_copy_matches_jax():
    for n in (1 << 10, 1 << 18):
        mine, theirs = roofline.msm_bitsliced_cost(n), jroofline.msm_bitsliced_cost(n)
        assert (mine.lane_ops, mine.hbm_bytes) == (theirs.lane_ops, theirs.hbm_bytes)


@pytest.mark.parametrize("rows", ["product", "square"])
def test_kernel_fold_count_matches_reduction(rows):
    """The cost model's fold map is the field's: a one in wide row r
    reduces to a one in each output row that fold_inputs sends r to."""
    wide_rows = range(F.WIDE) if rows == "product" else range(0, F.WIDE, 2)
    hits = np.zeros(F.M, np.int64)
    for r in wide_rows:
        w = torch.zeros((F.WIDE, 1), dtype=torch.int32)
        w[r] = 1
        hits += F._reduce_wide(w)[:, 0].numpy() & 1
    assert roofline.fold_inputs(wide_rows) == hits.tolist()


def _kernel_source():
    with open(msm_kernel.SOURCE) as f:
        return f.read()


def _body(src, start, end):
    return src[src.index(start) : src.index(end, src.index(start))]


def _schedule(body):
    """The mul_pass / out_pass / zero_partials calls of a kernel function,
    in order: ("mul", [(a, b), ...]), ("out", [(dst, wide, sq, xr), ...])
    or ("zero", [slots])."""
    calls = []
    for m in re.finditer(r"(mul_pass|out_pass|zero_partials)\((.*?)\);", body, re.S):
        kind, args = m.group(1), " ".join(m.group(2).split())
        if kind == "mul_pass":
            n, names = re.fullmatch(r"(\d), ops\((.*)\)", args).groups()
            names = [x.strip() for x in names.split(",")]
            calls.append(("mul", list(zip(names[0::2], names[1::2]))[: int(n)]))
        elif kind == "out_pass":
            n = int(args.split(",")[0])
            res = []
            for r in re.findall(r"res\(([^)]*)\)", args)[:n]:
                f = [x.strip() for x in r.split(",")] + ["NO", "NO"]
                wide = [int(w.strip()[1:]) for w in f[1].split("|") if w.strip() != "0"]
                res.append((f[0], wide, None if f[2] == "NO" else f[2],
                            None if f[3] == "NO" else f[3]))
            assert len(res) == n, args
            calls.append(("out", res))
        else:
            calls.append(("zero", [x.strip() for x in args.split(",")]))
    return calls


def _replay(calls, slots):
    """Run a schedule with the plain field ops; checks that no result of
    an out_pass reads a slot that another result of it writes, and that
    every product read was computed by the last mul_pass."""
    wide, zeros = [], None
    for kind, args in calls:
        if kind == "mul":
            assert 1 <= len(args) <= 4
            wide = [F.mul(slots[a], slots[b]) for a, b in args]
        elif kind == "zero":
            zeros = [F.is_zero_mask(slots[e]) for e in args]
        else:
            written = [r[0] for r in args]
            assert len(set(written)) == len(written)
            new = {}
            for dst, ws, sq, xr in args:
                assert sq not in written and (xr is None or xr == dst or xr not in written)
                v = torch.zeros_like(slots["X1"])
                for k in ws:
                    v = v ^ wide[k]
                if sq is not None:
                    v = v ^ F.square(slots[sq])
                if xr is not None:
                    v = v ^ slots[xr]
                new[dst] = v
            slots.update(new)
    return zeros


def test_kernel_cost_counts_the_source():
    """The products and squarings of csrc/bs_ladder.cu's generic add,
    doubling and tau^4 are the cost model's; a multiply is 233^2 terms
    plus a 306-LOP3 fold; a ladder's count adds one doubling per
    column-window that ran it."""
    src = _kernel_source()
    parts = {
        "generic": (_body(src, "void point_add()", "uint32_t zm[4]"),
                    roofline.GENERIC_MULS, roofline.GENERIC_SQRS),
        "double": (_body(src, "void point_double()", "void point_add()"),
                   roofline.DOUBLE_MULS, roofline.DOUBLE_SQRS),
        "tau4": (_body(src, "phase_override(PH_FROB);", "point_add();"), 0, roofline.FROB_SQRS),
    }
    for name, (body, muls, sqrs) in parts.items():
        calls = _schedule(body)
        assert sum(len(a) for k, a in calls if k == "mul") == muls, name
        # a squaring that several results of one pass take counts once
        assert sum(len({r[2] for r in a} - {None}) for k, a in calls if k == "out") == sqrs, name
    assert roofline.MUL.instructions == 233 * 233 + 306
    assert roofline.ladder_cost(4, 4).instructions == 4 * 62 * roofline.WINDOW.instructions
    assert (roofline.ladder_cost(4, 4, doubles=3).instructions
            == roofline.ladder_cost(4, 4).instructions + 3 * roofline.DOUBLE.instructions)


def test_kernel_schedule_replays_the_plain_add(ragged_fanout):
    """csrc/bs_ladder.cu's levels of field operations (slots, products,
    reductions, squarings, XORs, zero tests, selects), replayed with the
    plain field ops, give xsk233_bs.add bit for bit on generic pairs,
    P + P, P + (-P), one P = Q lane and infinity, and tau^4 gives
    frobenius(., 4)."""
    src = _kernel_source()
    _, _, planes = ragged_fanout  # 150 points, 10 padding slots at infinity
    p = planes
    q = torch.roll(planes, 1, dims=-1)
    q[..., 1] = p[..., 1]
    q[..., 2] = bs.neg(p[..., 2:3])[..., 0]
    lane = torch.tensor(1 << 3, dtype=torch.int32)
    q[..., 3] = (p[..., 3] & lane) | (q[..., 3] & ~lane)
    names = "X1 Y1 Z1 X2 Y2 Z2 S0 S1 S2 S3 S4 S5 S6 D0 D1".split()
    slots = {n: torch.zeros_like(p[0]) for n in names}
    slots.update(X1=p[0], Y1=p[1], Z1=p[2], X2=q[0], Y2=q[1], Z2=q[2])

    zeros = _replay(_schedule(_body(src, "void point_add()", "uint32_t zm[4]")), slots)
    inf_p, inf_q, v_zero, u_zero = zeros
    assert bool(((v_zero & u_zero & ~inf_p & ~inf_q) != 0).any())  # the doubling runs
    _replay(_schedule(_body(src, "void point_double()", "void point_add()")), slots)
    sel = _body(src, "const int gen[3]", "for (int idx")
    gen, dbl = (re.search(rf"{k}\[3\] = \{{(.*?)\}}", sel).group(1).split(", ")
                for k in ("gen", "dbl"))
    res = bs.point_select(v_zero & ~u_zero, bs.infinity((p.shape[-1],), "cpu"),
                          torch.stack([slots[n] for n in gen]))
    res = bs.point_select(v_zero & u_zero, torch.stack([slots[n] for n in dbl]), res)
    res = bs.point_select(inf_q, p, res)
    res = bs.point_select(inf_p, q, res)
    assert torch.equal(res, bs.add(p, q))

    slots.update(X1=p[0], Y1=p[1], Z1=p[2])
    _replay(_schedule(_body(src, "phase_override(PH_FROB);", "point_add();")), slots)
    assert torch.equal(torch.stack([slots["X1"], slots["Y1"], slots["Z1"]]),
                       bs.frobenius(p, 4))
