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


def test_kernel_cost_counts_the_source():
    """The complete add's multiplies and squarings are those of
    csrc/bs_ladder.cu; a multiply is 233^2 terms plus a 306-LOP3 fold."""
    with open(msm_kernel.SOURCE) as f:
        src = f.read()
    body = src[src.index("void point_double()") : src.index("__global__")]
    assert len(re.findall(r"^\s*gf_mul\(", body, re.M)) == roofline.ADD_MULS
    assert len(re.findall(r"^\s*gf_sqr\(", body, re.M)) == roofline.ADD_SQRS
    assert roofline.MUL.instructions == 233 * 233 + 306
    assert roofline.ladder_cost(4, 4).instructions == 4 * 62 * roofline.WINDOW.instructions
