"""The PyTorch port's plain msm_packed (what the CUDA kernels are held
against on the card) against the JAX package's XLA twin of the Pallas
kernel path (jbs.msm_packed): bit-equal planes; and the ladder operands
crafted to take the doubling branch against the host oracle.  Inputs
are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dvpari_tpu.ops import xsk233_bs as jbs
from dvpari_tpu_torch.ops import fr, msm_kernel, tnaf, xsk233
from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import tnaf_device as td
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.utils import gf2_host as gh
from dvpari_tpu_torch.utils import xsk233_host as host

SEED = 2718


def scalars(rng, n):
    return [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(n)]


@pytest.fixture(scope="module")
def ladder_case():
    """40 scalars (one zero) padded to 64 slots, their digit masks, and
    40 random points (padding columns zero planes)."""
    rng = np.random.default_rng(SEED)
    ks = scalars(rng, 40)
    ks[7] = 0
    canon = torch.from_numpy(fr.from_int(ks + [0] * 24))
    oh, ng, ok = td.recode_masks(canon)
    assert bool(ok)
    _, planes = xsk233.mulgen_limbs(fr.from_int(scalars(rng, 40)), device="cpu")
    return oh, ng, planes


def test_plain_msm_matches_jax(ladder_case):
    oh, ng, planes = ladder_case
    got = msm_kernel.msm_packed(oh, ng, planes)
    want = jbs.msm_packed(
        jnp.asarray(F.to_u32(oh)), jnp.asarray(F.to_u32(ng)), jnp.asarray(F.to_u32(planes))
    )
    assert tuple(got.shape) == (3, 233)
    # all 32 bits: bit 0 is the MSM, the rest the in-word fold's partial
    # sums, which a sign-extending shift would change
    np.testing.assert_array_equal(F.to_u32(got), np.asarray(want))


def test_host_recode_gives_the_same_msm(ladder_case):
    """The python recoder's digits (exact rounding) differ from the
    device recoder's (Barrett rounding), but drive the ladder to the
    same group element."""
    _, _, planes = ladder_case
    rng = np.random.default_rng(SEED + 3)
    ks = scalars(rng, 64)
    idx, sgn = tnaf.recode_scalars(ks)
    oh_h, ng_h = (torch.from_numpy(m.view(np.int32)) for m in bs.digit_masks(idx, sgn))
    oh_d, ng_d, ok = td.recode_masks(torch.from_numpy(fr.from_int(ks)))
    assert bool(ok)
    by_host = msm_kernel.msm_packed(oh_h, ng_h, planes)
    by_device = msm_kernel.msm_packed(oh_d, ng_d, planes)
    assert xsk233.to_affine_int(bs.extract_point(by_host)) == xsk233.to_affine_int(
        bs.extract_point(by_device)
    )


def test_crafted_doubling_ladder_vs_host(ladder_case):
    """The ladder operands built to take the complete add's doubling
    branch: at window 60 the chosen slots, and only those, have P = Q
    with neither point infinity, and the plain ladder's result equals
    the host oracle's in those slots and in others."""
    _, _, planes = ladder_case  # 40 finite points, then zero planes
    table = bs.tnaf_table(planes)
    slots = [0, 21, 33, 39]
    oh, ng, crafted = msm_kernel.doubling_operands(table, slots, seed=SEED)
    acc = bs.infinity((2,), "cpu")
    for wi in (61, 60):
        p = bs.frobenius(acc, 4)
        q = bs.cneg(bs._table_pick(crafted, oh[wi]), ng[wi])
        acc = bs.add(p, q)
    need = F.to_u32(msm_kernel.doubling_lanes(p, q))
    assert [(int(need[s // 32]) >> (s % 32)) & 1 for s in range(64)] == [
        int(s in slots) for s in range(64)
    ]

    got = xsk233.to_affine_int(bs.unpack_points(bs.ladder(oh, ng, crafted)))
    entries = [xsk233.to_affine_int(bs.unpack_points(crafted[e])) for e in range(11)]
    oh_u, ng_u = F.to_u32(oh), F.to_u32(ng)
    for s in slots + [5, 38]:
        col, bit = divmod(s, 32)
        want = None
        for wi in range(61, -1, -1):
            if want is not None:
                want = tuple(gh.pow2k_int(c, 4) for c in want)
            e = [int(oh_u[wi, k, col]) >> bit & 1 for k in range(11)].index(1)
            pt = entries[e][s]
            if int(ng_u[wi, col]) >> bit & 1:
                pt = host.neg(pt)
            want = host.add(want, pt)
        assert got[s] == want, s
