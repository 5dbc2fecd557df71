"""The PyTorch port's field, group and recode ops against the JAX package
on the same inputs, made with numpy from a seed.

Tolerance: exact everywhere -- bit-equal planes and masks, equal
canonical Fr limbs.  JAX runs on the CPU (tests/conftest.py); every JAX
reference is jitted once per test at <= 64 slots to keep compiles short.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dvpari_tpu.ops import fr as jfr
from dvpari_tpu.ops import gf2bs as JF
from dvpari_tpu.ops import tnaf_device as jtd
from dvpari_tpu.ops import xsk233_bs as jbs
from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import tnaf_device as td
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.utils import gf2_host as gh
from dvpari_tpu_torch.utils import xsk233_host as host

SEED = 1016


def t32(a) -> torch.Tensor:
    """numpy uint32 -> int32 tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy())


def u32(x) -> np.ndarray:
    return F.to_u32(x)


def rand_elems(rng, n):
    return [int.from_bytes(rng.bytes(30), "little") >> 7 for _ in range(n)]


def affine(planes, slot):
    """(3, 233, C) planes -> affine point of one slot (None = infinity)."""
    col = u32(planes)[..., slot // 32]
    return xsk233.to_affine_int(bs.extract_point(col, slot % 32))


@pytest.fixture(scope="module")
def points():
    """32 random curve points [e_i]G in word layout uint32[3, 8, 32]."""
    rng = np.random.default_rng(SEED)
    es = [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(32)]
    proj, _ = xsk233.mulgen_limbs(fr.from_int(es), device="cpu")
    return proj


INF_W = np.zeros((3, 8), np.uint32)
INF_W[1, 0] = 1  # (0 : 1 : 0)
ZERO_W = np.zeros((3, 8), np.uint32)  # (0 : 0 : 0), a padding slot


@pytest.fixture(scope="module")
def operands(points):
    """(P, Q) word-layout batches of 32 slots: generic pairs plus the
    degenerate cases (P + P, P + (-P), infinity on either or both sides,
    zero padding planes)."""
    P = points.copy()
    Q = np.roll(points, 5, axis=-1).copy()
    Q[..., 20] = P[..., 20]  # doubling
    Q[:, :, 21] = P[:, :, 21]
    Q[1, :, 21] ^= P[0, :, 21]  # -P = (X : X + Y : Z)
    P[..., 22] = INF_W
    Q[..., 23] = INF_W
    P[..., 24] = INF_W
    Q[..., 24] = INF_W
    P[..., 25] = ZERO_W
    Q[..., 26] = ZERO_W
    return bs.pack_points(P), bs.pack_points(Q)


# ---------------------------------------------------------------------------
# Fr
# ---------------------------------------------------------------------------

def test_strong_normalize_matches_jax():
    rng = np.random.default_rng(SEED)
    loose = rng.integers(-jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, 64)).astype(np.int32)
    loose[:, 0] = 0
    loose[:, 1] = jfr.P_LIMBS  # p itself -> 0
    loose[:, 2] = jfr.from_int(jfr.P - 1)
    loose[:, 3] = -jfr.LOOSE_BOUND
    want = np.asarray(jax.jit(jfr.strong_normalize)(jnp.asarray(loose)))
    got = fr.strong_normalize(torch.from_numpy(loose)).numpy()
    np.testing.assert_array_equal(got, want)
    assert fr.to_int(got) == jfr.to_int(loose)


def test_weak_normalize_matches_jax():
    """A 39-limb product-width input folds to 20 loose limbs, bit-equal."""
    rng = np.random.default_rng(SEED + 6)
    wide = rng.integers(-(2**22), 2**22 + 1, size=(39, 32)).astype(np.int32)
    want = np.asarray(jax.jit(jfr.weak_normalize)(jnp.asarray(wide)))
    got = fr.weak_normalize(torch.from_numpy(wide)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == fr.NLIMB and np.abs(got).max() <= jfr.LOOSE_BOUND
    assert fr.to_int(got) == jfr.to_int(want)


def test_from_int_matches_jax():
    rng = np.random.default_rng(SEED)
    vals = [0, 1, jfr.P - 1, jfr.P, jfr.P + 5, 2**240 - 1]
    vals += [int.from_bytes(rng.bytes(30), "little") for _ in range(26)]
    np.testing.assert_array_equal(fr.from_int(vals), jfr.from_int(vals))
    assert fr.to_int(fr.from_int(vals)) == [v % jfr.P for v in vals]


# ---------------------------------------------------------------------------
# GF(2^233) bit planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["mul", "square", "is_zero_mask"])
def test_field_op_matches_jax(op):
    rng = np.random.default_rng(SEED)
    a_int = rand_elems(rng, 64)
    b_int = rand_elems(rng, 64)
    a_int[3] = a_int[40] = 0
    a_int[31] = (1 << 232) | 1  # bit 31 of column 0 set in two planes
    a, b = JF.from_int(a_int), JF.from_int(b_int)
    if op == "mul":
        want = JF.mul(jnp.asarray(a), jnp.asarray(b))
        got = F.mul(t32(a), t32(b))
        ref = [gh.mul_int(x, y) for x, y in zip(a_int, b_int)]
    elif op == "square":
        want = JF.square(jnp.asarray(a))
        got = F.square(t32(a))
        ref = [gh.square_int(x) for x in a_int]
    else:
        want = JF.is_zero_mask(jnp.asarray(a))
        got = F.is_zero_mask(t32(a))
        ref = None
        zero_bits = sum(1 << j for j, v in enumerate(a_int[:32]) if v == 0)
        assert int(u32(got)[0]) == zero_bits
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    if ref is not None:
        assert F.to_int(got) == ref


def test_select_and_shr_on_sign_bit():
    """int32 planes: `~` and select need nothing special, a right shift
    must be logical (bit 31 is the sign bit)."""
    words = np.array([0x80000001, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000], np.uint32)
    for sh in (16, 8, 4, 2, 1):
        np.testing.assert_array_equal(u32(F.shr(t32(words), sh)), words >> np.uint32(sh))
    mask = t32(np.array([0xF000000F], np.uint32))
    a = t32(np.full((233, 1), 0xAAAAAAAA, np.uint32))
    b = t32(np.full((233, 1), 0x55555555, np.uint32))
    want = JF.select(jnp.asarray(u32(mask)), jnp.asarray(u32(a)), jnp.asarray(u32(b)))
    np.testing.assert_array_equal(u32(F.select(mask, a, b)), np.asarray(want))


def test_pack_words_matches_jax():
    rng = np.random.default_rng(SEED)
    words = rng.integers(0, 2**32, size=(8, 64), dtype=np.uint32)
    words[7] &= np.uint32((1 << 9) - 1)  # 233 bits
    planes = F.pack_words(words)
    np.testing.assert_array_equal(planes, JF.pack_words(words))
    np.testing.assert_array_equal(F.unpack_words(planes), words)
    pts = rng.integers(0, 2**32, size=(3, 8, 40), dtype=np.uint32)
    pts[:, 7] &= np.uint32((1 << 9) - 1)
    np.testing.assert_array_equal(bs.pack_points(pts), jbs.pack_points(pts))
    np.testing.assert_array_equal(bs.unpack_points(bs.pack_points(pts))[..., :40], pts)
    idx = rng.integers(0, 11, size=(62, 64)).astype(np.int32)
    sgn = np.where(rng.integers(0, 2, size=(62, 64)) == 1, 1, -1).astype(np.int32)
    for mine, theirs in zip(bs.digit_masks(idx, sgn), jbs.digit_masks(idx, sgn)):
        np.testing.assert_array_equal(mine, theirs)


# ---------------------------------------------------------------------------
# Group law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "double", "frobenius"])
def test_group_op_matches_jax(op, operands):
    P, Q = operands
    if op == "add":
        want = jax.jit(jbs.add)(jnp.asarray(P), jnp.asarray(Q))
        got = bs.add(t32(P), t32(Q))
    elif op == "double":
        want = jax.jit(jbs.double)(jnp.asarray(P))
        got = bs.double(t32(P))
    else:
        want = jax.jit(jbs.frobenius)(jnp.asarray(P))
        got = bs.frobenius(t32(P))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    if op == "add":  # and the affine results against the host oracle
        for j in range(32):
            assert affine(got, j) == host.add(affine(P, j), affine(Q, j)), f"slot {j}"


def test_tnaf_table_matches_jax(operands):
    P, _ = operands
    want = jax.jit(jbs.tnaf_table)(jnp.asarray(P))
    got = bs.tnaf_table(t32(P))
    assert tuple(got.shape) == (11, 3, 233, 1)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_fold_cols_matches_jax(operands):
    P, Q = operands
    flat = np.concatenate([P, Q], axis=-1)  # (3, 233, 2): words with bit 31 set
    want = jbs.fold_cols(jnp.asarray(flat))
    got = bs.fold_cols(t32(flat))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Recode
# ---------------------------------------------------------------------------

def test_recode_masks_matches_jax():
    rng = np.random.default_rng(SEED)
    ks = [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(64)]
    ks[0], ks[1], ks[2], ks[31], ks[63] = 0, 1, host.R - 1, 2**231 - 1, 7
    canon = jfr.from_int(ks)
    want = jtd.recode_masks_jit(jnp.asarray(canon))
    got = td.recode_masks(torch.from_numpy(canon))
    for mine, theirs in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(u32(mine), np.asarray(theirs))
    assert bool(got[2]) and bool(want[2])
    # bit 31 (element 31 of each column) is set in exactly one digit mask
    oh = u32(got[0])
    assert ((oh >> np.uint32(31)) & 1).sum(axis=1).tolist() == [[1, 1]] * 62


def test_pack_le32_sets_sign_bit():
    bits = torch.zeros((3, 32), dtype=torch.int32)
    bits[0, 31] = 1
    bits[1] = 1
    bits[2, ::2] = 1
    np.testing.assert_array_equal(
        u32(td._pack_le32(bits)), np.array([0x80000000, 0xFFFFFFFF, 0x55555555], np.uint32)
    )

