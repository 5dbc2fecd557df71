"""The PyTorch port stands alone (no jax, nothing of dvpari_tpu, and its
native library is its own build, not the JAX package's; its own
copies of the JAX package's pure-python recoder and host oracles equal
the originals), refuses to fall back to the CPU, rejects malformed input
at its entry points and pads ragged input, and carries the JAX package's
state bit for bit (G's window table, JAX planes and limbs)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dvpari_tpu.ops import fr as jfr
from dvpari_tpu.ops import tnaf as jtnaf
from dvpari_tpu.ops import tnaf_device as jtd
from dvpari_tpu.ops import xsk233 as jxsk
from dvpari_tpu.ops import xsk233_bs as jbs
from dvpari_tpu.utils import gf2_host as jgh
from dvpari_tpu.utils import xsk233_host as jhost
from dvpari_tpu_torch import convert
from dvpari_tpu_torch.ops import fr, msm_kernel, tnaf, xsk233
from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.utils import gf2_host as gh
from dvpari_tpu_torch.utils import xsk233_host as host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "dvpari_tpu_torch",
    "dvpari_tpu_torch.__main__",
    "dvpari_tpu_torch.convert",
    "dvpari_tpu_torch.device",
    "dvpari_tpu_torch.fftree",
    "dvpari_tpu_torch.fftree.aux_curve",
    "dvpari_tpu_torch.fftree.device_build",
    "dvpari_tpu_torch.fftree.precompute",
    "dvpari_tpu_torch.fftree.tree",
    "dvpari_tpu_torch.native",
    "dvpari_tpu_torch.ops",
    "dvpari_tpu_torch.ops.fr",
    "dvpari_tpu_torch.ops.gf2bs",
    "dvpari_tpu_torch.ops.msm_kernel",
    "dvpari_tpu_torch.ops.tnaf",
    "dvpari_tpu_torch.ops.tnaf_device",
    "dvpari_tpu_torch.ops.xsk233",
    "dvpari_tpu_torch.ops.xsk233_bs",
    "dvpari_tpu_torch.parallel",
    "dvpari_tpu_torch.parallel.dryrun",
    "dvpari_tpu_torch.parallel.mesh",
    "dvpari_tpu_torch.parallel.multihost",
    "dvpari_tpu_torch.parallel.sharded",
    "dvpari_tpu_torch.protocol",
    "dvpari_tpu_torch.protocol.proof",
    "dvpari_tpu_torch.protocol.prover",
    "dvpari_tpu_torch.protocol.srs",
    "dvpari_tpu_torch.protocol.transcript",
    "dvpari_tpu_torch.r1cs",
    "dvpari_tpu_torch.r1cs.gnark",
    "dvpari_tpu_torch.r1cs.toy",
    "dvpari_tpu_torch.storage",
    "dvpari_tpu_torch.storage.artifacts",
    "dvpari_tpu_torch.utils",
    "dvpari_tpu_torch.utils.blake3",
    "dvpari_tpu_torch.utils.gf2_host",
    "dvpari_tpu_torch.utils.kronecker",
    "dvpari_tpu_torch.utils.roofline",
    "dvpari_tpu_torch.utils.timing",
    "dvpari_tpu_torch.utils.xsk233_host",
]


def test_port_imports_no_jax():
    found = sorted(
        os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for d, _, files in os.walk(os.path.join(REPO, "dvpari_tpu_torch"))
        for f in files
        if f.endswith(".py")
    )
    assert found == sorted(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'dvpari_tpu' or k.startswith('dvpari_tpu.')]\n"
        "assert not bad, bad\n"
        "from dvpari_tpu_torch import native\n"
        "native.load()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'dvpari_tpu_torch/build/libdvpari_native_' in maps\n"
        "assert 'dvpari_tpu/native' not in maps\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def _limbs():
    return fr.from_int([3, 5, 7])


@pytest.mark.parametrize(
    "call",
    [
        lambda: xsk233.mulgen_limbs(_limbs()),
        lambda: xsk233.msm_limbs(_limbs(), torch.zeros((3, 233, 1), dtype=torch.int32)),
        lambda: xsk233.gen_table_planes(),
        lambda: convert.planes_from_numpy(np.zeros((3, 233, 1), np.uint32)),
        lambda: convert.limbs_from_numpy(_limbs()),
    ],
    ids=["mulgen_limbs", "msm_limbs", "gen_table_planes", "planes_from_numpy", "limbs_from_numpy"],
)
def test_default_device_is_cuda_and_never_falls_back(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_wrappers_take_cpu_or_cuda_only():
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    run through the plain path."""
    meta = torch.empty((3, 233, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        msm_kernel.point_add(meta, meta)
    oh = torch.empty((62, 11, 2), dtype=torch.int32, device="meta")
    ng = torch.empty((62, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        msm_kernel.msm_packed(oh, ng, meta)
    with pytest.raises(ValueError, match="meta"):
        msm_kernel.mulgen_packed(oh, ng, meta)


_PLANES_1 = torch.zeros((3, 233, 1), dtype=torch.int32)


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda: xsk233.recode(np.zeros((19, 4), np.int32), "cpu"), ValueError),
        (lambda: xsk233.recode(np.zeros((20, 0), np.int32), "cpu"), ValueError),
        (lambda: xsk233.msm_limbs(_limbs(), _PLANES_1.numpy(), "cpu"), TypeError),
        (lambda: xsk233.msm_limbs(_limbs(), _PLANES_1.long(), "cpu"), TypeError),
        (lambda: xsk233.msm_limbs(_limbs(), _PLANES_1.repeat(1, 1, 2), "cpu"), ValueError),
        (lambda: convert.limbs_from_numpy(_limbs().astype(np.int64), "cpu"), TypeError),
        (lambda: convert.planes_to_numpy(_PLANES_1.long()), TypeError),
    ],
    ids=["recode_19_limbs", "recode_no_scalars", "msm_numpy_planes", "msm_int64_planes",
         "msm_planes_too_wide", "limbs_int64", "planes_to_numpy_int64"],
)
def test_entry_points_reject_malformed_input(call, error):
    with pytest.raises(error):
        call()


def test_recode_pads_and_matches_jax():
    """xsk233.recode, the entry points' first stage: loose limbs of 40
    scalars are canonicalised, padded to 64 slots with zero scalars (the
    infinity digit) and recoded, bit-equal to the JAX steps."""
    rng = np.random.default_rng(8)
    loose = rng.integers(-jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, 40)).astype(np.int32)
    oh, ng, C = xsk233.recode(loose, device="cpu")
    assert C == 2
    canon = np.asarray(jax.jit(jfr.strong_normalize)(jnp.asarray(loose)))
    canon = np.concatenate([canon, np.zeros((20, 24), np.int32)], axis=1)
    want = jtd.recode_masks_jit(jnp.asarray(canon))
    np.testing.assert_array_equal(F.to_u32(oh), np.asarray(want[0]))
    np.testing.assert_array_equal(F.to_u32(ng), np.asarray(want[1]))
    pad_bits = np.uint32(0xFFFFFF00)  # slots 40..63 = bits 8..31 of column 1
    assert np.all(F.to_u32(oh)[:, 0, 1] & pad_bits == pad_bits)


def test_gen_table_matches_jax():
    """G's window table, built once by the port's own tnaf_table on G
    packed into all 32 slots, equals the JAX package's (word-sliced)
    one; later calls reuse it."""
    got = xsk233.gen_table_planes(device="cpu")
    np.testing.assert_array_equal(F.to_u32(got), jxsk._gen_table_planes())
    again = xsk233.gen_table_planes(device="cpu")
    assert torch.equal(again, got) and xsk233._gen_table_cpu.cache_info().misses == 1


def test_convert_round_trip():
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 2**32, size=(3, 233, 4), dtype=np.uint32)
    planes[0, 0, 0] = 0x80000000  # the int32 sign bit
    t = convert.planes_from_numpy(planes, device="cpu")
    assert t.dtype == torch.int32 and int(t[0, 0, 0]) == -(2**31)
    back = convert.planes_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, planes)
    limbs = rng.integers(-10000, 10001, size=(20, 9)).astype(np.int32)
    lt = convert.limbs_from_numpy(limbs, device="cpu")
    np.testing.assert_array_equal(convert.limbs_to_numpy(lt), limbs)
    assert fr.to_int(lt) == jfr.to_int(limbs)


def test_convert_reads_jax_planes():
    """Planes packed by the JAX package (the .planes.npz sidecar's
    format) unpack to the same points in the port."""
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, size=(3, 8, 64), dtype=np.uint32)
    words[:, 7] &= np.uint32((1 << 9) - 1)
    t = convert.planes_from_numpy(jbs.pack_points(words), device="cpu")
    np.testing.assert_array_equal(bs.unpack_points(t), words)
    with pytest.raises(TypeError):
        convert.planes_from_numpy(words.astype(np.int64), device="cpu")


# ---------------------------------------------------------------------------
# Copied python recoder and host oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["tnaf_constants", "python_recoder", "gf2_host", "xsk233_host"])
def test_host_copy_matches_jax(part):
    rng = np.random.default_rng(2)
    if part == "tnaf_constants":
        assert tnaf.DELTA == jtnaf.DELTA and tnaf.N_DELTA == jtnaf.N_DELTA
        assert tnaf._zt_conj(tnaf.DELTA) == jtnaf._zt_conj(jtnaf.DELTA)
        mine = (tnaf.MU, tnaf.M, tnaf.TNAF_LEN, tnaf.N_WINDOWS, tnaf.TABLE_SIZE)
        assert mine == (jtnaf.MU, jtnaf.M, jtnaf.TNAF_LEN, jtnaf.N_WINDOWS, jtnaf.TABLE_SIZE)
    elif part == "python_recoder":
        ks = [int.from_bytes(rng.bytes(29), "little") % host.R for _ in range(12)]
        ks += [0, 1, host.R - 1, 2**200]
        for k in ks[:4]:
            c, d = tnaf.partmod(k)
            assert (c, d) == jtnaf.partmod(k)
            np.testing.assert_array_equal(
                tnaf.tnaf_digits(c, d, tnaf.TNAF_LEN), jtnaf.tnaf_digits(c, d, jtnaf.TNAF_LEN)
            )
        for ds in [(0, 0, 0, 0), (1, 0, 0, 0), (0, -1, 0, 0), (1, 0, -1, 0), (-1, 0, 0, 1)]:
            assert tnaf._window_code(*ds) == jtnaf._window_code(*ds)
        for mine, theirs in zip(tnaf.recode_scalars(ks), jtnaf.recode_scalars(ks)):
            np.testing.assert_array_equal(mine, theirs)
    elif part == "gf2_host":
        xs = [int.from_bytes(rng.bytes(30), "little") >> 7 for _ in range(8)]
        for a, b in zip(xs, xs[1:] + [1]):
            assert gh.clmul_int(a, b) == jgh.clmul_int(a, b)
            assert gh.mul_int(a, b) == jgh.mul_int(a, b)
            assert gh.square_int(a) == jgh.square_int(a)
            assert gh.pow2k_int(a, 5) == jgh.pow2k_int(a, 5)
            assert gh.inv_int(a) == jgh.inv_int(a)
            assert gh.mul_int(a, gh.inv_int(a)) == 1
            assert gh.halftrace_int(a) == jgh.halftrace_int(a)
            assert gh.trace_fast_int(a) == gh.trace_int(a) == jgh.trace_int(a)
        assert gh.TRACE_MASK == gh.derive_trace_mask() == jgh.TRACE_MASK
    else:
        assert (host.R, host.GX, host.GY) == (jhost.R, jhost.GX, jhost.GY)
        G = (host.GX, host.GY)
        P = host.smul(12345, G)
        assert P == jhost.smul(12345, G)
        Q = host.add(P, G)
        assert Q == jhost.add(P, G)
        assert host.neg(Q) == jhost.neg(Q)
        assert host.add(Q, host.neg(Q)) is None
        assert host.smul(host.R, G) is None
        for pt in (None, G, P, Q):
            assert host.encode(pt) == jhost.encode(pt)
            assert host.decode(host.encode(pt)) == jhost.decode(jhost.encode(pt)) == (pt, True)
            assert host.in_subgroup(pt) and host.is_on_curve(pt)
        # an order-2 point, a curve point outside the subgroup, x = 0 with y-bit set
        for bad in ((0, 1), host.add(P, (0, 1))):
            assert host.is_on_curve(bad) == jhost.is_on_curve(bad)
            assert host.in_subgroup(bad) == jhost.in_subgroup(bad) is False
        for rec in (bytes(29) + b"\x02", (1 << 235).to_bytes(30, "little"), host.encode(Q)[:-1] + b"\x7f"):
            assert host.decode(rec) == jhost.decode(rec)
            assert host.decode(rec)[1] is False
