"""The port's native host backend (dvpari_tpu_torch/native.py, its own
copy of the C++ sources, built with g++ at first use) against the port's
python versions and the JAX package's smul_fast / decode_fast (its
native library where built): the verifier's scalar multiplication and
point decode, the bulk record decode, the vanishing-polynomial tree and
the R1CS row parse; and its build raising, never falling back, when the
compiler or libgmp fails.

Tolerance: zero -- points, bytes and canonical values must be equal.
"""

import random
import struct

import numpy as np
import pytest
import torch

from dvpari_tpu.utils import xsk233_host as jhost
from dvpari_tpu_torch import native
from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.r1cs import gnark, toy
from dvpari_tpu_torch.utils import kronecker
from dvpari_tpu_torch.utils import xsk233_host as host

G = (host.GX, host.GY)


def test_smul_and_decode_match_python_and_jax_native():
    rng = random.Random(4019)
    pts = [G, host.smul(rng.randrange(1, host.R), G)]
    for k, p in [(1, G), (2, G), (3, pts[1]), (rng.randrange(1, host.R), pts[1]),
                 (host.R - 1, pts[1])]:
        want = host.smul(k, p)
        assert host.smul_fast(k, p) == want == jhost.smul_fast(k, p)
    for p in pts:
        assert host.smul_fast(0, p) is None
        assert host.smul_fast(host.R, p) is None  # the order: infinity
    assert host.smul_fast(7, None) is None
    with pytest.raises(ValueError):
        host.smul_fast(1 << 240, G)

    bad_pad = bytearray(host.encode(G))
    bad_pad[29] |= 0xFC  # bits 234..239 set
    torsion = host.encode(host.add(pts[1], (0, 1)))  # on the curve, outside the subgroup
    records = [host.encode(p) for p in pts] + [
        bytes(30),  # infinity
        bytes(bad_pad),
        (1).to_bytes(30, "little"),  # x = 1: z^2 + z = x + x^-2 has no root
        torsion,
        (5).to_bytes(30, "little"),
    ]
    for rec in records:
        want = host.decode(rec)
        assert host.decode_fast(rec) == want == jhost.decode_fast(rec)
    assert [host.decode(r)[1] for r in records][:6] == [True] * 3 + [False] * 3

    good = [r for r in records if host.decode(r)[1]]
    xy, inf = native.pt_decode_bulk(b"".join(good))
    for i, rec in enumerate(good):
        p, _ = host.decode(rec)
        got = None if inf[i] else tuple(int.from_bytes(xy[i, 4 * c : 4 * c + 4].tobytes(), "little") for c in (0, 1))
        assert got == p
    for rec in (bytes(bad_pad), torsion):
        with pytest.raises(ValueError, match="1 invalid"):
            native.pt_decode_bulk(b"".join(good) + rec)


def test_native_vanishing_tree_matches_ctypes_tree(monkeypatch, tmp_path):
    """2^10 leaves, given as loose limbs: the native OpenMP tree against
    the ctypes Kronecker tree on the canonical values.  Then the build
    raises on a compile error and when libgmp cannot be found."""
    rng = np.random.default_rng(4020)
    leaves = rng.integers(-9000, 9001, size=(fr.NLIMB, 1 << 10)).astype(np.int32)
    dom = fr.to_int(leaves)
    assert len(set(dom)) == len(dom)
    got = kronecker.vanishing_coeffs_limbs(leaves)
    assert got.dtype == np.int32 and got.shape == (fr.NLIMB, (1 << 10) + 1)
    np.testing.assert_array_equal(fr.strong_normalize(torch.from_numpy(got)).numpy(), got)
    assert fr.to_int(got) == kronecker.vanishing_coeffs(dom, fr.P)

    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCES", [str(bad)])
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(kronecker, "_load_gmp", lambda: None)
    with pytest.raises(RuntimeError, match="libgmp not found"):
        native.build()


def test_native_row_parse_matches_numpy():
    dump, pub, priv = toy.synth_multiterm(200)
    (n_coeffs,) = struct.unpack_from("<I", dump, 0)
    rows_off = 4 + 32 * n_coeffs
    counts, mats = native.r1cs_parse_rows(dump, rows_off)
    want_counts, want_mats = gnark._parse_rows_numpy(dump, rows_off)
    np.testing.assert_array_equal(counts, want_counts)
    assert counts.dtype == want_counts.dtype and counts.shape == (202, 3)
    for (w, c), (ww, wc) in zip(mats, want_mats):
        np.testing.assert_array_equal(w, ww)
        np.testing.assert_array_equal(c, wc)
    assert sum(len(w) for w, _ in mats) == int(counts.sum())
    with pytest.raises(ValueError, match="malformed"):
        native.r1cs_parse_rows(dump[:-4], rows_off)
