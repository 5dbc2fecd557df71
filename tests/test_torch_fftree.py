"""The port's FFTree (dvpari_tpu_torch/fftree) against the golden pins of
tests/golden_n16.py (no JAX run), against the JAX package's FFTree on
the same layers and random inputs made with numpy from a seed (extend,
enter, and the device build against the JAX host chain), and its
Kronecker vanishing polynomial against the python-int product tree.
(`exit` is held to the JAX tree's in tests/test_torch_exit.py, to keep
each file under a minute on the CPU.)

Tolerance: zero -- values are compared as canonical ints (or canonical
limbs) and must be equal.
"""

import os
import sys

import numpy as np
import torch
import jax
import jax.numpy as jnp

from dvpari_tpu.fftree.tree import FFTree as JFFTree
from dvpari_tpu.ops import fr as jfr
from dvpari_tpu_torch import convert
from dvpari_tpu_torch.fftree import precompute as pre
from dvpari_tpu_torch.fftree import tree as tree_mod
from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.utils import timing

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden_n16 as G  # noqa: E402

SEED = 4017


def ints(hexes):
    return [int(h, 16) for h in hexes]


def test_toy_tree_matches_golden_pins():
    """The N = 16 instance: tree2n of 32 leaves built on the host."""
    tree = FFTree.build(32, False, 5, device="cpu")
    dom, dom2 = tree.both_domains()
    assert fr.to_int(dom) == ints(G.DOMAIN_D)
    assert fr.to_int(dom2) == ints(G.DOMAIN_DP)
    z = pre.compute_vanishing_polynomial(tree)
    assert fr.to_int(z) == ints(G.Z_POLY)
    bar = pre.compute_barycentric_weights(tree, z)
    assert fr.to_int(bar) == ints(G.BAR_WTS)
    tau = torch.from_numpy(fr.from_int(int(G.TAU, 16)))
    assert fr.to_int(pre.compute_lagrange_basis_at_tau(tree, z, tau, bar)) == ints(G.L_TAU)
    assert set(fr.to_int(pre.evaluate_vanishing_poly_at_domain(z, tree, 1))) == {0}
    out = tree.extend(torch.from_numpy(fr.from_int(G.EXTEND_IN)), "S1", 0)
    assert fr.to_int(out) == ints(G.EXTEND_OUT)
    out = tree.enter(torch.from_numpy(fr.from_int(G.ENTER_IN)), 0)
    assert fr.to_int(out) == ints(G.ENTER_OUT)


def test_extend_enter_match_jax(tmp_path):
    """2^6 leaves: the JAX tree's layers carried into the port
    (convert.fftree_from_numpy).  The port's extend tables are held to
    their defining formulas in python ints, then written in the JAX
    package's table format and read by the JAX tree (deriving them in
    JAX compiles one XLA program per level, ~12 s each on this CPU).
    Extend on both moieties and enter are held to the JAX transforms on
    the same loose random inputs, enter over all 64 leaves also to
    Horner in python ints."""
    jt = JFFTree.build(64, True, 7)
    tree = convert.fftree_from_numpy([np.asarray(l) for l in jt.layers], jt.x0s, True, 7, device="cpu")
    built = FFTree.build(64, True, 7, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(tree.layers, built.layers))
    assert tree.x0s == built.x0s
    tree.table_dir = str(tmp_path)
    P = fr.P
    for d, moiety in ((0, "S1"), (1, "S0")):
        dec, rec = tree._extend_consts(d, moiety)
        m, off = 64 >> (d + 1), (0 if moiety == "S1" else 1 << d)
        for k, (dk, rk) in enumerate(zip(dec, rec)):
            half = (m >> k) >> 1
            lk = fr.to_int(tree.layers[k])
            s = lk[off :: 1 << (d + 1)]
            t = lk[(1 << d) - off :: 1 << (d + 1)]
            x0 = tree.x0s[k]
            d_i = [fr.to_int(v) for v in dk]
            r_i = [fr.to_int(v) for v in rk]
            for i in range(half):
                s0, s1, t0, t1 = s[i], s[half + i], t[i], t[half + i]
                v0, v1 = pow(s0 - x0, half - 1, P), pow(s1 - x0, half - 1, P)
                inv_det = pow(v0 * v1 * (s1 - s0), -1, P)
                assert [d_i[c][i] for c in range(4)] == [
                    s1 * v1 * inv_det % P, -s0 * v0 * inv_det % P, -v1 * inv_det % P, v0 * inv_det % P,
                ]
                w0, w1 = pow(t0 - x0, half - 1, P), pow(t1 - x0, half - 1, P)
                assert [r_i[c][i] for c in range(4)] == [w0, t0 * w0 % P, w1, t1 * w1 % P]
    rng = np.random.default_rng(SEED)

    def loose(*shape):
        return rng.integers(-jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, *shape)).astype(np.int32)

    c64 = loose(64)
    got_enter = tree.enter(torch.from_numpy(c64), 0)
    coeffs, leaves = fr.to_int(c64), fr.to_int(tree.leaves(0))
    for v, x in zip(fr.to_int(got_enter), leaves):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % P
        assert v == acc
    c8 = loose(8)
    tree.enter(torch.from_numpy(c8), 3)  # writes the d = 3..5 tables for JAX

    jt.table_dir = str(tmp_path)
    canon_j = jax.jit(jfr.strong_normalize)
    for moiety, d, x in (("S1", 0, loose(32)), ("S0", 1, loose(16))):
        want = canon_j(jt.extend(jnp.asarray(x), moiety, d))
        got = fr.strong_normalize(tree.extend(torch.from_numpy(x), moiety, d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = canon_j(jt.enter(jnp.asarray(c8), 3))
    np.testing.assert_array_equal(fr.strong_normalize(tree.enter(torch.from_numpy(c8), 3)).numpy(), np.asarray(want))
    xb = loose(3, 32)
    got = tree.extend(torch.from_numpy(xb), "S1", 0)
    for j in range(3):
        one = tree.extend(torch.from_numpy(np.ascontiguousarray(xb[:, j])), "S1", 0)
        assert fr.to_int(got[:, j]) == fr.to_int(one)


def test_kronecker_z_poly_matches_product_tree():
    """2^13 leaves (above HOST_ZC_MAX): the GMP Kronecker tree against
    the python-int product tree on the same leaves."""
    tree = FFTree.build(1 << 14, False, 14, device="cpu")
    assert (tree.n >> 1) > tree_mod.HOST_ZC_MAX
    got = fr.to_int(tree.z_coeffs(1))
    leaves = fr.to_int(tree.leaves(1))
    assert got == tree_mod._host_vanishing_coeffs(leaves)
    assert len(got) == (1 << 13) + 1 and got[-1] == 1


def test_device_build_matches_jax_host_chain(monkeypatch):
    """32 leaves: the port's device build, run on the CPU, against the
    JAX package's host chain layer for layer, in one chunk and in chunks
    of 8 lanes; DVPARI_DEVICE_TREE_MIN picks the path."""
    jt = JFFTree.build(32, False, 4, device=False)
    want = [np.asarray(l) for l in jt.layers]
    for chunk in (None, "8"):
        if chunk:
            monkeypatch.setenv("DVPARI_LAYER0_CHUNK", chunk)
        tree = FFTree.build(32, False, 4, device="cpu", device_build=True)
        assert len(tree.layers) == len(want) == 6 and tree.x0s == jt.x0s
        for got, w in zip(tree.layers, want):
            np.testing.assert_array_equal(got, fr.strong_normalize(torch.from_numpy(w)).numpy())
    timing.reset()
    FFTree.build(32, False, 4, device="cpu")
    monkeypatch.setenv("DVPARI_DEVICE_TREE_MIN", "32")
    FFTree.build(32, False, 4, device="cpu")
    assert [e["phase"] for e in timing.EVENTS] == ["tree.host_build", "tree.device_build"]

