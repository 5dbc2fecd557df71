"""The port's R1CS layer (dvpari_tpu_torch/r1cs) against the JAX
package's on synth_multiterm(64): the parsed instance, the Vandermonde
splice, eval_matrix and sparse_accumulate, and the witness loader; plus
one 300,000-term segment against python ints (the port sums limbs in
int64 where the JAX package chunks int32 sums).

Tolerance: zero -- canonical values must be equal.
"""

import random

import numpy as np
import torch
import jax.numpy as jnp

from dvpari_tpu.ops import fr as jfr
from dvpari_tpu.r1cs import gnark as jgnark
from dvpari_tpu.r1cs import toy as jtoy
from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.r1cs import gnark, toy


def test_eval_matrix_and_sparse_accumulate_match_jax():
    dump, pub, priv = toy.synth_multiterm(64)
    assert (dump, pub, priv) == jtoy.synth_multiterm(64)
    inst = gnark.instance_from_dump(dump, 2)
    jinst = jgnark.instance_from_dump(dump, 2)
    assert inst.num_constraints == jinst.num_constraints == 128
    for name in "lro":
        a, b = getattr(inst, name), getattr(jinst, name)
        for f in ("indptr", "wire_ids", "coeff_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert fr.to_int(inst.coeffs) == jfr.to_int(jinst.coeffs)

    wit = gnark.write_witness([1] + pub + priv)
    w = gnark.load_witness_limbs(wit)
    assert fr.to_int(w) == jfr.to_int(jgnark.load_witness_limbs(wit)) == [1] + pub + priv

    rng = random.Random(4018)
    dom = [rng.randrange(fr.P) for _ in range(inst.num_constraints)]
    gnark.add_vandermonde_matrix(inst, torch.from_numpy(fr.from_int(dom)))
    jgnark.add_vandermonde_matrix(jinst, dom)
    np.testing.assert_array_equal(inst.o.indptr, jinst.o.indptr)
    np.testing.assert_array_equal(inst.o.wire_ids, jinst.o.wire_ids)
    np.testing.assert_array_equal(inst.o.coeff_ids, jinst.o.coeff_ids)
    assert fr.to_int(inst.coeffs) == jfr.to_int(jinst.coeffs)

    cd = gnark.coeffs_device(inst, "cpu")
    jcd = jgnark.coeffs_device(jinst)
    wt = torch.from_numpy(w)
    for name in "lro":
        got = gnark.eval_matrix(getattr(inst, name), cd, wt)
        want = jgnark.eval_matrix(getattr(jinst, name), jcd, jnp.asarray(w))
        assert fr.to_int(got) == jfr.to_int(want)
    # the SR1CS relation holds after the splice: a*b = c + i over dom
    a, b, c = (fr.to_int(gnark.eval_matrix(getattr(inst, n), cd, wt)) for n in "lro")
    for i, d in enumerate(dom):
        assert a[i] * b[i] % fr.P == (c[i] + gnark.evaluate_monomial_basis_poly(pub, d)) % fr.P

    # sparse_accumulate by wire, as setup's accumulate_m_values runs it
    lt = np.random.default_rng(4018).integers(
        -jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, inst.num_constraints)
    ).astype(np.int32)
    rows = np.repeat(np.arange(inst.num_constraints), np.diff(inst.r.indptr))
    n_wires = len(priv) + 3
    got = gnark.sparse_accumulate(cd, torch.from_numpy(lt), inst.r.coeff_ids, rows, inst.r.wire_ids, n_wires)
    want = jgnark.sparse_accumulate(jcd, jnp.asarray(lt), jinst.r.coeff_ids, rows, jinst.r.wire_ids, n_wires)
    assert fr.to_int(got) == jfr.to_int(want)
    assert np.abs(got.numpy()).max() <= jfr.LOOSE_BOUND


def test_sparse_accumulate_long_segment_exact():
    rng = np.random.default_rng(11)
    pyrng = random.Random(11)
    n_terms, n_c, n_v = 300_000, 8, 4
    coeff_ints = [pyrng.randrange(fr.P) for _ in range(n_c)]
    vec_ints = [pyrng.randrange(fr.P) for _ in range(n_v)]
    cids = rng.integers(0, n_c, n_terms).astype(np.int32)
    gids = rng.integers(0, n_v, n_terms).astype(np.int32)
    segs = np.zeros(n_terms, dtype=np.int64)
    segs[-50:] = 1
    out = gnark.sparse_accumulate(
        torch.from_numpy(fr.from_int(coeff_ints)), torch.from_numpy(fr.from_int(vec_ints)),
        cids, gids, segs, 2,
    )
    got = fr.to_int(out)
    for s in range(2):
        counts = np.bincount(cids[segs == s] * n_v + gids[segs == s], minlength=n_c * n_v)
        expect = sum(
            int(counts[i * n_v + j]) * coeff_ints[i] * vec_ints[j]
            for i in range(n_c) for j in range(n_v)
        ) % fr.P
        assert got[s] == expect
