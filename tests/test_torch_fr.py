"""The port's Fr arithmetic (dvpari_tpu_torch/ops/fr.py) against the JAX
package's on the same limbs, made with numpy from a seed, loose
(unnormalised) inputs included.

Tolerance: zero -- the canonical limbs (strong_normalize) must be equal.
The loose limbs may differ, as the two packages only promise equal
values mod P.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dvpari_tpu.ops import fr as jfr
from dvpari_tpu_torch.ops import fr

SEED = 4016
N = 48


def loose(rng, n):
    """Loose limbs |limb| <= LOOSE_BOUND (the inputs every op accepts)."""
    return rng.integers(-jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, n)).astype(np.int32)


def canon_jax(x) -> np.ndarray:
    return np.asarray(jax.jit(jfr.strong_normalize)(jnp.asarray(x)))


def canon(x: torch.Tensor) -> np.ndarray:
    return fr.strong_normalize(x).numpy()


@pytest.mark.parametrize("op", ["mul_square", "inverse", "poly_eval", "byte_codecs"])
def test_fr_op_matches_jax(op):
    rng = np.random.default_rng(SEED)
    a, b = loose(rng, N), loose(rng, N)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if op == "mul_square":
        want = jax.jit(lambda x, y: (jfr.mul(x, y), jfr.square(x), jfr.sub(jfr.add(x, y), jfr.neg(y)),
                                     jfr.mul_const(x, jfr.P - 7)))(jnp.asarray(a), jnp.asarray(b))
        got = (fr.mul(ta, tb), fr.square(ta), fr.sub(fr.add(ta, tb), fr.neg(tb)), fr.mul_const(ta, fr.P - 7))
        for g, w in zip(got, want):
            assert np.abs(g.numpy()).max() <= jfr.LOOSE_BOUND
            np.testing.assert_array_equal(canon(g), canon_jax(w))
    elif op == "inverse":
        a[:, 3] = 0  # zero maps to zero
        a[:, 7] = jfr.P_LIMBS  # p itself is zero too
        want_b = jax.jit(lambda x: jfr.batch_inverse(x, axis=0))(jnp.asarray(a))
        want_i = jax.jit(jfr.inv)(jnp.asarray(a[:, :4]))
        got_b = fr.batch_inverse(torch.from_numpy(a), axis=0)
        np.testing.assert_array_equal(canon(got_b), canon_jax(want_b))
        np.testing.assert_array_equal(canon(fr.inv(torch.from_numpy(a[:, :4]))), canon_jax(want_i))
        vals = fr.to_int(a)
        assert fr.to_int(got_b) == [pow(v, -1, fr.P) if v else 0 for v in vals]
        assert fr.is_zero(got_b).tolist() == [v == 0 for v in vals]
        # a batched axis: inversion along axis 1 of (20, 2, 24)
        got3 = fr.batch_inverse(torch.from_numpy(np.ascontiguousarray(a.reshape(20, 2, N // 2))), axis=1)
        assert fr.to_int(got3.reshape(20, N)) == fr.to_int(got_b)
    elif op == "poly_eval":
        x = loose(rng, 1)[:, 0]
        coeffs = loose(rng, 96)  # > 64: the powers + sum form
        jp = jax.jit(jfr.poly_eval)
        jh = jax.jit(jfr.horner_eval)
        tx = torch.from_numpy(x)
        np.testing.assert_array_equal(
            canon(fr.poly_eval(torch.from_numpy(coeffs), tx)), canon_jax(jp(coeffs, x))
        )
        np.testing.assert_array_equal(
            canon(fr.horner_eval(torch.from_numpy(coeffs[:, :9]), tx)), canon_jax(jh(coeffs[:, :9], x))
        )
        np.testing.assert_array_equal(
            canon(fr.powers(tx, 20)), canon_jax(jax.jit(jfr.powers, static_argnums=1)(x, 20))
        )
        np.testing.assert_array_equal(
            canon(fr.sum_along(ta, 0)), canon_jax(jax.jit(jfr.sum_along, static_argnums=1)(a, 0))
        )
        assert fr.eq(ta, ta + 0).all() and not fr.eq(ta, fr.add(ta, torch.from_numpy(fr.ones((1,)).numpy()))).any()
    else:
        raw = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
        np.testing.assert_array_equal(fr.limbs_from_be_bytes(raw), jfr.limbs_from_be_bytes(raw))
        c = canon(ta)
        np.testing.assert_array_equal(fr.limbs_to_le_bytes(c, 29), jfr.limbs_to_le_bytes(c, 29))
        recs = fr.limbs_to_le_bytes(c, 29)
        assert [int.from_bytes(bytes(r), "little") for r in recs] == fr.to_int(a)
