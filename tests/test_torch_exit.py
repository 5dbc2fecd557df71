"""The port's FFTree.exit (dvpari_tpu_torch/fftree/tree.py) inverts
enter, and equals the JAX package's exit on the same layers and on
coefficients made with numpy from a seed.

Tolerance: zero -- canonical limbs must be equal.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from dvpari_tpu.fftree.tree import FFTree as JFFTree
from dvpari_tpu.ops import fr as jfr
from dvpari_tpu_torch import convert
from dvpari_tpu_torch.ops import fr

SEED = 4018


def test_exit_inverts_enter_and_matches_jax(tmp_path):
    """exit(enter(c)) == c on 64 leaves at d = 0 and d = 1 (the last
    backward level of d = 0 multiplies through Karatsuba), batched at
    d = 1; and equal to the JAX tree's exit on the same numpy-made
    coefficients at d = 4, the 4-leaf view (the JAX exit compiles an XLA
    program per level, ~8 s each on this CPU), the port's tables handed
    to the JAX tree as table files."""
    jt = JFFTree.build(64, False, 7)
    tree = convert.fftree_from_numpy([np.asarray(l) for l in jt.layers], jt.x0s, False, 7, device="cpu")
    tree.table_dir = str(tmp_path)
    rng = np.random.default_rng(SEED)

    def loose(*shape):
        return rng.integers(-jfr.LOOSE_BOUND, jfr.LOOSE_BOUND + 1, size=(20, *shape)).astype(np.int32)

    for d, shape in ((0, (64,)), (1, (32,)), (1, (3, 32)), (4, (4,))):
        c = torch.from_numpy(loose(*shape))
        evals = tree.enter(c, d)
        got = fr.strong_normalize(tree.exit(evals, d))
        np.testing.assert_array_equal(got.numpy(), fr.strong_normalize(c).numpy())
    jt.table_dir = str(tmp_path)
    want = jax.jit(jfr.strong_normalize)(jt.exit(jnp.asarray(evals.numpy()), 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
