"""The port's proof of an m = 64 synth_multiterm circuit equals the JAX
package's, bit for bit, from the same trapdoor and witness; and the
port proves to the same bits over the cache the JAX setup wrote.

At m = 64 the prove joins the three g_k segments column by column
(ops/xsk233.py:concat_planes) and every MSM spans several columns, the
branches the toy pin (one column each, slot repack) does not take.

Slow tier (DVPARI_SLOW_TESTS=1): the JAX setup and prove compile their
XLA:CPU programs for minutes.  Tolerance: zero -- the 944 proof bits
must be equal.
"""

import os
import shutil

import pytest

from dvpari_tpu_torch.protocol import prover, srs
from dvpari_tpu_torch.r1cs.toy import synth_multiterm
from dvpari_tpu_torch.storage import artifacts as art

pytestmark = pytest.mark.slow

LOG_M = 6
SEED = b"dvpari-m64"


def _cache(path, dump):
    os.makedirs(path)
    with open(os.path.join(path, art.R1CS_CONSTRAINTS_FILE), "wb") as f:
        f.write(dump)
    return str(path)


def test_m64_proof_equals_jax(tmp_path, no_persistent_compile_cache):
    from dvpari_tpu.protocol import prover as jprover
    from dvpari_tpu.protocol import srs as jsrs

    dump, pub, priv = synth_multiterm((1 << LOG_M) - 2)
    jcache = _cache(tmp_path / "jax", dump)
    jtd = jsrs.Trapdoor.from_seed(SEED)
    jsrs.verifier_runs_setup(jtd, jcache, len(pub), True, True)
    jprover.prover_prepares_precomputes(jcache, True)
    want = jprover.prove(jcache, pub, priv).to_bits()

    pcache = _cache(tmp_path / "port", dump)
    td = srs.Trapdoor.from_seed(SEED)
    srs.verifier_runs_setup(td, pcache, len(pub), True, True, device="cpu")
    prover.prover_prepares_precomputes(pcache, True, device="cpu")
    proof = prover.prove(pcache, pub, priv, device="cpu")
    assert proof.to_bits() == want
    assert srs.verify(td, pub, proof)

    # the port's prove over the JAX-written SRS, trees and precomputes
    shutil.copytree(jcache, tmp_path / "from_jax")
    got = prover.prove(str(tmp_path / "from_jax"), pub, priv, device="cpu")
    assert got.to_bits() == want
