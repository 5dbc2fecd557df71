"""The port's proof of an m = 64 synth_multiterm circuit equals the JAX
package's, bit for bit, from the same trapdoor and witness; and the
port proves to the same bits over the cache the JAX setup wrote, on one
device and over two and four ranks (parallel/, gloo on the CPU).

At m = 64 the prove joins the three g_k segments column by column
(ops/xsk233.py:concat_planes) and every MSM spans several columns, the
branches the toy pin (one column each, slot repack) does not take; over
ranks, each MSM's columns split between ranks whose runs are not empty.
The JAX-written cache has no planes sidecars, so the ranks rebuild them
at once.

Slow tier (DVPARI_SLOW_TESTS=1): the JAX setup and prove compile their
XLA:CPU programs for minutes.  Tolerance: zero -- the 944 proof bits
must be equal.
"""

import os
import shutil

import pytest

from dvpari_tpu_torch.parallel import dryrun, mesh, multihost
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

    # over ranks, in the port's cache and in a fresh copy of the JAX one
    shutil.copytree(jcache, tmp_path / "from_jax_ranks")
    assert not any(f.endswith(".planes.npz") for f in os.listdir(tmp_path / "from_jax_ranks"))
    for R in (2, 4):  # every rank has g_k columns (4m points, 8 columns)
        assert all(c1 > c0 for c0, c1 in (mesh.col_run(8, R, r) for r in range(R)))
        for cache in (pcache, str(tmp_path / "from_jax_ranks")):
            ranks = multihost.run_ranks(R, dryrun.rank_prove, (cache, pub, priv), device="cpu")
            assert [r["proof"] for r in ranks] == [dryrun.proof_hex(proof)] * R, (R, cache)
