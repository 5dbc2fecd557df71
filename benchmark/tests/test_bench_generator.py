"""The frozen circuit generator against the port's synth_multiterm, and
the witness layout the harness hands the prover."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.circuits import multiterm


@pytest.mark.parametrize("log_m", [6, 8])
@pytest.mark.parametrize("x", [3, 5])
def test_dump_and_witness_equal_the_ports(log_m, x):
    from dvpari_tpu_torch.r1cs.toy import synth_multiterm

    m = 1 << log_m
    dump, pub, priv = synth_multiterm(m - 2, seed=7, x=x)
    c = multiterm.make(m, seed=7)
    vals = multiterm.witness(c, x)
    assert c.dump == dump
    assert vals[1:3] == pub and vals[3:] == priv
    assert c.m == m and len(vals) == m + 2


def test_limbs_are_the_ports():
    from dvpari_tpu_torch.ops import fr

    rng = np.random.default_rng(1)
    vals = [harness._field(rng) for _ in range(37)] + [0, 1, fr.P - 1]
    got = harness.limbs(vals)
    assert got.dtype == np.int32 and got.shape == (20, len(vals))
    assert np.array_equal(got, fr.from_int(vals))
