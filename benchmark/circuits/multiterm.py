"""SP1-shaped R1CS: multi-term rows over a shared coefficient table, and
its witnesses, written in the gnark sparse-R1CS dump the prover ingests.

A frozen copy of the port's r1cs/toy.py:synth_multiterm (same random
draws, same bytes), with the Fr modulus and the dump writer written out,
so that it imports nothing of the port.  The upstream deployment is the
SP1 stark-verifier R1CS (alpenlabs/dv-pari src/gnark_r1cs.rs:440-566):
rows of several terms drawn from a shared table.  Here each of the
m - 2 chain rows has `terms` L-, R- and O-terms (the O side defines one
new wire and feeds back terms - 1 earlier ones), wires uniform over the
already-defined prefix, coefficients from an `n_coeffs`-entry table
(entry 0 pinned to 1); two last rows bind the public outputs o = the
chain's end and w = its middle.  Wires: 0 = one, 1 = o, 2 = w, 3.. =
the chain, so n = m + 2 wires.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from benchmark.reference.fr import P


@dataclass
class Circuit:
    coeffs: list  # python ints, the shared table
    lw: np.ndarray  # (rows, terms) wire ids of the L terms
    lc: np.ndarray  # ... and their coefficient ids
    rw: np.ndarray
    rc: np.ndarray
    ow: np.ndarray  # O terms: column 0 is the row's new wire (coefficient 1)
    oc: np.ndarray
    dump: bytes  # the gnark sparse-R1CS dump of all m rows

    @property
    def n_chain(self) -> int:
        return self.lw.shape[0]

    @property
    def m(self) -> int:
        return self.n_chain + 2

    @property
    def bind(self) -> "tuple[int, int]":
        """The wires bound to the public outputs o and w."""
        return 3 + self.n_chain, 3 + self.n_chain // 2


def make(m: int, terms: int = 4, n_coeffs: int = 512, seed: int = 7) -> Circuit:
    """The m-row circuit of `seed` (m - 2 chain rows and the two binding
    rows)."""
    rng = np.random.default_rng(seed)
    k, n_chain = int(terms), m - 2
    assert k >= 1 and n_coeffs >= 2 and n_chain >= 1
    coeffs = [1] + [int.from_bytes(rng.bytes(29), "little") % P for _ in range(n_coeffs - 1)]
    avail = np.arange(n_chain, dtype=np.float64) + 2.0  # |{0} u [3, 3 + i]|

    def pick_wires():
        j = (rng.random((n_chain, k)) * avail[:, None]).astype(np.uint32)
        return np.where(j == 0, 0, j + 2).astype(np.uint32)

    lw, rw, ow_extra = pick_wires(), pick_wires(), pick_wires()
    lc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    rc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    oc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    new_wire = np.arange(n_chain, dtype=np.uint32) + 4
    ow = np.concatenate([new_wire[:, None], ow_extra[:, :-1]], axis=1)
    oc = np.concatenate([np.zeros((n_chain, 1), np.uint32), oc[:, :-1]], axis=1)

    # dump: u32 nbCoeffs, 32-byte big-endian coefficients, u32 nbRows,
    # per row u32 nL | nR | nO then (wire, coeff id) u32 pairs
    rec = np.zeros((n_chain, 3 + 6 * k), dtype="<u4")
    rec[:, 0:3] = k
    body = rec[:, 3:].reshape(n_chain, 3 * k, 2)
    body[:, 0:k, 0], body[:, 0:k, 1] = lw, lc
    body[:, k:2 * k, 0], body[:, k:2 * k, 1] = rw, rc
    body[:, 2 * k:, 0], body[:, 2 * k:, 1] = ow, oc
    out = bytearray(struct.pack("<I", len(coeffs)))
    for c in coeffs:
        out += int(c).to_bytes(32, "big")
    out += struct.pack("<I", n_chain + 2)
    out += rec.tobytes()
    circuit = Circuit(coeffs, lw, lc, rw, rc, ow, oc, b"")
    for src, dst in zip(circuit.bind, (1, 2)):
        out += struct.pack("<IIIIIIIII", 1, 1, 1, src, 0, 0, 0, dst, 0)
    circuit.dump = bytes(out)
    return circuit


def witness(c: Circuit, x: int) -> "list[int]":
    """All wire values (one, o, w, the chain) of the chain started at x:
    each row's new wire is L(w) R(w) minus its feedback O terms."""
    k = c.lw.shape[1]
    coeffs = c.coeffs
    vals = [0] * (3 + c.n_chain + 1)
    vals[0] = 1
    vals[3] = x % P
    lw, lc, rw, rc = (a.tolist() for a in (c.lw, c.lc, c.rw, c.rc))
    ow, oc = c.ow.tolist(), c.oc.tolist()
    for i in range(c.n_chain):
        lwi, lci, rwi, rci, owi, oci = lw[i], lc[i], rw[i], rc[i], ow[i], oc[i]
        left = sum(coeffs[lci[t]] * vals[lwi[t]] for t in range(k))
        right = sum(coeffs[rci[t]] * vals[rwi[t]] for t in range(k))
        extra = sum(coeffs[oci[t]] * vals[owi[t]] for t in range(1, k))
        vals[4 + i] = (left % P * (right % P) - extra) % P
    o, w = c.bind
    vals[1], vals[2] = vals[o], vals[w]
    return vals
