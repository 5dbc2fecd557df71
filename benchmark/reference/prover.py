"""The DV-Pari proof of a witness, computed by the designated verifier
from the trapdoor alone: plain python ints, no MSM, no FFT.

With the trapdoor (tau, delta, eps) every SRS point is a known multiple
of G, so each MSM of the prover collapses to a scalar:

  commit_p = [eps (a(tau) + delta b(tau) + delta^2 r(tau))] G,
  alpha    = the Fiat-Shamir challenge of commit_p and the public inputs,
  a0, b0   = a(alpha), b(alpha),
  kzg_k    = [((a(tau) - a0) + delta (b(tau) - b0) + delta^2 (r(tau) - r0))
              / (tau - alpha)] G,

where a, b interpolate A w and B w over D (degree < m), i(X) =
sum_j x_j X^j over the public inputs x, r = a b - i and r0 = a0 b0 -
i(alpha).  This follows from the SRS (g_m, g_q, g_k) and the prover's
stages (matvec, quotient q = (a b - i - C'w) / Z_D, k-scalars over D,
D' and their union): every sum the prover forms is an interpolant of
degree below its domain's size, evaluated at tau
(upstream: alpenlabs/dv-pari src/srs.rs, src/proving.rs).

Transcript (upstream src/proving.rs:72-198): srs and circuit hashes are
BLAKE3 of the empty string; the commitment hash is BLAKE3 of the 30-byte
commit_p, the public-input hash BLAKE3 of 29-byte little-endian
scalars; alpha = BLAKE3(BLAKE3(srs || circuit) || BLAKE3(commit ||
pub)) with its top 4 bytes zeroed, little-endian.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference import blake3, fr, koblitz
from benchmark.reference.domain import Domain

P = fr.P


@dataclass(frozen=True)
class Expected:
    commit_p: bytes
    kzg_k: bytes
    a0: int
    b0: int


def matvec(circuit, vals: "list[int]") -> "tuple[list[int], list[int]]":
    """(A w, B w) over the m rows: the chain rows' L and R sums, then the
    binding rows (L = the bound wire, R = the one wire)."""
    coeffs = np.array(circuit.coeffs, dtype=object)
    w = np.array(vals, dtype=object)
    a = ((coeffs[circuit.lc] * w[circuit.lw]).sum(axis=1) % P).tolist()
    b = ((coeffs[circuit.rc] * w[circuit.rw]).sum(axis=1) % P).tolist()
    for wire in circuit.bind:
        a.append(vals[wire])
        b.append(1)
    return [int(v) for v in a], [int(v) for v in b]


def public_poly(pub: "list[int]", z: int) -> int:
    return sum(x * pow(z, j, P) for j, x in enumerate(pub)) % P


def challenge(commit_p: bytes, pub: "list[int]") -> int:
    h = blake3.digest
    compiletime = h(h(b"") + h(b""))
    runtime = h(h(commit_p) + h(b"".join((x % P).to_bytes(29, "little") for x in pub)))
    root = bytearray(h(compiletime + runtime))
    root[28:] = bytes(4)
    return int.from_bytes(bytes(root), "little")


def expected_proof(domain: Domain, circuit, vals: "list[int]", trapdoor,
                   bind_challenge: bool = True) -> Expected:
    """The proof of the witness `vals` (all wires).  bind_challenge=False
    is the control: alpha drawn from the public inputs alone, before the
    commitment, which breaks the soundness that Fiat-Shamir gives."""
    tau, delta, eps = (v % P for v in trapdoor)
    pub = vals[1:3]
    a, b = matvec(circuit, vals)
    a_t, b_t = domain.interpolate_at(tau, [a, b])
    r_t = (a_t * b_t - public_poly(pub, tau)) % P
    d2 = delta * delta % P
    commit = koblitz.encode(koblitz.mul_g(eps * (a_t + delta * b_t + d2 * r_t) % P))
    alpha = challenge(commit if bind_challenge else bytes(30), pub)
    a0, b0 = domain.interpolate_at(alpha, [a, b])
    r0 = (a0 * b0 - public_poly(pub, alpha)) % P
    s_k = ((a_t - a0) + delta * (b_t - b0) + d2 * (r_t - r0)) * fr.inv(tau - alpha) % P
    return Expected(commit, koblitz.encode(koblitz.mul_g(s_k)), a0, b0)
