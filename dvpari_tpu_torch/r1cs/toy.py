"""The 5-constraint toy circuit, byte-identical to the reference's dump,
and the synthetic scale circuits.

A copy of dvpari_tpu/r1cs/toy.py; synth_multiterm also takes the chain's
start value `x` (default 3, the JAX package's), so one circuit gets more
than one witness.

(reference: create_five_constraint_dump_on_a_file,
src/dvsnark_test.rs:34-128)

Wires: 0 = one, 1 = o, 2 = w, 3 = y, 4 = z, 5 = x, 6 = t, 7 = s
Constraints:
  x*x = y;  (y+z)*1 = w;  (2z)*1 = t;  (x+t)*1 = s;  (w+s)*1 = o
Public inputs: [o, w]; private witness: [y, z, x, t, s].
"""

from __future__ import annotations

from dvpari_tpu_torch.r1cs import gnark


def toy_r1cs_dump() -> bytes:
    coeffs = [1, 2]
    c1 = lambda w: (w, 0)
    c2 = lambda w: (w, 1)
    ONE, O, W, Y, Z, X, T, S = range(8)
    rows = [
        ([c1(X)], [c1(X)], [c1(Y)]),
        ([c1(Y), c1(Z)], [c1(ONE)], [c1(W)]),
        ([c2(Z)], [c1(ONE)], [c1(T)]),
        ([c1(X), c1(T)], [c1(ONE)], [c1(S)]),
        ([c1(W), c1(S)], [c1(ONE)], [c1(O)]),
    ]
    return gnark.write_sparse_r1cs(coeffs, rows)


def toy_witness():
    """Returns (public_inputs, private_inputs) satisfying the circuit
    (reference: src/dvsnark_test.rs:136-147)."""
    x = 3
    y = x * x
    z = 4
    w = y + z
    t = 2 * z
    s = x + t
    o = w + s
    return [o, w], [y, z, x, t, s]


def synth_multiterm(n_rows: int, terms: int = 4, n_coeffs: int = 512,
                    seed: int = 7, x: int = 3):
    """SP1-realistic synthetic circuit: multi-term rows over a shared
    coefficient table.

    The reference's production input (the SP1 stark-verifier R1CS,
    src/gnark_r1cs.rs:440-566) averages several terms per matrix row
    drawn from a shared coefficient table; the squaring chain
    (one term per row) never exercises eval_matrix's gather/segment-sum
    path or the Vandermonde splice at realistic sparsity.  Here every
    chain row carries `terms` L-terms, `terms` R-terms and `terms`
    O-terms (new wire + terms-1 feedback terms), wires drawn from the
    already-defined prefix and coefficients from a `n_coeffs`-entry
    table -- nnz per matrix = terms * m.

    Wire layout matches synth_squaring_chain (0=one, 1=pub o, 2=pub w,
    3.. = chain) so the scale scripts can swap generators.  Returns
    (dump_bytes, public_inputs, private_witness_ints).
    """
    import numpy as np

    from dvpari_tpu_torch.ops import fr

    rng = np.random.default_rng(seed)
    k = int(terms)
    assert k >= 1 and n_coeffs >= 2
    # coeff table: id 0 pinned to 1 (binding rows and new-wire terms)
    coeffs = [1] + [
        int.from_bytes(rng.bytes(29), "little") % fr.P
        for _ in range(n_coeffs - 1)
    ]
    first_chain = 3
    n_chain = n_rows

    # row i references wire 0 or chain wires 3..3+i (the defined prefix;
    # pub wires 1/2 are bound at the end, referencing them would make the
    # witness circular), and defines chain wire 4+i
    avail = np.arange(n_chain, dtype=np.float64) + 2.0  # |{0} u [3, 3+i]|

    def pick_wires():
        j = (rng.random((n_chain, k)) * avail[:, None]).astype(np.uint32)
        return np.where(j == 0, 0, j + 2).astype(np.uint32)

    lw, rw, ow_extra = pick_wires(), pick_wires(), pick_wires()
    lc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    rc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    oc = rng.integers(0, n_coeffs, (n_chain, k), dtype=np.uint32)
    new_wire = np.arange(n_chain, dtype=np.uint32) + first_chain + 1
    ow = np.concatenate([new_wire[:, None], ow_extra[:, :-1]], axis=1)
    oc = np.concatenate(
        [np.zeros((n_chain, 1), np.uint32), oc[:, :-1]], axis=1
    )

    # witness: w_new = L(w) * R(w) - sum(extra O terms)
    vals = [0] * (first_chain + n_chain + 1)
    vals[0] = 1
    vals[first_chain] = x % fr.P
    for i in range(n_chain):
        L = sum(coeffs[lc[i, t]] * vals[lw[i, t]] for t in range(k)) % fr.P
        R = sum(coeffs[rc[i, t]] * vals[rw[i, t]] for t in range(k)) % fr.P
        extra = sum(
            coeffs[oc[i, t]] * vals[ow[i, t]] for t in range(1, k)
        ) % fr.P
        vals[first_chain + 1 + i] = (L * R - extra) % fr.P

    # vectorized dump writer (the per-term python writer costs minutes at
    # 2^18+): uniform chain records as one uint32 little-endian block
    rec = np.zeros((n_chain, 3 + 6 * k), dtype="<u4")
    rec[:, 0:3] = k
    body = rec[:, 3:].reshape(n_chain, 3 * k, 2)
    body[:, 0:k, 0], body[:, 0:k, 1] = lw, lc
    body[:, k:2 * k, 0], body[:, k:2 * k, 1] = rw, rc
    body[:, 2 * k:, 0], body[:, 2 * k:, 1] = ow, oc

    import struct

    out = bytearray(struct.pack("<I", len(coeffs)))
    for c in coeffs:
        out += int(c).to_bytes(32, "big")
    out += struct.pack("<I", n_chain + 2)
    out += rec.tobytes()
    last = first_chain + n_chain
    mid = first_chain + n_chain // 2
    for src, dst in ((last, 1), (mid, 2)):  # o = chain end, w = chain mid
        out += struct.pack("<III", 1, 1, 1)
        out += struct.pack("<II", src, 0)
        out += struct.pack("<II", 0, 0)
        out += struct.pack("<II", dst, 0)
    pub = [vals[last], vals[mid]]
    return bytes(out), pub, vals[first_chain:]


def synth_squaring_chain(n_rows: int):
    """Synthetic m-constraint circuit for scale tests: wire i+1 = wire_i^2
    plus two public-output rows (pads to m = next_pow2(n_rows + 2)).

    Returns (dump_bytes, public_inputs, private_witness).  Shared by the
    scale scripts (scripts/scale_e2e_tpu.py) and the sharded-prove tests;
    the role of the reference's SP1-scale test circuit
    (src/dvsnark_test.rs:184-244) without the 800 MB download.
    """
    from dvpari_tpu_torch.ops import fr

    c1 = lambda w: (w, 0)
    rows = []
    first_chain = 3  # wires: 0=one, 1=pub o, 2=pub w, 3..=chain
    n_chain = n_rows
    for i in range(n_chain):
        a = first_chain + i
        rows.append(([c1(a)], [c1(a)], [c1(a + 1)]))
    last = first_chain + n_chain
    mid = first_chain + n_chain // 2
    rows.append(([c1(last)], [c1(0)], [c1(1)]))  # o = chain end
    rows.append(([c1(mid)], [c1(0)], [c1(2)]))  # w = chain middle
    x = 3
    chain = [x]
    for _ in range(n_chain):
        chain.append(chain[-1] * chain[-1] % fr.P)
    pub = [chain[-1], chain[n_chain // 2]]
    return gnark.write_sparse_r1cs([1], rows), pub, chain
