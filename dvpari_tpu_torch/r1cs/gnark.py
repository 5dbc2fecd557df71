"""SP1/gnark sparse R1CS ingestion, SR1CS transform, sparse mat-vec.

Counterpart of dvpari_tpu/r1cs/gnark.py.  The byte formats are the JAX
package's; rows parse in the port's native library (native.py:
r1cs_parse_rows), and the numpy parser stays as its plain reference:

  R1CS dump (little-endian):
    u32 nbCoeffs; nbCoeffs x 32-byte big-endian field elements;
    u32 nbRows;  per row: u32 nL | u32 nR | u32 nO;
                 then (nL+nR+nO) x Term;  Term = (u32 wire_id, u32 coeff_id)
  Witness: u32 big-endian count; count x 32-byte big-endian elements.

Each of the three matrices is CSR (indptr / wire_ids / coeff_ids numpy
arrays); on the device the mat-vec is a gather of coeff x witness
products and an int64 index_add_ into rows.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from dvpari_tpu_torch import native
from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.ops import fr


@dataclass
class SparseMatrix:
    """CSR view of one of the L/R/O matrices."""

    indptr: np.ndarray  # int64[n_rows + 1]
    wire_ids: np.ndarray  # int32[nnz]
    coeff_ids: np.ndarray  # int32[nnz]


@dataclass
class R1CSInstance:
    """Parsed instance (reference: R1CSInstance, src/gnark_r1cs.rs:262-267).

    num_constraints is padded to a power of two
    (reference: src/gnark_r1cs.rs:291).
    """

    num_constraints: int
    num_public_inputs: int
    num_rows: int  # actual rows before padding
    l: SparseMatrix
    r: SparseMatrix
    o: SparseMatrix
    coeffs: np.ndarray  # Fr limbs int32[20, n_coeffs] (loose)
    has_vandermonde: bool = False


def load_sparse_r1cs(data: bytes) -> "tuple[list, list]":
    """Parse the dump; returns (coeff ints, rows as (l, r, o) term lists)."""
    off = 0
    (n_coeffs,) = struct.unpack_from("<I", data, off)
    off += 4
    coeffs = []
    for _ in range(n_coeffs):
        coeffs.append(int.from_bytes(data[off : off + 32], "big") % fr.P)
        off += 32
    (n_rows,) = struct.unpack_from("<I", data, off)
    off += 4
    rows = []
    for _ in range(n_rows):
        nl, nr, no = struct.unpack_from("<III", data, off)
        off += 12
        terms = np.frombuffer(data, dtype="<u4", count=2 * (nl + nr + no), offset=off)
        off += 8 * (nl + nr + no)
        terms = terms.reshape(-1, 2)
        rows.append((terms[:nl], terms[nl : nl + nr], terms[nl + nr :]))
    return coeffs, rows


def write_sparse_r1cs(coeffs: list, rows: list) -> bytes:
    """Inverse of load_sparse_r1cs (reference test-only writer,
    src/gnark_r1cs.rs:405-438)."""
    out = bytearray()
    out += struct.pack("<I", len(coeffs))
    for c in coeffs:
        out += int(c).to_bytes(32, "big")
    out += struct.pack("<I", len(rows))
    for l, r, o in rows:
        out += struct.pack("<III", len(l), len(r), len(o))
        for terms in (l, r, o):
            for wire, cid in np.asarray(terms, dtype=np.uint32).reshape(-1, 2):
                out += struct.pack("<II", int(wire), int(cid))
    return bytes(out)


def _be32_to_loose_limbs(raw: np.ndarray) -> np.ndarray:
    """(n, 32) big-endian records -> loose Fr limbs int32[20, n] (numpy
    bytes to wide limbs, reduced with torch on the CPU)."""
    if len(raw) == 0:
        return np.zeros((fr.NLIMB, 0), dtype=np.int32)
    wide = torch.from_numpy(fr.limbs_from_be_bytes(raw))
    return fr.weak_normalize(wide).numpy()


def load_witness_limbs(data: bytes) -> np.ndarray:
    """Vectorized witness loader: -> Fr limbs int32[20, count]
    (scale path; load_witness keeps the python-int contract for small
    inputs)."""
    (count,) = struct.unpack_from(">I", data, 0)
    raw = np.frombuffer(data, dtype=np.uint8, count=count * 32, offset=4)
    return _be32_to_loose_limbs(raw.reshape(count, 32))


def write_witness(values: list) -> bytes:
    out = bytearray(struct.pack(">I", len(values)))
    for v in values:
        out += int(v).to_bytes(32, "big")
    return bytes(out)


def _csr_from_counts(counts: np.ndarray, wires, cids, n_rows_padded: int) -> SparseMatrix:
    indptr = np.zeros(n_rows_padded + 1, dtype=np.int64)
    np.cumsum(counts.astype(np.int64), out=indptr[1 : len(counts) + 1])
    indptr[len(counts) + 1 :] = indptr[len(counts)]
    return SparseMatrix(
        indptr,
        np.asarray(wires, dtype=np.int32),
        np.asarray(cids, dtype=np.int32),
    )


def _parse_rows_numpy(data: bytes, rows_off: int):
    """Row parser: one cheap header read per row, one concatenate per
    matrix at the end."""
    (n_rows,) = struct.unpack_from("<I", data, rows_off)
    off = rows_off + 4
    counts = np.zeros((n_rows, 3), dtype=np.uint32)
    spans = []
    for i in range(n_rows):
        nl, nr, no = struct.unpack_from("<III", data, off)
        counts[i] = (nl, nr, no)
        off += 12
        spans.append(off)
        off += 8 * (nl + nr + no)
    all_terms = np.frombuffer(data, dtype="<u4")
    mats = []
    for k in range(3):
        w_parts, c_parts = [], []
        for i in range(n_rows):
            base = spans[i] // 4 + 2 * int(counts[i, :k].sum())
            t = all_terms[base : base + 2 * int(counts[i, k])]
            w_parts.append(t[0::2])
            c_parts.append(t[1::2])
        mats.append(
            (
                np.concatenate(w_parts) if w_parts else np.zeros(0, np.uint32),
                np.concatenate(c_parts) if c_parts else np.zeros(0, np.uint32),
            )
        )
    return counts, mats


def instance_from_dump(data: bytes, num_public_inputs: int) -> R1CSInstance:
    """(reference: R1CSInstance::from_dump, src/gnark_r1cs.rs:282-296)

    Coefficients convert to Fr limbs in bulk; rows parse in the native
    library."""
    (n_coeffs,) = struct.unpack_from("<I", data, 0)
    raw = np.frombuffer(data, dtype=np.uint8, count=32 * n_coeffs, offset=4)
    coeff_limbs = _be32_to_loose_limbs(raw.reshape(n_coeffs, 32))
    rows_off = 4 + 32 * n_coeffs

    counts, mats = native.r1cs_parse_rows(data, rows_off)
    n_rows = len(counts)
    m = 1 if n_rows == 0 else 1 << (n_rows - 1).bit_length()
    return R1CSInstance(
        num_constraints=m,
        num_public_inputs=num_public_inputs,
        num_rows=n_rows,
        l=_csr_from_counts(counts[:, 0], *mats[0], n_rows_padded=m),
        r=_csr_from_counts(counts[:, 1], *mats[1], n_rows_padded=m),
        o=_csr_from_counts(counts[:, 2], *mats[2], n_rows_padded=m),
        coeffs=coeff_limbs,
    )


def _neg_powers(dom: torch.Tensor, k: int) -> torch.Tensor:
    """-(d_i^j) for j = 1..k-1: int32[20, m, k-1] (i-major, j-minor when
    flattened)."""
    out = []
    power = dom
    for j in range(1, k):
        out.append(fr.neg(power))
        if j + 1 < k:
            power = fr.mul(power, dom)
    return torch.stack(out, dim=-1)


def add_vandermonde_matrix(inst: R1CSInstance, dom) -> None:
    """In-place C -> C' rewrite: C'w = Cw - Dx with D_ij = d_i^j.

    Mirrors the reference's coefficient bookkeeping
    (reference: update_to_include_vandermode_matrix_d,
    src/gnark_r1cs.rs:333-386): the -1 coefficient is reused if present,
    and each -d_i^j (j >= 1) is appended as a fresh coefficient
    (i-major, j-minor order, as there).  Powers on dom's device, CSR
    splice via numpy scatter.

    dom: domain elements as limbs int32[20, m] (tensor) or a list of ints.
    """
    assert not inst.has_vandermonde
    m, k = inst.num_constraints, inst.num_public_inputs
    if k == 0:  # no public inputs: D has zero columns, nothing to splice
        inst.has_vandermonde = True
        return
    if isinstance(dom, (list, tuple)):
        dom = torch.from_numpy(fr.from_int(dom))
    assert dom.shape[-1] == m

    minus_one = fr.from_int(fr.P - 1)  # canonical limbs (20,)
    canon = fr.strong_normalize(torch.from_numpy(inst.coeffs)).numpy()
    hits = np.nonzero((canon == minus_one[:, None]).all(axis=0))[0]
    coeffs = inst.coeffs
    if len(hits):
        coeff_one_idx = int(hits[0])
    else:
        coeffs = np.concatenate([coeffs, minus_one[:, None]], axis=1)
        coeff_one_idx = coeffs.shape[1] - 1
    base = coeffs.shape[1]

    new_cids = np.empty((m, k), dtype=np.int64)
    new_cids[:, 0] = coeff_one_idx
    if k > 1:
        negpow = _neg_powers(dom, k).cpu().numpy()
        coeffs = np.concatenate(
            [coeffs, negpow.reshape(fr.NLIMB, m * (k - 1))], axis=1
        )
        new_cids[:, 1:] = base + (
            np.arange(m)[:, None] * (k - 1) + np.arange(k - 1)[None, :]
        )
    new_wires = np.broadcast_to(np.arange(1, k + 1, dtype=np.int64), (m, k))

    # splice the k new terms per row into the O matrix CSR (vectorized)
    o = inst.o
    nnz_old = len(o.wire_ids)
    counts_old = np.diff(o.indptr).astype(np.int64)
    wire_ids = np.empty(nnz_old + m * k, dtype=np.int32)
    coeff_ids = np.empty_like(wire_ids)
    row_of_old = np.repeat(np.arange(m, dtype=np.int64), counts_old)
    dest_old = np.arange(nnz_old, dtype=np.int64) + row_of_old * k
    wire_ids[dest_old] = o.wire_ids
    coeff_ids[dest_old] = o.coeff_ids
    dest_new = (o.indptr[1:].astype(np.int64) + np.arange(m) * k)[:, None] + np.arange(k)[None, :]
    wire_ids[dest_new.ravel()] = new_wires.ravel()
    coeff_ids[dest_new.ravel()] = new_cids.ravel()
    indptr = np.concatenate([[0], np.cumsum(counts_old + k)]).astype(np.int64)
    inst.o = SparseMatrix(indptr, wire_ids, coeff_ids)
    inst.coeffs = coeffs
    inst.has_vandermonde = True


def coeffs_device(inst: R1CSInstance, device="cuda") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(inst.coeffs)).to(resolve(device))


def _wide_to_loose(sums: torch.Tensor) -> torch.Tensor:
    """int64 limb sums int64[20, n] (|sum| < 2^50) -> loose int32 limbs:
    each sum splits into three 12-bit digits and a signed top part at
    limb offsets 0..3 (width 23, every column small), then weak_normalize
    folds the top limbs back."""
    out = torch.zeros((fr.NLIMB + 3, *sums.shape[1:]), dtype=torch.int64, device=sums.device)
    for t in range(3):
        out[t : t + fr.NLIMB] += (sums >> (fr.LIMB_BITS * t)) & fr.MASK
    out[3:] += sums >> (3 * fr.LIMB_BITS)
    return fr.weak_normalize(out.to(torch.int32))


def sparse_accumulate(
    coeffs_dev: torch.Tensor,
    vec_dev: torch.Tensor,
    coeff_ids: np.ndarray,
    gather_ids: np.ndarray,
    seg_ids: np.ndarray,
    n_seg: int,
) -> torch.Tensor:
    """out[s] = sum over terms t with seg_ids[t]==s of
    coeffs[coeff_ids[t]] * vec[gather_ids[t]].

    The JAX package sums weak-normalised int32 limbs per segment in
    2^17-term chunks so that int32 stays exact (_seg_chunk_jit).  Here
    the products are gathered once and index_add_ sums their limbs into
    rows in int64, exact for any segment length below 2^37 terms; the
    result equals the JAX package's after strong_normalize."""
    dev = coeffs_dev.device
    if len(coeff_ids) == 0:
        return fr.zeros((n_seg,), dev)
    cid = torch.from_numpy(np.asarray(coeff_ids, dtype=np.int64)).to(dev)
    gid = torch.from_numpy(np.asarray(gather_ids, dtype=np.int64)).to(dev)
    seg = torch.from_numpy(np.asarray(seg_ids, dtype=np.int64)).to(dev)
    terms = fr.mul(coeffs_dev[:, cid], vec_dev[:, gid])  # (20, nnz)
    sums = torch.zeros((fr.NLIMB, n_seg), dtype=torch.int64, device=dev)
    sums.index_add_(1, seg, terms.to(torch.int64))
    return _wide_to_loose(sums)


def eval_matrix(mat: SparseMatrix, coeffs_dev: torch.Tensor, witness_dev: torch.Tensor) -> torch.Tensor:
    """Batched sparse mat-vec: out[i] = sum_terms coeff * w[wire]
    (reference: eval_row loop, src/proving.rs:382-396)."""
    n_rows = len(mat.indptr) - 1
    if len(mat.wire_ids) == 0:
        return fr.zeros((n_rows,), coeffs_dev.device)
    seg_ids = np.repeat(
        np.arange(n_rows, dtype=np.int64), np.diff(mat.indptr).astype(np.int64)
    )
    return sparse_accumulate(
        coeffs_dev, witness_dev, mat.coeff_ids, mat.wire_ids, seg_ids, n_rows
    )


def evaluate_monomial_basis_poly(public_inputs: list, alpha: int) -> int:
    """i(alpha) = sum_j x_j alpha^j (host ints)
    (reference: src/gnark_r1cs.rs:391-399)."""
    acc, power = 0, 1
    for x in public_inputs:
        acc = (acc + x * power) % fr.P
        power = power * alpha % fr.P
    return acc
