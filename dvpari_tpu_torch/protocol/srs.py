"""Setup (SRS generation) and O(1) designated-verifier verification.

Counterpart of dvpari_tpu/protocol/srs.py:

  Setup (verifier-side, holds trapdoor tau/delta/epsilon):
    g_m[j]    = eps * m_j(tau, delta) * G      (one per wire)
    g_q[i]    = eps * Z_D(tau) delta^2 L'_i(tau) * G
    g_k[0][i] = L_i(tau) * G
    g_k[1][i] = L_i(tau) delta * G
    g_k[2][i] = L^U_i(tau) delta^2 * G         (unified 2m domain)

  Verify: alpha from transcript; i0 = i(alpha); r0 = a0 b0 - i0;
    u0 = (a0 + delta b0 + delta^2 r0) eps; v0 = (tau - alpha) eps;
    accept iff v0*K + u0*G == P and all decodings valid.

The five fan-outs run through the port's fixed-base ladder
(ops/xsk233.py:mulgen_limbs); verify runs on the host, its point decodes
and scalar multiplications in the native library (native.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.fftree import precompute as pre
from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.protocol.proof import Proof
from dvpari_tpu_torch.protocol.transcript import Transcript
from dvpari_tpu_torch.r1cs import gnark
from dvpari_tpu_torch.storage import artifacts as art
from dvpari_tpu_torch.utils import xsk233_host as host
from dvpari_tpu_torch.utils.blake3 import blake3_digest
from dvpari_tpu_torch.utils.timing import phase


@dataclass(frozen=True)
class Trapdoor:
    tau: int
    delta: int
    epsilon: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "Trapdoor":
        """Deterministic trapdoor derivation (blake3 of seed || counter,
        232 bits, first three non-zero values below P)."""
        vals = []
        ctr = 0
        while len(vals) < 3:
            v = int.from_bytes(
                blake3_digest(seed + ctr.to_bytes(4, "little")), "little"
            ) >> 24  # 232 bits
            ctr += 1
            if 0 < v < fr.P:
                vals.append(v)
        return cls(*vals)


def _fan_out(path: str, scalars: torch.Tensor) -> None:
    """[s_i]G for limb scalars (20, n) through the fixed-base ladder,
    written as the point vector at `path` (records + planes sidecar)."""
    _, planes = xsk233.mulgen_limbs(scalars, scalars.device)
    art.write_point_vec(path, planes, scalars.shape[-1])


def accumulate_m_values(inst: gnark.R1CSInstance, l_tau: torch.Tensor, delta: int) -> torch.Tensor:
    """m_j = sum_i L_i(tau) (A_ij + delta B_ij + delta^2 C_ij) per wire j:
    gather + int64 index_add_ by wire (gnark.sparse_accumulate)."""
    n_wires = 1 + max(
        int(inst.l.wire_ids.max(initial=0)),
        int(inst.r.wire_ids.max(initial=0)),
        int(inst.o.wire_ids.max(initial=0)),
    )
    dev = l_tau.device
    coeffs_dev = gnark.coeffs_device(inst, dev)
    d = int(delta) % fr.P
    total = fr.zeros((n_wires,), dev)
    for mat, sc in zip((inst.l, inst.r, inst.o), (1, d, d * d % fr.P)):
        if len(mat.wire_ids) == 0:
            continue
        rows = np.repeat(
            np.arange(len(mat.indptr) - 1, dtype=np.int64),
            np.diff(mat.indptr).astype(np.int64),
        )
        lt = fr.mul_const(l_tau, sc)
        part = gnark.sparse_accumulate(coeffs_dev, lt, mat.coeff_ids, rows, mat.wire_ids, n_wires)
        total = fr.add(total, part)
    return total


def load_or_build_tree(cache_dir, name, domain_len, shift, base_log_n, device) -> FFTree:
    path = os.path.join(cache_dir, name)
    if art.fftree_exists(path):
        return art.read_fftree(path, device)
    tree = FFTree.build(domain_len, shift, base_log_n, device)
    art.write_fftree(path, tree)
    return tree


def all_zero(v: torch.Tensor) -> bool:
    return bool(fr.is_zero(v).all())


def verifier_runs_setup(
    trapdoor: Trapdoor,
    cache_dir: str,
    num_public_inputs: int,
    is_fresh_setup: bool = True,
    validate_precompute: bool = True,
    device="cuda",
):
    """Full setup pipeline; writes the SRS point vectors into the cache
    and returns their paths.

    is_fresh_setup=False expects the domain precomputes (trees,
    vanishing polys, barycentric weights) to be in cache_dir already and
    fails fast if any is missing."""
    dev = resolve(device)
    os.makedirs(cache_dir, exist_ok=True)
    assert trapdoor.tau % fr.P and trapdoor.delta % fr.P and trapdoor.epsilon % fr.P
    if not is_fresh_setup:
        missing = [
            name
            for name in (art.Z_POLY, art.Z_POLYD, art.BAR_WTS, art.BAR_WTSD)
            if not os.path.exists(os.path.join(cache_dir, name))
        ] + [
            name
            for name in (art.TREE_2N, art.TREE_2ND)
            if not art.fftree_exists(os.path.join(cache_dir, name))
        ]
        assert not missing, f"is_fresh_setup=False but precomputes missing from cache: {missing}"

    with open(os.path.join(cache_dir, art.R1CS_CONSTRAINTS_FILE), "rb") as f:
        inst = gnark.instance_from_dump(f.read(), num_public_inputs)
    m = inst.num_constraints
    n_log = m.bit_length() - 1
    tau_dev = torch.as_tensor(fr.from_int(trapdoor.tau), device=dev)

    def domain_precomputes(tree_name, zf, bf, shift):
        with phase("setup.tree", dev, tree=tree_name):
            tree2 = load_or_build_tree(cache_dir, tree_name, 2 * m, shift, n_log + 1, dev)
        zpath = os.path.join(cache_dir, zf)
        with phase("setup.vanishing", dev, artifact=zf):
            if os.path.exists(zpath):
                z = art.read_fr_vec(zpath, dev)
            else:
                z = pre.compute_vanishing_polynomial(tree2)
                art.write_fr_vec(zpath, z)
        if validate_precompute:
            with phase("setup.validate_z", dev, tree=tree_name):
                evs = pre.evaluate_vanishing_poly_at_domain(z, tree2, 1)
                assert all_zero(evs), "vanishing poly invalid"
        bpath = os.path.join(cache_dir, bf)
        with phase("setup.barycentric", dev, artifact=bf):
            if os.path.exists(bpath):
                bw = art.read_fr_vec(bpath, dev)
            else:
                bw = pre.compute_barycentric_weights(tree2, z, 1)
                art.write_fr_vec(bpath, bw)
        with phase("setup.lagrange", dev, tree=tree_name):
            ltau = pre.compute_lagrange_basis_at_tau(tree2, z, tau_dev, bw, 1)
        return tree2, z, ltau

    tree2n, z_poly, l_tau = domain_precomputes(art.TREE_2N, art.Z_POLY, art.BAR_WTS, False)
    tree2nd, z_polyd, l_taud = domain_precomputes(art.TREE_2ND, art.Z_POLYD, art.BAR_WTSD, True)

    def z_inv(fname, z_coeffs, tree):
        path = os.path.join(cache_dir, fname)
        if os.path.exists(path):
            return art.read_fr_vec(path, dev)
        vals = fr.batch_inverse(pre.evaluate_vanishing_poly_at_domain(z_coeffs, tree, 1), axis=0)
        art.write_fr_vec(path, vals)
        return vals

    with phase("setup.z_inv", dev):
        z_vals2_inv = z_inv(art.Z_VALS2_INV, z_poly, tree2nd)  # 1/Z_D on D'
        z_vals2d_inv = z_inv(art.Z_VALS2D_INV, z_polyd, tree2n)  # 1/Z_D' on D

    with phase("setup.vandermonde", dev):
        gnark.add_vandermonde_matrix(inst, tree2n.leaves(1))

    with phase("setup.lagrange_unified", dev):
        l_taul = pre.lagrange_basis_unified(
            tau_dev, m, l_tau, l_taud, z_poly, z_polyd, z_vals2_inv, z_vals2d_inv
        )
    del tree2n, tree2nd, z_polyd, z_vals2_inv, z_vals2d_inv

    eps = trapdoor.epsilon % fr.P
    delta = trapdoor.delta % fr.P
    delta2 = delta * delta % fr.P

    with phase("setup.g_m", dev):
        m_vals = accumulate_m_values(inst, l_tau, delta)
        _fan_out(os.path.join(cache_dir, art.SRS_G_M), fr.mul_const(m_vals, eps))

    with phase("setup.g_q", dev):
        z_tau = fr.to_int(fr.poly_eval(z_poly, tau_dev))
        scale = z_tau * delta2 % fr.P * eps % fr.P
        _fan_out(os.path.join(cache_dir, art.SRS_G_Q), fr.mul_const(l_taud, scale))

    with phase("setup.g_k", dev):
        names = [art.SRS_G_K_0, art.SRS_G_K_1, art.SRS_G_K_2]
        for vec, sc, name in zip((l_tau, l_tau, l_taul), (1, delta, delta2), names):
            _fan_out(os.path.join(cache_dir, name), fr.mul_const(vec, sc))

    return {
        "g_m": os.path.join(cache_dir, art.SRS_G_M),
        "g_q": os.path.join(cache_dir, art.SRS_G_Q),
        "g_k": [os.path.join(cache_dir, n) for n in names],
    }


def verify(trapdoor: Trapdoor, public_inputs: "list[int]", proof: Proof) -> bool:
    """O(1) verification on the host: two point decodes, the transcript,
    two scalar multiplications (the decodes and multiplications in the
    native library)."""
    commit_p, p_valid = host.decode_fast(proof.commit_p)
    kzg_k, k_valid = host.decode_fast(proof.kzg_k)

    t = Transcript()
    t.srs_hash()
    t.circuit_info_hash()
    t.public_input_hash(public_inputs)
    t.witness_commitment_hash([proof.commit_p])
    alpha = t.output()

    i0 = gnark.evaluate_monomial_basis_poly(public_inputs, alpha)
    r0 = (proof.a0 * proof.b0 - i0) % fr.P
    delta = trapdoor.delta % fr.P
    u0 = (
        (proof.a0 + delta * proof.b0 + delta * delta % fr.P * r0)
        % fr.P
        * trapdoor.epsilon
        % fr.P
    )
    v0 = (trapdoor.tau - alpha) % fr.P * trapdoor.epsilon % fr.P

    lhs = host.add(host.smul_fast(v0, kzg_k), host.smul_fast(u0, (host.GX, host.GY)))
    valid_inputs = p_valid and k_valid and proof.a0_valid and proof.b0_valid
    return bool(lhs == commit_p) and valid_inputs
