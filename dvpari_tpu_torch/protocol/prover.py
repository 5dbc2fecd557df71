"""Prover: precompute preparation and proof generation.

Counterpart of dvpari_tpu/protocol/prover.py, the same stages on torch
tensors of one device:

  sparse mat-vec (gather + index_add_)  ->  MSM(w, g_m)
  extend a,b,c,i to D' (ECFFT)          ->  quotient q = (ab - i - c)/Z
  MSM(q, g_q), commit_p = both          ->  Fiat-Shamir alpha
  barycentric a0,b0,i0 at alpha         ->  k-scalar vectors
  MSM([k_a||k_b||k_r], g_k)             ->  Proof (944 bits)

The MSMs run through ops/xsk233.py:msm_limbs (the ladder kernel on
CUDA) over the SRS planes, uploaded once per process; the commitment's
one point add runs on the host.

With a process group (prove(..., group=)), one prove runs over R ranks,
as the JAX prover does over a mesh: the three MSMs shard their 32-point
columns (parallel/sharded.py:msm_limbs_sharded, each rank reading only
its columns of the SRS), and where the domain splits into R runs of R
column blocks (sharded.can_shard_domain) the extend, quotient,
barycentric sums and k-scalars run on each rank's run of the domain
(the JAX package's domain-sharded layout).  The proof is byte-equal to
the one-device proof on every rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.fftree import precompute as pre
from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.parallel import mesh, multihost, sharded
from dvpari_tpu_torch.protocol.proof import Proof
from dvpari_tpu_torch.protocol.srs import all_zero, load_or_build_tree
from dvpari_tpu_torch.protocol.transcript import Transcript
from dvpari_tpu_torch.r1cs import gnark
from dvpari_tpu_torch.storage import artifacts as art
from dvpari_tpu_torch.utils import xsk233_host as host
from dvpari_tpu_torch.utils.timing import phase


def _tree2n(cache_dir: str, m: int, device) -> FFTree:
    return load_or_build_tree(cache_dir, art.TREE_2N, 2 * m, False, m.bit_length(), device)


def prover_prepares_precomputes(cache_dir: str, validate_precompute: bool = True, device="cuda"):
    """Ensure tree2n / bar_wts / z_vals2inv exist; z_poly is a required
    input."""
    dev = resolve(device)
    os.makedirs(cache_dir, exist_ok=True)
    z_poly = art.read_fr_vec(os.path.join(cache_dir, art.Z_POLY), dev)
    m = z_poly.shape[-1] - 1
    tree2n = _tree2n(cache_dir, m, dev)

    bpath = os.path.join(cache_dir, art.BAR_WTS)
    if not os.path.exists(bpath):
        art.write_fr_vec(bpath, pre.compute_barycentric_weights(tree2n, z_poly, 1))
    zpath = os.path.join(cache_dir, art.Z_VALS2_INV)
    if not os.path.exists(zpath):
        # Z_D over D' (odd moiety of tree2n): full-leaf eval, odd half
        full = _eval_z_all_leaves(tree2n, z_poly)
        art.write_fr_vec(zpath, fr.batch_inverse(full[:, 1::2], axis=0))
    if validate_precompute:
        evs = pre.evaluate_vanishing_poly_at_domain(z_poly, tree2n, 1)
        assert all_zero(evs), "vanishing poly invalid over D"


def _eval_z_all_leaves(tree2n, z_poly: torch.Tensor) -> torch.Tensor:
    """The (m+1)-coeff Z over all 2m leaves: enter on the zero-padded
    tail + one Horner step."""
    leaves = tree2n.leaves(0)
    padded = fr.zeros((leaves.shape[-1],), leaves.device)
    padded[:, : z_poly.shape[-1] - 1] = z_poly[:, 1:]
    return pre.horner_step(tree2n.enter(padded, 0), leaves, z_poly[:, 0])


def _monomial_evals_over_domain(public_inputs, dom: torch.Tensor) -> torch.Tensor:
    """i(d) = sum_j x_j d^j over the domain."""
    m = dom.shape[-1]
    acc = fr.zeros((m,), dom.device)
    power = fr.ones((m,), dom.device)
    for j, x in enumerate(public_inputs):
        acc = fr.add(acc, fr.mul_const(power, int(x)))
        if j + 1 < len(public_inputs):
            power = fr.mul(power, dom)
    return acc


def _k_scalars(dom2, a_vals, b_vals, i_vals, r2, a0, b0, i0, alpha_dev, diff_inv):
    m = dom2.shape[-1]
    r0 = fr.sub(fr.mul(a0, b0), i0)

    def bc(v):
        return fr.broadcast_scalar(v, (m,))

    # 1/(d_i - alpha) = -1/(alpha - d_i): reuse the barycentric stage's
    # batch inversion over D instead of re-inverting
    denom_inv = fr.neg(diff_inv)
    denom_inv2 = fr.batch_inverse(fr.sub(dom2, bc(alpha_dev)), axis=0)
    k_a = fr.mul(fr.sub(a_vals, bc(a0)), denom_inv)
    k_b = fr.mul(fr.sub(b_vals, bc(b0)), denom_inv)
    r_vals = fr.sub(fr.mul(a_vals, b_vals), i_vals)
    kr1 = fr.mul(fr.sub(r_vals, bc(r0)), denom_inv)
    kr2 = fr.mul(fr.sub(r2, bc(r0)), denom_inv2)
    # interleave [kr(D_i), kr(D'_i)]
    k_r = torch.stack([kr1, kr2], dim=-1).reshape(fr.NLIMB, 2 * m)
    return torch.cat([k_a, k_b, k_r], dim=-1)


_ctx_cache: dict = {}


def _prove_context(cache_dir: str, n_pubs: int, device):
    """Per-circuit context -- (z_poly, tree2n, parsed instance with the
    Vandermonde splice applied) -- cached across prove() calls.  Keyed
    by realpath, n_pubs and device, and stamped with the mtimes of the
    z_poly, R1CS and tree artifacts, so a regenerated cache (tree
    included) invalidates it.  One slot: the most recent circuit."""
    key = (os.path.realpath(cache_dir), n_pubs, str(device))
    paths = [
        os.path.join(cache_dir, art.Z_POLY),
        os.path.join(cache_dir, art.R1CS_CONSTRAINTS_FILE),
        os.path.join(cache_dir, art.TREE_2N + ".npz"),
    ]

    def stamp():
        return tuple(os.path.getmtime(p) if os.path.exists(p) else None for p in paths)

    hit = _ctx_cache.get(key)
    if hit is not None and hit[0] == stamp():
        return hit[1]
    z_poly = art.read_fr_vec(paths[0], device)
    m = z_poly.shape[-1] - 1
    tree2n = _tree2n(cache_dir, m, device)
    with open(paths[1], "rb") as f:
        inst = gnark.instance_from_dump(f.read(), n_pubs)
    assert inst.num_constraints == m
    gnark.add_vandermonde_matrix(inst, tree2n.both_domains()[0])
    ctx = (z_poly, tree2n, inst)
    _ctx_cache.clear()
    _ctx_cache[key] = (stamp(), ctx)
    return ctx


def prove(cache_dir: str, public_inputs: "list[int]", private_inputs, device=None,
          group: "mesh.Group | None" = None) -> Proof:
    """Proof over the cached setup of `cache_dir`; private_inputs are
    python ints or Fr limbs int32[20, n] (array or tensor).  `device`
    defaults to cuda; with a `group` the prove runs over its ranks on
    each rank's device (group.device, which `device` must then equal or
    leave unset) and every rank returns the same proof."""
    if group is None:
        dev = resolve(device or "cuda")
    else:
        dev = group.device
        if device is not None and multihost.rank_device(device) != dev:
            raise ValueError(f"device {device} is not the rank's device {dev}")
    with phase("prove.load_tree", dev):
        z_poly, tree2n, inst = _prove_context(cache_dir, len(public_inputs), dev)
        m = z_poly.shape[-1] - 1
        dom, dom2 = tree2n.both_domains()

    with phase("prove.witness", dev):
        head = fr.from_int([1] + [int(x) % fr.P for x in public_inputs])
        if isinstance(private_inputs, (np.ndarray, torch.Tensor)):
            priv = torch.as_tensor(private_inputs, dtype=torch.int32)
        else:
            priv = torch.from_numpy(fr.from_int([int(x) % fr.P for x in private_inputs]))
        w_dev = torch.cat([torch.from_numpy(head), priv.cpu()], dim=-1).to(dev)
        n_wires = int(w_dev.shape[-1])

    # The matvec (~0.03 s at m = 2^16) runs whole on every rank; a
    # domain-sharded prove then keeps each rank's run of its results.
    with phase("prove.matvec", dev):
        coeffs_dev = gnark.coeffs_device(inst, dev)
        a_vals = gnark.eval_matrix(inst.l, coeffs_dev, w_dev)
        b_vals = gnark.eval_matrix(inst.r, coeffs_dev, w_dev)
        c_vals = gnark.eval_matrix(inst.o, coeffs_dev, w_dev)
        i_vals = _monomial_evals_over_domain(public_inputs, dom)

    R = 1 if group is None else group.size
    sharded_dom = group is not None and sharded.can_shard_domain(m, R)
    lo, hi = mesh.dom_run(m, R, group.rank) if sharded_dom else (0, m)
    if sharded_dom:
        a_vals, b_vals, c_vals, i_vals = (v[:, lo:hi] for v in (a_vals, b_vals, c_vals, i_vals))

    with phase("prove.sat_check", dev):
        # witness satisfaction: a*b == c + i on D (on each rank's run)
        ok = all_zero(fr.sub(fr.mul(a_vals, b_vals), fr.add(c_vals, i_vals)))
        if sharded_dom:
            ok = mesh.all_true(ok, group)
        assert ok, "witness does not satisfy the SR1CS relation"

    def msm(scalars, parts, n=None):
        """MSM over the concatenation of point vector files [(path, len)];
        with a group, `scalars` may be this rank's run of the n scalars."""
        read = art.planes_reader(parts, dev)
        if group is not None:
            return sharded.msm_limbs_sharded(scalars, read, group, n)
        return xsk233.msm_limbs(scalars, read(0, -(-sum(k for _, k in parts) // 32)), dev)

    def to_point_run(pieces, layout, n):
        """Domain-run pieces of an n-vector -> this rank's MSM run of it."""
        want = [mesh.point_run(n, R, r) for r in range(R)]
        return mesh.redistribute(pieces, layout, want, group)

    with phase("prove.msm_gm", dev, n=n_wires):
        gm_path = os.path.join(cache_dir, art.SRS_G_M)
        assert art.point_vec_len(gm_path) == n_wires
        msm_gm = msm(w_dev, [(gm_path, n_wires)])
        del w_dev

    transcript = Transcript()
    transcript.circuit_info_hash(inst)
    transcript.public_input_hash(public_inputs)

    with phase("prove.extend", dev, n=4 * m):
        # the four extends D -> D' as one batched pass
        abci = torch.stack([a_vals, b_vals, c_vals, i_vals], dim=1)
        if sharded_dom:
            ext = sharded.extend_sharded(tree2n, abci, group)
        else:
            ext = tree2n.extend(abci, "S1", 0)
        a2, b2, c2, i2 = ext.unbind(dim=1)
        del c_vals, ext, abci

    with phase("prove.quotient", dev):
        z2inv = art.read_fr_vec(os.path.join(cache_dir, art.Z_VALS2_INV), dev, (lo, hi))
        r2 = fr.sub(fr.mul(a2, b2), i2)
        q2 = fr.mul(fr.sub(r2, c2), z2inv)
        del a2, b2, c2, i2, z2inv

    with phase("prove.msm_gq", dev, n=m):
        gq_path = os.path.join(cache_dir, art.SRS_G_Q)
        assert art.point_vec_len(gq_path) == m
        if sharded_dom:
            layout = [[(r * (hi - lo), hi - lo)] for r in range(R)]
            msm_q = msm(to_point_run([q2], layout, m), [(gq_path, m)], m)
        else:
            msm_q = msm(q2, [(gq_path, m)])
        del q2

    commit = host.add(xsk233.to_affine_int(msm_q), xsk233.to_affine_int(msm_gm))
    commit_p_bytes = host.encode(commit)
    transcript.witness_commitment_hash([commit_p_bytes])
    transcript.srs_hash()

    with phase("prove.challenge", dev):
        # alpha against the whole of D and D' on every rank (one compare each)
        alpha = transcript.output()
        alpha_dev = torch.as_tensor(fr.from_int(alpha), device=dev)
        in_domain = any(
            bool(fr.eq(d, fr.broadcast_scalar(alpha_dev, d.shape[1:])).any()) for d in (dom, dom2)
        )
        assert not in_domain, "challenge in domain (prob ~2^-200)"

    with phase("prove.evaluate_at_alpha", dev):
        bar_wts = art.read_fr_vec(os.path.join(cache_dir, art.BAR_WTS), dev, (lo, hi))
        sums, diff_inv = pre.barycentric_sums3(
            dom[:, lo:hi], bar_wts, a_vals, b_vals, i_vals, alpha_dev
        )
        if sharded_dom:  # the runs' sums, added in rank order
            runs = mesh.all_gather(sums, group)
            sums = runs[0]
            for part in runs[1:]:
                sums = fr.add(sums, part)
        a0, b0, i0 = pre.barycentric_at_alpha(sums, z_poly, alpha_dev)

    with phase("prove.k_scalars", dev):
        s_k = _k_scalars(dom2[:, lo:hi], a_vals, b_vals, i_vals, r2, a0, b0, i0, alpha_dev,
                         diff_inv)
        del a_vals, b_vals, i_vals, r2

    with phase("prove.msm_gk", dev, n=4 * m):
        parts = []
        for name in (art.SRS_G_K_0, art.SRS_G_K_1, art.SRS_G_K_2):
            path = os.path.join(cache_dir, name)
            parts.append((path, art.point_vec_len(path)))
        assert sum(n for _, n in parts) == 4 * m, ([n for _, n in parts], m)
        if sharded_dom:
            # [k_a || k_b || k_r]: each rank holds k_a and k_b at its run
            # and k_r (D and D' interleaved) at twice its run
            w = hi - lo
            layout = [[(r * w, w), (m + r * w, w), (2 * m + 2 * r * w, 2 * w)] for r in range(R)]
            pieces = [s_k[:, :w], s_k[:, w : 2 * w], s_k[:, 2 * w :]]
            kzg_k = msm(to_point_run(pieces, layout, 4 * m), parts, 4 * m)
        else:
            kzg_k = msm(s_k, parts)

    return Proof(
        commit_p=commit_p_bytes,
        kzg_k=host.encode(xsk233.to_affine_int(kzg_k)),
        a0=fr.to_int(a0),
        b0=fr.to_int(b0),
    )
