"""Domain precompute algorithms on FFTrees (protocol layer helpers).

Counterpart of dvpari_tpu/fftree/precompute.py: vanishing polynomial,
barycentric weights, Lagrange bases at tau, vanishing evaluations over a
domain, and O(N) barycentric evaluation at the challenge.  The JAX
package's warm_protocol_programs has no counterpart (torch compiles
nothing ahead of time).
"""

from __future__ import annotations

import torch

from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr


def poly_derivative(coeffs: torch.Tensor) -> torch.Tensor:
    """d/dx: (..., n) -> (..., n-1): i * c_i."""
    n = coeffs.shape[-1]
    shape = (fr.NLIMB,) + (1,) * (coeffs.dim() - 2) + (n - 1,)
    scale = torch.as_tensor(fr.from_int(list(range(1, n))), device=coeffs.device)
    return fr.mul(coeffs[..., 1:], scale.reshape(shape))


def horner_step(tail: torch.Tensor, leaves: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
    """tail * x + z0 over the leaves: Z(x) from its enter-evaluated tail."""
    return fr.add(fr.mul(tail, leaves), fr.broadcast_scalar(z0, leaves.shape[1:]))


def compute_vanishing_polynomial(tree2n: FFTree) -> torch.Tensor:
    """Coefficients (n+1, monic) of Z_D for D = tree2n's even moiety."""
    return tree2n.z_coeffs(1)


def compute_barycentric_weights(tree: FFTree, z_coeffs: torch.Tensor, d: int = 1) -> torch.Tensor:
    """1 / Z'(d_i) over the view(d) domain."""
    zp = poly_derivative(z_coeffs.to(tree.device))
    assert zp.shape[-1] == tree.n >> d
    return fr.batch_inverse(tree.enter(zp, d), axis=0)


def compute_lagrange_basis_at_tau(tree: FFTree, z_coeffs, tau, bar_wts, d: int = 1) -> torch.Tensor:
    """L_i(tau) = Z(tau) / ((tau - d_i) Z'(d_i))."""
    leaves = tree.leaves(d)
    batch = leaves.shape[1:]
    z_tau = fr.poly_eval(z_coeffs, tau)
    diff_inv = fr.batch_inverse(fr.sub(fr.broadcast_scalar(tau, batch), leaves), axis=0)
    return fr.mul(fr.mul(fr.broadcast_scalar(z_tau, batch), diff_inv), bar_wts)


def evaluate_vanishing_poly_at_domain(z_coeffs: torch.Tensor, tree: FFTree, d: int) -> torch.Tensor:
    """Z (n+1 coeffs) over the n-point view(d) domain: enter on the
    degree-(n-1) tail, then one Horner step."""
    z_coeffs = z_coeffs.to(tree.device)
    tail = tree.enter(z_coeffs[..., 1:].contiguous(), d)
    return horner_step(tail, tree.leaves(d), z_coeffs[..., 0])


def lagrange_basis_unified(tau, num_constraints: int, l_tau, l_taud, z_poly, z_polyd,
                           z_vals2_inv, z_vals2d_inv) -> torch.Tensor:
    """Lagrange basis over D u D' (interleaved) from the per-domain bases."""
    m = l_tau.shape[-1]
    assert m == num_constraints
    z_tau = fr.poly_eval(z_poly, tau)  # Z_D(tau)
    zd_tau = fr.poly_eval(z_polyd, tau)  # Z_D'(tau)
    even = fr.mul(fr.mul(l_tau, fr.broadcast_scalar(zd_tau, (m,))), z_vals2d_inv)
    odd = fr.mul(fr.mul(l_taud, fr.broadcast_scalar(z_tau, (m,))), z_vals2_inv)
    return torch.stack([even, odd], dim=-1).reshape(fr.NLIMB, 2 * m)


def barycentric_sums3(domain, bar_wts, pa, pb, pc, alpha):
    """(sums, diff_inv): sums int32[20, 3] holds sum_i y_i w_i / (alpha - d_i)
    for y = pa, pb, pc over the given run of the domain, sharing the
    (alpha - d_i) batch inversion; diff_inv = 1/(alpha - d_i) on that run
    is returned for the k-scalars.  A sharded prove adds the runs' sums."""
    diff_inv = fr.batch_inverse(
        fr.sub(fr.broadcast_scalar(alpha, domain.shape[1:]), domain), axis=0
    )
    wd = fr.mul(bar_wts, diff_inv)
    sums = torch.stack([fr.sum_along(fr.mul(p, wd), axis=0) for p in (pa, pb, pc)], dim=-1)
    return sums, diff_inv


def barycentric_at_alpha(sums, z_coeffs, alpha):
    """(a0, b0, i0) = Z(alpha) * sums: three barycentric evaluations at
    one alpha, P(alpha) = Z(alpha) * sum_i y_i w_i / (alpha - d_i), from
    the sums of barycentric_sums3 (the JAX package's
    barycentric_eval3_at_alpha is the two in one)."""
    z_alpha = fr.poly_eval(z_coeffs, alpha)
    return tuple(fr.mul(z_alpha, s) for s in sums.unbind(dim=-1))
