"""The sharded MSM and the domain-sharded extend over a torch.distributed
group.

Counterpart of dvpari_tpu/parallel/sharded.py (`msm_bs_sharded_canon`,
reached from ops/xsk233.py:_msm_limbs_bs_sharded) and of the
cross-shard butterflies that GSPMD inserts into the JAX package's
fftree/tree.py:_extend_tabled on domain-sharded vectors.

MSM: each rank takes its run of 32-point columns (mesh.col_run), reads
only those columns of the SRS planes onto its device
(storage/artifacts.py:planes_reader), and runs the one-device pipeline
on them (ops/xsk233.py:msm_partial): strong_normalize, the device recode
(its self-check raising), the window table, the ladder kernel and the
folds.  The (3, 233) partials, 2.8 KB each, are
all-gathered and every rank folds them with the point-add kernel in the
same pairwise order (xsk233_bs.fold_cols), so all ranks hold the same
point.  A rank whose run is empty contributes infinity (zero planes).

Extend: rank r holds evaluations [r m/R, (r+1) m/R) of each vector.
Every level of the extend pairs the entries g and g + half_k of a
vector and keeps them in place, with level k's tables indexed by
g mod half_k.  In the top log2 R levels half_k >= m/R, so a pair lies in
two ranks' runs at the same offset.  Viewed as R rows of m/R, one
all-to-all gives rank c column block c of every row; the top levels
then run locally with rank c's slice of each table, a second all-to-all
returns whole rows, the remaining levels (decompose and recombine) run
on the row as the one-device extend does, and two more all-to-alls
bracket the top recombine levels.  Every value equals the one-device
extend's: the same field operations on the same operands.
"""

from __future__ import annotations

import numpy as np
import torch

from dvpari_tpu_torch.fftree.tree import _extend_tabled
from dvpari_tpu_torch.ops import fr, msm_kernel, xsk233
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.parallel import mesh

M = bs.M


def msm_limbs_sharded(scalars, planes_of_cols, group: mesh.Group,
                      n: "int | None" = None) -> np.ndarray:
    """sum_i [k_i]P_i over the group: the sharded counterpart of
    ops/xsk233.py:msm_limbs.

    scalars: Fr limbs int32[20, n], the whole vector (n None), or this
    rank's run of an n-vector (mesh.point_run).  planes_of_cols(c0, c1)
    returns the points' bit planes int32[3, 233, c1 - c0] of columns
    [c0, c1) on the rank's device (artifacts.planes_reader).  Returns the word-layout point
    uint32[3, 8], the same on every rank."""
    dev = group.device
    s = torch.as_tensor(scalars, dtype=torch.int32)
    total = s.shape[-1] if n is None else n
    lo, hi = mesh.point_run(total, group.size, group.rank)
    c0, c1 = mesh.col_run(-(-total // 32), group.size, group.rank)
    if n is None:
        s = s[:, lo:hi]
    elif s.shape[-1] != hi - lo:
        raise ValueError(f"rank {group.rank} holds {s.shape[-1]} scalars of its run {lo}..{hi}")
    if c1 > c0:
        planes = planes_of_cols(c0, c1)
        if planes.device != dev:
            raise ValueError(f"planes of columns {c0}..{c1} on {planes.device}, not {dev}")
        part = xsk233.msm_partial(s, planes, dev)
    else:
        part = torch.zeros((3, M), dtype=torch.int32, device=dev)  # infinity
    parts = mesh.all_gather(part, group)
    folded = bs.fold_cols(torch.stack(parts, dim=-1), add=msm_kernel.point_add)
    return bs.extract_point(folded, 0)


# ---------------------------------------------------------------------------
# The domain-sharded extend
# ---------------------------------------------------------------------------

def _log2(n: int) -> int:
    assert n > 0 and n & (n - 1) == 0, n
    return n.bit_length() - 1


def can_shard_domain(m: int, R: int) -> bool:
    """True where the extend can run on R domain runs of m: R divides m
    and each run splits into R column blocks (m >= R^2)."""
    return m % R == 0 and (m // R) % R == 0


def _top_tables(consts, k: int, c: int, R: int, m: int) -> "list[torch.Tensor]":
    """Rank c's entries of level k's tables (k < log2 R) against the
    column-block state (20, *B, 2^k, R / 2^(k+1), w): the entry of
    state[..., q, t] is table[q * m/R + c w + t]."""
    g, w = R >> (k + 1), m // R // R
    return [t.reshape(fr.NLIMB, g, m // R)[..., c * w : (c + 1) * w] for t in consts]


def _bcast_top(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(20, g, w) -> (20, 1..1, 1, g, w) against a state of ndim axes."""
    return t.reshape((fr.NLIMB,) + (1,) * (ndim - 3) + tuple(t.shape[1:]))


def _to_blocks(row: torch.Tensor, group: mesh.Group) -> torch.Tensor:
    """Each rank's row (20, *B, m/R) -> this rank's column block of every
    row, (20, *B, R, w)."""
    R = group.size
    w = row.shape[-1] // R
    chunks = [row[..., c * w : (c + 1) * w] for c in range(R)]
    got = mesh.all_to_all(chunks, [chunks[0].shape] * R, group)
    return torch.stack(got, dim=-2)


def _to_row(blocks: torch.Tensor, group: mesh.Group) -> torch.Tensor:
    """The inverse of _to_blocks."""
    R = group.size
    chunks = [blocks[..., r, :] for r in range(R)]
    got = mesh.all_to_all(chunks, [chunks[0].shape] * R, group)
    return torch.cat(got, dim=-1)


def extend_sharded(tree, run: torch.Tensor, group: mesh.Group, moiety: str = "S1",
                   d: int = 0) -> torch.Tensor:
    """FFTree.extend over domain runs: run (20, *B, m/R) is this rank's
    run of evals on one moiety of view(d); returns its run of the evals
    on the other.  Needs can_shard_domain(m, R)."""
    R, c = group.size, group.rank
    m = tree.n >> (d + 1)
    if not can_shard_domain(m, R) or run.shape[-1] != m // R:
        raise ValueError(f"run of {run.shape[-1]} evals for m = {m} over {R} ranks")
    L = _log2(R)
    dec, rec = tree._extend_consts(d, moiety)
    state = _to_blocks(run.to(group.device), group)  # (20, *B, R, w)
    for k in range(L):
        st = state.reshape(*state.shape[:-2], 1 << k, 2, R >> (k + 1), state.shape[-1])
        E0, E1 = st[..., 0, :, :], st[..., 1, :, :]
        d00, d01, d10, d11 = (_bcast_top(t, E0.ndim) for t in _top_tables(dec[k], k, c, R, m))
        U0 = fr.add(fr.mul(d00, E0), fr.mul(d01, E1))
        U1 = fr.add(fr.mul(d10, E0), fr.mul(d11, E1))
        state = torch.stack([U0, U1], dim=-3).reshape(state.shape)
    row = _extend_tabled(_to_row(state, group), dec[L:], rec[L:])
    state = _to_blocks(row, group)
    for k in reversed(range(L)):
        st = state.reshape(*state.shape[:-2], 1 << k, 2, R >> (k + 1), state.shape[-1])
        U0, U1 = st[..., 0, :, :], st[..., 1, :, :]
        r0, r0x, r1, r1x = (_bcast_top(t, U0.ndim) for t in _top_tables(rec[k], k, c, R, m))
        P0 = fr.add(fr.mul(r0, U0), fr.mul(r0x, U1))
        P1 = fr.add(fr.mul(r1, U0), fr.mul(r1x, U1))
        state = torch.stack([P0, P1], dim=-3).reshape(state.shape)
    return _to_row(state, group)
