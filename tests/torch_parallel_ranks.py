"""Rank bodies for tests/test_torch_parallel.py.  Spawned ranks import
this module, so it imports torch, numpy and the port only: no JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr
from dvpari_tpu_torch.parallel import mesh, sharded
from dvpari_tpu_torch.storage import artifacts as art


def msm(group, scalars: np.ndarray, planes: np.ndarray):
    """msm_limbs_sharded over the whole scalars and in-memory planes;
    also returns this rank's column run."""
    n = scalars.shape[-1]
    pl = torch.from_numpy(planes).to(group.device)
    got = sharded.msm_limbs_sharded(torch.from_numpy(scalars), lambda c0, c1: pl[..., c0:c1],
                                    group)
    return got, mesh.col_run(-(-n // 32), group.size, group.rank)


def extend(group, tree_args, evals: np.ndarray, moieties):
    """This rank's runs of extend_sharded over its run of `evals`, one
    per moiety, as canonical limbs."""
    tree = FFTree(*tree_args, device=group.device)
    lo, hi = mesh.dom_run(evals.shape[-1], group.size, group.rank)
    run = torch.from_numpy(evals[..., lo:hi]).to(group.device)
    return [fr.strong_normalize(sharded.extend_sharded(tree, run, group, mo)).cpu().numpy()
            for mo in moieties]


# rank r holds entries [5r, 5r + 5) and [15 + 5r, 20 + 5r) of a 30-vector
REDISTRIBUTE_LAYOUT = [[(5 * r, 5), (15 + 5 * r, 5)] for r in range(3)]
REDISTRIBUTE_WANT = [(0, 7), (7, 20), (20, 30)]


def redistribute(group):
    """mesh.redistribute of a 30-vector whose entries are their indices."""
    pieces = [torch.arange(s, s + n, dtype=torch.int32).expand(fr.NLIMB, n)
              for s, n in REDISTRIBUTE_LAYOUT[group.rank]]
    out = mesh.redistribute(pieces, REDISTRIBUTE_LAYOUT, REDISTRIBUTE_WANT, group)
    return out.numpy()


def reread_sidecar(group, path: str, rounds: int):
    """Every rank reads its column run of `path` `rounds` times, with no
    barrier between, while rank 0 deletes the planes sidecar before each
    of its reads: the ranks find the sidecar missing (and rebuild it
    together), being replaced, or whole."""
    C = art.point_vec_len(path) // 32
    out = []
    dist.barrier(group=group.pg)
    for _ in range(rounds):
        if group.rank == 0:
            try:
                os.remove(path + ".planes.npz")
            except FileNotFoundError:  # between another rank's delete and its rename
                pass
        out.append(art.read_point_vec_planes_cols(path, mesh.col_run(C, group.size, group.rank)))
    dist.barrier(group=group.pg)
    return out
