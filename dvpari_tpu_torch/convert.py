"""State carried across from the JAX package: its numpy uint32 bit
planes and int32 Fr limbs <-> the port's int32 tensors, bit for bit.

The SRS `.planes.npz` sidecar (key "P", uint32[3, 233, C]) holds planes
of this kind, so a cache written by the JAX package loads here through
planes_from_numpy(np.load(path)["P"]); a JAX FFTree's layers become
the port's tree through fftree_from_numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from dvpari_tpu_torch.device import resolve


def planes_from_numpy(planes: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 (or int32) bit planes -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(planes)
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"bit planes must be uint32 or int32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve(device))


def planes_to_numpy(planes: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy planes with the same bits."""
    if planes.dtype != torch.int32:
        raise TypeError(f"bit planes must be int32, got {planes.dtype}")
    return planes.detach().cpu().numpy().view(np.uint32)


def limbs_from_numpy(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """int32 Fr limbs [20, ...] -> int32 tensor."""
    arr = np.asarray(limbs)
    if arr.dtype != np.int32:
        raise TypeError(f"Fr limbs must be int32, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(resolve(device))


def limbs_to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """int32 tensor -> int32 numpy limbs."""
    if limbs.dtype != torch.int32:
        raise TypeError(f"Fr limbs must be int32, got {limbs.dtype}")
    return limbs.detach().cpu().numpy()


def fftree_from_numpy(layers, x0s, shift_by_one: bool, base_log_n: int, device="cuda"):
    """The JAX package's FFTree state -- layers as numpy int32[20, n_l],
    isogeny x0s as python ints -> the port's FFTree on `device`."""
    from dvpari_tpu_torch.fftree.tree import FFTree

    for layer in layers:
        if np.asarray(layer).dtype != np.int32:
            raise TypeError(f"tree layers must be int32 limbs, got {np.asarray(layer).dtype}")
    return FFTree([np.asarray(l) for l in layers], x0s, shift_by_one, base_log_n, device)
