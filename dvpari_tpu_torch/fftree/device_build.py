"""The FFTree's layers built on the device (K8), batched over Fr lanes.

Counterpart of dvpari_tpu/fftree/device_build.py.  Layer 0 is a ladder
of mixed Jacobian adds: lane i starts at the coset C and adds the doubled
generator 2^j G wherever bit j of its index (offset + i) is set, so it
ends at C + [offset + i] G; one batch inversion at the end gives
x = X / Z^2.  The higher layers are isogeny x-maps of the layer below,
on the device as well (the JAX package runs them on its local CPU
backend only because of TPU compile times).  Every step is a handful of
elementwise Fr torch ops (ops/fr.py) over all lanes; no hand kernel.

Exceptional cases cannot occur: the accumulator lives in the coset
C + <G>, the added points in <G>, and the coset is chosen disjoint
(reference: src/ec_fft.rs:222-228), so the x-coordinates of the two
summands never agree and Z never becomes 0.

Layer 0 runs in chunks of DVPARI_LAYER0_CHUNK lanes (default
LAYER0_CHUNK), each with its own offset, so that peak device memory
stays bounded at 2^23-2^24 leaves.  A step whose bit no lane of the
chunk has set is skipped, and one that every lane has set needs no
select; torch compiles nothing, so the JAX package's fixed-length masked
ladder has no counterpart.  The layers come back to the host once each,
canonical, as int32[20, n_l].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dvpari_tpu_torch.fftree import aux_curve
from dvpari_tpu_torch.ops import fr

# Lanes per layer-0 chunk.  A 2^22-leaf build on an H100 peaked at 8.41
# GiB of device memory in one 2^22-lane chunk, 4.36 GiB in chunks of
# 2^21 and 2.96 GiB in chunks of 2^20, at about the same speed (19.0,
# 17.9 and 18.2 s; PERF.md, K8): 2^21 lanes keep a chunk near 4 GiB, a
# twentieth of the card, whatever the domain size.
LAYER0_CHUNK = 1 << 21


def layer0_chunk() -> int:
    return int(os.environ.get("DVPARI_LAYER0_CHUNK", LAYER0_CHUNK))


def _jacobian_madd(X, Y, Z, gx, gy):
    """Jacobian accumulator (X, Y, Z) + affine point (gx, gy): mixed
    addition madd-2007-bl (7M + 4S, no inversion)."""
    z1z1 = fr.square(Z)
    u2 = fr.mul(gx, z1z1)
    s2 = fr.mul(gy, fr.mul(Z, z1z1))
    h = fr.sub(u2, X)
    hh = fr.square(h)
    i4 = fr.add(fr.add(hh, hh), fr.add(hh, hh))
    j = fr.mul(h, i4)
    r = fr.add(fr.sub(s2, Y), fr.sub(s2, Y))
    v = fr.mul(X, i4)
    x3 = fr.sub(fr.sub(fr.square(r), j), fr.add(v, v))
    yj = fr.mul(Y, j)
    y3 = fr.sub(fr.mul(r, fr.sub(v, x3)), fr.add(yj, yj))
    z3 = fr.sub(fr.sub(fr.square(fr.add(Z, h)), z1z1), hh)
    return x3, y3, z3


def _iso_map(xs, x0, t):
    """One isogeny x-map (x^2 - x0 x + t) / (x - x0) over all lanes;
    x0, t are (20, 1) columns."""
    num = fr.add(fr.sub(fr.square(xs), fr.mul(x0, xs)), t)
    return fr.mul(num, fr.batch_inverse(fr.sub(xs, x0), axis=0))


def _col(v: int, device) -> torch.Tensor:
    return torch.as_tensor(fr.from_int(v), device=device).reshape(fr.NLIMB, 1)


def _layer0(doubles, coset, offset: int, width: int, device) -> torch.Tensor:
    """x(C + [offset + i] G) for lanes i < width: (20, width) loose limbs.
    `doubles` are the (gx, gy) columns of 2^j G, `coset` C's."""
    idx = offset + torch.arange(width, dtype=torch.int64, device=device)
    X, Y = coset
    Z = fr.ones((1,), device)
    last = offset + width - 1
    for j, (gx, gy) in enumerate(doubles):
        # bit j over the lanes' indices, known on the host: none set, all set, or mixed
        if (offset >> j) == (last >> j):
            if not (offset >> j) & 1:
                continue
            X, Y, Z = _jacobian_madd(X, Y, Z, gx, gy)
            continue
        x3, y3, z3 = _jacobian_madd(X, Y, Z, gx, gy)
        mask = ((idx >> j) & 1) == 1
        X, Y, Z = fr.select(mask, x3, X), fr.select(mask, y3, Y), fr.select(mask, z3, Z)
    X = X.expand(fr.NLIMB, width)
    Z = Z.expand(fr.NLIMB, width)
    zinv = fr.batch_inverse(Z, axis=0)
    return fr.mul(X, fr.square(zinv))


def build_layers(meta: aux_curve.ChainMeta, domain_len: int, device) -> "list[np.ndarray]":
    """The tree's layers x(layer l), l = 0..log2(domain_len), as
    canonical host int32[20, n_l] arrays, computed on `device`."""
    device = torch.device(device)
    doubles = [(_col(gx, device), _col(gy, device)) for gx, gy in meta.gen_doubles]
    coset = (_col(meta.coset[0], device), _col(meta.coset[1], device))
    ck = layer0_chunk()
    parts = [
        _layer0(doubles, coset, off, min(ck, domain_len - off), device)
        for off in range(0, domain_len, ck)
    ]
    top = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    del parts
    layers = [fr.strong_normalize(top)]
    n = domain_len
    for _, iso in meta.layers[:-1]:
        top = _iso_map(top[:, : n // 2], _col(iso.x0, device), _col(iso.t, device))
        layers.append(fr.strong_normalize(top))
        n //= 2
    return [layer.cpu().numpy() for layer in layers]
