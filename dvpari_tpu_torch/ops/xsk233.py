"""sect233k1 MSM and fixed-base fan-out on Fr limb scalars: the
production entry points, bit-sliced path only; and the bit-plane helpers
the artifact cache and the prover use (compressed records from planes,
plane vectors joined slot by slot).

Counterpart of dvpari_tpu/ops/xsk233.py (`msm_limbs` via
_msm_limbs_bitsliced + _msm_device_recoded, `mulgen_limbs_host` via
_mulgen_bs_device): strong_normalize -> on-device tau-NAF recode ->
ladder kernel -> fold.  The whole vector is recoded in one call and the
ladder runs over all columns in one launch; padding slots carry zero
scalars (which recode to the infinity digit) and, in the MSM, zero
planes (which the complete add treats as infinity).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.ops import fr, msm_kernel
from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import tnaf_device as tdev
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.utils import gf2_host as gh
from dvpari_tpu_torch.utils import xsk233_host as host

M = bs.M


def _int_planes(v: int) -> "list[int]":
    """A field element -> 233 plane words with the element in all 32 slots."""
    return [-1 if (v >> i) & 1 else 0 for i in range(M)]


def _generator() -> torch.Tensor:
    """G = (GX : GY : 1) in all 32 slots of one column: int32[3, 233, 1]."""
    rows = [_int_planes(host.GX), _int_planes(host.GY), _int_planes(1)]
    return torch.tensor(rows, dtype=torch.int32)[..., None]


@functools.lru_cache(maxsize=1)
def _gen_table_cpu() -> torch.Tensor:
    return bs.tnaf_table(_generator())


def gen_table_planes(device="cuda") -> torch.Tensor:
    """G's tau-NAF window table, int32[11, 3, 233, 1], G in all 32 slots:
    the shared table of the fixed-base ladder.  Built once per process
    with the plain tnaf_table on the CPU (one column); each call returns
    a copy on `device`."""
    return _gen_table_cpu().to(resolve(device), copy=True)


def to_affine_int(p):
    """Word-layout point(s) uint32[3, 8] or [3, 8, n] (array or tensor)
    -> (x, y) python ints, None for infinity (or a list of those)."""
    w = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    w = w.astype(np.uint32)
    squeeze = w.ndim == 2
    if squeeze:
        w = w[..., None]
    out = []
    for j in range(w.shape[-1]):
        X, Y, Z = (sum(int(w[c, i, j]) << (32 * i) for i in range(8)) for c in range(3))
        if Z == 0:
            out.append(None)
        else:
            zi = gh.inv_int(Z)
            out.append((gh.mul_int(X, zi), gh.mul_int(Y, zi)))
    return out[0] if squeeze else out


# Columns per chunk of encode_planes: a plane multiply of C columns holds
# ~4 * 233 * 466 * C bytes of partial products at once.
ENCODE_COLS = 1024


def encode_planes(planes: torch.Tensor, n: int) -> np.ndarray:
    """The first n slots of bit-sliced points int32[3, 233, C] -> their
    30-byte compressed records (n, 30) uint8, host.encode's layout:
    x = X/Z in bits 0..232, lsb(y/x) = lsb(Y/X) in bit 233, infinity
    (Z = 0, also zero padding planes) all-zero.  One inversion of XZ per
    point (Itoh-Tsujii over the planes) on the planes' own device; only
    x and the y-bit come back to the host."""
    C = planes.shape[-1]
    assert 0 <= n <= 32 * C, (n, C)
    xs, bits = [], []
    sh = torch.arange(32, dtype=torch.int32, device=planes.device)
    for c0 in range(0, C, ENCODE_COLS):
        X, Y, Z = planes[:, :, c0 : c0 + ENCODE_COLS]
        i = F.inv(F.mul(X, Z))  # 1/(XZ); 0 at infinity
        xs.append(F.mul(F.square(X), i))  # X/Z
        lam0 = F.mul(F.mul(Y, Z), i)[0]  # bit 0 of Y/X
        bits.append(((lam0[:, None] >> sh) & 1).reshape(-1))
    words = F.unpack_words(torch.cat(xs, dim=-1))[:, :n]  # (8, n)
    recs = np.ascontiguousarray(words.T).view(np.uint8)[:, :30].copy()
    recs[:, 29] |= (torch.cat(bits)[:n].cpu().numpy().astype(np.uint8) << 1)
    return recs


def slot_bits(planes: torch.Tensor, n: int) -> torch.Tensor:
    """Planes int32[3, 233, C] -> the first n slots as 0/1 int32[3, 233, n]."""
    sh = torch.arange(32, dtype=torch.int32, device=planes.device)
    return ((planes[..., None] >> sh) & 1).reshape(*planes.shape[:-1], -1)[..., :n]


def pack_slot_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 int32[3, 233, n] -> planes int32[3, 233, ceil(n/32)], padding
    slots zero planes (infinity under the complete add)."""
    n = bits.shape[-1]
    bits = torch.nn.functional.pad(bits, (0, -n % 32)).reshape(*bits.shape[:-1], -1, 32)
    out = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=bits.device)
    for b in range(32):
        out |= bits[..., b] << b
    return out


def concat_planes(parts) -> torch.Tensor:
    """[(planes, n), ...] -> planes of the concatenated point vectors.
    Slot-aligned parts (every n but the last a multiple of 32) join as
    columns; others are repacked slot by slot."""
    if all(n % 32 == 0 for _, n in parts[:-1]):
        return torch.cat([p[..., : -(-n // 32)] for p, n in parts], dim=-1)
    return pack_slot_bits(torch.cat([slot_bits(p, n) for p, n in parts], dim=-1))


def recode(scalars, device="cuda"):
    """Fr limbs int32[20, n] -> ladder operands (oh, ng, C): canonicalise,
    pad to 32*C slots with zero scalars, recode on `device`.  Raises if
    the recode's self-check fails."""
    s = torch.as_tensor(scalars, dtype=torch.int32).to(resolve(device))
    if s.dim() != 2 or s.shape[0] != fr.NLIMB or s.shape[1] < 1:
        raise ValueError(f"scalars must be int32[{fr.NLIMB}, n], got {tuple(s.shape)}")
    n = s.shape[1]
    C = -(-n // 32)
    canon = fr.strong_normalize(s)
    if 32 * C != n:
        canon = torch.cat([canon, canon.new_zeros((fr.NLIMB, 32 * C - n))], dim=1)
    oh, ng, ok = tdev.recode_masks(canon)
    if not bool(ok):
        raise RuntimeError("device tau-NAF recode self-check failed")
    return oh, ng, C


def msm_partial(scalars, planes, device="cuda") -> torch.Tensor:
    """sum_i [k_i]P_i over Fr limb scalars int32[20, n] and bit-sliced
    points int32[3, 233, ceil(n/32)] (tensor; slots past n must be zero
    planes or carry zero scalars), as (3, 233) planes on `device` with
    the sum in bit 0 (ops/msm_kernel.py:msm_packed)."""
    dev = resolve(device)
    oh, ng, C = recode(scalars, dev)
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32:
        raise TypeError("planes must be an int32 tensor (see convert.planes_from_numpy)")
    planes = planes.to(dev)
    if tuple(planes.shape) != (3, M, C):
        raise ValueError(
            f"planes have shape {tuple(planes.shape)} for {C} columns of scalars"
        )
    return msm_kernel.msm_packed(oh, ng, planes.contiguous())


def msm_limbs(scalars, planes, device="cuda") -> np.ndarray:
    """msm_partial as the word-layout point uint32[3, 8]."""
    return bs.extract_point(msm_partial(scalars, planes, device), 0)


def mulgen_limbs(scalars, device="cuda") -> "tuple[np.ndarray, torch.Tensor]":
    """Fixed-base fan-out [s_i]G over Fr limb scalars int32[20, n].
    Returns (word-layout points uint32[3, 8, n] on the host, bit planes
    int32[3, 233, ceil(n/32)] on `device`, padding slots infinity)."""
    dev = resolve(device)
    n = torch.as_tensor(scalars).shape[-1]
    oh, ng, _ = recode(scalars, dev)
    planes = msm_kernel.mulgen_packed(oh, ng, gen_table_planes(dev))
    proj = bs.unpack_points(planes)[..., :n]
    return proj, planes
