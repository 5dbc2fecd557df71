"""Artifact cache: names and on-disk formats, shared with the JAX package.

Counterpart of dvpari_tpu/storage/artifacts.py, with the same names and
interchange formats, so a cache written by either package reads in the
other:

* Fr vectors: u64 LE count, then 29-byte little-endian canonical
  elements.
* Point vectors: u64 LE count, then 30-byte compressed points, plus a
  `.planes.npz` sidecar (key "P": uint32 bit planes [3, 233, ceil(n/32)],
  "SRC": digest of the record file, "SELF": digest of the payload) that
  the MSM reads.  A JAX-written `.fast.npz` sidecar (word-layout X, Y, Z)
  is read when the planes sidecar is missing.
* FFTrees: an .npz of layer limb arrays, isogeny x0s and meta, with the
  derived tables in a `.tables` directory beside it.

The artifact cache is the checkpoint/resume system: every expensive
object is written once and skipped if present.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np
import torch

from dvpari_tpu_torch import convert, native
from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.fftree.tree import FFTree
from dvpari_tpu_torch.ops import fr, xsk233
from dvpari_tpu_torch.ops import xsk233_bs as bs

# --- artifact names (the JAX package's) ---------------------------------------
SRS_G_Q = "g_q"
SRS_G_M = "g_m"
SRS_G_K_0 = "g_k_0"
SRS_G_K_1 = "g_k_1"
SRS_G_K_2 = "g_k_2"
TREE_2N = "tree2n"
TREE_2ND = "tree2nd"
Z_POLY = "z_poly"
Z_POLYD = "z_polyd"
BAR_WTS = "bar_wts"
BAR_WTSD = "bar_wtsd"
Z_VALS2_INV = "z_vals2inv"
Z_VALS2D_INV = "z_vals2dinv"
R1CS_CONSTRAINTS_FILE = "r1cs_to_dvsnark"
R1CS_WITNESS_FILE = "witness_to_dvsnark"

FR_RECORD = 29  # ceil(232/8)
PT_RECORD = 30
IO_CHUNK = 1 << 20  # records decoded per native call


# --- sidecar integrity (blake2b digests, as the JAX package) -----------------

_PAYLOAD_KEYS = ("X", "Y", "Z", "P")  # fast: X/Y/Z; planes: P


def _file_digest(path: str) -> np.ndarray:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return np.frombuffer(h.digest(), dtype=np.uint8)


def _payload_digest(arrs: "dict[str, np.ndarray]") -> np.ndarray:
    h = hashlib.blake2b(digest_size=16)
    for k in _PAYLOAD_KEYS:
        if k in arrs:
            h.update(np.ascontiguousarray(arrs[k]).tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8)


def _sidecar_fresh(path: str, npz) -> bool:
    """True iff the sidecar matches both its source file and itself."""
    files = set(getattr(npz, "files", ()))
    if "SRC" not in files or "SELF" not in files or not os.path.exists(path):
        return False
    if not np.array_equal(npz["SRC"], _file_digest(path)):
        return False
    payload = {k: npz[k] for k in _PAYLOAD_KEYS if k in files}
    return bool(np.array_equal(npz["SELF"], _payload_digest(payload)))


def _save_planes_sidecar(path: str, planes: np.ndarray, src: np.ndarray) -> None:
    payload = {"P": planes}
    np.savez(path + ".planes.npz", SRC=src, SELF=_payload_digest(payload), **payload)


# --- Fr vectors --------------------------------------------------------------

def write_fr_vec(path: str, values: torch.Tensor) -> None:
    """Limbs (20, n) -> u64 count + 29-byte LE canonical records."""
    canon = fr.strong_normalize(torch.as_tensor(values)).cpu().numpy()
    if canon.ndim == 1:
        canon = canon[:, None]
    recs = fr.limbs_to_le_bytes(canon, FR_RECORD)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", recs.shape[0]))
        f.write(recs.tobytes())


def read_fr_vec(path: str, device="cuda") -> torch.Tensor:
    """-> canonical limbs int32[20, n] on `device`."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    raw = np.frombuffer(data, dtype=np.uint8, count=n * FR_RECORD, offset=8)
    bits = np.unpackbits(raw.reshape(n, FR_RECORD), axis=1, bitorder="little")
    want = fr.NLIMB * fr.LIMB_BITS  # 240 > 232 stored bits: zero-pad the top
    bits = np.pad(bits, [(0, 0), (0, want - bits.shape[1])])
    weights = (1 << np.arange(fr.LIMB_BITS)).astype(np.int32)
    limbs = bits.reshape(n, fr.NLIMB, fr.LIMB_BITS).astype(np.int32) @ weights
    return torch.from_numpy(np.ascontiguousarray(limbs.T)).to(resolve(device))


# --- point vectors -----------------------------------------------------------

def write_point_vec(path: str, planes: torch.Tensor, n: int) -> None:
    """The first n slots of bit-sliced points int32[3, 233, C] -> 30-byte
    compressed records (encoded on the planes' device,
    xsk233.encode_planes) + the `.planes.npz` sidecar."""
    recs = xsk233.encode_planes(planes, n)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(recs.tobytes())
    _save_planes_sidecar(path, convert.planes_to_numpy(planes), _file_digest(path))


def point_vec_len(path: str) -> int:
    """Record count from the u64-LE header (no payload read)."""
    with open(path, "rb") as f:
        return struct.unpack("<Q", f.read(8))[0]


def read_point_vec_planes(path: str) -> np.ndarray:
    """uint32 bit planes (3, 233, ceil(n/32)) of the point vector: the
    planes sidecar when fresh, else packed from a fresh `.fast.npz`
    (JAX-written small vectors) or from the records, decoded and
    validated in the native library (an invalid record raises), and then
    cached as the sidecar."""
    pp = path + ".planes.npz"
    if os.path.exists(pp):
        z = np.load(pp)
        if _sidecar_fresh(path, z):
            return z["P"]
    fast = path + ".fast.npz"
    z = np.load(fast) if os.path.exists(fast) else None
    if z is not None and _sidecar_fresh(path, z):
        words = np.stack([z["X"], z["Y"], z["Z"]], axis=0)
    else:
        with open(path, "rb") as f:
            data = f.read()
        (n,) = struct.unpack_from("<Q", data, 0)
        words = np.zeros((3, 8, n), dtype=np.uint32)
        for s in range(0, n, IO_CHUNK):  # bounded decode buffers
            e = min(s + IO_CHUNK, n)
            try:
                xy, inf = native.pt_decode_bulk(data[8 + s * PT_RECORD : 8 + e * PT_RECORD])
            except ValueError as err:
                raise ValueError(f"{path}: {err}") from None
            for c in (0, 1):  # x, y: four u64 words -> eight u32 words
                w64 = xy[:, 4 * c : 4 * c + 4].T
                words[c, 0::2, s:e] = (w64 & 0xFFFFFFFF).astype(np.uint32)
                words[c, 1::2, s:e] = (w64 >> 32).astype(np.uint32)
            words[2, 0, s:e] = inf == 0
            words[1, 0, s:e] |= inf  # infinity is (0 : 1 : 0)
    planes = bs.pack_points(words)
    _save_planes_sidecar(path, planes, _file_digest(path))
    return planes


# Device-resident planes: the SRS is a fixed per-circuit artifact, so each
# vector is uploaded once per process.  Keyed by (path, sidecar mtime);
# a rewritten artifact drops its stale upload.
_PLANES_DEVICE_CACHE: "dict[tuple, torch.Tensor]" = {}


def read_point_vec_planes_device(path: str, device="cuda") -> torch.Tensor:
    """read_point_vec_planes as an int32 tensor on `device`, cached."""
    dev = resolve(device)
    pp = path + ".planes.npz"
    mtime = os.path.getmtime(pp) if os.path.exists(pp) else None
    key = (os.path.abspath(path), mtime, str(dev))
    hit = _PLANES_DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    for k in [k for k in _PLANES_DEVICE_CACHE if k[0] == key[0]]:
        del _PLANES_DEVICE_CACHE[k]
    arr = convert.planes_from_numpy(read_point_vec_planes(path), dev)
    if mtime is None:  # the sidecar was written just now
        key = (key[0], os.path.getmtime(pp), key[2])
    _PLANES_DEVICE_CACHE[key] = arr
    return arr


# --- FFTrees -----------------------------------------------------------------

def write_fftree(path: str, tree: FFTree) -> None:
    arrs = {f"layer{i}": np.asarray(t) for i, t in enumerate(tree.layers)}
    arrs["x0s"] = np.array(
        [np.frombuffer(int(x).to_bytes(32, "little"), dtype=np.uint8) for x in tree.x0s],
        dtype=np.uint8,
    )
    arrs["meta"] = np.array([tree.n, int(tree.shift_by_one), tree.base_log_n], dtype=np.int64)
    np.savez(path + ".npz", **arrs)
    tree.table_dir = path + ".tables"  # persist derived tables alongside


def read_fftree(path: str, device="cuda") -> FFTree:
    z = np.load(path + ".npz")
    n, shift, base_log_n = (int(v) for v in z["meta"])
    layers = [z[f"layer{i}"] for i in range(n.bit_length())]  # log2(n) + 1
    x0s = [int.from_bytes(bytes(row), "little") for row in z["x0s"]]
    tree = FFTree(layers, x0s, bool(shift), base_log_n, device)
    tree.table_dir = path + ".tables"
    return tree


def fftree_exists(path: str) -> bool:
    return os.path.exists(path + ".npz")
