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
import zipfile

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
    """Write the sidecar beside the file and rename it into place: ranks
    that rebuild a missing sidecar at once each rename a whole file, and a
    reader that mapped the old one keeps its inode."""
    payload = {"P": planes}
    pp = path + ".planes.npz"
    tmp = f"{pp}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, SRC=src, SELF=_payload_digest(payload), **payload)
    os.replace(tmp, pp)


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


def read_fr_vec(path: str, device="cuda", records=None) -> torch.Tensor:
    """-> canonical limbs int32[20, n] on `device`; records=(lo, hi) reads
    only those records."""
    with open(path, "rb") as f:
        (total,) = struct.unpack("<Q", f.read(8))
        lo, hi = records if records is not None else (0, total)
        if not 0 <= lo <= hi <= total:
            raise ValueError(f"{path}: records {lo}..{hi} of {total}")
        f.seek(8 + lo * FR_RECORD)
        data = f.read((hi - lo) * FR_RECORD)
    n = hi - lo
    raw = np.frombuffer(data, dtype=np.uint8, count=n * FR_RECORD)
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
    try:
        z = np.load(path + ".planes.npz")
        if _sidecar_fresh(path, z):
            return z["P"]
    except FileNotFoundError:
        pass
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


def _npz_member(f, key: str) -> np.memmap:
    """Array `key` of an uncompressed .npz (np.savez) open as `f`, mapped
    from that file: slicing it reads only the pages the slice touches."""
    with zipfile.ZipFile(f) as zf:
        info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{f.name}: member {key} is compressed (np.savez writes it stored)")
    f.seek(info.header_offset)
    local = f.read(30)  # the zip local file header; name and extra follow
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}[version]
    shape, fortran, dtype = read_header(f)
    return np.memmap(f, dtype=dtype, mode="r", offset=f.tell(), shape=shape,
                     order="F" if fortran else "C")


def _planes_sidecar_fresh_streamed(path: str, f, planes: np.memmap) -> bool:
    """_sidecar_fresh for a planes sidecar open as `f`, hashing the mapped
    payload a block at a time instead of loading it."""
    f.seek(0)
    z = np.load(f)  # members load lazily: only SRC and SELF are read here
    if "SRC" not in z.files or "SELF" not in z.files or not os.path.exists(path):
        return False
    if not np.array_equal(z["SRC"], _file_digest(path)):
        return False
    h = hashlib.blake2b(digest_size=16)
    flat = planes.reshape(-1)
    for s in range(0, flat.shape[0], 1 << 22):
        h.update(np.ascontiguousarray(flat[s : s + (1 << 22)]).tobytes())
    return bool(np.array_equal(z["SELF"], np.frombuffer(h.digest(), dtype=np.uint8)))


def read_point_vec_planes_cols(path: str, cols: "tuple[int, int]") -> np.ndarray:
    """Columns [c0, c1) of read_point_vec_planes(path).  A fresh sidecar
    is mapped, not loaded: its digests are checked by hashing the files
    a block at a time, and only the slice is copied out, so host memory
    holds the slice, not the vector.  The digests, the header and the
    mapping all come from one open file, which a concurrent rebuild
    (renamed into place) does not change.  A missing or stale sidecar is
    first rebuilt from the records, whole, by read_point_vec_planes."""
    planes = None
    try:
        with open(path + ".planes.npz", "rb") as f:
            planes = _npz_member(f, "P")
            if not _planes_sidecar_fresh_streamed(path, f, planes):
                planes = None
    except FileNotFoundError:
        pass
    if planes is None:
        planes = read_point_vec_planes(path)
    c0, c1 = cols
    if not 0 <= c0 <= c1 <= planes.shape[-1]:
        raise ValueError(f"{path}: columns {c0}..{c1} of {planes.shape[-1]}")
    return np.ascontiguousarray(planes[:, :, c0:c1])


# Device-resident planes: the SRS is a fixed per-circuit artifact, so each
# vector (or column slice of one) is uploaded once per process.  Keyed by
# (path, sidecar mtime, device, columns); a rewritten artifact drops its
# stale uploads.
_PLANES_DEVICE_CACHE: "dict[tuple, torch.Tensor]" = {}


def read_point_vec_planes_device(path: str, device="cuda", cols=None) -> torch.Tensor:
    """read_point_vec_planes as an int32 tensor on `device`, cached;
    cols=(c0, c1) puts only those columns on the device
    (read_point_vec_planes_cols)."""
    dev = resolve(device)
    pp = path + ".planes.npz"
    mtime = os.path.getmtime(pp) if os.path.exists(pp) else None
    key = (os.path.abspath(path), mtime, str(dev), cols)
    hit = _PLANES_DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    for k in [k for k in _PLANES_DEVICE_CACHE if k[0] == key[0] and k[1] != mtime]:
        del _PLANES_DEVICE_CACHE[k]
    host = read_point_vec_planes(path) if cols is None else read_point_vec_planes_cols(path, cols)
    arr = convert.planes_from_numpy(host, dev)
    if mtime is None:  # the sidecar was written just now
        key = (key[0], os.path.getmtime(pp), key[2], cols)
    _PLANES_DEVICE_CACHE[key] = arr
    return arr


def planes_reader(parts, device):
    """The prover's SRS reader: read(c0, c1) gives columns [c0, c1) of the
    bit planes of one point vector [(path, n)] or of the concatenation of
    several (the g_k segments) on `device`.  Each file contributes the
    columns the range needs, read alone (read_point_vec_planes_device,
    cached); segments that are not 32-point aligned are joined slot by
    slot, as xsk233.concat_planes joins the whole vectors."""
    offs = np.cumsum([0] + [n for _, n in parts]).tolist()
    aligned = all(n % 32 == 0 for _, n in parts[:-1])

    def read(c0: int, c1: int) -> torch.Tensor:
        lo, hi = 32 * c0, min(32 * c1, offs[-1])
        got = []
        for (path, n), o in zip(parts, offs):
            a, b = max(lo, o) - o, min(hi, o + n) - o  # this segment's points
            if a >= b:
                continue
            cols = None if (a, b) == (0, n) else (a // 32, -(-b // 32))  # whole: one cache entry
            pl = read_point_vec_planes_device(path, device, cols)
            got.append(pl if aligned else xsk233.slot_bits(pl, b - (a // 32) * 32)[..., a % 32:])
        if aligned:
            return got[0] if len(got) == 1 else torch.cat(got, dim=-1)
        return xsk233.pack_slot_bits(torch.cat(got, dim=-1))

    return read


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
