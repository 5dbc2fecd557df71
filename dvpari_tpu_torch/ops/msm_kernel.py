"""The bit-sliced tau-NAF ladder on the GPU: CUDA kernels
(csrc/bs_ladder.cu) and their plain PyTorch versions.

Counterpart of dvpari_tpu/ops/pallas_msm.py.  Same entry points, names
and layouts: `msm_packed(oh, ng, planes)` -> (3, 233) planes with the
MSM in bit 0, and `mulgen_packed(oh, ng, table_slot)` -> (3, 233, C)
planes with [k_i]G in every slot.  Planes and masks are int32 tensors
(bit-exact views of the JAX uint32 arrays).

Two CUDA kernels, each behind one wrapper: `ladder` (the Pallas
kernel's counterpart) and `point_add` (its complete add alone, which
the window-table build and the folds use).  On CPU tensors a wrapper
runs its plain version (ops/xsk233_bs.py); on CUDA tensors it launches
the kernel or raises -- there is no fallback.  The kernels are built
from the repository's source with nvcc at first use (into
dvpari_tpu_torch/build/) and bound through ctypes.  Each wrapper counts
its launches in `<wrapper>.launches`.

`library(defines=PROFILE_DEFINES)` builds the same source a second time
with phase clocks and doubling counters compiled in; `profile_ladder` and
`profile_point_add` launch that build (uncounted) and read them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from dvpari_tpu_torch.ops import gf2bs as F
from dvpari_tpu_torch.ops import xsk233_bs as bs
from dvpari_tpu_torch.ops.tnaf import N_WINDOWS, TABLE_SIZE

M = bs.M

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bs_ladder.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

PROFILE_DEFINES = ("BS_PHASE_CLOCKS",)

_libs = {}
build_logs = {}  # library path -> nvcc's output (ptxas registers, spills, shared memory)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build(source: str = SOURCE, defines=()) -> str:
    """Compile `source` (csrc/bs_ladder.cu or a copy of it) for sm_90a
    with -D`defines`, once per content and defines; returns the shared
    library's path."""
    with open(source, "rb") as f:
        key = f.read() + repr(sorted(defines)).encode()
    tag = hashlib.sha256(key).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libbs_ladder_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, source],
        capture_output=True, text=True, check=False,
    )
    build_logs[so] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_logs[so]}")
    os.replace(tmp, so)
    return so


def library(source: str = SOURCE, defines=()) -> ctypes.CDLL:
    """The built library of `source` with `defines`, loaded once per
    process (a later edit of the source needs a new process)."""
    key = (source, tuple(defines))
    if key not in _libs:
        lib = ctypes.CDLL(build(source, defines))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bs_ladder.argtypes = [vp, vp, vp, ci, vp, ci, vp]
        lib.bs_ladder.restype = ci
        lib.bs_point_add.argtypes = [vp, vp, vp, ci, vp]
        lib.bs_point_add.restype = ci
        lib.bs_error_string.argtypes = [ci]
        lib.bs_error_string.restype = ctypes.c_char_p
        if hasattr(lib, "bs_occupancy"):
            lib.bs_occupancy.argtypes = [ci]
            lib.bs_occupancy.restype = ci
        if hasattr(lib, "bs_shared_bytes"):
            lib.bs_shared_bytes.argtypes = [ci]
            lib.bs_shared_bytes.restype = ci
        if hasattr(lib, "bs_phase_read"):
            lib.bs_phase_names.restype = ctypes.c_char_p
            lib.bs_phase_reset.restype = ci
            lib.bs_phase_read.argtypes = [vp]
            lib.bs_phase_read.restype = ci
        _libs[key] = lib
    return _libs[key]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (bit planes), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.bs_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")


# ---------------------------------------------------------------------------
# The two kernels' wrappers: plain version on CPU tensors, kernel on CUDA
# ---------------------------------------------------------------------------

def launch_ladder(lib, oh: torch.Tensor, ng: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch `lib`'s ladder kernel on CUDA operands (no count)."""
    _require_cuda(oh)
    C = oh.shape[-1]
    tcols = table.shape[-1]
    dev = oh.device
    if C < 1 or tcols not in (1, C):
        raise ValueError(f"{C} columns with a {tcols}-column table")
    _check("oh", oh, (N_WINDOWS, TABLE_SIZE, C), dev)
    _check("ng", ng, (N_WINDOWS, C), dev)
    _check("table", table, (TABLE_SIZE, 3, M, tcols), dev)
    out = torch.empty((3, M, C), dtype=torch.int32, device=dev)
    rc = lib.bs_ladder(
        oh.data_ptr(), ng.data_ptr(), table.data_ptr(), tcols,
        out.data_ptr(), C, _stream(dev),
    )
    _raise_on(lib, rc, "bs_ladder")
    return out


def ladder(oh: torch.Tensor, ng: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[k_i]P_i for every packed slot: oh int32[62, 11, C] digit masks,
    ng int32[62, C] negate masks, table int32[11, 3, 233, C] (or
    [..., 1]: one table shared by every column) -> int32[3, 233, C].
    xsk233_bs.ladder on CPU tensors, csrc/bs_ladder.cu on CUDA."""
    if oh.device.type == "cpu":
        return bs.ladder(oh, ng, table)
    _require_cuda(oh)
    out = launch_ladder(library(), oh, ng, table)
    ladder.launches += 1
    return out


ladder.launches = 0


def launch_point_add(lib, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Launch `lib`'s point-add kernel on CUDA operands (no count)."""
    _require_cuda(p)
    p, q = p.contiguous(), q.contiguous()
    C = p.shape[-1]
    _check("p", p, (3, M, C), p.device)
    _check("q", q, (3, M, C), p.device)
    if C < 1:
        raise ValueError("empty point batch")
    out = torch.empty_like(p)
    rc = lib.bs_point_add(p.data_ptr(), q.data_ptr(), out.data_ptr(), C, _stream(p.device))
    _raise_on(lib, rc, "bs_point_add")
    return out


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Masked-complete add of two (3, 233, C) point batches, slot by
    slot; xsk233_bs.add on CPU tensors, the CUDA kernel on CUDA."""
    if p.device.type == "cpu":
        return bs.add(p, q)
    _require_cuda(p)
    out = launch_point_add(library(), p, q)
    point_add.launches += 1
    return out


point_add.launches = 0


def reset_counts() -> None:
    ladder.launches = 0
    point_add.launches = 0


# ---------------------------------------------------------------------------
# Operands that take the complete add's doubling branch
# ---------------------------------------------------------------------------

def doubling_lanes(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The lanes of p + q that need the doubling (P = Q, neither
    infinity), as the complete add's masks define them: int32[*cols]."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    u = F.mul(Y1, Z2) ^ F.mul(Y2, Z1)
    v = F.mul(X1, Z2) ^ F.mul(X2, Z1)
    return (F.is_zero_mask(v) & F.is_zero_mask(u)
            & ~F.is_zero_mask(Z1) & ~F.is_zero_mask(Z2))


def doubling_operands(table: torch.Tensor, slots, seed: int, a: int = 1, b: int = 2):
    """Ladder operands under which the add at window 60 is a doubling in
    each of `slots` (point indices 32 * column + bit): `table` with entry
    b replaced by tau^4(entry a), and digit masks that pick entry a at
    window 61 and entry b at window 60, both unnegated, in those slots,
    and elsewhere random digits other than b, with random signs (from
    `seed`): no other lane picks tau^4(entry a), which a lane whose
    accumulator is +-entry a would double with.  In the chosen slots the
    accumulator after window 61 is entry a, so tau^4 of it equals the
    picked entry b.  Entry a must be finite in those slots.  Returns
    (oh, ng, table) on the table's device."""
    cols = table.shape[-1]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, TABLE_SIZE - 1, (N_WINDOWS, 32 * cols))
    idx[idx >= b] += 1
    sgn = np.where(rng.integers(0, 2, (N_WINDOWS, 32 * cols)) == 1, -1, 1)
    for s in slots:
        idx[N_WINDOWS - 1, s], idx[N_WINDOWS - 2, s] = a, b
        sgn[N_WINDOWS - 1, s] = sgn[N_WINDOWS - 2, s] = 1
    oh, ng = bs.digit_masks(idx, sgn)
    crafted = table.clone()
    crafted[b] = bs.frobenius(table[a], 4)
    dev = table.device
    return (torch.from_numpy(oh.view(np.int32)).to(dev),
            torch.from_numpy(ng.view(np.int32)).to(dev), crafted)


# ---------------------------------------------------------------------------
# The profiling build: phase clocks, doubling counts, occupancy
# ---------------------------------------------------------------------------

def occupancy(lib=None) -> "dict[str, dict]":
    """Each kernel's resident blocks per SM at its launch's dynamic
    shared memory, and those bytes (where the library reports them)."""
    lib = lib or library()
    out = {}
    for what, name in enumerate(("ladder", "point_add")):
        n = lib.bs_occupancy(what)
        if n < 0:
            _raise_on(lib, -n, f"occupancy of {name}")
        out[name] = {"blocks_per_sm": n}
        if hasattr(lib, "bs_shared_bytes"):
            out[name]["shared_bytes"] = lib.bs_shared_bytes(what)
    return out


def _profiled(lib, launch) -> "tuple[torch.Tensor, dict]":
    torch.cuda.synchronize()
    _raise_on(lib, lib.bs_phase_reset(), "bs_phase_reset")
    out = launch()
    torch.cuda.synchronize()
    names = lib.bs_phase_names().decode().split(",")
    raw = (ctypes.c_ulonglong * (len(names) + 3))()
    _raise_on(lib, lib.bs_phase_read(ctypes.addressof(raw)), "bs_phase_read")
    vals = list(raw)
    stats = {"cycles": dict(zip(names, vals)), "windows": vals[len(names)],
             "doubles_run": vals[len(names) + 1], "doubles_needed": vals[len(names) + 2]}
    return out, stats


def profile_ladder(oh, ng, table, source: str = SOURCE):
    """The profiling build's ladder on CUDA operands -> (out, stats):
    stats["cycles"] is each phase's clock64() cycles summed over the
    blocks (divide by stats["windows"] for cycles per column-window),
    doubles_run / doubles_needed count column-windows."""
    lib = library(source, PROFILE_DEFINES)
    return _profiled(lib, lambda: launch_ladder(lib, oh, ng, table))


def profile_point_add(p, q):
    """The profiling build's point add -> (out, stats); the doubling
    counts are per column."""
    lib = library(SOURCE, PROFILE_DEFINES)
    return _profiled(lib, lambda: launch_point_add(lib, p, q))


# ---------------------------------------------------------------------------
# Entry points (the JAX package's pallas_msm names and layouts)
# ---------------------------------------------------------------------------

def msm_packed(oh: torch.Tensor, ng: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Variable-base MSM on packed operands: oh int32[62, 11, C],
    ng int32[62, C], planes int32[3, 233, C] -> (3, 233) planes with
    sum_i [k_i]P_i in bit 0: window table and folds through point_add,
    then the ladder."""
    table = bs.tnaf_table(planes, add=point_add)
    return bs.fold_sum(ladder(oh, ng, table), add=point_add)


def mulgen_packed(oh: torch.Tensor, ng: torch.Tensor, table_slot: torch.Tensor) -> torch.Tensor:
    """Fixed-base batch scalar-mul: table_slot int32[11, 3, 233, 1] (one
    base point's window table, the same point in all 32 bits) ->
    (3, 233, C) planes with [k_i]G in every slot."""
    return ladder(oh, ng, table_slot)
