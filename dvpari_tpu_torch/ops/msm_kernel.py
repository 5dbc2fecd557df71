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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

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

_lib = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> str:
    """Compile csrc/bs_ladder.cu for sm_90a (once per source content);
    returns the shared library's path."""
    global build_log
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libbs_ladder_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, check=False,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bs_ladder.argtypes = [vp, vp, vp, ci, vp, ci, vp]
        lib.bs_ladder.restype = ci
        lib.bs_point_add.argtypes = [vp, vp, vp, ci, vp]
        lib.bs_point_add.restype = ci
        lib.bs_error_string.argtypes = [ci]
        lib.bs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (bit planes), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _load().bs_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")


# ---------------------------------------------------------------------------
# The two kernels' wrappers: plain version on CPU tensors, kernel on CUDA
# ---------------------------------------------------------------------------

def ladder(oh: torch.Tensor, ng: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[k_i]P_i for every packed slot: oh int32[62, 11, C] digit masks,
    ng int32[62, C] negate masks, table int32[11, 3, 233, C] (or
    [..., 1]: one table shared by every column) -> int32[3, 233, C].
    xsk233_bs.ladder on CPU tensors, csrc/bs_ladder.cu on CUDA."""
    if oh.device.type == "cpu":
        return bs.ladder(oh, ng, table)
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
    rc = _load().bs_ladder(
        oh.data_ptr(), ng.data_ptr(), table.data_ptr(), tcols,
        out.data_ptr(), C, _stream(dev),
    )
    _raise_on(rc, "bs_ladder")
    ladder.launches += 1
    return out


ladder.launches = 0


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Masked-complete add of two (3, 233, C) point batches, slot by
    slot; xsk233_bs.add on CPU tensors, the CUDA kernel on CUDA."""
    if p.device.type == "cpu":
        return bs.add(p, q)
    _require_cuda(p)
    p, q = p.contiguous(), q.contiguous()
    C = p.shape[-1]
    _check("p", p, (3, M, C), p.device)
    _check("q", q, (3, M, C), p.device)
    if C < 1:
        raise ValueError("empty point batch")
    out = torch.empty_like(p)
    rc = _load().bs_point_add(p.data_ptr(), q.data_ptr(), out.data_ptr(), C, _stream(p.device))
    _raise_on(rc, "bs_point_add")
    point_add.launches += 1
    return out


point_add.launches = 0


def reset_counts() -> None:
    ladder.launches = 0
    point_add.launches = 0


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
