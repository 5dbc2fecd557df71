"""The process group a sharded prove runs over, how its ranks split the
work, and the collectives they exchange it with.

Counterpart of dvpari_tpu/parallel/mesh.py.  The JAX package builds a
1-D device mesh and lets GSPMD place the collectives; torch has no
GSPMD, so the port names its group and its splits explicitly:

* a `Group`: the torch.distributed process group, its size R, this
  rank and the rank's device;
* `col_run`: rank r's contiguous run of the C 32-point columns of an
  MSM, ceil(C/R) columns each, the last run ragged (and empty where
  R * ceil(C/R) - C >= ceil(C/R)), the split of the JAX package's
  sharded MSM (parallel/sharded.py:146-156);
* `dom_run`: rank r's run of m domain evaluations, m/R each, where
  R divides m (the JAX prover's domain-sharded layout,
  protocol/prover.py:218);
* `all_gather`, `all_to_all` (variable sizes) and `all_true` over the
  group.  Gloo's support for CUDA tensors is partial, so under gloo the
  collectives copy CUDA tensors to the host, exchange them there and
  copy the results back to the rank's device; NCCL exchanges them on
  the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from dvpari_tpu_torch.ops.fr import NLIMB


@dataclass(frozen=True)
class Group:
    """A process group of `size` ranks, seen from rank `rank`, whose work
    runs on `device`."""

    pg: object  # torch.distributed.ProcessGroup
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def via_host(self) -> bool:
        """True where the collectives stage CUDA tensors through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"


def col_run(C: int, R: int, r: int) -> "tuple[int, int]":
    """Rank r's columns [c0, c1) of C, ceil(C/R) per rank, in rank order."""
    per = -(-C // R)
    c0 = min(r * per, C)
    return c0, min(c0 + per, C)


def point_run(n: int, R: int, r: int) -> "tuple[int, int]":
    """The points [lo, hi) of n that rank r's column run covers."""
    c0, c1 = col_run(-(-n // 32), R, r)
    return min(32 * c0, n), min(32 * c1, n)


def dom_run(m: int, R: int, r: int) -> "tuple[int, int]":
    """Rank r's evaluations [lo, hi) of m, m/R per rank; R must divide m."""
    if m % R:
        raise ValueError(f"{R} ranks do not divide {m} evaluations")
    w = m // R
    return r * w, (r + 1) * w


def _to_comm(t: torch.Tensor, group: Group) -> torch.Tensor:
    return t.cpu() if group.via_host else t


def all_gather(t: torch.Tensor, group: Group) -> "list[torch.Tensor]":
    """Every rank's `t` (one shape on all ranks), in rank order, on this
    rank's device."""
    t = _to_comm(t.contiguous(), group)
    out = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(out, t, group=group.pg)
    return [o.to(group.device) for o in out]


def all_to_all(chunks: "list[torch.Tensor]", shapes, group: Group) -> "list[torch.Tensor]":
    """Send chunks[d] to rank d and receive from each rank s a tensor of
    shapes[s] (one dtype throughout; sizes may differ and be zero).
    Returns the received tensors in rank order, on this rank's device."""
    dtype = chunks[0].dtype
    send = torch.cat([c.reshape(-1) for c in chunks])
    sizes_in = [c.numel() for c in chunks]
    sizes_out = [int(torch.Size(s).numel()) for s in shapes]
    send = _to_comm(send, group)
    recv = torch.empty(sum(sizes_out), dtype=dtype, device=send.device)
    dist.all_to_all_single(recv, send, sizes_out, sizes_in, group=group.pg)
    recv = recv.to(group.device)
    return [p.reshape(s) for p, s in zip(torch.split(recv, sizes_out), shapes)]


def all_true(flag: bool, group: Group) -> bool:
    """True iff `flag` holds on every rank."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=group.device)
    t = _to_comm(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group.pg)
    return bool(int(t.item()))


def redistribute(pieces: "list[torch.Tensor]", layout, want, group: Group) -> torch.Tensor:
    """Move the slices of a vector of Fr limbs between ranks.

    layout[r] lists rank r's pieces as (start, length) along the vector,
    want[r] = (lo, hi) is the run rank r needs; every rank passes the
    same layout and want, and `pieces` are this rank's tensors
    (20, length) in layout[rank]'s order.  Returns the (20, hi - lo)
    run of this rank, assembled in vector order."""
    r = group.rank
    lo, hi = want[r]

    def cuts(src: int, run) -> "list[tuple[int, int, int]]":
        """(piece index, start, end) of src's pieces inside `run`."""
        out = []
        for j, (s, n) in enumerate(layout[src]):
            a, b = max(s, run[0]), min(s + n, run[1])
            if a < b:
                out.append((j, a, b))
        return out

    send = []
    for d in range(group.size):
        parts = [pieces[j][:, a - layout[r][j][0] : b - layout[r][j][0]]
                 for j, a, b in cuts(r, want[d])]
        send.append(torch.cat(parts, dim=-1) if parts else
                    torch.empty((NLIMB, 0), dtype=torch.int32, device=group.device))
    shapes = [(NLIMB, sum(b - a for _, a, b in cuts(s, want[r]))) for s in range(group.size)]
    got = all_to_all(send, shapes, group)
    out = torch.empty((NLIMB, hi - lo), dtype=torch.int32, device=group.device)
    filled = 0
    for s in range(group.size):
        off = 0
        for _, a, b in cuts(s, want[r]):
            out[:, a - lo : b - lo] = got[s][:, off : off + b - a]
            off += b - a
            filled += b - a
    if filled != hi - lo:
        raise ValueError(f"the layout covers {filled} of rank {r}'s {hi - lo} entries")
    return out
