"""torch.distributed start-up: from torchrun's environment, or for ranks
that this process spawns itself.

Counterpart of dvpari_tpu/parallel/multihost.py (`maybe_initialize`,
`process_info`).  Environment contract, torchrun's:

  RANK         this process's rank in [0, WORLD_SIZE)
  WORLD_SIZE   the number of ranks
  LOCAL_RANK   the rank's index on its host: its card is cuda:LOCAL_RANK
  MASTER_ADDR  host of rank 0's rendezvous store
  MASTER_PORT  its port

With none of them set a process runs alone, as in the JAX package.  Where
only some are set, start-up raises: the JAX package's `is_configured()`
runs single-host in that case, so a misconfigured rank proves alone
beside a cluster waiting for it.  A rank's device is cuda:LOCAL_RANK
unless the caller names one, and a LOCAL_RANK with no card of its own
raises.  The backend follows from where the ranks are, which they tell
each other through the rendezvous store before the group starts: NCCL
when every rank has a card of its own, gloo when any rank is on the CPU
or two ranks share a card (NCCL refuses a card twice in one world).
Nothing here changes backend, device or world size after a failure.

`run_ranks` spawns R ranks of one world on this host (the dryrun, the
tests, the smoke's two ranks on one card) and returns what each rank's
function returned.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback

import torch
import torch.distributed as dist

from dvpari_tpu_torch.device import resolve
from dvpari_tpu_torch.parallel.mesh import Group

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# How long a collective may wait for a missing rank before it raises.
TIMEOUT_S = 600

_group: "Group | None" = None


def env_config() -> "dict | None":
    """torchrun's five variables, parsed; None when none is set.  Raises
    when some but not all are set, or when they are malformed."""
    got = {k: os.environ.get(k) for k in ENV}
    set_ = [k for k, v in got.items() if v]
    if not set_:
        return None
    if len(set_) != len(ENV):
        missing = [k for k in ENV if k not in set_]
        raise RuntimeError(f"partly set torchrun environment: {set_} set, {missing} missing")
    cfg = {"rank": int(got["RANK"]), "world_size": int(got["WORLD_SIZE"]),
           "local_rank": int(got["LOCAL_RANK"]), "addr": got["MASTER_ADDR"],
           "port": int(got["MASTER_PORT"])}
    if not 0 <= cfg["rank"] < cfg["world_size"]:
        raise ValueError(f"RANK={cfg['rank']} out of range for WORLD_SIZE={cfg['world_size']}")
    if cfg["local_rank"] < 0:
        raise ValueError(f"LOCAL_RANK={cfg['local_rank']} is negative")
    return cfg


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The rank's device: `device` if given (a bare "cuda" names the
    current card), else cuda:local_rank, which must exist."""
    if device is not None:
        dev = resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    resolve("cuda")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise RuntimeError(f"LOCAL_RANK={local_rank} but this host has {n} CUDA device(s)")
    return torch.device("cuda", local_rank)


def _backend(store, rank: int, world_size: int, dev: torch.device) -> str:
    """NCCL iff every rank's device is a card no other rank holds; every
    rank reads the same answer from the store."""
    store.set(f"device/{rank}", f"{socket.gethostname()} {dev}")
    seen = [store.get(f"device/{r}").decode() for r in range(world_size)]
    own_cards = all(s.split()[-1] != "cpu" for s in seen) and len(set(seen)) == world_size
    return "nccl" if own_cards else "gloo"


def initialize(rank: int, world_size: int, addr: str, port: int, device=None,
               local_rank: int = 0) -> Group:
    """Join the world of `world_size` ranks at tcp://addr:port as `rank`
    and return its Group."""
    global _group
    if _group is not None:
        raise RuntimeError("torch.distributed is already initialised in this process")
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store, _, _ = next(dist.rendezvous(f"tcp://{addr}:{port}", rank, world_size,
                                       timeout=timeout))
    backend = _backend(dist.PrefixStore("dvpari", store), rank, world_size, dev)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store), world_size=world_size,
                            rank=rank, timeout=timeout)
    _group = Group(dist.group.WORLD, world_size, rank, dev, backend)
    return _group


def maybe_initialize(device=None) -> bool:
    """Initialise torch.distributed from torchrun's environment; False
    (and nothing done) when none of it is set.  Idempotent."""
    if _group is not None:
        return True
    cfg = env_config()
    if cfg is None:
        return False
    initialize(cfg["rank"], cfg["world_size"], cfg["addr"], cfg["port"], device,
               cfg["local_rank"])
    return True


def group() -> Group:
    """The Group this process initialised; raises if there is none."""
    if _group is None:
        raise RuntimeError("torch.distributed is not initialised (maybe_initialize / initialize)")
    return _group


def process_info() -> "tuple[int, int]":
    """(rank, world size) of the live group."""
    g = group()
    return g.rank, g.size


def shutdown() -> None:
    """Leave the group (the next initialize may join another)."""
    global _group
    if _group is not None:
        dist.destroy_process_group()
        _group = None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, device, fn, args, queue):
    try:
        g = initialize(rank, world_size, "127.0.0.1", port, device, rank)
        if g.device.type == "cpu":
            # ranks sharing this host's cores: R processes of all-core
            # thread pools, each spinning between its many small ops, run
            # tens of times slower than one
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        try:
            out = fn(g, *args)
        finally:
            shutdown()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(world_size: int, fn, args=(), device=None,
              timeout_s: float = TIMEOUT_S) -> list:
    """Spawn `world_size` ranks of one world on this host; rank r calls
    fn(group, *args) (fn and args must pickle) and the list of their
    results, in rank order, is returned.  `device` None puts rank r on
    cuda:r (NCCL); a named device holds every rank (gloo).  Any rank's failure raises here, with its traceback, after
    every rank has stopped."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, device, fn, args, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world_size:
            try:
                r, ok, out = q.get(timeout=1)
            except queue_mod.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode not in (None, 0)}
                if dead:  # a rank that died before it could report
                    errors.update({i: f"exit code {c}" for i, c in dead.items() if i not in errors})
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {timeout_s} s") from None
                continue
            (results if ok else errors)[r] = out
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=timeout_s if len(results) == world_size else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        r = min(errors)
        raise RuntimeError(f"rank {r} of {world_size} failed:\n{errors[r]}")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [results[r] for r in range(world_size)]
