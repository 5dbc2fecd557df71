"""R rank processes that prove in step: the route of a cell whose
configuration states more than one rank (benchmark/harness.py:run_cell).

The parent makes the inputs and runs the set-up on one card, as the
designated verifier would, then hands the pool the cache directory, the
witness pool and the prove function once.  Each rank joins one world
through the port's parallel/multihost.initialize, rank r on cuda:r,
where the backend has to come out as NCCL (on the CPU, in the tests,
every rank is on the CPU and the backend is gloo), and then waits for
commands:

  prove j, profile j   every rank calls prove(cache, pubs[j], privs[j],
                       group=g), the second under torch.profiler
                       (harness.profiled_prove); each answers with its
                       proof, its phases and its peak device memory
  stop                 answer with the top-level names of the modules
                       the run may not hold (harness.forbidden_modules),
                       leave the world and exit

The prove function is pickled by its import path, so the program's
prover.prove and a stand-in for it (the control, a planted fault) reach
every rank alike.  A rank watches its parent from a thread of its own:
once the parent is gone (ended at a run's limit, or by os._exit) the
rank exits within a second, idle or inside a collective.  A rank that
raises or dies fails the prove; the pool is then stopped, and every
later prove fails at once.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
import traceback

POLL_S = 0.5  # how often a rank looks for its parent, and the parent for dead ranks
STOP_S = 20.0  # how long a stopping rank may take before it is terminated


def _watch_parent(parent: int) -> None:
    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="watch-parent").start()


def _rank_main(rank: int, size: int, device, parent: int, commands, results) -> None:
    _watch_parent(parent)
    import torch

    from benchmark import harness
    from dvpari_tpu_torch.parallel import multihost
    from dvpari_tpu_torch.utils import timing

    try:
        port, cache, pubs, privs, prove, trace = commands.get()
        g = multihost.initialize(rank, size, "127.0.0.1", port, device, rank)
        if g.device.type == "cuda" and g.backend != "nccl":
            raise RuntimeError(f"rank {rank} on {g.device} joined a {g.backend} world, not NCCL")
        # one share of the host's cores per rank, as one rank on a
        # one-card machine has
        omp = os.environ.get("OMP_NUM_THREADS", "").split(",")[0]
        torch.set_num_threads(max(1, (int(omp) if omp.isdigit() else os.cpu_count() or 1) // size))
        timing.SYNC_PHASES = bool(trace)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, {"backend": g.backend, "device": str(g.device)}))
    cuda = g.device.type == "cuda"
    while True:
        cmd, j = commands.get()
        if cmd == "stop":
            results.put((rank, True, {"forbidden": harness.forbidden_modules()}))
            break
        try:
            out = harness.answer(lambda: prove(cache, pubs[j], privs[j], group=g),
                                 cmd == "profile", cuda, g.device)
            if rank and out["profile"]:  # only rank 0's timeline is read
                del out["profile"]["device_events"]
            results.put((rank, True, out))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    multihost.shutdown()


class Ranks:
    """A pool of `size` rank processes of one world.  `device` None puts
    rank r on cuda:r; a named device ("cpu") holds every rank."""

    def __init__(self, size: int, device=None):
        import torch.multiprocessing as mp

        self.size, self.device = size, device
        self._ctx = mp.get_context("spawn")
        self._procs: list = []
        self._commands: list = []
        self._results = None
        self.ready: list = []  # each rank's backend and device, once joined
        self.failed = ""  # why the ranks failed, once one has raised or died
        self.forbidden: set = set()  # what the ranks held when they stopped

    @property
    def pids(self) -> "list[int]":
        return [p.pid for p in self._procs]

    def start(self) -> None:
        """Spawn the ranks; they import the port and wait for `join`."""
        self._results = self._ctx.Queue()
        self._commands = [self._ctx.Queue() for _ in range(self.size)]
        self._procs = [self._ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(r, self.size, self.device, os.getpid(), self._commands[r], self._results))
            for r in range(self.size)]
        for p in self._procs:
            p.start()

    def join(self, cache: str, pubs, privs, prove, trace: bool) -> None:
        """Hand every rank the job once and wait until all have joined one
        world."""
        from dvpari_tpu_torch.parallel import multihost

        if not self._procs:
            self.start()
        port = multihost.free_port()
        for q in self._commands:
            q.put((port, cache, pubs, privs, prove, bool(trace)))
        self.ready = self._collect()

    def prove(self, j: int, profile: bool = False) -> "list[dict]":
        """Every rank's answer to one prove of pool entry j, in rank order:
        proof, phases, profile (None unless `profile`), peak device bytes."""
        if self.failed:
            raise RuntimeError(f"the ranks failed earlier: {self.failed}")
        for q in self._commands:
            q.put(("profile" if profile else "prove", j))
        return self._collect()

    def _collect(self) -> list:
        """One answer from every rank; once one has raised or died, the pool
        stopped and RuntimeError."""
        got = {}
        while len(got) < self.size:
            try:
                r, ok, out = self._results.get(timeout=POLL_S)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    error = f"rank {dead[0][0]} of {self.size} exited with code {dead[0][1]}"
                    break
                continue
            if not ok:
                error = f"rank {r} of {self.size} raised:\n{out}"
                break
            got[r] = out
        else:
            return [got[r] for r in range(self.size)]
        self.failed = error
        self.close(0)  # the others may wait in a collective for the lost rank
        raise RuntimeError(f"the ranks failed: {error}")

    def close(self, timeout_s: float = STOP_S) -> None:
        """Stop every rank and wait until each has ended; one still running
        after `timeout_s` is terminated.  What the stopping ranks held of
        the forbidden modules goes into `forbidden`."""
        if not self._procs:
            return
        for p, q in zip(self._procs, self._commands):
            if p.is_alive():
                q.put(("stop", None))
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            self._drain()
            time.sleep(0.05)
        self._drain()
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs, self._commands, self._results = [], [], None

    def _drain(self) -> None:
        """Read what the ranks still send, so that none blocks in its exit."""
        try:
            while True:
                _, ok, out = self._results.get_nowait()
                if ok and "forbidden" in out:
                    self.forbidden.update(out["forbidden"])
        except (queue_mod.Empty, OSError, ValueError):
            pass
