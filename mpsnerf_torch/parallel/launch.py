"""Start ranks on this host: ``n`` processes (the ``spawn`` start method),
each in one process group, each calling ``fn(*args)`` and handing its
return value back to the caller.

The rendezvous is a ``TCPStore`` that the caller's process holds on a
free localhost port (the OS picks it, so two launches never race for
one); the ranks join it as clients.  Every rank's group gets the given
timeout, and the caller waits for the results, with a deadline where it
gives one.  A rank that raises, exits without a result, or outlives the
deadline makes :meth:`Ranks.wait` terminate the others and raise: a
launch never returns fewer results than ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


class RankFailed(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _rank_entry(fn, rank, n, port, device, timeout_s, threads, inbox,
                results):
    import torch
    import torch.distributed as dist

    from mpsnerf_torch.parallel.mesh import initialize_distributed

    # this host's cores split between the ranks (oversubscribed intra-op
    # pools stall every rank at each collective)
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // n))
    # the ranks share this host: gloo talks over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        initialize_distributed(num_processes=n, process_id=rank,
                               device=device, local_world_size=n,
                               timeout_s=timeout_s, store=store)
        out = fn(*pickle.loads(inbox.get()))
        # plain pickle: a tensor travels as its bytes, not as a shared
        # file descriptor that ends with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``n`` started ranks; :meth:`wait` collects their results."""

    def __init__(self, fn: Callable, n: int, args: Sequence = (),
                 device: str = "cpu", timeout_s: float = 600.0,
                 threads: Optional[int] = None):
        import multiprocessing

        import torch.distributed as dist

        ctx = multiprocessing.get_context("spawn")
        self.n, self.timeout_s = n, timeout_s
        self.store = dist.TCPStore(
            "127.0.0.1", 0, None, True,
            datetime.timedelta(seconds=timeout_s), wait_for_workers=False)
        self.results = ctx.Queue()
        # the arguments go through a queue, not the start: a start writes
        # its data into a pipe that the child reads only after its imports
        self.inbox = ctx.Queue()
        self.procs = [ctx.Process(
            target=_rank_entry, daemon=True,
            args=(fn, r, n, self.store.port, device, timeout_s, threads,
                  self.inbox, self.results)) for r in range(n)]
        for p in self.procs:
            p.start()
        blob = pickle.dumps(tuple(args))
        for _ in range(n):
            self.inbox.put(blob)
        # arguments that no rank takes (it died, or this process raises
        # before waiting) must not hold this process at its exit
        self.inbox.cancel_join_thread()

    def _fail(self, msg: str):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)
        raise RankFailed(msg)

    def wait(self, deadline_s: Optional[float] = None) -> List[Any]:
        """The ranks' return values in rank order.  Raises
        :class:`RankFailed` (after terminating every rank) on a failure or
        when ``deadline_s`` (None: no deadline) passes."""
        end = time.monotonic() + (deadline_s or float("inf"))
        out = {}
        while len(out) < self.n:
            try:
                rank, ok, value = self.results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    self._fail(f"rank {dead[0]} exited with code "
                               f"{self.procs[dead[0]].exitcode} and no result")
                if time.monotonic() > end:
                    self._fail(f"ranks {sorted(set(range(self.n)) - set(out))}"
                               f" gave no result in {deadline_s} s")
                continue
            if not ok:
                self._fail(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for r, p in enumerate(self.procs):
            p.join(min(60.0, max(1.0, end - time.monotonic())))
            if p.exitcode != 0:
                self._fail(f"rank {r} exited with code {p.exitcode}")
        return [out[r] for r in range(self.n)]


def spawn(fn: Callable, n: int, args: Sequence = (), device: str = "cpu",
          timeout_s: float = 600.0, threads: Optional[int] = None,
          deadline_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` ranks of a new group on this host and
    return their results in rank order.  ``fn`` must be importable by the
    ranks (a module-level function); ``device`` is ``"cpu"`` or
    ``"cuda"`` (each rank takes ``cuda:{rank % device_count}``);
    ``timeout_s`` is the group's collective timeout, ``deadline_s`` the
    caller's wait for all results; ``threads`` sets each rank's torch
    intra-op threads (default: this host's cores over ``n``)."""
    return Ranks(fn, n, args, device, timeout_s, threads).wait(deadline_s)
