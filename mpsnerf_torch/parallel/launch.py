"""Start ranks on this host: ``n`` processes (the ``spawn`` start method)
in one process group.

:class:`RankPool` keeps its ranks: each builds a handler once and answers
requests until the pool is closed (the sharded render of a served
bundle).  :func:`spawn` and :class:`Ranks` are a pool whose ranks each
run ``fn(*args)`` once, as they start, and hand its return value back.

The rendezvous is a ``TCPStore`` that the caller's process holds on a
free localhost port (the OS picks it, so two launches never race for
one); the ranks join it as clients.  Every rank's group gets the given
timeout, and the caller waits for the replies, with a deadline where it
gives one.  A rank that raises, exits, or outlives the deadline makes the
caller stop every rank, close the pool and raise :class:`RankFailed`: a
request never returns fewer replies than ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


class RankFailed(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _stop(procs, grace_s: float = 5.0) -> None:
    """Terminate the live processes; kill those that outlast ``grace_s``
    (a stopped process holds a SIGTERM until it runs again)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(grace_s)
        if p.is_alive():
            p.kill()
            p.join(grace_s)


def _join_group(rank, n, port, device, timeout_s, threads):
    import torch
    import torch.distributed as dist

    from mpsnerf_torch.parallel.mesh import initialize_distributed

    if not threads:
        # this host's cores split between the ranks (oversubscribed
        # intra-op pools stall every rank at each collective), at most
        # what OMP_NUM_THREADS allows where the caller's environment sets it
        threads = max(1, (os.cpu_count() or 1) // n)
        if "OMP_NUM_THREADS" in os.environ:
            threads = min(threads, torch.get_num_threads())
    torch.set_num_threads(threads)
    # the ranks share this host: gloo talks over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    initialize_distributed(num_processes=n, process_id=rank, device=device,
                           local_world_size=n, timeout_s=timeout_s,
                           store=store)


def _rank_entry(make, rank, n, port, device, timeout_s, threads, inbox,
                results):
    import torch.distributed as dist

    seq = 0
    try:
        _join_group(rank, n, port, device, timeout_s, threads)
        handler = make(*pickle.loads(inbox.get()))
        results.put((rank, seq, True, None))
        for blob in iter(inbox.get, None):
            seq += 1
            out = handler(pickle.loads(blob))
            # plain pickle: a tensor travels as its bytes, not as a shared
            # file descriptor that ends with this process
            results.put((rank, seq, True, pickle.dumps(out)))
    except BaseException:
        # printed here too: the caller stops every rank on the report,
        # before the process would print it on its way out
        traceback.print_exc()
        sys.stderr.flush()
        results.put((rank, seq, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``n`` long-lived ranks of one group on this host.  Each rank builds
    its handler once, ``handler = make(*args)`` (``make`` importable by
    the ranks), then answers requests until :meth:`close`: rank r calls
    ``handler(message r)``, and :meth:`request` returns the replies in
    rank order.  A rank that raises, exits or outlives a request's
    deadline fails the request: every rank is stopped, the pool is
    closed and :class:`RankFailed` raised.  ``device`` is ``"cpu"`` or
    ``"cuda"`` (each rank takes ``cuda:{rank % device_count}``);
    ``timeout_s`` is each collective's wait; ``threads`` sets each rank's
    torch intra-op threads (default: this host's cores over ``n``, at most
    ``OMP_NUM_THREADS`` where that is set)."""

    def __init__(self, make: Callable, n: int, args: Sequence = (),
                 device: str = "cpu", timeout_s: float = 600.0,
                 threads: Optional[int] = None):
        import multiprocessing

        import torch.distributed as dist

        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self.store = dist.TCPStore(
            "127.0.0.1", 0, None, True,
            datetime.timedelta(seconds=timeout_s), wait_for_workers=False)
        self.results = ctx.Queue()
        # the arguments go through a queue, not the start: a start writes
        # its data into a pipe that the child reads only after its imports
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(
            target=_rank_entry, daemon=True,
            args=(make, r, n, self.store.port, device, timeout_s, threads,
                  self.inboxes[r], self.results)) for r in range(n)]
        for p in self.procs:
            p.start()
        blob = pickle.dumps(tuple(args))
        for q in self.inboxes:
            q.put(blob)
            # messages that a dead rank never takes must not hold this
            # process at its exit
            q.cancel_join_thread()
        self._seq = 0
        self._ready = False
        self.closed = False

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def alive(self) -> bool:
        """Every rank runs and the pool is open."""
        return not self.closed and all(p.is_alive() for p in self.procs)

    def ready(self, deadline_s: Optional[float] = None) -> None:
        """Wait until every rank has built its handler."""
        self._wait_ready(_end(deadline_s), deadline_s)

    def _wait_ready(self, end: float, deadline_s) -> None:
        if not self._ready:
            self._collect(0, end, deadline_s)
            self._ready = True

    def request(self, messages: Sequence,
                deadline_s: Optional[float] = None) -> List[Any]:
        """Hand message r to rank r and return the replies in rank order
        (``deadline_s`` covers the handlers' build too; None: no
        deadline)."""
        if self.closed:
            raise RankFailed("the rank pool is closed")
        if len(messages) != self.n:
            raise ValueError(f"{len(messages)} messages for {self.n} ranks")
        end = _end(deadline_s)
        self._wait_ready(end, deadline_s)
        self._seq += 1
        for q, msg in zip(self.inboxes, messages):
            q.put(pickle.dumps(msg))
        return self._collect(self._seq, end, deadline_s)

    def _fail(self, msg: str):
        self._shut(grace_s=0.0)
        raise RankFailed(msg)

    def _collect(self, seq: int, end: float, deadline_s) -> List[Any]:
        out = {}
        while len(out) < self.n:
            try:
                rank, got, ok, value = self.results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    self._fail(f"rank {dead[0]} exited with code "
                               f"{self.procs[dead[0]].exitcode}")
                if time.monotonic() > end:
                    self._fail(f"ranks {sorted(set(range(self.n)) - set(out))}"
                               f" gave no reply in {deadline_s} s")
                continue
            if not ok:
                # a peer's death fails the others' collectives: name it first
                dead = "".join(
                    f"rank {r} exited with code {p.exitcode}; "
                    for r, p in enumerate(self.procs)
                    if r != rank and p.exitcode is not None)
                self._fail(f"{dead}rank {rank} failed:\n{value}")
            if got == seq:
                out[rank] = None if value is None else pickle.loads(value)
        return [out[r] for r in range(self.n)]

    def _shut(self, grace_s: float) -> None:
        """Ask the ranks to exit (``grace_s`` > 0), then stop those that
        have not within ``grace_s``."""
        if self.closed:
            return
        self.closed = True
        if grace_s > 0:
            for q in self.inboxes:
                q.put(None)
            for p in self.procs:
                p.join(grace_s)
        _stop(self.procs)
        for q in self.inboxes + [self.results]:
            q.close()
        self.store = None

    def close(self) -> None:
        """Ask every rank to leave its group and exit; stop the ranks that
        do not within 10 s."""
        self._shut(grace_s=10.0)


def _end(deadline_s: Optional[float]) -> float:
    return time.monotonic() + (deadline_s or float("inf"))


def _run_once(fn: Callable, *args):
    """A one-shot rank's handler: ``fn(*args)`` runs as the rank starts,
    and the first request returns its value."""
    out = fn(*args)
    return lambda _: out


class Ranks(RankPool):
    """``n`` started ranks, each running ``fn(*args)``; :meth:`wait`
    collects their results."""

    def __init__(self, fn: Callable, n: int, args: Sequence = (),
                 device: str = "cpu", timeout_s: float = 600.0,
                 threads: Optional[int] = None):
        super().__init__(_run_once, n, (fn, *args), device, timeout_s,
                         threads)

    def wait(self, deadline_s: Optional[float] = None) -> List[Any]:
        """The ranks' return values in rank order; the ranks then exit.
        Raises :class:`RankFailed` (after stopping every rank) on a
        failure, on a rank that does not exit cleanly, or when
        ``deadline_s`` (None: no deadline) passes."""
        out = self.request([None] * self.n, deadline_s)
        self._shut(grace_s=60.0)
        for r, p in enumerate(self.procs):
            if p.exitcode != 0:
                raise RankFailed(f"rank {r} exited with code {p.exitcode}")
        return out


def spawn(fn: Callable, n: int, args: Sequence = (), device: str = "cpu",
          timeout_s: float = 600.0, threads: Optional[int] = None,
          deadline_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` ranks of a new group on this host and
    return their results in rank order.  ``fn`` must be importable by the
    ranks (a module-level function); ``device``, ``timeout_s`` and
    ``threads`` as for :class:`RankPool`; ``deadline_s`` is the caller's
    wait for all results."""
    return Ranks(fn, n, args, device, timeout_s, threads).wait(deadline_s)
