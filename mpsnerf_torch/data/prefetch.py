"""Background-thread item prefetching (port of
``mpsnerf_tpu/data/prefetch.py``): a small thread pool keeps a queue of
ready items ahead of the train step, so that image reads, undistortion and
ray sampling on the host overlap the device's work.

Determinism: indices are drawn from a seeded sampler under a lock and
tagged with sequence numbers, and the consumer reorders finished items by
sequence, so two runs with one seed consume the same item stream whatever
the threads' races.  The default sampler is ``DistributedSampler`` with
``set_epoch``: every epoch a permutation seeded by (seed, epoch), the same
on every process, sliced ``process_index::process_count``.  The process
index and count default to ``torch.distributed``'s rank and world size
when a group is initialised, else 0 and 1.
"""

from __future__ import annotations

import heapq
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


def _process_slot():
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except ImportError:
        pass
    return 0, 1


class PrefetchLoader:
    """Iterates ``dataset[i]`` for sampled indices with lookahead.

    Args:
      dataset: anything with ``__len__`` and ``__getitem__``.
      sampler: callable rng -> index; defaults to the distributed sampler.
      num_workers: producer threads (0 = synchronous passthrough).
      prefetch: queue depth.
    """

    def __init__(
        self,
        dataset,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 4,
        sampler: Optional[Callable] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        if process_index is None or process_count is None:
            process_index, process_count = _process_slot()
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        self._epoch = 0
        self._epoch_indices: list = []
        self.sampler = sampler or self._distributed_sampler
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self._seq = 0
        self._next_out = 0
        self._reorder: list = []  # heap of (seq, item)
        self._threads = []
        for _ in range(num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _distributed_sampler(self, rng) -> int:
        """Next index of this process's slice of the epoch's permutation
        (called under ``_index_lock``)."""
        if not self._epoch_indices:
            g = np.random.default_rng((self.seed, self._epoch))
            perm = g.permutation(len(self.dataset))
            sliced = perm[self.process_index::self.process_count]
            if len(sliced) == 0:  # more processes than items
                sliced = perm
            self._epoch_indices = list(sliced[::-1])  # pop() from the front
            self._epoch += 1
        return int(self._epoch_indices.pop())

    def _draw(self):
        with self._index_lock:
            seq = self._seq
            self._seq += 1
            return seq, self.sampler(self.rng)

    def _worker(self) -> None:
        while not self._stop.is_set():
            seq, idx = self._draw()
            try:
                item = self.dataset[idx]
            except Exception as e:  # raised on the consumer's side
                item = e
            while not self._stop.is_set():
                try:
                    self._queue.put((seq, item), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self.num_workers == 0:
            return self.dataset[self._draw()[1]]
        while True:  # deliver strictly in sequence order
            if self._reorder and self._reorder[0][0] == self._next_out:
                _, item = heapq.heappop(self._reorder)
                self._next_out += 1
                if isinstance(item, Exception):
                    raise item
                return item
            seq, item = self._queue.get()
            heapq.heappush(self._reorder, (seq, item))  # seqs are unique

    def close(self) -> None:
        self._stop.set()
