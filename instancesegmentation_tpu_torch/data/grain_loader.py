"""Worker-process training loader: the port of the JAX package's grain
loader (``instancesegmentation_tpu/data/grain_loader.py``), built on
``torch.utils.data.DataLoader`` (the card's machine has no grain).

Its contract is JAX's (``grain_loader.py`` and ``train/loop.py``'s
``--loader grain`` branch):

- the train stream only (validation stays on ``batch_iterator``), and an
  incomplete tail batch is always dropped;
- ``num_workers=0`` decodes in the process, with ``read_threads`` threads
  (``batch_iterator``); ``num_workers > 0`` decodes in that many worker
  processes;
- under multi-process data parallelism (``shard_by_process``) each process
  takes grain's ``even_split`` range of the records with the remainder
  dropped, ``[p * (n // P), (p + 1) * (n // P))``, and ``batch_size`` is the
  per-process batch;
- the order of an epoch comes from its seed.  grain's shuffle cannot be
  matched (as jax.random cannot), so the order is ``batch_iterator``'s: one
  ``np.random.default_rng(seed)`` shuffles the records once per epoch.  In
  one process the batches equal ``batch_iterator(drop_last=True)``'s.

Design, for a trainer whose step runs on the card:

- workers start from a ``forkserver`` (never ``fork``: CUDA and the
  prefetch threads are up by then, and a forked child would inherit locks
  that other threads hold); the server preloads torch and this package, so
  a worker starts by a fork of a process that never touched CUDA;
- ``GrainLoader`` starts its pool once and keeps it across epochs
  (persistent workers): each epoch hands it that epoch's order.  After a
  pass at seed ``s`` the workers go on into the pass at ``s + 1`` (the
  trainer's next epoch), so its first batches are decoded while the
  trainer finishes the epoch; a call for another pass discards them;
- each batch is split into one contiguous chunk per worker, so that all
  workers decode every batch and an epoch's first batch waits for one
  chunk, not for one worker decoding a whole batch (an epoch of the
  trainer from disk is 4 batches); in order, the chunks of a batch are
  joined in the consumer by one copy, into pinned memory when the batch
  goes to the card (``pin_memory``);
- a worker stacks its chunk; its images and masks cross to the trainer
  as CPU tensors in shared memory, not through a pipe (``SHARED_KEYS``),
  the small arrays pickled with the chunk; a thread of the consumer's
  process receives the chunks and joins the batches (``device_prefetch``
  takes them), so that the thread which drives the card does neither;
- an exception in a worker is raised in the consumer; ``close`` (and an
  abandoned ``grain_batch_iterator``) stops every worker;
- the fork server and multiprocessing's resource tracker outlive a
  program that just ends (the server takes a while to unload torch), so
  ``stop_fork_server`` stops both and waits for them; it runs at exit in
  every process that started a pool.
"""
from __future__ import annotations

import atexit
import multiprocessing
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from instancesegmentation_tpu_torch.data.pipeline import batch_iterator, host_batch

#: how worker processes are started
START_METHOD = "forkserver"
#: modules the fork server imports once, before any worker forks from it
_PRELOAD = ("torch", "instancesegmentation_tpu_torch.data.grain_loader")


def shard_records(n: int, proc_id: int, proc_count: int) -> np.ndarray:
    """The records of process ``proc_id`` of ``proc_count``: grain's
    ``even_split`` with ``drop_remainder=True``."""
    per = n // proc_count
    return np.arange(proc_id * per, (proc_id + 1) * per)


def epoch_batches(records: np.ndarray, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True) -> list[list[int]]:
    """One epoch's full batches of ``records``, in ``batch_iterator``'s
    order: ``rng`` shuffles a copy once, the tail is dropped."""
    order = np.array(records)
    if shuffle:
        rng.shuffle(order)
    return [order[i:i + batch_size].tolist()
            for i in range(0, len(order) - batch_size + 1, batch_size)]


class _Samples(Dataset):
    """The dataset's samples, fetched in a worker."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        return self.dataset.fetch(int(index))


class _Chunks:
    """Batch sampler of the DataLoader: the chunks of the coming pass,
    drawn lazily (an endless pass is an endless generator)."""

    def __init__(self):
        self.chunks: Iterable[list[int]] = ()

    def __iter__(self):
        return iter(self.chunks)


#: the batch arrays that cross in shared memory (one file descriptor
#: each); the small ones travel pickled with their chunk
SHARED_KEYS = ("image", "mask")


def collate(samples: list) -> dict:
    """``host_batch`` of the samples, stacked in the worker: images and
    masks as CPU tensors (the DataLoader hands them over in shared memory),
    the rest as numpy arrays."""
    return {k: torch.from_numpy(v) if k in SHARED_KEYS else v
            for k, v in host_batch(samples).items()}


def stop_fork_server() -> None:
    """Stop this process's fork server and resource tracker, if they run,
    and wait until both have exited.  Close every pool first: the tracker
    ends when the last worker has.  A later pool starts them again."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _context():
    ctx = multiprocessing.get_context(START_METHOD)
    ctx.set_forkserver_preload(list(_PRELOAD))
    atexit.unregister(stop_fork_server)  # registered once
    atexit.register(stop_fork_server)
    return ctx


class GrainLoader:
    """A pool of ``num_workers`` decoding processes over ``dataset``, started
    at the first pass and kept until ``close``; ``batches(seed)`` streams
    passes in the order above.  ``num_workers=0`` holds no pool.
    ``pin_memory``: join each batch's chunks into page-locked memory (for
    ``non_blocking`` copies to a card)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 0,
                 shard_by_process: bool = False, read_threads: int = 8,
                 process: tuple[int, int] = (0, 1), pin_memory: bool = False):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.read_threads = read_threads
        self.pin_memory = pin_memory
        n = len(dataset)
        self.records = shard_records(n, *process) if shard_by_process else np.arange(n)
        #: chunks per batch: one per worker (fewer when the batch is smaller)
        self.parts = max(1, min(num_workers, batch_size))
        self._order = _Chunks()
        self._loader: Optional[DataLoader] = None
        self._stream: Optional[Iterator] = None  # the running pass's chunks
        self._ahead: Optional[tuple] = None  # (seed, shuffle) it delivers next

    def _pool(self) -> DataLoader:
        if self._loader is None:
            self._loader = DataLoader(
                _Samples(self.dataset), batch_sampler=self._order, collate_fn=collate,
                num_workers=self.num_workers, multiprocessing_context=_context(),
                persistent_workers=True, prefetch_factor=2)
        return self._loader

    def batches(self, seed: int, shuffle: bool = True, epochs: Optional[int] = 1) -> Iterator[dict]:
        """Host batch dicts of ``epochs`` passes (None: forever): numpy
        arrays without workers; from them, images and masks as CPU tensors
        and the small arrays as numpy."""
        if self.num_workers == 0:
            yield from batch_iterator(self.dataset, self.batch_size, shuffle=shuffle, seed=seed,
                                      epochs=epochs, drop_last=True,
                                      num_threads=self.read_threads, records=self.records)
            return
        if epochs != 1 or self._ahead != (seed, shuffle):
            self._order.chunks = self._chunks(seed, shuffle, epochs)
            self._stream = iter(self._pool())
        self._ahead = None
        total = None if epochs is None else len(self.records) // self.batch_size * epochs
        ready: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        failure: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def receive():
            # the chunks are received and joined here, beside the consumer,
            # whose thread drives the card
            try:
                n = 0
                while (total is None or n < total) and put(
                        self._join([next(self._stream) for _ in range(self.parts)])):
                    n += 1
            except BaseException as e:  # handed to the consumer, which raises it
                failure.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=receive, daemon=True)
        thread.start()
        done = 0
        try:
            while (item := ready.get()) is not None:
                yield item
                done += 1
            if failure:
                raise failure[0]
        finally:
            stop.set()
            thread.join()
        if done == total:
            self._ahead = (seed + epochs, shuffle)

    def _chunks(self, seed: int, shuffle: bool, epochs: Optional[int]) -> Iterator[list]:
        """The chunks of ``epochs`` passes from one generator seeded with
        ``seed``, then of one pass at each seed after (read ahead)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while True:
            if epochs is not None and epoch >= epochs:
                rng = np.random.default_rng(seed + epoch)
            for batch in epoch_batches(self.records, self.batch_size, rng, shuffle):
                yield from (part.tolist() for part in np.array_split(batch, self.parts))
            epoch += 1

    def _join(self, chunks: list) -> dict:
        """One batch dict from its chunks, in order: one copy per key."""
        if len(chunks) == 1 and not self.pin_memory:
            return chunks[0]
        out = {}
        for key, first in chunks[0].items():
            parts = [c[key] for c in chunks]
            if not isinstance(first, torch.Tensor):
                out[key] = np.concatenate(parts)
                continue
            rows = sum(p.shape[0] for p in parts)
            out[key] = torch.cat(parts, out=torch.empty(
                (rows, *first.shape[1:]), dtype=first.dtype, pin_memory=self.pin_memory))
        return out

    def close(self) -> None:
        """Stop the worker processes (if any)."""
        if self._loader is not None and self._loader._iterator is not None:
            self._loader._iterator._shutdown_workers()
        self._loader = self._stream = self._ahead = None


def grain_batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = 1,
    num_workers: int = 0,
    shard_by_process: bool = False,
    read_threads: int = 8,
) -> Iterator[dict]:
    """Yield host batch dicts through a pool of its own (the JAX function's
    arguments): ``num_workers`` processes, or none; ``epochs=None`` streams
    forever; with ``shard_by_process`` this process's shard, ``batch_size``
    per process.  The pool stops when the iterator ends or is dropped."""
    from instancesegmentation_tpu_torch.parallel import multihost

    process = multihost.process_info() if shard_by_process else (0, 1)
    loader = GrainLoader(dataset, batch_size, num_workers, shard_by_process, read_threads,
                         process)
    try:
        yield from loader.batches(seed, shuffle, epochs)
    finally:
        loader.close()
