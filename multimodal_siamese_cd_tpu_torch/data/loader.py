"""Batch loading with worker prefetch and staging onto the card (the JAX
package's ``data/loader.py``).

* Workers build whole batches ahead of the consumer: threads by default
  (the per-sample work is numpy slicing out of the memmapped scene cache,
  which releases the GIL), or processes (``DATALOADER.WORKER_TYPE
  process``), which sidestep the GIL at the cost of pickling each batch
  back.
* Randomness is independent of the worker schedule: the epoch's shuffle
  and each batch's crop draws come from ``np.random.SeedSequence([seed,
  epoch])`` and ``SeedSequence([seed, epoch, batch])`` spawns, the JAX
  package's schedule, so one seed gives both packages, and both worker
  types, the same batches.
* In a world of several ranks each rank assembles only its rows of every
  global batch (``rows``, :func:`..parallel.batch_rows`; on a
  ``TRAINER.SPATIAL_SHARDS`` grid its data column's rows, the same on
  every space rank of the column): the batch's ``SeedSequence`` spawns one
  child per row of the global batch and the rank keeps its rows'
  children, so its rows are exactly the global batch's.
* :func:`prefetch_to_device` copies each batch through pinned host memory
  with ``non_blocking=True`` on a side stream, and the consumer's stream
  waits on an event recorded after the copy; a super-batch of
  :func:`group_batches` (``TRAINER.STEPS_PER_EXECUTION``) moves the same
  way, one upload per window.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import tracing

# the arrays prefetch_to_device moves, and how many staged batches may wait
_DEVICE_KEYS = ("stack", "is_labeled")
_PREFETCH_DEPTH = 2
# batches a worker pool builds ahead of the consumer, beyond one per thread
_LOOKAHEAD = 4


def collate(items: list[dict]) -> dict:
    """The per-sample metadata of a batch: ``is_labeled`` becomes a float32
    mask vector, numeric scalars arrays, the rest lists. The ``stack`` key
    is skipped: the samples were assembled into the batch array in place."""
    batch: dict = {}
    for key in items[0]:
        if key == "stack":
            continue
        vals = [it[key] for it in items]
        if key == "is_labeled":
            batch[key] = np.asarray(vals, np.float32)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


def _assemble_batch(dataset, seed: int, epoch: int, batch_idx: int,
                    indices, rows=None) -> dict:
    """One collated batch, deterministic per (seed, epoch, batch): the
    training dataset's samples are assembled straight into one ``(B, C, S,
    S)`` buffer of its ``stack_spec()``. ``rows``: only these rows of the
    batch ``indices`` describes, each with its own draws."""
    with tracing.span("loader.assemble", (epoch, batch_idx)):
        children = np.random.SeedSequence([seed, epoch, batch_idx]).spawn(len(indices))
        if rows is not None:
            indices = [indices[r] for r in rows]
            children = [children[r] for r in rows]
        rngs = [np.random.default_rng(c) for c in children]
        shape, dtype = dataset.stack_spec()
        stack = np.empty((len(indices),) + tuple(shape), dtype)
        items = [_assemble_item(dataset, int(i), rng, stack[k])
                 for k, (i, rng) in enumerate(zip(indices, rngs))]
        batch = collate(items)
        batch["stack"] = stack
        return batch


def _assemble_item(dataset, index: int, rng, out) -> dict:
    """One sample assembled into ``out``; an unlabeled one (the dataset's
    ``labeled`` flags, where it has them) inside a span of its own."""
    labeled = getattr(dataset, "labeled", None)
    if labeled is None or labeled[index]:
        return dataset.get(index, rng, out=out)
    with tracing.span("loader.assemble_unlabeled"):
        return dataset.get(index, rng, out=out)


# the dataset of a process worker, installed once by the pool's initializer
_WORKER_STATE: dict = {}


def _init_worker(dataset, seed: int, rows) -> None:
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["seed"] = seed
    _WORKER_STATE["rows"] = rows


def _assemble_in_worker(epoch: int, batch_idx: int, indices) -> dict:
    return _assemble_batch(_WORKER_STATE["dataset"], _WORKER_STATE["seed"],
                           epoch, batch_idx, indices, _WORKER_STATE["rows"])


class TrainLoader:
    """Epoch iterator over a training dataset, yielding collated numpy
    batches: the reference trainer's DataLoader contract (``shuffle`` per
    epoch, ``drop_last=True``, ``len()`` = full batches per epoch).
    ``num_workers=0`` builds batches in the caller's thread (the DEBUG
    path).

    ``worker_type="process"`` builds them in a pool of processes that lives
    until :meth:`close`: started by ``forkserver`` (``spawn`` where that is
    missing), never ``fork``, because torch's and CUDA's threads are live
    by then; each worker receives the dataset once, from the pool's
    initializer. A pool that fails to start raises when its first batch is
    read; there is no fall-back to threads.

    ``rows`` (a rank's :func:`..parallel.batch_rows` of ``batch_size``)
    makes every batch those rows of the global batch alone; ``len()`` still
    counts global batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0,
                 worker_type: str = "thread", rows=None):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be thread|process, got {worker_type!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = min(max(0, int(num_workers)), os.cpu_count() or 1)
        self.seed = seed
        self.worker_type = worker_type
        self.rows = None if rows is None else [int(r) for r in rows]
        self._epoch = 0
        self._processes = None

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch counter that seeds the next epoch's shuffle and
        crops. A resumed run passes the number of epochs already trained,
        so the data schedule continues where the unbroken run would be."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _batch_indices(self, epoch: int) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        return [order[i:i + self.batch_size]
                for i in range(0, len(self) * self.batch_size, self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        epoch = self._epoch
        self._epoch += 1
        batches = self._batch_indices(epoch)
        if self.num_workers == 0:
            for b, idxs in enumerate(batches):
                yield _assemble_batch(self.dataset, self.seed, epoch, b, idxs,
                                      self.rows)
            return

        # the epoch's start: the pool and the first batch; closed before
        # that batch is yielded
        start = tracing.span("loader.epoch_start", (epoch, 0))
        start.__enter__()
        started = True
        futures, pool = [], None
        try:
            if self.worker_type == "thread":
                pool = ThreadPoolExecutor(max_workers=self.num_workers)

                def submit(b):
                    return pool.submit(_assemble_batch, self.dataset, self.seed,
                                       epoch, b, batches[b], self.rows)
            else:
                pool = self._process_pool()

                def submit(b):
                    return pool.submit(_assemble_in_worker, epoch, b, batches[b])

            window = self.num_workers + _LOOKAHEAD
            for b in range(min(window, len(batches))):
                futures.append(submit(b))
            for done in range(len(batches)):
                with tracing.span("loader.wait", (epoch, done)):
                    batch = futures[done].result()
                # a Future keeps its result: drop it so the epoch's batches
                # are not all pinned in memory
                futures[done] = None
                if len(futures) < len(batches):
                    futures.append(submit(len(futures)))
                if started:
                    started = False
                    start.__exit__(None, None, None)
                yield batch
        finally:
            if started:
                start.__exit__(None, None, None)
            # an abandoned epoch (exception, DEBUG break) leaves no queued
            # batch builds running; the process pool itself lives on
            if self.worker_type == "thread" and pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            else:
                for f in futures:
                    if f is not None:
                        f.cancel()

    def _process_pool(self) -> ProcessPoolExecutor:
        if self._processes is None:
            methods = multiprocessing.get_all_start_methods()
            ctx = multiprocessing.get_context(
                "forkserver" if "forkserver" in methods else "spawn")
            self._processes = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_init_worker,
                initargs=(self.dataset, self.seed, self.rows))
        return self._processes

    def close(self) -> None:
        """Stop the process pool's workers (nothing to do for threads)."""
        if self._processes is not None:
            self._processes.shutdown(wait=True, cancel_futures=True)
            self._processes = None


def group_batches(iterator: Iterable[dict], k: int) -> Iterator[dict]:
    """Stack consecutive batches into ``(k, B, ...)`` super-batches for
    multi-step execution (:func:`..train_lib.make_scanned_train_step`; the
    JAX package's ``group_batches``). Array keys gain a leading axis;
    metadata keys become lists. A trailing partial group is dropped (the
    trainer's execution plan checks divisibility up front)."""
    buf: list[dict] = []
    groups = 0
    for batch in iterator:
        buf.append(batch)
        if len(buf) < k:
            continue
        with tracing.span("loader.group", groups):
            out: dict = {}
            for key in buf[0]:
                vals = [b[key] for b in buf]
                out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        buf = []
        groups += 1
        yield out


def prefetch_to_device(iterator: Iterable[dict], device):
    """Stage upcoming batches on ``device`` ahead of consumption.

    On the card a background thread pulls from ``iterator``, copies the
    batch arrays into pinned host memory and from there to the card with
    ``non_blocking=True`` on a side stream, and records an event; the
    consumer's current stream waits on that event before the batch is
    yielded (and the tensors are recorded on that stream, so the caching
    allocator never hands their memory out early). At most
    ``_PREFETCH_DEPTH`` staged batches wait in the queue. On the CPU the
    arrays become tensors in the caller's thread."""
    keys = _DEVICE_KEYS
    device = torch.device(device)
    if device.type != "cuda":
        source, end, pulled = iter(iterator), object(), 0
        while True:
            tracing.follow_profiler()
            # the pull builds the batch in this thread
            with tracing.span("feed.wait", pulled):
                batch = next(source, end)
            if batch is end:
                return
            pulled += 1
            yield {k: torch.from_numpy(v) if k in keys and isinstance(v, np.ndarray)
                   else v for k, v in batch.items()}

    copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=_PREFETCH_DEPTH)
    end = object()
    error: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                for staged_count, batch in enumerate(iterator):
                    with tracing.span("feed.stage", staged_count):
                        staged = {k: torch.from_numpy(v).pin_memory().to(
                                      device, non_blocking=True)
                                  if k in keys and isinstance(v, np.ndarray) else v
                                  for k, v in batch.items()}
                        event = torch.cuda.Event()
                        event.record(copy_stream)
                    if not put((staged, event)):
                        return
        except BaseException as e:  # surfaced in the consumer
            error.append(e)
        finally:
            put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        consumer = torch.cuda.current_stream(device)
        pulled = 0
        while True:
            tracing.follow_profiler()
            # until a staged batch arrives
            with tracing.span("feed.wait", pulled):
                item = q.get()
            pulled += 1
            if item is end:
                if error:
                    raise error[0]
                return
            staged, event = item
            consumer.wait_event(event)
            for v in staged.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            yield staged
    finally:
        # the consumer stopped early (DEBUG break, an exception): stop the
        # producer instead of letting it stage the rest of the epoch
        stop.set()
        thread.join(timeout=60)
