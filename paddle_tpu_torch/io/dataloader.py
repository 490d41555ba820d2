"""DataLoader, after ``paddle_tpu/io/dataloader.py`` (reference:
python/paddle/io/reader.py:216 DataLoader, io/dataloader/dataloader_iter.py
multiprocess workers).

Workers are host-side numpy pipelines (``multiprocessing`` with fork):
batches collate to numpy in the worker (``_np_collate``) and become torch
tensors only in the main process, so no forked child touches CUDA, and
none runs a torch op, which can hang on the OpenMP pool it inherits from
the parent. A :class:`TensorDataset` is snapshotted to host numpy before
the fork for that reason. Ordered reassembly with a bounded prefetch
window replaces the reference's C++ BlockingQueue; the in-process
buffered reader (``use_buffer_reader=True``) feeds the port's copy of the
native queue from a thread.

Batches land on the loader's device, ``places`` through
:func:`~..device.resolve_device`: ``cuda`` unless the CPU is asked for.
A host batch bound for the card is pinned and copied with
``non_blocking=True``, so the copy does not hold up the host.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import queue as queue_mod
import threading

import numpy as np
import torch

from ..device import resolve_device
from .dataset import Dataset, IterableDataset, TensorDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info"]


def default_collate_fn(batch):
    """Stack samples into batch tensors on the host (reference:
    io/dataloader/collate.py default_collate_fn); the loader moves them to
    its device."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(col))
                            for col in transposed)
    raise TypeError(f"cannot collate batch of {type(sample)}")


def _np_collate(batch):
    """Worker-side collate: like default_collate_fn but stays numpy."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _np_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(_np_collate(list(col)) for col in zip(*batch))
    return batch


def _place(obj, device):
    """numpy arrays and host tensors -> tensors on ``device``; a host
    tensor bound for the card goes through pinned memory, copied without
    blocking the host."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        if device.type == "cuda" and obj.device.type == "cpu":
            return obj.pin_memory().to(device, non_blocking=True)
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _place(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_place(v, device) for v in obj)
    return obj


class _NumpyTensorDataset(Dataset):
    """Fork-safe twin of TensorDataset for multiprocess workers: indexes
    HOST numpy snapshots taken once in the parent, so a worker never runs
    a torch op (a CUDA tensor cannot be touched in a forked child, and a
    CPU op there can hang on the parent's OpenMP pool)."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return self.arrays[0].shape[0]


def _worker_loop(dataset, index_queue, data_queue, collate_fn,
                 worker_init_fn=None, worker_id=0):
    """Reference: io/dataloader/worker.py _worker_loop."""
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            samples = [dataset[i] for i in indices]
            batch = collate_fn(samples)
            data_queue.put((seq, batch, None))
        except Exception as e:  # propagate worker errors to the main process
            data_queue.put((seq, None, f"{type(e).__name__}: {e}"))


class _MultiprocessIter:
    def __init__(self, loader):
        self.loader = loader
        ctx = mp.get_context("fork")
        self.index_queue = ctx.Queue()
        self.data_queue = ctx.Queue()
        collate = loader._worker_collate
        dataset = loader.dataset
        if type(dataset) is TensorDataset:
            # snapshot the tensors to host numpy BEFORE forking so the
            # workers' __getitem__ runs no torch op. Exact-type check: a
            # SUBCLASS may override __getitem__ (transforms, label
            # mapping) and must keep its own behavior — it is then
            # responsible for staying torch-free in workers.
            dataset = _NumpyTensorDataset(
                [t.detach().cpu().numpy() for t in dataset.tensors])
        # paddle semantics: timeout=0 waits indefinitely
        self.timeout = loader.timeout if loader.timeout else None
        self.workers = []
        for wid in range(loader.num_workers):
            w = ctx.Process(target=_worker_loop,
                            args=(dataset, self.index_queue,
                                  self.data_queue, collate,
                                  loader.worker_init_fn, wid))
            w.daemon = True
            w.start()
            self.workers.append(w)
        self.batches = iter(loader.batch_sampler)
        self.send_seq = 0
        self.recv_seq = 0
        self.reorder = {}
        self.outstanding = 0
        # prefill the pipeline
        prefetch = loader.prefetch_factor * loader.num_workers
        for _ in range(prefetch):
            self._dispatch()

    def _dispatch(self):
        try:
            indices = next(self.batches)
        except StopIteration:
            return
        self.index_queue.put((self.send_seq, indices))
        self.send_seq += 1
        self.outstanding += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self.outstanding == 0:
            self._shutdown()
            raise StopIteration
        waited = 0.0
        while self.recv_seq not in self.reorder:
            # poll in short slices so dead workers are detected even with
            # timeout=0 (wait forever) semantics
            slice_t = 5.0 if self.timeout is None else min(5.0, self.timeout)
            try:
                seq, batch, err = self.data_queue.get(timeout=slice_t)
            except queue_mod.Empty:
                dead = [w for w in self.workers
                        if not w.is_alive() and w.exitcode not in (0, None)]
                if dead:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker died (exitcode "
                        f"{dead[0].exitcode}) before producing its batch")
                waited += slice_t
                if self.timeout is not None and waited >= self.timeout:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker timed out after {self.timeout}s "
                        "(set DataLoader(timeout=...) to wait longer, or 0 "
                        "to wait forever)") from None
                continue
            self.reorder[seq] = (batch, err)
        batch, err = self.reorder.pop(self.recv_seq)
        self.recv_seq += 1
        self.outstanding -= 1
        self._dispatch()
        if err is not None:
            self._shutdown()
            raise RuntimeError(f"DataLoader worker failed: {err}")
        return _place(batch, self.loader.device)

    def _shutdown(self):
        for _ in self.workers:
            try:
                self.index_queue.put(None)
            except Exception:
                pass
        for w in self.workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
        self.workers = []

    def __del__(self):
        self._shutdown()


class DataLoader:
    """Reference: python/paddle/io/reader.py:216. ``places`` (a device or
    a list whose first entry is taken) is where batches land: ``cuda``
    unless the CPU is asked for."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = resolve_device(places)
        self.dataset = dataset
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_buffer_reader = use_buffer_reader
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.collate_fn = collate_fn or default_collate_fn
        self._worker_collate = collate_fn or _np_collate
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset=dataset,
                                              shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_stream()
        if self.num_workers > 0:
            return _MultiprocessIter(self)
        if self.use_buffer_reader:
            return self._iter_buffered()
        return self._iter_single()

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield _place(self.collate_fn([self.dataset[i] for i in indices]),
                         self.device)

    def _iter_buffered(self):
        """use_buffer_reader=True (reference default): a feeder thread
        collates ahead into the native C++ BlockingQueue
        (core/native/blocking_queue.cpp — the lod_tensor_blocking_queue.h
        capability) so host data prep overlaps device compute."""
        from .blocking_queue import NativeBlockingQueue
        q = NativeBlockingQueue(capacity=max(int(self.prefetch_factor), 1))
        err: list = []

        def feeder():
            try:
                for indices in self.batch_sampler:
                    q.push(self._worker_collate(
                        [self.dataset[i] for i in indices]))
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.close()

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            while True:
                try:
                    batch = q.pop()
                except StopIteration:
                    break
                yield _place(batch, self.device)
            if err:
                raise RuntimeError(
                    f"DataLoader buffered reader failed: {err[0]}") \
                    from err[0]
        finally:
            q.close()
            th.join(timeout=5)

    def _iter_stream(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch or (self.drop_last and len(batch) < self.batch_size):
                return
            yield _place(self.collate_fn(batch), self.device)


class WorkerInfo:
    """Reference: io/dataloader/worker.py get_worker_info."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Returns the active worker's info inside a DataLoader worker, else
    None (reference semantics; the in-process loader path returns None)."""
    return _worker_info
