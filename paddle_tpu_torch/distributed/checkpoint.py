"""Distributed (sharded) checkpoint save/load, after
``paddle_tpu/distributed/checkpoint.py`` (reference: python/paddle/
distributed/checkpoint/save_state_dict.py:77 / load_state_dict.py:365 /
metadata.py).

The files are the JAX package's: each rank writes one ``.distcp.npz`` of
its tensors, a ``metadata_<rank>.pkl`` (global shape, dtype and each
shard's index window) and a ``manifest_<rank>.json`` of every file's
size and CRC32; ``verify_checkpoint`` rejects a snapshot whose bytes
disagree with its manifests before anything is read. An f32 (or any
numpy-native dtype) snapshot written by either package loads in the
other. A ``bfloat16`` tensor is written as its ``uint16`` bits under the
dtype tag ``bfloat16`` (numpy has no bf16 without ``ml_dtypes``, which
the port does not need), as ``framework/io.py`` writes one; the JAX
package reads such a shard as integers, so a bf16 snapshot crosses from
the port to JAX only through f32. A JAX bf16 shard (an ``ml_dtypes``
array, a 2-byte void to plain numpy) loads in the port.

A process holds the whole of every tensor (no mesh), so each tensor is
one shard. On load the assembled value is copied *into* the target
tensor, on its device and in its dtype: the storage stays the same, so
a captured CUDA graph that reads the parameters and the optimizer's
accumulators sees the restored values (the JAX package rebinds the
array and lets ``jax.device_put`` reshard it).

``async_save=True`` returns an :class:`AsyncSaveHandle`. The
device-to-host copy of the CUDA tensors is queued on a side stream into
pinned host buffers (kept between saves), and the current stream waits
for that copy on the device: the training thread does not block, and the
training stream's next kernels (which overwrite the parameters in place)
start only once the copy has read them. Serialization, CRC, the disk
writes (the native writer pool, ``core/native/ckpt_io.cpp``: fsync and
atomic rename) and the done-callbacks run on the handle's thread.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import zlib

import numpy as np
import torch

from .fault import atomic_write, atomic_write_bytes, maybe_inject

__all__ = ["save_state_dict", "load_state_dict", "verify_checkpoint",
           "AsyncSaveHandle", "CheckpointCorruptError"]


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed integrity validation (torn/missing shard, CRC
    mismatch, or missing rank manifest) — never load it."""


def _crc_of_file(path, chunk=1 << 22):
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _rank_world():
    """(rank, world size) of this process: ``torch.distributed``'s when a
    group is initialized, else (0, 1), as ``jax.process_index()`` /
    ``process_count()`` give them without ``jax.distributed``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def verify_checkpoint(path):
    """Integrity-check a snapshot directory against its CRC manifests.

    Every rank records a ``manifest_<rank>.json`` naming its files with
    size + CRC32 and the world size at save time; completeness = all
    ranks' manifests present AND every listed file matches. Raises
    :class:`CheckpointCorruptError` otherwise (a snapshot with no
    manifests at all is unverifiable and rejected the same way, so
    lineage fallback skips it)."""
    import glob

    manifests = sorted(glob.glob(os.path.join(path, "manifest_*.json")))
    if not manifests:
        raise CheckpointCorruptError(
            f"{path}: no manifest files (uncommitted or pre-manifest "
            "snapshot)")
    world = 1
    files = {}
    for mf in manifests:
        try:
            with open(mf) as f:
                m = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"{mf}: unreadable manifest ({e})")
        world = max(world, int(m.get("world_size", 1)))
        files.update(m.get("files", {}))
    if len(manifests) < world:
        raise CheckpointCorruptError(
            f"{path}: only {len(manifests)}/{world} rank manifests present")
    for fname, rec in files.items():
        fp = os.path.join(path, fname)
        if not os.path.exists(fp):
            raise CheckpointCorruptError(f"{fp}: listed in manifest but "
                                         "missing")
        size = os.path.getsize(fp)
        if size != int(rec["size"]):
            raise CheckpointCorruptError(
                f"{fp}: size {size} != manifest {rec['size']} (torn write)")
        crc = _crc_of_file(fp)
        if crc != int(rec["crc32"]):
            raise CheckpointCorruptError(
                f"{fp}: crc32 {crc:#010x} != manifest "
                f"{int(rec['crc32']):#010x} (corrupt shard)")


# ------------------------------------------------------------ host copies
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def _dtype_name(t):
    return _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))


def _as_numpy(host):
    """A CPU tensor -> the numpy array the shard file holds (a bf16
    tensor as its uint16 bits)."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


class _Pinned:
    """Pinned host buffers for the async save's device-to-host copies,
    kept between saves (pinning 1 GB costs far more than the copy). One
    save uses them at a time; a save that finds them busy pins its own."""

    def __init__(self):
        self.bufs = {}
        self.busy = False
        self.lock = threading.Lock()

    def take(self):
        with self.lock:
            if self.busy:
                return None
            self.busy = True
            return self.bufs

    def give_back(self):
        with self.lock:
            self.busy = False


_PINNED = _Pinned()


def _snapshot_to_host(tensors, async_save):
    """``{key: tensor}`` -> ``({key: host tensor}, release)``. CUDA tensors
    of an async save go through pinned buffers on a side stream (module
    docstring); everything else is a plain ``.cpu()``."""
    cuda = {k: t for k, t in tensors.items() if t.is_cuda}
    # a CPU tensor is serialized later on the handle's thread while the
    # trainer keeps updating it in place: an async save takes a copy
    out = {k: t.detach().clone() if async_save else t.detach()
           for k, t in tensors.items() if not t.is_cuda}
    if not cuda:
        return out, None
    if not async_save:
        for k, t in cuda.items():
            out[k] = t.detach().cpu()
        return out, None
    pool = _PINNED.take()
    bufs = pool if pool is not None else {}
    dev = next(iter(cuda.values())).device
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for k, t in cuda.items():
            host = bufs.get(k)
            if host is None or host.shape != t.shape or \
                    host.dtype != t.dtype:
                host = bufs[k] = torch.empty(t.shape, dtype=t.dtype,
                                             pin_memory=True)
            host.copy_(t.detach(), non_blocking=True)
            out[k] = host
        done = torch.cuda.Event()
        done.record(side)
    # the training stream's next writes to these tensors wait for the copy
    cur.wait_stream(side)

    def release():
        done.synchronize()
        return _PINNED.give_back if pool is not None else None
    return out, release


_SIDE = {}


def _side_stream(dev):
    s = _SIDE.get(dev)
    if s is None:
        s = _SIDE[dev] = torch.cuda.Stream(dev)
    return s


class AsyncSaveHandle:
    """One overlapped async snapshot (``save_state_dict(async_save=True)``).

    The calling (training) thread returns once the device-to-host copies
    are queued — serialization of the npz archive, the per-file CRC32,
    the disk IO, and any registered done-callbacks (the lineage's commit
    barrier + LATEST flip) all run on this handle's completion thread,
    which first waits for the copies. File bytes stream through the
    native writer pool (ckpt_io.AsyncCheckpointWriter) with ONE worker,
    so the FIFO ordering shard → metadata → manifest survives: a kill
    between any two files can never publish a manifest over missing
    shards.

    The manifest (written last, recording each file's intended CRC32 +
    size) is computed from the exact bytes handed to the writer, so
    load-time verification can prove the commit covers the bytes on
    disk. ``wait()`` blocks until everything — including callbacks —
    finished, re-raising any background failure. Chaos: ``torn_write``
    (site ``ckpt``) and ``async_torn`` (site ``async_ckpt``) truncate the
    landed shard while the manifest keeps the intended CRC — exactly a
    writer killed mid-overlap; load-time verification must reject it and
    fall back.
    """

    def __init__(self, path, rank, host, release, shard_file, meta_file,
                 meta_bytes, manifest_fn, fault_kind=None):
        self._done = threading.Event()
        self._error = None
        self._callbacks = []
        self._cb_lock = threading.Lock()
        self.stats = {}
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ckpt-async-{os.path.basename(path)}",
            args=(path, rank, host, release, shard_file, meta_file,
                  meta_bytes, manifest_fn, fault_kind))
        self._thread.start()

    def _run(self, path, rank, host, release, shard_file, meta_file,
             meta_bytes, manifest_fn, fault_kind):
        import io as _io
        import time
        from .ckpt_io import AsyncCheckpointWriter
        writer = None
        give_back = None
        try:
            t0 = time.perf_counter()
            if release is not None:
                give_back = release()   # the device-to-host copies landed
            t1 = time.perf_counter()
            buf = _io.BytesIO()
            np.savez(buf, **{k: _as_numpy(v) for k, v in host.items()})
            if give_back is not None:
                give_back()
                give_back = None
            view = buf.getbuffer()
            # the manifest records the bytes we INTEND to land, so a
            # torn write disagrees with it at load time
            manifest_bytes = manifest_fn(
                zlib.crc32(view) & 0xFFFFFFFF, view.nbytes)
            shard_write = view
            torn = (fault_kind == "torn_write"
                    or maybe_inject("async_ckpt") == "async_torn")
            if torn:
                shard_write = view[:max(1, view.nbytes // 2)]
            t2 = time.perf_counter()
            writer = AsyncCheckpointWriter(n_threads=1)
            writer.submit(os.path.join(path, shard_file), shard_write)
            writer.submit(os.path.join(path, meta_file), meta_bytes)
            writer.submit(os.path.join(path, f"manifest_{rank}.json"),
                          manifest_bytes)
            writer.wait()  # raises if any file failed to land
            t3 = time.perf_counter()
            self.stats = {"bytes": int(view.nbytes), "d2h_wait_s": t1 - t0,
                          "serialize_crc_s": t2 - t1, "write_s": t3 - t2}
            if not torn:
                # a torn overlap models a writer KILLED mid-stream — such
                # a process never reaches its commit, so the callbacks
                # (lineage barrier + LATEST flip) must not run either
                for cb in self._drain_callbacks():
                    cb()
        except BaseException as e:  # surfaced at wait()
            self._error = e
        finally:
            if give_back is not None:
                give_back()
            if writer is not None:
                writer.close()
            self._done.set()

    def _drain_callbacks(self):
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, None
            return cbs

    def add_done_callback(self, cb):
        """Run ``cb()`` on the completion thread once the snapshot is
        durable (inline if it already is). The lineage registers its
        commit here — the barrier overlaps with training too."""
        with self._cb_lock:
            if self._callbacks is not None:
                self._callbacks.append(cb)
                return
        if self._error is None:
            cb()

    def wait(self, timeout=None) -> bool:
        """True once the snapshot is durable and callbacks ran (re-raises
        a background failure); False if ``timeout`` expired first."""
        if not self._done.wait(timeout):
            return False
        if self._error is not None:
            raise self._error
        return True

    def close(self):
        """API-compat with the raw writer handle (resources are released
        by the completion thread itself)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _flatten(d, prefix=""):
    """``{dotted name: (container, key)}`` of every non-dict leaf: the
    dotted names are the JAX package's keys, and the container lets a
    loaded value be put back where a name holds dots of its own (the
    optimizer's ``f"{param name}_{accumulator}"`` keys)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = (d, k)
    return out


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False):
    """Reference: distributed/checkpoint/save_state_dict.py:77.

    ``async_save=True`` returns an :class:`AsyncSaveHandle` (module
    docstring): the training thread only queues the device-to-host
    copies; archive serialization, the CRC AND the disk IO overlap with
    training on the handle's completion thread; ``wait()`` blocks until
    the snapshot is durable and its done-callbacks ran."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state_dict)
    rank, world = _rank_world()
    shard_file = f"{rank}_0.distcp.npz"
    tensors = {}
    # every rank writes its OWN metadata; load merges all metadata files
    metadata = {"state": {}, "files": [shard_file]}
    for name, (container, k) in flat.items():
        value = container[k]
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        elif not isinstance(value, torch.Tensor):
            metadata["state"][name] = {"kind": "py", "value": value}
            continue
        key = f"r{rank}:{name}##0"  # rank prefix: no cross-file clash
        tensors[key] = value
        metadata["state"][name] = {
            "kind": "tensor", "global_shape": list(value.shape),
            "dtype": _dtype_name(value),
            "shards": [{"key": key, "file": shard_file,
                        "index": tuple((0, d) for d in value.shape)}]}
    host, release = _snapshot_to_host(tensors, async_save)
    meta_file = f"metadata_{rank}.pkl"
    meta_bytes = pickle.dumps(metadata, protocol=4)

    # integrity manifest: CRC32 + size of the bytes we INTEND to land; a
    # torn write leaves the disk file disagreeing, which load detects
    def _manifest_bytes(shard_crc, shard_size):
        manifest = {
            "version": 1, "rank": rank, "world_size": world,
            "files": {
                shard_file: {"crc32": shard_crc, "size": shard_size},
                meta_file: {"crc32": zlib.crc32(meta_bytes) & 0xFFFFFFFF,
                            "size": len(meta_bytes)},
            },
        }
        return json.dumps(manifest, indent=1).encode()

    shard_path = os.path.join(path, shard_file)
    fault_kind = maybe_inject("ckpt")
    if async_save:
        return AsyncSaveHandle(path, rank, host, release, shard_file,
                               meta_file, meta_bytes, _manifest_bytes,
                               fault_kind)
    shards = {k: _as_numpy(v) for k, v in host.items()}
    if fault_kind == "torn_write":
        # chaos harness: a torn write must know the INTENDED crc of bytes
        # it deliberately truncates, so serialize in memory, then land a
        # truncated shard at the FINAL path (models a non-atomic writer
        # killed mid-stream); load-time validation must catch the
        # manifest disagreement
        import io as _io
        buf = _io.BytesIO()
        np.savez(buf, **shards)
        shard_view = buf.getbuffer()
        manifest_bytes = _manifest_bytes(
            zlib.crc32(shard_view) & 0xFFFFFFFF, shard_view.nbytes)
        shard_write = shard_view[:max(1, shard_view.nbytes // 2)]
        with open(shard_path, "wb") as f:
            f.write(shard_write)
            f.flush()
            os.fsync(f.fileno())
    else:
        # the sync path streams the archive straight into the atomic temp
        # file, then CRCs the landed bytes for the manifest
        atomic_write(shard_path, lambda f: np.savez(f, **shards))
        manifest_bytes = _manifest_bytes(_crc_of_file(shard_path),
                                         os.path.getsize(shard_path))
    atomic_write_bytes(os.path.join(path, meta_file), meta_bytes)
    atomic_write_bytes(os.path.join(path, f"manifest_{rank}.json"),
                       manifest_bytes)
    return None


def _to_torch(arr, dtype_name):
    """A stored shard -> a CPU tensor of the entry's dtype."""
    if dtype_name == "bfloat16":
        if arr.dtype.kind == "V" or arr.dtype == np.uint16:
            # the port's uint16 bits, or JAX's ml_dtypes array (a 2-byte
            # void without ml_dtypes)
            bits = np.ascontiguousarray(arr).view(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(arr))


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, _verified=False):
    """Reference: distributed/checkpoint/load_state_dict.py:365. Fills the
    given state_dict in place: a tensor target is copied into (its device,
    dtype and storage kept), any other leaf is replaced."""
    import glob

    # integrity gate: if CRC manifests exist, a corrupted/torn shard must
    # be detected BEFORE any bytes are deserialized (never load it);
    # manifest-less snapshots load as-is. _verified: the caller
    # (CheckpointLineage.load_latest) already ran verify_checkpoint on
    # this directory — don't re-read every shard
    if not _verified and glob.glob(os.path.join(path, "manifest_*.json")):
        verify_checkpoint(path)

    # merge every rank's metadata (multi-host saves write one per rank)
    metadata = {"state": {}, "files": []}
    meta_files = sorted(glob.glob(os.path.join(path, "metadata_*.pkl")))
    if not meta_files:  # single-file layout
        meta_files = [os.path.join(path, "metadata.pkl")]
    for mf in meta_files:
        with open(mf, "rb") as f:
            md = pickle.load(f)
        metadata["files"].extend(md["files"])
        for name, entry in md["state"].items():
            if name not in metadata["state"] or entry["kind"] == "py":
                metadata["state"][name] = entry
            else:
                metadata["state"][name]["shards"].extend(entry["shards"])
    shard_data = {}
    for fname in metadata["files"]:
        fpath = os.path.join(path, fname)
        if os.path.exists(fpath):
            with np.load(fpath) as z:
                shard_data.update({k: z[k] for k in z.files})

    for name, (container, k) in _flatten(state_dict).items():
        target = container[k]
        entry = metadata["state"].get(name)
        if entry is None:
            raise KeyError(f"checkpoint at {path} has no entry for '{name}'")
        if entry["kind"] == "py":
            container[k] = entry["value"]
            continue
        dt = entry["dtype"]
        value = torch.zeros(entry["global_shape"], dtype=torch.bfloat16
                            if dt == "bfloat16" else
                            torch.from_numpy(np.zeros(0, dt)).dtype)
        for shard in entry["shards"]:
            if shard["key"] not in shard_data:
                raise FileNotFoundError(
                    f"checkpoint shard {shard['key']} (file "
                    f"{shard.get('file')}) is missing from {path}; "
                    "copy every rank's shard files before loading")
            arr = _to_torch(shard_data[shard["key"]], dt)
            if shard["index"]:
                window = tuple(slice(lo, hi) for lo, hi in shard["index"])
                value[window] = arr
            else:
                value[()] = arr
        if isinstance(target, torch.Tensor):
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(
                    f"checkpoint entry '{name}' has shape "
                    f"{list(value.shape)} but the target has "
                    f"{list(target.shape)}")
            with torch.no_grad():
                target.copy_(value)
        elif isinstance(target, np.ndarray):
            container[k] = value.float().numpy() if value.dtype == \
                torch.bfloat16 else value.numpy()
        elif isinstance(target, (int, float, bool)):
            container[k] = type(target)(value.item())
        else:
            container[k] = value
    return state_dict
