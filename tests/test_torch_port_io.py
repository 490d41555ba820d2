"""The port's ``io`` against ``paddle_tpu.io`` on the CPU.

Datasets, ``random_split`` and every sampler give the JAX package's
indices under the same numpy seed (and epoch, for the distributed
sampler); ``DataLoader`` gives the JAX package's batches in its three
map-style modes (in process, the buffered reader over the native queue,
two worker processes), with the same shuffle under the same seed; worker
and feeder errors surface as JAX's ``RuntimeError``; an
``IterableDataset`` honours ``drop_last``; dicts collate; the native
queue keeps order and bounds. The port's batches are torch tensors on
the loader's device (``places="cpu"`` here: the default is ``cuda``).

Every multiprocess loader runs with ``timeout=60``, so a worker that
hangs fails its test instead of holding the suite.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.io.blocking_queue import NativeBlockingQueue

WORKER_TIMEOUT = 60


def _squares(io, n=20):
    class SquareDataset(io.Dataset):
        def __getitem__(self, i):
            return (np.float32([i]), np.float32([i * i]))

        def __len__(self):
            return n

    return SquareDataset()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, paddle.Tensor):
        return x.numpy()
    return np.asarray(x)


def _batches(loader):
    """Every batch as numpy, dicts and tuples kept."""
    out = []
    for b in loader:
        if isinstance(b, dict):
            out.append({k: _np(v) for k, v in b.items()})
        elif isinstance(b, (list, tuple)):
            out.append(tuple(_np(v) for v in b))
        else:
            out.append(_np(b))
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        elif isinstance(w, tuple):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- datasets

def test_map_datasets_index_as_jax():
    a_j, b_j = _squares(jio, 4), _squares(jio, 6)
    a_t, b_t = _squares(tio, 4), _squares(tio, 6)
    cat_j, cat_t = jio.ConcatDataset([a_j, b_j]), tio.ConcatDataset([a_t,
                                                                    b_t])
    assert len(cat_t) == len(cat_j) == 10
    for i in list(range(10)) + [-1, -10]:
        np.testing.assert_array_equal(cat_t[i][0], cat_j[i][0])
    sub_j, sub_t = jio.Subset(a_j, [3, 1]), tio.Subset(a_t, [3, 1])
    assert len(sub_t) == 2
    for i in range(2):
        np.testing.assert_array_equal(sub_t[i][1], sub_j[i][1])
    comp_j = jio.ComposeDataset([a_j, _squares(jio, 4)])
    comp_t = tio.ComposeDataset([a_t, _squares(tio, 4)])
    assert len(comp_t[2]) == len(comp_j[2]) == 4
    for got, want in zip(comp_t[2], comp_j[2]):
        np.testing.assert_array_equal(got, want)
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6, dtype=np.int64)
    tds = tio.TensorDataset([torch.from_numpy(xs), torch.from_numpy(ys)])
    jds = jio.TensorDataset([paddle.to_tensor(xs), paddle.to_tensor(ys)])
    assert len(tds) == len(jds) == 6
    for i in range(6):
        for got, want in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(_np(got), _np(want))


def test_iterable_and_chain_datasets():
    def stream(io, n):
        class Stream(io.IterableDataset):
            def __iter__(self):
                for i in range(n):
                    yield np.float32([i])
        return Stream()

    chain_t = tio.ChainDataset([stream(tio, 3), stream(tio, 2)])
    chain_j = jio.ChainDataset([stream(jio, 3), stream(jio, 2)])
    assert [float(v[0]) for v in chain_t] == [float(v[0]) for v in chain_j]
    with pytest.raises(RuntimeError):
        stream(tio, 1)[0]
    with pytest.raises(RuntimeError):
        len(stream(tio, 1))
    for drop in (False, True):
        got = _batches(tio.DataLoader(stream(tio, 7), batch_size=3,
                                      drop_last=drop, places="cpu"))
        want = _batches(jio.DataLoader(stream(jio, 7), batch_size=3,
                                       drop_last=drop))
        _assert_same_batches(got, want)
        assert [b.shape[0] for b in got] == ([3, 3] if drop else [3, 3, 1])
    with pytest.raises(TypeError):
        len(tio.DataLoader(stream(tio, 7), batch_size=3, places="cpu"))


@pytest.mark.parametrize("lengths", [[7, 3], [0.5, 0.3, 0.2]])
def test_random_split_draws_jax_permutation(lengths):
    np.random.seed(11)
    want = jio.random_split(_squares(jio, 10), lengths)
    np.random.seed(11)
    got = tio.random_split(_squares(tio, 10), lengths)
    assert [p.indices for p in got] == [p.indices for p in want]


# ------------------------------------------------------------- samplers

def _sampler_cases(io, ds):
    return {
        "sequence": lambda: io.SequenceSampler(ds),
        "random": lambda: io.RandomSampler(ds),
        "random_replacement": lambda: io.RandomSampler(
            ds, replacement=True, num_samples=30),
        "random_num_samples": lambda: io.RandomSampler(ds, num_samples=7),
        "weighted": lambda: io.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 20), 15),
        "weighted_no_replacement": lambda: io.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 20), 10, replacement=False),
        "subset_random": lambda: io.SubsetRandomSampler([3, 9, 1, 17, 4]),
        "batch": lambda: io.BatchSampler(dataset=ds, batch_size=3),
        "batch_shuffle_drop": lambda: io.BatchSampler(
            dataset=ds, shuffle=True, batch_size=3, drop_last=True),
        "batch_of_sampler": lambda: io.BatchSampler(
            sampler=io.RandomSampler(ds), batch_size=6),
    }


@pytest.mark.parametrize("case", sorted(_sampler_cases(jio, None)))
def test_sampler_order_equals_jax_under_one_seed(case):
    np.random.seed(5)
    want = list(_sampler_cases(jio, _squares(jio))[case]())
    np.random.seed(5)
    sampler = _sampler_cases(tio, _squares(tio))[case]()
    got = list(sampler)
    assert got == want
    assert len(sampler) == len(_sampler_cases(jio, _squares(jio))[case]())


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_equals_jax_per_rank_and_epoch(
        shuffle, drop_last):
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        t = tio.DistributedBatchSampler(_squares(tio, 13), **kw)
        j = jio.DistributedBatchSampler(_squares(jio, 13), **kw)
        for epoch in (0, 3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)
    # without torch.distributed initialized: one rank of one
    s = tio.DistributedBatchSampler(_squares(tio, 5), batch_size=2)
    assert (s.nranks, s.local_rank) == (1, 0)


# ----------------------------------------------------------- DataLoader

@pytest.mark.parametrize("mode", ["single", "buffered", "workers"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_equal_jax(mode, shuffle):
    kw = dict(batch_size=5, shuffle=shuffle,
              use_buffer_reader=mode == "buffered",
              num_workers=2 if mode == "workers" else 0,
              timeout=WORKER_TIMEOUT if mode == "workers" else 0)
    np.random.seed(3)
    want = _batches(jio.DataLoader(_squares(jio, 17), **kw))
    np.random.seed(3)
    loader = tio.DataLoader(_squares(tio, 17), places="cpu", **kw)
    got = _batches(loader)
    _assert_same_batches(got, want)
    assert len(loader) == 4
    x, y = next(iter(loader))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert x.dtype == torch.float32 and tuple(x.shape) == (5, 1)


@pytest.mark.parametrize("mode", ["single", "buffered", "workers"])
def test_tensor_dataset_loads_as_jax(mode):
    """A TensorDataset (snapshotted to host numpy before the workers
    fork) gives the JAX batches in every mode."""
    xs = np.arange(14, dtype=np.float32).reshape(7, 2)
    ys = np.arange(7, dtype=np.int64)
    kw = dict(batch_size=3, use_buffer_reader=mode == "buffered",
              num_workers=2 if mode == "workers" else 0,
              timeout=WORKER_TIMEOUT if mode == "workers" else 0)
    want = _batches(jio.DataLoader(jio.TensorDataset(
        [paddle.to_tensor(xs), paddle.to_tensor(ys)]), **kw))
    got = _batches(tio.DataLoader(tio.TensorDataset(
        [torch.from_numpy(xs), torch.from_numpy(ys)]), places="cpu", **kw))
    _assert_same_batches(got, want)


@pytest.mark.parametrize("mode", ["single", "buffered", "workers"])
def test_dict_collate_equals_jax(mode):
    def dict_ds(io):
        class DictDs(io.Dataset):
            def __getitem__(self, i):
                return {"x": np.float32([i, -i]), "y": i, "s": f"n{i}"}

            def __len__(self):
                return 6
        return DictDs()

    kw = dict(batch_size=4, use_buffer_reader=mode == "buffered",
              num_workers=2 if mode == "workers" else 0,
              timeout=WORKER_TIMEOUT if mode == "workers" else 0)
    want = list(jio.DataLoader(dict_ds(jio), **kw))
    got = list(tio.DataLoader(dict_ds(tio), places="cpu", **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), w["x"].numpy())
        np.testing.assert_array_equal(g["y"].numpy(), w["y"].numpy())
        assert g["s"] == w["s"]


@pytest.mark.parametrize("mode", ["buffered", "workers"])
def test_loader_errors_surface_as_jax_runtime_error(mode):
    def bad(io):
        class Bad(io.Dataset):
            def __getitem__(self, i):
                if i == 5:
                    raise ValueError("boom")
                return np.float32([i])

            def __len__(self):
                return 10
        return Bad()

    kw = dict(batch_size=2, use_buffer_reader=mode == "buffered",
              num_workers=2 if mode == "workers" else 0,
              timeout=WORKER_TIMEOUT if mode == "workers" else 0)
    with pytest.raises(RuntimeError, match="boom") as want:
        list(jio.DataLoader(bad(jio), **kw))
    with pytest.raises(RuntimeError, match="boom") as got:
        list(tio.DataLoader(bad(tio), places="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_dead_worker_raises_instead_of_hanging():
    class Dies(tio.Dataset):
        def __getitem__(self, i):
            import os
            os._exit(3)

        def __len__(self):
            return 4

    t0 = time.time()
    with pytest.raises(RuntimeError, match="exitcode 3"):
        list(tio.DataLoader(Dies(), batch_size=2, num_workers=1,
                            places="cpu", timeout=WORKER_TIMEOUT))
    assert time.time() - t0 < WORKER_TIMEOUT


def test_worker_init_fn_runs_in_each_worker():
    import multiprocessing as mp
    flags = mp.get_context("fork").Queue()

    def init_fn(worker_id):
        flags.put(worker_id)

    list(tio.DataLoader(_squares(tio, 4), batch_size=2, num_workers=2,
                        places="cpu", worker_init_fn=init_fn,
                        timeout=WORKER_TIMEOUT))
    assert {flags.get(timeout=10), flags.get(timeout=10)} == {0, 1}


def test_native_queue_keeps_order_and_bounds():
    q = NativeBlockingQueue(capacity=3)
    n = 300

    def prod():
        for i in range(n):
            q.push({"i": i, "x": np.full(8, i, np.float32)})
        q.close()

    th = threading.Thread(target=prod)
    th.start()
    seen = []
    while True:
        try:
            seen.append(q.pop(timeout_ms=10_000)["i"])
        except StopIteration:
            break
    th.join(timeout=10)
    assert not th.is_alive() and seen == list(range(n))
    q2 = NativeBlockingQueue(capacity=1)
    q2.push(1)
    with pytest.raises(TimeoutError):
        q2.push(2, timeout_ms=100)
    assert len(q2) == 1 and q2.capacity == 1
    q2.close()
    with pytest.raises(RuntimeError, match="closed"):
        q2.push(3)


def test_default_collate_fn_equals_jax():
    samples = [(np.float32([i, 2 * i]), i, 0.5 * i) for i in range(3)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    stacked = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert stacked.shape == (2, 2)
    with pytest.raises(TypeError):
        tio.default_collate_fn([object()])
