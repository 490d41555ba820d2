"""Datasets, after ``paddle_tpu/io/dataset.py`` (reference:
python/paddle/io/dataset.py et al.). Plain Python over numpy; a
:class:`TensorDataset` indexes its torch tensors, and
:func:`random_split` draws its permutation from numpy's global RNG, so
the same seed splits as the JAX package does."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ConcatDataset",
           "ChainDataset", "Subset", "random_split", "ComposeDataset"]


class Dataset:
    """Map-style dataset (reference: paddle.io.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    """Stream-style dataset (reference: paddle.io.IterableDataset)."""

    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {t.shape[0] for t in tensors}
        assert len(lens) == 1, "all tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if abs(sum(lengths) - 1.0) < 1e-6 and all(
            isinstance(x, float) for x in lengths):
        lengths = [int(x * n) for x in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    assert sum(lengths) == n, "lengths must sum to dataset size"
    perm = np.random.permutation(n)
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start:start + ln].tolist()))
        start += ln
    return out


class ComposeDataset(Dataset):
    """Reference: io/dataloader/dataset.py ComposeDataset — zip fields of
    several map-style datasets into one sample tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert self.datasets, "ComposeDataset needs at least one dataset"
        n = len(self.datasets[0])
        for d in self.datasets[1:]:
            assert len(d) == n, "ComposeDataset inputs must share length"

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)
