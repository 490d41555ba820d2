"""paddle_tpu_torch.io — datasets and data loading, the namespace of
``paddle_tpu/io/__init__.py`` (reference: python/paddle/io/__init__.py)."""
from .dataloader import (  # noqa: F401
    DataLoader, default_collate_fn, get_worker_info,
)
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)
