"""Data substrate: synthetic datasets, non-IID partitioning and batch loaders."""
from repro_torch.data.loader import BatchLoader, token_batches  # noqa: F401
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import make_dataset  # noqa: F401
