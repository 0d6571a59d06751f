"""Data substrate: synthetic datasets and non-IID partitioning."""
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import make_dataset  # noqa: F401
