"""The sharding plane: partition-spec rules and the two-tier mean."""
from repro_torch.sharding.specs import (  # noqa: F401
    batch_specs,
    cache_specs,
    data_axes,
    param_specs,
    zero1_specs,
)
