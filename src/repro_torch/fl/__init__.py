"""FL plane of the port: algorithm API, engine, metrics and communication
accounting."""
from repro_torch.fl.api import (  # noqa: F401
    FLAlgorithm,
    MigrationRefused,
    WorkItem,
    create_algorithm,
    list_algorithms,
    register_algorithm,
)
from repro_torch.fl.engine import run_experiment  # noqa: F401
