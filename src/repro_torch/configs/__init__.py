"""FL experiment configuration (``FLConfig``) and the paper presets."""
from repro_torch.configs.base import FLConfig  # noqa: F401
