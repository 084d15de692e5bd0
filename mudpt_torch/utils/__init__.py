from mudpt_torch.utils.registry import Registry
from mudpt_torch.utils.logging import setup_logger, MetricsLogger
from mudpt_torch.utils.rng import set_seed, new_rng

__all__ = ["Registry", "setup_logger", "MetricsLogger", "set_seed", "new_rng"]
