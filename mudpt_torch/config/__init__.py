from mudpt_torch.config.config import (
    Config,
    default_config,
    load_config,
    merge_from_file,
    merge_from_list,
)
from mudpt_torch.config.perf import apply_perf_config, perf_snapshot

__all__ = [
    "Config",
    "apply_perf_config",
    "default_config",
    "load_config",
    "merge_from_file",
    "merge_from_list",
    "perf_snapshot",
]
