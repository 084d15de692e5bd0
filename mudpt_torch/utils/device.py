"""Device resolution for the port's entry points (counterpart of
``mudpt_tpu/utils/platform.py``).

The JAX package pins its platform from ``JAX_PLATFORMS``; the port instead
takes an explicit ``device`` argument.  ``None`` means the card: a serving
entry point must never drift onto the CPU because CUDA is missing.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mudpt_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
