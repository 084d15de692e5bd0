"""The trainers of the port, registered by import (as
``mudpt_tpu/trainers/__init__.py`` registers the JAX package's):
``build_trainer(cfg, devices)`` finds every name of ``TRAINER.NAME``."""

from mudpt_torch.trainers.base import TrainerBase, build_trainer

from mudpt_torch.trainers import (  # noqa: F401  (registration)
    cocoop,
    coop,
    mudpt,
    umudpt,
    uumudpt,
    vpt,
    zsclip,
)

__all__ = ["TrainerBase", "build_trainer"]
