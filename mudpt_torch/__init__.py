"""mudpt_torch: the PyTorch/CUDA port of ``mudpt_tpu`` for NVIDIA Hopper.

This package runs MuDPT serving (cached class-text features, then one
image-tower pass per request) with every transformer layer of both CLIP
towers going through hand-written CUDA kernels (``ops/fused_block.py``,
``csrc/``).  It imports ``torch`` and numpy only: nothing of JAX and nothing
of ``mudpt_tpu``, which stays beside it as the reference the port is tested
against.

Entry points take ``device=None``, meaning ``cuda``; they raise when CUDA is
absent and run the kernels' plain PyTorch versions only for tensors the
caller placed on the CPU (``device="cpu"``).
"""

__version__ = "0.1.0"
