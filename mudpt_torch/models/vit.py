"""Vision transformer tower with prompt hooks (counterpart of
``mudpt_tpu/models/vit.py:34-113``).

patchify -> prepend CLS -> +pos -> [append layer-0 prompt] -> ln_pre ->
transformer (deep prompts over the last n_ctx positions) -> ln_post on CLS
-> proj.  Patchify is a reshape and one ``torch.matmul`` (stride equals the
kernel, so the convolution is a blocked matmul), as the JAX package leaves
it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from mudpt_torch.models.layers import layer_norm
from mudpt_torch.models.transformer import make_injection_schedule, num_layers_of, transformer_forward
from mudpt_torch.parallel.mesh import shard_rows
from mudpt_torch.utils.profiling import span


def patchify(p: dict, images: torch.Tensor, patch_size: int, compute_dtype) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, n_patches, width) tokens."""
    B, H, W, C = images.shape
    gh, gw = H // patch_size, W // patch_size
    x = images.reshape(B, gh, patch_size, gw, patch_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, patch_size * patch_size * C)
    x = x.to(compute_dtype)
    return torch.matmul(x, p["patch_w"].to(compute_dtype))


def vit_forward(
    p: dict,
    images: torch.Tensor,
    *,
    patch_size: int,
    n_head: int,
    compute_dtype=torch.float32,
    layer0_prompt: Optional[torch.Tensor] = None,
    deep_prompts: Optional[torch.Tensor] = None,
    mesh_ctx=None,
) -> torch.Tensor:
    """images (B, H, W, 3) -> features (B, embed_dim).  Under a mesh the
    tower runs on this rank's rows of the 'data' axis (``vit.py:105-107``:
    ``shard_rows``, where a rank's batch already is its shard)."""
    with span("mudpt.vision"):
        x = patchify(p, images, patch_size, compute_dtype)
        B, _, width = x.shape
        cls = p["class_embedding"].to(compute_dtype).expand(B, 1, width)
        x = torch.cat([cls, x], dim=1) + p["pos_embedding"].to(compute_dtype)[None]
        if layer0_prompt is not None:
            n0 = layer0_prompt.shape[-2]
            prompt0 = layer0_prompt.to(compute_dtype).reshape(-1, n0, width)[:1]
            x = torch.cat([x, prompt0.expand(B, n0, width)], dim=1)
        x = layer_norm(p["ln_pre"], x)

        n_ctx = deep_prompts.shape[-2] if deep_prompts is not None else 0
        prompts, mask = make_injection_schedule(num_layers_of(p["blocks"]), deep_prompts)

        def tower(xx):
            return transformer_forward(p["blocks"], xx, n_head=n_head, prompts=prompts,
                                       prompt_mask=mask, n_ctx=n_ctx, is_text=False)

        x = shard_rows(mesh_ctx, "data", tower, x)
        pooled = layer_norm(p["ln_post"], x[:, 0])
        return torch.matmul(pooled, p["proj"].to(pooled.dtype))
