from mudpt_torch.models.clip import (
    CLIPConfig,
    init_clip_params,
    encode_image,
    encode_text,
    clip_forward,
    cast_matmul_weights,
    VIT_B16,
    VIT_B32,
)
from mudpt_torch.models.convert import state_dict_to_params, load_clip_checkpoint

__all__ = [
    "CLIPConfig",
    "init_clip_params",
    "encode_image",
    "encode_text",
    "clip_forward",
    "cast_matmul_weights",
    "VIT_B16",
    "VIT_B32",
    "state_dict_to_params",
    "load_clip_checkpoint",
]
