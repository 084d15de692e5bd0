"""ModifiedResNet vision tower of the RN-family CLIP checkpoints
(counterpart of ``mudpt_tpu/models/resnet.py``).

A 3-conv stem with an average pool, Bottleneck blocks whose stride is an
average pool after conv2 (and before the downsample's 1x1 conv), and a QKV
attention pool in place of global average pooling.  The backbone is frozen,
so BatchNorm runs in inference mode from the stored statistics, folded into
a scale and a bias in fp32 and then cast to the compute dtype (:35-39).

The JAX package runs this tower as XLA convolutions and dots, with no
Pallas kernel; so the port runs ``F.conv2d`` (cuDNN on the card) and
``torch.matmul``.  Images come in NHWC, as everywhere in the port; inside,
``images.permute(0, 3, 1, 2)`` is an NCHW view in the channels-last memory
layout that cuDNN keeps through the tower.  The parameter tree keeps the
JAX package's names and layouts: HWIO conv kernels, (in, out) linears.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mudpt_torch.utils.profiling import span


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """(B, C, H, W) conv with an HWIO kernel, symmetric padding (``conv2d`` :24)."""
    w = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=padding)


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN (``batch_norm`` :35): the scale folded in fp32 and
    cast to x's dtype, the bias from that rounded scale in fp32, then cast."""
    scale = (p["scale"].float() * torch.rsqrt(p["var"].float() + eps)).to(x.dtype)
    bias = (p["bias"].float() - p["mean"].float() * scale.float()).to(x.dtype)
    return x * scale[:, None, None] + bias[:, None, None]


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool, stride k, no padding (``avg_pool`` :42)."""
    return F.avg_pool2d(x, k)


def bottleneck(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The reference Bottleneck (``bottleneck`` :48-63): every conv at stride
    1; an average pool takes the stride after conv2; the downsample is an
    average pool and a 1x1 conv."""
    out = torch.relu(batch_norm(p["bn1"], conv2d(x, p["conv1"])))
    out = torch.relu(batch_norm(p["bn2"], conv2d(out, p["conv2"], padding=1)))
    if stride > 1:
        out = avg_pool(out, stride)
    out = batch_norm(p["bn3"], conv2d(out, p["conv3"]))
    identity = x
    if "downsample" in p:
        identity = x if stride == 1 else avg_pool(x, stride)
        identity = batch_norm(p["downsample"]["bn"], conv2d(identity, p["downsample"]["conv"]))
    return torch.relu(out + identity)


def attention_pool(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """QKV attention pool (``attention_pool`` :66-91): the mean token is the
    only query, the whole map keys and values; scores in fp32, the
    probabilities cast to v's dtype.  x (B, C, H, W) -> (B, output_dim)."""
    B, C = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)                       # (B, HW, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["pos_embedding"].to(tokens.dtype)[None]

    def proj(name, t):
        return torch.matmul(t, p[name]["w"].to(t.dtype)) + p[name]["b"].to(t.dtype)

    hd = C // num_heads
    q = proj("q", tokens[:, :1]).reshape(B, 1, num_heads, hd).transpose(1, 2)
    k = proj("k", tokens).reshape(B, -1, num_heads, hd).transpose(1, 2)
    v = proj("v", tokens).reshape(B, -1, num_heads, hd).transpose(1, 2)
    # bf16 products are exact in fp32: fp32 operands give the fp32-accumulated
    # scores of the JAX package's preferred_element_type
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, C)
    return torch.matmul(out, p["c"]["w"].to(out.dtype)) + p["c"]["b"].to(out.dtype)


def resnet_forward(p: dict, images: torch.Tensor, *, layers: Sequence[int], heads: int,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """images (B, H, W, 3) -> features (B, output_dim) (``resnet_forward`` :94)."""
    with span("mudpt.vision"):
        x = images.to(compute_dtype).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = torch.relu(batch_norm(p[f"bn{i}"], conv2d(x, p[f"conv{i}"],
                                                          stride=2 if i == 1 else 1, padding=1)))
        x = avg_pool(x, 2)
        for stage_idx, blocks in enumerate(layers, start=1):
            stage = p[f"layer{stage_idx}"]
            for block_idx in range(blocks):
                stride = 2 if (stage_idx > 1 and block_idx == 0) else 1
                x = bottleneck(stage[str(block_idx)], x, stride)
        return attention_pool(p["attnpool"], x, heads)


# ---------------------------------------------------------------------------
# the OpenAI state dict's visual.* entries (``convert_resnet_visual`` :137)
# ---------------------------------------------------------------------------

def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _bn(sd: dict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}


def _linear(sd: dict, prefix: str) -> dict:
    return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}


def stage_counts(sd: dict, prefix: str = "visual.") -> Tuple[int, ...]:
    """Blocks per stage of an RN state dict (reference clip/model.py:892-898)."""
    return tuple(len({k[len(prefix):].split(".")[1] for k in sd
                      if k.startswith(f"{prefix}layer{i}.")}) for i in (1, 2, 3, 4))


def convert_resnet_visual(sd: dict) -> Tuple[dict, Tuple[int, ...]]:
    """(numpy fp32 parameter tree, blocks per stage) of the ``visual.*``
    entries of an RN CLIP state dict of numpy arrays."""
    v = {k[len("visual."):]: np.asarray(t) for k, t in sd.items() if k.startswith("visual.")}
    layers = stage_counts(v, "")
    params: dict = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = _conv(v[f"conv{i}.weight"])
        params[f"bn{i}"] = _bn(v, f"bn{i}")
    for stage_idx, blocks in enumerate(layers, start=1):
        stage = {}
        for b in range(blocks):
            pre = f"layer{stage_idx}.{b}"
            bp = {}
            for j in (1, 2, 3):
                bp[f"conv{j}"] = _conv(v[f"{pre}.conv{j}.weight"])
                bp[f"bn{j}"] = _bn(v, f"{pre}.bn{j}")
            if f"{pre}.downsample.0.weight" in v:
                bp["downsample"] = {"conv": _conv(v[f"{pre}.downsample.0.weight"]),
                                    "bn": _bn(v, f"{pre}.downsample.1")}
            stage[str(b)] = bp
        params[f"layer{stage_idx}"] = stage
    params["attnpool"] = {
        "pos_embedding": v["attnpool.positional_embedding"],
        **{n: _linear(v, f"attnpool.{n}_proj") for n in ("q", "k", "v", "c")},
    }
    return _to_f32(params), layers


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(t) for k, t in tree.items()}
    return np.ascontiguousarray(tree, dtype=np.float32)
