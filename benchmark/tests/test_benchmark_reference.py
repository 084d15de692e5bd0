"""The plain reference against the port's plain route (its kernels' plain
versions, which run on CPU tensors) at tiny widths in fp32: the same MuDPT
forward, loss, gradients and SGD steps, and the int8 tier's quantization.
The reference itself imports nothing of the port; this test does."""

import pytest
import torch
import torch.nn.functional as F

from benchmark import cells, inputs
from benchmark.reference import clip_mudpt as ref
from benchmark.tests.conftest import TINY, tiny_cell
from mudpt_torch.models.layers import quantized
from mudpt_torch.trainers.mudpt import mudpt_forward, mudpt_image_logits, mudpt_text_features

DEV = torch.device("cpu")
SEED = 2 ** 31 + 77


def _fp32(tree):
    return {k: _fp32(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v) for k, v in tree.items()}


def _port(kind="train", quant="none"):
    cell = tiny_cell(kind)
    clip_cfg, params, aux, _ = cells._setup_port(cell, SEED, DEV, quant)
    return cell, clip_cfg, _fp32(params), aux


def _reference(cell):
    sd = ref.fp32_weights(inputs.openai_state_dict(inputs.make_weights(cell.config, SEED, DEV)))
    ids, eot = inputs.class_tokens(cell.traffic["n_cls"], TINY["n_ctx"], 77, SEED)
    return sd, torch.from_numpy(ids), torch.from_numpy(eot)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_text_features_and_logits_match_the_port():
    cell, clip_cfg, params, aux = _port()
    sd, ids, eot = _reference(cell)
    tr = inputs.make_trainable(TINY, SEED, DEV)
    images = inputs.images(6, 32, SEED, 5, DEV)
    kw = dict(clip_cfg=clip_cfg, compute_dtype=torch.float32)
    with torch.no_grad():
        txt = mudpt_text_features(tr, params, aux, **kw)
        logits = mudpt_image_logits(tr, params, aux, images, txt, **kw)
        txt_ref = ref.encode_text(sd, TINY, tr, ids, eot)
        logits_ref = ref.serve_logits(sd, TINY, tr, txt_ref, images, 4)
    assert _rel(txt, txt_ref) < 1e-5
    assert _rel(logits, logits_ref) < 1e-5


def test_loss_gradients_and_sgd_steps_match_the_port():
    cell, clip_cfg, params, aux = _port()
    sd, ids, eot = _reference(cell)
    tr0 = inputs.make_trainable(TINY, SEED, DEV)
    images = inputs.images(16, 32, SEED, 5, DEV).view(2, 8, 32, 32, 3)
    labels = inputs.labels((2, 8), 10, SEED, 6, DEV)
    tr = inputs.clone_tree(tr0)
    named = inputs.leaf_items(tr)
    for _, t in named:
        t.requires_grad_(True)
    opt = torch.optim.SGD([t for _, t in named], lr=0.0025, momentum=0.9)
    losses, grad1 = [], None
    for i in range(2):
        opt.zero_grad()
        loss = F.cross_entropy(mudpt_forward(tr, params, aux, images[i], clip_cfg=clip_cfg,
                                             compute_dtype=torch.float32), labels[i])
        loss.backward()
        grad1 = grad1 or {k: t.grad.clone() for k, t in named}
        opt.step()
        losses.append(float(loss.detach()))
    batches = [(images[i], labels[i]) for i in range(2)]
    ref_losses, ref_grad1, ref_after = ref.train(sd, TINY, tr0, ids, eot, batches, 0.0025, 0.9, 3)
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    for k, t in named:
        assert _rel(grad1[k], ref_grad1[k]) < 1e-4, k
        assert _rel(t.detach(), ref_after[k]) < 1e-5, k


def test_int8_reference_follows_the_int8_tier():
    cell, clip_cfg, params, aux = _port("serve_int8", quant="int8")
    sd, ids, eot = _reference(cell)
    tr = inputs.make_trainable(TINY, SEED, DEV)
    images = inputs.images(6, 32, SEED, 5, DEV)
    kw = dict(clip_cfg=clip_cfg, compute_dtype=torch.float32)
    with torch.no_grad(), quantized("int8"):
        txt = mudpt_text_features(tr, params, aux, **kw)
        logits = mudpt_image_logits(tr, params, aux, images, txt, **kw)
    with torch.no_grad():
        txt_ref = ref.encode_text(sd, TINY, tr, ids, eot, "int8")
        logits_ref = ref.serve_logits(sd, TINY, tr, txt_ref, images, 4, "int8")
        plain = ref.serve_logits(sd, TINY, tr, ref.encode_text(sd, TINY, tr, ids, eot), images, 4)
    # the int8 reference follows the tier far closer than the unquantized one
    assert _rel(logits, logits_ref) < 0.1 * _rel(logits, plain)


def test_port_tree_holds_the_openai_weights():
    w = inputs.make_weights(TINY, SEED, DEV)
    p, sd = inputs.to_port(w), inputs.openai_state_dict(w)
    assert torch.equal(p["visual"]["blocks"]["attn"]["qkv_w"][1],
                       sd["visual.transformer.resblocks.1.attn.in_proj_weight"].t())
    assert torch.equal(p["text"]["blocks"]["mlp"]["proj_w"][0],
                       sd["transformer.resblocks.0.mlp.c_proj.weight"].t())
    # a patch's (row, column, channel) pixels against the convolution's weight
    x = torch.randn(1, 16, 16, 3)
    conv = F.conv2d(x.permute(0, 3, 1, 2), sd["visual.conv1.weight"].float(), stride=16)
    assert _rel(x.reshape(1, -1) @ p["visual"]["patch_w"].float(), conv.reshape(1, -1)) < 1e-5
    assert p["visual"]["patch_w"].dtype == torch.bfloat16
    assert p["text"]["token_embedding"].dtype == torch.float32
    # no bf16 leaf keeps the draw alive: the port holds one copy of its weights
    draw = w["visual.proj"].untyped_storage().data_ptr()
    leaves = inputs.leaf_items(p)
    assert all(t.untyped_storage().data_ptr() != draw
               for _, t in leaves if t.dtype == torch.bfloat16)


def test_inputs_repeat_for_a_seed_and_keep_the_name_lengths():
    a = inputs.make_weights(TINY, 2 ** 33 + 5, DEV)
    b = inputs.make_weights(TINY, 2 ** 33 + 5, DEV)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for seed in (1, 2 ** 31 + 3):
        ids, eot = inputs.class_tokens(100, 2, 77, seed)
        assert sorted(eot - 4) == sorted([i % 8 + 1 for i in range(100)])
        assert (ids[range(100), eot] == inputs.EOT).all()
        assert (ids[:, 0] == inputs.SOT).all()
    sched = inputs.RequestSchedule([64, 128, 192], 400, 9)
    cycle = [sched[i][0] for i in range(3, 6)]
    assert sorted(cycle) == [64, 128, 192]
    assert all(0 <= off <= 400 - n for n, off in (sched[i] for i in range(30)))
