"""The port's prompt trainers against the JAX package's forwards, in fp32
at a tiny size, as ``test_torch_zoo.py`` holds CoOp: ``cocoop_forward``
unchunked and chunked (the tail padded), chunked against unchunked, its
chunk rule and its run under 'int8_ste'; ``vpt_forward`` for VPT and
MPT; ``umudpt_forward`` and ``uumudpt_forward``, whose prompt heads train
their own weights.  Logits and the gradient of every trainable leaf within
1e-4 of the largest value."""

import numpy as np
import pytest
import torch

from mudpt_tpu.trainers import cocoop as JCC
from mudpt_tpu.trainers import umudpt as JUM
from mudpt_tpu.trainers import uumudpt as JUU
from mudpt_tpu.trainers import vpt as JVP

from mudpt_torch.models.clip import leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import cocoop as TCC
from mudpt_torch.trainers import umudpt as TUM
from mudpt_torch.trainers import uumudpt as TUU
from mudpt_torch.trainers import vpt as TVP

from tests.test_torch_zoo import (TCFG, _against_jax, _class_aux, _head, _rand,  # noqa: F401
                                  batch, frozen, two_torch_threads)


def _cocoop_trainable(seed=2, n_ctx=4):
    rng = np.random.RandomState(seed)
    lin = lambda i, o: {"w": _rand(rng, i, o, std=i ** -0.5), "b": _rand(rng, o, std=0.1)}  # noqa: E731
    return {"ctx": _rand(rng, n_ctx, 64),
            "meta_net": {"linear1": lin(64, 4), "linear2": lin(4, 64)}}


@pytest.mark.parametrize("chunk", [-1, 2], ids=["unchunked", "chunked"])
def test_cocoop_forward_and_gradients(frozen, batch, chunk):
    """The per-instance encode as one 4-D text call, and in chunks of two
    instances under torch.utils.checkpoint, the tail padded with the last
    instance; the meta-net's biases get their gradients."""
    aux = _class_aux(frozen[0], 4, "X X X X")
    _against_jax(JCC.cocoop_forward, TCC.cocoop_forward, frozen, batch, _cocoop_trainable(),
                 aux, encode_chunk=chunk)


def test_cocoop_chunked_equals_unchunked(frozen, batch):
    """Chunked against unchunked in the port: the same logits and
    gradients, for every chunk size, with saves on around the call (the
    chunks run saves off inside, their recompute too)."""
    aux = params_from_numpy(_class_aux(frozen[0], 4, "X X X X"), "cpu")
    images = torch.from_numpy(batch[0])

    def run(chunk):
        tr = params_from_numpy(_cocoop_trainable(), "cpu")
        for t in leaves(tr):
            t.requires_grad_(True)
        logits = TCC.cocoop_forward(tr, frozen[1], aux, images, clip_cfg=TCFG,
                                    compute_dtype=torch.float32, encode_chunk=chunk)
        return logits.detach(), torch.autograd.grad(logits.square().sum(), leaves(tr))

    # the chunks' gradients add up over instances in another order: within
    # 1e-5 of each leaf's largest value
    logits, grads = run(-1)
    for chunk in (1, 2):
        lc, gc = run(chunk)
        torch.testing.assert_close(lc, logits, rtol=0, atol=1e-6)
        for a, b in zip(gc, grads):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_cocoop_resolves_chunks_as_jax():
    for args in ((0, 8, 1000, 80), (0, 32, 1000, 16), (0, 7, 1000, 24), (0, 3, 10, 16),
                 (-1, 5, 1000, 80), (3, 8, 100, 16), (0, 40, 1000, 16), (0, 13, 6000, 24)):
        assert TCC._resolve_chunk(*args) == JCC._resolve_chunk(*args), args


def test_cocoop_refuses_quant_modes(frozen, batch):
    """Under 'int8_ste' ``cocoop_forward`` runs, as the JAX package's does:
    its per-instance text encode on the dynamic q8 chain, a straight-through
    backward.  Logits and gradients against JAX's within this file's 1e-4
    (a reading of 1e-6: no code lands across a rounding boundary here; see
    ``test_torch_cocoop_quant.py`` for the bounds that admit one)."""
    from mudpt_tpu.models import layers as JL

    from mudpt_torch.models import layers as TL

    aux = _class_aux(frozen[0], 4, "X X X X")
    prev = JL._BLOCK_IMPL, JL.quant_mode(), TL.quant_mode()
    JL.set_block_impl("pallas")
    JL.set_quant_mode("int8_ste")
    TL.set_quant_mode("int8_ste")
    try:
        _against_jax(JCC.cocoop_forward, TCC.cocoop_forward, frozen, batch, _cocoop_trainable(),
                     aux)
    finally:
        JL._BLOCK_IMPL = prev[0]
        JL.set_quant_mode(prev[1])
        TL.set_quant_mode(prev[2])


@pytest.mark.parametrize("trainer", ["VPT", "MPT"])
def test_vpt_mpt_forward_and_gradients(frozen, batch, trainer):
    """VPT: the fixed hand prompt, layer-0 and deep visual prompts; MPT adds
    the learnable layer-0 text ctx and deep text prompts."""
    rng = np.random.RandomState(3)
    trainable = {"visual_ctx": _rand(rng, 2, 64), "visual_deep_prompts": _rand(rng, 1, 2, 64)}
    n_ctx_embed = 0
    if trainer == "MPT":
        trainable["ctx"] = _rand(rng, 2, 64)
        trainable["text_deep_prompts"] = _rand(rng, 1, 2, 64)
        n_ctx_embed = 2
    aux = _class_aux(frozen[0], n_ctx_embed, "a photo of a")
    _against_jax(JVP.vpt_forward, TVP.vpt_forward, frozen, batch, trainable, aux)


def test_umudpt_forward_and_gradients(frozen, batch):
    """The t2v head's LayerNorms, LightTransformer and projection receive
    JAX's gradients: the head runs plain autograd, not the dx-only chains."""
    rng = np.random.RandomState(4)
    trainable = {"ctx": _rand(rng, 2, 64), "deep_prompts": _rand(rng, 2, 2, 64),
                 "t2v": _head(11, 64, 64)}
    aux = _class_aux(frozen[0], 2, "a photo")
    _, grads = _against_jax(JUM.umudpt_forward, TUM.umudpt_forward, frozen, batch,
                            trainable, aux)
    assert sum(name.startswith("t2v/") for name in grads) == 18


def test_uumudpt_forward_and_gradients(frozen, batch):
    rng = np.random.RandomState(6)
    trainable = {"ctx": _rand(rng, 2, 64), "deep_prompts": _rand(rng, 2, 2, 64),
                 "t2v": _head(12, 64, 64), "visual_ctx": _rand(rng, 2, 64),
                 "visual_ctx_deep_prompts": _rand(rng, 2, 2, 64), "v2t": _head(13, 64, 64)}
    aux = _class_aux(frozen[0], 2, "a photo")
    _, grads = _against_jax(JUU.uumudpt_forward, TUU.uumudpt_forward, frozen, batch,
                            trainable, aux)
    assert sum(name.startswith(("t2v/", "v2t/")) for name in grads) == 36


def test_cocoop_recompute_takes_the_forward_route(frozen, batch, monkeypatch):
    """torch.utils.checkpoint re-runs each chunk's encode in the backward,
    after the caller's contexts have closed: every run of the text tower,
    the recompute too, sees the route of the forward's caller (here the
    plain blocks) and saves off."""
    from mudpt_torch.models import layers
    from mudpt_torch.ops import fused_block

    seen = []
    text_forward = TCC.text_forward

    def spy(*args, **kwargs):
        seen.append((layers.routes(), fused_block.save_acts_enabled()))
        return text_forward(*args, **kwargs)

    monkeypatch.setattr(TCC, "text_forward", spy)
    aux = params_from_numpy(_class_aux(frozen[0], 4, "X X X X"), "cpu")
    tr = params_from_numpy(_cocoop_trainable(), "cpu")
    for t in leaves(tr):
        t.requires_grad_(True)
    with layers.plain_blocks():
        logits = TCC.cocoop_forward(tr, frozen[1], aux, torch.from_numpy(batch[0]),
                                    clip_cfg=TCFG, compute_dtype=torch.float32, encode_chunk=2)
    assert layers.routes() == (False, "none") and fused_block.save_acts_enabled()
    logits.sum().backward()
    assert seen == [((True, "none"), False)] * 4  # two chunks, each run twice
