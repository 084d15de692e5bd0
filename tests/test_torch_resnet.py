"""The port's ResNet trunk and RN presets (``mudpt_torch/models/resnet.py``,
the RN branches of ``models/clip.py``, ``models/convert.py`` and
``trainers/base.py``) against the JAX package's, on the CPU at tiny sizes
with numpy-seeded inputs:

* ``resnet_forward`` and ``attention_pool`` on the JAX converter's tree of
  a numpy state dict, BatchNorm statistics away from unit, in fp32 (within 2^-16 of
  the largest value: the packages differ in the order of fp32 sums) and in
  bf16 on the bf16-cast tree (max error within 2^-6 of the largest value,
  relative norm error within 2^-6: readings 2^-8 and 0.0048, a bf16
  rounding of a conv or an add landing on the other side);
* an RN state dict of numpy arrays under the OpenAI key names: the config
  inferred and the tree converted as the JAX package does, bit-equal, and
  ``load_clip_checkpoint`` reading it from a ``.pt`` file, its conversion
  cache read back by both packages;
* the random init's paths and shapes and ``cast_matmul_weights``' dtypes,
  leaf by leaf, as the JAX package's;
* ``encode_image`` with the ``test-tiny-rn`` preset (fp32, 2^-16).

The RN trainers are in ``test_torch_resnet_trainers.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import clip as JC
from mudpt_tpu.models import convert as JCV
from mudpt_tpu.models import resnet as JR
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models import clip as TC
from mudpt_torch.models import convert as TCV
from mudpt_torch.models import resnet as TR
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers.base import NAMED_CONFIGS

LAYERS = (1, 1, 1, 1)
FP32_REL = 2.0 ** -16
BF16_MAX, BF16_NORM = 2.0 ** -6, 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rn_cfg(width, res, layers=LAYERS, **kw):
    return dict(embed_dim=48, image_resolution=res, vision_width=width, vision_patch_size=0,
                vision_arch="resnet", vision_layers_per_stage=layers,
                vision_layers=sum(layers), **kw)


@pytest.fixture(scope="module", params=[(8, 32), (32, 64)], ids=["w8", "w32"])
def tower(request):
    """A (1, 1, 1, 1) tower of the JAX package's converter, from a numpy
    state dict (BatchNorm statistics away from unit)."""
    width, res = request.param
    cfg = JC.CLIPConfig(**_rn_cfg(width, res))
    p, _ = JR.convert_resnet_visual(_state_dict(np.random.RandomState(1), width, LAYERS, res))
    return cfg, _np(p)


def _jax_resnet(p, images, heads, dtype):
    fn = jax.jit(JR.resnet_forward, static_argnames=("layers", "heads", "compute_dtype"))
    return np.asarray(fn(p, jnp.asarray(images), layers=LAYERS, heads=heads,
                         compute_dtype=dtype), np.float32)


def _hold(got, want, dtype):
    err, largest = np.abs(got - want).max(), np.abs(want).max()
    if dtype == "fp32":
        assert err <= FP32_REL * largest, (err, largest)
    else:
        assert err <= BF16_MAX * largest, (err, largest)
        assert np.linalg.norm(got - want) <= BF16_NORM * np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_resnet_forward_and_attention_pool_match_jax(tower, dtype):
    cfg, p = tower
    rng = np.random.RandomState(2)
    res, heads = cfg.image_resolution, cfg.vision_heads
    images = rng.randn(3, res, res, 3).astype(np.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bf16":
        jp, tp = JC._cast_rn_visual(jp, jdt), TC._cast_rn_visual(tp, tdt)
    want = _jax_resnet(jp, images, heads, jdt)
    got = TR.resnet_forward(tp, torch.from_numpy(images), layers=LAYERS, heads=heads,
                            compute_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (3, cfg.embed_dim)
    _hold(got.float().numpy(), want, dtype)

    # the pool alone, on a feature map of the last stage's width
    side, C = res // 32, cfg.vision_width * 32
    x = rng.randn(3, side, side, C).astype(np.float32)
    want = np.asarray(JR.attention_pool(jp["attnpool"], jnp.asarray(x, jdt), heads), np.float32)
    got = TR.attention_pool(tp["attnpool"], torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2),
                            heads)
    _hold(got.float().numpy(), want, dtype)


def _state_dict(rng, width=8, layers=(2, 1, 1, 1), res=64, tw=32, n_layers=2):
    """An RN CLIP state dict of numpy arrays under the OpenAI key names
    (reference clip/model.py ModifiedResNet and the text transformer),
    running statistics away from unit, as ``torch.save`` of a real one
    holds them (``num_batches_tracked`` included)."""
    sd = {}

    def arr(*shape, std=0.1):
        return (rng.randn(*shape) * std).astype(np.float32)

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = arr(cout, cin, k, k, std=(k * k * cin) ** -0.5)

    def bn(name, ch):
        sd.update({f"{name}.weight": 1 + arr(ch, std=0.2), f"{name}.bias": arr(ch, std=0.2),
                   f"{name}.running_mean": arr(ch, std=0.5),
                   f"{name}.running_var": np.exp(arr(ch, std=0.5)),
                   f"{name}.num_batches_tracked": np.array(7, np.int64)})

    for i, (cin, cout) in enumerate(((3, width // 2), (width // 2, width // 2),
                                     (width // 2, width)), start=1):
        conv(f"visual.conv{i}", cout, cin, 3)
        bn(f"visual.bn{i}", cout)
    inplanes = width
    for s, blocks in enumerate(layers, start=1):
        planes = width * 2 ** (s - 1)
        for b in range(blocks):
            pre = f"visual.layer{s}.{b}"
            conv(f"{pre}.conv1", planes, inplanes, 1)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3", planes * 4, planes, 1)
            bn(f"{pre}.bn3", planes * 4)
            if b == 0 and (s > 1 or inplanes != planes * 4):
                conv(f"{pre}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inplanes = planes * 4
    C, embed = width * 32, 48
    sd["visual.attnpool.positional_embedding"] = arr((res // 32) ** 2 + 1, C)
    for n, dout in (("q", C), ("k", C), ("v", C), ("c", embed)):
        sd[f"visual.attnpool.{n}_proj.weight"] = arr(dout, C)
        sd[f"visual.attnpool.{n}_proj.bias"] = arr(dout)
    sd["token_embedding.weight"] = arr(300, tw)
    sd["positional_embedding"] = arr(16, tw)
    for i in range(n_layers):
        pre = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = 1 + arr(tw), arr(tw)
        sd[f"{pre}.attn.in_proj_weight"] = arr(3 * tw, tw)
        sd[f"{pre}.attn.in_proj_bias"] = arr(3 * tw)
        sd[f"{pre}.attn.out_proj.weight"], sd[f"{pre}.attn.out_proj.bias"] = arr(tw, tw), arr(tw)
        sd[f"{pre}.mlp.c_fc.weight"], sd[f"{pre}.mlp.c_fc.bias"] = arr(4 * tw, tw), arr(4 * tw)
        sd[f"{pre}.mlp.c_proj.weight"], sd[f"{pre}.mlp.c_proj.bias"] = arr(tw, 4 * tw), arr(tw)
    sd["ln_final.weight"], sd["ln_final.bias"] = 1 + arr(tw), arr(tw)
    sd["text_projection"] = arr(tw, embed)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


def _same_config(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == {k: tuple(v) if isinstance(v, list) else v
                                        for k, v in dataclasses.asdict(jcfg).items()}


def _same_tree(tparams, jparams):
    tflat, jflat = _flat(tparams), _flat(_np(jparams))
    assert sorted(tflat) == sorted(jflat)
    for k, a in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), a, err_msg=k)


def test_rn_state_dict_converts_and_loads_as_jax(tmp_path):
    sd = _state_dict(np.random.RandomState(3))
    jcfg, jparams = JCV.torch_state_dict_to_jax(sd)
    tcfg, tparams = TCV.state_dict_to_params(sd)
    assert tcfg.vision_arch == "resnet" and tcfg.vision_layers_per_stage == (2, 1, 1, 1)
    assert (tcfg.image_resolution, tcfg.vision_width, tcfg.vision_heads) == (64, 8, 4)
    _same_config(tcfg, jcfg)
    _same_tree(tparams, jparams)
    visual, layers = TR.convert_resnet_visual(sd)
    assert layers == (2, 1, 1, 1) and "downsample" in visual["layer1"]["0"]
    assert "downsample" not in visual["layer1"]["1"]

    # a .pt of tensors (torch.jit.load refuses it; torch.load reads it), its
    # conversion cached beside it, which both packages read back
    path = str(tmp_path / "RN-tiny.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    cfg1, p1 = TCV.load_clip_checkpoint(path)
    _same_config(cfg1, jcfg)
    _same_tree(p1, jparams)
    cfg2, p2 = TCV.load_clip_checkpoint(path)  # from the cache
    assert cfg2 == cfg1
    _same_tree(p2, jparams)
    jcfg3, jp3 = JCV.load_npz_params(path + ".mudpt_tpu.npz")
    assert jcfg3 == jcfg
    _same_tree(p1, jp3)


def test_rn_init_paths_and_cast_rules_match_jax():
    """Paths, shapes and the bf16 cast's dtypes of the random init, leaf by
    leaf (the JAX side abstractly, by ``jax.eval_shape``)."""
    kw = _rn_cfg(8, 64, (2, 2, 1, 1), transformer_width=32, transformer_heads=1,
                 transformer_layers=1, vocab_size=300, context_length=16)
    jcfg = JC.CLIPConfig(**kw)
    jp = jax.eval_shape(lambda k: JC._init_clip_params(k, jcfg), new_rng(0))
    tp = TC.init_clip_params(TC.CLIPConfig(**kw), torch.Generator().manual_seed(0))
    jflat, tflat = _flat(jp), _flat(tp)
    assert sorted(tflat) == sorted(jflat)
    assert {k: tuple(v.shape) for k, v in tflat.items()} == {k: v.shape for k, v in jflat.items()}
    jcast = _flat(jax.eval_shape(lambda p: JC.cast_matmul_weights(p, jnp.bfloat16), jp))
    tcast = _flat(TC.cast_matmul_weights(tp, torch.bfloat16))
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    assert {k: names[v.dtype] for k, v in tcast.items()} == \
        {k: str(v.dtype) for k, v in jcast.items()}
    assert tcast["visual/bn1/var"].dtype == torch.float32
    assert tcast["visual/attnpool/pos_embedding"].dtype == torch.float32
    assert tcast["visual/layer1/0/conv2"].dtype == torch.bfloat16
    assert tcast["visual/attnpool/c/b"].dtype == torch.bfloat16


def test_encode_image_on_test_tiny_rn_matches_jax():
    """``encode_image`` with the ``test-tiny-rn`` preset, on a tree the JAX
    converter made from a numpy state dict of that shape."""
    tcfg = NAMED_CONFIGS["test-tiny-rn"]
    sd = _state_dict(np.random.RandomState(4), tcfg.vision_width, tcfg.vision_layers_per_stage,
                     tcfg.image_resolution)
    jcfg, jp = JCV.torch_state_dict_to_jax(sd)
    assert tcfg.vision_heads == jcfg.vision_heads == 4
    images = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(JC.encode_image, static_argnames=("cfg",))(
        jp, jnp.asarray(images), jcfg))
    tp = params_from_numpy(_np(jp), "cpu")
    got = TC.encode_image(tp, torch.from_numpy(images), tcfg)
    _hold(got.numpy(), want, "fp32")
    with pytest.raises(AssertionError, match="ViT towers only"):
        TC.encode_image(tp, torch.from_numpy(images), tcfg, deep_prompts=torch.zeros(1, 2, 64))
