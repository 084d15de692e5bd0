"""The port's trainer zoo against the JAX package's forwards, in fp32 at a
tiny size (2 layers, width 64): ``coop_forward`` over every class-token
position, shared and class-specific, and with CTX_INIT; the zero-shot
template encode and ``_zs_inference``; and the index map and prompt
composition themselves (CoCoOp, VPT, MPT, UMuDPT and UUMuDPT in
``test_torch_zoo_prompts.py``, with these helpers).  Logits and the
gradient of every trainable leaf are held within 1e-4 of the largest
value.  Weights come from ``mudpt_tpu.models.clip.init_clip_params`` and
cross over through ``params_from_numpy``; inputs are numpy-seeded."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models.clip import CLIPConfig as JCLIPConfig
from mudpt_tpu.models.clip import init_clip_params as jinit
from mudpt_tpu.trainers import coop as JCO
from mudpt_tpu.trainers import prompt_utils as JPU
from mudpt_tpu.trainers import zsclip as JZS
from mudpt_tpu.utils.rng import new_rng

from mudpt_torch.models.clip import CLIPConfig, leaves
from mudpt_torch.models.convert import params_from_numpy
from mudpt_torch.trainers import coop as TCO
from mudpt_torch.trainers import prompt_utils as TPU
from mudpt_torch.trainers import zsclip as TZS
from mudpt_torch.trainers.templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT

DIMS = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, transformer_width=64, transformer_heads=2,
            transformer_layers=2)
JCFG, TCFG = JCLIPConfig(**DIMS), CLIPConfig(**DIMS)
# class names of 1, 1, 2 and 3 BPE tokens, so the middle and front layouts
# move the class tokens by different amounts
CLASSNAMES = ["cat", "dog", "german shepherd", "tabby_cat kitten"]
B = 3
REL = 1e-4  # fp32 on both sides: they differ in the order of fp32 sums


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
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module")
def frozen():
    jp = jinit(new_rng(0), JCFG)
    return jp, params_from_numpy(_np(jp), "cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(5)
    return (rng.randn(B, 32, 32, 3).astype(np.float32),
            rng.randint(0, len(CLASSNAMES), size=B))


def _class_aux(jp, n_ctx, prefix, position="end"):
    aux_cls = JPU.embed_classnames(jp["text"], CLASSNAMES, n_ctx, prefix)
    tree = aux_cls.as_device_tree()
    index_map = JPU.build_position_index_map(position, aux_cls.name_lens, n_ctx,
                                             aux_cls.effective_length())
    if index_map is not None:
        tree["index_map"] = index_map
    return _np(tree)


def _rand(rng, *shape, std=0.02):
    return (rng.randn(*shape) * std).astype(np.float32)


def _head(seed, d_in, d_out):
    """A JAX prompt head with non-trivial LayerNorm affines, so their
    gradients are held too."""
    head = _np(JPU.init_prompt_transform_head(new_rng(seed), d_in, d_out))
    rng = np.random.RandomState(seed)
    for ln in (head["ln_pre"], head["ln_post"], head["block"]["ln_1"], head["block"]["ln_2"]):
        ln["scale"] = (1 + _rand(rng, d_in, std=0.1))
        ln["bias"] = _rand(rng, d_in, std=0.1)
    return head


def _close(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, largest = np.abs(got - want).max(), np.abs(want).max()
    assert err <= REL * largest, f"{what}: max err {err:.3g} of largest {largest:.3g}"


def _against_jax(jfwd, tfwd, frozen, batch, trainable, aux, **kw):
    """Logits and the loss's gradient of every trainable leaf, both
    packages; returns the port's logits and gradients by leaf name."""
    jp, tp = frozen
    images, labels = batch

    def jloss(tr):
        logits = jfwd(tr, jp, jax.tree_util.tree_map(jnp.asarray, aux), jnp.asarray(images),
                      clip_cfg=JCFG, compute_dtype=jnp.float32, **kw)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean(), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, trainable))
    ttr = params_from_numpy(trainable, "cpu")
    for t in leaves(ttr):
        t.requires_grad_(True)
    tlogits = tfwd(ttr, tp, params_from_numpy(aux, "cpu"), torch.from_numpy(images),
                   clip_cfg=TCFG, compute_dtype=torch.float32, **kw)
    loss = torch.nn.functional.cross_entropy(tlogits, torch.from_numpy(labels).long())
    tgrads = torch.autograd.grad(loss, leaves(ttr))
    _close("logits", tlogits.detach(), jlogits)
    names = list(_flat(ttr))
    jflat = _flat(_np(jgrads))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        assert np.abs(jflat[name]).max() > 0, f"JAX's gradient of {name} is zero"
        _close(f"gradient of {name}", g, jflat[name])
    return tlogits.detach(), dict(zip(names, tgrads))


@pytest.mark.parametrize("csc", [False, True], ids=["shared", "csc"])
@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_coop_forward_and_gradients(frozen, batch, position, csc):
    n_ctx = 4
    rng = np.random.RandomState(1)
    ctx = _rand(rng, *((len(CLASSNAMES),) if csc else ()), n_ctx, 64)
    aux = _class_aux(frozen[0], n_ctx, " ".join(["X"] * n_ctx), position)
    _against_jax(JCO.coop_forward, TCO.coop_forward, frozen, batch, {"ctx": ctx}, aux)


def test_coop_ctx_init(frozen, batch):
    """CTX_INIT: the phrase's embeddings as the context, the phrase as the
    prompts' prefix (``coop.py:56``), the class token in the middle."""
    jp = frozen[0]
    ctx = np.asarray(JPU.ctx_vectors_from_init(jp["text"], "a photo of a", 4))
    got = TPU.ctx_vectors_from_init(frozen[1]["text"], "a photo of a", 4)
    np.testing.assert_array_equal(got.numpy(), ctx)
    aux = _class_aux(jp, 4, "a photo of a", "middle")
    _against_jax(JCO.coop_forward, TCO.coop_forward, frozen, batch, {"ctx": ctx}, aux)


@pytest.mark.parametrize("templates", [["a photo of a {}."],
                                       IMAGENET_TEMPLATES_SELECT + [CUSTOM_TEMPLATES["Synthetic"]]],
                         ids=["one", "ensemble"])
def test_zero_shot_text_and_logits(frozen, batch, templates):
    """The template encode (each template's rows EOT-truncated) and the
    zero-shot logits against the cached text features."""
    jp, tp = frozen
    want = JZS._encode_templates(jp, JCFG, CLASSNAMES, templates, jnp.float32)
    got = TZS._encode_templates(tp, TCFG, CLASSNAMES, templates, torch.float32, "cpu")
    _close("text features", got, want)
    images = batch[0]
    jl = JZS._zs_inference(None, jp, {"text_features": jnp.asarray(want)}, jnp.asarray(images),
                           clip_cfg=JCFG, compute_dtype=jnp.float32)
    tl = TZS._zs_inference(None, tp, {"text_features": torch.from_numpy(np.asarray(want))},
                           torch.from_numpy(images), clip_cfg=TCFG,
                           compute_dtype=torch.float32)
    _close("zero-shot logits", tl, jl)


@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_index_map_and_composition(frozen, position):
    """The port's class buffers, index map and composed prompts equal the
    JAX package's, for shared, class-specific and per-instance ctx; each
    map row is a permutation of the bank's columns."""
    jp, tp = frozen
    n_ctx = 3
    jaux = JPU.embed_classnames(jp["text"], CLASSNAMES, n_ctx, "X X X")
    taux = TPU.embed_classnames(tp["text"], CLASSNAMES, n_ctx, "X X X")
    assert taux.name_lens == jaux.name_lens == [1, 1, 2, 3]
    L = jaux.effective_length()
    assert taux.effective_length() == L
    jmap = JPU.build_position_index_map(position, jaux.name_lens, n_ctx, L)
    tmap = TPU.build_position_index_map(position, taux.name_lens, n_ctx, L)
    if position == "end":
        assert jmap is None and tmap is None
    else:
        np.testing.assert_array_equal(tmap, jmap)
        assert all(sorted(row) == list(range(L)) for row in tmap)
    jt, tt = jaux.as_device_tree(), taux.as_device_tree()
    for k in jt:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]))
    rng = np.random.RandomState(7)
    for shape in ((n_ctx, 64), (len(CLASSNAMES), n_ctx, 64)):
        ctx = _rand(rng, *shape)
        want = JPU.compose_prompts(jnp.asarray(ctx), jt["token_prefix"], jt["token_suffix"],
                                   None if jmap is None else jnp.asarray(jmap))
        got = TPU.compose_prompts(torch.from_numpy(ctx), tt["token_prefix"],
                                  tt["token_suffix"], tmap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # per instance: B copies, each its own shared ctx (JAX: a vmap)
    ctx = _rand(rng, B, n_ctx, 64)
    want = jax.vmap(functools.partial(JPU.compose_prompts, prefix=jt["token_prefix"],
                                      suffix=jt["token_suffix"],
                                      index_map=None if jmap is None else jnp.asarray(jmap)))(
        jnp.asarray(ctx))
    ctx4 = torch.from_numpy(ctx)[:, None].expand(-1, len(CLASSNAMES), -1, -1)
    got = TPU.compose_prompts(ctx4, tt["token_prefix"], tt["token_suffix"], tmap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
