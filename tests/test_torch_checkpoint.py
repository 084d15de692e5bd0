"""Checkpoints across the packages: a trainable tree saved by either
package's ``utils/checkpoint`` loads in the other exactly (the same flat
npz, filenames and meta), and ``load_clip_checkpoint`` of a tiny CLIP state
dict built here and written with ``torch.save`` (and of the converted
``.npz`` either package writes) gives the same parameter tree and config in
both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudpt_tpu.models import convert as JC
from mudpt_tpu.utils import checkpoint as JK

from mudpt_torch.models import convert as TC
from mudpt_torch.models.clip import leaves
from mudpt_torch.utils import checkpoint as TK

NAME = "MultimodalDeepPromptTuning"


def _trainable(rs):
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ctx": f(2, 64), "deep_prompts": f(2, 2, 64),
            "embed_projection": {"w": f(64, 32), "b": f(32)},
            "visual_ctx": f(2, 32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_jax_checkpoint_loads_in_port(tmp_path):
    rs = np.random.RandomState(0)
    src = jax.tree_util.tree_map(jnp.asarray, _trainable(rs))
    opt = (jnp.asarray(rs.standard_normal(3).astype(np.float32)), jnp.int32(7))
    path = JK.save_checkpoint(str(tmp_path), NAME, 3, src, opt_state=opt, is_best=True,
                              meta={"trainer": "MuDPT", "best_val": 12.5})
    assert path.endswith(f"{NAME}/model.pth.tar-3")
    template = TC.params_from_numpy(jax.tree_util.tree_map(np.zeros_like, _trainable(rs)), "cpu")
    for epoch in (3, None):  # the epoch file and model-best.pth.tar
        loaded, opt_leaves, meta = TK.load_checkpoint(str(tmp_path), NAME, epoch)
        tree = TK.restore_into(template, loaded)
        want, got = _flat(src), _flat(tree)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert meta == {"epoch": 3, "trainer": "MuDPT", "best_val": 12.5}
        np.testing.assert_array_equal(opt_leaves[0], np.asarray(opt[0]))
        assert int(opt_leaves[1]) == 7


def test_port_checkpoint_loads_in_jax(tmp_path):
    rs = np.random.RandomState(1)
    src = TC.params_from_numpy(_trainable(rs), "cpu")
    for t in leaves(src):  # as the trainer holds them
        t.requires_grad_(True)
    opt = [np.asarray(5, np.int64), torch.randn(2, 64)]
    TK.save_checkpoint(str(tmp_path), NAME, 0, src, opt_state=opt, tag="preempt",
                       meta={"batches_done": 3, "global_step": 3})
    loaded, opt_leaves, meta = JK.load_checkpoint(str(tmp_path), NAME, tag="preempt")
    template = jax.tree_util.tree_map(jnp.zeros_like, _trainable(rs))
    tree = JK.restore_into(template, loaded, strict=True)
    want, got = _flat(src), _flat(tree)
    for k in want:
        assert got[k].dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].detach().numpy())
    assert meta["epoch"] == 0 and meta["batches_done"] == 3 and meta["global_step"] == 3
    assert int(opt_leaves[0]) == 5
    np.testing.assert_array_equal(opt_leaves[1], opt[1].numpy())


def _state_dict(rs, width=64, layers=2, patch=16, grid=2, tw=64, vocab=300, embed=32):
    def f(*s):
        return torch.from_numpy(rs.standard_normal(s).astype(np.float32))

    sd = {"visual.conv1.weight": f(width, 3, patch, patch),
          "visual.class_embedding": f(width),
          "visual.positional_embedding": f(grid * grid + 1, width),
          "visual.ln_pre.weight": f(width), "visual.ln_pre.bias": f(width),
          "visual.ln_post.weight": f(width), "visual.ln_post.bias": f(width),
          "visual.proj": f(width, embed),
          "token_embedding.weight": f(vocab, tw), "positional_embedding": f(77, tw),
          "ln_final.weight": f(tw), "ln_final.bias": f(tw), "text_projection": f(tw, embed),
          "logit_scale": torch.tensor(4.6), "input_resolution": torch.tensor(patch * grid),
          "context_length": torch.tensor(77), "vocab_size": torch.tensor(vocab)}
    for prefix, w in (("visual.transformer.resblocks", width), ("transformer.resblocks", tw)):
        for i in range(layers):
            p = f"{prefix}.{i}."
            sd.update({p + "ln_1.weight": f(w), p + "ln_1.bias": f(w),
                       p + "attn.in_proj_weight": f(3 * w, w), p + "attn.in_proj_bias": f(3 * w),
                       p + "attn.out_proj.weight": f(w, w), p + "attn.out_proj.bias": f(w),
                       p + "ln_2.weight": f(w), p + "ln_2.bias": f(w),
                       p + "mlp.c_fc.weight": f(4 * w, w), p + "mlp.c_fc.bias": f(4 * w),
                       p + "mlp.c_proj.weight": f(w, 4 * w), p + "mlp.c_proj.bias": f(w)})
    return sd


def _same_clip(jres, tres):
    (jcfg, jparams), (tcfg, tparams) = jres, tres
    # both configs carry the ResNet field, empty for a ViT
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert jcfg.vision_layers_per_stage == tcfg.vision_layers_per_stage == ()
    want, got = _flat(jparams), _flat(tparams)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_load_clip_checkpoint_same_tree(tmp_path, first):
    """Each package converts its own copy of the .pt; the .npz cache the
    first writes beside the second copy is read by the other."""
    sd = _state_dict(np.random.RandomState(2))
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    torch.save(sd, a)
    torch.save(sd, b)
    jres = JC.load_clip_checkpoint(str(a))
    tres = TC.load_clip_checkpoint(str(b))
    _same_clip(jres, tres)
    assert tres[0].vision_width == 64 and tres[0].image_resolution == 32
    assert tres[0].transformer_layers == 2 and tres[0].vocab_size == 300
    # the conversion caches: each package reads the other's
    if first == "jax":
        _same_clip(jres, TC.load_clip_checkpoint(str(a)))
    else:
        _same_clip(JC.load_clip_checkpoint(str(b)), tres)
    # and a converted .npz named directly
    TC.save_npz_params(str(tmp_path / "c.npz"), *tres)
    _same_clip(JC.load_npz_params(str(tmp_path / "c.npz")), TC.load_clip_checkpoint(
        str(tmp_path / "c.npz")))


def test_load_backbone_sources(tmp_path, monkeypatch):
    """MODEL.BACKBONE.PATH: a local file loads as load_clip_checkpoint does;
    a missing one raises, and so does PATH unset with no ~/.cache/clip file
    once the download fails (replaced here by one that raises, as it would
    without a network); 'random' inits the named config."""
    from mudpt_torch.config import default_config
    from mudpt_torch.models import download
    from mudpt_torch.trainers.base import load_backbone

    def no_download(name, root="~/.cache/clip"):
        raise OSError("no network")

    monkeypatch.setattr(download, "download_model", no_download)

    torch.save(_state_dict(np.random.RandomState(3)), tmp_path / "clip.pt")
    cfg = default_config()
    cfg.MODEL.BACKBONE.PATH = str(tmp_path / "clip.pt")
    _same_clip(TC.load_clip_checkpoint(str(tmp_path / "clip.pt")), load_backbone(cfg, "cpu"))
    cfg.MODEL.BACKBONE.PATH = str(tmp_path / "missing.pt")
    with pytest.raises(FileNotFoundError, match="not found"):
        load_backbone(cfg, "cpu")
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg.MODEL.BACKBONE.PATH = ""
    with pytest.raises(RuntimeError, match="is not cached at"):
        load_backbone(cfg, "cpu")
    cfg.MODEL.BACKBONE.PATH, cfg.MODEL.BACKBONE.NAME = "random", "test-tiny"
    clip_cfg, params = load_backbone(cfg, "cpu")
    assert clip_cfg.vision_width == 64 and params["visual"]["blocks"]["mlp"]["fc_w"].shape == (
        2, 64, 256)
