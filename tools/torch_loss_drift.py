#!/usr/bin/env python3
"""How far the kernels move the MuDPT ViT-B/16 loss and gradients from the
plain path at batch 64, on one GPU, where that difference comes from, and
what two faulty routes read beside it: the readings behind the limits of
``chip_smoke.py``'s ``[engine]``.

    python3 tools/torch_loss_drift.py

For the engine of ``chip_smoke.py`` (``build_trainer`` on the MuDPT YAML
and the synthetic dataset, 16 classes, batches of 64), at SEED 0, 1 and 2,
it prints for each of epoch 1's six batches, and for the six as one batch
of 384:

- ``chip_smoke.grad_readings``: the loss's relative difference between the
  kernels and the plain versions on the card (``plain_blocks``), the worst
  leaf's gradient error and the worst ratio of distances to fp32;
- the per-sample loss differences d (kernels minus plain), split into the
  text tower's part (the kernels' image pass against the kernels' and the
  plain class text features) and the image tower's part (against the
  plain text features, kernels and plain image passes): for each, the
  mean and spread relative to the loss, the intraclass correlation by
  label and the effective number of independent samples it gives, n / (1
  + (m - 1) ICC) for m samples a class; the batch's loss difference is d's
  mean, so its spread shrinks as 1 / sqrt(effective samples);
- for each batch of 64, ``grad_readings`` of two faulty plain routes in
  place of the kernels: QuickGELU taken of the MLP's pre-activation rounded
  to bf16 (a lost fp32 step), and an erf GELU for QuickGELU.

Then the same for random images (standard normal, as
``build_synth_mudpt_step`` draws them) through the seed-0 trainer and for
``build_synth_mudpt_step`` at batch 64 (16 and 100 classes, seeds 0-2).
Last, the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import copy
import statistics
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def intraclass(d, labels):
    """(ICC, effective samples) of the per-sample values d grouped by
    label: one-way analysis of variance, m0 the mean group size."""
    groups = {}
    for v, y in zip(d, labels):
        groups.setdefault(int(y), []).append(float(v))
    n, k = len(d), len(groups)
    if not 1 < k < n:  # one class, or no class with two samples
        return float("nan"), float(n)
    mean = sum(map(float, d)) / n
    ssb = sum(len(g) * (statistics.fmean(g) - mean) ** 2 for g in groups.values())
    ssw = sum((v - statistics.fmean(g)) ** 2 for g in groups.values() for v in g)
    msb, msw = ssb / (k - 1), ssw / (n - k)
    m0 = (n - sum(len(g) ** 2 for g in groups.values()) / n) / (k - 1)
    if msb + (m0 - 1) * msw == 0:  # every d equal: no spread to share out
        return 0.0, float(n)
    icc = (msb - msw) / (msb + (m0 - 1) * msw)
    return icc, n / (1 + (m0 - 1) * max(icc, 0.0))


@contextlib.contextmanager
def faulty_plain(gelu):
    """The plain route with the MLP's activation taken by ``gelu`` of the
    fp32 pre-activation h (saved h rounded as before)."""
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.ops import fused_block as FB

    prev = FB._PLAIN

    def gemm(a, w, bias, epilogue, extra=None, out=None):
        if epilogue not in ("fc_gelu", "fc_gelu_save"):
            return FB.gemm_epilogue_plain(a, w, bias, epilogue, extra, out)
        _, w_nk = FB._epilogue(epilogue)
        h = torch.matmul(a.float(), w.float().t() if w_nk else w.float()) + bias.float()
        act = gelu(h).to(a.dtype)
        return (h.to(a.dtype), act) if epilogue == "fc_gelu_save" else act

    FB._PLAIN = (prev[0], gemm, *prev[2:])
    try:
        with plain_blocks():
            yield
    finally:
        FB._PLAIN = prev


def with_fault(st, gelu):
    """``st`` whose kernel pass runs the faulty plain route instead; the
    plain pass (inside ``plain_blocks``) stays plain."""
    from mudpt_torch.models import layers

    def loss_fn(images, labels):
        if layers._PLAIN_ON_CUDA:
            return st.loss_fn(images, labels)
        with faulty_plain(gelu):
            return st.loss_fn(images, labels)

    return SimpleNamespace(**{**vars(st), "loss_fn": loss_fn})


def main() -> int:
    import torch

    import chip_smoke as C
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F
    from mudpt_torch.trainers.mudpt import mudpt_image_logits, mudpt_text_features
    from mudpt_torch.utils.synth_step import build_synth_mudpt_step

    if not torch.cuda.is_available():
        print("torch_loss_drift: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()

    def quick(h):
        return h.bfloat16().float() * torch.sigmoid(1.702 * h.bfloat16().float())

    controls = {"h rounded": quick, "erf GELU": torch.nn.functional.gelu}

    def step_state(trainable, frozen, aux, clip_cfg, images, labels, n_cls):
        """The grad_readings namespace of a MuDPT step, and its towers."""
        kw = dict(clip_cfg=clip_cfg, compute_dtype=torch.bfloat16)

        def text():
            return mudpt_text_features(trainable, frozen, aux, **kw)

        def image(im, txt):
            return mudpt_image_logits(trainable, frozen, aux, im, txt, **kw)[:, :n_cls].float()

        def loss_fn(im, lb):
            return nll(image(im, text()), lb).mean()

        return SimpleNamespace(trainable=trainable, params=frozen, aux=aux, clip_cfg=clip_cfg,
                               images=images, labels=labels, loss_fn=loss_fn,
                               text=text, image=image)

    def nll(logits, labels):
        return -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]

    def per_sample(st) -> str:
        """Per-sample loss differences, the text tower's part and the
        image tower's part (logits of the kernels' image pass against the
        plain text features, then both plain)."""
        im, lb = st.images, st.labels
        with torch.enable_grad():  # the train step's saving route
            txt_k = st.text()
            k = nll(st.image(im, txt_k), lb).detach()
            with plain_blocks():
                txt_p = st.text()
            kp = nll(st.image(im, txt_p), lb).detach()
            with plain_blocks():
                p = nll(st.image(im, txt_p), lb).detach()
        loss = p.double().mean().item()
        out = [f"loss {loss:.6f}"]
        for what, d in (("per-sample d", k - p), ("text part", k - kp), ("image part", kp - p)):
            d = d.double().cpu()
            icc, eff = intraclass(d.tolist(), lb.tolist())
            out.append(f"{what}: mean {d.mean().item() / loss:+.3g}, sd {d.std().item() / loss:.3g}"
                       f" of the loss, ICC by label {icc:.3f}, effective samples {eff:.1f} of "
                       f"{len(d)}")
        return "; ".join(out)

    def grads(st) -> str:
        r = C.grad_readings(F, st)
        return (f"loss rel {r['rel']:.3g}, worst gradient err {r['worst']:.4g}, worst ratio "
                f"{r['worst_ratio']:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        for seed in (0, 1, 2):
            tr = C._engine_trainer(ROOT, f"{tmp}/out{seed}", "SEED", str(seed))
            batches = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]

            def engine_st(images, labels, tr=tr):
                st = step_state(tr.trainable, tr.frozen, tr.aux, tr.clip_cfg, images, labels,
                                tr.num_classes)
                valid = torch.ones_like(labels, dtype=torch.bool)
                st.loss_fn = lambda im, lb: tr.loss_fn(  # the trainer's masked loss
                    {"image": im, "label": lb, "valid": valid})[0]
                return st

            for i, b in enumerate(batches):
                st = engine_st(b["image"], b["label"])
                print(f"engine seed {seed} batch {i} of 64: {grads(st)}; {per_sample(st)}",
                      flush=True)
                print("  controls, faulty plain route vs plain: " + "; ".join(
                    f"{name}: {grads(with_fault(st, gelu))}" for name, gelu in controls.items()),
                    flush=True)
            st = engine_st(torch.cat([b["image"] for b in batches]),
                           torch.cat([b["label"] for b in batches]))
            print(f"engine seed {seed} epoch 1 as one batch of {len(st.labels)}: {grads(st)}; "
                  f"{per_sample(st)}", flush=True)
            if seed == 0:
                gen = torch.Generator(device=st.images.device).manual_seed(0)
                for i, b in enumerate(batches):
                    im = torch.randn(b["image"].shape, generator=gen, device=st.images.device,
                                     dtype=b["image"].dtype)
                    st = engine_st(im, b["label"])
                    print(f"engine seed 0 batch {i}, random images: {grads(st)}; "
                          f"{per_sample(st)}", flush=True)
            del tr, batches, st
    for seed in (0, 1, 2):
        for n_cls in (16, 100):
            syn = build_synth_mudpt_step("ViT-B/16", 64, n_cls, 2, 9, seed=seed)
            st = step_state(syn.trainable, syn.params, syn.aux, syn.clip_cfg, syn.images,
                            syn.labels, n_cls)
            print(f"build_synth_mudpt_step batch 64, {n_cls} classes, seed {seed}: "
                  f"{grads(st)}; {per_sample(st)}", flush=True)
            del syn, st
    print(C.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
