"""Which activation and weight dtypes reach the int8 tiers' dispatch
(``models/layers._quant_block``) from the trainer configs the repository
ships.

``_quant_block`` takes the block's weights and biases in x's dtype and
raises on a mix, where the JAX package's kernels cast their operands to
x's dtype (``mudpt_tpu/ops/fused_block.py:301-315``).  A config that
reached a mix would run in the JAX package and raise in the port.  So each
trainer YAML under ``configs/trainers/`` (the top-level ones are the
zero-shot pair's) is built at the zoo tests' cut (test-tiny, random
weights, 32 px, batch 4, prompt depths 2, the synthetic dataset) with the
PREC the YAML sets (none does: the trainers' default, bf16), under every
``TRAIN.QUANT`` tier the JAX package accepts for it; one evaluation
forward and, where the trainer trains, one training loss pass through the
dispatch, whose dtypes are recorded.  Every record is one dtype: no
shipped config reaches a mix.  The static tiers on CoCoOp, UMuDPT and
UUMuDPT raise the JAX package's ``ValueError`` at build in both packages
(``test_torch_zoo_quant_static.py``, ``test_torch_cocoop_quant.py``)."""

from pathlib import Path

import pytest
import torch

from mudpt_torch.config import load_config
from mudpt_torch.models import layers as TL
from mudpt_torch.ops import quant_block as TQ
from mudpt_torch.trainers import build_trainer

ROOT = Path(__file__).resolve().parent.parent
TIERS = ("int8", "int8_static", "int8_ste", "int8_ste_static")
# the static tiers the JAX package refuses at build: CoCoOp's text depends
# on the image (no calibration text), the unified trainers' prompt heads
# enter the text capture
REFUSED = {("CoCoOp", "int8_static"), ("CoCoOp", "int8_ste_static"),
           ("UMuDPT", "int8_static"), ("UMuDPT", "int8_ste_static"),
           ("UUMuDPT", "int8_static"), ("UUMuDPT", "int8_ste_static")}
# the prompt depths cut to test-tiny's layers, by trainer
DEPTHS = {"MuDPT": ("DEEP_PROMPT_DEPTH",), "UMuDPT": ("DEEP_PROMPT_DEPTH",),
          "UUMuDPT": ("DEEP_PROMPT_DEPTH",), "VPT": ("VISUAL_PROMPT_DEPTH",),
          "MPT": ("VISUAL_PROMPT_DEPTH", "TEXT_PROMPT_DEPTH")}
CUT = ("MODEL.BACKBONE.NAME", "test-tiny", "MODEL.BACKBONE.PATH", "random",
       "INPUT.SIZE", "(32, 32)", "DATALOADER.TRAIN_X.BATCH_SIZE", "4",
       "DATALOADER.TEST.BATCH_SIZE", "4")


def _configs() -> list:
    """(YAML relative to the repository, trainer): a trainer directory's
    YAMLs with its trainer; the top-level ones with the zero-shot pair
    (scripts/zsclip/run_zsclip.sh)."""
    out = []
    for path in sorted((ROOT / "configs" / "trainers").rglob("*.yaml")):
        rel = str(path.relative_to(ROOT))
        if path.parent.name == "test":
            continue  # tiny.yaml, the tests' own config
        if path.parent.name == "trainers":
            out += [(rel, "ZeroshotCLIP"), (rel, "ZeroshotCLIP2")]
        else:
            out.append((rel, path.parent.name))
    return out


CONFIGS = _configs()


@pytest.fixture(autouse=True)
def _restore_modes():
    prev = torch.get_num_threads(), TL.quant_mode()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev[0])
    TL.set_quant_mode(prev[1])


def _record(monkeypatch) -> list:
    """Each call of ``_quant_block``: (x's dtype, the set of the four
    projections' weight and bias dtypes)."""
    seen, orig = [], TL._quant_block

    def rec(p, x, n_head, causal, mask):
        seen.append((x.dtype, {p[g][f"{n}_{k}"].dtype for g, n in TQ._PROJ for k in "wb"}))
        return orig(p, x, n_head, causal, mask)

    monkeypatch.setattr(TL, "_quant_block", rec)
    return seen


def test_every_shipped_trainer_config_is_covered():
    trainers = {t for _, t in CONFIGS}
    assert trainers == {"CoOp", "CoCoOp", "VPT", "MPT", "MuDPT", "UMuDPT", "UUMuDPT",
                        "ZeroshotCLIP", "ZeroshotCLIP2"}
    assert len(CONFIGS) == 17


@pytest.mark.parametrize("quant", TIERS)
@pytest.mark.parametrize("yaml,trainer", CONFIGS, ids=[f"{t}:{Path(y).name}" for y, t in CONFIGS])
def test_no_config_reaches_a_dtype_mix(tmp_path, monkeypatch, yaml, trainer, quant):
    opts = ["TRAINER.NAME", trainer, "OUTPUT_DIR", str(tmp_path), "TRAIN.QUANT", quant, *CUT]
    for key in DEPTHS.get(trainer, ()):
        opts += [f"TRAINER.{trainer.upper()}.{key}", "2"]
    cfg = load_config("configs/datasets/synthetic.yaml", str(ROOT / yaml), opts=opts)
    if (trainer, quant) in REFUSED:
        with pytest.raises(ValueError):
            build_trainer(cfg, devices="cpu")
        return
    seen = _record(monkeypatch)
    tr = build_trainer(cfg, devices="cpu")
    assert TL.quant_mode() == quant
    images = torch.from_numpy(next(iter(tr.dm.test_loader))["image"])
    with torch.no_grad():
        tr.forward(tr.trainable, tr.frozen, tr.aux, images)
    if tr.trainable is not None:
        tr.loss_fn(tr._device_batch(next(iter(tr.dm.train_loader))))
    assert seen, "no block reached the int8 dispatch"
    mixes = {(str(x), tuple(sorted(map(str, ws)))) for x, ws in seen if ws != {x}}
    assert not mixes, f"{trainer} {quant}: activation vs weight dtypes {mixes}"
    assert {x for x, _ in seen} == {torch.bfloat16}  # the YAMLs' PREC: the default, bf16
