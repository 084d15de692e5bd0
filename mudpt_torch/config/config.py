"""Typed configuration tree with the reference's cascade semantics (a
copy of ``mudpt_tpu/config/config.py``: the same tree, defaults, YAML
cascade, ``KEY VALUE`` opts and ``trainer_params()``, so one YAML file or
command line configures either package).

The reference uses a yacs ``CfgNode`` cascade (reference train.py:136-150):
defaults -> ``extend_cfg`` code defaults (train.py:68-133) -> dataset YAML ->
trainer YAML -> CLI overrides -> trailing ``KEY VALUE`` opts -> freeze.  The
trainer code then reads hyperparameters reflectively via
``eval(f"cfg.TRAINER.{cfg.TRAINER.NAME}...")`` (reference clip/model.py:220).

Here the same surface is provided by plain dataclasses:

  * every namespace the reference defines exists with the same field names
    and defaults (so the reference's YAML files and CLI opts work verbatim);
  * merging is type-checked against the declared field types;
  * unknown keys produce a warning, not a crash — this deliberately fixes the
    reference's stale ``TRAINER.MAPLE`` YAML keys (see SURVEY.md §2.5) which
    yacs would reject;
  * ``cfg.trainer_params()`` replaces the reflective ``eval``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import yaml


def _node(cls):
    """Decorator: a config namespace (dataclass with merge support)."""
    return dataclass(cls)


# ----------------------------------------------------------------------------
# Namespaces.  Field names are UPPERCASE to match the reference YAML keys.
# ----------------------------------------------------------------------------

@_node
class BackboneCfg:
    NAME: str = "ViT-B/16"
    PATH: str = ""  # local checkpoint path (reference train.py:78)


@_node
class ModelCfg:
    BACKBONE: BackboneCfg = field(default_factory=BackboneCfg)
    INIT_WEIGHTS: str = ""


@_node
class DatasetCfg:
    NAME: str = ""
    ROOT: str = ""
    NUM_SHOTS: int = 16              # reference train.py:80
    SUBSAMPLE_CLASSES: str = "all"   # all | base | new (train.py:79)
    # Synthetic-dataset sizing (repo-only dataset; no reference analogue).
    # Lets CLI smoke/e2e runs scale the in-memory dataset via KEY VALUE
    # overrides without touching the test defaults.
    SYNTHETIC_NUM_CLASSES: int = 4
    SYNTHETIC_PER_CLASS: int = 8


@_node
class LoaderSplitCfg:
    BATCH_SIZE: int = 32
    SAMPLER: str = "random"


@_node
class DataLoaderCfg:
    TRAIN_X: LoaderSplitCfg = field(default_factory=lambda: LoaderSplitCfg(BATCH_SIZE=32))
    TEST: LoaderSplitCfg = field(default_factory=lambda: LoaderSplitCfg(BATCH_SIZE=100, SAMPLER="sequential"))
    NUM_WORKERS: int = 8
    PIPELINE: str = "threads"  # threads (PIL) | tfdata (tf.data) | grain
    # multi-rank input strategy for TRAINING and EVAL (the JAX package's
    # hosts are the port's data indices; ranks that share one decode the
    # same items):
    #   "auto" (default) — each data index decodes a disjoint item shard and
    #     its slice of the global batch (decode work scales 1/n_data)
    #     whenever the batch size divides by the data axis; falls back to
    #     replicated decode otherwise.  Single-process runs are unaffected.
    #   True/"on" — require sharding (error if the batch is indivisible);
    #   False/"off" — every rank decodes the same seed-deterministic global
    #     batch and takes its rows (the one process's batches).
    HOST_SHARD: str = "auto"


@_node
class InputCfg:
    SIZE: Tuple[int, int] = (224, 224)
    INTERPOLATION: str = "bicubic"
    PIXEL_MEAN: Tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    PIXEL_STD: Tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)
    TRANSFORMS: Tuple[str, ...] = ("random_resized_crop", "random_flip", "normalize")


@_node
class OptimCfg:
    NAME: str = "sgd"
    LR: float = 0.002
    MAX_EPOCH: int = 10
    LR_SCHEDULER: str = "cosine"
    WARMUP_EPOCH: int = 1
    WARMUP_TYPE: str = "constant"
    WARMUP_CONS_LR: float = 1e-5
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 5e-4
    SGD_DAMPNING: float = 0.0
    SGD_NESTEROV: bool = False


@_node
class TrainCfg:
    PRINT_FREQ: int = 5
    CHECKPOINT_FREQ: int = 0  # 0 => only final epoch
    PROFILE_DIR: str = ""     # XProf trace dir; traces epoch-0 steps when set
    # SIGTERM (SLURM preemption / host maintenance) => finish the in-flight
    # step, write model-preempt.pth.tar (weights + optimizer state + exact
    # batch position), exit cleanly; RESUME continues bit-identically
    CHECKPOINT_ON_SIGTERM: bool = True
    # Block quantization (ops/quant_block.py):
    # 'int8' = W8A8 serving/eval forward, dynamic per-row activation
    # scales (inference-only — use with --eval_only / ZeroshotCLIP);
    # 'int8_static' = same, with per-tensor scales calibrated on one
    # training batch at build (no per-row quant chain in the kernel);
    # 'int8_ste' = quantization-aware prompt tuning (same int8 forward +
    # straight-through backward); 'int8_ste_static' = QAT against the
    # calibrated static serving tier (train/serve numerics match a
    # pallas_int8_static artifact exactly)
    QUANT: str = "none"


@_node
class TestCfg:
    EVALUATOR: str = "Classification"
    SPLIT: str = "test"
    FINAL_MODEL: str = "last_step"  # or "best_val"
    NO_TEST: bool = False
    PER_CLASS_RESULT: bool = False


# --- per-trainer hyperparameter namespaces (reference train.py:68-133) ------

@_node
class CoOpCfg:
    N_CTX: int = 16
    CTX_INIT: str = ""
    PREC: str = "fp16"   # fp16 | fp32 | amp (fp16 and amp map to bf16)
    CSC: bool = False
    CLASS_TOKEN_POSITION: str = "end"  # end | middle | front


@_node
class CoCoOpCfg:
    N_CTX: int = 16
    CTX_INIT: str = ""
    PREC: str = "fp16"
    CSC: bool = False
    CLASS_TOKEN_POSITION: str = "end"
    # micro-batch size for the per-instance text encode (the O(B·n_cls)
    # blowup that forced the reference to batch 1 on ImageNet,
    # cocoop.py:187-193 + SURVEY.md §7).  0 = auto: chunk so one micro-batch
    # encodes at most ~1024 full-length-row-equivalents of sequences —
    # EOT-truncated rows admit proportionally more instances
    # (trainers/cocoop.py _resolve_chunk derives the bound); -1 = never
    # chunk.
    ENCODE_CHUNK: int = 0


@_node
class VPTCfg:
    DEEP_TEXT_N_CTX: int = 0
    DEEP_VISUAL_N_CTX: int = 0
    TEXT_PROMPT_DEPTH: int = 0
    VISUAL_PROMPT_DEPTH: int = 0
    TEXT_CTX_INIT: str = "a photo of a"
    PREC: str = "fp16"


@_node
class MPTCfg:
    DEEP_TEXT_N_CTX: int = 0
    DEEP_VISUAL_N_CTX: int = 0
    TEXT_PROMPT_DEPTH: int = 0
    VISUAL_PROMPT_DEPTH: int = 0
    TEXT_CTX_INIT: str = "a photo of a"
    PREC: str = "fp16"


@_node
class MuDPTCfg:
    N_CTX: int = 2
    CTX_INIT: str = "a photo of a"
    DEEP_PROMPT_DEPTH: int = 8
    PREC: str = "fp16"


@_node
class UMuDPTCfg:
    N_CTX: int = 2
    CTX_INIT: str = "a photo of a"
    DEEP_PROMPT_DEPTH: int = 8
    PREC: str = "fp16"


@_node
class UUMuDPTCfg:
    N_CTX: int = 2
    CTX_INIT: str = "a photo of a"
    DEEP_PROMPT_DEPTH: int = 8
    PREC: str = "fp16"


@_node
class TrainerCfg:
    NAME: str = ""
    COOP: CoOpCfg = field(default_factory=CoOpCfg)
    COCOOP: CoCoOpCfg = field(default_factory=CoCoOpCfg)
    VPT: VPTCfg = field(default_factory=VPTCfg)
    MPT: MPTCfg = field(default_factory=MPTCfg)
    MUDPT: MuDPTCfg = field(default_factory=MuDPTCfg)
    UMUDPT: UMuDPTCfg = field(default_factory=UMuDPTCfg)
    UUMUDPT: UUMuDPTCfg = field(default_factory=UUMuDPTCfg)


@_node
class PerfCfg:
    """Kernel / memory / numerics policy.  Applied at trainer build
    (config/perf.py).  Precedence per knob: module default < programmatic
    setter (tests, A/B tools) < explicit config value; the port reads no
    environment variables.  The RESOLVED live values are recorded in
    ``metrics.jsonl`` (kind=perf_config), so a run's numerics envelope
    reproduces from its config dump alone.  ``TRAIN.QUANT`` is the
    quantization knob (kept under TRAIN: it changes the training
    objective, not just execution)."""

    BLOCK: str = "auto"           # auto | pallas | xla   (models/layers)
    SAVE_ACTS: bool = True        # save-activations backward (ops/fused_block)
    SAVE_MLP_WIDE: str = "auto"   # auto | 1 | 0 — wide-MLP h-save, D in (768,1024]
    SCAN_UNROLL: str = "auto"     # auto (full unroll) | int  (models/transformer)
    REMAT: str = "none"           # none | selective | full  (XLA block impl)
    TEXT_PACK: int = 0            # 0 auto | 1 off | G rows per kernel row
    TEXT_TRUNC: str = "auto"      # auto (EOT-truncate) | 0 (full 77 rows)
    TEXT_RECOMPUTE: str = "auto"  # auto | 0 (save) | 1 (recompute)
    LN: str = "fp32"              # fp32 (reference parity) | bf16 (experiment)

    # "explicit config value" in the precedence chain means SET, not
    # merely different-from-default: a YAML/CLI write of a knob at its
    # default (e.g. ``PERF.BLOCK auto`` to recover from a leaked
    # set_block_impl) must still reapply.  Post-init writes are recorded
    # here; config/perf.py consults it.
    def __post_init__(self):
        object.__setattr__(self, "_touched", set())

    def __setattr__(self, k, v):
        object.__setattr__(self, k, v)
        touched = getattr(self, "_touched", None)
        if touched is not None and not k.startswith("_"):
            touched.add(k)


@_node
class ParallelCfg:
    """Device mesh layout (the JAX package's), one rank a device under
    ``torch.distributed`` (``parallel/mesh.py``).  DATA shards the batch,
    MODEL shards the class axis of the text tower.  DATA 0 = the ranks
    divided by MODEL."""
    DATA: int = 0
    MODEL: int = 1


@_node
class Config:
    SEED: int = 1
    OUTPUT_DIR: str = "./output"
    RESUME: str = ""
    USE_CUDA: bool = True  # accepted for reference-config compatibility; the device is the trainer's argument
    VERBOSE: bool = True
    MODEL: ModelCfg = field(default_factory=ModelCfg)
    DATASET: DatasetCfg = field(default_factory=DatasetCfg)
    DATALOADER: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    INPUT: InputCfg = field(default_factory=InputCfg)
    OPTIM: OptimCfg = field(default_factory=OptimCfg)
    TRAIN: TrainCfg = field(default_factory=TrainCfg)
    TEST: TestCfg = field(default_factory=TestCfg)
    TRAINER: TrainerCfg = field(default_factory=TrainerCfg)
    PARALLEL: ParallelCfg = field(default_factory=ParallelCfg)
    PERF: PerfCfg = field(default_factory=PerfCfg)

    # -- reflective hyperparameter access (replaces the reference's eval) ----
    def trainer_params(self, name: Optional[str] = None):
        name = (name or self.TRAINER.NAME).upper()
        aliases = {"ZEROSHOTCLIP": None, "ZEROSHOTCLIP2": None}
        if name in aliases:
            return None
        if not hasattr(self.TRAINER, name):
            raise KeyError(f"No hyperparameter namespace TRAINER.{name}")
        return getattr(self.TRAINER, name)

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def __str__(self) -> str:
        return _pformat(self)


# ----------------------------------------------------------------------------
# Merge machinery
# ----------------------------------------------------------------------------

# string-typed fields whose value space is {"auto", "True", "False"} and so
# legitimately accept YAML booleans
_TRI_STATE_KEYS = frozenset({"DATALOADER.HOST_SHARD"})

# string-typed knobs whose value space includes numerals ("auto" | "0" | "1"
# | an int) — YAML writes those as integers, which merge as their string form
_STRINGLY_SCALAR_KEYS = frozenset(
    {
        "PERF.SAVE_MLP_WIDE",
        "PERF.SCAN_UNROLL",
        "PERF.TEXT_TRUNC",
        "PERF.TEXT_RECOMPUTE",
    }
)


def _coerce(value: Any, target: Any, key: str):
    """Coerce a YAML/CLI value to the type of the existing field value."""
    if isinstance(value, str):
        # yacs-style: "(224, 224)" and "1e-5" arrive as strings
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if isinstance(target, bool):
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        if isinstance(value, float) and value != int(value):
            raise TypeError(f"{key}: expected int, got {value!r}")
        if isinstance(value, (int, float)):
            return int(value)
    if isinstance(target, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(target, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if (
        isinstance(target, str)
        and isinstance(value, int)
        and not isinstance(value, bool)
        and key in _STRINGLY_SCALAR_KEYS
    ):
        return str(value)
    if isinstance(target, str) and isinstance(value, bool):
        # ONLY the tri-state fields accept YAML booleans (reference-config
        # compatibility); a bool landing in any other string field (e.g.
        # ``PIPELINE: true``) is a typo and should fail at merge time
        if key in _TRI_STATE_KEYS:
            return "True" if value else "False"
    if isinstance(target, str) and value is None:
        return ""
    if type(value) is type(target) or target is None:
        return value
    raise TypeError(
        f"{key}: cannot merge {value!r} ({type(value).__name__}) into "
        f"{type(target).__name__}"
    )


def _merge_dict(node: Any, d: dict, prefix: str = "") -> None:
    for k, v in d.items():
        key = f"{prefix}{k}"
        if not hasattr(node, k):
            warnings.warn(f"Unknown config key {key!r}; ignored", stacklevel=2)
            continue
        cur = getattr(node, k)
        if dataclasses.is_dataclass(cur):
            if not isinstance(v, dict):
                raise TypeError(f"{key}: expected a mapping, got {v!r}")
            _merge_dict(cur, v, prefix=key + ".")
        else:
            setattr(node, k, _coerce(v, cur, key))


def merge_from_file(cfg: Config, path: str) -> Config:
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    _merge_dict(cfg, d)
    return cfg


def merge_from_list(cfg: Config, opts: List[str]) -> Config:
    """Merge trailing ``KEY VALUE`` pairs (reference train.py:148)."""
    if opts is None:
        return cfg
    if len(opts) % 2 != 0:
        raise ValueError(f"Override list must have even length, got {opts}")
    for k, v in zip(opts[0::2], opts[1::2]):
        node = cfg
        parts = k.split(".")
        for p in parts[:-1]:
            if not hasattr(node, p):
                warnings.warn(f"Unknown config key {k!r}; ignored", stacklevel=2)
                node = None
                break
            node = getattr(node, p)
        if node is None:
            continue
        leaf = parts[-1]
        if not hasattr(node, leaf):
            warnings.warn(f"Unknown config key {k!r}; ignored", stacklevel=2)
            continue
        setattr(node, leaf, _coerce(v, getattr(node, leaf), k))
    return cfg


def default_config() -> Config:
    return Config()


def load_config(
    dataset_config: Optional[str] = None,
    trainer_config: Optional[str] = None,
    opts: Optional[List[str]] = None,
    **overrides: Any,
) -> Config:
    """Reference cascade (train.py:136-150): defaults -> dataset yaml ->
    trainer yaml -> explicit CLI overrides -> trailing opts."""
    cfg = default_config()
    if dataset_config:
        merge_from_file(cfg, dataset_config)
    if trainer_config:
        merge_from_file(cfg, trainer_config)
    for k, v in overrides.items():
        if v in (None, ""):
            continue
        merge_from_list(cfg, [k, v if isinstance(v, str) else repr(v)])
    if opts:
        merge_from_list(cfg, list(opts))
    return cfg


def _pformat(node: Any, indent: int = 0) -> str:
    lines = []
    pad = "  " * indent
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if dataclasses.is_dataclass(v):
            lines.append(f"{pad}{f.name}:")
            lines.append(_pformat(v, indent + 1))
        else:
            lines.append(f"{pad}{f.name}: {v}")
    return "\n".join(lines)


def to_dict(node: Any) -> dict:
    return dataclasses.asdict(node)
