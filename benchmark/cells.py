"""The two kinds of cell: MuDPT prompt-tuning steps and cached-text serving.

Each has a program side, which drives the port (``mudpt_torch``) the way
its trainer and evaluator do, and a reference side, which runs the plain
reference of ``benchmark/reference`` on the same inputs made anew from the
seed, after the program's state is freed.

Training: ``trainers.mudpt.mudpt_forward``, the NLL of its logits,
``loss.backward()`` and ``torch.optim.SGD`` with momentum over the
trainable leaves; steps dispatched back to back over a pool of distinct
seeded batches, the loss read on the host every ``loss_every`` steps (the
loop's only synchronization, as ``TRAIN.PRINT_FREQ`` logs it).  Set-up runs
the first ``check_steps`` (one on each batch of the pool) through the same
step, optimizer and feed that the window then goes on with, and keeps the
losses, the first gradient (the momentum buffer after step 1) and each
leaf's change, which the reference follows.

Serving: ``trainers.mudpt.mudpt_text_features`` once at set-up, cached;
then one client in a closed loop, each request ``mudpt_image_logits`` on
its images against the cached features, the argmax on the device, fetched
to the host.  A seeded reservoir keeps the logits and served classes of a
few requests, and of one of the largest, for the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import inputs, tracing
from benchmark.metrics import work
from benchmark.reference import clip_mudpt as ref
from benchmark.spec import ROOT

CLIP_KEYS = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
             "vision_patch_size", "context_length", "vocab_size", "transformer_width",
             "transformer_heads", "transformer_layers")
# a traffic file's tier -> the port's quant mode, by mode
QUANT = {"train": {"bf16": "none"}, "serve": {"bf16": "none", "int8": "int8"}}
# a tier -> the reference's rounding of it, and of the precision below it
# (the control: fp8 for bf16, int4 for int8)
REF_QUANT = {"bf16": None, "int8": "int8"}
CONTROL_QUANT = {"bf16": "fp8", "int8": "int4"}
TRACE_DIR = str(ROOT / "build" / "benchmark")


@dataclasses.dataclass
class Program:
    """What a program run measured and kept."""
    setup_s: float
    timed_s: float                   # the window, or its untraced part in a traced run
    units: int                       # steps or requests in it
    images: int
    latencies: List[float]           # seconds per request (serving)
    timed_ops: List[work.Op]
    peak_bytes: int
    readings: dict
    trace: Optional[tracing.Trace] = None
    traced_units: int = 0
    traced_ops: List[work.Op] = dataclasses.field(default_factory=list)

    # what the per-layer readers of ``benchmark/metrics`` read; None where
    # the run has nothing to read (no trace, no kernel of the family)

    def mfu(self) -> Optional[float]:
        """% of the untraced window the model's operations need at the peaks."""
        return 100 * work.total(self.timed_ops, kind="ops") / self.timed_s if self.timed_s else None

    def roofline(self, family: str, patterns) -> Optional[float]:
        """% of the family's device time its work needs at the roofline."""
        spent = self.trace.family_s(patterns) if self.trace else 0.0
        return 100 * work.total(self.traced_ops, family) / spent if spent else None

    def launches_per_unit(self) -> Optional[float]:
        return self.trace.launches / self.traced_units if self.trace else None

    def idle_share(self) -> Optional[float]:
        return 100 * self.trace.idle_share() if self.trace else None


def log(t_start: float, what: str) -> None:
    """A set-up phase's end, on standard error, in seconds from the start."""
    print(f"[{time.perf_counter() - t_start:8.3f} s] {what}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _setup_port(cell, seed: int, dev, quant: str):
    """(CLIPConfig, parameter tree, aux tree, eot positions) of the port."""
    from mudpt_torch.models.clip import CLIPConfig
    from mudpt_torch.ops import quant_block
    from mudpt_torch.trainers.prompt_utils import ClassPromptAux

    cfg, n_cls = cell.config, cell.traffic["n_cls"]
    params = inputs.to_port(inputs.make_weights(cfg, seed, dev))
    ids, eot = inputs.class_tokens(n_cls, cfg["n_ctx"], cfg["context_length"], seed)
    table = params["text"]["token_embedding"]
    emb = table[torch.from_numpy(ids).to(table.device)].float()
    aux = ClassPromptAux(eot_idx=eot.astype(np.int32), token_prefix=emb[:, :1],
                         token_suffix=emb[:, 1 + cfg["n_ctx"]:], n_ctx=cfg["n_ctx"],
                         name_lens=list(eot - cfg["n_ctx"] - 2)).as_device_tree()
    if quant != "none":
        for tower in ("visual", "text"):
            params[tower]["blocks"] = quant_block.quantize_blocks(params[tower]["blocks"])
    return CLIPConfig(**{k: cfg[k] for k in CLIP_KEYS}), params, aux, eot


def _trace_path(cell) -> str:
    """A fixed path in the checkout, overwritten by each traced run."""
    return os.path.join(TRACE_DIR, f"{cell.name}.json")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def program_train(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
                  fault: Optional[str] = None) -> Program:
    """Set-up, the checked steps, the window; ``fault`` breaks the step:
    'state_unchanged' (no optimizer step) or 'half_batch' (the step on half
    of its batch, the mean over it)."""
    from mudpt_torch.models.layers import quantized
    from mudpt_torch.trainers.mudpt import mudpt_forward

    cfg, tf = cell.config, cell.traffic
    tier = tf["tier"]
    quant = QUANT["train"][tier]
    B, every, pool = tf["batch"], tf["loss_every"], tf["pool_batches"]
    res = cfg["image_resolution"]
    log(t_start, "imports")
    clip_cfg, params, aux, eot = _setup_port(cell, seed, dev, quant)
    _sync(dev)
    log(t_start, "weights")
    trainable = inputs.make_trainable(cfg, seed, dev)
    named = inputs.leaf_items(trainable)
    p0 = {k: t.clone() for k, t in named}
    for _, t in named:
        t.requires_grad_(True)
    images = inputs.images(pool * B, res, seed, 5, dev).view(pool, B, res, res, 3)
    labels = inputs.labels((pool, B), tf["n_cls"], seed, 6, dev)
    opt = torch.optim.SGD([t for _, t in named], lr=tf["lr"], momentum=tf["momentum"])
    rows = B // 2 if fault == "half_batch" else B

    def step(i: int, mark=lambda what: None) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        x, y = images[i % pool, :rows], labels[i % pool, :rows]
        with quantized(quant):
            logits = mudpt_forward(trainable, params, aux, x, clip_cfg=clip_cfg,
                                   compute_dtype=torch.bfloat16)
        loss = F.cross_entropy(logits.float(), y)
        mark("forward")
        loss.backward()
        mark("backward")
        if fault != "state_unchanged":
            opt.step()
        mark("optimizer step")
        return loss.detach()

    def mark(what: str) -> None:
        _sync(dev)
        log(t_start, f"checked step 1: {what}")

    losses, grad1 = [], {}
    for i in range(tf["check_steps"]):
        losses.append(float(step(i, mark) if i == 0 else step(i)))
        log(t_start, f"checked step {i + 1}")
        if i == 0:
            grad1 = {k: opt.state[t]["momentum_buffer"].to("cpu", copy=True) if t in opt.state
                     else torch.zeros_like(t, device="cpu") for k, t in named}
    change = {k: (t.detach() - p0[k]).cpu() for k, t in named}
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    done = [tf["check_steps"]]

    def next_step() -> torch.Tensor:
        done[0] += 1
        return step(done[0] - 1)

    def loop(budget_s: float, min_steps: int = 0):
        n, t0 = 0, time.perf_counter()
        while True:
            loss = next_step()
            n += 1
            if n % every == 0:
                float(loss)
                if n >= min_steps and time.perf_counter() - t0 >= budget_s:
                    return n, time.perf_counter() - t0

    n, timed = loop(seconds / 2 if trace else seconds, every)
    step_ops = work.train_step_ops(cfg, B, eot, tier)
    out = Program(setup_s=setup_s, timed_s=timed, units=n, images=n * B, latencies=[],
                  timed_ops=step_ops * n, peak_bytes=0,
                  readings={"losses": losses, "grad1": grad1, "change": change})
    if trace:
        path = tracing.traced(lambda: loop(0.0, every), lambda: float(next_step()), dev,
                              _trace_path(cell))
        out.trace = tracing.read_trace(path)
        out.traced_units, out.traced_ops = every, step_ops * every
    out.peak_bytes = _peak(dev)
    return out


def reference_train(cell, seed: int, dev, quant: Optional[str] = None) -> dict:
    """The reference's losses, first gradient and changes over the checked
    steps, from the seed's inputs; ``quant`` rounds its products (the
    control)."""
    cfg, tf = cell.config, cell.traffic
    B, pool, res = tf["batch"], tf["pool_batches"], cfg["image_resolution"]
    sd = ref.fp32_weights(inputs.openai_state_dict(inputs.make_weights(cfg, seed, dev)))
    tr0 = inputs.make_trainable(cfg, seed, dev)
    ids, eot = inputs.class_tokens(tf["n_cls"], cfg["n_ctx"], cfg["context_length"], seed)
    images = inputs.images(pool * B, res, seed, 5, dev).view(pool, B, res, res, 3)
    labels = inputs.labels((pool, B), tf["n_cls"], seed, 6, dev)
    batches = [(images[i % pool], labels[i % pool]) for i in range(tf["check_steps"])]
    with ref.exact_fp32():
        losses, grad1, after = ref.train(sd, cfg, tr0, torch.from_numpy(ids).to(dev),
                                         torch.from_numpy(eot).to(dev), batches, tf["lr"],
                                         tf["momentum"], cfg["reference_chunk"], quant)
    p0 = dict(inputs.leaf_items(tr0))
    return {"losses": losses, "grad1": {k: v.cpu() for k, v in grad1.items()},
            "change": {k: (after[k] - p0[k]).cpu() for k in p0}}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class Sample:
    """A seeded reservoir of ``k`` requests of the window, and one of the
    requests of the largest size."""

    def __init__(self, k: int, largest: int, seed: int):
        self.k, self.largest = k, largest
        self.rng = inputs.host_rng(seed, 8)
        self.kept: list = []
        self.big = None
        self.seen = self.seen_big = 0

    def offer(self, item: tuple) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item
        if item[1] == self.largest:
            self.seen_big += 1
            if self.rng.randrange(self.seen_big) == 0:
                self.big = item

    def items(self) -> list:
        """(index, size, offset, logits, served) of each kept request."""
        out = {it[0]: it for it in self.kept}
        if self.big is not None:
            out[self.big[0]] = self.big
        return [out[i] for i in sorted(out)]


def program_serve(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
                  fault: Optional[str] = None) -> Program:
    """Set-up (text features, each request size once), the window;
    ``fault`` breaks each request: 'altered_answer' changes its first answer
    on the device where it is produced, 'half_request' answers its second
    half of images from the first half's pixels."""
    from mudpt_torch.models.layers import quantized
    from mudpt_torch.trainers.mudpt import mudpt_image_logits, mudpt_text_features

    cfg, tf = cell.config, cell.traffic
    tier = tf["tier"]
    quant, n_cls = QUANT["serve"][tier], tf["n_cls"]
    sizes, pool_n = tf["request_sizes"], tf["image_pool"]
    log(t_start, "imports")
    clip_cfg, params, aux, _ = _setup_port(cell, seed, dev, quant)
    _sync(dev)
    log(t_start, "weights")
    tr = inputs.make_trainable(cfg, seed, dev)
    kw = dict(clip_cfg=clip_cfg, compute_dtype=torch.bfloat16)
    with torch.inference_mode(), quantized(quant):
        txt = mudpt_text_features(tr, params, aux, **kw)
    _sync(dev)
    log(t_start, "text features")
    pool = inputs.images(pool_n, cfg["image_resolution"], seed, 7, dev)
    schedule = inputs.RequestSchedule(sizes, pool_n, seed)

    def request(n: int, off: int):
        x = pool[off:off + n]
        if fault == "half_request":
            x = torch.cat([x[:n // 2], x[:n - n // 2]])
        t0 = time.perf_counter()
        with torch.inference_mode(), quantized(quant):
            logits = mudpt_image_logits(tr, params, aux, x, txt, **kw)
            pred = logits.argmax(-1)
            if fault == "altered_answer":
                pred[0] = (pred[0] + 1) % n_cls
        served = pred.cpu()
        return time.perf_counter() - t0, logits, served

    for n in sorted(set(sizes)):
        request(n, 0)
    _sync(dev)
    log(t_start, "one request of each size")
    setup_s = time.perf_counter() - t_start
    sample = Sample(tf["check_requests"], max(sizes), seed)
    done = [0]

    def loop(budget_s: float, cycles: bool):
        """Requests until ``budget_s`` has passed, with ``cycles`` only
        after a whole cycle of sizes, so every window holds the same mix."""
        lats, images, t0 = [], 0, time.perf_counter()
        while True:
            i = done[0]
            n, off = schedule[i]
            lat, logits, served = request(n, off)
            sample.offer((i, n, off, logits, served))
            lats.append(lat)
            images += n
            done[0] += 1
            if (not cycles or done[0] % len(sizes) == 0) and time.perf_counter() - t0 >= budget_s:
                return lats, images, time.perf_counter() - t0

    first = done[0]
    lats, images, timed = loop(seconds / 2 if trace else seconds, True)
    ops = [op for i in range(first, done[0])
           for op in work.request_ops(cfg, schedule[i][0], n_cls, tier)]
    out = Program(setup_s=setup_s, timed_s=timed, units=len(lats), images=images,
                  latencies=lats, timed_ops=ops, peak_bytes=0, readings={})
    if trace:
        begin = []

        def window():
            begin.append(done[0])
            for _ in range(2):
                loop(0.0, True)

        path = tracing.traced(window, lambda: loop(0.0, True), dev, _trace_path(cell))
        out.trace, out.traced_units = tracing.read_trace(path), done[0] - begin[0]
        out.traced_ops = [op for i in range(begin[0], done[0])
                          for op in work.request_ops(cfg, schedule[i][0], n_cls, tier)]
    out.peak_bytes = _peak(dev)
    out.readings = {"requests": [(i, n, off, lg.float().cpu(), s)
                                 for i, n, off, lg, s in sample.items()]}
    return out


def reference_serve(cell, seed: int, dev, requests,
                    quant: Optional[str]) -> Dict[tuple, torch.Tensor]:
    """{(size, offset): reference logits} of the requests' images."""
    cfg, tf = cell.config, cell.traffic
    sd = ref.fp32_weights(inputs.openai_state_dict(inputs.make_weights(cfg, seed, dev)))
    tr = inputs.make_trainable(cfg, seed, dev)
    ids, eot = inputs.class_tokens(tf["n_cls"], cfg["n_ctx"], cfg["context_length"], seed)
    pool = inputs.images(tf["image_pool"], cfg["image_resolution"], seed, 7, dev)
    out = {}
    with ref.exact_fp32(), torch.no_grad():
        txt = ref.encode_text(sd, cfg, tr, torch.from_numpy(ids).to(dev),
                              torch.from_numpy(eot).to(dev), quant)
        for n, off in requests:
            if (n, off) not in out:
                out[(n, off)] = ref.serve_logits(sd, cfg, tr, txt, pool[off:off + n],
                                                 2 * cfg["reference_chunk"], quant).cpu()
    return out


# ---------------------------------------------------------------------------
# one cell, both sides
# ---------------------------------------------------------------------------

PROGRAMS: Dict[str, Callable] = {"train": program_train, "serve": program_serve}


def compare(cell, seed: int, r: dict, dev, reference: Optional[dict] = None) -> Dict[str, float]:
    """The numbers of :mod:`benchmark.check` for a run's readings ``r``
    (``Program.readings``); the reference is computed unless given (a
    training cell's readings, or a serving cell's {(size, offset): logits})."""
    from benchmark import check

    if cell.traffic["mode"] == "train":
        ref_r = reference or reference_train(cell, seed, dev, REF_QUANT[cell.traffic["tier"]])
        return check.train_numbers(r["losses"], r["grad1"], r["change"],
                                   ref_r["losses"], ref_r["grad1"], ref_r["change"])
    reqs = [(n, off) for _, n, off, _, _ in r["requests"]]
    ref_l = reference or reference_serve(cell, seed, dev, reqs, REF_QUANT[cell.traffic["tier"]])
    return check.serve_numbers([(lg, s, ref_l[(n, off)]) for _, n, off, lg, s in r["requests"]])


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
