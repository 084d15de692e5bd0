#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's MuDPT serving paths and train steps on one
GPU, ViT-B/16, ViT-L/14 and ViT-L/14@336px, its training engine, CLI, trainer
zoo, dataset pipelines, mesh and bench entry point, the int8 tiers at ViT-B/16 and
ViT-L/14, over the zoo and in CoCoOp, the RN presets, its chunked MLP
half-block, the kernel chains on fp32 activations (PREC fp32), the int8
tiers on fp32 activations, its serving artifacts, REMAT, the XLA block
route, the text tower's switches, the tools, the feature extractor and
reference (Dassl) checkpoints, and the user-facing layer (clip_forward,
validate_zeroshot, the bench's --remat, the trainer's trace).

    python3 chip_smoke.py
    python3 chip_smoke.py --times-of ROOT   # only the kernel times of the
                                            # checkout at ROOT and the digests
                                            # of its bf16 LayerNorms and int8
                                            # kernels and of its fp32 s8 GEMM
                                            # (A/B of two trees)
    python3 chip_smoke.py --steps-of ROOT   # only the fp32 trainer's step
                                            # and encode ms with the package of
                                            # the checkout at ROOT (A/B of two
                                            # trees end to end)
    python3 chip_smoke.py --mesh-rank RANK WORLD PORT JOB   # one gloo rank of
                                            # [mesh], started by the phase
    python3 chip_smoke.py --cli-launches ARGS   # python -m mudpt_torch.train
                                            # ARGS, then its launches (for [fp32]
                                            # and [fp32 int8])

Phases, each printed with the card's name and power limit:

  1. device   CUDA present; TF32 off for the plain versions.
  2. build    nvcc builds mudpt_torch/csrc/*.cu (parallel, one per source).
  3. kernels  every kernel against its plain PyTorch version at the shapes
              of the ViT-B/16 serving path and train step, with the
              kernel's, the plain version's and one library call's time (the
              library call is a yardstick, never used by the port), and the
              bound from bytes and operations, and each GEMM epilogue and
              attention_bwd launched twice on the same inputs, bit-equal;
              attention_fwd and attention_bwd at every block length from 16
              to 1,024 rows (their tiles resident and streamed), every mask
              spec, attention_fwd's both output forms; then the whole layer
              against its plain version at D=768 and D=512, forward alone
              and forward with backward, and forward alone at the zoo's
              vision towers without a prompt (197 and 50 tokens).
  4. serving  build_synth_mudpt_server("ViT-B/16", 384, 100, 2, 9) on
              seeded random weights: encode the class text once, answer
              requests of 384 images, count kernel launches, check logits
              against the plain path on the card, report images/s.
  5. train    build_synth_mudpt_step("ViT-B/16", 384, 100, 2, 9): one step's
              loss and gradients of the ten trainable leaves against the
              plain path on the card, warm-up and timed steps (launches
              counted per step, losses finite), images/s, and a traced step.
  5a. engine  MuDPT ViT-B/16 through build_trainer (the MuDPT ViT-B/16
              YAML on the synthetic dataset: 16 classes, 384 training
              images at 224 px, batches of 64, two epochs, random weights):
              the trainer's first step against the plain route (its
              gradients at batch 64; loss and gradients on epoch 1's 384
              images as one batch), a traced train step's launches,
              one evaluate encoding the class text once over six batches,
              the trainer's step ms beside build_synth_mudpt_step's at batch
              64, and a run preempted after batch 3 of epoch 1 and resumed,
              its losses and final prompts bit-equal to the uninterrupted run.
  5b. bench   python -m mudpt_torch.bench in this process, --mode train and
              --mode eval at ViT-B/16, batch 384: one JSON line each, its
              value within 10% of the images/s of [train] and [serving].
  5c. zoo     every registered trainer through the port's CLI
              (mudpt_torch.train.main, in this process) on its own YAML,
              the synthetic dataset cut as [engine]'s, one epoch: CoOp
              (shared, and class-specific with the class token in the
              middle), VPT, MPT, UMuDPT, UUMuDPT at ViT-B/16, CoCoOp at
              ViT-B/32, ZeroshotCLIP and ZeroshotCLIP2.  For each that
              trains: its first step's gradients against the plain route
              (every leaf's finite and not zero), a traced step's launches
              by route, the epoch's step ms at the YAML's batch and the
              step at batch 64; for the zero-shot pair, text features and
              logits against the plain route; for each, one evaluate's
              launches (the class text once, cached, or a batch for CoCoOp)
              and images/s.  Then cocoop_forward at 1,000 classes, 4
              images: its text rows on the half-blocks with saves off at
              D = 512, unchunked and in chunks of two (checkpointed), each
              against the plain route, chunked against unchunked, launches
              held (the recompute: one more text forward a chunk), peak
              memory lower chunked.
  5d. datasets  MuDPT ViT-B/16 base-to-new on JPEGs: a Caltech101-layout
              tree (100 classes + the reader's two ignored folders, 40
              images a class at 300 x 240 px), 16 shots, through the CLI
              on the MuDPT and Caltech101 YAMLs (one epoch, batch 64), under
              DATALOADER.PIPELINE threads, grain and tfdata: the step's
              median ms in the epoch loop, a traced step fed by the loader
              (its launches held, the idle share), --eval_only on the new
              classes (evaluate images/s), a run preempted after batch 3
              and resumed bit-equal under grain and tfdata, grain's eval
              batches bit-equal to threads'; then TRAIN.QUANT
              int8_ste_static through the CLI (calibration seconds, the
              first step's gradients against the plain route, the static
              chain's launches a step, the loader's epoch kept) and
              int8_static after --eval_only loads the checkpoint (the
              recalibration; launches, logits against the plain route);
              then python -m mudpt_torch.bench --input threads|grain|tfdata
              at batch 384 (images/s, H2D MB/s beside [train]'s resident).
  5e. mesh    the mesh on torch.distributed (mudpt_torch/parallel).  NCCL
              takes one rank a card: MuDPT ViT-B/16 through the CLI at
              [engine]'s configuration under torchrun --nproc_per_node 1
              (NCCL) against the same run without a process group, losses,
              final prompts and test accuracy bit-equal; then two gloo
              ranks sharing the card (python3 chip_smoke.py --mesh-rank,
              the kernels built by this process first; all_reduce,
              broadcast and all_gather of CUDA tensors probed) run MuDPT
              on meshes (2,1) and (1,2) and CoCoOp on (1,2), ViT-B/16,
              global batch 64, MESH_STEPS steps through the CLI's trainer,
              each held against one process on the same global batches
              (MESH_* limits: every step's loss, the first step's
              gradients, against one process's two halves where the data
              axis splits the batch, the prompts after the last step, the
              test confusion matrix's total and accuracy), the replicas
              bit-equal after every step, a checkpoint saved by rank 0
              and loaded on every rank; a rank's launches a step.
  6. kernels ViT-L/14   the same at the ViT-L/14 shapes (vision 1024 wide,
              259 tokens, 16 heads; text 768 wide, 12 heads), the two
              recompute epilogues, attention at 8 blocks of 384 rows, and
              the four half-block chains, forward alone and forward with
              backward, qkv and h saved and recomputed, and the halves at
              CoCoOp's packed text rows (D = 512, 8 heads), recomputed.
  7. serving ViT-L/14   as 4, for build_synth_mudpt_server("ViT-L/14", ...).
  8. train ViT-L/14     gradients against the plain path and an fp32 plain
              step at batch 32, twice: the vision MLP recomputing h, then
              2,560 classes, whose text tower trains with saves off; then
              timed steps at batch 384 (the vision MLP recomputes h there),
              launches per step, peak device memory and a traced step.
  8b. kernels ViT-L/14@336px, serving ViT-L/14@336px, train ViT-L/14@336px
              every kernel at the 336px shapes (577 + n_ctx = 579 vision
              rows, M = 384 x 579 = 222,336: LayerNorm, every GEMM mode of
              the step, attention_fwd and attention_bwd beside SDPA), then
              serving as 4, then the train step as 8: gradients against the
              plain path and fp32 at batch 32 with h recomputed, timed steps
              at batch 384, the vision saves reckoned, peak memory.
  9. kernels int8   the int8 kernels against their plain versions at the
              ViT-B/16 shapes (LayerNorm-quant, the row quantizer with a
              probe of exact ties, every s8 GEMM epilogue with torch._int_mm
              as its yardstick, attention_fwd's fp32 output), then the four
              int8 layer chains: the dynamic and the static forward, the
              saving forwards, and the quantization-aware forward with its
              backward, activations saved and recomputed.
 10. serving int8, serving int8_static   as 4, with quant="int8" and
              "int8_static" (calibrated at build), and the top-1 agreement
              with the bf16 tier on the same weights printed.
 11. train int8_ste, train int8_ste_static   as 5, quantization-aware.
 11a. kernels int8 ViT-L/14   as 9 at ViT-L/14's shapes (LayerNorm-quant at
              99,456 x 1024, the row quantizer at 1024 and 4096 columns, the
              s8 GEMM at 1024 -> 3072, 1024 -> 1024, 1024 -> 4096 with h
              saved or not, 4096 -> 1024, attention_fwd's fp32 output at 259
              rows and 16 heads), and the int8 chains there, the
              quantization-aware layer saving at batch 32 and recomputing at
              384 (the wide-MLP row-token budget); then serving ViT-L/14 int8
              and int8_static as 10, and train ViT-L/14 int8_ste as 8: the
              gradient check at batch 32 (h saved), the timed steps at 384
              (the q8 forward recomputed in the backward), launches of each.
 11b. zoo int8   every zoo trainer through the CLI under TRAIN.QUANT int8_ste
              at batch 64: the first step against the plain route, its
              launches by route; one evaluate of 64 images under int8 and,
              where the JAX package calibrates at build, int8_static.
 11c. cocoop int8   cocoop_forward at 1,000 classes under int8 (logits) and
              int8_ste (gradients), unchunked and chunked, each against the
              plain route, chunked bit-equal to unchunked; then a CoCoOp
              trainer's pallas_int8 artifact at a pinned batch of 64 served
              in a fresh process, bit-equal to the tier in this process, and
              timed.
 11d. rn       the RN presets: CoOp on RN50 through the CLI (the first step
              against the plain route, a traced step, step ms, evaluate
              images/s), one step of CoOp on RN50x4 (text 640 wide, 10 heads)
              and of CoCoOp on RN50; ZeroshotCLIP on RN50, RN101, RN50x4,
              RN50x16 and RN50x64 (its text encode's launches, an evaluate of
              64 images, images/s, peak memory, bf16 features against fp32
              with BatchNorm statistics drawn far from unit); the CoOp RN50
              pallas artifact served in a fresh process, bit-equal.
 12. kernels chunked   mlp_halfblock_chunked, the MLP half streamed over
              hidden-dim chunks: LayerNorm forward and dx at D = 1024 and
              1280; each GEMM of its chain at ViT-L/14's chunk (the fc
              weight's column chunk read in place, y and the fp32 dxn
              updated in place); then the op against its plain version,
              forward and forward with backward, launches per call held, at
              ViT-L/14's vision MLP (K = 8 chunks), ViT-B/16's (K = 2) and
              D = 1280 (K = 10), timed beside mlp_halfblock at ViT-L/14.
 12a. fp32     the kernel chains on fp32 activations, held to plain fp32
              torch ops with TF32 off: each fp32 kernel (layernorm_fwd and
              layernorm_bwd on fp32 rows, gemm_f32_epilogue in every mode,
              attention_fwd_f32 and attention_bwd_f32 with the vision and
              text masks) at the ViT-B/16 step's shapes, relaunched
              bit-equal, timed beside its plain version and a library call
              (F.layer_norm, torch.addmm, SDPA, in fp32); attention_f32
              both ways at 16-1,024 rows under every mask spec; the
              ViT-B/16 vision layer (forward, and the saving forward with
              dx), the half-blocks at D = 1024 (batch 32 x 259 tokens, 16
              heads), qkv and h saved and recomputed, forward and dx, and
              the chunked MLP half at D = 1280, each chain timed beside the
              plain chain with its fp32 bound (products at the 3xTF32 rate,
              4-byte activations); then MuDPT ViT-B/16 under
              TRAINER.MUDPT.PREC fp32:
              the CLI in a fresh process ([engine]'s configuration, one
              epoch and the test evaluate), fp32 kernels only; the
              trainer's first step (loss and every leaf's gradient) and the
              evaluate's logits against plain_blocks(); CoCoOp ViT-B/16 at
              1,000 classes x 4 images, one step; the step at 64 and at
              384 and the image encode at 384, beside bf16, peak memory.
 12b. fp32 int8   the int8 tiers on fp32 activations: layernorm_q8_f32
              (dynamic and static) and gemm_s8_epilogue_f32 (every mode, h
              saved or not) at ViT-B/16's and ViT-L/14's vision rows against
              their plain versions (codes within a step; qkv, R + v and h
              bit-equal), relaunched bit-equal, timed beside torch._int_mm;
              every mode at ragged tile edges (1000 x 80 -> 784 and 912);
              the four q8 chains on fp32 x at D = 768 (384 x 199) and 1024
              (32 x 259) under the bf16 int8 chains' limits, their launches
              those of the bf16 chains mapped to the fp32 kernels, timed
              with their fp32 bound; then
              MuDPT ViT-B/16 under PREC fp32: the CLI under int8_ste in a
              fresh process, through build_trainer the int8_ste and
              int8_ste_static first steps against the plain route, a traced
              step, the step at 64 and 384 and the encode at 384 beside
              [fp32]'s unquantized fp32 (the tiers in bf16: [train int8_ste*],
              [serving int8*]), the int8 and int8_static evaluates' logits;
              CoCoOp ViT-B/16 at 1,000 classes under int8_ste, chunked: the
              logits bit-equal, the gradients within 2^-16, the op where they
              part found by taps (the kernels replayed bit-equal); the zero-shot
              pallas_int8 artifact at its default fp32 served in a fresh
              process, an fp32 trainer's pallas and pallas_int8 artifacts
              served in this process, each bit-equal to its tier.
 13. export    MuDPT ViT-B/16 through build_trainer (its YAML on the
              synthetic dataset at 100 classes), one training step at batch
              64, then exported under the four serving tiers (xla: PyTorch
              ops, a symbolic batch; pallas, pallas_int8, pallas_int8_static:
              the kernel chains as custom ops, batch 384, the static tier
              calibrated on 64 training images); each artifact loaded and
              served on 384 test images in a fresh process (python3
              chip_smoke.py --serve-artifact ART IMAGES OUT GO), started as
              soon as its artifact is written so that its import and load
              overlap the next exports here, and serving only after every
              child has loaded and this process gives its word (no two timed
              windows on the card at once); its logits held to the tier in
              this process (bit-equality printed) and the xla tier's to the
              kernel route, its launches held, no model module imported by
              the loader; each timed by mudpt_torch.tools.bench_artifact's
              main at 384, in turn, the pallas tier within 10% of
              [serving]'s images/s; then a zero-shot classifier in fp32
              exported on the CPU under xla and served on the card against
              api.zero_shot_classifier.
 14. remat, remat ViT-L/14@336px   the train step at batch 384 under REMAT
              none and full: one step's loss and gradients bit-equal, launches
              (one more forward of every layer), peak memory lower under full;
              timed steps of each mode.
 15. block xla   the ViT-B/16 request under BLOCK xla (no kernel launched)
              held to the kernel route, timed and traced; one block 1280 wide
              (20 heads, 257 rows, batch 64), routed to XLA, in bf16 against
              fp32 on the card, timed.
 15a. probes    the two probes of tools/ on the port's kernels, run in this
              process through their entry points at the JAX probes' shapes
              (python -m mudpt_torch.tools.probe_int8_mxu: the tensor cores'
              rate, bf16 and s8, at 384 x 768 -> 3072, 16 slices a step, G
              64 and 320, and quant_rows at 384 x 768; python -m
              mudpt_torch.tools.probe_q8_residual: one ViT-B layer, 128 x
              200, under six modes, towers of 4 and 16 layers), their
              readings and launches; then each new kernel instance against
              its plain version: the s8 sums bit-equal where int32 wraps,
              the bf16 sums bit-equal on small integers (exact in fp32 in
              any order) and within stated limits on the probe's draws,
              each quantizer ablation of quant_rows bit-equal and of
              layernorm_q8 within a code step, q8_noclip's codes equal to
              q8's, q8_recip's within a step (share printed), the floor's
              convert saturating as XLA's, the floor GEMM's qkv and
              residual bit-equal, and each mode's layer within the q8
              chains' limits (q8_static and q8_floor, numerically off by
              the probe's design, within limits of their own); each timed
              beside its bound.
 15b. text switches   the text tower's three switches (PERF.TEXT_PACK,
              TEXT_TRUNC, TEXT_RECOMPUTE), every value, on the ViT-B/16
              text tower (512 x 12 layers, 8 heads) at 100 classes with
              deep prompts: features and the prompts' gradients against
              the plain route, the rows the tower takes (G to a row, 16 or
              77 tokens), the layers' route and launches; CoOp and
              ZeroshotCLIP built with PERF.TEXT_TRUNC 0 through the CLI
              (full rows; logits and text features against the plain
              route and the truncated rows'); attention on 77-token rows,
              unpacked and packed (80, 77), at the text tower's and
              CoCoOp's shapes, both ways, bf16 and fp32, against the plain
              versions, relaunched bit-equal, timed beside SDPA and the bound.
 15c. tools     the port's tools through main(argv) in this process, each
              line held to its keys: bench_cocoop at its defaults (CoCoOp
              ViT-B/16, 8 images x 1,000 classes), with --text-trunc 0,
              --mode eval --quant int8, and under TEXT_PACK 1 and
              TEXT_RECOMPUTE 0 and 1 (its peak memory; the rows its tower
              took); sweep_bench 384:none:pallas:save; profile_step at its
              defaults (device time by kernel; its trace's launches of each
              kernel equal to the counter's for the traced steps);
              bench_zoo --trainers CoOp CoCoOp --steps 2; run_protocol
              --synthetic (test-tiny, one dataset, one seed); launches held
              where the path is known.
 15d. periphery   python -m mudpt_torch.tools.feat_extractor in this process
              at ViT-B/16 (random weights, seed 0) on a Caltech101-layout
              JPEG tree of 20 classes x 40 images, splits train and test,
              --dtype bf16 and fp32: the files' keys and shapes, labels in
              the split's order, features against encode_image under
              plain_blocks() on the same images, launches per batch (the
              fp32 run on the fp32 kernels only), images/s; then a MuDPT
              ViT-B/16 trainer's seeded prompts saved, exported by
              tools.export_reference_checkpoint to a Dassl pickle and
              evaluated through python -m mudpt_torch.train --eval_only
              --model_dir <the exported dir> (accuracy and logits bit-equal
              to the native checkpoint's --eval_only, launches those of an
              evaluate), and imported back by
              tools.import_reference_checkpoint (the tree bit-equal).
 15e. api       the user-facing layer at ViT-B/16: api.clip_forward (random
              weights, 64 images x 100 prompts, bf16 and fp32): 12 + 12
              layers' launches on the dtype's kernels, logits_per_text the
              transpose, logits against the same call on the CPU's plain
              versions on 8 x 16, and the towers' features (encode_image,
              encode_text) against the CPU's on the same rows;
              validate_zeroshot.main in this process on
              a Caltech101 tree of 20 classes x 40 images with
              --backbone_path random: exit 1, its FAIL line's accuracy that
              of build_trainer(cfg).test() on the same config, launches a
              test batch and one text encode; mudpt_torch.bench at batch 384
              under --remat none and full: the final loss bit-equal, 24
              against 48 saving forwards a step, vs_baseline, each value within
              10% of [train]'s and [remat]'s; one epoch of [engine]'s
              trainer with TRAIN.PROFILE_DIR: the trace records one step
              (after its warmup step) and holds every launch the counter
              counted for it.
 16. processes   the loaders' worker processes, their forkserver and
              resource tracker stopped and waited for; any other process
              the run started and left running is killed and fails it.

The last three lines are one JSON object describing each kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.  Times in
the kernel object are totals over one vision layer's launches in the
ViT-B/16 train step (LayerNorm twice, the eight projections, attention once,
each way), under "vit_l14" and "vit_l14_336px" in the ViT-L/14 and
ViT-L/14@336px train steps (LayerNorm three times, nine projections),
under "int8" attention_fwd's fp32
output in the int8 request; the int8 kernels' totals are over one vision
layer of the int8 request, under "int8_static" of the int8_static request,
under "int8_vit_l14" and "int8_static_vit_l14" the same at ViT-L/14;
under "chunked" one call of the chunked MLP half's forward and backward at
ViT-L/14 (LayerNorm twice, 40 products, LayerNorm dx once).  The fp32
kernels (names ending in _f32, and gemm_f32_epilogue) have entries of
their own: totals over one vision layer of the fp32 ViT-B/16 step at batch
384, their launches those of the fp32 trainer's first step
("fp32_train_step"); the int8 tiers' fp32 kernels (layernorm_q8_f32,
gemm_s8_epilogue_f32) totals over one vision layer of the fp32 int8_ste
step, under "fp32_int8_ste_static" of the int8_ste_static one, their
launches those of the fp32 int8_ste trainer's step
("fp32_int8_ste_train_step"); the probes' kernels (probe_mma_bf16,
probe_mma_s8, and the ablations quant_rows_*, layernorm_q8_* and
gemm_s8_epilogue_floor) totals of one call of the rate kernel at G 64, or
over one layer of probe_q8_residual, their launches those of the probe's
entry point run in [probes] ("probe_int8_mxu", "probe_q8_residual"); under
"text_77" the four attention entries' (bf16 and fp32) totals over the
77-token cases of [text switches].  "launches"
counts the main path's run ("main_path": the ViT-B/16 train step, or the
int8 request), "launches_by_path" each path's ("engine_train_step": one
train step of the engine; "zoo_<trainer>_step" one of each zoo trainer,
"zoo_<trainer>_evaluate" the zero-shot pair's evaluate, "cocoop_scale_*"
CoCoOp at 1,000 classes, "datasets_<pipeline>_step" a loader-fed step,
"datasets_int8_ste_static_step" and "datasets_int8_static_evaluate" the
static tiers through the CLI; "serving_vit_l14_<tier>" and
"train_step_vit_l14_int8_ste" ViT-L/14's int8 paths; "periphery_feat_bf16"
and "periphery_feat_fp32" the feature extractor over both splits,
"periphery_reference_eval" the --eval_only of an exported Dassl checkpoint;
"api_clip_forward_<dtype>" one api.clip_forward call, "api_validate_zeroshot"
the tool's run, "api_bench_remat_full" the bench under --remat full,
"api_trainer_trace_epoch" the traced epoch; "zoo_<tier>_<trainer>_*"
the zoo under the int8 tiers; "cocoop_scale_<tier>_*" and
"cocoop_pallas_int8_artifact_request" CoCoOp's int8 paths; "rn_*" the RN
presets' steps and text encodes; "fp32_*" the fp32 paths (the half-block
chains, the CLI run, the trainer's step, the evaluate's batch, CoCoOp's
step; "fp32_int8*" and "fp32_*_artifact_request" the int8 tiers' fp32
paths); "export_<tier>_request" one request of each
served artifact in its fresh process, "remat_full_step*" a train step under
REMAT full, "block_xla_request" the text encode and request under BLOCK
xla, where no kernel runs).  Any failed
check raises, and the script exits non-zero without a result; so it does
without CUDA, and outside a checkout of the repository.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
# TF32 tensor cores, dense (NVIDIA data sheet, at 700 W): three TF32
# products (3xTF32) a product are the fastest fp32-accurate product the
# card has, the bound of an fp32 product's operations
PEAK_TF32_FLOPS = 494.7e12

# Kernel vs plain version: the same rounding points, but a different order
# of fp32 sums and hardware exp, rsqrt and division, so a bf16 rounding
# moves by one ulp only where the fp32 value lies next to a rounding
# boundary.  Each comparison is held to three limits:
MAX_ERR_OF_MAX = 2.0 ** -5  # max |err| <= 4 bf16 ulps of the largest value
NORM_ERR = 2.0 ** -8        # ||err|| <= the bf16 unit roundoff x ||ref||
# share of elements that are not bit-equal, one kernel alone: a rounding
# point moved or a different activation (erf GELU for QuickGELU; in the
# backward, ds from bf16(p), QuickGELU' of the unrounded h, a rounding
# before the residual) changes more than one element in sixteen
# (tests/test_torch_chip_checks.py), boundary cases about one in a thousand
# or fewer
DIFFER_SHARE = 2.0 ** -8
# the served path against the plain path on the card, 12 text or 12 vision
# layers deep, where one-ulp flips propagate
TEXT_MAX_ERR, TEXT_NORM_ERR = 2.0 ** -4, 2.0 ** -5      # text features
LOGITS_MAX_ERR, LOGITS_NORM_ERR = 2.0 ** -3, 2.0 ** -3  # logits, rows centred
# and the served logits' drift, within this share of their largest magnitude
LOGITS_DRIFT = 0.05
# the int8 tiers end to end.  Where the kernels' and the plain version's
# fp32 sums put a value on either side of a rounding boundary of an int8
# site, its code moves by a step of 1/127 of its row's (or the tensor's)
# absmax: twice a bf16 ulp of a value near that absmax.  The int8 checks of
# CoCoOp's logits and of the zoo's evaluates double the logits' limits, max
# and norm, and CoCoOp at 1,000 classes takes its [zoo] gradient limit
# (ZOO_GRAD_LIMITS, the spread over eight seeds: its logits over many
# near-equal classes pass flips on to the gradients).  A served ViT-L/14
# tower is 24 layers deep: its drift limit grows with the square root of
# the depth, as the gradient limit does (GRAD_DEPTH), and a loss over
# GRAD_BATCH images averages fewer samples than one over BATCH: its limit
# grows with the square root of their ratio (readings under PERF.md
# Findings)
Q8_STEP = 2.0

# fp32 outputs (the GEMM's store_f32): the sum order alone moves the last
# bits of nearly every element, so no bit-equal share is held; the error is
# that of fp32 sums of K bf16 products
F32_MAX_ERR, F32_NORM_ERR = 2.0 ** -15, 2.0 ** -16
# the chunked MLP half's y against the plain chain: rounded after each chunk
# as the plain chain rounds, so only one-ulp flips of the chunks' sums
# differ (readings 2.8e-4-4.6e-4); y rounded once after the fp32 sum of all
# chunks, the half-block's rounding, reads 5.0e-3
# (tests/test_torch_chip_checks.py)
CHUNK_Y_NORM_ERR = 2.0 ** -10
# the layer's dx against the plain chain: seven kernels deep, where one-ulp
# flips of bf16 intermediates propagate (limits under PERF.md Findings)
LAYER_DX_MAX_ERR, LAYER_DX_NORM_ERR = 2.0 ** -5, 2.0 ** -7
# one train step's gradients of the trainable leaves against the plain path
# on the card, both towers deep (relative norm error per leaf) and the loss.
# The gradient limit holds at 12 layers (ViT-B/16's towers); bf16 rounding
# adds up over the layers like a random walk, so a deeper tower's limit
# grows with the square root of its depth: ViT-L/14's 24 vision layers,
# 2^-4 x sqrt(2) (readings under PERF.md Findings, tools/torch_grad_noise.py)
GRAD_NORM_ERR, LOSS_REL_ERR = 2.0 ** -4, 2.0 ** -12
GRAD_DEPTH = 12
# and the kernels' gradients no further from the fp32 ones than this times
# the plain bf16 path's (the worst leaf).  Derived by
# tools/torch_grad_noise.py --ratio as the mean + 4 standard deviations of
# that ratio over eight seeds of each ViT-B/16 check (bf16, int8_ste,
# int8_ste_static at batch 384), rounded up to a tenth: 24 cases, mean
# 1.0547, sd 0.0595, largest 1.2118 (PERF.md).  The ViT-L/14 checks at batch
# 32 spread wider, as wide with the first port's attention_fwd as with the
# key-tiled one (16 cases each, one call: mean 1.1694 and 1.1818, sd 0.1504
# and 0.1748, largest 1.6162 and 1.5520; seed 0, this script's case,
# 1.24-1.41 as the kernels' rounding changed), the worst leaf being the
# one whose plain-vs-fp32 distance is least: the same rule gives 1.8 and
# 1.9
GRAD_FP32_RATIO, GRAD_FP32_RATIO_L14 = 1.3, 1.9

# int8 codes of the quantizing kernels against their plain versions.  The
# row quantizer and the s8 GEMM's qkv and residual epilogues compute the
# plain version's arithmetic exactly and are held bit-equal.  LayerNorm's
# statistics sum in another order and QuickGELU's exp is the card's, so
# there a code moves by one step where the fp32 value lies next to a
# rounding boundary: codes within one step, at most this share differing
CODE_STEP, CODE_SHARE = 1, 2.0 ** -8
# LayerNorm-quant's row scales: the row's absmax moves by an fp32 ulp or two
LN_SCALE_ERR = 2.0 ** -20
# the attention output in fp32 (the int8 layers quantize it unrounded): the
# card's exp moves a bf16 probability by an ulp now and then, and the fp32
# sums run in another order, so no element is held bit-equal; its codes are
ATTN_F32_MAX_ERR, ATTN_F32_NORM_ERR = 2.0 ** -5, 2.0 ** -12

BATCH, N_CLS, N_CTX, DEPTH = 384, 100, 2, 9
REQUESTS = 20
WARMUP_STEPS, TIMED_STEPS = 3, 10
# ViT-L/14 gradient checks: an fp32 plain step at batch 384 would not fit
# the card; 2,560 classes x 16 tokens = 40,960 text row-tokens, where the
# text tower trains with saves off (models/text._text_saves_off)
GRAD_BATCH, SAVES_OFF_N_CLS = 32, 2560

TPU = "mudpt_tpu/ops/fused_block.py"
FWD = f"{TPU}:851 _layer_fwd_nosave_kernel, :831 _layer_fwd_kernel"
BWD = f"{TPU}:868 _layer_bwd_kernel"
ATTN_FWD = ":318 _attn_fwd_kernel, :326 _attn_fwd_save_kernel"
MLP_FWD = ":403 _mlp_fwd_kernel, :415 _mlp_fwd_save_kernel"
ATTN_BWD = ":369 _attn_bwd_save_kernel, :358 _attn_bwd_kernel"
MLP_BWD = ":451 _mlp_bwd_save_kernel, :444 _mlp_bwd_kernel"
CHUNK_FWD, CHUNK_BWD = ":477 _mlp_chunk_fwd_kernel", ":500 _mlp_chunk_bwd_kernel"
Q8 = ("mudpt_tpu/ops/quant_block.py:89 _layer_fwd_q8_kernel, :178 _layer_fwd_q8_save_kernel, "
      ":377 _layer_fwd_q8_static_kernel, :563 _layer_fwd_q8_static_save_kernel")
REPLACES = {
    "layernorm_fwd": f"{FWD}, {ATTN_FWD}, {MLP_FWD}, :358 _attn_bwd_kernel, "
                     f":444 _mlp_bwd_kernel, {CHUNK_FWD}, {CHUNK_BWD}",
    "gemm_bf16_epilogue": f"{FWD}, :868 _layer_bwd_kernel, {ATTN_FWD}, {MLP_FWD}, "
                          f"{ATTN_BWD}, {MLP_BWD}, {CHUNK_FWD}, {CHUNK_BWD}",
    "attention_fwd": f"{FWD}, {ATTN_FWD}; {Q8}",
    "layernorm_bwd": f"{BWD}, {ATTN_BWD}, {MLP_BWD}, {CHUNK_BWD}",
    "attention_bwd": f"{BWD}, {ATTN_BWD}",
    "layernorm_q8": Q8,
    "gemm_s8_epilogue": Q8,
    "quant_rows": Q8,
}
# the fp32 kernels replace the same Pallas functions on fp32 activations
# (rows 1-13 of PERF.md's table, and the q8 layers' fp32 forms, rows 14-17)
REPLACES.update({
    "layernorm_fwd_f32": REPLACES["layernorm_fwd"] + " (fp32 x)",
    "gemm_f32_epilogue": REPLACES["gemm_bf16_epilogue"] + " (fp32 x)",
    "attention_fwd_f32": f"{FWD}, {ATTN_FWD}, :358 _attn_bwd_kernel; {Q8} (fp32 x)",
    "layernorm_bwd_f32": REPLACES["layernorm_bwd"] + " (fp32 x)",
    "attention_bwd_f32": REPLACES["attention_bwd"] + " (fp32 x)",
    "layernorm_q8_f32": f"{Q8} (fp32 x)",
    "gemm_s8_epilogue_f32": f"{Q8} (fp32 x)",
})
# the int8 kernels, whose times in the kernel object are those of one
# vision layer of the ViT-B/16 int8 request, and whose launches are that path's
Q8_KERNELS = ("layernorm_q8", "gemm_s8_epilogue", "quant_rows")
# the probes of tools/ (rows 18-19 of PERF.md's table; ops/probe.py): the
# rate kernel, and the quantizer ablations' instances of the int8 sources;
# quant_rows is also the rate probe's quantize kernel
PROBE_INT8_MXU = "tools/probe_int8_mxu.py"
PROBE_Q8 = "tools/probe_q8_residual.py:116 layer_kernel (launched :142)"
PROBE_KERNELS = ("probe_mma_bf16", "probe_mma_s8", "quant_rows_recip", "quant_rows_noclip",
                 "quant_rows_floor", "layernorm_q8_recip", "layernorm_q8_noclip",
                 "layernorm_q8_floor", "gemm_s8_epilogue_floor")
REPLACES["quant_rows"] += f"; {PROBE_INT8_MXU}:56 quant_kernel (launched :124)"
REPLACES.update({
    "probe_mma_bf16": f"{PROBE_INT8_MXU}:41 mm_kernel (launched :81), bf16 x bf16 -> fp32",
    "probe_mma_s8": f"{PROBE_INT8_MXU}:41 mm_kernel (launched :81), s8 x s8 -> s32",
    **{f"quant_rows_{m}": f"{PROBE_Q8}, quant_rows :76 in mode q8_{m}"
       for m in ("recip", "noclip", "floor")},
    **{f"layernorm_q8_{m}": f"{PROBE_Q8}, _ln_fp32 + quant_rows :76 in mode q8_{m}"
       for m in ("recip", "noclip", "floor")},
    "gemm_s8_epilogue_floor": f"{PROBE_Q8}, q8_matmul :104 in mode q8_floor",
})
# the chunked MLP half's kernels, whose times under "chunked" are those of
# one call of its forward and backward at ViT-L/14's vision MLP
CHUNKED_KERNELS = ("layernorm_fwd", "gemm_bf16_epilogue", "layernorm_bwd")

# kernel launches of one layer on each route of models/layers.residual_block
# (the half-block routes count the Functions of both halves)
_HALVES = dict(attn_halfblock=1, mlp_halfblock=1)
_HALVES_TRAIN = dict(_HALVES, attn_halfblock_bwd=1, mlp_halfblock_bwd=1,
                     attention_fwd=1, attention_bwd=1, layernorm_bwd=2)
_Q8_BWD = dict(gemm_bf16_epilogue=4, layernorm_bwd=2, attention_bwd=1,
               layer_fullblock_q8_ste_bwd=1)
ROUTES = {
    # no gradient: the no-save forwards
    "full": dict(layernorm_fwd=2, gemm_bf16_epilogue=4, attention_fwd=1, layer_fullblock=1),
    "half": dict(_HALVES, layernorm_fwd=2, gemm_bf16_epilogue=4, attention_fwd=1),
    # training, forward and backward: the whole layer (saves on, D <= 768);
    # the halves with qkv and h saved; with h recomputed (LN2 and the fc
    # product again); with saves off (LN1 and the qkv product again too)
    "full_train": dict(layernorm_fwd=2, gemm_bf16_epilogue=8, attention_fwd=1,
                       layernorm_bwd=2, attention_bwd=1, layer_fullblock=1,
                       layer_fullblock_bwd=1),
    "half_train": dict(_HALVES_TRAIN, layernorm_fwd=2, gemm_bf16_epilogue=8),
    "half_train_recompute_h": dict(_HALVES_TRAIN, layernorm_fwd=3, gemm_bf16_epilogue=9),
    "half_train_saves_off": dict(_HALVES_TRAIN, layernorm_fwd=4, gemm_bf16_epilogue=10),
    # the int8 layer chains: dynamic (the attention output and g quantized
    # by quant_rows) and static (g quantized in the fc product's epilogue);
    # quantization-aware training adds PR 2's bf16 layer backward
    "q8": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2,
               layer_fullblock_q8=1),
    "q8s": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=1,
                layer_fullblock_q8_static=1),
    "q8_train": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2,
                     layer_fullblock_q8_ste=1, **_Q8_BWD),
    "q8s_train": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=1,
                      layer_fullblock_q8_ste_static=1, **_Q8_BWD),
    # the same where the layer saves nothing (saves off, or D > 768 over the
    # wide-MLP row-token budget): the backward runs the saving q8 forward again
    "q8_train_recompute": dict(layernorm_q8=4, gemm_s8_epilogue=8, attention_fwd=2,
                               quant_rows=4, layer_fullblock_q8_ste=1, **_Q8_BWD),
    "q8s_train_recompute": dict(layernorm_q8=4, gemm_s8_epilogue=8, attention_fwd=2,
                                quant_rows=2, layer_fullblock_q8_ste_static=1, **_Q8_BWD),
    # a quantization-aware layer's forward alone, where its input needs a
    # gradient: the recompute a checkpointed CoCoOp chunk makes
    "q8_train_fwd": dict(layernorm_q8=2, gemm_s8_epilogue=4, attention_fwd=1, quant_rows=2,
                         layer_fullblock_q8_ste=1),
}
# each tier's layer route, serving and training
Q8_ROUTES = {"int8": "q8", "int8_static": "q8s", "int8_ste": "q8_train",
             "int8_ste_static": "q8s_train"}


def qat_route(F, width: int, row_tokens: int, quant: str) -> str:
    """A quantization-aware layer's route: it saves y1, qkv and h while
    saves are on and D <= 768, or D <= 1024 within the wide-MLP row-token
    budget (``quant_block._ste_forward``, JAX ``quant_block.py:298-299``),
    else its backward recomputes the q8 forward."""
    saves = F.save_acts_enabled() and (width <= F.FULLBLOCK_MAX_WIDTH
                                       or F.wide_mlp_save(row_tokens))
    return Q8_ROUTES[quant] + ("" if saves else "_recompute")


def expect(keys, *parts) -> dict:
    """Launches of a path: the sum of (count, route or dict) parts, over
    every key of the launch counter."""
    out = dict.fromkeys(keys, 0)
    for n, route in parts:
        for k, v in (ROUTES[route] if isinstance(route, str) else route).items():
            out[k] += n * v
    return out


def tower_lns(fwd: int, bwd: int = 0) -> dict:
    """The towers' own LayerNorms (ln_pre, ln_post, ln_final)."""
    return dict(layernorm_fwd=fwd, layernorm_bwd=bwd)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | {smi()}", flush=True)


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SLEEP_CYCLES = 60_000_000  # ~30 ms of the card's clock: the queue's head start


def queued_ms(fn, iters: int = 10) -> tuple:
    """(device ms, host us) a call of ``fn``: the calls are issued while the
    card sleeps, so that it runs them back to back whatever the host's pace
    (``time_ms`` reads the slower of the two); host us, the time to issue
    one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    asleep, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    asleep.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= asleep.elapsed_time(start):
        raise AssertionError(f"issuing {iters} calls took {host_ms:.2f} ms, longer than the sleep")
    return start.elapsed_time(end) / iters, host_ms * 1e3 / iters


def bound(bytes_moved: float, bf16_ops: float, fp32_ops: float = 0.0, int8_ops: float = 0.0,
          tf32_ops: float = 0.0):
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = (bf16_ops / PEAK_BF16_FLOPS + fp32_ops / PEAK_FP32_FLOPS + int8_ops / PEAK_INT8_OPS
             + tf32_ops / PEAK_TF32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def chain_bound(B: int, S: int, D: int, causal, halves=("attn", "mlp"), bwd: bool = False,
                int8: bool = False, fp32: bool = False) -> str:
    """The least time of a layer chain (both halves or one) over B blocks
    of S rows: its forward, with ``bwd`` also the dx-only backward.  Bytes:
    x in and y out, the weights, and with the backward g in and dx out, each
    once.  Operations: the projections' products at the bf16 peak (the
    forward's at the int8 peak under ``int8``; the quantization-aware
    backward is bf16, its weights read as bf16 too), attention's two
    score-sized products over the keys each row attends (a causal row's
    earlier keys, a packed block's own valid keys), four in the backward.
    With ``fp32`` the same bytes and products on fp32 activations: every
    activation and weight (the backward's under ``int8``) at 4 bytes, and
    every product fp32-accurate, three TF32 products at the TF32 peak (as
    ``bound32`` counts them), but the int8 forward's projections.  The
    recompute routes do the same work."""
    M, attn, mlp = B * S, "attn" in halves, "mlp" in halves
    if causal is False:
        keys = S
    elif causal is True:
        keys = (S + 1) / 2
    else:  # packed (period, valid): each period's valid rows, causal
        period, valid = causal
        keys = valid * (valid + 1) / 2 / period
    weights = (4 * attn + 8 * mlp) * D * D
    fwd_ops, bwd_ops = 2 * M * weights, 2 * M * weights * bwd
    att_ops = 4 * M * keys * D * attn * (3 if bwd else 1)
    act = 4 if fp32 else 2
    nbytes = M * D * act * (4 if bwd else 2) + weights * ((1 + act * bwd) if int8 else act)
    if fp32:
        ms, by = bound(nbytes, 0, int8_ops=fwd_ops if int8 else 0,
                       tf32_ops=3 * (att_ops + bwd_ops + (0 if int8 else fwd_ops)))
    elif int8:
        ms, by = bound(nbytes, att_ops + bwd_ops, int8_ops=fwd_ops)
    else:
        ms, by = bound(nbytes, fwd_ops + bwd_ops + att_ops)
    return f"bound {ms:.4f} ({by})"


class Kernel:
    """Totals of one kernel over the launches of one vision layer of a path
    (the train step's forward and backward, or an int8 request); its source
    is mudpt_torch/csrc/<source or name>.cu."""

    def __init__(self, name: str, source: str = None):
        self.name = name
        self.source = source or name
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None  # None while no launch has a library yardstick
        self.t_bytes = self.t_ops = 0.0
        self.max_abs_err = 0.0

    def add(self, ms, plain_ms, library_ms, bound_ms, by):
        self.ms += ms
        self.plain_ms += plain_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        self.bound_ms += bound_ms
        if by == "bytes":
            self.t_bytes += bound_ms
        else:
            self.t_ops += bound_ms

    def times(self) -> dict:
        return {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.t_bytes >= self.t_ops else "operations",
                "library_ms": self.library_ms}

    def record(self, launches: dict, main_path: str, **more: "Kernel") -> dict:
        """The kernel's JSON entry: its times, those of ``more`` under their
        keys, and its launches on ``main_path``."""
        return {
            "name": self.name, "route": "cuda",
            "source": f"mudpt_torch/csrc/{self.source}.cu",
            "replaces": REPLACES[self.name],
            "launches": launches[main_path], "main_path": main_path,
            "launches_by_path": launches,
            "max_abs_err": max([self.max_abs_err] + [k.max_abs_err for k in more.values()]),
            **self.times(), **{key: k.times() for key, k in more.items()},
        }


def check_close(what: str, got, ref, kernel: Kernel = None, max_limit=MAX_ERR_OF_MAX,
                norm_limit=NORM_ERR, share_limit=DIFFER_SHARE, abs_limit=None) -> str:
    """Hold ``got`` to ``ref``: max abs error within ``max_limit`` of the
    largest value (or within ``abs_limit``, where given), relative norm
    error within ``norm_limit``, and at most ``share_limit`` of the
    elements not bit-equal (None: not held).  Returns the readings as text."""
    import torch

    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    norm = (diff.norm() / ref.float().norm()).item()
    share = (got != ref).float().mean().item()
    largest = ref.float().abs().max().item()
    reading = f"err {err:.3g} of max {largest:.3g} norm {norm:.3g} differ {share:.3g}"
    if abs_limit is not None:
        if not err <= abs_limit:
            raise AssertionError(f"{what}: {reading}: max abs err over {abs_limit}")
    elif not err <= max_limit * largest:
        raise AssertionError(f"{what}: {reading}: max abs err over {max_limit} of the largest value")
    if not norm <= norm_limit:
        raise AssertionError(f"{what}: {reading}: relative norm error over {norm_limit}")
    if share_limit is not None and not share <= share_limit:
        raise AssertionError(f"{what}: {reading}: share of differing elements over {share_limit}")
    if kernel is not None:
        kernel.max_abs_err = max(kernel.max_abs_err, err)
    return reading


def check_codes(what: str, got, ref, kernel: Kernel = None) -> str:
    """int8 codes within one step of the plain version's, at most
    ``CODE_SHARE`` of them differing."""
    return check_close(what, got, ref, kernel, abs_limit=CODE_STEP, share_limit=CODE_SHARE)


def check_equal(what: str, got, ref, kernel: Kernel = None) -> str:
    """Bit-equal to the plain version."""
    return check_close(what, got, ref, kernel, abs_limit=0, norm_limit=0, share_limit=0)


# the kernels' shapes on each model's paths; the last field of a case: its
# launches in one vision layer of the train step
M_B, M_L = BATCH * 199, BATCH * 259  # vision tokens per batch: 197 or 257 + n_ctx
M_336 = BATCH * 579                   # 577 + n_ctx at 336px
# ViT-L/14's vision GEMMs; the train step at batch 384 recomputes the vision
# MLP's h: LN2 and the fc product run again in the backward, which stores
# QuickGELU'(h32) (fc_gelu_grad) for the g.proj_w^T product to apply (mul_f32)
_L14_GEMM = (("qkv", M_L, 1024, 3072, 1), ("residual", M_L, 1024, 1024, 1),
             ("fc_gelu", M_L, 1024, 4096, 1), ("fc_gelu_save", M_L, 1024, 4096, 0),
             ("residual", M_L, 4096, 1024, 1), ("fc_gelu_grad", M_L, 1024, 4096, 1),
             ("mul_f32", M_L, 1024, 4096, 1), ("gelu_bwd", M_L, 1024, 4096, 0),
             ("store_f32", M_L, 4096, 1024, 1), ("store_bf16", M_L, 1024, 1024, 1),
             ("store_f32", M_L, 3072, 1024, 1))
SHAPES = {
    "ViT-B/16": dict(
        tag="kernels",
        ln=((M_B, 768, 2), (13 * 128, 512, 0)),
        gemm=(("qkv", M_B, 768, 2304, 1), ("residual", M_B, 768, 768, 1),
              ("fc_gelu", M_B, 768, 3072, 0), ("fc_gelu_save", M_B, 768, 3072, 1),
              ("residual", M_B, 3072, 768, 1), ("gelu_bwd", M_B, 768, 3072, 1),
              ("store_f32", M_B, 3072, 768, 1), ("store_bf16", M_B, 768, 768, 1),
              ("store_f32", M_B, 2304, 768, 1)),
        # the text rows at D = 640 are RN50x4's (its text tower, 10 heads)
        ln_bwd=((M_B, 768, "float32", True, 2), (13 * 128, 512, "float32", True, 0),
                (13 * 128, 640, "float32", True, 0), (M_B, 768, "bfloat16", False, 0)),
        attn=(("vision", 384, 199, 12, False, True), ("text causal", 100, 16, 8, True, False),
              ("text packed (16,16)", 13, 128, 8, (16, 16), False),
              ("text packed (16,11)", 13, 128, 8, (16, 11), False)),
    ),
    "ViT-L/14": dict(
        tag="kernels ViT-L/14",
        ln=((M_L, 1024, 3), (13 * 128, 768, 0)),
        gemm=_L14_GEMM,
        ln_bwd=((M_L, 1024, "float32", True, 2), (13 * 128, 768, "float32", True, 0),
                (M_L, 1024, "bfloat16", False, 0)),
        attn=(("vision", 384, 259, 16, False, True),
              ("text packed (16,16)", 13, 128, 12, (16, 16), False),
              ("384 rows", 8, 384, 16, False, False)),
    ),
    # ViT-L/14@336px: the same towers on a 24 x 24 grid, 577 + n_ctx vision
    # rows; the train step at batch 384 recomputes the vision MLP's h as
    # ViT-L/14's does
    "ViT-L/14@336px": dict(
        tag="kernels ViT-L/14@336px",
        ln=((M_336, 1024, 3),),
        gemm=tuple((ep, M_336, K, N, n) for ep, _, K, N, n in _L14_GEMM),
        ln_bwd=((M_336, 1024, "float32", True, 2), (M_336, 1024, "bfloat16", False, 0)),
        attn=(("vision", 384, 579, 16, False, True),),
    ),
}


def randn_fn(seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    return rn


def check_ln_fwd(F, rn, tag: str, rows: int, D: int, kernel: Kernel, per_layer: int) -> None:
    """layernorm_fwd at (rows, D) against its plain version, timed beside
    F.layer_norm, added ``per_layer`` times to ``kernel``'s totals."""
    import torch
    import torch.nn.functional as tf

    x = rn(rows, D, std=2.0)
    s = rn(D, dtype=torch.float32) * 0.1 + 1
    b = rn(D, dtype=torch.float32) * 0.1
    reading = check_close(f"layernorm {rows}x{D}", F.layer_norm_fwd(x, s, b),
                          F.layer_norm_plain(x, s, b), kernel)
    ms = time_ms(lambda: F.layer_norm_fwd(x, s, b))
    plain = time_ms(lambda: F.layer_norm_plain(x, s, b))
    s16, b16 = s.bfloat16(), b.bfloat16()
    lib = time_ms(lambda: tf.layer_norm(x, (D,), s16, b16, 1e-5))
    bms, by = bound(2 * rows * D * 2 + 2 * D * 4, 0, 8 * rows * D)
    say(tag, f"layernorm_fwd {rows}x{D}: {reading} ms {ms:.4f} plain {plain:.4f} "
             f"library(F.layer_norm) {lib:.4f} bound {bms:.4f} ({by})")
    for _ in range(per_layer):
        kernel.add(ms, plain, lib, bms, by)


def check_ln_bwd(F, rn, tag: str, rows: int, D: int, dxn_name: str, with_r: bool,
                 kernel: Kernel, per_layer: int) -> None:
    """layernorm_bwd at (rows, D) against its plain version, timed beside
    F.layer_norm's backward, added ``per_layer`` times to ``kernel``."""
    import torch
    import torch.nn.functional as tf

    dxn_dt = getattr(torch, dxn_name)
    x = rn(rows, D, std=2.0)
    dxn = rn(rows, D, dtype=dxn_dt)
    s = rn(D, dtype=torch.float32) * 0.1 + 1
    r = rn(rows, D) if with_r else None
    reading = check_close(f"layernorm_bwd {rows}x{D}", F.layer_norm_bwd(dxn, x, s, r),
                          F.layer_norm_bwd_plain(dxn, x, s, r), kernel)
    ms = time_ms(lambda: F.layer_norm_bwd(dxn, x, s, r))
    plain = time_ms(lambda: F.layer_norm_bwd_plain(dxn, x, s, r))
    xr = x.detach().requires_grad_(True)
    y = tf.layer_norm(xr, (D,), s.bfloat16(), s.bfloat16(), 1e-5)
    g16 = dxn.bfloat16()
    lib = time_ms(lambda: torch.autograd.grad(y, xr, g16, retain_graph=True))
    nbytes = rows * D * (dxn.element_size() + 2 + 2 + (2 if with_r else 0)) + D * 4
    bms, by = bound(nbytes, 0, 15 * rows * D)
    say(tag, f"layernorm_bwd {rows}x{D} dxn {dxn_name} residual {with_r}: "
             f"{reading} ms {ms:.4f} plain {plain:.4f} library(F.layer_norm "
             f"backward) {lib:.4f} bound {bms:.4f} ({by})")
    for _ in range(per_layer):
        kernel.add(ms, plain, lib, bms, by)


def check_gemm(F, tag: str, ep: str, a, w, bias, extra, kernel: Kernel, per_layer: int,
               out=None, note: str = "") -> None:
    """The GEMM with epilogue ``ep`` against its plain version, timed beside
    one library product, added ``per_layer`` times to ``kernel``.  ``out``:
    the fp32 accumulator of ``add_f32`` (each side adds into a copy); for
    ``chunk_residual``, ``out`` given means y in place, the kernel writing
    into the copy of ``extra`` that it reads."""
    import torch

    w_nk = F.EPILOGUES[ep][1]
    M, K = a.shape
    N = w.shape[0] if w_nk else w.shape[1]
    def launch(schedule="auto"):
        if ep == "add_f32":
            return F._gemm_epilogue(a, w, bias, ep, extra, out.clone(), schedule)
        if out is not None:
            y = extra.clone()
            return F._gemm_epilogue(a, w, bias, ep, y, y, schedule)
        return F._gemm_epilogue(a, w, bias, ep, extra, None, schedule)

    got = launch()
    if ep == "add_f32":
        ref = F.gemm_epilogue_plain(a, w, bias, ep, extra, out.clone())
    else:
        ref = F.gemm_epilogue_plain(a, w, bias, ep, extra)
    # two launches on the same inputs give the same bits (no atomics), and
    # so does every schedule: each output sums its K slices in one order
    for schedule in F._GEMM_SCHEDULES:
        again = launch(schedule)
        for x, y in zip(got if ep == "fc_gelu_save" else (got,),
                        again if ep == "fc_gelu_save" else (again,)):
            check_equal(f"gemm {K}->{N} {ep}, launched again ({schedule})", x, y)
        del again
    if ep == "fc_gelu_save":
        reading = "h " + check_close(f"gemm {ep} h", got[0], ref[0], kernel)
        reading += "; a " + check_close(f"gemm {ep} a", got[1], ref[1], kernel)
    elif ep in F._F32_OUT:
        reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernel,
                              max_limit=F32_MAX_ERR, norm_limit=F32_NORM_ERR, share_limit=None)
    else:
        reading = check_close(f"gemm {K}->{N} {ep}", got, ref, kernel)
    del got, ref
    # timed in place where the epilogue writes in place (the sums only grow);
    # then each schedule beside the one the shape selects, in an order and
    # its reverse (the card slows as it warms under back-to-back products)
    ms = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra, out))
    schedules = F._GEMM_SCHEDULES[1:]
    by_schedule = dict.fromkeys(schedules, 0.0)
    for sch in schedules + schedules[::-1]:
        by_schedule[sch] += time_ms(
            lambda: F._gemm_epilogue(a, w, bias, ep, extra, out, sch)) / 2
    by_schedule = ", ".join(f"{k} {v:.4f}" for k, v in by_schedule.items())
    plain = time_ms(lambda: F.gemm_epilogue_plain(a, w, bias, ep, extra, out), 3)
    if w_nk:
        lib = time_ms(lambda: torch.matmul(a, w.t()))
        lib_name = "torch.matmul(a, W.t())"
    elif bias is None:
        lib = time_ms(lambda: torch.matmul(a, w))
        lib_name = "torch.matmul"
    else:
        lib = time_ms(lambda: torch.addmm(bias, a, w))
        lib_name = "torch.addmm"
    out_bytes = {"store_f32": 4, "fc_gelu_save": 4, "fc_gelu_grad": 4, "add_f32": 4}.get(ep, 2)
    # add_f32 reads the fp32 accumulator it writes
    extra_bytes = 4 if ep == "add_f32" else 0 if extra is None else extra.element_size()
    nbytes = (M * K + K * N) * 2 + M * N * (out_bytes + extra_bytes)
    bms, by = bound(nbytes + (N * 2 if bias is not None else 0), 2 * M * N * K)
    say(tag, f"gemm_bf16_epilogue {ep} {M}x{K}->{N}{note}: {reading} ms {ms:.4f} "
             f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s) plain {plain:.4f} "
             f"library({lib_name}) {lib:.4f} bound {bms:.4f} ({by}); schedules: {by_schedule}")
    for _ in range(per_layer):
        kernel.add(ms, plain, lib, bms, by)


def launch_profile(fn, symbol: str = None) -> str:
    """What CUPTI records of one launch in ``fn`` (the kernel whose name
    holds ``symbol``, else the longest): grid, block, registers a thread and
    shared memory a block, read from the profiler's trace (written under
    build/ and removed), and the warps an SM holds at those figures (64 K
    registers and 228 KB of shared memory an SM, 1 KB of it reserved a
    block).  CUPTI's stall reasons are not recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "launch_profile.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("cat") == "kernel" and (symbol is None or symbol in e.get("name", ""))]
    path.unlink()
    if not events:
        return "not recorded"
    e = max(events, key=lambda e: e.get("dur", 0))
    a = e.get("args", {})
    try:
        threads = a["block"][0] * a["block"][1] * a["block"][2]
        regs, smem = a["registers per thread"], a["shared memory"]
    except (KeyError, TypeError, IndexError):
        return f"{e['name'][:48]}: no launch figures"
    blocks = min(65536 // (regs * threads), 233472 // (smem + 1024), 2048 // threads, 32)
    return (f"{e['name'][:48]}: {e.get('dur')} us, grid {a.get('grid')}, {threads} threads, "
            f"{regs} registers, {smem} B shared: {blocks} blocks, "
            f"{blocks * threads // 32} warps an SM")


def gemm_operands(F, rn, ep: str, M: int, K: int, N: int, dtype=None) -> tuple:
    """Seeded (a, W, bias, second operand) of a GEMM epilogue in the
    activation dtype (bf16 where None): the forward epilogues take W (K, N),
    the backward ones W (N, K), read transposed."""
    import torch

    dt = dtype or torch.bfloat16
    w_nk = F.EPILOGUES[ep][1]
    a = rn(M, K, dtype=dt)
    w = rn(N, K, std=K ** -0.5, dtype=dt) if w_nk else rn(K, N, std=K ** -0.5, dtype=dt)
    bias = rn(N, std=0.1, dtype=dt) if ep in F._BIASED else None
    extra = None
    if ep == "residual":
        extra = rn(M, N, dtype=dt)
    elif ep == "gelu_bwd":
        extra = rn(M, N, std=2.0, dtype=dt)  # a saved pre-activation
    elif ep == "mul_f32":  # QuickGELU' of an fp32 pre-activation
        extra = F.quick_gelu_grad(rn(M, N, std=2.0, dtype=torch.float32))
    return a, w, bias, extra


def phase_kernels(F, kernels: dict, model: str):
    """Every kernel at the model's shapes; returns the seeded generator,
    which the layer checks go on drawing from."""
    import torch
    import torch.nn.functional as tf

    spec = SHAPES[model]
    tag = spec["tag"]
    rn = randn_fn(0)

    # ---- LayerNorm: vision (per layer as the last field) and packed text rows
    for rows, D, per_layer in spec["ln"]:
        check_ln_fwd(F, rn, tag, rows, D, kernels["layernorm_fwd"], per_layer)

    # ---- GEMM with each epilogue at the vision shapes
    for ep, M, K, N, per_layer in spec["gemm"]:
        a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N)
        check_gemm(F, tag, ep, a, w, bias, extra, kernels["gemm_bf16_epilogue"], per_layer)
        del a, w, extra

    # ---- LayerNorm dx: the layer's two (fp32 dxn, with a residual), at the
    # vision shape (2 per layer) and the packed text rows; a tower LayerNorm
    # (bf16 dxn, no residual) at the vision shape
    for rows, D, dxn_name, with_r, per_layer in spec["ln_bwd"]:
        check_ln_bwd(F, rn, tag, rows, D, dxn_name, with_r, kernels["layernorm_bwd"], per_layer)

    # ---- attention: vision (1 per layer), text causal, packed text rows;
    # forward, then backward from a seeded upstream gradient
    for label, B, S, H, causal, per_layer in spec["attn"]:
        D = 64 * H
        qkv = rn(B, S, 3 * D)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        pairs = sum(min(r + 1, valid) if is_causal else valid for r in range(L))
        q, k, v = (t.detach().requires_grad_(True)
                   for t in qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4))
        if isinstance(causal, tuple):
            i = torch.arange(L, device=qkv.device)
            allowed = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # noqa: E731
        else:
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, is_causal=is_causal)  # noqa: E731

        reading = check_close(f"attention {label}", F.attention_fwd(qkv, H, causal),
                              F.attention_plain(qkv, H, causal), kernels["attention_fwd"])
        ms = time_ms(lambda: F.attention_fwd(qkv, H, causal))
        plain = time_ms(lambda: F.attention_plain(qkv, H, causal), 3)
        with torch.no_grad():
            lib = time_ms(sdpa)
        bms, by = bound(4 * B * S * D * 2, 4 * 64 * pairs * n * H, 5 * pairs * n * H)
        say(tag, f"attention_fwd {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                       f"plain {plain:.4f} library(sdpa) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kernels["attention_fwd"].add(ms, plain, lib, bms, by)
        do = rn(B, S, D, std=0.1)
        got = F.attention_bwd(qkv, do, H, causal)
        reading = check_close(f"attention_bwd {label}", got,
                              F.attention_bwd_plain(qkv, do, H, causal), kernels["attention_bwd"])
        # no float atomics: a second launch gives the same bits
        check_equal(f"attention_bwd {label}, launched twice", got,
                    F.attention_bwd(qkv, do, H, causal))
        del got
        ms = time_ms(lambda: F.attention_bwd(qkv, do, H, causal))
        plain = time_ms(lambda: F.attention_bwd_plain(qkv, do, H, causal), 3)
        out = sdpa()
        do4 = do.view(n, L, H, 64).permute(0, 2, 1, 3)
        lib = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do4, retain_graph=True))
        bms, by = bound(7 * B * S * D * 2, 5 * 2 * 64 * pairs * n * H, 8 * pairs * n * H)
        say(tag, f"attention_bwd {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                       f"plain {plain:.4f} library(sdpa backward) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kernels["attention_bwd"].add(ms, plain, lib, bms, by)
        del qkv, q, k, v, do, do4, out
    return rn


# each vision tower's attention block: model, rows, heads
ATTN_PROFILE_SHAPES = (("ViT-B/16", 199, 12), ("ViT-L/14", 259, 16), ("ViT-L/14@336px", 579, 16))


def phase_attention_profiles(F) -> None:
    """CUPTI's launch figures of attention_fwd and of SDPA at each vision
    tower's block.  Run early: in the later phases the profiler's trace
    held no kernel events."""
    import torch.nn.functional as tf

    rn = randn_fn(9)
    for model, S, H in ATTN_PROFILE_SHAPES:
        qkv = rn(BATCH, S, 3 * 64 * H)
        q, k, v = qkv.view(BATCH, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        say("kernels", f"launch profile {model} {BATCH} x {S}, {H} heads: attention_fwd "
                       f"{launch_profile(lambda: F.attention_fwd(qkv, H), 'attention_fwd')}; "
                       f"sdpa {launch_profile(lambda: tf.scaled_dot_product_attention(q, k, v))}")
        del qkv, q, k, v
    # attention_bwd's two kernels at the text tower's causal 16-row blocks
    qkv, do = rn(100, 16, 3 * 64 * 8), rn(100, 16, 64 * 8, std=0.1)
    say("kernels", "launch profile text causal 100 x 16, 8 heads: attention_bwd " + "; ".join(
        launch_profile(lambda: F.attention_bwd(qkv, do, 8, True), sym)
        for sym in ("attn_bwd_query_kernel", "attn_bwd_key_kernel")))

# the attention kernels' block lengths: one query and key tile (<= 64 rows),
# the tiles resident (attention_fwd to 768 rows, attention_bwd to 640) and
# streamed past that
ATTN_SWEEP_S = (16, 40, 64, 128, 199, 259, 384, 579, 769, 1024)


def phase_attention_sweep(F) -> None:
    """attention_fwd and attention_bwd against their plain versions at every
    block length of the models and past the resident limits, every mask
    spec (none, causal, packed (S, S - 7) and (16, 11)), attention_fwd's
    both output forms; 4 sequences of 2 heads each."""
    rn = randn_fn(8)
    for S in ATTN_SWEEP_S:
        readings = []
        for mask in (False, True, (S, S - 7), (16, 11)):
            if S % mask[0] if isinstance(mask, tuple) else False:
                continue
            qkv = rn(4, S, 3 * 128)
            do = rn(4, S, 128, std=0.1)
            check_close(f"attention_bwd S={S} mask={mask}", F.attention_bwd(qkv, do, 2, mask),
                        F.attention_bwd_plain(qkv, do, 2, mask))
            readings.append(f"{mask}/bwd")
            for f32 in (False, True):
                what = f"attention_fwd S={S} mask={mask} {'fp32' if f32 else 'bf16'}"
                got, ref = F.attention_fwd(qkv, 2, mask, f32), F.attention_plain(qkv, 2, mask, f32)
                if f32:
                    check_close(what, got, ref, max_limit=ATTN_F32_MAX_ERR,
                                norm_limit=ATTN_F32_NORM_ERR, share_limit=None)
                else:
                    check_close(what, got, ref)
                readings.append(f"{mask}/{'f32' if f32 else 'bf16'}")
        say("kernels", f"attention S={S}: within limits for {', '.join(readings)}")


def layer_params(rn, D: int, dtype=None) -> list:
    """The twelve weights of a layer at width D, seeded, the projections in
    ``dtype`` (bf16 where None), the LayerNorms' in fp32."""
    import torch

    dt = dtype or torch.bfloat16
    return [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
            rn(D, 3 * D, std=D ** -0.5, dtype=dt), rn(3 * D, std=0.1, dtype=dt),
            rn(D, D, std=D ** -0.5, dtype=dt), rn(D, std=0.1, dtype=dt),
            *mlp_params(rn, D, dtype)]


def mlp_params(rn, D: int, dtype=None) -> list:
    """The six weights of an MLP half at width D (hidden 4D), seeded, as
    ``layer_params``."""
    import torch

    dt = dtype or torch.bfloat16
    return [rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1,
            rn(D, 4 * D, std=D ** -0.5, dtype=dt), rn(4 * D, std=0.1, dtype=dt),
            rn(4 * D, D, std=(4 * D) ** -0.5, dtype=dt), rn(D, std=0.1, dtype=dt)]


def phase_layer_chains(F, rn) -> None:
    import torch

    # ---- the whole layer, kernel chain against the plain chain: the no-save
    # forward, then the saving forward with the backward (LayerFullblockFn).
    # The main path's row counts are multiples of the GEMM's 128-row tile;
    # the unpacked causal text rows (1,600) also reach its masked last tile
    # the last two, forward alone: the zoo's vision towers without a prompt
    # (ViT-B/16's 197 tokens, ViT-B/32's 50) at its batch of 64
    for D, B, S, H, causal, train in ((768, 384, 199, 12, False, True),
                                      (512, 13, 128, 8, (16, 16), True),
                                      (512, 100, 16, 8, True, True),
                                      (768, ZOO_BATCH, 197, 12, False, False),
                                      (768, ZOO_BATCH, 50, 12, False, False)):
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        # a one-ulp flip early in the chain moves later roundings: the
        # share of differing elements is printed, not held
        reading = check_close(f"layer_fullblock D={D}", F.layer_fullblock(x, *ps, H, causal),
                              F.layer_fullblock_plain(x, *ps, H, causal), share_limit=None)
        ms = time_ms(lambda: F.layer_fullblock(x, *ps, H, causal))
        plain = time_ms(lambda: F.layer_fullblock_plain(x, *ps, H, causal), 3)
        say("kernels", f"layer_fullblock D={D} B={B} S={S} mask={causal}: {reading} "
                       f"ms {ms:.4f} plain {plain:.4f} {chain_bound(B, S, D, causal)}")
        if not train:
            continue

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)

        def step(plain_fns):
            y = F.layer_fullblock(xg, *ps, H, causal, plain=plain_fns)
            return y, torch.autograd.grad(y, xg, gy)[0]

        (y, dx), (y_ref, dx_ref) = step(False), step(True)
        r_y = check_close(f"layer_fullblock save D={D} y", y, y_ref, share_limit=None)
        r_dx = check_close(f"layer_fullblock D={D} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                           norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
        del y, dx, y_ref, dx_ref
        ms = time_ms(lambda: step(False))
        plain = time_ms(lambda: step(True), 3)
        say("kernels", f"layer_fullblock forward-save + backward D={D} B={B} S={S} "
                       f"mask={causal}: y {r_y}; dx {r_dx}; ms {ms:.4f} plain {plain:.4f} "
                       f"{chain_bound(B, S, D, causal, bwd=True)}")
        del x, xg, gy, ps


def phase_halfblock_chains(F) -> None:
    """The four half-block chains against their plain versions: each half's
    forward alone, then its forward with the backward, qkv or h saved and
    recomputed; at the ViT-L/14 vision shape and at the packed text rows of
    2,560 classes, which train with saves off; and, recomputed only, at
    CoCoOp's per-instance text rows (ViT-B/32's text tower, D = 512, 8
    heads: B x 1,000 classes packed G to a row), which train with saves off."""
    import torch

    tag = SHAPES["ViT-L/14"]["tag"]
    rn = randn_fn(2)
    G, P = COCOOP_PACK
    for label, B, S, D, H, causal, saves in (
            ("vision", BATCH, 259, 1024, 16, False, (True, False)),
            ("text packed", SAVES_OFF_N_CLS // 8, 128, 768, 12, (16, 16), (True, False)),
            ("CoCoOp text packed", COCOOP_B * COCOOP_N_CLS // G, G * P, 512, 8, (P, P),
             (False,))):
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        halves = {"attn": (F.attn_halfblock, F.attn_halfblock_plain, ps[:6], (H, causal)),
                  "mlp": (F.mlp_halfblock, F.mlp_halfblock_plain, ps[6:], ())}
        serve_ms, train_ms = {}, {}
        for half, (fn, plain_fn, p, extra) in halves.items():
            reading = check_close(f"{half}_halfblock {label}", fn(x, *p, *extra),
                                  plain_fn(x, *p, *extra), share_limit=None)
            ms = time_ms(lambda: fn(x, *p, *extra))
            plain = time_ms(lambda: plain_fn(x, *p, *extra), 3)
            serve_ms[half] = (ms, plain)
            say(tag, f"{half}_halfblock {label} B={B} S={S} D={D} mask={causal}: {reading} "
                     f"ms {ms:.4f} plain {plain:.4f} {chain_bound(B, S, D, causal, (half,))}")
            xg = x.detach().requires_grad_(True)
            gy = rn(B, S, D)
            for save in saves:
                def step(plain_fns):
                    F.set_save_mlp_wide("1" if save else "0")
                    with F.saved_acts(save):
                        y = fn(xg, *p, *extra, plain=plain_fns)
                    F.set_save_mlp_wide("auto")
                    if (y.grad_fn.saved_tensors[-1] is not None) != save:
                        raise AssertionError(f"{half}_halfblock save={save}: wrong backward")
                    return y, torch.autograd.grad(y, xg, gy)[0]

                (y, dx), (y_ref, dx_ref) = step(False), step(True)
                what = f"{half}_halfblock {label} {'save' if save else 'recompute'}"
                r_y = check_close(f"{what} y", y, y_ref, share_limit=None)
                r_dx = check_close(f"{what} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                                   norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
                del y, dx, y_ref, dx_ref
                ms = time_ms(lambda: step(False), 5)
                plain = time_ms(lambda: step(True), 2)
                train_ms[half, save] = (ms, plain)
                kept = {"attn": "qkv", "mlp": "h"}[half]
                say(tag, f"{half}_halfblock forward + backward {label}, {kept} "
                         f"{'saved' if save else 'recomputed'}: y {r_y}; dx {r_dx}; "
                         f"ms {ms:.4f} plain {plain:.4f} "
                         f"{chain_bound(B, S, D, causal, (half,), bwd=True)}")
            del xg, gy
        if label == "vision":
            # one vision layer of the serving path, and of the train step at
            # batch 384 (qkv saved, h recomputed)
            fwd = [sum(v[i] for v in serve_ms.values()) for i in (0, 1)]
            trn = [train_ms["attn", True][i] + train_ms["mlp", False][i] for i in (0, 1)]
            say(tag, f"one ViT-L/14 vision layer: forward ms {fwd[0]:.4f} plain {fwd[1]:.4f}; "
                     f"train step's forward + backward ms {trn[0]:.4f} plain {trn[1]:.4f}")
        del x, ps


# the int8 kernels' cases at the ViT-B/16 shapes; the last two fields of a
# case: its launches in one vision layer of the int8 and of the int8_static
# request.  LayerNorm-quant: rows, D, static (the text rows at D = 640:
# RN50x4's text tower)
Q8_LN = ((M_B, 768, False, 2, 0), (M_B, 768, True, 0, 2), (13 * 128, 512, False, 0, 0),
         (13 * 128, 640, False, 0, 0))
# the row quantizer: rows, X (the attention output, g), static
Q8_ROWS = ((M_B, 768, False, 1, 0), (M_B, 3072, False, 1, 0), (M_B, 768, True, 0, 1))
# the s8 GEMM: epilogue, M, K, N, h saved (the quantization-aware forward)
Q8_GEMM = (("q8_qkv", M_B, 768, 2304, False, 1, 0), ("q8_residual", M_B, 768, 768, False, 1, 0),
           ("q8_fc_gelu", M_B, 768, 3072, False, 1, 0), ("q8_fc_gelu", M_B, 768, 3072, True, 0, 0),
           ("q8_residual", M_B, 3072, 768, False, 1, 0), ("q8s_qkv", M_B, 768, 2304, False, 0, 1),
           ("q8s_residual", M_B, 768, 768, False, 0, 1),
           ("q8s_fc_gelu", M_B, 768, 3072, False, 0, 1), ("q8s_fc_gelu", M_B, 768, 3072, True, 0, 0),
           ("q8s_residual", M_B, 3072, 768, False, 0, 1))
# fp32 operations of the GEMM's epilogue per output element (dequant, bias,
# conversion or residual add; QuickGELU's exp and division counted as one each)
Q8_EPILOGUE_OPS = {"qkv": 4, "residual": 5, "fc_gelu": 9}
# every s8 epilogue at M, K, N that are no multiples of the kernel's tile
S8_RAGGED = tuple((f"{kind}_{ep}", save) for kind in ("q8", "q8s")
                  for ep, save in (("qkv", False), ("residual", False), ("fc_gelu", False),
                                   ("fc_gelu", True)))
S8_RAGGED_MKN = (1000, 80, 784)
# the same at ViT-L/14's shapes (vision 1024 wide, 257 + n_ctx rows, 16
# heads; text 768 wide, 12 heads): LayerNorm-quant at its D <= 1024 limit,
# the row quantizer at 1024 columns and at QUANT_ROWS_MAX = 4096, the s8
# GEMM at 1024 -> 3072, 1024 -> 1024, 1024 -> 4096 (h saved or not) and
# 4096 -> 1024
Q8_LN_L14 = ((M_L, 1024, False, 2, 0), (M_L, 1024, True, 0, 2), (13 * 128, 768, False, 0, 0))
Q8_ROWS_L14 = ((M_L, 1024, False, 1, 0), (M_L, 4096, False, 1, 0), (M_L, 1024, True, 0, 1))
Q8_GEMM_L14 = tuple((f"{kind}_{ep}", M_L, K, N, save, *((n, 0) if kind == "q8" else (0, n)))
                    for kind in ("q8", "q8s")
                    for ep, K, N, save, n in (("qkv", 1024, 3072, False, 1),
                                              ("residual", 1024, 1024, False, 1),
                                              ("fc_gelu", 1024, 4096, False, 1),
                                              ("fc_gelu", 1024, 4096, True, 0),
                                              ("residual", 4096, 1024, False, 1)))
# attention's fp32 output: label, B, S, heads, mask, launches in a vision layer
Q8_ATTN = (("vision", BATCH, 199, 12, False, 1), ("text packed (16,16)", 13, 128, 8, (16, 16), 0))
Q8_ATTN_L14 = (("vision", BATCH, 259, 16, False, 1),
               ("text packed (16,16)", 13, 128, 12, (16, 16), 0))
Q8_SHAPES = {"ViT-B/16": (Q8_LN, Q8_ROWS, Q8_GEMM, Q8_ATTN),
             "ViT-L/14": (Q8_LN_L14, Q8_ROWS_L14, Q8_GEMM_L14, Q8_ATTN_L14)}


def _per_layer(kernels: tuple, counts: tuple, *times) -> None:
    for k, n in zip(kernels, counts):
        for _ in range(n):
            k.add(*times)


def s8_case(Q, rn, ep: str, M: int, K: int, N: int, save: bool, kern: Kernel = None,
            dtype=None) -> tuple:
    """One s8 GEMM epilogue against its plain version on seeded operands,
    the bias, residual and outputs in the activation dtype ``dtype`` (bf16
    by default, or fp32): (the call's arguments, the reading).  qkv,
    residual and the saved h are held bit-equal, g within F32_MAX_ERR, the
    static codes within a step."""
    import torch

    static = ep.startswith("q8s_")
    x32 = rn(M, K, dtype=torch.float32)
    dev = x32.device
    one = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    wq, ws = Q.quantize_cols(rn(K, N, std=K ** -0.5))
    wq = wq.t().contiguous()
    if static:  # per-tensor codes, the site's dequant factor folded into ws
        amax = x32.abs().amax()
        a, xs = Q.quantize_rows_plain(x32, one(127.0) / amax)[0], None
        ws = ws * (amax / 127.0)
    else:
        a, xs = Q.quantize_rows_plain(x32)
    del x32
    dtype = dtype or torch.bfloat16
    bias = rn(N, std=0.1, dtype=dtype)
    extra = rn(M, N, dtype=dtype) if ep.endswith("residual") else None
    r = None
    if ep == "q8s_fc_gelu":
        v = Q._s8_matmul(a, wq) * ws + bias.float()
        r = one(127.0) / (v * torch.sigmoid(1.702 * v)).abs().amax()
        del v
    args = (a, xs, wq, ws, bias, ep, extra, r, save, dtype)
    got, ref = Q.gemm_s8(*args), Q.gemm_s8_plain(*args)
    what = f"gemm_s8 {ep} {M}x{K}->{N}"
    reading = ""
    if save:
        reading = "h " + check_equal(f"{what} h", got[0], ref[0], kern) + "; "
        got, ref = got[1], ref[1]
    if ep == "q8_fc_gelu":
        reading += "g " + check_close(f"{what} g", got, ref, kern, max_limit=F32_MAX_ERR,
                                      norm_limit=F32_NORM_ERR, share_limit=None)
        # g's codes, as quant_rows (held on its own above) would make them
        reading += "; g's codes " + check_codes(f"{what} g's codes",
                                                 Q.quantize_rows_plain(got)[0],
                                                 Q.quantize_rows_plain(ref)[0])
    elif ep == "q8s_fc_gelu":
        reading += "codes " + check_codes(what, got, ref, kern)
    else:
        reading += check_equal(what, got, ref, kern)
    return args, reading


def phase_kernels_int8(F, Q, kq: dict, kqs: dict, model: str = "ViT-B/16") -> None:
    """Every int8 kernel against its plain version at the model's shapes
    (``Q8_SHAPES``): LayerNorm-quant, the row quantizer, each s8 GEMM
    epilogue, and attention_fwd's fp32 output; at ViT-B/16 also a probe of
    exact ties and the GEMM's ragged tile edges."""
    import torch

    tag = phase_name("kernels int8", model, "none")
    rn = randn_fn(4)
    one = lambda v: torch.full((), v, dtype=torch.float32, device="cuda")  # noqa: E731
    q8_ln, q8_rows, q8_gemm, q8_attn = Q8_SHAPES[model]

    for rows, D, static, n_dyn, n_st in q8_ln:
        x = rn(rows, D, std=2.0)
        s = rn(D, dtype=torch.float32) * 0.1 + 1
        b = rn(D, dtype=torch.float32) * 0.1
        r = one(127.0) / F.layer_norm_plain(x, s, b).float().abs().amax() if static else None
        (q, sc), (q_ref, sc_ref) = Q.ln_quant(x, s, b, r), Q.ln_quant_plain(x, s, b, r)
        reading = check_codes(f"layernorm_q8 {rows}x{D}", q, q_ref, kq["layernorm_q8"])
        if not static:
            reading += "; scales " + check_close(f"layernorm_q8 {rows}x{D} scales", sc, sc_ref,
                                                 max_limit=LN_SCALE_ERR, norm_limit=LN_SCALE_ERR,
                                                 share_limit=None)
        ms = time_ms(lambda: Q.ln_quant(x, s, b, r))
        plain = time_ms(lambda: Q.ln_quant_plain(x, s, b, r), 3)
        bms, by = bound(rows * D * 3 + rows * 4 + 2 * D * 4, 0, 12 * rows * D)
        say(tag, f"layernorm_q8 {rows}x{D} {'static' if static else 'dynamic'}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f} library none bound {bms:.4f} ({by})")
        _per_layer((kq["layernorm_q8"], kqs["layernorm_q8"]), (n_dyn, n_st), ms, plain, None,
                   bms, by)
        del x, q, q_ref

    for rows, X, static, n_dyn, n_st in q8_rows:
        x = rn(rows, X, dtype=torch.float32)
        r = one(127.0) / x.abs().amax() if static else None
        (q, sc), (q_ref, sc_ref) = Q.quantize_rows(x, r), Q.quantize_rows_plain(x, r)
        reading = check_equal(f"quant_rows {rows}x{X}", q, q_ref, kq["quant_rows"])
        if not static:
            reading += "; scales " + check_equal(f"quant_rows {rows}x{X} scales", sc, sc_ref)
        ms = time_ms(lambda: Q.quantize_rows(x, r))
        plain = time_ms(lambda: Q.quantize_rows_plain(x, r), 3)
        bms, by = bound(rows * X * 5 + rows * 4, 0, 5 * rows * X)
        say(tag, f"quant_rows {rows}x{X} {'static' if static else 'dynamic'}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f} library none bound {bms:.4f} ({by})")
        _per_layer((kq["quant_rows"], kqs["quant_rows"]), (n_dyn, n_st), ms, plain, None, bms, by)
        del x, q, q_ref
    for ep, M, K, N, save, n_dyn, n_st in q8_gemm:
        static = ep.startswith("q8s_")
        kern = kq["gemm_s8_epilogue"] if not static else kqs["gemm_s8_epilogue"]
        args, reading = s8_case(Q, rn, ep, M, K, N, save, kern)
        a, wq, extra = args[0], args[2], args[6]
        ms = time_ms(lambda: Q.gemm_s8(*args))
        plain = time_ms(lambda: Q.gemm_s8_plain(*args), 3)
        lib = time_ms(lambda: torch._int_mm(a, wq.t()))  # the yardstick: int32 out, no epilogue
        out_bytes = {"q8_fc_gelu": 4, "q8s_fc_gelu": 1}.get(ep, 2)
        nbytes = (M * K + N * K + M * N * (out_bytes + (2 if extra is not None or save else 0))
                  + (0 if static else M * 4) + N * 6)
        e_ops = Q8_EPILOGUE_OPS[ep.split("_", 1)[1]] - static
        bms, by = bound(nbytes, 0, e_ops * M * N, 2 * M * N * K)
        say(tag, f"gemm_s8_epilogue {ep}{' save h' if save else ''} {M}x{K}->{N}: {reading} "
                 f"ms {ms:.4f} ({2 * M * N * K / ms / 1e9:.1f} TOP/s) plain {plain:.4f} "
                 f"library(torch._int_mm) {lib:.4f} "
                 f"bound {bms:.4f} ({by})")
        _per_layer((kq["gemm_s8_epilogue"], kqs["gemm_s8_epilogue"]), (n_dyn, n_st), ms, plain,
                   lib, bms, by)
        del a, wq, extra, args
    if model == "ViT-B/16":
        q8_ties_and_edges(F, Q, kq, rn, tag)
    q8_attention_f32(F, Q, kq, rn, tag, q8_attn)


def q8_ties_and_edges(F, Q, kq: dict, rn, tag: str) -> None:
    """The row quantizer on exact ties and every s8 epilogue at ragged tile
    edges, each against its plain version."""
    import torch

    one = lambda v: torch.full((), v, dtype=torch.float32, device="cuda")  # noqa: E731
    # exact ties, rint's half-to-even: rows of k + 1/2 whose largest value is
    # 127, so the dynamic scale is 1 and x / s lands on the tie; static r = 1
    k = torch.randint(-127, 127, (64, 768), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5))
    ties = k.float() + 0.5
    ties[:, 0] = 127.0
    for r in (None, one(1.0)):
        reading = check_equal("quant_rows ties", Q.quantize_rows(ties, r)[0],
                              Q.quantize_rows_plain(ties, r)[0], kq["quant_rows"])
        say(tag, f"quant_rows 64x768 of exact ties, {'static' if r is not None else 'dynamic'}: "
                 f"{reading}")

    # the ragged tile edges (tiles of 128 rows, 256 columns, 128 of K): the
    # product's K tail and the rows past M arrive as TMA's zeros, the
    # columns past N are cut from the ws and bias loads and the stores
    for ep, save in S8_RAGGED:
        M, K, N = S8_RAGGED_MKN
        _, reading = s8_case(Q, rn, ep, M, K, N, save)
        say(tag, f"gemm_s8_epilogue {ep}{' save h' if save else ''} {M}x{K}->{N}: {reading}")


def q8_attention_f32(F, Q, kq: dict, rn, tag: str, cases: tuple) -> None:
    """attention_fwd's fp32 output, the int8 layers' accumulator, and its
    codes, against the plain version, beside SDPA."""
    import torch
    import torch.nn.functional as tf

    for label, B, S, H, causal, per_layer in cases:
        D = 64 * H
        qkv = rn(B, S, 3 * D)
        got, ref = F.attention_fwd(qkv, H, causal, True), F.attention_plain(qkv, H, causal, True)
        reading = check_close(f"attention_fwd fp32 {label}", got, ref, kq["attention_fwd"],
                              max_limit=ATTN_F32_MAX_ERR, norm_limit=ATTN_F32_NORM_ERR,
                              share_limit=None)
        reading += "; codes " + check_codes(f"attention_fwd fp32 {label} codes",
                                            Q.quantize_rows_plain(got)[0],
                                            Q.quantize_rows_plain(ref)[0])
        del got, ref
        ms = time_ms(lambda: F.attention_fwd(qkv, H, causal, True))
        plain = time_ms(lambda: F.attention_plain(qkv, H, causal, True), 3)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        pairs = sum(min(i + 1, valid) if is_causal else valid for i in range(L))
        q, k_, v = qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4)
        mask = None
        if isinstance(causal, tuple):
            i = torch.arange(L, device=qkv.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
        lib = time_ms(lambda: tf.scaled_dot_product_attention(q, k_, v, attn_mask=mask))
        bms, by = bound(B * S * D * (3 * 2 + 4), 4 * 64 * pairs * n * H, 5 * pairs * n * H)
        say(tag, f"attention_fwd fp32 out {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} "
                 f"plain {plain:.4f} library(sdpa, bf16 out) {lib:.4f} bound {bms:.4f} ({by})")
        if per_layer:
            kq["attention_fwd"].add(ms, plain, lib, bms, by)
        del qkv, q, k_, v


def q8_block(ps: list) -> dict:
    """The twelve layer weights as a block's parameter tree."""
    names = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"), ("attn", "qkv_b"),
             ("attn", "out_w"), ("attn", "out_b"), ("ln_2", "scale"), ("ln_2", "bias"),
             ("mlp", "fc_w"), ("mlp", "fc_b"), ("mlp", "proj_w"), ("mlp", "proj_b"))
    blk = {}
    for (group, name), p in zip(names, ps):
        blk.setdefault(group, {})[name] = p
    return blk


# the int8 layer chains' cases: label, B, S, D, heads, mask.  At ViT-L/14
# the quantization-aware layer saves at batch 32 and, over the wide-MLP
# row-token budget, recomputes at 384
Q8_CHAINS = {"ViT-B/16": (("vision", BATCH, 199, 768, 12, False),
                          ("text packed", 13, 128, 512, 8, (16, 16))),
             "ViT-L/14": (("vision", BATCH, 259, 1024, 16, False),
                          (f"vision batch {GRAD_BATCH}", GRAD_BATCH, 259, 1024, 16, False),
                          ("text packed", 13, 128, 768, 12, (16, 16)))}


def phase_q8_chains(F, Q, layers, model: str = "ViT-B/16") -> None:
    """The four int8 layer chains against their plain versions at the
    model's vision shape and packed text rows (``Q8_CHAINS``): the dynamic
    and the static serving forward, the saving forwards, and the
    quantization-aware forward with its backward, saves on and off (the
    layer saves where ``qat_route`` says it does)."""
    import torch

    tag = phase_name("kernels int8", model, "none")
    rn = randn_fn(6)
    for label, B, S, D, H, causal in Q8_CHAINS[model]:
        x = rn(B, S, D)
        ps = layer_params(rn, D)
        blk = q8_block(ps)
        amax = Q.calibrate(lambda: layers.residual_block(blk, x, H, causal))[0]
        qw = Q.quantize_weights(blk)
        qp = Q._quantize_layer(ps, qw)
        qps, r = Q._quantize_layer_static(ps, amax, qw)
        serve = {}
        for tier, fn, ops in (("int8", Q.layer_fullblock_q8, (*qp,)),
                              ("int8_static", Q.layer_fullblock_q8_static, (*qps, r))):
            y, y_ref = fn(x, *ops, H, causal), fn(x, *ops, H, causal, plain=True)
            reading = check_close(f"{tier} layer {label}", y, y_ref, share_limit=None)
            serve[tier] = y
            ms = time_ms(lambda: fn(x, *ops, H, causal))
            plain = time_ms(lambda: fn(x, *ops, H, causal, plain=True), 2)
            say(tag, f"{tier} layer {label} B={B} S={S} D={D} mask={causal}: {reading} "
                     f"ms {ms:.4f} plain {plain:.4f} {chain_bound(B, S, D, causal, int8=True)}")
            rs = None if tier == "int8" else r
            got = Q.q8_save_forward(x, qps if rs is not None else qp, H, causal, rs)
            ref = Q.q8_save_forward(x, qps if rs is not None else qp, H, causal, rs, plain=True)
            check_equal(f"{tier} saving forward {label}: y vs the serving forward", got[0], y)
            readings = [f"{n} " + check_close(f"{tier} saving forward {label} {n}", g, w,
                                              share_limit=None)
                        for n, g, w in zip(("y", "y1", "qkv", "h"), got, ref)]
            say(tag, f"{tier} saving forward {label}: " + "; ".join(readings))
            del y, y_ref, got, ref

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)
        for tier in ("int8_ste", "int8_ste_static"):
            for save in (True, False):
                with F.saved_acts(save):
                    saves = not qat_route(F, D, B * S, tier).endswith("_recompute")

                def step(plain_fns):
                    with F.saved_acts(save):
                        if tier == "int8_ste":
                            y = Q.layer_fullblock_q8_ste(xg, *ps, H, causal, plain_fns, qw)
                        else:
                            y = Q.layer_fullblock_q8_ste_static(xg, amax, *ps, H, causal,
                                                                plain_fns, qw)
                    if (y.grad_fn.saved_tensors[1] is not None) != saves:
                        raise AssertionError(f"{tier} {label} save={save}: wrong route")
                    return y, torch.autograd.grad(y, xg, gy)[0]

                (y, dx), (y_ref, dx_ref) = step(False), step(True)
                what = (f"{tier} {label} saves {'on' if save else 'off'}: "
                        f"{'saved' if saves else 'recomputed'}")
                served = serve["int8" if tier == "int8_ste" else "int8_static"]
                check_equal(f"{what}: y vs the serving forward", y.detach(), served)
                r_y = check_close(f"{what} y", y, y_ref, share_limit=None)
                r_dx = check_close(f"{what} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                                   norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
                del y, dx, y_ref, dx_ref
                ms = time_ms(lambda: step(False), 5)
                plain = time_ms(lambda: step(True), 1)
                say(tag, f"{what} forward + backward: y {r_y}; dx {r_dx}; ms {ms:.4f} "
                         f"plain {plain:.4f} {chain_bound(B, S, D, causal, bwd=True, int8=True)}")
        del x, xg, gy, ps, blk, qw, qp, qps, serve


# the chunked MLP half (mlp_halfblock_chunked): its kernels at ViT-L/14's
# vision rows and chunk (D 1024, hidden 4096 in 8 chunks of 512), per call
# of its forward and backward; then the op at three shapes: ViT-L/14's
# vision MLP, ViT-B/16's (2 chunks of 1536) and one width above 1024, the
# ViT family's next (ViT-H/14's 1280, 10 chunks of 512: a shape, not a
# model of the repository), at batch 128
M_H = 128 * 259
CHUNK_D, CHUNK_DH = 1024, 4096
CHUNKED = (("ViT-L/14", BATCH, 259, 1024), ("ViT-B/16", BATCH, 199, 768),
           ("D=1280", 128, 259, 1280))
# its LayerNorm dx (fp32 dxn, with a residual): rows, D, launches a call at
# ViT-L/14; D = 2048 is CHUNKED_MAX_WIDTH, the widest the op takes
CHUNKED_LN_BWD = ((M_L, CHUNK_D, 1), (M_H, 1280, 0), (M_H, 2048, 0))


def ln_bwd_widths() -> set:
    """The widths at which ``[kernels*]`` holds the bf16 LayerNorm dx."""
    return ({c[1] for spec in SHAPES.values() for c in spec["ln_bwd"]}
            | {D for _, D, _ in CHUNKED_LN_BWD})


def q8_ln_widths() -> set:
    """The widths at which ``[kernels int8*]`` holds the bf16 LayerNorm-quant."""
    return {c[1] for ln, *_ in Q8_SHAPES.values() for c in ln}


def chunked_launches(K: int) -> tuple:
    """Launches of one call of the chunked MLP half over K chunks: the
    forward (LN, then the fc and proj products of each chunk) and the
    backward (LN again; per chunk fc_gelu_grad, mul_f32 and the dxn
    product; LN dx)."""
    return (dict(layernorm_fwd=1, gemm_bf16_epilogue=2 * K, mlp_halfblock_chunked=1),
            dict(layernorm_fwd=1, gemm_bf16_epilogue=3 * K, layernorm_bwd=1,
                 mlp_halfblock_chunked_bwd=1))


def phase_kernels_chunked(F, kc: dict) -> dict:
    """The chunked MLP half: LayerNorm forward at D = 1024 and 1280, dx at
    ``CHUNKED_LN_BWD``'s widths (1024, 1280, 2048);
    each GEMM of its chain at ViT-L/14's chunk, the fc weight's column
    chunk read in place (strided rows); then the op against its plain
    version at the three CHUNKED shapes, forward and forward + backward,
    launches per call asserted, and its time beside mlp_halfblock's at
    ViT-L/14.  Returns the launches of the op's forward and of its backward
    at ViT-L/14 ({path: counts})."""
    import torch

    tag = "kernels chunked"
    rn = randn_fn(7)
    D, Dh = CHUNK_D, CHUNK_DH
    c = F._pick_chunk(Dh, D)
    K = Dh // c
    # LayerNorm: twice per call (the forward's and the backward's), dx once
    check_ln_fwd(F, rn, tag, M_L, D, kc["layernorm_fwd"], 2)
    check_ln_fwd(F, rn, tag, M_H, 1280, kc["layernorm_fwd"], 0)
    for rows, width, n in CHUNKED_LN_BWD:
        check_ln_bwd(F, rn, tag, rows, width, "float32", True, kc["layernorm_bwd"], n)

    # the chain's GEMMs at the second chunk (a column chunk off the start of
    # fc_w, 16-byte aligned): per call K each, the first chunk's proj and
    # dxn products once, the others' K - 1 times
    kern = kc["gemm_bf16_epilogue"]
    cols = slice(c, 2 * c)
    fc_w, fc_b = rn(D, Dh, std=D ** -0.5), rn(Dh, std=0.1)
    proj_w, proj_b = rn(Dh, D, std=Dh ** -0.5), rn(D, std=0.1)
    xn, x, g = rn(M_L, D), rn(M_L, D), rn(M_L, D)
    act, dh = rn(M_L, c), rn(M_L, c)
    factor = F.quick_gelu_grad(rn(M_L, c, std=2.0, dtype=torch.float32))
    dxn = rn(M_L, D, dtype=torch.float32)
    chunk = f", W a column chunk of ({D}, {Dh})"
    check_gemm(F, tag, "fc_gelu", xn, fc_w[:, cols], fc_b[cols], None, kern, K, note=chunk)
    check_gemm(F, tag, "chunk_residual", act, proj_w[cols], proj_b, x, kern, 1,
               note=", first chunk: r = x, + proj_b")
    check_gemm(F, tag, "chunk_residual", act, proj_w[cols], None, x, kern, K - 1, out=x,
               note=", y in place")
    check_gemm(F, tag, "fc_gelu_grad", xn, fc_w[:, cols], fc_b[cols], None, kern, K, note=chunk)
    check_gemm(F, tag, "mul_f32", g, proj_w[cols], None, factor, kern, K)
    check_gemm(F, tag, "store_f32", dh, fc_w[:, cols], None, None, kern, 1, note=chunk)
    check_gemm(F, tag, "add_f32", dh, fc_w[:, cols], None, None, kern, K - 1, out=dxn,
               note=chunk + ", into the fp32 dxn")
    del fc_w, fc_b, proj_w, proj_b, xn, x, g, act, dh, factor, dxn

    paths = {}
    for label, B, S, D in CHUNKED:
        K = 4 * D // F._pick_chunk(4 * D, D)
        n_fwd, n_bwd = chunked_launches(K)
        x = rn(B, S, D)
        ps = mlp_params(rn, D)
        F.reset_launches()
        y = F.mlp_halfblock_chunked(x, *ps)
        if dict(F.LAUNCHES) != expect(F.LAUNCHES, (1, n_fwd)):
            raise AssertionError(f"mlp_halfblock_chunked {label}: launches {dict(F.LAUNCHES)}")
        reading = check_close(f"mlp_halfblock_chunked {label} y", y,
                              F.mlp_halfblock_chunked_plain(x, *ps), norm_limit=CHUNK_Y_NORM_ERR,
                              share_limit=None)
        del y
        ms = time_ms(lambda: F.mlp_halfblock_chunked(x, *ps))
        plain = time_ms(lambda: F.mlp_halfblock_chunked_plain(x, *ps), 3)
        say(tag, f"mlp_halfblock_chunked {label} B={B} S={S} D={D} K={K}: {reading} "
                 f"ms {ms:.4f} plain {plain:.4f} {chain_bound(B, S, D, False, ('mlp',))}")

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D)

        def step(plain_fns):
            y = F.mlp_halfblock_chunked(xg, *ps, plain=plain_fns)
            return y, torch.autograd.grad(y, xg, gy)[0]

        F.reset_launches()
        y = F.mlp_halfblock_chunked(xg, *ps)
        counts_f = dict(F.LAUNCHES)
        F.reset_launches()
        dx = torch.autograd.grad(y, xg, gy)[0]
        counts_b = dict(F.LAUNCHES)
        if counts_f != expect(F.LAUNCHES, (1, n_fwd)) or counts_b != expect(F.LAUNCHES, (1, n_bwd)):
            raise AssertionError(f"mlp_halfblock_chunked {label}: launches forward {counts_f}, "
                                 f"backward {counts_b}")
        y_ref, dx_ref = step(True)
        r_y = check_close(f"mlp_halfblock_chunked {label} y (saving forward)", y, y_ref,
                          norm_limit=CHUNK_Y_NORM_ERR, share_limit=None)
        r_dx = check_close(f"mlp_halfblock_chunked {label} dx", dx, dx_ref,
                           max_limit=LAYER_DX_MAX_ERR, norm_limit=LAYER_DX_NORM_ERR,
                           share_limit=None)
        del y, dx, y_ref, dx_ref
        ms_t = time_ms(lambda: step(False), 5)
        plain_t = time_ms(lambda: step(True), 2)
        say(tag, f"mlp_halfblock_chunked forward + backward {label}: y {r_y}; dx {r_dx}; "
                 f"ms {ms_t:.4f} plain {plain_t:.4f} "
                 f"{chain_bound(B, S, D, False, ('mlp',), bwd=True)}; launches per call: forward "
                 f"{ {k: v for k, v in counts_f.items() if v} }, backward "
                 f"{ {k: v for k, v in counts_b.items() if v} }")
        if label == "ViT-L/14":
            paths["mlp_halfblock_chunked"], paths["mlp_halfblock_chunked_bwd"] = counts_f, counts_b
            # the monolithic half's chain on the same inputs, h recomputed
            # in its backward as the chunked op recomputes h32
            half_f = time_ms(lambda: F.mlp_halfblock(x, *ps))
            F.set_save_mlp_wide("0")
            try:
                half_t = time_ms(lambda: torch.autograd.grad(F.mlp_halfblock(xg, *ps), xg, gy), 5)
            finally:
                F.set_save_mlp_wide("auto")
            say(tag, f"at ViT-L/14: forward chunked {ms:.4f} ms, mlp_halfblock {half_f:.4f} ms; "
                     f"forward + backward chunked {ms_t:.4f} ms, mlp_halfblock (h recomputed) "
                     f"{half_t:.4f} ms")
        del x, xg, gy, ps
    return paths


def traced(phase: str, fn, cats_of):
    """Run ``fn`` once under the profiler and print where the device time
    went: ``cats_of(prof)`` gives ({category: us}, {kernel: us}, {other: us}).
    Returns the device's idle share of the wall time (None: not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cats, by_kernel, others = cats_of(prof)
    busy = sum(cats.values())
    what = "request" if phase.startswith("serving") else "step"
    if busy <= 0:
        say(phase, f"traced {what}: the profiler recorded no device time (not measured)")
        return None
    share = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in cats.items())
    say(phase, f"traced {what}: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
               f"wall ({1 - busy / wall_us:.1%} idle); {share}")
    if by_kernel:
        say(phase, "by kernel: " + "; ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    say(phase, "largest other device time: " + "; ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top))
    return 1 - busy / wall_us


def serving_time_by_kernel(prof) -> tuple:
    """({kernel or "other": device us}, {}, {other kernel: us}) of a request."""
    import torch

    from mudpt_torch.utils.profiling import SPAN_PREFIX

    by_kernel = {"gemm_bf16_kernel": 0.0, "gemm_s8_kernel": 0.0,
                 "attention_fwd_wgmma_kernel": 0.0,
                 "layernorm_fwd_kernel": 0.0, "layernorm_q8_kernel": 0.0,
                 "quant_rows_kernel": 0.0, "other": 0.0}
    others = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith(SPAN_PREFIX):
            continue  # host-side ops and the program's spans also report their kernels' time
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        key = next((k for k in by_kernel if k in e.key), "other")
        by_kernel[key] += us
        if key == "other" and us > 0:
            others[e.key[:60]] = us
    return {k: v for k, v in by_kernel.items() if v or k == "other"}, {}, others


def phase_name(kind: str, model: str, quant: str) -> str:
    return " ".join([kind] + ([model] if model != "ViT-B/16" else [])
                    + ([quant] if quant != "none" else []))


def phase_serving(F, model: str, quant: str = "none") -> dict:
    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.mudpt import mudpt_image_logits, mudpt_text_features
    from mudpt_torch.utils.synth_step import build_synth_mudpt_server

    phase = phase_name("serving", model, quant)
    t0 = time.perf_counter()
    st = build_synth_mudpt_server(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0, quant=quant)
    torch.cuda.synchronize()
    say(phase, f"built {model} server (random weights, seed 0, quant {quant}) in "
               f"{time.perf_counter() - t0:.2f} s; text rows {tuple(st.aux['token_suffix'].shape)}")
    if st.quantize_s is not None:
        say(phase, f"both towers' weights quantized once, per output channel into (Dout, Din) "
                   f"int8: {st.quantize_s * 1e3:.2f} ms")
    if st.calibration_s is not None:
        say(phase, f"calibration (text encoded under int8, then both towers' activation "
                   f"absmax on the plain route) {st.calibration_s:.3f} s")
    tr, params, aux, images = st.trainable, st.params, st.aux, st.images
    cfg = st.clip_cfg

    # ---- the main path, counted: text encode once, then requests
    F.reset_launches()
    t0 = time.perf_counter()
    txt = st.text_features(tr, params, aux)
    torch.cuda.synchronize()
    t_text = time.perf_counter() - t0
    text_counts = dict(F.LAUNCHES)
    preds = st.eval_step_cached(tr, params, aux, images, txt)  # warm-up request
    torch.cuda.synchronize()
    lat = []
    t_all = time.perf_counter()
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        preds = st.eval_step_cached(tr, params, aux, images, txt)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t_all = time.perf_counter() - t_all
    counts = dict(F.LAUNCHES)

    # the text tower (D <= 768, saves on) runs whole layers, plus ln_final;
    # a request runs the vision tower's layers (whole at D <= 768, halves
    # above), plus ln_pre and ln_post
    n_req = REQUESTS + 1
    vision = "full" if cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH else "half"
    text = "full"
    if quant != "none":  # every layer of both towers runs the tier's int8 chain
        vision = text = Q8_ROUTES[quant]
    want_text = expect(F.LAUNCHES, (cfg.transformer_layers, text), (1, tower_lns(1)))
    if text_counts != want_text:
        raise AssertionError(f"text encode launches {text_counts} != {want_text}")
    want = expect(F.LAUNCHES, (1, want_text), (n_req * cfg.vision_layers, vision),
                  (n_req, tower_lns(2)))
    if counts != want:
        raise AssertionError(f"main-path launches {counts} != {want}")
    per_request = expect(F.LAUNCHES, (cfg.vision_layers, vision), (1, tower_lns(2)))
    say(phase, f"launches: text encode {text_counts}; per request "
               f"{ {k: v for k, v in per_request.items() if v} }; text + {n_req} requests {counts}")

    ips = BATCH * REQUESTS / t_all
    THROUGHPUT[phase] = ips
    say(phase, f"text encode {t_text * 1e3:.1f} ms (once, {N_CLS} classes); "
               f"{REQUESTS} requests of {BATCH} images: median {statistics.median(lat) * 1e3:.2f} ms, "
               f"max {max(lat) * 1e3:.2f} ms; cached-text throughput {ips:.1f} images/s")

    # ---- where one request's device time goes (a separate, traced request)
    traced(phase, lambda: st.eval_step_cached(tr, params, aux, images, txt),
           serving_time_by_kernel)

    # ---- outputs: shape, finiteness, agreement with the plain path on the card
    logits = st.image_logits(tr, params, aux, images, txt)
    with plain_blocks():
        txt_ref = st.text_features(tr, params, aux)
        logits_ref = st.image_logits(tr, params, aux, images, txt_ref)
    torch.cuda.synchronize()
    if txt.shape != (N_CLS, cfg.embed_dim) or logits.shape != (BATCH, N_CLS):
        raise AssertionError(f"shapes: text {tuple(txt.shape)}, logits {tuple(logits.shape)}")
    if preds.shape != (BATCH,) or preds.dtype != torch.int32 or not torch.isfinite(logits).all():
        raise AssertionError("predictions or logits malformed")
    if not torch.equal(preds, logits.argmax(-1).to(torch.int32)):
        raise AssertionError("eval_step_cached disagrees with argmax of image_logits")
    # kernels and plain chain round at the same points, but over 12 bf16
    # layers a one-ulp flip grows like any bf16 drift
    t_read = check_close("text features", txt, txt_ref, max_limit=TEXT_MAX_ERR,
                         norm_limit=TEXT_NORM_ERR, share_limit=None)
    # an int8 tower deeper than GRAD_DEPTH: the drift limit at its depth
    depth = max(cfg.vision_layers, GRAD_DEPTH) if quant != "none" else GRAD_DEPTH
    say(phase, f"vs plain path on the card: text features {t_read}; "
               + hold_logits(logits, logits_ref, LOGITS_DRIFT * math.sqrt(depth / GRAD_DEPTH)))
    if quant != "none":
        # printed, not held: how often int8 serving picks the bf16 tier's class
        kw = dict(clip_cfg=cfg, compute_dtype=torch.bfloat16)
        with torch.inference_mode():
            txt16 = mudpt_text_features(tr, params, aux, **kw)
            logits16 = mudpt_image_logits(tr, params, aux, images, txt16, **kw)
        same = (logits.argmax(-1) == logits16.argmax(-1)).float().mean().item()
        say(phase, f"top-1 agreement with the bf16 tier on the same weights: {same:.4f}; "
                   f"logits max abs difference {(logits - logits16).abs().max().item():.4g}")
    return counts


def hold_logits(logits, logits_ref, drift_limit: float = LOGITS_DRIFT) -> str:
    """Served logits against the plain path's on the card: rows centred
    within ``LOGITS_MAX_ERR`` / ``LOGITS_NORM_ERR``, and the bound of
    tests/test_precision_drift.py (drift within ``drift_limit``, 5%, of the
    largest magnitude, every top-1 whose margin exceeds the drift equal, 75%
    agreement)."""
    # random weights leave the logits of a row close together: the error is
    # held against their spread around the row's mean, not their size
    centred, centred_ref = (t - t.mean(-1, keepdim=True) for t in (logits, logits_ref))
    l_read = check_close("logits, rows centred", centred, centred_ref, max_limit=LOGITS_MAX_ERR,
                         norm_limit=LOGITS_NORM_ERR, share_limit=None)
    drift = (logits - logits_ref).abs().max().item()
    scale = logits_ref.abs().max().item()
    top = logits_ref.topk(2, dim=-1).values
    decisive = (top[:, 0] - top[:, 1]) > 2 * drift
    agree = (logits.argmax(-1) == logits_ref.argmax(-1))
    if drift > drift_limit * scale or not agree[decisive].all() or agree.float().mean() < 0.75:
        raise AssertionError(f"logits vs plain path: drift {drift} (scale {scale}, limit "
                             f"{drift_limit:.4g}), agreement {agree.float().mean().item()}")
    return (f"logits, rows centred {l_read}; logits max abs err {drift:.4g} of max "
            f"{scale:.4g}; top-1 agreement {agree.float().mean().item():.4f}; "
            f"{int(decisive.sum())} decisive rows, {int(agree[decisive].sum())} equal")


def to_float(tree):
    """A parameter tree with every floating tensor in fp32."""
    if isinstance(tree, dict):
        return {k: to_float(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def device_time_by_kernel(prof) -> tuple:
    """({category: device us}, {kernel: us}, {other kernel: us}) from a
    profiler run (``mudpt_torch.utils.profiling.device_time_by_kernel``:
    the forward kernels, the backward kernels, and everything else)."""
    from mudpt_torch.utils.profiling import device_time_by_kernel as by_kernel

    return by_kernel(prof)


def grad_limit(cfg) -> float:
    """The gradient limit at the depth of the model's deeper tower."""
    depth = max(cfg.vision_layers, cfg.transformer_layers, GRAD_DEPTH)
    return GRAD_NORM_ERR * math.sqrt(depth / GRAD_DEPTH)


def leaf_names(tree: dict, prefix: str = "") -> list:
    """The '/'-joined names of a tree's tensors, in ``leaves`` order."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])
    return out


def check_leaf_grads(names, grads) -> None:
    """Every trainable leaf gets a finite gradient that is not zero: a leaf
    cut from the loss (a detached meta-net bias, a prompt head's LayerNorm
    on a dx-only route) gets none, or zeros."""
    import torch

    for name, g in zip(names, grads):
        if g is None or not bool((g != 0).any()):
            raise AssertionError(f"gradient of {name}: none or all zero")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient of {name}: not finite")


def grad_readings(F, st) -> dict:
    """One step's loss and gradients of the trainable leaves from the same
    starting state: the kernels (their launches recorded), the plain
    versions on the card and, to show how far bf16 alone moves them, the
    plain versions in fp32 on the same values (TF32 off), through
    ``st.forward32`` where given (a trainer's forward at fp32), else
    ``mudpt_forward``.  Every leaf's gradient is held finite and not zero.
    Returns the loss's relative difference, the worst leaf's relative norm
    error, the worst ratio of the kernels' and the plain path's distances
    to fp32, and a line a leaf."""
    import functools

    import torch

    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.mudpt import mudpt_forward
    from mudpt_torch.utils.synth_step import leaves, nll_loss

    tr = leaves(st.trainable)
    names = leaf_names(st.trainable)
    forward32 = getattr(st, "forward32", None) or functools.partial(
        mudpt_forward, clip_cfg=st.clip_cfg, compute_dtype=torch.float32)

    def grad(loss):
        return torch.autograd.grad(loss, tr, allow_unused=True)

    F.reset_launches()
    loss = st.loss_fn(st.images, st.labels)
    grads = grad(loss)
    launches = dict(F.LAUNCHES)
    check_leaf_grads(names, grads)
    with plain_blocks():
        loss_ref = st.loss_fn(st.images, st.labels)
        grads_ref = grad(loss_ref)
        params32 = to_float(st.params)
        logits32 = forward32(st.trainable, params32, st.aux, st.images.float())
        grads32 = grad(nll_loss(logits32, st.labels))
        del params32, logits32
    torch.cuda.synchronize()
    check_leaf_grads(names, grads_ref)
    check_leaf_grads(names, grads32)
    loss, loss_ref = loss.item(), loss_ref.item()
    worst = worst_ratio = 0.0
    parts = []
    for name, gk, gp, g32 in zip(names, grads, grads_ref, grads32):
        if gk.shape != gp.shape:
            raise AssertionError(f"gradient of {name}: misshapen")
        err = ((gk - gp).norm() / gp.norm()).item()
        k32, p32 = (((g - g32).norm() / g32.norm()).item() for g in (gk, gp))
        worst, worst_ratio = max(worst, err), max(worst_ratio, k32 / p32)
        parts.append(f"{name} {err:.3g} ({k32:.3g} / {p32:.3g})")
    return dict(launches=launches, loss=loss, loss_ref=loss_ref,
                rel=abs(loss - loss_ref) / abs(loss_ref), worst=worst,
                worst_ratio=worst_ratio, parts=parts)


def grad_check(F, st, phase: str, label: str, want: dict,
               loss_limit: float | None = LOSS_REL_ERR, limits: tuple | None = None) -> None:
    """``grad_readings`` held: the kernels' launches to ``want``, the loss
    to ``loss_limit`` (None: printed, not held), the gradients to
    ``grad_limit`` and the ratio of distances to fp32 to
    ``GRAD_FP32_RATIO`` (ViT-L/14's where the vision tower is deeper than
    12 layers), or to ``limits`` (gradient, ratio) where given."""
    r = grad_readings(F, st)
    check_launches(label, r["launches"], want)
    limit = grad_limit(st.clip_cfg)
    ratio_limit = GRAD_FP32_RATIO_L14 if st.clip_cfg.vision_layers > GRAD_DEPTH else GRAD_FP32_RATIO
    if limits is not None:
        limit, ratio_limit = limits
    rel, worst, worst_ratio = r["rel"], r["worst"], r["worst_ratio"]
    held = "not held" if loss_limit is None else f"limit {loss_limit:.3g}"
    say(phase, f"{label} vs plain path on the card: loss {r['loss']:.6f} vs "
               f"{r['loss_ref']:.6f} (rel {rel:.3g}, {held}); gradient "
               f"relative norm errors, kernels vs plain, limit {limit:.4g} (kernels vs fp32 / "
               f"plain vs fp32): " + ", ".join(r["parts"])
               + f"; worst ratio {worst_ratio:.4f} (limit {ratio_limit})")
    if not ((loss_limit is None or rel <= loss_limit) and worst <= limit
            and worst_ratio <= ratio_limit):
        raise AssertionError(f"{label} vs plain path: loss rel err {rel} (limit "
                             f"{loss_limit}), worst gradient norm err {worst} (limit "
                             f"{limit}), worst ratio of distances to fp32 "
                             f"{worst_ratio} (limit {ratio_limit})")


def step_launches(F, cfg, text_route: str, vision_route: str) -> dict:
    """Launches of one train step: both towers' layers, and ln_pre,
    ln_post, ln_final forward and backward."""
    return expect(F.LAUNCHES, (cfg.transformer_layers, text_route),
                  (cfg.vision_layers, vision_route), (1, tower_lns(3, 3)))


def phase_train(F, model: str, quant: str = "none") -> dict:
    import torch

    from mudpt_torch.utils.synth_step import build_synth_mudpt_step, leaves

    phase = phase_name("train", model, quant)
    if model == "ViT-L/14" and quant != "none":
        # ---- gradients at batch 32, where an fp32 plain step fits and the
        # vision layers' quantization-aware forward saves h (D = 1024 within
        # the wide-MLP row-token budget); the timed steps at batch 384 take
        # the recompute branch
        st = build_synth_mudpt_step(model, GRAD_BATCH, N_CLS, N_CTX, DEPTH, seed=0, quant=quant)
        cfg = st.clip_cfg
        vision = qat_route(F, cfg.vision_width, GRAD_BATCH * (cfg.vision_seq_len + N_CTX), quant)
        if vision != Q8_ROUTES[quant]:
            raise AssertionError(f"{quant} at batch {GRAD_BATCH}: vision route {vision}")
        grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, {quant}, h saved",
                   step_launches(F, cfg, Q8_ROUTES[quant], vision),
                   loss_limit=LOSS_REL_ERR * math.sqrt(BATCH / GRAD_BATCH))
        del st
        torch.cuda.empty_cache()
    elif model in ("ViT-L/14", "ViT-L/14@336px"):
        # ---- gradients at batch 32, where an fp32 plain step fits: the
        # vision MLP recomputing h (its "0" mode), as at batch 384; then, at
        # ViT-L/14, 2,560 classes, whose text tower trains with saves off
        # while the vision MLP saves h (the 336px text tower is the same)
        F.set_save_mlp_wide("0")
        try:
            st = build_synth_mudpt_step(model, GRAD_BATCH, N_CLS, N_CTX, DEPTH, seed=0)
            grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, h recomputed",
                       step_launches(F, st.clip_cfg, "full_train", "half_train_recompute_h"))
        finally:
            F.set_save_mlp_wide("auto")
        del st
        if model == "ViT-L/14":
            st = build_synth_mudpt_step(model, GRAD_BATCH, SAVES_OFF_N_CLS, N_CTX, DEPTH, seed=0)
            grad_check(F, st, phase, f"one step at batch {GRAD_BATCH}, {SAVES_OFF_N_CLS} "
                                     "classes (text saves off, h saved)",
                       step_launches(F, st.clip_cfg, "half_train_saves_off", "half_train"))
            del st
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    st = build_synth_mudpt_step(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0, quant=quant)
    torch.cuda.synchronize()
    tr = leaves(st.trainable)
    cfg = st.clip_cfg
    say(phase, f"built {model} train step (random weights, seed 0, quant {quant}) in "
               f"{time.perf_counter() - t0:.2f} s; {len(tr)} trainable leaves, "
               f"{sum(t.numel() for t in tr)} values")
    if st.quantize_s is not None:
        say(phase, f"both towers' weights quantized once: {st.quantize_s * 1e3:.2f} ms")
    if st.calibration_s is not None:
        say(phase, f"calibration (both towers' activation absmax on the plain route) "
                   f"{st.calibration_s:.3f} s")
    # the text tower (768 wide or less, 100 classes) saves and runs whole
    # layers; the vision tower too at ViT-B; at ViT-L its halves, the MLP's
    # h over the row-token budget at batch 384, so recomputed.  Under a
    # quantization-aware tier every layer saves and runs its int8 chain
    text_route = "full_train"
    if quant != "none":
        text_route = Q8_ROUTES[quant]
        vision_route = qat_route(F, cfg.vision_width, BATCH * (cfg.vision_seq_len + N_CTX),
                                 quant)
    elif cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH:
        vision_route = "full_train"
    elif F.wide_mlp_save(BATCH * cfg.vision_seq_len + BATCH * N_CTX):
        vision_route = "half_train"
    else:
        vision_route = "half_train_recompute_h"
    per_step = step_launches(F, cfg, text_route, vision_route)
    if model == "ViT-B/16":
        grad_check(F, st, phase, "one step", per_step)
    if vision_route.endswith("_recompute"):
        say(phase, f"vision layers over the wide-MLP row-token budget at batch {BATCH}: the "
                   f"quantization-aware forward saves nothing, its backward recomputes it")
    if vision_route.startswith("half_train"):
        # what the vision tower saves for its backward, reckoned: per layer
        # x (the attention half's input), qkv and y1 (the MLP half's input)
        # in bf16, and h where it is saved
        rows = BATCH * (cfg.vision_seq_len + N_CTX)
        per_layer = rows * cfg.vision_width * (5 + (4 if vision_route == "half_train" else 0)) * 2
        say(phase, f"vision saves reckoned: {per_layer / 1e9:.3f} GB a layer, "
                   f"{cfg.vision_layers * per_layer / 1e9:.2f} GB over {cfg.vision_layers} layers "
                   f"({rows} rows of {cfg.vision_width})")

    # ---- the main path, counted: warm-up, then timed steps
    for _ in range(WARMUP_STEPS):
        st.train_step(st.images, st.labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    step_s, losses, after = [], [], [dict(F.LAUNCHES)]
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(st.train_step(st.images, st.labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after.append(dict(F.LAUNCHES))
    t_all = time.perf_counter() - t_all
    counts = after[-1]
    losses = [v.item() for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")

    for i in range(TIMED_STEPS):
        got = {k: after[i + 1][k] - after[i][k] for k in per_step}
        if got != per_step:
            raise AssertionError(f"train step {i}: launches {got} != {per_step}")
    say(phase, f"launches per step ({vision_route} vision layers): "
               f"{ {k: v for k, v in per_step.items() if v} }; over {TIMED_STEPS} steps: {counts}")
    ips = BATCH * TIMED_STEPS / t_all
    THROUGHPUT[phase] = ips
    say(phase, f"{TIMED_STEPS} steps of {BATCH} images: median "
               f"{statistics.median(step_s) * 1e3:.2f} ms, max {max(step_s) * 1e3:.2f} ms; "
               f"training throughput {ips:.1f} images/s; losses {losses[0]:.5f} .. "
               f"{losses[-1]:.5f}; peak device memory over the timed steps "
               f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # ---- where one step's device time goes (a separate, traced step)
    traced(phase, lambda: st.train_step(st.images, st.labels), device_time_by_kernel)
    return counts


# [engine]: MuDPT ViT-B/16 through build_trainer on the synthetic dataset,
# 16 classes x 24 training images at 224 px (384, six batches of 64), two
# epochs; the preempted run stops after batch 3 of epoch 1
ENGINE_FILES = ("configs/datasets/synthetic.yaml",
                "configs/trainers/MuDPT/vit_b16_bz4_ep5_nctx2_depth9.yaml")
ENGINE_BATCH, ENGINE_PREEMPT_AFTER = 64, 3
ENGINE_OPTS = ("TRAINER.NAME", "MuDPT", "MODEL.BACKBONE.PATH", "random",
               "DATASET.SYNTHETIC_NUM_CLASSES", "16", "DATASET.SYNTHETIC_PER_CLASS", "24",
               "DATALOADER.TRAIN_X.BATCH_SIZE", str(ENGINE_BATCH),
               "DATALOADER.TEST.BATCH_SIZE", str(ENGINE_BATCH), "OPTIM.MAX_EPOCH", "2",
               "TRAIN.PRINT_FREQ", "1")
# [bench]: python -m mudpt_torch.bench's value within this share of the
# images/s that [train] and [serving] read in the same run
BENCH_AGREE = 0.10
# images/s of each serving and train phase, for [bench]
THROUGHPUT = {}


def check_resumed(losses, resumed_losses, leaves, resumed_leaves) -> str:
    """A preempted-then-resumed run against the uninterrupted one: every
    per-step loss and every final trainable leaf bit-equal."""
    import torch

    if len(resumed_losses) != len(losses) or any(
            a != b for a, b in zip(resumed_losses, losses)):
        raise AssertionError(f"resumed losses {resumed_losses} != uninterrupted {losses}")
    if len(resumed_leaves) != len(leaves) or not all(
            torch.equal(a, b) for a, b in zip(resumed_leaves, leaves)):
        raise AssertionError("resumed trainable leaves not bit-equal to the uninterrupted run's")
    return f"{len(losses)} losses and {len(leaves)} trainable leaves bit-equal"


def parse_bench_line(out: str) -> dict:
    """The one JSON line ``python -m mudpt_torch.bench`` prints."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines, not one: {out!r}")
    rec = json.loads(lines[0])
    missing = {"metric", "value", "unit", "device", "card"} - set(rec)
    if missing or rec["unit"] != "images/sec/chip":
        raise AssertionError(f"bench line lacks {sorted(missing)} or has unit {rec.get('unit')}")
    return rec


def check_bench(what: str, value: float, reference: float) -> str:
    """The bench's images/s within ``BENCH_AGREE`` of the phase's."""
    rel = value / reference - 1
    if not abs(rel) <= BENCH_AGREE:
        raise AssertionError(f"bench {what}: {value:.1f} images/s is {rel:+.1%} off "
                             f"{reference:.1f} (limit {BENCH_AGREE:.0%})")
    return f"{value:.1f} images/s, {rel:+.2%} from {reference:.1f}"


def _engine_trainer(root: Path, out: str, *more: str):
    from mudpt_torch.config import load_config
    from mudpt_torch.trainers.base import build_trainer

    cfg = load_config(*(str(root / f) for f in ENGINE_FILES),
                      opts=[*ENGINE_OPTS, "OUTPUT_DIR", out, *more])
    return build_trainer(cfg)


def _train_losses(out: str) -> list:
    with open(Path(out) / "metrics.jsonl") as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


def _synced_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def phase_engine(F, root: Path) -> dict:
    """MuDPT ViT-B/16 through the engine: build_trainer on the synthetic
    dataset, the step's gradients and launches, one evaluate's text
    encode, two epochs uninterrupted, and the same preempted and resumed."""
    import copy
    import shutil
    import tempfile
    from types import SimpleNamespace

    import torch

    from mudpt_torch.data.loader import DataLoader
    from mudpt_torch.models.clip import leaves
    from mudpt_torch.utils.synth_step import build_synth_mudpt_step

    phase = "engine"
    tmp = tempfile.mkdtemp(prefix="mudpt_engine_")
    try:
        t0 = time.perf_counter()
        tr = _engine_trainer(root, f"{tmp}/check")
        torch.cuda.synchronize()
        cfg = tr.clip_cfg
        n_train = len(tr.dm.dataset.train_x)
        say(phase, f"built MuDPT ViT-B/16 trainer through build_trainer (random weights, "
                   f"{tr.num_classes} classes, {n_train} training images) in "
                   f"{time.perf_counter() - t0:.2f} s; {len(tr.dm.train_loader)} batches "
                   f"of {ENGINE_BATCH} an epoch; text rows {tuple(tr.aux['token_suffix'].shape)}")
        # epoch 1's batches, from a copy of the loader (the trainer's own
        # keeps its epoch count)
        batches = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]

        # ---- the trainer's first step against the plain route, at its
        # batch of 64 and on epoch 1's 384 images as one batch, with
        # grad_check's limits.  The loss is held only at 384: its difference
        # belongs to the class (each class's images meet one text feature
        # row), so at 16 classes it averages over 16 rows at either batch,
        # reads up to 9.6e-4 at 64 over three seeds and cannot tell two
        # faulty routes from rounding (tools/torch_loss_drift.py, PERF.md)
        per_step = step_launches(F, cfg, "full_train", "full_train")

        def engine_st(b):
            return SimpleNamespace(
                trainable=tr.trainable, params=tr.frozen, aux=tr.aux, clip_cfg=cfg,
                images=b["image"], labels=b["label"],
                loss_fn=lambda images, labels: tr.loss_fn(
                    {"image": images, "label": labels, "valid": b["valid"]})[0])

        grad_check(F, engine_st(batches[0]), phase,
                   f"the trainer's first step, batch of {ENGINE_BATCH}", per_step, loss_limit=None)
        whole = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        grad_check(F, engine_st(whole), phase,
                   f"the trainer's loss on epoch 1's {n_train} images", per_step)
        del whole

        # ---- a traced train step at batch 64, its launches held
        F.reset_launches()
        traced(phase, lambda: tr._train_step(batches[0]), device_time_by_kernel)
        counts = dict(F.LAUNCHES)
        if counts != per_step:
            raise AssertionError(f"traced train step launches {counts} != {per_step}")
        say(phase, f"launches of the traced train step: "
                   f"{ {k: v for k, v in counts.items() if v} }")

        # ---- evaluate: the class text once a pass, then one vision pass a
        # batch (the training images through an eval loader: six batches)
        loader = DataLoader(tr.dm.dataset.train_x, tr.dm.test_loader.transform, ENGINE_BATCH,
                            num_workers=tr.cfg.DATALOADER.NUM_WORKERS)
        n_batches = len(loader)
        F.reset_launches()
        t0 = time.perf_counter()
        results = tr.evaluate(loader, split="train images, eval transform")
        t_eval = time.perf_counter() - t0
        want = expect(F.LAUNCHES, (cfg.transformer_layers, "full"), (1, tower_lns(1)),
                      (n_batches * cfg.vision_layers, "full"), (n_batches, tower_lns(2)))
        if dict(F.LAUNCHES) != want or results["total"] != n_train:
            raise AssertionError(f"evaluate: launches {dict(F.LAUNCHES)} != {want} (one text "
                                 f"encode, {n_batches} vision passes), or {results['total']} "
                                 f"of {n_train} images scored")
        say(phase, f"evaluate over {n_train} images ({n_batches} batches, the text encoded "
                   f"once): {t_eval:.3f} s with the host loader, {n_train / t_eval:.1f} "
                   f"images/s; accuracy {results['accuracy']:.2f}")
        del tr, batches

        # ---- two epochs uninterrupted, every step timed (synchronized)
        full = _engine_trainer(root, f"{tmp}/full")
        step_ms, step = [], full._train_step

        def timed_step(b):
            out = []
            step_ms.append(_synced_ms(lambda: out.append(step(b))))
            return out[0]

        full._train_step = timed_step
        t0 = time.perf_counter()
        full.train()
        t_train = time.perf_counter() - t0
        losses = _train_losses(f"{tmp}/full")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite engine loss: {losses}")
        # the synthetic step at the same batch and class count
        synth = build_synth_mudpt_step("ViT-B/16", ENGINE_BATCH, 16, N_CTX, DEPTH, seed=0)
        for _ in range(WARMUP_STEPS):
            synth.train_step(synth.images, synth.labels)
        synth_ms = [_synced_ms(lambda: synth.train_step(synth.images, synth.labels))
                    for _ in range(TIMED_STEPS)]
        del synth
        say(phase, f"2 epochs x {len(step_ms) // 2} steps of {ENGINE_BATCH} images in "
                   f"{t_train:.2f} s with the loader, evaluation and checkpoints; trainer step "
                   f"median {statistics.median(step_ms[1:]):.2f} ms (first {step_ms[0]:.2f} "
                   f"ms) vs build_synth_mudpt_step at batch {ENGINE_BATCH} "
                   f"{statistics.median(synth_ms):.2f} ms; losses {losses[0]:.5f} .. "
                   f"{losses[-1]:.5f}")

        # ---- the same run preempted after batch 3 of epoch 1, then resumed
        part = _engine_trainer(root, f"{tmp}/part")
        pstep = part._train_step

        def preempting_step(b):
            out = pstep(b)
            if part.epoch == 0 and part.global_step == ENGINE_PREEMPT_AFTER - 1:
                part._preempt = True  # as the SIGTERM handler sets it
            return out

        part._train_step = preempting_step
        part.train()
        if not (Path(tmp) / "part" / part.model_name / "model-preempt.pth.tar").exists():
            raise AssertionError("no preemption checkpoint written")
        del part
        resumed = _engine_trainer(root, f"{tmp}/part", "RESUME", f"{tmp}/part")
        resumed.train()
        reading = check_resumed(losses, _train_losses(f"{tmp}/part"),
                                leaves(full.trainable), leaves(resumed.trainable))
        say(phase, f"preempted after batch {ENGINE_PREEMPT_AFTER} of epoch 1 and resumed: "
                   f"{reading} with the uninterrupted run")
        # the trainer's step again on one resident batch, no loader threads
        # running beside it: how much of its time is the step's own
        b = full._device_batch(list(copy.copy(full.dm.train_loader))[0])
        alone_ms = [_synced_ms(lambda: step(b)) for _ in range(TIMED_STEPS)]
        say(phase, f"trainer step on one resident batch of {ENGINE_BATCH}, no loader "
                   f"running: median {statistics.median(alone_ms):.2f} ms")
        ZOO_RESULTS["MuDPT (engine)"] = dict(batch=ENGINE_BATCH,
                                             step64_ms=statistics.median(alone_ms))
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_bench(F) -> None:
    """``python -m mudpt_torch.bench`` in this process, train and eval at
    ViT-B/16, each value held to [train]'s and [serving]'s images/s."""
    import contextlib
    import io

    from mudpt_torch import bench

    for mode, ref in (("train", "train"), ("eval", "serving")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main(["--mode", mode, "--model", "ViT-B/16", "--batch", str(BATCH),
                        "--n-cls", str(N_CLS), "--n-ctx", str(N_CTX), "--depth", str(DEPTH),
                        "--steps", str(TIMED_STEPS), "--warmup", str(WARMUP_STEPS)])
        rec = parse_bench_line(out.getvalue())
        say("bench", f"--mode {mode}: {json.dumps(rec)}")
        say("bench", f"--mode {mode} vs [{ref}]: "
                     + check_bench(mode, rec["value"], THROUGHPUT[ref]))


# [zoo]: every registered trainer through the port's CLI
# (mudpt_torch.train.main), each on its own YAML, the synthetic dataset cut
# as [engine]'s (16 classes x 24 images at 224 px, one epoch), random
# weights: (label, trainer, trainer YAML, more opts)
ZOO_DATA = "configs/datasets/synthetic.yaml"
ZOO_OPTS = ("DATASET.SYNTHETIC_NUM_CLASSES", "16", "DATASET.SYNTHETIC_PER_CLASS", "24",
            "OPTIM.MAX_EPOCH", "1", "TRAIN.PRINT_FREQ", "1000")
ZOO = (
    ("CoOp", "CoOp", "configs/trainers/CoOp/vit_b16_ep50.yaml", ()),
    ("CoOp_csc_middle", "CoOp", "configs/trainers/CoOp/vit_b16_c16_ep200.yaml",
     ("TRAINER.COOP.CLASS_TOKEN_POSITION", "middle")),
    ("VPT", "VPT", "configs/trainers/VPT/vit_b16_c2_ep5_batch4.yaml", ()),
    ("MPT", "MPT", "configs/trainers/MPT/vit_b16_c2_ep5_batch4.yaml", ()),
    ("UMuDPT", "UMuDPT", "configs/trainers/UMuDPT/vit_b16_bz4_ep5_nctx2_depth9.yaml", ()),
    ("UUMuDPT", "UUMuDPT", "configs/trainers/UUMuDPT/vit_b16_bz4_ep10_nctx2_depth9.yaml", ()),
    ("CoCoOp", "CoCoOp", "configs/trainers/CoCoOp/vit_b32_bz1_ep10_ctxv1.yaml", ()),
    ("ZeroshotCLIP", "ZeroshotCLIP", "configs/trainers/vit_b16.yaml", ()),
    ("ZeroshotCLIP2", "ZeroshotCLIP2", "configs/trainers/vit_b16.yaml", ()),
)
# the zoo's second step timing and its evaluate batch
ZOO_BATCH = 64
# each zoo trainer's step ms at its YAML's batch and at ZOO_BATCH and its
# evaluate images/s, [engine]'s MuDPT step, CoCoOp at scale; printed by [zoo]
ZOO_RESULTS = {}
# a zoo trainer's first step at its YAML's batch (1 to 32 images, 16
# classes) averages fewer samples than the checks above, and bf16 moves its
# gradients further.  Where a trainer's own spread over eight seeds
# (tools/torch_grad_noise.py --zoo, PERF.md) exceeds the default limits,
# its check takes the spread's: (gradient relative norm error, ratio of
# distances to fp32), each the mean + 4 sd, the first rounded up to a power
# of two as GRAD_NORM_ERR is, the second to a tenth as GRAD_FP32_RATIO is;
# the other trainers keep GRAD_NORM_ERR and GRAD_FP32_RATIO
ZOO_GRAD_LIMITS = {"CoOp": (2.0 ** -3, 1.4), "MPT": (2.0 ** -3, 2.0),
                   "UMuDPT": (2.0 ** -4, 1.5), "UUMuDPT": (2.0 ** -4, 1.4),
                   "CoCoOp": (2.0 ** -2, 2.6)}
# CoCoOp at scale: cocoop_forward over 1,000 classes at ViT-B/32, 4 images,
# unchunked and in chunks of 2 instances; its text rows (G sequences of P
# tokens packed to a row) are the half-block chains' case in
# phase_halfblock_chains, and [zoo] holds the real ones to these
COCOOP_B, COCOOP_N_CLS, COCOOP_CHUNK = 4, 1000, 2
COCOOP_PACK = (8, 24)


# under a quantization-aware tier, a layer whose input needs no gradient
# runs the serving forward of its tier
Q8_SERVES = {"int8_ste": "int8", "int8_ste_static": "int8_static"}


def _routes(quant: str) -> tuple:
    """(a trained layer's route, a served layer's route) under ``quant``
    (a quantization-aware layer that saves; D <= 768 on the zoo's paths)."""
    if quant == "none":
        return "full_train", "full"
    return Q8_ROUTES[quant], Q8_ROUTES[Q8_SERVES.get(quant, quant)]


def zoo_step_launches(keys, cfg, text_trains: bool, vision_trains: bool,
                      quant: str = "none") -> dict:
    """A zoo train step's launches: the text tower's saving forward and
    backward where text prompts train (none where its features are cached
    at build), and the vision tower's, or its no-save forward where nothing
    visual trains; the towers' LayerNorms likewise.  An RN vision tower runs
    no kernel of the port (cuDNN convolutions and torch.matmul)."""
    train, serve = _routes(quant)
    parts = []
    if cfg.vision_arch == "vit":
        parts += [(cfg.vision_layers, train if vision_trains else serve),
                  (1, tower_lns(2, 2 if vision_trains else 0))]
    if text_trains:
        parts += [(cfg.transformer_layers, train), (1, tower_lns(1, 1))]
    return expect(keys, *parts)


def zoo_eval_launches(keys, cfg, n_batches: int, text_encodes: int,
                      text_per_batch: bool, quant: str = "none") -> dict:
    """An evaluate pass's launches: ``text_encodes`` class-text encodes (one
    for the trainers with a text/image split, none where the features are
    cached at build), a vision pass a batch (none for an RN tower), and with
    ``text_per_batch`` (CoCoOp) the text tower a batch too."""
    serve = _routes(quant)[1]
    per_batch = ([(cfg.vision_layers, serve), (1, tower_lns(2))]
                 if cfg.vision_arch == "vit" else [])
    text = [(cfg.transformer_layers, serve), (1, tower_lns(1))]
    if text_per_batch:
        per_batch += text
    return expect(keys, (n_batches, expect(keys, *per_batch)),
                  (text_encodes, expect(keys, *text)))


def cocoop_launches(keys, cfg, n_chunks: int, quant: str = "none") -> dict:
    """Launches of one cocoop_forward and its backward at the scale case:
    the vision tower's no-save forward, then a chunk at a time the text
    tower's training forward and backward on the half-blocks with saves
    off, and, chunked, the recompute torch.utils.checkpoint makes in the
    backward: one more text forward a chunk.  Under ``int8`` the forward
    alone (inference), every layer on the dynamic chain; under ``int8_ste``
    the text layers' quantization-aware chain, saves off (its backward
    recomputes the q8 forward), and chunked the checkpoint's forward again."""
    if quant == "int8":
        return expect(keys, (cfg.vision_layers, "q8"), (1, tower_lns(2)),
                      (n_chunks, expect(keys, (cfg.transformer_layers, "q8"),
                                        (1, tower_lns(1)))))
    train, again, serve = (("half_train_saves_off", "half", "full") if quant == "none" else
                           ("q8_train_recompute", "q8_train_fwd", "q8"))
    chunk = [(cfg.transformer_layers, train), (1, tower_lns(1, 1))]
    if n_chunks > 1:
        chunk += [(cfg.transformer_layers, again), (1, tower_lns(1))]
    return expect(keys, (cfg.vision_layers, serve), (1, tower_lns(2)),
                  (n_chunks, expect(keys, *chunk)))


def kernel_groups(F) -> tuple:
    """The kernel object's entries, every launch count of ``F.KERNELS``
    once: (the bf16 chains' kernels, the int8 tiers', the fp32 chains', the
    probes')."""
    import torch

    fp32 = [by[torch.float32] for by in F.DTYPE_KERNELS.values()]
    bf16 = [k for k in F.KERNELS if k not in (*fp32, *Q8_KERNELS, *PROBE_KERNELS)]
    return bf16, list(Q8_KERNELS), fp32, list(PROBE_KERNELS)


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        raise AssertionError(f"{what}: launches differ (got, expected): {diff}")


def zoo_step_case(tr, batch: dict = None):
    """(the trainer's first batch, or the device ``batch``, as
    ``grad_readings`` takes a step: its loss, trees and fp32 forward; the
    device batch)."""
    import copy
    import functools
    from types import SimpleNamespace

    import torch

    if batch is None:
        batch = tr._device_batch(next(iter(copy.copy(tr.dm.train_loader))))
    st = SimpleNamespace(
        trainable=tr.trainable, params=tr.frozen, aux=tr.aux, clip_cfg=tr.clip_cfg,
        images=batch["image"], labels=batch["label"],
        forward32=functools.partial(tr.forward, compute_dtype=torch.float32),
        loss_fn=lambda images, labels: tr.loss_fn(
            {"image": images, "label": labels, "valid": batch["valid"]})[0])
    return st, batch


def zoo_trainer(root: Path, trainer: str, yaml: str, more: tuple, out: str):
    """The trainer as ``python -m mudpt_torch.train ... --no_train`` builds
    it, in this process; the CLI's tee of stdout into the run's log is
    undone after."""
    from mudpt_torch import train as train_cli

    argv = ["--trainer", trainer, "--trainer_config", str(root / yaml),
            "--dataset_config", str(root / ZOO_DATA), "--output_dir", out,
            "--backbone_path", "random", "--no_train", *ZOO_OPTS, *more]
    streams = sys.stdout, sys.stderr
    try:
        return train_cli.main(train_cli.parse_args(argv))
    finally:
        sys.stdout, sys.stderr = streams


def phase_zoo(F, root: Path) -> dict:
    """Every registered trainer through the port's CLI, then CoCoOp at
    1,000 classes unchunked and chunked.  Returns each path's launches."""
    import shutil
    import tempfile

    import torch

    from mudpt_torch.data.loader import DataLoader
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.zsclip import _encode_templates

    phase = "zoo"
    paths = {}
    tmp = tempfile.mkdtemp(prefix="mudpt_zoo_")
    try:
        for label, trainer, yaml, more in ZOO:
            t0 = time.perf_counter()
            tr = zoo_trainer(root, trainer, yaml, more, f"{tmp}/{label}")
            torch.cuda.synchronize()
            cfg = tr.clip_cfg
            bsz = tr.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
            n_leaves = len(leaf_names(tr.trainable)) if tr.trainable is not None else 0
            say(phase, f"{label}: built {trainer} ({yaml}, {tr.cfg.MODEL.BACKBONE.NAME}, "
                       f"{tr.num_classes} classes, {len(tr.dm.dataset.train_x)} training "
                       f"images, batch {bsz}) through mudpt_torch.train in "
                       f"{time.perf_counter() - t0:.2f} s; {n_leaves} trainable leaves")
            loader = DataLoader(tr.dm.dataset.train_x, tr.dm.test_loader.transform, ZOO_BATCH,
                                num_workers=tr.cfg.DATALOADER.NUM_WORKERS)
            b64 = tr._device_batch(next(iter(loader)))
            static = getattr(tr, "static_text", False)
            split = getattr(tr, "forward_text", None) is not None
            if tr.trainable is None:
                # ---- zero-shot: text features and logits against the plain
                # route on the card
                templates = tr.template_list()
                with torch.no_grad():
                    logits = tr.forward(tr.trainable, tr.frozen, tr.aux, b64["image"])
                    with plain_blocks():
                        txt_ref = _encode_templates(tr.frozen, cfg, tr.classnames, templates,
                                                    tr.compute_dtype, tr.device)
                        logits_ref = tr.forward(tr.trainable, tr.frozen,
                                                {"text_features": txt_ref}, b64["image"])
                t_read = check_close(f"{label} text features", tr.aux["text_features"], txt_ref,
                                     max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR,
                                     share_limit=None)
                centred, centred_ref = (t - t.mean(-1, keepdim=True)
                                        for t in (logits, logits_ref))
                l_read = check_close(f"{label} logits, rows centred", centred, centred_ref,
                                     max_limit=LOGITS_MAX_ERR, norm_limit=LOGITS_NORM_ERR,
                                     share_limit=None)
                say(phase, f"{label} vs plain route on the card ({len(templates)} templates): "
                           f"text features {t_read}; logits of {ZOO_BATCH} images, rows "
                           f"centred {l_read}")
                step_ms = step64_ms = None
            else:
                # ---- the first step against the plain route, every leaf's
                # gradient finite and not zero, the step's launches held
                st, batch = zoo_step_case(tr)
                per_step = zoo_step_launches(F.LAUNCHES, cfg, not static,
                                             trainer not in ("CoOp", "CoCoOp"))
                grad_check(F, st, phase, f"{label}: the first step, batch {bsz}, all "
                                         f"{n_leaves} leaves' gradients finite and not zero",
                           per_step, loss_limit=None, limits=ZOO_GRAD_LIMITS.get(label))
                F.reset_launches()
                traced(phase, lambda: tr._train_step(batch), device_time_by_kernel)
                check_launches(f"{label} traced step", dict(F.LAUNCHES), per_step)
                paths[f"zoo_{label}_step"] = dict(F.LAUNCHES)
                say(phase, f"{label}: launches of a step "
                           f"{ {k: v for k, v in per_step.items() if v} }")
                # ---- one epoch at the YAML's batch, every step timed
                times, step = [], tr._train_step

                def timed_step(b, step=step, times=times):
                    out = []
                    times.append(_synced_ms(lambda: out.append(step(b))))
                    return out[0]

                tr._train_step = timed_step
                t0 = time.perf_counter()
                tr.train()
                t_train = time.perf_counter() - t0
                tr._train_step = step
                losses = _train_losses(f"{tmp}/{label}")
                if not all(math.isfinite(v) for v in losses):
                    raise AssertionError(f"{label}: non-finite loss {losses}")
                step_ms = statistics.median(times[1:])
                for _ in range(WARMUP_STEPS):
                    step(b64)
                step64_ms = statistics.median(_synced_ms(lambda: step(b64))
                                              for _ in range(TIMED_STEPS))
                say(phase, f"{label}: one epoch of {len(times)} steps in {t_train:.2f} s "
                           f"(loader, checkpoint and test in); step at batch {bsz} median "
                           f"{step_ms:.2f} ms (first {times[0]:.2f} ms), at batch {ZOO_BATCH} "
                           f"{step64_ms:.2f} ms; loss at the epoch's end {losses[-1]:.5f}")
            # ---- evaluate over the training images at batch 64: the class
            # text once where the forward splits, cached, or a batch (CoCoOp)
            n_batches = len(loader)
            F.reset_launches()
            t0 = time.perf_counter()
            results = tr.evaluate(loader, split="train images, eval transform")
            t_eval = time.perf_counter() - t0
            cocoop = trainer == "CoCoOp"
            want = zoo_eval_launches(F.LAUNCHES, cfg, n_batches, int(split and not static),
                                     cocoop)
            check_launches(f"{label} evaluate", dict(F.LAUNCHES), want)
            if results["total"] != len(tr.dm.dataset.train_x):
                raise AssertionError(f"{label} evaluate scored {results['total']} images")
            if tr.trainable is None:
                paths[f"zoo_{label}_evaluate"] = dict(F.LAUNCHES)
                tr.train()  # zero-shot: test()
            ips = results["total"] / t_eval
            text_note = "a batch" if cocoop else "once" if split and not static else "cached"
            say(phase, f"{label}: evaluate over {results['total']} images ({n_batches} batches, "
                       f"the class text {text_note}): {ips:.1f} images/s with the host "
                       f"loader; accuracy {results['accuracy']:.2f}")
            ZOO_RESULTS[label] = dict(batch=bsz, step_ms=step_ms, step64_ms=step64_ms,
                                      eval_images_per_s=ips)
            del tr, b64, loader
            torch.cuda.empty_cache()
        say(phase, "summary: " + json.dumps(ZOO_RESULTS))
        paths.update(cocoop_at_scale(F))
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cocoop_names(n: int) -> list:
    """Synthetic class names of 3 to 12 words, whose prompts end within
    24 tokens, as most of ImageNet's do."""
    return [" ".join(["synthetic", "class", str(i)] + ["variant"] * (i % 10)) for i in range(n)]


def check_bit_equal(what: str, a: tuple, b: tuple) -> str:
    """Two runs' outputs (logits, then each gradient) bit-equal."""
    import torch

    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if x.shape != y.shape or not torch.equal(x, y)]
    if differ or len(a) != len(b):
        raise AssertionError(f"{what}: outputs {differ} not bit-equal")
    return f"{len(a)} outputs bit-equal"


def cocoop_at_scale(F, device: str = "cuda", quant: str = "none") -> dict:
    """cocoop_forward at 1,000 classes, 4 images, ViT-B/32 (seeded random
    weights, CTX_INIT "a photo of a" as CoCoOp's YAML): its text rows take
    the half-block route with saves off at D = 512.  Unchunked and chunked,
    each against the plain route on the card, chunked against unchunked;
    launches held, the step ms and peak memory of each, chunked lower.
    Under ``int8`` (the logits, inference) and ``int8_ste`` (logits and
    gradients) the towers' weights are quantized once as a trainer's build
    does, and chunked is held bit-equal to unchunked."""
    import contextlib

    import torch

    from mudpt_torch.models import layers
    from mudpt_torch.models.clip import VIT_B32, cast_matmul_weights, init_clip_params, leaves
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.models.text import _auto_pack_g, _text_saves_off
    from mudpt_torch.ops.quant_block import quantize_blocks
    from mudpt_torch.trainers.cocoop import cocoop_forward
    from mudpt_torch.trainers.prompt_utils import (ctx_vectors_from_init, embed_classnames,
                                                   init_linear)
    from mudpt_torch.utils.rng import new_rng
    from mudpt_torch.utils.synth_step import nll_loss

    phase = "zoo" if quant == "none" else "cocoop int8"
    cfg, dev = VIT_B32, torch.device(device)
    g = new_rng(0, dev)
    params = cast_matmul_weights(init_clip_params(cfg, g), torch.bfloat16)
    if quant != "none":
        params = {k: dict(v, blocks=quantize_blocks(v["blocks"])) if isinstance(v, dict) else v
                  for k, v in params.items()}
    aux = embed_classnames(params["text"], cocoop_names(COCOOP_N_CLS), 4,
                           "a photo of a").as_device_tree()
    trainable = {"ctx": ctx_vectors_from_init(params["text"], "a photo of a", 4),
                 "meta_net": {"linear1": init_linear(g, cfg.embed_dim, cfg.embed_dim // 16),
                              "linear2": init_linear(g, cfg.embed_dim // 16,
                                                     cfg.transformer_width)}}
    for t in leaves(trainable):
        t.requires_grad_(True)
    res = cfg.image_resolution
    images = torch.randn(COCOOP_B, res, res, 3, generator=g, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, COCOOP_N_CLS, (COCOOP_B,), generator=g, device=dev)
    S = aux["token_prefix"].shape[1] + 4 + aux["token_suffix"].shape[1]
    P = -(-S // 8) * 8
    G = _auto_pack_g(P, COCOOP_B * COCOOP_N_CLS)
    if (G, P) != COCOOP_PACK or S != P or not _text_saves_off(COCOOP_B * COCOOP_N_CLS, P):
        raise AssertionError(f"CoCoOp text rows: G {G}, P {P}, S {S}; the half-block chain "
                             f"case was {COCOOP_PACK}, saves off")
    names = leaf_names(trainable)
    inference = quant == "int8"

    def run(chunk: int, plain: bool):
        F.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with (plain_blocks() if plain else contextlib.nullcontext()), layers.quantized(quant), \
                (torch.no_grad() if inference else contextlib.nullcontext()):
            logits = cocoop_forward(trainable, params, aux, images, clip_cfg=cfg,
                                    compute_dtype=torch.bfloat16, encode_chunk=chunk)
            grads = () if inference else torch.autograd.grad(
                nll_loss(logits, labels), leaves(trainable), allow_unused=True)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if not inference:
            check_leaf_grads(names, grads)
        return logits.detach(), grads, dict(F.LAUNCHES), peak

    def compare(what, a, b):
        (la, ga), (lb, gb) = a, b
        centred = [t - t.mean(-1, keepdim=True) for t in (la, lb)]
        step = 1 if quant == "none" else Q8_STEP
        reading = check_close(f"{what} logits, rows centred", *centred,
                              max_limit=LOGITS_MAX_ERR * step, norm_limit=LOGITS_NORM_ERR * step,
                              share_limit=None)
        if inference:
            return f"logits {reading}"
        limit = grad_limit(cfg) if quant == "none" else ZOO_GRAD_LIMITS["CoCoOp"][0]
        errs = [((x - y).norm() / y.norm()).item() for x, y in zip(ga, gb)]
        if not max(errs) <= limit:
            raise AssertionError(f"{what}: gradient relative norm errors {errs} over {limit}")
        return f"logits {reading}; gradients " + ", ".join(
            f"{n} {e:.3g}" for n, e in zip(names, errs)) + f" (limit {limit:.4g})"

    out, runs = {}, {}
    key_of = f"cocoop_scale_{'' if quant == 'none' else quant + '_'}"
    for chunk in (-1, COCOOP_CHUNK):
        key = "unchunked" if chunk == -1 else f"chunks of {chunk}"
        n_chunks = 1 if chunk == -1 else -(-COCOOP_B // chunk)
        logits, grads, launches, peak = run(chunk, False)
        check_launches(f"CoCoOp {key}", launches,
                       cocoop_launches(F.LAUNCHES, cfg, n_chunks, quant))
        out[key_of + ("unchunked" if chunk == -1 else "chunked")] = launches
        ref = run(chunk, True)
        reading = compare(f"CoCoOp {key} vs plain route", (logits, grads), ref[:2])
        run(chunk, False)  # warm
        ms = statistics.median(_synced_ms(lambda: run(chunk, False)) for _ in range(3))
        runs[chunk] = (logits, grads, peak, ms)
        say(phase, f"CoCoOp {COCOOP_B} images x {COCOOP_N_CLS} classes ({G} sequences of {P} "
                   f"tokens a packed row, D = 512, saves off, quant {quant}), {key}: "
                   f"{'forward' if inference else 'forward + backward'} {ms:.2f} ms, peak "
                   f"{peak:.3f} GiB over the inputs; launches "
                   f"{ {k: v for k, v in launches.items() if v} }; vs plain route: {reading}")
    (lu, gu, pu, mu), (lc, gcs, pc, mc) = runs[-1], runs[COCOOP_CHUNK]
    if quant == "none":
        reading = compare("CoCoOp chunked vs unchunked", (lc, gcs), (lu, gu))
    else:
        reading = check_bit_equal(f"CoCoOp {quant} chunked vs unchunked", (lc, *gcs),
                                  (lu, *gu))
    if not pc < pu:
        raise AssertionError(f"CoCoOp chunked peak {pc:.3f} GiB not below unchunked {pu:.3f}")
    say(phase, f"CoCoOp chunked vs unchunked: {reading}; peak {pc:.3f} vs {pu:.3f} GiB, "
               f"step {mc:.2f} vs {mu:.2f} ms")
    ZOO_RESULTS["CoCoOp_scale" + ("" if quant == "none" else f"_{quant}")] = dict(
        unchunked_ms=mu, chunked_ms=mc, unchunked_peak_gib=pu, chunked_peak_gib=pc)
    return out


# [zoo int8]: the zoo under the int8 tiers: one step of each trainer at
# ZOO_BATCH under int8_ste, and an evaluate of one batch under int8 and,
# for the trainers the JAX package calibrates at build (its UMuDPT and
# UUMuDPT raise: their prompt heads' blocks enter the text capture; CoCoOp
# raises: no image-independent text), under int8_static
ZOO_Q8_STATIC = ("CoOp", "CoOp_csc_middle", "VPT", "MPT", "ZeroshotCLIP", "ZeroshotCLIP2")


def zoo_eval_one_batch(F, tr, label: str, loader, quant: str, phase: str) -> dict:
    """One evaluate of ``loader``'s batch under ``quant``: its launches held,
    its images/s, and the forward's logits against the plain route."""
    import torch

    from mudpt_torch.models.layers import plain_blocks

    cfg = tr.clip_cfg
    split = getattr(tr, "forward_text", None) is not None
    static = getattr(tr, "static_text", False)
    cocoop = type(tr).__name__ == "CoCoOp"
    images = tr._device_batch(next(iter(loader)))["image"]
    F.reset_launches()
    t0 = time.perf_counter()
    results = tr.evaluate(loader, split=f"one batch, {quant}")
    t_eval = time.perf_counter() - t0
    launches = dict(F.LAUNCHES)
    check_launches(f"{label} evaluate under {quant}", launches,
                   zoo_eval_launches(F.LAUNCHES, cfg, 1, int(split and not static), cocoop,
                                     quant))
    with torch.no_grad():
        logits = tr.forward(tr.trainable, tr.frozen, tr.aux, images)
        with plain_blocks():
            logits_ref = tr.forward(tr.trainable, tr.frozen, tr.aux, images)
    centred, centred_ref = (t[:, :tr.num_classes].float() - t[:, :tr.num_classes].float().mean(
        -1, keepdim=True) for t in (logits, logits_ref))
    reading = check_close(f"{label} logits under {quant}, rows centred", centred, centred_ref,
                          max_limit=LOGITS_MAX_ERR * Q8_STEP,
                          norm_limit=LOGITS_NORM_ERR * Q8_STEP, share_limit=None)
    say(phase, f"{label} evaluate of {results['total']} images under {quant}: "
               f"{results['total'] / t_eval:.1f} images/s; launches "
               f"{ {k: v for k, v in launches.items() if v} }; vs plain route, logits rows "
               f"centred: {reading}")
    return launches


def phase_zoo_int8(F, root: Path) -> dict:
    """Each zoo trainer through the port's CLI under TRAIN.QUANT int8_ste at
    batch ZOO_BATCH: the first step against the plain route (every leaf's
    gradient finite and not zero, the worst leaf and the ratio of distances
    to fp32 printed and held as [zoo] holds them) and its launches; then
    one evaluate under int8 and, where the JAX package calibrates, under
    int8_static, calibrated as the build does.  Returns each path's
    launches."""
    import shutil
    import tempfile

    import torch

    from mudpt_torch.data.loader import DataLoader
    from mudpt_torch.models import layers

    phase = "zoo int8"
    paths = {}
    tmp = tempfile.mkdtemp(prefix="mudpt_zoo_int8_")
    try:
        for label, trainer, yaml, more in ZOO:
            t0 = time.perf_counter()
            tr = zoo_trainer(root, trainer, yaml, more + (
                "TRAIN.QUANT", "int8_ste", "DATALOADER.TRAIN_X.BATCH_SIZE", str(ZOO_BATCH)),
                f"{tmp}/{label}")
            torch.cuda.synchronize()
            say(phase, f"{label}: built {trainer} ({tr.cfg.MODEL.BACKBONE.NAME}) under "
                       f"int8_ste through mudpt_torch.train in {time.perf_counter() - t0:.2f} s")
            loader = DataLoader(tr.dm.dataset.train_x[:ZOO_BATCH], tr.dm.test_loader.transform,
                                ZOO_BATCH, num_workers=tr.cfg.DATALOADER.NUM_WORKERS)
            if tr.trainable is not None:
                st, batch = zoo_step_case(tr)
                per_step = zoo_step_launches(F.LAUNCHES, tr.clip_cfg,
                                             not getattr(tr, "static_text", False),
                                             trainer not in ("CoOp", "CoCoOp"), "int8_ste")
                grad_check(F, st, phase, f"{label}: the first step under int8_ste, batch "
                                         f"{ZOO_BATCH}", per_step, loss_limit=None,
                           limits=ZOO_GRAD_LIMITS.get(label))
                F.reset_launches()
                ms = _synced_ms(lambda: tr._train_step(batch))
                check_launches(f"{label} int8_ste step", dict(F.LAUNCHES), per_step)
                paths[f"zoo_int8_ste_{label}_step"] = dict(F.LAUNCHES)
                say(phase, f"{label}: an int8_ste step at batch {ZOO_BATCH} {ms:.2f} ms; "
                           f"launches {json.dumps({k: v for k, v in per_step.items() if v})}")
            else:
                paths[f"zoo_int8_ste_{label}_evaluate"] = zoo_eval_one_batch(
                    F, tr, label, loader, "int8_ste", phase)
            layers.set_quant_mode("int8")
            paths[f"zoo_int8_{label}_evaluate"] = zoo_eval_one_batch(F, tr, label, loader,
                                                                     "int8", phase)
            if label in ZOO_Q8_STATIC:
                layers.set_quant_mode("int8_static")
                t0 = time.perf_counter()
                tr._calibrate_static_quant()
                say(phase, f"{label}: calibrated for int8_static in "
                           f"{time.perf_counter() - t0:.3f} s")
                paths[f"zoo_int8_static_{label}_evaluate"] = zoo_eval_one_batch(
                    F, tr, label, loader, "int8_static", phase)
            layers.set_quant_mode("none")
            del tr, loader
            torch.cuda.empty_cache()
        return paths
    finally:
        layers.set_quant_mode("none")
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cocoop_int8(F, root: Path) -> dict:
    """cocoop_at_scale under int8 and int8_ste; then a CoCoOp trainer built
    under TRAIN.QUANT int8 through the CLI, exported under pallas_int8 at a
    pinned batch of ZOO_BATCH, served in a fresh process (bit-equal to the
    tier in this process, its launches held) and timed."""
    import shutil
    import tempfile

    from mudpt_torch.models import layers

    phase = "cocoop int8"
    paths = {}
    for quant in ("int8", "int8_ste"):
        paths.update(cocoop_at_scale(F, quant=quant))
    tmp = tempfile.mkdtemp(prefix="mudpt_cocoop_int8_")
    try:
        _, trainer, yaml, more = next(z for z in ZOO if z[0] == "CoCoOp")
        tr = zoo_trainer(root, trainer, yaml, more + ("TRAIN.QUANT", "int8"), f"{tmp}/out")
        layers.set_quant_mode("none")
        paths["cocoop_pallas_int8_artifact_request"] = export_and_serve(
            F, root, tmp, tr, "pallas_int8", phase,
            zoo_eval_launches(F.LAUNCHES, tr.clip_cfg, 1, 0, True, "int8"))
        return paths
    finally:
        layers.set_quant_mode("none")
        shutil.rmtree(tmp, ignore_errors=True)


def export_and_serve(F, root: Path, tmp: str, tr, tier: str, phase: str, want: dict) -> dict:
    """The trainer exported under ``tier`` at a pinned batch of ZOO_BATCH
    training images, served in a fresh process: its logits bit-equal to the
    tier in this process, its launches ``want``, its request timed there.
    Returns the request's launches."""
    import numpy as np
    import torch

    from mudpt_torch import serving
    from mudpt_torch.data.loader import DataLoader

    loader = DataLoader(tr.dm.dataset.train_x[:ZOO_BATCH], tr.dm.test_loader.transform,
                        ZOO_BATCH)
    images_np = np.asarray(next(iter(loader))["image"], np.float32)
    np.save(f"{tmp}/images.npy", images_np)
    art = f"{tmp}/{tier}"
    t0 = time.perf_counter()
    serving.export_trainer(art, tr, batch=ZOO_BATCH, block_impl=tier)
    export_s = time.perf_counter() - t0
    score, ops, _ = serving.trainer_program(tr, block_impl=tier)
    with torch.no_grad(), serving._block_impl(tier):
        ref = score(ops, torch.from_numpy(images_np).cuda())
    del score, ops
    logits, child, process_s = served_fresh(root, art, f"{tmp}/images.npy", tier)
    check_launches(f"the {tier} artifact's request", child["launches"], want)
    reading = check_bit_equal(f"the {tier} artifact vs the tier in this process", (logits,),
                              (ref,))
    say(phase, f"{type(tr).__name__} {tr.cfg.MODEL.BACKBONE.NAME} {tier} artifact at batch "
               f"{ZOO_BATCH}: exported in {export_s:.2f} s; fresh process {process_s:.2f} s "
               f"(load {child['load_s']:.2f} s); launches "
               f"{ {k: v for k, v in child['launches'].items() if v} }; vs the tier in this "
               f"process: {reading}; a request there {child['request_ms']:.2f} ms, "
               f"{child['images_per_s']:.1f} images/s")
    return child["launches"]


# [rn]: the RN presets at full width on the zoo's synthetic cut.  CoOp's
# and CoCoOp's YAMLs with MODEL.BACKBONE.NAME set (RN50x4 at its 288 px);
# the zero-shot trainer on each preset at its resolution
RN_COOP = ("configs/trainers/CoOp/vit_b16_ep50.yaml",
           ("MODEL.BACKBONE.NAME", "RN50", "DATALOADER.TRAIN_X.BATCH_SIZE", str(ZOO_BATCH)))
RN_ZS = (("RN50", 224), ("RN101", 224), ("RN50x4", 288), ("RN50x16", 384), ("RN50x64", 448))
# the bf16 image features against an fp32 run of the same tower on the card
# (TF32 off), over RN_FEATURE_IMAGES images, with BatchNorm statistics drawn
# by rn_bn_stats: relative norm error
RN_FEATURE_IMAGES = 16
# readings 0.0260-0.0310 over the five presets on the H100 (PERF.md): the
# limit 1.45 times the largest; a BatchNorm folded in bf16 reads 2.3 times
# the sound tower's (tests/test_torch_chip_checks.py)
RN_FEATURE_NORM_ERR = 0.045


def rn_bn_stats(tree: dict, seed: int) -> dict:
    """A copy of an RN tower with every BatchNorm's statistics drawn from
    ``seed``: running means far from zero (sd 4) that the fold cancels
    (bias = mean x scale / sqrt(var + eps) plus a small offset), as in a
    tower whose convolutions' outputs sit far from zero.  Folded in fp32 and
    rounded once, the bias keeps its small offset; folded in bf16, each
    operand's rounding (4 x 2^-9) swamps it."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def draw(node):
        if set(node) == {"scale", "bias", "mean", "var"}:
            n, dev = node["scale"].shape[0], node["scale"].device
            mean = 4.0 * torch.randn(n, generator=g)
            var = torch.exp(0.5 * torch.randn(n, generator=g))
            scale = 1 + 0.1 * torch.randn(n, generator=g)
            bias = mean * scale * torch.rsqrt(var + 1e-5) + 0.2 * torch.randn(n, generator=g)
            return {k: v.to(dev) for k, v in
                    dict(scale=scale, bias=bias, mean=mean, var=var).items()}
        return {k: draw(v) if isinstance(v, dict) else v for k, v in node.items()}

    return draw(tree)


def rn_feature_check(visual: dict, cfg, images, label: str, limit: float) -> str:
    """The RN tower's bf16 image features (its bf16 cast, ``_cast_rn_visual``)
    against the same tower in fp32, both with ``rn_bn_stats``' statistics:
    relative norm error within ``limit``."""
    import torch

    from mudpt_torch.models.clip import _cast_rn_visual
    from mudpt_torch.models.resnet import resnet_forward

    p = rn_bn_stats(to_float(visual), 7)
    kw = dict(layers=cfg.vision_layers_per_stage, heads=cfg.vision_heads)
    with torch.no_grad():
        f32 = resnet_forward(p, images.float(), compute_dtype=torch.float32, **kw)
        f16 = resnet_forward(_cast_rn_visual(p, torch.bfloat16), images.to(torch.bfloat16),
                             compute_dtype=torch.bfloat16, **kw).float()
    if not bool(torch.isfinite(f16).all()) or f16.shape != f32.shape:
        raise AssertionError(f"{label}: bf16 features malformed {tuple(f16.shape)}")
    err = ((f16 - f32).norm() / f32.norm()).item()
    if not err <= limit:
        raise AssertionError(f"{label}: bf16 features vs fp32, relative norm error {err:.4g} "
                             f"over {limit:.4g}")
    return f"bf16 features vs fp32 relative norm error {err:.4g} (limit {limit:.4g})"


def phase_rn(F, root: Path) -> dict:
    """The RN presets: CoOp on RN50 through the CLI (the first step against
    the plain route, a traced step's idle share and launches, step ms,
    evaluate images/s), one step of CoOp on RN50x4 (its text tower's rows
    1-3 at D = 640, 10 heads) and of CoCoOp on RN50; the zero-shot trainer
    on each of the five presets (its text encode's launches, one evaluate of
    ZOO_BATCH images, images/s, peak memory, the bf16 features against
    fp32); the CoOp RN50 pallas artifact served in a fresh process."""
    import shutil
    import tempfile

    import torch

    from mudpt_torch.data.loader import DataLoader

    phase = "rn"
    paths = {}
    tmp = tempfile.mkdtemp(prefix="mudpt_rn_")
    try:
        cases = (("CoOp_RN50", "CoOp", *RN_COOP),
                 ("CoOp_RN50x4", "CoOp", RN_COOP[0],
                  ("MODEL.BACKBONE.NAME", "RN50x4", "INPUT.SIZE", "(288, 288)",
                   "DATALOADER.TRAIN_X.BATCH_SIZE", str(ZOO_BATCH))),
                 ("CoCoOp_RN50", "CoCoOp", "configs/trainers/CoCoOp/vit_b32_bz1_ep10_ctxv1.yaml",
                  ("MODEL.BACKBONE.NAME", "RN50", "INPUT.SIZE", "(224, 224)")))
        for label, trainer, yaml, more in cases:
            t0 = time.perf_counter()
            tr = zoo_trainer(root, trainer, yaml, more, f"{tmp}/{label}")
            cfg = tr.clip_cfg
            bsz = tr.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
            say(phase, f"{label}: built {trainer} on {tr.cfg.MODEL.BACKBONE.NAME} (text "
                       f"{cfg.transformer_width} x {cfg.transformer_layers} x "
                       f"{cfg.transformer_heads} heads; stages {cfg.vision_layers_per_stage}, "
                       f"{cfg.image_resolution} px) through mudpt_torch.train in "
                       f"{time.perf_counter() - t0:.2f} s")
            st, batch = zoo_step_case(tr)
            per_step = zoo_step_launches(F.LAUNCHES, cfg, True, False)
            grad_check(F, st, phase, f"{label}: the first step, batch {bsz}", per_step,
                       loss_limit=None, limits=ZOO_GRAD_LIMITS.get(trainer))
            paths[f"rn_{label}_step"] = per_step
            if label != "CoOp_RN50":
                del tr, st, batch
                torch.cuda.empty_cache()
                continue
            F.reset_launches()
            idle = traced(phase, lambda: tr._train_step(batch), device_time_by_kernel)
            check_launches(f"{label} traced step", dict(F.LAUNCHES), per_step)
            for _ in range(WARMUP_STEPS):
                tr._train_step(batch)
            step_ms = statistics.median(_synced_ms(lambda: tr._train_step(batch))
                                        for _ in range(TIMED_STEPS))
            loader = DataLoader(tr.dm.dataset.train_x, tr.dm.test_loader.transform, ZOO_BATCH,
                                num_workers=tr.cfg.DATALOADER.NUM_WORKERS)
            F.reset_launches()
            t0 = time.perf_counter()
            results = tr.evaluate(loader, split="train images, eval transform")
            ips = results["total"] / (time.perf_counter() - t0)
            check_launches(f"{label} evaluate", dict(F.LAUNCHES),
                           zoo_eval_launches(F.LAUNCHES, cfg, len(loader), 1, False))
            say(phase, f"{label}: step at batch {bsz} median {step_ms:.2f} ms (traced: "
                       f"{'not measured' if idle is None else f'{idle:.1%} idle'}); launches "
                       f"{ {k: v for k, v in per_step.items() if v} } a step (the RN tower "
                       f"none: cuDNN); evaluate over {results['total']} images "
                       f"{ips:.1f} images/s with the host loader")
            # the class text is encoded at export: a request runs the RN
            # tower alone, on no kernel of the port
            paths["rn_CoOp_RN50_pallas_artifact_request"] = export_and_serve(
                F, root, tmp, tr, "pallas", phase, dict.fromkeys(F.LAUNCHES, 0))
            del tr, st, batch, loader
            torch.cuda.empty_cache()

        for name, res in RN_ZS:
            t0 = time.perf_counter()
            F.reset_launches()
            tr = zoo_trainer(root, "ZeroshotCLIP", "configs/trainers/vit_b16.yaml",
                             ("MODEL.BACKBONE.NAME", name, "INPUT.SIZE", f"({res}, {res})"),
                             f"{tmp}/zs_{name}")
            build_s = time.perf_counter() - t0
            cfg = tr.clip_cfg
            route = "full" if cfg.transformer_width <= F.FULLBLOCK_MAX_WIDTH else "half"
            check_launches(f"ZeroshotCLIP {name} text encode", dict(F.LAUNCHES),
                           expect(F.LAUNCHES, (cfg.transformer_layers, route),
                                  (1, tower_lns(1))))
            paths[f"rn_zs_{name}_text_encode"] = dict(F.LAUNCHES)
            loader = DataLoader(tr.dm.dataset.train_x[:ZOO_BATCH], tr.dm.test_loader.transform,
                                ZOO_BATCH)
            images = tr._device_batch(next(iter(loader)))["image"]
            if tuple(images.shape) != (ZOO_BATCH, res, res, 3):
                raise AssertionError(f"{name}: images {tuple(images.shape)}")
            tr.evaluate(loader, split="one batch")  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results = tr.evaluate(loader, split="one batch")
            ips = results["total"] / (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            reading = rn_feature_check(tr.frozen["visual"], cfg, images[:RN_FEATURE_IMAGES],
                                       name, RN_FEATURE_NORM_ERR)
            say(phase, f"ZeroshotCLIP {name} ({cfg.image_resolution} px, stages "
                       f"{cfg.vision_layers_per_stage}, width {cfg.vision_width}, "
                       f"{cfg.vision_heads} pool heads; text {cfg.transformer_width} wide on "
                       f"the {route} route): built in {build_s:.2f} s; evaluate of "
                       f"{results['total']} images {ips:.1f} images/s, peak "
                       f"{peak:.2f} GiB; {reading}")
            del tr, loader, images
            torch.cuda.empty_cache()
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [datasets]: MuDPT ViT-B/16 base-to-new on JPEGs: a Caltech101-layout tree
# (the reader's 100 classes, its two ignored folders, 40 images a class of
# 300 x 240 px: smooth images with noise), 16 shots, the MuDPT YAML and
# the Caltech101 dataset YAML through the port's CLI, random weights; cut:
# one epoch for five, training batches of 64 for 4, no test at the end of
# training (the --eval_only run tests); the run preempted after batch 3
DS_CLASSES, DS_PER_CLASS, DS_W, DS_H = 100, 40, 300, 240
DS_TRAINER = "configs/trainers/MuDPT/vit_b16_bz4_ep5_nctx2_depth9.yaml"
DS_DATA = "configs/datasets/caltech101.yaml"
DS_BATCH, DS_PREEMPT_AFTER, DS_COMPARED = 64, 3, 2
DS_OPTS = ("DATASET.NUM_SHOTS", "16", "OPTIM.MAX_EPOCH", "1",
           "DATALOADER.TRAIN_X.BATCH_SIZE", str(DS_BATCH), "TRAIN.PRINT_FREQ", "1",
           "TEST.NO_TEST", "True")
PIPELINES = ("threads", "grain", "tfdata")
# [datasets] (c): the bench fed by each loader, ViT-B/16 train at batch 384
DS_BENCH = ("--mode", "train", "--model", "ViT-B/16", "--batch", str(BATCH), "--steps", "3",
            "--warmup", "1", "--n-jpegs", str(BATCH))
DS_RESULTS = {}


def write_jpeg_tree(root: Path, n_classes: int = DS_CLASSES, per_class: int = DS_PER_CLASS) -> int:
    """The Caltech101 reader's layout under ``root``; returns the JPEG count."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    img_root = root / "caltech101" / "caltech-101" / "101_ObjectCategories"
    folders = [(f"object_{k:03d}", k, per_class) for k in range(n_classes)]
    folders += [("BACKGROUND_Google", n_classes, 3), ("Faces_easy", n_classes + 1, 3)]
    yy, xx = np.mgrid[0:DS_H, 0:DS_W].astype(np.float32)
    ramp = np.stack([yy / DS_H, xx / DS_W, (yy + xx) / (DS_H + DS_W)], -1) * 160
    noise = np.random.RandomState(0).normal(0, 16, (8, DS_H, DS_W, 3)).astype(np.float32)

    def write(job):
        name, k, n = job
        (img_root / name).mkdir(parents=True, exist_ok=True)
        tint = np.array([(37 * k) % 96, (91 * k) % 96, (53 * k) % 96], np.float32)
        for i in range(n):
            img = ramp[:, ::(-1) ** (k + i)] + tint + np.roll(noise[i % 8], 7 * i, axis=0)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                img_root / name / f"image_{i:04d}.jpg", quality=90)
        return n

    with ThreadPoolExecutor(8) as pool:
        return sum(pool.map(write, folders))


def ds_cli(root: Path, tree: Path, out: str, *argv: str):
    """``python -m mudpt_torch.train`` on the JPEG tree, in this process (the
    CLI's tee of stdout into the run's log undone after)."""
    from mudpt_torch import train as train_cli

    args = ["--trainer", "MuDPT", "--trainer_config", str(root / DS_TRAINER),
            "--dataset_config", str(root / DS_DATA), "--dataset_root", str(tree),
            "--output_dir", out, "--backbone_path", "random", *argv]
    streams = sys.stdout, sys.stderr
    try:
        return train_cli.main(train_cli.parse_args(args))
    finally:
        sys.stdout, sys.stderr = streams


def timed_evaluate(fn):
    """``fn()``'s result and the seconds and images of each
    ``TrainerBase.evaluate`` it ran (synchronized)."""
    import torch

    from mudpt_torch.trainers.base import TrainerBase

    runs, evaluate = [], TrainerBase.evaluate

    def timed(self, loader, split="test"):
        t0 = time.perf_counter()
        results = evaluate(self, loader, split)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, results["total"]))
        return results

    TrainerBase.evaluate = timed
    try:
        return fn(), runs
    finally:
        TrainerBase.evaluate = evaluate


def check_batches_equal(what: str, batches, batches_ref) -> str:
    """Host batches bit-equal, key by key."""
    import numpy as np

    n = 0
    for a, b in zip(batches, batches_ref):
        for k in ("image", "label", "valid"):
            if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{what}: batch {n} {k} differs")
        n += 1
    if n == 0:
        raise AssertionError(f"{what}: no batch compared")
    return f"{n} batches bit-equal"


def check_epoch_kept(what: str, loader, epoch: int) -> None:
    """The training loader's epoch where it was (a calibration's fetch must
    not advance it: an exact resume replays epochs by number)."""
    if loader._epoch != epoch:
        raise AssertionError(f"{what}: the training loader's epoch moved {epoch} -> "
                             f"{loader._epoch}")


def ds_step_case(tr, batch: dict = None):
    """``zoo_step_case`` with its fp32 reference forward unquantized (the
    fp32 model, as ``[train*]``'s reference is)."""
    import functools

    import torch

    from mudpt_torch.models import layers

    st, batch = zoo_step_case(tr, batch)
    forward = functools.partial(tr.forward, compute_dtype=torch.float32)

    def forward32(*args):
        with layers.quantized("none"):
            return forward(*args)

    st.forward32 = forward32
    return st, batch


def phase_datasets(F, root: Path) -> dict:
    """MuDPT ViT-B/16 base-to-new on JPEGs through the CLI under each
    pipeline, the static int8 tiers through the CLI, and the bench fed by
    each loader.  Returns each path's launches."""
    import contextlib
    import copy
    import gc
    import io
    import itertools
    import shutil
    import tempfile

    import torch

    from mudpt_torch import bench
    from mudpt_torch.models import layers
    from mudpt_torch.models.clip import leaves
    from mudpt_torch.models.layers import plain_blocks

    phase = "datasets"
    paths, eval_loaders = {}, {}
    tmp = tempfile.mkdtemp(prefix="mudpt_datasets_")
    try:
        tree = Path(tmp) / "data"
        t0 = time.perf_counter()
        n_jpegs = write_jpeg_tree(tree)
        say(phase, f"wrote {n_jpegs} JPEGs of {DS_W} x {DS_H} px in the Caltech101 layout "
                   f"({DS_CLASSES} classes + 2 ignored folders) in "
                   f"{time.perf_counter() - t0:.2f} s")
        base = (*DS_OPTS, "DATASET.SUBSAMPLE_CLASSES", "base")
        new = (*DS_OPTS, "DATASET.SUBSAMPLE_CLASSES", "new")
        # ---- (a) base-to-new through the CLI under each pipeline
        for pipe in PIPELINES:
            out = f"{tmp}/{pipe}"
            more = ("DATALOADER.PIPELINE", pipe)
            t0 = time.perf_counter()
            tr = ds_cli(root, tree, f"{out}/train", "--no_train", *base, *more)
            cfg, loader = tr.clip_cfg, tr.dm.train_loader
            say(phase, f"{pipe}: built MuDPT ViT-B/16 through mudpt_torch.train on "
                       f"{len(tr.dm.dataset.train_x)} base training images of "
                       f"{tr.num_classes} classes in {time.perf_counter() - t0:.2f} s; "
                       f"{len(loader)} batches of {DS_BATCH}")
            marks, step = [], tr._train_step

            def marked(b, step=step, marks=marks):
                marks.append(time.perf_counter())
                return step(b)

            tr._train_step = marked
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            tr._train_step = step
            losses = _train_losses(f"{out}/train")
            if len(losses) != len(loader) or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{pipe}: losses {losses}")
            step_ms = statistics.median(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
            if pipe != "threads":
                # ---- the same run preempted after batch 3, then resumed
                part = ds_cli(root, tree, f"{out}/part", "--no_train", *base, *more)
                pstep = part._train_step

                def preempting(b, part=part, pstep=pstep):
                    res = pstep(b)
                    if part.global_step == DS_PREEMPT_AFTER - 1:
                        part._preempt = True  # as the SIGTERM handler sets it
                    return res

                part._train_step = preempting
                part.train()
                del part
                resumed = ds_cli(root, tree, f"{out}/part", "--no_train", *base, *more,
                                 "RESUME", f"{out}/part")
                resumed.train()
                say(phase, f"{pipe}: preempted after batch {DS_PREEMPT_AFTER} and resumed: "
                           + check_resumed(losses, _train_losses(f"{out}/part"),
                                           leaves(tr.trainable), leaves(resumed.trainable)))
                del resumed
            # ---- a traced step fed by the loader: decode, copy and step
            it = iter(copy.copy(loader))
            F.reset_launches()
            idle = traced(phase, lambda: tr._train_step(tr._device_batch(next(it))),
                          device_time_by_kernel)
            want = step_launches(F, cfg, "full_train", "full_train")
            check_launches(f"{pipe} traced step", dict(F.LAUNCHES), want)
            paths[f"datasets_{pipe}_step"] = dict(F.LAUNCHES)
            del it, tr
            # ---- the new classes, with the checkpoint (--eval_only)
            ev, runs = timed_evaluate(lambda: ds_cli(
                root, tree, f"{out}/eval", "--eval_only", "--model_dir", f"{out}/train",
                "--load_epoch", "1", *new, *more))
            (t_eval, n_eval), = runs
            eval_loaders[pipe] = ev.dm.test_loader
            DS_RESULTS[pipe] = dict(step_ms=step_ms, epoch_s=t_train, traced_idle=idle,
                                    evaluate_images_per_s=n_eval / t_eval)
            say(phase, f"{pipe}: one epoch of {len(losses)} steps in {t_train:.2f} s, step "
                       f"{step_ms:.2f} ms median in the epoch loop (each loss fetched); "
                       f"losses {losses[0]:.5f} .. {losses[-1]:.5f}; evaluate on "
                       f"{ev.num_classes} new classes: {n_eval} images in {t_eval:.2f} s, "
                       f"{n_eval / t_eval:.1f} images/s")
            del ev
            torch.cuda.empty_cache()
        # grain and threads run the same EvalTransform on the new classes
        say(phase, "grain vs threads eval batches: " + check_batches_equal(
            "grain vs threads eval", itertools.islice(eval_loaders["grain"], DS_COMPARED),
            itertools.islice(eval_loaders["threads"], DS_COMPARED)))

        # ---- (b) the static int8 tiers through the CLI
        qout = f"{tmp}/static"
        stc = ds_cli(root, tree, f"{qout}/train", "--no_train", *base,
                     "TRAIN.QUANT", "int8_ste_static")
        cfg = stc.clip_cfg
        check_epoch_kept("int8_ste_static build", stc.dm.train_loader, 0)
        t0 = time.perf_counter()
        stc._calibrate_static_quant()  # the build's work again, timed
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        check_epoch_kept("int8_ste_static calibration", stc.dm.train_loader, 0)
        per_step = step_launches(F, cfg, "q8s_train", "q8s_train")
        st, batch = ds_step_case(stc)
        grad_check(F, st, phase, f"int8_ste_static: the trainer's first step, batch "
                                 f"{DS_BATCH}", per_step, loss_limit=None)
        F.reset_launches()
        traced(phase, lambda: stc._train_step(batch), device_time_by_kernel)
        check_launches("int8_ste_static traced step", dict(F.LAUNCHES), per_step)
        paths["datasets_int8_ste_static_step"] = dict(F.LAUNCHES)
        stc.train()
        losses = _train_losses(f"{qout}/train")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"int8_ste_static: losses {losses}")
        del stc, st, batch
        F.reset_launches()
        ev, runs = timed_evaluate(lambda: ds_cli(
            root, tree, f"{qout}/eval", "--eval_only", "--model_dir", f"{qout}/train",
            "--load_epoch", "1", *new, "TRAIN.QUANT", "int8_static"))
        (t_eval, n_eval), = runs
        n_batches = len(ev.dm.test_loader)
        want = expect(F.LAUNCHES, (cfg.transformer_layers, "q8s"), (1, tower_lns(1)),
                      (n_batches * cfg.vision_layers, "q8s"), (n_batches, tower_lns(2)))
        check_launches("int8_static evaluate", dict(F.LAUNCHES), want)
        paths["datasets_int8_static_evaluate"] = dict(F.LAUNCHES)
        check_epoch_kept("int8_static build and recalibration after load",
                         ev.dm.train_loader, 0)
        images = ev._device_batch(next(iter(ev.dm.test_loader)))["image"]
        with torch.no_grad():
            logits = ev.forward(ev.trainable, ev.frozen, ev.aux, images).float()
            with plain_blocks():
                logits_ref = ev.forward(ev.trainable, ev.frozen, ev.aux, images).float()
        reading = hold_logits(logits[:, :ev.num_classes], logits_ref[:, :ev.num_classes])
        DS_RESULTS["int8_static"] = dict(calibration_s=calib_s,
                                         evaluate_images_per_s=n_eval / t_eval)
        say(phase, f"int8_ste_static: one epoch, losses {losses[0]:.5f} .. {losses[-1]:.5f}; "
                   f"calibration {calib_s:.3f} s; int8_static after --eval_only "
                   f"(recalibrated on the loaded prompts): evaluate {n_eval} images, "
                   f"{n_eval / t_eval:.1f} images/s, launches {n_batches} vision passes and "
                   f"one text encode on the static chain; vs plain route on the card: {reading}")
        del ev, images, logits, logits_ref
        layers.set_quant_mode("none")
        torch.cuda.empty_cache()

        # ---- (c) the bench fed by each loader
        for pipe in PIPELINES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                bench.main([*DS_BENCH, "--input", pipe])
            rec = parse_bench_line(buf.getvalue())
            if not (math.isfinite(rec["value"]) and rec["value"] > 0):
                raise AssertionError(f"bench --input {pipe}: value {rec['value']}")
            DS_RESULTS[f"bench_{pipe}"] = dict(images_per_s=rec["value"],
                                               h2d_mb_per_sec=rec["h2d_mb_per_sec"])
            say(phase, f"bench --input {pipe}: {rec['value']:.1f} images/s (resident "
                       f"{THROUGHPUT['train']:.1f} in [train]), H2D "
                       f"{rec['h2d_mb_per_sec']} MB/s; {json.dumps(rec)}")
        say(phase, "summary: " + json.dumps(DS_RESULTS))
        return paths
    finally:
        layers.set_quant_mode("none")  # the static trainers' builds set it
        gc.collect()  # the phase's trainers (cycles) and their device memory
        shutil.rmtree(tmp, ignore_errors=True)


# [mesh]: the mesh on torch.distributed.  NCCL takes one rank a card, so
# on the one card NCCL runs at world size 1 (MuDPT ViT-B/16 through the CLI
# at [engine]'s configuration under torchrun, bit-equal to the same run
# without a process group), and two gloo ranks share cuda:0 for the
# multi-rank cases, each held against one process on the same global batch
# (DATALOADER.HOST_SHARD off: every rank decodes it and takes its rows)
MESH_STEPS = 3
MESH_DEVICE = "cuda:0"
MESH_OPTS = ("MODEL.BACKBONE.PATH", "random", "DATASET.SYNTHETIC_NUM_CLASSES", "16",
             "DATASET.SYNTHETIC_PER_CLASS", "24", "DATALOADER.TRAIN_X.BATCH_SIZE", "64",
             "DATALOADER.TEST.BATCH_SIZE", "64", "DATALOADER.HOST_SHARD", "off",
             "OPTIM.MAX_EPOCH", "1", "TRAIN.PRINT_FREQ", "1000")
# (label, trainer, its YAML, the mesh, the case's other options)
MESH_CASES = (
    ("MuDPT (2,1)", "MuDPT", ENGINE_FILES[1], ("PARALLEL.DATA", "2"), ()),
    ("MuDPT (1,2)", "MuDPT", ENGINE_FILES[1], ("PARALLEL.MODEL", "2"), ()),
    ("CoCoOp (1,2)", "CoCoOp", "configs/trainers/CoCoOp/vit_b32_bz1_ep10_ctxv1.yaml",
     ("PARALLEL.MODEL", "2"), ("MODEL.BACKBONE.NAME", "ViT-B/16")),
)
# the limits (PERF.md: the first ones held the gradients to fp32 sums and
# failed on the card; these follow the readings that showed why).
# A rank's rows give one process's per-row results (measured bit-equal at
# another M), so the first step's loss differs in the order of fp32 sums
# alone (MESH_LOSS_REL, relative); later steps start from prompts apart by
# a bf16 share of the update (MESH_LATER_LOSS_REL).  The prompts'
# gradients are bf16 sums: the splice's backward sums rows in bf16 and the
# text tower's backward runs per half of the images, so a split rounds
# partial sums; the first step's gradients are held to one process's by
# the bound the port holds such bf16 roundings to (GRAD_NORM_ERR, relative
# norm, worst leaf), and where the data axis splits the batch to one
# process's two halves summed in fp32, the same bf16 sums
# (MESH_HALVES_REL).  The prompts after the last step within
# MESH_PROMPT_REL of the update one process made (three steps of the
# gradient limit); the test accuracy within MESH_ACC_POINTS, the
# confusion total the test set's size
MESH_LOSS_REL = 2.0 ** -12
MESH_LATER_LOSS_REL = 2.0 ** -8
MESH_GRAD_REL = GRAD_NORM_ERR
MESH_HALVES_REL = 2.0 ** -10
MESH_PROMPT_REL = 2.0 ** -2
MESH_ACC_POINTS = 0.5


def mesh_digest(tr) -> str:
    """The trainable leaves' bytes, hashed: equal across ranks iff the
    replicas are bit-equal."""
    import hashlib

    from mudpt_torch.models.clip import leaves

    h = hashlib.sha256()
    for t in leaves(tr.trainable):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_trainer(root: Path, trainer: str, yaml: str, more: tuple, out: str):
    """The trainer as ``python -m mudpt_torch.train ... --no_train`` builds
    it on MESH_DEVICE, in this process (the CLI's tee of stdout undone)."""
    from mudpt_torch import train as train_cli

    argv = ["--trainer", trainer, "--trainer_config", str(root / yaml), "--dataset_config",
            str(root / ENGINE_FILES[0]), "--output_dir", out, "--device", MESH_DEVICE,
            "--no_train", *MESH_OPTS, *more]
    streams = sys.stdout, sys.stderr
    try:
        return train_cli.main(train_cli.parse_args(argv))
    finally:
        sys.stdout, sys.stderr = streams


def batch_halves(tr, b: dict) -> dict:
    """What splitting the batch does in one process: the first half's
    logits alone against inside the whole batch (per-row results at
    another M, relative norm), and the sum of the two halves' gradients,
    each half's loss over the global count of valid rows, in fp32."""
    import torch

    n = b["image"].shape[0]
    half = n // 2
    with torch.no_grad():
        whole = tr.forward(tr.trainable, tr.frozen, tr.aux, b["image"])[:half].float()
        alone = tr.forward(tr.trainable, tr.frozen, tr.aux, b["image"][:half]).float()
    grads = None
    for rows in (slice(0, half), slice(half, n)):
        part = {k: v[rows] for k, v in b.items()}
        # loss_fn divides by the part's valid rows: scale back to the batch's
        loss = tr.loss_fn(part)[0] * (part["valid"].sum() / b["valid"].sum())
        g = torch.autograd.grad(loss, tr._params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x.float() for x, p in zip(g, tr._params)]
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
    out = {f"halfgrad/{k}": g.cpu().numpy().copy()
           for k, g in zip(leaf_names(tr.trainable), grads)}
    out["rows_rel"] = ((alone - whole).norm() / whole.norm()).item()
    return out


def mesh_record(root: Path, trainer: str, yaml: str, more: tuple, out: str,
                halves: bool = False) -> dict:
    """One case as a rank (or one process) runs it: the trainer through the
    CLI on cuda:0, MESH_STEPS steps fed by its loader (each rank its rows
    of the global batch), the global losses, the first step's gradients
    (summed over the mesh), a step's launches, the prompts before and
    after, their digest after each step, the test confusion matrix, and a
    checkpoint saved by the primary and loaded on every rank.  ``halves``:
    before the first step, ``batch_halves`` of its batch."""
    import numpy as np
    import torch

    from mudpt_torch.models.clip import leaves
    from mudpt_torch.ops import fused_block as F
    from mudpt_torch.trainers import base

    tr = mesh_trainer(root, trainer, yaml, more, out)
    names = leaf_names(tr.trainable)
    rec = {f"prompt0/{k}": t.detach().float().cpu().numpy().copy()
           for k, t in zip(names, leaves(tr.trainable))}
    rec.update(losses=[], digests=[], n_test=len(tr.dm.dataset.test))
    for i, batch in enumerate(tr._device_prefetch(tr.dm.train_loader)):
        if i == MESH_STEPS:
            break
        if i == 0 and halves:
            rec.update(batch_halves(tr, batch))
        if i == 1:
            F.reset_launches()
        loss, _ = tr._train_step(batch)
        torch.cuda.synchronize()
        if i == 0:
            rec.update({f"grad/{k}": p.grad.float().cpu().numpy().copy()
                        for k, p in zip(names, tr._params)})
        if i == 1:
            rec["launches"] = json.dumps(F.LAUNCHES)
        rec["losses"].append(float(loss))
        rec["digests"].append(mesh_digest(tr))
    rec.update({f"prompt/{k}": t.detach().float().cpu().numpy().copy()
                for k, t in zip(names, leaves(tr.trainable))})
    kept, build = [], base.build_evaluator
    base.build_evaluator = lambda *a, **k: kept.append(build(*a, **k)) or kept[-1]
    try:
        tr.evaluate(tr.dm.test_loader)
    finally:
        base.build_evaluator = build
    rec["conf"] = kept[0]._conf
    tr.save_model()
    with torch.no_grad():
        for t in leaves(tr.trainable):
            t.zero_()
    tr.load_model(out, epoch=1)
    rec["ckpt_sum"] = float(sum(t.detach().double().sum().item() for t in leaves(tr.trainable)))
    rec["ckpt_digest"] = mesh_digest(tr)
    del tr
    torch.cuda.empty_cache()
    return {k: np.asarray(v) for k, v in rec.items()}


def gloo_cuda_probe(rank: int, world: int) -> str:
    """What the mesh sends through gloo, on CUDA tensors, each result held
    exactly: all_reduce of fp32 (gradients, counts) and int64 (confusion
    matrices), broadcast of bytes, all_gather of bytes (bf16 features) and
    fp32."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    ok = True
    for dtype in (torch.float32, torch.int64):
        x = torch.arange(4, dtype=dtype, device=dev) + rank
        dist.all_reduce(x)
        ok &= torch.equal(x, torch.arange(4, dtype=dtype, device=dev) * world
                          + sum(range(world)))
    b = torch.full((3,), rank, dtype=torch.uint8, device=dev)
    dist.broadcast(b, src=0)
    ok &= torch.equal(b, torch.zeros_like(b))
    for dtype in (torch.uint8, torch.float32):
        parts = [torch.empty(2, dtype=dtype, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), rank, dtype=dtype, device=dev))
        ok &= all(torch.equal(p, torch.full((2,), r, dtype=dtype, device=dev))
                  for r, p in enumerate(parts))
    if not ok:
        raise AssertionError("gloo on CUDA tensors: a collective's result is not exact")
    return ("all_reduce (fp32, int64), broadcast (uint8), all_gather (uint8, fp32) of CUDA "
            "tensors exact")


def mesh_rank(root: Path, rank: str, world: str, port: str, job: str) -> int:
    """``python3 chip_smoke.py --mesh-rank RANK WORLD PORT JOB``: one gloo
    rank on cuda:0, running the job's cases (kernels built by the parent)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(root))
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from mudpt_torch.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed("gloo")  # the ranks share one card: NCCL refuses that
    spec = json.loads(Path(job).read_text())
    try:
        print(f"rank {rank}: {gloo_cuda_probe(int(rank), int(world))}", flush=True)
        for i, (_, trainer, yaml, mesh, more) in enumerate(MESH_CASES):
            rec = mesh_record(root, trainer, yaml, mesh + more, f"{spec['out']}/case{i}")
            np.savez(f"{spec['out']}/case{i}-rank{rank}.npz", **rec)
    finally:
        dist.destroy_process_group()
    return 0


def _rel_norm(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_mesh_run(what: str, ranks: list, ref: dict) -> str:
    """Hold each rank's record to one process's (the MESH_* limits; its
    gradients to the two halves too, where ``ref`` has them: the data axis
    splits the batch) and the ranks to each other (the replicas bit-equal
    after every step, one confusion matrix, one checkpoint).  Returns the
    readings as text."""
    import numpy as np

    n_test = int(ref["n_test"])
    acc_ref = 100.0 * np.trace(ref["conf"]) / n_test
    split = "rows_rel" in ref
    worst = dict(loss=0.0, later=0.0, grad=0.0, halves=0.0, prompt=0.0, acc=0.0)
    for r, rec in enumerate(ranks):
        losses = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"])]
        reading = dict(
            loss=losses[0], later=max(losses[1:], default=0.0),
            grad=max(_rel_norm(rec[k], ref[k]) for k in ref if k.startswith("grad/")),
            halves=max((_rel_norm(rec[k], ref["half" + k]) for k in ref
                        if k.startswith("grad/")), default=0.0) if split else 0.0,
            prompt=max(np.linalg.norm(rec[k] - ref[k])
                       / max(np.linalg.norm(ref[k] - ref["prompt0/" + k[7:]]), 1e-30)
                       for k in ref if k.startswith("prompt/")))
        total = int(rec["conf"].sum())
        reading["acc"] = abs(100.0 * np.trace(rec["conf"]) / max(total, 1) - acc_ref)
        limits = dict(loss=MESH_LOSS_REL, later=MESH_LATER_LOSS_REL, grad=MESH_GRAD_REL,
                      halves=MESH_HALVES_REL, prompt=MESH_PROMPT_REL, acc=MESH_ACC_POINTS)
        names = dict(loss="first loss", later="later losses", grad="gradients",
                     halves="gradients vs the halves", prompt="prompts",
                     acc="accuracy points")
        over = [f"{names[k]} {v:.3e} over {limits[k]:.3e}" for k, v in reading.items()
                if not v <= limits[k]]
        if len(rec["losses"]) != len(ref["losses"]):
            over.append(f"{len(rec['losses'])} steps, not {len(ref['losses'])}")
        if not total == n_test == int(ref["conf"].sum()):
            over.append(f"{total} test images scored, not {n_test}")
        if over:
            leaf = max((k for k in ref if k.startswith("grad/")),
                       key=lambda k: _rel_norm(rec[k], ref[k]))
            raise AssertionError(
                f"{what}, rank {r} vs one process: " + "; ".join(over)
                + f" (losses {list(map(float, rec['losses']))} vs "
                f"{list(map(float, ref['losses']))}; worst gradient {leaf})")
        if (list(rec["digests"]) != list(ranks[0]["digests"])
                or not np.array_equal(rec["conf"], ranks[0]["conf"])
                or str(rec["ckpt_digest"]) != str(ranks[0]["ckpt_digest"])):
            raise AssertionError(f"{what}: rank {r}'s replica, confusion matrix or loaded "
                                 "checkpoint differs from rank 0's")
        worst = {k: max(worst[k], v) for k, v in reading.items()}
    halves = (f", vs one process's halves {worst['halves']:.3e} ({MESH_HALVES_REL:.3e}; "
              f"the halves vs the whole "
              f"{max(_rel_norm(ref['half' + k], ref[k]) for k in ref if k.startswith('grad/')):.3e}"
              f", the first half's logits alone {float(ref['rows_rel']):.3e})") if split else ""
    return (f"first loss within {worst['loss']:.3e} (limit {MESH_LOSS_REL:.3e}), later "
            f"{worst['later']:.3e} ({MESH_LATER_LOSS_REL:.3e}); first-step gradients "
            f"{worst['grad']:.3e} ({MESH_GRAD_REL:.3e}){halves}; prompts {worst['prompt']:.3e} "
            f"of the update ({MESH_PROMPT_REL:.3e}); test accuracy {acc_ref:.2f} within "
            f"{worst['acc']:.2f} points over {n_test} images counted once; replicas bit-equal "
            f"after every step; checkpoint checksum {float(ranks[0]['ckpt_sum']):.6f} on "
            f"every rank")


def check_bit_equal_runs(what: str, a: dict, b: dict) -> str:
    """Two CLI runs' losses, final prompts (the last checkpoint) and test
    accuracy, bit-equal."""
    import numpy as np

    if a["losses"] != b["losses"] or a["accuracy"] != b["accuracy"]:
        raise AssertionError(f"{what}: losses {a['losses']} vs {b['losses']}, accuracy "
                             f"{a['accuracy']} vs {b['accuracy']}")
    if a["prompts"].keys() != b["prompts"].keys() or not all(
            np.array_equal(a["prompts"][k], b["prompts"][k]) for k in a["prompts"]):
        raise AssertionError(f"{what}: final prompts not bit-equal")
    return (f"{len(a['losses'])} losses, {len(a['prompts'])} prompt leaves and test accuracy "
            f"{a['accuracy']:.2f} bit-equal")


def cli_run(out: str) -> dict:
    """A finished CLI run's train losses, final checkpoint and test accuracy."""
    import numpy as np

    with open(Path(out) / "metrics.jsonl") as f:
        rows = [json.loads(x) for x in f]
    ckpts = sorted((p for p in Path(out).glob("*/model.pth.tar-*") if p.suffix != ".json"),
                   key=lambda p: int(p.name.split("-")[-1]))
    with np.load(ckpts[-1]) as z:
        prompts = {k: z[k] for k in z.files if k.startswith("trainable/")}
    return {"losses": [r["loss"] for r in rows if r["kind"] == "train"],
            "accuracy": [r["accuracy"] for r in rows if r["kind"] == "eval"][-1],
            "prompts": prompts}


def _spawn(cmd: list, root: Path, log: Path):
    env = dict(os.environ, PYTHONPATH=str(root))
    fh = open(log, "w")
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=fh, stderr=subprocess.STDOUT), fh


def _finish(procs: list, timeout: float) -> None:
    """Wait for every process; kill what outlives ``timeout``; raise with
    the log's end of any that failed."""
    deadline = time.perf_counter() + timeout
    failed = []
    for proc, fh, log in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        fh.close()
        if proc.returncode != 0:
            failed.append(f"--- {' '.join(map(str, proc.args[:6]))} ... exit {proc.returncode}\n"
                          + Path(log).read_text()[-3000:])
    if failed:
        raise AssertionError("mesh processes failed:\n" + "\n".join(failed))


MESH_TIMEOUT = 400


def phase_mesh(F, root: Path) -> dict:
    """NCCL at world size 1 against no process group, bit-equal; then two
    gloo ranks sharing cuda:0 on MESH_CASES, each held against one process
    on the same global batches, whose references this process computes
    while the ranks run.  Returns rank 0's launches of a step by case."""
    import shutil
    import socket
    import tempfile

    import numpy as np

    phase = "mesh"
    tmp = Path(tempfile.mkdtemp(prefix="mudpt_mesh_"))

    def argv(out: str) -> list:
        return ["--trainer", "MuDPT", "--trainer_config", str(root / ENGINE_FILES[1]),
                "--dataset_config", str(root / ENGINE_FILES[0]), "--output_dir", out,
                *ENGINE_OPTS]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp / "job.json").write_text(json.dumps({"out": str(tmp)}))
    procs = []
    try:
        t0 = time.perf_counter()
        for name, cmd in (
                ("plain", [sys.executable, "-m", "mudpt_torch.train", *argv(str(tmp / "plain"))]),
                ("nccl", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", "-m", "mudpt_torch.train",
                          *argv(str(tmp / "nccl"))]),
                *((f"rank{r}", [sys.executable, str(root / "chip_smoke.py"), "--mesh-rank",
                                str(r), "2", str(port), str(tmp / "job.json")])
                  for r in range(2))):
            proc, fh = _spawn(cmd, root, tmp / f"{name}.log")
            procs.append((proc, fh, tmp / f"{name}.log"))
        refs = [mesh_record(root, trainer, yaml, more, str(tmp / f"ref{i}"),
                            halves="PARALLEL.DATA" in mesh)
                for i, (_, trainer, yaml, mesh, more) in enumerate(MESH_CASES)]
        t_refs = time.perf_counter() - t0
        _finish(procs, MESH_TIMEOUT)
        say(phase, f"4 processes (2 CLI runs, 2 gloo ranks) and the one-process references "
                   f"({t_refs:.1f} s) in {time.perf_counter() - t0:.1f} s")
        nccl_log = (tmp / "nccl.log").read_text()
        if "process group: backend nccl, rank 0 of 1" not in nccl_log:
            raise AssertionError("the torchrun run joined no NCCL process group:\n"
                                 + nccl_log[-2000:])
        say(phase, "NCCL at world size 1 (torchrun --nproc_per_node 1, MuDPT ViT-B/16 at "
                   "[engine]'s configuration) vs no process group: "
                   + check_bit_equal_runs("NCCL world 1", cli_run(str(tmp / "nccl")),
                                          cli_run(str(tmp / "plain"))))
        for r in range(2):
            probe = [ln for ln in (tmp / f"rank{r}.log").read_text().splitlines()
                     if ln.startswith(f"rank {r}: ")]
            say(phase, f"gloo on cuda:0, {probe[0] if probe else 'no probe line'}")
        paths, failed = {}, []
        for i, (label, *_) in enumerate(MESH_CASES):
            ranks = [dict(np.load(tmp / f"case{i}-rank{r}.npz")) for r in range(2)]
            try:
                reading = check_mesh_run(label, ranks, refs[i])
            except AssertionError as e:
                failed.append(str(e))
                reading = f"FAILED: {e}"
            say(phase, f"{label} ViT-B/16 on 2 gloo ranks, global batch 64, "
                       f"{MESH_STEPS} steps, vs one process: {reading}")
            launches = json.loads(str(ranks[0]["launches"]))
            paths[f"mesh_rank_step {label}"] = launches
            say(phase, f"{label}: a rank's launches a step: "
                       f"{ {k: v for k, v in launches.items() if v} }")
        if failed:
            raise AssertionError("[mesh] cases failed:\n" + "\n".join(failed))
        return paths
    finally:
        for proc, fh, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
        shutil.rmtree(tmp, ignore_errors=True)


# [export]: MuDPT ViT-B/16 through build_trainer (its YAML, the synthetic
# dataset at 100 classes: one training image a class, four test images),
# one training step at batch 64, then an artifact of each tier served in a
# fresh process on 384 test images and timed by the bench tool
EXPORT_OPTS = ("TRAINER.NAME", "MuDPT", "MODEL.BACKBONE.PATH", "random",
               "DATASET.SYNTHETIC_NUM_CLASSES", str(N_CLS), "DATASET.SYNTHETIC_PER_CLASS", "1",
               "DATALOADER.TRAIN_X.BATCH_SIZE", "64", "DATALOADER.TEST.BATCH_SIZE", "64",
               "OPTIM.MAX_EPOCH", "1")
EXPORT_TIERS = ("xla", "pallas", "pallas_int8", "pallas_int8_static")
EXPORT_ROUTES = {"xla": None, "pallas": "full", "pallas_int8": "q8",
                 "pallas_int8_static": "q8s"}
CALIB_IMAGES = 64
# the pallas artifact's images/s within this share of [serving]'s, as
# [bench] is held
ARTIFACT_AGREE = 0.10


def check_artifact_rate(value: float, reference: float) -> str:
    """The pallas artifact's images/s within ``ARTIFACT_AGREE`` of
    [serving]'s (the same kernels on the same request)."""
    rel = value / reference - 1
    if not abs(rel) <= ARTIFACT_AGREE:
        raise AssertionError(f"pallas artifact: {value:.1f} images/s is {rel:+.1%} off "
                             f"[serving]'s {reference:.1f} (limit {ARTIFACT_AGREE:.0%})")
    return f"{value:.1f} images/s, {rel:+.2%} from [serving]'s {reference:.1f}"


def serve_artifact(root: Path, art: str, images_npy: str, out_npy: str, go: str) -> int:
    """``python3 chip_smoke.py --serve-artifact ART IMAGES OUT GO``: load
    the artifact in this fresh process, write GO.ready and wait for the file
    GO (the parent's word that no timed window of its own is on the card);
    serve the batch once with the launches counted, write the logits
    to OUT, time the request, and print one JSON line (launches, load
    seconds, the model modules this process imported, request ms and
    images/s)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from mudpt_torch import serving
    from mudpt_torch.ops import fused_block as F

    t0 = time.perf_counter()
    clf = serving.load(art)
    images = torch.from_numpy(np.load(images_npy)).cuda()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    Path(go + ".ready").touch()
    while not os.path.exists(go):
        time.sleep(0.02)
    F.reset_launches()
    logits = clf.forward(images)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    np.save(out_npy, logits.float().cpu().numpy())
    model_modules = sorted(m for m in sys.modules
                           if m.startswith(("mudpt_torch.models", "mudpt_torch.trainers")))
    # then the same request timed, as bench_artifact times it
    for _ in range(WARMUP_STEPS):
        clf.forward(images)
    ms = time_ms(lambda: clf.forward(images), REQUESTS)
    print(json.dumps({"launches": launches, "load_s": load_s, "model_modules": model_modules,
                      "request_ms": ms, "images_per_s": images.shape[0] / ms * 1e3,
                      "card": smi()}), flush=True)
    return 0


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.strip()][-1])


class FreshServer:
    """``--serve-artifact`` in a fresh process, started at once: the child
    imports the package and loads the artifact while this process goes on,
    then waits for :meth:`finish`'s word before its counted and timed
    request, so no two timed windows share the card."""

    def __init__(self, root: Path, art: str, images_npy: str, what: str):
        self.what, self.out_npy, self.go = what, f"{art}.logits.npy", f"{art}.go"
        self.t0 = time.perf_counter()
        # the child's streams into files: a pipe nobody reads while it waits
        # could fill and stop it
        self.streams = open(f"{art}.stdout", "w+"), open(f"{art}.stderr", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), "--serve-artifact", art, images_npy,
             self.out_npy, self.go],
            cwd=root, stdout=self.streams[0], stderr=self.streams[1], text=True)

    def wait_loaded(self, timeout: float = 600) -> float:
        """Seconds from the start until the child had loaded its artifact."""
        while not os.path.exists(self.go + ".ready"):
            if self.proc.poll() is not None or time.perf_counter() - self.t0 > timeout:
                err = self.close()[1]
                raise AssertionError(f"serving the {self.what} artifact failed before its "
                                     f"request:\n{err[-4000:]}")
            time.sleep(0.02)
        return time.perf_counter() - self.t0

    def finish(self) -> tuple:
        """(logits on the card, the child's JSON line, seconds from the word
        to its exit): the child's request, after it has loaded; the child
        must import no model module."""
        import numpy as np
        import torch

        self.wait_loaded()
        t0 = time.perf_counter()
        Path(self.go).touch()
        try:
            self.proc.wait(timeout=600)
        finally:
            out, err = self.close()
        if self.proc.returncode != 0:
            raise AssertionError(f"serving the {self.what} artifact failed:\n{err[-4000:]}")
        child = _json_line(out)
        if child["model_modules"]:
            raise AssertionError(f"the loader imported model code: {child['model_modules']}")
        return torch.from_numpy(np.load(self.out_npy)).cuda(), child, time.perf_counter() - t0

    def close(self) -> tuple:
        """Stop the child if it still runs; its (stdout, stderr)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        out = []
        for f in self.streams:
            if not f.closed:
                f.seek(0)
                out.append(f.read())
                f.close()
        return tuple(out) if out else ("", "")


def served_fresh(root: Path, art: str, images_npy: str, what: str) -> tuple:
    """(logits on the card, the child's JSON line, seconds): the artifact
    served by ``--serve-artifact`` in a fresh process, which must import no
    model module."""
    t0 = time.perf_counter()
    logits, child, _ = FreshServer(root, art, images_npy, what).finish()
    return logits, child, time.perf_counter() - t0


def bench_artifact(art: str, batch: int, what: str) -> dict:
    """``python -m mudpt_torch.tools.bench_artifact``'s JSON line at
    ``batch``, through its ``main(argv)`` in this process: its values finite
    and the card named."""
    import contextlib
    import io

    from mudpt_torch.tools import bench_artifact as tool

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = tool.main(["--artifact", art, "--batch", str(batch), "--steps", str(REQUESTS),
                         "--warmup", str(WARMUP_STEPS)])
    if _json_line(out.getvalue()) != rec or not rec["finite"] or rec["card"] is None:
        raise AssertionError(f"bench_artifact {what}: {rec}")
    return rec


def phase_export(F, root: Path) -> dict:
    """MuDPT ViT-B/16 trained one step, exported under the four tiers; each
    artifact served in a fresh process (started as soon as it is written,
    serving on this process's word), its logits held to the tier in this
    process (and the xla tier to the kernel route), its launches counted and
    its images/s read by ``mudpt_torch.tools.bench_artifact``'s ``main``;
    then a zero-shot classifier exported on the CPU in fp32 and served on
    the card (the program moved there) against ``api.zero_shot_classifier``."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mudpt_torch import api, serving
    from mudpt_torch.config import load_config
    from mudpt_torch.models import layers
    from mudpt_torch.models.clip import _map
    from mudpt_torch.trainers.base import build_trainer

    phase = "export"
    tmp = tempfile.mkdtemp(prefix="mudpt_export_")
    paths, servers = {}, {}
    try:
        t0 = time.perf_counter()
        cfg = load_config(*(str(root / f) for f in ENGINE_FILES),
                          opts=[*EXPORT_OPTS, "OUTPUT_DIR", f"{tmp}/out"])
        tr = build_trainer(cfg)
        b = tr._device_batch(next(iter(tr.dm.train_loader)))
        calib = b["image"].float().cpu().numpy()[:CALIB_IMAGES]
        loss = tr._train_step(b)[0]
        torch.cuda.synchronize()
        test = [np.asarray(x["image"], np.float32) for x in tr.dm.test_loader]
        images_np = np.concatenate(test)[:BATCH]
        if images_np.shape[0] != BATCH:
            raise AssertionError(f"{images_np.shape[0]} test images, not {BATCH}")
        np.save(f"{tmp}/images.npy", images_np)
        images = torch.from_numpy(images_np).cuda()
        say(phase, f"built MuDPT ViT-B/16 through build_trainer ({tr.num_classes} classes) "
                   f"and took one step at batch {b['image'].shape[0]} (loss "
                   f"{float(loss):.5f}) in {time.perf_counter() - t0:.2f} s; serving "
                   f"{BATCH} test images, calibrating on {len(calib)} training images")
        vision = tr.clip_cfg.vision_layers
        refs, rates, exported = {}, {}, {}
        # each tier's serving child starts as soon as its artifact is
        # written: its import and load overlap the next tiers' exports and
        # checks here.  The children are all loaded before the first request
        for tier in EXPORT_TIERS:
            art = f"{tmp}/{tier}"
            kw = dict(calib_images=calib) if tier == "pallas_int8_static" else {}
            t0 = time.perf_counter()
            serving.export_trainer(art, tr, batch=None if tier == "xla" else BATCH,
                                   block_impl=tier, **kw)
            export_s = time.perf_counter() - t0
            if layers.block_impl() != "auto" or layers.quant_mode() != "none":
                raise AssertionError(f"export {tier} left {layers.block_impl()!r}, "
                                     f"{layers.quant_mode()!r} set")
            size = sum(f.stat().st_size for f in Path(art).iterdir()) / 1e6
            servers[tier] = FreshServer(root, art, f"{tmp}/images.npy", tier)
            # the same program in this process, on the same images
            t0 = time.perf_counter()
            score, ops, _ = serving.trainer_program(tr, block_impl=tier, **kw)
            with torch.no_grad(), serving._block_impl(tier):
                refs[tier] = score(ops, images)
            torch.cuda.synchronize()
            del score, ops
            exported[tier] = (export_s, size, time.perf_counter() - t0)
        t0 = time.perf_counter()
        loaded = {tier: server.wait_loaded() for tier, server in servers.items()}
        say(phase, f"exports and in-process references done; the children loaded "
                   f"{time.perf_counter() - t0:.2f} s later (each loaded "
                   f"{json.dumps({k: round(v, 2) for k, v in loaded.items()})} s after its "
                   "start)")
        for tier in EXPORT_TIERS:
            art = f"{tmp}/{tier}"
            logits, child, request_s = servers.pop(tier).finish()
            route = EXPORT_ROUTES[tier]
            want = (dict.fromkeys(F.LAUNCHES, 0) if route is None else
                    expect(F.LAUNCHES, (vision, route), (1, tower_lns(2))))
            check_launches(f"the {tier} artifact's request", child["launches"], want)
            paths[f"export_{tier}_request"] = child["launches"]
            if logits.shape != (BATCH, tr.num_classes) or not torch.isfinite(logits).all():
                raise AssertionError(f"{tier} artifact logits malformed: {tuple(logits.shape)}")
            same = torch.equal(logits, refs[tier])
            reading = hold_logits(logits, refs[tier])
            export_s, size, ref_s = exported[tier]
            say(phase, f"{tier}: exported in {export_s:.2f} s ({size:.1f} MB), its reference "
                       f"in this process {ref_s:.2f} s; fresh process "
                       f"loaded {loaded[tier]:.2f} s after its start (load {child['load_s']:.2f} "
                       f"s), served {request_s:.2f} s after the word; launches "
                       f"{ {k: v for k, v in child['launches'].items() if v} }; vs the tier in "
                       f"this process: bit-equal {same}; {reading}")
            if tier == "xla":
                xla_logits = logits
            t0 = time.perf_counter()
            rec = bench_artifact(art, BATCH, tier)
            rates[tier] = rec["value"]
            say(phase, f"{tier}: bench_artifact in this process, {time.perf_counter() - t0:.2f} "
                       f"s: {json.dumps(rec)}")
        say(phase, "xla artifact vs the kernel route in this process: "
                   + hold_logits(xla_logits, refs["pallas"]))
        say(phase, "pallas artifact vs [serving]: "
                   + check_artifact_rate(rates["pallas"], THROUGHPUT["serving"]))
        say(phase, "images/s by tier: " + json.dumps(rates))
        classnames, clip_cfg = list(tr.classnames), tr.clip_cfg
        params32 = to_float(tr.frozen)
        del tr, refs, b
        gc.collect()

        # ---- zero-shot, fp32 on the XLA route: exported on the CPU, served
        # on the card, against api.zero_shot_classifier on the card
        cpu = _map(params32, lambda t: t.cpu())
        templates = ["a photo of a {}.", "a drawing of a {}."]
        t0 = time.perf_counter()
        serving.export_zero_shot(f"{tmp}/zs", clip_cfg, cpu, classnames, templates,
                                 compute_dtype=torch.float32)
        export_s = time.perf_counter() - t0
        clf = serving.load(f"{tmp}/zs")
        F.reset_launches()
        got = clf.forward(images)
        torch.cuda.synchronize()
        if any(F.LAUNCHES.values()):
            raise AssertionError(f"the xla zero-shot artifact launched kernels: {F.LAUNCHES}")
        with serving._block_impl("xla"):
            want = api.zero_shot_classifier(clip_cfg, params32, classnames, templates,
                                            compute_dtype=torch.float32)(images)
        reading = check_close("zero-shot logits, fp32", got, want, max_limit=F32_MAX_ERR,
                              norm_limit=F32_NORM_ERR, share_limit=None)
        say(phase, f"zero-shot, fp32, xla: exported on the CPU in {export_s:.2f} s, served on "
                   f"the card (moved there at load), vs api.zero_shot_classifier on the card: "
                   f"{reading}; no kernel launched")
        return paths
    finally:
        for server in servers.values():
            server.close()
        shutil.rmtree(tmp, ignore_errors=True)


# [remat]: the train step at batch 384 with REMAT 'none' and 'full': loss
# and every leaf's gradient bit-equal, peak memory lower under 'full'
REMAT_TIMED = 5


def check_remat(label: str, none: tuple, full: tuple, peaks: tuple) -> str:
    """REMAT 'full' against 'none' from one starting state: the loss and
    every gradient bit-equal (the recompute runs the same kernels on the
    same inputs), and the peak device memory lower."""
    import torch

    (loss0, grads0), (loss1, grads1) = none, full
    if not torch.equal(loss0, loss1):
        raise AssertionError(f"{label}: REMAT full loss {loss1.item()} != none {loss0.item()}")
    differ = [i for i, (a, b) in enumerate(zip(grads0, grads1)) if not torch.equal(a, b)]
    if differ or len(grads0) != len(grads1):
        raise AssertionError(f"{label}: REMAT full gradients of leaves {differ} not bit-equal")
    if not peaks[1] < peaks[0]:
        raise AssertionError(f"{label}: peak under REMAT full {peaks[1] / 2 ** 30:.2f} GiB "
                             f"did not fall below none's {peaks[0] / 2 ** 30:.2f} GiB")
    return (f"loss and {len(grads0)} leaves' gradients bit-equal; peak "
            f"{peaks[0] / 2 ** 30:.2f} -> {peaks[1] / 2 ** 30:.2f} GiB")


def phase_remat(F, model: str) -> dict:
    """The synthetic train step of ``model`` at batch 384 under REMAT 'none'
    and 'full': one step's loss and gradients from the same state, its peak
    memory and launches (the recompute: one more forward of every layer),
    then timed steps of each mode."""
    import torch

    from mudpt_torch.models import transformer
    from mudpt_torch.utils.synth_step import build_synth_mudpt_step, leaves

    phase = " ".join(["remat"] + ([model] if model != "ViT-B/16" else []))
    st = build_synth_mudpt_step(model, BATCH, N_CLS, N_CTX, DEPTH, seed=0)
    cfg, tr = st.clip_cfg, leaves(st.trainable)
    if cfg.vision_width <= F.FULLBLOCK_MAX_WIDTH:
        vision_route, vision_fwd = "full_train", "full"
    elif F.wide_mlp_save(BATCH * cfg.vision_seq_len + BATCH * N_CTX):
        vision_route, vision_fwd = "half_train", "half"
    else:
        vision_route, vision_fwd = "half_train_recompute_h", "half"
    per_step = step_launches(F, cfg, "full_train", vision_route)
    readings, peaks, paths = {}, {}, {}
    try:
        for mode in ("none", "full"):
            transformer.set_remat_mode(mode)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            F.reset_launches()
            loss = st.loss_fn(st.images, st.labels)
            grads = torch.autograd.grad(loss, tr)
            torch.cuda.synchronize()
            peaks[mode] = torch.cuda.max_memory_allocated()
            want = per_step if mode == "none" else expect(
                F.LAUNCHES, (1, per_step), (cfg.transformer_layers, "full"),
                (cfg.vision_layers, vision_fwd))
            check_launches(f"{model} step under REMAT {mode}", dict(F.LAUNCHES), want)
            paths[mode] = dict(F.LAUNCHES)
            readings[mode] = (loss.detach(), grads)
            del loss, grads
        say(phase, f"one step at batch {BATCH} ({vision_route} vision layers), REMAT full vs "
                   "none: " + check_remat(model, readings["none"], readings["full"],
                                          (peaks["none"], peaks["full"])))
        say(phase, f"launches a step: none {sum(paths['none'].values())}, full "
                   f"{sum(paths['full'].values())} (one more forward of each of "
                   f"{cfg.transformer_layers} text and {cfg.vision_layers} vision layers)")
        del readings
        for mode in ("none", "full"):
            transformer.set_remat_mode(mode)
            for _ in range(WARMUP_STEPS):
                st.train_step(st.images, st.labels)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = [_synced_ms(lambda: st.train_step(st.images, st.labels))
                  for _ in range(REMAT_TIMED)]
            if model == "ViT-B/16":  # for [api]'s bench under --remat
                THROUGHPUT[f"remat_{mode}"] = BATCH * 1e3 / statistics.median(ms)
            say(phase, f"REMAT {mode}: {REMAT_TIMED} steps of {BATCH} images, median "
                       f"{statistics.median(ms):.2f} ms ({BATCH * 1e3 / statistics.median(ms):.1f} "
                       f"images/s); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    finally:
        transformer.set_remat_mode("none")
    return paths["full"]


# [block xla]: the XLA route on the card: the ViT-B/16 request under
# BLOCK xla against the kernel route, and one block 1280 wide (20 heads,
# 257 rows, batch 64) in bf16 against the same block in fp32
XLA_WIDE = (64, 257, 1280, 20)
# bf16 against fp32 through one block: each intermediate rounded to bf16
# (LN, qkv, probs, the attention output, h) and the output once
XLA_BLOCK_MAX_ERR, XLA_BLOCK_NORM_ERR = 2.0 ** -5, 2.0 ** -6


def phase_block_xla(F) -> dict:
    """The ViT-B/16 server under block impl 'xla' (text and requests on
    PyTorch ops, no kernel launched) held to the kernel route and timed;
    then a D = 1280 block, which 'auto' routes to XLA."""
    import torch

    from mudpt_torch.models import layers
    from mudpt_torch.utils.synth_step import build_synth_mudpt_server

    phase = "block xla"
    st = build_synth_mudpt_server("ViT-B/16", BATCH, N_CLS, N_CTX, DEPTH, seed=0)
    tr, params, aux, images = st.trainable, st.params, st.aux, st.images
    txt = st.text_features(tr, params, aux)
    logits_k = st.image_logits(tr, params, aux, images, txt)
    layers.set_block_impl("xla")
    try:
        F.reset_launches()
        txt_x = st.text_features(tr, params, aux)
        logits_x = st.image_logits(tr, params, aux, images, txt_x)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        if any(launches.values()):
            raise AssertionError(f"BLOCK xla launched kernels: {launches}")
        say(phase, "ViT-B/16 under BLOCK xla vs the kernel route: "
                   + hold_logits(logits_x, logits_k))
        ms = time_ms(lambda: st.image_logits(tr, params, aux, images, txt_x), REQUESTS)
        say(phase, f"ViT-B/16 request of {BATCH} under BLOCK xla: {ms:.2f} ms, "
                   f"{BATCH * 1e3 / ms:.1f} images/s ([serving], the kernels: "
                   f"{THROUGHPUT['serving']:.1f}); no kernel launched")
        traced("serving block xla", lambda: st.image_logits(tr, params, aux, images, txt_x),
               serving_time_by_kernel)
    finally:
        layers.set_block_impl("auto")
    del st, params, aux, images, txt, txt_x

    B, S, D, H = XLA_WIDE
    rn = randn_fn(23)
    p = {"ln_1": {"scale": rn(D, dtype=torch.float32, std=0.1) + 1.0,
                  "bias": rn(D, dtype=torch.float32, std=0.1)},
         "ln_2": {"scale": rn(D, dtype=torch.float32, std=0.1) + 1.0,
                  "bias": rn(D, dtype=torch.float32, std=0.1)},
         "attn": {"qkv_w": rn(D, 3 * D, std=D ** -0.5), "qkv_b": rn(3 * D, std=0.02),
                  "out_w": rn(D, D, std=D ** -0.5), "out_b": rn(D, std=0.02)},
         "mlp": {"fc_w": rn(D, 4 * D, std=D ** -0.5), "fc_b": rn(4 * D, std=0.02),
                 "proj_w": rn(4 * D, D, std=(4 * D) ** -0.5), "proj_b": rn(D, std=0.02)}}
    p32 = to_float(p)
    x = rn(B, S, D)
    F.reset_launches()
    with torch.no_grad():
        y = layers.residual_block(p, x, H)
        y32 = layers.residual_block(p32, x.float(), H)
        torch.cuda.synchronize()
        if any(F.LAUNCHES.values()):
            raise AssertionError(f"the D = {D} block launched kernels: {dict(F.LAUNCHES)}")
        reading = check_close(f"D = {D} block, bf16 vs fp32", y.float(), y32,
                              max_limit=XLA_BLOCK_MAX_ERR, norm_limit=XLA_BLOCK_NORM_ERR,
                              share_limit=None)
        ms = time_ms(lambda: layers.residual_block(p, x, H))
        ms32 = time_ms(lambda: layers.residual_block(p32, x.float(), H))
    M = B * S
    flops = 2 * M * 12 * D * D + 4 * M * S * D
    say(phase, f"a block {B} x {S} x {D} ({H} heads) routed to XLA: {reading}; bf16 {ms:.3f} "
               f"ms ({flops / ms / 1e9:.1f} TFLOP/s), fp32 {ms32:.3f} ms; no kernel launched")
    return launches


# [fp32]: the kernel chains on fp32 activations, as a trainer under PREC
# fp32 runs them.  The Pallas functions take an fp32 x and round to x.dtype,
# so in fp32 their rounding points are no-ops; the plain versions are fp32
# torch ops with TF32 off (phase 1), and a kernel and its plain version
# differ only in the order of fp32 sums and the last ulp of exp, rsqrt and
# division.  The limits, stated before the phase's first run (PERF.md,
# the fp32 findings): LayerNorm's sums only change order (readings near
# 2^-20 expected); an epilogue GEMM's K = 768-3072 fp32 terms summed in another
# order than the library's, and attention's, read 2^-16 or better.  One
# bf16 rounding anywhere reads about 2^-9 and a single-pass TF32 product
# (10-bit mantissa) about 2^-11 (tests/test_torch_chip_checks.py), so:
F32_LN_NORM_ERR = 2.0 ** -16      # each LayerNorm, forward and dx: relative norm error
F32_KERNEL_NORM_ERR = 2.0 ** -14  # each GEMM epilogue and attention, each way
F32_KERNEL_MAX_ERR = 2.0 ** -12   # any kernel: max abs error over the largest value
# a chain (the half-blocks at D = 1024, the chunked half at 1280, forward
# and dx), the step's gradients, the evaluate's and CoCoOp's logits: several
# kernels deep, where the sum-order differences propagate; never looser
# than 2^-12, which one bf16 rounding anywhere in an fp32 chain exceeds
F32_CHAIN_NORM_ERR = 2.0 ** -12
F32_CHAIN_MAX_ERR = 2.0 ** -10
# the step's loss: a mean over the batch, which one bf16 rounding moves by
# ~2^-10 of itself at these sizes
F32_LOSS_REL_ERR = 2.0 ** -14
FP32_OPTS = ("TRAINER.MUDPT.PREC", "fp32")
# the step at 384 runs about 3x the request's products on the fp32 kernels
FP32_TIMED_STEPS = 2
FP32_CHAIN = (32, 259, 1024, 16)   # rows 4-11: batch, tokens, width, heads
FP32_CHUNKED = (8, 197, 1280)      # rows 12-13: batch, tokens, width (10 chunks)
# the fp32 GEMM cases of [fp32] and --times-of: ViT-B/16's, and the MLP's
# recompute epilogues
FP32_GEMM = SHAPES["ViT-B/16"]["gemm"] + (("fc_gelu_grad", M_B, 768, 3072, 0),
                                          ("mul_f32", M_B, 768, 3072, 0))
# attention_f32 (both ways) in --times-of: ViT-B/16's blocks, and the
# halves' at D = 1024
FP32_ATTN_BWD = tuple(a[:5] for a in SHAPES["ViT-B/16"]["attn"]) + (
    ("fp32 chain", FP32_CHAIN[0], FP32_CHAIN[1], FP32_CHAIN[3], False),)
# the fp32 LayerNorms' rows in [fp32] beyond the step's (SHAPES) and in
# --times-of: ViT-B/16's vision and text rows, the halves' at D = 1024 and
# the chunked half's at 1280, each way (forward, dx with a residual, dx)
FP32_LN = ((M_B, 768), (13 * 128, 512), (FP32_CHAIN[0] * FP32_CHAIN[1], FP32_CHAIN[2]),
           (FP32_CHUNKED[0] * FP32_CHUNKED[1], FP32_CHUNKED[2]))
LN_WAYS = ("forward", "dx + r", "dx")


def bound32(bytes_moved: float, product_ops: float, fp32_ops: float = 0.0):
    """(ms, 'bytes' | 'operations'): the least time for fp32 work whose
    products must be fp32-accurate, at best three TF32 products each
    (3 x ops / 494.7 TFLOP/s), the rest on the FMA pipes."""
    return bound(bytes_moved, 0, fp32_ops, tf32_ops=3 * product_ops)


def fp32_ln_case(F, rn, rows: int, D: int, way: str) -> dict:
    """One fp32 LayerNorm case of ``LN_WAYS`` at (rows, D) on seeded inputs:
    its name, the kernel's call, the plain version's, F.layer_norm's (the
    forward, or its backward without a residual: the same dx) and the bytes
    each moves: the kernel each input once and its output (with the
    scale and bias), the library's backward dy and x in, dx out, and its
    saved mean and rstd."""
    import torch
    import torch.nn.functional as tf

    f32 = torch.float32
    x = rn(rows, D, std=2.0, dtype=f32)
    s = rn(D, dtype=f32) * 0.1 + 1
    if way == "forward":
        b = rn(D, dtype=f32) * 0.1
        return dict(name=f"layernorm_fwd_f32 {rows}x{D}", fn=lambda: F.layer_norm_fwd(x, s, b),
                    plain=lambda: F.layer_norm_plain(x, s, b),
                    lib=lambda: tf.layer_norm(x, (D,), s, b, 1e-5),
                    bytes=2 * rows * D * 4 + 2 * D * 4, lib_bytes=2 * rows * D * 4 + 2 * D * 4,
                    ops=8 * rows * D)
    dxn = rn(rows, D, dtype=f32)
    r = rn(rows, D, dtype=f32) if way == "dx + r" else None
    xr = x.detach().requires_grad_(True)
    y = tf.layer_norm(xr, (D,), s, s, 1e-5)
    return dict(name=f"layernorm_bwd_f32 {way} {rows}x{D}",
                fn=lambda: F.layer_norm_bwd(dxn, x, s, r),
                plain=lambda: F.layer_norm_bwd_plain(dxn, x, s, r),
                lib=lambda: torch.autograd.grad(y, xr, dxn, retain_graph=True)[0],
                bytes=rows * D * 4 * (3 + (r is not None)) + D * 4,
                lib_bytes=rows * D * 4 * 3 + rows * 8 + D * 4, ops=15 * rows * D)


def fp32_ln_check(F, tag: str, case: dict, kern: "Kernel" = None, per_layer: int = 0) -> None:
    """An fp32 LayerNorm case against its plain version (``F32_LN_NORM_ERR``),
    relaunched bit-equal, timed beside its plain version and F.layer_norm
    (by ``time_ms``, and queued: device ms and the host's us a call), each
    side's bytes and TB/s; added ``per_layer`` times to ``kern``."""
    name = case["name"]
    reading = check_f32(name, case["fn"](), case["plain"](), kern, F32_LN_NORM_ERR)
    check_relaunch(name, case["fn"])
    ms, lib = time_ms(case["fn"]), time_ms(case["lib"])
    plain = time_ms(case["plain"])
    (dev, host), (lib_dev, lib_host) = queued_ms(case["fn"]), queued_ms(case["lib"])
    bms, by = bound32(case["bytes"], 0, case["ops"])
    lib_name = "F.layer_norm" + (" backward" if "bwd" in name else "")
    say(tag, f"{name}: {reading} ms {ms:.4f} plain {plain:.4f} library({lib_name}) {lib:.4f} "
             f"bound {bms:.4f} ({by}); queued device ms {dev:.4f}, host {host:.1f} us a call; "
             f"library {lib_dev:.4f}, host {lib_host:.1f} us; bytes {case['bytes'] / 1e6:.1f} MB "
             f"({case['bytes'] / dev / 1e9:.3f} TB/s queued), library "
             f"{case['lib_bytes'] / 1e6:.1f} MB ({case['lib_bytes'] / lib_dev / 1e9:.3f} TB/s)")
    for _ in range(per_layer):
        kern.add(ms, plain, lib, bms, by)


def fp32_kernels(F) -> dict:
    """{a bf16 kernel's launch count: its fp32 counterpart's}."""
    import torch

    return {by[torch.bfloat16]: by[torch.float32] for by in F.DTYPE_KERNELS.values()}


def in_fp32(F, want: dict) -> dict:
    """A path's launches on fp32 activations: each bf16 kernel's count
    moved to its fp32 counterpart, the chains' counts as they are."""
    names = fp32_kernels(F)
    out = dict.fromkeys(want, 0)
    for k, v in want.items():
        out[names.get(k, k)] += v
    return out


def fp32_q8_kernels(F) -> list:
    """The int8 tiers' kernels on fp32 activations: the fp32 counterparts of
    Q8_KERNELS, and quant_rows, which takes fp32 rows in both dtypes."""
    names = fp32_kernels(F)
    return [names.get(k, k) for k in Q8_KERNELS]


def check_fp32_launches(F, what: str, got: dict, backward: bool = True,
                        quant: bool = False) -> str:
    """An fp32 run went through the fp32 kernels and no other: each fp32
    kernel of its route launched (the backward ones only where it trains;
    under an int8 tier, ``quant``, the fp32 q8 kernels with quant_rows, and
    of the unquantized ones the LayerNorm, attention and, training, the
    layer backward's), no bf16 kernel, no int8 kernel in an unquantized
    run, and the chains counted (the XLA route counts none)."""
    q8 = fp32_q8_kernels(F)
    plain32 = [k for k in fp32_kernels(F).values() if k not in q8]
    allowed = plain32 + (q8 if quant else [])
    f32 = [k for k in plain32 if backward or "bwd" not in k]
    if quant:
        f32 = q8 + [k for k in f32 if backward or k != "gemm_f32_epilogue"]
    wrong = {k: got.get(k, 0) for k in F.KERNELS if k not in allowed and got.get(k, 0)}
    idle = [k for k in f32 if not got.get(k, 0)]
    chains = {k: got[k] for k in F.CHAINS if got.get(k, 0)}
    if wrong or idle or not chains:
        raise AssertionError(f"{what}: launched {wrong or 'no other kernel'}, fp32 kernels "
                             f"not launched {idle or 'none'}, chains {chains or 'none'}")
    return "fp32 kernels only: " + ", ".join(f"{k} {got[k]}" for k in f32) + f"; chains {chains}"


def check_f32(what: str, got, ref, kernel: Kernel = None, norm_limit=F32_KERNEL_NORM_ERR,
              max_limit=F32_KERNEL_MAX_ERR) -> str:
    """An fp32 result against its plain version: relative norm error and
    max error (every element may differ: the sums run in another order);
    the reading with log2 of the norm error."""
    reading = check_close(what, got, ref, kernel, max_limit=max_limit, norm_limit=norm_limit,
                          share_limit=None)
    norm = float(reading.split(" norm ")[1].split()[0])
    return f"{reading} (2^{math.log2(norm) if norm > 0 else float('-inf'):.1f})"


def check_relaunch(what: str, fn) -> None:
    """Two launches on the same inputs give the same bits."""
    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        check_equal(f"{what}, launched again", x, y)


def phase_kernels_fp32(F, kernels: dict) -> None:
    """Every fp32 kernel against its plain version at the ViT-B/16 step's
    shapes (SHAPES, and the MLP's recompute epilogues), relaunched
    bit-equal, timed beside its plain version and one library call
    (F.layer_norm, torch.addmm or torch.matmul, SDPA, all in fp32 with TF32
    off), added to ``kernels`` per vision layer of the step; then
    attention_f32 both ways at every block length of ``ATTN_SWEEP_S``
    (16-1,024 rows) under every mask spec, relaunched bit-equal."""
    import torch
    import torch.nn.functional as tf

    tag, f32 = "fp32", torch.float32
    spec = SHAPES["ViT-B/16"]
    rn = randn_fn(14)

    for rows, D, per_layer in spec["ln"]:
        fp32_ln_check(F, tag, fp32_ln_case(F, rn, rows, D, "forward"),
                      kernels["layernorm_fwd_f32"], per_layer)

    for ep, M, K, N, per_layer in FP32_GEMM:
        a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N, f32)
        kern = kernels["gemm_f32_epilogue"]
        got, ref = (F.gemm_epilogue(a, w, bias, ep, extra),
                    F.gemm_epilogue_plain(a, w, bias, ep, extra))
        if ep == "fc_gelu_save":
            reading = "h " + check_f32(f"gemm_f32 {ep} h", got[0], ref[0], kern)
            reading += "; a " + check_f32(f"gemm_f32 {ep} a", got[1], ref[1], kern)
        else:
            reading = check_f32(f"gemm_f32 {K}->{N} {ep}", got, ref, kern)
        del got, ref
        check_relaunch(f"gemm_f32 {K}->{N} {ep}", lambda: F.gemm_epilogue(a, w, bias, ep, extra))
        w_nk = F.EPILOGUES[ep][1]
        ms = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra))
        plain = time_ms(lambda: F.gemm_epilogue_plain(a, w, bias, ep, extra), 3)
        if w_nk:
            lib, lib_name = time_ms(lambda: torch.matmul(a, w.t())), "torch.matmul(a, W.t())"
        elif bias is None:
            lib, lib_name = time_ms(lambda: torch.matmul(a, w)), "torch.matmul"
        else:
            lib, lib_name = time_ms(lambda: torch.addmm(bias, a, w)), "torch.addmm"
        outputs = 2 if ep == "fc_gelu_save" else 1
        nbytes = (M * K + K * N + M * N * (outputs + (extra is not None))
                  + (N if bias is not None else 0)) * 4
        flops = 2 * M * N * K
        bms, by = bound32(nbytes, flops)
        say(tag, f"gemm_f32_epilogue {ep} {M}x{K}->{N}: {reading} ms {ms:.4f} "
                 f"({flops / ms / 1e9:.1f} TFLOP/s; the FMA pipes' 67 TFLOP/s take "
                 f"{flops / PEAK_FP32_FLOPS * 1e3:.4f} ms) plain {plain:.4f} "
                 f"library({lib_name}, fp32) {lib:.4f} bound {bms:.4f} ({by}, 3xTF32)")
        for _ in range(per_layer):
            kern.add(ms, plain, lib, bms, by)
        del a, w, bias, extra

    for rows, D, _, with_r, per_layer in spec["ln_bwd"]:
        fp32_ln_check(F, tag, fp32_ln_case(F, rn, rows, D, "dx + r" if with_r else "dx"),
                      kernels["layernorm_bwd_f32"], per_layer)
    # the rest of FP32_LN's cases: checked and timed, in no layer's totals
    done = {(rows, D, "forward") for rows, D, _ in spec["ln"]} | {
        (rows, D, "dx + r" if with_r else "dx") for rows, D, _, with_r, _ in spec["ln_bwd"]}
    for rows, D in FP32_LN:
        for way in LN_WAYS:
            if (rows, D, way) not in done:
                fp32_ln_check(F, tag, fp32_ln_case(F, rn, rows, D, way),
                              kernels["layernorm_fwd_f32" if way == "forward"
                                      else "layernorm_bwd_f32"])

    for label, B, S, H, causal, per_layer in spec["attn"]:
        D = 64 * H
        qkv = rn(B, S, 3 * D, dtype=f32)
        do = rn(B, S, D, std=0.1, dtype=f32)
        L, is_causal, valid = F._block_spec(S, causal)
        n = B * (S // L)
        pairs = sum(min(r + 1, valid) if is_causal else valid for r in range(L))
        q, k, v = (t.detach().requires_grad_(True)
                   for t in qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4))
        if isinstance(causal, tuple):
            i = torch.arange(L, device=qkv.device)
            allowed = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # noqa: E731
        else:
            sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, is_causal=is_causal)  # noqa: E731
        for name, fn, plain_fn, nbytes, prods, lib_fn in (
                ("attention_fwd_f32", lambda: F.attention_fwd(qkv, H, causal),
                 lambda: F.attention_plain(qkv, H, causal), 4 * B * S * D * 4,
                 2 * 2 * 64 * pairs * n * H, None),
                ("attention_bwd_f32", lambda: F.attention_bwd(qkv, do, H, causal),
                 lambda: F.attention_bwd_plain(qkv, do, H, causal), 7 * B * S * D * 4,
                 5 * 2 * 64 * pairs * n * H, "bwd")):
            kern = kernels[name]
            reading = check_f32(f"{name} {label}", fn(), plain_fn(), kern)
            check_relaunch(f"{name} {label}", fn)
            ms = time_ms(fn)
            plain = time_ms(plain_fn, 3)
            if lib_fn is None:
                with torch.no_grad():
                    lib = time_ms(sdpa)
            else:
                out = sdpa()
                do4 = do.view(n, L, H, 64).permute(0, 2, 1, 3)
                lib = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do4, retain_graph=True))
                del out, do4
            bms, by = bound32(nbytes, prods, (5 if lib_fn is None else 8) * pairs * n * H)
            say(tag, f"{name} {label} B={B} S={S} H={H}: {reading} ms {ms:.4f} plain "
                     f"{plain:.4f} library(sdpa{' backward' if lib_fn else ''}, fp32) {lib:.4f} "
                     f"bound {bms:.4f} ({by})")
            if per_layer:
                kern.add(ms, plain, lib, bms, by)
        del qkv, do, q, k, v
    torch.cuda.empty_cache()

    # both entry points at every block length of the models and past them,
    # every mask spec, 4 sequences of 2 heads, each relaunched bit-equal
    for S in ATTN_SWEEP_S:
        readings = []
        for mask in (False, True, (S, S - 7), (16, 11)):
            if S % mask[0] if isinstance(mask, tuple) else False:
                continue
            qkv, do = rn(4, S, 3 * 128, dtype=f32), rn(4, S, 128, std=0.1, dtype=f32)
            for name, fn, plain_fn in (
                    ("attention_fwd_f32", lambda: F.attention_fwd(qkv, 2, mask),
                     lambda: F.attention_plain(qkv, 2, mask)),
                    ("attention_bwd_f32", lambda: F.attention_bwd(qkv, do, 2, mask),
                     lambda: F.attention_bwd_plain(qkv, do, 2, mask))):
                what = f"{name} S={S} mask={mask}"
                reading = check_f32(what, fn(), plain_fn(), kernels[name])
                check_relaunch(what, fn)
                readings.append(f"{mask}/{name[10:13]} 2^{reading.rsplit('2^', 1)[1][:-1]}")
        say(tag, f"attention_f32 S={S}: within limits, relaunched bit-equal: {', '.join(readings)}")


def fp32_chain_case(F, what: str, fn, ref_fn, want: dict, bound_text: str) -> tuple:
    """A chain's output (and, where it trains, its dx) against the plain
    chain's, its launches held to ``want`` (fp32 kernels only), timed beside
    the plain chain: (the reading with ms, plain ms and ``bound_text``, the
    launches of one call)."""
    F.reset_launches()
    got = fn()
    launches = dict(F.LAUNCHES)
    check_launches(what, launches, want)
    reading = check_f32(what, got, ref_fn(), norm_limit=F32_CHAIN_NORM_ERR,
                        max_limit=F32_CHAIN_MAX_ERR)
    del got
    ms = time_ms(fn, 3)
    plain = time_ms(ref_fn, 1)
    return f"{reading} ms {ms:.4f} plain {plain:.4f} {bound_text}", launches


def phase_fp32_chains(F) -> dict:
    """Rows 1-3 of PERF.md's table in fp32: the ViT-B/16 vision layer
    (384 x 199, D = 768), its forward and its saving forward with dx; rows
    4-11: the attention and MLP halves at D = 1024 (16 heads, 259 tokens,
    batch 32), forward alone and forward with dx, qkv and h saved (saves on)
    and recomputed (saves off); then rows 12-13: the chunked MLP half at D
    = 1280 (10 chunks of 512), forward and dx.  Each against the plain
    chain, timed beside it with its fp32 bound (``chain_bound``).  Returns
    the launches of one forward and backward of each half, saving."""
    import torch

    rn = randn_fn(15)
    f32 = torch.float32
    B, S, D, H = BATCH, 199, 768, 12
    ps = layer_params(rn, D, f32)
    x = rn(B, S, D, dtype=f32)
    g = rn(B, S, D, std=0.1, dtype=f32)
    with torch.no_grad():
        fwd, _ = fp32_chain_case(
            F, "layer_fullblock fp32 forward", lambda: F.layer_fullblock(x, *ps, H),
            lambda: F.layer_fullblock_plain(x, *ps, H),
            in_fp32(F, expect(F.LAUNCHES, (1, "full"))), chain_bound(B, S, D, False, fp32=True))

    def layer_step(plain=False):
        xr = x.detach().requires_grad_(True)
        y = F.layer_fullblock(xr, *ps, H, plain=plain)
        return torch.autograd.grad(y, xr, g)[0]

    bwd, _ = fp32_chain_case(F, "layer_fullblock fp32 forward-save + dx", layer_step,
                             lambda: layer_step(plain=True),
                             in_fp32(F, expect(F.LAUNCHES, (1, "full_train"))),
                             chain_bound(B, S, D, False, bwd=True, fp32=True))
    say("fp32", f"layer_fullblock D={D} B={B} S={S}: forward {fwd}; forward-save + dx {bwd}")
    del ps, x, g

    B, S, D, H = FP32_CHAIN
    ps = layer_params(rn, D, f32)
    x = rn(B, S, D, dtype=f32)
    g = rn(B, S, D, std=0.1, dtype=f32)
    halves = (("attn_halfblock", F.attn_halfblock, ps[:6], (H,), "attn"),
              ("mlp_halfblock", F.mlp_halfblock, ps[6:], (), "mlp"))
    out = {}
    for name, fn, p, more, half in halves:
        readings = []
        with torch.no_grad():
            want = {k: 0 for k in F.LAUNCHES}
            want.update({name: 1, "layernorm_fwd_f32": 1, "gemm_f32_epilogue": 2,
                         "attention_fwd_f32": int(half == "attn")})
            readings.append("forward " + fp32_chain_case(
                F, f"{name} fp32 forward", lambda: fn(x, *p, *more),
                lambda: fn(x, *p, *more, plain=True), want,
                chain_bound(B, S, D, False, (half,), fp32=True))[0])
        for saves in (True, False):
            def fwd_bwd(plain=False):
                xr = x.detach().requires_grad_(True)
                with F.saved_acts(saves):
                    y = fn(xr, *p, *more, plain=plain)
                    return torch.autograd.grad(y, xr, g)[0]
            recompute = not saves
            # the forward's LayerNorm and two products, the backward's two
            # products and LayerNorm dx (the attention half: attention each
            # way); recomputing, the LayerNorm and the qkv product (or the
            # fc product, its epilogue storing QuickGELU') again
            want = {k: 0 for k in F.LAUNCHES}
            want.update({name: 1, f"{name}_bwd": 1, "layernorm_fwd_f32": 1 + recompute,
                         "gemm_f32_epilogue": 4 + recompute, "layernorm_bwd_f32": 1})
            if half == "attn":
                want.update(attention_fwd_f32=1, attention_bwd_f32=1)
            what = f"{name} fp32 forward + dx, {'saved' if saves else 'recomputed'}"
            reading, launches = fp32_chain_case(F, what, fwd_bwd, lambda: fwd_bwd(plain=True),
                                                want, chain_bound(B, S, D, False, (half,),
                                                                  bwd=True, fp32=True))
            readings.append(("saved " if saves else "recomputed ") + reading)
            if saves:
                out[f"fp32_{name}_train"] = launches
        say("fp32", f"{name} D={D} B={B} S={S}: " + "; ".join(readings))

    B, S, D = FP32_CHUNKED
    p = mlp_params(rn, D, f32)
    x = rn(B, S, D, dtype=f32)
    g = rn(B, S, D, std=0.1, dtype=f32)
    n_chunks = 4 * D // F._pick_chunk(4 * D, D)
    with torch.no_grad():
        want = {k: 0 for k in F.LAUNCHES}
        want.update(mlp_halfblock_chunked=1, layernorm_fwd_f32=1,
                    gemm_f32_epilogue=2 * n_chunks)
        fwd, _ = fp32_chain_case(F, "mlp_halfblock_chunked fp32 forward",
                                 lambda: F.mlp_halfblock_chunked(x, *p),
                                 lambda: F.mlp_halfblock_chunked(x, *p, plain=True), want,
                                 chain_bound(B, S, D, False, ("mlp",), fp32=True))

    def fwd_bwd(plain=False):
        xr = x.detach().requires_grad_(True)
        y = F.mlp_halfblock_chunked(xr, *p, plain=plain)
        return torch.autograd.grad(y, xr, g)[0]

    want = {k: 0 for k in F.LAUNCHES}
    want.update(mlp_halfblock_chunked=1, mlp_halfblock_chunked_bwd=1, layernorm_fwd_f32=2,
                gemm_f32_epilogue=5 * n_chunks, layernorm_bwd_f32=1)
    bwd, out["fp32_mlp_halfblock_chunked_train"] = fp32_chain_case(
        F, "mlp_halfblock_chunked fp32 forward + dx", fwd_bwd, lambda: fwd_bwd(plain=True), want,
        chain_bound(B, S, D, False, ("mlp",), bwd=True, fp32=True))
    say("fp32", f"mlp_halfblock_chunked D={D} B={B} S={S} ({n_chunks} chunks): forward {fwd}; "
                f"forward + dx {bwd}")
    return out


def cli_launches(root: Path, argv: list) -> int:
    """``python3 chip_smoke.py --cli-launches ARGS``: the port's CLI
    (``mudpt_torch.train``'s main on ARGS, as ``python -m mudpt_torch.train
    ARGS`` runs it) in this fresh process, then one JSON line of the
    kernels it launched, counted from its start."""
    sys.path.insert(0, str(root))
    from mudpt_torch import train as train_cli
    from mudpt_torch.ops import fused_block as F

    streams = sys.stdout, sys.stderr
    F.reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(train_cli.parse_args(argv))
    seconds = time.perf_counter() - t0
    sys.stdout, sys.stderr = streams  # the CLI tees stdout into its log
    print(json.dumps({"launches": dict(F.LAUNCHES), "seconds": seconds,
                      "compute_dtype": str(trainer.compute_dtype)}), flush=True)
    return 0


def fp32_grads(F, tr, batch) -> dict:
    """The trainer's loss and every trainable leaf's gradient on ``batch``,
    through the kernels (their launches counted) and under plain_blocks()
    (fp32 torch ops, TF32 off), each leaf's finite and not zero."""
    import torch

    from mudpt_torch.models.clip import leaves
    from mudpt_torch.models.layers import plain_blocks

    params, names = leaves(tr.trainable), leaf_names(tr.trainable)

    def one():
        loss = tr.loss_fn(batch)[0]
        grads = torch.autograd.grad(loss, params)
        check_leaf_grads(names, grads)
        return loss.item(), grads

    F.reset_launches()
    loss, grads = one()
    launches = dict(F.LAUNCHES)
    with plain_blocks():
        loss_ref, grads_ref = one()
    errs = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, grads, grads_ref)}
    return dict(launches=launches, loss=loss, loss_ref=loss_ref,
                rel=abs(loss - loss_ref) / abs(loss_ref), errs=errs)


def hold_fp32_grads(what: str, r: dict) -> str:
    worst = max(r["errs"].values())
    reading = (f"loss {r['loss']:.7f} vs {r['loss_ref']:.7f} (rel {r['rel']:.3g}, limit "
               f"{F32_LOSS_REL_ERR:.3g}); gradient relative norm errors, limit "
               f"{F32_CHAIN_NORM_ERR:.3g}: " + ", ".join(
                   f"{n} {e:.3g}" for n, e in r["errs"].items())
               + f" (worst 2^{math.log2(worst) if worst > 0 else float('-inf'):.1f})")
    if not (r["rel"] <= F32_LOSS_REL_ERR and worst <= F32_CHAIN_NORM_ERR):
        raise AssertionError(f"{what}: {reading}")
    return reading


class TextTaps:
    """Taps on the text encode of ``cocoop_forward``: each call of
    ``text_forward`` (the prompts in, the features out), of the text
    tower's ``transformer_forward`` (the packed rows in and out, every
    kernel of rows 14-15 and their backward) and of ``layer_norm`` (the
    EOT rows through ln_final, the LayerNorm kernels), with the gradient
    that reaches its input and its output."""

    SITES = (("trainers.cocoop", "text_forward"), ("models.text", "transformer_forward"),
             ("models.text", "layer_norm"))

    def __enter__(self):
        import importlib

        self.calls, self.real = [], {}
        for mod, name in self.SITES:
            m = importlib.import_module(f"mudpt_torch.{mod}")
            self.real[mod, name] = fn = getattr(m, name)
            setattr(m, name, self._tap(name, fn))
        return self

    def __exit__(self, *exc):
        import importlib

        for (mod, name), fn in self.real.items():
            setattr(importlib.import_module(f"mudpt_torch.{mod}"), name, fn)

    def _tap(self, name, fn):
        def tapped(p, x, *args, **kw):
            rec = {"site": name, "fn": fn, "p": p, "x": x.detach(), "args": args, "kw": kw}
            self.calls.append(rec)
            if x.requires_grad:
                x.register_hook(lambda g: rec.__setitem__("dx", g))
            y = fn(p, x, *args, **kw)
            if y.requires_grad:
                y.register_hook(lambda g: rec.__setitem__("dy", g))
            return y
        return tapped

    def by_site(self) -> dict:
        """Each site's calls whose gradients arrived (a checkpoint's
        recompute in the backward has none), in the order of the rows."""
        out = {}
        for rec in self.calls:
            if "dy" in rec:
                out.setdefault(rec["site"], []).append(rec)
        return out


def chunk_cause(unchunked: dict, chunked: dict, quant: str) -> str:
    """Where the chunked step's gradients part from the unchunked one's:
    each tap's output and input gradient on a chunk's rows against the same
    rows of the unchunked run, from the loss down (the first that differs
    names the op); then each kernel site replayed on the unchunked run's
    inputs and output gradients, all rows against one chunk's, which must be
    bit-equal (the kernels compute a row alike in any batch), and the text
    projection's backward product (``models.text._project``, products of a
    fixed row count, between ln_final and the features) replayed the same
    way.  The features' gradients must be bit-equal."""
    import torch

    from mudpt_torch.models import layers
    from mudpt_torch.ops.fused_block import saved_acts

    def rel(a, b):
        return "bit-equal" if torch.equal(a, b) else f"{((a - b).norm() / b.norm()).item():.3g}"

    parts, chain = [], []
    for site in ("text_forward", "layer_norm", "transformer_forward"):
        (whole,), chunks = unchunked[site], chunked[site]
        for key, what in (("dy", "output"), ("dx", "input")):
            start, reads = 0, []
            for rec in chunks:
                n = rec[key].shape[0]
                reads.append(rel(rec[key], whole[key][start:start + n]))
                start += n
            if start != whole[key].shape[0]:
                raise AssertionError(f"{site}: the chunks cover {start} rows of "
                                     f"{whole[key].shape[0]}")
            if (site, key) == ("text_forward", "dy") and set(reads) != {"bit-equal"}:
                raise AssertionError(f"the text features' gradients differ chunked: {reads}")
            chain.append(f"{site} {what} " + " / ".join(reads))
    parts.append("gradients, chunked vs unchunked rows (each chunk): " + "; ".join(chain))
    for site in ("layer_norm", "transformer_forward"):
        (whole,), n = unchunked[site], chunked[site][0]["x"].shape[0]

        def replay(rows):
            x = whole["x"][:rows].clone().requires_grad_(True)
            with layers.quantized(quant), saved_acts(False):
                y = whole["fn"](whole["p"], x, *whole["args"], **whole["kw"])
                (dx,) = torch.autograd.grad(y, x, whole["dy"][:rows])
            return y.detach()[:n], dx[:n]

        got = replay(n)
        check_bit_equal(f"{site} replayed on {n} rows vs all", got, replay(whole["x"].shape[0]))
        parts.append(f"{site} replayed on the first chunk's {n} rows vs all "
                     f"{whole['x'].shape[0]}, the same output gradient: output and input "
                     f"gradient bit-equal")
    # out = _project(pooled, projection); its input gradient, replayed
    from mudpt_torch.models.text import _project

    (whole,), n = unchunked["text_forward"], chunked["layer_norm"][0]["x"].shape[0]
    w = whole["p"]["projection"].to(whole["dy"].dtype)
    dout = whole["dy"].reshape(-1, w.shape[-1])

    def project_dx(rows):
        pooled = torch.zeros(rows, w.shape[0], device=w.device, dtype=w.dtype,
                             requires_grad=True)
        return torch.autograd.grad(_project(pooled, w), pooled, dout[:rows])[0][:n]

    parts.append(f"the text projection's backward product ({tuple(w.shape)}, products of "
                 f"a fixed row count) on the first chunk's {n} rows vs all {dout.shape[0]}: "
                 + rel(project_dx(n), project_dx(dout.shape[0])))
    return "; ".join(parts)


def fp32_cocoop_step(F, device: str = "cuda", quant: str = "none") -> dict:
    """CoCoOp ViT-B/16 in fp32 at [zoo]'s cut (1,000 classes, 4 images,
    seeded random weights, CTX_INIT "a photo of a"): one step, unchunked,
    its text rows on the half-blocks with saves off at D = 512 (rows 4, 6,
    8 and 10), its logits and gradients against the plain route.  Under
    ``int8_ste`` the towers' weights are quantized once as a trainer's build
    does, the text rows take the quantization-aware q8 chain (rows 14-15 at
    D = 512, recomputed in the backward), held to the plain route under
    [cocoop int8]'s limits, and the step in chunks of COCOOP_CHUNK instances
    is held to the unchunked one: the logits and the gradients bit-equal,
    each op's gradients on a chunk's rows shown by :func:`chunk_cause`.
    Returns each run's launches."""
    import contextlib

    import torch

    from mudpt_torch.models import layers
    from mudpt_torch.models.clip import VIT_B16, init_clip_params, leaves
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.models.text import _auto_pack_g, _text_saves_off
    from mudpt_torch.ops.quant_block import quantize_blocks
    from mudpt_torch.trainers.cocoop import cocoop_forward
    from mudpt_torch.trainers.prompt_utils import (ctx_vectors_from_init, embed_classnames,
                                                   init_linear)
    from mudpt_torch.utils.rng import new_rng
    from mudpt_torch.utils.synth_step import nll_loss

    cfg, dev = VIT_B16, torch.device(device)
    quantized = quant != "none"
    phase = "fp32 int8" if quantized else "fp32"
    g = new_rng(0, dev)
    params = init_clip_params(cfg, g)
    if quantized:
        params = {k: dict(v, blocks=quantize_blocks(v["blocks"])) if isinstance(v, dict) else v
                  for k, v in params.items()}
    aux = embed_classnames(params["text"], cocoop_names(COCOOP_N_CLS), 4,
                           "a photo of a").as_device_tree()
    trainable = {"ctx": ctx_vectors_from_init(params["text"], "a photo of a", 4),
                 "meta_net": {"linear1": init_linear(g, cfg.embed_dim, cfg.embed_dim // 16),
                              "linear2": init_linear(g, cfg.embed_dim // 16,
                                                     cfg.transformer_width)}}
    for t in leaves(trainable):
        t.requires_grad_(True)
    res = cfg.image_resolution
    images = torch.randn(COCOOP_B, res, res, 3, generator=g, device=dev)
    labels = torch.randint(0, COCOOP_N_CLS, (COCOOP_B,), generator=g, device=dev)
    S = aux["token_prefix"].shape[1] + 4 + aux["token_suffix"].shape[1]
    P = -(-S // 8) * 8
    if (_auto_pack_g(P, COCOOP_B * COCOOP_N_CLS), P) != COCOOP_PACK or not _text_saves_off(
            COCOOP_B * COCOOP_N_CLS, P):
        raise AssertionError(f"CoCoOp fp32 text rows: P {P}; expected {COCOOP_PACK}, saves off")
    names = leaf_names(trainable)

    def run(chunk: int = -1, taps=None):
        with layers.quantized(quant), taps or contextlib.nullcontext():
            logits = cocoop_forward(trainable, params, aux, images, clip_cfg=cfg,
                                    compute_dtype=torch.float32, encode_chunk=chunk)
            grads = torch.autograd.grad(nll_loss(logits, labels), leaves(trainable))
        check_leaf_grads(names, grads)
        return logits.detach(), grads

    label = f"CoCoOp fp32{' ' + quant if quantized else ''} step"
    taps = TextTaps() if quantized else None
    F.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, grads = run(taps=taps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(F.LAUNCHES)
    check_launches(label, launches, in_fp32(F, cocoop_launches(F.LAUNCHES, cfg, 1, quant)))
    only = check_fp32_launches(F, label, launches, quant=quantized)
    with plain_blocks():
        logits_ref, grads_ref = run()
    centred = [t - t.mean(-1, keepdim=True) for t in (logits, logits_ref)]
    if quantized:  # a flipped code sets the distance: [cocoop int8]'s limits
        max_limit, norm_limit = LOGITS_MAX_ERR * Q8_STEP, LOGITS_NORM_ERR * Q8_STEP
        grad_lim = ZOO_GRAD_LIMITS["CoCoOp"][0]
    else:
        max_limit, norm_limit, grad_lim = F32_CHAIN_MAX_ERR, F32_CHAIN_NORM_ERR, F32_CHAIN_NORM_ERR
    reading = check_f32(f"{label} logits, rows centred", *centred, norm_limit=norm_limit,
                        max_limit=max_limit)
    errs = [((a - b).norm() / b.norm()).item() for a, b in zip(grads, grads_ref)]
    if not max(errs) <= grad_lim:
        raise AssertionError(f"{label} gradients: relative norm errors {errs} over {grad_lim}")
    key = f"fp32_{quant + '_' if quantized else ''}cocoop_step"
    out = {key: launches}
    chunked = ""
    if quantized:
        F.reset_launches()
        taps_c = TextTaps()
        logits_c, grads_c = run(COCOOP_CHUNK, taps_c)
        n_chunks = -(-COCOOP_B // COCOOP_CHUNK)
        out[key + "_chunked"] = dict(F.LAUNCHES)
        check_launches(f"{label}, chunks of {COCOOP_CHUNK}", out[key + "_chunked"],
                       in_fp32(F, cocoop_launches(F.LAUNCHES, cfg, n_chunks, quant)))
        cause = chunk_cause(taps.by_site(), taps_c.by_site(), quant)
        try:
            equal = check_bit_equal(f"{label} chunked vs unchunked", (logits_c, *grads_c),
                                    (logits, *grads))
        except AssertionError as e:
            errs_c = [((a - b).norm() / b.norm()).item() for a, b in zip(grads_c, grads)]
            raise AssertionError(f"{e}; gradient relative norm errors {errs_c}; {cause}") from e
        chunked = (f"; chunks of {COCOOP_CHUNK} vs unchunked: logits and gradients {equal}; "
                   + cause)
        del taps, taps_c
    say(phase, f"CoCoOp ViT-B/16 fp32{' under ' + quant if quantized else ''}, {COCOOP_B} "
               f"images x {COCOOP_N_CLS} classes (text rows packed {COCOOP_PACK}, D = 512, "
               f"saves off): one step {ms:.1f} ms (first call), peak "
               f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {only}; vs plain "
               f"route: logits {reading}; gradients " + ", ".join(
                   f"{n} {e:.3g}" for n, e in zip(names, errs)) + f" (limit {grad_lim:.3g})"
               + chunked)
    return out


def fp32_cli_run(F, root: Path, out: str, phase: str, quant: str = "none") -> dict:
    """``python -m mudpt_torch.train`` under PREC fp32 (and TRAIN.QUANT
    ``quant``) at [engine]'s configuration, one epoch and the test
    evaluate, in a fresh process: its launches, fp32 kernels only."""
    more = () if quant == "none" else ("TRAIN.QUANT", quant)
    argv = ["--trainer", "MuDPT", "--trainer_config", str(root / ENGINE_FILES[1]),
            "--dataset_config", str(root / ENGINE_FILES[0]), "--output_dir", out,
            "--backbone_path", "random", *ENGINE_OPTS, "OPTIM.MAX_EPOCH", "1", *FP32_OPTS, *more]
    proc = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--cli-launches",
                           *argv], cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "=> result on test" not in proc.stdout:
        raise AssertionError(f"fp32 CLI run ({quant}): exit {proc.returncode}, no test result\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rec = _json_line(proc.stdout)
    if rec["compute_dtype"] != "torch.float32":
        raise AssertionError(f"fp32 CLI run computed in {rec['compute_dtype']}")
    result = next(ln for ln in proc.stdout.splitlines() if "=> result on test" in ln)
    say(phase, f"python -m mudpt_torch.train --trainer MuDPT ... TRAINER.MUDPT.PREC fp32 "
               f"{' '.join(more)} (one epoch of 384 images, batch 64, and the test evaluate) "
               f"in a fresh process: exit 0, {rec['seconds']:.1f} s; {result.strip()}; "
               + check_fp32_launches(F, f"fp32 CLI run ({quant})", rec["launches"],
                                     quant=quant != "none"))
    return rec["launches"]


def fp32_timed(tr, batch, n: int) -> tuple:
    """(median step ms over ``n`` steps after one warm-up, peak GiB) of the
    trainer's step on a resident batch."""
    import torch

    tr._train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = [_synced_ms(lambda: tr._train_step(batch)) for _ in range(n)]
    return statistics.median(ms), torch.cuda.max_memory_allocated() / 2 ** 30


def phase_fp32(F, root: Path) -> dict:
    """MuDPT ViT-B/16 under PREC fp32: the CLI as a subprocess (one epoch and
    its evaluate, [engine]'s configuration) with its launches by route;
    build_trainer's first step (loss and every trainable leaf's gradient)
    and the evaluate's logits against plain_blocks(); CoCoOp's step; then
    the step at 64 and 384 and the image encode at 384, timed beside the
    same trainer's in bf16 (PREC fp16), with peak memory.  Returns each
    path's launches and the timed fp32 row ((ms, GiB) of the step at 64, at
    384 and of the encode at 384)."""
    import copy
    import shutil
    import tempfile

    import torch

    from mudpt_torch.models.layers import plain_blocks

    phase, paths = "fp32", {}
    tmp = tempfile.mkdtemp(prefix="mudpt_fp32_")
    try:
        # ---- the CLI, a fresh process
        paths["fp32_cli_run"] = fp32_cli_run(F, root, f"{tmp}/cli", phase)

        # ---- build_trainer in this process: the first step and the evaluate
        tr = _engine_trainer(root, f"{tmp}/fp32", "OPTIM.MAX_EPOCH", "1", *FP32_OPTS)
        if tr.compute_dtype != torch.float32:
            raise AssertionError(f"PREC fp32 trainer computes in {tr.compute_dtype}")
        cfg = tr.clip_cfg
        batches = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]
        r = fp32_grads(F, tr, batches[0])
        want = in_fp32(F, step_launches(F, cfg, "full_train", "full_train"))
        check_launches("fp32 train step", r["launches"], want)
        paths["fp32_train_step"] = r["launches"]
        say(phase, f"the trainer's first step, batch of {ENGINE_BATCH}, vs plain_blocks() in "
                   f"fp32: {hold_fp32_grads('fp32 first step', r)}; "
                   + check_fp32_launches(F, "fp32 train step", r["launches"]))
        images = batches[0]["image"]
        F.reset_launches()
        with torch.no_grad():
            txt = tr._text_features(tr.trainable, tr.frozen, tr.aux)
            logits = tr.forward_image(tr.trainable, tr.frozen, tr.aux, images, txt)
            paths["fp32_evaluate_batch"] = dict(F.LAUNCHES)
            with plain_blocks():
                txt_ref = tr._text_features(tr.trainable, tr.frozen, tr.aux)
                logits_ref = tr.forward_image(tr.trainable, tr.frozen, tr.aux, images, txt_ref)
        want = in_fp32(F, expect(F.LAUNCHES, (cfg.transformer_layers, "full"), (1, tower_lns(1)),
                                 (cfg.vision_layers, "full"), (1, tower_lns(2))))
        check_launches("fp32 evaluate", paths["fp32_evaluate_batch"], want)
        centred = [t[:, :tr.num_classes] - t[:, :tr.num_classes].mean(-1, keepdim=True)
                   for t in (logits, logits_ref)]
        say(phase, "the evaluate's text encode and a batch of 64, logits rows centred vs "
                   "plain_blocks(): " + check_f32("fp32 evaluate logits", *centred,
                                                  norm_limit=F32_CHAIN_NORM_ERR,
                                                  max_limit=F32_CHAIN_MAX_ERR)
                   + "; " + check_fp32_launches(F, "fp32 evaluate",
                                                paths["fp32_evaluate_batch"], backward=False))
        del logits, logits_ref, txt_ref

        # ---- CoCoOp at 1,000 classes in fp32
        paths.update(fp32_cocoop_step(F))
        torch.cuda.empty_cache()

        # ---- timed: the step at 64 and on epoch 1's 384 images as one
        # batch, the image encode at 384, fp32 beside the same trainer in
        # bf16 (the YAML's PREC fp16)
        del batches
        rows = {}
        for prec in ("fp32", "fp16"):
            t = tr if prec == "fp32" else _engine_trainer(root, f"{tmp}/{prec}",
                                                           "OPTIM.MAX_EPOCH", "1")
            bs = [t._device_batch(b) for b in list(copy.copy(t.dm.train_loader))]
            whole = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
            n_img = whole["image"].shape[0]
            step64 = fp32_timed(t, bs[0], TIMED_STEPS)
            step384 = fp32_timed(t, whole, FP32_TIMED_STEPS if prec == "fp32" else TIMED_STEPS)
            with torch.no_grad():
                txt = t._text_features(t.trainable, t.frozen, t.aux)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                enc = [_synced_ms(lambda: t._eval_step_cached(t.trainable, t.frozen, t.aux,
                                                              whole["image"], txt))
                       for _ in range(1 + FP32_TIMED_STEPS)][1:]
                enc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rows[prec] = (step64, step384, (statistics.median(enc), enc_peak))
            del t, bs, whole, txt
            torch.cuda.empty_cache()
        (s64, s384, enc), (h64, h384, henc) = rows["fp32"], rows["fp16"]
        say(phase, f"timed (median ms, peak GiB), fp32 vs bf16: trainer step at "
                   f"{ENGINE_BATCH} {s64[0]:.2f} ({s64[1]:.2f} GiB) vs {h64[0]:.2f} "
                   f"({h64[1]:.2f}); step at {n_img} {s384[0]:.2f} ({s384[1]:.2f} GiB, "
                   f"{FP32_TIMED_STEPS} steps) vs {h384[0]:.2f} ({h384[1]:.2f}); image encode "
                   f"and logits at {n_img} {enc[0]:.2f} ({enc[1]:.2f} GiB), "
                   f"{n_img / enc[0] * 1e3:.1f} images/s, vs {henc[0]:.2f} ({henc[1]:.2f}), "
                   f"{n_img / henc[0] * 1e3:.1f} images/s; fp32 / bf16: step "
                   f"{s384[0] / h384[0]:.1f}x, encode {enc[0] / henc[0]:.1f}x")
        return paths, rows["fp32"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [fp32 int8]: the int8 tiers on fp32 activations, rows 14-17 under PREC
# fp32.  Their kernels at ViT-B/16's and ViT-L/14's vision rows:
# LayerNorm-quant (rows, D, static), and every s8 epilogue with and without
# the saved h; the last two fields of a GEMM case: its launches in one
# vision layer of the fp32 int8_ste and of the fp32 int8_ste_static step at
# ViT-B/16, whose quantization-aware forward saves h at D = 768
F32_Q8_LN = tuple((M, D, static) for M, D in ((M_B, 768), (M_L, 1024))
                  for static in (False, True))
F32_Q8_GEMM = tuple(
    (f"{kind}_{ep}", M, K, N, save,
     *((n * (M == M_B), 0) if kind == "q8" else (0, n * (M == M_B))))
    for M, D in ((M_B, 768), (M_L, 1024)) for kind in ("q8", "q8s")
    for ep, K, N, save, n in (("qkv", D, 3 * D, False, 1), ("residual", D, D, False, 1),
                              ("fc_gelu", D, 4 * D, False, 0),
                              ("fc_gelu", D, 4 * D, True, 1),
                              ("residual", 4 * D, D, False, 1)))
# the q8 chains on fp32 x: label, B, S, D, heads (unmasked vision rows; the
# quantization-aware layer saves at both: D <= 768, and D = 1024 within the
# wide-MLP row-token budget)
F32_Q8_CHAINS = (("ViT-B/16 vision", BATCH, 199, 768, 12),
                 ("ViT-L/14 vision", GRAD_BATCH, 259, 1024, 16))
# the fp32 trainer's first step under a quantization-aware tier against the
# plain route: the loss at a batch of 64 moves with each flipped code (the
# fp32 sums of the LayerNorm statistics and of attention run in another
# order, and a value next to a boundary of the int8 grid takes the
# neighbouring code), as test_torch_zoo_quant.py's loss bound of 2^-7 allows
# at tiny size; the gradients keep [train int8_ste]'s limits
F32_Q8_LOSS_REL_ERR = 2.0 ** -7
def int_mm_epilogue(a, xs, wq, ws, bias, ep, extra, r, save, dtype):
    """torch._int_mm followed by the s8 GEMM's epilogue on torch ops: a
    yardstick of gemm_s8_epilogue_f32, never called by the port."""
    import torch

    v = torch._int_mm(a, wq.t()).float()
    if xs is not None:
        v = v * xs
    v = v * ws + bias
    if ep.endswith("qkv"):
        return v
    if ep.endswith("residual"):
        return extra + v
    g = v * torch.sigmoid(1.702 * v)
    if ep == "q8s_fc_gelu":
        g = torch.round(g * r).clamp(-127, 127).to(torch.int8)
    return (v, g) if save else g


def phase_kernels_fp32_int8(F, Q, kq: dict, kqs: dict) -> None:
    """The int8 tiers' kernels on fp32 activations against their plain
    versions at ViT-B/16's and ViT-L/14's vision rows (``F32_Q8_LN``,
    ``F32_Q8_GEMM``): layernorm_q8_f32, dynamic and static (codes within a
    step, scales within LN_SCALE_ERR); gemm_s8_epilogue_f32 in every mode,
    with and without the saved h (qkv, R + v and h bit-equal, g and the
    static codes held as the bf16 kernel's are); each launched twice,
    bit-equal; timed beside its plain version and torch._int_mm (alone, the
    library yardstick, and with its epilogue on torch ops), with the bound
    from bytes and operations, added to ``kq`` (``kqs``) per vision layer
    of the fp32 int8_ste (int8_ste_static) step at ViT-B/16."""
    import torch

    tag, f32 = "fp32 int8", torch.float32
    rn = randn_fn(16)
    one = lambda v: torch.full((), v, dtype=f32, device="cuda")  # noqa: E731

    for rows, D, static in F32_Q8_LN:
        x = rn(rows, D, std=2.0, dtype=f32)
        sc = rn(D, dtype=f32) * 0.1 + 1
        b = rn(D, dtype=f32) * 0.1
        r = one(127.0) / F.layer_norm_plain(x, sc, b).abs().amax() if static else None
        what = f"layernorm_q8_f32 {rows}x{D} {'static' if static else 'dynamic'}"
        kern = (kqs if static else kq)["layernorm_q8_f32"]
        (q, s), (q_ref, s_ref) = Q.ln_quant(x, sc, b, r), Q.ln_quant_plain(x, sc, b, r)
        reading = check_codes(what, q, q_ref, kern)
        if not static:
            reading += "; scales " + check_close(f"{what} scales", s, s_ref,
                                                 max_limit=LN_SCALE_ERR, norm_limit=LN_SCALE_ERR,
                                                 share_limit=None)
        del q, s, q_ref, s_ref
        check_relaunch(what, lambda: tuple(t for t in Q.ln_quant(x, sc, b, r) if t is not None))
        ms = time_ms(lambda: Q.ln_quant(x, sc, b, r))
        plain = time_ms(lambda: Q.ln_quant_plain(x, sc, b, r), 3)
        bms, by = bound(rows * D * 5 + (0 if static else rows * 4) + 2 * D * 4, 0, 12 * rows * D)
        say(tag, f"{what}: {reading} ms {ms:.4f} plain {plain:.4f} library none "
                 f"bound {bms:.4f} ({by})")
        if rows == M_B:
            _per_layer((kern,), (2,), ms, plain, None, bms, by)
        del x

    for ep, M, K, N, save, n_dyn, n_st in F32_Q8_GEMM:
        static = ep.startswith("q8s_")
        kern = (kqs if static else kq)["gemm_s8_epilogue_f32"]
        what = f"gemm_s8_epilogue_f32 {ep}{' save h' if save else ''} {M}x{K}->{N}"
        args, reading = s8_case(Q, rn, ep, M, K, N, save, kern, f32)
        check_relaunch(what, lambda: Q.gemm_s8(*args))
        a, wq, extra = args[0], args[2], args[6]
        ms = time_ms(lambda: Q.gemm_s8(*args))
        plain = time_ms(lambda: Q.gemm_s8_plain(*args), 3)
        lib = time_ms(lambda: torch._int_mm(a, wq.t()))  # int32 out, no epilogue
        lib_ep = time_ms(lambda: int_mm_epilogue(*args))
        out_bytes = 1 if ep == "q8s_fc_gelu" else 4
        nbytes = (M * K + N * K + M * N * (out_bytes + (4 if extra is not None or save else 0))
                  + (0 if static else M * 4) + N * 8)
        e_ops = Q8_EPILOGUE_OPS[ep.split("_", 1)[1]] - static
        bms, by = bound(nbytes, 0, e_ops * M * N, 2 * M * N * K)
        say(tag, f"{what}: {reading} ms {ms:.4f} ({2 * M * N * K / ms / 1e9:.1f} TOP/s) "
                 f"plain {plain:.4f} library(torch._int_mm) {lib:.4f}, with its epilogue on "
                 f"torch ops {lib_ep:.4f} bound {bms:.4f} ({by})")
        _per_layer((kq["gemm_s8_epilogue_f32"], kqs["gemm_s8_epilogue_f32"]), (n_dyn, n_st), ms,
                   plain, lib, bms, by)
        del a, wq, extra, args
    torch.cuda.empty_cache()
    # the ragged tile edges: N = 784 leaves a tile's second column half
    # outside the matrix, N = 912 cuts it at 16 columns
    M, K, _ = S8_RAGGED_MKN
    for N in (S8_RAGGED_MKN[2], 912):
        for ep, save in S8_RAGGED:
            _, reading = s8_case(Q, rn, ep, M, K, N, save, dtype=f32)
            say(tag, f"gemm_s8_epilogue_f32 {ep}{' save h' if save else ''} {M}x{K}->{N}: "
                     f"{reading}")


def phase_fp32_q8_chains(F, Q, layers) -> dict:
    """Rows 14-17 on fp32 x (``F32_Q8_CHAINS``): the dynamic and the static
    serving layer, the saving forwards (y1, qkv and h in fp32, y bit-equal
    to the serving layer's) and the two quantization-aware Functions'
    forward and backward, each against the plain chain on the card under
    the bf16 int8 chains' limits (a flipped code, not fp32 rounding, sets
    the distance), each call's launches those of the bf16 q8 chain with
    every kernel mapped to its fp32 counterpart (no bf16 kernel launched),
    timed beside the plain chain with the fp32 bound (``chain_bound``: the
    forward's projections at the int8 peak, every other product 3xTF32).
    Returns the quantization-aware layers' launches."""
    import torch

    tag, f32 = "fp32 int8", torch.float32
    rn = randn_fn(17)
    out = {}

    def fp32_only(what, *ts):
        if any(t.dtype != f32 for t in ts):
            raise AssertionError(f"{what}: {[t.dtype for t in ts]}, not fp32")

    for label, B, S, D, H in F32_Q8_CHAINS:
        x = rn(B, S, D, dtype=f32)
        ps = layer_params(rn, D, f32)
        blk = q8_block(ps)
        amax = Q.calibrate(lambda: layers.residual_block(blk, x, H))[0]
        qw = Q.quantize_weights(blk)
        qp = Q._quantize_layer(ps, qw)
        qps, r = Q._quantize_layer_static(ps, amax, qw)
        serve = {}
        for tier, fn, ops, route in (("int8", Q.layer_fullblock_q8, (*qp,), "q8"),
                                     ("int8_static", Q.layer_fullblock_q8_static, (*qps, r),
                                      "q8s")):
            what = f"{tier} layer {label}, fp32"
            F.reset_launches()
            y = fn(x, *ops, H)
            check_launches(what, dict(F.LAUNCHES), in_fp32(F, expect(F.LAUNCHES, (1, route))))
            y_ref = fn(x, *ops, H, plain=True)
            fp32_only(what, y)
            reading = check_close(what, y, y_ref, share_limit=None)
            serve[tier] = y
            ms = time_ms(lambda: fn(x, *ops, H))
            plain = time_ms(lambda: fn(x, *ops, H, plain=True), 2)
            say(tag, f"{what} B={B} S={S} D={D}: {reading} ms {ms:.4f} plain {plain:.4f} "
                     f"{chain_bound(B, S, D, False, int8=True, fp32=True)}; "
                     f"launches {json.dumps({k: v for k, v in F.LAUNCHES.items() if v})}")
            rs = None if tier == "int8" else r
            qq = qp if rs is None else qps
            got = Q.q8_save_forward(x, qq, H, False, rs)
            ref = Q.q8_save_forward(x, qq, H, False, rs, plain=True)
            fp32_only(f"{tier} saving forward {label}", *got)
            check_equal(f"{tier} saving forward {label}: y vs the serving forward", got[0], y)
            readings = [f"{n} " + check_close(f"{tier} saving forward {label} {n}, fp32", g, w,
                                              share_limit=None)
                        for n, g, w in zip(("y", "y1", "qkv", "h"), got, ref)]
            say(tag, f"{tier} saving forward {label}, fp32 (y1, qkv, h fp32; y bit-equal to "
                     f"the serving layer's): " + "; ".join(readings))
            del y, y_ref, got, ref

        xg = x.detach().requires_grad_(True)
        gy = rn(B, S, D, dtype=f32)
        for tier in ("int8_ste", "int8_ste_static"):
            def step(plain_fns):
                if tier == "int8_ste":
                    y = Q.layer_fullblock_q8_ste(xg, *ps, H, False, plain_fns, qw)
                else:
                    y = Q.layer_fullblock_q8_ste_static(xg, amax, *ps, H, False, plain_fns, qw)
                return y, torch.autograd.grad(y, xg, gy)[0]

            route = qat_route(F, D, B * S, tier)
            what = f"{tier} {label}, fp32 ({route})"
            F.reset_launches()
            y, dx = step(False)
            launches = dict(F.LAUNCHES)
            check_launches(what, launches, in_fp32(F, expect(F.LAUNCHES, (1, route))))
            out[f"fp32_{tier}_layer_D{D}"] = launches
            (y_ref, dx_ref) = step(True)
            fp32_only(what, y, dx)
            served = serve["int8" if tier == "int8_ste" else "int8_static"]
            check_equal(f"{what}: y vs the serving forward", y.detach(), served)
            r_y = check_close(f"{what} y", y, y_ref, share_limit=None)
            r_dx = check_close(f"{what} dx", dx, dx_ref, max_limit=LAYER_DX_MAX_ERR,
                               norm_limit=LAYER_DX_NORM_ERR, share_limit=None)
            del y, dx, y_ref, dx_ref
            ms = time_ms(lambda: step(False), 5)
            plain = time_ms(lambda: step(True), 1)
            say(tag, f"{what} forward + backward: y {r_y}; dx {r_dx}; ms {ms:.4f} plain "
                     f"{plain:.4f} {chain_bound(B, S, D, False, bwd=True, int8=True, fp32=True)}; "
                     f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        del x, xg, gy, ps, blk, qw, qp, qps, serve
        torch.cuda.empty_cache()
    return out


def phase_fp32_int8(F, root: Path, unquantized: tuple) -> dict:
    """MuDPT ViT-B/16 under PREC fp32 and each int8 tier, [engine]'s
    configuration: the CLI under int8_ste in a fresh process (fp32 q8
    kernels only); through build_trainer, under int8_ste and
    int8_ste_static the first step's loss and gradients against the plain
    route (and the fp32 unquantized model), a traced step, the step at 64
    and 384 and the encode at 384 beside ``unquantized``, [fp32]'s timed
    row (the same tiers in bf16 are timed by [train int8_ste*] and
    [serving int8*]); under int8 and int8_static (calibrated at build) the
    evaluate's logits against the plain route and the encode at 384;
    CoCoOp ViT-B/16 at 1,000 classes under int8_ste; the zero-shot
    pallas_int8 artifact at the default fp32 served in a fresh process, and
    an fp32 trainer's pallas and pallas_int8 artifacts served in this
    process.  Returns each path's launches."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mudpt_torch import serving
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.zsclip import _encode_templates, _zs_inference

    phase, paths = "fp32 int8", {}
    tmp = tempfile.mkdtemp(prefix="mudpt_fp32_int8_")
    try:
        paths["fp32_int8_ste_cli_run"] = fp32_cli_run(F, root, f"{tmp}/cli", phase, "int8_ste")

        def encode_ms(t, images):
            with torch.no_grad():
                txt = t._text_features(t.trainable, t.frozen, t.aux)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                enc = [_synced_ms(lambda: t._eval_step_cached(t.trainable, t.frozen, t.aux,
                                                              images, txt))
                       for _ in range(1 + FP32_TIMED_STEPS)][1:]
            return statistics.median(enc), torch.cuda.max_memory_allocated() / 2 ** 30

        # ---- the quantization-aware tiers, timed beside unquantized fp32
        u64, u384, uenc = unquantized
        for tier in ("int8_ste", "int8_ste_static"):
            t0 = time.perf_counter()
            tr = _engine_trainer(root, f"{tmp}/{tier}", "OPTIM.MAX_EPOCH", "1",
                                 "TRAIN.QUANT", tier, *FP32_OPTS)
            build_s = time.perf_counter() - t0
            if tr.compute_dtype != torch.float32:
                raise AssertionError(f"PREC fp32 {tier} trainer computes in {tr.compute_dtype}")
            cfg, route = tr.clip_cfg, Q8_ROUTES[tier]
            bs = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]
            whole = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
            n_img = whole["image"].shape[0]
            want = in_fp32(F, step_launches(F, cfg, route, route))
            grad_check(F, ds_step_case(tr, bs[0])[0], phase,
                       f"PREC fp32 {tier} (built in {build_s:.1f} s): the trainer's first "
                       f"step, batch {ENGINE_BATCH}", want, loss_limit=F32_Q8_LOSS_REL_ERR)
            F.reset_launches()
            if tier == "int8_ste":
                traced(phase, lambda: tr._train_step(bs[0]), device_time_by_kernel)
            else:
                tr._train_step(bs[0])
            launches = dict(F.LAUNCHES)
            check_launches(f"PREC fp32 {tier} step", launches, want)
            paths[f"fp32_{tier}_train_step"] = launches
            say(phase, f"PREC fp32 {tier} step: " + check_fp32_launches(
                F, f"PREC fp32 {tier} step", launches, quant=True))
            s64 = fp32_timed(tr, bs[0], TIMED_STEPS)
            s384 = fp32_timed(tr, whole, FP32_TIMED_STEPS)
            enc = encode_ms(tr, whole["image"])
            say(phase, f"timed PREC fp32 {tier} (median ms, peak GiB) beside unquantized fp32 "
                       f"([fp32] in this run): trainer step at {ENGINE_BATCH} {s64[0]:.2f} "
                       f"({s64[1]:.2f} GiB) vs {u64[0]:.2f} ({u64[1]:.2f}); step at {n_img} "
                       f"{s384[0]:.2f} ({s384[1]:.2f} GiB, {FP32_TIMED_STEPS} steps) vs "
                       f"{u384[0]:.2f} ({u384[1]:.2f}); image encode and logits at {n_img} "
                       f"(the tier's serving chain) {enc[0]:.2f} ({enc[1]:.2f} GiB), "
                       f"{n_img / enc[0] * 1e3:.1f} images/s, vs {uenc[0]:.2f} ({uenc[1]:.2f});"
                       f" {tier} / unquantized: step {s384[0] / u384[0]:.3f}x, encode "
                       f"{enc[0] / uenc[0]:.3f}x; {time.perf_counter() - t0:.1f} s")
            del tr, bs, whole
            torch.cuda.empty_cache()

        # ---- the serving tiers: the evaluate's logits, the encode at 384
        for tier in ("int8", "int8_static"):
            t0 = time.perf_counter()
            tr = _engine_trainer(root, f"{tmp}/{tier}", "OPTIM.MAX_EPOCH", "1",
                                 "TRAIN.QUANT", tier, *FP32_OPTS)
            build_s = time.perf_counter() - t0
            cfg, route = tr.clip_cfg, Q8_ROUTES[tier]
            if tr.compute_dtype != torch.float32 or (
                    tier == "int8_static") != getattr(tr, "_static_calibrated", False):
                raise AssertionError(f"PREC fp32 {tier} trainer: {tr.compute_dtype}, "
                                     f"calibrated {getattr(tr, '_static_calibrated', False)}")
            bs = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]
            images = bs[0]["image"]
            F.reset_launches()
            with torch.no_grad():
                txt = tr._text_features(tr.trainable, tr.frozen, tr.aux)
                logits = tr.forward_image(tr.trainable, tr.frozen, tr.aux, images, txt)
                launches = dict(F.LAUNCHES)
                with plain_blocks():
                    txt_ref = tr._text_features(tr.trainable, tr.frozen, tr.aux)
                    logits_ref = tr.forward_image(tr.trainable, tr.frozen, tr.aux, images,
                                                  txt_ref)
            want = in_fp32(F, expect(F.LAUNCHES, (cfg.transformer_layers, route),
                                     (1, tower_lns(1)), (cfg.vision_layers, route),
                                     (1, tower_lns(2))))
            check_launches(f"PREC fp32 {tier} evaluate", launches, want)
            paths[f"fp32_{tier}_evaluate_batch"] = launches
            centred = [t[:, :tr.num_classes] - t[:, :tr.num_classes].mean(-1, keepdim=True)
                       for t in (logits, logits_ref)]
            reading = check_close(f"PREC fp32 {tier} logits, rows centred", *centred,
                                  max_limit=LOGITS_MAX_ERR * Q8_STEP,
                                  norm_limit=LOGITS_NORM_ERR * Q8_STEP, share_limit=None)
            whole = torch.cat([b["image"] for b in bs])
            enc = encode_ms(tr, whole)
            say(phase, f"PREC fp32 {tier} (built in {build_s:.1f} s"
                       f"{', calibrated at build' if tier == 'int8_static' else ''}): the "
                       f"evaluate's text encode and a batch of {ENGINE_BATCH}, vs "
                       f"plain_blocks(), logits rows centred: {reading}; "
                       + check_fp32_launches(F, f"PREC fp32 {tier} evaluate", launches,
                                             backward=False, quant=True)
                       + f"; image encode and logits at {whole.shape[0]} {enc[0]:.2f} ms "
                         f"({enc[1]:.2f} GiB), {whole.shape[0] / enc[0] * 1e3:.1f} images/s")
            del tr, bs, images, whole, txt, logits, txt_ref, logits_ref
            torch.cuda.empty_cache()

        # ---- CoCoOp at 1,000 classes under int8_ste
        paths.update(fp32_cocoop_step(F, quant="int8_ste"))
        torch.cuda.empty_cache()

        # ---- the fp32 artifacts: the zero-shot pallas_int8 one at its
        # default compute dtype, served in a fresh process; an fp32 trainer's
        # pallas and pallas_int8 ones, served in this process
        tr = _engine_trainer(root, f"{tmp}/export", "OPTIM.MAX_EPOCH", "1", *FP32_OPTS)
        cfg = tr.clip_cfg
        images = tr._device_batch(next(iter(copy.copy(tr.dm.train_loader))))["image"]
        np.save(f"{tmp}/images.npy", images.cpu().numpy())
        serve_want = in_fp32(F, expect(F.LAUNCHES, (cfg.vision_layers, "q8"), (1, tower_lns(2))))
        templates = ["a photo of a {}.", "a drawing of a {}."]
        t0 = time.perf_counter()
        serving.export_zero_shot(f"{tmp}/zs_q8", cfg, tr.frozen, tr.classnames, templates,
                                 batch=images.shape[0], block_impl="pallas_int8")
        export_s = time.perf_counter() - t0
        with serving._block_impl("xla"):
            txt = _encode_templates(tr.frozen, cfg, list(tr.classnames), templates,
                                    torch.float32, images.device)
        with torch.no_grad(), serving._block_impl("pallas_int8"):
            ref = _zs_inference(None, serving._quantize_visual(tr.frozen),
                                {"text_features": txt}, images, clip_cfg=cfg,
                                compute_dtype=torch.float32).float()
        logits, child, process_s = served_fresh(root, f"{tmp}/zs_q8", f"{tmp}/images.npy",
                                                "zero-shot pallas_int8")
        check_launches("the zero-shot pallas_int8 artifact's request", child["launches"],
                       serve_want)
        paths["fp32_zero_shot_pallas_int8_request"] = child["launches"]
        say(phase, f"zero-shot pallas_int8 artifact, compute dtype fp32 (the default), batch "
                   f"{images.shape[0]}: exported in {export_s:.2f} s; fresh process "
                   f"{process_s:.2f} s; vs the tier in this process: "
                   + check_bit_equal("the zero-shot pallas_int8 artifact", (logits,), (ref,))
                   + "; " + check_fp32_launches(F, "zero-shot artifact", child["launches"],
                                                backward=False, quant=True)
                   + f"; a request there {child['request_ms']:.2f} ms")
        with torch.no_grad():
            txt = tr._text_features(tr.trainable, tr.frozen, tr.aux)
            own = tr.forward_image(tr.trainable, tr.frozen, tr.aux, images, txt)[
                :, :tr.num_classes].float()
        for tier in ("pallas", "pallas_int8"):
            art = f"{tmp}/{tier}"
            serving.export_trainer(art, tr, batch=images.shape[0], block_impl=tier)
            clf = serving.load(art)
            F.reset_launches()
            got = clf.forward(images)
            torch.cuda.synchronize()
            launches = dict(F.LAUNCHES)
            if tier == "pallas":
                want, ref_name, ref = (in_fp32(F, expect(F.LAUNCHES, (cfg.vision_layers, "full"),
                                                         (1, tower_lns(2)))),
                                       "the trainer's own evaluate", own)
            else:
                score, ops, _ = serving.trainer_program(tr, block_impl=tier)
                with torch.no_grad(), serving._block_impl(tier):
                    ref = score(ops, images)
                want, ref_name = serve_want, "the tier in this process"
                del score, ops
            check_launches(f"the fp32 trainer's {tier} artifact", launches, want)
            paths[f"fp32_{tier}_artifact_request"] = launches
            say(phase, f"the fp32 MuDPT trainer's {tier} artifact, loaded and served in this "
                       f"process, vs {ref_name}: "
                       + check_bit_equal(f"fp32 {tier} artifact", (got,), (ref,)) + "; "
                       + check_fp32_launches(F, f"fp32 {tier} artifact", launches,
                                             backward=False, quant=tier == "pallas_int8"))
            del clf, got
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [probes]: the rate kernel's bf16 sums on the probe's normal draws run in
# another order than the plain version's (each block's share of the 1,024
# slice products at G 64 in the tensor cores' fp32 accumulators, then 11
# atomic adds, against the slices' sum added once a step): 786,432 products
# an element, about 250 times the GEMM's longest K, so the fp32 limits grow
# by 2^4 over F32_MAX_ERR and F32_NORM_ERR (the square root of the ratio
# of the sums' lengths, rounded up), and no element is held bit-equal.  On
# small integers, where every partial sum is an exact fp32 integer in any
# order, the sums are held bit-equal instead
PROBE_BF16_MAX_ERR, PROBE_BF16_NORM_ERR = 2.0 ** -11, 2.0 ** -12
# the q8_static mode's layer: on the probe's unfolded weight scales its qkv
# is 8x the layer's and its scores 64x, so the softmax's inputs carry 64x
# the sum-order differences and the bf16 probabilities round apart far more
# often than in the production chains, whose limits (2^-5, 2^-8) four of
# the other modes meet (reading 0.037 of the largest value and 9.3e-3 in norm;
# tests/test_torch_probes.py reads 1.3e-2 against the JAX probe's kernel):
# the mode times the chain and computes nothing a model uses
PROBE_STATIC_MAX_ERR, PROBE_STATIC_NORM_ERR = 2.0 ** -3, 2.0 ** -5
# the q8_floor mode's layer: its unscaled products put the softmax's inputs
# near 1e5, so the probabilities are one-hot and a near-tie of two scores,
# parted by the order of fp32 sums, sends a row's attention to another key:
# that row of y moves as a whole (reading 0.082 of the largest value, 8.2e-5
# of the elements not bit-equal) while the norm stays within the chains'
# 2^-8 (reading 9.9e-4); timing only, like the static mode
PROBE_FLOOR_MAX_ERR = 2.0 ** -2
# |x|, |w| <= 4: a sum at G = 64 stays below 16 x 768 x 16 x 64 < 2^24
PROBE_INT_RANGE = 4
# positive s8 codes: a step's sum passes 5e7 an element, so at G = 320 every
# output wraps mod 2^32 (in the blocks' int32 registers and in the atomics)
PROBE_WRAP_CODES = (64, 128)
# out-of-range values, infinities and NaN for the floor's convert
PROBE_FLOOR_SPECIALS = (300.0, -300.0, 127.9, -128.9, 1e30, float("inf"), -float("inf"),
                        float("nan"))


def probe_launches(n_layers: int) -> list:
    """The (count, route) parts of ``probe_q8_residual``'s launches: each of
    its six modes' layer route, run for ``n_layers`` layers."""
    parts = [(n_layers, "full"), (n_layers, "q8"), (n_layers, "q8s")]
    for m in ("recip", "noclip", "floor"):
        parts.append((n_layers, {f"layernorm_q8_{m}": 2, f"quant_rows_{m}": 2, "attention_fwd": 1,
                                 "gemm_s8_epilogue_floor" if m == "floor" else
                                 "gemm_s8_epilogue": 4}))
    return parts


def phase_probes(F, Q, kernels: dict) -> dict:
    """The probes of tools/ through their entry points in this process, at
    the JAX probes' shapes, their launches held; then every new kernel
    instance against its plain version, timed beside its bound, into
    ``kernels`` (by launch count: the rate kernel's totals are one call at
    G1, the ablations' one layer of the probe's shape)."""
    import torch

    from mudpt_torch.ops import probe as P
    from mudpt_torch.tools import probe_int8_mxu, probe_q8_residual

    tag = "probes"
    paths = {}
    F.reset_launches()
    mxu = probe_int8_mxu.main([])
    torch.cuda.synchronize()
    paths["probe_int8_mxu"] = dict(F.LAUNCHES)
    F.reset_launches()
    q8r = probe_q8_residual.main([])
    torch.cuda.synchronize()
    paths["probe_q8_residual"] = dict(F.LAUNCHES)
    sh, reps = mxu["shape"], 1 + 4  # the entry point's warm-up and --rep 4
    check_launches("probe_int8_mxu", paths["probe_int8_mxu"],
                   expect(F.LAUNCHES, (1, dict(probe_mma_bf16=2 * reps, probe_mma_s8=2 * reps,
                                                quant_rows=1))))
    lsh = q8r["shape"]
    n_layers = (1 + 6) * (lsh["l1"] + lsh["l2"]) + lsh["l2"]  # --rep 6, then the finite check
    check_launches("probe_q8_residual", paths["probe_q8_residual"],
                   expect(F.LAUNCHES, *probe_launches(n_layers)))
    if not mxu["quant_exact"] or not all(q8r["finite"].values()):
        raise AssertionError(f"probes: quantizer exact {mxu['quant_exact']}, finite towers "
                             f"{q8r['finite']}")
    say(tag, f"probe_int8_mxu: bf16 {mxu['bf16_ops_per_s'] / 1e12:.1f} TFLOP/s "
             f"({mxu['bf16_ops_per_s'] / PEAK_BF16_FLOPS:.3f} of 989), int8 "
             f"{mxu['int8_ops_per_s'] / 1e12:.1f} TOP/s "
             f"({mxu['int8_ops_per_s'] / PEAK_INT8_OPS:.3f} of 1,979), "
             f"{mxu['int8_ops_per_s'] / mxu['bf16_ops_per_s']:.3f}x bf16; G {sh['g1']} / "
             f"{sh['g2']} ms bf16 {mxu['bf16_s'][0] * 1e3:.3f} / {mxu['bf16_s'][1] * 1e3:.3f}, "
             f"int8 {mxu['int8_s'][0] * 1e3:.3f} / {mxu['int8_s'][1] * 1e3:.3f}; yardstick "
             + ", ".join(f"{k} {v / 1e12:.1f} T/s" for k, v in mxu["yardstick_ops_per_s"].items())
             + f"; launches {paths['probe_int8_mxu']['probe_mma_bf16']} + "
             f"{paths['probe_int8_mxu']['probe_mma_s8']}, quant_rows 1")
    B, S, D, H = lsh["B"], lsh["S"], lsh["D"], lsh["H"]
    bounds = [float(chain_bound(B, S, D, False, int8=q).split()[1]) for q in (False, True)]
    tool = [q8r["bound_s"][k] * 1e3 for k in ("bf16", "int8")]
    if any(abs(a - b) > 1e-4 for a, b in zip(bounds, tool)):
        raise AssertionError(f"probe_q8_residual's bound {tool} is not chain_bound's {bounds}")
    say(tag, "probe_q8_residual ms a layer: " + ", ".join(
        f"{m} {v * 1e3:.4f}" for m, v in q8r["per_layer_s"].items()) + "; deltas: " + ", ".join(
        f"{k} {v * 1e3:.4f}" for k, v in q8r["deltas_s"].items())
        + f"; chain_bound bf16 {bounds[0]:.4f}, int8 {bounds[1]:.4f} ms; "
        f"{n_layers} layers a mode")

    # the rate kernel: s8 where int32 wraps, bf16 exact on small integers
    # and within limits on the probe's draws; each timed at G1
    rn = randn_fn(16)
    gen = torch.Generator(device="cuda").manual_seed(17)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    iters, M, K, N, g1, g2 = sh["iters"], sh["S"], sh["D"], sh["DO"], sh["g1"], sh["g2"]
    blocks = P.probe_blocks(M, N, iters * g1, n_sm)
    ops = probe_int8_mxu.operands(M, K, N, iters, "cuda")
    lo, hi = PROBE_WRAP_CODES
    xw = torch.randint(lo, hi, (iters, M, K), generator=gen, device="cuda").to(torch.int8)
    ww = torch.randint(lo, hi, (N, K), generator=gen, device="cuda").to(torch.int8)
    least = P.mma_probe_plain(xw, ww, 1).abs().min().item()  # one step's sums: no wrap
    wraps = least * g2 >= 2 ** 31
    reading = check_equal("probe_mma s8 wrapping", P.mma_probe(xw, ww, g2),
                          P.mma_probe_plain(xw, ww, g2), kernels["probe_mma_s8"])
    reading += "; probe's draws at G1 " + check_equal(
        "probe_mma s8", P.mma_probe(*ops["int8"], g1), P.mma_probe_plain(*ops["int8"], g1))
    if not wraps:
        raise AssertionError(f"probe_mma s8: not every output wraps ({least} x {g2} < 2^31)")
    del xw, ww
    r_ = PROBE_INT_RANGE
    xi = torch.randint(-r_, r_ + 1, (iters, M, K), generator=gen, device="cuda").bfloat16()
    wi = torch.randint(-r_, r_ + 1, (N, K), generator=gen, device="cuda").bfloat16()
    reading_b = "small integers " + check_equal("probe_mma bf16 integers", P.mma_probe(xi, wi, g1),
                                                P.mma_probe_plain(xi, wi, g1),
                                                kernels["probe_mma_bf16"])
    reading_b += "; probe's draws " + check_close(
        "probe_mma bf16", P.mma_probe(*ops["bf16"], g1), P.mma_probe_plain(*ops["bf16"], g1),
        kernels["probe_mma_bf16"], max_limit=PROBE_BF16_MAX_ERR,
        norm_limit=PROBE_BF16_NORM_ERR, share_limit=None)
    del xi, wi
    for dt, rd in (("bf16", reading_b), ("s8", reading)):
        xs, wt = ops["bf16" if dt == "bf16" else "int8"]
        ms = time_ms(lambda: P.mma_probe(xs, wt, g1), 5)
        plain = time_ms(lambda: P.mma_probe_plain(xs, wt, g1), 2)
        work = 2 * M * K * N * iters * g1
        nbytes = xs.numel() * xs.element_size() + wt.numel() * wt.element_size() + M * N * 4
        bms, by = bound(nbytes, work if dt == "bf16" else 0, 0, work if dt == "s8" else 0)
        kernels[f"probe_mma_{dt}"].add(ms, plain, None, bms, by)
        say(tag, f"probe_mma {dt} {iters}x{M}x{K}->{N}, G {g1}: {rd}; ms {ms:.4f} "
                 f"({work / ms / 1e9:.1f} T/s) plain {plain:.4f} library none bound {bms:.4f} "
                 f"({by}); {blocks} blocks on {n_sm} SMs ({blocks / n_sm:.2f} waves, "
                 f"{min(blocks, n_sm)} SMs busy)")
    del ops

    # the quantizer ablations at the probe layer's rows: the attention
    # output (D wide) and g (4 D wide) for quant_rows, LN rows for
    # layernorm_q8, each twice a layer
    rows = B * S
    x_att = rn(rows, D, dtype=torch.float32)
    x_g = rn(rows, 4 * D, dtype=torch.float32) * 200  # g past 127, as the floor's
    specials = rn(1, D, dtype=torch.float32)
    specials[0, :len(PROBE_FLOOR_SPECIALS)] = torch.tensor(PROBE_FLOOR_SPECIALS, device="cuda")
    q_dyn, s_dyn = Q.quantize_rows(x_att)
    for m in ("recip", "noclip", "floor"):
        mode, kern = f"q8_{m}", kernels[f"quant_rows_{m}"]
        readings, ms = [], 0.0
        for x in (x_att, x_g):
            what = f"quant_rows {mode} {rows}x{x.shape[1]}"
            (q, sc), (q_ref, sc_ref) = P.quantize_rows_mode(x, mode), \
                P.quantize_rows_mode_plain(x, mode)
            readings.append(check_equal(what, q, q_ref, kern))
            if sc is not None:
                readings[-1] += "; scales " + check_equal(f"{what} scales", sc, sc_ref)
            t = time_ms(lambda: P.quantize_rows_mode(x, mode))
            plain = time_ms(lambda: P.quantize_rows_mode_plain(x, mode), 3)
            bms, by = bound(x.numel() * 5 + (0 if m == "floor" else rows * 4), 0, 5 * x.numel())
            kern.add(t, plain, None, bms, by)
            ms += t
        if m == "noclip":
            q, sc = P.quantize_rows_mode(x_att, mode)
            readings.append("codes vs q8 " + check_equal("q8_noclip codes vs q8", q, q_dyn)
                            + "; scales " + check_equal("q8_noclip scales vs q8", sc, s_dyn))
        elif m == "recip":
            q = P.quantize_rows_mode(x_att, mode)[0]
            readings.append("codes vs q8 " + check_codes("q8_recip codes vs q8", q, q_dyn))
        else:
            q, q_ref = P.quantize_rows_mode(specials, mode)[0], P.sat_s8(specials)
            readings.append("specials " + check_equal("q8_floor specials", q, q_ref))
            got = q[0, :len(PROBE_FLOOR_SPECIALS)].tolist()
            if got != [127, -128, 127, -128, 127, 127, -128, 0]:
                raise AssertionError(f"quant_rows q8_floor: {PROBE_FLOOR_SPECIALS} -> {got}, "
                                     "not XLA's saturating convert")
            readings.append(f"{PROBE_FLOOR_SPECIALS} -> {got}")
        say(tag, f"quant_rows {mode}: " + "; ".join(readings) + f"; ms a layer {ms:.4f}")
    del x_att, x_g, specials, q_dyn, s_dyn

    x = rn(rows, D, std=2.0)
    sc_ln, b_ln = rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1
    for m in ("recip", "noclip", "floor"):
        mode, kern = f"q8_{m}", kernels[f"layernorm_q8_{m}"]
        (q, sc), (q_ref, sc_ref) = P.ln_quant_mode(x, sc_ln, b_ln, mode), \
            P.ln_quant_mode_plain(x, sc_ln, b_ln, mode)
        reading = check_codes(f"layernorm_q8 {mode}", q, q_ref, kern)
        if sc is not None:
            reading += "; scales " + check_close(f"layernorm_q8 {mode} scales", sc, sc_ref,
                                                 max_limit=LN_SCALE_ERR, norm_limit=LN_SCALE_ERR,
                                                 share_limit=None)
        ms = time_ms(lambda: P.ln_quant_mode(x, sc_ln, b_ln, mode))
        plain = time_ms(lambda: P.ln_quant_mode_plain(x, sc_ln, b_ln, mode), 3)
        bms, by = bound(rows * D * 3 + (0 if m == "floor" else rows * 4) + 2 * D * 4, 0,
                        12 * rows * D)
        _per_layer((kern,), (2,), ms, plain, None, bms, by)
        say(tag, f"layernorm_q8 {mode} {rows}x{D}: {reading}; ms {ms:.4f} plain {plain:.4f} "
                 f"bound {bms:.4f} ({by})")
    del x

    # the floor GEMM's four products of the layer
    kern = kernels["gemm_s8_epilogue_floor"]
    for ep, K_, N_ in (("q8f_qkv", D, 3 * D), ("q8f_residual", D, D),
                       ("q8f_fc_gelu", D, 4 * D), ("q8f_residual", 4 * D, D)):
        a = P.sat_s8(rn(rows, K_, dtype=torch.float32) * 2)
        wq, ws = Q.quantize_cols(rn(K_, N_, std=K_ ** -0.5))
        wq = wq.t().contiguous()
        bias = rn(N_, std=0.1)
        extra = rn(rows, N_) if ep.endswith("residual") else None
        args = (a, None, wq, ws, bias, ep, extra)
        got, ref = Q.gemm_s8(*args), Q.gemm_s8_plain(*args)
        what = f"gemm_s8_epilogue {ep} {rows}x{K_}->{N_}"
        if ep == "q8f_fc_gelu":
            reading = "g " + check_close(what, got, ref, kern, max_limit=F32_MAX_ERR,
                                         norm_limit=F32_NORM_ERR, share_limit=None)
        else:
            reading = check_equal(what, got, ref, kern)
        ms = time_ms(lambda: Q.gemm_s8(*args))
        plain = time_ms(lambda: Q.gemm_s8_plain(*args), 3)
        lib = time_ms(lambda: torch._int_mm(a, wq.t()))  # the yardstick: int32 out, no epilogue
        out_bytes = 4 if ep == "q8f_fc_gelu" else 2
        nbytes = rows * K_ + N_ * K_ + rows * N_ * (out_bytes + (2 if extra is not None else 0)) \
            + N_ * 2
        bms, by = bound(nbytes, 0, (Q8_EPILOGUE_OPS[ep.split("_", 1)[1]] - 2) * rows * N_,
                        2 * rows * N_ * K_)
        kern.add(ms, plain, lib, bms, by)
        say(tag, f"{what}: {reading}; ms {ms:.4f} ({2 * rows * N_ * K_ / ms / 1e9:.1f} TOP/s) "
                 f"plain {plain:.4f} library(torch._int_mm) {lib:.4f} bound {bms:.4f} ({by})")
        del a, wq, extra, args, got, ref

    # each mode's layer against its plain version
    params = probe_q8_residual.layer_params(D, "cuda")
    x = torch.randn(B, S, D, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").bfloat16()
    for mode in P.MODES:
        qp = P.probe_operands(params, mode)
        limits = {"q8_static": (PROBE_STATIC_MAX_ERR, PROBE_STATIC_NORM_ERR),
                  "q8_floor": (PROBE_FLOOR_MAX_ERR, NORM_ERR)}.get(mode,
                                                                  (MAX_ERR_OF_MAX, NORM_ERR))
        reading = check_close(f"probe layer {mode}", P.probe_layer(x, qp, mode, H),
                              P.probe_layer(x, qp, mode, H, plain=True), None, *limits,
                              share_limit=None)
        say(tag, f"layer {mode} {B}x{S}x{D}: {reading}")
    return paths


# [text switches]: the text tower's three switches (models/text:
# set_text_pack, set_text_truncate, set_text_recompute; PERF.TEXT_PACK,
# TEXT_TRUNC, TEXT_RECOMPUTE), each value on the ViT-B/16 text tower (512 x
# 12 layers, 8 heads) at the bench's 100 classes with 2 context vectors and
# 8 deep prompt layers, forward and backward against the plain route; the
# trainers that read truncation; and attention on the 77-token rows that
# TEXT_TRUNC 0 brings, unpacked and packed, both ways, in both dtypes.
# Each case: (TEXT_PACK, TEXT_TRUNC, TEXT_RECOMPUTE); together they take
# every value of each switch
TEXT_SW_CASES = ((0, "auto", "auto"), (1, "auto", "auto"), (4, "auto", "0"), (2, "0", "auto"),
                 (0, "0", "auto"), (1, "0", "1"), (0, "auto", "1"), (4, "0", "0"))
TEXT_SW_N_CLS, TEXT_SW_N_CTX, TEXT_SW_DEPTH = 100, 2, 9
TEXT_FULL = 77  # the class prompts' full length (the tokenizer's context)
# attention on 77-token rows: (label, blocks, rows, heads, mask): the text
# tower at 100 classes unpacked and packed 4 to a row (TEXT_TRUNC 0's auto
# G), and CoCoOp's chunk of 4 instances x 1,000 classes the same two ways
ATTN_77 = (("text 100 x 77, causal", 100, 77, 8, True),
           ("text packed (80, 77), 25 x 320", 25, 320, 8, (80, 77)),
           ("CoCoOp chunk 4000 x 77, causal", 4000, 77, 8, True),
           ("CoCoOp chunk packed (80, 77), 1000 x 320", 1000, 320, 8, (80, 77)))
ATTN_77_KERNELS = ("attention_fwd", "attention_bwd", "attention_fwd_f32", "attention_bwd_f32")


class text_switches:
    """The port's text switches set inside the context (None: left as
    they are), every one restored after it."""

    def __init__(self, pack=None, trunc=None, recompute=None):
        self.values = pack, trunc, recompute

    def __enter__(self):
        from mudpt_torch.models import text

        self.prev = text.text_pack(), text.text_truncate(), text.text_recompute()
        self._set(*self.values)
        return self

    def __exit__(self, *exc):
        self._set(*self.prev)

    @staticmethod
    def _set(pack, trunc, recompute):
        from mudpt_torch.models import text

        if pack is not None:
            text.set_text_pack(pack)
        if trunc is not None:
            text.set_text_truncate(str(trunc) != "0")
        if recompute is not None:
            text.set_text_recompute(recompute)


class TowerRows:
    """The rows each call of the text tower's ``transformer_forward`` takes:
    (shape, mask spec, splice period)."""

    def __enter__(self):
        from mudpt_torch.models import text

        self.seen, self.real = [], text.transformer_forward

        def spy(blocks, x, **kw):
            self.seen.append((tuple(x.shape), kw.get("causal"), kw.get("splice_period", 0)))
            return self.real(blocks, x, **kw)

        text.transformer_forward = spy
        return self

    def __exit__(self, *exc):
        from mudpt_torch.models import text

        text.transformer_forward = self.real


class BlockCalls:
    """Calls of the kernel route's whole layer (``layer_fullblock``) and of
    its attention half (``attn_halfblock``): the route each layer took, on
    either device."""

    NAMES = ("layer_fullblock", "attn_halfblock")

    def __enter__(self):
        from mudpt_torch.ops import fused_block

        self.n, self.real = dict.fromkeys(self.NAMES, 0), {}
        for name in self.NAMES:
            self.real[name] = real = getattr(fused_block, name)
            setattr(fused_block, name, self._count(name, real))
        return self

    def _count(self, name, real):
        def counted(*args, **kwargs):
            self.n[name] += 1
            return real(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        from mudpt_torch.ops import fused_block

        for name, fn in self.real.items():
            setattr(fused_block, name, fn)


def text_rows_want(n_rows: int, S: int, D: int, G: int) -> tuple:
    """The rows the text tower must take for ``n_rows`` sequences of ``S``
    tokens at ``G`` a row: G > 1, ceil(n / G) rows of G x P tokens (P, S
    rounded up to 8) under the packed (P, S) mask, spliced every P; else
    the n rows of S tokens, causal."""
    P = -(-S // 8) * 8
    if G > 1:
        return (-(-n_rows // G), G * P, D), (P, S), P
    return (n_rows, S, D), True, 0


def text_switch_case(F, text_p: dict, names: list, case: tuple, n_head: int,
                     device: str = "cuda", hold_launches: bool = True) -> dict:
    """One switch case on the text tower: the class bank built under the
    switches (its row length: max(eot) + 1 rounded up to 8, at least 16,
    under TEXT_TRUNC auto; the full 77 under 0), then the features and the
    gradients of the context vectors and the deep prompts, against the
    plain route; the rows the tower took held to the pack switch (G, or
    the auto rule under 0), and the layers' route (``BlockCalls``) and
    launches to the recompute switch's (the halves with saves off under '1'
    or past the row-token crossover under 'auto', else the whole layer that
    saves)."""
    import torch

    from mudpt_torch.models import text
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.models.transformer import num_layers_of
    from mudpt_torch.trainers.prompt_utils import embed_classnames

    pack, trunc, recompute = case
    n, D = len(names), text_p["token_embedding"].shape[1]
    layers_n = num_layers_of(text_p["blocks"])
    dtype = text_p["blocks"]["attn"]["qkv_w"].dtype
    g = torch.Generator(device=device).manual_seed(11)
    ctx = (torch.randn(TEXT_SW_N_CTX, D, generator=g, device=device) * 0.02).requires_grad_(True)
    deep = (torch.randn(TEXT_SW_DEPTH - 1, TEXT_SW_N_CTX, D, generator=g, device=device)
            * 0.02).requires_grad_(True)
    cot = torch.randn(n, text_p["projection"].shape[1], generator=g, device=device)
    with text_switches(pack, trunc, recompute):
        aux = embed_classnames(text_p, names, TEXT_SW_N_CTX, "a photo of a").as_device_tree()

        def run():
            prompts = torch.cat([aux["token_prefix"], ctx[None].expand(n, -1, -1),
                                 aux["token_suffix"]], dim=1).to(dtype)
            with TowerRows() as rows:
                feats = text.text_forward(text_p, prompts, aux["eot_idx"], n_head=n_head,
                                          deep_prompts=deep)
                grads = torch.autograd.grad(feats.float(), (ctx, deep), cot)
            return feats.detach(), grads, rows.seen

        F.reset_launches()
        with BlockCalls() as calls:
            feats, grads, seen = run()
        launches = dict(F.LAUNCHES)
        with plain_blocks():
            feats_ref, grads_ref, _ = run()
        ms = _synced_ms(run) if device != "cpu" else None
    S = aux["token_suffix"].shape[1] + 1 + TEXT_SW_N_CTX
    max_eot = int(aux["eot_idx"].max())
    S_want = TEXT_FULL if trunc == "0" else max(16, -(-(max_eot + 1) // 8) * 8)
    if S != S_want:
        raise AssertionError(f"text switches {case}: rows of {S} tokens, expected {S_want}")
    P = -(-S // 8) * 8
    G = pack or text._auto_pack_g(P, n)
    want = text_rows_want(n, S, D, G)
    if seen != [want]:
        raise AssertionError(f"text switches {case}: the tower took {seen}, expected {[want]}")
    saves_off = recompute == "1" or (recompute == "auto" and n * P >= 512 * 80)
    route = "half_train_saves_off" if saves_off else "full_train"
    blocks = dict(layer_fullblock=0, attn_halfblock=layers_n) if saves_off else dict(
        layer_fullblock=layers_n, attn_halfblock=0)
    if calls.n != blocks:
        raise AssertionError(f"text switches {case}: blocks {calls.n}, expected {blocks} "
                             f"({route})")
    if hold_launches:
        check_launches(f"text switches {case}", launches,
                       expect(F.LAUNCHES, (layers_n, route), (1, tower_lns(1, 1))))
    f_read = check_close(f"text switches {case} features", feats, feats_ref,
                         max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR, share_limit=None)
    errs = [((a - b).norm() / b.norm()).item() for a, b in zip(grads, grads_ref)]
    if not max(errs) <= GRAD_NORM_ERR:
        raise AssertionError(f"text switches {case}: gradient relative norm errors {errs} "
                             f"over {GRAD_NORM_ERR}")
    return {"S": S, "G": G, "route": route, "launches": launches, "ms": ms,
            "reading": f"features {f_read}; gradients ctx {errs[0]:.3g}, deep prompts "
                       f"{errs[1]:.3g} (limit {GRAD_NORM_ERR:.3g})"}


def attention_77_case(F, rn, label: str, B: int, S: int, H: int, causal, dtype,
                      kernels: dict) -> list:
    """attention_fwd and attention_bwd (``dtype`` bf16: the bf16 kernels;
    fp32: attention_f32's) on ``B`` blocks of ``S`` rows under ``causal``,
    against their plain versions at the kernel limits, relaunched
    bit-equal; each timed beside its plain version and SDPA, with its
    bound.  Returns the lines."""
    import torch
    import torch.nn.functional as tf

    f32 = dtype == torch.float32
    D, esize = 64 * H, 4 if f32 else 2
    qkv, do = rn(B, S, 3 * D, dtype=dtype), rn(B, S, D, std=0.1, dtype=dtype)
    L, is_causal, valid = F._block_spec(S, causal)
    n = B * (S // L)
    pairs = sum(min(r + 1, valid) if is_causal else valid for r in range(L))
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(n, L, 3, H, 64).permute(2, 0, 3, 1, 4))
    if isinstance(causal, tuple):
        i = torch.arange(L, device=qkv.device)
        allowed = (i[None, :] <= i[:, None]) & (i[None, :] < valid)
        sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # noqa: E731
    else:
        sdpa = lambda: tf.scaled_dot_product_attention(q, k, v, is_causal=is_causal)  # noqa: E731
    lines = []
    for way, fn, plain_fn, nbytes, prods, others in (
            ("fwd", lambda: F.attention_fwd(qkv, H, causal),
             lambda: F.attention_plain(qkv, H, causal), 4, 2, 5),
            ("bwd", lambda: F.attention_bwd(qkv, do, H, causal),
             lambda: F.attention_bwd_plain(qkv, do, H, causal), 7, 5, 8)):
        name = f"attention_{way}{'_f32' if f32 else ''}"
        kern = kernels[name]
        what = f"{name} {label}"
        if f32:
            reading = check_f32(what, fn(), plain_fn(), kern)
        else:
            reading = check_close(what, fn(), plain_fn(), kern)
        check_relaunch(what, fn)
        ms = time_ms(fn)
        plain = time_ms(plain_fn, 3)
        if way == "fwd":
            with torch.no_grad():
                lib = time_ms(sdpa)
        else:
            out = sdpa()
            do4 = do.view(n, L, H, 64).permute(0, 2, 1, 3)
            lib = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do4, retain_graph=True))
            del out, do4
        work = nbytes * B * S * D * esize, prods * 2 * 64 * pairs * n * H, others * pairs * n * H
        bms, by = bound32(*work) if f32 else bound(work[0], work[1], work[2])
        kern.add(ms, plain, lib, bms, by)
        lines.append(f"{name} {label}, {H} heads: {reading} ms {ms:.4f} plain {plain:.4f} "
                     f"library(sdpa{' backward' if way == 'bwd' else ''}"
                     f"{', fp32' if f32 else ''}) {lib:.4f} bound {bms:.4f} ({by})")
    del qkv, do, q, k, v
    return lines


def phase_text_switches(F, root: Path, kernels: dict) -> dict:
    """Every text switch value on the ViT-B/16 text tower against the plain
    route (``TEXT_SW_CASES``); CoOp built with ``PERF.TEXT_TRUNC 0`` through
    the CLI (its class bank of the full 77 tokens, its logits against the
    plain route) and ZeroshotCLIP's text features under it against the
    plain route and against the truncated rows'; then attention on 77-token
    rows (``ATTN_77``) both ways in both dtypes into ``kernels``.  Returns
    each case's launches."""
    import tempfile

    import torch

    from mudpt_torch.models.clip import VIT_B16, cast_matmul_weights, init_clip_params
    from mudpt_torch.models.layers import plain_blocks
    from mudpt_torch.trainers.zsclip import _encode_templates

    phase = "text switches"
    cfg = VIT_B16
    params = cast_matmul_weights(init_clip_params(cfg, torch.Generator(
        device="cuda").manual_seed(0)), torch.bfloat16)
    names = [f"object number {i}" for i in range(TEXT_SW_N_CLS)]
    paths = {}
    for case in TEXT_SW_CASES:
        r = text_switch_case(F, params["text"], names, case, cfg.transformer_heads)
        paths["text_switches_" + "_".join(map(str, case))] = r["launches"]
        say(phase, f"TEXT_PACK {case[0]}, TEXT_TRUNC {case[1]}, TEXT_RECOMPUTE {case[2]}: "
                   f"{TEXT_SW_N_CLS} rows of {r['S']} tokens, {r['G']} a kernel row, route "
                   f"{r['route']}; forward + backward {r['ms']:.2f} ms; vs plain route: "
                   f"{r['reading']}")
    del params
    # ---- the trainers that read truncation, built under PERF.TEXT_TRUNC 0
    tmp = tempfile.mkdtemp(prefix="mudpt_text_switches_")
    try:
        with text_switches():  # the config sets the switch: restored after
            label, trainer, yaml, more = ZOO[0]
            tr = zoo_trainer(root, trainer, yaml, more + ("PERF.TEXT_TRUNC", "0"),
                             f"{tmp}/{label}")
            n_ctx = tr.cfg.TRAINER.COOP.N_CTX
            if tr.aux["token_suffix"].shape[1] != TEXT_FULL - 1 - n_ctx or \
                    tr.perf_resolved["TEXT_TRUNC"] != "0":
                raise AssertionError(f"CoOp under TEXT_TRUNC 0: suffix "
                                     f"{tuple(tr.aux['token_suffix'].shape)}, perf "
                                     f"{tr.perf_resolved['TEXT_TRUNC']}")
            images = tr._device_batch(next(iter(tr.dm.test_loader)))["image"]
            with torch.no_grad():
                logits = tr.forward(tr.trainable, tr.frozen, tr.aux, images)
                with plain_blocks():
                    logits_ref = tr.forward(tr.trainable, tr.frozen, tr.aux, images)
            centred = [t - t.mean(-1, keepdim=True) for t in (logits, logits_ref)]
            reading = check_close("CoOp under TEXT_TRUNC 0 logits, rows centred", *centred,
                                  max_limit=LOGITS_MAX_ERR, norm_limit=LOGITS_NORM_ERR,
                                  share_limit=None)
            say(phase, f"CoOp built through the CLI with PERF.TEXT_TRUNC 0: class rows of "
                       f"{TEXT_FULL} tokens; logits of {images.shape[0]} images vs plain "
                       f"route, rows centred: {reading}")
            del tr
            label, trainer, yaml, more = next(z for z in ZOO if z[0] == "ZeroshotCLIP")
            tr = zoo_trainer(root, trainer, yaml, more + ("PERF.TEXT_TRUNC", "0"),
                             f"{tmp}/{label}")
            txt = tr.aux["text_features"]
            args = (tr.frozen, tr.clip_cfg, tr.classnames, tr.template_list(),
                    tr.compute_dtype, tr.device)
            with torch.no_grad():
                with plain_blocks():
                    txt_ref = _encode_templates(*args)
                with text_switches(trunc="auto"):
                    txt_trunc = _encode_templates(*args)
            r_plain = check_close("ZeroshotCLIP under TEXT_TRUNC 0 text features", txt,
                                  txt_ref, max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR,
                                  share_limit=None)
            r_trunc = check_close("ZeroshotCLIP text features, full vs truncated rows", txt,
                                  txt_trunc, max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR,
                                  share_limit=None)
            say(phase, f"ZeroshotCLIP built with PERF.TEXT_TRUNC 0: text features vs plain "
                       f"route {r_plain}; vs the truncated rows {r_trunc}")
            del tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    # ---- attention on 77-token rows, both dtypes
    rn = randn_fn(12)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, S, H, causal in ATTN_77:
            for line in attention_77_case(F, rn, label, B, S, H, causal, dtype, kernels):
                say(phase, line)
            torch.cuda.empty_cache()
    return paths


# [tools]: the port's tools through main(argv) in this process, each line
# held to its keys (and, where it launches kernels of a known path, to its
# launches).  Under TOOL_KEYS: the keys each line must carry
TOOL_KEYS = {
    "bench_cocoop": ("metric", "value", "unit", "img_per_sec", "text_trunc", "encode_chunk"),
    "sweep_bench": ("spec", "B", "remat", "block", "save", "img_per_sec", "ms_per_step", "loss"),
    "profile_step": ("metric", "self_time", "total_ms", "steps", "top", "by_kernel_ms",
                     "final_loss"),
    "bench_zoo": ("trainer", "img_per_sec", "ms_per_step", "static_text_cache", "first_step_s",
                  "final_loss"),
    "run_protocol": ("n_units", "zeroshot", "fewshot", "base2new", "domain_gen", "failures"),
}
# bench_cocoop's runs: (label, argv, switches (pack, trunc, recompute), the
# chunks of its encode, whether its text rows train with saves off, the
# tokens of its class rows).  Its defaults (8 images x 1,000 classes, P =
# 16) encode unchunked, past the row-token crossover (saves off); full rows
# (P = 80) in chunks of 4 instances; the switch runs take 3 timed steps
COCOOP_TOOL = (
    ("defaults", [], (None, None, None), 1, True, 16),
    ("--text-trunc 0", ["--text-trunc", "0"], (None, None, None), 2, True, 77),
    ("--mode eval --quant int8", ["--mode", "eval", "--quant", "int8"], (None, None, None), 1,
     True, 16),
    ("TEXT_PACK 1", ["--steps", "3", "--warmup", "1"], (1, None, None), 1, True, 16),
    ("TEXT_RECOMPUTE 0", ["--steps", "3", "--warmup", "1"], (None, None, "0"), 1, False, 16),
    ("TEXT_RECOMPUTE 1", ["--steps", "3", "--warmup", "1"], (None, None, "1"), 1, True, 16),
)


def check_tool_line(tool: str, line: dict, extra: tuple = ()) -> dict:
    """A tool's line carries its keys (``TOOL_KEYS`` and ``extra``), no
    ``error``, and its numbers are finite."""
    missing = [k for k in (*TOOL_KEYS[tool], *extra) if k not in line]
    if missing or "error" in line:
        raise AssertionError(f"{tool}: line {line} lacks {missing} or holds an error")
    bad = [k for k, v in line.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{tool}: {bad} not finite in {line}")
    return line


def cocoop_tool_launches(keys, cfg, n_chunks: int, saves_off: bool, quant: str) -> dict:
    """One bench_cocoop step's launches: ``cocoop_launches``, its text rows
    on the whole layer that saves where ``saves_off`` is False (unchunked)."""
    if quant != "none" or saves_off:
        return cocoop_launches(keys, cfg, n_chunks, quant)
    return expect(keys, (cfg.vision_layers, "full"), (1, tower_lns(2)),
                  (cfg.transformer_layers, "full_train"), (1, tower_lns(1, 1)))


# profile_step's trace against the launch counter: each kernel of
# utils/profiling.KERNELS (the GEMMs under their name without template
# arguments) and the counts of the wrappers that launch it once a call
# (attention's backward launches its query and its key kernel)
TRACE_COUNTS = {
    "layernorm_fwd_kernel": ("layernorm_fwd", "layernorm_fwd_f32"),
    "gemm_bf16_kernel": ("gemm_bf16_epilogue",),
    "attention_fwd_wgmma_kernel": ("attention_fwd",),
    "layernorm_bwd_kernel": ("layernorm_bwd",),
    "attn_bwd_query_kernel": ("attention_bwd",),
    "attn_bwd_key_kernel": ("attention_bwd",),
    "layernorm_bwd_f32_kernel": ("layernorm_bwd_f32",),
    "gemm_f32_kernel": ("gemm_f32_epilogue",),
    "attn_fwd_tc_kernel": ("attention_fwd_f32",),
    "attn_bwd_query_tc_kernel": ("attention_bwd_f32",),
    "attn_bwd_key_tc_kernel": ("attention_bwd_f32",),
    "gemm_s8_kernel": ("gemm_s8_epilogue", "gemm_s8_epilogue_f32", "gemm_s8_epilogue_floor"),
    "layernorm_q8_kernel": ("layernorm_q8", "layernorm_q8_f32", "layernorm_q8_recip",
                            "layernorm_q8_noclip", "layernorm_q8_floor"),
    "quant_rows_kernel": ("quant_rows", "quant_rows_recip", "quant_rows_noclip",
                          "quant_rows_floor"),
    "probe_mma_kernel": ("probe_mma_bf16", "probe_mma_s8"),
}


def check_trace_launches(what: str, traced: dict, launches: dict, steps: int, of: int) -> str:
    """A trace's launches of each kernel (``utils/profiling.kernel_launches``)
    against the counter's for the traced steps: ``steps`` of the ``of``
    steps that ``launches`` counts, each step launching alike.  Every kernel
    the trace names is held, none may be missing or extra."""
    got = {}
    for name, n in traced.items():
        base = name.split("<")[0]
        got[base] = got.get(base, 0) + n
    want = {}
    for kernel, counts in TRACE_COUNTS.items():
        total = sum(launches.get(c, 0) for c in counts)
        if total * steps % of:
            raise AssertionError(f"{what}: {total} launches of {kernel} do not split evenly "
                                 f"into {of} steps")
        if total:
            want[kernel] = total * steps // of
    if got != want or not want:
        diff = {k: (got.get(k, 0), want.get(k, 0)) for k in {*got, *want}
                if got.get(k, 0) != want.get(k, 0)}
        raise AssertionError(f"{what}: the trace's launches differ from the counter's for "
                             f"{steps} steps (traced, counted): {diff}")
    return f"the trace holds every launch of the {steps} traced steps: " + ", ".join(
        f"{k} {v}" for k, v in sorted(want.items()))


def phase_tools(F, root: Path) -> dict:
    """``mudpt_torch.tools``' bench_cocoop (its defaults, full rows, int8
    serving, and its step under TEXT_PACK 1 and TEXT_RECOMPUTE 0 and 1, its
    peak memory beside), sweep_bench at one spec, profile_step at its
    defaults, bench_zoo for CoOp and CoCoOp and run_protocol's synthetic
    dry run, each through ``main(argv)`` in this process: its line held to
    its keys, its launches to its path where the path is known."""
    import glob
    import tempfile

    import torch

    from mudpt_torch.models.clip import VIT_B16
    from mudpt_torch.tools import bench_cocoop, bench_zoo, profile_step, run_protocol, sweep_bench
    from mudpt_torch.utils.profiling import kernel_launches

    phase = "tools"
    paths = {}
    steps_of = {"--steps": 8, "--warmup": 2}
    for label, argv, switches, n_chunks, saves_off, S in COCOOP_TOOL:
        n_steps = sum(int(argv[argv.index(k) + 1]) if k in argv else v
                      for k, v in steps_of.items())
        quant = "int8" if "int8" in argv else "none"
        F.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with text_switches(*switches), TowerRows() as rows:
            line = check_tool_line("bench_cocoop", bench_cocoop.main(argv),
                                   () if quant != "none" else ("final_loss",))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(F.LAUNCHES)
        per_step = cocoop_tool_launches(F.LAUNCHES, VIT_B16, n_chunks, saves_off, quant)
        check_launches(f"bench_cocoop {label}", launches,
                       {k: v * n_steps for k, v in per_step.items()})
        n_rows = 8000 // n_chunks
        G = switches[0] or (8 if S == 16 else 4)
        want = text_rows_want(n_rows, S, VIT_B16.transformer_width, G)
        if rows.seen[0] != want:
            raise AssertionError(f"bench_cocoop {label}: the text tower took {rows.seen[0]}, "
                                 f"expected {want}")
        paths["tools_bench_cocoop_" + label.replace(" ", "_").replace("-", "")] = launches
        say(phase, f"bench_cocoop {label}: {json.dumps(line)}; peak {peak:.2f} GiB; text rows "
                   f"{rows.seen[0]}; {n_steps} steps' launches held")
    torch.cuda.empty_cache()
    # ---- sweep_bench at the JAX tool's first example spec
    F.reset_launches()
    out = sweep_bench.main(["384:none:pallas:save"])
    (row,) = out["results"]
    check_tool_line("sweep_bench", row)
    n_steps = sweep_bench.WARMUP + sweep_bench.TIMED
    check_launches("sweep_bench 384:none:pallas:save", dict(F.LAUNCHES),
                   {k: v * n_steps for k, v in step_launches(F, VIT_B16, "full_train",
                                                             "full_train").items()})
    paths["tools_sweep_bench"] = dict(F.LAUNCHES)
    say(phase, f"sweep_bench: {json.dumps(row)}")
    torch.cuda.empty_cache()
    # ---- profile_step at its defaults (batch 192, 1,000 classes, depth 9)
    tmp = tempfile.mkdtemp(prefix="mudpt_tools_")
    try:
        F.reset_launches()
        rec = check_tool_line("profile_step", profile_step.main(["--outdir", f"{tmp}/profile"]))
        # 1,000 rows of 16 tokens: under the crossover, the text layers save
        check_launches("profile_step", dict(F.LAUNCHES),
                       {k: v * (2 + rec["steps"]) for k, v in step_launches(
                           F, VIT_B16, "full_train", "full_train").items()})
        paths["tools_profile_step"] = dict(F.LAUNCHES)
        (trace,) = glob.glob(f"{tmp}/profile/trace-*.json")
        say(phase, "profile_step: " + check_trace_launches(
            "profile_step", kernel_launches(trace), F.LAUNCHES, rec["steps"], 2 + rec["steps"]))
        kernel_ms = {k: v for k, v in (rec["by_kernel_ms"] or {}).items()
                     if k not in ("forward kernels", "backward kernels", "other")}
        if not (rec["self_time"] == "device" and rec["total_ms"] > 0 and kernel_ms):
            raise AssertionError(f"profile_step: no device time by kernel in {rec}")
        top = "; ".join(f"{t['op'][:48]} {t['self_ms']:.2f} ms ({t['share']:.1%}, "
                        f"{t['occurrences']})" for t in rec["top"][:8])
        say(phase, f"profile_step (batch 192, 1,000 classes, {rec['steps']} steps): device "
                   f"{rec['total_ms']:.2f} ms; top ops: {top}; by kernel: " + ", ".join(
                       f"{k} {v:.3f}" for k, v in sorted(kernel_ms.items(), key=lambda kv: -kv[1])))
        # ---- bench_zoo: CoOp and CoCoOp's train steps at its defaults
        F.reset_launches()
        rows = bench_zoo.main(["--trainers", "CoOp", "CoCoOp", "--steps", "2"])
        for name in ("CoOp", "CoCoOp"):
            check_tool_line("bench_zoo", rows[name])
        paths["tools_bench_zoo"] = dict(F.LAUNCHES)
        # CoOp's text rows train on the whole layer, CoCoOp's chunks on the halves
        if not (F.LAUNCHES["layer_fullblock_bwd"] and F.LAUNCHES["attn_halfblock_bwd"]):
            raise AssertionError(f"bench_zoo: a tower's backward not launched: {F.LAUNCHES}")
        say(phase, "bench_zoo: " + "; ".join(json.dumps(r) for r in rows.values()))
        # ---- run_protocol's synthetic dry run (test-tiny, one dataset, one seed)
        F.reset_launches()
        summary = check_tool_line("run_protocol", run_protocol.main(
            ["--synthetic", "--output_root", f"{tmp}/protocol"]))
        fp32_launched = [k for k in ("layernorm_fwd_f32", "gemm_f32_epilogue",
                                     "attention_fwd_f32", "attention_bwd_f32") if F.LAUNCHES[k]]
        if summary["n_units"] != 6 or summary["failures"] or len(fp32_launched) != 4:
            raise AssertionError(f"run_protocol --synthetic: {summary}, fp32 kernels launched "
                                 f"{fp32_launched}")
        paths["tools_run_protocol"] = dict(F.LAUNCHES)
        say(phase, f"run_protocol --synthetic: {summary['n_units']} units, no failure; "
                   f"launches {dict((k, v) for k, v in F.LAUNCHES.items() if v)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


# [periphery] (a): python -m mudpt_torch.tools.feat_extractor at ViT-B/16 on
# a Caltech101-layout JPEG tree of its own, small enough that each split is
# a few hundred images (the reader's 50 / 20 / 30 split of 40 a class:
# train 400, test 240); (b) a MuDPT ViT-B/16 trainer on the synthetic
# dataset (32 classes, its 128 test images in batches of 64), its prompts
# through a Dassl pickle and back
PERI_CLASSES, PERI_PER_CLASS, PERI_BATCH = 20, 40, 128
PERI_SPLITS = ("train", "test")
PERI_OPTS = ("DATALOADER.TRAIN_X.BATCH_SIZE", str(PERI_BATCH), "DATALOADER.NUM_WORKERS", "8")
PERI_CLI = ("DATASET.SYNTHETIC_NUM_CLASSES", "32", "DATASET.SYNTHETIC_PER_CLASS", "1",
            "DATALOADER.TEST.BATCH_SIZE", "64")


def plain_features(params: dict, clip_cfg, images, dtype):
    """``encode_image`` under ``plain_blocks()`` on host ``images`` (N, H, W,
    3), ``PERI_BATCH`` at a time, as fp32 on the card."""
    import torch

    from mudpt_torch.models.clip import encode_image
    from mudpt_torch.models.layers import plain_blocks

    out = []
    with torch.no_grad(), plain_blocks():
        for i in range(0, len(images), PERI_BATCH):
            x = torch.from_numpy(images[i:i + PERI_BATCH]).to(dtype).cuda()
            out.append(encode_image(params, x, clip_cfg, compute_dtype=dtype).float())
    return torch.cat(out)


def check_features(what: str, path: str, labels: list, ref, embed_dim: int, dtype: str) -> str:
    """A feat_extractor file: its two keys, (N, embed_dim) fp32 features
    against ``ref`` (bf16 within [serving]'s feature limits, fp32 within the
    fp32 chains'), ``label_list`` the split's labels in order."""
    import numpy as np
    import torch

    with np.load(path) as f:
        keys, feats, labs = sorted(f.files), f["feature_list"], f["label_list"]
    if keys != ["feature_list", "label_list"] or feats.shape != (len(labels), embed_dim) \
            or feats.dtype != np.float32:
        raise AssertionError(f"{what}: keys {keys}, features {feats.shape} {feats.dtype}, "
                             f"expected ({len(labels)}, {embed_dim}) float32")
    if labs.tolist() != list(labels):
        raise AssertionError(f"{what}: label_list is not the split's labels in order")
    limits = (dict(max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR) if dtype == "bf16" else
              dict(max_limit=F32_CHAIN_MAX_ERR, norm_limit=F32_CHAIN_NORM_ERR))
    return check_close(what, torch.from_numpy(feats).to(ref.device), ref, share_limit=None,
                       **limits)


def check_same_tree(what: str, want: dict, got: dict) -> str:
    """Two prompt trees (tensors or arrays) with the same leaves, bit-equal."""
    import numpy as np

    from mudpt_torch.utils.checkpoint import _flatten

    want, got = _flatten(want), _flatten(got)
    differ = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
    if differ or len(got) != len(want):
        raise AssertionError(f"{what}: leaves differ or missing: {differ}; extra: "
                             f"{sorted(set(got) - set(want))}")
    return f"{len(want)} leaves bit-equal"


def periphery_cli(root: Path, out: str, *argv: str):
    """``python -m mudpt_torch.train`` for MuDPT ViT-B/16 on the synthetic
    dataset (PERI_CLI), in this process (the CLI's tee of stdout undone)."""
    from mudpt_torch import train as train_cli

    args = ["--trainer", "MuDPT", "--trainer_config", str(root / ENGINE_FILES[1]),
            "--dataset_config", str(root / ENGINE_FILES[0]), "--output_dir", out,
            "--backbone_path", "random", *argv, *PERI_CLI]
    streams = sys.stdout, sys.stderr
    try:
        return train_cli.main(train_cli.parse_args(args))
    finally:
        sys.stdout, sys.stderr = streams


def eval_record(out: str) -> dict:
    """The run's last evaluate record, its time stamp left out."""
    with open(Path(out) / "metrics.jsonl") as f:
        rec = [r for r in map(json.loads, f) if r["kind"] == "eval"][-1]
    return {k: v for k, v in rec.items() if k != "time"}


def phase_periphery(F, root: Path) -> dict:
    """(a) feat_extractor through ``main(argv)`` at ViT-B/16, both splits,
    bf16 and fp32: files, labels, features against the plain path, launches,
    images/s; (b) a trainer's seeded prompts saved, exported to a Dassl
    pickle, evaluated through the CLI's --eval_only (bit-equal to the native
    checkpoint's, launches an evaluate's) and imported back (bit-equal).
    Returns each path's launches."""
    import tempfile

    import numpy as np
    import torch

    from mudpt_torch.models.clip import cast_matmul_weights, leaves
    from mudpt_torch.models.import_reference import is_torch_checkpoint
    from mudpt_torch.tools import export_reference_checkpoint, feat_extractor
    from mudpt_torch.tools import import_reference_checkpoint
    from mudpt_torch.trainers.base import load_backbone
    from mudpt_torch.utils.checkpoint import load_checkpoint

    phase, paths = "periphery", {}
    tmp = tempfile.mkdtemp(prefix="mudpt_periphery_")
    try:
        # ---- (a) the feature extractor
        t0 = time.perf_counter()
        tree = Path(tmp) / "data"
        n_jpegs = write_jpeg_tree(tree, PERI_CLASSES, PERI_PER_CLASS)
        base = ["--root", str(tree), "--output_dir", f"{tmp}/feat", "--dataset_config_file",
                str(root / DS_DATA), "--backbone_name", "ViT-B/16", "--backbone_path", "random"]
        cfg = feat_extractor.setup_config(feat_extractor.parse_args(
            [*base, "--split", "train", *PERI_OPTS]))
        splits = {}
        for split in PERI_SPLITS:  # each split decoded once for the plain path
            items = feat_extractor.split_items(cfg, split)
            batches = list(feat_extractor.split_loader(cfg, items))
            splits[split] = ([it.label for it in items], len(batches),
                             np.concatenate([b["image"][b["valid"]] for b in batches]))
        say(phase, f"{n_jpegs} JPEGs written and the splits ("
                   + ", ".join(f"{s} {len(v[0])}" for s, v in splits.items())
                   + f") decoded once in {time.perf_counter() - t0:.2f} s")
        for dtype in ("bf16", "fp32"):
            compute = torch.bfloat16 if dtype == "bf16" else torch.float32
            clip_cfg, params = load_backbone(cfg, "cuda")  # the tool's weights (seed 0)
            if dtype == "bf16":
                params = cast_matmul_weights(params, torch.bfloat16)
            launches = dict.fromkeys(F.LAUNCHES, 0)
            timed = seconds = 0.0
            readings = []
            for split in PERI_SPLITS:
                labels, n_batches, images = splits[split]
                F.reset_launches()
                rec = feat_extractor.main([*base, "--split", split, "--dtype", dtype,
                                           *PERI_OPTS])
                got = dict(F.LAUNCHES)
                want = expect(F.LAUNCHES, (n_batches * clip_cfg.vision_layers, "full"),
                              (n_batches, tower_lns(2)))
                if dtype == "fp32":
                    want = in_fp32(F, want)
                    check_fp32_launches(F, f"feat_extractor {split} fp32", got, backward=False)
                check_launches(f"feat_extractor {split} {dtype}", got, want)
                for k, v in got.items():
                    launches[k] += v
                ref = plain_features(params, clip_cfg, images, compute)
                readings.append(f"{split} ({rec['n_images']} images, {n_batches} batches): "
                                + check_features(f"feat_extractor {split} {dtype}", rec["path"],
                                                 labels, ref, clip_cfg.embed_dim, dtype))
                timed += rec["timed_images"]
                seconds += rec["seconds"]
            paths[f"periphery_feat_{dtype}"] = launches
            per_batch = expect(F.LAUNCHES, (clip_cfg.vision_layers, "full"), (1, tower_lns(2)))
            per_batch = per_batch if dtype == "bf16" else in_fp32(F, per_batch)
            if not timed > 0:
                raise AssertionError(f"feat_extractor {dtype}: no image timed")
            say(phase, f"feat_extractor --dtype {dtype}: {timed / seconds:.1f} images/s "
                       f"({int(timed)} images counted as collected, {seconds:.2f} s); launches a "
                       f"batch { {k: v for k, v in per_batch.items() if v} }, held; "
                       "vs plain_blocks(): " + "; ".join(readings))
            del params
            torch.cuda.empty_cache()

        # ---- (b) a Dassl pickle of the trainer's prompts, out and back in
        t0 = time.perf_counter()
        tr = periphery_cli(root, f"{tmp}/native", "--no_train")
        g = torch.Generator(device=tr.device).manual_seed(21)
        with torch.no_grad():
            for leaf in leaves(tr.trainable):
                leaf.add_(0.02 * torch.randn(leaf.shape, device=leaf.device, generator=g))
        tr.save_model()
        if export_reference_checkpoint.main(["--src", f"{tmp}/native", "--dst",
                                             f"{tmp}/exported"]) != 0:
            raise AssertionError("export_reference_checkpoint failed")
        exported = Path(tmp) / "exported" / tr.model_name / "model.pth.tar-1"
        if not is_torch_checkpoint(str(exported)):
            raise AssertionError(f"{exported} is not a torch pickle")
        evals = ("--eval_only", "--load_epoch", "1", "--model_dir")
        native = periphery_cli(root, f"{tmp}/eval_native", *evals, f"{tmp}/native")
        F.reset_launches()
        ref_tr = periphery_cli(root, f"{tmp}/eval_reference", *evals, f"{tmp}/exported")
        launches = dict(F.LAUNCHES)
        n_batches = len(ref_tr.dm.test_loader)
        check_launches("--eval_only of the Dassl checkpoint", launches,
                       zoo_eval_launches(F.LAUNCHES, ref_tr.clip_cfg, n_batches, 1, False))
        paths["periphery_reference_eval"] = launches
        check_same_tree("the prompts --eval_only loaded from the Dassl checkpoint",
                        tr.trainable, ref_tr.trainable)
        rec_n, rec_r = eval_record(f"{tmp}/eval_native"), eval_record(f"{tmp}/eval_reference")
        if rec_n != rec_r:
            raise AssertionError(f"--eval_only: Dassl {rec_r} != native {rec_n}")
        n_logits = 0
        with torch.no_grad():
            txt_n = native._text_features(native.trainable, native.frozen, native.aux)
            txt_r = ref_tr._text_features(ref_tr.trainable, ref_tr.frozen, ref_tr.aux)
            for batch in ref_tr.dm.test_loader:
                images = ref_tr._device_batch(batch)["image"]
                a = native.forward_image(native.trainable, native.frozen, native.aux, images, txt_n)
                b = ref_tr.forward_image(ref_tr.trainable, ref_tr.frozen, ref_tr.aux, images, txt_r)
                check_equal("eval logits, Dassl vs native checkpoint", b, a)
                n_logits += a.numel()
        if import_reference_checkpoint.main(["--src", f"{tmp}/exported", "--dst",
                                             f"{tmp}/converted"]) != 0:
            raise AssertionError("import_reference_checkpoint failed")
        back, _, meta = load_checkpoint(f"{tmp}/converted", tr.model_name, 1)
        back_read = check_same_tree("import_reference_checkpoint's tree", tr.trainable, back)
        say(phase, f"MuDPT ViT-B/16 prompts -> native checkpoint -> Dassl pickle "
                   f"({exported.stat().st_size} bytes) -> --eval_only: accuracy "
                   f"{rec_r['accuracy']:.2f} and {n_logits} logits bit-equal to the native "
                   f"checkpoint's; launches {n_batches} batches + 1 text encode, held "
                   f"{ {k: v for k, v in launches.items() if v} }; imported back "
                   f"({meta['trainer']}): {back_read}; "
                   f"{time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


# [api]: the user-facing layer at ViT-B/16's full width.  (a)
# api.clip_forward on API_IMAGES images x API_PROMPTS prompts, bf16 and
# fp32, against the same call on the CPU's plain versions on the first
# API_REF_IMAGES x API_REF_PROMPTS; (b) validate_zeroshot on a Caltech101
# tree of API_CLASSES classes x 40 images (the reader's split: 12 test
# images a class); (c) the bench under --remat none and full; (d) one
# epoch of [engine]'s trainer with TRAIN.PROFILE_DIR set
API_IMAGES, API_PROMPTS, API_REF_IMAGES, API_REF_PROMPTS = 64, 100, 8, 16
API_CLASSES = 20
API_BENCH = ("--mode", "train", "--model", "ViT-B/16", "--batch", str(BATCH),
             "--n-cls", str(N_CLS), "--n-ctx", str(N_CTX), "--depth", str(DEPTH),
             "--steps", "5", "--warmup", "2")


def clip_forward_launches(F, cfg, fp32: bool) -> dict:
    """One ``clip_forward`` call: both towers' layers on the no-save
    forward, ln_pre, ln_post and ln_final; on fp32 activations the fp32
    kernels."""
    want = expect(F.LAUNCHES, (cfg.vision_layers, "full"), (cfg.transformer_layers, "full"),
                  (1, tower_lns(3)))
    return in_fp32(F, want) if fp32 else want


def check_clip_forward(what: str, launches: dict, want: dict, per_image, per_text) -> str:
    """A ``clip_forward`` call: its launches ``want`` and its
    logits_per_text the transpose of logits_per_image."""
    import torch

    check_launches(what, launches, want)
    if not torch.equal(per_text, per_image.T):
        raise AssertionError(f"{what}: logits_per_text is not logits_per_image transposed")
    return (f"launches held ({launches['layer_fullblock']} layer_fullblock), "
            "logits_per_text the transpose")


def check_zeroshot_report(out: str, rc: int, dataset: str, accuracy: float) -> str:
    """``validate_zeroshot``'s report on random weights: exit 1, and the
    dataset's FAIL line with the accuracy of ``test()`` on the same
    config and its delta from the published value."""
    from mudpt_torch.tools.validate_zeroshot import PUBLISHED_VIT_B16

    published = PUBLISHED_VIT_B16[dataset]
    want = (f"{dataset}: measured {accuracy:.2f} published {published:.2f} "
            f"delta {accuracy - published:+.2f} [FAIL]")
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{dataset}: measured")]
    if rc != 1 or lines != [want] or f"FAILED: ['{dataset}']" not in out:
        raise AssertionError(f"validate_zeroshot: exit {rc}, report {lines}, expected exit 1 "
                             f"and {want!r}")
    return want


def check_remat_bench(recs: dict, launches: dict, want: dict) -> str:
    """The bench under --remat none and full: the final loss bit-equal, each
    run's launches ``want`` (full: one more forward of every layer a step),
    its line's remat the mode asked for and vs_baseline the line's own.
    The executed TFLOP/s are printed, not held: the recomputed forward runs
    at about the step's own rate, so their order is within the runs'
    spread."""
    from mudpt_torch.bench import A100_BASELINE_IPS

    none, full = recs["none"], recs["full"]
    if none["final_loss"] != full["final_loss"]:
        raise AssertionError(f"--remat full final loss {full['final_loss']!r} != none's "
                             f"{none['final_loss']!r}")
    for mode, rec in recs.items():
        check_launches(f"bench --remat {mode}", launches[mode], want[mode])
        vs = rec["vs_baseline"]
        if rec["remat"] != mode or not (math.isfinite(vs) and vs == round(
                rec["value"] / A100_BASELINE_IPS, 3)):
            raise AssertionError(f"bench --remat {mode}: remat {rec['remat']!r}, vs_baseline "
                                 f"{vs!r} for {rec['value']} images/s")
    return (f"final loss {none['final_loss']!r} bit-equal; layer_fullblock "
            f"{launches['none']['layer_fullblock']} -> {launches['full']['layer_fullblock']}; "
            f"exec TFLOP/s {none['exec_tflops_per_sec']} -> {full['exec_tflops_per_sec']}")


def check_trainer_trace(what: str, trace: str, launches: dict, n_steps: int) -> str:
    """The trainer's TRAIN.PROFILE_DIR trace: exactly one recorded step (the
    profiler's step 1, after its warmup step), holding every launch the
    counter counted for one of the epoch's ``n_steps`` steps."""
    from mudpt_torch.utils.profiling import kernel_launches

    with open(trace) as f:
        steps = sorted({e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("name", "").startswith("ProfilerStep#")})
    if steps != ["ProfilerStep#1"]:
        raise AssertionError(f"{what}: the trace records steps {steps}, not the one after "
                             "its warmup")
    return check_trace_launches(what, kernel_launches(trace), launches, 1, n_steps)


def phase_api(F, root: Path) -> dict:
    """(a) ``api.clip_forward`` at ViT-B/16, bf16 and fp32: launches, the
    transpose, logits against the CPU's plain versions; (b)
    ``validate_zeroshot.main`` on a Caltech101 tree with random weights:
    exit 1, its FAIL line's accuracy that of ``test()`` in this process,
    launches; (c) ``mudpt_torch.bench.main`` under --remat none and full;
    (d) the engine's TRAIN.PROFILE_DIR trace held to the counter.  Returns
    each path's launches."""
    import contextlib
    import glob
    import io
    import tempfile

    import numpy as np
    import torch

    from mudpt_torch import api, bench
    from mudpt_torch.models.clip import VIT_B16, _map, cast_matmul_weights, init_clip_params
    from mudpt_torch.tools import validate_zeroshot
    from mudpt_torch.trainers.base import build_trainer

    phase, paths = "api", {}
    tmp = tempfile.mkdtemp(prefix="mudpt_api_")
    try:
        # ---- (a) clip_forward, random weights from a seeded generator
        t0 = time.perf_counter()
        cfg = VIT_B16
        params = init_clip_params(cfg, torch.Generator(device="cuda").manual_seed(22))
        rs = np.random.RandomState(22)
        side = cfg.image_resolution
        images = torch.from_numpy(rs.randn(API_IMAGES, side, side, 3).astype(np.float32))
        names = cocoop_names(API_PROMPTS)
        tokens = torch.from_numpy(np.asarray(
            api.tokenize([f"a photo of a {n}." for n in names]))).long()
        readings = []
        for dtype in ("bf16", "fp32"):
            compute = torch.bfloat16 if dtype == "bf16" else torch.float32
            p = cast_matmul_weights(params, compute) if dtype == "bf16" else params
            F.reset_launches()
            with torch.no_grad():
                per_image, per_text = api.clip_forward(p, images.cuda(), tokens.cuda(), cfg,
                                                       compute_dtype=compute)
            torch.cuda.synchronize()
            launches = dict(F.LAUNCHES)
            want = clip_forward_launches(F, cfg, dtype == "fp32")
            held = check_clip_forward(f"api.clip_forward {dtype}", launches, want, per_image,
                                      per_text)
            if dtype == "fp32":
                check_fp32_launches(F, "api.clip_forward fp32", launches, backward=False)
            paths[f"api_clip_forward_{dtype}"] = launches
            cpu = _map(p, lambda t: t.cpu())
            few = images[:API_REF_IMAGES], tokens[:API_REF_PROMPTS]
            with torch.no_grad():
                ref, _ = api.clip_forward(cpu, *few, cfg, compute_dtype=compute)
                # the towers' features, wider-ranged than the random
                # weights' logits: a fault in a few rows shows there
                feats = [(what, enc(p, x.cuda(), cfg, compute_dtype=compute),
                          enc(cpu, x, cfg, compute_dtype=compute))
                         for what, enc, x in (("image", api.encode_image, few[0]),
                                              ("text", api.encode_text, few[1]))]
            got = per_image[:API_REF_IMAGES, :API_REF_PROMPTS]
            got, ref = (t - t.mean(-1, keepdim=True) for t in (got, ref.cuda()))
            limits, feat_limits = (
                (dict(max_limit=LOGITS_MAX_ERR, norm_limit=LOGITS_NORM_ERR),
                 dict(max_limit=TEXT_MAX_ERR, norm_limit=TEXT_NORM_ERR)) if dtype == "bf16" else
                (dict(max_limit=F32_CHAIN_MAX_ERR, norm_limit=F32_CHAIN_NORM_ERR),) * 2)
            readings.append(f"{dtype}: {tuple(per_image.shape)} logits, {held}; vs the CPU's "
                            f"plain versions on {API_REF_IMAGES} x {API_REF_PROMPTS}, rows "
                            "centred: " + check_close(f"api.clip_forward {dtype} logits", got,
                                                      ref, share_limit=None, **limits)
                            + "".join(f"; {what} features: " + check_close(
                                f"api.encode_{what} {dtype}", a.float(), b.float().cuda(),
                                share_limit=None, **feat_limits) for what, a, b in feats))
        del params, p
        torch.cuda.empty_cache()
        say(phase, f"api.clip_forward, ViT-B/16, {API_IMAGES} images x {API_PROMPTS} "
                   f"prompts: " + "; ".join(readings)
                   + f" ({time.perf_counter() - t0:.2f} s)")

        # ---- (b) validate_zeroshot on a Caltech101 tree, random weights
        t0 = time.perf_counter()
        tree = Path(tmp) / "data"
        n_jpegs = write_jpeg_tree(tree, API_CLASSES, 40)
        argv = ["--dataset_root", str(tree), "--backbone", "ViT-B/16", "--backbone_path",
                "random", "--datasets", "caltech101"]
        out = io.StringIO()
        F.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = validate_zeroshot.main(argv)
        launches = dict(F.LAUNCHES)
        tr = build_trainer(validate_zeroshot.dataset_config("caltech101", str(tree), "ViT-B/16",
                                                            "random"))
        with contextlib.redirect_stdout(io.StringIO()):
            rec = tr.test()
        line = check_zeroshot_report(out.getvalue(), rc, "caltech101", rec["accuracy"])
        n_batches = len(tr.dm.test_loader)
        check_launches("validate_zeroshot", launches,
                       zoo_eval_launches(F.LAUNCHES, tr.clip_cfg, n_batches, 1, False))
        paths["api_validate_zeroshot"] = launches
        say(phase, f"validate_zeroshot --backbone ViT-B/16 --backbone_path random on "
                   f"{n_jpegs} JPEGs ({rec['total']} test images, {n_batches} batches): exit "
                   f"{rc}, {line!r}, the accuracy of test() on the same config; launches "
                   f"{n_batches} batches + 1 text encode, held "
                   f"({time.perf_counter() - t0:.2f} s)")
        del tr

        # ---- (c) the bench under --remat none and full
        t0 = time.perf_counter()
        recs, launches = {}, {}
        per_step = step_launches(F, cfg, "full_train", "full_train")
        want = {"none": per_step, "full": expect(F.LAUNCHES, (1, per_step), (
            cfg.transformer_layers, "full"), (cfg.vision_layers, "full"))}
        n_steps = int(API_BENCH[API_BENCH.index("--steps") + 1]) + int(
            API_BENCH[API_BENCH.index("--warmup") + 1])
        for mode in ("none", "full"):
            out = io.StringIO()
            F.reset_launches()
            with contextlib.redirect_stdout(out):
                bench.main([*API_BENCH, "--remat", mode])
            recs[mode] = parse_bench_line(out.getvalue())
            launches[mode] = dict(F.LAUNCHES)
            want[mode] = {k: v * n_steps for k, v in want[mode].items()}
            say(phase, f"bench --remat {mode}: {json.dumps(recs[mode])}")
        paths["api_bench_remat_full"] = launches["full"]
        say(phase, "bench --remat full vs none: " + check_remat_bench(recs, launches, want)
                   + "; vs [train]: " + check_bench("--remat none", recs["none"]["value"],
                                                     THROUGHPUT["train"])
                   + "; vs [remat]'s full: " + check_bench(
                       "--remat full", recs["full"]["value"], THROUGHPUT["remat_full"])
                   + f" ({time.perf_counter() - t0:.2f} s)")

        # ---- (d) the trainer's TRAIN.PROFILE_DIR trace, one epoch
        t0 = time.perf_counter()
        tr = _engine_trainer(root, f"{tmp}/engine", "OPTIM.MAX_EPOCH", "1",
                             "TRAIN.PROFILE_DIR", f"{tmp}/trace", "TEST.NO_TEST", "True")
        F.reset_launches()
        tr.train()
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        n_steps = len(tr.dm.train_loader)
        check_launches("the traced epoch", launches,
                       {k: v * n_steps for k, v in per_step.items()})
        paths["api_trainer_trace_epoch"] = launches
        (trace,) = glob.glob(f"{tmp}/trace/trace-*.json")
        say(phase, f"TRAIN.PROFILE_DIR, one epoch of {n_steps} steps of {ENGINE_BATCH} "
                   "images: " + check_trainer_trace("the trainer's trace", trace, launches,
                                                    n_steps)
                   + f" ({time.perf_counter() - t0:.2f} s)")
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def descendants(pid: int) -> list:
    """The pids of the running processes descended from ``pid`` (/proc),
    parents before their children."""
    children = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (FileNotFoundError, ProcessLookupError):
            continue  # exited meanwhile
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(stat.parent.name))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def check_no_process_left() -> str:
    """Stop the loaders' worker processes, their forkserver and resource
    tracker, waiting for each; then hold that no other process this one
    started is still running.  One that is gets killed (and reaped, where
    it is a child), then fails the run."""
    import gc

    from mudpt_torch.data.grain_pipeline import stop_workers

    gc.collect()  # passes held open by cycles release their workers
    stop_workers()
    left = descendants(os.getpid())
    if not left:
        return "no process left running"
    names = {}
    for pid in left:
        try:
            names[pid] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
            os.kill(pid, signal.SIGKILL)
        except (FileNotFoundError, ProcessLookupError):
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass  # not a child: its own parent reaps it
    raise AssertionError(f"processes left running, killed: {names}")


AB_ITERS = 40  # launches a kernel time of --times-of averages


def kernel_times(F) -> dict:
    """ms per launch of every GEMM epilogue and attention_bwd case of
    SHAPES (the three vision towers' paths and the text shapes), of every
    bf16 s8 GEMM case of Q8_GEMM, of the row quantizer at ViT-B/16's rows,
    of LayerNorm-quant at every case of ``Q8_LN_AB`` and of the bf16
    LayerNorm dx at every case of ``LN_BWD_AB`` (these also queued: a
    launch takes 4-800 us, where the host's pace can set ``time_ms``), on
    seeded inputs, through the public
    wrappers only, so that two trees' kernels can be timed in one call
    (``--times-of``); and of every fp32 GEMM mode of ``FP32_GEMM``, of
    attention_fwd_f32 and attention_bwd_f32 at every case of
    ``FP32_ATTN_BWD``, of every gemm_s8_epilogue_f32 case of
    ``F32_Q8_GEMM`` (ViT-B/16's and ViT-L/14's rows, dynamic and static) and
    of the fp32 LayerNorms at every row count of ``FP32_LN``, each way.
    attention (bf16 backward and fp32 both ways) and the fp32 LayerNorms
    also by ``queued_ms``: their text shapes take microseconds, where the
    host's pace can set ``time_ms``.  A block length that a package refuses (an attention_bwd
    with a row cap) is left out."""
    import torch

    from mudpt_torch.ops import quant_block as Q

    rn = randn_fn(11)
    times = {}
    for key, fn in itertools.chain(q8_row_cases(F, Q, rn), ln_bwd_cases(F, rn)):
        times[key] = time_ms(fn, AB_ITERS)
        times[key + " device"], times[key + " host us"] = queued_ms(fn, AB_ITERS)
    for ep, M, K, N, save, *_ in Q8_GEMM:
        args, _ = s8_case(Q, rn, ep, M, K, N, save)
        times[f"gemm_s8_epilogue {ep}{' save h' if save else ''} {M}x{K}->{N}"] = time_ms(
            lambda: Q.gemm_s8(*args), AB_ITERS)
        del args
    for model, spec in SHAPES.items():
        for ep, M, K, N, _ in spec["gemm"]:
            key = f"gemm_bf16_epilogue {ep} {M}x{K}->{N}"
            if key in times:
                continue
            a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N)
            times[key] = time_ms(lambda: F.gemm_epilogue(a, w, bias, ep, extra), AB_ITERS)
            del a, w, bias, extra
        for label, B, S, H, causal, _ in spec["attn"]:
            L = F._block_spec(S, causal)[0]
            key = f"attention_bwd {model} {label} {B}x{S} H={H}"
            if L > getattr(F, "ATTN_BWD_MAX_BLOCK", L) or key in times:
                continue
            qkv, do = rn(B, S, 3 * 64 * H), rn(B, S, 64 * H, std=0.1)
            times[key] = time_ms(lambda: F.attention_bwd(qkv, do, H, causal), AB_ITERS)
            times[key + " device"], times[key + " host us"] = queued_ms(
                lambda: F.attention_bwd(qkv, do, H, causal), AB_ITERS)
            del qkv, do
        torch.cuda.empty_cache()
    f32 = torch.float32
    for ep, M, K, N, _ in FP32_GEMM:
        a, w, bias, extra = gemm_operands(F, rn, ep, M, K, N, f32)
        times[f"gemm_f32_epilogue {ep} {M}x{K}->{N}"] = time_ms(
            lambda: F.gemm_epilogue(a, w, bias, ep, extra), AB_ITERS)
        del a, w, bias, extra
    for label, B, S, H, causal in FP32_ATTN_BWD:
        qkv, do = rn(B, S, 3 * 64 * H, dtype=f32), rn(B, S, 64 * H, std=0.1, dtype=f32)
        for name, fn in (("attention_fwd_f32", lambda: F.attention_fwd(qkv, H, causal)),
                         ("attention_bwd_f32", lambda: F.attention_bwd(qkv, do, H, causal))):
            key = f"{name} {label} {B}x{S} H={H}"
            times[key] = time_ms(fn, AB_ITERS)
            times[key + " device"], times[key + " host us"] = queued_ms(fn, AB_ITERS)
        del qkv, do
    for ep, M, K, N, save, *_ in F32_Q8_GEMM:
        args, _ = s8_case(Q, rn, ep, M, K, N, save, dtype=f32)
        times[f"gemm_s8_epilogue_f32 {ep}{' save h' if save else ''} {M}x{K}->{N}"] = time_ms(
            lambda: Q.gemm_s8(*args), AB_ITERS)
        del args
    for rows, D in FP32_LN:
        for way in LN_WAYS:
            case = fp32_ln_case(F, rn, rows, D, way)
            times[case["name"]] = time_ms(case["fn"], AB_ITERS)
            times[case["name"] + " device"], times[case["name"] + " host us"] = queued_ms(
                case["fn"], AB_ITERS)
            del case
    torch.cuda.empty_cache()
    return times


# CoCoOp's packed text rows at 1,000 classes (500 blocks of 192 rows)
M_T = 500 * 192
# the bf16 LayerNorm dx at every width a path reaches, as --times-of reads
# it: rows, D, dxn dtype, residual (the layers' fp32 dxn with r; the towers'
# own LayerNorms' bf16 dxn without); the text rows of ViT-B/16 and RN50
# (512; also CoCoOp's M_T), RN50x4 (640), ViT-L/14 (768); the chunked
# half's 1280 and 2048
LN_BWD_AB = ((M_B, 768, "float32", True), (M_B, 768, "bfloat16", False),
             (13 * 128, 512, "float32", True), (13 * 128, 512, "bfloat16", False),
             (M_T, 512, "float32", True), (M_T, 640, "float32", True),
             (13 * 128, 640, "float32", True), (13 * 128, 768, "float32", True),
             (M_L, 1024, "float32", True), (M_L, 1024, "bfloat16", False),
             (M_336, 1024, "float32", True), (M_336, 1024, "bfloat16", False),
             (M_H, 1280, "float32", True), (M_H, 2048, "float32", True))
# LayerNorm-quant as --times-of reads it: rows, D, x dtype, modes (the
# probe's ablations on its 128 x 200 rows)
Q8_LN_AB = ((M_B, 768, "bfloat16", ("q8", "q8_static")),
            (13 * 128, 512, "bfloat16", ("q8",)), (13 * 128, 640, "bfloat16", ("q8",)),
            (13 * 128, 768, "bfloat16", ("q8",)), (M_T, 512, "bfloat16", ("q8",)),
            (M_T, 640, "bfloat16", ("q8",)),
            (M_L, 1024, "bfloat16", ("q8", "q8_static")),
            (M_B, 768, "float32", ("q8", "q8_static")),
            (M_L, 1024, "float32", ("q8", "q8_static")),
            (128 * 200, 768, "bfloat16", ("q8_recip", "q8_noclip", "q8_floor")))
DTYPE_TAGS = {"float32": "fp32", "bfloat16": "bf16"}


def ln_bwd_cases(F, rn):
    """(name, call) of the bf16 LayerNorm dx at each case of
    ``LN_BWD_AB``, one case's tensors alive at a time."""
    import torch

    for rows, D, dxn_name, with_r in LN_BWD_AB:
        x = rn(rows, D, std=2.0)
        dxn = rn(rows, D, dtype=getattr(torch, dxn_name))
        s = rn(D, dtype=torch.float32) * 0.1 + 1
        r = rn(rows, D) if with_r else None
        name = f"layernorm_bwd {rows}x{D} {DTYPE_TAGS[dxn_name]} dxn" + (" + r" if with_r else "")
        yield name, lambda x=x, dxn=dxn, s=s, r=r: F.layer_norm_bwd(dxn, x, s, r)
        del x, dxn, s, r


def q8_row_cases(F, Q, rn):
    """(name, call) of the row quantizer at ViT-B/16's attention and g
    rows and of LayerNorm-quant at each case of ``Q8_LN_AB`` (its bf16 and
    fp32 instances, dynamic and static, and the probe's ablations), one
    case's tensors alive at a time."""
    import torch

    from mudpt_torch.ops import probe as P

    for X in (768, 3072):
        v = rn(M_B, X, dtype=torch.float32)
        one = torch.full((), 127.0, device=v.device)
        for kind, rr in (("dynamic", None), ("static", one / 4)):
            yield f"quant_rows {M_B}x{X} {kind}", lambda v=v, rr=rr: Q.quantize_rows(v, rr)
        del v
    for rows, D, dtype, modes in Q8_LN_AB:
        x = rn(rows, D, std=2.0, dtype=getattr(torch, dtype))
        s, b = rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1
        r = one / F.layer_norm_plain(x, s, b).float().abs().amax()
        for mode in modes:
            kind = {"q8": "dynamic", "q8_static": "static"}.get(mode, mode[3:])
            name = "layernorm_q8" + ("_f32" if dtype == "float32" else "")
            if mode.startswith("q8_") and mode != "q8_static":
                name += "_" + mode[3:]
                yield (f"{name} {rows}x{D}",
                       lambda x=x, s=s, b=b, mode=mode: P.ln_quant_mode(x, s, b, mode))
            else:
                yield (f"{name} {rows}x{D} {kind}",
                       lambda x=x, s=s, b=b, rr=r if mode == "q8_static" else None:
                       Q.ln_quant(x, s, b, rr))
        del x, s, b, r


def kernel_digests(F) -> dict:
    """A digest of the bits of each bf16 LayerNorm output, forward at the
    vision towers' rows and at D = 1280, dx at every case of ``LN_BWD_AB``,
    of the LayerNorm-quant's codes and scales at every case of ``Q8_LN_AB``
    (bf16 and fp32 rows, dynamic, static, the probe's ablations), of the
    row quantizer's, and of every bf16 s8 GEMM case of Q8_GEMM, on seeded
    inputs: two trees whose digests agree compute the same bits
    (``--times-of``); and of every fp32 s8 GEMM case at ViT-B/16's rows."""
    import hashlib

    import torch

    from mudpt_torch.ops import quant_block as Q

    def digest(*ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            if t is not None:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    rn = randn_fn(12)
    out = {}
    for key, fn in q8_row_cases(F, Q, rn):
        out[key] = digest(*fn())
    for key, fn in ln_bwd_cases(F, rn):
        out[key] = digest(fn())
    for kernel, cases, dtype in (("gemm_s8_epilogue", Q8_GEMM, None),
                                 ("gemm_s8_epilogue_f32",
                                  [c for c in F32_Q8_GEMM if c[1] == M_B], torch.float32)):
        for ep, M, K, N, save, *_ in cases:
            args, _ = s8_case(Q, rn, ep, M, K, N, save, dtype=dtype)
            got = Q.gemm_s8(*args)
            out[f"{kernel} {ep}{' save h' if save else ''} {M}x{K}->{N}"] = digest(
                *(got if save else (got,)))
            del args, got
    for rows, D in ((M_B, 768), (M_L, 1024), (2048, 1280)):
        x = rn(rows, D, std=2.0)
        s, b = rn(D, dtype=torch.float32) * 0.1 + 1, rn(D, dtype=torch.float32) * 0.1
        out[f"layernorm_fwd {rows}x{D}"] = digest(F.layer_norm_fwd(x, s, b))
        del x
    return out


def times_of(root: Path) -> int:
    """``python3 chip_smoke.py --times-of ROOT``: the kernel times of the
    mudpt_torch package of the checkout at ROOT (its kernels built there)
    and the digests of its bf16 LayerNorms' bits, one JSON line.  Run on two
    trees in turns (parent, change, change, parent) in one call to compare
    their kernels on one card."""
    import torch

    sys.path.insert(0, str(root))
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    if Path(F.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {F.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    print(json.dumps({"times_of": str(root), "card": smi(), "ms": kernel_times(F),
                      "digests": kernel_digests(F)}), flush=True)
    return 0


AB_STEPS = 5  # timed steps a median of --steps-of takes at 384


def steps_of(root: Path) -> int:
    """``python3 chip_smoke.py --steps-of ROOT``: MuDPT ViT-B/16 under PREC
    fp32 ([engine]'s configuration) on the mudpt_torch package of the
    checkout at ROOT (its kernels built there): the median ms of the step at
    64 and on the 384 images of epoch 1 as one batch and of the image
    encode at 384, then the same steps under TRAIN.QUANT int8_ste, one JSON
    line.  Run on two trees in turns (parent, change, change, parent) in
    one call to compare them end to end on one card."""
    import copy
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, str(root))
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F

    if Path(F.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {F.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    out = {"steps_of": str(root), "card": smi()}
    tmp = tempfile.mkdtemp(prefix="mudpt_steps_of_")
    try:
        for label, quant in (("fp32", ()), ("fp32 int8_ste", ("TRAIN.QUANT", "int8_ste"))):
            tr = _engine_trainer(root, f"{tmp}/{label}", "OPTIM.MAX_EPOCH", "1", *quant,
                                 *FP32_OPTS)
            bs = [tr._device_batch(b) for b in list(copy.copy(tr.dm.train_loader))]
            whole = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
            out[f"{label} step {ENGINE_BATCH}"] = fp32_timed(tr, bs[0], TIMED_STEPS)[0]
            out[f"{label} step {len(whole['image'])}"] = fp32_timed(tr, whole, AB_STEPS)[0]
            if not quant:
                with torch.no_grad():
                    txt = tr._text_features(tr.trainable, tr.frozen, tr.aux)
                    enc = [_synced_ms(lambda: tr._eval_step_cached(
                        tr.trainable, tr.frozen, tr.aux, whole["image"], txt))
                        for _ in range(1 + AB_STEPS)][1:]
                out[f"{label} encode {len(whole['image'])}"] = statistics.median(enc)
            del tr, bs, whole
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if sys.argv[1:2] in (["--times-of"], ["--steps-of"]):
        root = Path(sys.argv[2]).resolve()
    if not (root / "mudpt_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no mudpt_torch package in {root}", file=sys.stderr)
        return 3
    if sys.argv[1:2] == ["--times-of"]:
        return times_of(root)
    if sys.argv[1:2] == ["--steps-of"]:
        return steps_of(root)
    if sys.argv[1:2] == ["--serve-artifact"]:
        return serve_artifact(root, *sys.argv[2:6])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(root, *sys.argv[2:6])
    if sys.argv[1:2] == ["--cli-launches"]:
        return cli_launches(root, sys.argv[2:])
    sys.path.insert(0, str(root))
    from mudpt_torch.models import layers
    from mudpt_torch.ops import _build
    from mudpt_torch.ops import fused_block as F
    from mudpt_torch.ops import quant_block as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                  f"{torch.cuda.device_count()} device(s)")

    _build.load()
    regs = {name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in _build.build_logs.items()}
    say("build", f"{len(_build.SIGNATURES)} kernel sources built in "
                 f"{_build.build_seconds:.2f} s; ptxas: {json.dumps(regs)}")

    bf16_names, _, fp32_names, probe_names = kernel_groups(F)
    kernels = {name: Kernel(name) for name in bf16_names}
    kernels_l = {name: Kernel(name) for name in bf16_names}
    # one vision layer of the int8 request (attention_fwd's fp32 output
    # mode with them) and of the int8_static request
    kernels_q = {name: Kernel(name) for name in (*Q8_KERNELS, "attention_fwd")}
    kernels_qs = {name: Kernel(name) for name in Q8_KERNELS}
    # the same at ViT-L/14's int8 request
    kernels_ql = {name: Kernel(name) for name in (*Q8_KERNELS, "attention_fwd")}
    kernels_qls = {name: Kernel(name) for name in Q8_KERNELS}
    # one call of the chunked MLP half's forward and backward at ViT-L/14
    kernels_c = {name: Kernel(name) for name in CHUNKED_KERNELS}
    # one vision layer of the ViT-L/14@336px train step
    kernels_336 = {name: Kernel(name) for name in bf16_names}
    # one vision layer of the fp32 ViT-B/16 train step; the int8 tiers'
    # fp32 kernels: of the fp32 int8_ste step, and of the int8_ste_static one
    kernels_32 = {name: Kernel(name, F.KERNELS[name][0]) for name in fp32_names}
    fp32_q8 = [k for k in fp32_q8_kernels(F) if k in kernels_32]
    kernels_32s = {name: Kernel(name, F.KERNELS[name][0]) for name in fp32_q8}
    # the probes' kernels: the rate kernel's one call at G1, the ablations'
    # one layer of the probe's shape
    kernels_p = {name: Kernel(name, F.KERNELS[name][0]) for name in probe_names}
    # attention on the 77-token rows of TEXT_TRUNC 0, both dtypes (ATTN_77)
    kernels_t77 = {name: Kernel(name, F.KERNELS[name][0]) for name in ATTN_77_KERNELS}
    paths = {}

    def run(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(phase, f"phase done in {time.perf_counter() - t0:.1f} s")
        return out

    rn = run("kernels", phase_kernels, F, kernels, "ViT-B/16")
    run("kernels", phase_attention_profiles, F)
    run("kernels", phase_attention_sweep, F)
    run("kernels", phase_layer_chains, F, rn)
    paths["serving"] = run("serving", phase_serving, F, "ViT-B/16")
    paths["train_step"] = run("train", phase_train, F, "ViT-B/16")
    paths["engine_train_step"] = run("engine", phase_engine, F, root)
    run("bench", phase_bench, F)
    paths.update(run("zoo", phase_zoo, F, root))
    paths.update(run("datasets", phase_datasets, F, root))
    paths.update(run("mesh", phase_mesh, F, root))
    run("kernels ViT-L/14", phase_kernels, F, kernels_l, "ViT-L/14")
    run("kernels ViT-L/14", phase_halfblock_chains, F)
    paths["serving_vit_l14"] = run("serving ViT-L/14", phase_serving, F, "ViT-L/14")
    paths["train_step_vit_l14"] = run("train ViT-L/14", phase_train, F, "ViT-L/14")
    run("kernels ViT-L/14@336px", phase_kernels, F, kernels_336, "ViT-L/14@336px")
    paths["serving_vit_l14_336px"] = run("serving ViT-L/14@336px", phase_serving, F,
                                         "ViT-L/14@336px")
    paths["train_step_vit_l14_336px"] = run("train ViT-L/14@336px", phase_train, F,
                                            "ViT-L/14@336px")
    run("kernels int8", phase_kernels_int8, F, Q, kernels_q, kernels_qs)
    run("kernels int8", phase_q8_chains, F, Q, layers)
    for quant in ("int8", "int8_static"):
        paths[f"serving_{quant}"] = run(f"serving {quant}", phase_serving, F, "ViT-B/16", quant)
    for quant in ("int8_ste", "int8_ste_static"):
        paths[f"train_step_{quant}"] = run(f"train {quant}", phase_train, F, "ViT-B/16", quant)
    run("kernels int8 ViT-L/14", phase_kernels_int8, F, Q, kernels_ql, kernels_qls, "ViT-L/14")
    run("kernels int8 ViT-L/14", phase_q8_chains, F, Q, layers, "ViT-L/14")
    for quant in ("int8", "int8_static"):
        paths[f"serving_vit_l14_{quant}"] = run(f"serving ViT-L/14 {quant}", phase_serving, F,
                                                "ViT-L/14", quant)
    paths["train_step_vit_l14_int8_ste"] = run("train ViT-L/14 int8_ste", phase_train, F,
                                               "ViT-L/14", "int8_ste")
    paths.update(run("zoo int8", phase_zoo_int8, F, root))
    paths.update(run("cocoop int8", phase_cocoop_int8, F, root))
    paths.update(run("rn", phase_rn, F, root))
    paths.update(run("kernels chunked", phase_kernels_chunked, F, kernels_c))
    run("fp32", phase_kernels_fp32, F, kernels_32)
    paths.update(run("fp32", phase_fp32_chains, F))
    fp32_paths, fp32_row = run("fp32", phase_fp32, F, root)
    paths.update(fp32_paths)
    run("fp32 int8", phase_kernels_fp32_int8, F, Q, kernels_32, kernels_32s)
    paths.update(run("fp32 int8", phase_fp32_q8_chains, F, Q, layers))
    paths.update(run("fp32 int8", phase_fp32_int8, F, root, fp32_row))
    paths.update(run("export", phase_export, F, root))
    paths["remat_full_step"] = run("remat", phase_remat, F, "ViT-B/16")
    paths["remat_full_step_vit_l14_336px"] = run("remat ViT-L/14@336px", phase_remat, F,
                                                 "ViT-L/14@336px")
    paths["block_xla_request"] = run("block xla", phase_block_xla, F)
    paths.update(run("probes", phase_probes, F, Q, kernels_p))
    paths.update(run("text switches", phase_text_switches, F, root, kernels_t77))
    paths.update(run("tools", phase_tools, F, root))
    paths.update(run("periphery", phase_periphery, F, root))
    paths.update(run("api", phase_api, F, root))
    say("processes", check_no_process_left())

    def by_path(name: str) -> dict:
        return {path: counts[name] for path, counts in paths.items()}

    records = [k.record(by_path(name), "train_step", vit_l14=kernels_l[name],
                        vit_l14_336px=kernels_336[name],
                        **({"int8": kernels_q[name], "int8_vit_l14": kernels_ql[name]}
                           if name in kernels_q else {}),
                        **({"chunked": kernels_c[name]} if name in kernels_c else {}),
                        **({"text_77": kernels_t77[name]} if name in kernels_t77 else {}))
               for name, k in kernels.items()]
    records += [kernels_q[name].record(by_path(name), "serving_int8", int8_static=kernels_qs[name],
                                       int8_vit_l14=kernels_ql[name],
                                       int8_static_vit_l14=kernels_qls[name])
                for name in Q8_KERNELS]
    records += [kernels_32[name].record(
        by_path(name), "fp32_train_step",
        **({"text_77": kernels_t77[name]} if name in kernels_t77 else {}))
        for name in fp32_names if name not in fp32_q8]
    records += [kernels_32[name].record(by_path(name), "fp32_int8_ste_train_step",
                                        fp32_int8_ste_static=kernels_32s[name])
                for name in fp32_q8]
    records += [kernels_p[name].record(by_path(name), "probe_int8_mxu" if name.startswith(
        "probe_mma") else "probe_q8_residual") for name in probe_names]
    print(json.dumps({"kernels": records}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
