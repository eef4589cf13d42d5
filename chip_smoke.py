#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits nonzero, with no result):
  1. device  - the card (nvidia-smi name and power limit); TF32 off for parity
  2. build   - nvcc of every csrc/*.cu kernel (into build/torch_kernels/)
  3. K1      - the MSDA kernel against its plain PyTorch version on the card,
               at the encoder (Q = L, 2-d refs) and decoder (Q = 900, 4-d refs)
               shapes of the 800x1216 bucket
  4. K2      - the fusion kernel against its plain version at the encoder
               fusion shape (Nv = 20197, Nl = 256 with 41 live tokens, E = 1024);
               its library's SASS must hold tensor-core MMA instructions
               (cuobjdump), and ptxas's registers, shared memory and spills
               of each of its kernels are printed
  5. serve   - load_model + predict at full Swin-T / BERT-base width (seeded
               random weights, synthetic 30522-entry WordPiece vocab) on three
               images of different sizes with two captions; counts the kernel
               launches of that run (12 K1 + 6 K2 per request)
  6. forward - one request's pred_logits / pred_boxes on the card against the
               same model on the CPU (plain versions), flip-aware
  7. profile - torch.profiler over one request: device time by kernel group
               (read from the profiler's raw kineto events, as every profile
               of the smoke; here also held against key_averages())
  8. K3      - the MSDA backward kernel against autograd of K1's plain
               version (grad_value, grad_locs, grad_attn), and K1 against its
               plain version on the same operands (and timed: 12 of its
               launches a step run at these shapes), at the encoder and
               decoder shapes of a B = 4 training batch of the 800x1216
               bucket whose images each have their own valid region, with a
               seeded upstream gradient; K1 and K3 (here and in phase 3) also
               by torch.profiler's device time; ptxas's report of the K1,
               K3, K5, K6/K7, K8, K9 and K10 libraries, K3's, K9's and K10's
               launch plans and K5's-K8's tiles against each library's count
               of their shared memory, and the atomics in K3's, K9's and
               K10's SASS
  9. K4      - the fusion backward kernel against autograd of K2's plain
               version (gq, gk, gvv, gvl), and K2 against its plain version
               on the same operands, at the encoder fusion shape of that
               B = 4 batch, each image with its own valid region and live
               text count; K2 is also timed there, against its B = 4 bound;
               phase 4's SASS and ptxas report for both fusion libraries
 10. train   - the port's training entry (open_groundingdino_tpu_torch.main) on
               a synthetic 8-image ODVG set at full Swin-T / BERT-base width
               and depth, B = 4, f32, from the seeded checkpoint: 1 warm-up +
               5 timed steps, each loss finite; median step time, peak device
               memory beside the allocation when the run began (after a
               garbage collection; each training phase reads it), and the
               launches of K1-K4 (12 / 6 / 12 / 6 a step: the checkpointed
               blocks keep the kernels' outputs, remat_save_kernels); then
               torch.profiler over one more step
 11. train parity - one training step on the card and the same step on the
               CPU (plain versions): B = 1, the 800x1216 bucket, droppath 0;
               loss within 5e-3, each top-level module's gradient norm within
               1e-2 and the gradient of each parameter that K3 or K4 feeds
               within 1e-2, relative; then the card's step with K3's
               grad_locs, and apart K4's gvl, negated must fail that check
 12. sweep   - the sweep MSDA kernels (the JAX package's msda_impl="pallas"
               with MSDA_BANDED=0): K6 (and K7 on the decoder's sorted query
               set), K9 and K10 against their plain versions on the operands
               the model path gives them, at phase 8's encoder and decoder
               shapes (K10's tap gradients on every tap; each kernel also by
               torch.profiler's device time); then the sweep op against K1
               and K3 on the same inputs; then K6 and K7 at phase 3's B = 1
               shapes
 13. sweep serve - load_model + predict through msda_kernel="sweep" (K6), and
               again with msda_dec_fused=True (K7 in the decoder), on phase
               5's requests; each one forward against phase 6's CPU forward,
               flip-aware; a profiled request of each (the fused one reads
               K7's time on its path)
 14. sweep train - main with --options msda_kernel=sweep: 2 B = 4 steps (K6,
               K9) and a profiled one; then 1 step with msda_sweep_bwd=rowtap
               (K6, K10) and a profiled one
 15. sweep train parity - phase 11's step through the sweep, with the corner
               (K9) and the row-tap (K10) backward, against the gather's step
               on the card: loss within 5e-3, each gradient the MSDA kernels
               feed within 1e-2; with K9's, and apart K10's, gw negated each
               must fail
 16. K5, K8  - the per-point banded forward K5 and the corner-tap sweep
               forward K8 against their plain versions on the operands their
               paths give them, and each op against K1 on the same inputs, at
               phase 3's B = 1 and phase 8's B = 4 encoder and decoder shapes
               (each kernel also by torch.profiler's device time)
 17. banded serve - load_model + predict through msda_kernel="banded_point"
               (K5: 12 a request, no K1) on phase 5's requests; one forward
               against phase 6's CPU forward, flip-aware; a profiled request
 18. banded train - main with --options msda_kernel=banded_point: 2 B = 4
               steps (12 K5 and 12 K3 a step) and a profiled one; then phase
               11's step through K5 against the gather's step on the card:
               loss within 5e-3, each MSDA-fed gradient within 1e-2
 19. microbench - open_groundingdino_tpu_torch.tools.msda_microbench with
               --sweep --fwd_variant corner --banded_mp 0 --bwd --xla: K5 and
               K8 (K3 and K9 under --bwd) at the flagship B = 4 encoder shape;
               then with --dtype bf16 (no --xla): their bf16 entries only
 20. bf16 kernels - the bf16 entries of K1 and K3 (phase 3's B = 1 and phase
               8's B = 4 encoder and decoder shapes) and of K2 and K4 (phase
               4's B = 1 and phase 9's B = 4 fusion shapes) against their bf16
               plain versions on the card (forward outputs within 1e-2 of each
               output's largest |reference|, K2's out_l within twice its
               out_v's error, K3's grad_value within 3e-2 and grad_locs /
               grad_attn within 1e-3, K4's gradients within 1e-2),
               by CUDA events and torch.profiler's device time, against bounds
               at bf16 bytes and the bf16 tensor-core rate; K2's and K4's
               libraries must hold HMMA.16816.F32.BF16, K3's bf16 global
               reductions
 21. bf16 train - main with the config's default compute_dtype (bf16) at
               B = 4, full width and depth: 1 warm-up + 5 timed steps, each
               loss finite, 12 K1 + 12 K3 + 6 K2 + 6 K4 bf16 launches a step
               and no f32 one; a profiled step; then phase 11's step in bf16
               on the card against phase 11's f32 step on the card: loss
               within 2e-2 and each K3/K4-fed gradient within 0.75, relative
               (bf16 itself moves some by ~0.4 at these random weights);
               with the bf16 K3's grad_locs, and apart the bf16 K4's gvl,
               negated each must fail
 22. eval    - main --eval on a COCO val split of the 8 ODVG images (their
               boxes as annotations) at full width and depth, B = 4, with the
               config's bf16 and with compute_dtype=float32: eval_stats.json
               with the 12 finite COCO stats, 12 K1 + 6 K2 launches a batch in
               the compute dtype's entry and no other kernel; images/s over a
               second pass, in bf16 one batch's device busy share under
               torch.profiler.  Then one B = 4 eval batch (4 images of the
               800x1216 bucket, each with its own valid region) through
               make_eval_step + PostProcess in f32 on the card and on the CPU
               (plain versions), flip-aware with phase 6's limits; the CPU's
               detections after NMS give a pseudo ground truth on which the
               CPU scores AP 1.0 and the card within 0.02 of it; with K1's
               output negated the card's AP must fall by more than 0.3; the
               bf16 eval's AP on it is recorded
 23. checkpoints - main at B = 4, bf16, one step an epoch, use_ema, with that
               pseudo ground truth as its val split: 2 epochs, and apart 1
               epoch then 2 in one directory (resuming from
               checkpoint_0.pth); the restored state equals the saved one bit
               for bit (parameters, both AdamW moments and the count, the EMA,
               step, nonfinite_count, the stochastic-depth generator), the
               epoch-1 loss matches the continuous run's within 1e-3
               relative, best/ and best_ema/ exist, every log.txt line holds
               the JAX package's keys, and load_model on checkpoint_1.pth
               answers a request
 24. bf16 sweep kernels - the bf16 entries of K6 and K7 (phase 8's B = 4
               and phase 3's B = 1 shapes, K7 on the decoder's sorted query
               set) and of K9 and K10 (B = 4) against their bf16 plain
               versions on phase 12's operands (forwards and grad_value within
               1e-2 of each output's largest |reference|, gw and gpx within
               1e-3), by CUDA events and torch.profiler's device time, against
               bounds at bf16 value and g bytes and f32 grad_value bytes;
               ptxas's report of the four bf16 instances (K6 and K7 without
               spills), and K9's and K10's bf16 SASS must hold f32 global
               reductions and no bf16x2 one
 25. bf16 sweep train - main --options msda_kernel=sweep in the config's
               default bf16 at B = 4, full width and depth: 1 warm-up + 1
               timed step, each loss finite, 12 K6 + 12 K9 + 6 K2 + 6 K4
               bf16 launches a step and no other; 1 step with
               msda_sweep_bwd=rowtap (12 K10 bf16), and 1 with
               msda_dec_fused=True (6 K6 + 6 K7 bf16); phase 15's
               step in
               bf16 through the sweep (corner and row-tap backward) against
               phase 15's f32 sweep steps on the card: loss within 2e-2 and
               each MSDA-fed gradient within 0.75, relative, beside its
               distance from phase 21's bf16 gather step; with K9 bf16's, and
               apart K10 bf16's, gw negated each must fail; then main --eval
               through the sweep in bf16 on phase 22's val split: 12 finite
               stats, 12 K6 + 6 K2 bf16 launches a batch, images/s
 26. bf16 K5, K8 - the bf16 entries of K5 and K8 against their bf16 plain
               versions on phase 16's operands (B = 1 and B = 4, encoder and
               decoder), and the ops that launch them against K1 bf16, each
               within 1e-2 of the output's largest |reference| (a negated
               output must fail), by CUDA events and torch.profiler's device
               time, against the bound at bf16 value rows; ptxas's report of
               both bf16 instances (no spills)
 27. bf16 banded train - main --options msda_kernel=banded_point in the
               config's default bf16 at B = 4, full width and depth: one
               epoch of 2 steps with its eval of the 8 images as a COCO val
               split, 12 K5 + 12 K3 + 6 K2 + 6 K4 bf16 launches a step and
               12 K5 + 6 K2 bf16 an eval batch, no other; a profiled step;
               phase 18's step in bf16 against phase 18's f32 banded_point
               step on the card (phase 21's limits), beside its distance from
               phase 21's bf16 gather step; with K5 bf16's output negated it
               must fail
 28. backbones serve - the JAX package's other published geometries at full
               width: cfg_swinb (swin_B_384_22k), cfg_swinl (swin_L_384_22k),
               cfg_resnet50 and cfg_resnet50 with dilation=True (seeded
               weights with random biases; ResNet's FrozenBN terms drawn near
               the identity, draw_frozen_bn), each
               through inference.Model on the card: a warm-up and one
               predict_with_classes request on each of phase 5's three
               images, 12 K1 + 6 K2 f32 launches a request and no other,
               median latency, peak memory; one forward
               against the same checkpoint on the CPU: as served, fewer than
               10% of the queries flipped (and how many queries the two
               devices give other encoder tokens); then on the CPU's
               two-stage selection (TwoStageSelection: near-tied scores swap
               places, and a swap moves every query through the decoder's
               per-index embeddings and self-attention), flip-aware with
               phase 6's limits; for
               Swin-B the card's forward with K1's output negated must fail
               it; the dilated model (levels 100x152,
               50x76, 50x76, 25x38, L = 23750) holds K1 and K3, f32 and bf16,
               against their plain versions on its encoder operands; annotate
               draws one Swin-B request's boxes into an image
 29. backbones train - main with cfg_swinl in the default bf16 at B = 4:
               2 steps (12 K1 + 12 K3 + 6 K2 + 6 K4 bf16 a step, no other),
               then 1 more step of that model with
               use_checkpoint off (no per-block recompute; the same
               launches, the kernels' outputs being saved either way) for
               the peak memory the recompute saves; phase 11's f32 B = 1 step on ResNet-50 on the card
               against the CPU with main's freeze policy (phase 11's limits,
               on the CPU's two-stage selection as in phase 28; the stem,
               layer1 and every FrozenBN buffer bit-exact after it, every
               other trunk tensor moved); phase 11's step on the dilated
               ResNet-50 on the card (exact f32 launches), whose K1 and K3
               (f32 and bf16) are held against their plain versions on its
               encoder operands
 30. pave    - the PAVE vehicle-damage pipeline on phase 5's checkpoint and a
               seeded 1080x1920 frame: (a) a seeded full-width M1.1 RepViT +
               Semantic-FPN segmentor (classifier bias set so 30% of the
               pixels are car), derive_car_bbox's logits on the card against
               the CPU's within SEG_LOGIT_RTOL of max|logit|, the masks equal
               where the CPU's margin clears it, its time and peak memory; (b)
               tools/inference_pave.py end to end with --car_bbox (21 512x512
               crops, each in the 608x928 bucket) and with
               --car_seg_checkpoint, each run with n_crops x (12 K1 + 6 K2)
               f32 launches and no other, the median frame and per-crop time,
               a profiled crop, its first crop's forward against the CPU's on
               its two-stage selection with phase 6's limits (a negated K1
               must fail them); (c)
               pave/batch_eval.run_batch_eval over a two-frame manifest at
               batch_size 16 in the config's bf16 through make_eval_step +
               PostProcess.device (batches of 16 and 5 a frame): 12 K1 + 6 K2
               bf16 launches a batch and no other, crops/s and frames/s, peak
               memory, a profiled B = 16 batch, a finite summary that
               tools/get_metrics.py reads back from its CSV; (d) K1 (encoder,
               decoder) and K2 on that B = 16 batch's own operands, f32 and
               bf16, against their plain versions (K1_TOL / K2_TOL, phase 20's
               bf16 limits), timed beside their bounds
 31. export  - the serving artifacts (serving.py through torch.export, the
               forward kernels as the custom ops of ops/library.py):
               tools/export_model.py in subprocesses for the 800x1216
               bucket on the card, on phase 5's checkpoint (gather) and on
               a checkpoint of one encoder and one decoder layer at full
               width on the sweep (msda_dec_fused: K6, K7) and banded_point
               (K5) paths; each artifact loaded by load_exported in a fresh
               process (serve_artifact) and its forward held against the
               eager forward of its checkpoint on the card with phase 6's
               limits, its launches exactly the eager forward's; the gather
               artifact's requests 12 K1 + 6 K2 f32 launches and no other,
               predict and predict_with_spans equal to eager, a negated K1
               failing the comparison; export seconds, artifact sizes,
               load seconds, the median latency and profiled busy time of
               its requests beside eager predict's on the same request (its
               profile phase 7's)
 32. roberta - the RoBERTa text encoder at full width: a 50265-entry
               byte-level BPE vocabulary learnt from a seeded corpus
               (write_bpe_vocab), phase 5's config with roberta-base's
               geometry (514 positions, one token type) and its seeded
               checkpoint; (a) load_model with the vocab.json + merges.txt
               directory, 3 predict requests (12 K1 + 6 K2 f32 launches each,
               no other; phrases words of the caption), predict_with_spans, a
               profiled request; the checkpoint cut to 1 encoder and 1 decoder
               layer (text tower and Swin-T whole) on the card against the CPU
               on its two-stage selection with phase 6's limits, a negated K1
               failing them; (c) tools/zero_shot_eval.py --debug in a fresh
               process on a pseudo ground truth of the served model's bf16
               detections: 12 rows and the JSON line, AP in (0, 1], 12 K1 + 6
               K2 bf16 launches a batch, the C++ matcher built and used, its
               numbers within 1e-6 of main --eval --debug in this process with
               the numpy matcher; (b) main with text_dropout=0.1 in bf16 at
               B = 4, 2 steps (12 K1 + 6 K2 + 12 K3 + 6 K4 bf16 a step), then
               the served model's training-mode loss on the run's first batch
               with the step generator seeded 0 (twice: each within 1e-6 of
               main's first step's loss) and 1 (another loss), and the
               embeddings' dropped share within 4 sigma of 0.1
 33. dist    - data parallelism through main on the one card, f32, TF32 off,
               phase 22's checkpoint at full width and depth, 8 seeded
               800x1066 images with one category each (every batch pads to
               800x1216) and a val split whose ground truth is the
               checkpoint's own detections on the even ids and the ODVG boxes
               on the odd ones: (a) 2 ranks over gloo, both on cuda:0, each a
               fresh process with torchrun's variables running main inside
               torch.profiler, B = 2 a rank, 2 steps and the eval; (b) main in
               this process as rank 0 of 1 over NCCL at B = 4 on the same
               steps and eval.  The ranks' parameters equal bit for bit
               (all-gathered digests), their losses and stats the same, each
               step's loss within 5e-3 of (b)'s, the update within 5e-2 and
               each stat within 0.05; rank 0 alone wrote the checkpoint (best/
               a hard link to it) and log.txt; the merged eval saw the 8 ids
               once; 12 K1 + 6 K2 + 12 K3 + 6 K4 f32 launches a step and 12
               K1 + 6 K2 an eval batch on each rank and in (b); (c) planted
               faults: each step's loss from its criterion inputs with
               per-rank num_boxes / num_pos leaves the 5e-3 limit, a step
               without the gradient reduction parts the
               ranks, an eval without the merge sees 4 ids a rank and moves
               the stats by more than 0.05; the seconds of each part, the step
               medians, the reduction's share of the step and the merged
               eval's images/s
 34. ops and tools - every kernel as a differentiable op: torch.library
               .opcheck of the ten ogd_torch ops on CUDA tensors at small
               shapes in the kernels' geometry, f32 and bf16, the forwards on
               operands that require a gradient (schema, fake, registered
               autograd, AOT dispatch; K3 bf16's comparisons within 3e-2 of
               its largest grad_value: its bf16 atomics part two runs); one
               fusion block and one gather encoder layer at flagship width
               (B = 2, the 800x1216 bucket's levels, f32) compiled fullgraph
               through AOTAutograd: K2 and K1 in the forward graph, K3 and K4
               in the backward, one launch each, the loss and every gradient
               within phase 11's limits of eager, a compiled run with K3's
               grad_locs negated outside them; then the tools once each at
               flagship size: benchmark (B = 1 f32 forward; B = 4 bf16
               --train at one step a call and at --steps_per_call 2, its
               FLOPs holding K1-K4's formulas), profile (B = 4 bf16, 2
               iterations),
               serving_bench (the 800x1216 bucket),
               eval_pipeline_bench (8 images, B = 4), matcher_microbench and
               opt_microbench: the JAX tools' keys, every launch counted
 35. device step - the training step with no host read inside it, bf16,
               B = 4, at flagship width: the LSAP kernel (the Hungarian
               matcher on the device) against its plain version on the
               (28, 900, 128) costs of the step's own criterion (the same
               indices, no overflow; total cost against scipy within 1e-5)
               and on degenerate matrices (ties, +/-inf, a spinning row:
               the same indices and overflow flags), timed beside scipy;
               one step under set_sync_debug_mode("error") (and "warn",
               which lists any synchronisation) between the batch's copy
               and the read of its metrics; the step's median with the
               device matcher and with scipy on the host; a steps_per_call
               = 2 call against two single steps; main with steps_per_call
               = 2 (one multi-step call)
 36. saved kernels, flat AdamW - on phase 35's weights and batches: (a) the
               bf16 B = 4 step with the checkpointed blocks keeping the
               kernels' outputs (remat_save_kernels, the default: 12 K1 + 6
               K2 bf16) against the step that replays them (18 + 12), three
               of each from the same weights and draws, in turns: the
               launches exact, the losses bit-equal, the whole gradient
               within 1.5x and each gradient K3 or K4 computes within 3x
               (+ 1e-5 of its norm) the largest distance between two runs
               of one arm (K3's bf16 atomics); a cache that hands back
               fusion_fwd's out_v x 1.01, and one that hands back another
               image's MSDA output, must fail that; each arm's
               peak memory, host ms to issue a step and step median over
               full steps in turns, device busy of a profiled step, and the
               host and device ms of one checkpointed fusion block and one
               encoder layer, the outputs kept, replayed, and kept through
               torch's selective checkpoint.  (b) the port's AdamW (one
               f32 buffer a group) against a plain per-tensor AdamW on the
               858 flagship tensors and (a)'s gradients: three updates, the
               second non-finite (a no-op in both), parameters and moments
               within 1e-6 of their max after each; an AdamW with the
               next count's bias correction must fail; one update's device
               launches of each (torch.profiler) and its host-clock time,
               in turns; every number beside the card's name and
               power limit
The CPU references of phases 11, 22, 28 and 29 (a B = 1 training step, a
B = 4 eval forward, one forward of each backbone, the ResNet-50 step) run
one after the other on a thread beside the card's phases, which join each
result where they compare.  Each main training run asks for one
checkpoint, after its last epoch, and with a val split best/ (and
best_ema/) as hard links to it when the epoch scores best; train()'s runs
do not write theirs (no phase reads them), phase 23's and 33's do (the
card's machine takes at most 45 GiB of disk writes a run).
Every training phase runs with the config's use_checkpoint,
use_transformer_ckpt and remat_save_kernels (all True): Swin recomputes
each block in the backward and the encoder's fusion blocks and deformable
layers recompute all but their kernels' outputs, as the JAX package
does.  A [time] line after each phase gives its seconds.
then the {"kernels": [...]} line (K1-K10, then the bf16 entries of all ten;
K1's and K2's rows hold phase 30 under launches_by_path "pave" and per_shape
"pave B=16 ...", K1's, K2's, K5's, K6's and K7's phase 31 under
launches_by_path "export", K1's-K4's rows, f32 and bf16, phase 32 under
"roberta" (its requests and training steps) and "zero_shot", and K1's-K4's
f32 rows phase 33 under "dist" (rank 0 of the gloo pair) and "dist-nccl",
and phase 34's compiled layers ("compiled", K1-K4 f32) and tools ("tools
<name>"), and the bf16 K1-K4 rows phase 36's step launches with the
kernels' outputs saved and replayed ("save-kernels-step",
"replay-kernels-step"); last the LSAP kernel's row, phase 35's) and, last,
{"ok": true, "device": {...}}.

Exits nonzero when no CUDA device is present.  Scratch files (checkpoint,
vocab, the ODVG set and its COCO val splits, the runs' outputs and
checkpoints) go to build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import contextlib
import gc
from concurrent import futures
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

from open_groundingdino_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = (800, 1216)
HEADS, HEAD_DIM, LEVELS, POINTS = 8, 32, 4, 4      # flagship MSDA geometry
FUSION_E, FUSION_HEADS, TEXT_LEN, LIVE_TEXT = 1024, 4, 256, 41
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores (the MSDA kernels compute in f32 on the SIMT units)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the least time f32-accurate products take on the tensor cores: 3xTF32, three
# TF32 products (495 TFLOP/s dense) for each f32 one; the fusion kernels' rate
TF32X3_FLOP_PER_S = 495e12 / 3
# the bf16 entries of K2 and K4: one bf16 MMA with f32 sums a product (989
# TFLOP/s dense)
BF16_FLOP_PER_S = 989e12
K1_TOL = 1e-4   # f32; only the order of the 64 weighted taps differs
K2_TOL = 1e-4   # f32; online softmax and split partials reorder the sums
# K3 and K4 against autograd of the plain versions, relative to the largest
# |reference| of each gradient: f32 sums of up to ~10^3 terms (K3: atomics in
# an order that changes from run to run, warp-shuffle trees; K4: flash tiles
# and split partials over 20k image tokens) taken in another order than
# cuBLAS and the scatter-add take them: a few 1e-7 relative, 1e-4 leaves room
K3_RTOL = 1e-4
K4_RTOL = 1e-4
# a B = 4 training batch of the 800x1216 bucket: each image's valid (h, w)
# region of the canvas and its caption's live text tokens (phases 8 and 9)
BATCH_VALID = ((800, 1066), (800, 1216), (608, 1216), (704, 939))
BATCH_LIVE_TEXT = (41, 9, 187, 256)
CAPTIONS = ("a cat . a dog .", "person . bicycle . car . traffic light .")
IMAGE_SIZES = ((480, 640), (720, 1280), (700, 500))   # (h, w): three buckets


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class PhaseClock:
    """Logs the seconds since the previous mark as each phase ends."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        log("time", f"phase {phase}: {now - self.last:.1f} s ({now - self.t0:.1f} s in all)")
        self.last = now


def level_shapes(h: int, w: int):
    """Feature-map shapes of the flagship model at an (h, w) bucket: Swin-T
    patch 4, three ceil-halving merges (out_indices 1, 2, 3), then the extra
    stride-2 3x3 conv level."""
    h, w = -(-h // 4), -(-w // 4)
    shapes = []
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    shapes.append(((h - 1) // 2 + 1, (w - 1) // 2 + 1))
    return tuple(shapes)


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn over `iters` back-to-back launches,
    after one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def json_safe(x):
    """x with every non-finite float (a device time no profile recorded) as
    None, so that json.dumps writes standard JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    return x


def kernel_device_ms(fn, iters: int, match, per_call: int = 0) -> float:
    """profiling.kernel_device_ms, its lost launches logged."""
    return profiling.kernel_device_ms(fn, iters, match, per_call,
                                      note=lambda msg: log("profiler", msg))


def padded_tokens(shapes, valid, device):
    """(B, L) bool, True where a feature-map position lies outside its
    image's valid (h, w) region of the BUCKET canvas (level strides 8, 16,
    32, 64)."""
    import torch

    masks = []
    for lvl, (h, w) in enumerate(shapes):
        s = 8 << lvl
        rows = torch.arange(h, device=device)[None, :, None]
        cols = torch.arange(w, device=device)[None, None, :]
        hv = torch.tensor([-(-vh // s) for vh, _ in valid], device=device)[:, None, None]
        wv = torch.tensor([-(-vw // s) for _, vw in valid], device=device)[:, None, None]
        masks.append(((rows >= hv) | (cols >= wv)).flatten(1))
    return torch.cat(masks, 1)


# ---------------------------------------------------------------- K1 (MSDA)
def msda_inputs(shapes, num_queries, ref_dim: int, g, device, valid=(BUCKET,)):
    """Seeded K1 operands at the model's layout for a batch of B = len(valid)
    images, each with its valid (h, w) region of the BUCKET canvas: value
    zeroed outside the region, as the model's masked value projection is.
    Encoder (ref_dim 2): every token queries around its own centre, scaled
    into its image's region; decoder (ref_dim 4): queries around random boxes
    inside it.  Offsets of a few pixels, as after training."""
    import torch

    B, H, D, NL, P = len(valid), HEADS, HEAD_DIM, LEVELS, POINTS
    L = sum(h * w for h, w in shapes)
    value = torch.randn(B, L, H, D, generator=g, device=device)
    offs = torch.randn(B, num_queries, H, NL, P, 2, generator=g, device=device) * 2.0
    ratio = torch.tensor([[vw / BUCKET[1], vh / BUCKET[0]] for vh, vw in valid],
                         device=device)[:, None, None, None, None, :]      # (x, y)
    if ref_dim == 2:
        centres = []
        for h, w in shapes:
            ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                    indexing="ij")
            centres.append(torch.stack([(xs.flatten() + 0.5) / w, (ys.flatten() + 0.5) / h], -1))
        ref = torch.cat(centres)[None, :, None, None, None, :] * ratio
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=device)
        locs = ref + offs / wh[None, None, None, :, None, :]
    else:
        cxcy = torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        bwh = 0.02 + 0.48 * torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        locs = (cxcy + offs / P * bwh * 0.5) * ratio
    logits = torch.randn(B, num_queries, H, NL * P, generator=g, device=device)
    attn = torch.softmax(logits, -1).view(B, num_queries, H, NL, P)
    value = value.masked_fill(padded_tokens(shapes, valid, device)[:, :, None, None], 0.0)
    return value, locs.contiguous(), attn.contiguous()


def msda_traffic(value, shapes, locs) -> tuple:
    """(distinct in-map corner (position, head) value rows these locations
    touch, in-map corners summed over every sample)."""
    import torch

    B, Q, H, NL, P, _ = locs.shape
    L = value.shape[1]
    touched = torch.zeros(B, H, L, dtype=torch.bool, device=locs.device)
    bh = (torch.arange(B, device=locs.device)[:, None, None, None] * H
          + torch.arange(H, device=locs.device)[None, None, :, None]) * L     # (B, 1, H, 1)
    corners, start = 0, 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[:, :, :, lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(locs[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                corners += int(inside.sum())
                touched.view(-1)[(bh + start + y * w + x)[inside]] = True
        start += h * w
    return int(touched.sum()), corners


def msda_bound_ms(value, shapes, locs, attn) -> tuple:
    """(least ms, "bytes"|"operations"): the value rows these locations touch
    (distinct in-map corner (position, head) rows, each read once), locations
    and weights read once and the output written once, against 2 FLOP per
    channel for every in-map corner plus ~16 FLOP of index math per sample."""
    B, Q, H, NL, P, _ = locs.shape
    D = value.shape[-1]
    rows, corners = msda_traffic(value, shapes, locs)
    nbytes = (rows * D * value.element_size() + locs.numel() * 4
              + attn.numel() * 4 + B * Q * H * D * value.element_size())
    ops = 2 * D * corners + 16 * B * Q * H * NL * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_msda(g, device):
    import torch

    from open_groundingdino_tpu_torch.ops import msda

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    rows = {}
    for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
        value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device)
        out_k = msda.ms_deform_attn(value, shapes, starts, locs, attn)
        out_p = msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)
        err = float((out_k - out_p).abs().max())
        ms = event_ms(lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn), 50)
        device_ms = kernel_device_ms(lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn),
                                     50, "msda_fwd_kernel")
        plain_ms = event_ms(lambda: msda.ms_deform_attn_plain(value, shapes, starts, locs, attn), 5)
        bound_ms, bound_by = msda_bound_ms(value, shapes, locs, attn)
        rows[name] = dict(Q=q, L=L, max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log("K1", f"{name}: Q={q} L={L} shapes={shapes} max|kernel-plain|={err:.3e} "
                  f"kernel {ms:.4f} ms (device time {device_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
        if not err <= K1_TOL:
            raise AssertionError(f"K1 {name}: max abs error {err} > {K1_TOL}")
        # the bf16-value entry point: both versions accumulate in f32 and
        # round the output to bf16 (8 significant bits), so they differ by at
        # most one bf16 step, 2^-7 of the largest output
        value_bf16 = value.to(torch.bfloat16)
        out_k = msda.ms_deform_attn(value_bf16, shapes, starts, locs, attn).float()
        out_p = msda.ms_deform_attn_plain(value_bf16, shapes, starts, locs, attn).float()
        err, tol = float((out_k - out_p).abs().max()), 2 ** -7 * float(out_p.abs().max())
        rows[name]["bf16_max_abs_err"] = err
        log("K1", f"{name} with bf16 values: max|kernel-plain|={err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 {name} bf16: max abs error {err} > {tol}")
    return rows


# ---------------------------------------------------------------- K2 (fusion)
def fusion_inputs(g, device, valid=((800, 1066),), live=(LIVE_TEXT,)):
    """Seeded K2 operands at the encoder fusion shape for B = len(valid)
    images of the 800x1216 bucket: the raw (B, N, E) projections, q
    pre-scaled by D^-0.5; image b's valid (h, w) region is valid[b] (the
    positions outside it padded at every level) and its caption has live[b]
    live text tokens.  The default is serving's: one 800x1066 image, 41
    live tokens."""
    import torch

    shapes = level_shapes(*BUCKET)
    nv = sum(h * w for h, w in shapes)
    B, D = len(valid), FUSION_E // FUSION_HEADS
    q = torch.randn(B, nv, FUSION_E, generator=g, device=device) * D ** -0.5
    k = torch.randn(B, TEXT_LEN, FUSION_E, generator=g, device=device)
    val_v = torch.randn(B, nv, FUSION_E, generator=g, device=device)
    val_l = torch.randn(B, TEXT_LEN, FUSION_E, generator=g, device=device)
    mask_v = padded_tokens(shapes, valid, device)
    mask_l = torch.arange(TEXT_LEN, device=device)[None] >= torch.tensor(live, device=device)[:, None]
    return q, k, val_v, val_l, mask_v, mask_l


def fusion_bound_ms(q, k, mask_v, mask_l) -> tuple:
    """Each operand read once and each output written once, against the
    products this data needs: logits for the (image, text) pairs some output
    reads (every image token with the live text, every text token with the
    live image), the image->text product over live text tokens, the
    text->image product over live image tokens.  f32 operands at the 3xTF32
    rate; bf16 ones, with the f32 statistics they write, at the bf16 rate."""
    B, nv, E = q.shape
    nl = k.shape[1]
    D = E // FUSION_HEADS
    es = q.element_size()
    rate = BF16_FLOP_PER_S if es == 2 else TF32X3_FLOP_PER_S
    nbytes = es * (3 * B * nv * E + 3 * B * nl * E) + mask_v.numel() + mask_l.numel()
    if es == 2:   # the f32 softmax statistics the bf16 entry writes
        nbytes += 4 * B * FUSION_HEADS * (nv + nl)
    products = 0   # multiply-adds of length D per head
    for lv, ll in zip((~mask_v).sum(-1).tolist(), (~mask_l).sum(-1).tolist()):
        products += (nv * ll + lv * nl - lv * ll) + nv * ll + nl * lv
    ops = 2 * D * FUSION_HEADS * products
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_sass(name: str) -> str:
    """cuobjdump's SASS of the built csrc/<name>.cu."""
    from open_groundingdino_tpu_torch.ops import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def ptxas_kernels(name: str, kernel_names) -> dict:
    """ptxas's registers, static shared memory and spill bytes of each kernel
    of csrc/<name>.cu (the build's -Xptxas -v report), keyed by the first of
    kernel_names (pairs of (mangled-name fragment, key)) each entry holds."""
    import re

    from open_groundingdino_tpu_torch.ops import build

    with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as f:
        ptxas = f.read()
    kernels = {}
    for entry, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry|\Z)",
                                  ptxas, re.S):
        kname = next((key for frag, key in kernel_names if frag in entry), entry)
        regs = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", body)]
        kernels[kname] = dict(registers=int(regs.group(1)) if regs else None,
                              static_smem=int(smem.group(1)) if smem else 0,
                              spill_bytes=sum(spill))
    return kernels


def sass_atomics(name: str, function: str = None) -> dict:
    """The atomics in the SASS of csrc/<name>.cu (of its kernels whose
    mangled names hold `function`, where one is given): vector global
    reductions (RED ... F32x4), scalar ones, bf16 ones, and shared-memory
    f32 atomics, which Hopper runs as compare-and-swap loops
    (ATOMS.CAST.SPIN)."""
    import re

    sass = library_sass(name)
    if function is not None:
        sass = "".join(part for part in sass.split("Function : ")[1:]
                       if function in part.split("\n", 1)[0])
    return {"red_global_f32x4": len(re.findall(r"RED\S*F32x4", sass)),
            "red_global_f32": len(re.findall(r"RED\S*\.F32\b(?!x)", sass)),
            "red_global_bf16x2": len(re.findall(r"RED\S*BF16", sass)),
            "atoms_cas": sass.count("ATOMS.CAST.SPIN")}


def msda_kernel_report(plans: dict) -> dict:
    """The MSDA gather kernels' ptxas report (K1, K3, K5-K10), their launch
    plans with their dynamic shared memory checked against each library's
    own count (K3: `plans`, the wrapper's msda_bwd_plan by shape; K9 and
    K10: corner_bwd_plan and rowtap_bwd_plan at phase 8's B = 4; K5-K8: their
    tile at phase 8's B = 4 and phase 3's B = 1, encoder and decoder shapes,
    K7 at the decoder's only), and the atomics in K3's, K9's and K10's
    SASS."""
    import ctypes

    from open_groundingdino_tpu_torch.ops import build, msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    def smem_fn(lib, nargs):
        fn = getattr(build.load(lib), f"{lib}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
        return fn

    fn = smem_fn("msda_bwd", 1)
    for shape, plan in plans.items():
        if fn(plan["smem_rows"]) != plan["smem_bytes"]:
            raise AssertionError(f"K3's plan at the {shape} gives {plan['smem_bytes']} B of shared "
                                 f"memory, the kernel needs {fn(plan['smem_rows'])}")
    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    bwd_plans = {"K9": ("msda_corner_bwd", sw.corner_bwd_plan),
                 "K10": ("msda_rowtap_bwd", sw.rowtap_bwd_plan)}
    fwd_tiles = {"K5": ("msda_banded_fwd", mb.fwd_smem_bytes),
                 "K6": ("msda_rowtap_fwd", sw.rowtap_fwd_smem_bytes),
                 "K7": ("msda_rowtap_fwd", sw.rowtap_fwd_smem_bytes),
                 "K8": ("msda_corner_fwd", sw.corner_fwd_smem_bytes)}
    found = {k: {} for k in (*bwd_plans, *fwd_tiles)}
    for part, q in (("encoder", L), ("decoder", 900)):
        qp = -(-q // sw.QBLOCK) * sw.QBLOCK
        for kname, (lib, plan_fn) in bwd_plans.items():
            plan = plan_fn(shapes, len(BATCH_VALID), qp, HEADS)._asdict()
            if smem_fn(lib, 1)(plan["smem_rows"]) != plan["smem_bytes"]:
                raise AssertionError(f"{kname}'s plan at the {part} gives {plan['smem_bytes']} B "
                                     f"of shared memory, the kernel needs "
                                     f"{smem_fn(lib, 1)(plan['smem_rows'])}")
            found[kname][part] = plan
        for batch in (1, len(BATCH_VALID)):
            tile = msda.msda_fwd_tile(batch, qp, HEADS)
            for kname, (lib, bytes_fn) in fwd_tiles.items():
                if kname == "K7" and part != "decoder":   # the decoder's sorted query set
                    continue
                smem = bytes_fn(LEVELS, tile)
                if smem_fn(lib, 2)(LEVELS, tile) != smem:
                    raise AssertionError(f"{kname}'s tile {tile} gives {smem} B of shared memory, "
                                         f"the kernel needs {smem_fn(lib, 2)(LEVELS, tile)}")
                found[kname][f"B={batch} {part}"] = {"tile_q": tile, "smem_bytes": smem}
    report = {
        "msda_fwd": ptxas_kernels("msda_fwd", (("kernelIf", "msda_fwd_kernel<float>"),
                                               ("bfloat16", "msda_fwd_kernel<bf16>"))),
        "msda_bwd": ptxas_kernels("msda_bwd", (("bfloat16", "msda_bwd_kernel<bf16>"),
                                               ("msda_bwd_kernel", "msda_bwd_kernel<float>"))),
        "msda_bwd_atomics": sass_atomics("msda_bwd"),
        "msda_bwd_plans": plans,
    }
    for lib, kernels in (("msda_banded_fwd", {"K5": "banded_fwd_kernel"}),
                         ("msda_rowtap_fwd", {"K6": "rowtap_fwd_kernel",
                                              "K7": "allq_fwd_kernel"}),
                         ("msda_corner_fwd", {"K8": "corner_fwd_kernel"}),
                         ("msda_corner_bwd", {"K9": "corner_bwd_kernel"}),
                         ("msda_rowtap_bwd", {"K10": "rowtap_bwd_kernel"})):
        # K6, K7, K9 and K10 are templates on the value type: their bf16
        # instances under "<kernel><bf16>", the f32 ones under the kernel's name
        report[lib] = ptxas_kernels(lib, [(f"{k}{BF16_MANGLED}", f"{k}<bf16>")
                                          for k in kernels.values()]
                                    + [(k, k) for k in kernels.values()])
        bwd = any(kname in bwd_plans for kname in kernels)
        if bwd:   # the f32 instance's (phase 24 reads the bf16 one's)
            report[f"{lib}_atomics"] = sass_atomics(lib, f"{next(iter(kernels.values()))}If")
        for kname in kernels:
            report[f"{kname}_plans"] = found[kname]
        log("sass", f"lib{lib}.so ({', '.join(kernels)}): ptxas {report[lib]}"
                    + (f", SASS atomics {report[f'{lib}_atomics']}" if bwd else "")
                    + "".join(f"; {kname} {'B = 4 plans' if bwd else 'tiles'} and dynamic shared "
                              f"memory {found[kname]}" for kname in kernels))
    log("sass", f"libmsda_fwd.so: ptxas {report['msda_fwd']}; libmsda_bwd.so: ptxas "
                f"{report['msda_bwd']}, SASS atomics {report['msda_bwd_atomics']}; K3 plans "
                f"(dynamic shared memory as the library counts it) {plans}")
    return report


def tensor_core_report(libs, nv: int) -> dict:
    """Each library's SASS (cuobjdump) must hold tensor-core MMA instructions
    (HMMA with TF32 from mma.sync, or HGMMA from wgmma); returns the count
    of each, ptxas's registers, static shared memory and spills of each
    kernel from the build's report, and the dynamic shared memory of the
    main kernel's two passes at Nv = nv image tokens."""
    import ctypes

    from open_groundingdino_tpu_torch.ops import build, fusion

    report = {}
    for name in libs:
        sass = library_sass(name)
        hmma = sum(1 for line in sass.splitlines() if "HMMA" in line and "TF32" in line)
        hgmma = sass.count("HGMMA")
        if hmma + hgmma == 0:
            raise AssertionError(f"{name}: no tensor-core MMA instruction in its SASS")
        kernels = ptxas_kernels(name, [(k, k) for k in ("attend_kernel", "combine_kernel",
                                                        "bwd_kernel", "sum_splits_kernel")])
        smem_fn = getattr(build.load(name), f"{name}_smem_bytes")
        smem_fn.argtypes, smem_fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        n_splits = max(2, min(64, -(-nv // fusion.IMAGE_TOKENS_PER_SPLIT)))
        dynamic = {"image_rows": smem_fn(TEXT_LEN, 1), "text_rows": smem_fn(nv, n_splits)}
        report[name] = dict(hmma_tf32=hmma, hgmma=hgmma, ptxas=kernels, dynamic_smem=dynamic)
        log("sass", f"lib{name}.so: {hmma} HMMA.TF32, {hgmma} HGMMA; ptxas {kernels}; "
                    f"dynamic shared memory {dynamic} bytes")
    return report


def check_fusion(g, device):
    from open_groundingdino_tpu_torch.ops import fusion

    args = fusion_inputs(g, device)
    q, k, val_v, val_l, mask_v, mask_l = args
    ov_k, ol_k = fusion.fused_bi_attention(*args, FUSION_HEADS)
    ov_p, ol_p = fusion.fused_bi_attention_plain(*args, FUSION_HEADS)
    err = max(float((ov_k - ov_p).abs().max()), float((ol_k - ol_p).abs().max()))
    ms = event_ms(lambda: fusion.fused_bi_attention(*args, FUSION_HEADS), 10)
    plain_ms = event_ms(lambda: fusion.fused_bi_attention_plain(*args, FUSION_HEADS), 3)
    bound_ms, bound_by = fusion_bound_ms(q, k, mask_v, mask_l)
    log("K2", f"Nv={q.shape[1]} ({int((~mask_v).sum())} live) Nl={k.shape[1]} "
              f"({int((~mask_l).sum())} live) "
              f"E={FUSION_E} H={FUSION_HEADS}: max|kernel-plain|={err:.3e} kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err <= K2_TOL:
        raise AssertionError(f"K2: max abs error {err} > {K2_TOL}")
    sass = tensor_core_report(("fusion_fwd",), q.shape[1])
    return dict(Nv=q.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, sass=sass)


# ---------------------------------------------------------------- K3 (MSDA backward)
def msda_bwd_bound_ms(value, shapes, locs, attn, grad_value_size: int = None) -> tuple:
    """(least ms, "bytes"|"operations"): the touched value rows, locations,
    weights and upstream gradient read once; grad_value (whole; of
    `grad_value_size` bytes an element, by default value's), grad_locs and
    grad_attn written once; against 8 FLOP per channel for every in-map
    corner (the value product, the scatter and the two location derivatives)
    plus ~16 FLOP of index math per sample."""
    B, Q, H, NL, P, _ = locs.shape
    D = value.shape[-1]
    rows, corners = msda_traffic(value, shapes, locs)
    es = value.element_size()   # value and upstream gradient
    nbytes = (es * (rows * D + B * Q * H * D) + (grad_value_size or es) * value.numel()
              + 4 * (2 * locs.numel() + 2 * attn.numel()))
    ops = 8 * D * corners + 16 * B * Q * H * NL * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_msda_bwd(device):
    """K3 against autograd of the plain version, and K1 against the plain
    version on the same operands, at the encoder and decoder shapes of a
    B = 4 training batch (BATCH_VALID: each image its own valid region) with
    a seeded upstream gradient."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    B = len(BATCH_VALID)
    rows = {}
    for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
        value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, BATCH_VALID)
        fwd_err = float((msda.ms_deform_attn(value, shapes, starts, locs, attn)
                         - msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)).abs().max())
        if not fwd_err <= K1_TOL:
            raise AssertionError(f"K1 {name} at B={B}: max abs error {fwd_err} > {K1_TOL}")
        # K1 at the training shapes too: 12 of its launches a step run here
        k1_call = lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn)   # noqa: E731
        k1_bound = msda_bound_ms(value, shapes, locs, attn)
        k1 = dict(max_abs_err=fwd_err, ms=event_ms(k1_call, 50),
                  device_ms=kernel_device_ms(k1_call, 50, "msda_fwd_kernel"),
                  plain_ms=event_ms(
                      lambda: msda.ms_deform_attn_plain(value, shapes, starts, locs, attn), 3),
                  bound_ms=k1_bound[0], bound_by=k1_bound[1])
        log("K1", f"{name}: B={B} (valid {BATCH_VALID}) Q={q}: max|kernel-plain|={fwd_err:.3e} "
                  f"kernel {k1['ms']:.4f} ms (device time {k1['device_ms']:.4f} ms), plain "
                  f"{k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
        grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device)
        args = (value, shapes, starts, locs, attn, grad_out)
        got = msda.ms_deform_attn_bwd(*args)
        ref = msda.ms_deform_attn_bwd_plain(*args)
        errs = {}
        for key, a, b in zip(("grad_value", "grad_locs", "grad_attn"), got, ref):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            errs[key] = err
            if not err <= K3_RTOL * scale:
                raise AssertionError(f"K3 {name} {key}: max abs error {err} > "
                                     f"{K3_RTOL} x max|ref| {scale}")
        ms = event_ms(lambda: msda.ms_deform_attn_bwd(*args), 20)
        device_ms = kernel_device_ms(lambda: msda.ms_deform_attn_bwd(*args), 20, "msda_bwd_kernel")
        plain_ms = event_ms(lambda: msda.ms_deform_attn_bwd_plain(*args), 3)
        bound_ms, bound_by = msda_bwd_bound_ms(value, shapes, locs, attn)
        rows[name] = dict(B=B, Q=q, L=L, max_abs_err=max(errs.values()), errs=errs,
                          k1_max_abs_err=fwd_err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, k1=k1,
                          plan=msda.msda_bwd_plan(shapes, B, q, HEADS)._asdict())
        log("K3", f"{name}: B={B} (valid {BATCH_VALID}) Q={q} max|kernel-plain| "
                  f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance {K3_RTOL} x "
                  f"max|ref|), K1 on the same operands {fwd_err:.3e} (tolerance {K1_TOL}); "
                  f"kernel {ms:.4f} ms (device time {device_ms:.4f} ms), plain (autograd: forward "
                  f"+ backward) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); plan "
                  f"{rows[name]['plan']}")
    return rows


# ---------------------------------------------------------------- K4 (fusion backward)
def fusion_bwd_bound_ms(q, k, mask_v, mask_l) -> tuple:
    """The forward operands, K2's outputs and statistics and both upstream
    gradients read once, the four gradients written once; against the
    products this data needs: over the (image, text) pairs that some softmax
    reaches (U = every image token with the live text, every text token with
    the live image), the logits and gq and gk; G1 and gvl where the row
    softmax is live; G2 and gvv where the column softmax is live; at the
    3xTF32 rate for f32 operands, at the bf16 rate for bf16 ones (the
    statistics f32 either way)."""
    B, nv, E = q.shape
    nl = k.shape[1]
    H = FUSION_HEADS
    D = E // H
    es = q.element_size()
    nbytes = es * (8 * B * nv * E + 8 * B * nl * E) + 4 * B * H * (nv + nl) \
        + mask_v.numel() + mask_l.numel()
    products = 0
    for lv, ll in zip((~mask_v).sum(-1).tolist(), (~mask_l).sum(-1).tolist()):
        union = nv * ll + lv * nl - lv * ll
        products += 3 * union + 2 * nv * ll + 2 * lv * nl
    ops = 2 * D * H * products
    rate = BF16_FLOP_PER_S if es == 2 else TF32X3_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_fusion_bwd(device):
    """K4 against autograd of the plain version, and K2 against the plain
    version on the same operands, at the encoder fusion shape of a B = 4
    training batch (BATCH_VALID, BATCH_LIVE_TEXT: each image its own valid
    region and live text count) with seeded upstream gradients."""
    import torch

    from open_groundingdino_tpu_torch.ops import fusion

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    args = fusion_inputs(g, device, BATCH_VALID, BATCH_LIVE_TEXT)
    q, k, val_v, val_l, mask_v, mask_l = args
    g_ov = torch.randn(q.shape, generator=g, device=device)
    g_ol = torch.randn(k.shape, generator=g, device=device)
    out_v, out_l, lse_v, lse_l = fusion._fusion_fwd_cuda(*args, FUSION_HEADS)
    ov_p, ol_p = fusion.fused_bi_attention_plain(*args, FUSION_HEADS)
    fwd_err = max(float((out_v - ov_p).abs().max()), float((out_l - ol_p).abs().max()))
    del ov_p, ol_p
    if not fwd_err <= K2_TOL:
        raise AssertionError(f"K2 at B={q.shape[0]}: max abs error {fwd_err} > {K2_TOL}")
    # K2 at the B = 4 shape, where the training step's launches run
    k2_ms = event_ms(lambda: fusion._fusion_fwd_cuda(*args, FUSION_HEADS), 5)
    k2_plain_ms = event_ms(lambda: fusion.fused_bi_attention_plain(*args, FUSION_HEADS), 3)
    k2_bound_ms, k2_bound_by = fusion_bound_ms(q, k, mask_v, mask_l)
    log("K2", f"B={q.shape[0]} (valid {BATCH_VALID}, live text {BATCH_LIVE_TEXT}): "
              f"max|kernel-plain|={fwd_err:.3e} kernel {k2_ms:.3f} ms, plain "
              f"{k2_plain_ms:.3f} ms, bound {k2_bound_ms:.4f} ms ({k2_bound_by})")
    bwd_args = (*args, out_v, out_l, lse_v, lse_l, g_ov, g_ol, FUSION_HEADS)
    got = fusion.fused_bi_attention_bwd(*bwd_args)
    ref = fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS)
    errs = {}
    for key, a, b in zip(("gq", "gk", "gvv", "gvl"), got, ref):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        errs[key] = err
        if not err <= K4_RTOL * scale:
            raise AssertionError(f"K4 {key}: max abs error {err} > {K4_RTOL} x max|ref| {scale}")
    ms = event_ms(lambda: fusion.fused_bi_attention_bwd(*bwd_args), 5)
    plain_ms = event_ms(
        lambda: fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS), 3)
    bound_ms, bound_by = fusion_bwd_bound_ms(q, k, mask_v, mask_l)
    log("K4", f"B={q.shape[0]} (valid {BATCH_VALID}, live text {BATCH_LIVE_TEXT}) "
              f"Nv={q.shape[1]} Nl={k.shape[1]} E={FUSION_E} H={FUSION_HEADS}: max|kernel-plain| "
              f"{ {k_: f'{v:.3e}' for k_, v in errs.items()} } (tolerance {K4_RTOL} x max|ref|), "
              f"K2 on the same operands {fwd_err:.3e} (tolerance {K2_TOL}); "
              f"kernel {ms:.3f} ms, plain (autograd: forward + backward) {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    sass = tensor_core_report(("fusion_fwd", "fusion_bwd"), q.shape[1])
    k2 = dict(B=q.shape[0], max_abs_err=fwd_err, ms=k2_ms, plain_ms=k2_plain_ms,
              bound_ms=k2_bound_ms, bound_by=k2_bound_by)
    return dict(B=q.shape[0], Nv=q.shape[1], max_abs_err=max(errs.values()), errs=errs,
                k2_max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, k2=k2, sass=sass)


# ---------------------------------------------------------------- K6, K7, K9, K10 (sweep)
# the sweep kernels against their plain versions: forward abs (f32, only the
# order of each output's sums differs); backward relative to each gradient's
# largest |reference| (grad_value by atomics in an order that changes from
# run to run); K10's tap gradients on every tap, K9's where the tap is live
# (w != 0: K9 gives a dead tap gw = 0, which the chain rule multiplies by
# zero)
SWEEP_TOL = 1e-4
SWEEP_RTOL = 1e-4
# the kernels' names as torch.profiler sees them, for kernel_device_ms (the
# f32 instances of the templated K6, K7, K9 and K10 by their f32 launches)
DEVICE_NAMES = {"K5": "banded_fwd_kernel", "K6": "rowtap_fwd_kernel", "K7": "allq_fwd_kernel",
                "K8": "corner_fwd_kernel", "K9": "corner_bwd_kernel", "K10": "rowtap_bwd_kernel"}


def sweep_operands(value, shapes, locs, attn, grad_out):
    """The operands MSDASweepFunction hands the kernels on the model path:
    row taps (row, px, w) and corner taps (idx, wc), in the kernels' query
    order (sorted for Q != L) and padded to the query block, and the
    upstream gradient likewise."""
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    B, L, H, D = value.shape
    Q = locs.shape[1]
    locs_t, attn_t = sw.kernel_layout(locs, attn)
    row, px, w = sw.rowtap_positions_and_weights(locs_t, attn_t, shapes)
    idx, wc = sw.corner_indices_and_weights(locs_t, attn_t, shapes)
    order = sw.query_order(row, px, L)
    g_k = grad_out.view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    return {"row": sw.sort_and_pad(row, order), "px": sw.sort_and_pad(px, order),
            "w": sw.sort_and_pad(w, order),
            "idx": sw.sort_and_pad(idx, order), "wc": sw.sort_and_pad(wc, order),
            "g": sw.sort_and_pad(g_k, order, 1)}


def corner_operands(value, shapes, locs, attn):
    """K8's operands as the corner forward (MSDASweepFunction with
    fwd="corner") hands them over: corner taps (idx, w), sorted by the first
    corner tap for Q != L and padded to the query block."""
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    idx, w = sw.corner_indices_and_weights(*sw.kernel_layout(locs, attn), shapes)
    order = sw.query_order(idx, None, value.shape[1])
    return sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order)


def rel_errs(got, ref, masks=None) -> dict:
    """max |got - ref| / max |ref| for each named pair, over mask[name]
    where one is given."""
    out = {}
    for key in ref:
        a, b = got[key], ref[key]
        if masks and key in masks:
            a, b = a[masks[key]], b[masks[key]]
        out[key] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return out


def check_sweep(device) -> dict:
    """K6 (and K7 on the decoder's sorted query set), K9 and K10 against their
    plain versions at the encoder and decoder shapes of phase 8's B = 4
    batch, then the sweep op as the model calls it against K1 and K3 on the
    same inputs; then K6 and K7 again at phase 3's B = 1 shapes, serving's."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    rows = {}
    for batch, valid in (("B=4", BATCH_VALID), ("B=1", (BUCKET,))):
        B = len(valid)
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device)
            ops = sweep_operands(value, shapes, locs, attn, grad_out)
            row, px, w, idx, wc, g_k = (ops[k] for k in ("row", "px", "w", "idx", "wc", "g"))
            fwd_bound = msda_bound_ms(value, shapes, locs, attn)
            bwd_bound = msda_bwd_bound_ms(value, shapes, locs, attn)
            out_p = sw.sweep_fwd_plain(value, row, px, w)
            fwd_plain_ms = event_ms(lambda: sw.sweep_fwd_plain(value, row, px, w), 3)
            fwds = [("K6", sw.sweep_fwd)]
            if q != L:
                fwds.append(("K7", sw.sweep_fwd_allq))
            # the B = 4 rows keep their (kernel, shape) keys; B = 1's name its batch
            key = name if batch == "B=4" else f"{batch} {name}"
            for kname, fn in fwds:
                err = float((fn(value, shapes, row, px, w) - out_p).abs().max())
                call = lambda: fn(value, shapes, row, px, w)   # noqa: E731
                ms = event_ms(call, 10)
                device_ms = kernel_device_ms(call, 10, DEVICE_NAMES[kname])
                rows[kname, key] = dict(B=B, Q=q, max_abs_err=err, ms=ms, device_ms=device_ms,
                                        plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0],
                                        bound_by=fwd_bound[1])
                log(kname, f"{name}: {batch} Q={q} L={L}: max|kernel-plain| {err:.3e} (tolerance "
                           f"{SWEEP_TOL}); kernel {ms:.4f} ms (device time {device_ms:.4f} ms), "
                           f"plain {fwd_plain_ms:.3f} ms, bound {fwd_bound[0]:.4f} ms "
                           f"({fwd_bound[1]})")
                if not err <= SWEEP_TOL:
                    raise AssertionError(f"{kname} {batch} {name}: max abs error {err} > "
                                         f"{SWEEP_TOL}")
            del out_p
            if batch == "B=1":
                continue
            for kname, fn, plain, args, keys, masks in (
                    ("K9", sw.sweep_bwd_corner, sw.sweep_bwd_corner_plain, (idx, wc),
                     ("grad_value", "gw"), {"gw": wc != 0}),
                    ("K10", sw.sweep_bwd_rowtap, sw.sweep_bwd_rowtap_plain, (row, px, w),
                     ("grad_value", "gpx", "gw"), None)):
                got = dict(zip(keys, fn(value, shapes, *args, g_k)))
                ref = dict(zip(keys, plain(value, *args, g_k)))
                errs = rel_errs(got, ref, masks)
                del got, ref
                ms = event_ms(lambda: fn(value, shapes, *args, g_k), 5)
                device_ms = kernel_device_ms(lambda: fn(value, shapes, *args, g_k), 5,
                                             DEVICE_NAMES[kname])
                plain_ms = event_ms(lambda: plain(value, *args, g_k), 2)
                rows[kname, name] = dict(B=B, Q=q, max_abs_err=max(errs.values()), errs=errs,
                                         ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                         bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
                where = "where w != 0" if masks else "on every tap"
                log(kname, f"{name}: B={B} Q={q}: max|kernel-plain| / max|plain| "
                           f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance "
                           f"{SWEEP_RTOL}, tap gradients {where}); kernel {ms:.4f} ms (device "
                           f"time {device_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
                           f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
                if not max(errs.values()) <= SWEEP_RTOL:
                    raise AssertionError(f"{kname} {name}: {errs} > {SWEEP_RTOL}")
            rows["vs K1/K3", name] = sweep_vs_gather(value, shapes, starts, locs, attn, grad_out)
    return rows


def lattice_samples(locs, shapes):
    """(B, Q, H, NL, P) bool: sampling points with a coordinate exactly on
    the pixel lattice (zero fraction of x * W - 0.5 or y * H - 0.5, rounded
    as the expansions round it)."""
    import torch

    on = []
    for lvl, (h, w) in enumerate(shapes):
        x = locs[:, :, :, lvl, :, 0] * w - 0.5
        y = locs[:, :, :, lvl, :, 1] * h - 0.5
        on.append((x == torch.floor(x)) | (y == torch.floor(y)))
    return torch.stack(on, 3)


def sweep_vs_gather(value, shapes, starts, locs, attn, grad_out) -> dict:
    """The sweep op as the model calls it (MSDASweepFunction: K6, or K7 for a
    sorted query set under dec_fused; K9 or K10 backward) against K1 and K3
    on the same inputs.  The two compute one function: the forward within
    SWEEP_TOL, each gradient within SWEEP_RTOL of its largest |reference|
    (f32 sums in another order; grad_value by atomics on both sides).
    Location gradients are compared off the pixel lattice: at B = 4 some
    tens of the 10M f32 sampling points have a coordinate with zero
    fraction, where K3 takes the one-sided derivative through floor and the
    sweep, as its TPU kernels do, another one (row taps: sign(0) = 0; corner
    taps: K9 gives gw = 0 on a tap whose bilinear weight is zero there).
    The count is reported."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    keys = ("grad_value", "grad_locs", "grad_attn")
    ref_out = msda.ms_deform_attn(value, shapes, starts, locs, attn)
    ref = dict(zip(keys, msda.ms_deform_attn_bwd(value, shapes, starts, locs, attn, grad_out)))
    lattice = lattice_samples(locs, shapes)
    off = {"grad_locs": ~lattice[..., None].expand_as(locs)}
    res = {}
    for bwd, dec_fused in (("corner", False), ("rowtap", True)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, attn)]
        out = sw.ms_deform_attn_sweep(leaves[0], shapes, starts, leaves[1], leaves[2], bwd=bwd,
                                      dec_fused=dec_fused)
        fwd_err = float((out.detach() - ref_out).abs().max())
        errs = rel_errs(dict(zip(keys, torch.autograd.grad(out, leaves, grad_out))), ref, off)
        res[bwd] = dict(fwd_max_abs_err=fwd_err, grad_errs=errs, lattice=int(lattice.sum()))
        k7 = " + K7" if dec_fused and locs.shape[1] != value.shape[1] else ""
        log("sweep", f"Q={locs.shape[1]} {bwd} backward{k7}: forward vs K1 {fwd_err:.3e} "
                     f"(tolerance {SWEEP_TOL}); gradients vs K3, max|d| / max|K3| "
                     f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance {SWEEP_RTOL}; "
                     f"locations off the lattice: {int(lattice.sum())} of {lattice.numel()} "
                     f"samples on it)")
        if not (fwd_err <= SWEEP_TOL and max(errs.values()) <= SWEEP_RTOL):
            raise AssertionError(f"the sweep ({bwd}) disagrees with K1/K3: {res[bwd]}")
    return res


# ---------------------------------------------------------------- K5, K8
# K5 and K8 against their plain versions and against K1: forwards on exact
# corner or row weights, so only the order of each output's f32 sums differs
K5_K8_TOL = 1e-4


def check_banded_corner(device) -> dict:
    """K5 (per-point banded forward) and K8 (corner-tap sweep forward)
    against their plain versions on the operands their paths give them (K5:
    banded_operands, the decoder's queries sorted; K8: corner taps sorted by
    the first for Q != L), and the ops that launch them against K1 on the
    same inputs, at phase 3's B = 1 and phase 8's B = 4 (BATCH_VALID)
    encoder and decoder shapes."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 16)
    rows = {}
    for batch, valid in (("B=1", (BUCKET,)), ("B=4", BATCH_VALID)):
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            k1 = msda.ms_deform_attn(value, shapes, starts, locs, attn)
            bound = msda_bound_ms(value, shapes, locs, attn)
            _, locs_t, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
            ranges = mb.band_ranges(locs_t, shapes, px.shape[-1] // sw.QBLOCK,
                                    mb.level_bands(shapes, mb.BAND))
            idx, w = corner_operands(value, shapes, locs, attn)
            for kname, kernel, plain, op in (
                    ("K5", lambda: mb.banded_fwd(value, shapes, px, py, wa),
                     lambda: mb.banded_fwd_plain(value, shapes, px, py, wa, ranges),
                     lambda: mb.ms_deform_attn_banded(value, shapes, starts, locs, attn)),
                    ("K8", lambda: sw.sweep_fwd_corner(value, shapes, idx, w),
                     lambda: sw.sweep_fwd_corner_plain(value, idx, w),
                     lambda: sw.ms_deform_attn_sweep(value, shapes, starts, locs, attn,
                                                     fwd="corner"))):
                err = float((kernel() - plain()).abs().max())
                op_err = float((op() - k1).abs().max())
                ms = event_ms(kernel, 10)
                device_ms = kernel_device_ms(kernel, 10, DEVICE_NAMES[kname])
                plain_ms = event_ms(plain, 2)
                rows[kname, batch, name] = dict(Q=q, max_abs_err=err, k1_max_abs_err=op_err,
                                                ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                                bound_ms=bound[0], bound_by=bound[1])
                log(kname, f"{name}: {batch} Q={q} L={L}: max|kernel-plain| {err:.3e}, the op "
                           f"against K1 {op_err:.3e} (tolerance {K5_K8_TOL}); kernel {ms:.4f} ms "
                           f"(device time {device_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
                           f"{bound[0]:.4f} ms ({bound[1]})")
                if not (err <= K5_K8_TOL and op_err <= K5_K8_TOL):
                    raise AssertionError(f"{kname} {batch} {name}: {rows[kname, batch, name]}")
    return rows


def check_banded_train_parity(harness, gather_card) -> dict:
    """One training step through banded_point (K5 forward, K3 backward)
    against the gather's step on the card (phase 11's) from the same weights
    and batch: loss within PARITY_LOSS_RTOL, module gradient norms within
    PARITY_GRAD_RTOL, each parameter that the MSDA kernels feed within
    PARITY_LEAF_RTOL.  Returns the comparison and the banded_point step
    (phase 27 holds its bf16 step against it)."""
    step, gaps, within = harness
    run = step("cuda", msda={"kernel": "banded_point"})
    gap = gaps(run, gather_card, MSDA_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("banded-train-parity", f"banded_point step vs gather step on the card: loss "
                               f"{run['loss']:.6f} vs {gather_card['loss']:.6f} (rel "
                               f"{loss_rel:.2e}, limit {PARITY_LOSS_RTOL}); grad-norm rel by "
                               f"module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
                               f"{len(leaf_rel)} MSDA-fed leaves ||dg||/||g|| max "
                               f"{max(leaf_rel.values()):.2e} (limit {PARITY_LEAF_RTOL}), worst "
                               f"{[(n, f'{v:.2e}') for n, v in worst]}; step s {run['seconds']:.1f}")
    if not (math.isfinite(run["loss"]) and within(gap)):
        raise AssertionError("the banded_point training step disagrees with the gather's")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values())), run


def run_microbench(dtype: str = "f32") -> tuple:
    """The port's MSDA microbench in this process, K5 and K8 paths with
    their backwards (in f32 also the plain op; with dtype "bf16" a bf16
    value through the bf16 entries), a few iterations; returns (its
    results, the kernels' launches in the run)."""
    from open_groundingdino_tpu_torch.tools import msda_microbench

    reset_counts()
    argv = ["--sweep", "--fwd_variant", "corner", "--banded_mp", "0", "--bwd",
            *(["--xla"] if dtype == "f32" else ["--dtype", dtype]), "--iters", "3",
            "--repeats", "2"]
    res = msda_microbench.main(argv)
    counts = read_counts()
    log("microbench", f"msda_microbench {' '.join(argv)}: ms a layer "
                      f"{ {k: round(v, 3) for k, v in res.items() if k != 'max_abs_diff'} }"
                      + (f", max|banded - plain| {res['max_abs_diff']:.2e}" if dtype == "f32"
                         else "") + f"; launches { {k: v for k, v in counts.items() if v} }")
    kernels = ("banded_fwd", "sweep_fwd_corner", "sweep_bwd_corner", "msda_bwd")
    suffix = "" if dtype == "f32" else "_bf16"
    launched = all(counts[k + suffix] > 0 for k in kernels)
    if dtype != "f32":   # and none of the f32 entries
        launched = launched and not any(counts[k] for k in kernels)
    if not launched or (dtype == "f32" and not res["max_abs_diff"] <= K5_K8_TOL):
        raise AssertionError(f"the microbench missed a kernel or disagrees: {counts} {res}")
    return res, counts


# ---------------------------------------------------------------- serving
VOCAB_WORDS = ("a", "the", "cat", "dog", "person", "bicycle", "car", "traffic", "light",
               "on", "in", "bird", "chair", "table", "sofa", "tree",
               "dent", "scratch", "missing", "scraped", "broken")


def write_vocab(path: str, size: int = 30522) -> None:
    """A bert-base-uncased-shaped vocab: the special tokens at their usual
    ids, punctuation, the caption words, then synthetic words and
    continuation pieces up to `size` entries."""
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list(".,?!;:'\"()-") + list(VOCAB_WORDS)
    i = 0
    while len(toks) < size:
        toks.append(f"w{i}" if i % 2 == 0 else f"##p{i}")
        i += 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(toks) + "\n")


# roberta-base's geometry (reference get_tokenlizer.py:22-29 + RobertaModel)
ROBERTA_VOCAB = 50265
ROBERTA_MAX_POSITION = 514
BPE_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


def learn_bpe_merges(words: dict, n_tokens: int) -> list:
    """Byte-level BPE merges learnt on `words` ({byte-encoded pre-token:
    count}): each step merges the most frequent adjacent pair (ties: the
    smallest pair), until the merges have made `n_tokens` distinct tokens;
    raises if the corpus runs out of pairs first."""
    import heapq

    seqs, freq = [list(w) for w in words], list(words.values())
    pairs, where = {}, {}
    for i, sq in enumerate(seqs):
        for q in zip(sq, sq[1:]):
            pairs[q] = pairs.get(q, 0) + freq[i]
            where.setdefault(q, set()).add(i)
    heap = [(-c, q) for q, c in pairs.items()]
    heapq.heapify(heap)
    made, merges = set(), []
    while len(made) < n_tokens:
        if not heap:
            raise ValueError(f"the corpus ran out of pairs at {len(made)} of {n_tokens} tokens")
        c, q = heapq.heappop(heap)
        cur = pairs.get(q, 0)
        if cur != -c:   # a stale entry: its count has fallen since
            if cur > 0:
                heapq.heappush(heap, (-cur, q))
            continue
        a, b = q
        new = a + b
        merges.append(q)
        made.add(new)
        for i in where.pop(q):
            sq, f, out, j = seqs[i], freq[i], [], 0
            while j < len(sq):
                if j + 1 < len(sq) and sq[j] == a and sq[j + 1] == b:
                    out.append(new)
                    j += 2
                else:
                    out.append(sq[j])
                    j += 1
            for r in zip(sq, sq[1:]):
                pairs[r] -= f
            for r in zip(out, out[1:]):
                pairs[r] = pairs.get(r, 0) + f
                where.setdefault(r, set()).add(i)
                if new in r:   # only pairs with the new token gain counts
                    heapq.heappush(heap, (-pairs[r], r))
            seqs[i] = out
        pairs.pop(q, None)
    return merges


def write_bpe_vocab(directory: str, size: int = ROBERTA_VOCAB, seed: int = SEED) -> str:
    """A roberta-base-shaped byte-level BPE vocabulary of exactly `size`
    entries in `directory` (vocab.json + merges.txt, the file format of
    tests/test_tokenization.py:118-133): the five special tokens at
    roberta-base's ids, the 256 byte symbols, then every token that merges
    learnt from a seeded synthetic corpus make (learn_bpe_merges).  The
    corpus: the smoke's caption and category words, frequent and mostly
    after a space, and random lowercase words, as GPT-2's pre-tokenizer
    splits them.  Returns the directory."""
    import random

    from open_groundingdino_tpu_torch.data.tokenization import _bytes_to_unicode, _gpt2_pretokenize

    n_tokens = size - len(BPE_SPECIALS) - 256
    rng = random.Random(seed)
    enc = _bytes_to_unicode()
    words = {}

    def add(text: str, count: int) -> None:
        for piece, _ in _gpt2_pretokenize(text):
            key = "".join(enc[b] for b in piece.encode("utf-8"))
            words[key] = words.get(key, 0) + count

    for w in VOCAB_WORDS + CATEGORIES:
        add(" " + w, 1000)
        add(w, 100)
    add(" . ? , ' 0 1 2 3 4 5 6 7 8 9", 500)
    # ~3.1 distinct tokens a random word before the corpus runs out
    for _ in range(n_tokens // 3 + 100):
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randint(4, 12)))
        add((" " if rng.random() < 0.8 else "") + w, rng.randint(1, 20))
    merges = learn_bpe_merges(words, n_tokens)
    toks = list(BPE_SPECIALS) + list(enc.values()) + list(dict.fromkeys(a + b for a, b in merges))
    if len(toks) != size:
        raise AssertionError(f"BPE vocab of {len(toks)} entries, expected {size}")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(toks)}, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return directory


def draw_frozen_bn(model, g) -> list:
    """A ResNet backbone's FrozenBN terms drawn near the identity, as a
    trained network's are away from it: weight and running_var U(0.5, 1.5),
    bias and running_mean N(0, 0.1).  (At the port's lecun-normal init the
    identity keeps the stage outputs O(1); statistics calibrated to each
    input's mean and variance cancel a large mean in the fold and amplify
    f32 rounding, on the CPU and the card alike.)  Returns the
    largest |activation| of each output stage in one forward of the trunk on
    the CPU, on a seeded ImageNet-normalized 256x384 image."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.data.transforms import normalize_image
    from open_groundingdino_tpu_torch.models.resnet import FrozenBatchNorm2d

    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, FrozenBatchNorm2d):
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.running_var.uniform_(0.5, 1.5, generator=g)
                bn.bias.normal_(0.0, 0.1, generator=g)
                bn.running_mean.normal_(0.0, 0.1, generator=g)
        image = normalize_image(synthetic_image(256, 384, SEED)).astype(np.float32)
        outs = model.backbone[0](torch.from_numpy(image)[None])
    return [float(o.abs().max()) for o in outs]


def write_checkpoint(cfg_path: str, path: str, random_biases: bool = False,
                     anchor_boxes: bool = False, extra=None) -> None:
    """Seeded random weights of the config's model with the reference
    state-dict keys; a ResNet backbone's FrozenBN terms drawn near the
    identity (`draw_frozen_bn`).
    The deformable-attention offset and weight projections get small random
    kernels (zero at init) so that every sampling point is query-dependent
    and off the pixel lattice, as in a trained model.  With `random_biases`
    every Linear/Conv bias is drawn from N(0, 0.02) too, as a trained
    network's are non-zero: with zero biases the zero-padded image region
    gives constant tokens, whose LayerNorm gradients grow by 1/sqrt(eps) at
    every Swin layer, and the first training step at B = 4 overflows f32 in
    the JAX package and the port alike (ROADMAP section 3,
    tests/test_torch_padding_init.py).  With `anchor_boxes` each query's
    box is the anchor of the encoder token it was selected from, so that an
    image's detections spread over it as a trained model's do: the last
    layer of each box head (the decoder's shared bbox_embed and the
    encoder's enc_out_bbox_embed) is zero, as the reference initialises it
    (groundingdino.py), and so is enc_output's bias, so that the padded and
    out-of-range proposals, whose memory is zero, score 0 and leave the top
    900 to the image's tokens.  With random biases there, those proposals
    (all one box) took every query, and NMS left one box an image.  `extra`
    ({key: tensor}) adds entries a published checkpoint holds beside the
    model's tensors (buffers the loader drops)."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_
    from open_groundingdino_tpu_torch.models.resnet import ResNetConfig

    args = SLConfig.fromfile(cfg_path)
    model = init_weights_(build_groundingdino(args, device="cpu"), SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    if isinstance(model.backbone_cfg, ResNetConfig):
        peaks = draw_frozen_bn(model, g)
        log("checkpoint", f"{args.backbone}: FrozenBN terms drawn near the identity; max "
                          f"|output| by stage {[f'{v:.3g}' for v in peaks]} (a 256x384 image)")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.normal_(0.0, 0.01, generator=g)
        if random_biases:
            for m in model.modules():
                if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=g)
        if anchor_boxes:
            for head in (model.bbox_embed[0], model.transformer.enc_out_bbox_embed):
                head.layers[-1].weight.zero_()
                head.layers[-1].bias.zero_()
            model.transformer.enc_output.bias.zero_()
    torch.save({"model": {**model.state_dict(), **(extra or {})}}, path)


def synthetic_image(h: int, w: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    return Image.fromarray(base).resize((w, h), Image.BILINEAR)   # smooth blobs


def write_serving_files(cfg: str, work: str):
    """The smoke's vocab and seeded checkpoint; returns (cfg, ckpt, vocab)."""
    vocab, ckpt = os.path.join(work, "vocab.txt"), os.path.join(work, "ckpt.pth")
    t0 = time.perf_counter()
    write_vocab(vocab)
    write_checkpoint(cfg, ckpt)
    log("serve", f"wrote vocab + checkpoint ({os.path.getsize(ckpt) / 2**20:.0f} MiB) "
                 f"in {time.perf_counter() - t0:.1f} s")
    return cfg, ckpt, vocab


def msda_config(cfg: str, work: str, name: str, **keys) -> str:
    """A config file that takes `cfg` and sets the given keys (MSDA keys,
    dilation)."""
    path = os.path.join(work, f"cfg_{name}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = {cfg!r}\n" + "".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path


def serving_launches(args, n_req: int) -> dict:
    """The kernel launches of n_req forwards: one MSDA forward per encoder and
    decoder layer (K1, or the sweep: K6, with K7 for the decoder under
    msda_dec_fused), one K2 per encoder fusion layer, no backward."""
    want = dict.fromkeys(kernel_counters(), 0)
    enc, dec = args.enc_layers * n_req, args.dec_layers * n_req
    want["fusion_fwd"] = enc
    if str(args.msda_kernel) == "banded_point":
        want["banded_fwd"] = enc + dec
    elif str(args.msda_kernel) == "sweep":
        fused = bool(args.msda_dec_fused)
        want["sweep_fwd"] = enc + (0 if fused else dec)
        want["sweep_fwd_allq"] = dec if fused else 0
    else:
        want["msda_fwd"] = enc + dec
    return want


def serve(files, device: str, tag: str = "serve"):
    """load_model + predict on a few requests; returns (model, per-request
    seconds, launch counts of the run, the images)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference

    cfg, ckpt, vocab = files
    t0 = time.perf_counter()
    im = inference.load_model(cfg, ckpt, vocab, device=device)
    log(tag, f"load_model on {device} in {time.perf_counter() - t0:.1f} s")
    images = [synthetic_image(h, w, i) for i, (h, w) in enumerate(IMAGE_SIZES)]

    reset_counts()
    inference.predict(im, images[0], CAPTIONS[0])           # warm-up
    torch.cuda.synchronize()
    lat = []
    for i, img in enumerate(images):
        for cap in CAPTIONS:
            t0 = time.perf_counter()
            boxes, scores, phrases = inference.predict(im, img, cap)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if not (len(boxes) == len(scores) == len(phrases)
                    and np.isfinite(boxes).all() and ((boxes >= 0) & (boxes <= 1)).all()
                    and ((scores > 0.35) & (scores <= 1)).all()):
                raise AssertionError(f"malformed predict output for image {i} {cap!r}")
    n_req = len(images) * len(CAPTIONS) + 1
    counts = read_counts()
    log(tag, f"{n_req - 1} requests after 1 warm-up: latency ms "
             f"{[round(t * 1e3, 1) for t in lat]} "
             f"(median {1e3 * sorted(lat)[len(lat) // 2]:.1f}); "
             f"launches over {n_req} requests: { {k: v for k, v in counts.items() if v} }")
    want = serving_launches(im.args, n_req)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return im, lat, counts, images


def forward_outputs(im, image, caption, **size):
    """(pred_logits, pred_boxes, image shape) of one request (prepare_inputs'
    `size` / `max_size`, if given), on the host."""
    import torch

    from open_groundingdino_tpu_torch import inference

    inputs, _ = inference.prepare_inputs(im, image, inference.preprocess_caption(caption), **size)
    with torch.inference_mode():
        out = im.model(**inputs)
    return (out["pred_logits"].float().cpu().numpy(), out["pred_boxes"].float().cpu().numpy(),
            tuple(inputs["images"].shape))


def check_forward(im_gpu, files, image, caption, tag="forward"):
    """pred_logits / pred_boxes of one request on the card against the same
    checkpoint on the CPU, flip-aware (__graft_entry__.py:376-393 bounds);
    returns the CPU's outputs."""
    from open_groundingdino_tpu_torch import inference

    t0 = time.perf_counter()
    cpu = forward_outputs(inference.load_model(*files, device="cpu"), image, caption)
    compare_forward(forward_outputs(im_gpu, image, caption), cpu, tag,
                    f"CPU forward {time.perf_counter() - t0:.1f} s")
    return cpu


def forward_gap(card, cpu) -> tuple:
    """(share of the queries flipped, bulk max |dlogit|, bulk max |dbox|,
    within the limits: fewer than 10% flipped, on the rest |dlogit| < 5e-2,
    |dbox| < 5e-3) of the card's (logits, boxes) against the CPU's."""
    import numpy as np

    lg_g, bx_g, _ = card
    lg_c, bx_c, _ = cpu
    flip = np.max(np.abs(bx_g - bx_c), axis=-1) > 1e-2
    keep = ~flip
    fin = np.isfinite(lg_c) & keep[..., None]
    same_inf = bool(np.array_equal(np.isfinite(lg_g), np.isfinite(lg_c)))
    lg_err = float(np.max(np.abs(lg_g[fin] - lg_c[fin]))) if fin.any() else 0.0
    bx_err = float(np.max(np.abs(bx_g[keep] - bx_c[keep]))) if keep.any() else 0.0
    ok = (same_inf and bool(np.isfinite(bx_g).all()) and flip.mean() < 0.10
          and lg_err < 5e-2 and bx_err < 5e-3)
    return float(flip.mean()), lg_err, bx_err, ok


def compare_forward(card, cpu, tag, note=""):
    """The card's (logits, boxes) against the CPU's: fewer than 10% of the
    queries flipped, and on the rest |dlogit| < 5e-2, |dbox| < 5e-3
    (forward_gap)."""
    flip, lg_err, bx_err, ok = forward_gap(card, cpu)
    log(tag, f"image {card[2]} pred_logits {card[0].shape} pred_boxes {card[1].shape}: "
             f"flipped {flip:.1%}, bulk max|dlogit| {lg_err:.3e}, "
             f"bulk max|dbox| {bx_err:.3e}" + (f" ({note})" if note else ""))
    if not ok:
        raise AssertionError(f"{tag}: the card's forward disagrees with the CPU forward")
    return flip, lg_err, bx_err


# ---------------------------------------------------------------- training
CATEGORIES = ("cat", "dog", "person", "bicycle", "car", "traffic light", "bird", "chair",
              "table", "sofa")
TRAIN_IMAGE_SIZES = ((480, 640), (720, 1280), (600, 800), (1024, 768), (500, 700),
                     (640, 480), (800, 1200), (900, 1350))   # (h, w)
TRAIN_STEPS = 6            # 1 warm-up + 5 timed
TRAIN_EPOCHS = 3           # 8 images, B = 4: 2 steps an epoch
# K1 per step: 6 encoder + 6 decoder forward; K2: 6 forward (the checkpointed
# encoder blocks keep both kernels' outputs, remat_save_kernels, so the
# backward replays neither); K3: one per MSDA layer; K4: one per fusion layer
TRAIN_LAUNCHES_PER_STEP = {"msda_fwd": 12, "fusion_fwd": 6, "msda_bwd": 12, "fusion_bwd": 6,
                           "lsap": 1}
PARITY_LOSS_RTOL = 5e-3    # the JAX package's kernel-vs-reference train-step bound
PARITY_GRAD_RTOL = 1e-2    # per top-level module gradient norm
# ||g_card - g_cpu|| / ||g_cpu|| of each parameter that K3 or K4 computes the
# gradient of (the deformable attention's offset, weight and value
# projections, the fusion's four input projections).  The derivative of a
# bilinear sample in its position jumps where the position crosses a pixel
# centre, and the card's and the CPU's products round the positions apart:
# the encoder's sampling-offset leaves differ by up to 3.75e-3 (H100 run);
# a negated kernel output gives ~2
PARITY_LEAF_RTOL = 1e-2
KERNEL_FED = (".sampling_offsets.", ".attention_weights.", ".value_proj.", ".attn.v_proj.",
              ".attn.l_proj.", ".attn.values_v_proj.", ".attn.values_l_proj.")
MSDA_FED = KERNEL_FED[:3]   # the deformable attentions' projections


def odvg_manifest(work: str, subdir: str = "odvg") -> str:
    return os.path.join(work, "datasets.json" if subdir == "odvg" else f"datasets_{subdir}.json")


def write_odvg(work: str, sizes=TRAIN_IMAGE_SIZES, subdir: str = "odvg",
               one_label: bool = False) -> str:
    """A seeded synthetic ODVG set (OD mode) in work/subdir: images of
    `sizes` (8 of mixed sizes by default) with 1-5 boxes each (with
    `one_label` all of one category an image, so that its caption does not
    hang on Python's string hashing), a 10-category label map, and the
    manifest (odvg_manifest); returns the manifest's path."""
    import numpy as np

    root = os.path.join(work, subdir)
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 10)
    lines = []
    for i, (h, w) in enumerate(sizes):
        name = f"img{i}.jpg"
        synthetic_image(h, w, 100 + i).save(os.path.join(root, name), quality=90)
        instances = []
        label = int(rng.randint(len(CATEGORIES))) if one_label else None
        for _ in range(rng.randint(1, 6)):
            bw, bh = rng.uniform(0.1, 0.6) * w, rng.uniform(0.1, 0.6) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            instances.append({"bbox": [float(x0), float(y0), float(x0 + bw), float(y0 + bh)],
                              "label": label if one_label else int(rng.randint(len(CATEGORIES)))})
        lines.append(json.dumps({"filename": name, "height": h, "width": w,
                                 "detection": {"instances": instances}}))
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "label_map.json"), "w") as f:
        json.dump({str(i): c for i, c in enumerate(CATEGORIES)}, f)
    manifest = odvg_manifest(work, subdir)
    with open(manifest, "w") as f:
        json.dump({"train": [{"root": root, "anno": os.path.join(root, "train.jsonl"),
                              "label_map": os.path.join(root, "label_map.json"),
                              "dataset_mode": "odvg"}]}, f)
    return manifest


def write_coco_val(work: str, indices=tuple(range(len(TRAIN_IMAGE_SIZES))), annotations=None,
                   name: str = "val", subdir: str = "odvg") -> str:
    """A COCO-format val split of write_odvg's images `indices` (run
    write_odvg first, with the same `subdir`), image ids 100 + index, the
    label map's names as categories (ids 2i + 1, so that contiguous labels
    and category ids differ); the annotations are the ODVG boxes, or
    `annotations` ({image id: [(category id, [x, y, w, h])]}); and a
    manifest with write_odvg's train split and this val split; returns the
    manifest's path."""
    root = os.path.join(work, subdir)
    with open(os.path.join(root, "train.jsonl")) as f:
        metas = [json.loads(line) for line in f]
    images, anns = [], []
    for i in indices:
        meta, img_id = metas[i], 100 + i
        images.append({"id": img_id, "file_name": meta["filename"], "height": meta["height"],
                       "width": meta["width"]})
        if annotations is None:
            boxes = [(2 * inst["label"] + 1, [inst["bbox"][0], inst["bbox"][1],
                                              inst["bbox"][2] - inst["bbox"][0],
                                              inst["bbox"][3] - inst["bbox"][1]])
                     for inst in meta["detection"]["instances"]]
        else:
            boxes = annotations.get(img_id, [])
        for cat, (x, y, w, h) in boxes:
            anns.append({"id": len(anns) + 1, "image_id": img_id, "iscrowd": 0,
                         "category_id": int(cat), "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w) * float(h)})
    anno = os.path.join(root, f"{name}.json")
    with open(anno, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 2 * i + 1, "name": c} for i, c in enumerate(CATEGORIES)]},
                  f)
    with open(odvg_manifest(work, subdir)) as f:
        manifest = json.load(f)
    manifest["val"] = [{"root": root, "anno": anno, "dataset_mode": "coco"}]
    path = os.path.join(work, f"datasets_{name}.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


# the kernels with a bf16 entry, whose wrappers count its launches apart
BF16_KERNELS = ("msda_fwd", "fusion_fwd", "msda_bwd", "fusion_bwd", "banded_fwd", "sweep_fwd",
                "sweep_fwd_allq", "sweep_fwd_corner", "sweep_bwd_corner", "sweep_bwd_rowtap")
ENC_LAYERS = 6             # the config's encoder layers: its fusion blocks' K2 launches a forward
DEC_LAYERS = 6             # the config's decoder layers: the decoder's MSDA launches a forward


def kernel_counters():
    """{count name: (wrapper, attribute)}: each wrapper's f32 launches, and
    as "<name>_bf16" its bf16 entry's launches (the LSAP kernel has none: the
    matcher's costs are f32 in every step)."""
    from open_groundingdino_tpu_torch.ops import fusion, lsap, msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    fns = {"msda_fwd": msda.ms_deform_attn, "fusion_fwd": fusion.fused_bi_attention,
           "msda_bwd": msda.ms_deform_attn_bwd, "fusion_bwd": fusion.fused_bi_attention_bwd,
           "banded_fwd": mb.banded_fwd,
           "sweep_fwd": sw.sweep_fwd, "sweep_fwd_allq": sw.sweep_fwd_allq,
           "sweep_fwd_corner": sw.sweep_fwd_corner,
           "sweep_bwd_corner": sw.sweep_bwd_corner, "sweep_bwd_rowtap": sw.sweep_bwd_rowtap,
           "lsap": lsap.lsap}
    counters = {k: (fn, "launches") for k, fn in fns.items()}
    counters.update({f"{k}_bf16": (fns[k], "launches_bf16") for k in BF16_KERNELS})
    return counters


def reset_counts() -> None:
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in kernel_counters().items()}


def train_launches_per_step(msda_keys: dict, bf16: bool = False) -> dict:
    """TRAIN_LAUNCHES_PER_STEP with the MSDA kernels the config selects: the
    sweep runs K6 where the gather runs K1 (under msda_dec_fused the
    decoder's DEC_LAYERS sorted query sets on K7, the encoder's forwards and
    replays on K6), and K9 or K10 where it runs K3; banded_point runs K5
    where the gather runs K1, and K3.  With remat_save_kernels False the
    checkpointed blocks replay their kernels in the backward: ENC_LAYERS
    more forward MSDA launches under use_transformer_ckpt, ENC_LAYERS more
    K2 under use_checkpoint (both on unless the keys say False).  In bf16
    the same launches go to the bf16 entries, the LSAP kernel's (one a
    step, the matcher on the device) to its one entry."""
    per = dict(TRAIN_LAUNCHES_PER_STEP)
    if msda_keys.get("remat_save_kernels") is False:
        if msda_keys.get("use_transformer_ckpt") is not False:
            per["msda_fwd"] += ENC_LAYERS
        if msda_keys.get("use_checkpoint") is not False:
            per["fusion_fwd"] += ENC_LAYERS
    if msda_keys.get("msda_kernel") == "banded_point":
        per["banded_fwd"] = per.pop("msda_fwd")
    elif msda_keys.get("msda_kernel") == "sweep":
        per["sweep_fwd"] = per.pop("msda_fwd")
        if msda_keys.get("msda_dec_fused"):
            per["sweep_fwd"] -= DEC_LAYERS
            per["sweep_fwd_allq"] = DEC_LAYERS
        per["sweep_bwd_" + msda_keys.get("msda_sweep_bwd", "corner")] = per.pop("msda_bwd")
    suffix = "_bf16" if bf16 else ""
    return dict.fromkeys(kernel_counters(), 0) | {
        (k + suffix if k in BF16_KERNELS else k): v for k, v in per.items()}


def train(cfg: str, work: str, files, device: str, msda_keys=None, epochs: int = TRAIN_EPOCHS,
          max_steps: int = None, tag: str = "train", compute_dtype="float32",
          val: bool = False) -> dict:
    """The port's training entry (main.main) on the synthetic ODVG set at
    the config's full width and depth: B = 4, `compute_dtype` (None: the
    config's default, bf16), two steps an epoch (at most max_steps) from the
    smoke's seeded checkpoint (random biases), with the MSDA config keys
    `msda_keys` given as --options; with `val`, the 8 images also as a COCO
    val split, which main evaluates after each epoch; main saves one
    checkpoint, after the last epoch, which is not written (no phase reads
    a train() run's checkpoint; each weighs 2.6-5 GB: phase 23 writes and
    reads them): its state dict is made and its path handed back, the save
    asked for once with main's keys; counts the kernels' launches of the
    run."""
    import torch

    from open_groundingdino_tpu_torch import main as train_main
    from open_groundingdino_tpu_torch.utils import checkpoint as ckpt_io

    manifest = write_odvg(work)
    if val:
        manifest = write_coco_val(work)
    _, ckpt, vocab = files
    msda_keys = msda_keys or {}
    out_dir = os.path.join(work, f"{tag}_out")
    steps = 2 * epochs if max_steps is None else min(2 * epochs, max_steps)
    cli = train_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", out_dir,
        "--vocab", vocab, "--pretrain_model_path", ckpt, "--device", device,
        "--seed", str(SEED), "--num_workers", "2", "--print_freq", "1",
        *(["--max_steps", str(max_steps)] if max_steps else []),
        # one checkpoint a run, at its end: each weighs 2-4 GB, and the card's
        # machine takes at most 45 GiB of writes a run
        "--options", f"epochs={epochs}", "batch_size=4", f"save_checkpoint_interval={epochs}",
        *([f"compute_dtype={compute_dtype}"] if compute_dtype else []),
        *(f"{k}={v}" for k, v in msda_keys.items()),
    ])
    reset_counts()
    # what earlier phases still hold counts in the peak: free what nothing
    # references (models in reference cycles too) and read the rest
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    saves = []

    def unwritten(ckpt_dir, epoch, payload=None):
        saves.append((os.path.relpath(ckpt_dir, out_dir), epoch,
                      sorted(payload) if payload is not None else None))
        return ckpt_io.checkpoint_path(ckpt_dir, epoch)

    kept = ckpt_io.save_checkpoint, ckpt_io.link_checkpoint
    ckpt_io.save_checkpoint = lambda ckpt_dir, epoch, payload: unwritten(ckpt_dir, epoch, payload)
    ckpt_io.link_checkpoint = lambda src, ckpt_dir, epoch: unwritten(ckpt_dir, epoch)
    t0 = time.perf_counter()
    try:
        run = train_main.main(cli)
    finally:
        ckpt_io.save_checkpoint, ckpt_io.link_checkpoint = kept
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    records = run["records"]
    losses = [r["loss"] for r in records]
    step_s = [r["step_seconds"] for r in records]
    timed = sorted(step_s[1:]) or step_s   # the first step warms up
    median_s = timed[len(timed) // 2]
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs_logged = len(f.read().splitlines())
    dtype = run["train_step"].compute_dtype
    log(tag, f"{len(records)} steps (B=4, {dtype}, TF32 off{', ' if msda_keys else ''}"
             f"{', '.join(f'{k}={v}' for k, v in msda_keys.items())}) in {wall:.1f} s with set-up: "
                 f"losses {[round(x, 4) for x in losses]}; step s "
                 f"{[round(x, 3) for x in step_s]} (median of the {len(timed)} timed: "
                 f"{median_s:.3f} s); max_memory_allocated {peak / 2**30:.2f} GiB, of it "
                 f"{base / 2**30:.2f} GiB allocated before the run ({held / 2**30:.2f} GiB "
                 f"before a garbage collection freed what earlier phases left), the run's own "
                 f"{(peak - base) / 2**30:.2f} GiB; "
                 f"log.txt lines {epochs_logged}; launches { {k: v for k, v in counts.items() if v} } "
                 f"(per step { {k: v / max(len(records), 1) for k, v in counts.items() if v} })")
    if len(records) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    if epochs_logged != epochs:
        raise AssertionError(f"log.txt has {epochs_logged} lines, expected {epochs}")
    written = [(d, e, keys) for d, e, keys in saves if keys is not None]
    if (len(written) != 1 or written[0][:2] != (".", epochs - 1)
            or not {"model", "optimizer", "epoch"} <= set(written[0][2])):
        raise AssertionError(f"main asked for the saves {saves}, expected one of its state at "
                             f"epoch {epochs - 1}")
    want = {k: v * steps
            for k, v in train_launches_per_step(msda_keys, dtype == "bfloat16").items()}
    if val:   # each epoch's eval pass over the 8 images, B = 4
        msda_fwd = {"banded_point": "banded_fwd", "sweep": "sweep_fwd"}.get(
            msda_keys.get("msda_kernel"), "msda_fwd")
        evals = eval_launches(-(-len(TRAIN_IMAGE_SIZES) // 4) * epochs, dtype == "bfloat16",
                              msda_fwd)
        want = {k: v + evals[k] for k, v in want.items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return dict(run=run, counts=counts, losses=losses, step_seconds=step_s,
                median_step_s=median_s, peak_bytes=peak, wall_s=wall)


BF16_MANGLED = profiling.BF16_MANGLED
K1_BF16_NAMES, K3_BF16_NAMES = profiling.K1_BF16_NAMES, profiling.K3_BF16_NAMES
SWEEP_BF16_NAMES = profiling.SWEEP_BF16_NAMES
device_kernels = profiling.device_kernels
device_time_by_group = profiling.device_time_by_group
host_spans_ms = profiling.host_spans_ms


def check_device_kernels(prof) -> dict:
    """profiling.check_device_kernels, logged: the raw kineto events against
    key_averages() on one profile, and both readers' seconds."""
    r = profiling.check_device_kernels(prof)
    log("profiler", f"raw kineto events: {r['kernels']} kernels, {r['raw_ms']:.3f} ms in "
                    f"{r['raw_s']:.2f} s; key_averages(): {r['ref_kernels']} kernels, "
                    f"{r['ref_ms']:.3f} ms in {r['key_averages_s']:.2f} s; worst kernel's "
                    f"relative difference {r['worst_rel']:.1e}")
    return r


def profile_train_step(run, top: int = 8, tag: str = "train-profile") -> dict:
    """torch.profiler over one more training step (after one under its
    warm-up): device time and launches by kernel group against the step's
    wall time (profiler on)."""
    batches = iter(run["loader"])
    batch = next(batches)
    batches.close()   # stops the loader's threads
    prof, wall_ms = profiling.profile_calls(lambda: run["train_step"](run["state"], batch))
    t0 = time.perf_counter()
    kernels, groups, launches = device_time_by_group(prof)
    digest_s = time.perf_counter() - t0
    busy = sum(groups.values())
    log(tag, f"one step {wall_ms:.1f} ms wall (profiler on), device busy "
                         f"{busy:.1f} ms ({busy / wall_ms:.0%}; the profile read in {digest_s:.1f} "
                         f"s); by group ms "
                         f"{ {k: round(v, 2) for k, v in groups.items()} }, launches "
                         f"{ {k: n for k, n in launches.items() if n} }; top kernels "
                         f"{[(k[:48], round(ms, 2), n) for k, ms, n in kernels[:top]]}")
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "groups_ms": groups}


def module_of(name: str) -> str:
    for prefix, group in (("backbone.", "backbone"), ("bert.", "bert"),
                          ("transformer.encoder.", "encoder"),
                          ("transformer.decoder.", "decoder")):
        if name.startswith(prefix):
            return group
    return "heads"


def negated_output(fn, index=None):
    """`fn` with its index-th output (its one output: None) negated: a
    planted kernel fault."""
    def planted(*args):
        if index is None:
            return -fn(*args)
        out = list(fn(*args))
        out[index] = -out[index]
        return tuple(out)
    planted.launches = planted.launches_bf16 = 0   # the wrapper counts on its module's name
    return planted


def parity_harness(cfg: str, files):
    """The one-step comparisons' common ground: the same seeded weights, the
    same batch (B = 1, an 800x1216-bucket image), fusion droppath 0, the
    config's full depth.  Returns (step, gaps, within):
      step(device, msda=None, compute_dtype=None, frozen_keys=(), snapshot=None)
          - one training step of a fresh copy of the weights (MSDeformAttn
          attributes `msda` set on every deformable attention; f32 unless
          compute_dtype says bf16; the optimizer's frozen_keys): loss, every
          parameter's gradient on the host, seconds, and with `snapshot` the
          state-dict entries under that prefix after the step, on the host;
      gaps(run, ref, fed) - (loss rel, {module: gradient-norm rel}, {leaf
          whose name holds one of `fed`: ||g_run - g_ref|| / ||g_ref||});
      within(gaps) - all three inside the PARITY_* limits."""
    import copy

    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import Sample
    from open_groundingdino_tpu_torch.inference import load_reference_state_dict
    from open_groundingdino_tpu_torch.models.criterion import build_criterion
    from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
    from open_groundingdino_tpu_torch.parallel.optim import make_optimizer
    from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step

    _, ckpt, vocab = files
    args = SLConfig.fromfile(cfg)
    args.merge_from_dict({"fusion_droppath": 0.0})
    base = build_groundingdino(args, device="cpu")
    load_reference_state_dict(base, ckpt)

    h, w = 800, 1200
    rng = np.random.RandomState(SEED + 11)
    boxes = np.asarray([[100, 120, 500, 600], [600, 200, 1100, 700], [300, 400, 700, 780]],
                       np.float32)
    cap_list = list(CATEGORIES)
    sample = Sample(image=synthetic_image(h, w, 200), boxes=boxes,
                    labels=rng.randint(len(cap_list), size=len(boxes)).astype(np.int64),
                    caption=" . ".join(cap_list) + " .", cap_list=cap_list)
    collator = Collator(build_tokenizer(vocab), args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=True)
    batch = collator([sample])
    if tuple(batch["images"].shape[1:3]) != BUCKET:
        raise AssertionError(f"parity batch landed in {batch['images'].shape}, not {BUCKET}")

    def step(device, msda=None, compute_dtype=None, frozen_keys=(), snapshot=None):
        model = copy.deepcopy(base).to(device)
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for k, v in (msda or {}).items():
                    setattr(m, k, v)
        opt = make_optimizer(model, lr=float(args.lr), base_lr=float(args.lr),
                             lr_backbone=float(args.lr_backbone),
                             lr_linear_proj_mult=float(args.lr_linear_proj_mult),
                             weight_decay=float(args.weight_decay),
                             clip_max_norm=float(args.clip_max_norm), frozen_keys=frozen_keys)
        grads = {}
        step_fn = opt.step

        def spy(gs, norm, finite):
            grads.update((n, g.detach().to("cpu", copy=True)) for n, g in zip(opt.names, gs))
            step_fn(gs, norm, finite)

        opt.step = spy
        t0 = time.perf_counter()
        metrics = make_train_step(build_criterion(args), compute_dtype=compute_dtype)(
            TrainState.create(model, opt, seed=SEED), batch)
        if device == "cuda":
            torch.cuda.synchronize()
        run = dict(loss=float(metrics["loss"]), grads=grads, seconds=time.perf_counter() - t0)
        if snapshot:
            run["snapshot"] = {k: v.detach().to("cpu", copy=True)
                               for k, v in model.state_dict().items() if k.startswith(snapshot)}
        return run

    def gaps(run, ref, fed):
        sq = {}
        for dev, r in (("run", run), ("ref", ref)):
            for name, g in r["grads"].items():
                key = (dev, module_of(name))
                sq[key] = sq.get(key, 0.0) + float(g.double().pow(2).sum())
        modules = {m for _, m in sq}
        norm_rel = {m: abs(sq["run", m] ** 0.5 - sq["ref", m] ** 0.5)
                    / max(sq["ref", m] ** 0.5, 1e-30) for m in modules}
        leaf_rel = {}
        for name, g in ref["grads"].items():
            if any(k in name for k in fed):
                g = g.double()
                leaf_rel[name] = float((run["grads"][name].double() - g).norm()
                                       / max(float(g.norm()), 1e-30))
        loss_rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
        return loss_rel, norm_rel, leaf_rel

    def within(gap):
        loss_rel, norm_rel, leaf_rel = gap
        return (loss_rel < PARITY_LOSS_RTOL and all(v < PARITY_GRAD_RTOL for v in norm_rel.values())
                and all(v < PARITY_LEAF_RTOL for v in leaf_rel.values()))

    return step, gaps, within


def planted_faults(step, gaps, within, ref, fed, faults, tag, **step_kw) -> dict:
    """The card's step again with each planted kernel fault (label, module,
    wrapper name, output index): each must fail the comparison with ref."""
    planted = {}
    for label, module, attr, index in faults:
        kernel = getattr(module, attr)
        setattr(module, attr, negated_output(kernel, index))
        try:
            run = step("cuda", **step_kw)
        finally:
            setattr(module, attr, kernel)
        gap = gaps(run, ref, fed)
        planted[label] = max(gap[2].values())
        log(tag, f"planted fault, {label}: leaves ||dg||/||g|| max {planted[label]:.2e}, "
                 f"module grad-norm rel max {max(gap[1].values()):.2e}")
        if within(gap):
            raise AssertionError(f"{tag} passes with a planted fault: {label}")
    return planted


def check_train_parity(harness, cpu_step) -> dict:
    """One training step on the card and the same step on the CPU (plain
    versions of the kernels; `cpu_step` the future of harness's step("cpu"),
    run on a thread beside the earlier phases).  Loss within PARITY_LOSS_RTOL, each top-level
    module's gradient norm within PARITY_GRAD_RTOL, and the gradient of each
    parameter that K3 or K4 feeds within PARITY_LEAF_RTOL.  Then the card's
    step again with K3's grad_locs and, apart, K4's gvl negated: each planted
    fault must fail the same comparison.  Returns the comparison and the
    card's step."""
    from open_groundingdino_tpu_torch.ops import fusion, msda

    step, gaps, within = harness
    card = step("cuda")
    t0 = time.perf_counter()
    cpu = cpu_step.result()
    waited = time.perf_counter() - t0
    gap = gaps(card, cpu, KERNEL_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("train-parity", f"B=1 {BUCKET} bucket, config depth, droppath 0: loss card "
                        f"{card['loss']:.6f} CPU {cpu['loss']:.6f} (rel {loss_rel:.2e}, limit "
                        f"{PARITY_LOSS_RTOL}); grad-norm rel diff by module "
                        f"{ {k: f'{v:.2e}' for k, v in norm_rel.items()} } (limit "
                        f"{PARITY_GRAD_RTOL}); {len(leaf_rel)} K3/K4-fed leaves "
                        f"||dg||/||g|| max {max(leaf_rel.values()):.2e} (limit "
                        f"{PARITY_LEAF_RTOL}), worst {[(n, f'{v:.2e}') for n, v in worst]}; "
                        f"step s card {card['seconds']:.1f}, CPU {cpu['seconds']:.1f} (on its "
                        f"own thread; {waited:.1f} s waited for it here)")
    if len(card["grads"]) != len(cpu["grads"]) or not within(gap):
        raise AssertionError("the card's training step disagrees with the CPU's")
    planted = planted_faults(step, gaps, within, cpu, KERNEL_FED,
                             (("K3 grad_locs negated", msda, "ms_deform_attn_bwd", 1),
                              ("K4 gvl negated", fusion, "fused_bi_attention_bwd", 3)),
                             "train-parity")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()),
                planted=planted), card


def check_sweep_train_parity(harness, gather_card) -> tuple:
    """One training step through the sweep (K6 forward, K9 backward) and one
    with the row-tap backward (K10) against the gather's step on the card
    (phase 11's) from the same weights and batch: loss within
    PARITY_LOSS_RTOL, module gradient norms within PARITY_GRAD_RTOL, and
    each parameter that the MSDA kernels feed within PARITY_LEAF_RTOL.  Then
    each with its backward's gw negated, which must fail.  Returns the
    comparisons and the two sweep steps (phase 25 holds its bf16 steps
    against them)."""
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    step, gaps, within = harness
    res, cards = {}, {}
    for bwd, fault in (("corner", ("K9 gw negated", sw, "sweep_bwd_corner", 1)),
                       ("rowtap", ("K10 gw negated", sw, "sweep_bwd_rowtap", 2))):
        sweep = {"kernel": "sweep", "sweep_bwd": bwd}
        run = step("cuda", msda=sweep)
        gap = gaps(run, gather_card, MSDA_FED)
        loss_rel, norm_rel, leaf_rel = gap
        worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
        log("sweep-train-parity", f"sweep step ({bwd} backward) vs gather step on the card: loss "
                                  f"{run['loss']:.6f} vs {gather_card['loss']:.6f} (rel "
                                  f"{loss_rel:.2e}); grad-norm rel by module "
                                  f"{ {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
                                  f"{len(leaf_rel)} MSDA-fed leaves ||dg||/||g|| max "
                                  f"{max(leaf_rel.values()):.2e} (limit {PARITY_LEAF_RTOL}), "
                                  f"worst {[(n, f'{v:.2e}') for n, v in worst]}; step s "
                                  f"{run['seconds']:.1f}")
        if not within(gap):
            raise AssertionError(f"the sweep's training step ({bwd}) disagrees with the gather's")
        planted = planted_faults(step, gaps, within, gather_card, MSDA_FED, (fault,),
                                 "sweep-train-parity", msda=sweep)
        res[bwd] = dict(loss_rel=loss_rel, norm_rel=norm_rel,
                        leaf_rel_max=max(leaf_rel.values()), planted=planted)
        cards[bwd] = run
    return res, cards


def profile_request(im, image, caption, top: int = 8, tag: str = "profile",
                    check_reader: bool = False, **predict_kw) -> dict:
    """torch.profiler over one warm request (after one under its warm-up;
    `predict_kw` go to predict): device time and launches by kernel group
    (KERNEL_GROUPS, matrix products, the rest) against the request's wall
    time (profiler on).  With `check_reader`, the raw-event reader is held
    against key_averages() on this profile (check_device_kernels)."""
    import torch

    from open_groundingdino_tpu_torch import inference

    inference.predict(im, image, caption, **predict_kw)
    torch.cuda.synchronize()
    prof, wall_ms = profiling.profile_calls(
        lambda: inference.predict(im, image, caption, **predict_kw))
    reader = check_device_kernels(prof) if check_reader else None
    kernels, groups, launches = device_time_by_group(prof)
    busy = sum(groups.values())
    log(tag, f"one request {wall_ms:.1f} ms wall (profiler on), device busy {busy:.1f} ms "
                   f"({busy / wall_ms:.0%}); by group ms "
                   f"{ {k: round(v, 2) for k, v in groups.items()} }, launches "
                   f"{ {k: n for k, n in launches.items() if n} }; top kernels "
                   f"{[(k[:48], round(ms, 2), n) for k, ms, n in kernels[:top]]}")
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "groups_ms": groups, "reader": reader}


# ---------------------------------------------------------------- bf16 (phases 20, 21)
# the bf16 entries against their bf16 plain versions, relative to the largest
# |reference| of each output: both sides take the same bf16 operands and sum
# in f32, and round the same values to bf16, so they part where a sum's order
# moves a rounding across a bf16 step (2^-8 relative); K2's text side sums
# at nearly f32, as the plain version and the TPU kernel do, so its error is
# held to twice the image side's; K3's grad_value adds in bf16 (atomics, each add
# rounded), the JAX package's bound for that accumulation being 3e-2
# (tests/test_msda_banded.py:133)
BF16_FWD_RTOL = 1e-2
# K2's text side against its image side (the same bf16 output rounding)
K2_BF16_TEXT_SIDE = 2.0
BF16_K3_GV_RTOL = 3e-2
BF16_K3_RTOL = 1e-3          # grad_locs, grad_attn: f32 from the same bf16 rows
BF16_K4_RTOL = 1e-2
# phase 21: the bf16 step on the card against the f32 step on the card, from
# the same weights and batch.  bf16 moves each sampling offset by its
# rounding, and a bilinear sample's position derivative jumps where the
# position crosses a pixel centre: at these random weights the worst
# K3/K4-fed gradient (a decoder value projection, an encoder's sampling
# offsets) reads 0.38 of its norm apart (H100 run), as the JAX package's own
# bf16 step reads a module's gradient 27% from its f32 step
# (tests/test_torch_bf16.py); a negated bf16 kernel output reads ~2
BF16_LOSS_RTOL = 2e-2
BF16_LEAF_RTOL = 0.75


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in f32."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def bf16_mma_report(libs) -> dict:
    """The fusion libraries' bf16 tensor-core MMAs in their SASS
    (HMMA.16816.F32.BF16 from mma.sync m16n8k16 bf16: each must hold some)
    and ptxas's report of their bf16 kernels."""
    report = {}
    for name in libs:
        sass = library_sass(name)
        hmma = sum(1 for line in sass.splitlines() if "HMMA.16816.F32.BF16" in line)
        if hmma == 0:
            raise AssertionError(f"{name}: no HMMA.16816.F32.BF16 in its SASS")
        kernels = ptxas_kernels(name, [(k, k) for k in ("attend_bf16_kernel", "combine_bf16_kernel",
                                                        "bwd_bf16_kernel",
                                                        "sum_splits_bf16_kernel")])
        report[name] = dict(hmma_bf16=hmma, ptxas={k: v for k, v in kernels.items()
                                                   if "bf16" in k})
        log("sass", f"lib{name}.so bf16 entry: {hmma} HMMA.16816.F32.BF16; ptxas "
                    f"{report[name]['ptxas']}")
    return report


def check_bf16_kernels(device) -> dict:
    """Phase 20: the bf16 entries of K1, K3 (phase 3's B = 1 and phase 8's
    B = 4 encoder and decoder shapes) and K2, K4 (phase 4's B = 1 and phase
    9's B = 4 fusion shapes) against their bf16 plain versions on the card,
    timed by CUDA events and by torch.profiler's device time, with their
    bounds at bf16 bytes and the bf16 tensor-core rate; K2's and K4's bf16
    MMAs in their SASS, K3's bf16 atomics in its."""
    import torch

    from open_groundingdino_tpu_torch.ops import fusion, msda

    import ctypes

    from open_groundingdino_tpu_torch.ops import build

    bf = torch.bfloat16
    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 20)
    smem_fn = build.load("msda_bwd").msda_bwd_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_int
    rows = {}
    for batch, valid in (("B=1", (BUCKET,)), ("B=4", BATCH_VALID)):
        B = len(valid)
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            value = value.to(bf)
            fwd = lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn)   # noqa: E731
            err, rel = rel_err(fwd(), msda.ms_deform_attn_plain(value, shapes, starts, locs, attn))
            if not rel <= BF16_FWD_RTOL:
                raise AssertionError(f"K1 bf16 {batch} {name}: error {rel} of max|ref| > "
                                     f"{BF16_FWD_RTOL}")
            bound = msda_bound_ms(value, shapes, locs, attn)
            rows["K1", batch, name] = dict(
                max_abs_err=err, rel_err=rel, ms=event_ms(fwd, 50),
                device_ms=kernel_device_ms(fwd, 50, K1_BF16_NAMES),
                plain_ms=event_ms(
                    lambda: msda.ms_deform_attn_plain(value, shapes, starts, locs, attn), 3),
                bound_ms=bound[0], bound_by=bound[1])
            grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device).to(bf)
            args = (value, shapes, starts, locs, attn, grad_out)
            got, ref = msda.ms_deform_attn_bwd(*args), msda.ms_deform_attn_bwd_plain(*args)
            errs, abs_errs = {}, {}
            for key, a, b, tol in zip(("grad_value", "grad_locs", "grad_attn"), got, ref,
                                      (BF16_K3_GV_RTOL, BF16_K3_RTOL, BF16_K3_RTOL)):
                abs_errs[key], errs[key] = rel_err(a, b)
                if not errs[key] <= tol:
                    raise AssertionError(f"K3 bf16 {batch} {name} {key}: error {errs[key]} of "
                                         f"max|ref| > {tol}")
            if got[0].dtype != bf or got[1].dtype != torch.float32:
                raise AssertionError(f"K3 bf16 returned {[t.dtype for t in got]}")
            bwd = lambda: msda.ms_deform_attn_bwd(*args)   # noqa: E731
            bound = msda_bwd_bound_ms(value, shapes, locs, attn)
            # a record, not a check: the f32 entry's plan (fewer levels in
            # shared memory, more bf16 adds a row) on the same operands
            budget, msda.BWD_SMEM_BUDGET_BF16 = msda.BWD_SMEM_BUDGET_BF16, msda.BWD_SMEM_BUDGET
            try:
                f32_plan = dict(grad_value_rel_err=rel_err(bwd()[0], ref[0])[1],
                                ms=event_ms(bwd, 20))
            finally:
                msda.BWD_SMEM_BUDGET_BF16 = budget
            plan = msda.msda_bwd_plan(shapes, B, q, HEADS, msda.BWD_SMEM_BUDGET_BF16)._asdict()
            if smem_fn(plan["smem_rows"]) != plan["smem_bytes"]:
                raise AssertionError(f"K3 bf16's plan {plan}: the kernel needs "
                                     f"{smem_fn(plan['smem_rows'])} B of shared memory")
            rows["K3", batch, name] = dict(plan=plan, with_f32_plan=f32_plan,
                max_abs_err=max(abs_errs.values()), rel_errs=errs, ms=event_ms(bwd, 20),
                device_ms=kernel_device_ms(bwd, 20, K3_BF16_NAMES),
                plain_ms=event_ms(lambda: msda.ms_deform_attn_bwd_plain(*args), 3),
                bound_ms=bound[0], bound_by=bound[1])
            for kname in ("K1", "K3"):
                r = rows[kname, batch, name]
                log("bf16-kernels", f"{kname} {batch} {name} Q={q}: error of max|ref| "
                    f"{r.get('rel_errs', r.get('rel_err'))} (limits fwd {BF16_FWD_RTOL}, "
                    f"grad_value {BF16_K3_GV_RTOL}, grad_locs/attn {BF16_K3_RTOL}); kernel "
                    f"{r['ms']:.4f} ms (device time {r['device_ms']:.4f} ms), plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                    + (f"; plan {r['plan']} (the f32 entry's plan: grad_value error "
                       f"{r['with_f32_plan']['grad_value_rel_err']:.3e} of max|ref|, "
                       f"{r['with_f32_plan']['ms']:.4f} ms)" if kname == "K3" else ""))
    for batch, valid, live in (("B=1", ((800, 1066),), (LIVE_TEXT,)),
                               ("B=4", BATCH_VALID, BATCH_LIVE_TEXT)):
        args = list(fusion_inputs(g, device, valid, live))
        args[:4] = [t.to(bf) for t in args[:4]]
        q, k, val_v, val_l, mask_v, mask_l = args
        fwd = lambda: fusion._fusion_fwd_cuda(*args, FUSION_HEADS)   # noqa: E731
        out_v, out_l, lse_v, lse_l = fwd()
        ov_p, ol_p = fusion.fused_bi_attention_plain(*args, FUSION_HEADS)
        abs_errs, errs = zip(rel_err(out_v, ov_p), rel_err(out_l, ol_p))
        errs = dict(zip(("out_v", "out_l"), errs))
        # a record beside the limits: the mean |error| over the mean |reference|
        # and the share of elements whose bf16 value differs, each side apart
        mean_errs = {k: (float((a.float() - b.float()).abs().mean() / b.float().abs().mean()),
                         float((a != b).float().mean()))
                     for k, a, b in (("out_v", out_v, ov_p), ("out_l", out_l, ol_p))}
        del ov_p, ol_p
        if not max(errs.values()) <= BF16_FWD_RTOL:
            raise AssertionError(f"K2 bf16 {batch}: errors of max|ref| {errs} > {BF16_FWD_RTOL}")
        # the text side sums val_v^T.P_l at nearly f32 (P_l in two bf16
        # parts), as the TPU kernel does: its error is the output's bf16
        # rounding, the image side's level
        if not errs["out_l"] <= K2_BF16_TEXT_SIDE * errs["out_v"]:
            raise AssertionError(f"K2 bf16 {batch}: out_l's error {errs['out_l']:.3e} of max|ref| "
                                 f"> {K2_BF16_TEXT_SIDE} x out_v's {errs['out_v']:.3e}")
        bound = fusion_bound_ms(q, k, mask_v, mask_l)
        frags = ("attend_bf16_kernel", "combine_bf16_kernel")
        rows["K2", batch, "fusion"] = dict(
            max_abs_err=max(abs_errs), rel_errs=errs, mean_rel_errs_and_share_differing=mean_errs,
            ms=event_ms(fwd, 5),
            device_ms=kernel_device_ms(fwd, 5, frags, per_call=3),
            plain_ms=event_ms(lambda: fusion.fused_bi_attention_plain(*args, FUSION_HEADS), 3),
            bound_ms=bound[0], bound_by=bound[1])
        g_ov = torch.randn(q.shape, generator=g, device=device).to(bf)
        g_ol = torch.randn(k.shape, generator=g, device=device).to(bf)
        bwd_args = (*args, out_v, out_l, lse_v, lse_l, g_ov, g_ol, FUSION_HEADS)
        got = fusion.fused_bi_attention_bwd(*bwd_args)
        ref = fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS)
        abs_errs, errs = zip(*(rel_err(a, b) for a, b in zip(got, ref)))
        errs = dict(zip(("gq", "gk", "gvv", "gvl"), errs))
        del ref
        if not max(errs.values()) <= BF16_K4_RTOL or {t.dtype for t in got} != {bf}:
            raise AssertionError(f"K4 bf16 {batch}: errors of max|ref| {errs} > {BF16_K4_RTOL} "
                                 f"or dtypes {[t.dtype for t in got]}")
        bwd = lambda: fusion.fused_bi_attention_bwd(*bwd_args)   # noqa: E731
        bound = fusion_bwd_bound_ms(q, k, mask_v, mask_l)
        rows["K4", batch, "fusion"] = dict(
            max_abs_err=max(abs_errs), rel_errs=errs, ms=event_ms(bwd, 5),
            device_ms=kernel_device_ms(bwd, 5, ("bwd_bf16_kernel", "sum_splits_bf16_kernel"),
                                       per_call=3),
            plain_ms=event_ms(
                lambda: fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS), 2),
            bound_ms=bound[0], bound_by=bound[1])
        for kname in ("K2", "K4"):
            r = rows[kname, batch, "fusion"]
            log("bf16-kernels", f"{kname} {batch} (valid {valid}, live text {live}): error of "
                f"max|ref| { {k_: f'{v:.2e}' for k_, v in r['rel_errs'].items()} } (limit "
                f"{BF16_FWD_RTOL if kname == 'K2' else BF16_K4_RTOL}"
                + (f"; out_l at most {K2_BF16_TEXT_SIDE} x out_v's; mean |error| of mean |ref| "
                   f"and share of elements differing "
                   f"{ {k_: f'{a:.2e}, {b:.2e}' for k_, (a, b) in mean_errs.items()} }"
                   if kname == "K2" else "") + f"); kernel {r['ms']:.3f} ms "
                f"(device time {r['device_ms']:.3f} ms), plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        del got, bwd_args, args
    sass = bf16_mma_report(("fusion_fwd", "fusion_bwd"))
    atomics = sass_atomics("msda_bwd")
    log("sass", f"libmsda_bwd.so SASS atomics with the bf16 entry: {atomics}")
    if atomics["red_global_bf16x2"] == 0:
        raise AssertionError("K3's bf16 entry holds no bf16 global reduction")
    sass["msda_bwd_atomics"] = atomics
    return {"rows": rows, "sass": sass}


def train_bf16(cfg, work, train_files, harness, f32_card) -> dict:
    """Phase 21: main with the config's default compute_dtype (bf16) at
    B = 4, full width and depth, 1 warm-up + 5 timed steps (12 K1 + 12 K3 +
    6 K2 + 6 K4 bf16 launches a step, no f32 ones) and a profiled step;
    then phase 11's step in bf16 on the card against phase 11's f32 step on
    the card (loss within BF16_LOSS_RTOL, each K3/K4-fed gradient within
    BF16_LEAF_RTOL), and with a negated bf16 K3 grad_locs, and apart a
    negated bf16 K4 gvl, each must fail."""
    from open_groundingdino_tpu_torch.ops import fusion, msda

    run = train(cfg, work, train_files, "cuda", tag="bf16-train", compute_dtype=None)
    if run["run"]["train_step"].compute_dtype != "bfloat16":
        raise AssertionError("main's default compute_dtype is not bf16")
    run["profile"] = profile_train_step(run.pop("run"), tag="bf16-train-profile")

    step, gaps, _ = harness

    def within(gap):
        return gap[0] < BF16_LOSS_RTOL and all(v < BF16_LEAF_RTOL for v in gap[2].values())

    card = step("cuda", compute_dtype="bfloat16")
    gap = gaps(card, f32_card, KERNEL_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("bf16-parity", f"B=1 {BUCKET} bucket: loss bf16 {card['loss']:.6f} f32 "
                       f"{f32_card['loss']:.6f} (rel {loss_rel:.2e}, limit {BF16_LOSS_RTOL}); "
                       f"grad-norm rel diff by module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
                       f"{len(leaf_rel)} K3/K4-fed leaves ||dg||/||g|| max "
                       f"{max(leaf_rel.values()):.2e} (limit {BF16_LEAF_RTOL}), worst "
                       f"{[(n, f'{v:.2e}') for n, v in worst]}; step s {card['seconds']:.1f}")
    if not within(gap):
        raise AssertionError("the bf16 step disagrees with the f32 step")
    planted = planted_faults(step, gaps, within, f32_card, KERNEL_FED,
                             (("bf16 K3 grad_locs negated", msda, "ms_deform_attn_bwd", 1),
                              ("bf16 K4 gvl negated", fusion, "fused_bi_attention_bwd", 3)),
                             "bf16-parity", compute_dtype="bfloat16")
    run["parity"] = dict(loss_rel=loss_rel, leaf_rel_max=max(leaf_rel.values()), planted=planted)
    run["parity_card"] = card   # phase 25 reads the bf16 sweep step's distance from it
    return run


# ---------------------------------------------------------------- eval, checkpoints (phases 22, 23)
# phase 22 (b): four landscape images of the ODVG set whose eval sizes
# (800x1066, 800x1066, 800x1120, 800x1200) share the 800x1216 bucket, each
# with its own valid region
EVAL_PARITY_IMAGES = (0, 2, 4, 6)
# the pseudo ground truth: the batch's highest-scoring detections after the
# postprocessor's class-agnostic NMS, 10 an image on average.  The CPU's own
# detections then score AP 1.0 exactly: each box matches itself, and every
# other detection ranks below all of them (a per-image top 10 would let one
# image's false positives outrank another's true ones); the card's f32
# detections score within EVAL_AP_TOL of it; a negated K1 output must cost
# more than EVAL_FAULT_DROP
PSEUDO_GT_PER_IMAGE = 10
PSEUDO_GT_NMS = 0.5
# every (query, category) pair goes into the NMS
PSEUDO_GT_NUM_SELECT = 900 * len(CATEGORIES)
EVAL_AP_TOL = 0.02
EVAL_FAULT_DROP = 0.3
# phase 23: the epoch-1 loss of a run resumed from the continuous run's own
# checkpoint_0.pth against the continuous run's.  Two runs apart from the
# start part by more: K3's bf16 atomics add in an order that changes from
# run to run, and the Hungarian matching turns the last bits into another
# assignment (1.3e-3 and 5.5e-3 relative at epoch 2 in two H100 runs of
# this phase): recorded for the split run, not held
RESUME_LOSS_RTOL = 1e-3
STAT_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm",
             "ARl")
LOG_KEYS = ("epoch", "loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm", *STAT_KEYS,
            *(f"ema_{k}" for k in STAT_KEYS), "best_AP")


def run_main(cfg: str, manifest: str, files, out_dir: str, *flags: str, options=(),
             device: str = "cuda") -> dict:
    """open_groundingdino_tpu_torch.main on `device` from the smoke's seeded
    checkpoint (files: cfg, ckpt, vocab), B = 4."""
    from open_groundingdino_tpu_torch import main as train_main

    _, ckpt, vocab = files
    cli = train_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", out_dir, "--vocab", vocab,
        "--pretrain_model_path", ckpt, "--device", device, "--seed", str(SEED),
        "--num_workers", "2", "--print_freq", "1", *flags,
        "--options", "batch_size=4", *options,
    ])
    return train_main.main(cli)


# ---------------------------------------------------------------- bf16 sweep (phases 24, 25)
# phase 24: the bf16 entries of K6, K7, K9 and K10 against their bf16 plain
# versions (the plain versions on the same bf16 operands, summed in f32 and
# rounded to bf16 once), relative to each output's largest |reference|.  The
# forwards' outputs and grad_value sum in f32 on both sides and are rounded
# once, so they part where a sum's order moves a rounding across a bf16 step:
# at most 2^-8 of the largest element (grad_value's sums are f32 atomics in a
# run-dependent order, as in the f32 entries); gw and gpx are f32 on both
# sides, sums of the same bf16 rows' products in another order
BF16_SWEEP_GV_RTOL = 1e-2
BF16_SWEEP_TAP_RTOL = 1e-3


def check_bf16_sweep(device) -> dict:
    """Phase 24: the bf16 entries of K6 (and K7 on the decoder's sorted query
    set) at phase 8's B = 4 encoder and decoder shapes, each image with its
    own valid region, and at phase 3's B = 1 shapes; of K9 (corner taps) and
    K10 (row taps) at the B = 4 shapes; each against its bf16 plain version
    on the operands the model path gives it (phase 12's), timed by CUDA
    events and by torch.profiler's device time, against bounds at bf16 value
    and g bytes (the backwards' grad_value at f32 bytes); then ptxas's
    registers, shared memory and spills of the four bf16 instances (K6's and
    K7's without spills) and the global reductions in K9's and K10's bf16
    SASS: f32 ones, no bf16x2."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    bf = torch.bfloat16
    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 24)
    rows = {}
    for batch, valid in (("B=4", BATCH_VALID), ("B=1", (BUCKET,))):
        B = len(valid)
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            value = value.to(bf)
            grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device).to(bf)
            ops = sweep_operands(value, shapes, locs, attn, grad_out)
            row, px, w, idx, wc, g_k = (ops[k] for k in ("row", "px", "w", "idx", "wc", "g"))
            fwd_plain = lambda: sw.sweep_fwd_plain(value, row, px, w).to(bf)   # noqa: E731
            out_p = fwd_plain()
            fwd_bound = msda_bound_ms(value, shapes, locs, attn)
            fwd_plain_ms = event_ms(fwd_plain, 3)
            fwds = [("K6", sw.sweep_fwd)] + ([("K7", sw.sweep_fwd_allq)] if q != L else [])
            for kname, fn in fwds:
                call = lambda: fn(value, shapes, row, px, w)   # noqa: E731
                out = call()
                err, rel = rel_err(out, out_p)
                if out.dtype != bf or not rel <= BF16_FWD_RTOL:
                    raise AssertionError(f"{kname} bf16 {batch} {name}: {out.dtype}, error {rel} "
                                         f"of max|ref| (limit {BF16_FWD_RTOL})")
                rows[kname, batch, name] = dict(
                    B=B, Q=q, max_abs_err=err, rel_errs={"out": rel}, ms=event_ms(call, 10),
                    device_ms=kernel_device_ms(call, 10, SWEEP_BF16_NAMES[kname]),
                    plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
            del out_p
            if batch == "B=1":
                continue
            bwd_bound = msda_bwd_bound_ms(value, shapes, locs, attn, grad_value_size=4)
            for kname, fn, plain, args, keys, masks in (
                    ("K9", sw.sweep_bwd_corner, sw.sweep_bwd_corner_plain, (idx, wc),
                     ("grad_value", "gw"), {"gw": wc != 0}),
                    ("K10", sw.sweep_bwd_rowtap, sw.sweep_bwd_rowtap_plain, (row, px, w),
                     ("grad_value", "gpx", "gw"), {})):
                got = dict(zip(keys, fn(value, shapes, *args, g_k)))
                ref = dict(zip(keys, plain(value, *args, g_k)))
                ref["grad_value"] = ref["grad_value"].to(bf)
                dtypes = [got[k].dtype for k in keys]
                if dtypes != [bf] + [torch.float32] * (len(keys) - 1):
                    raise AssertionError(f"{kname} bf16 returned {dtypes}")
                abs_errs, errs = {}, {}
                for key in keys:
                    m = masks.get(key)
                    abs_errs[key], errs[key] = rel_err(got[key] if m is None else got[key][m],
                                                       ref[key] if m is None else ref[key][m])
                del got, ref
                limits = {k: BF16_SWEEP_GV_RTOL if k == "grad_value" else BF16_SWEEP_TAP_RTOL
                          for k in keys}
                if any(errs[k] > limits[k] for k in keys):
                    raise AssertionError(f"{kname} bf16 {name}: errors of max|ref| {errs} > "
                                         f"{limits}")
                call = lambda: fn(value, shapes, *args, g_k)   # noqa: E731
                rows[kname, batch, name] = dict(
                    B=B, Q=q, max_abs_err=max(abs_errs.values()), rel_errs=errs,
                    ms=event_ms(call, 5),
                    device_ms=kernel_device_ms(call, 5, SWEEP_BF16_NAMES[kname]),
                    plain_ms=event_ms(lambda: plain(value, *args, g_k), 2),
                    bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    for (kname, batch, name), r in rows.items():
        log("bf16-sweep-kernels",
            f"{kname} {batch} {name} Q={r['Q']}: error of max|ref| "
            f"{ {k: f'{v:.3e}' for k, v in r['rel_errs'].items()} } (limits fwd {BF16_FWD_RTOL}, "
            f"grad_value {BF16_SWEEP_GV_RTOL}, gw/gpx {BF16_SWEEP_TAP_RTOL}"
            f"{', gw where w != 0' if kname == 'K9' else ''}); kernel {r['ms']:.4f} ms (device "
            f"time {r['device_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    sass = {}
    for lib, kernels in (("msda_rowtap_fwd", {"K6": "rowtap_fwd_kernel", "K7": "allq_fwd_kernel"}),
                         ("msda_corner_bwd", {"K9": "corner_bwd_kernel"}),
                         ("msda_rowtap_bwd", {"K10": "rowtap_bwd_kernel"})):
        ptxas = ptxas_kernels(lib, [(f"{k}{BF16_MANGLED}", f"{k}<bf16>") for k in kernels.values()])
        for kname, kernel in kernels.items():
            sass[kname] = {"ptxas": ptxas[f"{kernel}<bf16>"]}
            if kname in ("K9", "K10"):
                sass[kname]["atomics"] = sass_atomics(lib, f"{kernel}{BF16_MANGLED}")
            log("sass", f"lib{lib}.so {kname} bf16 ({kernel}<__nv_bfloat16>): {sass[kname]}")
        for kname in kernels:
            atomics = sass[kname].get("atomics")
            if kname in ("K6", "K7") and sass[kname]["ptxas"]["spill_bytes"]:
                raise AssertionError(f"{kname} bf16 spills under its launch bounds: {sass[kname]}")
            if atomics and (atomics["red_global_bf16x2"] or not atomics["red_global_f32x4"]):
                raise AssertionError(f"{kname} bf16's grad_value reductions are not the f32 "
                                     f"entry's float4 f32 ones: {atomics}")
    return {"rows": rows, "sass": sass}


def train_bf16_sweep(cfg, work, train_files, eval_files, harness, sweep_f32_cards,
                     gather_bf16_card) -> dict:
    """Phase 25: main --options msda_kernel=sweep in the config's default
    bf16 at B = 4, full width and depth: 1 warm-up + 1 timed step (each a
    12 K6 + 12 K9 + 6 K2 + 6 K4 bf16 launches, no f32 entry and no K1, K3);
    1 step with msda_sweep_bwd=rowtap (12 K10 bf16, no
    K9), and 1 with msda_dec_fused=True (the decoder's 6
    on K7 bf16, the encoder's 6 on K6 bf16).  Then phase 15's B = 1 step in bf16 through the
    sweep, with the corner and the row-tap backward, against phase 15's f32
    sweep steps on the card (loss within BF16_LOSS_RTOL, each MSDA-fed
    gradient within BF16_LEAF_RTOL), its distance from phase 21's bf16
    gather step recorded; with K9 bf16's, and apart K10 bf16's, gw negated
    each must fail.  Last, main --eval through the sweep in bf16 on phase
    22's val split: 12 finite stats, 12 K6 + 6 K2 bf16 launches a batch and
    nothing else, images/s over a second pass."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    sweep = {"msda_kernel": "sweep"}
    runs = {}
    for tag, keys, kw in (("bf16-sweep-train", sweep, dict(epochs=1)),
                          ("bf16-sweep-train-rowtap", sweep | {"msda_sweep_bwd": "rowtap"},
                           dict(epochs=1, max_steps=1)),
                          ("bf16-sweep-train-fused", sweep | {"msda_dec_fused": True},
                           dict(epochs=1, max_steps=1))):
        run = train(cfg, work, train_files, "cuda", keys, tag=tag, compute_dtype=None, **kw)
        if run["run"]["train_step"].compute_dtype != "bfloat16":
            raise AssertionError("main's default compute_dtype is not bf16")
        del run["run"]
        runs[tag] = run

    step, gaps, _ = harness

    def within(gap):
        return gap[0] < BF16_LOSS_RTOL and all(v < BF16_LEAF_RTOL for v in gap[2].values())

    parity = {}
    for bwd, fault in (("corner", ("K9 bf16 gw negated", sw, "sweep_bwd_corner", 1)),
                       ("rowtap", ("K10 bf16 gw negated", sw, "sweep_bwd_rowtap", 2))):
        msda = {"kernel": "sweep", "sweep_bwd": bwd}
        card = step("cuda", msda=msda, compute_dtype="bfloat16")
        gap = gaps(card, sweep_f32_cards[bwd], MSDA_FED)
        to_gather = gaps(card, gather_bf16_card, MSDA_FED)
        loss_rel, norm_rel, leaf_rel = gap
        worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
        log("bf16-sweep-parity",
            f"B=1 {BUCKET} bucket, sweep ({bwd} backward): loss bf16 {card['loss']:.6f} f32 "
            f"{sweep_f32_cards[bwd]['loss']:.6f} (rel {loss_rel:.2e}, limit {BF16_LOSS_RTOL}); "
            f"grad-norm rel by module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
            f"{len(leaf_rel)} MSDA-fed leaves ||dg||/||g|| max {max(leaf_rel.values()):.2e} "
            f"(limit {BF16_LEAF_RTOL}), worst {[(n, f'{v:.2e}') for n, v in worst]}; against "
            f"phase 21's bf16 gather step: loss rel {to_gather[0]:.2e}, leaves max "
            f"{max(to_gather[2].values()):.2e}; step s {card['seconds']:.1f}")
        if not within(gap):
            raise AssertionError(f"the bf16 sweep step ({bwd}) disagrees with the f32 sweep step")
        planted = planted_faults(step, gaps, within, sweep_f32_cards[bwd], MSDA_FED, (fault,),
                                 "bf16-sweep-parity", msda=msda, compute_dtype="bfloat16")
        parity[bwd] = dict(loss_rel=loss_rel, leaf_rel_max=max(leaf_rel.values()),
                           vs_gather_bf16=dict(loss_rel=to_gather[0],
                                               leaf_rel_max=max(to_gather[2].values())),
                           planted=planted)

    write_odvg(work)
    manifest = write_coco_val(work)
    n_images = len(TRAIN_IMAGE_SIZES)
    n_batches = -(-n_images // 4)
    tag = "eval-bf16-sweep"
    out_dir = os.path.join(work, f"{tag}_out")
    reset_counts()
    t0 = time.perf_counter()
    run = run_main(cfg, manifest, eval_files, out_dir, "--eval", options=("msda_kernel=sweep",))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(out_dir, "eval_stats.json")) as f:
        stats = json.load(f)
    want = eval_launches(n_batches, True, "sweep_fwd")
    if counts != want:
        raise AssertionError(f"{tag}: kernel launches {counts}, expected {want}")
    if set(stats) != set(STAT_KEYS) or not all(map(math.isfinite, stats.values())):
        raise AssertionError(f"{tag}: eval_stats.json {stats}")
    params = dict(run["model"].named_parameters())
    t0 = time.perf_counter()
    run["run_eval"](params)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    log(tag, f"main --eval --options msda_kernel=sweep on {n_images} images (B=4, {n_batches} "
             f"batches, bfloat16): {first_s:.1f} s with set-up; stats {stats}; launches "
             f"{ {k: v for k, v in counts.items() if v} }; a second pass {pass_s:.3f} s, "
             f"{n_images / pass_s:.2f} images/s")
    runs[tag] = dict(counts=counts, stats=stats, pass_s=pass_s, images_per_s=n_images / pass_s)
    del run, params
    return {"runs": runs, "parity": parity}


def eval_launches(n_batches: int, bf16: bool, msda_fwd: str = "msda_fwd") -> dict:
    """An eval pass's launches: a forward's 12 MSDA forwards (K1, or the
    sweep's K6: msda_fwd="sweep_fwd", or banded_point's K5: "banded_fwd")
    and 6 K2 a batch, in the compute dtype's entries, and nothing else."""
    want = dict.fromkeys(kernel_counters(), 0)
    suffix = "_bf16" if bf16 else ""
    want[f"{msda_fwd}{suffix}"], want[f"fusion_fwd{suffix}"] = 12 * n_batches, 6 * n_batches
    return want


def check_eval_main(cfg: str, work: str, files, device: str = "cuda") -> dict:
    """Phase 22 (a): main --eval on a COCO val split of the 8 ODVG images
    (their boxes as annotations), with the config's bf16 and with
    compute_dtype=float32: eval_stats.json with the 12 finite stats, the
    launches of K1 and K2 in the compute dtype's entry only; images/s over a
    second pass, and in bf16 one batch's device busy share under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    write_odvg(work)
    manifest = write_coco_val(work)
    n_images = len(TRAIN_IMAGE_SIZES)
    n_batches = -(-n_images // 4)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        tag = f"eval-{dtype}"
        out_dir = os.path.join(work, f"{tag}_out")
        reset_counts()
        t0 = time.perf_counter()
        run = run_main(cfg, manifest, files, out_dir, "--eval", device=device,
                       options=() if dtype == "bfloat16" else ("compute_dtype=float32",))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(out_dir, "eval_stats.json")) as f:
            stats = json.load(f)
        want = eval_launches(n_batches, dtype == "bfloat16")
        if counts != want:
            raise AssertionError(f"{tag}: kernel launches {counts}, expected {want}")
        if set(stats) != set(STAT_KEYS) or not all(map(math.isfinite, stats.values())):
            raise AssertionError(f"{tag}: eval_stats.json {stats}")
        params = dict(run["model"].named_parameters())
        t0 = time.perf_counter()
        run["run_eval"](params)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        runs[dtype] = dict(stats=stats, counts=counts, first_pass_s=first_s, pass_s=pass_s,
                           images_per_s=n_images / pass_s)
        note = ""
        if dtype == "bfloat16":   # the default's batch profiled
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    t0 = time.perf_counter()
                    run["run_eval"](params, max_steps=1)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    prof.step()
            _, groups, launches = device_time_by_group(prof)
            busy = sum(groups.values())
            runs[dtype].update(batch_wall_ms=wall_ms, batch_busy_ms=busy,
                               batch_busy_share=busy / wall_ms, groups_ms=groups)
            note = (f"; one batch {wall_ms:.1f} ms wall (profiler on), device busy {busy:.1f} ms "
                    f"({busy / wall_ms:.0%}); by group ms "
                    f"{ {k: round(v, 2) for k, v in groups.items() if v} }, launches "
                    f"{ {k: n for k, n in launches.items() if n} }")
            if busy <= 0:
                raise AssertionError(f"{tag}: the profiler recorded no device time")
        log(tag, f"main --eval on {n_images} images (B=4, {n_batches} batches, {dtype}): "
                 f"{first_s:.1f} s with set-up; stats {stats}; launches "
                 f"{ {k: v for k, v in counts.items() if v} }; a second pass {pass_s:.3f} s, "
                 f"{n_images / pass_s:.2f} images/s" + note)
        del run, params
    return runs


def pseudo_ground_truth(results, image_ids, contiguous_to_catid,
                        per_image: int = PSEUDO_GT_PER_IMAGE) -> dict:
    """{image id: [(category id, [x, y, w, h])]}: the per_image x B
    highest-scoring of a batch's detections (PostProcess results, after its
    NMS), as write_coco_val's annotations."""
    import numpy as np

    scores = np.sort(np.concatenate([r["scores"] for r in results]))
    if len(scores) < per_image * len(results):
        raise AssertionError(f"{len(scores)} detections after NMS for a pseudo ground truth of "
                             f"{per_image * len(results)}")
    cut = scores[-per_image * len(results)]
    return {img_id: [(contiguous_to_catid[int(c)],
                      [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])])
                     for c, b, sc in zip(r["labels"], r["boxes"], r["scores"]) if sc >= cut]
            for img_id, r in zip(image_ids, results)}


def eval_detections(model, batch, post, dtype) -> tuple:
    """One eval batch through make_eval_step + PostProcess on the model's
    device: ((logits, boxes, image shape) on the host, per-image results)."""
    from open_groundingdino_tpu_torch.parallel.train_state import make_eval_step

    out = make_eval_step(model, compute_dtype=dtype)(batch)
    host = (out["pred_logits"].float().cpu().numpy(), out["pred_boxes"].float().cpu().numpy(),
            tuple(batch["images"].shape))
    return host, post(out, batch["orig_sizes"])


def coco_ap(index, batch, results, contiguous_to_catid) -> float:
    from open_groundingdino_tpu_torch.eval.coco_eval import CocoBboxEvaluator

    evaluator = CocoBboxEvaluator(index)
    evaluator.update({
        img_id: {"scores": r["scores"], "boxes": r["boxes"],
                 "labels": [contiguous_to_catid[int(c)] for c in r["labels"]]}
        for img_id, r in zip(batch["image_ids"].tolist(), results)})
    evaluator.accumulate()
    return evaluator.summarize()["AP"]


def start_eval_parity(cfg: str, work: str, files, cpu_jobs) -> dict:
    """Phase 22 (b)'s operands and its CPU half, started on `cpu_jobs`: one
    B = 4 eval batch (EVAL_PARITY_IMAGES, the 800x1216 bucket), the
    checkpoint's model on the CPU, and the future of its f32 eval forward +
    PostProcess (plain versions of the kernels)."""
    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.coco import CocoDetection
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import EvalTransform
    from open_groundingdino_tpu_torch.inference import load_reference_state_dict
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
    from open_groundingdino_tpu_torch.models.postprocess import PostProcess

    _, ckpt, vocab = files
    args = SLConfig.fromfile(cfg)
    write_odvg(work)
    with open(write_coco_val(work, EVAL_PARITY_IMAGES, name="parity")) as f:
        anno = json.load(f)["val"][0]["anno"]
    ds = CocoDetection(os.path.join(work, "odvg"), anno,
                       transform=EvalTransform(args.eval_shortest_edge, args.eval_max_size))
    tokenizer = build_tokenizer(vocab)
    batch = Collator(tokenizer, args.image_buckets, int(args.max_text_len), int(args.max_gt_boxes),
                     u8_images=True)([ds[i] for i in range(len(ds))])
    if tuple(batch["images"].shape[1:3]) != BUCKET:
        raise AssertionError(f"eval parity batch landed in {batch['images'].shape}")
    post = PostProcess(tokenizer, ds.cat_list, num_select=PSEUDO_GT_NUM_SELECT,
                       max_text_len=int(args.max_text_len), nms_iou_threshold=PSEUDO_GT_NMS)
    cpu_model = build_groundingdino(args, device="cpu")
    load_reference_state_dict(cpu_model, ckpt)

    def cpu_half():
        t0 = time.perf_counter()
        out, res = eval_detections(cpu_model, batch, post, None)
        return out, res, time.perf_counter() - t0

    return dict(ds=ds, batch=batch, post=post, model=cpu_model, work=work,
                cpu=cpu_jobs.submit(cpu_half))


def check_eval_parity(ref: dict, device: str = "cuda") -> dict:
    """Phase 22 (b): the batch of start_eval_parity (`ref`) through
    make_eval_step + PostProcess in f32 on the card, against its CPU half:
    pred_logits / pred_boxes flip-aware with phase 6's limits; the CPU's
    detections, after NMS, give a pseudo ground truth (PSEUDO_GT_PER_IMAGE
    an image on average) on which the CPU scores AP 1.0, the card within
    EVAL_AP_TOL of it, and the card with K1's output negated more than
    EVAL_FAULT_DROP lower; the bf16 eval's AP is recorded.  Returns the AP
    values and the manifest of the pseudo ground truth's val split."""
    import copy

    import torch

    from open_groundingdino_tpu_torch.data.coco import CocoIndex
    from open_groundingdino_tpu_torch.ops import msda

    ds, batch, post, work = ref["ds"], ref["batch"], ref["post"], ref["work"]
    t0 = time.perf_counter()
    cpu_out, cpu_res, cpu_s = ref["cpu"].result()
    waited = time.perf_counter() - t0
    card = copy.deepcopy(ref.pop("model")).to(device)
    card_out, card_res = eval_detections(card, batch, post, None)
    compare_forward(card_out, cpu_out, "eval-parity",
                    f"B={len(EVAL_PARITY_IMAGES)} valid {batch['image_sizes'].tolist()}, f32; "
                    f"CPU {cpu_s:.1f} s on its own thread, {waited:.1f} s waited for it here")

    pseudo = pseudo_ground_truth(cpu_res, batch["image_ids"].tolist(), ds.contiguous_to_catid)
    n_gt = sum(map(len, pseudo.values()))
    manifest = write_coco_val(work, EVAL_PARITY_IMAGES, annotations=pseudo, name="pseudo_gt")
    with open(manifest) as f:
        index = CocoIndex(json.load(f)["val"][0]["anno"])
    ap = {"cpu_f32": coco_ap(index, batch, cpu_res, ds.contiguous_to_catid),
          "card_f32": coco_ap(index, batch, card_res, ds.contiguous_to_catid)}
    fwd = msda._msda_fwd_cuda
    msda._msda_fwd_cuda = negated_output(fwd)
    try:
        _, fault_res = eval_detections(card, batch, post, None)
    finally:
        msda._msda_fwd_cuda = fwd
    ap["card_f32_k1_negated"] = coco_ap(index, batch, fault_res, ds.contiguous_to_catid)
    _, bf16_res = eval_detections(card, batch, post, torch.bfloat16)
    ap["card_bf16"] = coco_ap(index, batch, bf16_res, ds.contiguous_to_catid)
    log("eval-parity", f"pseudo ground truth: the CPU's top {n_gt} detections of the batch "
                       f"after NMS {PSEUDO_GT_NMS} (by image {[len(v) for v in pseudo.values()]} "
                       f"of {[len(r['scores']) for r in cpu_res]}); "
                       f"AP {ap} (the CPU's must be 1.0, the card's f32 within {EVAL_AP_TOL}, "
                       f"with K1 negated more than {EVAL_FAULT_DROP} lower; bf16 a record)")
    if not ap["cpu_f32"] == 1.0:
        raise AssertionError(f"the CPU's AP on its own pseudo ground truth is {ap['cpu_f32']}")
    if not abs(ap["card_f32"] - ap["cpu_f32"]) <= EVAL_AP_TOL:
        raise AssertionError(f"the card's f32 eval AP {ap['card_f32']} is off the CPU's")
    if not ap["card_f32"] - ap["card_f32_k1_negated"] > EVAL_FAULT_DROP:
        raise AssertionError(f"eval parity passes with K1's output negated: {ap}")
    del card
    return {"ap": ap, "manifest": manifest}


def read_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def check_resume(cfg: str, work: str, files, manifest: str, device: str = "cuda") -> dict:
    """Phase 23: main at B = 4, bf16, one step an epoch, use_ema, on the
    pseudo ground truth's val split (its NMS and num_select in the
    postprocessor), a checkpoint each epoch: 2 epochs continuously; main for
    2 epochs on a directory that holds the continuous run's
    checkpoint_0.pth, whose epoch-1 loss must be the continuous run's within
    RESUME_LOSS_RTOL; and 1 epoch then 2 in another directory, which resumes
    from its own checkpoint_0.pth: the state it restores equals what was
    saved, bit for bit, best/ and best_ema/ exist, every log.txt line has
    the JAX package's keys, and load_model on its checkpoint_1.pth answers
    a request."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference
    from open_groundingdino_tpu_torch.parallel.train_state import TrainState
    from open_groundingdino_tpu_torch.utils import checkpoint as ckpt

    def main_run(out_dir, epochs):
        t0 = time.perf_counter()
        run = run_main(cfg, manifest, files, out_dir, "--max_steps", "1", device=device,
                       options=(f"epochs={epochs}", "use_ema=True", "save_checkpoint_interval=1",
                                f"nms_iou_threshold={PSEUDO_GT_NMS}",
                                f"num_select={PSEUDO_GT_NUM_SELECT}"))
        torch.cuda.synchronize()
        return run, time.perf_counter() - t0

    cont_dir, same_dir, res_dir = (os.path.join(work, f"resume_{d}")
                                   for d in ("cont", "same", "split"))
    for d in (cont_dir, same_dir, res_dir):
        shutil.rmtree(d, ignore_errors=True)
    cont, cont_s = main_run(cont_dir, 2)
    cont_log = read_log(cont_dir)
    del cont
    os.makedirs(same_dir)
    shutil.copy(os.path.join(cont_dir, "checkpoint_0.pth"), same_dir)
    shutil.rmtree(cont_dir)   # checkpoints of ~2.6 GB each
    same, _ = main_run(same_dir, 2)
    same_log = read_log(same_dir)
    del same
    gc.collect()
    shutil.rmtree(same_dir)
    first, first_s = main_run(res_dir, 1)
    del first
    gc.collect()
    saved = ckpt.restore_checkpoint(os.path.join(res_dir, "checkpoint_0.pth"))

    restored = []
    load = TrainState.load_state_dict

    def spy(self, state):
        load(self, state)
        restored.append(self.state_dict())

    TrainState.load_state_dict = spy
    try:
        resumed, resumed_s = main_run(res_dir, 2)
    finally:
        TrainState.load_state_dict = load
    del resumed
    gc.collect()
    res_log = read_log(res_dir)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k])
                                                                        for k in a)
        if isinstance(a, torch.Tensor):
            return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
        return a == b

    back = restored[0] if restored else None
    exact = {k: back is not None and same(back[k], saved[k])
             for k in ("model", "optimizer", "ema", "step", "nonfinite_count", "generator")}
    loss_c, loss_s = cont_log[1]["loss"], same_log[0]["loss"]
    loss_rel = abs(loss_s - loss_c) / abs(loss_c)
    loss_r = [r for r in res_log if r["epoch"] == 1][0]["loss"]
    split_rel = abs(loss_r - loss_c) / abs(loss_c)
    best = {d: os.path.exists(os.path.join(res_dir, d, "checkpoint_0.pth"))
            for d in ("best", "best_ema")}
    missing = [sorted(set(LOG_KEYS) - set(r)) for r in cont_log + res_log]
    im = inference.load_model(cfg, os.path.join(res_dir, "checkpoint_1.pth"), files[2],
                              device=device)
    image = synthetic_image(800, 1200, 7)
    boxes, scores, phrases = inference.predict(im, image, CAPTIONS[1])
    logits, pred_boxes, _ = forward_outputs(im, image, CAPTIONS[1])
    del im
    size = os.path.getsize(os.path.join(res_dir, "checkpoint_1.pth"))
    resumed_from = [r["epoch"] for r in res_log]
    log("resume", f"continuous 2 epochs {cont_s:.1f} s, 1 epoch {first_s:.1f} s, resumed to 2 "
                  f"{resumed_s:.1f} s (B=4, bf16, 1 step an epoch, use_ema; a checkpoint "
                  f"{size / 2**30:.2f} GiB); restored equal to the saved bit for bit {exact}; "
                  f"epoch-1 loss continuous {loss_c:.6f}, resumed from its checkpoint_0 "
                  f"{loss_s:.6f} (rel {loss_rel:.2e}, limit {RESUME_LOSS_RTOL}; epochs "
                  f"{[r['epoch'] for r in same_log]}), split run {loss_r:.6f} (rel "
                  f"{split_rel:.2e}, a record); APs by epoch continuous "
                  f"{[(r['AP'], r['ema_AP']) for r in cont_log]}, resumed "
                  f"{[(r['AP'], r['ema_AP']) for r in res_log]} (model, EMA); best dirs {best}; "
                  f"log lines missing keys {missing}; load_model(checkpoint_1.pth) answered "
                  f"{len(boxes)} boxes over the 0.35 threshold (largest probability "
                  f"{float(np.nanmax(1 / (1 + np.exp(-logits.astype(np.float64))))):.3e})")
    if not all(exact.values()):
        raise AssertionError(f"the resumed run restored another state than was saved: {exact}")
    if not (loss_rel <= RESUME_LOSS_RTOL and [r["epoch"] for r in same_log] == [1]):
        raise AssertionError(f"the run resumed from the continuous run's checkpoint_0 has "
                             f"epoch-1 loss {loss_s} against {loss_c}, epochs {same_log}")
    if not all(best.values()) or any(missing) or len(cont_log) != 2 or resumed_from != [0, 1]:
        raise AssertionError(f"best dirs {best}, log keys missing {missing}, log lines "
                             f"{len(cont_log)} / {len(res_log)}")
    if not (len(boxes) == len(scores) == len(phrases) and np.isfinite(boxes).all()
            and np.isfinite(pred_boxes).all() and not np.isnan(logits).any()):
        raise AssertionError("load_model on checkpoint_1.pth gave no well-formed answer")
    return dict(exact=exact, loss_rel=loss_rel, split_loss_rel=split_rel, cont_log=cont_log,
                res_log=res_log, checkpoint_bytes=size, seconds=(cont_s, first_s, resumed_s))


# ---------------------------------------------------------------- bf16 K5, K8 (phases 26, 27)
def check_bf16_banded_corner(device) -> dict:
    """Phase 26: the bf16 entries of K5 (on banded_operands) and K8 (on the
    corner taps) against their bf16 plain versions (the plain versions on
    the same bf16 value, summed in f32 and rounded to bf16 once) on phase
    16's operands (its generator: phase 3's B = 1 and phase 8's B = 4
    encoder and decoder shapes, each image with its own valid region), and
    the ops that launch them against K1 bf16 on the same reference
    operands, all within BF16_FWD_RTOL of each output's largest |reference|;
    each negated output must fail its check.  Timed by CUDA events and by
    torch.profiler's device time, against the bound at bf16 value rows;
    ptxas's registers and spills of the two bf16 instances (none may
    spill)."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    bf = torch.bfloat16
    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 16)   # phase 16's draws
    rows = {}
    for batch, valid in (("B=1", (BUCKET,)), ("B=4", BATCH_VALID)):
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            value = value.to(bf)
            k1 = msda.ms_deform_attn(value, shapes, starts, locs, attn)   # K1 bf16
            bound = msda_bound_ms(value, shapes, locs, attn)
            _, locs_t, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
            ranges = mb.band_ranges(locs_t, shapes, px.shape[-1] // sw.QBLOCK,
                                    mb.level_bands(shapes, mb.BAND))
            idx, w = corner_operands(value, shapes, locs, attn)
            for kname, kernel, plain, op in (
                    ("K5", lambda: mb.banded_fwd(value, shapes, px, py, wa),
                     lambda: mb.banded_fwd_plain(value, shapes, px, py, wa, ranges).to(bf),
                     lambda: mb.ms_deform_attn_banded(value, shapes, starts, locs, attn)),
                    ("K8", lambda: sw.sweep_fwd_corner(value, shapes, idx, w),
                     lambda: sw.sweep_fwd_corner_plain(value, idx, w).to(bf),
                     lambda: sw.ms_deform_attn_sweep(value, shapes, starts, locs, attn,
                                                     fwd="corner"))):
                out, ref, out_op = kernel(), plain(), op()
                err, rel = rel_err(out, ref)
                op_err, op_rel = rel_err(out_op, k1)
                planted = rel_err(-out, ref)[1]
                if out.dtype != bf or out_op.dtype != bf:
                    raise AssertionError(f"{kname} bf16 returned {out.dtype} / {out_op.dtype}")
                del out, ref, out_op
                rows[kname, batch, name] = dict(
                    B=len(valid), Q=q, max_abs_err=err, k1_max_abs_err=op_err,
                    rel_errs={"out": rel, "op_vs_k1": op_rel}, planted_rel_err=planted,
                    ms=event_ms(kernel, 10),
                    device_ms=kernel_device_ms(kernel, 10, SWEEP_BF16_NAMES[kname]),
                    plain_ms=event_ms(plain, 2), bound_ms=bound[0], bound_by=bound[1])
                r = rows[kname, batch, name]
                log("bf16-banded-corner",
                    f"{kname} bf16 {batch} {name} Q={q}: error of max|ref| {rel:.3e}, the op "
                    f"against K1 bf16 {op_rel:.3e} (limit {BF16_FWD_RTOL}); negated output "
                    f"{planted:.3e}; kernel {r['ms']:.4f} ms (device time {r['device_ms']:.4f} "
                    f"ms), plain {r['plain_ms']:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
                if not (rel <= BF16_FWD_RTOL and op_rel <= BF16_FWD_RTOL):
                    raise AssertionError(f"{kname} bf16 {batch} {name}: {r}")
                if planted <= BF16_FWD_RTOL:
                    raise AssertionError(f"{kname} bf16 {batch} {name}: a negated output passes")
    sass = {}
    for kname, lib, kernel in (("K5", "msda_banded_fwd", "banded_fwd_kernel"),
                               ("K8", "msda_corner_fwd", "corner_fwd_kernel")):
        ptxas = ptxas_kernels(lib, [(f"{kernel}{BF16_MANGLED}", f"{kernel}<bf16>")])
        sass[kname] = {"ptxas": ptxas[f"{kernel}<bf16>"]}
        log("sass", f"lib{lib}.so {kname} bf16 ({kernel}<__nv_bfloat16>): {sass[kname]}")
        if sass[kname]["ptxas"]["spill_bytes"]:
            raise AssertionError(f"{kname} bf16 spills under its launch bounds: {sass[kname]}")
    return {"rows": rows, "sass": sass}


def train_bf16_banded(cfg, work, train_files, harness, banded_f32_card,
                      gather_bf16_card) -> dict:
    """Phase 27: main --options msda_kernel=banded_point in the config's
    default bf16 at B = 4, full width and depth, one epoch of 2 steps with
    its eval of the 8 images as a COCO val split (12 K5 + 12 K3 + 6 K2 +
    6 K4 bf16 launches a step, 12 K5 + 6 K2 bf16 an eval batch, no f32
    entry) and a profiled step; then phase 18's B = 1 step in bf16 through
    banded_point against phase 18's f32 banded_point step on the card (loss
    within BF16_LOSS_RTOL, each MSDA-fed gradient within BF16_LEAF_RTOL),
    its distance from phase 21's bf16 gather step recorded; with K5 bf16's
    output negated it must fail."""
    from open_groundingdino_tpu_torch.ops import msda_banded as mb

    run = train(cfg, work, train_files, "cuda", {"msda_kernel": "banded_point"},
                epochs=1, tag="bf16-banded-train", compute_dtype=None, val=True)
    if run["run"]["train_step"].compute_dtype != "bfloat16":
        raise AssertionError("main's default compute_dtype is not bf16")
    run["profile"] = profile_train_step(run.pop("run"), tag="bf16-banded-train-profile")

    step, gaps, _ = harness

    def within(gap):
        return gap[0] < BF16_LOSS_RTOL and all(v < BF16_LEAF_RTOL for v in gap[2].values())

    banded = {"kernel": "banded_point"}
    card = step("cuda", msda=banded, compute_dtype="bfloat16")
    gap = gaps(card, banded_f32_card, MSDA_FED)
    to_gather = gaps(card, gather_bf16_card, MSDA_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("bf16-banded-parity",
        f"B=1 {BUCKET} bucket, banded_point: loss bf16 {card['loss']:.6f} f32 "
        f"{banded_f32_card['loss']:.6f} (rel {loss_rel:.2e}, limit {BF16_LOSS_RTOL}); grad-norm "
        f"rel by module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; {len(leaf_rel)} "
        f"MSDA-fed leaves ||dg||/||g|| max {max(leaf_rel.values()):.2e} (limit "
        f"{BF16_LEAF_RTOL}), worst {[(n, f'{v:.2e}') for n, v in worst]}; against phase 21's "
        f"bf16 gather step: loss rel {to_gather[0]:.2e}, leaves max "
        f"{max(to_gather[2].values()):.2e}; step s {card['seconds']:.1f}")
    if not within(gap):
        raise AssertionError("the bf16 banded_point step disagrees with the f32 banded_point step")
    planted = planted_faults(step, gaps, within, banded_f32_card, MSDA_FED,
                             (("K5 bf16 output negated", mb, "_banded_fwd_cuda", None),),
                             "bf16-banded-parity", msda=banded, compute_dtype="bfloat16")
    run["parity"] = dict(loss_rel=loss_rel, leaf_rel_max=max(leaf_rel.values()),
                         vs_gather_bf16=dict(loss_rel=to_gather[0],
                                             leaf_rel_max=max(to_gather[2].values())),
                         planted=planted)
    return run


# ---------------------------------------------------------------- other backbones (phases 28, 29)
# the JAX package's other published geometries at full width: (tag, config of
# the port, config keys set on top); the dilated ResNet-50 shares ResNet-50's
# checkpoint
BACKBONES = (("swinb", "cfg_swinb.py", {}), ("swinl", "cfg_swinl.py", {}),
             ("resnet50", "cfg_resnet50.py", {}),
             ("resnet50-dilated", "cfg_resnet50.py", {"dilation": True}))
CLASSES = list(CATEGORIES[:4])   # predict_with_classes' caption: "cat. dog. person. bicycle"


def backbone_files(work: str, vocab: str) -> dict:
    """{tag: (config, checkpoint, vocab)} for BACKBONES: seeded checkpoints
    with random biases (the Swin-L and ResNet-50 ones also train, phase 29)."""
    cfg_dir = os.path.join(REPO, "open_groundingdino_tpu_torch", "config")
    files, ckpts = {}, {}
    for tag, cfg_name, keys in BACKBONES:
        cfg = os.path.join(cfg_dir, cfg_name)
        if cfg_name not in ckpts:
            t0 = time.perf_counter()
            ckpts[cfg_name] = os.path.join(work, f"ckpt_{tag}.pth")
            write_checkpoint(cfg, ckpts[cfg_name], random_biases=True)
            log("checkpoint", f"{cfg_name}: {os.path.getsize(ckpts[cfg_name]) / 2**20:.0f} MiB in "
                              f"{time.perf_counter() - t0:.1f} s")
        files[tag] = (msda_config(cfg, work, tag, **keys) if keys else cfg, ckpts[cfg_name], vocab)
    return files


class KernelOperands:
    """Within the block, keeps copies of the operands of the first K1 launch
    at an encoder (Q = L: `msda["encoder"]`), the first at a decoder
    (`msda["decoder"]`) and the first K2 launch (`fusion`), in the dtype the
    model gives them; the launches and counts are the kernels' own.  The
    copies are detached and made outside inference mode, so that autograd of
    the plain versions can take them."""

    def __init__(self):
        self.msda, self.fusion = {}, None

    def __enter__(self):
        import torch

        from open_groundingdino_tpu_torch.ops import fusion, msda

        self.modules = msda, fusion
        self.kernels = msda._msda_fwd_cuda, fusion._fusion_fwd_cuda

        def keep(args):
            with torch.inference_mode(False):
                return tuple(t.detach().clone() if torch.is_tensor(t) else t for t in args)

        def msda_spy(*args):
            value, locs = args[0], args[3]
            name = "encoder" if locs.shape[1] == value.shape[1] else "decoder"
            if name not in self.msda:
                self.msda[name] = keep(args)
            return self.kernels[0](*args)

        def fusion_spy(*args):
            if self.fusion is None:
                self.fusion = keep(args)
            return self.kernels[1](*args)

        msda._msda_fwd_cuda, fusion._fusion_fwd_cuda = msda_spy, fusion_spy
        return self

    def __exit__(self, *exc):
        self.modules[0]._msda_fwd_cuda, self.modules[1]._fusion_fwd_cuda = self.kernels


# the thread's active TwoStageSelection: the CPU references run on a thread
# of their own beside the card's phases, each with its own selection
_SELECTION = threading.local()


class TwoStageSelection:
    """Within the block, the model's two-stage query selection
    (models/transformer.py two_stage_select: the top num_queries encoder
    tokens by score, in score order) is recorded (`order`, `scores`), or,
    given an `order`, takes that order's tokens instead, on this thread
    only (one hook, installed once, hands each thread's calls to that
    thread's selection).  At random weights two tokens' scores can tie to
    within the card's and the CPU's rounding and swap places in the order
    (or at the cut).  Each query index has its own learned content embedding
    (tgt_embed), so a swap changes both queries, and the decoder's
    self-attention spreads it over every query: the forwards are compared on
    one selection."""

    def __init__(self, order=None):
        self.order, self.scores = order, None

    def __enter__(self):
        from open_groundingdino_tpu_torch.models import transformer

        if not hasattr(transformer.two_stage_select, "original"):
            original = transformer.two_stage_select

            def hook(*args):
                active = getattr(_SELECTION, "active", None)
                return active.select(*args) if active is not None else original(*args)

            hook.original = original
            transformer.two_stage_select = hook
        self.original = transformer.two_stage_select.original
        self.outer = getattr(_SELECTION, "active", None)
        _SELECTION.active = self
        return self

    def select(self, output_memory, output_proposals, enc_delta, enc_logits, num_queries):
        import torch

        if self.order is not None:   # rank the given order first, in that order
            rank = torch.full(enc_logits.shape[:2], float(-enc_logits.shape[1]),
                              device=enc_logits.device)
            order = self.order.to(enc_logits.device)
            rank.scatter_(1, order, -torch.arange(order.shape[1], device=rank.device,
                                                  dtype=rank.dtype).expand_as(order))
            enc_logits = rank[..., None]
        else:
            self.scores = enc_logits.max(-1).values.float().cpu()
            self.order = torch.sort(self.scores, dim=1, descending=True,
                                    stable=True).indices[:, :num_queries]
        return self.original(output_memory, output_proposals, enc_delta, enc_logits,
                             num_queries)

    def __exit__(self, *exc):
        _SELECTION.active = self.outer

    def compare(self, other) -> dict:
        """How many query indices hold another token in the other selection,
        how many of this selection's tokens it misses, and this side's score
        margin between its last kept token and the best token it left out."""
        queries = self.order.shape[1]
        reordered = int((self.order != other.order).sum())
        swapped = sum(len(set(a.tolist()) - set(b.tolist()))
                      for a, b in zip(self.order, other.order))
        ranked = self.scores.sort(dim=1, descending=True).values
        margin = float((ranked[:, queries - 1] - ranked[:, queries]).min())
        return dict(queries=queries, reordered=reordered, swapped=swapped, margin=margin)


def check_msda_on(operands, tag: str) -> dict:
    """K1 against its plain version on f32 operands a model run gave it, and
    K3 against autograd of the plain version on the same operands with a
    seeded upstream gradient (K1_TOL; K3_RTOL of each gradient's largest
    |reference|); then both bf16 entries on the value and gradient rounded to
    bf16 (phase 20's limits).  K3's launch plans for these shapes are logged:
    the f32 entry's and the bf16 entry's shared-memory levels differ."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda

    value, shapes, starts, locs, attn = operands
    B, Q, H = locs.shape[:3]
    g = torch.Generator(device=value.device).manual_seed(SEED + 28)
    grad_out = torch.randn(B, Q, H * value.shape[3], generator=g, device=value.device)
    res = dict(B=B, L=Q, shapes=[list(hw) for hw in shapes])
    for dtype, fwd_tol, bwd_tols, budget in (
            (torch.float32, None, (K3_RTOL,) * 3, msda.BWD_SMEM_BUDGET),
            (torch.bfloat16, BF16_FWD_RTOL, (BF16_K3_GV_RTOL, BF16_K3_RTOL, BF16_K3_RTOL),
             msda.BWD_SMEM_BUDGET_BF16)):
        v, go = value.to(dtype), grad_out.to(dtype)
        k1_abs, k1_rel = rel_err(msda.ms_deform_attn(v, shapes, starts, locs, attn),
                                 msda.ms_deform_attn_plain(v, shapes, starts, locs, attn))
        args = (v, shapes, starts, locs, attn, go)
        errs = {key: rel_err(a, b)[1] for key, a, b in zip(
            ("grad_value", "grad_locs", "grad_attn"), msda.ms_deform_attn_bwd(*args),
            msda.ms_deform_attn_bwd_plain(*args))}
        plan = msda.msda_bwd_plan(shapes, B, Q, H, budget)._asdict()
        name = "f32" if dtype == torch.float32 else "bf16"
        k1_ok = k1_abs <= K1_TOL if fwd_tol is None else k1_rel <= fwd_tol
        log(tag, f"{name} K1 and K3 on the model's encoder operands: B={B} Q=L={Q} shapes "
                 f"{list(shapes)}; K1 max|kernel-plain| {k1_abs:.3e} ({k1_rel:.2e} of max|ref|; "
                 f"limit {K1_TOL if fwd_tol is None else f'{fwd_tol} of max|ref|'}); K3 "
                 f"max|kernel-plain| / max|ref| { {k: f'{e:.2e}' for k, e in errs.items()} } "
                 f"(limits {bwd_tols}); K3 plan {plan}")
        if not k1_ok or not all(e <= t for e, t in zip(errs.values(), bwd_tols)):
            raise AssertionError(f"{tag}: {name} K1 or K3 disagrees with its plain version at "
                                 f"{list(shapes)}")
        res[name] = dict(k1_max_abs_err=k1_abs, k1_rel_err=k1_rel, k3_rel_errs=errs, k3_plan=plan)
    return res


def backbone_reference(files) -> tuple:
    """Phase 28's CPU half for one model: the checkpoint on the CPU, one
    forward of the first image and caption with its two-stage selection
    recorded -> (outputs, TwoStageSelection, seconds)."""
    from open_groundingdino_tpu_torch import inference

    t0 = time.perf_counter()
    cpu_im = inference.load_model(*files, device="cpu")
    h, w = IMAGE_SIZES[0]
    with TwoStageSelection() as cpu_sel:
        cpu = forward_outputs(cpu_im, synthetic_image(h, w, 0), CAPTIONS[0])
    return cpu, cpu_sel, time.perf_counter() - t0


def serve_backbone(files, tag: str, plant_k1: bool = False, device: str = "cuda",
                   annotate_in: str = None, cpu_ref=None) -> dict:
    """Phase 28 for one model: Model(...) on the card, a warm-up and one
    request on each of the three IMAGE_SIZES through predict_with_classes
    (12 K1 + 6 K2 f32 launches a request, no other), median latency and peak
    memory; one forward against the CPU's: as served with fewer than 10% of
    the queries flipped, and on the CPU's two-stage selection flip-aware with
    phase 6's limits; with `plant_k1` the card's forward with K1's output
    negated must fail that comparison.  A dilated ResNet's K1 and K3 are held
    against their plain versions on its encoder operands.  With
    `annotate_in`, annotate_request on the model into that directory.
    `cpu_ref`: the future of backbone_reference(files), run on a thread
    beside the earlier phases (None: run here)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference
    from open_groundingdino_tpu_torch.ops import msda

    cfg, ckpt, vocab = files
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = inference.Model(cfg, ckpt, vocab, device=device)
    load_s = time.perf_counter() - t0
    pil = [synthetic_image(h, w, i) for i, (h, w) in enumerate(IMAGE_SIZES)]
    images = [np.asarray(im) for im in pil]
    reset_counts()
    with KernelOperands() as encoder:
        model.predict_with_classes(images[0], CLASSES)              # warm-up
    torch.cuda.synchronize()
    lat, found = [], []
    for img in images:
        t0 = time.perf_counter()
        det = model.predict_with_classes(img, CLASSES)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        ids = [c for c in det.class_id.tolist() if c is not None]
        if not (len(det.xyxy) == len(det.confidence) == len(det.class_id)
                and np.isfinite(det.xyxy).all() and (det.confidence > 0.35).all()
                and all(0 <= c < len(CLASSES) for c in ids)):
            raise AssertionError(f"{tag}: malformed Detections for an image of {img.shape}")
        found.append(len(det))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = serving_launches(model.im.args, len(images) + 1)
    median = sorted(lat)[len(lat) // 2]
    log(tag, f"Model on {device} in {load_s:.1f} s; predict_with_classes({CLASSES}) on "
             f"{[im.shape[:2] for im in images]} after 1 warm-up: latency ms "
             f"{[round(t * 1e3, 1) for t in lat]} (median {median * 1e3:.1f}), detections "
             f"{found}; max_memory_allocated {peak / 2**30:.2f} GiB; launches over "
             f"{len(images) + 1} requests { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"{tag}: kernel launches {counts}, expected {want}")
    res = dict(load_s=load_s, latency_s=lat, median_s=median, peak_bytes=peak, counts=counts,
               detections=found)

    t0 = time.perf_counter()
    cpu, cpu_sel, cpu_s = cpu_ref.result() if cpu_ref is not None else backbone_reference(files)
    waited = time.perf_counter() - t0
    with TwoStageSelection() as card_sel:
        free = forward_outputs(model.im, pil[0], CAPTIONS[0])
    res["selection"] = cpu_sel.compare(card_sel)
    flip, lg_err, bx_err, _ = forward_gap(free, cpu)
    sel = res["selection"]
    log(f"{tag}-forward", f"as served: {sel['reordered']} of {sel['queries']} queries took "
                          f"another encoder token than on the CPU, {sel['swapped']} tokens of "
                          f"the top {sel['queries']} differ (score margin {sel['margin']:.2e} "
                          f"at the cut); "
                          f"flipped {flip:.1%}, bulk max|dlogit| {lg_err:.3e}, bulk max|dbox| "
                          f"{bx_err:.3e}")
    if not flip < 0.10:
        raise AssertionError(f"{tag}: {flip:.1%} of the queries flipped")
    res["forward_as_served"] = (flip, lg_err, bx_err)
    # the numerical check: the same forward with the CPU's two-stage selection
    with TwoStageSelection(cpu_sel.order):
        card = forward_outputs(model.im, pil[0], CAPTIONS[0])
    res["forward"] = compare_forward(card, cpu, f"{tag}-forward",
                                     f"with the CPU's two-stage selection; CPU forward "
                                     f"{cpu_s:.1f} s on its own thread, {waited:.1f} s waited "
                                     f"for it here")
    if plant_k1:
        fwd = msda._msda_fwd_cuda
        msda._msda_fwd_cuda = negated_output(fwd)
        try:
            with TwoStageSelection(cpu_sel.order):
                planted = forward_gap(forward_outputs(model.im, pil[0], CAPTIONS[0]), cpu)
        finally:
            msda._msda_fwd_cuda = fwd
        log(f"{tag}-forward", f"planted fault, K1 output negated: flipped {planted[0]:.1%}, bulk "
                              f"max|dlogit| {planted[1]:.3e}, bulk max|dbox| {planted[2]:.3e}")
        if planted[3]:
            raise AssertionError(f"{tag}: the forward comparison passes with K1's output negated")
        res["planted_k1"] = planted[:3]
    if annotate_in:
        res["annotated"] = annotate_request(model.im, annotate_in)
    shapes = encoder.msda["encoder"][1]
    res["levels"] = [list(hw) for hw in shapes]
    if model.im.args.get("dilation", False):
        if shapes[1] != shapes[2]:
            raise AssertionError(f"{tag}: a dilated stage 3 should keep stage 2's map: {shapes}")
        res["msda_check"] = check_msda_on(encoder.msda["encoder"], f"{tag}-msda")
    return res


def annotate_request(im, work: str) -> str:
    """annotate() on one request's predict output on `im` (an
    InferenceModel): writes the drawn image under `work` and returns its
    path."""
    import numpy as np
    from PIL import Image

    from open_groundingdino_tpu_torch import inference

    image = synthetic_image(*IMAGE_SIZES[1], 1)
    boxes, scores, phrases = inference.predict(im, image, CAPTIONS[1])
    drawn = inference.annotate(np.asarray(image), boxes, scores, phrases)
    path = os.path.join(work, "annotated.png")
    Image.fromarray(drawn).save(path)
    if drawn.shape != np.asarray(image).shape or (len(boxes) and np.array_equal(
            drawn, np.asarray(image))):
        raise AssertionError("annotate drew nothing")
    log("annotate", f"{len(boxes)} boxes drawn into {os.path.basename(path)} "
                    f"({os.path.getsize(path)} bytes)")
    return path


def serve_backbones(work: str, files: dict, device: str = "cuda", cpu_refs=None) -> dict:
    """Phase 28: serve_backbone for each of BACKBONES (K1 negated must fail
    Swin-B's comparison), and annotate on Swin-B's predict; `cpu_refs`: the
    futures of their CPU halves by tag."""
    return {tag: serve_backbone(files[tag], f"serve-{tag}", tag == "swinb", device,
                                annotate_in=work if tag == "swinb" else None,
                                cpu_ref=(cpu_refs or {}).get(tag))
            for tag, _, _ in BACKBONES}


def resnet_reference(files) -> tuple:
    """Phase 29 (c)'s CPU half: the parity harness on the ResNet-50 model and
    its step on the CPU with main's freeze policy, the two-stage selection
    recorded -> (harness, the CPU's run, its TwoStageSelection)."""
    from open_groundingdino_tpu_torch.models.resnet import frozen_param_keys

    harness = parity_harness(files[0], files)
    with TwoStageSelection() as selection:
        cpu = harness[0]("cpu", frozen_keys=frozen_param_keys(True))
    return harness, cpu, selection


def check_resnet_train_parity(files, device: str = "cuda", cpu_ref=None) -> dict:
    """Phase 29 (c): phase 11's step (B = 1, f32, the 800x1216 bucket) on
    the ResNet-50 model on the CPU and on the card, with main's freeze
    policy.  The card's step on the CPU's two-stage selection
    (TwoStageSelection) is held within phase 11's limits; its step on its
    own selection is logged.  After it the stem, layer1 and every FrozenBN
    buffer equal the checkpoint's bit for bit, and every other trunk
    parameter has moved.  `cpu_ref`: the future of resnet_reference(files),
    run on a thread beside the earlier phases (None: run here)."""
    import torch

    from open_groundingdino_tpu_torch.models.resnet import BODY_PREFIX, frozen_param_keys

    (step, gaps, within), cpu, selection = (cpu_ref.result() if cpu_ref is not None
                                            else resnet_reference(files))
    frozen = frozen_param_keys(True)
    free = gaps(step(device, frozen_keys=frozen), cpu, KERNEL_FED)
    log("resnet-train-parity", f"the card's step on its own two-stage selection: loss rel "
                               f"{free[0]:.2e}, grad-norm rel max {max(free[1].values()):.2e}, "
                               f"leaves max {max(free[2].values()):.2e} (not held: a query "
                               f"order swapped at a near-tie changes the matching)")
    with TwoStageSelection(selection.order):
        card = step(device, frozen_keys=frozen, snapshot=BODY_PREFIX)
    gap = gaps(card, cpu, KERNEL_FED)
    loss_rel, norm_rel, leaf_rel = gap
    before = torch.load(files[1], map_location="cpu", weights_only=True)["model"]
    after = card["snapshot"]
    # the stem, layer1, and the FrozenBN buffers (bn1-3, downsample.1) everywhere
    fixed = [k for k in after if k.startswith((BODY_PREFIX + "conv1.", BODY_PREFIX + "bn1.",
                                               BODY_PREFIX + "layer1."))
             or ".bn" in k or ".downsample.1." in k]
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    log("resnet-train-parity", f"ResNet-50, B=1 {BUCKET} bucket, f32, the CPU's two-stage "
                               f"selection: loss card {card['loss']:.6f} CPU "
                               f"{cpu['loss']:.6f} (rel {loss_rel:.2e}, limit "
                               f"{PARITY_LOSS_RTOL}); grad-norm rel by module "
                               f"{ {k: f'{v:.2e}' for k, v in norm_rel.items()} } (limit "
                               f"{PARITY_GRAD_RTOL}); {len(leaf_rel)} K3/K4-fed leaves "
                               f"||dg||/||g|| max {max(leaf_rel.values()):.2e} (limit "
                               f"{PARITY_LEAF_RTOL}); trunk tensors {len(after)}: {len(fixed)} "
                               f"frozen (stem, layer1, FrozenBN buffers), {len(moved)} moved; "
                               f"step s card {card['seconds']:.1f}, CPU {cpu['seconds']:.1f}")
    if not within(gap):
        raise AssertionError("the card's ResNet-50 training step disagrees with the CPU's")
    if set(moved) != set(after) - set(fixed):
        raise AssertionError(f"frozen trunk tensors moved or trainable ones did not: "
                             f"{sorted(set(moved) ^ (set(after) - set(fixed)))[:8]}")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()),
                frozen=len(fixed), moved=len(moved),
                own_selection=dict(loss_rel=free[0], leaf_rel_max=max(free[2].values())))


def step_without_recompute(run, device: str = "cuda") -> dict:
    """Phase 29 (b): one more step of a main run's model and state with
    use_checkpoint off, as the build sets it from use_checkpoint=False: the
    Swin blocks and the fusion blocks keep their activations (the same
    launches: with remat_save_kernels the checkpointed fusion blocks replay
    no K2 either).  On the batch the profiled step took
    (main would save another checkpoint); peak memory over the step,
    launches."""
    import dataclasses

    import torch

    model = run["state"].model
    model.backbone[0].cfg = dataclasses.replace(model.backbone[0].cfg, use_checkpoint=False)
    model.transformer.encoder.use_checkpoint = False
    batches = iter(run["loader"])
    batch = next(batches)
    batches.close()
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in run["train_step"](run["state"], batch).items()}
    seconds = time.perf_counter() - t0
    peak, counts = torch.cuda.max_memory_allocated(), read_counts()
    want = train_launches_per_step({"use_checkpoint": False},
                                   run["train_step"].compute_dtype == "bfloat16")
    log("swinl-train-no-recompute", f"1 step (B=4, {run['train_step'].compute_dtype}, "
                                    f"use_checkpoint off) in {seconds:.3f} s: loss "
                                    f"{metrics['loss']:.4f}; max_memory_allocated "
                                    f"{peak / 2**30:.2f} GiB, of it {base / 2**30:.2f} GiB "
                                    f"allocated before the step; launches "
                                    f"{ {k: v for k, v in counts.items() if v} }")
    if not math.isfinite(metrics["loss"]) or counts != want:
        raise AssertionError(f"the step without recompute: loss {metrics['loss']}, launches "
                             f"{counts}, expected {want}")
    return dict(counts=counts, peak_bytes=peak, base_bytes=base, step_seconds=seconds,
                loss=metrics["loss"])


def train_backbones(work: str, files: dict, device: str = "cuda", resnet_ref=None) -> dict:
    """Phase 29: main with cfg_swinl at B = 4 in the default bf16, 2 steps
    (12 K1 + 12 K3 + 6 K2 + 6 K4 bf16 launches a step), then one step with
    use_checkpoint off (step_without_recompute); phase
    11's f32 step on ResNet-50 against the CPU's with its frozen tensors;
    and phase 11's f32 step on the dilated ResNet-50 on the card (its
    launches exact), whose K1 and K3 are held against their plain versions
    on its encoder operands.  `resnet_ref`: the future of the ResNet-50
    step's CPU half (resnet_reference)."""
    from open_groundingdino_tpu_torch.models.resnet import frozen_param_keys

    cfg_l = files["swinl"][0]
    res = {"swinl": train(cfg_l, work, files["swinl"], device, tag="swinl-train", epochs=1,
                          compute_dtype=None)}
    main_run = res["swinl"].pop("run")
    res["swinl-no-recompute"] = step_without_recompute(main_run, device)
    del main_run
    res["resnet50-parity"] = check_resnet_train_parity(files["resnet50"], device, resnet_ref)
    step, _, _ = parity_harness(files["resnet50-dilated"][0], files["resnet50-dilated"])
    reset_counts()
    with KernelOperands() as encoder:
        run = step(device, frozen_keys=frozen_param_keys(True))
    counts = read_counts()
    log("resnet50-dilated-train", f"1 step (B=1, {BUCKET} bucket, f32) in {run['seconds']:.1f} "
                                  f"s: loss {run['loss']:.4f}; launches "
                                  f"{ {k: v for k, v in counts.items() if v} }")
    if not math.isfinite(run["loss"]) or counts != train_launches_per_step({}):
        raise AssertionError(f"the dilated step: loss {run['loss']}, launches {counts}")
    res["resnet50-dilated"] = dict(counts=counts, loss=run["loss"],
                                   msda_check=check_msda_on(encoder.msda["encoder"],
                                                            "resnet50-dilated-train-msda"))
    return res


# ---------------------------------------------------------------- PAVE (phase 30)
# the PAVE pipeline at full Swin-T width: a seeded 1080x1920 frame, a car
# box that gives 21 crops of 512x512 (each padded into the 608x928 bucket:
# levels 76x116, 38x58, 19x29, 10x15, L = 11721,
# valid 64x64 / 32x32 / 16x16 / 8x8), the damage caption, a full-width M1.1
# segmentor (RepViTConfig(): widths 64-512, depths 2/2/12/2, fpn 128)
PAVE_FRAME = (1080, 1920)
PAVE_CAR_BBOX = (200, 150, 1700, 950)
PAVE_CROPS = 21
PAVE_BUCKET = (608, 928)
PAVE_LABELS = ["dent", "scratch", "missing", "scraped", "broken"]
PAVE_CAPTION = " . ".join(PAVE_LABELS) + " ."
PAVE_BATCH = 16              # pave/batch_eval.run_batch_eval's crop batch
PAVE_SEG_INFER = (512, 1024)
PAVE_SEG_CAR_SHARE = 0.3     # the classifier bias makes this share of pixels car
# the segmentor's card logits against the CPU's, relative to the largest
# |logit|: f32 with TF32 off, cuDNN and oneDNN take each conv's sums (up to
# 3x3x512 = 4608 terms) in their own order through ~60 layers, a few 1e-6
# relative each, and the head's GroupNorms re-normalize; 1e-3 leaves room
# above that and stays far below a fault (a wrong layer moves the logits by
# their own size)
SEG_LOGIT_RTOL = 1e-3


def pave_frames():
    """Two seeded 1080x1920 frames (smooth blobs) as uint8 arrays, and each
    frame's GT boxes: a few damage boxes inside the car box."""
    import numpy as np

    frames, gts = [], []
    rng = np.random.RandomState(SEED + 30)
    for i in range(2):
        frames.append(np.asarray(synthetic_image(*PAVE_FRAME, 300 + i)))
        x0, y0, x1, y1 = PAVE_CAR_BBOX
        xy = rng.uniform((x0, y0), (x1 - 150, y1 - 150), (3 + i, 2))
        gts.append(np.concatenate([xy, xy + rng.uniform(30, 150, (3 + i, 2))], 1)
                   .astype(np.float32))
    return frames, gts


def check_segmentor(work: str, frame, device: str = "cuda") -> dict:
    """Phase 30 (a): a seeded full-width M1.1 segmentor, its classifier bias
    set so that PAVE_SEG_CAR_SHARE of the frame's pixels are car on the CPU;
    the logits of derive_car_bbox's input on the card against the CPU's
    (TF32 off) within SEG_LOGIT_RTOL of the largest |logit|, the masks equal
    wherever the CPU's margin exceeds twice that; derive_car_bbox on both;
    its time (median of 5 after a warm-up, host clock) and peak memory on
    the card.  Saves the segmentor's .pth for phase 30 (b)."""
    import copy

    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.pave import repvit_seg as seg

    cpu = seg.init_segmentor(seg.RepViTConfig(), seed=SEED, device="cpu")
    x_cpu = seg.frame_input(frame, PAVE_SEG_INFER, "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = cpu(x_cpu)[0].numpy()
        margin = logits[..., 1] - logits[..., 0]
        shift = -float(np.quantile(margin, 1.0 - PAVE_SEG_CAR_SHARE))
        cpu.head.cls.bias[cpu.cfg.car_class] += shift
        logits = cpu(x_cpu)[0].numpy()
    cpu_s = (time.perf_counter() - t0) / 2
    card = copy.deepcopy(cpu).to(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = card(seg.frame_input(frame, PAVE_SEG_INFER, device))[0].cpu().numpy()
    bbox_card = seg.derive_car_bbox(card, frame, PAVE_SEG_INFER)     # warm
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        bbox_card = seg.derive_car_bbox(card, frame, PAVE_SEG_INFER)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    bbox_cpu = seg.derive_car_bbox(cpu, frame, PAVE_SEG_INFER)
    scale = float(np.abs(logits).max())
    err = float(np.abs(got - logits).max())
    margin = logits[..., 1] - logits[..., 0]
    clear = np.abs(margin) > 2 * SEG_LOGIT_RTOL * scale
    mask_cpu, mask_card = margin > 0, got[..., 1] > got[..., 0]
    differ = int((mask_cpu != mask_card)[clear].sum())
    median = sorted(lat)[len(lat) // 2]
    log("pave-segmentor", f"M1.1 (widths {cpu.cfg.widths}, depths {cpu.cfg.depths}, fpn "
                          f"{cpu.cfg.fpn_dim}; {sum(p.numel() for p in cpu.parameters())} "
                          f"parameters) on a {PAVE_FRAME} frame at {PAVE_SEG_INFER}: logits "
                          f"max|card-CPU| {err:.3e} ({err / scale:.2e} of max|logit| {scale:.3g}; "
                          f"limit {SEG_LOGIT_RTOL}); car share CPU {mask_cpu.mean():.3f}, card "
                          f"{mask_card.mean():.3f}; masks differ at {differ} of {int(clear.sum())} "
                          f"clear pixels ({int((~clear).sum())} within the margin); bbox card "
                          f"{[round(v, 2) for v in bbox_card]}, CPU "
                          f"{[round(v, 2) for v in bbox_cpu]}; derive_car_bbox on the card ms "
                          f"{[round(t * 1e3, 1) for t in lat]} (median {median * 1e3:.1f}; CPU "
                          f"{cpu_s * 1e3:.0f} a forward), max_memory_allocated "
                          f"{peak / 2**30:.2f} GiB")
    if not err <= SEG_LOGIT_RTOL * scale or differ or bbox_card is None:
        raise AssertionError(f"the card's segmentor disagrees with the CPU's: error {err}, "
                             f"{differ} clear pixels differ, bbox {bbox_card}")
    path = os.path.join(work, "pave_seg.pth")
    seg.save_segmentor(cpu, path)
    return dict(max_abs_err=err, rel_err=err / scale, car_share=float(mask_cpu.mean()),
                bbox_card=bbox_card, bbox_cpu=bbox_cpu, latency_s=lat, median_s=median,
                peak_bytes=peak, cpu_forward_s=cpu_s, checkpoint=path)


def run_pave_tool(files, frame_path: str, out_dir: str, *car: str, device: str = "cuda") -> dict:
    """tools/inference_pave.py's main end to end on the frame (the car box
    from `car`: --car_bbox ... or --car_seg_checkpoint ...), its launches
    counted: n_crops x (12 K1 + 6 K2) f32 and no other kernel."""
    import numpy as np
    import torch
    from PIL import Image

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.tools import inference_pave

    cfg, ckpt, vocab = files
    args = inference_pave.get_args_parser().parse_args([
        "-c", cfg, "-p", ckpt, "--vocab", vocab, "-i", frame_path, "-t", PAVE_CAPTION,
        "-o", out_dir, "--device", device, *car])
    frame = np.asarray(Image.open(frame_path).convert("RGB"))
    reset_counts()
    t0 = time.perf_counter()
    pred = inference_pave.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = serving_launches(SLConfig.fromfile(cfg), pred["n_crops"])
    boxes, scores = np.asarray(pred["boxes_xyxy"]), np.asarray(pred["scores"])
    log("pave-tool", f"inference_pave {' '.join(car)}: {pred['n_crops']} crops, "
                     f"{len(boxes)} detections after the merge, {seconds:.2f} s with load_model; "
                     f"launches { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"inference_pave: kernel launches {counts}, expected {want}")
    if not (len(boxes) == len(scores) == len(pred["phrases"]) and np.isfinite(boxes).all()
            and ((scores > args.box_threshold) & (scores <= 1)).all()
            and os.path.getsize(os.path.join(out_dir, "pred.jpg")) > 0):
        raise AssertionError(f"inference_pave: malformed output in {out_dir}")
    # the car box the run used (the segmentor's is derived again, outside the count)
    car_bbox = inference_pave.car_bbox_from_args(args, frame)
    return dict(pred=pred, counts=counts, seconds=seconds, car_bbox=car_bbox)


def check_pave_run(im, cpu_im, frame, car_bbox, tag: str) -> dict:
    """Phase 30 (b) on one tool run's car box: the median of 3 frames
    (predict_frame) and a crop's share of it, the frame's predicts alone,
    host clock; a profiled crop's device busy share; the first crop's
    forward on the card against the CPU's on the CPU's two-stage selection
    with phase 6's limits, and with K1's output negated it must fail them."""
    import torch
    from PIL import Image

    from open_groundingdino_tpu_torch import inference
    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.pave import crop_utils
    from open_groundingdino_tpu_torch.tools import inference_pave

    crops = [Image.fromarray(crop_utils.crop_image(frame, cb))
             for cb in crop_utils.create_crop_boxes(frame.shape[:2], car_bbox)]
    size = dict(size=512, max_size=512)
    lat = []
    for _ in range(2):
        t0 = time.perf_counter()
        inference_pave.predict_frame(im, frame, car_bbox, PAVE_CAPTION)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    median = statistics.median(lat)
    t0 = time.perf_counter()
    for crop in crops:   # the frame's predicts alone: the rest is the crop cuts and the merge
        inference.predict(im, crop, PAVE_CAPTION, box_threshold=0.3, **size)
    torch.cuda.synchronize()
    predicts_s = time.perf_counter() - t0
    log(f"pave-frame-{tag}", f"predict_frame over {len(crops)} crops: ms "
                             f"{[round(t * 1e3, 1) for t in lat]} (median {median * 1e3:.1f}, "
                             f"{median * 1e3 / len(crops):.1f} a crop); its {len(crops)} predicts "
                             f"alone {predicts_s * 1e3:.1f} ms, the crop cuts and the merge (NMS "
                             f"of every crop's detections) the rest")
    profile = profile_request(im, crops[0], PAVE_CAPTION, tag=f"pave-crop-profile-{tag}", **size)

    t0 = time.perf_counter()
    with TwoStageSelection() as cpu_sel:
        cpu = forward_outputs(cpu_im, crops[0], PAVE_CAPTION, **size)
    cpu_s = time.perf_counter() - t0
    if cpu[2][1:3] != PAVE_BUCKET:
        raise AssertionError(f"a crop landed in {cpu[2]}, not the {PAVE_BUCKET} bucket")
    with TwoStageSelection(cpu_sel.order):
        card = forward_outputs(im, crops[0], PAVE_CAPTION, **size)
    forward = compare_forward(card, cpu, f"pave-forward-{tag}",
                              f"its first crop, the CPU's two-stage selection; CPU forward "
                              f"{cpu_s:.1f} s")
    fwd = msda._msda_fwd_cuda
    msda._msda_fwd_cuda = negated_output(fwd)
    try:
        with TwoStageSelection(cpu_sel.order):
            planted = forward_gap(forward_outputs(im, crops[0], PAVE_CAPTION, **size), cpu)
    finally:
        msda._msda_fwd_cuda = fwd
    log(f"pave-forward-{tag}", f"planted fault, K1 output negated: flipped {planted[0]:.1%}, "
                               f"bulk max|dlogit| {planted[1]:.3e}, bulk max|dbox| "
                               f"{planted[2]:.3e}")
    if planted[3]:
        raise AssertionError(f"pave {tag}: the crop forward comparison passes with K1's output "
                             f"negated")
    return dict(frame_s=lat, median_frame_s=median, crop_s=median / len(crops),
                predicts_s=predicts_s, profile=profile, forward=forward, planted_k1=planted[:3])


def check_pave_tool(files, work: str, frame, seg_path: str, device: str = "cuda") -> dict:
    """Phase 30 (b): tools/inference_pave.py twice, with --car_bbox
    PAVE_CAR_BBOX (PAVE_CROPS crops) and with --car_seg_checkpoint (the
    segmentor of (a)), each with exact f32 launches, then check_pave_run on
    each run's car box."""
    from PIL import Image

    from open_groundingdino_tpu_torch import inference

    frame_path = os.path.join(work, "pave_frame.png")
    Image.fromarray(frame).save(frame_path)
    runs = {"bbox": run_pave_tool(files, frame_path, os.path.join(work, "pave_out"),
                                  "--car_bbox", ",".join(str(v) for v in PAVE_CAR_BBOX),
                                  device=device),
            "segmentor": run_pave_tool(files, frame_path, os.path.join(work, "pave_seg_out"),
                                       "--car_seg_checkpoint", seg_path, device=device)}
    if runs["bbox"]["pred"]["n_crops"] != PAVE_CROPS:
        raise AssertionError(f"{runs['bbox']['pred']['n_crops']} crops for {PAVE_CAR_BBOX}")
    im = inference.load_model(*files, device=device)
    cpu_im = inference.load_model(*files, device="cpu")
    return {tag: {"counts": r["counts"], "seconds": r["seconds"],
                  "n_crops": r["pred"]["n_crops"],
                  **check_pave_run(im, cpu_im, frame, r["car_bbox"], tag)}
            for tag, r in runs.items()}


def pave_forward_fn(model, post, compute_dtype):
    """run_batch_eval's forward: make_eval_step in `compute_dtype` (the
    parameters cast once) and PostProcess.device; per crop {'scores': (K,),
    'boxes': (K, 4) xyxy in crop pixels} on the host."""
    from open_groundingdino_tpu_torch.parallel.train_state import (cast_floating, make_eval_step,
                                                                   resolve_compute_dtype)

    step = make_eval_step(model, compute_dtype=compute_dtype)
    dtype = resolve_compute_dtype(compute_dtype)
    params = dict(model.named_parameters())
    if dtype is not None:
        params = cast_floating(params, dtype)

    def forward(batch):
        packed = post.device(step(batch, params), batch["orig_sizes"]).cpu().numpy()
        return {"scores": packed[..., 0], "boxes": packed[..., 2:6]}

    forward.step, forward.params = step, params
    return forward


def check_pave_eval(files, work: str, frames, gts, device: str = "cuda") -> dict:
    """Phase 30 (c): pave/batch_eval.run_batch_eval over a two-frame manifest
    at batch_size PAVE_BATCH in the config's compute dtype (bf16), through
    make_eval_step + PostProcess.device: 12 K1 + 6 K2 bf16 launches a batch
    and no other (a frame of 21 crops is a batch of 16 and one of 5), a
    finite summary, and tools/get_metrics.py on its CSV giving the same
    summary; crops/s and frames/s over a second pass, peak memory, a
    profiled B = 16 batch's busy share; and the B = 16 batch's K1 and K2
    operands for phase 30 (d)."""
    import csv

    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile, schedule

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_caption, build_tokenizer
    from open_groundingdino_tpu_torch.inference import load_model
    from open_groundingdino_tpu_torch.models.postprocess import PostProcess
    from open_groundingdino_tpu_torch.pave import batch_eval, engine
    from open_groundingdino_tpu_torch.tools import get_metrics

    cfg, ckpt, vocab = files
    args = SLConfig.fromfile(cfg)
    rows = []
    for i, (frame, gt) in enumerate(zip(frames, gts)):
        path = os.path.join(work, f"pave_eval_{i}.png")
        Image.fromarray(frame).save(path)
        rows.append({"image_path": path, "car_bbox": ",".join(map(str, PAVE_CAR_BBOX)),
                     "gt_boxes": ";".join(",".join(f"{v:.1f}" for v in b) for b in gt),
                     "gt_labels": ";".join(PAVE_LABELS[j % len(PAVE_LABELS)]
                                           for j in range(len(gt)))})
    manifest = os.path.join(work, "pave_manifest.csv")
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    manifest_rows = batch_eval.parse_manifest(manifest)
    tokenizer = build_tokenizer(vocab)
    collator = Collator(tokenizer, args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=True)
    post = PostProcess(tokenizer, PAVE_LABELS, int(args.num_select), int(args.max_text_len))
    model = load_model(*files, device=device).model
    dtype = str(args.compute_dtype)
    forward = pave_forward_fn(model, post, dtype)
    n_crops = len(frames) * PAVE_CROPS
    n_batches = len(frames) * -(-PAVE_CROPS // PAVE_BATCH)
    out_csv = os.path.join(work, "pave_eval.csv")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = batch_eval.run_batch_eval(forward, collator, manifest_rows, PAVE_LABELS,
                                    out_csv=out_csv, batch_size=PAVE_BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = eval_launches(n_batches, dtype == "bfloat16")
    t0 = time.perf_counter()
    batch_eval.run_batch_eval(forward, collator, manifest_rows, PAVE_LABELS,
                              batch_size=PAVE_BATCH)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    summary = res["summary"]
    read_back = get_metrics.main(get_metrics.get_args_parser().parse_args([out_csv]))
    log("pave-eval", f"run_batch_eval over {len(frames)} frames ({n_crops} crops, "
                     f"{n_batches} batches of at most {PAVE_BATCH}, {dtype}): {first_s:.2f} s "
                     f"with warm-up; a second pass {pass_s:.3f} s: {n_crops / pass_s:.1f} crops/s, "
                     f"{len(frames) / pass_s:.2f} frames/s; max_memory_allocated "
                     f"{peak / 2**30:.2f} GiB; launches "
                     f"{ {k: v for k, v in counts.items() if v} }; summary {summary}; "
                     f"get_metrics on its CSV {read_back['summary']}")
    if counts != want:
        raise AssertionError(f"pave eval: kernel launches {counts}, expected {want}")
    if (not all(math.isfinite(v) for v in summary.values()) or read_back["summary"] != summary
            or read_back["sweep"] != res["sweep"] or res["n_frames"] != len(frames)):
        raise AssertionError(f"pave eval: summary {summary}, read back {read_back['summary']}")

    # one B = 16 crop batch: its K1/K2 operands, and a profiled batch
    caption = build_caption(PAVE_LABELS)
    samples, _ = engine.crops_to_samples(frames[0], PAVE_CAR_BBOX, gts[0],
                                         np.zeros(len(gts[0]), np.int64), caption, PAVE_LABELS,
                                         keep_empty=True)
    batch = collator(samples[:PAVE_BATCH])
    if tuple(batch["images"].shape[:3]) != (PAVE_BATCH, *PAVE_BUCKET):
        raise AssertionError(f"the crop batch is {batch['images'].shape}")
    with KernelOperands() as operands:
        forward.step(batch, forward.params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            forward(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    _, groups, launches = device_time_by_group(prof)
    busy = sum(groups.values())
    log("pave-eval-profile", f"one B={PAVE_BATCH} crop batch ({dtype}) {wall_ms:.1f} ms wall "
                             f"(profiler on), device busy {busy:.1f} ms ({busy / wall_ms:.0%}); "
                             f"by group ms { {k: round(v, 2) for k, v in groups.items() if v} }, "
                             f"launches { {k: n for k, n in launches.items() if n} }")
    if busy <= 0:
        raise AssertionError("pave eval: the profiler recorded no device time")
    return dict(counts=counts, summary=summary, first_pass_s=first_s, pass_s=pass_s,
                crops_per_s=n_crops / pass_s, frames_per_s=len(frames) / pass_s,
                peak_bytes=peak, batch_wall_ms=wall_ms, batch_busy_ms=busy,
                batch_busy_share=busy / wall_ms, groups_ms=groups,
                operands=(operands.msda, operands.fusion))


def check_pave_kernels(operands) -> dict:
    """Phase 30 (d): K1 (encoder and decoder) and K2 on the B = 16 crop
    batch's own operands (each image valid 512x512 of 608x928), through
    their f32 entries (the operands widened) and their bf16 entries (the
    model's), against the plain versions: f32 within K1_TOL / K2_TOL, bf16
    within BF16_FWD_RTOL of max|ref| (K2's out_l within K2_BF16_TEXT_SIDE x
    out_v's error); CUDA-event and profiler device times beside the plain
    version and the bound at these inputs."""
    import torch

    from open_groundingdino_tpu_torch.ops import fusion, msda

    msda_ops, fusion_ops = operands
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for part in ("encoder", "decoder"):
            value, shapes, starts, locs, attn = msda_ops[part]
            value = value.to(dtype)
            fwd = lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn)   # noqa: E731
            plain = lambda: msda.ms_deform_attn_plain(   # noqa: E731
                value, shapes, starts, locs, attn)
            err, rel = rel_err(fwd(), plain())
            bound = msda_bound_ms(value, shapes, locs, attn)
            rows["K1", name, part] = dict(
                B=value.shape[0], Q=locs.shape[1], L=value.shape[1],
                shapes=[list(hw) for hw in shapes], max_abs_err=err, rel_err=rel,
                ms=event_ms(fwd, 20),
                device_ms=kernel_device_ms(fwd, 20, K1_BF16_NAMES if name == "bf16"
                                           else "msda_fwd_kernel"),
                plain_ms=event_ms(plain, 3), bound_ms=bound[0], bound_by=bound[1])
            ok = err <= K1_TOL if name == "f32" else rel <= BF16_FWD_RTOL
            r = rows["K1", name, part]
            log("pave-kernels", f"K1 {name} {part}: B={r['B']} Q={r['Q']} L={r['L']} shapes "
                                f"{r['shapes']}; max|kernel-plain| {err:.3e} ({rel:.2e} of "
                                f"max|ref|; limit {K1_TOL if name == 'f32' else BF16_FWD_RTOL}"
                                f"{'' if name == 'f32' else ' of max|ref|'}); kernel "
                                f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
                                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                                f"({r['bound_by']})")
            if not ok:
                raise AssertionError(f"pave: K1 {name} {part} disagrees with its plain version")
        q, k, val_v, val_l, mask_v, mask_l, heads = fusion_ops
        args = [t.to(dtype) for t in (q, k, val_v, val_l)] + [mask_v, mask_l]
        fwd = lambda: fusion._fusion_fwd_cuda(*args, heads)   # noqa: E731
        plain = lambda: fusion.fused_bi_attention_plain(*args, heads)   # noqa: E731
        out_v, out_l = fwd()[:2]
        ov_p, ol_p = plain()
        (ev, rv), (el, rl) = rel_err(out_v, ov_p), rel_err(out_l, ol_p)
        del ov_p, ol_p
        bound = fusion_bound_ms(args[0], args[1], mask_v, mask_l)
        frags = (("attend_bf16_kernel", "combine_bf16_kernel") if name == "bf16"
                 else ("attend_kernel", "combine_kernel"))
        rows["K2", name, "fusion"] = r = dict(
            B=q.shape[0], Nv=q.shape[1], live_v=int((~mask_v).sum()), live_l=int((~mask_l).sum()),
            max_abs_err=max(ev, el), rel_errs={"out_v": rv, "out_l": rl},
            ms=event_ms(fwd, 5), device_ms=kernel_device_ms(fwd, 5, frags, per_call=3),
            plain_ms=event_ms(plain, 3), bound_ms=bound[0], bound_by=bound[1])
        ok = (max(ev, el) <= K2_TOL if name == "f32" else
              max(rv, rl) <= BF16_FWD_RTOL and rl <= K2_BF16_TEXT_SIDE * rv)
        log("pave-kernels", f"K2 {name}: B={r['B']} Nv={r['Nv']} ({r['live_v']} live of "
                            f"{r['B'] * r['Nv']}) Nl={k.shape[1]} ({r['live_l']} live): "
                            f"max|kernel-plain| out_v {ev:.3e} out_l {el:.3e} (of max|ref| "
                            f"{rv:.2e} / {rl:.2e}; limit "
                            f"{K2_TOL if name == 'f32' else f'{BF16_FWD_RTOL} of max|ref|'}); "
                            f"kernel {r['ms']:.3f} ms (device {r['device_ms']:.3f}), plain "
                            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                            f"({r['bound_by']})")
        if not ok:
            raise AssertionError(f"pave: K2 {name} disagrees with its plain version")
        del args
    return rows


def check_pave(work: str, files, device: str = "cuda") -> dict:
    """Phase 30: the PAVE pipeline (a)-(d) on the smoke's Swin-T checkpoint."""
    frames, gts = pave_frames()
    segmentor = check_segmentor(work, frames[0], device)
    tool = check_pave_tool(files, work, frames[0], segmentor["checkpoint"], device)
    evals = check_pave_eval(files, work, frames, gts, device)
    kernels = check_pave_kernels(evals.pop("operands"))
    return dict(segmentor=segmentor, tool=tool, eval=evals, kernels=kernels)


# ---------------------------------------------------------------- export (phase 31)
# phase 31: the serving artifacts.  The sweep (with msda_dec_fused: K6 in the
# encoder, K7 in the decoder) and banded_point (K5) artifacts are of a model
# with one encoder and one decoder layer at full width; the gather artifact is
# phase 5's full model.  Each artifact is served in a fresh process; its
# forward is held against the eager forward of the same checkpoint on the
# card with phase 6's limits (both launch the same kernels and cuBLAS calls)
EXPORT_LAYERS = 1
EXPORT_REQUESTS = 5          # timed requests of the gather artifact and of eager predict
EXPORT_SPANS = [[(2, 5)], [(10, 13)]]   # "cat" and "dog" of CAPTIONS[0]
EXPORT_PATHS = (("gather", {}),
                ("sweep", {"msda_kernel": "sweep", "msda_dec_fused": True}),
                ("banded_point", {"msda_kernel": "banded_point"}))
FLAG_TIMEOUT_S = 900


def start_export(files, out_dir: str, device: str = "cuda") -> tuple:
    """tools/export_model.py for the 800x1216 bucket on `device`, started in
    a subprocess; returns (process, start time)."""
    cfg, ckpt, vocab = files
    cmd = [sys.executable, "-m", "open_groundingdino_tpu_torch.tools.export_model", "-c", cfg,
           "--checkpoint", ckpt, "--vocab", vocab, "-o", out_dir,
           "--bucket", f"{BUCKET[0]}x{BUCKET[1]}", "--device", device]
    return (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True), time.perf_counter())


def start_serving(art: str, out: str, full: bool, device: str = "cuda") -> tuple:
    """serve_artifact(art, out, full, device) in a fresh process; returns
    (process, start time)."""
    code = (f"import chip_smoke; chip_smoke.serve_artifact({art!r}, {out!r}, {full!r}, "
            f"{device!r})")
    return (subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), time.perf_counter())


def finish(started, tag: str, timeout: int = FLAG_TIMEOUT_S) -> tuple:
    """Wait for a started subprocess; returns (its output, its wall
    seconds); raises with its output's end if it failed."""
    proc, t0 = started
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exited with {proc.returncode}:\n{out[-4000:]}")
    return out, time.perf_counter() - t0


def wait_for(flag: str) -> None:
    """Block until the file `flag` exists (FLAG_TIMEOUT_S at most)."""
    deadline = time.monotonic() + FLAG_TIMEOUT_S
    while not os.path.exists(flag):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {flag} after {FLAG_TIMEOUT_S} s")
        time.sleep(0.05)


def raise_flag(flag: str) -> None:
    with open(flag, "w"):
        pass


def serve_artifact(art: str, out: str, full: bool, device: str = "cuda") -> None:
    """Phase 31's fresh process.  It starts before the artifact exists: it
    readies the device (as a server does at its start) and waits for
    `out`.ready, then runs
    load_exported and one forward (its launches counted), and with `full`
    one predict and one predict_with_spans; with `full` it then waits for
    `out`.go (the other processes done) and serves EXPORT_REQUESTS timed
    predict requests (their launches counted), a profiled request, and the
    forward again with K1's output negated.  Writes the outputs and numbers
    to `out` (.npz)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference, serving
    from open_groundingdino_tpu_torch.ops import build, library, msda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # what a serving process does once at its start: the ops registered, the
    # kernels' libraries loaded, the device's BLAS and cuDNN handles made
    library.custom_ops()
    if device == "cuda":
        for name in build.SOURCES:
            build.load(name)
    x = torch.ones(1, 1, 8, 8, device=device)
    torch.nn.functional.conv2d(x, x[..., :3, :3])
    torch.mm(x[0, 0], x[0, 0])
    wait_for(out + ".ready")
    t0 = time.perf_counter()
    sm = serving.load_exported(art, device=device)
    res = {"load_s": time.perf_counter() - t0}
    image, caption = synthetic_image(*IMAGE_SIZES[0], 0), CAPTIONS[0]
    reset_counts()
    t0 = time.perf_counter()
    logits, boxes, _ = forward_outputs(sm, image, caption)
    res["first_s"] = time.perf_counter() - t0
    res["forward_counts"] = read_counts()
    arrays = dict(logits=logits, boxes=boxes)
    if full:
        pred = inference.predict(sm, image, caption)
        spans = inference.predict_with_spans(sm, image, caption, EXPORT_SPANS)
        arrays.update(pred_boxes=pred[0], pred_scores=pred[1], spans_boxes=spans[0],
                      spans_scores=spans[1])
        res["phrases"], res["spans_phrases"] = pred[2], spans[2]
        wait_for(out + ".go")
        res["latency_s"], res["request_counts"] = timed_requests(sm, image, caption)
        res["profile"] = profile_request(sm, image, caption, tag="export-profile")
        fwd = msda._msda_fwd_cuda
        msda._msda_fwd_cuda = negated_output(fwd)
        arrays["neg_logits"], arrays["neg_boxes"], _ = forward_outputs(sm, image, caption)
        msda._msda_fwd_cuda = fwd
    np.savez(out, meta=json.dumps(json_safe(res)), **arrays)


def timed_requests(im, image, caption) -> tuple:
    """EXPORT_REQUESTS predict requests, each timed by the host clock to its
    end on the device; returns (seconds, launch counts)."""
    import torch

    from open_groundingdino_tpu_torch import inference

    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for _ in range(EXPORT_REQUESTS):
        t0 = time.perf_counter()
        inference.predict(im, image, caption)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat, read_counts()


def export_config(cfg: str, work: str, name: str, keys: dict) -> str:
    """A config on `cfg` with the MSDA keys and EXPORT_LAYERS encoder and
    decoder layers."""
    return msda_config(cfg, work, f"export-{name}", enc_layers=EXPORT_LAYERS,
                       dec_layers=EXPORT_LAYERS, **keys)


def parse_export(out: str) -> dict:
    """The tool's lines "  <file>  <size> MB  (export <s> s)" as {file: {mb,
    export_s}}."""
    written = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[2] == "MB":
            written[parts[0]] = {"mb": float(parts[1])}
            if "(export" in line:
                written[parts[0]]["export_s"] = float(parts[4])
    return written


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over the entries finite in both."""
    import numpy as np

    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def check_export(work: str, files, eager_profile: dict, device: str = "cuda") -> dict:
    """Phase 31: the serving artifacts, each exported by
    tools/export_model.py in a subprocess for the 800x1216 bucket: the gather
    path on phase 5's checkpoint, the sweep (dec_fused) and banded_point
    paths on a checkpoint of EXPORT_LAYERS encoder and decoder layers.  Each
    is served in a fresh process (serve_artifact), started first so that it
    waits for its artifact with the device ready, while the eager models of
    the same checkpoints answer the same requests here.  The gather
    artifact: 12 K1 + 6 K2 f32 launches a request and no other, its forward
    against the eager one with phase 6's limits (the largest difference
    printed), with K1's output negated failing them, predict and
    predict_with_spans as the eager ones, export seconds, artifact sizes,
    load seconds, the median latency and the profiled busy time of its
    requests beside eager predict's (its latency timed here with no other
    process at work, `eager_profile` phase 7's profile of the same
    request).  The sweep and banded_point artifacts: their forwards against
    their eager ones, and exactly the eager forward's launches (K6 + K7, K5,
    K2)."""
    import numpy as np

    from open_groundingdino_tpu_torch import inference

    cfg, ckpt, vocab = files
    arts = {name: os.path.join(work, f"artifact_{name}") for name, _ in EXPORT_PATHS}
    outs = {name: os.path.join(work, f"served_{name}.npz") for name, _ in EXPORT_PATHS}
    procs = {}
    try:
        for name, _ in EXPORT_PATHS:
            procs[f"serve-{name}"] = start_serving(arts[name], outs[name], name == "gather",
                                                   device)
        procs["export-gather"] = start_export(files, arts["gather"], device)
        small_ckpt = os.path.join(work, "ckpt_export_small.pth")
        write_checkpoint(export_config(cfg, work, "gather", {}), small_ckpt)
        small = {name: (export_config(cfg, work, name, keys), small_ckpt, vocab)
                 for name, keys in EXPORT_PATHS[1:]}
        for name, f in small.items():
            procs[f"export-{name}"] = start_export(f, arts[name], device)

        # the eager models' answers, while the exports run
        image, caption = synthetic_image(*IMAGE_SIZES[0], 0), CAPTIONS[0]
        eager, want = {}, {}
        for name, f in (("gather", files), *small.items()):
            im = inference.load_model(*f, device=device)
            reset_counts()
            eager[name] = forward_outputs(im, image, caption)
            want[name] = read_counts()
            if name == "gather":
                gather_im, args = im, im.args
                eager_pred = inference.predict(im, image, caption)
                eager_spans = inference.predict_with_spans(im, image, caption, EXPORT_SPANS)
            del im
        if want["gather"] != serving_launches(args, 1):
            raise AssertionError(f"export: the eager forward launched {want['gather']}")

        res = {}
        for name, _ in EXPORT_PATHS:
            out, wall = finish(procs.pop(f"export-{name}"), f"export-{name}")
            res[name] = {"export_wall_s": wall, "files": parse_export(out)}
            raise_flag(outs[name] + ".ready")
        for name in ("sweep", "banded_point", "gather"):
            if name == "gather":   # its timed requests wait for the others to end
                raise_flag(outs[name] + ".go")
            out, wall = finish(procs.pop(f"serve-{name}"), f"export-serve-{name}")
            for line in out.splitlines():
                if line.startswith("["):
                    print(line, flush=True)
            with np.load(outs[name]) as z:
                served = {k: z[k] for k in z.files}
            res[name].update(json.loads(str(served.pop("meta"))), serve_wall_s=wall,
                             served=served)
        lat, _ = timed_requests(gather_im, image, caption)
        del gather_im
    finally:
        for proc, _ in procs.values():
            proc.kill()
            proc.wait()

    for name, _ in EXPORT_PATHS:
        run = res[name]
        served = run.pop("served")
        if name == "gather":
            negated = {"logits": served["neg_logits"], "boxes": served["neg_boxes"]}
            answers = {"predict": (served["pred_boxes"], served["pred_scores"], run["phrases"]),
                       "predict_with_spans": (served["spans_boxes"], served["spans_scores"],
                                              run["spans_phrases"])}
        card = (served["logits"], served["boxes"], eager[name][2])
        run["forward"] = compare_forward(card, eager[name], f"export-{name}",
                                         "the artifact in a fresh process against the eager "
                                         "forward on the card")
        run["max_abs_diff"] = (max_abs_diff(card[0], eager[name][0]),
                               max_abs_diff(card[1], eager[name][1]))
        log(f"export-{name}", f"files {run['files']}; export subprocess "
                              f"{run['export_wall_s']:.1f} s; load_exported {run['load_s']:.1f} s "
                              f"in a fresh process; first forward {run['first_s']:.2f} s; "
                              f"launches { {k: v for k, v in run['forward_counts'].items() if v} } "
                              f"(the eager forward's "
                              f"{ {k: v for k, v in want[name].items() if v} }); max |dlogit| "
                              f"{run['max_abs_diff'][0]:.3e}, max |dbox| "
                              f"{run['max_abs_diff'][1]:.3e} against the eager forward")
        if run["forward_counts"] != want[name]:
            raise AssertionError(f"export-{name}: the artifact launched {run['forward_counts']}, "
                                 f"the eager forward {want[name]}")
    run = res["gather"]
    per_request = serving_launches(args, EXPORT_REQUESTS)
    if run["request_counts"] != per_request:
        raise AssertionError(f"export: {EXPORT_REQUESTS} requests launched "
                             f"{run['request_counts']}, expected {per_request}")
    planted = forward_gap((negated["logits"], negated["boxes"], eager["gather"][2]),
                          eager["gather"])
    log("export-gather", f"planted fault, K1 output negated in the artifact: flipped "
                         f"{planted[0]:.1%}, bulk max|dlogit| {planted[1]:.3e}, bulk max|dbox| "
                         f"{planted[2]:.3e}")
    if planted[3]:
        raise AssertionError("export: the comparison passes with K1's output negated")
    for what, got, ref in (("predict", answers["predict"], eager_pred),
                           ("predict_with_spans", answers["predict_with_spans"], eager_spans)):
        ok = (len(got[0]) == len(ref[0]) and list(got[2]) == list(ref[2])
              and np.allclose(got[0], ref[0], atol=5e-3) and np.allclose(got[1], ref[1], atol=5e-2))
        log("export-gather", f"{what}: {len(got[0])} boxes served, {len(ref[0])} eager; max "
                             f"|dbox| {max_abs_diff(got[0], ref[0]) if ok else float('nan'):.3e}, "
                             f"phrases equal {list(got[2]) == list(ref[2])}")
        if not ok:
            raise AssertionError(f"export: {what} on the artifact disagrees with eager")
    med = sorted(run["latency_s"])[len(run["latency_s"]) // 2]
    eager_med = sorted(lat)[len(lat) // 2]
    run.update(latency_median_s=med, eager_latency_s=lat, eager_latency_median_s=eager_med,
               eager_profile=eager_profile, planted_k1=planted[:3])
    log("export-gather", f"{EXPORT_REQUESTS} requests after 2: latency ms "
                         f"{[round(t * 1e3, 1) for t in run['latency_s']]} (median "
                         f"{med * 1e3:.1f}), device busy {run['profile']['device_busy_ms']:.1f} ms "
                         f"of {run['profile']['wall_ms']:.1f} ms profiled; eager predict on the "
                         f"same request {[round(t * 1e3, 1) for t in lat]} (median "
                         f"{eager_med * 1e3:.1f}), device busy "
                         f"{eager_profile['device_busy_ms']:.1f} ms of "
                         f"{eager_profile['wall_ms']:.1f} ms (phase 7)")
    for name, _ in EXPORT_PATHS:
        shutil.rmtree(arts[name], ignore_errors=True)
        for suffix in ("", ".ready", ".go"):
            if os.path.exists(outs[name] + suffix):
                os.remove(outs[name] + suffix)
    return res


# ---------------------------------------------------------------- RoBERTa (phase 32)
ROBERTA_CAPTION = "a cat . a dog . person . bicycle ."
ROBERTA_SPANS = [[(2, 5)], [(10, 13)], [(16, 22)]]      # cat, dog, person
ROBERTA_REQUESTS = 3        # timed predict requests after one warm-up
# the card-vs-CPU forward's encoder and decoder layers (the text tower and
# Swin-T stay at full depth): a full-depth CPU forward takes 45-65 s
ROBERTA_FWD_LAYERS = 1
TEXT_DROPOUT = 0.1
DROPOUT_SIGMAS = 4.0
# the same generator seed, weights and batch as main's first step: its loss,
# but for the order of the card's sums where it is not fixed
DROPOUT_LOSS_RTOL = 1e-6
# the zero-shot tool's 12 numbers against the in-process numpy-matcher eval
ZERO_SHOT_TOL = 1e-6


def roberta_files(cfg: str, work: str) -> tuple:
    """Phase 32's inputs in `work`: the 50265-entry BPE vocabulary
    (write_bpe_vocab), a config on `cfg` with roberta-base's geometry,
    text_encoder_type and text_dropout TEXT_DROPOUT (which only training
    applies), and its seeded checkpoint (random biases, anchor
    boxes) at the reference keys, with the (1, 514) position-id buffer a
    roberta-base checkpoint carries; returns (config, checkpoint, vocab
    directory)."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig

    t0 = time.perf_counter()
    bpe = write_bpe_vocab(os.path.join(work, "roberta_bpe"))
    vocab_s = time.perf_counter() - t0
    rcfg = msda_config(cfg, work, "roberta", bert_vocab_size=ROBERTA_VOCAB,
                       bert_max_position=ROBERTA_MAX_POSITION, bert_type_vocab=1,
                       text_encoder_type="roberta-base", text_dropout=TEXT_DROPOUT)
    ckpt = os.path.join(work, "roberta_ckpt.pth")
    write_checkpoint(rcfg, ckpt, random_biases=True, anchor_boxes=True, extra={
        "bert.embeddings.position_ids": torch.arange(ROBERTA_MAX_POSITION)[None]})
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    shapes = {k: tuple(sd[k].shape) for k in (
        "bert.embeddings.word_embeddings.weight", "bert.embeddings.position_embeddings.weight",
        "bert.embeddings.token_type_embeddings.weight", "bert.embeddings.position_ids")}
    log("roberta", f"BPE vocabulary of {ROBERTA_VOCAB} entries in {vocab_s:.1f} s; checkpoint "
                   f"{os.path.getsize(ckpt) / 2**20:.0f} MiB in "
                   f"{time.perf_counter() - t0 - vocab_s:.1f} s, {shapes}")
    width = int(SLConfig.fromfile(rcfg).get("bert_hidden_size", 768))
    if shapes != {"bert.embeddings.word_embeddings.weight": (ROBERTA_VOCAB, width),
                  "bert.embeddings.position_embeddings.weight": (ROBERTA_MAX_POSITION, width),
                  "bert.embeddings.token_type_embeddings.weight": (1, width),
                  "bert.embeddings.position_ids": (1, ROBERTA_MAX_POSITION)}:
        raise AssertionError(f"the RoBERTa checkpoint's text tower: {shapes}")
    return rcfg, ckpt, bpe


def depth_cut_checkpoint(files, work: str, layers: int) -> tuple:
    """The checkpoint's model cut to `layers` encoder and decoder layers (the
    rest of it whole): a config and a .pth holding the cut model's keys (and
    the position-id buffer); returns (config, checkpoint, vocab)."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino

    cfg, ckpt, vocab = files
    cut_cfg = msda_config(cfg, work, "roberta-cut", enc_layers=layers, dec_layers=layers)
    keys = build_groundingdino(SLConfig.fromfile(cut_cfg), device="meta").state_dict()
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    path = os.path.join(work, "roberta_cut.pth")
    torch.save({"model": {k: v for k, v in sd.items()
                          if k in keys or k == "bert.embeddings.position_ids"}}, path)
    return cut_cfg, path, vocab


def check_roberta_tokens(im) -> dict:
    """The served tokenizer: roberta-base's BPE of the caption, its phrases
    delimited by the 'Ġ.' id (one attention block and position run a
    phrase), decoded back to the caption."""
    from open_groundingdino_tpu_torch.data.tokenization import (
        RobertaBPETokenizer, generate_masks_with_special_tokens)

    tok = im.tokenizer
    enc = tok([ROBERTA_CAPTION], padding=im.max_text_len)
    ids = enc.input_ids[0][enc.attention_mask[0].astype(bool)]
    _, pos = generate_masks_with_special_tokens(enc.input_ids, tok.special_token_ids())
    phrases = int((pos[0][1:len(ids) - 1] == 0).sum())
    pieces = [tok.ids_to_tokens[int(i)] for i in ids]
    log("roberta", f"tokenizer {type(tok).__name__} ({len(tok.vocab)} entries): "
                   f"{ROBERTA_CAPTION!r} -> {pieces}; {phrases} phrase position runs")
    if not (isinstance(tok, RobertaBPETokenizer) and len(tok.vocab) == ROBERTA_VOCAB
            and tok.decode(ids) == ROBERTA_CAPTION and tok.vocab["Ġ."] in tok.special_token_ids()
            and phrases == ROBERTA_CAPTION.count(".")):
        raise AssertionError("the served RoBERTa tokenizer")
    return {"pieces": pieces}


def serve_roberta(files, image, device: str = "cuda") -> dict:
    """Phase 32 (a), serving at full width and depth: load_model with the BPE
    directory, a warm-up and ROBERTA_REQUESTS predict requests (12 K1 + 6 K2
    f32 launches each, no other), their phrases words of the caption;
    predict_with_spans on three of its phrases; a profiled request."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference

    t0 = time.perf_counter()
    im = inference.load_model(*files, device=device)
    load_s = time.perf_counter() - t0
    tokens = check_roberta_tokens(im)
    inference.predict(im, image, ROBERTA_CAPTION)                     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for _ in range(ROBERTA_REQUESTS):
        t0 = time.perf_counter()
        boxes, scores, phrases = inference.predict(im, image, ROBERTA_CAPTION)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    counts = read_counts()
    want = serving_launches(im.args, ROBERTA_REQUESTS)
    words = set(ROBERTA_CAPTION.split())
    spans = inference.predict_with_spans(im, image, ROBERTA_CAPTION, ROBERTA_SPANS)
    median = sorted(lat)[len(lat) // 2]
    log("roberta-serve", f"load_model on {device} in {load_s:.1f} s; {ROBERTA_REQUESTS} requests "
                         f"after 1 warm-up: latency ms {[round(t * 1e3, 1) for t in lat]} (median "
                         f"{median * 1e3:.1f}); {len(boxes)} boxes, phrases "
                         f"{sorted(set(phrases))[:8]}; predict_with_spans {len(spans[0])} boxes "
                         f"over {sorted(set(spans[2]))}; launches "
                         f"{ {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"RoBERTa requests: kernel launches {counts}, expected {want}")
    if not (len(boxes) == len(scores) == len(phrases) > 0 and np.isfinite(boxes).all()
            and all(set(p.split()) <= words for p in phrases)
            and any(set(p.split()) - {"."} for p in phrases)):
        raise AssertionError(f"RoBERTa predict's phrases are not the caption's words: {phrases}")
    if not (len(spans[0]) == len(spans[2]) > 0 and np.isfinite(spans[0]).all()
            and set(spans[2]) <= {"cat", "dog", "person"}):
        raise AssertionError(f"RoBERTa predict_with_spans: {set(spans[2])}")
    profile = profile_request(im, image, ROBERTA_CAPTION, tag="roberta-profile")
    return dict(im=im, load_s=load_s, latency_s=lat, median_s=median, counts=counts,
                profile=profile, tokens=tokens, phrases=sorted(set(phrases)))


def check_roberta_forward(files, work: str, image, device: str = "cuda") -> dict:
    """Phase 32 (a): the checkpoint cut to ROBERTA_FWD_LAYERS encoder and
    decoder layers (depth_cut_checkpoint: the 12-layer text tower and Swin-T
    whole) on the card and on the CPU: as served fewer than 10% of the
    queries flipped, and on the CPU's two-stage selection phase 6's limits;
    with K1's output negated the card must fail them."""
    from open_groundingdino_tpu_torch import inference
    from open_groundingdino_tpu_torch.ops import msda

    cut = depth_cut_checkpoint(files, work, ROBERTA_FWD_LAYERS)
    card_im = inference.load_model(*cut, device=device)
    t0 = time.perf_counter()
    cpu_im = inference.load_model(*cut, device="cpu")
    with TwoStageSelection() as cpu_sel:
        cpu = forward_outputs(cpu_im, image, ROBERTA_CAPTION)
    del cpu_im
    cpu_s = time.perf_counter() - t0
    with TwoStageSelection() as card_sel:
        free = forward_outputs(card_im, image, ROBERTA_CAPTION)
    sel = cpu_sel.compare(card_sel)
    flip, lg_err, bx_err, _ = forward_gap(free, cpu)
    log("roberta-forward", f"{ROBERTA_FWD_LAYERS} + {ROBERTA_FWD_LAYERS} layers, as served: "
                           f"{sel['reordered']} of {sel['queries']} queries took another encoder "
                           f"token than on the CPU (score margin {sel['margin']:.2e} at the cut); "
                           f"flipped {flip:.1%}, bulk max|dlogit| {lg_err:.3e}, bulk max|dbox| "
                           f"{bx_err:.3e}")
    if not flip < 0.10:
        raise AssertionError(f"RoBERTa forward: {flip:.1%} of the queries flipped")
    with TwoStageSelection(cpu_sel.order):
        card = forward_outputs(card_im, image, ROBERTA_CAPTION)
    res = dict(selection=sel, as_served=(flip, lg_err, bx_err), cpu_s=cpu_s)
    res["forward"] = compare_forward(card, cpu, "roberta-forward",
                                     f"with the CPU's two-stage selection; CPU forward "
                                     f"{cpu_s:.1f} s")
    fwd = msda._msda_fwd_cuda
    msda._msda_fwd_cuda = negated_output(fwd)
    try:
        with TwoStageSelection(cpu_sel.order):
            planted = forward_gap(forward_outputs(card_im, image, ROBERTA_CAPTION), cpu)
    finally:
        msda._msda_fwd_cuda = fwd
    log("roberta-forward", f"planted fault, K1 output negated: flipped {planted[0]:.1%}, bulk "
                           f"max|dlogit| {planted[1]:.3e}, bulk max|dbox| {planted[2]:.3e}")
    if planted[3]:
        raise AssertionError("the RoBERTa forward comparison passes with K1's output negated")
    res["planted_k1"] = planted[:3]
    return res


def roberta_pseudo_gt(im, work: str) -> str:
    """A COCO val split of EVAL_PARITY_IMAGES whose ground truth is the
    served model's own bf16 detections (make_eval_step + PostProcess, NMS
    PSEUDO_GT_NMS, pseudo_ground_truth); returns its manifest."""
    import torch

    from open_groundingdino_tpu_torch.data.coco import CocoDetection
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.transforms import EvalTransform
    from open_groundingdino_tpu_torch.models.postprocess import PostProcess

    args = im.args
    write_odvg(work)
    with open(write_coco_val(work, EVAL_PARITY_IMAGES, name="roberta_parity")) as f:
        anno = json.load(f)["val"][0]["anno"]
    ds = CocoDetection(os.path.join(work, "odvg"), anno,
                       transform=EvalTransform(args.eval_shortest_edge, args.eval_max_size))
    batch = Collator(im.tokenizer, args.image_buckets, int(args.max_text_len),
                     int(args.max_gt_boxes), u8_images=True)([ds[i] for i in range(len(ds))])
    post = PostProcess(im.tokenizer, ds.cat_list, num_select=PSEUDO_GT_NUM_SELECT,
                       max_text_len=int(args.max_text_len), nms_iou_threshold=PSEUDO_GT_NMS)
    _, res = eval_detections(im.model, batch, post, torch.bfloat16)
    pseudo = pseudo_ground_truth(res, batch["image_ids"].tolist(), ds.contiguous_to_catid)
    log("roberta-zero-shot", f"pseudo ground truth: the served model's top "
                             f"{sum(map(len, pseudo.values()))} bf16 detections of "
                             f"{len(EVAL_PARITY_IMAGES)} images after NMS {PSEUDO_GT_NMS}")
    return write_coco_val(work, EVAL_PARITY_IMAGES, annotations=pseudo, name="roberta_gt")


ZERO_SHOT_OPTIONS = ("batch_size=4", f"nms_iou_threshold={PSEUDO_GT_NMS}",
                     f"num_select={PSEUDO_GT_NUM_SELECT}")


def run_zero_shot(argv, out: str) -> None:
    """Phase 32 (c)'s process: tools/zero_shot_eval.py's main on `argv`
    (TF32 off, as the smoke), then its launches, its native matches and
    whether the matcher's library exists, into `out` (JSON)."""
    import torch

    from open_groundingdino_tpu_torch.tools import zero_shot_eval
    from open_groundingdino_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    t0 = time.perf_counter()
    stats = zero_shot_eval.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"stats": stats, "seconds": time.perf_counter() - t0, "counts": read_counts(),
                   "native_calls": native.coco_greedy_match.calls,
                   "native_lib": os.path.exists(native.lib_path("coco_match"))}, f)


def start_zero_shot(files, manifest: str, work: str, device: str = "cuda") -> tuple:
    """run_zero_shot on the pseudo ground truth's val split with --debug, in
    a fresh process; returns ((process, start time), result path)."""
    cfg, ckpt, vocab = files
    with open(manifest) as f:
        val = json.load(f)["val"][0]
    out = os.path.join(work, "zero_shot_result.json")
    argv = ["--checkpoint", ckpt, "--vocab", vocab, "--images", val["root"], "--annotations",
            val["anno"], "--config", cfg, "--output_dir", os.path.join(work, "zero_shot_out"),
            "--num_workers", "2", "--debug", "--device", device,
            "--options", *ZERO_SHOT_OPTIONS]
    code = f"import chip_smoke; chip_smoke.run_zero_shot({argv!r}, {out!r})"
    return (subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), time.perf_counter()), out


def check_zero_shot(started, out: str, files, manifest: str, work: str,
                    device: str = "cuda") -> dict:
    """Phase 32 (c): the zero-shot tool's process (start_zero_shot) prints the
    12 summary rows and the JSON line of its stats, AP in (0, 1], launches
    12 K1 + 6 K2 bf16 a batch and nothing else, and matched in C++ (its
    library built and called); its numbers within ZERO_SHOT_TOL of main
    --eval --debug in this process on the same checkpoint and split with the
    numpy matcher (run_eval(use_native=False); the C++ matcher's pass beside
    it)."""
    from open_groundingdino_tpu_torch.utils import native

    text, wall = finish(started, "zero-shot")
    with open(out) as f:
        child = json.load(f)
    lines = text.strip().splitlines()
    rows = [line for line in lines if line.startswith(" Average ")]
    printed = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
    eval_s = next((float(line.split("Eval done in ")[1].split()[0]) for line in lines
                   if "Eval done in " in line), float("nan"))
    n_images = len(EVAL_PARITY_IMAGES)
    want = eval_launches(-(-n_images // 4), bf16=True)
    cfg, ckpt, vocab = files
    calls = native.coco_greedy_match.calls
    run = run_main(cfg, manifest, files, os.path.join(work, "zero_shot_main"), "--eval",
                   "--debug", options=ZERO_SHOT_OPTIONS[1:], device=device)
    in_native = run["stats"]
    in_numpy = run["run_eval"](dict(run["model"].named_parameters()), use_native=False)
    gap = max(abs(printed[k] - in_numpy[k]) for k in STAT_KEYS)
    in_calls = native.coco_greedy_match.calls - calls
    log("roberta-zero-shot", f"tools/zero_shot_eval.py --debug in a fresh process: {wall:.1f} s "
                             f"of process, its eval pass {eval_s:.2f} s ({n_images / eval_s:.2f} "
                             f"images/s, B=4, bf16); {len(rows)} summary rows; stats {printed}; "
                             f"launches { {k: v for k, v in child['counts'].items() if v} }; "
                             f"C++ matches {child['native_calls']} (library built: "
                             f"{child['native_lib']}); in-process main --eval --debug: C++ "
                             f"matcher AP {in_native['AP']:.6f} ({in_calls} matches), numpy "
                             f"matcher AP {in_numpy['AP']:.6f}; max |tool - "
                             f"numpy| over the 12 stats {gap:.2e} (limit {ZERO_SHOT_TOL})")
    if len(rows) != 12 or printed != child["stats"] or set(printed) != set(STAT_KEYS):
        raise AssertionError(f"zero_shot_eval printed {len(rows)} rows and {printed}")
    if not 0.0 < printed["AP"] <= 1.0:
        raise AssertionError(f"zero-shot AP {printed['AP']} on the pseudo ground truth")
    if child["counts"] != want:
        raise AssertionError(f"zero-shot eval launches {child['counts']}, expected {want}")
    if not (child["native_lib"] and child["native_calls"] > 0):
        raise AssertionError("the zero-shot eval did not match in C++")
    if not gap <= ZERO_SHOT_TOL:
        raise AssertionError(f"the zero-shot tool is {gap:.2e} off the in-process eval")
    return dict(stats=printed, counts=child["counts"], process_s=wall, eval_s=eval_s,
                images_per_s=n_images / eval_s, native_calls=child["native_calls"],
                in_process_numpy=in_numpy, in_process_native=in_native, gap=gap)


def dropout_losses(model, run, cfg: str, seeds) -> dict:
    """The training-mode loss (the train step's bf16 forward and criterion,
    no update) of `model` on the first batch of the training run's first
    epoch, once with the step generator seeded by each of `seeds`; and on
    the first, the share of the text embeddings' output that dropout
    zeroed."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.models.criterion import build_criterion
    from open_groundingdino_tpu_torch.parallel.train_state import (
        MODEL_INPUT_KEYS, cast_floating, maybe_device_normalize, swapped_parameters, to_device)

    criterion = build_criterion(SLConfig.fromfile(cfg))
    run["loader"].set_epoch(0)
    batches = iter(run["loader"])
    batch = next(batches)
    batches.close()
    t = to_device(batch, next(model.parameters()).device)
    inputs = {k: t[k] for k in MODEL_INPUT_KEYS}
    inputs["images"] = maybe_device_normalize(inputs["images"], inputs["image_sizes"]).to(
        torch.bfloat16)
    seen = {}

    def hook(mod, inp, out):
        if "share" not in seen:
            live = inp[0] != 0
            seen["share"] = float(((out == 0) & live).sum()) / float(live.sum())
            seen["n"] = int(live.sum())

    handle = model.bert.embeddings.dropout.register_forward_hook(hook)
    losses = []
    model.train()
    try:
        with torch.no_grad(), swapped_parameters(
                model, cast_floating(dict(model.named_parameters()), torch.bfloat16)):
            for seed in seeds:
                out = model(**inputs, generator=torch.Generator().manual_seed(seed))
                total, _ = criterion(out, t["gt_boxes"], t["gt_pos_maps"], t["gt_valid"])
                losses.append(float(total))
    finally:
        handle.remove()
        model.eval()
    return dict(losses=losses, **seen)


def train_roberta(files, work: str, model, device: str = "cuda") -> dict:
    """Phase 32 (b): main with the RoBERTa checkpoint and BPE vocabulary,
    text_dropout TEXT_DROPOUT, in the default bf16 at B = 4: one epoch of 2
    steps (train(): 12 K1 + 6 K2 + 12 K3 + 6 K4 bf16 a step and no other,
    each loss finite); then `model`, the served model on the same
    checkpoint, gives the first step's loss on the run's first batch with
    the step generator seeded SEED as main's is (within DROPOUT_LOSS_RTOL),
    twice, and another loss seeded SEED + 1; the embeddings' dropped share
    lies within DROPOUT_SIGMAS sigma of TEXT_DROPOUT."""
    cfg = files[0]
    run = train(cfg, work, files, device, {"text_dropout": TEXT_DROPOUT}, epochs=1,
                tag="roberta-train", compute_dtype=None)
    drop = dropout_losses(model, run["run"], cfg, (SEED, SEED, SEED + 1))
    first = run["losses"][0]
    a, b, c = drop["losses"]
    sigma = (TEXT_DROPOUT * (1 - TEXT_DROPOUT) / drop["n"]) ** 0.5
    rel = max(abs(a - first), abs(b - first)) / abs(first)
    log("roberta-train", f"the first step's loss {first:.6f}; the same forward on the "
                         f"checkpoint with the step generator seeded {SEED}, {SEED}, {SEED + 1}: "
                         f"{a:.6f}, {b:.6f}, {c:.6f} (seed {SEED} against the step: relative "
                         f"{rel:.1e}, limit {DROPOUT_LOSS_RTOL}); embeddings dropout zeroed "
                         f"{drop['share']:.4f} of {drop['n']} activations "
                         f"({(drop['share'] - TEXT_DROPOUT) / sigma:+.2f} sigma of {TEXT_DROPOUT})")
    if not rel <= DROPOUT_LOSS_RTOL:
        raise AssertionError(f"dropout seed {SEED} gave losses {a}, {b}; the first step {first}")
    if c == a:
        raise AssertionError("another dropout seed gave the same loss")
    if not abs(drop["share"] - TEXT_DROPOUT) <= DROPOUT_SIGMAS * sigma:
        raise AssertionError(f"text dropout zeroed {drop['share']} of the embeddings")
    run.pop("run")
    return dict(run, dropout=drop)


def check_roberta(cfg: str, work: str, device: str = "cuda") -> dict:
    """Phase 32: the RoBERTa text encoder at full width.  (a) serving
    (serve_roberta) and the depth-cut forward against the CPU
    (check_roberta_forward); (c) the zero-shot tool in a fresh process on a
    pseudo ground truth of the served model's detections, held against main
    --eval in this process (check_zero_shot); (b) training with text dropout
    (train_roberta; its first step's loss held against the served model's
    on the same batch and generator seed)."""
    import torch

    files = roberta_files(cfg, work)
    image = synthetic_image(*IMAGE_SIZES[0], 0)
    serve_res = serve_roberta(files, image, device)
    im = serve_res.pop("im")
    manifest = roberta_pseudo_gt(im, work)
    started, out = start_zero_shot(files, manifest, work, device)
    try:
        forward = check_roberta_forward(files, work, image, device)
    except BaseException:
        started[0].kill()
        started[0].wait()
        raise
    gc.collect()
    torch.cuda.empty_cache()
    zero_shot = check_zero_shot(started, out, files, manifest, work, device)
    training = train_roberta(files, work, im.model, device)
    return dict(serve=serve_res, forward=forward, zero_shot=zero_shot, train=training)


# ------------------------------------------------------------ data parallel (phase 33)
DIST_WORLD = 2
DIST_BATCH = 2               # a rank's batch: (b) takes the global B = DIST_WORLD x DIST_BATCH
DIST_SIZE = (800, 1066)      # (h, w) of every image: each sample pads to the 800x1216 bucket
DIST_STEPS = 2
DIST_TIMEOUT_S = 300         # a rank's process, and its process group's collectives
# the steps' learning rates: at the config's (1e-4, backbone 1e-5) two Adam
# steps move every parameter of the random-weight model by ~lr and leave none
# of its initial detections (AP 0 on their pseudo ground truth: H100 run);
# at these the eval still scores them, and Adam's steps are as large
# relative to lr, so the updates compare as well
DIST_LR, DIST_LR_BACKBONE = 1e-7, 1e-8
# (a)'s loss at each step against (b)'s: the two run the same images and
# weights, the 2 ranks at B = 2 each and (b) at B = 4 (other GEMM shapes, K3's
# atomics in another order, the matcher on their output): the card-vs-CPU
# step bound (phase 11)
DIST_LOSS_RTOL = PARITY_LOSS_RTOL
# ||update_a - update_b|| / ||update_b||, each update the parameters after the
# 2 steps minus the checkpoint's: Adam moves each parameter by about lr
# whatever the size of its gradient, so a gradient that is zero up to
# rounding (the attention key biases) takes a step of noise on either side
DIST_UPDATE_RTOL = 5e-2
# each of the 12 COCO stats, (a)'s merged eval against (b)'s: the same
# images in the same bucket on nearly the same weights; one near-tied box
# swapped among the ~55 ground-truth boxes moves AP by up to ~0.02
DIST_STAT_TOL = 0.05
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_files(cfg: str, work: str, files, size=DIST_SIZE, device: str = "cuda") -> tuple:
    """Phase 33's data: 8 seeded images of one size (`size`) with one
    category each (captions that do not hang on string hashing) as an ODVG
    train split, and a COCO val split of them whose ground truth is, for the
    even ids, `files`' checkpoint's own detections on the card (f32, NMS
    PSEUDO_GT_NMS, pseudo_ground_truth) and, for the odd ids, the ODVG boxes
    (AP ~0 at these weights): a rank that scores only its own half moves
    the stats.  Returns (manifest, main's --options for these images)."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.coco import CocoDetection
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import EvalTransform
    from open_groundingdino_tpu_torch.inference import load_reference_state_dict
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
    from open_groundingdino_tpu_torch.models.postprocess import PostProcess

    _, ckpt, vocab = files
    args = SLConfig.fromfile(cfg)
    n = 4 * DIST_WORLD
    write_odvg(work, sizes=[size] * n, subdir="dist", one_label=True)
    with open(write_coco_val(work, range(n), name="dist_odvg", subdir="dist")) as f:
        anno = json.load(f)["val"][0]["anno"]
    ds = CocoDetection(os.path.join(work, "dist"), anno,
                       transform=EvalTransform(args.eval_shortest_edge, args.eval_max_size))
    tokenizer = build_tokenizer(vocab)
    collate = Collator(tokenizer, args.image_buckets, int(args.max_text_len),
                       int(args.max_gt_boxes), u8_images=True)
    num_select = int(args.num_queries) * len(CATEGORIES)
    post = PostProcess(tokenizer, ds.cat_list, num_select=num_select,
                       max_text_len=int(args.max_text_len), nms_iou_threshold=PSEUDO_GT_NMS)
    t0 = time.perf_counter()
    model = build_groundingdino(args, device="cpu")
    load_reference_state_dict(model, ckpt)
    model.to(device)
    t_model = time.perf_counter() - t0
    results, ids = [], []
    for start in range(0, n, 4):
        batch = collate([ds[i] for i in range(start, start + 4)])
        results += eval_detections(model, batch, post, None)[1]
        ids += batch["image_ids"].tolist()
    del model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    pseudo = pseudo_ground_truth(results, ids, ds.contiguous_to_catid)
    with open(anno) as f:
        odvg = json.load(f)["annotations"]
    truth = {i: pseudo[i] if (i - 100) % 2 == 0 else
             [(a["category_id"], a["bbox"]) for a in odvg if a["image_id"] == i] for i in ids}
    manifest = write_coco_val(work, range(n), annotations=truth, name="dist_val", subdir="dist")
    scale = size[0]
    options = (f"data_aug_scales=[{scale}]", f"data_aug_scales2_resize=[{scale}]",
               f"data_aug_scales2_crop=[{scale},{scale}]", "epochs=1", "compute_dtype=float32",
               f"lr={DIST_LR}", f"lr_backbone={DIST_LR_BACKBONE}",
               f"nms_iou_threshold={PSEUDO_GT_NMS}", f"num_select={num_select}")
    log("dist-data", f"{n} images of {size[0]}x{size[1]}, one category each; ground truth: "
                     f"{sum(len(truth[i]) for i in ids[::2])} pseudo boxes on the even ids, "
                     f"{sum(len(truth[i]) for i in ids[1::2])} ODVG boxes on the odd ids; the "
                     f"model built and loaded in {t_model:.1f} s")
    return manifest, options


@contextlib.contextmanager
def evaluated_ids():
    """Within the block, the image ids each CocoBboxEvaluator.accumulate()
    sees, one list a call."""
    from open_groundingdino_tpu_torch.eval import coco_eval

    seen = []
    accumulate = coco_eval.CocoBboxEvaluator.accumulate

    def spy(self):
        seen.append(list(self.img_ids))
        return accumulate(self)

    coco_eval.CocoBboxEvaluator.accumulate = spy
    try:
        yield seen
    finally:
        coco_eval.CocoBboxEvaluator.accumulate = accumulate


def dist_main(cfg: str, manifest: str, files, out_dir: str, device: str, batch: int,
              options) -> tuple:
    """main at `batch` a rank for DIST_STEPS steps and the eval of the val
    split, its training epoch inside torch.profiler, with spies on the
    evaluator's image ids, the checkpoint writes and the eval pass's
    seconds; returns (main's result, a record of the run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from open_groundingdino_tpu_torch import engine
    from open_groundingdino_tpu_torch import main as train_main
    from open_groundingdino_tpu_torch.utils import checkpoint as ckpt

    _, weights, vocab = files
    cli = train_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", out_dir, "--vocab", vocab,
        "--pretrain_model_path", weights, "--device", device, "--seed", str(SEED),
        "--num_workers", "2", "--print_freq", "1", "--max_steps", str(DIST_STEPS),
        "--options", f"batch_size={batch}", *options])
    saves, eval_s, profiles = [], [], []
    save, link = ckpt.save_checkpoint, ckpt.link_checkpoint
    evaluate, epoch_fn = engine.evaluate_coco, engine.train_one_epoch

    def spy_epoch(*args, **kw):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = epoch_fn(*args, **kw)
        profiles.append(prof)
        return out

    def spy_save(ckpt_dir, epoch, payload):
        saves.append(os.path.relpath(ckpt.checkpoint_path(ckpt_dir, epoch), out_dir))
        return save(ckpt_dir, epoch, payload)

    def spy_link(src, ckpt_dir, epoch):
        saves.append(os.path.relpath(ckpt.checkpoint_path(ckpt_dir, epoch), out_dir) + " (link)")
        return link(src, ckpt_dir, epoch)

    def spy_evaluate(*args, **kw):
        t0 = time.perf_counter()
        stats = evaluate(*args, **kw)
        eval_s.append(time.perf_counter() - t0)
        return stats

    ckpt.save_checkpoint, ckpt.link_checkpoint = spy_save, spy_link
    engine.evaluate_coco, engine.train_one_epoch = spy_evaluate, spy_epoch
    reset_counts()
    try:
        with evaluated_ids() as covered:
            t0 = time.perf_counter()
            run = train_main.main(cli)
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ckpt.save_checkpoint, ckpt.link_checkpoint = save, link
        engine.evaluate_coco, engine.train_one_epoch = evaluate, epoch_fn
    prof, = profiles
    counts = read_counts()
    records = run["records"]
    with open(os.path.join(out_dir, "log.txt")) as f:
        log_lines = len(f.read().splitlines())
    return run, dict(
        losses=[r["loss"] for r in records], grad_norms=[r["grad_norm"] for r in records],
        step_s=[r["step_seconds"] for r in records], stats=run["eval"][0], counts=counts,
        covered=covered, saves=saves, eval_s=eval_s, wall_s=wall,
        reduce_ms=host_spans_ms(prof, "ogd_torch::all_reduce_sum"),
        nccl_device_ms=sum(ms for name, (ms, _) in device_kernels(prof).items()
                           if "nccl" in name.lower()),
        log_lines=log_lines)


@contextlib.contextmanager
def criterion_inputs():
    """Within the block, (criterion, its arguments detached) of every
    SetCriterion call made with gradients on (the training steps'), in
    order."""
    import torch

    from open_groundingdino_tpu_torch.models import criterion

    seen = []
    call = criterion.SetCriterion.__call__

    def detached(x):
        if isinstance(x, torch.Tensor):
            return x.detach()
        if isinstance(x, dict):
            return {k: detached(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(detached(v) for v in x)
        return x

    def spy(self, *args):
        if torch.is_grad_enabled():
            seen.append((self, detached(args)))
        return call(self, *args)

    criterion.SetCriterion.__call__ = spy
    try:
        yield seen
    finally:
        criterion.SetCriterion.__call__ = call


def dist_worker(spec: dict) -> None:
    """Phase 33 (a)'s rank (its process started with torchrun's variables):
    TF32 off, the process group over gloo on spec["device"] (both ranks on
    cuda:0), dist_main at DIST_BATCH, the ranks' parameter digests gathered;
    then in the same group the planted faults: each step's loss again from
    the criterion inputs that step saw with the count reduction removed
    (per-rank num_boxes / num_pos; the ranks' totals summed as the step sums
    them), the eval again with merge_eval_records skipped, and one more step
    on this rank's next batch with the gradient reduction replaced by
    identity, the digests gathered again.  Writes its record to spec["out"]
    (JSON)."""
    import types

    import torch

    from open_groundingdino_tpu_torch import engine
    from open_groundingdino_tpu_torch.models import criterion
    from open_groundingdino_tpu_torch.parallel import dist, train_state

    started = time.time() - spec["spawned"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = dist.init_distributed(spec["device"], "gloo", timeout_s=DIST_TIMEOUT_S)
    with criterion_inputs() as calls:
        run, rec = dist_main(spec["cfg"], spec["manifest"], spec["files"], spec["out_dir"],
                             spec["device"], DIST_BATCH, spec["options"])
    t0 = time.perf_counter()
    params = dict(run["state"].model.named_parameters())
    rec["digests"] = dist.all_gather_object(dist.digest(params.values()))
    criterion.dist = types.SimpleNamespace(all_reduce_sum_=lambda tensors: None)
    try:
        with torch.no_grad():
            mine = [float(crit(*args)[0]) for crit, args in calls]
    finally:
        criterion.dist = dist
    rec["per_rank_count_losses"] = [sum(x) for x in zip(*dist.all_gather_object(mine))]
    merge = engine.merge_eval_records
    engine.merge_eval_records = lambda evaluator: None
    try:
        with evaluated_ids() as covered:
            rec["unmerged_stats"] = run["run_eval"](params)
    finally:
        engine.merge_eval_records = merge
    rec["unmerged_covered"] = covered
    batches = iter(run["loader"])
    batch = next(batches)
    batches.close()   # stops the loader's threads
    train_state.dist = types.SimpleNamespace(all_reduce_sum_=lambda tensors: None)
    try:
        run["train_step"](run["state"], batch)
    finally:
        train_state.dist = dist
    rec["fault_digests"] = dist.all_gather_object(dist.digest(params.values()))
    rec.update(rank=info.rank, world_size=info.world_size, device=str(info.device),
               start_s=started, after_main_s=time.perf_counter() - t0)
    dist.cleanup()
    with open(spec["out"], "w") as f:
        json.dump(rec, f)


def start_dist_workers(spec: dict, work: str) -> list:
    """dist_worker in DIST_WORLD fresh processes, each in a session of its
    own (killed with its children on failure); returns [(process, record
    path)]."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    started = []
    for r in range(DIST_WORLD):
        out = os.path.join(work, f"dist_rank{r}.json")
        code = (f"import chip_smoke; "
                f"chip_smoke.dist_worker({dict(spec, out=out, spawned=time.time())!r})")
        started.append((subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True), out))
    return started


def finish_dist_workers(started) -> list:
    """Each worker's record; on a failure or after DIST_TIMEOUT_S every
    worker is killed and the phase fails with their output's ends."""
    import signal

    deadline = time.monotonic() + DIST_TIMEOUT_S
    outs = []
    try:
        for proc, _ in started:
            outs.append(proc.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except BaseException:
        for proc, _ in started:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        raise
    bad = [(r, proc.returncode, out[-3000:])
           for r, ((proc, _), out) in enumerate(zip(started, outs)) if proc.returncode != 0]
    if bad:
        raise AssertionError(f"dist workers failed: {bad}")
    records = []
    for _, path in started:
        with open(path) as f:
            records.append(json.load(f))
    return records


def dist_reference(cfg: str, manifest: str, files, out_dir: str, device: str,
                   options) -> dict:
    """Phase 33 (b): dist_main in this process as rank 0 of 1 over the
    default backend (NCCL on the card), at the global batch."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        run, rec = dist_main(cfg, manifest, files, out_dir, device, DIST_WORLD * DIST_BATCH,
                             options)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del run
    return rec


def update_gap(init_ckpt: str, a_ckpt: str, b_ckpt: str) -> float:
    """||(a - init) - (b - init)|| / ||b - init|| over the floating tensors
    of the checkpoints' models."""
    import torch

    load = lambda p: torch.load(p, map_location="cpu", weights_only=True, mmap=True)["model"]
    init, a, b = load(init_ckpt), load(a_ckpt), load(b_ckpt)
    diff = ref = 0.0
    for k, v in init.items():
        if v.is_floating_point():
            ub = b[k].double() - v.double()
            diff += float(((a[k].double() - v.double()) - ub).pow(2).sum())
            ref += float(ub.pow(2).sum())
    return math.sqrt(diff) / max(math.sqrt(ref), 1e-30)


def check_dist(cfg: str, work: str, files, device: str = "cuda", size=DIST_SIZE) -> dict:
    """Phase 33: data parallelism through the port's main on the one card.
    (a) DIST_WORLD ranks over gloo, each on cuda:0 in a fresh process
    (dist_worker), DIST_STEPS steps at B = DIST_BATCH a rank and the eval of
    the 8-image val split (dist_files); (b) main in this process as rank 0 of
    1 over NCCL at the global batch on the same steps and eval.  Held: the
    ranks' parameters equal bit for bit, and parted by a step without the
    gradient reduction; both ranks' losses and stats the same; each step's
    loss within DIST_LOSS_RTOL of (b)'s, and not so with per-rank counts in
    the criterion, the update within DIST_UPDATE_RTOL
    and each stat within DIST_STAT_TOL; rank 0 alone wrote the checkpoint
    (best/ a link to it) and log.txt's one line; every eval saw the 8 ids
    once, and with the merge skipped each rank its 4 and stats that move by
    more than DIST_STAT_TOL; each rank's and (b)'s launches exactly the f32
    training steps' and eval batches'."""
    import torch

    t_phase = time.perf_counter()
    manifest, options = dist_files(cfg, work, files, size, device)
    t_data = time.perf_counter() - t_phase
    rank_device = "cuda:0" if device == "cuda" else device
    dirs = {tag: os.path.join(work, f"dist_{tag}") for tag in ("a", "b")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = finish_dist_workers(start_dist_workers(
        dict(cfg=cfg, manifest=manifest, files=list(files), out_dir=dirs["a"],
             device=rank_device, options=list(options)), work))
    t_a = time.perf_counter() - t0
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = dist_reference(cfg, manifest, files, dirs["b"], device, options)
    t_b = time.perf_counter() - t0
    gap = update_gap(files[1], *(os.path.join(dirs[t], "checkpoint_0.pth") for t in ("a", "b")))
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)   # checkpoints of ~2 GB each

    n = 4 * DIST_WORLD
    ids = list(range(100, 100 + n))
    per_rank = -(-n // DIST_WORLD)
    step = train_launches_per_step({})
    evals = eval_launches(-(-per_rank // DIST_BATCH), False)
    want = {k: DIST_STEPS * v + evals[k] for k, v in step.items()}
    evals = eval_launches(-(-n // (DIST_WORLD * DIST_BATCH)), False)
    want_b = {k: DIST_STEPS * v + evals[k] for k, v in step.items()}
    a0 = ranks[0]
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(a0["losses"], ref["losses"]))
    stat_gap = max(abs(a0["stats"][k] - ref["stats"][k]) for k in STAT_KEYS)
    moved = min(max(abs(r["unmerged_stats"][k] - a0["stats"][k]) for k in STAT_KEYS)
                for r in ranks)
    # per-rank counts: the ranks' totals summed, and their mean (the form a
    # normaliser averaged over the ranks would give)
    count_gap = max(abs(x - y) / abs(y) for x, y in zip(a0["per_rank_count_losses"],
                                                         ref["losses"]))
    count_mean_gap = max(abs(x / DIST_WORLD - y) / abs(y)
                         for x, y in zip(a0["per_rank_count_losses"], ref["losses"]))
    # the reduction's host time a step: each step calls it twice (the
    # criterion's counts, then the gradients and losses)
    red = [sum(a0["reduce_ms"][2 * i:2 * i + 2]) for i in range(DIST_STEPS)]
    share = [r / 1e3 / s for r, s in zip(red, a0["step_s"])]
    t_phase = time.perf_counter() - t_phase
    log("dist", f"(a) {DIST_WORLD} ranks over gloo on {rank_device}, B = {DIST_BATCH} a rank, "
                f"f32: losses {a0['losses']}, step s {[round(x, 3) for x in a0['step_s']]} "
                f"(median {statistics.median(a0['step_s']):.3f}), gradient reduction host ms "
                f"a step {[round(x, 1) for x in red]} ({[f'{x:.0%}' for x in share]} of the "
                f"step), "
                f"eval {a0['eval_s'][0]:.2f} s ({n / a0['eval_s'][0]:.2f} images/s merged), "
                f"s by rank to reach dist_worker {[round(r['start_s'], 1) for r in ranks]}, "
                f"in main {[round(r['wall_s'], 1) for r in ranks]}, after it (digests, faults) "
                f"{[round(r['after_main_s'], 1) for r in ranks]}; launches a rank "
                f"{ {k: v for k, v in a0['counts'].items() if v} }; saves by rank "
                f"{[r['saves'] for r in ranks]}, log.txt lines {a0['log_lines']}; digests "
                f"{[d[:12] for d in a0['digests']]}, after a step without the reduction "
                f"{[d[:12] for d in a0['fault_digests']]}")
    log("dist", f"(b) 1 rank over the default backend ({'NCCL' if device == 'cuda' else 'gloo'}),"
                f" B = {DIST_WORLD * DIST_BATCH}: losses {ref['losses']}, step s "
                f"{[round(x, 3) for x in ref['step_s']]} (median "
                f"{statistics.median(ref['step_s']):.3f}), "
                f"reduction host ms {[round(x, 2) for x in ref['reduce_ms']]}, NCCL device ms "
                f"{ref['nccl_device_ms']:.3f}, eval {ref['eval_s'][0]:.2f} s "
                f"({n / ref['eval_s'][0]:.2f} images/s); launches "
                f"{ {k: v for k, v in ref['counts'].items() if v} }")
    log("dist", f"(a) against (b): loss {loss_gap:.2e} (limit {DIST_LOSS_RTOL}), update "
                f"{gap:.2e} (limit {DIST_UPDATE_RTOL}), stats {stat_gap:.4f} (limit "
                f"{DIST_STAT_TOL}): (a) {a0['stats']}, (b) {ref['stats']}; per-rank counts: "
                f"losses {a0['per_rank_count_losses']}, loss {count_gap:.2e} (their mean "
                f"{count_mean_gap:.2e}); merge skipped: ids "
                f"{[len(set(r['unmerged_covered'][0])) for r in ranks]} a rank, stats moved by "
                f">= {moved:.4f}; seconds: data {t_data:.1f}, (a) {t_a:.1f}, (b) {t_b:.1f}, "
                f"phase {t_phase:.1f}")
    for r, rec in enumerate(ranks):
        if (rec["rank"], rec["world_size"], rec["device"]) != (r, DIST_WORLD, rank_device):
            raise AssertionError(f"rank {r} ran as {rec['rank']} of {rec['world_size']} on "
                                 f"{rec['device']}")
        if rec["counts"] != want:
            raise AssertionError(f"rank {r}: launches {rec['counts']}, expected {want}")
        if rec["losses"] != a0["losses"] or rec["stats"] != a0["stats"]:
            raise AssertionError("the ranks logged other losses or stats")
        if [sorted(c) for c in rec["covered"]] != [ids]:
            raise AssertionError(f"rank {r}'s merged eval saw ids {rec['covered']}")
        if len(set(rec["unmerged_covered"][0])) != per_rank:
            raise AssertionError(f"rank {r} without the merge saw {rec['unmerged_covered']}")
    if len(set(a0["digests"])) != 1:
        raise AssertionError(f"the ranks' parameters differ: {a0['digests']}")
    if len(set(a0["fault_digests"])) != DIST_WORLD:
        raise AssertionError("a step without the gradient reduction left the ranks equal")
    rank0_writes = ["checkpoint_0.pth", os.path.join("best", "checkpoint_0.pth") + " (link)"]
    if a0["saves"] != rank0_writes or any(r["saves"] for r in ranks[1:]) or a0["log_lines"] != 1:
        raise AssertionError(f"writes by rank {[r['saves'] for r in ranks]}, log.txt lines "
                             f"{a0['log_lines']}")
    if ref["counts"] != want_b or [sorted(c) for c in ref["covered"]] != [ids]:
        raise AssertionError(f"(b): launches {ref['counts']} (expected {want_b}), ids "
                             f"{ref['covered']}")
    if not loss_gap <= DIST_LOSS_RTOL or not gap <= DIST_UPDATE_RTOL or \
            not stat_gap <= DIST_STAT_TOL:
        raise AssertionError("(a) is off (b)")
    if not moved > DIST_STAT_TOL:
        raise AssertionError("the stats hold without the eval merge")
    if len(a0["per_rank_count_losses"]) != DIST_STEPS or not count_gap > DIST_LOSS_RTOL:
        raise AssertionError(f"per-rank counts pass the loss limit: "
                             f"{a0['per_rank_count_losses']} against {ref['losses']}")
    return dict(ranks=ranks, reference=ref, update_gap=gap, loss_gap=loss_gap,
                stat_gap=stat_gap, unmerged_moved=moved, count_gap=count_gap,
                count_mean_gap=count_mean_gap, reduce_share=share,
                seconds=dict(data=t_data, a=t_a, b=t_b, phase=t_phase))


# ---------------------------------------------------------------- ops with autograd, the tools (phase 34)
# small operands in the kernels' geometry: D = 32, P = 4, four levels (the
# 128x192 bucket's), a decoder-like query set the sweep sorts; the fusion's
# head dim 256
OPCHECK_LEVELS = ((16, 24), (8, 12), (4, 6), (2, 3))
OPCHECK_QUERIES = 40


def op_cases(dtype, device) -> dict:
    """Each ogd_torch op's operands at small shapes on `device`, value (and
    the upstream gradients) in `dtype`, the forwards' differentiable
    operands requiring a gradient, as the model hands them over."""
    import torch

    from open_groundingdino_tpu_torch.ops import fusion, library, msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    g = torch.Generator(device="cpu").manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=g)   # noqa: E731
    shapes = OPCHECK_LEVELS
    L, Q = sum(h * w for h, w in shapes), OPCHECK_QUERIES
    value = rand(1, L, 2, HEAD_DIM).to(device, dtype)
    locs = (torch.rand(1, Q, 2, len(shapes), POINTS, 2, generator=g) * 1.2 - 0.1).to(device)
    attn = torch.rand(1, Q, 2, len(shapes), POINTS, generator=g).to(device)
    flat, starts = library.flat_shapes(shapes), list(msda.level_starts(shapes))
    E = 2 * 256
    q, k, vv, vl = (rand(1, n, E).mul(0.05).to(device, dtype) for n in (40, 8, 40, 8))
    mask_v = (torch.arange(40) >= 36)[None].to(device)
    mask_l = (torch.arange(8) >= 5)[None].to(device)
    order, _, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
    row, tpx, w = sw.rowtap_positions_and_weights(*sw.kernel_layout(locs, attn), shapes)
    rorder = sw.query_order(row, tpx, L)
    row, tpx, w = (sw.sort_and_pad(t, rorder) for t in (row, tpx, w))
    idx, cw = sw.corner_indices_and_weights(*sw.kernel_layout(locs, attn), shapes)
    corder = sw.query_order(idx, None, L)
    idx, cw = (sw.sort_and_pad(t, corder) for t in (idx, cw))
    with torch.no_grad():
        fo = fusion.fusion_fwd(q, k, vv, vl, mask_v, mask_l, 2)
    g_msda = rand(1, Q, 2 * HEAD_DIM).to(device, dtype)
    g_taps = rand(2, w.shape[-1], HEAD_DIM).to(device, dtype)
    g_fus = [rand(*t.shape).to(device, dtype) for t in fo[:2]]
    grad = lambda t: t.detach().clone().requires_grad_(True)   # noqa: E731
    return {
        "msda_fwd": (grad(value), flat, starts, grad(locs), grad(attn)),
        "msda_bwd": (value, flat, starts, locs, attn, g_msda),
        "fusion_fwd": (grad(q), grad(k), grad(vv), grad(vl), mask_v, mask_l, 2),
        "fusion_bwd": (q, k, vv, vl, mask_v, mask_l, *fo, *g_fus, 2),
        "banded_fwd": (grad(value), flat, px, py, wa, grad(locs), grad(attn), order),
        "sweep_fwd": (grad(value), flat, row, grad(tpx), grad(w), "corner"),
        "sweep_fwd_allq": (grad(value), flat, row, grad(tpx), grad(w), "rowtap"),
        "sweep_fwd_corner": (grad(value), flat, idx, grad(cw)),
        "sweep_bwd_corner": (value, flat, idx, cw, g_taps),
        "sweep_bwd_rowtap": (value, flat, row, tpx, w, g_taps),
        # the matcher's costs: f32 whatever the compute dtype, few valid GT
        "lsap": (rand(4, OPCHECK_QUERIES, 16).to(device),
                 (torch.rand(4, 16, generator=g) > 0.6).to(device)),
    }


def check_opcheck(device: str = "cuda") -> dict:
    """torch.library.opcheck of every ogd_torch op on CUDA tensors, f32 and
    bf16: schema, the fake implementation against the kernel, the registered
    autograd (the forwards' operands require a gradient, so their backward
    kernels run), dispatch under AOT tracing.  Raises on any failure."""
    import torch

    from open_groundingdino_tpu_torch.ops import library

    ops = library.custom_ops()
    seconds = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = op_cases(dtype, device)
        if set(cases) != set(ops):
            raise AssertionError(f"opcheck cases {sorted(cases)} against the ops {sorted(ops)}")
        # K3's bf16 entry adds grad_value with bf16 atomics in an order that
        # changes from run to run: two runs part by up to a few bf16 steps of
        # an element, so the comparisons of the runs that reach it (msda_bwd,
        # and the forwards whose gradient it is) take phase 20's limit, 3e-2
        # of the largest grad_value, instead of assert_close's bf16 default
        tol = {}
        if dtype == torch.bfloat16:
            grad_value = ops["msda_bwd"](*cases["msda_bwd"])[0]
            atol = BF16_K3_GV_RTOL * float(grad_value.float().abs().max())
            tol = {name: dict(atol=atol, rtol=BF16_FWD_RTOL)
                   for name in ("msda_bwd", "msda_fwd", "banded_fwd")}
        for name, args in cases.items():
            t0 = time.perf_counter()
            torch.library.opcheck(ops[name], args, **tol.get(name, {}))
            seconds[f"{name} {str(dtype)[6:]}"] = round(time.perf_counter() - t0, 2)
    log("opcheck", f"{len(seconds)} checks passed on {device} (schema, fake, autograd "
                   f"registration, AOT dispatch; K3 bf16's comparisons within {BF16_K3_GV_RTOL} "
                   f"of its largest grad_value): seconds {seconds}")
    return seconds


def check_compiled_gather(device: str = "cuda") -> dict:
    """One fusion block and one deformable encoder layer on the gather path
    at flagship width (hidden 256, 8 heads, 4 levels, 4 points; fusion 1024
    wide, 4 heads) on the 800x1216 bucket's levels, B = 2, f32, compiled
    whole (torch.compile fullgraph through AOTAutograd, utils/graph_check):
    no graph break, K2 and K1 in the forward graph, K3 and K4 in the
    backward, one launch each in the compiled run (its launches counted
    alone), the loss and every gradient against eager within phase 11's
    limits (PARITY_LOSS_RTOL, PARITY_GRAD_RTOL); a compiled run whose K3
    grad_locs is negated must leave the gradient limit."""
    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.utils import graph_check

    layers = graph_check.build_layers(HEADS * HEAD_DIM, 2048, LEVELS, HEADS, POINTS, FUSION_E,
                                      FUSION_HEADS, device, seed=SEED)
    inputs = graph_check.layer_inputs(2, level_shapes(*BUCKET), HEADS * HEAD_DIM, TEXT_LEN,
                                      LIVE_TEXT, device, seed=SEED + 1)
    t0 = time.perf_counter()
    r = graph_check.compile_check(layers, inputs, before=reset_counts, after=read_counts)
    t_clean = time.perf_counter() - t0
    launches = {k: v for k, v in r["after"].items() if v}
    real = msda.ms_deform_attn_bwd

    def plant():
        reset_counts()
        msda.ms_deform_attn_bwd = negated_output(real, 1)

    t0 = time.perf_counter()
    try:
        fault = graph_check.compile_check(layers, inputs, before=plant,
                                          after=lambda: setattr(msda, "ms_deform_attn_bwd", real))
    finally:
        msda.ms_deform_attn_bwd = real
    t_fault = time.perf_counter() - t0
    loss_rel = abs(r["loss"] - r["eager_loss"]) / abs(r["eager_loss"])
    log("compiled", f"fusion block + gather encoder layer (B=2, 800x1216 levels, f32) compiled "
                    f"fullgraph through AOTAutograd in {t_clean:.1f} s: forward graph ops "
                    f"{r['forward_ops']}, backward {r['backward_ops']}; launches of the compiled "
                    f"run {launches}; loss {r['loss']:.6f} against eager {r['eager_loss']:.6f} "
                    f"(rel {loss_rel:.2e}, limit {PARITY_LOSS_RTOL}), worst gradient "
                    f"{r['max_rel_grad_err']:.2e} of its max (limit {PARITY_GRAD_RTOL}); "
                    f"K3 grad_locs negated: {fault['max_rel_grad_err']:.2e} ({t_fault:.1f} s)")
    if sorted(r["forward_ops"]) != ["fusion_fwd", "msda_fwd"] or \
            sorted(r["backward_ops"]) != ["fusion_bwd", "msda_bwd"]:
        raise AssertionError("the compiled graphs do not hold K1, K2 forward and K3, K4 backward")
    if launches != {"msda_fwd": 1, "fusion_fwd": 1, "msda_bwd": 1, "fusion_bwd": 1}:
        raise AssertionError(f"the compiled run launched {launches}")
    if loss_rel > PARITY_LOSS_RTOL or r["max_rel_grad_err"] > PARITY_GRAD_RTOL:
        raise AssertionError("the compiled layers' loss or gradients left eager's")
    if fault["max_rel_grad_err"] <= PARITY_GRAD_RTOL:
        raise AssertionError("a negated K3 grad_locs stayed within the gradient limit")
    return {"launches": launches, "max_rel_grad_err": r["max_rel_grad_err"],
            "loss_rel": loss_rel, "fault_rel": fault["max_rel_grad_err"], "seconds": t_clean}


# each tool's arguments at flagship size (few iterations) and the kernel
# launches a call of it makes; the JAX tools' keys each must print
TOOL_FWD_KEYS = ("nparam", "flops_per_forward", "gflops", "time_s", "fps", "shape", "platform")
TOOL_TRAIN_KEYS = ("mode", "nparam", "compute_dtype", "step_time_s", "steps_per_call",
                   "imgs_per_sec", "loss", "shape", "platform")
TOOL_SERVE_KEYS = ("metric", "aot_latency_ms", "aot_img_s", "first_call_s", "export_s",
                   "artifact_mb", "bucket", "batch", "platform")
TOOL_EVAL_KEYS = ("metric", "pipeline_img_s", "raw_fwd_img_s", "ratio", "images", "batch",
                  "device_resident", "platform")
FWD_LAUNCHES = {"msda_fwd": 2 * ENC_LAYERS, "fusion_fwd": ENC_LAYERS}   # a forward's, f32


def run_tools(cfg: str, work: str) -> dict:
    """The JAX package's last tools, ported, once each at flagship width and
    depth on the card (tools/): benchmark forward (B = 1, 800x1216, f32)
    and --train (B = 4, bf16, one step a call and --steps_per_call 2),
    profile (forward, B = 4 bf16, 2 iterations),
    serving_bench (the 800x1216 bucket), eval_pipeline_bench (8 images of
    750x1000, B = 4), matcher_microbench and opt_microbench.  Each tool's
    result and seconds on a line; the keys the JAX tools print, the
    benchmark's FLOPs (K1 and K2 in the forward's count, K3 and K4 too in the
    step's) and every tool's kernel launches checked."""
    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.tools import (benchmark, eval_pipeline_bench,
                                                    matcher_microbench, opt_microbench, profile,
                                                    serving_bench)

    out = os.path.join(work, "tools")
    results, seconds, launches = {}, {}, {}

    def tool(name, fn, want=None):
        reset_counts()
        t0 = time.perf_counter()
        results[name] = fn()
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in read_counts().items() if v}
        shown = {k: v for k, v in results[name].items() if k not in ("summary",)} \
            if isinstance(results[name], dict) else results[name]
        log("tools", f"{name}: {shown} in {seconds[name]:.1f} s; launches {launches[name]}")
        if want is not None and launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]}, expected {want}")

    bench = benchmark.get_args_parser()
    fwd_calls = 1 + 2 + 5      # the FLOP count, warm-up, timed
    tool("benchmark", lambda: benchmark.run(bench.parse_args(
        ["-c", cfg, "-o", out, "--batch", "1", "--warmup", "2", "--iters", "5"])),
        {k: v * fwd_calls for k, v in FWD_LAUNCHES.items()})
    per_step = train_launches_per_step({}, bf16=True)
    steps = 1 + 1 + 3          # the FLOP count, warm-up, timed
    tool("benchmark --train", lambda: benchmark.run(bench.parse_args(
        ["-c", cfg, "-o", out, "--train", "--batch", "4", "--compute_dtype", "bfloat16",
         "--warmup", "1", "--iters", "3"])), {k: v * steps for k, v in per_step.items() if v})
    steps = 2 * (1 + 1 + 2)    # two steps a call: the FLOP count, warm-up, timed
    tool("benchmark --train --steps_per_call 2", lambda: benchmark.run(bench.parse_args(
        ["-c", cfg, "-o", out, "--train", "--batch", "4", "--compute_dtype", "bfloat16",
         "--steps_per_call", "2", "--warmup", "1", "--iters", "2"])),
        {k: v * steps for k, v in per_step.items() if v})
    tool("profile", lambda: profile.run(profile.get_args_parser().parse_args(
        ["-c", cfg, "-o", os.path.join(out, "trace"), "--batch", "4", "--iters", "2"])),
        {f"{k}_bf16": v * (1 + 2 + 2 + 2) for k, v in FWD_LAUNCHES.items()})
    tool("serving_bench", lambda: serving_bench.run(serving_bench.get_args_parser().parse_args(
        ["-c", cfg, "--iters", "5"])))
    tool("eval_pipeline_bench", lambda: eval_pipeline_bench.run(
        eval_pipeline_bench.get_args_parser().parse_args(
            ["-c", cfg, "--images", "8", "--batch", "4", "--fwd_iters", "3"])))
    tool("matcher_microbench", lambda: matcher_microbench.run(
        matcher_microbench.get_args_parser().parse_args(["--iters", "5", "--repeats", "2"])),
        {"lsap": 1 + 2 * 5})   # the device path's warm-up and timed calls
    tool("opt_microbench", lambda: opt_microbench.run(opt_microbench.get_args_parser().parse_args(
        ["--iters", "5", "--repeats", "2", "--ema"])), {})

    fwd, train_r = results["benchmark"], results["benchmark --train"]
    chunk_r = results["benchmark --train --steps_per_call 2"]
    for name, keys in (("benchmark", TOOL_FWD_KEYS), ("benchmark --train", TOOL_TRAIN_KEYS),
                       ("benchmark --train --steps_per_call 2", TOOL_TRAIN_KEYS),
                       ("serving_bench", TOOL_SERVE_KEYS), ("eval_pipeline_bench", TOOL_EVAL_KEYS)):
        missing = [k for k in keys if k not in results[name]]
        if missing or results[name]["platform"] != "gpu":
            raise AssertionError(f"{name} printed no {missing} or ran off the card")
    if set(fwd["kernel_flops"]) != {"msda_fwd", "fusion_fwd"} or \
            not {"msda_fwd", "fusion_fwd", "msda_bwd", "fusion_bwd"} <= set(train_r["kernel_flops"]):
        raise AssertionError(f"FLOP counts by kernel: forward {fwd['kernel_flops']}, step "
                             f"{train_r['kernel_flops']}")
    if not (math.isfinite(train_r["loss"]) and math.isfinite(chunk_r["loss"])) or \
            results["profile"]["summary"]["device_ms_per_iter"] <= 0:
        raise AssertionError("a step's loss or the profile's device time is missing")
    if (train_r["steps_per_call"], chunk_r["steps_per_call"]) != (1, 2):
        raise AssertionError(f"benchmark --train printed steps_per_call "
                             f"{train_r['steps_per_call']} and {chunk_r['steps_per_call']}")
    # the serving artifact and the eval pipeline launch K1 and K2 (f32 serving,
    # bf16 eval, the config's compute dtype)
    if not (launches["serving_bench"].get("msda_fwd") and launches["serving_bench"].get("fusion_fwd")
            and launches["eval_pipeline_bench"].get("msda_fwd_bf16")):
        raise AssertionError("serving_bench or eval_pipeline_bench reached no kernel")
    return {"results": results, "seconds": seconds, "launches": launches}


DEVICE_STEP_BATCHES = 2      # B = 4 batches of synthetic 800x1200 images (the 800x1216 bucket)
DEVICE_STEP_TIMED = 5        # timed steps a matcher, in turns, after one warm-up each
LSAP_TIMED = 20              # kernel launches timed on the captured costs
LSAP_COST_RTOL = 1e-5        # total cost against scipy's, relative
SYNC_MARK = "synchronizing CUDA operation"
# main with steps_per_call = 2: every image resized to at most 480 on its
# longer side, so that each B = 4 batch lands in the 480x736 bucket and an
# epoch's two batches make one chunk
MULTI_STEP_KEYS = {"steps_per_call": 2, "data_aug_scales": [480], "data_aug_max_size": 480,
                   "data_aug_scales2_resize": [480], "data_aug_scales2_crop": [480, 480]}


def device_step_batches(cfg: str, vocab: str, n: int = DEVICE_STEP_BATCHES) -> list:
    """n B = 4 training batches (the Collator's uint8 images, as main's) of
    synthetic 800x1200 images in the 800x1216 bucket, each image with 3-8
    boxes of the categories' caption."""
    import numpy as np

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import Sample

    args = SLConfig.fromfile(cfg)
    collator = Collator(build_tokenizer(vocab), args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=True)
    rng = np.random.RandomState(SEED + 35)
    cap_list = list(CATEGORIES)
    batches = []
    for b in range(n):
        samples = []
        for i in range(4):
            k = int(rng.randint(3, 9))
            xy = rng.uniform(0, 600, (k, 2))
            wh = rng.uniform(60, 500, (k, 2))
            boxes = np.concatenate([xy, np.minimum(xy + wh, [1199, 799])], 1).astype(np.float32)
            samples.append(Sample(image=synthetic_image(800, 1200, 300 + 4 * b + i), boxes=boxes,
                                  labels=rng.randint(len(cap_list), size=k).astype(np.int64),
                                  caption=" . ".join(cap_list) + " .", cap_list=cap_list))
        batch = collator(samples)
        if tuple(batch["images"].shape[1:3]) != BUCKET:
            raise AssertionError(f"a phase 35 batch landed in {batch['images'].shape}")
        batches.append(batch)
    return batches


class DeviceStepHarness:
    """Phase 35's ground: the flagship model from the smoke's training
    checkpoint (on the host, copied onto the card for each state), its
    config's criterion and optimizer settings."""

    def __init__(self, cfg: str, ckpt: str):
        from open_groundingdino_tpu_torch.config import SLConfig
        from open_groundingdino_tpu_torch.inference import load_reference_state_dict
        from open_groundingdino_tpu_torch.models.criterion import build_criterion
        from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino

        self.args = SLConfig.fromfile(cfg)
        self.base = build_groundingdino(self.args, device="cpu")
        load_reference_state_dict(self.base, ckpt)
        self.criterion = build_criterion(self.args)

    def state(self, device: str = "cuda"):
        import copy

        from open_groundingdino_tpu_torch.parallel.optim import make_optimizer
        from open_groundingdino_tpu_torch.parallel.train_state import TrainState

        a = self.args
        model = copy.deepcopy(self.base).to(device)
        opt = make_optimizer(model, lr=float(a.lr), base_lr=float(a.lr),
                             lr_backbone=float(a.lr_backbone),
                             lr_linear_proj_mult=float(a.lr_linear_proj_mult),
                             weight_decay=float(a.weight_decay),
                             clip_max_norm=float(a.clip_max_norm))
        return TrainState.create(model, opt, seed=SEED)


def host_metrics(metrics: dict) -> dict:
    """A step's (or a call's) device metrics as host numbers, in one read."""
    from open_groundingdino_tpu_torch import engine

    if metrics["loss"].dim() == 0:
        return engine.metrics_to_host([metrics])[0]
    n = metrics["loss"].shape[0]
    return engine.metrics_to_host([{k: v[j] for k, v in metrics.items()} for j in range(n)])


def sync_sites(fn) -> list:
    """fn() under torch.cuda.set_sync_debug_mode("warn"): every host
    synchronisation it makes, each as the last frames of the Python stack
    that made it."""
    import traceback
    import warnings

    import torch

    sites = []
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_MARK in str(message):
            frames = traceback.extract_stack()[:-1]
            sites.append(" <- ".join(f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                                     for f in reversed(frames[-8:])))
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    return sites


def lsap_degenerate_cases():
    """(name, costs (N, Q, G), valid (N, G), the overflow flags the solver
    must set): ties, the JAX package's +/-inf matrix and a sparser mix, a
    row whose Dijkstra would spin, more valid GT than queries."""
    import numpy as np

    rng = np.random.RandomState(SEED + 36)
    inf = rng.randn(2, 10, 5).astype(np.float32)
    inf[0, 2, :] = np.inf
    inf[0, :, 3] = -np.inf
    inf[1][rng.rand(10, 5) < 0.2] = np.inf
    inf[1][rng.rand(10, 5) < 0.1] = -np.inf
    spin = (rng.rand(2, 8, 2) * 10).astype(np.float32)
    spin[0, :, 0] = np.inf
    spin[0, 0, :] = -np.inf
    return [("ties", np.zeros((2, 12, 6), np.float32), np.ones((2, 6), bool), [False, False]),
            ("integer ties", rng.randint(0, 3, (2, 15, 8)).astype(np.float32),
             np.ones((2, 8), bool), [False, False]),
            ("+/-inf", inf, np.ones((2, 5), bool), [False, False]),
            ("spinning row", spin, np.ones((2, 2), bool), [True, False]),
            ("more GT than queries", rng.randn(1, 3, 5).astype(np.float32),
             np.ones((1, 5), bool), [True])]


def total_costs(cost, assigned, valid) -> list:
    """Each problem's total cost over its valid, assigned GT (float64)."""
    import numpy as np

    Q = cost.shape[1]
    out = []
    for c, a, v in zip(cost, assigned, valid):
        g = np.nonzero(v & (a < Q))[0]
        out.append(float(c[a[g], g].astype(np.float64).sum()))
    return out


def check_lsap(costs, valid) -> dict:
    """Phase 35 (a): the LSAP kernel against its plain version on a flagship
    step's (S*B, Q, G) costs: identical indices and no overflow; each
    problem's total cost against scipy's within LSAP_COST_RTOL; the kernel
    against the plain version on the degenerate matrices (the same indices
    and overflow flags, injective on the valid GT); the plain version with
    the last minimum in place of the first must part from the kernel on the
    tied matrix (a planted fault).  Times: the kernel by CUDA events and
    torch.profiler, the plain version on the card, scipy on the host copy
    (the library call) and the matcher's callback path (copy, scipy, copy
    back)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.models import matcher
    from open_groundingdino_tpu_torch.ops import lsap as L

    N, Q, G = costs.shape
    got, over = L.lsap(costs, valid)
    ref, ref_over = L.lsap_plain(costs, valid)
    host_c, host_v = costs.cpu().numpy(), valid.cpu().numpy()
    got_h = got.cpu().numpy()
    scipy_a = matcher.host_lsa(host_c, host_v)
    ours, theirs = total_costs(host_c, got_h, host_v), total_costs(host_c, scipy_a, host_v)
    cost_rel = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(ours, theirs))
    diff = int((got != ref).sum())
    n_valid = host_v.sum(1)
    if diff or over.any() or ref_over.any():
        raise AssertionError(f"LSAP kernel against its plain version: {diff} indices differ, "
                             f"overflow {over.tolist()} / {ref_over.tolist()}")
    if not cost_rel <= LSAP_COST_RTOL:
        raise AssertionError(f"LSAP total cost {ours} against scipy's {theirs}")
    degenerate = {}
    for name, c, v, want_over in lsap_degenerate_cases():
        tc, tv = torch.from_numpy(c).cuda(), torch.from_numpy(v).cuda()
        (a, o), (pa, po) = L.lsap(tc, tv), L.lsap_plain(tc, tv)
        a, o = a.cpu().numpy(), o.cpu().numpy().tolist()
        live = [row[row < c.shape[1]] for row in a]
        if (not np.array_equal(a, pa.cpu().numpy()) or o != po.cpu().tolist() or o != want_over
                or any(len(set(r.tolist())) != len(r) for r in live)):
            raise AssertionError(f"LSAP {name}: kernel {a.tolist()} {o}, plain "
                                 f"{pa.tolist()} {po.tolist()}, overflow wanted {want_over}")
        degenerate[name] = o
    ties = torch.zeros(2, 12, 6, device="cuda"), torch.ones(2, 6, dtype=torch.bool, device="cuda")
    real_argmin = L.first_argmin
    L.first_argmin = lambda x, dim=-1: x.shape[dim] - 1 - real_argmin(x.flip(dim), dim)
    try:
        planted = L.lsap_plain(*ties)[0]
    finally:
        L.first_argmin = real_argmin
    if torch.equal(planted, L.lsap(*ties)[0]):
        raise AssertionError("the plain LSAP with the last minimum gave the kernel's indices")
    ms = event_ms(lambda: L.lsap(costs, valid), LSAP_TIMED)
    device_ms = kernel_device_ms(lambda: L.lsap(costs, valid), LSAP_TIMED, "lsap_kernel")
    t0 = time.perf_counter()
    for _ in range(2):
        L.lsap_plain(costs, valid)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 2 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        matcher.host_lsa(host_c, host_v)
    scipy_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        matcher.hungarian_assign(costs, valid, method="callback")
    callback_ms = (time.perf_counter() - t0) / 5 * 1e3
    nbytes = costs.numel() * 4 + valid.numel() + got.numel() * 8 + N
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("lsap", f"kernel on a flagship step's costs ({N}, {Q}, {G}), valid GT a problem "
                f"{int(n_valid.min())}-{int(n_valid.max())}: the plain version's indices "
                f"({diff} differ), no overflow; total cost against scipy's worst {cost_rel:.1e} "
                f"(limit {LSAP_COST_RTOL}); degenerate matrices against the plain version: "
                f"{degenerate} (overflow flags); the last-minimum plant parts from the kernel; "
                f"kernel {ms:.4f} ms (dev. {device_ms:.4f}), plain on the card {plain_ms:.1f} ms, "
                f"scipy {scipy_ms:.2f} ms (the host path with its copies {callback_ms:.2f} ms), "
                f"bound {bound_ms:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)")
    return {"max_abs_err": float(diff), "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": scipy_ms,
            "callback_ms": callback_ms, "cost_rel": cost_rel, "degenerate": degenerate,
            "shape": [N, Q, G]}


def timed_steps(step, state, batches, n: int) -> list:
    """n steps over `batches` in turn, each ended by a read of its metrics:
    host seconds of whole steps."""
    seconds = []
    for i in range(n):
        t0 = time.perf_counter()
        metrics = host_metrics(step(state, batches[i % len(batches)]))
        seconds.append(time.perf_counter() - t0)
        if not math.isfinite(metrics["loss"]):
            raise AssertionError(f"a timed step's loss is {metrics['loss']}")
    return seconds


def check_device_step(cfg: str, work: str, files) -> dict:
    """Phase 35: the device-resident training step at flagship width, bf16,
    B = 4 (the config's default step, make_train_step).  (a) The LSAP
    kernel on the costs of the step's own criterion (check_lsap).  (b) With
    the batch on the card (its copy made first), a step under
    set_sync_debug_mode("warn") makes no host synchronisation (its sites
    listed if it does), and one under "error" runs through; its metrics
    reach the host in one read after it.  (c) The step's median with the
    device matcher against the host (scipy) matcher, DEVICE_STEP_TIMED
    whole steps each, in turns.  (d) steps_per_call = 2: one make_multi_train_step
    call against two single steps on the same batches from the same
    weights: the losses within PARITY_LOSS_RTOL, the count and
    nonfinite_count equal, the parameters' update within DIST_UPDATE_RTOL;
    the call on the batches in swapped order must fail the loss limit.  (e)
    main with steps_per_call = 2 (MULTI_STEP_KEYS: one chunk, a multi-step
    call, an epoch; train()'s checks).  tools/benchmark.py --train
    --steps_per_call 2 runs in phase 34."""
    import functools

    import torch

    from open_groundingdino_tpu_torch.models import criterion as crit_mod
    from open_groundingdino_tpu_torch.models import matcher
    from open_groundingdino_tpu_torch.parallel import train_state as ts

    t_phase = time.perf_counter()
    harness = DeviceStepHarness(files[0], files[1])
    batches = device_step_batches(cfg, files[2])
    step = ts.make_train_step(harness.criterion, compute_dtype="bfloat16")
    state = harness.state()
    captured = []
    real_assign = crit_mod.hungarian_assign

    def capture(cost, gt_valid, method="device"):
        captured.append((cost.detach().clone(), gt_valid.clone()))
        return real_assign(cost, gt_valid, method)

    reset_counts()
    crit_mod.hungarian_assign = capture
    try:
        first = host_metrics(step(state, batches[0]))             # warm-up
    finally:
        crit_mod.hungarian_assign = real_assign
    lsap_row = check_lsap(*captured[0])
    del captured
    reset_counts()   # the main path's launches from here: the steps of (b) and (c)

    # (b) no host sync inside a step
    on_card = ts.to_device(batches[1], "cuda")
    torch.cuda.synchronize()
    sites = sync_sites(lambda: step(state, on_card))
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(state, on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    read = host_metrics(metrics)
    log("device-step", f"bf16 B=4 step with the device matcher: warm-up loss {first['loss']:.4f}; "
                       f"under set_sync_debug_mode('warn') {len(sites)} synchronisations"
                       f"{': ' + '; '.join(sites[:12]) if sites else ''}; under 'error' one "
                       f"step ran through, its metrics read after it: loss {read['loss']:.4f}, "
                       f"grad_norm {read['grad_norm']:.4g}, nonfinite_count "
                       f"{read['nonfinite_count']}")
    if sites:
        raise AssertionError(f"the step synchronised with the host {len(sites)} times")

    # (c) the step's median, device matcher against the host one, in turns
    device_s, host_s = [], []
    host_assign = functools.partial(matcher.hungarian_assign, method="callback")
    for i in range(DEVICE_STEP_TIMED + 1):
        device_s += timed_steps(step, state, batches[i % 2:], 1)
        crit_mod.hungarian_assign = host_assign
        try:
            host_s += timed_steps(step, state, batches[i % 2:], 1)
        finally:
            crit_mod.hungarian_assign = real_assign
    device_s, host_s = device_s[1:], host_s[1:]
    step_counts = read_counts()
    n_device = 2 + DEVICE_STEP_TIMED + 1
    want = {k: v * (n_device + DEVICE_STEP_TIMED + 1)
            for k, v in train_launches_per_step({}, bf16=True).items()}
    want["lsap"] = n_device
    if step_counts != want:
        raise AssertionError(f"phase 35's steps launched {step_counts}, expected {want}")
    medians = {"device": statistics.median(device_s), "callback": statistics.median(host_s)}
    log("device-step", f"step s with the device matcher {[round(x, 4) for x in device_s]} "
                       f"(median {medians['device']:.4f}), with scipy on the host "
                       f"{[round(x, 4) for x in host_s]} (median {medians['callback']:.4f}); "
                       f"launches {({k: v for k, v in step_counts.items() if v})}")
    del state
    gc.collect()

    # (d) steps_per_call = 2 against two single steps
    single = harness.state()
    p0 = [p.detach().clone() for p in single.optimizer.params]
    ref = [host_metrics(step(single, b)) for b in batches[:2]]
    multi_step = ts.make_multi_train_step(harness.criterion, 2, compute_dtype="bfloat16")
    from open_groundingdino_tpu_torch.engine import stack_batches

    def multi(order):
        st = harness.state()
        got = host_metrics(multi_step(st, stack_batches([batches[i] for i in order])))
        return st, got

    def loss_gap(got):
        return max(abs(g["loss"] - r["loss"]) / abs(r["loss"]) for g, r in zip(got, ref))

    chunk_state, got = multi((0, 1))
    num = sum(float((a - b).double().pow(2).sum()) for a, b in
              zip(chunk_state.optimizer.params, single.optimizer.params))
    den = sum(float((b - a).double().pow(2).sum()) for a, b in zip(p0, single.optimizer.params))
    update_rel = (num / max(den, 1e-300)) ** 0.5
    counts_equal = (int(chunk_state.optimizer.count) == int(single.optimizer.count) == 2
                    and int(chunk_state.nonfinite_count) == int(single.nonfinite_count) == 0)
    del chunk_state
    swapped = loss_gap(multi((1, 0))[1])
    log("multi-step", f"steps_per_call=2 call against 2 single steps (bf16, B=4): losses "
                      f"{[round(g['loss'], 5) for g in got]} against "
                      f"{[round(r['loss'], 5) for r in ref]} (worst relative "
                      f"{loss_gap(got):.1e}, limit {PARITY_LOSS_RTOL}); update relative "
                      f"{update_rel:.2e} (limit {DIST_UPDATE_RTOL}); counts equal {counts_equal}; "
                      f"the call on the swapped batches: {swapped:.2e}")
    if not (loss_gap(got) <= PARITY_LOSS_RTOL and update_rel <= DIST_UPDATE_RTOL
            and counts_equal):
        raise AssertionError("the steps_per_call=2 call left two single steps")
    if swapped <= PARITY_LOSS_RTOL:
        raise AssertionError("the call on swapped batches stayed within the loss limit")
    del single, p0
    gc.collect()

    # (e) main with steps_per_call = 2
    calls = []
    real_multi = ts.make_multi_train_step

    def counted(*a, **k):
        fn = real_multi(*a, **k)

        def wrapped(*b, **kw):
            calls.append(1)
            return fn(*b, **kw)
        return wrapped

    ts.make_multi_train_step = counted
    try:
        run = train(cfg, work, files, "cuda", MULTI_STEP_KEYS, epochs=1, tag="multi-train",
                    compute_dtype=None)
    finally:
        ts.make_multi_train_step = real_multi
    if len(calls) != 1:
        raise AssertionError(f"main with steps_per_call=2 made {len(calls)} multi-step calls")
    log("multi-train", f"main with steps_per_call=2: {len(calls)} multi-step call of its "
                       f"{len(run['losses'])} steps; phase 35 in "
                       f"{time.perf_counter() - t_phase:.1f} s")
    return {"lsap": lsap_row, "step_counts": step_counts, "medians": medians,
            "multi_train_counts": run["counts"], "sync_sites": len(sites),
            "harness": harness, "batches": batches}


# ------------------------------------------------------ saved kernel outputs, flat AdamW (phase 36)
REMAT_RUNS = 3             # parity steps an arm, in turns, from the same weights and draws
REMAT_TIMED = 7            # steps timed an arm, in turns, after a warm-up of each
REMAT_BLOCK_RUNS = 15      # timed calls of one checkpointed block an arm, in turns
# (a) the saving step's gradients against the replaying step's.  Both arms
# run the same forward and the same backward kernels on the same values, so
# they part only where a sum's order changes from run to run (K3's bf16
# atomics; K4's and cuBLAS's sums), and such a gradient takes one of a few
# values from run to run, not a spread around one: two runs of one arm may
# agree bit for bit on a tensor where a third does not.  Held: the whole
# gradient's largest distance between a saving and a replaying run within
# REMAT_WHOLE_FACTOR x its largest between two runs of one arm; and each
# gradient K3 or K4 computes (KERNEL_FED), its largest distance between the
# arms within REMAT_LEAF_FACTOR x its own largest between two runs of one
# arm plus REMAT_LEAF_FLOOR of its norm.  The same per-tensor reading over
# every gradient is printed, not held: a BERT bias far from the kernels read
# 2.89 of that limit in one run and 0.41 in another (PERF.md §6).
REMAT_WHOLE_FACTOR = 1.5
REMAT_LEAF_FACTOR = 3.0
REMAT_LEAF_FLOOR = 1e-5
# (b) the port's AdamW (one f32 buffer a group) against a plain per-tensor
# AdamW in optax's order on the same gradients: each parameter and moment
# within OPT_RTOL of its largest |value| (their elements' arithmetic is the
# same; only the norms' f32 sums run in another order)
OPT_RTOL = 1e-6
OPT_TIMED = 5              # updates an optimizer, timed in turns, twice each


def faulty_cache(op: str, fault):
    """A context_fn like library.saving_checkpoint_contexts whose recompute
    hands back fault(the kept outputs) for the forward op `op`: a planted
    fault of phase 36."""
    from open_groundingdino_tpu_torch.ops import library

    class Faulty(library.KernelOutputs):
        def run(self, name, impl, args):
            out = super().run(name, impl, args)
            return fault(out) if self.at is not None and name == op else out

    return lambda: Faulty().contexts()


def leaf_distances(a, b=None) -> list:
    """||a_i - b_i|| of each pair of tensors (||a_i|| without b), in one read."""
    import torch

    with torch.no_grad():
        return torch.stack([(x - y if b is not None else x).float().norm()
                            for x, y in zip(a, b if b is not None else a)]).tolist()


def rel_gaps(got, ref) -> float:
    """The worst max|got - ref| / max|ref| over pairs of tensors, in one read."""
    import torch

    with torch.no_grad():
        return max(torch.stack([(x - y).abs().max() / y.abs().max().clamp(min=1e-30)
                                for x, y in zip(got, ref)]).tolist())


def plain_global_norm(tensors):
    """The overflow-safe global norm a leaf at a time (two reductions a
    leaf): phase 36's plain version of optim.safe_global_norm."""
    import torch

    tensors = [t.float() for t in tensors]
    gmax = torch.stack([t.abs().max() for t in tensors]).max().clamp(min=1e-30)
    return gmax * torch.sqrt(torch.stack([((t / gmax) ** 2).sum() for t in tensors]).sum())


def plain_adamw(base):
    """A subclass of the port's GroupedAdamW (`base`) whose step is the plain
    per-tensor AdamW in optax's order (a `_foreach_*` pass a group over the
    parameters' own tensors): phase 36's plain version of the flat update."""
    import torch

    class PlainAdamW(base):
        @torch.no_grad()
        def step(self, grads, norm, finite):
            finite, lr, bc1, bc2, b1, b2, scale = self._schedule(norm, finite)
            for group, idx in self.groups.items():
                g = [torch.where(finite, grads[i].float(), 0.0) for i in idx]
                torch._foreach_mul_(g, scale)
                p = [self.params[i] for i in idx]
                m = [self.m[i] for i in idx]
                v = [self.v[i] for i in idx]
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, g, alpha=1.0 - self.b1)
                torch._foreach_mul_(v, b2)
                torch._foreach_add_(v, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
                upd = torch._foreach_div(m, bc1)
                den = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.eps)
                torch._foreach_div_(upd, den)
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
                torch._foreach_mul_(upd, torch.where(finite, -(lr * self.mults[group]), 0.0))
                torch._foreach_add_(p, upd)
            self.count = torch.where(finite, self.count + 1, self.count)

    return PlainAdamW


def dispatch_mode_contexts():
    """torch.utils.checkpoint's selective contexts keeping the outputs of
    library.SAVED_OPS (MUST_SAVE; PREFER_RECOMPUTE for every other op): the
    library's way to what library.saving_checkpoint_contexts does, through
    a dispatch mode that sees every op of the block (phase 36 times it)."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    from open_groundingdino_tpu_torch.ops import library

    saved = {f"{library.NAMESPACE}::{name}" for name in library.SAVED_OPS}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op.name() in saved else \
            CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def block_host_ms(state, encoder, step, batch, runs: int) -> dict:
    """The host's cost of each way to checkpoint one block: the first
    fusion block and the first deformable encoder layer, called by the
    encoder's own checkpoint on the inputs a step gives them and the step's
    bf16 weights, forward and backward, `runs` calls of each block an arm,
    in turns: "save" (the kernels' outputs kept, the port's), "replay"
    (remat_save_kernels off) and "dispatch" (dispatch_mode_contexts in the
    port's place).  {block: {arm: (host ms to issue the forward and the
    backward, median; device busy ms of one profiled call)}}."""
    import torch

    from open_groundingdino_tpu_torch.ops import library
    from open_groundingdino_tpu_torch.parallel import train_state as ts

    blocks = {"fusion block": encoder.fusion_layers[0], "encoder layer": encoder.layers[0]}
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda _m, args, tag=tag: inputs.setdefault(tag, args) and None)
        for tag, m in blocks.items()]
    real = state.optimizer.step
    state.optimizer.step = lambda grads, norm, finite: None
    try:
        host_metrics(step(state, batch))
    finally:
        state.optimizer.step = real
        for h in hooks:
            h.remove()
    model = state.model
    bf16 = {k: v.detach() for k, v in
            ts.cast_floating(dict(model.named_parameters()), torch.bfloat16).items()}
    for v in bf16.values():
        v.requires_grad_(True)

    real_contexts = library.saving_checkpoint_contexts

    def call(tag, arm: str) -> float:
        """One forward and backward of the block; host ms to issue it."""
        encoder.remat_save_kernels = arm != "replay"
        library.saving_checkpoint_contexts = \
            dispatch_mode_contexts if arm == "dispatch" else real_contexts
        args = [a.detach().requires_grad_(a.requires_grad) if torch.is_tensor(a) else a
                for a in inputs[tag]]
        torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            with ts.swapped_parameters(model, bf16):
                out = encoder._checkpoint(blocks[tag], *args)
                outs = [o for o in (out if isinstance(out, tuple) else (out,)) if o.requires_grad]
                torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
            host = (time.perf_counter() - t0) * 1e3
        finally:
            library.saving_checkpoint_contexts = real_contexts
        torch.cuda.synchronize()
        return host

    arms = ("save", "replay", "dispatch")
    result = {}
    for tag in blocks:
        host = {arm: [] for arm in arms}
        for i in range(runs + 1):   # the arms' order rotates
            for arm in arms[i % 3:] + arms[:i % 3]:
                host[arm].append(call(tag, arm))
        result[tag] = {}
        for arm in arms:
            prof, _ = profiling.profile_calls(lambda: call(tag, arm))
            result[tag][arm] = (statistics.median(host[arm][1:]),
                                sum(device_time_by_group(prof)[1].values()))
    for v in bf16.values():
        v.grad = None
    for p in model.parameters():
        p.grad = None
    encoder.remat_save_kernels = True
    return result


def check_saved_kernels(files, smi: str, harness, batches, device: str = "cuda") -> dict:
    """Phase 36, on phase 35's flagship weights and bf16 B = 4 batches.  (a)
    The step with the checkpointed blocks keeping the kernels' outputs
    (remat_save_kernels, the default) against the step that replays them
    (remat_save_kernels=False): REMAT_RUNS steps of each from the same
    weights and stochastic-depth draws, in turns, with no update; the
    launches exact (12 K1 + 6 K2 bf16 against 18 + 12), the losses
    bit-equal, the gradients within the run-to-run distance of one arm (the
    whole gradient and each kernel-fed one, see REMAT_WHOLE_FACTOR); a cache
    that hands back fusion_fwd's out_v scaled by 1.01, and one that hands
    back another image's MSDA output, must each fail that; each arm's peak
    memory, host ms to issue a step and host-clock median over REMAT_TIMED
    full steps in turns, device busy of a profiled step, and the host and
    device ms of one checkpointed block of each kind under each policy
    (block_host_ms).  (b) The port's AdamW (one f32 buffer a group) against
    the plain per-tensor one (plain_adamw, plain_global_norm) on the
    flagship parameters (858 tensors) and (a)'s gradients: three updates,
    the second non-finite; parameters and moments within OPT_RTOL after
    each, the non-finite one a no-op in both; an AdamW with the next count's
    bias correction must fail; one update's device launches of each
    (torch.profiler) and its host-clock time, in turns."""
    import torch

    from open_groundingdino_tpu_torch.ops import library
    from open_groundingdino_tpu_torch.parallel import optim
    from open_groundingdino_tpu_torch.parallel import train_state as ts

    t_phase = time.perf_counter()
    state = harness.state(device)
    encoder = state.model.transformer.encoder
    step = ts.make_train_step(harness.criterion, compute_dtype="bfloat16")
    batch = ts.to_device(batches[0], device)
    draws = state.generator.get_state()

    def parity_step(save: bool):
        """(loss, the gradients, the launches) of a step from the state's
        weights and stochastic-depth draws, with no update."""
        encoder.remat_save_kernels = save
        state.generator.set_state(draws)
        got = []
        state.optimizer.step = lambda grads, norm, finite: got.append(
            [g.detach().clone() for g in grads])
        reset_counts()
        try:
            loss = host_metrics(step(state, batch))["loss"]
        finally:
            del state.optimizer.step
        return loss, got[0], read_counts()

    runs = {"save": [], "replay": []}
    for i in range(REMAT_RUNS):   # save, replay, replay, save, ...
        for arm in (("save", "replay") if i % 2 == 0 else ("replay", "save")):
            runs[arm].append(parity_step(arm == "save"))
    want = {"save": train_launches_per_step({}, bf16=True),
            "replay": train_launches_per_step({"remat_save_kernels": False}, bf16=True)}
    for arm, rs in runs.items():
        for r in rs:
            if r[2] != want[arm]:
                raise AssertionError(f"the {arm} step launched {r[2]}, expected {want[arm]}")
    counts = {arm: rs[0][2] for arm, rs in runs.items()}   # as measured
    grads = {arm: [r[1] for r in rs] for arm, rs in runs.items()}
    losses = [r[0] for arm in ("save", "replay") for r in runs[arm]]
    del runs
    names = state.optimizer.names
    fed = [i for i, n in enumerate(names) if any(k in n for k in KERNEL_FED)]
    norms = leaf_distances(grads["save"][0])

    def pair_max(pairs) -> list:
        """Each parameter's largest gradient distance over pairs of runs."""
        return [max(ds) for ds in zip(*(leaf_distances(a, b) for a, b in pairs))]

    def whole(dists) -> float:
        return math.sqrt(sum(d * d for d in dists))

    same = pair_max([p for arm in grads.values() for p in itertools.combinations(arm, 2)])

    def share(d: float, limit: float) -> float:
        return d / limit if limit > 0 else (math.inf if d > 0 else 0.0)

    def verdict(dists) -> tuple:
        """(the whole gradient's distance / its limit, the worst kernel-fed
        gradient's distance / its limit, that parameter's name, the worst
        over every gradient by the same per-tensor limit, its name)."""
        leaf = [(share(dists[i], REMAT_LEAF_FACTOR * same[i] + REMAT_LEAF_FLOOR * norms[i]),
                 names[i]) for i in range(len(names))]
        return (share(whole(dists), REMAT_WHOLE_FACTOR * whole(same)),
                *max(leaf[i] for i in fed), *max(leaf))

    cross = verdict(pair_max([(a, b) for a in grads["save"] for b in grads["replay"]]))
    real_contexts = library.saving_checkpoint_contexts
    faults = {}
    for tag, op, fault in (
            ("fusion out_v x 1.01", "fusion_fwd", lambda out: (out[0] * 1.01, *out[1:])),
            ("another image's MSDA output", "msda_fwd", lambda out: out.roll(1, 0))):
        library.saving_checkpoint_contexts = faulty_cache(op, fault)
        try:
            loss, got, _ = parity_step(True)
        finally:
            library.saving_checkpoint_contexts = real_contexts
        faults[tag] = (loss, verdict(pair_max([(got, a) for a in grads["save"]])))
        del got
    rel_same = max(d / n for d, n in zip(same, norms) if n > 0)
    log("saved-kernels", f"{smi}: bf16 B=4 step, the kernels' outputs saved against replayed "
                         f"({REMAT_RUNS} steps each, in turns, same weights and draws): launches "
                         f"{ {k: v for k, v in counts['save'].items() if v} } against "
                         f"{ {k: v for k, v in counts['replay'].items() if v} }; losses {losses}; "
                         f"gradients: {sum(d > 0 for d in same)} of {len(names)} parameters part "
                         f"between runs of one arm, by at most {rel_same:.2e} of their norm, the "
                         f"whole gradient by {whole(same) / whole(norms):.2e}; the arms' distance: "
                         f"whole {cross[0]:.3f} of its limit ({REMAT_WHOLE_FACTOR} x one arm's), "
                         f"the worst of the {len(fed)} kernel-fed gradients {cross[1]:.3f} of its "
                         f"limit ({REMAT_LEAF_FACTOR} x one arm's + {REMAT_LEAF_FLOOR} of its "
                         f"norm; {cross[2]}), of all {len(names)} by that limit (not held) "
                         f"{cross[3]:.3f} ({cross[4]}); planted: " + "; ".join(
                             f"{t}: whole {v[0]:.3g}, kernel-fed {v[1]:.3g} ({v[2]}), all "
                             f"{v[3]:.3g}, loss {l}" for t, (l, v) in faults.items()))
    failed = []   # raised at the phase's end, after every part has run and logged
    if len(set(losses)) != 1:
        failed.append(f"the saving and the replaying steps' losses part: {losses}")
    if max(cross[:2]) > 1.0:
        failed.append(f"the saving step's gradients left the replaying step's: {cross}")
    failed += [f"a cache with {tag} kept the gradients within the limits"
               for tag, (_, v) in faults.items() if max(v[:2]) <= 1.0]
    s1, r1 = grads["save"][0], grads["replay"][0]
    del grads
    gc.collect()

    # each arm's peak memory, host ms to issue a step and step median over
    # full steps, in turns
    seconds, issue = {"save": [], "replay": []}, {"save": [], "replay": []}
    peaks = {"save": [], "replay": []}
    base = torch.cuda.memory_allocated()
    for i in range(REMAT_TIMED + 1):
        for arm in (("save", "replay") if i % 2 == 0 else ("replay", "save")):
            encoder.remat_save_kernels = arm == "save"
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batches[i % 2])
            t1 = time.perf_counter()
            if not math.isfinite(host_metrics(metrics)["loss"]):
                raise AssertionError("a timed step's loss is not finite")
            seconds[arm].append(time.perf_counter() - t0)
            issue[arm].append((t1 - t0) * 1e3)
            peaks[arm].append(torch.cuda.max_memory_allocated())
    medians = {arm: statistics.median(v[1:]) for arm, v in seconds.items()}
    issue_ms = {arm: statistics.median(v[1:]) for arm, v in issue.items()}
    peak = {arm: max(v) for arm, v in peaks.items()}
    log("saved-kernels", f"{smi}: full bf16 B=4 steps in turns (a warm-up each, then "
                         f"{REMAT_TIMED}): saved {[round(x, 4) for x in seconds['save']]} s "
                         f"(median {medians['save']:.4f}), replayed "
                         f"{[round(x, 4) for x in seconds['replay']]} s (median "
                         f"{medians['replay']:.4f}); host ms to issue a step (no read inside "
                         f"it) median saved {issue_ms['save']:.1f}, replayed "
                         f"{issue_ms['replay']:.1f}; max_memory_allocated saved "
                         f"{peak['save'] / 2**30:.2f} GiB, replayed {peak['replay'] / 2**30:.2f} "
                         f"GiB, of it {base / 2**30:.2f} GiB allocated before the steps "
                         f"(the model, AdamW's moments, (a)'s gradients)")
    busy = {}
    for arm, label in (("save", "saved"), ("replay", "replayed")):   # a profiled step of each
        encoder.remat_save_kernels = arm == "save"
        prof, wall_ms = profiling.profile_calls(lambda: step(state, batch))
        _, groups, launches = device_time_by_group(prof)
        busy[arm] = sum(groups.values())
        kernel_groups = {k: (round(v, 2), launches[k]) for k, v in groups.items()
                         if launches[k] and k[:2] in ("K1", "K2", "K3", "K4")}
        log("saved-kernels", f"{smi}: a profiled step, the kernels' outputs {label}: {wall_ms:.1f} ms "
                             f"wall (profiler on), device busy {busy[arm]:.1f} ms; K1-K4 ms and "
                             f"launches {kernel_groups}; matmul {groups['matmul']:.2f}, other "
                             f"{groups['other']:.2f} ms")
    blocks = block_host_ms(state, encoder, step, batch, REMAT_BLOCK_RUNS)
    log("saved-kernels", f"{smi}: one checkpointed block, forward and backward on a step's inputs "
                         f"and bf16 weights ({REMAT_BLOCK_RUNS} calls an arm in turns), host ms "
                         f"to issue (median) and device busy ms: " +
        "; ".join(f"{tag}: outputs kept {v['save'][0]:.2f} / {v['save'][1]:.2f}, replayed "
                  f"{v['replay'][0]:.2f} / {v['replay'][1]:.2f}, kept through torch's selective "
                  f"checkpoint (a dispatch mode) {v['dispatch'][0]:.2f} / {v['dispatch'][1]:.2f}"
                  for tag, v in blocks.items()))
    del state, encoder
    gc.collect()

    # (b) the port's AdamW against the plain per-tensor one on (a)'s gradients
    a = harness.args
    params = [(n, p) for n, p in harness.base.named_parameters()]
    kw = dict(base_lr=float(a.lr), lr_backbone=float(a.lr_backbone),
              lr_linear_proj_mult=float(a.lr_linear_proj_mult),
              weight_decay=float(a.weight_decay), clip_max_norm=float(a.clip_max_norm))

    class NextBiasCorrection(optim.GroupedAdamW):
        """A planted fault: bc1 of the next count."""

        def _schedule(self, norm, finite):
            finite, lr, bc1, bc2, b1, b2, scale = super()._schedule(norm, finite)
            return finite, lr, 1.0 - (1.0 - bc1) * self.b1, bc2, b1, b2, scale

    opts, norm_of = {}, {"port": optim.safe_global_norm, "plain": plain_global_norm,
                         "planted": optim.safe_global_norm}
    for tag, cls in (("plain", plain_adamw(optim.GroupedAdamW)), ("port", optim.GroupedAdamW),
                     ("planted", NextBiasCorrection)):
        named = [(n, torch.nn.Parameter(p.detach().to(device, copy=True))) for n, p in params]
        opts[tag] = cls(named, optim.constant_schedule(float(a.lr)), **kw)
    bad = list(s1)
    bad[len(bad) // 2] = bad[len(bad) // 2].clone()
    bad[len(bad) // 2].view(-1)[0] = float("nan")

    def update(tag, grads):
        norm = norm_of[tag](grads)
        opts[tag].step(grads, norm, torch.isfinite(norm))

    def held(opt):
        return list(opt.params) + opt.m + opt.v

    gaps = []
    for k, grads in enumerate((s1, bad, r1)):
        before = [t.detach().clone() for tag in ("plain", "port") for t in held(opts[tag])] \
            if k == 1 else None
        for tag in opts:
            update(tag, grads)
        if k == 0:
            planted = rel_gaps(opts["planted"].params, opts["plain"].params)
            del opts["planted"]
        if before is not None:
            after = [t.detach() for tag in ("plain", "port") for t in held(opts[tag])]
            if not all(torch.equal(x, y) for x, y in zip(after, before)):
                failed.append("a non-finite update moved a parameter or a moment")
            del before, after
        gaps.append(rel_gaps(held(opts["port"]), held(opts["plain"])))
    opt_counts = [int(o.count) for o in opts.values()]
    launches, update_ms = {}, {"port": [], "plain": []}
    for tag in opts:
        prof, _ = profiling.profile_calls(lambda: update(tag, r1), 1)
        launches[tag] = sum(n for _, n in profiling.device_kernels(prof).values())
    for tag in ("port", "plain", "plain", "port"):   # host-clock ms of an update, in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OPT_TIMED):
            update(tag, r1)
        torch.cuda.synchronize()
        update_ms[tag].append((time.perf_counter() - t0) * 1e3 / OPT_TIMED)
    del opts, s1, r1, bad
    gc.collect()
    log("flat-adamw", f"{smi}: the port's AdamW (one f32 buffer a group) against the plain "
                      f"per-tensor one on the flagship's {len(params)} parameter tensors and "
                      f"(a)'s gradients, three updates (the second non-finite, a no-op in both): "
                      f"worst parameter or moment {max(gaps):.2e} of its max|value| after each "
                      f"({[f'{g:.1e}' for g in gaps]}, limit {OPT_RTOL}); counts {opt_counts}; "
                      f"the next count's bias correction planted: {planted:.2e}; one update's "
                      f"device launches, the guard's norm included {launches} (torch.profiler); "
                      f"host-clock ms an update ({OPT_TIMED} a time, in turns) "
                      f"{ {k: [round(x, 2) for x in v] for k, v in update_ms.items()} }; "
                      f"phase 36 in {time.perf_counter() - t_phase:.1f} s")
    if max(gaps) > OPT_RTOL or opt_counts != [2, 2]:
        failed.append("the port's AdamW left the plain per-tensor one")
    if planted <= OPT_RTOL:
        failed.append("an AdamW with the next count's bias correction stayed within the limit")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"counts": counts, "medians": medians, "issue_ms": issue_ms, "peak_bytes": peak,
            "base_bytes": base, "device_busy_ms": busy, "blocks": blocks,
            "grad_cross": cross, "grad_same_rel": rel_same,
            "faults": {t: v for t, (_, v) in faults.items()}, "opt_gaps": gaps,
            "opt_planted": planted, "opt_launches": launches, "opt_update_ms": update_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from open_groundingdino_tpu_torch.ops import build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    clock = PhaseClock()
    clock("1")
    # 2. build
    secs = build.build_all()
    log("build", f"nvcc of {', '.join(build.SOURCES)} in {secs:.1f} s; " + build.ptxas_summary())
    clock("2")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = check_msda(g, "cuda")        # 3
    clock("3")
    k2 = check_fusion(g, "cuda")      # 4
    clock("4")

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    # the CPU reference computations of phases 11, 22, 28 and 29 (B = 1
    # training steps, a B = 4 eval forward, one forward a backbone: ~230 s
    # on an H100 host) run on a thread of their own beside the card's
    # phases, one after the other; each phase joins its result where it
    # compares
    cpu_jobs = futures.ThreadPoolExecutor(1)
    try:
        cfg = os.path.join(REPO, "open_groundingdino_tpu_torch", "config", "cfg_coco.py")
        files = write_serving_files(cfg, work)
        train_files = (cfg, os.path.join(work, "train_ckpt.pth"), files[2])
        write_checkpoint(cfg, train_files[1], random_biases=True)
        harness = parity_harness(cfg, train_files)
        cpu_step = cpu_jobs.submit(harness[0], "cpu")
        eval_files = (cfg, os.path.join(work, "eval_ckpt.pth"), files[2])
        write_checkpoint(cfg, eval_files[1], random_biases=True, anchor_boxes=True)
        eval_reference = start_eval_parity(cfg, work, eval_files, cpu_jobs)
        bb_files = backbone_files(work, files[2])
        bb_refs = {tag: cpu_jobs.submit(backbone_reference, bb_files[tag])
                   for tag, _, _ in BACKBONES}
        resnet_ref = cpu_jobs.submit(resnet_reference, bb_files["resnet50"])
        im, lat, counts, images = serve(files, "cuda")                 # 5
        clock("5")
        cpu_out = check_forward(im, files, images[0], CAPTIONS[0])     # 6
        clock("6")
        eager_profile = profile_request(im, images[0], CAPTIONS[0],    # 7
                                        check_reader=True)
        clock("7")
        del im
        k3 = check_msda_bwd("cuda")                                    # 8
        msda_sass = msda_kernel_report({n: k3[n]["plan"] for n in k3})
        clock("8")
        k4 = check_fusion_bwd("cuda")                                  # 9
        clock("9")
        tr = train(cfg, work, train_files, "cuda")                     # 10
        profile_train_step(tr.pop("run"))
        clock("10")
        _, gather_card = check_train_parity(harness, cpu_step)         # 11
        clock("11")

        sweep = check_sweep("cuda")                                    # 12
        clock("12")
        serve_counts, sweep_profiles = {}, {}
        for tag, keys in (("sweep-serve", {"msda_kernel": "sweep"}),   # 13
                          ("sweep-serve-fused", {"msda_kernel": "sweep", "msda_dec_fused": True})):
            sweep_files = (msda_config(cfg, work, tag, **keys), *files[1:])
            im, _, serve_counts[tag], _ = serve(sweep_files, "cuda", tag)
            compare_forward(forward_outputs(im, images[0], CAPTIONS[0]), cpu_out,
                            f"{tag}-forward", "against phase 6's CPU forward")
            sweep_profiles[tag] = profile_request(im, images[0], CAPTIONS[0],
                                                  tag=tag.replace("serve", "profile"))
            del im
        clock("13")
        train_counts_sweep = {}
        for tag, keys, kw in (                                          # 14
                ("sweep-train", {"msda_kernel": "sweep"}, dict(epochs=1)),
                ("sweep-train-rowtap", {"msda_kernel": "sweep", "msda_sweep_bwd": "rowtap"},
                 dict(epochs=1, max_steps=1))):
            run = train(cfg, work, train_files, "cuda", keys, tag=tag, **kw)
            train_counts_sweep[tag] = run["counts"]
            profile_train_step(run.pop("run"), tag=f"{tag}-profile")
            del run
        clock("14")
        _, sweep_cards = check_sweep_train_parity(harness, gather_card)   # 15
        clock("15")

        banded = check_banded_corner("cuda")                           # 16
        clock("16")
        banded_files = (msda_config(cfg, work, "banded-serve", msda_kernel="banded_point"),
                        *files[1:])
        im, _, serve_counts["banded-serve"], _ = serve(banded_files, "cuda", "banded-serve")  # 17
        compare_forward(forward_outputs(im, images[0], CAPTIONS[0]), cpu_out,
                        "banded-serve-forward", "against phase 6's CPU forward")
        profile_request(im, images[0], CAPTIONS[0], tag="banded-profile")
        del im
        clock("17")
        run = train(cfg, work, train_files, "cuda", {"msda_kernel": "banded_point"},  # 18
                    tag="banded-train", epochs=1)
        train_counts_sweep["banded-train"] = run["counts"]
        profile_train_step(run.pop("run"), tag="banded-train-profile")
        del run
        _, banded_card = check_banded_train_parity(harness, gather_card)
        clock("18")
        _, bench_counts = run_microbench()                              # 19
        _, bench_counts_bf16 = run_microbench("bf16")
        clock("19")
        bf16 = check_bf16_kernels("cuda")                               # 20
        clock("20")
        bf16_train = train_bf16(cfg, work, train_files, harness, gather_card)   # 21
        gather_bf16_card = bf16_train.pop("parity_card")
        del gather_card
        clock("21")
        evals = check_eval_main(cfg, work, eval_files, "cuda")          # 22
        parity = check_eval_parity(eval_reference, "cuda")
        clock("22")
        check_resume(cfg, work, eval_files, parity["manifest"], "cuda")    # 23
        clock("23")
        bf16_sweep = check_bf16_sweep("cuda")                           # 24
        clock("24")
        bf16_sweep_train = train_bf16_sweep(cfg, work, train_files, eval_files,   # 25
                                            harness, sweep_cards, gather_bf16_card)
        del sweep_cards
        clock("25")
        bf16_banded = check_bf16_banded_corner("cuda")                  # 26
        clock("26")
        bf16_banded_train = train_bf16_banded(cfg, work, train_files, harness,   # 27
                                              banded_card, gather_bf16_card)
        del harness, banded_card, gather_bf16_card
        clock("27")
        bb_serve = serve_backbones(work, bb_files, cpu_refs=bb_refs)   # 28
        clock("28")
        bb_train = train_backbones(work, bb_files, resnet_ref=resnet_ref)   # 29
        clock("29")
        del bb_files
        pave = check_pave(work, files)                                 # 30
        clock("30")
        export = check_export(work, files, eager_profile)              # 31
        clock("31")
        roberta = check_roberta(cfg, work)                             # 32
        clock("32")
        dist = check_dist(cfg, work, eval_files)                       # 33
        clock("33")
        check_opcheck("cuda")                                          # 34
        compiled = check_compiled_gather("cuda")
        tools = run_tools(cfg, work)
        clock("34")
        device_step = check_device_step(cfg, work, train_files)       # 35
        clock("35")
        saved = check_saved_kernels(train_files, smi, device_step.pop("harness"),   # 36
                                    device_step.pop("batches"))
        clock("36")
    finally:
        cpu_jobs.shutdown(cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)

    def mean_row(rows):
        """K1 and K3 run 6x at each shape per forward/backward: their row is
        the mean launch"""
        enc, dec = rows["encoder"], rows["decoder"]
        return {"max_abs_err": max(enc["max_abs_err"], dec["max_abs_err"]),
                **{key: (enc[key] + dec[key]) / 2 for key in ("ms", "plain_ms", "bound_ms")},
                "bound_by": enc["bound_by"], "library_ms": None, "per_shape": rows}

    def single_row(row):
        return {key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by")} | {"library_ms": None}

    src, tpu = "open_groundingdino_tpu_torch/csrc/", "open_groundingdino_tpu/ops/"
    # launches: the serving run's (phase 5) for K1 and K2, the training run's
    # (phase 10) for K3 and K4; both runs' counts under launches_by_path
    train_counts = tr["counts"]
    # K1 and K2 were also held to their plain versions, and timed, at B = 4
    # (phases 8, 9); K1's row is serving's B = 1, per_shape adds B = 4
    k1_b4 = {n: k3[n].pop("k1") for n in k3}
    k1_err = max(r["max_abs_err"] for r in k1_b4.values())
    k2_err = k4["k2_max_abs_err"]
    k1_row = mean_row(k1)
    k1_row["per_shape"] = {f"{batch} {n}": r for batch, rows in (("B=1", k1), ("B=4", k1_b4))
                           for n, r in rows.items()}
    # the other backbones' runs (phases 28, 29), by counter
    bb_counts = {**{f"serve-{tag}": r["counts"] for tag, r in bb_serve.items()},
                 **{f"train-{tag}": bb_train[tag]["counts"]
                    for tag in ("swinl", "swinl-no-recompute", "resnet50-dilated")}}

    def bb_launches(counter):
        return {tag: c[counter] for tag, c in bb_counts.items() if c[counter]}

    # the PAVE paths (phase 30): the tool's two f32 runs, the bf16 crop-batch
    # eval; the kernels held at the B = 16 crop batch's operands
    pave_kernels = pave["kernels"]

    def pave_launches(counter):
        return sum(r["counts"][counter] for r in pave["tool"].values())

    def pave_shapes(kname, dtype):
        return {f"pave B={PAVE_BATCH} {part}": r for (k, d, part), r in pave_kernels.items()
                if k == kname and d == dtype}

    k1_row["per_shape"].update(pave_shapes("K1", "f32"))

    def roberta_launches(counter):
        """Phase 32's launches by the counter's name: the RoBERTa requests
        (f32) and training steps (bf16) under "roberta", the zero-shot eval
        (bf16) under "zero_shot"."""
        served, trained = roberta["serve"]["counts"], roberta["train"]["counts"]
        return {"roberta": served[counter] + trained[counter],
                "zero_shot": roberta["zero_shot"]["counts"][counter]}

    def dist_launches(counter):
        """Phase 33's launches by the counter's name: rank 0's of the gloo
        pair under "dist" (each rank's are equal), the NCCL rank's under
        "dist-nccl"."""
        return {"dist": dist["ranks"][0]["counts"][counter],
                "dist-nccl": dist["reference"]["counts"][counter]}

    def export_launches(path, counter):
        """The artifact's launches (phase 31): the gather artifact's timed
        requests, the sweep's and banded_point's one forward each."""
        run = export[path]
        return (run["request_counts"] if path == "gather" else run["forward_counts"])[counter]

    kernels = [
        {"name": "msda_fwd", "route": "cuda", "source": src + "msda_fwd.cu",
         "replaces": tpu + "msda_banded.py:311", "launches": counts["msda_fwd"],
         "launches_by_path": {"serve": counts["msda_fwd"], "train": train_counts["msda_fwd"],
                              "eval-f32": evals["float32"]["counts"]["msda_fwd"],
                              **bb_launches("msda_fwd"), "pave": pave_launches("msda_fwd"),
                              "export": export_launches("gather", "msda_fwd"),
                              **roberta_launches("msda_fwd"), **dist_launches("msda_fwd")},
         **k1_row | {"max_abs_err": max(k1_row["max_abs_err"], k1_err, *(
             r["max_abs_err"] for r in pave_shapes("K1", "f32").values()))},
         "sass": msda_sass["msda_fwd"]},
        {"name": "fusion_fwd", "route": "cuda", "source": src + "fusion_fwd.cu",
         "replaces": tpu + "fusion_pallas.py:50", "launches": counts["fusion_fwd"],
         "launches_by_path": {"serve": counts["fusion_fwd"],
                              "train": train_counts["fusion_fwd"],
                              "eval-f32": evals["float32"]["counts"]["fusion_fwd"],
                              **bb_launches("fusion_fwd"), "pave": pave_launches("fusion_fwd"),
                              "export": export_launches("gather", "fusion_fwd"),
                              **roberta_launches("fusion_fwd"), **dist_launches("fusion_fwd")},
         **single_row(k2) | {"max_abs_err": max(
             k2["max_abs_err"], k2_err, pave_kernels["K2", "f32", "fusion"]["max_abs_err"])},
         "per_shape": {"B=1": single_row(k2), "B=4": single_row(k4["k2"]),
                       **pave_shapes("K2", "f32")},
         "sass": k2["sass"]["fusion_fwd"]},
        {"name": "msda_bwd", "route": "cuda", "source": src + "msda_bwd.cu",
         "replaces": tpu + "msda_banded.py:524", "launches": train_counts["msda_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["msda_bwd"],
                              **bb_launches("msda_bwd"), **roberta_launches("msda_bwd"),
                              **dist_launches("msda_bwd")},
         **mean_row(k3),
         "sass": {k: msda_sass[k] for k in ("msda_bwd", "msda_bwd_atomics", "msda_bwd_plans")}},
        {"name": "fusion_bwd", "route": "cuda", "source": src + "fusion_bwd.cu",
         "replaces": tpu + "fusion_pallas.py:198", "launches": train_counts["fusion_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["fusion_bwd"],
                              **bb_launches("fusion_bwd"), **roberta_launches("fusion_bwd"),
                              **dist_launches("fusion_bwd")},
         **single_row(k4), "sass": k4["sass"]["fusion_bwd"]},
    ]
    # the compiled fusion block and gather encoder layer (phase 34), and the
    # tools' runs of the gather path
    for row in kernels:
        row["launches_by_path"]["compiled"] = compiled["launches"][row["name"]]
        row["launches_by_path"].update({f"tools {name}": c[row["name"]]
                                        for name, c in tools["launches"].items()
                                        if c.get(row["name"])})
    # K5 and K8 (phase 16; the row is phase 8's B = 4 shapes, per_shape adds
    # B = 1) and the sweep kernels (phase 12 at phase 8's B = 4 shapes; K6's
    # and K7's per_shape add B = 1);
    # launches: K5's from the banded serving run (phase 17), K6's and K7's
    # from the sweep serving runs (phase 13), K8's from the microbench (phase
    # 19), K9's and K10's from the sweep training runs (phase 14); every
    # run's counts under launches_by_path
    by_path = {**serve_counts, **train_counts_sweep, "microbench": bench_counts}
    measured = {**sweep, **{(k, n): r for (k, batch, n), r in banded.items() if batch == "B=4"}}
    for kname, counter, launches_from, source, line in (
            ("K5", "banded_fwd", "banded-serve", "msda_banded_fwd.cu", "msda_banded.py:152"),
            ("K6", "sweep_fwd", "sweep-serve", "msda_rowtap_fwd.cu", "msda_pallas.py:484"),
            ("K7", "sweep_fwd_allq", "sweep-serve-fused", "msda_rowtap_fwd.cu",
             "msda_pallas.py:634"),
            ("K8", "sweep_fwd_corner", "microbench", "msda_corner_fwd.cu", "msda_pallas.py:169"),
            ("K9", "sweep_bwd_corner", "sweep-train", "msda_corner_bwd.cu", "msda_pallas.py:955"),
            ("K10", "sweep_bwd_rowtap", "sweep-train-rowtap", "msda_rowtap_bwd.cu",
             "msda_pallas.py:1200")):
        shapes = {n: measured[kname, n] for n in ("encoder", "decoder") if (kname, n) in measured}
        row = mean_row(shapes) if len(shapes) == 2 else single_row(shapes["decoder"])
        if kname in ("K5", "K8"):
            row["per_shape"] = {f"{batch} {n}": r for (k, batch, n), r in banded.items()
                                if k == kname}
            row["max_abs_err"] = max(max(r["max_abs_err"], r["k1_max_abs_err"])
                                     for r in row["per_shape"].values())
        if kname in ("K6", "K7"):
            row["per_shape"] = {f"B=4 {n}" if n in shapes else n: r
                                for (k, n), r in sweep.items() if k == kname}
            row["max_abs_err"] = max(r["max_abs_err"] for r in row["per_shape"].values())
        if kname == "K7":   # its device time in one profiled fused request (phase 13)
            row["request_profile_ms"] = sweep_profiles["sweep-serve-fused"]["groups_ms"][
                "K7 allq_fwd"]
        lib = {"K5": "msda_banded_fwd", "K6": "msda_rowtap_fwd", "K7": "msda_rowtap_fwd",
               "K8": "msda_corner_fwd", "K9": "msda_corner_bwd", "K10": "msda_rowtap_bwd"}[kname]
        row["sass"] = {k: v for k, v in msda_sass.items()
                       if k.startswith(lib) or k == f"{kname}_plans"}
        kernels.append({"name": counter, "route": "cuda", "source": src + source,
                        "replaces": tpu + line, "launches": by_path[launches_from][counter],
                        "launches_by_path": {k: v[counter] for k, v in by_path.items()}, **row})
        if kname in ("K5", "K6", "K7"):   # the serving artifacts (phase 31)
            kernels[-1]["launches_by_path"]["export"] = export_launches(
                "banded_point" if kname == "K5" else "sweep", counter)
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname} was not launched on its path")
    # the bf16 entries (phase 20; the row is phase 8's / 9's B = 4 shapes,
    # per_shape adds B = 1); launches from the bf16 training run (phase 21)
    bf16_rows, bf16_counts = bf16["rows"], bf16_train["counts"]
    for kname, counter, source, line, parts in (
            ("K1", "msda_fwd", "msda_fwd.cu", "msda_banded.py:311", ("encoder", "decoder")),
            ("K2", "fusion_fwd", "fusion_fwd.cu", "fusion_pallas.py:50", ("fusion",)),
            ("K3", "msda_bwd", "msda_bwd.cu", "msda_banded.py:524", ("encoder", "decoder")),
            ("K4", "fusion_bwd", "fusion_bwd.cu", "fusion_pallas.py:198", ("fusion",))):
        shapes = {n: bf16_rows[kname, "B=4", n] for n in parts}
        row = mean_row(shapes) if len(parts) == 2 else single_row(shapes["fusion"])
        row["per_shape"] = {f"{batch} {n}": r for (k, batch, n), r in bf16_rows.items()
                            if k == kname}
        row["per_shape"].update(pave_shapes(kname, "bf16"))   # the crop batch (phase 30)
        row["max_abs_err"] = max(r["max_abs_err"] for r in row["per_shape"].values())
        row["device_ms"] = sum(r["device_ms"] for r in shapes.values()) / len(shapes)
        row["sass"] = bf16["sass"].get({"K2": "fusion_fwd", "K3": "msda_bwd_atomics",
                                        "K4": "fusion_bwd"}.get(kname))
        by_path = {"bf16-train": bf16_counts[f"{counter}_bf16"],
                   **{f"{arm}-kernels-step": c[f"{counter}_bf16"]   # phase 36
                      for arm, c in saved["counts"].items()}}
        if kname in ("K1", "K2"):   # and the bf16 eval (phase 22), the PAVE crop eval (30)
            by_path["eval-bf16"] = evals["bfloat16"]["counts"][f"{counter}_bf16"]
            by_path["pave"] = pave["eval"]["counts"][f"{counter}_bf16"]
        by_path.update(bb_launches(f"{counter}_bf16"))   # the Swin-L steps (phase 29)
        by_path.update(roberta_launches(f"{counter}_bf16"))   # phase 32
        by_path.update({f"tools {name}": c[f"{counter}_bf16"]   # phase 34
                        for name, c in tools["launches"].items() if c.get(f"{counter}_bf16")})
        kernels.append({"name": f"{counter}_bf16", "route": "cuda", "source": src + source,
                        "replaces": tpu + line, "launches": bf16_counts[f"{counter}_bf16"],
                        "launches_by_path": by_path, **row})
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname}'s bf16 entry was not launched on its path")
    # the sweep kernels' bf16 entries (phase 24; the row is phase 8's B = 4
    # shapes, K6's and K7's per_shape add B = 1); launches from the bf16
    # sweep runs of phase 25: K6 and K9 from its training run, K10 from the
    # row-tap step, K7 from the dec_fused step; every run's under
    # launches_by_path
    sweep_rows = bf16_sweep["rows"]
    sweep_counts = {tag: r["counts"] for tag, r in bf16_sweep_train["runs"].items()}
    for kname, counter, launches_from, source, line, parts in (
            ("K6", "sweep_fwd", "bf16-sweep-train", "msda_rowtap_fwd.cu", "msda_pallas.py:484",
             ("encoder", "decoder")),
            ("K7", "sweep_fwd_allq", "bf16-sweep-train-fused", "msda_rowtap_fwd.cu",
             "msda_pallas.py:634", ("decoder",)),
            ("K9", "sweep_bwd_corner", "bf16-sweep-train", "msda_corner_bwd.cu",
             "msda_pallas.py:955", ("encoder", "decoder")),
            ("K10", "sweep_bwd_rowtap", "bf16-sweep-train-rowtap", "msda_rowtap_bwd.cu",
             "msda_pallas.py:1200", ("encoder", "decoder"))):
        shapes = {n: sweep_rows[kname, "B=4", n] for n in parts}
        row = mean_row(shapes) if len(parts) == 2 else single_row(shapes["decoder"])
        row["per_shape"] = {f"{batch} {n}": r for (k, batch, n), r in sweep_rows.items()
                            if k == kname}
        row["max_abs_err"] = max(r["max_abs_err"] for r in row["per_shape"].values())
        row["device_ms"] = sum(r["device_ms"] for r in shapes.values()) / len(shapes)
        row["sass"] = bf16_sweep["sass"][kname]
        kernels.append({"name": f"{counter}_bf16", "route": "cuda", "source": src + source,
                        "replaces": tpu + line,
                        "launches": sweep_counts[launches_from][f"{counter}_bf16"],
                        "launches_by_path": {tag: c[f"{counter}_bf16"]
                                             for tag, c in sweep_counts.items()}, **row})
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname}'s bf16 entry was not launched on its path")
    # the bf16 entries of K5 and K8 (phase 26; the row is phase 8's B = 4
    # shapes, per_shape adds B = 1); launches: K5 bf16's from the bf16
    # banded_point training run with its eval (phase 27), K8 bf16's from the
    # bf16 microbench (phase 19); both runs' counts under launches_by_path
    by_path = {"bf16-banded-train": bf16_banded_train["counts"],
               "bf16-microbench": bench_counts_bf16}
    for kname, counter, launches_from, source, line in (
            ("K5", "banded_fwd", "bf16-banded-train", "msda_banded_fwd.cu", "msda_banded.py:152"),
            ("K8", "sweep_fwd_corner", "bf16-microbench", "msda_corner_fwd.cu",
             "msda_pallas.py:169")):
        rows = bf16_banded["rows"]
        shapes = {n: rows[kname, "B=4", n] for n in ("encoder", "decoder")}
        row = mean_row(shapes)
        row["per_shape"] = {f"{batch} {n}": r for (k, batch, n), r in rows.items() if k == kname}
        row["max_abs_err"] = max(max(r["max_abs_err"], r["k1_max_abs_err"])
                                 for r in row["per_shape"].values())
        row["device_ms"] = sum(r["device_ms"] for r in shapes.values()) / len(shapes)
        row["sass"] = bf16_banded["sass"][kname]
        if kname == "K5":   # its device time in the profiled step (phase 27)
            row["step_profile_ms"] = bf16_banded_train["profile"]["groups_ms"][
                "K5 banded_fwd bf16"]
        kernels.append({"name": f"{counter}_bf16", "route": "cuda", "source": src + source,
                        "replaces": tpu + line,
                        "launches": by_path[launches_from][f"{counter}_bf16"],
                        "launches_by_path": {k: v[f"{counter}_bf16"] for k, v in by_path.items()},
                        **row})
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname}'s bf16 entry was not launched on its path")
    # the LSAP kernel (phase 35, on a flagship bf16 step's costs); launches
    # from the gather training run (phase 10), one a step; every training
    # run's under launches_by_path, phase 35's own steps under "device-step"
    row = device_step["lsap"]
    kernels.append({
        "name": "lsap", "route": "cuda", "source": src + "lsap.cu",
        "replaces": tpu + "hungarian.py:215", "launches": train_counts["lsap"],
        "launches_by_path": {
            "train": train_counts["lsap"], "bf16-train": bf16_counts["lsap"],
            **{tag: c["lsap"] for tag, c in train_counts_sweep.items()},
            **{tag: c["lsap"] for tag, c in sweep_counts.items()},
            "bf16-banded-train": bf16_banded_train["counts"]["lsap"],
            **bb_launches("lsap"), **roberta_launches("lsap"), **dist_launches("lsap"),
            **{f"tools {name}": c["lsap"] for name, c in tools["launches"].items()
               if c.get("lsap")},
            "device-step": device_step["step_counts"]["lsap"],
            "multi-train": device_step["multi_train_counts"]["lsap"]},
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "device_ms", "callback_ms", "cost_rel", "shape")}})
    if kernels[-1]["launches"] <= 0:
        raise AssertionError("the LSAP kernel was not launched on its path")
    print(json.dumps({"kernels": json_safe(kernels)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
