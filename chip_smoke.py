#!/usr/bin/env python3
"""Smoke run of refign_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. card: name and power limit (nvidia-smi);
2. build: every ``refign_tpu_torch/csrc/*.cu`` with nvcc, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at its main-path shapes (K1, K2: the four MiT-B5 stages; K3:
   the three UAWarpC levels at the UDA geometry, in the fused ReLU + L2
   mode with bf16 output that the head launches and in the raw fp32
   mode, and at the stage-1 UAWarpC train step's and the DeepLabV2 UDA
   step's three levels) plus ragged cases, with
   CUDA-event times (batches of back-to-back calls) beside the least time
   the card could take (bound), the share of that bound reached, and one
   PyTorch library call that computes the same function, where there is
   one; and the K1 and K2 backward kernels against autograd of their plain
   versions at the train step's shapes (bf16, fp32) and ragged ones, and
   K3's backward at the stage-1 UAWarpC step's three levels (fused bf16
   with both gradients, and with gs alone as the path asks; raw) and
   ragged ones (the kernel, plain and library backwards timed by
   their device time, as the host work of the wrapper and of autograd
   outlasts their kernels); and, for the lab-only Pallas functions of
   tools/, their bounds and library calls at their own shapes; K3 and its
   backward (gs alone) also at the folded UAWarpC step's 18-row levels;
   and the native host correlation (``refign_tpu_torch/native``, built
   with g++) against K3's plain version and K3 at a small shape;
4. HRDA★ path: Refign-HRDA★ (MiT-B5, DAFormer, SegFormer scale attention,
   seeded random bf16 weights) on a 1x1080x1920 image through
   ``build_hrda_star`` and ``hrda_slide_forward``: the output is checked
   for shape and finiteness, K1 and K2 must launch 52 times per forward,
   and the forward must agree with the same model run through the plain
   versions; a small fp32 model checks the kernels' path tightly; a
   ``utils/profiling.StepTracer`` window over two warm forwards must write
   a trace holding K1's kernel;
5. align path: Refign's align and refine (VGG-16 + UAWarpC, seeded random
   bf16 weights) on B=4 1024x1024 target/reference images and 19-class
   logits through ``build_alignment`` and ``refign_align_refine``: K3 must
   launch 3 times, the probabilities are checked for shape, range and
   their per-pixel sum, and flow and probabilities must agree with the
   plain-version run; a small fp32 network checks ``align_forward``
   tightly;
6. UDA train step: the Refign-HRDA* step of ``refign_hrda_star.yaml``
   (MiT-B5 + DAFormer + SegFormer scale attention with remat, the frozen
   VGG-16 + UAWarpC, adapt-to-reference, the ImageNet feature distance,
   DACS, AdamW; seeded random weights, bf16 on fp32 masters) on a seeded
   synthetic B=4 1024^2 batch through ``build_uda_trainer`` and
   ``uda_train_step``: from one state with the same draws, one step's
   losses and every parameter's gradient through the kernels must agree
   with the plain versions' (and tightly on a small fp32 model); one step
   must launch K1 and K2 312 times forward and 104 times backward and K3 3
   times; then 1 warm-up and 5 timed steps with finite losses, the peak
   memory and a profile; then the MiT blocks' recompute under
   ``remat_policy='dots'`` (products and convolutions kept, K1 and K2
   recomputed) against the whole-block recompute from one state with the
   same draws at the limits above, its launch counts (the same), step time
   and peak memory;
6b. UAWarpC train step, stage 1: VGG-16 + UAWarpC (seeded random
   weights, bf16 on fp32 masters, remat_modules, Adam at lr 1e-4 and wd
   4e-4) on B=6 seeded synthetic uint8 pairs of 750^2, the prime view
   synthesised on the card and everything cropped to 520^2, through
   ``build_align_trainer`` and ``align_train_step``: from one state with
   the same draws, the losses and every head gradient through the kernels
   against the plain versions' (tightly on a reduced fp32 step, for the
   wiring at full size in bf16); one step must launch K3 and its backward
   9 times each (3 levels x 3 head passes); 1 warm-up and 5 timed steps
   with finite losses, the peak memory and a profile; then, from that
   state with one set of draws, the step's memory options against the
   serial step: ``fold_passes`` (one head pass of 18 rows, BatchNorm in 3
   groups; K3 and its backward 3 times a step) at the limits above on
   losses, head gradients and BN running statistics, and the folded step
   through the kernels against it through the plain versions;
   ``remat_head`` whole, with the 'dots' policy and with ``remat_skip_last``
   within 10x the most the serial step differs by from three repeats
   (bit-equal where they repeat); each variant's launches of every
   kernel, the device time of its compared forward and backward, its warm
   step time and peak memory beside the serial step's; then one stage-2
   step (elastic flow, visibility mask) with finite losses and the same
   launch counts;
6c. Refign-DeepLabV2 (``refign_deeplabv2.yaml``: ResNet-101 v1c at output
   stride 8 + DeepLabV2, seeded random weights, every BatchNorm's scale
   and bias drawn and its statistics calibrated on seeded images):
   inference of one 540x960 image through ``build_deeplabv2``
   and ``deeplabv2_forward``, bf16 against fp32 on the same weights (no
   hand-written kernel on that path), warm median of 5 and a profile;
   then the UDA step (the frozen VGG-16 + UAWarpC, adapt-to-reference, the
   ImageNet feature distance on layer4, DACS, AdamW; bf16 on fp32 masters)
   on a B=4 512^2 batch through ``build_uda_trainer``: losses and every
   gradient through the kernels against the plain versions' (tightly on a
   small fp32 resnet50_v1c step), one counted Refign-branch step that must
   launch K3 3 times at the levels' shapes and no other kernel, 1 warm-up
   and 5 timed Refign-branch steps, the peak memory and a profile;
6d. the runtime, through ``refign_tpu_torch.cli.main`` in this process,
   on synthetic dataset trees at the datasets' sizes
   (``refign_tpu_torch/data/synthetic.py``: Cityscapes 1024x2048 with the
   rare-class files, ACDC 1080x1920, MegaDepth's full-length train split)
   and seeded weights written as reference-named files (MiT-B5, VGG-16,
   an AlignmentModel .ckpt) that the configs' ``pretrained`` entries are
   pointed at: ``fit`` of ``configs/cityscapes_acdc/refign_hrda_star.yaml``
   for 6 steps (each step's launches: K1, K2 and their backwards as phase
   6 counts them, K3 3 times on a Refign-branch step and none on the
   others; two steps profiled for the device's busy share; the loader's
   wait per step; the checkpoint's write time and size; the last step
   again from the state it left, on its batch and draws and on the Refign
   branch, losses and gradients through the kernels against the plain
   versions' at phase 6's limits; the same step timed with the loader
   stopped), ``validate`` from the checkpoint (its IoU and confusion
   matrices equal to the fit's last validation; the first image's fp32
   logits and confusion matrix against the plain versions'), ``predict``
   (a trainId and a colour PNG per test image at 1080x1920); ``fit`` (3
   steps, K3 and its backward 9 times each per step; the step timed with
   the loader stopped) and ``validate`` of
   ``configs/megadepth/uawarpc_stage1.yaml``; ``test`` of
   ``configs/cityscapes_acdc/refign_deeplabv2.yaml`` (no kernel launched);
   every loss and metric finite; and the fit's last step through the
   plain versions again on its input images moved by one ulp of the
   compute dtype (the featdist loss's noise floor), and through the
   kernels twice (whether the step's backward repeats bit for bit);
6e. data parallelism over torch.distributed: (a) ``fit`` (3 steps) of
   ``refign_hrda_star.yaml`` through the CLI under ``python -m
   torch.distributed.run --nproc_per_node 1`` over NCCL (this script's
   ``--cli-worker`` mode counts each step's launches): step 1's losses
   bit-equal to phase 6d's group-free fit's, the later steps' within 10x
   of what a second group-free fit differs by (the backward's atomic adds
   do not repeat bit for bit), each step's launches as phase 6 counts
   them; then ``validate`` of phase 6d's checkpoint, its confusion
   matrices equal to 6d's; (b) 2 gloo ranks on cuda:0 against one process
   on the global batch: the UDA step (a small fp32 mit_b1 step, then the
   full-width MiT-B5 one at B=2 + 2, one row a rank) at phase 6's limits
   with every rank's launch counts, the UAWarpC stage-1 step (a reduced
   fp32 step, with and without cuDNN and remat_modules; the full-width
   bf16 one at 6 pairs, 3 a rank) against one process's own one-ulp
   floor (see ``phase_dist_ranks``), every parameter equal on every rank,
   and one 1080x1920 HRDA* validation image with its 30 rows spread over
   the ranks (fp32 logits within E2E_FP32_REL, confusion matrix equal but
   for pixels within the tie margin); each rank's step times, collective
   time, peak memory; (c) with two cards or more, (b) over NCCL, one rank
   a card;
7. each kernel's time per call of its path (K1 and K2 summed over the 52
   launches of a forward, beside SDPA's and cuDNN conv + gelu's sums; K3
   over an align; the backward kernels over the 104 launches of a train
   step, beside SDPA's and cuDNN's forward + backward and the sums of
   their first designs; K3's backward over the 9 launches of a stage-1
   UAWarpC step, both gradients and gs alone, beside its first design;
   K3 over a Refign-DeepLabV2 step), the host-clock seconds of each phase
   and of the parts timed on their own, the ``kernels`` JSON line (the
   launches on each path as this run counted them), the card line and,
   last, the result line.

There is no CPU path: without a CUDA device the script exits non-zero.
"""
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 tensor-core
# rate and fp32 CUDA-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12


def peak_flops(itemsize: int) -> float:
    """Peak rate for products of inputs of this size: bf16 products summed
    in fp32 are tensor-core work, fp32 ones CUDA-core work."""
    return BF16_TENSOR_FLOPS if itemsize == 2 else FP32_FLOPS

# MiT-B5 at 30 rows of 540^2 (one 1080x1920 image): per stage, launches per
# forward and the shapes each kernel sees
B_ROWS = 30
STAGES = [  # (launches, tokens N, keys M, heads H, dwconv H=W, hidden C)
    (3, 18225, 256, 1, 135, 256),
    (6, 4624, 289, 2, 68, 512),
    (40, 1156, 289, 5, 34, 1280),
    (3, 289, 289, 8, 17, 2048),
]
LAUNCHES_PER_FORWARD = sum(s[0] for s in STAGES)  # 52

# the UDA train step (refign_hrda_star.yaml: B=4 1024^2 crops): each
# student pass runs MiT-B5 on 8 rows of 512^2 (4 LR images, 4 HR crops) and
# has one backward; per stage, launches per pass and the shapes each kernel
# sees there
UDA_B, UDA_HW = 4, 1024
TRAIN_ROWS = 8
TRAIN_STAGES = [  # (launches, tokens N, keys M, heads H, dwconv H=W, hidden C)
    (3, 16384, 256, 1, 128, 256),
    (6, 4096, 256, 2, 64, 512),
    (40, 1024, 256, 5, 32, 1280),
    (3, 256, 256, 8, 16, 2048),
]
TRAIN_PASSES = 2
# K4, the DAFormer head's three dilated depthwise convs (d = 6, 12, 18,
# 1024 channels): one launch each a head forward; in a slide frame all three
# with the eval BatchNorm + ReLU epilogue, in the UDA step none (train-mode
# BatchNorm)
K4_DILATIONS = (6, 12, 18)
K4_LAUNCHES_PER_FORWARD = len(K4_DILATIONS)  # 3
K4_MAP = (30, 135, 135, 1024)  # a slide frame's ASPP input, 30 crops at 1/4
# launches per step: the forward kernels run in the teacher, the ImageNet
# copy, both student passes and both recomputes of the remat; the backward
# kernels in both student backwards; K3 in the align step; K4 in the heads
# of the teacher and of both student passes
TRAIN_LAUNCHES = {
    "sra_attention": 6 * LAUNCHES_PER_FORWARD,
    "sra_attention_backward": TRAIN_PASSES * LAUNCHES_PER_FORWARD,
    "dwconv3x3_gelu": 6 * LAUNCHES_PER_FORWARD,
    "dwconv3x3_gelu_backward": TRAIN_PASSES * LAUNCHES_PER_FORWARD,
    "local_correlation": 3,
    "dilated_dwconv3x3": 3 * K4_LAUNCHES_PER_FORWARD,
}

# UAWarpC local correlation (K3) at the UDA geometry: B=4 1024^2 crops,
# P=9, one launch per level per align forward: (B, H, W, C) of levels
# 1, 2, 3 (refign_tpu/models/heads/uawarpc.py:253, :230, :170)
ALIGN_B, ALIGN_HW = 4, 1024
CORR_LEVELS = [(4, 256, 256, 128), (4, 128, 128, 256), (4, 32, 32, 256)]
CORR_PATCH = 9

# the DeepLabV2 configurations (configs/{cityscapes_acdc,
# cityscapes_darkzurich,cityscapes_robotcar}/refign_deeplabv2.yaml:
# ResNet-101 v1c at output stride 8 + the DeepLabV2 head): whole-image
# inference at 540x960 (the test configuration's Resize), and the Refign
# UDA step on B=4 512^2 crops, whose align step launches K3 (fused ReLU +
# L2, bf16 out) once per UAWarpC level: (B, H, W, C) at 512^2, read back
# from the counted step's launches
DL_EVAL_HW = (540, 960)
DL_B, DL_HW = 4, 512
DL_CORR_LEVELS = [(4, 128, 128, 128), (4, 64, 64, 256), (4, 32, 32, 256)]
DL_LAUNCHES = {"sra_attention": 0, "sra_attention_backward": 0,
               "dwconv3x3_gelu": 0, "dwconv3x3_gelu_backward": 0,
               "local_correlation": len(DL_CORR_LEVELS),
               "local_correlation_backward": 0}

# UAWarpC training, stage 1 (configs/megadepth/uawarpc_stage1.yaml:9,15,51):
# B=6 uint8 pairs loaded at 750^2, the prime synthesised there, everything
# cropped to 520^2; three head passes a step, each launching K3 (fused
# ReLU + L2, bf16 out) and its backward once per level: (B, H, W, C) of
# levels 1, 2 (1/4 and 1/8 of 520^2) and 3 (32^2 of the 256^2 pyramid)
ALIGN_TRAIN_B, ALIGN_TRAIN_LOAD, ALIGN_TRAIN_CROP = 6, 750, 520
ALIGN_TRAIN_PASSES = 3
ALIGN_TRAIN_LEVELS = [(6, 130, 130, 128), (6, 65, 65, 256), (6, 32, 32, 256)]
ALIGN_TRAIN_LAUNCHES = {
    "local_correlation": ALIGN_TRAIN_PASSES * len(ALIGN_TRAIN_LEVELS),
    "local_correlation_backward": ALIGN_TRAIN_PASSES * len(ALIGN_TRAIN_LEVELS),
}

# the step's memory options (refign_tpu_torch/alignment/trainer.py):
# fold_passes runs the three head passes as one of 3B = 18 rows, so K3 and
# its backward launch once a level; remat_head recomputes each pass in
# the backward, K3 with it (every pass, or two with remat_skip_last), its
# backward as often as before.  Each: its AlignConfig options and (K3, K3
# backward) launches a step
ALIGN_FOLD_LEVELS = [(3 * b, h, w, c) for b, h, w, c in ALIGN_TRAIN_LEVELS]
ALIGN_VARIANTS = {
    "fold_passes": (dict(fold_passes=True), (3, 3)),
    "remat_head": (dict(remat_head=True), (18, 9)),
    "remat_head dots": (dict(remat_head=True, remat_head_policy="dots"),
                        (18, 9)),
    "remat_head skip_last": (dict(remat_head=True, remat_skip_last=True),
                             (15, 9)),
}
# warm steps timed for each variant (its comparison run warms it)
ALIGN_VARIANT_STEPS = 3
# repeats of the serial run beside them (the remat_head variants' limits)
ALIGN_SERIAL_REPEATS = 3

# per-step sums (ms) of the first designs of the backward kernels, read by
# this script on an NVIDIA H100 80GB HBM3 at 700 W; phase 7 prints them
# beside this run's.  K1 (fp32 CUDA cores, softmax recomputed in three
# passes) and K2 (three kernels through an fp32 g' map): 104 launches a
# train step.  K3 (fp32 CUDA cores): 9 launches a stage-1 UAWarpC step,
# phase 3's fused bf16 rows (both gradients) and its in-path time in phase
# 6b's profile (gs alone)
FIRST_BACKWARD_STEP_MS = {"sra_attention_backward": 104.4,
                          "dwconv3x3_gelu_backward": 49.51,
                          "local_correlation_backward": 13.84,
                          "local_correlation_backward in path": 10.40}

# elementwise bound for a kernel output in bf16 against the fp32 plain
# version on the same inputs: one bf16 rounding (2^-8 relative) plus fp32
# summation-order noise
BF16_REL = 2.0 ** -8
BF16_ABS = 1e-4
# fp32 kernel output against the fp32 plain version (summation order only)
FP32_ABS = 1e-5
# whole 1080x1920 bf16 forward, kernels against plain versions: both round
# every activation to bf16 at the same places; one-ulp differences travel
# through 52 residual blocks and both heads
E2E_MAX_REL = 5e-2
E2E_MEAN_REL = 1e-2
# small fp32 model, kernels against plain versions
E2E_FP32_REL = 1e-4
# the train step, kernels against plain versions, from one state with the
# same draws: the three losses (relative) and every parameter's gradient
# (relative L2).  fp32 (mit_b1, B=2 256^2): summation order only.  bf16
# (MiT-B5, B=4 1024^2): both round every activation to bf16 at the same
# places; one-ulp differences travel through 52 blocks, the heads and the
# backward.  Each limit is about 10x the reading on an H100 (fp32: losses
# 2.5e-7, largest per-parameter gradient 1.14e-4, median parameter
# 1.53e-6, all gradients 8.7e-6; bf16: losses 2.1e-5, per parameter
# 4.94e-2, median 2.48e-2, all 1.97e-2).  In bf16 that rounding noise is
# ~2.5 % on the median gradient, so the full-width comparison checks the
# wiring of the step (every path through the kernels, the right inputs);
# the kernels themselves are held tightly by the backward check of phase 3
# and by the fp32 step.
TRAIN_FP32_LOSS_REL = 3e-6
TRAIN_FP32_GRAD_REL = 1e-3
TRAIN_FP32_MEDIAN_REL = 1.5e-5
TRAIN_FP32_TOTAL_REL = 1e-4
TRAIN_BF16_LOSS_REL = 2e-4
TRAIN_BF16_GRAD_REL = 0.5
TRAIN_BF16_MEDIAN_REL = 0.25
TRAIN_BF16_TOTAL_REL = 0.2
# The bf16 loss limit was set on phase 6's fresh state and blocky labels,
# where the losses' own noise lies far below it.  On a loader's batch the
# feature distance may average a few label-pure positions, and the plain
# versions moved by one input ulp then move it by up to 2.7e-4 on an H100
# (phase 6d, seven runs): no kernel can be held below that.  So where a
# step's floor is measured (:func:`loss_floor`, the largest movement over
# a few random one-ulp directions), each loss is held to the larger of
# the limit and 3x its floor; a fault (a wrong wiring, a kernel off by
# more than rounding) moves a loss by far more than either
LOSS_FLOOR_DIRECTIONS = 3
LOSS_FLOOR_MARGIN = 3
# the UAWarpC train step, kernels against plain versions, from one state
# with the same draws: the three losses (relative) and the head gradients
# (relative L2: all together, the median parameter, the largest one).  fp32
# (B=2, 288^2 -> 256^2): summation order only, which the head's train-mode
# BatchNorm amplifies in single parameters (a BN bias of an uncertainty
# module the most).  bf16 (B=6, 750^2 -> 520^2): both round every
# activation to bf16 at the same places; the full-width comparison checks
# the wiring, the kernels themselves are held tightly by phase 3 and by the
# fp32 step.  Each limit is about 10x the reading on an H100 (fp32: losses
# equal, all gradients 6.07e-6, median parameter 5.43e-6, largest 3.03e-3;
# bf16: losses 2.07e-5, all 4.06e-3, median 5.93e-3, largest 7.68e-2).
ALIGN_FP32_LOSS_REL = 1e-6
ALIGN_FP32_TOTAL_REL = 6e-5
ALIGN_FP32_MEDIAN_REL = 5e-5
ALIGN_FP32_GRAD_REL = 3e-2
ALIGN_BF16_LOSS_REL = 2e-4
ALIGN_BF16_TOTAL_REL = 4e-2
ALIGN_BF16_MEDIAN_REL = 6e-2
ALIGN_BF16_GRAD_REL = 0.8
# the head's BatchNorm running statistics after the step's three passes
# (relative L2 over all of them), the folded step against the serial one
# and against its plain versions: about 10x the reading on an H100
# (3.51e-6 and 1.49e-6)
ALIGN_BF16_STAT_REL = 4e-5
# backward kernels against autograd of the plain versions on the same
# inputs: fp32 sums over up to 131k terms (dw at stage 1) in another
# order, so within GRAD_REL of the largest |ref| of each gradient (the
# reading on an H100 is <= 4.1e-6 of it); a bf16 gradient adds one bf16
# rounding, within BF16_REL*|ref| on top
GRAD_REL = 3e-5
# K3 sums in fp32 from bf16 or fp32 inputs: only summation order separates
# its raw volume and its fused fp32 output from their plain versions;
# inputs are unit-norm features as in the head.  A fused bf16 output adds
# one bf16 rounding: within BF16_REL*|ref| + CORR_ABS of the fp32 fused
# plain version.
CORR_ABS = 1e-5
# align path, bf16 network, K3 against its plain version: the fp32
# correlations round to bf16 at the same place in both, so they differ by
# at most one bf16 ulp where summation order crosses a rounding boundary;
# that travels through three decoder levels into the flow.  Probabilities:
# a flow difference can flip the strict in-bounds warp mask of a pixel on
# the border, which moves that pixel's probabilities by up to the mixing
# weight, so the bound is on the mean and on the share of such pixels.
# Each limit is about 10x the reading on an H100 (flow max rel 1.99e-4,
# mean rel 6.3e-6; probabilities mean abs 3.3e-5, flipped share 2.1e-5).
ALIGN_FLOW_MAX_REL = 2e-3
ALIGN_FLOW_MEAN_REL = 1e-4
ALIGN_PROB_MEAN_ABS = 3e-4
ALIGN_PROB_FLIP = 0.05      # |dp| counted as a flipped pixel above this
ALIGN_PROB_FLIP_SHARE = 3e-4
# probabilities: refine mixes each class with weight s*max(P, M); the sum
# over classes leaves 1 by at most 1 - P on warped pixels
PROB_SUM_ABS = 1e-5
# DeepLabV2 inference (ResNet-101 v1c, 1x540x960), bf16 against fp32 on the
# same weights (the path has no hand-written kernel): the logits' largest
# and mean difference relative to the fp32 ones' largest and mean |value|,
# and the share of pixels whose argmax class agrees.  bf16 rounds every
# activation through 104 BatchNorms and the residual stages of a random
# network; each limit is about 10x the reading on an H100 (max rel 6.16e-2,
# mean rel 4.33e-2, disagreeing pixels 4.15 %), so the check catches a
# miswired path (decorrelated logits), not the rounding itself
DL_BF16_MAX_REL = 0.6
DL_BF16_MEAN_REL = 0.4
DL_ARGMAX_AGREE = 0.6


def log(*a):
    print(*a, flush=True)


# time_ms: calls longer than this (ms) are timed alone, over fewer samples
LONG_CALL_MS, LONG_CALL_REPS = 5.0, 5

# host-clock seconds of each phase and of each part of a phase that is
# timed on its own (``timed``), logged as they end and summed at the end
SECONDS = {}


def add_seconds(what, t0):
    SECONDS[what] = SECONDS.get(what, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def timed(what):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_seconds(what, t0)


def ptxas_summary(text):
    """One line per kernel from nvcc's -Xptxas -v log: its (mangled) name,
    registers and spills."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), None
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=20, warmup=3, batch=10) -> float:
    """CUDA-event time of one call: the median over ``reps`` samples, each
    of ``batch`` back-to-back calls, so a wrapper's host time overlaps the
    previous call's device time as it does in the model (one call between
    two events would time the host where it is the slower).  A call whose
    warm-up took more than ``LONG_CALL_MS`` a call (a plain version at the
    largest shapes, tens of ms on the card) is timed alone, over
    ``LONG_CALL_REPS`` samples: the host is not what it waits for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t) * 1e3 > LONG_CALL_MS * max(warmup - 1, 1):
        reps, batch = min(reps, LONG_CALL_REPS), 1
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms_by_kernel(fn, calls=10, expect=None, tries=5) -> dict:
    """Device time of one call of ``fn`` by device kernel name, from the
    profiler over ``calls`` calls after a warm-up step.  A reading is whole
    when every name was recorded its launches a call times ``calls``: the
    value of the key of ``expect`` that the name contains, else its count
    over ``calls`` rounded up.  The profiler can drop a launch's events, or
    a whole reading's, so a reading that is not whole is taken again, up to
    ``tries`` times; the last is then corrected (each name's mean time a
    launch times its launches a call) and the correction logged.  Raises
    where a name of ``expect`` was not recorded as often as it launches,
    or where nothing was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        ready = []  # the reading's events, kept as its cycle ends
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: ready.extend(
                         p.key_averages())) as prof:
            for n in (2, calls):  # the warm-up step, then the reading
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own range on the device timeline is no kernel
        evs = [e for e in ready
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
        per = {e.key: next((v for sub, v in (expect or {}).items()
                            if sub in e.key), -(-e.count // calls))
               for e in evs}
        short = {e.key[:80]: (e.count, per[e.key] * calls) for e in evs
                 if e.count != per[e.key] * calls}
        if evs and not short:
            break
        log(f"  profiler reading not whole (recorded, launched): "
            f"{short or 'nothing'}"
            + (", taken again" if attempt + 1 < tries else ", corrected"))
    unseen = [sub for sub, v in (expect or {}).items()
              if (v > 0) != any(sub in e.key for e in evs)]
    if not evs or unseen or any(e.count > per[e.key] * calls for e in evs):
        raise AssertionError(f"the profiler recorded {len(evs)} kernels, "
                             f"{unseen} not as expected ({expect} a call)")
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
            / e.count * per[e.key] / 1e3 for e in evs}


def device_ms(fn, calls=10, expect=None) -> float:
    """Device time of one call of ``fn`` (``device_ms_by_kernel``
    summed).  For closures whose host work (autograd's Python and
    dispatch) can outlast their kernels, where CUDA events around
    back-to-back calls would time the host."""
    return sum(device_ms_by_kernel(fn, calls, expect).values())


def check_close(name, got, ref, rel, abs_):
    """Elementwise |got - ref| <= rel*|ref| + abs_ (a number, or a tensor
    of per-element allowances); returns max abs error."""
    import torch
    got = got.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > rel * ref.abs() + abs_
    if bad.any():
        allow = (f"{abs_:g}" if isinstance(abs_, (int, float))
                 else "its allowance")
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond {rel:g}*|ref| + "
            f"{allow}; max abs err {err.max().item():.3e}")
    return err.max().item()


def attention_case(gen, B, N, M, H, dtype):
    """q (B,N,H,64) and k/v as the two halves of one kv projection, as the
    MiT block passes them."""
    import torch
    q = torch.randn(B, N, H, 64, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(B, M, 2, H, 64, generator=gen, device="cuda").to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def dwconv_case(gen, B, S, C, dtype):
    import torch
    x = torch.randn(B, S, S, C, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(C, 1, 3, 3, generator=gen, device="cuda")
         ).to(dtype)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def k4_affine(gen, C):
    """The per-channel fp32 a, c of an eval BatchNorm with drawn parameters
    and statistics, as ``TorchBatchNorm.eval_fold`` computes them."""
    import torch
    from refign_tpu_torch.nn.layers import TorchBatchNorm
    bn = TorchBatchNorm(C).cuda().eval()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=gen,
                                              device="cuda"))
        bn.bias.copy_(0.2 * torch.randn(C, generator=gen, device="cuda"))
        bn.running_mean.copy_(0.3 * torch.randn(C, generator=gen,
                                                device="cuda"))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=gen,
                                              device="cuda"))
        return bn.eval_fold()


def k4_library(x, w, d, affine):
    """What the model ran before K4: cuDNN's grouped conv on the NHWC
    map's channels-last view, then (with ``affine``) TorchBatchNorm's bf16
    arm and ReLU as separate passes."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, d, d,
                 x.shape[-1]).permute(0, 2, 3, 1)
    if affine is None:
        return y
    a, c = affine
    return F.relu((y.float() * a + c).to(x.dtype))


def corr_case(gen, B, H, W, C, dtype):
    """Target and source as the head passes them: unit-norm features, the
    target NHWC, the warped source the NHWC view of grid_sample's NCHW
    output."""
    import torch
    t = torch.randn(B, H, W, C, generator=gen, device="cuda")
    s = torch.randn(B, C, H, W, generator=gen, device="cuda")
    t = t / t.norm(dim=-1, keepdim=True)
    s = s / s.norm(dim=1, keepdim=True)
    return t.to(dtype), s.to(dtype).permute(0, 2, 3, 1)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_reference)
    from refign_tpu_torch.ops.correlation import (
        local_correlation, local_correlation_reference,
        local_correlation_relu_l2norm, local_correlation_relu_l2norm_reference)
    from refign_tpu_torch.ops.dilated_dwconv import (
        dilated_dwconv3x3, dilated_dwconv3x3_reference)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    scale = 64 ** -0.5
    rows = []

    def attn_bound(B, N, M, H, itemsize):
        nbytes = (2 * B * N * H * 64 + 2 * B * M * H * 64) * itemsize
        flops = 4.0 * B * H * N * M * 64
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def dw_bound(B, S, C, itemsize):
        nbytes = (2 * B * S * S * C + 10 * C) * itemsize
        flops = B * S * S * C * 20.0  # 9 FMAs, bias, GELU
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def k4_bound(B, H, W, C, itemsize):
        nbytes = (2 * B * H * W * C + 9 * C) * itemsize
        flops = B * H * W * C * 20.0  # 9 FMAs, the fold's multiply and add
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def corr_bound(B, H, W, C, P, itemsize, out_itemsize):
        nbytes = (2 * B * H * W * C * itemsize
                  + B * H * W * P * P * out_itemsize)
        flops = 2.0 * B * H * W * P * P * C
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    # (name, launches per call of its path, shape, kind, input dtype, K3's
    # output: None for the raw fp32 volume, else the fused mode's dtype;
    # K4: whether the BatchNorm + ReLU epilogue runs)
    cases = [("sra_attention", n, (B_ROWS, N, M, H), "main", bf16, None)
             for (n, N, M, H, _, _) in STAGES]
    cases += [("sra_attention", 0, (2, 1000, 17, 1), "ragged", bf16, None),
              ("sra_attention", 0, (2, 1000, 17, 1), "ragged", torch.float32,
               None)]
    cases += [("dwconv3x3_gelu", n, (B_ROWS, S, C), "main", bf16, None)
              for (n, _, _, _, S, C) in STAGES]
    cases += [("dwconv3x3_gelu", 0, (2, 33, 40), "ragged", bf16, None),
              ("dwconv3x3_gelu", 0, (2, 33, 40), "ragged", torch.float32,
               None)]
    # K4 at the slide frame's ASPP: fused, as the frame runs it, and the
    # conv alone (the UDA step's mode)
    cases += [("dilated_dwconv3x3", 1, (*K4_MAP, d), "main", bf16, True)
              for d in K4_DILATIONS]
    cases += [("dilated_dwconv3x3", 0, (*K4_MAP, d), "conv", bf16, False)
              for d in K4_DILATIONS]
    # K3: the head launches the fused mode with bf16 output ("main"); the
    # raw mode at the same shapes, off the path, for the kernel alone
    cases += [("local_correlation", 1, (*lvl, CORR_PATCH), "main", bf16, bf16)
              for lvl in CORR_LEVELS]
    cases += [("local_correlation", 1, (*lvl, CORR_PATCH), "raw", bf16, None)
              for lvl in CORR_LEVELS]
    # and at the stage-1 UAWarpC train step's levels, 3 launches a step each
    cases += [("local_correlation", ALIGN_TRAIN_PASSES, (*lvl, CORR_PATCH),
               "align-train", bf16, bf16) for lvl in ALIGN_TRAIN_LEVELS]
    cases += [("local_correlation", 0, (*lvl, CORR_PATCH), "raw-train", bf16,
               None) for lvl in ALIGN_TRAIN_LEVELS]
    # and at the folded step's levels (fold_passes: one pass of 18 rows),
    # one launch a step each
    cases += [("local_correlation", 1, (*lvl, CORR_PATCH), "align-fold",
               bf16, bf16) for lvl in ALIGN_FOLD_LEVELS]
    # and at the DeepLabV2 UDA step's levels, one launch a step each
    cases += [("local_correlation", 1, (*lvl, CORR_PATCH), "deeplabv2", bf16,
               bf16) for lvl in DL_CORR_LEVELS]
    cases += [("local_correlation", 0, (2, 33, 70, 40, 5), "ragged",
               torch.float32, None),
              ("local_correlation", 0, (1, 17, 45, 40, 9), "ragged",
               torch.float32, None),
              ("local_correlation", 0, (2, 33, 70, 40, 5), "ragged",
               torch.float32, torch.float32),
              ("local_correlation", 0, (1, 17, 45, 40, 9), "ragged", bf16,
               torch.float32)]

    for name, n_launch, shape, kind, dtype, corr_out in cases:
        t_row = time.perf_counter()
        if name == "sra_attention":
            B, N, M, H = shape
            q, k, v = attention_case(gen, B, N, M, H, dtype)
            ref = sra_attention_reference(q.float(), k.float(), v.float(),
                                          scale)
            got = sra_attention(q, k, v, scale)
            kernel = lambda: sra_attention(q, k, v, scale)  # noqa: E731
            plain = lambda: sra_attention_reference(q, k, v, scale)  # noqa
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, scale=scale)
            bound, bound_by = attn_bound(B, N, M, H, q.element_size())
        elif name == "local_correlation":
            B, H, W, C, P = shape
            t, s = corr_case(gen, B, H, W, C, dtype)
            if corr_out is None:
                ref = local_correlation_reference(t, s, P)
                got = local_correlation(t, s, P)
                kernel = lambda: local_correlation(t, s, P)  # noqa: E731
                plain = lambda: local_correlation_reference(t, s, P)  # noqa
                out_itemsize = 4
            else:
                ref = local_correlation_relu_l2norm_reference(t, s, P)
                got = local_correlation_relu_l2norm(t, s, P, corr_out)
                kernel = lambda: local_correlation_relu_l2norm(  # noqa: E731
                    t, s, P, corr_out)
                plain = lambda: local_correlation_relu_l2norm_reference(  # noqa
                    t, s, P, corr_out)
                out_itemsize = got.element_size()
            library = None  # no single PyTorch call computes it
            bound, bound_by = corr_bound(B, H, W, C, P, t.element_size(),
                                         out_itemsize)
        elif name == "dilated_dwconv3x3":
            B, H, W, C, d = shape
            x, w, _ = dwconv_case(gen, B, H, C, dtype)
            affine = k4_affine(gen, C) if corr_out else None
            ref = dilated_dwconv3x3_reference(x.float(), w.float(), d)
            # fused: the conv's own rounding, times a, besides the output's
            allow = BF16_ABS
            if affine is not None:
                a, c = affine
                allow = BF16_ABS + BF16_REL * (ref * a).abs()
                ref = F.relu(ref * a + c)
            got = dilated_dwconv3x3(x, w, d, affine)
            kernel = lambda: dilated_dwconv3x3(x, w, d, affine)  # noqa: E731
            plain = lambda: dilated_dwconv3x3_reference(  # noqa: E731
                x, w, d, affine)
            library = lambda: k4_library(x, w, d, affine)  # noqa: E731
            bound, bound_by = k4_bound(B, H, W, C, x.element_size())
        else:
            B, S, C = shape
            x, w, b = dwconv_case(gen, B, S, C, dtype)
            ref = dwconv3x3_gelu_reference(x.float(), w.float(), b.float())
            got = dwconv3x3_gelu(x, w, b)
            kernel = lambda: dwconv3x3_gelu(x, w, b)  # noqa: E731
            plain = lambda: dwconv3x3_gelu_reference(x, w, b)  # noqa: E731
            xc = x.permute(0, 3, 1, 2)
            library = lambda: F.gelu(F.conv2d(  # noqa: E731
                xc, w, b, padding=1, groups=C))
            bound, bound_by = dw_bound(B, S, C, x.element_size())
        torch.cuda.synchronize()
        if name == "local_correlation":
            want = torch.float32 if corr_out is None else corr_out
            if got.dtype != want:
                raise AssertionError(f"{name}: output {got.dtype}, not {want}")
            err = check_close(f"{name}{shape} {kind}", got, ref,
                              BF16_REL if want == bf16 else 0.0, CORR_ABS)
        elif name == "dilated_dwconv3x3":
            err = check_close(f"{name}{shape} {kind}", got, ref, BF16_REL,
                              allow)
        elif dtype == bf16:
            err = check_close(f"{name}{shape}", got, ref, BF16_REL, BF16_ABS)
        else:
            err = check_close(f"{name}{shape} fp32", got, ref, 0.0, FP32_ABS)
        mode = ("" if name not in ("local_correlation", "dilated_dwconv3x3")
                else ("bn+relu" if corr_out else "conv")
                if name == "dilated_dwconv3x3" else "raw fp32"
                if corr_out is None else
                "fused " + str(corr_out).replace("torch.", ""))
        row = dict(name=name, shape=list(shape), kind=kind, mode=mode,
                   dtype=str(dtype).replace("torch.", ""),
                   launches_per_forward=n_launch, max_abs_err=err,
                   ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=None if library is None else time_ms(library),
                   bound_ms=bound, bound_by=bound_by)
        row["bound_share"] = bound / row["ms"]
        rows.append(row)
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        log(f"  {name:17s} {kind:6s} {row['dtype']:8s} {mode:11s} "
            f"{str(shape):26s} "
            f"err {err:.2e}  kernel {row['ms']:.4f} ms  bound "
            f"{bound:.4f} ms ({bound_by}, {100 * row['bound_share']:.1f} % "
            f"of it)  plain {row['plain_ms']:.4f} ms  library {lib}")
        del got, ref
        add_seconds(f"3 {name} {kind}", t_row)
    return rows


def check_grad(name, got, ref, dtype):
    """A backward kernel's gradient against the fp32 gradient of the plain
    version: |got - ref| <= GRAD_REL*max|ref| (+ BF16_REL*|ref| in bf16);
    returns the max abs error."""
    import torch
    if got.dtype != dtype:
        raise AssertionError(f"{name}: gradient {got.dtype}, not {dtype}")
    return check_close(name, got, ref,
                       BF16_REL if dtype == torch.bfloat16 else 0.0,
                       GRAD_REL * ref.abs().max().item())


def corr_grad_scale(t, s, g, P, fused):
    """Per element of K3's two gradients, from the plain version, (gt's,
    gs's) pairs of two bounds: the sum of the magnitudes of the fp32 terms
    it sums (the volume's gradient bounded without cancellation), the
    scale of its summation error, which pixels whose clamp makes graw ~1e12
    leave far above an element where their terms cancel; and, in the fused
    mode, the sum over the taps whose raw sum lies within fp32 summation
    noise of 0 (1e-5 of the sum of |t||s|, that sum not 0) of their whole
    term, as the ReLU's slope there may differ between the kernel's
    recomputed sums and the plain version's (the plain version's sum may
    land on 0 exactly, where it takes slope 0.5, while the exact sum and
    the kernel's lie on one side)."""
    import torch
    from refign_tpu_torch.ops.correlation import local_correlation_reference
    g = g.float()
    gmag, jump = g.abs(), torch.zeros_like(g)
    if fused:
        raw = local_correlation_reference(t.float(), s.float(), P)
        absraw = local_correlation_reference(t.float().abs(),
                                             s.float().abs(), P)
        r = raw.clamp_min(0)
        den = r.square().sum(-1, keepdim=True).clamp_min(1e-24).sqrt()
        n = r / den
        slope = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        whole = (g.abs() + n * (g * n).sum(-1, keepdim=True).abs()) / den
        gmag = slope * whole
        # a raw sum that fp32 rounding puts exactly on 0 is near the kink
        # too (the exact sum is not 0 where some product is not): only
        # where every product is 0 is the zero exact, both sides slope 0.5
        jump = torch.where((absraw > 0) & (raw.abs() <= 1e-5 * absraw),
                           whole, 0.0)
        del raw, absraw, r, n, slope, whole
    ta = t.detach().float().abs().requires_grad_()
    sa = s.detach().float().abs().requires_grad_()
    out = local_correlation_reference(ta, sa, P)
    return (torch.autograd.grad(out, (ta, sa), gmag, retain_graph=True),
            torch.autograd.grad(out, (ta, sa), jump))


def corr_grad_limit(ref, scale, jump, dtype):
    """K3-bwd's limit per element, with the bounds of ``corr_grad_scale``:
    GRAD_REL*scale + jump, + BF16_REL*(|ref| + jump) in bf16 (a kernel that
    takes the other ReLU slope at a tap within fp32 noise of the kink
    rounds a value near |ref| + jump).  Returns the limit and the limit
    without the bf16 allowance on jump (the same where jump is 0)."""
    import torch
    lim = GRAD_REL * scale + jump
    if dtype != torch.bfloat16:
        return lim, lim
    old = lim + BF16_REL * ref.abs()
    return old + BF16_REL * jump, old


def kink_only(err, lim, old, jump, name=""):
    """The count of elements within ``lim`` only by the bf16 allowance on
    jump (beyond ``old``); each must have jump > 0."""
    only = (err > old) & (err <= lim)
    if (jump[only] <= 0).any():
        raise AssertionError(f"{name}: an element passes by the bf16 "
                             f"allowance on jump with jump 0")
    return int(only.sum())


def check_corr_grad(name, got, ref, scale, jump, dtype):
    """K3's backward against the fp32 gradient of its plain version within
    ``corr_grad_limit``; returns the max abs error and the count of
    elements that pass only by the bf16 allowance on jump (``kink_only``)."""
    import torch
    if got.dtype != dtype:
        raise AssertionError(f"{name}: gradient {got.dtype}, not {dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite gradient")
    err = (got.float() - ref).abs()
    lim, old = corr_grad_limit(ref, scale, jump, dtype)
    bad = err > lim
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond the "
                             f"limit; max abs err {err.max().item():.3e}")
    return err.max().item(), kink_only(err, lim, old, jump, name)


def corr_grad_case(gen, B, H, W, C, P, dtype, fused):
    """The head's inputs (``corr_case``) with the exact zeros of the train
    step: a target pixel of zeros and a source block of zeros that whole
    9x9 windows lie in (warped out of the image), and a gradient in the
    output's dtype (bf16 in the fused mode with bf16 inputs, else fp32)."""
    import torch
    t, s = corr_case(gen, B, H, W, C, dtype)
    t[0, H // 2, W // 3] = 0
    s[:, :min(H, 12), :min(W, 14)] = 0
    out_dtype = dtype if fused else torch.float32
    g = torch.randn(B, H, W, P * P, generator=gen, device="cuda").to(
        out_dtype)
    return t, s, g


def phase_backward_kernels():
    """K1 and K2 backward against autograd of their plain versions, at the
    train step's shapes (bf16: the path; fp32: the precision check) and
    ragged ones, k/v always the two halves of one kv tensor."""
    import torch
    import torch.nn.functional as F
    from refign_tpu_torch.ops.attention import (sra_attention_backward,
                                                sra_attention_forward,
                                                sra_attention_reference)
    from refign_tpu_torch.ops.correlation import (
        local_correlation_backward, local_correlation_reference,
        local_correlation_relu_l2norm_reference)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu_backward,
                                             dwconv3x3_gelu_reference)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    scale = 64 ** -0.5
    rows = []

    def bound(nbytes, flops, itemsize):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def grads_of(fn, inputs, g):
        """fp32 gradient of the plain version on the fp32 values of the
        inputs (the reference), and a closure timing the plain version's
        own backward in the inputs' dtype (graph kept)."""
        ref_in = [t.detach().float().requires_grad_() for t in inputs]
        ref = torch.autograd.grad(fn(*ref_in), ref_in, g.float())
        own_in = [t.detach().requires_grad_() for t in inputs]
        out = fn(*own_in)
        return ref, lambda: torch.autograd.grad(out, own_in, g,
                                                retain_graph=True)

    cases = []
    for n, N, M, H, S, C in TRAIN_STAGES:
        per_step = n * TRAIN_PASSES
        cases += [("sra_attention_backward", per_step, (TRAIN_ROWS, N, M, H),
                   "main", bf16),
                  ("sra_attention_backward", 0, (TRAIN_ROWS, N, M, H),
                   "fp32", torch.float32)]
    cases += [("sra_attention_backward", 0, (2, 1000, 17, 3), "ragged", dt)
              for dt in (bf16, torch.float32)]
    for n, N, M, H, S, C in TRAIN_STAGES:
        per_step = n * TRAIN_PASSES
        cases += [("dwconv3x3_gelu_backward", per_step, (TRAIN_ROWS, S, C),
                   "main", bf16),
                  ("dwconv3x3_gelu_backward", 0, (TRAIN_ROWS, S, C), "fp32",
                   torch.float32)]
    cases += [("dwconv3x3_gelu_backward", 0, (2, 33, 40), "ragged", dt)
              for dt in (bf16, torch.float32)]
    # K3: the head launches the fused mode (bf16 in and out) at the three
    # levels, once a pass; the raw mode (fp32 gradient) off the path
    cases += [("local_correlation_backward", ALIGN_TRAIN_PASSES,
               (*lvl, CORR_PATCH), "main", bf16) for lvl in ALIGN_TRAIN_LEVELS]
    cases += [("local_correlation_backward", 0, (*lvl, CORR_PATCH), "raw",
               bf16) for lvl in ALIGN_TRAIN_LEVELS]
    # the path's own call: the target is frozen, so the head's backward asks
    # for gs alone (fused bf16)
    cases += [("local_correlation_backward", 0, (*lvl, CORR_PATCH), "path",
               bf16) for lvl in ALIGN_TRAIN_LEVELS]
    # and the folded step's (fold_passes: 18 rows, one launch a level)
    cases += [("local_correlation_backward", 1, (*lvl, CORR_PATCH),
               "path-fold", bf16) for lvl in ALIGN_FOLD_LEVELS]
    cases += [("local_correlation_backward", 0, (2, 33, 70, 40, 5), kind,
               torch.float32) for kind in ("ragged", "ragged-raw")]
    cases += [("local_correlation_backward", 0, (1, 17, 45, 40, 9), kind,
               bf16) for kind in ("ragged", "ragged-raw")]

    for name, n_launch, shape, kind, dtype in cases:
        t_row = time.perf_counter()
        expect = None  # the kernels a call launches, where they are known
        if name == "sra_attention_backward":
            B, N, M, H = shape
            q, k, v = attention_case(gen, B, N, M, H, dtype)
            g = torch.randn(B, N, H, 64, generator=gen, device="cuda").to(dtype)
            (dq_r, dk_r, dv_r), plain = grads_of(
                lambda a, b_, c: sra_attention_reference(a, b_, c, scale),
                (q, k, v), g)
            # the grad-mode forward's statistics, which the bf16 backward
            # reads (fp32 has none); the forward is not timed here
            _, stats = sra_attention_forward(q, k, v, scale, stats=True)
            got = sra_attention_backward(q, k, v, g, scale, stats)
            refs = (dq_r, dk_r, dv_r)
            kernel = lambda: sra_attention_backward(  # noqa: E731
                q, k, v, g, scale, stats)
            qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            gt = g.transpose(1, 2)
            library = lambda: torch.autograd.grad(  # noqa: E731
                F.scaled_dot_product_attention(qs, ks, vs, scale=scale),
                (qs, ks, vs), gt)
            nbytes = (3 * B * N * H * 64 + 4 * B * M * H * 64) \
                * q.element_size()
            bnd, bound_by = bound(nbytes, 10.0 * B * H * N * M * 64,
                                  q.element_size())
        elif name == "local_correlation_backward":
            B, H, W, C, P = shape
            fused = kind in ("main", "ragged", "path", "path-fold")
            need_t = kind not in ("path", "path-fold")
            t, s, g = corr_grad_case(gen, B, H, W, C, P, dtype, fused)
            plain_fn = (local_correlation_relu_l2norm_reference if fused
                        else local_correlation_reference)
            refs, plain = grads_of(lambda a, b_: plain_fn(a, b_, P), (t, s),
                                   g)
            if not need_t:  # the plain backward of gs alone
                s_in = s.detach().requires_grad_()
                out = plain_fn(t, s_in, P)
                plain = lambda: torch.autograd.grad(  # noqa: E731
                    out, s_in, g, retain_graph=True)
            scales, jumps = corr_grad_scale(t, s, g, P, fused)
            got = local_correlation_backward(t, s, g, P, fused, need_t=need_t)
            kernel = lambda: local_correlation_backward(  # noqa: E731
                t, s, g, P, fused, need_t=need_t)
            library = None  # no single PyTorch call computes it
            # a call's kernels: graw's in the fused mode, then the
            # gradients' (bf16: the tensor-core pair; fp32: the CUDA-core)
            expect = ({"::graw_kernel<": int(fused), "::grad_kernel<": 1}
                      if dtype == bf16 else
                      {"::raw_grad_kernel<": int(fused),
                       "::input_grad_kernel<": 1})
            # t, s and g read, each wanted gradient written
            nbytes = ((3 + need_t) * B * H * W * C * t.element_size()
                      + B * H * W * P * P * g.element_size())
            bnd, bound_by = bound(nbytes, 4.0 * B * H * W * P * P * C,
                                  t.element_size())
        else:
            B, S, C = shape
            x, w, b = dwconv_case(gen, B, S, C, dtype)
            # the main path's weights are OIHW; the ragged cases take HWIO
            if kind == "ragged":
                w = w.permute(2, 3, 1, 0)
            g = torch.randn(B, S, S, C, generator=gen, device="cuda").to(dtype)
            refs, plain = grads_of(dwconv3x3_gelu_reference, (x, w, b), g)
            got = dwconv3x3_gelu_backward(x, w, b, g)
            kernel = lambda: dwconv3x3_gelu_backward(x, w, b, g)  # noqa
            xc = x.detach().permute(0, 3, 1, 2).requires_grad_()
            wc = (w if w.shape[0] == C else w.permute(3, 2, 0, 1)) \
                .detach().requires_grad_()
            bc = b.detach().requires_grad_()
            yc = F.gelu(F.conv2d(xc, wc, bc, padding=1, groups=C))
            gc = g.permute(0, 3, 1, 2)
            library = lambda: torch.autograd.grad(  # noqa: E731
                yc, (xc, wc, bc), gc, retain_graph=True)
            nbytes = (3 * B * S * S * C + 20 * C) * x.element_size()
            bnd, bound_by = bound(nbytes, 60.0 * B * S * S * C,
                                  x.element_size())
        torch.cuda.synchronize()
        kink = ""
        if name == "local_correlation_backward":
            checked = [check_corr_grad(f"{name}{shape} {kind} d{i}", a, r,
                                       sc, jp, dtype)
                       for i, (a, r, sc, jp) in enumerate(zip(
                           got, refs, scales, jumps)) if a is not None]
            err = max(e for e, _ in checked)
            kink = (" (" + "/".join(str(n) for _, n in checked)
                    + " elements within the limit only by the bf16 "
                    "allowance on jump)")
            del scales, jumps
        else:
            err = max(check_grad(f"{name}{shape} {kind} d{i}", a, r, dtype)
                      for i, (a, r) in enumerate(zip(got, refs)))
        # device time of all three: the plain and library backwards run
        # through autograd, and the kernels' wrapper allocates and checks in
        # Python, host work that outlasts the kernels at these shapes (the
        # wrapper's CUDA-event time is logged beside it); one reading of
        # the kernel gives its total and its split by device kernel
        split = device_ms_by_kernel(kernel, expect=expect)
        row = dict(name=name, shape=list(shape), kind=kind, mode="",
                   dtype=str(dtype).replace("torch.", ""),
                   launches_per_forward=n_launch, max_abs_err=err,
                   ms=sum(split.values()),
                   wrapper_ms=time_ms(kernel),
                   plain_ms=device_ms(plain),
                   library_ms=None if library is None else device_ms(library),
                   bound_ms=bnd, bound_by=bound_by)
        if not all(row[k] > 0 for k in ("ms", "plain_ms", "library_ms")
                   if row[k] is not None):
            raise AssertionError(f"{name}{shape}: the profiler recorded no "
                                 f"device time")
        row["bound_share"] = bnd / row["ms"]
        rows.append(row)
        if name == "local_correlation_backward" and dtype == bf16:
            # the bf16 body's two kernels: graw (fused mode), gt and gs
            log(f"  {name} {kind} {shape} by kernel: " + ", ".join(
                f"{k.split('::')[-1].split('(')[0]} {ms:.4f} ms"
                for k, ms in sorted(split.items())))
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        log(f"  {name:26s} {kind:10s} {row['dtype']:8s} {str(shape):22s} "
            f"err {err:.2e}  kernel {row['ms']:.4f} ms (wrapper "
            f"{row['wrapper_ms']:.4f})  bound {bnd:.4f} ms ({bound_by}, "
            f"{100 * row['bound_share']:.1f} % of it)  plain "
            f"{row['plain_ms']:.4f} ms  library {lib}{kink}")
        del got, refs, plain, library
        add_seconds(f"3 {name} {kind}", t_row)
    return rows


def phase_native():
    """The native host correlation (``refign_tpu_torch/native``: C++ and
    OpenMP, built with g++ at first use), an oracle on no path, against
    K3's plain version and K3's raw fp32 mode on the card at a small
    shape; fp32 sums in another order."""
    import torch
    from refign_tpu_torch import native
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_reference)
    gen = torch.Generator(device="cuda").manual_seed(2)
    t0 = time.perf_counter()
    native.get_lib()
    built = time.perf_counter() - t0
    t, s = corr_case(gen, 2, 33, 47, 64, torch.float32)
    got = torch.from_numpy(native.correlation_forward(
        t.cpu().numpy(), s.cpu().numpy(), CORR_PATCH)).cuda()
    err = check_close("native correlation vs K3's plain version", got,
                      local_correlation_reference(t, s, CORR_PATCH), 0.0,
                      CORR_ABS)
    err_k3 = check_close("native correlation vs K3 (raw fp32)", got,
                         local_correlation(t, s, CORR_PATCH), 0.0, CORR_ABS)
    log(f"  native host correlation (built and loaded in {built:.1f} s) at "
        f"(2, 33, 47, 64), P={CORR_PATCH}: max abs err {err:.2e} against "
        f"K3's plain version, {err_k3:.2e} against K3 (limit {CORR_ABS:g})")


def phase_lab_yardsticks():
    """The Pallas functions of ``tools/`` that no path runs (L1-L6), at
    their own production shapes: each one's bound (bytes of its inputs and
    output over the memory rate, or its products over the bf16 rate) and
    the time of the one PyTorch call that computes the same function
    (SDPA for L1-L5; ``F.grid_sample`` in fp32, as ``ops/warp.py`` calls
    it, for L6), summed over a call of the path each would serve: L1-L5
    over the 3/6/40/3 blocks of an HRDA* forward's four stages (per 30
    slide rows), L6 over the 3 head passes of a stage-1 UAWarpC step."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    blocks = [s[0] for s in STAGES]

    def bound(nbytes, flops):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS)

    def attention(BH, N, M, D=64):
        q = torch.randn(BH, 1, N, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(BH, 1, M, D, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        return ms, bound(2 * BH * (2 * N + 2 * M) * D, 4.0 * BH * N * M * D)

    # L1-L4: tools/attn_kernel_lab.py:268-271, (B*H, N, D, M); L5:
    # tools/attn_opt_lab.py:44-50, (B, N, H, D, M)
    labs = {"L1-L4": [attention(BH, N, M) for BH, N, _, M in (
                (30, 18225, 64, 289), (60, 4624, 64, 289),
                (150, 1156, 64, 289), (240, 289, 64, 289))],
            "L5": [attention(B * H, N, M) for B, N, H, _, M in (
                (30, 18225, 1, 64, 256), (30, 4624, 2, 64, 289),
                (30, 1156, 5, 64, 289), (30, 289, 8, 64, 289))]}
    for name, rows in labs.items():
        ms = sum(n * r[0] for n, r in zip(blocks, rows))
        bnd = sum(n * r[1] for n, r in zip(blocks, rows))
        log(f"  {name} (lab) per stage shape: SDPA "
            f"{[round(r[0], 4) for r in rows]} ms, bound "
            f"{[round(r[1], 4) for r in rows]} ms; per forward (3/6/40/3 "
            f"blocks): SDPA {ms:.3f} ms, bound {bnd:.3f} ms")
    # L6: tools/warp_kernel_lab.py:322-323, the head's feature warps of
    # the stage-1 step, (B, H, W, C)
    rows = []
    for B, H, W, C in ((6, 130, 130, 256), (6, 65, 65, 512)):
        x = torch.randn(B, C, H, W, generator=gen, device="cuda")
        grid = torch.rand(B, H, W, 2, generator=gen, device="cuda") * 2 - 1
        ms = time_ms(lambda: F.grid_sample(x, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True))
        rows.append((ms, bound(4 * (2 * x.numel() + grid.numel()),
                               8.0 * x.numel())))
    log(f"  L6 (lab) grid_sample fp32 at (6,130,130,256), (6,65,65,512): "
        f"{[round(r[0], 4) for r in rows]} ms, bound "
        f"{[round(r[1], 4) for r in rows]} ms; per stage-1 step (3 passes): "
        f"{3 * sum(r[0] for r in rows):.3f} ms, bound "
        f"{3 * sum(r[1] for r in rows):.4f} ms")


def plain_versions(enabled: bool):
    """Test-only switch: route the MiT blocks, the DAFormer head's dilated
    depthwise convs and the UAWarpC head's local correlations through the
    kernels' plain versions (enabled) or back through the kernel
    wrappers."""
    from refign_tpu_torch.models import mix_transformer as mt
    from refign_tpu_torch.models.heads import uawarpc
    from refign_tpu_torch.nn import layers
    from refign_tpu_torch.ops import (attention, correlation, dilated_dwconv,
                                      dwconv)
    mt.sra_attention = (attention.sra_attention_reference if enabled
                        else attention.sra_attention)
    mt.dwconv3x3_gelu = (dwconv.dwconv3x3_gelu_reference if enabled
                         else dwconv.dwconv3x3_gelu)
    uawarpc.local_correlation_relu_l2norm = (
        correlation.local_correlation_relu_l2norm_reference if enabled
        else correlation.local_correlation_relu_l2norm)
    layers.dilated_dwconv3x3 = (
        dilated_dwconv.dilated_dwconv3x3_reference if enabled
        else dilated_dwconv.dilated_dwconv3x3)


def phase_main_path(card):
    import torch
    from refign_tpu_torch.entry import build_hrda_star, hrda_slide_forward
    from refign_tpu_torch.ops.attention import sra_attention
    from refign_tpu_torch.ops.dilated_dwconv import dilated_dwconv3x3
    from refign_tpu_torch.ops.dwconv import dwconv3x3_gelu

    counted = (sra_attention, dwconv3x3_gelu, dilated_dwconv3x3)
    per_forward = {"sra_attention": LAUNCHES_PER_FORWARD,
                   "dwconv3x3_gelu": LAUNCHES_PER_FORWARD,
                   "dilated_dwconv3x3": K4_LAUNCHES_PER_FORWARD}

    # small fp32 model first: kernels against plain versions, tightly
    small = build_hrda_star("mit_b1", dtype=torch.float32, device="cuda",
                            seed=1, channels=64)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(1, 128, 192, 3, generator=gen).cuda()
    out_k = hrda_slide_forward(small, img, (128, 128), (64, 64))
    plain_versions(True)
    try:
        out_p = hrda_slide_forward(small, img, (128, 128), (64, 64))
    finally:
        plain_versions(False)
    rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    log(f"  mit_b1 fp32 128x192: kernels vs plain max rel {rel:.2e} "
        f"(limit {E2E_FP32_REL:g})")
    if not rel <= E2E_FP32_REL:
        raise AssertionError(f"fp32 small model: kernels vs plain {rel}")
    del small, out_k, out_p

    t0 = time.perf_counter()
    model = build_hrda_star("mit_b5", dtype=torch.bfloat16, device="cuda",
                            seed=0)
    torch.cuda.synchronize()
    log(f"  built MiT-B5 HRDA* in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    img = torch.randn(1, 1080, 1920, 3, generator=gen).to(
        "cuda", torch.bfloat16)

    for f in counted:
        f.launches = 0
    dilated_dwconv3x3.fused = 0
    out = hrda_slide_forward(model, img)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counted}
    fused = dilated_dwconv3x3.fused
    log(f"  launches in one forward: {launches}; K4's with the BatchNorm + "
        f"ReLU epilogue: {fused}")
    for name, n in launches.items():
        if n != per_forward[name]:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{per_forward[name]}")
    if fused != K4_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{fused} of K4's launches fused, expected "
                             f"{K4_LAUNCHES_PER_FORWARD}")
    if tuple(out.shape) != (1, 1080, 1920, 19):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if out.dtype != torch.bfloat16 or not torch.isfinite(out).all():
        raise AssertionError("output not finite bf16")

    plain_versions(True)
    try:
        ref = hrda_slide_forward(model, img)
    finally:
        plain_versions(False)
    diff = (out.float() - ref.float()).abs()
    max_rel = (diff.max() / ref.float().abs().max()).item()
    mean_rel = (diff.mean() / ref.float().abs().mean()).item()
    log(f"  bf16 forward vs plain versions: max rel {max_rel:.3e} "
        f"(limit {E2E_MAX_REL:g}), mean rel {mean_rel:.3e} "
        f"(limit {E2E_MEAN_REL:g}); |ref| max "
        f"{ref.float().abs().max().item():.3f}")
    if not (max_rel <= E2E_MAX_REL and mean_rel <= E2E_MEAN_REL):
        raise AssertionError("bf16 forward disagrees with plain versions")
    del ref, diff

    sec, times = warm_median(lambda: hrda_slide_forward(model, img))
    log(f"  warm forward: median {sec * 1e3:.1f} ms over {len(times)} "
        f"({[round(x * 1e3, 1) for x in times]} ms) = {1.0 / sec:.3f} "
        f"images/s on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_device(lambda: hrda_slide_forward(model, img), sec, "forward")
    with timed("4 StepTracer window"):
        trace_window(lambda: hrda_slide_forward(model, img), "HRDA* forward")
    return launches, sec


# K1's device kernel, as KERNEL_GROUPS names it
TRACE_KERNEL = "sra_attention_kernel"


def trace_window(fn, what):
    """``utils/profiling.StepTracer`` over calls 1 and 2 of four calls of
    ``fn`` (the window [1, 3)): it must write one trace file, and the file
    must hold K1's kernel; logs the file's size, the kernel's count in it
    and the traced calls' times beside the others."""
    import torch
    from refign_tpu_torch.utils.profiling import StepTracer
    logdir = tempfile.mkdtemp(prefix="refign_trace_")
    try:
        tracer = StepTracer(logdir, start=1, stop=3)
        times = []
        for step in range(4):
            tracer.step(step)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if tracer.active:
            raise AssertionError("the step tracer did not close at its stop")
        files = [f for f in os.listdir(logdir)
                 if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"the step tracer wrote {files}")
        path = os.path.join(logdir, files[0])
        with open(path) as f:
            found = f.read().count(TRACE_KERNEL)
        if not found:
            raise AssertionError(f"the trace of two {what} calls holds no "
                                 f"{TRACE_KERNEL}")
        log(f"  StepTracer over {what} calls 1-2 of 0-3: one trace file, "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, {found} mentions of "
            f"{TRACE_KERNEL}; calls "
            f"{[round(x * 1e3, 1) for x in times]} ms (1 and 2 traced)")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def warm_median(fn, n=5):
    """Median host-clock seconds of n synchronised calls, and their list."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


def phase_align(card):
    import torch
    import torch.nn.functional as F
    from refign_tpu_torch.entry import (align_forward, build_alignment,
                                        refign_align_refine)
    from refign_tpu_torch.ops.correlation import local_correlation as k3

    # small fp32 network first: K3 against its plain version, tightly
    small = build_alignment(dtype=torch.float32, device="cuda", seed=1)
    gen = torch.Generator().manual_seed(1)
    a, b = (torch.randn(1, 256, 320, 3, generator=gen).cuda()
            for _ in range(2))
    flow_k, unc_k = align_forward(small, a, b)
    plain_versions(True)
    try:
        flow_p, unc_p = align_forward(small, a, b)
    finally:
        plain_versions(False)
    rel = ((flow_k - flow_p).abs().max() / flow_p.abs().max()).item()
    unc_err = (unc_k - unc_p).abs().max().item()
    log(f"  alignment fp32 1x256x320: K3 vs plain flow max rel {rel:.2e}, "
        f"uncertainty max abs {unc_err:.2e} (limit {E2E_FP32_REL:g} each)")
    if not (rel <= E2E_FP32_REL and unc_err <= E2E_FP32_REL):
        raise AssertionError(f"fp32 alignment: K3 vs plain {rel}, {unc_err}")
    del small, flow_k, flow_p, unc_k, unc_p

    t0 = time.perf_counter()
    net = build_alignment(dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  built VGG-16 + UAWarpC in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (ALIGN_B, ALIGN_HW, ALIGN_HW)
    img_trg, img_ref = (
        torch.randn(*shape, 3, generator=gen, device="cuda").bfloat16()
        for _ in range(2))
    # teacher-like logits: a coarse field at 1/16, upsampled
    logits_trg, logits_ref = (F.interpolate(
        3.0 * torch.randn(ALIGN_B, 19, ALIGN_HW // 16, ALIGN_HW // 16,
                          generator=gen, device="cuda"),
        (ALIGN_HW, ALIGN_HW), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1).bfloat16() for _ in range(2))

    def run():
        return refign_align_refine(net, logits_trg, logits_ref, img_trg,
                                   img_ref)

    torch.cuda.reset_peak_memory_stats()
    k3.launches = 0
    probs, mask, cert = run()
    torch.cuda.synchronize()
    launches = k3.launches
    log(f"  launches in one align and refine: local_correlation {launches}")
    if launches != len(CORR_LEVELS):
        raise AssertionError(f"local_correlation launched {launches} times, "
                             f"expected {len(CORR_LEVELS)}")
    if tuple(probs.shape) != (*shape, 19) or probs.dtype != torch.float32:
        raise AssertionError(f"probabilities {tuple(probs.shape)} "
                             f"{probs.dtype}")
    if not (torch.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise AssertionError("probabilities not finite in [0, 1]")
    sum_err = (probs.sum(-1) - 1).abs()
    bound = torch.where(mask, 1.0 - cert[..., 0], 0.0) + PROB_SUM_ABS
    log(f"  probabilities {tuple(probs.shape)} fp32: |sum - 1| max "
        f"{sum_err.max().item():.3e} (bound 1 - P on warped pixels, "
        f"{PROB_SUM_ABS:g} elsewhere); warp mask true on "
        f"{mask.float().mean().item():.4f} of pixels; confidence mean "
        f"{cert.float().mean().item():.4f}")
    if not (sum_err <= bound).all():
        raise AssertionError("probability sums beyond their bound")
    flow_k, _ = align_forward(net, img_trg, img_ref)

    plain_versions(True)
    try:
        probs_p, _, _ = run()
        flow_p, _ = align_forward(net, img_trg, img_ref)
    finally:
        plain_versions(False)
    fdiff = (flow_k - flow_p).abs()
    f_max = (fdiff.max() / flow_p.abs().max()).item()
    f_mean = (fdiff.mean() / flow_p.abs().mean()).item()
    pdiff = (probs - probs_p).abs()
    p_mean = pdiff.mean().item()
    p_flip = (pdiff.amax(-1) > ALIGN_PROB_FLIP).float().mean().item()
    log(f"  bf16 align vs plain versions: flow max rel {f_max:.3e} (limit "
        f"{ALIGN_FLOW_MAX_REL:g}), mean rel {f_mean:.3e} (limit "
        f"{ALIGN_FLOW_MEAN_REL:g}), |flow| max "
        f"{flow_p.abs().max().item():.2f} px; probabilities mean abs "
        f"{p_mean:.3e} (limit {ALIGN_PROB_MEAN_ABS:g}), max abs "
        f"{pdiff.max().item():.3e}, share of pixels beyond "
        f"{ALIGN_PROB_FLIP:g} {p_flip:.2e} (limit {ALIGN_PROB_FLIP_SHARE:g})")
    if not (f_max <= ALIGN_FLOW_MAX_REL and f_mean <= ALIGN_FLOW_MEAN_REL
            and p_mean <= ALIGN_PROB_MEAN_ABS
            and p_flip <= ALIGN_PROB_FLIP_SHARE):
        raise AssertionError("bf16 align disagrees with plain versions")
    del probs_p, flow_p, pdiff, fdiff, sum_err, bound

    sec, times = warm_median(run)
    log(f"  warm align and refine (B=4, 1024^2): median {sec * 1e3:.1f} ms "
        f"over {len(times)} ({[round(x * 1e3, 1) for x in times]} ms) = "
        f"{ALIGN_B / sec:.2f} image pairs/s on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_device(run, sec, "align and refine", top_n=25)
    return launches, sec


def uda_batch(B, S, seed, device):
    """A seeded synthetic UDA batch: normalised-scale source, target and
    reference images (the reference a shifted, noisy target, so the warp
    has structure to find) and blocky source labels of 128-pixel blocks
    (so the feature-distance mask keeps pixels) with an ignored strip."""
    import torch
    g = torch.Generator().manual_seed(seed)
    trg = torch.randn(B, S, S, 3, generator=g)
    ref = 0.9 * trg.roll(3, dims=2) + 0.1 * torch.randn(B, S, S, 3,
                                                        generator=g)
    blocks = torch.randint(0, 19, (B, S // 128, S // 128), generator=g)
    sem = blocks.repeat_interleave(128, 1).repeat_interleave(128, 2)
    sem[:, :8] = 255
    batch = dict(image_src=torch.randn(B, S, S, 3, generator=g),
                 image_trg=trg, image_ref=ref, semantic_src=sem)
    return {k: v.to(device) for k, v in batch.items()}


def grads_kernels_vs_plain(trainer, batch, gen=None, draws=None):
    """From one state and the same draws, the gradient of one step through
    the kernels and through their plain versions (the state is restored
    after each).  The draws are the given ones, or drawn from ``gen`` on
    the Refign branch.  Returns the two runs' logs and gradients by
    name."""
    from refign_tpu_torch.uda.trainer import draw_step
    if draws is None:
        draws = draw_step(trainer.cfg, batch, gen)
        draws.use_ref_as_target = False  # the Refign branch, with its align
    kernel = uda_run(trainer, batch, draws)
    plain_versions(True)
    try:
        plain = uda_run(trainer, batch, draws)
    finally:
        plain_versions(False)
    return kernel, plain


def uda_run(trainer, batch, draws):
    """One UDA step without its update from the trainer's state: its logs
    and the student's gradients by name; the student and the teacher are
    restored after it."""
    from refign_tpu_torch.uda.trainer import forward_backward
    state = trainer.state
    saved = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (state.student, state.teacher)]
    logs = forward_backward(trainer, batch, draws)
    grads = {n: p.grad.detach().clone()
             for n, p in state.student.named_parameters()
             if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    for m, sd in zip((state.student, state.teacher), saved):
        m.load_state_dict(sd)
    return logs, grads


def loss_floor(trainer, batch, draws, plain=True, what="the Refign branch"):
    """The step against itself on its normalised input images moved by one
    ulp of the compute dtype in random directions (the networks cast their
    input to it first, so a smaller move vanishes), from one state with the
    same draws, through the plain versions or (``plain=False``) the
    kernels: each loss's largest relative movement over
    ``LOSS_FLOOR_DIRECTIONS`` directions, the noise floor under a loss
    check of that step (the method of the UAWarpC and DeepLabV2 steps'
    checks).  Also logs how many feature positions the feature-distance
    loss averages over (few positions: a noisy mean)."""
    import torch
    from refign_tpu_torch.uda.refine import _class_mask, downscale_label_ratio
    from refign_tpu_torch.uda.trainer import device_normalize, forward_backward
    state, cfg = trainer.state, trainer.cfg
    base = dict(device_normalize(cfg, batch))
    cdt = cfg.dtype
    for k in ("image_src", "image_trg", "image_ref"):
        base[k] = base[k].to(cdt).float()
    gen = torch.Generator().manual_seed(0)
    moves = []
    for _ in range(LOSS_FLOOR_DIRECTIONS):
        moved = dict(base)
        for k in ("image_src", "image_trg", "image_ref"):
            x = base[k].to(cdt)
            up = (torch.rand(x.shape, generator=gen) < 0.5).to(x.device)
            inf = torch.full_like(x, float("inf"))
            moved[k] = torch.where(up, torch.nextafter(x, inf),
                                   torch.nextafter(x, -inf)).float()
        moves.append(moved)
    saved = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (state.student, state.teacher)]

    def run(b):
        logs = forward_backward(trainer, b, draws)
        state.optimizer.zero_grad(set_to_none=True)
        for m, sd in zip((state.student, state.teacher), saved):
            m.load_state_dict(sd)
        return {k: float(v) for k, v in logs.items()}

    plain_versions(plain)
    try:
        a = run(base)
        runs = [run(m) for m in moves]
    finally:
        plain_versions(False)
    keys = ("train_loss_src", "train_loss_featdist_src", "train_loss_uda_trg")
    each = [{k: abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for k in keys}
            for b in runs]
    rel = {k: max(e[k] for e in each) for k in keys}
    # HRDA's feature distance: the context crop's last stage against the
    # ImageNet copy, over the positions whose label block is >= 75 % one
    # thing class (refign_tpu_torch/uda/refine.py:fdist_loss)
    gt = base["semantic_src"]
    scale = 32 * (2 if cfg.use_hrda else 1)
    small = downscale_label_ratio(gt, scale, cfg.fdist_scale_min_ratio,
                                  cfg.num_classes)
    fdc = _class_mask(cfg.fdist_classes, cfg.num_classes + 256, gt.device)
    n_pos = int(fdc[small.clamp(0, cfg.num_classes + 255)].sum())
    log(f"  {'plain versions' if plain else 'kernels'} against themselves "
        f"under a one-ulp (in the compute dtype) change of the normalised "
        f"input images in {LOSS_FLOOR_DIRECTIONS} random directions "
        f"(B={gt.shape[0]} + {base['image_trg'].shape[0]}, {what}), the "
        "largest: " + ", ".join(f"{k[len('train_loss_'):]} {v:.2e}"
                                for k, v in rel.items())
        + " (featdist each: " + ", ".join(
            f"{e['train_loss_featdist_src']:.2e}" for e in each)
        + f"); the feature distance averages {n_pos} of "
        f"{small.numel()} positions")
    return rel


def backward_repeat(trainer, batch, draws):
    """The step through the kernels twice from one state with the same
    draws: whether its losses and gradients repeat bit for bit (atomic
    adds on the card, e.g. in the bilinear resize's backward, need not),
    and the gradients' largest relative difference."""
    from refign_tpu_torch.uda.trainer import forward_backward
    state = trainer.state
    saved = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (state.student, state.teacher)]

    def run():
        logs = forward_backward(trainer, batch, draws)
        grads = {n: p.grad.detach().clone()
                 for n, p in state.student.named_parameters()
                 if p.grad is not None}
        state.optimizer.zero_grad(set_to_none=True)
        for m, sd in zip((state.student, state.teacher), saved):
            m.load_state_dict(sd)
        return {k: float(v) for k, v in logs.items()}, grads

    (la, ga), (lb, gb) = run(), run()
    worst = max(((ga[n] - gb[n]).abs().max()
                 / ga[n].abs().max().clamp_min(1e-30)).item() for n in ga)
    varies = la != lb or worst > 0
    log(f"  the fit's last step through the kernels twice from one state: "
        f"losses {'equal' if la == lb else 'differ'}, gradients "
        + (f"differ by up to {worst:.2e} of a parameter's largest"
           if worst > 0 else "bit-equal"))
    return varies


def compare_step(what, kernel, plain, loss_limit, grad_limit, total_limit,
                 median_limit, loss_noise=None, versus="kernels vs plain"):
    """Relative differences of the three losses and the relative L2 error
    of every parameter's gradient, kernels against plain versions: the
    largest, the median and all gradients together, each against its
    limit.  A gradient that is zero in exact arithmetic (a bias that only
    shifts a channel before a batch-statistics BN, which removes any such
    shift) holds rounding noise alone, so each parameter's error is taken
    relative to its gradient's norm or to a thousandth of the RMS
    parameter gradient norm, whichever is larger.  Given the losses' own
    one-ulp noise floor from this run (:func:`loss_floor`), a loss is held
    to the larger of ``loss_limit`` and ``LOSS_FLOOR_MARGIN`` x its
    floor."""
    import torch
    (logs_k, g_k), (logs_p, g_p) = kernel, plain
    loss_rel = {}
    for key in ("train_loss_src", "train_loss_featdist_src",
                "train_loss_uda_trg"):
        a, b = float(logs_k[key]), float(logs_p[key])
        if not (torch.isfinite(logs_k[key]) and torch.isfinite(logs_p[key])):
            raise AssertionError(f"{what}: {key} not finite ({a}, {b})")
        loss_rel[key] = abs(a - b) / max(abs(b), 1e-12)
    limits = {k: max(loss_limit, LOSS_FLOOR_MARGIN * loss_noise[k]
                     if loss_noise else 0.0) for k in loss_rel}
    norms = {n: g.norm().item() for n, g in g_p.items()}
    floor = 1e-3 * (sum(v * v for v in norms.values()) / len(norms)) ** 0.5
    rel = {n: (g_k[n] - g_p[n]).norm().item() / max(norms[n], floor)
           for n in g_p}
    at_floor = sum(norms[n] < floor for n in norms)
    total = (sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p).sqrt()
             / sum((g_p[n] ** 2).sum() for n in g_p).sqrt()).item()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    median = statistics.median(rel.values())
    log(f"  {what}: losses {versus} rel "
        + ", ".join(f"{k[len('train_loss_'):]} {v:.2e}"
                    for k, v in loss_rel.items())
        + (f" (limit {loss_limit:g})" if not loss_noise else " (limits "
           + ", ".join(f"{limits[k]:.2e}" for k in loss_rel)
           + f": {loss_limit:g} or {LOSS_FLOOR_MARGIN}x the floor)")
        + f"; gradient rel L2 over all "
        f"{len(rel)} parameters {total:.2e}, median parameter "
        f"{median:.2e} (limit {median_limit:g}), largest per parameter "
        + ", ".join(f"{n} {v:.2e}" for n, v in worst)
        + f" (limit {grad_limit:g}; {at_floor} gradients below the floor "
        f"{floor:.2e}; all: limit {total_limit:g}); loss "
        f"{float(logs_k['train_loss_total']):.4f}")
    if not (all(loss_rel[k] <= limits[k] for k in loss_rel)
            and max(rel.values()) <= grad_limit and total <= total_limit
            and median <= median_limit):
        raise AssertionError(f"{what}: {versus} disagree")
    return max(loss_rel.values()), max(rel.values()), total


def phase_train(card):
    import dataclasses
    import torch
    from refign_tpu_torch.entry import (REFIGN_HRDA_STAR, build_uda_trainer,
                                        uda_train_step)
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import local_correlation as k3
    from refign_tpu_torch.ops.dilated_dwconv import dilated_dwconv3x3
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    from refign_tpu_torch.uda.trainer import draw_step, train_step

    counted = {"sra_attention": sra_attention,
               "sra_attention_backward": sra_attention_backward,
               "dwconv3x3_gelu": dwconv3x3_gelu,
               "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
               "local_correlation": k3,
               "dilated_dwconv3x3": dilated_dwconv3x3}

    # small fp32 model first: kernels against plain versions, tightly.
    # mit_b1 (MiT-B5's widths and heads at depth 2): K1 takes head dim 64,
    # and mit_b0's first stages have 32
    cfg32 = dataclasses.replace(REFIGN_HRDA_STAR, compute_dtype="float32")
    small = build_uda_trainer("mit_b1", cfg=cfg32, device="cuda", seed=1,
                              channels=64)
    sbatch = uda_batch(2, 256, 1, "cuda")
    compare_step("mit_b1 fp32 B=2 256^2",
                 *grads_kernels_vs_plain(small, sbatch,
                                         torch.Generator().manual_seed(1)),
                 TRAIN_FP32_LOSS_REL, TRAIN_FP32_GRAD_REL,
                 TRAIN_FP32_TOTAL_REL, TRAIN_FP32_MEDIAN_REL)
    del small, sbatch

    t0 = time.perf_counter()
    trainer = build_uda_trainer("mit_b5", device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  built the MiT-B5 Refign-HRDA* trainer in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = uda_batch(UDA_B, UDA_HW, 0, "cuda")
    gen = torch.Generator().manual_seed(0)
    compare_step(f"MiT-B5 bf16 B={UDA_B} {UDA_HW}^2",
                 *grads_kernels_vs_plain(trainer, batch, gen),
                 TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL,
                 TRAIN_BF16_TOTAL_REL, TRAIN_BF16_MEDIAN_REL)

    # one step counted, the Refign branch (the adapt-to-reference coin
    # skips the align step in half the steps)
    draws = draw_step(trainer.cfg, batch, gen)
    draws.use_ref_as_target = False
    for f in counted.values():
        f.launches = 0
    dilated_dwconv3x3.fused = 0
    logs = train_step(trainer, batch, draws)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counted.items()}
    log(f"  launches in one train step: {launches}; K4's with the BatchNorm "
        f"+ ReLU epilogue: {dilated_dwconv3x3.fused}")
    for name, n in launches.items():
        if n != TRAIN_LAUNCHES[name]:
            raise AssertionError(f"{name} launched {n} times in a train "
                                 f"step, expected {TRAIN_LAUNCHES[name]}")
    if dilated_dwconv3x3.fused:
        raise AssertionError(f"{dilated_dwconv3x3.fused} of K4's launches "
                             f"fused in a train step, expected none")

    all_logs = [logs]
    uda_train_step(trainer, batch, gen)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_logs.append(uda_train_step(trainer, batch, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    sec = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [{k: float(v) for k, v in lg.items()} for lg in all_logs]
    if not all(all(map(lambda v: v == v and abs(v) != float("inf"),
                       lg.values())) for lg in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    log(f"  warm train step (B={UDA_B} {UDA_HW}^2): median "
        f"{sec * 1e3:.1f} ms over {len(times)} "
        f"({[round(x * 1e3, 1) for x in times]} ms) = {UDA_B / sec:.3f} "
        f"source images/s on {card}; peak memory {peak:.1f} GiB")
    log("  losses (counted step, then the timed steps): " + "; ".join(
        ", ".join(f"{k[len('train_'):]} {v:.4f}" for k, v in lg.items())
        for lg in losses))
    profile_device(lambda: uda_train_step(trainer, batch, gen), sec,
                   "train step", top_n=25)
    with timed("6 remat 'dots' step against whole-block"):
        phase_train_dots(card, trainer, batch, gen, counted, sec, peak)
    return launches, sec, peak


def phase_train_dots(card, trainer, batch, gen, counted, remat_sec,
                     remat_peak):
    """The UDA step with the MiT blocks recomputed under
    ``remat_policy='dots'`` (their products' and convolutions' outputs
    kept, K1 and K2 run again) against the whole-block recompute of
    ``refign_hrda_star.yaml``, from one state with the same draws on the
    Refign branch, at phase 6's bf16 limits; its launches in a counted
    step, warm step time and peak memory beside the whole-block one's."""
    import torch
    from refign_tpu_torch.entry import uda_train_step
    from refign_tpu_torch.uda.trainer import draw_step, train_step
    backbone = trainer.state.student.backbone
    draws = draw_step(trainer.cfg, batch, gen)
    draws.use_ref_as_target = False
    remat = uda_run(trainer, batch, draws)
    backbone.remat_policy = "dots"
    try:
        dots = uda_run(trainer, batch, draws)
        compare_step(f"MiT-B5 bf16 B={UDA_B} {UDA_HW}^2, remat 'dots' vs "
                     f"whole-block remat", dots, remat, TRAIN_BF16_LOSS_REL,
                     TRAIN_BF16_GRAD_REL, TRAIN_BF16_TOTAL_REL,
                     TRAIN_BF16_MEDIAN_REL, versus="'dots' vs whole-block")
        for f in counted.values():
            f.launches = 0
        train_step(trainer, batch, draws)
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in counted.items()}
        log(f"  launches in one train step under remat 'dots': {launches}")
        for name, n in launches.items():
            if n != TRAIN_LAUNCHES[name]:
                raise AssertionError(f"{name} launched {n} times in a "
                                     f"'dots' train step, expected "
                                     f"{TRAIN_LAUNCHES[name]}")
        # the runs above warmed the 'dots' step
        torch.cuda.reset_peak_memory_stats()
        sec, times = warm_median(lambda: uda_train_step(trainer, batch, gen),
                                 n=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        backbone.remat_policy = None
    log(f"  warm train step under remat 'dots' (B={UDA_B} {UDA_HW}^2): "
        f"median {sec * 1e3:.1f} ms over {len(times)} "
        f"({[round(x * 1e3, 1) for x in times]} ms), peak memory "
        f"{peak:.2f} GiB; whole-block remat {remat_sec * 1e3:.1f} ms, peak "
        f"{remat_peak:.2f} GiB, on {card}")


def align_batch(B, S, seed, device):
    """B seeded synthetic uint8 image pairs of S^2: smooth random scenes
    (bicubic upsampling of 12x12 noise, plus pixel noise), the reference a
    shifted, noisier copy of the target, so the head has structure to
    match."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    low = torch.randn(B, 3, 12, 12, generator=g)
    trg = F.interpolate(low, (S, S), mode="bicubic", align_corners=False)
    trg = trg + 0.1 * torch.randn(B, 3, S, S, generator=g)
    ref = trg.roll((5, -7), dims=(2, 3)) + 0.15 * torch.randn(
        B, 3, S, S, generator=g)

    def u8(x):
        return ((x.permute(0, 2, 3, 1) * 60 + 128).clamp(0, 255)
                .to(torch.uint8))

    return {"image_ref": u8(ref).to(device), "image_trg": u8(trg).to(device)}


def align_grads_kernels_vs_plain(trainer, batch, gen):
    """From one state and the same draws, one UAWarpC step's losses and
    head gradients through the kernels and through their plain versions
    (the head's BN statistics restored after each)."""
    from refign_tpu_torch.alignment.trainer import draw_align, forward_backward
    B, H, W = batch["image_trg"].shape[:3]
    draws = draw_align(trainer.cfg, B, H, W, gen)
    head = trainer.state.head
    saved = {k: v.clone() for k, v in head.state_dict().items()}

    def run():
        logs = forward_backward(trainer, batch, draws)
        grads = {n: p.grad.detach().clone()
                 for n, p in head.named_parameters()}
        trainer.state.optimizer.zero_grad(set_to_none=True)
        head.load_state_dict(saved)
        return logs, grads

    kernel = run()
    plain_versions(True)
    try:
        plain = run()
    finally:
        plain_versions(False)
    return kernel, plain


def compare_align_step(what, kernel, plain, loss_limit, total_limit,
                       median_limit, grad_limit, per_param=False):
    """The three losses' relative differences and the relative L2 error of
    the head gradients, kernels against plain versions: all together, the
    median parameter and the largest one, each against its limit.  Returns
    the largest loss difference and the gradients' error over all
    parameters (with ``per_param`` also the median's and the largest
    parameter's)."""
    import torch
    (logs_k, g_k), (logs_p, g_p) = kernel, plain
    loss_rel = {}
    for key in ("train_matching_loss", "loss_ss", "loss_us"):
        a, b = float(logs_k[key]), float(logs_p[key])
        if not (torch.isfinite(logs_k[key]) and torch.isfinite(logs_p[key])):
            raise AssertionError(f"{what}: {key} not finite ({a}, {b})")
        loss_rel[key] = abs(a - b) / max(abs(b), 1e-12)
    rel = {n: (g_k[n] - g_p[n]).norm().item() / max(g_p[n].norm().item(),
                                                     1e-30) for n in g_p}
    total = (sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p).sqrt()
             / sum((g_p[n] ** 2).sum() for n in g_p).sqrt()).item()
    median = statistics.median(rel.values())
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {what}: losses kernels vs plain rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in loss_rel.items())
        + f" (limit {loss_limit:g}); head gradient rel L2 over all "
        f"{len(rel)} parameters {total:.2e} (limit {total_limit:g}), median "
        f"parameter {median:.2e} (limit {median_limit:g}), largest "
        + ", ".join(f"{n} {v:.2e}" for n, v in worst)
        + f" (limit {grad_limit:g}); loss "
        f"{float(logs_k['train_matching_loss']):.4f}")
    if not (max(loss_rel.values()) <= loss_limit and total <= total_limit
            and median <= median_limit and max(rel.values()) <= grad_limit):
        raise AssertionError(f"{what}: kernels disagree with plain versions")
    if per_param:
        return max(loss_rel.values()), total, median, max(rel.values())
    return max(loss_rel.values()), total


def phase_align_train(card):
    import dataclasses
    import torch
    from refign_tpu_torch.alignment.trainer import draw_align, train_step
    from refign_tpu_torch.entry import (UAWARPC_STAGE1, align_train_step,
                                        build_align_trainer)
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_backward)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    counted = {"sra_attention": sra_attention,
               "sra_attention_backward": sra_attention_backward,
               "dwconv3x3_gelu": dwconv3x3_gelu,
               "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
               "local_correlation": local_correlation,
               "local_correlation_backward": local_correlation_backward}

    # a reduced fp32 step first: kernels against plain versions, tightly
    # (B=2 pairs loaded at 288^2, cropped to 256^2)
    cfg32 = dataclasses.replace(UAWARPC_STAGE1, compute_dtype="float32",
                                crop_after_flow=(256, 256))
    small = build_align_trainer(1, cfg=cfg32, device="cuda", seed=1)
    compare_align_step(
        "VGG-16 + UAWarpC fp32 B=2 288^2 -> 256^2",
        *align_grads_kernels_vs_plain(small, align_batch(2, 288, 1, "cuda"),
                                      torch.Generator().manual_seed(1)),
        ALIGN_FP32_LOSS_REL, ALIGN_FP32_TOTAL_REL, ALIGN_FP32_MEDIAN_REL,
        ALIGN_FP32_GRAD_REL)
    del small

    t0 = time.perf_counter()
    trainer = build_align_trainer(1, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  built the stage-1 VGG-16 + UAWarpC trainer in "
        f"{time.perf_counter() - t0:.1f} s")
    B, S = ALIGN_TRAIN_B, ALIGN_TRAIN_LOAD
    batch = align_batch(B, S, 0, "cuda")
    gen = torch.Generator().manual_seed(0)
    compare_align_step(
        f"VGG-16 + UAWarpC bf16 B={B} {S}^2 -> {ALIGN_TRAIN_CROP}^2",
        *align_grads_kernels_vs_plain(trainer, batch, gen),
        ALIGN_BF16_LOSS_REL, ALIGN_BF16_TOTAL_REL, ALIGN_BF16_MEDIAN_REL,
        ALIGN_BF16_GRAD_REL)

    def counted_step(tr, what):
        draws = draw_align(tr.cfg, B, S, S, gen)
        for f in counted.values():
            f.launches = 0
        logs = train_step(tr, batch, draws)
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in counted.items()}
        log(f"  launches in one {what} step: {launches}")
        for name, n in launches.items():
            if n != ALIGN_TRAIN_LAUNCHES.get(name, 0):
                raise AssertionError(f"{name} launched {n} times in a {what} "
                                     f"step, expected "
                                     f"{ALIGN_TRAIN_LAUNCHES.get(name, 0)}")
        return launches, logs

    launches, logs = counted_step(trainer, "stage-1")
    all_logs = [logs]
    align_train_step(trainer, batch, gen)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_logs.append(align_train_step(trainer, batch, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    sec = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [{k: float(v) for k, v in lg.items()} for lg in all_logs]
    if not all(all(map(lambda v: v == v and abs(v) != float("inf"),
                       lg.values())) for lg in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    log(f"  warm stage-1 step (B={B} {S}^2 -> {ALIGN_TRAIN_CROP}^2): median "
        f"{sec * 1e3:.1f} ms over {len(times)} "
        f"({[round(x * 1e3, 1) for x in times]} ms) = {B / sec:.3f} image "
        f"pairs/s on {card}; peak memory {peak:.2f} GiB")
    log("  losses (counted step, then the timed steps): " + "; ".join(
        ", ".join(f"{k} {v:.4f}" for k, v in lg.items()) for lg in losses))
    profile_device(lambda: align_train_step(trainer, batch, gen), sec,
                   "stage-1 step", top_n=25)
    variants = phase_align_variants(card, trainer, batch, gen, counted,
                                    (sec, peak))
    del trainer

    stage2 = build_align_trainer(2, device="cuda", seed=2)
    _, logs = counted_step(stage2, "stage-2")
    logs = {k: float(v) for k, v in logs.items()}
    if not all(v == v and abs(v) != float("inf") for v in logs.values()):
        raise AssertionError(f"stage-2 losses not finite: {logs}")
    log("  stage-2 step losses: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in logs.items()))
    del stage2
    return launches, variants["fold_passes"], sec, peak


def align_run(trainer, batch, draws):
    """One UAWarpC step without its update from the trainer's state: its
    logs, the head's gradients and the BatchNorm running statistics it
    leaves, by name; the head is restored after it."""
    from refign_tpu_torch.alignment.trainer import forward_backward
    head = trainer.state.head
    saved = {k: v.clone() for k, v in head.state_dict().items()}
    logs = forward_backward(trainer, batch, draws)
    grads = {n: p.grad.detach().clone() for n, p in head.named_parameters()}
    stats = {n: b.detach().clone() for n, b in head.named_buffers()}
    trainer.state.optimizer.zero_grad(set_to_none=True)
    head.load_state_dict(saved)
    return logs, grads, stats


def step_differences(got, want):
    """Relative differences of two UAWarpC runs (:func:`align_run`): the
    largest of the three losses', and the relative L2 errors of the head
    gradients over all parameters, of the median and of the largest
    parameter, and of the running statistics over all buffers."""
    (logs_g, g_g, st_g), (logs_w, g_w, st_w) = got, want

    def total(a, b):
        num = sum(float(((a[n] - b[n]).double() ** 2).sum()) for n in b)
        den = sum(float((b[n].double() ** 2).sum()) for n in b)
        return (num / max(den, 1e-300)) ** 0.5

    per = [total({n: g_g[n]}, {n: g_w[n]}) for n in g_w]
    return {"loss": max(abs(float(logs_g[k]) - float(logs_w[k]))
                        / max(abs(float(logs_w[k])), 1e-12)
                        for k in ("train_matching_loss", "loss_ss",
                                  "loss_us")),
            "all": total(g_g, g_w), "median": statistics.median(per),
            "largest": max(per), "stats": total(st_g, st_w)}


def _fmt(d):
    return ", ".join(f"{k} {v:.2e}" for k, v in d.items())


def phase_align_variants(card, trainer, batch, gen, counted, serial_time):
    """The stage-1 step's memory options (``ALIGN_VARIANTS``) from the
    trainer's state with one set of draws, against the serial step:
    ``fold_passes`` at phase 6b's bf16 limits on the losses and head
    gradients, and on the running statistics at ``ALIGN_BF16_STAT_REL``;
    the folded step through the kernels against it through the plain
    versions at the same limits; the remat_head variants within 10x what
    the serial step differs by from its ``ALIGN_SERIAL_REPEATS`` repeats
    (the largest of the repeats' differences, metric by metric: bit-equal
    where the step repeats, and one repeat can agree on a gradient metric
    by chance where the backward's atomic adds do not).  Each run is
    counted (every kernel's launches) and its forward and backward
    profiled on the device alone (the device time beside the serial
    run's); then each variant's warm step time (median of
    ``ALIGN_VARIANT_STEPS``; its comparison run warmed it) and peak
    memory, beside the serial step's (``serial_time``: the phase's median
    seconds and peak GiB).  Returns each variant's launches by kernel."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from refign_tpu_torch.alignment.trainer import AlignTrainer, draw_align
    from refign_tpu_torch.entry import align_train_step
    B, S = ALIGN_TRAIN_B, ALIGN_TRAIN_LOAD
    draws = draw_align(trainer.cfg, B, S, S, gen)
    pair = ("local_correlation", "local_correlation_backward")

    def counted_run(tr):
        for f in counted.values():
            f.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = align_run(tr, batch, draws)
            torch.cuda.synchronize()
        launches = {n: f.launches for n, f in counted.items()}
        dev = device_sum_ms(prof)
        return out, launches, (f"{dev:.1f} ms" if dev > 0 else
                               "not measured (no device events recorded)")

    with timed("6b serial run and its repeats"):
        serial, serial_launches, serial_dev = counted_run(trainer)
        spread = {}
        for _ in range(ALIGN_SERIAL_REPEATS):
            diff = step_differences(align_run(trainer, batch, draws), serial)
            spread = {k: max(v, spread.get(k, 0.0)) for k, v in diff.items()}
    log(f"  stage-1 step, serial, {ALIGN_SERIAL_REPEATS + 1} times from one "
        f"state with the same draws: "
        + ("bit-equal" if not any(spread.values()) else
           "differ by up to " + _fmt(spread)) + f"; launches "
        f"{serial_launches}; forward and backward {serial_dev} on the "
        f"device")
    runs, measured = {}, {}
    for name, (opts, want) in ALIGN_VARIANTS.items():
        t0 = time.perf_counter()
        tr = AlignTrainer(dataclasses.replace(trainer.cfg, **opts),
                          trainer.state)
        runs[name] = tr
        got, launches, dev = counted_run(tr)
        measured[name] = launches
        diff = step_differences(got, serial)
        if (tuple(launches[k] for k in pair) != want
                or any(launches[k] for k in launches if k not in pair)):
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"(K3, K3 backward) {want} and no other")
        if name == "fold_passes":
            limits = {"loss": ALIGN_BF16_LOSS_REL,
                      "all": ALIGN_BF16_TOTAL_REL,
                      "median": ALIGN_BF16_MEDIAN_REL,
                      "largest": ALIGN_BF16_GRAD_REL,
                      "stats": ALIGN_BF16_STAT_REL}
            plain_versions(True)
            try:
                plain = align_run(tr, batch, draws)
            finally:
                plain_versions(False)
            vs_plain = step_differences(got, plain)
            log(f"  {name}: kernels vs plain versions {_fmt(vs_plain)} "
                f"(limits {_fmt(limits)})")
            if any(vs_plain[k] > limits[k] for k in limits):
                raise AssertionError(f"{name}: kernels disagree with the "
                                     f"plain versions")
        else:
            limits = {k: 10 * v for k, v in spread.items()}
        log(f"  {name} vs serial step: {_fmt(diff)} (limits "
            f"{_fmt(limits)}); launches (K3, K3 backward) "
            f"{tuple(launches[k] for k in pair)}; forward and backward "
            f"{dev} on the device (serial {serial_dev})")
        if any(diff[k] > limits[k] for k in limits):
            raise AssertionError(f"{name}: the step disagrees with the "
                                 f"serial step")
        add_seconds(f"6b {name} against serial", t0)
    # speed and memory, each variant from the state the last one left
    sec, peak = serial_time
    log(f"  stage-1 step, serial (above): median {sec * 1e3:.1f} ms, peak "
        f"memory {peak:.2f} GiB on {card}")
    for name, tr in runs.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        sec, times = warm_median(lambda: align_train_step(tr, batch, gen),
                                 n=ALIGN_VARIANT_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  stage-1 step, {name}: median {sec * 1e3:.1f} ms over "
            f"{len(times)} ({[round(x * 1e3, 1) for x in times]} ms), peak "
            f"memory {peak:.2f} GiB on {card}")
        add_seconds(f"6b {name} timed", t0)
    return measured


def randomize_bn(module, seed):
    """Every BatchNorm's scale and bias of ``module`` drawn from ``seed``, in
    module order: scales 1 +- 0.3, but a tenth of that on the last
    BatchNorm of each residual branch (the init's zero there would leave
    the branches' convs out of every comparison; at unit scale a random
    ResNet-101 with calibrated statistics is chaotic, bf16 and fp32 logits
    decorrelating: mean relative difference 0.7, argmax agreement 0.44 in
    a CPU reading at 135x240), biases +- 0.2.  The running statistics are
    set by ``calibrate_bn``."""
    import torch
    from refign_tpu_torch.nn.layers import TorchBatchNorm
    last = {id(m.last_bn()) for m in module.modules()
            if hasattr(m, "last_bn")}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.weight.shape[0]
                scale = 0.1 if id(m) in last else 1.0
                m.weight.copy_(scale * (1.0 + 0.3 * torch.randn(
                    n, generator=gen)))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))


def calibrate_bn(module, x):
    """Every BatchNorm's running statistics set to the batch statistics of
    one train-mode forward of ``module`` on ``x`` (momentum 1), so that eval
    mode normalises its activations as a trained network's statistics
    would (with the init's 0/1 statistics they grow through the residual
    stages, to ~1e8 at ResNet-101's output); the module's mode is kept."""
    import torch
    from refign_tpu_torch.nn.layers import TorchBatchNorm
    bns = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    was = module.training
    for m in bns:
        m.momentum = 1.0
    module.train()
    try:
        with torch.no_grad():
            module(x)
    finally:
        for m in bns:
            del m.momentum  # the class's 0.1 again
        module.train(was)


def prepare_trainer_bn(trainer, seed, x):
    """``randomize_bn`` and ``calibrate_bn`` (on images ``x``, the target
    images: calibrated on the source images, the ImageNet copy's eval
    features would equal the student's train-mode ones and the feature
    distance start at ~0) on the student; the EMA teacher and the ImageNet
    copy, copies of the student at the start, take its state again."""
    state = trainer.state
    randomize_bn(state.student, seed)
    calibrate_bn(state.student, x)
    state.teacher.load_state_dict(state.student.state_dict())
    if state.imnet is not None:
        state.imnet.load_state_dict(state.student.backbone.state_dict())


def phase_deeplabv2(card):
    """DeepLabV2 (``refign_deeplabv2.yaml``): whole-image inference of
    ResNet-101 v1c + DeepLabV2 at 1x540x960 through ``build_deeplabv2`` and
    ``deeplabv2_forward``, bf16 against fp32 on the same weights (no
    hand-written kernel runs there); then the Refign UDA step through
    ``build_uda_trainer`` with a ResNet: kernels against plain versions on
    a small fp32 resnet50_v1c step and on the full bf16 ResNet-101 step at
    B=4 512^2, one counted Refign-branch step (K3 3 launches at the
    levels' shapes, no other kernel), 1 warm-up and 5 timed Refign-branch
    steps, the peak memory and a profile.  BatchNorm scales and biases are
    drawn from a seed and their running statistics calibrated on seeded
    images throughout (``randomize_bn``, ``calibrate_bn``)."""
    import dataclasses
    import torch
    from refign_tpu_torch.entry import (REFIGN_DEEPLABV2, build_deeplabv2,
                                        build_uda_trainer, deeplabv2_forward)
    from refign_tpu_torch.models.heads import uawarpc
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_backward)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    from refign_tpu_torch.uda.trainer import draw_step, train_step
    counted = {"sra_attention": sra_attention,
               "sra_attention_backward": sra_attention_backward,
               "dwconv3x3_gelu": dwconv3x3_gelu,
               "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
               "local_correlation": local_correlation,
               "local_correlation_backward": local_correlation_backward}

    # inference: bf16 against fp32 on the same (seeded) weights
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    img32 = torch.randn(1, *DL_EVAL_HW, 3, generator=gen).cuda()
    model32 = build_deeplabv2("resnet101_v1c", dtype=torch.float32,
                              device="cuda", seed=0)
    randomize_bn(model32, 1)
    calibrate_bn(model32, torch.randn(2, 256, 256, 3, generator=gen).cuda())
    model = build_deeplabv2("resnet101_v1c", dtype=torch.bfloat16,
                            device="cuda", seed=0)
    model.load_state_dict(model32.state_dict())  # bf16 parameters
    torch.cuda.synchronize()
    log(f"  built ResNet-101 v1c + DeepLabV2 (bf16 and fp32) in "
        f"{time.perf_counter() - t0:.1f} s")
    img = img32.bfloat16()
    for f in counted.values():
        f.launches = 0
    out = deeplabv2_forward(model, img)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counted.items()}
    if any(launches.values()):
        raise AssertionError(f"DeepLabV2 inference launched {launches}")
    if (tuple(out.shape) != (1, *DL_EVAL_HW, 19)
            or out.dtype != torch.bfloat16 or not torch.isfinite(out).all()):
        raise AssertionError(f"DeepLabV2 logits {tuple(out.shape)} "
                             f"{out.dtype}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    ref = deeplabv2_forward(model32, img32)
    diff = (out.float() - ref).abs()
    max_rel = (diff.max() / ref.abs().max()).item()
    mean_rel = (diff.mean() / ref.abs().mean()).item()
    agree = (out.float().argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"  bf16 DeepLabV2 1x{DL_EVAL_HW[0]}x{DL_EVAL_HW[1]} vs fp32: max "
        f"rel {max_rel:.3e} (limit {DL_BF16_MAX_REL:g}), mean rel "
        f"{mean_rel:.3e} (limit {DL_BF16_MEAN_REL:g}), argmax agreement "
        f"{agree:.5f} (limit {DL_ARGMAX_AGREE:g}); |ref| max "
        f"{ref.abs().max().item():.3f}; no hand-written kernel launched")
    if not (max_rel <= DL_BF16_MAX_REL and mean_rel <= DL_BF16_MEAN_REL
            and agree >= DL_ARGMAX_AGREE):
        raise AssertionError("bf16 DeepLabV2 disagrees with fp32")
    del model32, ref, diff, img32
    torch.cuda.reset_peak_memory_stats()
    sec, times = warm_median(lambda: deeplabv2_forward(model, img))
    log(f"  warm DeepLabV2 forward: median {sec * 1e3:.2f} ms over "
        f"{len(times)} ({[round(x * 1e3, 2) for x in times]} ms) = "
        f"{1.0 / sec:.2f} images/s on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_device(lambda: deeplabv2_forward(model, img), sec,
                   "DeepLabV2 forward", top_n=12)
    del model, out, img

    # the UDA step: a small fp32 step first, kernels against plain versions
    cfg32 = dataclasses.replace(REFIGN_DEEPLABV2, compute_dtype="float32")
    small = build_uda_trainer("resnet50_v1c", cfg=cfg32, device="cuda",
                              seed=1)
    sbatch = uda_batch(2, 256, 1, "cuda")
    prepare_trainer_bn(small, 2, sbatch["image_trg"])
    compare_step("resnet50_v1c + DeepLabV2 fp32 B=2 256^2",
                 *grads_kernels_vs_plain(small, sbatch,
                                         torch.Generator().manual_seed(1)),
                 TRAIN_FP32_LOSS_REL, TRAIN_FP32_GRAD_REL,
                 TRAIN_FP32_TOTAL_REL, TRAIN_FP32_MEDIAN_REL)
    del small, sbatch

    t0 = time.perf_counter()
    trainer = build_uda_trainer("resnet101_v1c", device="cuda", seed=0)
    batch = uda_batch(DL_B, DL_HW, 0, "cuda")
    prepare_trainer_bn(trainer, 3, batch["image_trg"])
    torch.cuda.synchronize()
    log(f"  built the ResNet-101 Refign-DeepLabV2 trainer in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(0)
    compare_step(f"ResNet-101 + DeepLabV2 bf16 B={DL_B} {DL_HW}^2",
                 *grads_kernels_vs_plain(trainer, batch, gen),
                 TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL,
                 TRAIN_BF16_TOTAL_REL, TRAIN_BF16_MEDIAN_REL)

    def refign_step():
        # the Refign branch (the adapt-to-reference coin skips the align
        # step in half the steps)
        draws = draw_step(trainer.cfg, batch, gen)
        draws.use_ref_as_target = False
        return train_step(trainer, batch, draws)

    # one counted step, with K3's input shapes read from its launches
    shapes = []
    real = uawarpc.local_correlation_relu_l2norm

    def recording(t, s, *a, **k):
        shapes.append(tuple(t.shape))
        return real(t, s, *a, **k)

    for f in counted.values():
        f.launches = 0
    uawarpc.local_correlation_relu_l2norm = recording
    try:
        logs = refign_step()
        torch.cuda.synchronize()
    finally:
        uawarpc.local_correlation_relu_l2norm = real
    launches = {n: f.launches for n, f in counted.items()}
    log(f"  launches in one Refign-DeepLabV2 step: {launches}; K3 shapes "
        f"{shapes}")
    if launches != DL_LAUNCHES:
        raise AssertionError(f"launches {launches}, expected {DL_LAUNCHES}")
    if sorted(shapes) != sorted(tuple(s) for s in DL_CORR_LEVELS):
        raise AssertionError(f"K3 shapes {shapes}, expected "
                             f"{DL_CORR_LEVELS}")

    all_logs = [logs]
    refign_step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    sec, times = warm_median(lambda: all_logs.append(refign_step()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [{k: float(v) for k, v in lg.items()} for lg in all_logs]
    if not all(all(map(lambda v: v == v and abs(v) != float("inf"),
                       lg.values())) for lg in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    log(f"  warm Refign-DeepLabV2 step (B={DL_B} {DL_HW}^2, Refign branch): "
        f"median {sec * 1e3:.1f} ms over {len(times)} "
        f"({[round(x * 1e3, 1) for x in times]} ms) = {DL_B / sec:.3f} "
        f"source images/s on {card}; peak memory {peak:.2f} GiB")
    log("  losses (counted step, then the timed steps): " + "; ".join(
        ", ".join(f"{k[len('train_'):]} {v:.4f}" for k, v in lg.items())
        for lg in losses))
    profile_device(refign_step, sec, "DeepLabV2 train step", top_n=25)
    del trainer
    return launches, sec, peak


# --- phase 6d: the runtime (CLI fit / validate / predict / test) ---------

HRDA_YAML = "configs/cityscapes_acdc/refign_hrda_star.yaml"
STAGE1_YAML = "configs/megadepth/uawarpc_stage1.yaml"
DL_YAML = "configs/cityscapes_acdc/refign_deeplabv2.yaml"
RUNTIME_FIT_STEPS = 6
RUNTIME_PROFILED = (2, 3)       # 0-based loop steps profiled together
RUNTIME_ALIGN_STEPS = 3
RUNTIME_MIT = "mit_b5"          # refign_hrda_star.yaml's backbone
# the trees: Cityscapes 8 train + 2 val at 1024x2048; ACDC 8 train (with
# their _ref images) + 2 val + 2 test at 1080x1920; MegaDepth's full-length
# train split (100 scenes of 18 images from 18 shared 1600x1064 JPEGs) and
# one validation scene of 4 images (12 pairs)
CITYSCAPES_HW, ACDC_HW, MEGADEPTH_HW = (1024, 2048), (1080, 1920), (1064,
                                                                    1600)


def write_runtime_data(root):
    """The synthetic dataset trees (``refign_tpu_torch/data/synthetic.py``)
    at the datasets' sizes."""
    from refign_tpu_torch.data.synthetic import (make_acdc, make_cityscapes,
                                                 make_megadepth)
    make_cityscapes(os.path.join(root, "Cityscapes"), n_train=8, n_val=2,
                    size=CITYSCAPES_HW)
    make_acdc(os.path.join(root, "ACDC"), n_train=8, n_val=2, n_test=2,
              size=ACDC_HW)
    make_megadepth(os.path.join(root, "MegaDepth"), n_files=18,
                   size=MEGADEPTH_HW)


def write_reference_weights(root):
    """Seeded weights as reference-named files: a MiT-B5 ImageNet file
    (bare names, the reference's ``mlp.dwconv.dwconv``, a classifier to
    drop), a torchvision VGG-16 file and an AlignmentModel ``.ckpt`` (a
    Lightning ``state_dict`` under ``alignment_head.``).  Returns their
    paths."""
    import torch
    from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
    from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
    from refign_tpu_torch.models.vgg import VGG
    from refign_tpu_torch.utils.checkpoint import to_reference
    os.makedirs(root, exist_ok=True)
    paths = {}
    mit = MixVisionTransformer(RUNTIME_MIT)
    mit.init_weights(torch.Generator().manual_seed(10))
    sd = to_reference(mit.state_dict())
    sd.update({"head.weight": torch.zeros(1000, 512),
               "head.bias": torch.zeros(1000)})
    paths["mit"] = os.path.join(root, f"{RUNTIME_MIT}.pth")
    torch.save(sd, paths["mit"])
    vgg = VGG("vgg16", out_indices=(2, 3, 4))
    vgg.init_weights(torch.Generator().manual_seed(11))
    paths["vgg16"] = os.path.join(root, "vgg16-397923af.pth")
    torch.save(vgg.state_dict(), paths["vgg16"])
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True)
    head.init_weights(torch.Generator().manual_seed(12))
    paths["uawarpc"] = os.path.join(root, "uawarpc_megadepth.ckpt")
    torch.save({"state_dict": to_reference(head.state_dict(),
                                           "alignment_head."),
                "epoch": 0, "global_step": 0}, paths["uawarpc"])
    return paths


def busy_share(prof, window_s):
    """The share of ``window_s`` in which the card ran a kernel or a copy
    (the union of the trace's device intervals), and their count."""
    import torch
    ivs = sorted((e.time_range.start, e.time_range.end) for e in
                 prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in ivs:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6 / window_s, len(ivs)


class StepProbe:
    """Wraps a task module's ``train_step``: per step, the launches of each
    counted wrapper and the branch; a torch.profiler window over the steps
    ``profiled`` (from the first's start to the last's end, the loop
    between them included)."""

    def __init__(self, module, counted, profiled=()):
        self.module, self.counted = module, counted
        self.profiled = tuple(profiled)
        self.steps, self.prof, self.window = [], None, None
        self.last = None
        self.real = module.train_step
        module.train_step = self

    def __call__(self, trainer, batch, draws, *rest, **kw):
        import torch
        from torch.profiler import ProfilerActivity, profile
        i = len(self.steps)
        if self.profiled and i == self.profiled[0]:
            torch.cuda.synchronize()
            # device activity only: host-side tracing of ~100k ops a step
            # would lengthen the window it measures
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t0 = time.perf_counter()
        before = {n: f.launches for n, f in self.counted.items()}
        out = self.real(trainer, batch, draws, *rest, **kw)
        self.last = (trainer, batch, draws)
        self.steps.append(dict(
            launches={n: f.launches - before[n]
                      for n, f in self.counted.items()},
            refign=not getattr(draws, "use_ref_as_target", False)))
        if self.profiled and i == self.profiled[-1]:
            torch.cuda.synchronize()
            self.window = time.perf_counter() - self._t0
            self.prof.__exit__(None, None, None)
        return out

    def restore(self):
        self.module.train_step = self.real


class Recorder:
    """Replaces ``owner.name`` with a wrapper that times each call (to the
    card's end of it) and keeps its arguments and what it returns."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.calls = []
        rec = self

        def wrapper(*a, **k):
            import torch
            t0 = time.perf_counter()
            out = rec.real(*a, **k)
            torch.cuda.synchronize()
            rec.calls.append((a, out, time.perf_counter() - t0))
            return out
        setattr(owner, name, wrapper)

    def restore(self):
        setattr(self.owner, self.name, self.real)


def time_alone(step, last, n=3):
    """Host-clock seconds of ``n`` more steps on a fit's last trainer,
    batch and draws (the loader stopped), after one warm-up."""
    import torch
    step(*last)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*last)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def check_eval_plain(fwd, call, loader_of):
    """The first validation image of a run again through the plain
    versions: the fp32 logits within E2E_FP32_REL of the kernel run's, and
    the confusion matrix against its label equal but for pixels whose two
    largest logits lie within twice the logits' largest difference."""
    import torch
    from refign_tpu_torch.metrics import iou_init, iou_update
    (task, model, x, out_size), out_k, _ = call
    loaders = loader_of(task)
    try:
        first = next(iter(loaders[0]))
    finally:
        for loader in loaders:
            loader.close()
    if not torch.equal(first["image"].to(x.device), x):
        raise AssertionError("the first validation image differs")
    y = first["semantic"].to(x.device)
    was_training = model.training
    model.eval()
    plain_versions(True)
    try:
        with torch.inference_mode():
            out_p = fwd(task, model, x, out_size)
    finally:
        plain_versions(False)
        model.train(was_training)
    diff = (out_k - out_p).abs().max()
    rel = (diff / out_p.abs().max()).item()
    top2 = out_p.topk(2, dim=-1).values
    near = int(((top2[..., 0] - top2[..., 1]) <= 2 * diff).sum())
    nc = out_p.shape[-1]
    conf_k = iou_update(iou_init(nc).to(x.device), out_k.argmax(-1), y)
    conf_p = iou_update(iou_init(nc).to(x.device), out_p.argmax(-1), y)
    moved = int((conf_k - conf_p).abs().sum()) // 2
    log(f"  first validation image, fp32 {tuple(x.shape)}: logits kernels "
        f"vs plain max rel {rel:.2e} (limit {E2E_FP32_REL:g}); confusion "
        f"matrices differ by {moved} pixels ({near} within the tie "
        f"margin {2 * diff.item():.2e})")
    if not (rel <= E2E_FP32_REL and moved <= near):
        raise AssertionError("validation: kernels disagree with plain "
                             "versions")


def _finite(d):
    return all(v == v and abs(v) != float("inf") for v in d.values())


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_runtime(card, bare_step_sec, bare_align_sec, root):
    """The runtime through ``refign_tpu_torch.cli.main`` on synthetic trees
    at the datasets' sizes and seeded reference-named weight files, under
    ``root`` (the caller removes it).  Returns the launches over the fit,
    the phase's seconds and what phase 6e compares with: the HRDA* fit's
    workdir, its arguments, its metrics lines and its last validation's
    confusion matrices."""
    import dataclasses
    import torch
    from refign_tpu_torch import cli
    from refign_tpu_torch.alignment import trainer as atr
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_backward)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    from refign_tpu_torch.tasks import seg_task
    from refign_tpu_torch.utils import checkpoint as ckpt_mod
    counted = {"sra_attention": sra_attention,
               "sra_attention_backward": sra_attention_backward,
               "dwconv3x3_gelu": dwconv3x3_gelu,
               "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
               "local_correlation": local_correlation,
               "local_correlation_backward": local_correlation_backward}

    def reset():
        for f in counted.values():
            f.launches = 0

    def read():
        return {n: f.launches for n, f in counted.items()}

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = os.path.join(root, "data")
    write_runtime_data(data)
    weights = write_reference_weights(os.path.join(root, "weights"))
    log(f"  wrote the synthetic trees and weight files in "
        f"{time.perf_counter() - t0:.1f} s")
    wd = os.path.join(root, "hrda")
    common = ["--config", HRDA_YAML, "--data_dir", data, "--workdir", wd,
              "--model.init_args.backbone.init_args.pretrained",
              weights["mit"],
              "--model.init_args.alignment_backbone.init_args.pretrained",
              weights["vgg16"],
              "--model.init_args.alignment_head.init_args.pretrained",
              weights["uawarpc"]]

    # fit: 6 steps, validation and checkpoint at step 6
    probe = StepProbe(seg_task, counted, RUNTIME_PROFILED)
    saves = Recorder(ckpt_mod, "save_checkpoint")
    evals = Recorder(seg_task.SegTask, "evaluate")
    fwds = Recorder(seg_task.SegTask, "forward")
    try:
        reset()
        t0 = time.perf_counter()
        cli.main(["fit"] + common + [
            "--trainer.max_steps", str(RUNTIME_FIT_STEPS),
            "--trainer.val_every_n_steps", str(RUNTIME_FIT_STEPS),
            "--trainer.log_every_n_steps", "1"])
        fit_sec = time.perf_counter() - t0
        fit_launches = read()
    finally:
        probe.restore()
        saves.restore()
    steps = probe.steps
    log(f"  cli fit ({RUNTIME_FIT_STEPS} steps, validation and "
        f"checkpoint at the last) in {fit_sec:.1f} s; launches over the "
        f"run: {fit_launches}")
    for name in ("sra_attention", "sra_attention_backward",
                 "dwconv3x3_gelu", "dwconv3x3_gelu_backward",
                 "local_correlation"):
        if not fit_launches[name]:
            raise AssertionError(f"{name} never launched in the cli fit")
    for i, s in enumerate(steps):
        branch = "Refign" if s["refign"] else "ref as target"
        log(f"    step {i + 1} ({branch} branch): {s['launches']}")
        # K3 runs in the Refign branch's align step alone
        want = {n: TRAIN_LAUNCHES.get(n, 0) for n in counted}
        if not s["refign"]:
            want["local_correlation"] = 0
        if s["launches"] != want:
            raise AssertionError(f"fit step {i + 1}: launches "
                                 f"{s['launches']}, expected {want}")
    if not any(s["refign"] for s in steps):
        raise AssertionError("no Refign-branch step in the cli fit")
    lines = _jsonl(os.path.join(wd, "metrics.jsonl"))
    if not all(_finite(l) for l in lines):
        raise AssertionError(f"non-finite fit logs: {lines}")
    hrda_lines = lines
    timing = _jsonl(os.path.join(wd, "timing.jsonl"))
    step_s = [t["step_s"] for t in timing[1:]]
    wait_s = [t["data_wait_s"] for t in timing[1:]]
    med = statistics.median(step_s)
    unprof = [t["step_s"] for t in timing[1:]
              if t["step"] - 1 not in RUNTIME_PROFILED]
    log(f"  cli fit step (B=2 source + 2 target 1024^2 crops, steps "
        f"2-{RUNTIME_FIT_STEPS}): median {med * 1e3:.1f} ms "
        f"({[round(x * 1e3, 1) for x in step_s]} ms; unprofiled "
        f"median {statistics.median(unprof) * 1e3:.1f} ms) vs phase 6's "
        f"bare step (B=4 + 4 on tensors made on the card) "
        f"{bare_step_sec * 1e3:.1f} ms, on {card}")
    log(f"  loader wait per step: median "
        f"{statistics.median(wait_s) * 1e3:.1f} ms "
        f"({[round(x * 1e3, 1) for x in wait_s]} ms), "
        f"{100 * sum(wait_s) / sum(step_s):.1f} % of the steps' wall "
        f"time; first step {timing[0]['data_wait_s'] * 1e3:.1f} ms of "
        f"{timing[0]['step_s'] * 1e3:.1f} ms")
    # the fit's last step again from the state it left, on its batch
    # (B=2 + 2: 4-row student passes), with its draws and on the
    # Refign branch: kernels against plain versions at phase 6's limits
    # The floor is measured once, on the Refign branch: the source pass
    # (src and featdist) is the same on both, and uda_trg's floor lies far
    # below the limit on either (H100 runs: <= 4.3e-5)
    trainer, batch, draws = probe.last
    plain_floor = loss_floor(
        trainer, batch, dataclasses.replace(draws, use_ref_as_target=False))
    for refign in sorted({not draws.use_ref_as_target, True}):
        d = dataclasses.replace(draws, use_ref_as_target=not refign)
        compare_step(
            f"cli fit's last step, "
            f"{'Refign' if refign else 'ref as target'} branch",
            *grads_kernels_vs_plain(trainer, batch, draws=d),
            TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL,
            TRAIN_BF16_TOTAL_REL, TRAIN_BF16_MEDIAN_REL,
            loss_noise=plain_floor)
    backward_varies = backward_repeat(trainer, batch, draws)
    del trainer, batch, draws
    # the fit's own trainer on its last batch, the loader stopped
    alone = time_alone(probe.real, probe.last)
    probe.last = None
    log(f"  the same step on the fit's last batch with the loader "
        f"stopped: {[round(x * 1e3, 1) for x in alone]} ms, median "
        f"{statistics.median(alone) * 1e3:.1f} ms")
    if probe.prof is not None:
        share, n_ev = busy_share(probe.prof, probe.window)
        log(f"  profiled fit steps {RUNTIME_PROFILED[0] + 1}-"
            f"{RUNTIME_PROFILED[-1] + 1}: {probe.window * 1e3:.1f} ms "
            f"window, device busy {100 * share:.1f} % ({n_ev} device "
            f"events, kernels and copies)")
        report_profile(probe.prof, probe.window, "fit window", top_n=12)
    for (a, out, sec) in saves.calls:
        size = os.path.getsize(out)
        log(f"  checkpoint {os.path.basename(out)}: {size / 2 ** 30:.3f} "
            f"GiB written in {sec:.2f} s ({size / 2 ** 30 / sec:.2f} "
            f"GiB/s)")
    if len(saves.calls) != 1:
        raise AssertionError(f"{len(saves.calls)} checkpoints written")
    fit_val = [c for c in evals.calls if c[0][1] == "val"]
    fit_iou = fit_val[-1][1]
    fit_conf = fit_val[-1][0][0].last_confmats
    if fit_iou != {k: v for k, v in lines[-1].items() if k != "step"}:
        raise AssertionError(f"logged {lines[-1]} vs {fit_iou}")

    fit_fwd = [sec / a[2].shape[0] for a, _, sec in fwds.calls]

    # validate after the reload
    evals.calls.clear()
    fwds.calls.clear()
    last = os.path.join(wd, "checkpoints", "last")
    reset()
    try:
        cli.main(["validate", "--ckpt_path", last] + common)
    finally:
        fwds.restore()
    val_launches = read()
    (args, val_iou, _), = evals.calls
    if val_iou != fit_iou:
        raise AssertionError(f"validate after reload {val_iou} != the "
                             f"fit's last validation {fit_iou}")
    for name, conf in fit_conf.items():
        for ig, c in conf.items():
            if not torch.equal(c, args[0].last_confmats[name][ig]):
                raise AssertionError(f"{name} confusion matrices differ")
    per_image = fit_fwd + [sec / a[2].shape[0]
                           for a, _, sec in fwds.calls]
    log(f"  validate after reload: {val_iou} (= the fit's last "
        f"validation, confusion matrices identical); launches "
        f"{val_launches}; forward per 1080x1920 image (slide "
        f"inference, fp32) {[round(x * 1e3, 1) for x in per_image]} ms "
        f"over the fit's and this validation, median "
        f"{statistics.median(per_image) * 1e3:.1f} ms")
    if not (val_launches["sra_attention"]
            and val_launches["dwconv3x3_gelu"]):
        raise AssertionError(f"validate launches {val_launches}")
    evals.restore()
    check_eval_plain(fwds.real, fwds.calls[0],
                     lambda task: task.datamodule.eval_dataloaders("val"))
    fwds.calls.clear()

    # predict
    preds = Recorder(seg_task.SegTask, "predict")
    fwds = Recorder(seg_task.SegTask, "forward")
    try:
        reset()
        cli.main(["predict", "--ckpt_path", last] + common)
        pred_launches = read()
    finally:
        preds.restore()
        fwds.restore()
    from PIL import Image
    from refign_tpu_torch.data.datasets.seg_datasets import ACDC
    for sub in ("preds", "color_preds"):
        d = os.path.join(wd, sub, "ACDC")
        files = sorted(os.listdir(d))
        sizes = {Image.open(os.path.join(d, f)).size for f in files}
        if len(files) != 2 or sizes != {ACDC.orig_dims[::-1]}:
            raise AssertionError(f"{sub}: {files} sizes {sizes}")
    per_image = [sec / a[2].shape[0] for a, _, sec in fwds.calls]
    fwds.calls.clear()
    (_, _, pred_sec), = preds.calls
    log(f"  predict: 2 trainId and 2 colour PNGs at 1080x1920; forward "
        f"per image {[round(x * 1e3, 1) for x in per_image]} ms; the "
        f"whole call {pred_sec * 1e3:.1f} ms (the checkpoint's restore "
        f"and the loader's start, the forwards, the PNG writes); "
        f"launches {pred_launches}")

    # UAWarpC stage 1: fit 3 steps, then validate
    wd1 = os.path.join(root, "stage1")
    common1 = ["--config", STAGE1_YAML, "--data_dir", data,
               "--workdir", wd1,
               "--model.init_args.alignment_backbone.init_args."
               "pretrained", weights["vgg16"]]
    aprobe = StepProbe(atr, counted)
    try:
        reset()
        cli.main(["fit"] + common1 + [
            "--trainer.max_steps", str(RUNTIME_ALIGN_STEPS),
            "--trainer.val_every_n_steps", str(RUNTIME_ALIGN_STEPS),
            "--trainer.log_every_n_steps", "1"])
        align_launches = read()
    finally:
        aprobe.restore()
    want = {n: ALIGN_TRAIN_LAUNCHES.get(n, 0) for n in counted}
    for i, s in enumerate(aprobe.steps):
        if s["launches"] != want:
            raise AssertionError(f"UAWarpC fit step {i + 1}: launches "
                                 f"{s['launches']}, expected {want}")
    lines = _jsonl(os.path.join(wd1, "metrics.jsonl"))
    if not all(_finite(l) for l in lines):
        raise AssertionError(f"non-finite UAWarpC logs: {lines}")
    atiming = _jsonl(os.path.join(wd1, "timing.jsonl"))
    astep = [t["step_s"] for t in atiming[1:]]
    await_ = [t["data_wait_s"] for t in atiming[1:]]
    aalone = time_alone(aprobe.real, aprobe.last)
    aprobe.last = None
    log(f"  cli UAWarpC fit step (B=6 750^2 -> 520^2, steps 2-"
        f"{RUNTIME_ALIGN_STEPS}): {[round(x * 1e3, 1) for x in astep]} "
        f"ms, loader wait {[round(x * 1e3, 1) for x in await_]} ms; the "
        f"same step on the fit's last batch with the loader stopped "
        f"{[round(x * 1e3, 1) for x in aalone]} ms; phase 6b's bare step "
        f"{bare_align_sec * 1e3:.1f} ms; on {card}; launches per step "
        f"{aprobe.steps[-1]['launches']}")
    reset()
    cli.main(["validate", "--ckpt_path",
              os.path.join(wd1, "checkpoints", "last")] + common1)
    aval = json.load(open(os.path.join(wd1, "val_metrics.json")))
    if not _finite(aval) or aval != {k: v for k, v in lines[-1].items()
                                     if k != "step"}:
        raise AssertionError(f"UAWarpC validate {aval} vs the fit's "
                             f"{lines[-1]}")
    log(f"  UAWarpC validate after reload: {aval}; launches {read()}")

    # Refign-DeepLabV2 test (no hand-written kernel on its path)
    wd2 = os.path.join(root, "deeplabv2")
    reset()
    cli.main(["test", "--config", DL_YAML, "--data_dir", data,
              "--workdir", wd2,
              "--model.init_args.backbone.init_args.pretrained", "null",
              "--model.init_args.alignment_backbone.init_args.pretrained",
              weights["vgg16"],
              "--model.init_args.alignment_head.init_args.pretrained",
              weights["uawarpc"]])
    dl = json.load(open(os.path.join(wd2, "test_metrics.json")))
    if not _finite(dl) or any(read().values()):
        raise AssertionError(f"DeepLabV2 test {dl}, launches {read()}")
    log(f"  Refign-DeepLabV2 test: {dl}; no kernel launched")
    sec = time.perf_counter() - t_phase
    log(f"  runtime phase took {sec:.1f} s")
    return fit_launches, sec, dict(wd=wd, common=common, lines=hrda_lines,
                                   confmats=fit_conf, steps=steps,
                                   backward_varies=backward_varies,
                                   loss_floor=plain_floor)


# --- phase 6e: data parallel over torch.distributed --------------------

DIST_FIT_STEPS = 3
DIST_WORLD = 2
# the gloo check's global batches: the UDA step at B=2 + 2 (one row a
# rank), its small fp32 model at B=2 256^2; the UAWarpC stage-1 step at 6
# pairs (3 a rank), its reduced fp32 step at 2 pairs of 288^2 -> 256^2
DIST_UDA_B = 2
DIST_ALIGN_B = 6
DIST_TIMED_STEPS = 2


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _counted():
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_backward)
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    return {"sra_attention": sra_attention,
            "sra_attention_backward": sra_attention_backward,
            "dwconv3x3_gelu": dwconv3x3_gelu,
            "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
            "local_correlation": local_correlation,
            "local_correlation_backward": local_correlation_backward}


def _timed_collectives():
    """Wraps ``torch.distributed.all_reduce`` and ``broadcast``: the host
    seconds spent in them and their count (the whole collective for gloo,
    which returns when it is done; the launch for NCCL, whose time is read
    from the profile)."""
    import torch.distributed as dist
    acc = {"sec": 0.0, "calls": 0}
    real = {n: getattr(dist, n) for n in ("all_reduce", "broadcast")}

    def wrap(fn):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc["sec"] += time.perf_counter() - t
                acc["calls"] += 1
        return timed
    for n, fn in real.items():
        setattr(dist, n, wrap(fn))

    def undo():
        for n, fn in real.items():
            setattr(dist, n, fn)
    return acc, undo


def _nccl_ms(prof):
    """Device milliseconds of the NCCL kernels in a profile."""
    total = 0.0
    for e in prof.key_averages():
        if "nccl" in e.key.lower():
            total += getattr(e, "device_time_total", 0.0) or getattr(
                e, "cuda_time_total", 0.0)
    return total / 1e3


def cli_worker(out_path, argv):
    """A rank of torch's launcher: ``cli.main(argv)`` with each train
    step's launches counted (and the second step profiled for its NCCL
    kernels), the evaluations' confusion matrices kept, the collectives'
    host time and the peak memory; rank 0 writes them to ``out_path``."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from refign_tpu_torch import cli
    from refign_tpu_torch.tasks import seg_task
    probe = StepProbe(seg_task, _counted(), profiled=(1,))
    evals = Recorder(seg_task.SegTask, "evaluate")
    acc, undo = _timed_collectives()
    per_step = []

    def step(*a, **k):
        c0 = acc["sec"], acc["calls"]
        out = probe(*a, **k)
        per_step.append((acc["sec"] - c0[0], acc["calls"] - c0[1]))
        return out
    seg_task.train_step = step
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        probe.restore()
        evals.restore()
        undo()
    out = {"rank": int(os.environ.get("RANK", 0)),
           "world": int(os.environ.get("WORLD_SIZE", 1)),
           "sec": time.perf_counter() - t0, "steps": probe.steps,
           "collective_host_s": acc["sec"], "collectives": acc["calls"],
           "step_collectives": per_step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "confmats": [{n: {str(ig): c.tolist() for ig, c in m.items()}
                         for n, m in a[0].last_confmats.items()}
                        for a, _, _ in evals.calls],
           "eval_s": [sec for _, _, sec in evals.calls]}
    if probe.prof is not None:
        out["nccl_ms_profiled_step"] = _nccl_ms(probe.prof)
        out["profiled_step_s"] = probe.window
    if out["rank"] == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return 0


def _launch(argv, out_path, nproc=1, timeout=600):
    """``cli_worker`` on ``nproc`` ranks through torch's launcher; its
    record."""
    port = _free_port()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "localhost", "--master_port",
           str(port), os.path.abspath(__file__), "--cli-worker", out_path,
           "--"] + argv
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[:8])} ... exited "
                             f"{res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    with open(out_path) as f:
        rec = json.load(f)
    rec["launch_s"] = time.perf_counter() - t0
    return rec


def _loss_keys(line):
    return {k: v for k, v in line.items() if k.startswith("train_")}


def phase_dist_cli(card, rt, root):
    """6e (a): the CLI's fit and validate of refign_hrda_star.yaml under
    torch's launcher at world size 1 over NCCL, against phase 6d's fit and
    validation without a process group."""
    import torch
    from refign_tpu_torch import cli
    wd = os.path.join(root, "hrda_nccl")
    common = list(rt["common"])
    common[common.index("--workdir") + 1] = wd
    rec = _launch(["fit"] + common + [
        "--trainer.max_steps", str(DIST_FIT_STEPS),
        "--trainer.val_every_n_steps", str(10 ** 6),
        "--trainer.log_every_n_steps", "1"],
        os.path.join(root, "nccl_fit.json"))
    if rec["world"] != 1:
        raise AssertionError(f"launcher world size {rec['world']}")
    for i, s in enumerate(rec["steps"]):
        want = {n: TRAIN_LAUNCHES.get(n, 0) for n in s["launches"]}
        if not s["refign"]:
            want["local_correlation"] = 0
        if s["launches"] != want:
            raise AssertionError(f"NCCL fit step {i + 1}: launches "
                                 f"{s['launches']}, expected {want}")
        if s["refign"] != rt["steps"][i]["refign"]:
            raise AssertionError(f"NCCL fit step {i + 1}: another branch")
    # a second group-free fit in this process: how far two fits without a
    # group drift apart once a step's backward does not repeat bit for bit
    fwd_ = os.path.join(root, "hrda_free")
    free = list(rt["common"])
    free[free.index("--workdir") + 1] = fwd_
    cli.main(["fit"] + free + [
        "--trainer.max_steps", str(DIST_FIT_STEPS),
        "--trainer.val_every_n_steps", str(10 ** 6),
        "--trainer.log_every_n_steps", "1"])
    torch.cuda.empty_cache()

    def losses(lines):
        return [_loss_keys(l) for l in lines
                if "train_loss_total" in l][:DIST_FIT_STEPS]

    def rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}

    got = losses(_jsonl(os.path.join(wd, "metrics.jsonl")))
    again = losses(_jsonl(os.path.join(fwd_, "metrics.jsonl")))
    want = losses(rt["lines"])
    if got[0] != want[0] or again[0] != want[0]:
        raise AssertionError(f"fit step 1: NCCL world size 1 {got[0]}, "
                             f"group-free {again[0]} and {want[0]} differ")
    # after step 1 the fits part by the backward's atomic adds: a
    # parameter's fp32 master that lands on the other side of a bf16
    # rounding moves its bf16 copy by one ulp.  One sample of that (the
    # second group-free fit) can miss it (featdist 0 here, 5.3e-4 in
    # another run), so steps 2 on are held to 10x the larger of that
    # spread and phase 6d's one-bf16-ulp loss floor
    noise = max(rt["loss_floor"].values())
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        r, spread = rel(g, w), rel(a, w)
        log(f"  NCCL world size 1, fit step {i + 1}: losses "
            + ("bit-equal to the group-free fit's" if g == w else
               "differ from the group-free fit's by " + ", ".join(
                   f"{k[len('train_'):]} {v:.2e}" for k, v in r.items())
               + "; a second group-free fit differs by " + ", ".join(
                   f"{k[len('train_'):]} {v:.2e}"
                   for k, v in spread.items()))
            + f"; limit {10 * max(max(spread.values()), noise):.2e}"
            + f"; launches {rec['steps'][i]['launches']}")
        if g != w and not (rt["backward_varies"] and max(r.values())
                           <= 10 * max(max(spread.values()), noise)):
            raise AssertionError(
                f"NCCL fit step {i + 1}: losses differ ({r}) beyond 10x "
                f"what two group-free fits differ by ({spread}) and the "
                f"one-ulp floor ({noise:.2e}; the backward repeats: "
                f"{not rt['backward_varies']})")
    timing = _jsonl(os.path.join(wd, "timing.jsonl"))
    step_s = [t["step_s"] for t in timing[1:]]
    log(f"  NCCL world size 1 fit on {card}: step (steps 2-"
        f"{DIST_FIT_STEPS}) {[round(x * 1e3, 1) for x in step_s]} ms; "
        f"collectives a step "
        f"{[c for _, c in rec['step_collectives']]} calls, "
        f"{[round(x * 1e3, 2) for x, _ in rec['step_collectives']]} ms of "
        f"host time in them; "
        f"{rec.get('nccl_ms_profiled_step', float('nan')):.3f} ms of NCCL "
        f"kernels in the profiled step 2 "
        f"({rec.get('profiled_step_s', float('nan')) * 1e3:.1f} ms "
        f"window; one rank's collectives may run as plain copies); "
        f"{rec['collectives']} collectives over the run (the start's "
        f"broadcasts of every parameter included), "
        f"{rec['collective_host_s'] * 1e3:.1f} ms; peak memory "
        f"{rec['peak_gib']:.2f} GiB; loader wait "
        f"{[round(t['data_wait_s'] * 1e3, 1) for t in timing]} ms; the "
        f"launcher's run {rec['launch_s']:.1f} s")
    vwd = os.path.join(root, "hrda_nccl_val")
    common[common.index("--workdir") + 1] = vwd
    vrec = _launch(["validate", "--ckpt_path",
                    os.path.join(rt["wd"], "checkpoints", "last")] + common,
                   os.path.join(root, "nccl_val.json"))
    got_conf = vrec["confmats"][-1]
    for name, m in rt["confmats"].items():
        for ig, c in m.items():
            if got_conf[name][str(ig)] != c.tolist():
                raise AssertionError(f"NCCL validate: {name} confusion "
                                     f"matrix differs from phase 6d's")
    log(f"  NCCL world size 1 validate of phase 6d's checkpoint: confusion "
        f"matrices equal to phase 6d's; {vrec['eval_s'][-1]:.1f} s for the "
        f"validation; the launcher's run {vrec['launch_s']:.1f} s")
    return dict(fit=rec, step_s=step_s, timing=timing, val=vrec)


def _grads(module):
    return {n: p.grad.detach().float().cpu().clone()
            for n, p in module.named_parameters() if p.grad is not None}


def _logs(logs):
    return {k: v.detach().float().cpu() for k, v in logs.items()}


@contextlib.contextmanager
def per_rank_convolutions(world):
    """Within the block every 2-D convolution of a batch that ``world``
    divides runs as ``world`` calls on equal blocks of its rows, the batch
    a rank's call gets: cuDNN picks its algorithms, and so its summation
    order, by the batch size, so one process matches the ranks' order
    only this way."""
    import torch
    import torch.nn.functional as F
    if world == 1:
        yield
        return
    real = F.conv2d

    def conv2d(x, *a, **k):
        if x.dim() != 4 or x.shape[0] % world:
            return real(x, *a, **k)
        return torch.cat([real(c, *a, **k) for c in x.chunk(world)])
    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = real


def dist_reference(out_dir, world):
    """One process on the global batches of 6e (b), its results saved to
    ``out_dir/single.pt``: the UDA step's and the UAWarpC step's logs and
    gradients (fp32 small, bf16 full width), and one 1080x1920 HRDA*
    validation image's fp32 logits.  The fp32 UAWarpC steps with cuDNN run
    their convolutions in per-rank-sized calls
    (:func:`per_rank_convolutions`); the first also with whole-batch
    calls, which only the log reads."""
    import torch
    from refign_tpu_torch.entry import (build_hrda_star, build_uda_trainer,
                                        hrda_slide_forward)
    from refign_tpu_torch.uda.trainer import draw_step, forward_backward
    out = {}
    for what, kw in _dist_uda_cases():
        tr = build_uda_trainer(device="cuda", **kw["build"])
        batch = uda_batch(kw["B"], kw["S"], kw["seed"], "cuda")
        draws = draw_step(tr.cfg, batch, torch.Generator().manual_seed(
            kw["seed"]))
        draws.use_ref_as_target = False
        logs = forward_backward(tr, batch, draws)
        out[what] = (_logs(logs), _grads(tr.state.student))
        if what == "uda_bf16":
            tr.state.optimizer.zero_grad(set_to_none=True)
            out[what + "_floor"] = loss_floor(
                tr, batch, draws, plain=False,
                what="one process on 6e (b)'s global batch")
        del tr, batch
    cases = _dist_align_cases()
    cases.append(("align_fp32_whole_batch_convs",
                  dict(cases[0][1], per_rank_convs=False)))
    for what, kw in cases:
        torch.backends.cudnn.enabled = kw.get("cudnn", True)
        try:
            with per_rank_convolutions(
                    world if kw.get("per_rank_convs") else 1):
                out.update(_align_reference(what, kw))
        finally:
            torch.backends.cudnn.enabled = True
    model = build_hrda_star("mit_b5", dtype=torch.float32, device="cuda",
                            seed=3)
    img, label = _dist_eval_image()
    out["eval"] = hrda_slide_forward(model, img.cuda()).cpu()
    del model
    torch.save(out, os.path.join(out_dir, "single.pt"))


def _align_reference(what, kw):
    """One process's UAWarpC step of a 6e (b) case: its logs and head
    gradients, and for ``align_fp32`` and ``align_bf16`` the noise floor,
    the same step from the frozen weights moved by one ulp (of their
    dtype) in random directions."""
    import torch
    from refign_tpu_torch.alignment.trainer import draw_align
    from refign_tpu_torch.alignment.trainer import (
        forward_backward as align_fb)
    from refign_tpu_torch.entry import build_align_trainer
    tr = build_align_trainer(1, device="cuda", **kw["build"])
    batch = align_batch(kw["B"], kw["S"], kw["seed"], "cuda")
    B, H, W = batch["image_trg"].shape[:3]
    draws = draw_align(tr.cfg, B, H, W,
                       torch.Generator().manual_seed(kw["seed"]))
    saved = {k: v.clone() for k, v in tr.state.head.state_dict().items()}
    out = {what: (_logs(align_fb(tr, batch, draws)), _grads(tr.state.head))}
    if what in ("align_fp32", "align_bf16"):
        tr.state.optimizer.zero_grad(set_to_none=True)
        tr.state.head.load_state_dict(saved)
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for p in tr.state.backbone.parameters():
                up = (torch.rand(p.shape, generator=g) < 0.5).to(p.device)
                inf = torch.full_like(p, float("inf"))
                p.copy_(torch.where(up, torch.nextafter(p, inf),
                                    torch.nextafter(p, -inf)))
        out[what + "_floor"] = (_logs(align_fb(tr, batch, draws)),
                                _grads(tr.state.head))
    return out


def _dist_uda_cases():
    import dataclasses
    from refign_tpu_torch.entry import REFIGN_HRDA_STAR
    cfg32 = dataclasses.replace(REFIGN_HRDA_STAR, compute_dtype="float32")
    return [("uda_fp32", dict(build=dict(model_type="mit_b1", cfg=cfg32,
                                         seed=1, channels=64),
                              B=2, S=256, seed=1)),
            ("uda_bf16", dict(build=dict(model_type="mit_b5", seed=0),
                              B=DIST_UDA_B, S=UDA_HW, seed=0))]


def _dist_align_cases():
    import dataclasses
    from refign_tpu_torch.entry import UAWARPC_STAGE1
    cfg32 = dataclasses.replace(UAWARPC_STAGE1, compute_dtype="float32",
                                crop_after_flow=(256, 256))
    # the fp32 step also with PyTorch's own convolutions (cuDNN off); with
    # cuDNN, whose algorithms (so summation order) follow the batch size,
    # one process runs its convolutions in per-rank-sized calls
    fp32 = dict(build=dict(cfg=cfg32, seed=1), B=2, S=288, seed=1,
                per_rank_convs=True)
    bf16 = dict(build=dict(seed=0), B=DIST_ALIGN_B, S=ALIGN_TRAIN_LOAD,
                seed=0)
    return [("align_fp32", fp32),
            ("align_fp32_no_remat", dict(fp32, build=dict(
                cfg=dataclasses.replace(cfg32, remat_modules=False),
                seed=1))),
            ("align_fp32_no_cudnn", dict(fp32, cudnn=False,
                                         per_rank_convs=False)),
            ("align_bf16", bf16)]


def _dist_eval_image():
    """A seeded 1x1080x1920 normalised image and its labels (blocks of 60
    pixels, an ignored band)."""
    import torch
    g = torch.Generator().manual_seed(4)
    img = torch.randn(1, 1080, 1920, 3, generator=g)
    lab = torch.randint(0, 19, (1, 18, 32), generator=g)
    lab = lab.repeat_interleave(60, 1).repeat_interleave(60, 2)
    lab[:, :20] = 255
    return img, lab


def dist_rank(rank, world, port, out_dir, backend):
    """A rank of 6e (b): the global batches' steps and the validation
    image on this rank's rows, over ``backend`` (gloo: every rank on
    cuda:0; NCCL: rank r on cuda:r)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import refign_tpu_torch
    from refign_tpu_torch.alignment.trainer import (draw_align,
                                                    train_step as align_ts)
    from refign_tpu_torch.alignment.trainer import (
        forward_backward as align_fb)
    from refign_tpu_torch.entry import (build_align_trainer, build_hrda_star,
                                        build_uda_trainer,
                                        hrda_slide_forward)
    from refign_tpu_torch.metrics import iou_init, iou_update
    from refign_tpu_torch.parallel import mesh
    from refign_tpu_torch.uda.trainer import (draw_step, forward_backward,
                                              train_step)
    refign_tpu_torch.full_fp32_precision()
    device = f"cuda:{0 if backend == 'gloo' else rank}"
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    mesh.init_distributed(device, backend=backend, env=env)
    counted = _counted()
    acc, undo = _timed_collectives()
    out = {"rank": rank}

    def reset():
        for f in counted.values():
            f.launches = 0

    def read():
        return {n: f.launches for n, f in counted.items()}
    try:
        for what, kw in _dist_uda_cases():
            tr = build_uda_trainer(device=device, **kw["build"])
            batch = uda_batch(kw["B"], kw["S"], kw["seed"], device)
            gen = torch.Generator().manual_seed(kw["seed"])
            draws = draw_step(tr.cfg, batch, gen)
            draws.use_ref_as_target = False
            logs = forward_backward(tr, batch, draws)
            out[what] = (_logs(logs),
                         _grads(tr.state.student) if rank == 0 else None)
            if what == "uda_bf16":
                tr.state.optimizer.zero_grad(set_to_none=True)
                times, colls = [], []
                torch.cuda.reset_peak_memory_stats()
                for i in range(1 + DIST_TIMED_STEPS):
                    d = draw_step(tr.cfg, batch, gen)
                    d.use_ref_as_target = False
                    reset()
                    c0 = acc["sec"]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    train_step(tr, batch, d)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                    colls.append(acc["sec"] - c0)
                    if i == 0:
                        out["uda_launches"] = read()
                out["uda_step_s"] = times[1:]
                out["uda_collective_s"] = colls[1:]
                out["uda_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
                out["uda_divergence"] = mesh.max_param_divergence(
                    [tr.state.student, tr.state.teacher])
            del tr, batch
            torch.cuda.empty_cache()
        for what, kw in _dist_align_cases():
            torch.backends.cudnn.enabled = kw.get("cudnn", True)
            tr = build_align_trainer(1, device=device, **kw["build"])
            batch = align_batch(kw["B"], kw["S"], kw["seed"], device)
            gen = torch.Generator().manual_seed(kw["seed"])
            B, H, W = batch["image_trg"].shape[:3]
            draws = draw_align(tr.cfg, B, H, W, gen)
            logs = align_fb(tr, batch, draws)
            out[what] = (_logs(logs),
                         _grads(tr.state.head) if rank == 0 else None)
            if what == "align_bf16":
                tr.state.optimizer.zero_grad(set_to_none=True)
                times, colls = [], []
                torch.cuda.reset_peak_memory_stats()
                for i in range(1 + DIST_TIMED_STEPS):
                    d = draw_align(tr.cfg, B, H, W, gen)
                    reset()
                    c0 = acc["sec"]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    align_ts(tr, batch, d)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                    colls.append(acc["sec"] - c0)
                    if i == 0:
                        out["align_launches"] = read()
                out["align_step_s"] = times[1:]
                out["align_collective_s"] = colls[1:]
                out["align_peak_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
                out["align_divergence"] = mesh.max_param_divergence(
                    tr.state.head)
            torch.backends.cudnn.enabled = True
            del tr, batch
            torch.cuda.empty_cache()
        model = build_hrda_star("mit_b5", dtype=torch.float32,
                                device=device, seed=3)
        img, label = _dist_eval_image()
        reset()
        c0 = acc["sec"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mesh.compute_mesh():
            logits = hrda_slide_forward(model, img.to(device))
        torch.cuda.synchronize()
        out["eval_s"] = time.perf_counter() - t
        out["eval_collective_s"] = acc["sec"] - c0
        out["eval_launches"] = read()
        out["eval_conf"] = iou_update(iou_init(19).to(device),
                                      logits.argmax(-1),
                                      label.to(device)).cpu()
        if rank == 0:
            out["eval"] = logits.cpu()
    finally:
        undo()
        mesh.destroy_distributed()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_dist_ranks(card, root, backend, world):
    """6e (b) and (c): ``world`` ranks over ``backend`` against one
    process on the global batches (phase 6, 6b and 6d's limits)."""
    import torch
    import torch.multiprocessing as mp
    from refign_tpu_torch.metrics import iou_init, iou_update
    out_dir = os.path.join(root, f"dist_{backend}")
    os.makedirs(out_dir, exist_ok=True)
    if not os.path.exists(os.path.join(root, "dist_single.pt")):
        t0 = time.perf_counter()
        dist_reference(out_dir, world)
        os.replace(os.path.join(out_dir, "single.pt"),
                   os.path.join(root, "dist_single.pt"))
        torch.cuda.empty_cache()
        log(f"  one process on the global batches in "
            f"{time.perf_counter() - t0:.1f} s")
    single = torch.load(os.path.join(root, "dist_single.pt"),
                        weights_only=False)
    t0 = time.perf_counter()
    mp.start_processes(dist_rank, args=(world, _free_port(), out_dir,
                                        backend),
                       nprocs=world, start_method="spawn")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    log(f"  {world} ranks over {backend} in {time.perf_counter() - t0:.1f} s")
    r0 = ranks[0]
    for what, limits in (
            ("uda_fp32", (TRAIN_FP32_LOSS_REL, TRAIN_FP32_GRAD_REL,
                          TRAIN_FP32_TOTAL_REL, TRAIN_FP32_MEDIAN_REL)),
            ("uda_bf16", (TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL,
                          TRAIN_BF16_TOTAL_REL, TRAIN_BF16_MEDIAN_REL))):
        for r in ranks[1:]:
            if any(not torch.equal(r[what][0][k], v)
                   for k, v in r0[what][0].items()):
                raise AssertionError(f"{what}: the ranks' logs differ")
        compare_step(f"{what} over {world} {backend} ranks vs one process",
                     r0[what], single[what], *limits,
                     loss_noise=single.get(what + "_floor"))
    # the UAWarpC step.  The head's train-mode BatchNorm amplifies fp32
    # rounding (tests/test_torch_align_train_step.py), and the ranks' sums
    # (sync-BN's statistics, the masked means) take another order than one
    # process's, so the gradients over all parameters and of the median one
    # are held as that file holds the port against JAX: 1e-4 (phase 6b's
    # bf16 limits in bf16) + 5x one process's own movement under a one-ulp
    # change of the frozen weights.  The losses and every parameter's
    # gradient are held at phase 6b's limits (+ 5x the floor for the bf16
    # losses).  In fp32 one process runs cuDNN's convolutions in
    # per-rank-sized calls, since cuDNN picks its algorithms by the batch
    # size (with whole-batch calls one head gradient moved by 0.15 on an
    # H100; that comparison is logged, not held).  In bf16 the
    # per-rank calls bring one process no closer: its one-ulp floor moves
    # single head gradients by up to 0.31 there
    floors = {}
    for dtype in ("fp32", "bf16"):
        floors[dtype] = compare_align_step(
            f"align_{dtype}: one process against itself, the frozen weights "
            f"moved by one ulp", single[f"align_{dtype}_floor"],
            single[f"align_{dtype}"], 1, 1, 1, 1, per_param=True)
    for run, dtype, loss_limit, total, median, grad in (
            ("align_fp32_no_cudnn", "fp32", ALIGN_FP32_LOSS_REL, 1e-4, 1e-4,
             ALIGN_FP32_GRAD_REL),
            ("align_fp32", "fp32", ALIGN_FP32_LOSS_REL, 1e-4, 1e-4,
             ALIGN_FP32_GRAD_REL),
            ("align_fp32_no_remat", "fp32", ALIGN_FP32_LOSS_REL, 1e-4, 1e-4,
             ALIGN_FP32_GRAD_REL),
            ("align_bf16", "bf16", ALIGN_BF16_LOSS_REL
             + 5 * floors["bf16"][0], ALIGN_BF16_TOTAL_REL,
             ALIGN_BF16_MEDIAN_REL, ALIGN_BF16_GRAD_REL)):
        f = floors[dtype]
        compare_align_step(f"{run} over {world} {backend} ranks vs one "
                           f"process", r0[run], single[run], loss_limit,
                           total + 5 * f[1], median + 5 * f[2], grad)
    compare_align_step(f"align_fp32 over {world} {backend} ranks vs one "
                       f"process with whole-batch cuDNN calls (logged, not "
                       f"held)", r0["align_fp32"],
                       single["align_fp32_whole_batch_convs"],
                       *[float("inf")] * 4)
    # remat_modules replays the statistics its forward reduced: the same
    # step with it and without it
    compare_align_step(f"align_fp32 over {world} {backend} ranks, "
                       f"remat_modules against none", r0["align_fp32"],
                       r0["align_fp32_no_remat"], ALIGN_FP32_LOSS_REL,
                       ALIGN_FP32_TOTAL_REL, ALIGN_FP32_MEDIAN_REL,
                       ALIGN_FP32_GRAD_REL)
    for r in ranks:
        want = {n: TRAIN_LAUNCHES.get(n, 0) for n in r["uda_launches"]}
        if r["uda_launches"] != want:
            raise AssertionError(f"rank {r['rank']}: UDA step launches "
                                 f"{r['uda_launches']}, expected {want}")
        want = {n: ALIGN_TRAIN_LAUNCHES.get(n, 0)
                for n in r["align_launches"]}
        if r["align_launches"] != want:
            raise AssertionError(f"rank {r['rank']}: UAWarpC step launches "
                                 f"{r['align_launches']}, expected {want}")
        if r["uda_divergence"] or r["align_divergence"]:
            raise AssertionError(f"rank {r['rank']}: parameters differ "
                                 f"across ranks ({r['uda_divergence']}, "
                                 f"{r['align_divergence']})")
        if not r["eval_launches"]["sra_attention"]:
            raise AssertionError(f"rank {r['rank']}: validation launched "
                                 f"no kernel")
    # the validation image: logits and confusion matrix against one
    # process (equal but for pixels whose two largest logits lie within
    # twice the logits' largest difference, the rule of phase 6d)
    img, label = _dist_eval_image()
    out_p, out_d = single["eval"], r0["eval"]
    diff = (out_d - out_p).abs().max()
    rel = (diff / out_p.abs().max()).item()
    top2 = out_p.topk(2, dim=-1).values
    near = int(((top2[..., 0] - top2[..., 1]) <= 2 * diff).sum())
    conf_p = iou_update(iou_init(19), out_p.argmax(-1), label)
    moved = int((r0["eval_conf"] - conf_p).abs().sum()) // 2
    for r in ranks[1:]:
        if not torch.equal(r["eval_conf"], r0["eval_conf"]):
            raise AssertionError("the ranks' confusion matrices differ")
    log(f"  1080x1920 HRDA* validation image, 30 rows spread over {world} "
        f"ranks, fp32: logits vs one process max rel {rel:.2e} (limit "
        f"{E2E_FP32_REL:g}); confusion matrices differ by {moved} pixels "
        f"({near} within the tie margin {2 * diff.item():.2e}); launches "
        f"a rank {r0['eval_launches']}")
    if not (rel <= E2E_FP32_REL and moved <= near):
        raise AssertionError("row-spread validation disagrees with one "
                             "process")
    for r in ranks:
        log(f"  rank {r['rank']} on {card}: UDA step (B=1 + 1 a rank, "
            f"1024^2) {[round(x * 1e3, 1) for x in r['uda_step_s']]} ms, "
            f"collectives {[round(x * 1e3, 1) for x in r['uda_collective_s']]}"
            f" ms of host time, peak {r['uda_peak_gib']:.2f} GiB; UAWarpC "
            f"step (3 pairs a rank) "
            f"{[round(x * 1e3, 1) for x in r['align_step_s']]} ms, "
            f"collectives "
            f"{[round(x * 1e3, 1) for x in r['align_collective_s']]} ms, "
            f"peak {r['align_peak_gib']:.2f} GiB; validation image "
            f"{r['eval_s'] * 1e3:.1f} ms (collectives "
            f"{r['eval_collective_s'] * 1e3:.1f} ms); no loader (batches "
            f"made on the card)")
    return ranks


def phase_distributed(card, rt, root):
    import torch
    t0 = time.perf_counter()
    log("  (a) NCCL at world size 1 through the CLI under "
        "torch.distributed.run")
    a = phase_dist_cli(card, rt, root)
    log(f"  (b) gloo at world size {DIST_WORLD}, every rank on cuda:0 "
        f"(a correctness check, not a speed: gloo stages the card's "
        f"tensors through the host)")
    b = phase_dist_ranks(card, root, "gloo", DIST_WORLD)
    n = torch.cuda.device_count()
    if n >= DIST_WORLD:
        log(f"  (c) NCCL at world size {DIST_WORLD}, one rank a card")
        phase_dist_ranks(card, root, "nccl", DIST_WORLD)
    else:
        log(f"  (c) not run: NCCL at world size {DIST_WORLD} needs "
            f"{DIST_WORLD} cards (NCCL refuses two ranks on one device) "
            f"and this machine has {n}")
    sec = time.perf_counter() - t0
    log(f"  data-parallel phase took {sec:.1f} s")
    return a, b, sec


KERNEL_GROUPS = [  # (group, substrings of device kernel names), first match
    ("K1 sra_attention", ("sra_attention_kernel",)),
    ("K1 backward", ("attn_bwd_",)),
    ("K2 dwconv3x3_gelu", ("dwconv3x3_gelu_kernel",)),
    ("K2 backward", ("dwconv_bwd_",)),
    ("K3 backward", ("::graw_kernel<", "::grad_kernel<",
                     "::raw_grad_kernel<", "::input_grad_kernel<")),
    ("K3 local_correlation", ("local_correlation",)),
    ("K4 dilated_dwconv", ("dilated_dwconv_fwd_kernel",)),
    # F.grid_sample runs as cuDNN's sampler on these shapes
    ("grid_sample", ("grid_sampler", "bilinear_sampler")),
    # cuDNN's implicit-GEMM convolutions carry "gemm" in their names too
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                             "winograd")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_",
                         "cublas")),
    ("resize", ("upsample", "interpolate", "bilinear")),
    ("reduction", ("reduce", "norm")),
    ("copy / cat", ("copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def profile_device(fn, sec, what, top_n=12):
    """Device time of one warm call of ``fn`` by kernel group
    (torch.profiler), and its ``top_n`` kernels; ``sec`` is its warm
    host-clock time.  Returns the device time in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return report_profile(prof, sec, what, top_n)


def device_sum_ms(prof):
    """The summed device time of a profile's kernels and copies (ms), as
    :func:`report_profile` sums it."""
    import torch
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def report_profile(prof, sec, what, top_n=12):
    """Log a profile's device time by kernel group and its ``top_n``
    kernels; ``sec`` is the host-clock time it covers.  Returns the device
    time in ms (0 where none was recorded)."""
    import torch
    groups, top = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in evt.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
        top.append((us, evt.count, evt.key))
    total = sum(groups.values())
    if total == 0:
        log("  profiler: no device time recorded")
        return 0.0
    log(f"  profiled {what}: device busy {total / 1e3:.1f} ms of the "
        f"{sec * 1e3:.1f} ms warm {what} "
        f"({100 * total / 1e3 / (sec * 1e3):.1f} %), "
        f"{sum(n for _, n, _ in top)} device events")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:22s} {us / 1e3:8.2f} ms  {100 * us / total:5.1f} %")
    for us, n, key in sorted(top, reverse=True)[:top_n]:
        log(f"    top: {us / 1e3:8.2f} ms  x{n:<5d} {key[:100]}")
    return total / 1e3


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--cli-worker"]:
        # a rank of phase 6e's launcher run: python3 chip_smoke.py
        # --cli-worker OUT.json -- <cli arguments>
        return cli_worker(sys.argv[2], sys.argv[4:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import refign_tpu_torch
        from refign_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: refign_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    refign_tpu_torch.full_fp32_precision()

    card = card_line()
    log(f"[1/7] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with timed("2 build"):
        logs = _build.build_all()
    log(f"[2/7] built {len(logs)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(text):
            log(f"  {name}: {line}")

    log("[3/7] kernels against plain versions (bf16 limit "
        f"{BF16_REL:g}*|ref| + {BF16_ABS:g}, fp32 limit {FP32_ABS:g}; "
        f"backward: {GRAD_REL:g}*max|ref|, + {BF16_REL:g}*|ref| in bf16)")
    with timed("3"):
        rows = phase_kernels()
        rows += phase_backward_kernels()
        with timed("3 native oracle"):
            phase_native()
        phase_lab_yardsticks()

    log("[4/7] HRDA* path")
    with timed("4"):
        launches, sec = phase_main_path(card)
    log("[5/7] align path")
    with timed("5"):
        launches["local_correlation"], align_sec = phase_align(card)
    log("[6/7] UDA train step")
    with timed("6"):
        train_launches, train_sec, peak = phase_train(card)
    for name in ("sra_attention_backward", "dwconv3x3_gelu_backward"):
        launches[name] = train_launches[name]
    log("[6b/7] UAWarpC train step, stage 1")
    with timed("6b"):
        (align_launches, folded_launches, align_train_sec,
         align_peak) = phase_align_train(card)
    launches["local_correlation_backward"] = align_launches[
        "local_correlation_backward"]
    train_launches["local_correlation_backward"] = 0
    log("[6c/7] Refign-DeepLabV2: inference and UDA train step")
    with timed("6c"):
        dl_launches, dl_sec, dl_peak = phase_deeplabv2(card)
    root = tempfile.mkdtemp(prefix="refign_runtime_")
    try:
        log("[6d/7] runtime: the CLI's fit, validate, predict and test on "
            "synthetic trees at the datasets' sizes")
        with timed("6d"):
            rt_launches, rt_sec, rt = phase_runtime(card, train_sec,
                                                    align_train_sec, root)
        log("[6e/7] data parallel over torch.distributed: the CLI under "
            "torch's launcher at world size 1 over NCCL; 2 gloo ranks on "
            "cuda:0 against one process")
        with timed("6e"):
            phase_distributed(card, rt, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    log(f"[7/7] done in {time.perf_counter() - t_start:.1f} s; host-clock "
        f"seconds by phase and part:")
    for what, sec_ in sorted(SECONDS.items()):
        log(f"  {what}: {sec_:.1f} s")
    sources = {"sra_attention": ("refign_tpu_torch/csrc/sra_attention.cu",
                                 "refign_tpu/ops/attention.py:82"),
               "dwconv3x3_gelu": ("refign_tpu_torch/csrc/dwconv3x3_gelu.cu",
                                  "refign_tpu/ops/dwconv.py:102"),
               "local_correlation": (
                   "refign_tpu_torch/csrc/local_correlation.cu",
                   "refign_tpu/ops/correlation.py:106"),
               # the backward of each custom_vjp (the Pallas kernels have
               # none of their own)
               "sra_attention_backward": (
                   "refign_tpu_torch/csrc/sra_attention_backward.cu",
                   "refign_tpu/ops/attention.py:183"),
               "dwconv3x3_gelu_backward": (
                   "refign_tpu_torch/csrc/dwconv3x3_gelu_backward.cu",
                   "refign_tpu/ops/dwconv.py:162"),
               "local_correlation_backward": (
                   "refign_tpu_torch/csrc/local_correlation_backward.cu",
                   "refign_tpu/ops/correlation.py:135"),
               # no TPU kernel: the JAX package leaves this conv to XLA
               "dilated_dwconv3x3": (
                   "refign_tpu_torch/csrc/dilated_dwconv.cu", None)}
    kernels = []
    for name, (src, replaces) in sources.items():
        main_rows = [r for r in rows if r["name"] == name
                     and r["kind"] == "main"]

        def per_call(key):
            if any(r[key] is None for r in main_rows):
                return None
            return sum(r[key] * r["launches_per_forward"] for r in main_rows)

        bound_ops = [r for r in main_rows if r["bound_by"] == "operations"]
        ms, bound = per_call("ms"), per_call("bound_ms")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            launches_train_step=train_launches[name],
            # None: the phase does not count the kernel
            launches_align_train_step=align_launches.get(name),
            launches_align_train_step_folded=folded_launches.get(name),
            launches_deeplabv2_step=dl_launches.get(name),
            launches_cli_fit=rt_launches.get(name),
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["name"] == name),
            ms=ms, plain_ms=per_call("plain_ms"), bound_ms=bound,
            bound_by=("operations" if 2 * len(bound_ops) > len(main_rows)
                      else "bytes"),
            library_ms=per_call("library_ms"), bound_share=bound / ms))
    log("kernel times are per call of each kernel's path: K1 and K2 summed "
        "over their 52 launches and K4 over its 3 fused ones in one "
        f"1080x1920 HRDA* forward ({1.0 / sec:.3f} images/s), K3 over its "
        f"3 launches in one B=4 1024^2 align and refine ({align_sec * 1e3:.1f} ms), K1 and K2 "
        "backward (device time) over their 104 launches in one B=4 1024^2 "
        "train step "
        f"({train_sec * 1e3:.1f} ms, peak memory {peak:.1f} GiB)")
    log(f"  local_correlation_backward per stage-1 UAWarpC step: 9 launches "
        f"(B={ALIGN_TRAIN_B} {ALIGN_TRAIN_LOAD}^2 -> {ALIGN_TRAIN_CROP}^2, "
        f"{align_train_sec * 1e3:.1f} ms a step, "
        f"{ALIGN_TRAIN_B / align_train_sec:.3f} image pairs/s, peak memory "
        f"{align_peak:.2f} GiB)")
    for kind in ("align-train", "raw-train"):
        part = [r for r in rows if r["name"] == "local_correlation"
                and r["kind"] == kind]
        k_ms, k_bound, k_plain = (
            sum(r[k] * ALIGN_TRAIN_PASSES for r in part)
            for k in ("ms", "bound_ms", "plain_ms"))
        log(f"  local_correlation {kind} per stage-1 step (9 launches): "
            f"{k_ms:.3f} ms, bound {k_bound:.4f} ms "
            f"({100 * k_bound / k_ms:.1f} % of it), plain {k_plain:.3f} ms")
        if kind == "align-train":
            k3_align_train = dict(ms_align_train_step=k_ms,
                                  bound_ms_align_train_step=k_bound,
                                  plain_ms_align_train_step=k_plain)
    for name, kind in (("local_correlation", "align-fold"),
                       ("local_correlation_backward", "path-fold")):
        part = [r for r in rows if r["name"] == name and r["kind"] == kind]
        k_ms, k_bound, k_plain = (sum(r[k] for r in part)
                                  for k in ("ms", "bound_ms", "plain_ms"))
        log(f"  {name} {kind} per folded stage-1 step (3 launches of 18 "
            f"rows): {k_ms:.3f} ms, bound {k_bound:.4f} ms "
            f"({100 * k_bound / k_ms:.1f} % of it), plain {k_plain:.3f} ms")
        next(k for k in kernels if k["name"] == name).update(
            ms_align_train_step_folded=k_ms,
            bound_ms_align_train_step_folded=k_bound,
            plain_ms_align_train_step_folded=k_plain)
    part = [r for r in rows if r["name"] == "local_correlation"
            and r["kind"] == "deeplabv2"]
    k_ms, k_bound, k_plain = (sum(r[k] for r in part)
                              for k in ("ms", "bound_ms", "plain_ms"))
    log(f"  local_correlation per Refign-DeepLabV2 step (3 launches, B={DL_B} "
        f"{DL_HW}^2, {dl_sec * 1e3:.1f} ms a step, {DL_B / dl_sec:.3f} source "
        f"images/s, peak memory {dl_peak:.2f} GiB): {k_ms:.4f} ms, bound "
        f"{k_bound:.4f} ms ({100 * k_bound / k_ms:.1f} % of it), plain "
        f"{k_plain:.3f} ms")
    k3_align_train.update(ms_deeplabv2_step=k_ms,
                          bound_ms_deeplabv2_step=k_bound,
                          plain_ms_deeplabv2_step=k_plain)
    next(k for k in kernels if k["name"] == "local_correlation").update(
        k3_align_train)
    for kind, what, first in (
            ("main", "fused bf16, both gradients",
             "local_correlation_backward"),
            ("path", "fused bf16, gs alone (the path's call)",
             "local_correlation_backward in path")):
        part = [r for r in rows if r["name"] == "local_correlation_backward"
                and r["kind"] == kind]
        k_ms, k_bound = (sum(r[k] * ALIGN_TRAIN_PASSES for r in part)
                         for k in ("ms", "bound_ms"))
        log(f"  local_correlation_backward {what} per stage-1 step (9 "
            f"launches): {k_ms:.3f} ms, bound {k_bound:.4f} ms "
            f"({100 * k_bound / k_ms:.1f} % of it); first design "
            f"{FIRST_BACKWARD_STEP_MS[first]:.2f} ms"
            + (" (in-path, phase 6b's profile)" if kind == "path" else ""))
    raw = [r for r in rows if r["name"] == "local_correlation"
           and r["kind"] == "raw"]
    raw_ms, raw_bound = (sum(r[k] for r in raw) for k in ("ms", "bound_ms"))
    log(f"  local_correlation raw fp32 mode (off the path) {raw_ms:.3f} ms "
        f"per align, bound {raw_bound:.4f} ms "
        f"({100 * raw_bound / raw_ms:.1f} % of it)")
    libs = {"sra_attention": "SDPA", "dwconv3x3_gelu": "cuDNN conv + gelu",
            "sra_attention_backward": "SDPA forward + backward",
            "dwconv3x3_gelu_backward": "cuDNN conv + gelu backward",
            "dilated_dwconv3x3": "cuDNN grouped conv + BatchNorm chain"}
    for k in kernels:
        lib = libs.get(k["name"])
        first = FIRST_BACKWARD_STEP_MS.get(k["name"])
        log(f"  {k['name']:23s} {k['ms']:.3f} ms per call of its path, "
            f"bound {k['bound_ms']:.4f} ms ({100 * k['bound_share']:.1f} % "
            "of it)" + ("" if lib is None else
                        f", {lib} {k['library_ms']:.3f} ms "
                        f"({k['ms'] / k['library_ms']:.2f}x)")
            + ("" if first is None else
               f", first design {first:.2f} ms ({first / k['ms']:.2f}x)"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
