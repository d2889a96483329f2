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
   tools/, their bounds and library calls at their own shapes;
4. HRDA★ path: Refign-HRDA★ (MiT-B5, DAFormer, SegFormer scale attention,
   seeded random bf16 weights) on a 1x1080x1920 image through
   ``build_hrda_star`` and ``hrda_slide_forward``: the output is checked
   for shape and finiteness, K1 and K2 must launch 52 times per forward,
   and the forward must agree with the same model run through the plain
   versions; a small fp32 model checks the kernels' path tightly;
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
   memory and a profile;
6b. UAWarpC train step, stage 1: VGG-16 + UAWarpC (seeded random
   weights, bf16 on fp32 masters, remat_modules, Adam at lr 1e-4 and wd
   4e-4) on B=6 seeded synthetic uint8 pairs of 750^2, the prime view
   synthesised on the card and everything cropped to 520^2, through
   ``build_align_trainer`` and ``align_train_step``: from one state with
   the same draws, the losses and every head gradient through the kernels
   against the plain versions' (tightly on a reduced fp32 step, for the
   wiring at full size in bf16); one step must launch K3 and its backward
   9 times each (3 levels x 3 head passes); 1 warm-up and 5 timed steps
   with finite losses, the peak memory and a profile; then one stage-2
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
   every loss and metric finite;
7. each kernel's time per call of its path (K1 and K2 summed over the 52
   launches of a forward, beside SDPA's and cuDNN conv + gelu's sums; K3
   over an align; the backward kernels over the 104 launches of a train
   step, beside SDPA's and cuDNN's forward + backward and the sums of
   their first designs; K3's backward over the 9 launches of a stage-1
   UAWarpC step, both gradients and gs alone, beside its first design;
   K3 over a Refign-DeepLabV2 step), the ``kernels`` JSON line, the card
   line and, last, the result line.

There is no CPU path: without a CUDA device the script exits non-zero.
"""
import json
import os
import re
import statistics
import subprocess
import sys
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
# launches per step: the forward kernels run in the teacher, the ImageNet
# copy, both student passes and both recomputes of the remat; the backward
# kernels in both student backwards; K3 in the align step
TRAIN_LAUNCHES = {
    "sra_attention": 6 * LAUNCHES_PER_FORWARD,
    "sra_attention_backward": TRAIN_PASSES * LAUNCHES_PER_FORWARD,
    "dwconv3x3_gelu": 6 * LAUNCHES_PER_FORWARD,
    "dwconv3x3_gelu_backward": TRAIN_PASSES * LAUNCHES_PER_FORWARD,
    "local_correlation": 3,
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
    two events would time the host where it is the slower)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    """Elementwise |got - ref| <= rel*|ref| + abs_; returns max abs error."""
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
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond {rel:g}*|ref| + "
            f"{abs_:g}; max abs err {err.max().item():.3e}")
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

    def corr_bound(B, H, W, C, P, itemsize, out_itemsize):
        nbytes = (2 * B * H * W * C * itemsize
                  + B * H * W * P * P * out_itemsize)
        flops = 2.0 * B * H * W * P * P * C
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / peak_flops(itemsize)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    # (name, launches per call of its path, shape, kind, input dtype, K3's
    # output: None for the raw fp32 volume, else the fused mode's dtype)
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
        elif dtype == bf16:
            err = check_close(f"{name}{shape}", got, ref, BF16_REL, BF16_ABS)
        else:
            err = check_close(f"{name}{shape} fp32", got, ref, 0.0, FP32_ABS)
        mode = ("" if name != "local_correlation" else "raw fp32"
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
    noise of 0 (1e-5 of the sum of |t||s|) of their whole term, as the
    ReLU's slope there may differ between the kernel's recomputed sums and
    the plain version's."""
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
        jump = torch.where((raw != 0) & (raw.abs() <= 1e-5 * absraw),
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
    cases += [("local_correlation_backward", 0, (2, 33, 70, 40, 5), kind,
               torch.float32) for kind in ("ragged", "ragged-raw")]
    cases += [("local_correlation_backward", 0, (1, 17, 45, 40, 9), kind,
               bf16) for kind in ("ragged", "ragged-raw")]

    for name, n_launch, shape, kind, dtype in cases:
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
            fused = kind in ("main", "ragged", "path")
            need_t = kind != "path"
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
        # wrapper's CUDA-event time is logged beside it)
        row = dict(name=name, shape=list(shape), kind=kind, mode="",
                   dtype=str(dtype).replace("torch.", ""),
                   launches_per_forward=n_launch, max_abs_err=err,
                   ms=device_ms(kernel, expect=expect),
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
            split = device_ms_by_kernel(kernel, expect=expect)
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
    return rows


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
    """Test-only switch: route the MiT blocks and the UAWarpC head's local
    correlations through the kernels' plain versions (enabled) or back
    through the kernel wrappers."""
    from refign_tpu_torch.models import mix_transformer as mt
    from refign_tpu_torch.models.heads import uawarpc
    from refign_tpu_torch.ops import attention, correlation, dwconv
    mt.sra_attention = (attention.sra_attention_reference if enabled
                        else attention.sra_attention)
    mt.dwconv3x3_gelu = (dwconv.dwconv3x3_gelu_reference if enabled
                         else dwconv.dwconv3x3_gelu)
    uawarpc.local_correlation_relu_l2norm = (
        correlation.local_correlation_relu_l2norm_reference if enabled
        else correlation.local_correlation_relu_l2norm)


def phase_main_path(card):
    import torch
    from refign_tpu_torch.entry import build_hrda_star, hrda_slide_forward
    from refign_tpu_torch.ops.attention import sra_attention
    from refign_tpu_torch.ops.dwconv import dwconv3x3_gelu

    counted = (sra_attention, dwconv3x3_gelu)

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
    out = hrda_slide_forward(model, img)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counted}
    log(f"  launches in one forward: {launches}")
    for name, n in launches.items():
        if n != LAUNCHES_PER_FORWARD:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{LAUNCHES_PER_FORWARD}")
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
    return launches, sec


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
    from refign_tpu_torch.uda.trainer import draw_step, forward_backward
    state = trainer.state
    if draws is None:
        draws = draw_step(trainer.cfg, batch, gen)
        draws.use_ref_as_target = False  # the Refign branch, with its align
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
        return logs, grads

    kernel = run()
    plain_versions(True)
    try:
        plain = run()
    finally:
        plain_versions(False)
    return kernel, plain


def compare_step(what, kernel, plain, loss_limit, grad_limit, total_limit,
                 median_limit):
    """Relative differences of the three losses and the relative L2 error
    of every parameter's gradient, kernels against plain versions: the
    largest, the median and all gradients together, each against its
    limit.  A gradient that is zero in exact arithmetic (a bias that only
    shifts a channel before a batch-statistics BN, which removes any such
    shift) holds rounding noise alone, so each parameter's error is taken
    relative to its gradient's norm or to a thousandth of the RMS
    parameter gradient norm, whichever is larger."""
    import torch
    (logs_k, g_k), (logs_p, g_p) = kernel, plain
    loss_rel = {}
    for key in ("train_loss_src", "train_loss_featdist_src",
                "train_loss_uda_trg"):
        a, b = float(logs_k[key]), float(logs_p[key])
        if not (torch.isfinite(logs_k[key]) and torch.isfinite(logs_p[key])):
            raise AssertionError(f"{what}: {key} not finite ({a}, {b})")
        loss_rel[key] = abs(a - b) / max(abs(b), 1e-12)
    norms = {n: g.norm().item() for n, g in g_p.items()}
    floor = 1e-3 * (sum(v * v for v in norms.values()) / len(norms)) ** 0.5
    rel = {n: (g_k[n] - g_p[n]).norm().item() / max(norms[n], floor)
           for n in g_p}
    at_floor = sum(norms[n] < floor for n in norms)
    total = (sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p).sqrt()
             / sum((g_p[n] ** 2).sum() for n in g_p).sqrt()).item()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    median = statistics.median(rel.values())
    log(f"  {what}: losses kernels vs plain rel "
        + ", ".join(f"{k[len('train_loss_'):]} {v:.2e}"
                    for k, v in loss_rel.items())
        + f" (limit {loss_limit:g}); gradient rel L2 over all "
        f"{len(rel)} parameters {total:.2e}, median parameter "
        f"{median:.2e} (limit {median_limit:g}), largest per parameter "
        + ", ".join(f"{n} {v:.2e}" for n, v in worst)
        + f" (limit {grad_limit:g}; {at_floor} gradients below the floor "
        f"{floor:.2e}; all: limit {total_limit:g}); loss "
        f"{float(logs_k['train_loss_total']):.4f}")
    if not (max(loss_rel.values()) <= loss_limit
            and max(rel.values()) <= grad_limit and total <= total_limit
            and median <= median_limit):
        raise AssertionError(f"{what}: kernels disagree with plain versions")
    return max(loss_rel.values()), max(rel.values()), total


def phase_train(card):
    import dataclasses
    import torch
    from refign_tpu_torch.entry import (REFIGN_HRDA_STAR, build_uda_trainer,
                                        uda_train_step)
    from refign_tpu_torch.ops.attention import (sra_attention,
                                                sra_attention_backward)
    from refign_tpu_torch.ops.correlation import local_correlation as k3
    from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                             dwconv3x3_gelu_backward)
    from refign_tpu_torch.uda.trainer import draw_step, train_step

    counted = {"sra_attention": sra_attention,
               "sra_attention_backward": sra_attention_backward,
               "dwconv3x3_gelu": dwconv3x3_gelu,
               "dwconv3x3_gelu_backward": dwconv3x3_gelu_backward,
               "local_correlation": k3}

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
    logs = train_step(trainer, batch, draws)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counted.items()}
    log(f"  launches in one train step: {launches}")
    for name, n in launches.items():
        if n != TRAIN_LAUNCHES[name]:
            raise AssertionError(f"{name} launched {n} times in a train "
                                 f"step, expected {TRAIN_LAUNCHES[name]}")

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
    return launches, sec, peak


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
                       median_limit, grad_limit):
    """The three losses' relative differences and the relative L2 error of
    the head gradients, kernels against plain versions: all together, the
    median parameter and the largest one, each against its limit."""
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
    return max(loss_rel.values()), total


def phase_align_train(card):
    import dataclasses
    import torch
    from refign_tpu_torch.alignment.trainer import draw_align, train_step
    from refign_tpu_torch.entry import (UAWARPC_STAGE1, align_train_step,
                                        build_align_trainer)
    from refign_tpu_torch.ops.correlation import (local_correlation,
                                                  local_correlation_backward)
    counted = {"local_correlation": local_correlation,
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
            if n != ALIGN_TRAIN_LAUNCHES[name]:
                raise AssertionError(f"{name} launched {n} times in a {what} "
                                     f"step, expected "
                                     f"{ALIGN_TRAIN_LAUNCHES[name]}")
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
    del trainer

    stage2 = build_align_trainer(2, device="cuda", seed=2)
    _, logs = counted_step(stage2, "stage-2")
    logs = {k: float(v) for k, v in logs.items()}
    if not all(v == v and abs(v) != float("inf") for v in logs.values()):
        raise AssertionError(f"stage-2 losses not finite: {logs}")
    log("  stage-2 step losses: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in logs.items()))
    del stage2
    return launches, sec, peak


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

    def __call__(self, trainer, batch, draws):
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
        out = self.real(trainer, batch, draws)
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


def phase_runtime(card, bare_step_sec, bare_align_sec):
    """The runtime through ``refign_tpu_torch.cli.main`` on synthetic trees
    at the datasets' sizes and seeded reference-named weight files."""
    import dataclasses
    import shutil
    import tempfile
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
    root = tempfile.mkdtemp(prefix="refign_runtime_")
    try:
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
        trainer, batch, draws = probe.last
        for refign in sorted({not draws.use_ref_as_target, True}):
            d = dataclasses.replace(draws, use_ref_as_target=not refign)
            compare_step(
                f"cli fit's last step, "
                f"{'Refign' if refign else 'ref as target'} branch",
                *grads_kernels_vs_plain(trainer, batch, draws=d),
                TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL,
                TRAIN_BF16_TOTAL_REL, TRAIN_BF16_MEDIAN_REL)
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sec = time.perf_counter() - t_phase
    log(f"  runtime phase took {sec:.1f} s")
    return fit_launches, sec


KERNEL_GROUPS = [  # (group, substrings of device kernel names), first match
    ("K1 sra_attention", ("sra_attention_kernel",)),
    ("K1 backward", ("attn_bwd_",)),
    ("K2 dwconv3x3_gelu", ("dwconv3x3_gelu_kernel",)),
    ("K2 backward", ("dwconv_bwd_",)),
    ("K3 backward", ("::graw_kernel<", "::grad_kernel<",
                     "::raw_grad_kernel<", "::input_grad_kernel<")),
    ("K3 local_correlation", ("local_correlation",)),
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
    host-clock time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    report_profile(prof, sec, what, top_n)


def report_profile(prof, sec, what, top_n=12):
    """Log a profile's device time by kernel group and its ``top_n``
    kernels; ``sec`` is the host-clock time it covers."""
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
        return
    log(f"  profiled {what}: device busy {total / 1e3:.1f} ms of the "
        f"{sec * 1e3:.1f} ms warm {what} "
        f"({100 * total / 1e3 / (sec * 1e3):.1f} %), "
        f"{sum(n for _, n, _ in top)} device events")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:22s} {us / 1e3:8.2f} ms  {100 * us / total:5.1f} %")
    for us, n, key in sorted(top, reverse=True)[:top_n]:
        log(f"    top: {us / 1e3:8.2f} ms  x{n:<5d} {key[:100]}")


def main() -> int:
    import torch
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
    logs = _build.build_all()
    log(f"[2/7] built {len(logs)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(text):
            log(f"  {name}: {line}")

    log("[3/7] kernels against plain versions (bf16 limit "
        f"{BF16_REL:g}*|ref| + {BF16_ABS:g}, fp32 limit {FP32_ABS:g}; "
        f"backward: {GRAD_REL:g}*max|ref|, + {BF16_REL:g}*|ref| in bf16)")
    rows = phase_kernels()
    rows += phase_backward_kernels()
    phase_lab_yardsticks()

    log("[4/7] HRDA* path")
    launches, sec = phase_main_path(card)
    log("[5/7] align path")
    launches["local_correlation"], align_sec = phase_align(card)
    log("[6/7] UDA train step")
    train_launches, train_sec, peak = phase_train(card)
    for name in ("sra_attention_backward", "dwconv3x3_gelu_backward"):
        launches[name] = train_launches[name]
    log("[6b/7] UAWarpC train step, stage 1")
    align_launches, align_train_sec, align_peak = phase_align_train(card)
    launches["local_correlation_backward"] = align_launches[
        "local_correlation_backward"]
    train_launches["local_correlation_backward"] = 0
    log("[6c/7] Refign-DeepLabV2: inference and UDA train step")
    dl_launches, dl_sec, dl_peak = phase_deeplabv2(card)
    log("[6d/7] runtime: the CLI's fit, validate, predict and test on "
        "synthetic trees at the datasets' sizes")
    rt_launches, rt_sec = phase_runtime(card, train_sec, align_train_sec)

    log(f"[7/7] done in {time.perf_counter() - t_start:.1f} s")
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
                   "refign_tpu/ops/correlation.py:135")}
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
            launches_align_train_step=ALIGN_TRAIN_LAUNCHES.get(name, 0),
            launches_deeplabv2_step=dl_launches[name],
            launches_cli_fit=rt_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["name"] == name),
            ms=ms, plain_ms=per_call("plain_ms"), bound_ms=bound,
            bound_by=("operations" if 2 * len(bound_ops) > len(main_rows)
                      else "bytes"),
            library_ms=per_call("library_ms"), bound_share=bound / ms))
    log("kernel times are per call of each kernel's path: K1 and K2 summed "
        "over their 52 launches in one 1080x1920 HRDA* forward "
        f"({1.0 / sec:.3f} images/s), K3 over its 3 launches in one B=4 "
        f"1024^2 align and refine ({align_sec * 1e3:.1f} ms), K1 and K2 "
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
            "dwconv3x3_gelu_backward": "cuDNN conv + gelu backward"}
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
