"""UAWarpC alignment: the frozen network's forward, and its training step
(counterpart of ``refign_tpu/alignment/trainer.py``).

Forward.  Both callers, ``align_forward`` here and the UDA align step,
batch the backbone the same way: one call on ``cat([source, target])`` at
the image size with ``extract_only_indices=[-3, -2]``, one on the 256^2
area-resized pair with ``[-2, -1]``; the head then matches the target
(first argument) against the source.

Training (the JAX ``make_align_train_step``, the reference's
``AlignmentModel.training_step``).  One step, in the JAX step's order:

* prefix, without grad: uint8 batches normalised on the device; the prime
  view (:func:`prepare_alignment_batch`: a per-image coin picks the base
  image, ref or target, then the photometric augmentations and a random
  synthetic flow, on the full grid, with only the centre-crop window
  warped); the crop of ref and target (750^2 -> 520^2 at the stage
  geometry); the frozen VGG pyramids of ref, target and prime, one pass at
  the image size and one at 256^2;
* core: three head passes on the pyramids of i (the image the prime came
  from) and j (the other): prime -> i, prime -> j, j -> i, each continuing
  the BatchNorm running statistics of the one before; the warp-supervision
  loss of the first, the W-bipath loss of the other two, the adaptive
  weights (detached, with the reference's bug-compatible ratio 0) and ONE
  backward of w_ss * ss + w_us * us on bf16 copies of the fp32 master
  parameters; then Adam (L2 decay) at the MultiStepLR rate.

Every random draw of a step is made on the host first (:func:`draw_align`:
the coins, the photometric factors, each image's transform and its
parameters, the elastic blobs), except the two (H, W) noise fields of each
elastic flow, which a device generator seeded from the draws makes; a test
pins any of them by building :class:`AlignDraws` by hand or by passing the
noise.  Under a process group (``parallel/mesh.py``) every rank draws
the global batch's draws, noise fields included, and keeps its rows
(:meth:`AlignDraws.rows`); the head passes run in a ``sharded_pass``
(sync-BN), the masked means count every rank's mask, the adaptive weights
come from the global losses and the gradients are averaged.
``remat_modules`` (the stage default) recomputes each decoder,
refinement and uncertainty module in the backward, its BN statistics
updated once.  The JAX step's memory options (``refign_tpu/alignment/
trainer.py:297-360``): ``remat_head`` recomputes each whole head pass
(``remat_head_policy`` 'dots': all but its convolutions' and products'
outputs), but the last with ``remat_skip_last``; ``fold_passes`` runs the
three passes as one head pass over their inputs concatenated in pass order
[prime -> i, prime -> j, j -> i], its BatchNorms in 3 groups
(``nn.layers.grouped_bn``: each group normalised on its own statistics,
the running ones updated in group order, as the three serial passes do),
and slices the output by group (``remat_head`` does not apply to it, as in
JAX).  Under a process group each rank folds its own rows, so group g of
every rank is pass g.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.layers import grouped_bn, remat_call
from ..ops.resize import interpolate
from ..ops.warp import confidence_from_logvar
from ..parallel import mesh
from ..parallel.mesh import apply_cast, cast_floating, cast_params
from ..train.optim import MultiStepLR
from ..uda.dacs import (JitterFactors, color_jitter_bcsh, denorm,
                        draw_jitter_bcsh, gaussian_blur_image, renorm)
from ..utils.profiling import span
from .losses import adaptive_loss_weights, multi_scale_flow_loss, wbipath_loss
from .synthetic_flows import (FlowDraws, batched_composite_flow, draw_flow,
                              draw_elastic_noise)

__all__ = ["AlignmentNet", "flow_and_logvar", "align_forward",
           "AlignConfig", "PrimeDraws", "AlignDraws",
           "AlignTrainState", "AlignTrainer", "init_align_state",
           "draw_align", "device_normalize", "crop_window",
           "prime_photometric", "prepare_alignment_batch",
           "extract_pyramids", "forward_backward", "train_step"]


class AlignmentNet(nn.Module):
    """The alignment network: a VGG pyramid ``backbone`` and a UAWarpC
    ``head`` with uncertainty estimation."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def dtype(self) -> torch.dtype:
        return next(self.head.parameters()).dtype


def flow_and_logvar(net: AlignmentNet, images_trg: torch.Tensor,
                    images_src: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finest-level flow target -> source and its log-variance, upsampled
    to the image size, both fp32.  Images (B, H, W, 3) are cast to the
    network's dtype first."""
    B, H, W = images_trg.shape[:3]
    images_trg = images_trg.to(net.dtype)
    images_src = images_src.to(net.dtype)

    def to256(x):
        return interpolate(x, (256, 256), mode="area")

    full = net.backbone(torch.cat([images_src, images_trg]),
                        extract_only_indices=[-3, -2])
    small = net.backbone(torch.cat([to256(images_src), to256(images_trg)]),
                         extract_only_indices=[-2, -1])
    pyr_src = [f[:B] for f in full]
    pyr_trg = [f[B:] for f in full]
    pyr_src_256 = [f[:B] for f in small]
    pyr_trg_256 = [f[B:] for f in small]
    flow, logvar = net.head(pyr_trg, pyr_src, pyr_trg_256, pyr_src_256,
                            (H, W))[-1]
    flow = interpolate(flow, (H, W), mode="bilinear", align_corners=False)
    logvar = interpolate(logvar, (H, W), mode="bilinear",
                         align_corners=False)
    return flow, logvar


def align_forward(net: AlignmentNet, images_i: torch.Tensor,
                  images_j: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AlignmentModel.forward: flow i -> j at the image size (B, H, W, 2)
    and the uncertainty 1 - P_R (B, H, W, 1), R = 1."""
    flow, logvar = flow_and_logvar(net, images_i, images_j)
    return flow, 1.0 - confidence_from_logvar(logvar, R=1.0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Static settings of the step (the JAX ``AlignConfig`` with its
    defaults; the JAX ``device_normalize`` switch has no counterpart: uint8
    batches are always normalised on the device, float ones pass).
    ``entry.ALIGN_STAGES`` holds the two stages' settings."""
    loss_type: str = "HuberLoss"
    # passed in the adaptive weighting's weight_ss slot, as the reference
    # does (alignment_model.py:141-143): False (both stages) gives ratio
    # 0, so the weights are (0, 1) where loss_us > loss_ss and (1, 100)
    # otherwise
    apply_constant_flow_weights: bool = False
    level_weights: Optional[Tuple[float, ...]] = None
    # the W-bipath loss's cyclic-consistency visibility mask and its
    # thresholds
    visibility_mask: bool = False
    alpha_1: float = 0.03
    alpha_2: float = 0.5
    include_transforms: Tuple[str, ...] = ("hom", "tps", "afftps")
    random_alpha: float = 0.26
    random_s: float = 0.45
    random_tx: float = 0.25
    random_ty: float = 0.25
    random_t_hom: float = 0.333
    random_t_tps: float = 0.333
    random_t_tps_for_afftps: float = 0.08
    add_elastic: bool = False
    # the prime view's photometric augmentations: jitter (b, c, s, h),
    # channel shuffle, blur (p, kernel_size, sigma_lo, sigma_hi), in the
    # space the normalisation below maps back to [0, 1]
    prime_jitter: Optional[Tuple[float, float, float, float]] = None
    prime_channel_shuffle: bool = False
    prime_blur: Optional[Tuple[float, int, float, float]] = None
    # centre crop of everything after the flow is synthesised
    crop_after_flow: Optional[Tuple[int, int]] = None
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    compute_dtype: str = "bfloat16"
    remat_head: bool = False
    remat_head_policy: Optional[str] = None
    remat_skip_last: bool = False
    fold_passes: bool = False
    remat_modules: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass
class PrimeDraws:
    """One prime image's photometric draws: jitter factors, channel
    permutation and blur sigma, each None where that augmentation is off
    (the blur also where its coin fell against it)."""
    jitter: Optional[JitterFactors] = None
    perm: Optional[Tuple[int, int, int]] = None
    blur_sigma: Optional[float] = None


@dataclasses.dataclass
class AlignDraws:
    """Every random number of one step, drawn on the host: per image the
    coin (1: the prime derives from the target), the photometric draws and
    the flow's; and the seed of the device generator of the elastic noise
    fields.  ``noise_rows`` (first, count of the batch the noise fields
    are drawn for): the rows of a global batch these draws belong to, or
    None for all."""
    prime_trg_idx: Tuple[int, ...]
    photometric: List[PrimeDraws]
    flows: List[FlowDraws]
    noise_seed: int = 0
    noise_rows: Optional[Tuple[int, int]] = None

    def rows(self, sl: slice) -> "AlignDraws":
        """The draws of the images ``sl`` of the batch."""
        return dataclasses.replace(
            self, prime_trg_idx=self.prime_trg_idx[sl],
            photometric=self.photometric[sl], flows=self.flows[sl],
            noise_rows=(sl.start, len(self.flows)))


def _photometric_on(cfg: AlignConfig) -> bool:
    return (cfg.prime_jitter is not None or cfg.prime_channel_shuffle
            or cfg.prime_blur is not None)


def draw_align(cfg: AlignConfig, B: int, H: int, W: int,
               generator: torch.Generator) -> AlignDraws:
    """All host draws of one step for B pairs of H x W images (the size
    before any crop), from a CPU generator."""
    coins = tuple(int(v) for v in torch.rand(B, generator=generator) < 0.5)
    photometric = []
    for _ in range(B):
        d = PrimeDraws()
        if cfg.prime_jitter is not None:
            d.jitter = draw_jitter_bcsh(generator, *cfg.prime_jitter)
        if cfg.prime_channel_shuffle:
            d.perm = tuple(int(i) for i in torch.randperm(
                3, generator=generator))
        if cfg.prime_blur is not None:
            p, _, lo, hi = cfg.prime_blur
            apply = float(torch.rand((), generator=generator)) < p
            sigma = lo + (hi - lo) * float(torch.rand((), generator=generator))
            d.blur_sigma = sigma if apply else None
        photometric.append(d)
    flows = [draw_flow(generator, H, W, cfg.include_transforms,
                       cfg.random_alpha, cfg.random_s, cfg.random_tx,
                       cfg.random_ty, cfg.random_t_tps, cfg.random_t_hom,
                       cfg.random_t_tps_for_afftps, cfg.add_elastic)
             for _ in range(B)]
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return AlignDraws(coins, photometric, flows, seed)


def device_normalize(x: torch.Tensor, cfg: AlignConfig) -> torch.Tensor:
    """(x / 255 - mean) / std of a uint8 batch on its device (the
    normalisation of ``cfg``); float batches (normalised already) pass
    through."""
    if x.dtype != torch.uint8:
        return x
    return renorm(x.float() / 255.0, cfg.norm_mean, cfg.norm_std)


def crop_window(cfg: AlignConfig, H: int, W: int
                ) -> Optional[Tuple[int, int, int, int]]:
    """(top, left, th, tw) of the centre crop after the flow, or None."""
    if cfg.crop_after_flow is None:
        return None
    th, tw = cfg.crop_after_flow
    return (int(round((H - th) / 2.0)), int(round((W - tw) / 2.0)), th, tw)


def prime_photometric(draws: Sequence[PrimeDraws], base: torch.Tensor,
                      cfg: AlignConfig) -> torch.Tensor:
    """Jitter, channel shuffle and blur of each normalised base image in
    its denormalised [0, 1] space (the transform order of the stage
    YAMLs)."""
    out = []
    for d, img in zip(draws, denorm(base, cfg.norm_mean, cfg.norm_std)):
        if d.jitter is not None:
            img = color_jitter_bcsh(img, d.jitter, *cfg.prime_jitter)
        if d.perm is not None:
            img = img[..., list(d.perm)]
        if d.blur_sigma is not None:
            img = gaussian_blur_image(img, d.blur_sigma,
                                      kernel_size=int(cfg.prime_blur[1]))
        out.append(img)
    return renorm(torch.stack(out), cfg.norm_mean, cfg.norm_std)


def prepare_alignment_batch(draws: AlignDraws, images_ref: torch.Tensor,
                            images_trg: torch.Tensor, cfg: AlignConfig,
                            out_slice=None,
                            noise: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """The prime view: the coin's base image, its photometric
    augmentations, then the synthetic flow warp.  ``out_slice`` (top, left,
    th, tw): the prime image, flow and mask come back cut to that window,
    warped only there.  ``noise`` (B, 2, H, W) pins the elastic noise
    fields, else they are drawn on the device from ``draws.noise_seed``."""
    B, H, W = images_ref.shape[:3]
    idx = torch.tensor(draws.prime_trg_idx, dtype=torch.int32,
                       device=images_ref.device)
    base = torch.where(idx.bool()[:, None, None, None], images_trg,
                       images_ref)
    if _photometric_on(cfg):
        base = prime_photometric(draws.photometric, base, cfg)
    if noise is None and any(f.elastic is not None for f in draws.flows):
        gen = torch.Generator(device=base.device).manual_seed(
            draws.noise_seed)
        first, total = draws.noise_rows or (0, B)
        noise = draw_elastic_noise(gen, total, H, W)[first:first + B]
    image_prime, flow_prime, mask_prime = batched_composite_flow(
        draws.flows, base, out_slice=out_slice, noise=noise)
    return {"image_prime": image_prime, "flow_prime": flow_prime,
            "mask_prime": mask_prime, "prime_trg_idx": idx}


def extract_pyramids(backbone: nn.Module, images_ref: torch.Tensor,
                     images_trg: torch.Tensor, images_prime: torch.Tensor):
    """Frozen VGG pyramids of the three image sets, one batched pass at
    the image size and one at 256^2: ((ref, trg, prime), (ref_256,
    trg_256, prime_256)), each a list of levels."""
    B = images_ref.shape[0]

    def to256(x):
        return interpolate(x, (256, 256), mode="area")

    full = backbone(torch.cat([images_ref, images_trg, images_prime]),
                    extract_only_indices=[-3, -2])
    small = backbone(torch.cat([to256(images_ref), to256(images_trg),
                                to256(images_prime)]),
                     extract_only_indices=[-2, -1])

    def split(fs):
        return ([f[:B] for f in fs], [f[B:2 * B] for f in fs],
                [f[2 * B:] for f in fs])

    return split(full), split(small)


def _select(idx: torch.Tensor, a_list, b_list):
    """Per image: b where idx, else a."""
    out = []
    for a, b in zip(a_list, b_list):
        m = idx.reshape((-1,) + (1,) * (a.dim() - 1)).bool()
        out.append(torch.where(m, b, a))
    return out


@dataclasses.dataclass
class AlignTrainState:
    """The frozen backbone (eval, parameters in the compute dtype), the
    head (fp32 masters, train mode), Adam and its schedule, and the update
    count."""
    backbone: nn.Module
    head: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: MultiStepLR
    step: int = 0


@dataclasses.dataclass
class AlignTrainer:
    cfg: AlignConfig
    state: AlignTrainState


def init_align_state(backbone: nn.Module, head: nn.Module,
                     optimizer: torch.optim.Optimizer,
                     scheduler: MultiStepLR,
                     dtype: torch.dtype = torch.float32) -> AlignTrainState:
    """Freeze the backbone in ``dtype`` (its parameters cast in place)
    and put the head in train mode."""
    cast_floating(backbone, dtype).eval().requires_grad_(False)
    head.train()
    return AlignTrainState(backbone, head, optimizer, scheduler)


def forward_backward(trainer: AlignTrainer, batch: Dict[str, torch.Tensor],
                     draws: AlignDraws,
                     noise: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """A step without its update: the prime view, the pyramids, the three
    head passes, the losses and one backward, which leaves the gradient in
    the head's ``.grad`` (averaged over the ranks under a process group).
    batch: ``image_ref``, ``image_trg`` (B, H, W, 3) normalised, or uint8
    (normalised here).  Returns the logs as 0-d fp32 tensors on the
    device.  ``batch``, ``draws`` and ``noise`` (pinned elastic noise
    fields, see :func:`prepare_alignment_batch`) are the global batch's;
    under a process group the step keeps this rank's rows of them."""
    sl = mesh.shard_of(batch["image_trg"].shape[0])
    if sl is not None:
        draws = draws.rows(sl)
    local = mesh.shard_batch({**batch, "noise": noise})
    with mesh.sharded_pass(sl):
        return _forward_backward(trainer, local, draws, local.pop("noise"))


def _forward_backward(trainer: AlignTrainer, batch: Dict[str, torch.Tensor],
                      draws: AlignDraws, noise: Optional[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    cfg, state = trainer.cfg, trainer.state
    cdt = cfg.dtype
    with span("align.prime"):
        images_ref = device_normalize(batch["image_ref"], cfg)
        images_trg = device_normalize(batch["image_trg"], cfg)
        out_slice = crop_window(cfg, *images_trg.shape[1:3])
        with torch.no_grad():
            prime = prepare_alignment_batch(draws, images_ref, images_trg,
                                            cfg, out_slice=out_slice,
                                            noise=noise)
        if out_slice is not None:
            top, left, th, tw = out_slice
            images_ref = images_ref[:, top:top + th, left:left + tw]
            images_trg = images_trg[:, top:top + th, left:left + tw]
    H, W = images_trg.shape[1:3]
    with span("align.pyramids"):
        with torch.no_grad():
            pyrs, pyrs256 = extract_pyramids(
                state.backbone, images_ref.to(cdt), images_trg.to(cdt),
                prime["image_prime"].to(cdt))
        pyr_ref, pyr_trg, pyr_prime = pyrs
        pyr_ref_256, pyr_trg_256, pyr_prime_256 = pyrs256
        idx = prime["prime_trg_idx"]
        # i: the image the prime was derived from; j: the other
        pyr_i = _select(idx, pyr_ref, pyr_trg)
        pyr_j = _select(1 - idx, pyr_ref, pyr_trg)
        pyr_i_256 = _select(idx, pyr_ref_256, pyr_trg_256)
        pyr_j_256 = _select(1 - idx, pyr_ref_256, pyr_trg_256)

    head = state.head
    with span("align.cast_params"):
        params = None if cdt == torch.float32 else cast_params(head, cdt)

    def head_pass(trg, src, trg256, src256, remat=False):
        # the head maps its first pyramid (target) onto its second
        args = (trg, src, trg256, src256, (H, W))
        if remat:
            return remat_call(head, *args, policy=cfg.remat_head_policy,
                              params=params)
        return apply_cast(head, cdt, *args, params=params)

    with span("align.head"):
        if cfg.fold_passes:
            B = idx.shape[0]

            def cat3(*levels):
                return [torch.cat(ts) for ts in zip(*levels)]

            with grouped_bn(head, 3):
                out3 = head_pass(cat3(pyr_prime, pyr_prime, pyr_j),
                                 cat3(pyr_i, pyr_j, pyr_i),
                                 cat3(pyr_prime_256, pyr_prime_256,
                                      pyr_j_256),
                                 cat3(pyr_i_256, pyr_j_256, pyr_i_256))

            def group(g):
                sl = slice(g * B, (g + 1) * B)
                return [tuple(t[sl] for t in lv) if isinstance(lv, tuple)
                        else lv[sl] for lv in out3]

            prime_i, prime_j, j_i = group(0), group(1), group(2)
        else:
            remat = cfg.remat_head
            prime_i = head_pass(pyr_prime, pyr_i, pyr_prime_256, pyr_i_256,
                                remat)
            prime_j = head_pass(pyr_prime, pyr_j, pyr_prime_256, pyr_j_256,
                                remat)
            j_i = head_pass(pyr_j, pyr_i, pyr_j_256, pyr_i_256,
                            remat and not cfg.remat_skip_last)

    with span("align.losses"):
        ss = multi_scale_flow_loss(prime_i, prime["flow_prime"],
                                   prime["mask_prime"],
                                   loss_type=cfg.loss_type,
                                   level_weights=cfg.level_weights)
        us = wbipath_loss(prime_j, j_i, prime["flow_prime"],
                          prime["mask_prime"], loss_type=cfg.loss_type,
                          level_weights=cfg.level_weights,
                          visibility_mask=cfg.visibility_mask,
                          alpha_1=cfg.alpha_1, alpha_2=cfg.alpha_2)
        # the weights from the global losses: the same on every rank
        ss_all, us_all = mesh.mean_over_ranks(
            torch.stack([ss.detach(), us.detach()])).unbind()
        w_ss, w_us = adaptive_loss_weights(
            ss_all, us_all, weight_ss=float(cfg.apply_constant_flow_weights))
        loss = w_ss * ss + w_us * us
    with span("align.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh.reduce_gradients(head.parameters())
    return {"train_matching_loss": mesh.mean_over_ranks(loss.detach()),
            "loss_ss": ss_all, "loss_us": us_all}


def train_step(trainer: AlignTrainer, batch: Dict[str, torch.Tensor],
               draws: AlignDraws, noise: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """One UAWarpC step in place on ``trainer.state``:
    :func:`forward_backward`, then Adam at the schedule's rate for the
    update count (the same update on every rank).  Its phases are spans
    (``utils/profiling.py``): ``align.step`` over ``align.prime``,
    ``align.pyramids``, ``align.cast_params``, ``align.head``,
    ``align.losses``, ``align.backward`` and ``align.optimizer``."""
    with span("align.step"):
        logs = forward_backward(trainer, batch, draws, noise)
        state = trainer.state
        with span("align.optimizer"):
            state.scheduler.set_step(state.step)
            state.optimizer.step()
        state.step += 1
    return logs
