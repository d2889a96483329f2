"""Entry points of the port.

HRDA★ inference (counterpart of ``__graft_entry__.entry()`` and the
pipeline of ``bench.py``): ``build_hrda_star`` builds Refign-HRDA★ (MiT
backbone, DAFormer head, SegFormer scale attention) in eval mode with
seeded random weights; ``hrda_slide_forward`` runs the 1080x1920 slide
pipeline: an outer slide of 1080^2 crops at stride 420, each crop through
``Segmentor.whole`` (HRDA eval, upsampled to the crop), folded back onto
the image.

Alignment: ``build_alignment`` builds the frozen alignment network (VGG-16
pyramid, UAWarpC head with uncertainty) of
``configs/cityscapes_acdc/refign_hrda_star.yaml``; ``align_forward`` is
UAWarpC's evaluation forward and ``refign_align_refine`` Refign's align
and refine of the teacher's pseudo-labels inside a UDA step.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .alignment.trainer import AlignmentNet, align_forward as _align_forward
from .models.heads.daformer import DAFormerHead
from .models.heads.segformer import SegFormerHead
from .models.heads.uawarpc import UAWarpCHead
from .models.mix_transformer import MixVisionTransformer
from .models.segmentor import Segmentor, slide_inference
from .models.vgg import VGG
from .parallel.mesh import cast_floating
from .uda.refine import refine
from .uda.trainer import align_fn


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "refign_tpu_torch entry points run on CUDA by default and no "
            "CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def build_hrda_star(model_type: str = "mit_b5", num_classes: int = 19,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0, channels: int = 256) -> Segmentor:
    """Eval-mode Refign-HRDA★ on ``device`` with weights drawn from
    ``seed`` (parameters in ``dtype``, BatchNorm statistics fp32).
    ``channels`` sets both heads' widths (256 in the published model)."""
    dev = _resolve_device(device)
    backbone = MixVisionTransformer(model_type=model_type,
                                    drop_path_rate=0.0)
    dims = backbone.embed_dims
    head = DAFormerHead(num_classes, in_channels=dims, channels=channels,
                        embed_dims=channels)
    scale_attention = SegFormerHead(num_classes, in_channels=dims,
                                    channels=channels)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    scale_attention.init_weights(gen)
    model = Segmentor(backbone, head, scale_attention)
    cast_floating(model, dtype)
    return model.to(dev).eval().requires_grad_(False)


def hrda_slide_forward(model: Segmentor, img: torch.Tensor,
                       crop_size: Tuple[int, int] = (1080, 1080),
                       stride: Tuple[int, int] = (420, 420)) -> torch.Tensor:
    """(B, H, W, 3) image -> (B, H, W, num_classes) logits through the
    slide + HRDA pipeline of ``bench.py``."""
    with torch.inference_mode():
        return slide_inference(model.whole, img, crop_size, stride)


def build_alignment(model_type: str = "vgg16",
                    iterative_refinement: bool = False,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0) -> AlignmentNet:
    """Eval-mode alignment network on ``device`` with weights drawn from
    ``seed`` (parameters in ``dtype``, BatchNorm statistics fp32): VGG-16
    (the only ``model_type`` ported) with ``out_indices`` (2, 3, 4),
    UAWarpC with ``in_index`` (0, 1) and uncertainty estimation."""
    dev = _resolve_device(device)
    backbone = VGG(model_type, out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True,
                       iterative_refinement=iterative_refinement)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    net = AlignmentNet(backbone, head)
    cast_floating(net, dtype)
    return net.to(dev).eval().requires_grad_(False)


def align_forward(net: AlignmentNet, images_i: torch.Tensor,
                  images_j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) images i and j -> flow i -> j (B, H, W, 2) and the
    uncertainty 1 - P_R (B, H, W, 1), both fp32."""
    with torch.inference_mode():
        return _align_forward(net, images_i, images_j)


def refign_align_refine(net: AlignmentNet, logits_trg: torch.Tensor,
                        logits_ref: torch.Tensor, images_trg: torch.Tensor,
                        images_ref: torch.Tensor, gamma: float = 0.25
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refign's align and refine: warp the teacher's logits of the
    reference image onto the adverse target and mix them into its
    pseudo-label.  Logits (B, H, W, 19), images (B, H, W, 3).  Returns the
    refined probabilities (B, H, W, 19) fp32, the warp mask (B, H, W) and
    the confidence (B, H, W, 1) fp32."""
    with torch.inference_mode():
        warped, mask, cert = align_fn(net, logits_ref, images_ref,
                                      images_trg)
        probs = refine(logits_trg, warped, mask, cert, gamma)
    return probs, mask, cert
