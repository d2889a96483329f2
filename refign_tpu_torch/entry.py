"""Entry points of the HRDA★ inference path (counterpart of
``__graft_entry__.entry()`` and the pipeline of ``bench.py``).

``build_hrda_star`` builds Refign-HRDA★ (MiT backbone, DAFormer head,
SegFormer scale attention) in eval mode with seeded random weights;
``hrda_slide_forward`` runs the 1080x1920 slide pipeline: an outer slide of
1080^2 crops at stride 420, each crop through ``Segmentor.whole`` (HRDA
eval, upsampled to the crop), folded back onto the image.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .models.heads.daformer import DAFormerHead
from .models.heads.segformer import SegFormerHead
from .models.mix_transformer import MixVisionTransformer
from .models.segmentor import Segmentor, slide_inference
from .parallel.mesh import cast_floating


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
