"""Pretrained-weight bootstrap: keyword / path resolution (counterpart of
``refign_tpu/utils/pretrained.py``, with its keyword tables copied).

The reference's resolution chain (models/backbones/mix_transformer.py:
19-28,445-462, resnet.py:15-19,341-350, vgg.py:12-21,91-100,
models/segmentation_model.py:421-436):

1. ``'imagenet'`` / ``'cityscapes'`` keywords resolve through a per-family
   URL/path table;
2. the resolved source is tried as a local path, then under
   ``$TORCH_HOME/hub/<source>``;
3. URLs are looked up in the torch-hub download cache
   (``$TORCH_HOME/hub/checkpoints/<basename>``) and, on a miss,
   downloaded there (``torch.hub.download_url_to_file``); a failed
   download raises and names the file to place and where.

An unresolvable source is always a hard error, never a silent random
initialisation.
"""
from __future__ import annotations

import os
from typing import Optional

# keyword tables (reference mix_transformer.py:19-28; the SegFormer release
# ships MiT weights as local files, so the reference maps keywords to
# ./pretrained_models paths rather than URLs)
MIT_URLS = {
    "imagenet": {
        "mit_b0": "./pretrained_models/mit_b0.pth",
        "mit_b1": "./pretrained_models/mit_b1.pth",
        "mit_b2": "./pretrained_models/mit_b2.pth",
        "mit_b3": "./pretrained_models/mit_b3.pth",
        "mit_b4": "./pretrained_models/mit_b4.pth",
        "mit_b5": "./pretrained_models/mit_b5.pth",
    },
    "cityscapes": {
        "mit_b5":
            "./pretrained_models/segformer.b5.1024x1024.city.160k.pth",
    },
}

# reference resnet.py:15-19 (imagenet only)
RESNET_URLS = {
    "resnet18_v1c": "https://download.openmmlab.com/pretrain/third_party/"
                    "resnet18_v1c-b5776b93.pth",
    "resnet50_v1c": "https://download.openmmlab.com/pretrain/third_party/"
                    "resnet50_v1c-2cccc1ad.pth",
    "resnet101_v1c": "https://download.openmmlab.com/pretrain/third_party/"
                     "resnet101_v1c-e67eebb6.pth",
}

# reference vgg.py:12-21 (torchvision, imagenet only)
VGG_URLS = {
    "vgg11": "https://download.pytorch.org/models/vgg11-8a719046.pth",
    "vgg13": "https://download.pytorch.org/models/vgg13-19584684.pth",
    "vgg16": "https://download.pytorch.org/models/vgg16-397923af.pth",
    "vgg19": "https://download.pytorch.org/models/vgg19-dcbb9e9d.pth",
    "vgg11_bn": "https://download.pytorch.org/models/vgg11_bn-6002323d.pth",
    "vgg13_bn": "https://download.pytorch.org/models/vgg13_bn-abd245e5.pth",
    "vgg16_bn": "https://download.pytorch.org/models/vgg16_bn-6c64b313.pth",
    "vgg19_bn": "https://download.pytorch.org/models/vgg19_bn-c79401a0.pth",
}

KEYWORDS = ("imagenet", "cityscapes")


def keyword_to_source(keyword: str, family: str, model_type: str) -> str:
    """'imagenet'/'cityscapes' -> URL or release-relative path."""
    if family == "mix_transformer":
        table = MIT_URLS.get(keyword, {})
        if model_type not in table:
            raise KeyError(
                f"no '{keyword}' weights known for MiT '{model_type}' "
                f"(reference model_urls covers: {sorted(table)})")
        return table[model_type]
    if family == "resnet":
        if keyword != "imagenet" or model_type not in RESNET_URLS:
            raise KeyError(
                f"no '{keyword}' weights known for ResNet '{model_type}'")
        return RESNET_URLS[model_type]
    if family == "vgg":
        if keyword != "imagenet" or model_type not in VGG_URLS:
            raise KeyError(
                f"no '{keyword}' weights known for VGG '{model_type}'")
        return VGG_URLS[model_type]
    raise KeyError(f"unknown backbone family '{family}'")


def _hub_dir() -> str:
    # torch.hub's default cache: $TORCH_HOME/hub, falling back to
    # ~/.cache/torch/hub ($XDG_CACHE_HOME aware) — matching the reference's
    # load_state_dict_from_url cache so checkpoints are shared, not
    # re-downloaded per working directory
    torch_home = os.environ.get("TORCH_HOME")
    if not torch_home:
        cache = os.environ.get(
            "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"),
                                           ".cache"))
        torch_home = os.path.join(cache, "torch")
    return os.path.join(torch_home, "hub")


def resolve_pretrained(spec: str, family: Optional[str] = None,
                       model_type: Optional[str] = None) -> str:
    """Resolve a pretrained spec to a local checkpoint file path.

    Raises FileNotFoundError/RuntimeError with an actionable message when
    the source cannot be resolved (never silently skips).
    """
    source = spec
    if spec in KEYWORDS:
        if family is None or model_type is None:
            raise KeyError(
                f"pretrained keyword '{spec}' needs a backbone family/"
                f"model_type to resolve")
        source = keyword_to_source(spec, family, model_type)

    if os.path.exists(source):
        return source
    hub_path = os.path.normpath(os.path.join(_hub_dir(), source))
    if os.path.exists(hub_path):
        return hub_path

    if source.startswith(("http://", "https://")):
        cache = os.path.join(_hub_dir(), "checkpoints",
                             os.path.basename(source))
        if os.path.exists(cache):
            return cache
        try:
            import torch.hub
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            torch.hub.download_url_to_file(source, cache, progress=False)
            return cache
        except Exception as e:
            raise RuntimeError(
                f"pretrained '{spec}' resolves to {source} but the download "
                f"failed ({type(e).__name__}: {e}).  Place the file at "
                f"{cache} manually (TORCH_HOME="
                f"{os.environ.get('TORCH_HOME', '')!r}).") from e

    raise FileNotFoundError(
        f"pretrained '{spec}' (resolved source: {source!r}) not found "
        f"locally nor under {_hub_dir()!r}.  Place the reference release "
        f"weights at one of those paths; refusing to start from random "
        f"initialization.")


def backbone_family(module) -> Optional[str]:
    name = type(module).__name__
    return {"MixVisionTransformer": "mix_transformer",
            "ResNet": "resnet",
            "VGG": "vgg"}.get(name)
