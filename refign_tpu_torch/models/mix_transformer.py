"""MiT (Mix Vision Transformer, SegFormer encoder) on NHWC tensors.

Counterpart of ``refign_tpu/models/mix_transformer.py`` (forward path): a
4-stage hierarchical ViT with overlapping patch embeddings (7/4, then 3/2),
spatial-reduction attention (sr_ratios 8/4/2/1) through kernel K1
(``ops/attention.py``), and a Mix-FFN whose depthwise 3x3 conv + GELU is
kernel K2 (``ops/dwconv.py``).  In train mode the blocks' stochastic depth
draws from the generator passed to ``forward``, and ``remat=True`` recomputes
each block in the backward (``torch.utils.checkpoint``, non-reentrant; the
JAX ``nn.remat`` of ``refign_tpu/models/mix_transformer.py:198-259``), all
of it, or with ``remat_policy='dots'`` all but the outputs of its matrix
products and convolutions (``nn.layers.remat_call``; JAX's
``dots_with_no_batch_dims_saveable``): K1 and K2 run again in the
recompute either way.  The drop-path draws are made before a block is
checkpointed and handed to it, so the recompute applies the same ones.

Parameter names follow the reference's torch keys, so the JAX package's
``convert_state_dict`` maps this module's ``state_dict`` onto its flax tree:
``patch_embed{k}.proj``, ``block{k}.{i}.{norm1,attn,norm2,mlp}``,
``norm{k}``; ``mlp.fc1``/``mlp.fc2`` are Linear weights (the JAX package
holds them as 1x1 conv kernels).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..nn.layers import (REMAT_POLICIES, DropPath, Linear, TorchConv,
                         TorchLayerNorm, conv2d, kaiming_normal_fanout_,
                         normal_, remat_call)
from ..ops.attention import sra_attention
from ..ops.dwconv import dwconv3x3_gelu

ARCH_SETTINGS = {
    # embed_dims, num_heads, mlp_ratios, depths, sr_ratios
    "mit_b0": dict(embed_dims=[32, 64, 160, 256], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[2, 2, 2, 2],
                   sr_ratios=[8, 4, 2, 1]),
    "mit_b1": dict(embed_dims=[64, 128, 320, 512], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[2, 2, 2, 2],
                   sr_ratios=[8, 4, 2, 1]),
    "mit_b2": dict(embed_dims=[64, 128, 320, 512], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[3, 4, 6, 3],
                   sr_ratios=[8, 4, 2, 1]),
    "mit_b3": dict(embed_dims=[64, 128, 320, 512], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[3, 4, 18, 3],
                   sr_ratios=[8, 4, 2, 1]),
    "mit_b4": dict(embed_dims=[64, 128, 320, 512], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[3, 8, 27, 3],
                   sr_ratios=[8, 4, 2, 1]),
    "mit_b5": dict(embed_dims=[64, 128, 320, 512], num_heads=[1, 2, 5, 8],
                   mlp_ratios=[4, 4, 4, 4], depths=[3, 6, 40, 3],
                   sr_ratios=[8, 4, 2, 1]),
}


class SRAttention(nn.Module):
    """Spatial-reduction attention on NHWC maps: KV tokens are reduced by a
    kernel=stride=sr_ratio conv and LayerNorm (eps 1e-5) when
    sr_ratio > 1."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.q = Linear(dim, dim, bias=qkv_bias)
        if sr_ratio > 1:
            self.sr = conv2d(dim, dim, kernel_size=sr_ratio, stride=sr_ratio)
            self.norm = TorchLayerNorm(dim, eps=1e-5)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        q = self.q(x).reshape(B, H * W, nh, C // nh)
        if self.sr_ratio > 1:
            kv_in = self.norm(self.sr(x)).reshape(B, -1, C)
        else:
            kv_in = x.reshape(B, H * W, C)
        kv = self.kv(kv_in).reshape(B, -1, 2, nh, C // nh)
        # strided views: the kernel reads k and v in place
        out = sra_attention(q, kv[:, :, 0], kv[:, :, 1], self.scale)
        return self.proj(out.reshape(B, H, W, C))


class DWConvGELU(nn.Module):
    """Depthwise 3x3 conv + bias + exact GELU (kernel K2); ``weight`` is the
    OIHW (C, 1, 3, 3) depthwise kernel."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, 3, 3))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dwconv3x3_gelu(x.contiguous(), self.weight, self.bias)


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 conv -> GELU -> fc2."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.dwconv = DWConvGELU(hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dwconv(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, drop_path: float = 0.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.norm1 = TorchLayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, qk_scale)
        self.drop_path = DropPath(drop_path)
        self.norm2 = TorchLayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, keep1: Optional[torch.Tensor] = None,
                keep2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block with the drop-path keep draws of its two branches
        (None: identity)."""
        x = x + self.drop_path.apply_mask(self.attn(self.norm1(x)), keep1)
        return x + self.drop_path.apply_mask(self.mlp(self.norm2(x)), keep2)

    def masks(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        return (self.drop_path.mask(x, generator),
                self.drop_path.mask(x, generator))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patch embedding + LayerNorm (eps 1e-5)."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = conv2d(in_chans, embed_dim, kernel_size=patch_size,
                           stride=stride, padding=patch_size // 2)
        self.norm = TorchLayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class MixVisionTransformer(nn.Module):
    """4-stage MiT backbone; returns 4 NHWC feature maps at 1/4, 1/8, 1/16
    and 1/32 resolution.  ``remat`` recomputes each block in the backward
    where grad is enabled, under ``remat_policy`` (None: the whole block;
    'dots': keeping its products' and convolutions' outputs)."""

    def __init__(self, model_type: str = "mit_b5",
                 drop_path_rate: float = 0.1,
                 qk_scale: Optional[float] = None, in_chans: int = 3,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        cfg = ARCH_SETTINGS[model_type]
        self.model_type = model_type
        self.remat = remat
        self.remat_policy = remat_policy
        self.embed_dims = list(cfg["embed_dims"])
        depths = cfg["depths"]
        dpr = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        patch_cfg = [(7, 4), (3, 2), (3, 2), (3, 2)]
        cur = 0
        prev = in_chans
        for s in range(4):
            dim = cfg["embed_dims"][s]
            setattr(self, f"patch_embed{s + 1}",
                    OverlapPatchEmbed(*patch_cfg[s], prev, dim))
            setattr(self, f"block{s + 1}", nn.ModuleList([
                Block(dim, cfg["num_heads"][s], cfg["mlp_ratios"][s],
                      cfg["sr_ratios"][s], dpr[cur + i], qk_scale=qk_scale)
                for i in range(depths[s])]))
            setattr(self, f"norm{s + 1}", TorchLayerNorm(dim, eps=1e-6))
            cur += depths[s]
            prev = dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                keeps = blk.masks(x, generator)
                x = (remat_call(blk, x, *keeps, policy=self.remat_policy)
                     if remat else blk(x, *keeps))
            x = getattr(self, f"norm{s}")(x)
            outs.append(x)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference init rules (``refign_tpu/models/mix_transformer.py:
        34-38``): Linear N(0, .02) with zero bias; conv N(0, sqrt(2/fan_out))
        with fan_out divided by groups (the depthwise conv) and zero bias;
        LayerNorm ones/zeros."""
        for m in self.modules():
            if isinstance(m, Linear):
                normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, TorchConv):
                kaiming_normal_fanout_(m.weight, generator, m.groups)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, DWConvGELU):
                kaiming_normal_fanout_(m.weight, generator, m.weight.shape[0])
                nn.init.zeros_(m.bias)
            elif isinstance(m, TorchLayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
