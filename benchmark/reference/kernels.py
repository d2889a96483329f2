"""The plain composites of the port's hand-written kernels, frozen: what
K1, K2 and K3 compute, in fp32, in the reference's NCHW / token layouts.
Autograd takes their backward."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """K1: softmax(q k^T * scale) v over (B, heads, tokens, 64)."""
    a = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    return torch.matmul(a.softmax(dim=-1), v.float())


def dwconv3x3_gelu(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K2: depthwise 3x3 (zero padding 1) + bias + exact GELU, NCHW."""
    y = F.conv2d(x.float(), w.float(), b.float(), padding=1,
                 groups=x.shape[1])
    return F.gelu(y)


def local_correlation(t: torch.Tensor, s: torch.Tensor,
                      patch: int) -> torch.Tensor:
    """K3: (B, P*P, H, W) dot products of t with s shifted by each
    displacement of the P x P window (zero outside), dy slowest."""
    r = patch // 2
    H, W = t.shape[-2:]
    sp = F.pad(s.float(), (r, r, r, r))
    return torch.stack([(t.float() * sp[:, :, dy:dy + H, dx:dx + W]).sum(1)
                        for dy in range(patch) for dx in range(patch)], 1)


def global_correlation(source: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """(B, Hs*Ws, Ht, Wt): each target position against every source
    position, the source's row-major index as the channel."""
    B, C, Ht, Wt = target.shape
    corr = torch.einsum("bcs,bct->bst", source.float().flatten(2),
                        target.float().flatten(2))
    return corr.reshape(B, -1, Ht, Wt)
