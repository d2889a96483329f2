"""The port's HRDA★ segmentor (refign_tpu_torch/models/segmentor.py with
the MiT backbone, DAFormer head and SegFormer scale attention) against the
JAX package's, with the JAX weights and BN statistics carried over.

mit_b1 (mit_b5's widths at depth 2) with heads at channels=64 on a
non-square 128x192 image: ``hrda_eval`` and ``slide_inference`` in fp32 at
rtol/atol 1e-4, and the JAX package's own ``convert_state_dict`` maps the
port's ``state_dict`` onto the flax tree with no mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.heads.daformer import DAFormerHead as JaxDAFormer
from refign_tpu.models.heads.segformer import SegFormerHead as JaxSegFormer
from refign_tpu.models.mix_transformer import \
    MixVisionTransformer as JaxMiT
from refign_tpu.models.segmentor import Segmentor as JaxSegmentor
from refign_tpu.models.segmentor import \
    compute_slide_boxes as jax_compute_slide_boxes
from refign_tpu.models.segmentor import \
    slide_inference as jax_slide_inference
from refign_tpu.ops.resize import interpolate as jax_interpolate
from refign_tpu.utils.torch_convert import (check_tree_match,
                                            convert_state_dict)
from refign_tpu_torch.entry import build_hrda_star, hrda_slide_forward
from refign_tpu_torch.models.heads.daformer import DAFormerHead
from refign_tpu_torch.models.heads.segformer import SegFormerHead
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.models.segmentor import (Segmentor,
                                               compute_slide_boxes,
                                               fold_crops, slide_inference)
from refign_tpu_torch.utils.jax_convert import load_jax_variables

CH = 64
H, W = 128, 192
CROP, STRIDE = (128, 128), (64, 64)


def _perturb(tree, seed, scale=0.02):
    rng = np.random.RandomState(seed)

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        a = a + scale * rng.randn(*a.shape).astype(np.float32)
        return np.abs(a) + 0.5 if name == "var" else a

    return go(tree)


def _jax_seg():
    return JaxSegmentor(
        backbone=JaxMiT(model_type="mit_b1", drop_path_rate=0.0),
        head=JaxDAFormer(num_classes=19, channels=CH, embed_dims=CH),
        scale_attention=JaxSegFormer(num_classes=19, channels=CH))


def _port_seg():
    backbone = MixVisionTransformer("mit_b1", drop_path_rate=0.0)
    dims = backbone.embed_dims
    return Segmentor(
        backbone,
        DAFormerHead(19, in_channels=dims, channels=CH, embed_dims=CH),
        SegFormerHead(19, in_channels=dims, channels=CH)).eval()


@pytest.fixture(scope="module")
def models():
    seg = _jax_seg()
    variables = jax.jit(
        lambda k, x: seg.init(k, x, method=JaxSegmentor.hrda_eval))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = _perturb(jax.tree_util.tree_map(np.asarray,
                                                dict(variables)), 1)
    port = load_jax_variables(_port_seg(), variables)
    img = np.random.RandomState(2).randn(1, H, W, 3).astype(np.float32)
    return seg, variables, port, img


@pytest.mark.parametrize("img_size,crop,stride", [
    ((1080, 1920), (1080, 1080), (420, 420)),
    ((1080, 1080), (540, 540), (270, 270)),
    ((128, 192), CROP, STRIDE),
])
def test_slide_boxes_match_jax(img_size, crop, stride):
    assert (compute_slide_boxes(img_size, crop, stride)
            == jax_compute_slide_boxes(img_size, crop, stride))


def test_fold_crops_identity():
    img = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 96, 3)
                           .astype(np.float32))
    out = slide_inference(lambda c: c, img, (32, 32), (16, 16))
    torch.testing.assert_close(out, img, rtol=0, atol=1e-6)
    boxes = compute_slide_boxes((64, 96), (32, 32), (16, 16))
    crops = torch.cat([img[:, a:b, c:d] for (a, b, c, d) in boxes])
    torch.testing.assert_close(fold_crops(crops, boxes, (64, 96), 2), img,
                               rtol=0, atol=1e-6)


def test_fold_counts_built_once_per_grid():
    """The visit counts of a box grid are built once and kept; counts first
    built under inference mode still divide a tensor that requires grad."""
    from refign_tpu_torch.models import segmentor
    boxes = compute_slide_boxes((40, 72), (24, 24), (16, 16))
    crops = torch.randn(len(boxes) * 2, 24, 24, 3,
                        generator=torch.Generator().manual_seed(5))
    segmentor._visit_counts.cache_clear()
    with torch.inference_mode():
        first = fold_crops(crops, boxes, (40, 72), 2)
    leaf = crops.clone().requires_grad_()
    second = fold_crops(leaf, boxes, (40, 72), 2)
    assert segmentor._visit_counts.cache_info()[:2] == (1, 1)  # hits, misses
    assert torch.equal(first, second.detach())
    second.sum().backward()
    assert torch.isfinite(leaf.grad).all() and (leaf.grad > 0).all()


def test_hrda_eval_matches_jax(models):
    seg, variables, port, img = models
    want = np.asarray(jax.jit(lambda v, x: seg.apply(
        v, x, method=JaxSegmentor.hrda_eval))(variables, img))
    with torch.no_grad():
        got = port.hrda_eval(torch.from_numpy(img)).numpy()
    assert got.shape == (1, H // 4, W // 4, 19)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_slide_inference_matches_jax(models):
    seg, variables, port, img = models

    def whole(v, crops):
        logits = seg.apply(v, crops, method=JaxSegmentor.hrda_eval)
        return jax_interpolate(logits, crops.shape[1:3], mode="bilinear",
                               align_corners=False)

    want = np.asarray(jax.jit(lambda v, x: jax_slide_inference(
        lambda c: whole(v, c), x, CROP, STRIDE))(variables, img))
    got = hrda_slide_forward(port, torch.from_numpy(img), CROP,
                             STRIDE).numpy()
    assert got.shape == (1, H, W, 19)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_state_dict_converts_to_jax_tree(models, collection):
    _, variables, port, _ = models
    conv = convert_state_dict(port.state_dict())
    assert check_tree_match(conv[collection], variables[collection]) == []


def test_build_hrda_star_bf16_params_fp32_stats():
    model = build_hrda_star("mit_b0", dtype=torch.bfloat16, device="cpu",
                            seed=0, channels=32)
    assert not model.training
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    img = torch.from_numpy(np.random.RandomState(4).randn(1, 64, 96, 3)
                           .astype(np.float32)).to(torch.bfloat16)
    out = hrda_slide_forward(model, img, (64, 64), (32, 32))
    assert out.shape == (1, 64, 96, 19) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    again = build_hrda_star("mit_b0", dtype=torch.bfloat16, device="cpu",
                            seed=0, channels=32)
    torch.testing.assert_close(
        hrda_slide_forward(again, img, (64, 64), (32, 32)), out,
        rtol=0, atol=0)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_hrda_star("mit_b0", channels=32)
