"""The port's align-and-refine path (refign_tpu_torch/uda/{refine,trainer}.py,
alignment/trainer.py, utils/sparse_epe.py, entry.py) against the JAX
package.

* ``refine``/``eta``/the fdist family at atol 1e-5 (fp32);
* ``SparseEPE`` against the JAX package's class;
* ``align_forward`` against ``refign_tpu.alignment.trainer.align_forward``,
  and ``align_fn`` + ``refine`` against the same composition of JAX
  functions as the UDA step (``refign_tpu/uda/trainer.py:191-246``), with
  the JAX alignment trees loaded through ``load_alignment_params``, at B=1
  and 64x96 images, fp32 at rtol/atol 1e-4;
* the entry points, which run on CUDA unless given ``device="cpu"``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.alignment.trainer import align_forward as jax_align_forward
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxHead
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu.ops.resize import interpolate as jax_interpolate
from refign_tpu.ops.warp import confidence_from_logvar as jax_confidence
from refign_tpu.ops.warp import warp as jax_warp
from refign_tpu.uda import refine as jr
from refign_tpu.utils.sparse_epe import SparseEPE as JaxSparseEPE
from refign_tpu_torch import entry
from refign_tpu_torch.alignment.trainer import AlignmentNet, align_forward
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.uda import refine as tr
from refign_tpu_torch.uda.trainer import align_fn
from refign_tpu_torch.utils.jax_convert import load_alignment_params
from refign_tpu_torch.utils.sparse_epe import SparseEPE

TOL = dict(rtol=0, atol=1e-5)
ALIGN_TOL = dict(rtol=1e-4, atol=1e-4)
B, H, W = 1, 64, 96


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _logits(seed, b=2, h=12, w=16):
    # large enough spread that argmax and the static-class mask vary
    return _rand(seed, b, h, w, 19, scale=3.0)


def test_eta_matches_jax():
    x = _logits(0)
    np.testing.assert_allclose(tr.eta(torch.from_numpy(x)).numpy(),
                               np.asarray(jr.eta(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("with_mask,with_cert,disable_M,disable_P", [
    (True, True, False, False), (False, False, False, False),
    (True, True, True, False), (True, True, False, True),
])
def test_refine_matches_jax(with_mask, with_cert, disable_M, disable_P):
    lt, lr = _logits(1), _logits(2)
    rng = np.random.RandomState(3)
    mask = rng.rand(2, 12, 16) > 0.2 if with_mask else None
    cert = rng.rand(2, 12, 16, 1).astype(np.float32) if with_cert else None
    want = jr.refine(jnp.asarray(lt), jnp.asarray(lr),
                     None if mask is None else jnp.asarray(mask),
                     None if cert is None else jnp.asarray(cert),
                     0.25, disable_M, disable_P)
    got = tr.refine(torch.from_numpy(lt), torch.from_numpy(lr),
                    None if mask is None else torch.from_numpy(mask),
                    None if cert is None else torch.from_numpy(cert),
                    0.25, disable_M, disable_P)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refine_rejects_other_class_counts():
    with pytest.raises(ValueError):
        tr.refine(torch.zeros(1, 2, 2, 7), torch.zeros(1, 2, 2, 7), None,
                  None)


def _labels(seed, b=2, h=16, w=24):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 19, (b, h // 4, w // 4)).repeat(4, 1).repeat(4, 2)
    noise = rng.rand(b, h, w) < 0.15
    gt = np.where(noise, rng.randint(0, 19, (b, h, w)), gt)
    gt[:, :2] = 255
    return gt.astype(np.int32)


@pytest.mark.parametrize("scale", [2, 4])
def test_downscale_label_ratio_matches_jax(scale):
    gt = _labels(4)
    want = jr.downscale_label_ratio(jnp.asarray(gt), scale, 0.75, 19)
    got = tr.downscale_label_ratio(torch.from_numpy(gt), scale, 0.75, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fdist_matches_jax():
    gt = _labels(5)
    f1, f2 = _rand(6, 2, 4, 6, 32), _rand(7, 2, 4, 6, 32)
    mask = np.random.RandomState(8).rand(2, 4, 6) > 0.5
    for m in (None, mask):
        want = jr.masked_feat_dist(jnp.asarray(f1), jnp.asarray(f2),
                                   None if m is None else jnp.asarray(m))
        got = tr.masked_feat_dist(torch.from_numpy(f1), torch.from_numpy(f2),
                                  None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), **TOL)
    classes = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)
    want = jr.fdist_loss(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(gt),
                         classes)
    got = tr.fdist_loss(torch.from_numpy(f1), torch.from_numpy(f2),
                        torch.from_numpy(gt), classes)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("uncertainty", [True, False])
def test_sparse_epe_matches_jax(uncertainty):
    rng = np.random.RandomState(9)
    h, w = 30, 40
    flow = (4 * rng.randn(3, h, w, 2)).astype(np.float32)
    unc = rng.rand(3, h, w, 1).astype(np.float32)
    pts_t = [rng.uniform(-2, [w + 1, h + 1], (n, 2)) for n in (50, 0, 80)]
    pts_s = [p + rng.randn(*p.shape) * 3 for p in pts_t]
    metrics = []
    for cls in (JaxSparseEPE, SparseEPE):
        m = cls(uncertainty_estimation=uncertainty)
        m.update(flow, pts_s, pts_t, (h, w), unc if uncertainty else None)
        metrics.append(m.compute())
    assert metrics[0].keys() == metrics[1].keys()
    for k in metrics[0]:
        np.testing.assert_allclose(metrics[1][k], metrics[0][k], rtol=1e-12)


def _perturb_stats(stats, seed):
    rng = np.random.RandomState(seed)

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        return np.abs(a) + 0.5 if name == "var" else a

    return go(stats)


@functools.lru_cache(maxsize=None)
def _align_models():
    """JAX VGG-16 + UAWarpC and their trees in the UDA step's layout, and
    the port's AlignmentNet filled from them."""
    backbone = JaxVGG(model_type="vgg16", out_indices=(2, 3, 4))
    head = JaxHead(in_index=(0, 1), estimate_uncertainty=True)
    key = jax.random.PRNGKey(0)
    bb_vars = jax.jit(backbone.init)(key, jnp.zeros((1, 256, 256, 3)))
    feats = backbone.apply(bb_vars, jnp.zeros((1, H, W, 3)),
                           extract_only_indices=[-3, -2])
    feats256 = backbone.apply(bb_vars, jnp.zeros((1, 256, 256, 3)),
                              extract_only_indices=[-2, -1])
    head_vars = jax.jit(lambda k: head.init(k, feats, feats, feats256,
                                            feats256, (H, W)))(key)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": bb_vars["params"], "head": head_vars["params"],
        "head_stats": head_vars["batch_stats"]})
    tree["head_stats"] = _perturb_stats(tree["head_stats"], 1)
    net = AlignmentNet(VGG("vgg16", out_indices=(2, 3, 4)),
                       UAWarpCHead(in_index=(0, 1),
                                   estimate_uncertainty=True))
    load_alignment_params(net.eval(), tree)
    return backbone, head, tree, net


def _images(seed):
    return _rand(seed, B, H, W, 3), _rand(seed + 1, B, H, W, 3)


def _smooth_logits(seed):
    """Teacher-like logits: a coarse random field upsampled, so that the
    warp does not turn the flows' 1e-4 agreement into large jumps between
    independent neighbouring pixels."""
    coarse = torch.from_numpy(_rand(seed, B, 19, H // 8, W // 8, scale=3.0))
    return torch.nn.functional.interpolate(
        coarse, (H, W), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1).contiguous().numpy()


def test_align_forward_matches_jax():
    backbone, head, tree, net = _align_models()
    img_i, img_j = _images(10)
    want_flow, want_unc = jax.jit(functools.partial(
        jax_align_forward, backbone, head))(
        tree["backbone"],
        {"params": tree["head"], "batch_stats": tree["head_stats"]},
        img_i, img_j)
    with torch.no_grad():
        flow, unc = align_forward(net, torch.from_numpy(img_i),
                                  torch.from_numpy(img_j))
    assert flow.shape == (B, H, W, 2) and unc.shape == (B, H, W, 1)
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow),
                               **ALIGN_TOL)
    np.testing.assert_allclose(unc.numpy(), np.asarray(want_unc),
                               **ALIGN_TOL)


def _jax_align_fn(backbone, head, tree, logits_ref, images_ref, images_trg):
    """``align_fn`` of refign_tpu/uda/trainer.py:191-222 in fp32."""
    b, h, w, _ = images_trg.shape
    trg256 = jax_interpolate(images_trg, (256, 256), mode="area")
    ref256 = jax_interpolate(images_ref, (256, 256), mode="area")
    bb_vars = {"params": tree["backbone"]}
    full = backbone.apply(bb_vars, jnp.concatenate([images_ref, images_trg]),
                          extract_only_indices=[-3, -2])
    small = backbone.apply(bb_vars, jnp.concatenate([ref256, trg256]),
                           extract_only_indices=[-2, -1])
    flow, logvar = head.apply(
        {"params": tree["head"], "batch_stats": tree["head_stats"]},
        [f[b:] for f in full], [f[:b] for f in full],
        [f[b:] for f in small], [f[:b] for f in small], (h, w))[-1]
    flow = jax_interpolate(flow, (h, w), mode="bilinear", align_corners=False)
    logvar = jax_interpolate(logvar, (h, w), mode="bilinear",
                             align_corners=False)
    cert = jax_confidence(logvar, R=1.0)
    warped, mask = jax_warp(logits_ref, flow, return_mask=True)
    return warped, mask, cert


def test_align_fn_and_refine_match_jax():
    backbone, head, tree, net = _align_models()
    img_ref, img_trg = _images(20)
    lt, lr = _smooth_logits(22), _smooth_logits(23)
    w_warped, w_mask, w_cert = jax.jit(functools.partial(
        _jax_align_fn, backbone, head))(tree, lr, img_ref, img_trg)
    w_probs = jr.refine(jnp.asarray(lt), w_warped, w_mask, w_cert, 0.25)
    with torch.no_grad():
        warped, mask, cert = align_fn(net, torch.from_numpy(lr),
                                      torch.from_numpy(img_ref),
                                      torch.from_numpy(img_trg))
    np.testing.assert_allclose(warped.numpy(), np.asarray(w_warped),
                               **ALIGN_TOL)
    np.testing.assert_allclose(cert.numpy(), np.asarray(w_cert), **ALIGN_TOL)
    # the strict in-bounds mask may flip only where a coordinate sits on
    # the border within the flow's 1e-4 agreement
    assert (mask.numpy() != np.asarray(w_mask)).mean() < 1e-3
    probs, mask_e, cert_e = entry.refign_align_refine(
        net, torch.from_numpy(lt), torch.from_numpy(lr),
        torch.from_numpy(img_trg), torch.from_numpy(img_ref))
    assert torch.equal(mask_e, mask) and torch.equal(cert_e, cert)
    assert probs.shape == (B, H, W, 19) and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(w_probs),
                               **ALIGN_TOL)


def test_align_fn_order_matters():
    """Swapping reference and target still gives a plausible flow but not
    the same warp: the comparison above is sensitive to the order."""
    _, _, _, net = _align_models()
    img_ref, img_trg = map(torch.from_numpy, _images(30))
    lr = torch.from_numpy(_rand(32, B, H, W, 19))
    with torch.no_grad():
        right = align_fn(net, lr, img_ref, img_trg)[0]
        swapped = align_fn(net, lr, img_trg, img_ref)[0]
    assert (right - swapped).abs().max() > 1e-2


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.build_alignment(dtype=torch.float32)
    net = entry.build_alignment(dtype=torch.bfloat16, device="cpu", seed=0)
    assert not net.training
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers())
    # seeded: the same seed gives the same weights, another seed others
    again = entry.build_alignment(dtype=torch.bfloat16, device="cpu", seed=0)
    other = entry.build_alignment(dtype=torch.bfloat16, device="cpu", seed=1)
    key = "head.decoder1.conv_0.conv.weight"
    assert torch.equal(net.state_dict()[key], again.state_dict()[key])
    assert not torch.equal(net.state_dict()[key], other.state_dict()[key])


def test_entry_align_drive_on_cpu():
    """The bf16 network on the CPU: align_forward and refign_align_refine
    give finite results of the documented shapes and dtypes."""
    net = entry.build_alignment(dtype=torch.bfloat16, device="cpu", seed=0)
    img_i, img_j = map(torch.from_numpy, _images(40))
    flow, unc = entry.align_forward(net, img_i, img_j)
    assert flow.dtype == unc.dtype == torch.float32
    assert flow.shape == (B, H, W, 2) and unc.shape == (B, H, W, 1)
    assert torch.isfinite(flow).all() and ((unc >= 0) & (unc <= 1)).all()
    lt = torch.from_numpy(_rand(42, B, H, W, 19)).bfloat16()
    lr = torch.from_numpy(_rand(43, B, H, W, 19)).bfloat16()
    probs, mask, cert = entry.refign_align_refine(net, lt, lr, img_i, img_j)
    assert probs.shape == (B, H, W, 19) and probs.dtype == torch.float32
    assert mask.shape == (B, H, W) and mask.dtype == torch.bool
    assert ((probs >= 0) & (probs <= 1)).all()
    # refine mixes the static classes with weight s and the others with
    # s*P, so a pixel's sum leaves 1 by at most 1 - P where it is warped
    bound = torch.where(mask, 1.0 - cert[..., 0], 0.0) + 1e-5
    assert ((probs.sum(-1) - 1).abs() <= bound).all()
