"""The port's UDA pieces (refign_tpu_torch/uda/{losses,dacs}.py,
train/optim.py, models/segmentor.py hrda_train, entry.py) against the JAX
package.

* the pixel-weighted CE at 1e-5 (fp32);
* DACS: the random draws cannot match between the two frameworks, so the
  port takes them as arguments and the tests recompute JAX's own draws
  from its key and hand them over: ClassMix masks from the same scores
  (exact), kornia-0.5.8 jitter from the same factors and order at 1e-5,
  the Gaussian blur at a given sigma at 1e-5, and the whole ``dacs_mix``
  with jitter and blur on (images at 1e-5, labels and weights exact);
* the schedule against ``warmup_poly_schedule`` (fp32, 1e-7 relative) and
  AdamW in the 4 groups against ``make_uda_optimizer``'s optax chain: the
  same gradients for 5 steps across warmup and decay, parameters at 1e-6;
* ``Segmentor.hrda_train`` at a pinned crop offset (BN on batch
  statistics): outputs and updated statistics at 1e-4, parameter
  gradients at 1e-4 of each parameter's largest;
* the entry points: CUDA by default, a CPU step with ``device="cpu"``.
"""
import dataclasses

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
from refign_tpu.train import optim as jo
from refign_tpu.uda import dacs as jd
from refign_tpu.uda.losses import \
    pixel_weighted_cross_entropy as jax_pixel_ce
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch import entry
from refign_tpu_torch.models.heads.daformer import DAFormerHead
from refign_tpu_torch.models.heads.segformer import SegFormerHead
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.models.segmentor import Segmentor
from refign_tpu_torch.train import optim as to
from refign_tpu_torch.uda import dacs as td
from refign_tpu_torch.uda.losses import pixel_weighted_cross_entropy
from refign_tpu_torch.utils.jax_convert import (flax_location,
                                                load_jax_variables,
                                                params_like)

TOL = dict(rtol=0, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _labels(seed, shape, ignore_share=0.1):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 19, size=shape)
    lab[rng.rand(*shape) < ignore_share] = 255
    return lab.astype(np.int64)


@pytest.mark.parametrize("weighted", [False, True])
def test_pixel_weighted_ce_matches_jax(weighted):
    logits = _rand(0, 2, 9, 11, 19, scale=3.0)
    target = _labels(1, (2, 9, 11), ignore_share=0.2)
    weight = np.random.RandomState(2).rand(2, 9, 11).astype(np.float32) \
        if weighted else None
    want = jax_pixel_ce(jnp.asarray(logits), jnp.asarray(target),
                        None if weight is None else jnp.asarray(weight))
    got = pixel_weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(target),
        None if weight is None else torch.from_numpy(weight))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_pixel_weighted_ce_counts_ignored_pixels():
    """Ignored pixels add 0 to the sum and 1 to the count."""
    logits = torch.zeros(1, 1, 4, 19)
    target = torch.tensor([[[0, 255, 255, 255]]])
    torch.testing.assert_close(
        pixel_weighted_cross_entropy(logits, target),
        torch.tensor(np.log(19.0) / 4, dtype=torch.float32))


def _jax_mask_scores(rng, B, num_classes=19):
    """The uniform scores ``get_class_masks`` draws from ``rng``."""
    keys = jax.random.split(rng, B)
    return np.stack([np.asarray(jax.random.uniform(k, (num_classes + 1,)))
                     for k in keys])


def _jax_jitter_factors(rng, s):
    """The factors and order ``color_jitter_image`` draws from ``rng``."""
    k_order, kb, kc, ks, kh = jax.random.split(rng, 5)
    u = jax.random.uniform
    return td.JitterFactors(
        float(u(kb, (), minval=max(0.0, 1 - s), maxval=min(2.0, 1 + s))),
        float(u(kc, (), minval=max(0.0, 1 - s), maxval=1 + s)),
        float(u(ks, (), minval=max(0.0, 1 - s), maxval=1 + s)),
        float(u(kh, (), minval=-s, maxval=s)),
        tuple(int(i) for i in jax.random.permutation(k_order, 4)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_masks_match_jax(seed):
    labels = _labels(10 + seed, (3, 12, 10))
    # a batch that lacks some classes, so the present set matters
    labels[labels == 5] = 255
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jd.get_class_masks(rng, jnp.asarray(labels)))
    got = td.get_class_masks(torch.from_numpy(_jax_mask_scores(rng, 3)),
                             torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_jitter_matches_jax(seed):
    img = np.random.RandomState(seed).rand(13, 17, 3).astype(np.float32)
    rng = jax.random.PRNGKey(100 + seed)
    want = np.asarray(jd.color_jitter_image(rng, jnp.asarray(img), 0.2))
    got = td.color_jitter_image(torch.from_numpy(img),
                                _jax_jitter_factors(rng, 0.2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("H,W,sigma,k", [(40, 52, 0.7, None),
                                         (33, 21, 1.1, None),
                                         (64, 64, 0.3, 5)])
def test_gaussian_blur_matches_jax(H, W, sigma, k):
    img = np.random.RandomState(H).rand(H, W, 3).astype(np.float32)
    want = np.asarray(jd.gaussian_blur_image(jnp.asarray(img),
                                             jnp.float32(sigma), k))
    got = td.gaussian_blur_image(torch.from_numpy(img), sigma, k)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _jax_dacs_draws(rng, B, s, blur):
    """Every draw ``dacs_mix`` makes from ``rng``, as port ``DACSDraws``."""
    k_coin_j, k_coin_b, k_masks, k_jit = jax.random.split(rng, 4)
    jitter, sigma = [], []
    for key in jax.random.split(k_jit, B):
        kj, ks2 = jax.random.split(key)
        jitter.append(_jax_jitter_factors(kj, s))
        sigma.append(float(jax.random.uniform(ks2, (), minval=0.15,
                                              maxval=1.15)))
    return td.DACSDraws(
        float(jax.random.uniform(k_coin_j, ())),
        float(jax.random.uniform(k_coin_b, ())) if blur else 0.0,
        torch.from_numpy(_jax_mask_scores(k_masks, B)), jitter, sigma)


@pytest.mark.parametrize("jitter_p,blur", [(0.0, True), (1.0, False)])
def test_dacs_mix_matches_jax(jitter_p, blur):
    B, H, W = 2, 40, 44
    # a key whose blur coin is heads, so the blur runs where it is on
    seed = next(s for s in range(100) if float(jax.random.uniform(
        jax.random.split(jax.random.PRNGKey(s), 4)[1], ())) > 0.5)
    rng = jax.random.PRNGKey(seed)
    img_t, img_s = _rand(1, B, H, W, 3), _rand(2, B, H, W, 3)
    probs = jax.nn.softmax(jnp.asarray(_rand(3, B, H, W, 19, scale=4.0)), -1)
    gt = _labels(4, (B, H, W))
    want = jd.dacs_mix(rng, jnp.asarray(img_t), probs, jnp.asarray(img_s),
                       jnp.asarray(gt), pseudo_label_threshold=0.6,
                       color_jitter_p=jitter_p, blur=blur,
                       psweight_ignore_top=3, psweight_ignore_bottom=2)
    draws = _jax_dacs_draws(rng, B, 0.2, blur)
    got = td.dacs_mix(draws, torch.from_numpy(img_t),
                      torch.from_numpy(np.asarray(probs)),
                      torch.from_numpy(img_s), torch.from_numpy(gt),
                      pseudo_label_threshold=0.6, color_jitter_p=jitter_p,
                      blur=blur, psweight_ignore_top=3,
                      psweight_ignore_bottom=2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if blur:  # the augmentation ran: the images are not the plain mix
        mask = td.get_class_masks(draws.class_scores,
                                  torch.from_numpy(gt))
        plain = td.one_mix(mask, torch.from_numpy(img_s),
                           torch.from_numpy(img_t))
        assert (got[0] - plain).abs().max() > 1e-2


def test_draws_are_seeded_and_in_range():
    a = td.draw_dacs(torch.Generator().manual_seed(7), 3)
    b = td.draw_dacs(torch.Generator().manual_seed(7), 3)
    assert a.jitter == b.jitter and a.sigma == b.sigma
    assert torch.equal(a.class_scores, b.class_scores)
    assert a.class_scores.shape == (3, 20)
    assert all(0.15 <= s <= 1.15 for s in a.sigma)
    for f in a.jitter:
        assert 0.8 <= f.brightness <= 1.2 and -0.2 <= f.hue <= 0.2
        assert sorted(f.order) == [0, 1, 2, 3]


@pytest.mark.parametrize("factor,min_lr", [(1.0, 0.0), (0.1, 1e-5)])
def test_schedule_matches_jax(factor, min_lr):
    sched = jo.warmup_poly_schedule(6e-4 * factor, 40, warmup_iters=7,
                                    power=1.0, min_lr=min_lr)
    for step in (0, 1, 6, 7, 8, 20, 39):
        np.testing.assert_allclose(
            to.warmup_poly_lr(step, 6e-4 * factor, 40, warmup_iters=7,
                              power=1.0, min_lr=min_lr),
            float(sched(step)), rtol=1e-7)


class _Tiny(torch.nn.Module):
    """Parameters of every rank, under a backbone and a head."""

    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.fc = torch.nn.Linear(4, 3)
        self.backbone.norm = torch.nn.LayerNorm(3)
        self.head = torch.nn.Conv2d(3, 2, 3)


def test_adamw_groups_match_optax():
    model = _Tiny()
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]

    def tree(values):
        out = {}
        for n, v in zip(names, values):
            node = out
            *path, leaf = n.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
        return out

    def leaves(t, n):
        for k in n.split("."):
            t = t[k]
        return t

    params = tree([jnp.asarray(p.detach().numpy())
                   for p in model.parameters()])
    kw = dict(backbone_lr_factor=0.1, warmup_iters=2, power=1.0,
              min_lr=1e-5)
    tx, _ = jo.make_uda_optimizer(params, 6e-4, 0.01, 10, **kw)
    opt_state = tx.init(params)
    opt, sched = to.make_uda_optimizer(model, 6e-4, 0.01, 10, **kw)
    assert sorted(g["label"] for g in opt.param_groups) == [
        "backbone_bias", "backbone_weight", "head_bias", "head_weight"]
    import optax
    for step in range(5):
        grads_np = [rng.randn(*p.shape).astype(np.float32)
                    for p in model.parameters()]
        updates, opt_state = tx.update(tree(map(jnp.asarray, grads_np)),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(model.parameters(), grads_np):
            p.grad = torch.from_numpy(g)
        sched.set_step(step)
        opt.step()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(leaves(params, n)),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {n}")


CH = 32


@pytest.fixture(scope="module")
def hrda_models():
    """The port's mit_b0 HRDA segmentor from its seeded init with every
    parameter and BN statistic moved off it, the same weights as JAX
    variables (``convert_state_dict``), and the JAX HRDA train loss and
    gradient, compiled once for every crop offset."""
    seg = JaxSegmentor(
        backbone=JaxMiT(model_type="mit_b0", drop_path_rate=0.0),
        head=JaxDAFormer(num_classes=19, channels=CH, embed_dims=CH),
        scale_attention=JaxSegFormer(num_classes=19, channels=CH))
    backbone = MixVisionTransformer("mit_b0", drop_path_rate=0.0)
    dims = backbone.embed_dims
    port = Segmentor(backbone,
                     DAFormerHead(19, in_channels=dims, channels=CH,
                                  embed_dims=CH),
                     SegFormerHead(19, in_channels=dims, channels=CH))
    gen = torch.Generator().manual_seed(1)
    for m in (port.backbone, port.head, port.scale_attention):
        m.init_weights(gen)
    with torch.no_grad():
        for name, t in port.state_dict().items():
            noise = 0.02 * torch.randn(t.shape, generator=gen)
            t.copy_((t + noise).abs() + 0.5 if name.endswith("running_var")
                    else t + noise)
    # copies: the numpy views of the state_dict would follow the port's
    # in-place BN updates
    variables = jax.tree_util.tree_map(
        np.array, convert_state_dict(port.state_dict()))

    def loss(params, x, offset, c_fused, c_hr):
        (fused, hr, _, feats), mut = seg.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, offset, train=True, deterministic=True,
            mutable=["batch_stats"], method=JaxSegmentor.hrda_train)
        return (jnp.sum(fused * c_fused) + jnp.sum(hr * c_hr),
                (fused, hr, feats, mut["batch_stats"]))

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return variables, port, grad_fn


@pytest.mark.parametrize("offset", [(0, 24), (16, 8), (32, 32)])
def test_hrda_train_matches_jax(hrda_models, offset):
    variables, port, grad_fn = hrda_models
    x = _rand(5, 2, 64, 64, 3)
    c_fused, c_hr = _rand(6, 2, 16, 16, 19), _rand(7, 2, 32, 32, 19)
    (_, (fused, hr, feats, stats)), grads = grad_fn(
        variables["params"], jnp.asarray(x), jnp.asarray(offset, jnp.int32),
        jnp.asarray(c_fused), jnp.asarray(c_hr))
    load_jax_variables(port, variables)
    port.train()
    # dropout off, as deterministic=True turns it off on the JAX side
    port.head.dropout.eval()
    port.scale_attention.dropout.eval()
    t_fused, t_hr, t_feats = port(torch.from_numpy(x), offset,
                                  method="hrda_train")
    ((t_fused * torch.from_numpy(c_fused)).sum()
     + (t_hr * torch.from_numpy(c_hr)).sum()).backward()
    np.testing.assert_allclose(t_fused.detach().numpy(), np.asarray(fused),
                               **MODEL_TOL)
    np.testing.assert_allclose(t_hr.detach().numpy(), np.asarray(hr),
                               **MODEL_TOL)
    for a, b in zip(t_feats, feats):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **MODEL_TOL)
    for name, buf in port.named_buffers():
        _, path = flax_location(name, buf.dim())
        node = stats
        for k in path:
            node = node[k]
        np.testing.assert_allclose(buf.numpy(), np.asarray(node),
                                   err_msg=name, **MODEL_TOL)
    # gradients up to ~300 in size, summed in another order through the
    # batch-statistics BN: 1e-4 of each parameter's largest gradient (the
    # port in fp64 sits within 7.5e-6 of it from the JAX fp32 gradient)
    want = params_like(port, grads)
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    port.zero_grad(set_to_none=True)


def test_hrda_train_refuses_bad_offsets(hrda_models):
    _, port, _ = hrda_models
    x = torch.zeros(1, 64, 64, 3)
    for bad in [(4, 0), (0, 40)]:
        with pytest.raises(ValueError, match="crop offset"):
            port(x, bad, method="hrda_train")


def test_entry_uda_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.build_uda_trainer("mit_b0", channels=32)


def _batch(seed, B=2, S=64):
    g = torch.Generator().manual_seed(seed)
    blocks = torch.randint(0, 19, (B, S // 32, S // 32), generator=g)
    sem = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    return dict(image_src=torch.randn(B, S, S, 3, generator=g),
                image_trg=torch.randn(B, S, S, 3, generator=g),
                image_ref=torch.randn(B, S, S, 3, generator=g),
                semantic_src=sem)


def test_entry_uda_train_step_on_cpu():
    """The Refign-HRDA* step (HRDA, Refign with VGG-16 + UAWarpC,
    adapt-to-reference, fdist, DACS with jitter and blur, dropout and drop
    path on) at mit_b0 on the CPU, fp32 compute: finite losses, the update
    count, the student moved, the teacher the EMA of it (m = 0 at step 0,
    0.5 at step 1), the ImageNet copy frozen, the same losses from the same
    seeds."""
    cfg = dataclasses.replace(entry.REFIGN_HRDA_STAR, compute_dtype="float32")
    key = "backbone.block1.0.attn.q.weight"

    def run():
        tr = entry.build_uda_trainer("mit_b0", cfg=cfg, device="cpu",
                                     channels=32, max_steps=10,
                                     warmup_iters=2)
        gen = torch.Generator().manual_seed(3)
        weights, logs = [tr.state.student.state_dict()[key].clone()], []
        for s in range(2):
            logs.append(entry.uda_train_step(tr, _batch(s), gen))
            weights.append(tr.state.student.state_dict()[key].clone())
        return tr, logs, weights

    # one intra-op thread: the VGG-16 align convs at 256^2 crawl when every
    # test worker's thread pool competes for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr, logs, (w0, w1, w2) = run()
        _, again, _ = run()
    finally:
        torch.set_num_threads(threads)
    st = tr.state
    assert st.step == 2
    for lg in logs:
        assert set(lg) == {"train_loss_src", "train_loss_featdist_src",
                           "train_loss_uda_trg", "train_pseudo_weight",
                           "train_loss_total"}
        assert all(torch.isfinite(v) and v.dim() == 0 for v in lg.values())
    assert not torch.equal(w2, w1)
    torch.testing.assert_close(st.teacher.state_dict()[key],
                               0.5 * w0 + 0.5 * w1)
    torch.testing.assert_close(st.imnet.state_dict()[key[9:]], w0,
                               rtol=0, atol=0)
    assert not any(p.requires_grad for p in st.teacher.parameters())
    for a, b in zip(logs, again):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_device_normalize_matches_host_transform():
    """uint8 images are ConvertImageDtype + Normalize'd on the device where
    the config asks for it; float images and labels pass through."""
    from refign_tpu_torch.uda.trainer import device_normalize
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, size=(2, 5, 6, 3)).astype(np.uint8)
    batch = {"image_src": torch.from_numpy(img),
             "image_trg": torch.from_numpy(_rand(9, 2, 5, 6, 3)),
             "semantic_src": torch.from_numpy(_labels(9, (2, 5, 6)))}
    cfg = entry.UDAConfig(device_normalize=True)
    out = device_normalize(cfg, batch)
    mean = np.asarray(cfg.norm_mean, np.float32)
    std = np.asarray(cfg.norm_std, np.float32)
    np.testing.assert_allclose(out["image_src"].numpy(),
                               (img.astype(np.float32) / 255.0 - mean) / std,
                               **TOL)
    assert out["image_trg"] is batch["image_trg"]
    assert out["semantic_src"] is batch["semantic_src"]
    assert device_normalize(entry.UDAConfig(), batch) is batch
