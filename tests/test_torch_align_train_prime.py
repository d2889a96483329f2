"""The port's prime view (refign_tpu_torch/alignment/synthetic_flows.py and
``prepare_alignment_batch``) against the JAX package, fp32 on the CPU.

JAX draws inside its functions from keys; the port takes its draws as
arguments (:class:`FlowDraws`, :class:`AlignDraws`).  The tests replay
JAX's key splits to read the numbers it draws and hand those to the port:
each mapping, the elastic flow, the composite, and the whole prime view
(coin, jitter, channel shuffle, blur, flow, crop window) of both stage
settings.  The port's own draws are checked by their distribution.

Tolerances: mappings 1e-5 absolute ([-1, 1] units); flows 1e-5 of the
field's largest displacement (the elastic warp moves each value by its
neighbours' differences) and 1e-4 pixels; images 1e-5 / 1e-4; masks
exactly.  The afftps mapping marks what leaves the image with -1e10, which
bilinear weights then mix into neighbouring values: such values (beyond 2
in [-1, 1] units, beyond 1e4 pixels in a flow) must sit at the same places
on both sides, and their size is not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.alignment.synthetic_flows as jsf
from refign_tpu.alignment.trainer import (AlignConfig as JaxAlignConfig,
                                          prepare_alignment_batch as jax_prep)
from refign_tpu_torch.alignment import synthetic_flows as tsf
from refign_tpu_torch.alignment.trainer import (AlignConfig, AlignDraws,
                                                PrimeDraws, crop_window,
                                                draw_align,
                                                prepare_alignment_batch)
from refign_tpu_torch.entry import ALIGN_STAGES
from refign_tpu_torch.uda.dacs import JitterFactors

# the two stages' step settings, read from megadepth/uawarpc_stage{1,2}.yaml
STAGE1, STAGE2 = ALIGN_STAGES[1][0], ALIGN_STAGES[2][0]

FLOW_TOL = dict(rtol=1e-5, atol=1e-4)
IMG_TOL = dict(rtol=1e-5, atol=1e-4)
MAP_TOL = dict(rtol=0, atol=1e-5)
split = jax.random.split
uniform = jax.random.uniform


def _assert_fields_close(got, want, wild, tol):
    """Values within ``wild`` of 0 agree to ``tol`` (a dict of rtol and
    atol, atol relative to their largest magnitude); the rest, the
    sentinel's mixtures, lie at the same places."""
    got, want = np.asarray(got), np.asarray(want)
    far = np.abs(want) > wild
    np.testing.assert_array_equal(np.abs(got) > wild, far)
    scale = np.abs(want[~far]).max()
    np.testing.assert_allclose(got[~far], want[~far], rtol=tol["rtol"],
                               atol=max(tol["atol"], tol["rtol"] * scale))


# ---------------------------------------------------------------------------
# replays of JAX's draws
# ---------------------------------------------------------------------------

def _affine_draw(key, alpha, s, tx, ty):
    k = split(key, 5)
    rot = (uniform(k[0]) - 0.5) * 2 * alpha
    sh = (uniform(k[1]) - 0.5) * 2 * alpha
    l1 = 1 + (2 * uniform(k[2]) - 1) * s
    tx_ = (2 * uniform(k[3]) - 1) * tx
    ty_ = (2 * uniform(k[4]) - 1) * ty
    return tuple(float(v) for v in (rot, sh, l1, l1, tx_, ty_))


def _theta_draw(key, base, t):
    base = jnp.asarray(base, jnp.float32)
    return tuple(np.asarray(base + (uniform(key, base.shape) - 0.5) * 2 * t)
                 .tolist())


def _tps_base():
    P_X, P_Y, _, _ = jsf._tps_control(3)
    return np.concatenate([P_X, P_Y])


def _elastic_draw(key, H, W):
    """The elastic ElasticDraws and (2, H, W) noise that JAX's apply_elastic
    draws from key."""
    k1, k2 = split(key)
    kk = split(k1, 4)
    m = float(max(H, W))
    sigma = float(m * (0.1 + 0.08 * uniform(kk[0])))
    alpha = float(m * (1.0 + 1.0 * uniform(kk[1])))
    noise = np.stack([np.asarray(uniform(kk[2], (H, W))),
                      np.asarray(uniform(kk[3], (H, W)))])
    kn, krest = split(k2)
    n = int(jax.random.randint(kn, (), 5, 14))
    sig, ux, uy = [], [], []
    for kb in split(krest, 13):
        ks, kx, ky = split(kb, 3)
        sig.append(int(jax.random.randint(ks, (), 10, 41)))
        ux.append(float(uniform(kx)))
        uy.append(float(uniform(ky)))
    return (tsf.ElasticDraws(sigma, alpha, n, tuple(sig), tuple(ux),
                             tuple(uy)), noise)


def _flow_draw(key, H, W, cfg):
    """FlowDraws and noise (or None) of JAX's composite_flow(key, ...)."""
    k_choice, k_gen, k_el = split(key, 3)
    kinds = cfg.include_transforms
    kind = kinds[int(jax.random.randint(k_choice, (), 0, len(kinds)))]
    aff = (cfg.random_alpha, cfg.random_s, cfg.random_tx, cfg.random_ty)
    if kind == "hom":
        draw = tsf.FlowDraws(kind, theta=_theta_draw(
            k_gen, [-1., -1., 1., 1., -1., 1., -1., 1.], cfg.random_t_hom))
    elif kind == "tps":
        draw = tsf.FlowDraws(kind, theta=_theta_draw(k_gen, _tps_base(),
                                                     cfg.random_t_tps))
    elif kind == "affine":
        draw = tsf.FlowDraws(kind, affine=_affine_draw(k_gen, *aff))
    else:
        ka, kt = split(k_gen)
        draw = tsf.FlowDraws(kind, affine=_affine_draw(ka, *aff),
                             theta=_theta_draw(kt, _tps_base(),
                                               cfg.random_t_tps_for_afftps))
    noise = None
    if cfg.add_elastic:
        draw.elastic, noise = _elastic_draw(k_el, H, W)
    return draw, noise


def _jitter_draw(key, b, c, s, h):
    k_order, kb, kc, ks, kh = split(key, 5)
    return JitterFactors(
        float(uniform(kb, (), minval=max(0.0, 1 - b), maxval=1 + b)),
        float(uniform(kc, (), minval=max(0.0, 1 - c), maxval=1 + c)),
        float(uniform(ks, (), minval=max(0.0, 1 - s), maxval=1 + s)),
        float(uniform(kh, (), minval=-h, maxval=h)),
        tuple(int(i) for i in jax.random.permutation(k_order, 4)))


def _align_draws(rng, B, H, W, cfg):
    """AlignDraws and noise of JAX's prepare_alignment_batch(rng, ...)."""
    k_coin, k_photo, k_flow = split(rng, 3)
    coins = tuple(int(v) for v in np.asarray(
        jax.random.bernoulli(k_coin, 0.5, (B,))))
    photo = [PrimeDraws() for _ in range(B)]
    r = k_photo
    if cfg.prime_jitter is not None:
        r, k = split(r)
        for d, kk in zip(photo, split(k, B)):
            d.jitter = _jitter_draw(kk, *cfg.prime_jitter)
    if cfg.prime_channel_shuffle:
        r, k = split(r)
        for d, kk in zip(photo, split(k, B)):
            d.perm = tuple(int(i) for i in jax.random.permutation(kk, 3))
    if cfg.prime_blur is not None:
        p, _, lo, hi = cfg.prime_blur
        r, kp, ks = split(r, 3)
        apply = np.asarray(jax.random.bernoulli(kp, p, (B,)))
        sig = np.asarray(uniform(ks, (B,), minval=lo, maxval=hi))
        for d, a, sg in zip(photo, apply, sig):
            d.blur_sigma = float(sg) if a else None
    flows, noises = [], []
    for kk in split(k_flow, B):
        draw, noise = _flow_draw(kk, H, W, cfg)
        flows.append(draw)
        noises.append(noise)
    noise = (torch.from_numpy(np.stack(noises)) if cfg.add_elastic
             else None)
    return AlignDraws(coins, photo, flows), noise


def _jax_cfg(cfg: AlignConfig) -> JaxAlignConfig:
    fields = {f.name for f in dataclasses.fields(JaxAlignConfig)}
    return JaxAlignConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                             if k in fields})


# ---------------------------------------------------------------------------
# the mappings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_mappings_match_jax(seed):
    H, W = 24, 30
    key = jax.random.PRNGKey(seed)
    aff = _affine_draw(key, 0.26, 0.45, 0.25, 0.25)
    want = jsf.affine_mapping(key, H, W, 0.26, 0.45, 0.25, 0.25)
    np.testing.assert_allclose(tsf.affine_mapping(H, W, aff).numpy(),
                               np.asarray(want), **MAP_TOL)
    theta = _theta_draw(key, [-1., -1., 1., 1., -1., 1., -1., 1.], 0.4)
    want = jsf.homography_mapping(key, H, W, 0.4)
    np.testing.assert_allclose(tsf.homography_mapping(H, W, theta).numpy(),
                               np.asarray(want), **MAP_TOL)
    theta = _theta_draw(key, _tps_base(), 0.4)
    want = jsf.tps_mapping(key, H, W, 0.4)
    np.testing.assert_allclose(tsf.tps_mapping(H, W, theta).numpy(),
                               np.asarray(want), **MAP_TOL)


@pytest.mark.parametrize("seed", range(4))
def test_afftps_mapping_matches_jax(seed):
    """The analytic grid_sample of the sentineled affine map at the TPS
    coordinates, -1e10 where either leaves (-1, 1)."""
    H, W = 26, 22
    key = jax.random.PRNGKey(10 + seed)
    ka, kt = split(key)
    aff = _affine_draw(ka, 0.5, 0.6, 0.4, 0.4)
    theta = _theta_draw(kt, _tps_base(), 0.26)
    want = np.asarray(jsf.afftps_mapping(key, H, W, 0.5, 0.6, 0.4, 0.4,
                                         0.26))
    got = tsf.afftps_mapping(H, W, aff, theta).numpy()
    out = want < -1e9
    assert out.any() and not out.all()
    np.testing.assert_array_equal(got < -1e9, out)
    _assert_fields_close(got, want, 2.0, MAP_TOL)


@pytest.mark.parametrize("kind", ["hom", "tps", "afftps", "affine"])
def test_composite_flow_with_elastic_matches_jax(kind):
    """Each transform composed with the elastic perturbation (blurred
    noise, blobs, warp of the mapping)."""
    H, W = 40, 36
    cfg = dataclasses.replace(STAGE2, include_transforms=(kind,))
    for seed in range(2):
        key = jax.random.PRNGKey(20 + seed)
        draw, noise = _flow_draw(key, H, W, cfg)
        want = jsf.composite_flow(
            key, H, W, include_transforms=(kind,),
            random_alpha=cfg.random_alpha, random_s=cfg.random_s,
            random_tx=cfg.random_tx, random_ty=cfg.random_ty,
            random_t_tps=cfg.random_t_tps, random_t_hom=cfg.random_t_hom,
            random_t_tps_for_afftps=cfg.random_t_tps_for_afftps,
            add_elastic=True)
        got = tsf.composite_flow(draw, H, W, noise=torch.from_numpy(noise))
        _assert_fields_close(got, want, 1e4, FLOW_TOL)


def test_elastic_pieces_match_jax():
    """The FFT blur of the noise and the blob mask, on their own."""
    H, W = 48, 40
    key = jax.random.PRNGKey(5)
    draws, noise = _elastic_draw(key, H, W)
    k1, k2 = split(key)
    np.testing.assert_allclose(
        tsf.elastic_flow_field(torch.from_numpy(noise), draws.sigma,
                               draws.alpha).numpy(),
        np.asarray(jsf.elastic_flow_field(k1, H, W)), **FLOW_TOL)
    np.testing.assert_allclose(
        tsf.elastic_blob_mask(H, W, draws).numpy(),
        np.asarray(jsf.elastic_blob_mask(k2, H, W)), rtol=1e-5, atol=1e-6)


def _flows(H, W):
    rng = np.random.RandomState(1)
    return [rng.randn(H, W, 2).astype(np.float32) * 4,
            np.full((H, W, 2), 2.5, np.float32),
            # a huge displacement: the border mask is nearly empty and the
            # too-small fallback takes the full grid's border mask
            np.full((H, W, 2), 3.0 * W, np.float32)]


@pytest.mark.parametrize("out_slice", [None, (5, 7, 16, 20)])
def test_apply_synthetic_flow_matches_jax(out_slice):
    H, W = 30, 34
    img = np.random.RandomState(2).rand(H, W, 3).astype(np.float32)
    for flow in _flows(H, W):
        want = jsf.apply_synthetic_flow(jnp.asarray(img), jnp.asarray(flow),
                                        out_slice=out_slice)
        got = tsf.apply_synthetic_flow(torch.from_numpy(img),
                                       torch.from_numpy(flow),
                                       out_slice=out_slice)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **IMG_TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_windowed_warp_equals_full_warp_sliced():
    H, W = 30, 34
    img = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(3))
    for flow in map(torch.from_numpy, _flows(H, W)):
        full = tsf.apply_synthetic_flow(img, flow)
        win = tsf.apply_synthetic_flow(img, flow, out_slice=(4, 6, 17, 21))
        for a, b in zip(full, win):
            torch.testing.assert_close(a[4:21, 6:27], b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the whole prime view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_alignment_batch_matches_jax(stage, seed):
    """Coin, jitter, channel shuffle, blur, the flow on the full grid and
    the crop window's warp, with the numbers JAX draws from the key."""
    B, H, W = 3, 44, 44
    cfg = dataclasses.replace(STAGE1 if stage == 1 else STAGE2,
                              crop_after_flow=(32, 32),
                              prime_blur=(0.5, 7, 0.2, 2.0))
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    trg = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    key = jax.random.PRNGKey(100 + seed)
    out_slice = crop_window(cfg, H, W)
    want = jax.jit(jax_prep, static_argnames=("cfg", "out_slice"))(
        key, jnp.asarray(ref), jnp.asarray(trg), cfg=_jax_cfg(cfg),
        out_slice=out_slice)
    draws, noise = _align_draws(key, B, H, W, cfg)
    got = prepare_alignment_batch(draws, torch.from_numpy(ref),
                                  torch.from_numpy(trg), cfg,
                                  out_slice=out_slice, noise=noise)
    np.testing.assert_array_equal(got["prime_trg_idx"].numpy(),
                                  np.asarray(want["prime_trg_idx"]))
    _assert_fields_close(got["flow_prime"], want["flow_prime"], 1e4,
                         FLOW_TOL)
    np.testing.assert_array_equal(got["mask_prime"].numpy(),
                                  np.asarray(want["mask_prime"]))
    np.testing.assert_allclose(got["image_prime"].numpy(),
                               np.asarray(want["image_prime"]), **IMG_TOL)
    assert got["image_prime"].shape == (B, 32, 32, 3)


def test_elastic_noise_comes_from_the_seeded_device_generator():
    cfg = dataclasses.replace(STAGE2, crop_after_flow=None,
                              prime_jitter=None, prime_blur=None,
                              prime_channel_shuffle=False)
    B, H, W = 2, 24, 24
    gen = torch.Generator().manual_seed(4)
    draws = draw_align(cfg, B, H, W, gen)
    ref, trg = torch.randn(2, B, H, W, 3, generator=gen)
    first = prepare_alignment_batch(draws, ref, trg, cfg)
    noise = tsf.draw_elastic_noise(
        torch.Generator().manual_seed(draws.noise_seed), B, H, W)
    pinned = prepare_alignment_batch(draws, ref, trg, cfg, noise=noise)
    for k in first:
        torch.testing.assert_close(first[k], pinned[k], rtol=0, atol=0)
    assert noise.shape == (B, 2, H, W) and 0 <= noise.min() < noise.max() < 1


def test_draws_follow_their_distributions():
    """The port's host draws (stage 2 settings, 750^2): coins, the
    photometric draws, the uniform choice of transform, each theta within
    its base +- t, the affine ranges and the elastic parameters."""
    gen = torch.Generator().manual_seed(0)
    cfg = STAGE2
    n = 600
    draws = [draw_align(cfg, 1, 750, 750, gen) for _ in range(n)]
    coins = np.array([d.prime_trg_idx[0] for d in draws])
    assert 0.44 < coins.mean() < 0.56
    photo = [d.photometric[0] for d in draws]
    blurred = np.array([p.blur_sigma is not None for p in photo])
    assert 0.15 < blurred.mean() < 0.25
    sig = np.array([p.blur_sigma for p in photo if p.blur_sigma])
    assert 0.2 <= sig.min() and sig.max() <= 2.0
    assert len({p.perm for p in photo}) == 6
    kinds = [d.flows[0].kind for d in draws]
    for k in cfg.include_transforms:
        assert 0.28 < kinds.count(k) / n < 0.39
    hom = np.array([d.flows[0].theta for d in draws
                    if d.flows[0].kind == "hom"])
    base = np.array([-1., -1., 1., 1., -1., 1., -1., 1.])
    dev = np.abs(hom - base)
    assert dev.max() <= cfg.random_t_hom and dev.max() > 0.9 * cfg.random_t_hom
    tps = np.array([d.flows[0].theta for d in draws
                    if d.flows[0].kind == "tps"])
    assert np.abs(tps - _tps_base()).max() <= cfg.random_t_tps
    aff = np.array([d.flows[0].affine for d in draws
                    if d.flows[0].kind == "afftps"])
    lim = [cfg.random_alpha, cfg.random_alpha, None, None, cfg.random_tx,
           cfg.random_ty]
    for i, m in enumerate(lim):
        if m is not None:
            assert np.abs(aff[:, i]).max() <= m
    assert np.abs(aff[:, 2] - 1).max() <= cfg.random_s
    np.testing.assert_array_equal(aff[:, 2], aff[:, 3])
    el = [d.flows[0].elastic for d in draws]
    s = np.array([e.sigma for e in el])
    a = np.array([e.alpha for e in el])
    assert 75 <= s.min() and s.max() <= 135
    assert 750 <= a.min() < a.max() <= 1500
    nb = np.array([e.n_blobs for e in el])
    assert nb.min() == 5 and nb.max() == 13
    bs = np.array([e.blob_sigma for e in el])
    assert bs.min() == 10 and bs.max() == 40
