"""The modules under the port's UAWarpC train step against the JAX package,
fp32 on the CPU: K3's gradient in both modes (the plain backward the CPU
wrapper takes, whose arithmetic the CUDA backward kernel repeats), the
VGG configurations, the matching losses, Adam with MultiStepLR and the
prime view's photometric augmentations.

Tolerances: 1e-5 relative / 1e-4 absolute for values of order one
(losses, weights, optimizer updates, images in [0, 1]); K3's gradients
1e-5 of their largest magnitude (fp32 sums in another order; the pixels
whose clamp makes graw ~1e12 are held to 1e-5 relative on their own).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.alignment.losses as jl
import refign_tpu.uda.dacs as jd
from refign_tpu.models.vgg import ARCH_SETTINGS, VGG as JaxVGG
from refign_tpu.ops import correlation as jc
from refign_tpu.train.optim import make_adam_optimizer as jax_adam
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch.alignment import losses as tl
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.ops import correlation as tc
from refign_tpu_torch.train.optim import make_adam_optimizer, multistep_lr
from refign_tpu_torch.uda import dacs as td

RTOL, ATOL = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# K3's gradient
# ---------------------------------------------------------------------------

def _corr_inputs(B, H, W, C, seed):
    """Target and source with the exact zeros of the head's inputs: a
    target pixel of zeros (all its taps 0, its sum of squares clamped) and
    a source block of zeros that some pixels' whole 9x9 window lies in (a
    warped-out window), besides the zero-padded taps at the border."""
    rng = np.random.RandomState(seed)
    t = rng.randn(B, H, W, C).astype(np.float32)
    s = rng.randn(B, H, W, C).astype(np.float32)
    t[0, H // 2, W // 3] = 0
    s[-1, 1:11, 2:12] = 0
    g = rng.randn(B, H, W, 81).astype(np.float32)
    return t, s, g


def _jax_fns(use_pallas):
    """raw and fused JAX functions of (t, s): the XLA shift loop, or the
    Pallas kernel in interpret mode through its custom_vjp."""
    if use_pallas:
        raw = functools.partial(jc.local_correlation, patch_size=9,
                                use_pallas=True, interpret=True)
    else:
        raw = functools.partial(jc.local_correlation, patch_size=9,
                                use_pallas=False)

    def fused(t, s):
        corr = jnp.maximum(raw(t, s), 0.0)
        ss = jnp.sum(jnp.square(corr), axis=-1, keepdims=True)
        return corr / jnp.sqrt(jnp.maximum(ss, 1e-24))

    return raw, fused


def _assert_grads_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    big = np.abs(want) > 1e6
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[big], want[big], rtol=1e-5)
    small = np.where(big, 0, want)
    np.testing.assert_allclose(np.where(big, 0, got), small, rtol=0,
                               atol=1e-5 * np.abs(small).max())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_k3_gradient_matches_jax_vjp(fused, use_pallas):
    t, s, g = _corr_inputs(2, 14, 15, 12, seed=3)
    raw_fn, fused_fn = _jax_fns(use_pallas)
    if fused and not use_pallas:
        # the JAX package's own function on the CPU path
        def fn(a, b):
            return jc.local_correlation_relu_l2norm(a, b, 9)
    else:
        fn = fused_fn if fused else raw_fn
    want_out, vjp = jax.vjp(fn, jnp.asarray(t), jnp.asarray(s))
    want = vjp(jnp.asarray(g))
    tt = torch.tensor(t, requires_grad=True)
    ts = torch.tensor(s, requires_grad=True)
    port = tc.local_correlation_relu_l2norm if fused else tc.local_correlation
    out = port(tt, ts, 9)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, (tt, ts), torch.from_numpy(g))
    for a, b in zip(got, want):
        _assert_grads_close(a.numpy(), b)
    if fused:
        # the clamped pixels: graw = 0.5 g / 1e-12 flows on
        assert np.abs(np.asarray(want[0])).max() > 1e10
        assert np.abs(np.asarray(want[1])).max() > 1e10


def test_relu_l2norm_gradient_at_its_non_smooth_points():
    """0.5 at an exact 0, 1 above, 0 below (jnp.maximum), and g / 1e-12
    where the sum of squares is clamped; torch's clamp_min would give 1 at
    0 and relu 0."""
    corr = np.array([[0.0, 1.0, -1.0, 2.0], [0.0, -3.0, 0.0, 0.0]],
                    np.float32)
    g = np.array([[1.0, 0.5, 2.0, -1.0], [1.0, 2.0, -3.0, 0.5]], np.float32)

    def jax_fn(x):
        c = jnp.maximum(x, 0.0)
        ss = jnp.sum(jnp.square(c), axis=-1, keepdims=True)
        return c / jnp.sqrt(jnp.maximum(ss, 1e-24))

    _, vjp = jax.vjp(jax_fn, jnp.asarray(corr))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.tensor(corr, requires_grad=True)
    (got,) = torch.autograd.grad(tc.relu_l2norm(x), x, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the clamped row: 0.5 g / 1e-12 at the zeros, 0 below
    np.testing.assert_allclose(want[1], [0.5e12, 0.0, -1.5e12, 0.25e12],
                               rtol=1e-6)


def test_k3_gradient_only_where_needed():
    """A frozen target: the plain path gives the source gradient alone, as
    the kernel's backward is asked for it alone."""
    t, s, g = _corr_inputs(1, 10, 11, 8, seed=5)
    ts = torch.tensor(s, requires_grad=True)
    out = tc.local_correlation_relu_l2norm(torch.from_numpy(t), ts, 9)
    (gs,) = torch.autograd.grad(out, ts, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda b: jc.local_correlation_relu_l2norm(
        jnp.asarray(t), b, 9), jnp.asarray(s))
    _assert_grads_close(gs.numpy(), vjp(jnp.asarray(g))[0])


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", sorted(ARCH_SETTINGS))
def test_vgg_configurations_match_jax(model_type):
    """Every configuration, with and without BN (on moved running
    statistics, applied in train mode too), at every level."""
    net = VGG(model_type, out_indices=(0, 1, 2, 3, 4))
    gen = torch.Generator().manual_seed(0)
    net.init_weights(gen)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            noise = 0.1 * torch.randn(buf.shape, generator=gen)
            buf.copy_(buf.abs() + 0.5 + noise.abs() if name.endswith("var")
                      else noise)
    net.train()
    variables = jax.tree_util.tree_map(np.array,
                                       convert_state_dict(net.state_dict()))
    x = np.random.RandomState(1).randn(2, 32, 48, 3).astype(np.float32)
    want = JaxVGG(model_type=model_type, out_indices=(0, 1, 2, 3, 4)).apply(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL * float(np.abs(b).max()))
    with torch.no_grad():
        last = net(torch.from_numpy(x), extract_only_indices=[-2, -1])
    for a, b in zip(last, want[-2:]):
        torch.testing.assert_close(a, torch.from_numpy(np.array(b)),
                                   rtol=RTOL,
                                   atol=ATOL * float(np.abs(b).max()))


def test_vgg_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown VGG"):
        VGG("vgg12")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _levels(rng, B, sizes, uncert_channels=1):
    return [(rng.randn(B, h, w, 2).astype(np.float32) * 3,
             rng.randn(B, h, w, uncert_channels).astype(np.float32))
            for h, w in sizes]


def _to_torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(x) for x in tree)
    return torch.from_numpy(np.asarray(tree))


def _to_jax(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(x) for x in tree)
    return jnp.asarray(tree)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def test_huber_matches_jax():
    d = np.linspace(-3, 3, 101).astype(np.float32)
    for delta in (1.0, 0.5):
        _close(tl.huber(torch.from_numpy(d), delta),
               jl.huber(jnp.asarray(d), delta))


@pytest.mark.parametrize("loss_type,comps", [
    ("HuberLoss", None), ("HuberLoss", 1), ("HuberLoss", 2),
    ("L2Loss", None), ("L2Loss", 1), ("L2Loss", 2), ("L1Loss", None)])
def test_multi_scale_flow_loss_matches_jax(loss_type, comps):
    rng = np.random.RandomState(2)
    B, H, W = 2, 32, 40
    sizes = [(4, 5), (8, 10), (16, 20)]
    outs = _levels(rng, B, sizes, comps or 1)
    if comps is None:
        outs = [f for f, _ in outs]
    gt = rng.randn(B, H, W, 2).astype(np.float32) * 3
    mask = rng.rand(B, H, W) > 0.3
    for m, w in ((mask, None), (None, (0.5, 1.0, 2.0))):
        got = tl.multi_scale_flow_loss(_to_torch(outs), torch.from_numpy(gt),
                                       None if m is None
                                       else torch.from_numpy(m),
                                       loss_type=loss_type, level_weights=w)
        want = jax.jit(functools.partial(
            jl.multi_scale_flow_loss, loss_type=loss_type,
            level_weights=w))(_to_jax(outs), jnp.asarray(gt),
                              None if m is None else jnp.asarray(m))
        _close(got, want)


def test_probabilistic_l1_loss_refused():
    flow = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="L2Loss or HuberLoss"):
        tl.multi_scale_flow_loss([(flow, torch.zeros(1, 4, 4, 1))],
                                 torch.zeros(1, 8, 8, 2), loss_type="L1Loss")


def test_downsampled_mask_and_empty_mask_mean():
    """The mask is resized bilinearly and floored (only pixels whose whole
    neighbourhood is valid stay); an empty mask gives 0."""
    rng = np.random.RandomState(4)
    mask = rng.rand(2, 24, 36) > 0.2
    got = tl._downsample_mask(torch.from_numpy(mask), (6, 9))
    want = jl._downsample_mask(jnp.asarray(mask), (6, 9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.randn(2, 6, 9).astype(np.float32)
    empty = np.zeros((2, 6, 9), bool)
    assert float(tl._masked_mean(torch.from_numpy(x),
                                 torch.from_numpy(empty))) == 0.0
    _close(tl._masked_mean(torch.from_numpy(x), got),
           jl._masked_mean(jnp.asarray(x), want))


@pytest.mark.parametrize("visibility_mask", [False, True])
@pytest.mark.parametrize("probabilistic", [False, True])
def test_wbipath_loss_matches_jax(visibility_mask, probabilistic):
    rng = np.random.RandomState(5)
    B, H, W = 2, 32, 32
    sizes = [(4, 4), (8, 8), (16, 16)]
    a = _levels(rng, B, sizes)
    b = _levels(rng, B, sizes)
    if not probabilistic:
        a, b = [f for f, _ in a], [f for f, _ in b]
    gt = rng.randn(B, H, W, 2).astype(np.float32) * 3
    mask = rng.rand(B, H, W) > 0.1
    kw = dict(loss_type="HuberLoss", visibility_mask=visibility_mask,
              alpha_1=0.03, alpha_2=3.0)
    got = tl.wbipath_loss(_to_torch(a), _to_torch(b), torch.from_numpy(gt),
                          torch.from_numpy(mask), **kw)
    want = jax.jit(functools.partial(jl.wbipath_loss, **kw))(
        _to_jax(a), _to_jax(b), jnp.asarray(gt), jnp.asarray(mask))
    _close(got, want)
    # the visibility mask keeps some pixels and drops others here
    fa, fb = _to_torch(a[1] if not probabilistic else a[1][0]), \
        _to_torch(b[1] if not probabilistic else b[1][0])
    vis = tl._cyclic_consistency_mask(fa, fb, torch.from_numpy(gt), 0.03, 3.0)
    want_vis = jl._cyclic_consistency_mask(jnp.asarray(fa.numpy()),
                                           jnp.asarray(fb.numpy()),
                                           jnp.asarray(gt), 0.03, 3.0)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want_vis))
    assert 0 < vis.float().mean() < 1


def test_wbipath_loss_gradient_matches_jax():
    """The warp flow is detached: the gradient reaches flow_a only through
    the composition's direct term, and flow_b through the warp."""
    rng = np.random.RandomState(6)
    B, H, W = 1, 16, 16
    a = _levels(rng, B, [(8, 8)])
    b = _levels(rng, B, [(8, 8)])
    gt = rng.randn(B, H, W, 2).astype(np.float32)

    def jax_loss(a_, b_):
        return jl.wbipath_loss(a_, b_, jnp.asarray(gt), None,
                               visibility_mask=True, alpha_2=3.0)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(_to_jax(a),
                                                        _to_jax(b))
    ta = [tuple(x.requires_grad_() for x in lvl) for lvl in _to_torch(a)]
    tb = [tuple(x.requires_grad_() for x in lvl) for lvl in _to_torch(b)]
    loss = tl.wbipath_loss(ta, tb, torch.from_numpy(gt), None,
                           visibility_mask=True, alpha_2=3.0)
    got = torch.autograd.grad(loss, [x for lvl in ta + tb for x in lvl])
    flat = jax.tree_util.tree_leaves(want)
    for g_, w_ in zip(got, flat):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("ss,us", [(1.0, 2.0), (2.0, 1.0), (3.0, 3.0),
                                   (1e-9, 5.0), (5.0, 1e-9)])
@pytest.mark.parametrize("weight_ss,apply_constant",
                         [(0.0, False), (1.0, False), (0.5, False),
                          (2.0, True)])
def test_adaptive_loss_weights_match_jax(ss, us, weight_ss, apply_constant):
    """Including the step's bug-compatible weight_ss = 0: weights (0, 1)
    where us > ss, else (1, 100)."""
    got = tl.adaptive_loss_weights(torch.tensor(ss), torch.tensor(us),
                                   weight_ss=weight_ss,
                                   apply_constant=apply_constant)
    want = jl.adaptive_loss_weights(jnp.float32(ss), jnp.float32(us),
                                    weight_ss=weight_ss,
                                    apply_constant=apply_constant)
    for a, b in zip(got, want):
        _close(a, b)
    if weight_ss == 0.0 and not apply_constant:
        assert [float(v) for v in got] == ([0.0, 1.0] if us > ss
                                           else [1.0, 100.0])


# ---------------------------------------------------------------------------
# Adam + MultiStepLR
# ---------------------------------------------------------------------------

def test_multistep_lr_matches_jax():
    from refign_tpu.train.optim import multistep_schedule
    sched = multistep_schedule(1e-4, (3, 5), 0.5)
    for step in range(8):
        np.testing.assert_allclose(multistep_lr(step, 1e-4, (3, 5), 0.5),
                                   float(sched(step)), rtol=1e-7)


def test_adam_with_l2_decay_matches_optax():
    """Four updates across two milestones with L2 decay 0.1 on every
    parameter, biases too (the decay precedes the moments)."""
    rng = np.random.RandomState(7)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    tx, _ = jax_adam(1e-2, (1, 3), gamma=0.5, weight_decay=0.1)
    state, p = tx.init(params), dict(params)
    for g in grads:
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sched = make_adam_optimizer(tp.values(), 1e-2, (1, 3), gamma=0.5,
                                     weight_decay=0.1)
    for step, g in enumerate(grads):
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        sched.set_step(step)
        opt.step()
    for k, v in tp.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(p[k]),
                                   rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the prime view's photometric augmentations
# ---------------------------------------------------------------------------

def _jitter_factors(key, b, c, s, h):
    """The factors and order that JAX's color_jitter_bcsh draws from key."""
    k_order, kb, kc, ks, kh = jax.random.split(key, 5)
    fb = float(jax.random.uniform(kb, (), minval=max(0.0, 1 - b),
                                  maxval=1 + b))
    fc = float(jax.random.uniform(kc, (), minval=max(0.0, 1 - c),
                                  maxval=1 + c))
    fs = float(jax.random.uniform(ks, (), minval=max(0.0, 1 - s),
                                  maxval=1 + s))
    fh = float(jax.random.uniform(kh, (), minval=-h, maxval=h))
    order = tuple(int(i) for i in jax.random.permutation(k_order, 4))
    return td.JitterFactors(fb, fc, fs, fh, order)


@pytest.mark.parametrize("strengths", [(0.6, 0.6, 0.6, 0.0),
                                       (0.4, 0.0, 0.3, 0.1),
                                       (0.0, 0.5, 0.0, 0.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_bcsh_matches_jax(strengths, seed):
    """torchvision semantics with the factors JAX draws; an op whose
    strength is 0 is left out."""
    img = np.random.RandomState(seed).rand(12, 14, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jd.color_jitter_bcsh(key, jnp.asarray(img), *strengths)
    got = td.color_jitter_bcsh(torch.from_numpy(img),
                               _jitter_factors(key, *strengths), *strengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_draw_jitter_bcsh_ranges():
    gen = torch.Generator().manual_seed(0)
    draws = [td.draw_jitter_bcsh(gen, 0.6, 0.6, 0.6, 0.0)
             for _ in range(400)]
    for name in ("brightness", "contrast", "saturation"):
        v = np.array([getattr(d, name) for d in draws])
        assert 0.4 <= v.min() < 0.45 and 1.55 < v.max() <= 1.6
        assert abs(v.mean() - 1.0) < 0.05
    assert all(d.hue == 0.0 for d in draws)
    orders = {d.order for d in draws}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders)
    assert len(orders) > 12


@pytest.mark.parametrize("sigma", [0.2, 1.3, 2.0])
def test_blur_with_kernel_size_matches_jax(sigma):
    img = np.random.RandomState(3).rand(20, 17, 3).astype(np.float32)
    want = jd.gaussian_blur_image(jnp.asarray(img), jnp.float32(sigma),
                                  kernel_size=7)
    got = td.gaussian_blur_image(torch.from_numpy(img), sigma, kernel_size=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
