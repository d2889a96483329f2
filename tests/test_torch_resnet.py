"""The port's ResNet v1c (refign_tpu_torch/models/resnet.py) against the JAX
package's (refign_tpu/models/resnet.py), fp32 on the CPU.

Weights: the port's seeded init with every BatchNorm's scale, bias,
running mean and running variance drawn at random (the init's zero scale
on the last BatchNorm of each residual branch would silence every
branch), carried to JAX by the JAX package's ``convert_state_dict``.
Inputs are seeded numpy arrays.  Held:

* the max pool of the stem against the JAX package's -inf padding, both
  ceil modes, odd and even sizes;
* the stage outputs of ``resnet18_v1c`` (strides (1, 2, 2, 2)) and of
  ``resnet50_v1c`` with DeepLabV2's strides (1, 2, 1, 1) and dilations
  (1, 1, 2, 4), at narrow widths, with ``contract_dilation`` off and on,
  ``max_pool_ceil_mode`` off and on (on a 63x97 input, whose stem output
  is 32 rows high: the ceil mode adds a pooled row), in eval and train
  BatchNorm, within 1e-4 of each output's largest |value| (train mode:
  against JAX's own floor, below);
* the running statistics after one train forward, ``norm_eval`` (eval
  BatchNorm in train mode, statistics unchanged);
* the input gradient and every parameter's gradient, 1e-4 relative (L2 of
  each) in eval mode, in train mode against JAX's own floor (below);
* ``remat``: the same gradients and running statistics as without it;
* a narrow ``resnet101_v1c`` (stem and base width 8, 33^2), so the
  23-block stage is held;
* the init: Kaiming fan-out convs, BatchNorm ones/zeros, a zero scale on
  the last BatchNorm of each residual branch, and the parameter names of
  the JAX package's tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.resnet import ResNet as JaxResNet
from refign_tpu.models.resnet import _max_pool_3x3_s2 as jax_max_pool
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch.models.resnet import ResNet, max_pool_3x3_s2
from refign_tpu_torch.nn.layers import TorchBatchNorm, TorchConv
from refign_tpu_torch.utils.jax_convert import (flax_location,
                                                load_jax_variables)

# Limits.  Eval-mode BatchNorm: each output within 1e-4 of its largest
# |value| (the residual stages sum their branches, so activations grow to
# ~1e2 and an element near 0 carries the rounding of its large neighbours),
# each gradient within 1e-4 relative (L2).  Train-mode BatchNorm normalises
# with statistics of the batch over maps of 96 values a channel at layer2-4
# here, which amplifies fp32 rounding through the 16 bottleneck blocks of
# resnet50: JAX's own outputs move by up to 8e-5 of their largest |value|
# (layer4), and its gradients by ~8e-3 relative, when the input moves by one
# ulp.  So in train mode each comparison is held to 1e-4 + 5x that floor,
# measured on the JAX side in the test (readings on the CPU: resnet18 within
# 1e-5 everywhere; resnet50 outputs up to 2.6e-4 at layer4 against a floor
# of 8.1e-5, gradients 2.2e-2 against 8.2e-3; a float64 forward of the same
# network puts the port's layer4 at 5.9e-5 from it and JAX's at 2.6e-4).
REL = 1e-4
GRAD_RTOL = 1e-4
FLOOR_FACTOR = 5
ARCHS = {
    "resnet18_v1c": dict(strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1)),
    "resnet50_v1c": dict(strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)),
}
NARROW = dict(stem_channels=16, base_channels=16)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def randomize_bn_(module: torch.nn.Module, seed: int) -> None:
    """Every BatchNorm's scale, bias, running mean and running variance
    drawn at random (scale around 1, variance in [0.5, 1.5])."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.weight.shape[0]
                m.weight.copy_(1.0 + 0.3 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def _pair(model_type, seed=0, **kw):
    """The port's ResNet (seeded, BatchNorms randomized) and the JAX one
    with its variables (copies of the port's state)."""
    kw = {**ARCHS.get(model_type, {}), **kw}
    port = ResNet(model_type, **kw)
    port.init_weights(torch.Generator().manual_seed(seed))
    randomize_bn_(port, seed + 1)
    variables = jax.tree_util.tree_map(
        np.array, convert_state_dict(port.state_dict()))
    jm = JaxResNet(model_type=model_type, **{
        k: tuple(v) if isinstance(v, (list, tuple)) else v
        for k, v in kw.items()})
    return port, jm, variables


def _nhwc(out):
    return [np.asarray(o) for o in out]


def assert_close_rel(got, want, rel=REL, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _ulp(x, seed=99):
    """x moved by one ulp (2^-23 relative), up or down at random."""
    sign = np.random.RandomState(seed).choice([-1.0, 1.0], x.shape)
    return (x * (1 + sign * 2.0 ** -23)).astype(np.float32)


def _floor(a, b):
    """How far JAX's result moved: max |a - b| over max |a|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _stats(port):
    return {k: v.clone() for k, v in port.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_stats(port, batch_stats):
    """The JAX batch statistics on the port's state_dict keys."""
    out = {}
    for key, t in _stats(port).items():
        node = batch_stats
        for p in flax_location(key, t.dim())[1]:
            node = node[p]
        out[key] = np.asarray(node)
    return out


@pytest.mark.parametrize("ceil", [False, True])
@pytest.mark.parametrize("H,W", [(32, 49), (33, 48), (17, 17), (8, 9)])
def test_max_pool_matches_jax(H, W, ceil):
    x = _rand(H * W, 2, H, W, 5)
    want = np.asarray(jax_max_pool(jnp.asarray(x), ceil))
    got = max_pool_3x3_s2(torch.from_numpy(x), ceil).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ceil", [False, True])
@pytest.mark.parametrize("contract", [False, True])
@pytest.mark.parametrize("model_type", sorted(ARCHS))
def test_forward_matches_jax(model_type, contract, ceil, train):
    port, jm, variables = _pair(model_type, contract_dilation=contract,
                                max_pool_ceil_mode=ceil, **NARROW)
    jm = jm.clone(contract_dilation=contract, max_pool_ceil_mode=ceil)
    x = _rand(1, 2, 63, 97, 3)
    floors = [0.0] * 4
    if train:
        want, mut = jm.apply(variables, x, train=True,
                             mutable=["batch_stats"])
        moved, moved_mut = jm.apply(variables, _ulp(x), train=True,
                                    mutable=["batch_stats"])
        floors = [_floor(a, b) for a, b in zip(want, moved)]
    else:
        want = jm.apply(variables, x)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, _nhwc(want))):
        assert_close_rel(g.numpy(), w, REL + FLOOR_FACTOR * floors[i],
                         f"stage {i}")
    # the ceil mode adds the pooled row: 17 rows after the stem's max pool
    assert got[0].shape[1] == (17 if ceil else 16)
    if train:
        # the running statistics after the forward: each within 1e-5 of
        # its largest |value| + 5x JAX's own movement
        want_stats = _jax_stats(port, mut["batch_stats"])
        moved_stats = _jax_stats(port, moved_mut["batch_stats"])
        for key, t in _stats(port).items():
            floor = _floor(want_stats[key], moved_stats[key])
            assert_close_rel(t.numpy(), want_stats[key],
                             1e-5 + FLOOR_FACTOR * floor, key)


def test_running_stats_move_in_train_mode():
    """One train forward moves every running statistic (momentum 0.1 of
    the batch's), an eval forward none."""
    port, _, _ = _pair("resnet18_v1c", **NARROW)
    before = _stats(port)
    x = torch.from_numpy(_rand(2, 2, 33, 33, 3))
    with torch.no_grad():
        port.eval()(x)
        assert all(torch.equal(before[k], v) for k, v in _stats(port).items())
        port.train()(x)
    moved = [k for k, v in _stats(port).items()
             if not torch.equal(before[k], v)]
    assert len(moved) == len(before)


def test_norm_eval_matches_jax():
    """``norm_eval``: train mode runs BatchNorm on the running statistics
    and leaves them as they are, on both sides."""
    port, jm, variables = _pair("resnet50_v1c", norm_eval=True, **NARROW)
    port.train()
    assert port.training and not any(
        m.training for m in port.modules() if isinstance(m, TorchBatchNorm))
    x = _rand(3, 2, 48, 64, 3)
    want, mut = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    before = _stats(port)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, _nhwc(want)):
        assert_close_rel(g.numpy(), w)
    for key, t in _stats(port).items():
        assert torch.equal(t, before[key])
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           mut["batch_stats"], variables["batch_stats"])


def _jax_grad_fn(jm, variables, cots, train=True):
    """x -> (parameter gradients, input gradient) of the stage outputs
    against ``cots``, compiled once."""
    def loss(params, x):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            outs, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
        else:
            outs = jm.apply(v, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    return lambda x: grad(variables["params"], x)


def _port_grads(port, x, cots, train=True):
    xt = torch.from_numpy(x).requires_grad_()
    port.train(train)
    port.zero_grad(set_to_none=True)
    outs = port(xt)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
        ).backward()
    return xt.grad, {n: p.grad.clone() for n, p in port.named_parameters()}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _rel_all(a, b):
    """Relative L2 error over all entries of two name -> tensor maps."""
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in b)
    den = sum(float((b[n] ** 2).sum()) for n in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("model_type,train", [
    ("resnet18_v1c", True), ("resnet50_v1c", True), ("resnet50_v1c", False)])
def test_gradients_match_jax(model_type, train):
    """The input gradient and every parameter's against ``jax.grad`` with
    the same cotangents on the four stage outputs: 1e-4 relative (L2) in
    eval mode, each parameter's; in train mode the input gradient, all
    parameters together and the median parameter within 1e-4 + 5x JAX's
    own movement under a one-ulp input change, the largest parameter's
    within 1e-4 + 5x the largest such movement of a parameter."""
    port, jm, variables = _pair(model_type, **NARROW)
    x = _rand(5, 2, 48, 64, 3)
    shapes = [o.shape for o in jm.apply(variables, x)]
    cots = [_rand(10 + i, *s) for i, s in enumerate(shapes)]
    ref = ResNet(model_type, **ARCHS[model_type], **NARROW)
    grad_fn = _jax_grad_fn(jm, variables, cots, train)

    def jax_grads(x):
        gp, gx = grad_fn(x)
        load_jax_variables(ref, {"params": gp,
                                 "batch_stats": variables["batch_stats"]})
        return (torch.from_numpy(np.array(gx)),
                {n: p.detach().clone() for n, p in ref.named_parameters()})

    want_x, want = jax_grads(x)
    got_x, got = _port_grads(port, x, cots, train)
    assert set(got) == set(want)
    rel = {n: _rel(g, want[n]) for n, g in got.items()}
    if not train:
        assert _rel(got_x, want_x) <= GRAD_RTOL
        worst = max(rel, key=rel.get)
        assert rel[worst] <= GRAD_RTOL, (worst, rel[worst])
        return
    moved_x, moved = jax_grads(_ulp(x))
    floor = {n: _rel(moved[n], want[n]) for n in want}
    limit = lambda f: GRAD_RTOL + FLOOR_FACTOR * f  # noqa: E731
    assert _rel(got_x, want_x) <= limit(_rel(moved_x, want_x))
    assert _rel_all(got, want) <= limit(_rel_all(moved, want))
    assert np.median(list(rel.values())) <= limit(
        np.median(list(floor.values())))
    worst = max(rel, key=rel.get)
    assert rel[worst] <= limit(max(floor.values())), (worst, rel[worst])


def test_remat_gives_the_same_gradients_and_statistics():
    """``remat`` recomputes each block in the backward: the gradients and
    the running statistics (updated once) are those without it."""
    x = _rand(6, 2, 48, 64, 3)
    results = []
    for remat in (False, True):
        port, _, _ = _pair("resnet50_v1c", remat=remat, **NARROW)
        shapes = [o.shape for o in port.eval()(torch.from_numpy(x))]
        cots = [_rand(20 + i, *s) for i, s in enumerate(shapes)]
        gx, grads = _port_grads(port, x, cots)
        results.append((gx, grads, _stats(port)))
    (gx0, g0, s0), (gx1, g1, s1) = results
    torch.testing.assert_close(gx1, gx0, rtol=1e-6, atol=1e-7)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7,
                                   msg=name)
    for key in s0:
        torch.testing.assert_close(s1[key], s0[key], rtol=0, atol=0,
                                   msg=key)


@pytest.mark.parametrize("train", [False, True])
def test_resnet101_narrow_matches_jax(train):
    """resnet101_v1c at stem and base width 8 on 33^2: the 23-block
    dilated stage."""
    port, jm, variables = _pair("resnet101_v1c", stem_channels=8,
                                base_channels=8, strides=(1, 2, 1, 1),
                                dilations=(1, 1, 2, 4))
    assert len(port.layer3) == 23
    x = _rand(7, 2, 33, 33, 3)
    floors = [0.0] * 4
    if train:
        want, _ = jm.apply(variables, x, train=True, mutable=["batch_stats"])
        moved, _ = jm.apply(variables, _ulp(x), train=True,
                            mutable=["batch_stats"])
        floors = [_floor(a, b) for a, b in zip(want, moved)]
    else:
        want = jm.apply(variables, x)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, _nhwc(want))):
        assert_close_rel(g.numpy(), w, REL + FLOOR_FACTOR * floors[i],
                         f"stage {i}")


def test_init_and_names_match_jax():
    """The port's init rules, and its state_dict names the JAX package's
    tree leaf for leaf (the bridge loads it strictly both ways)."""
    port = ResNet("resnet50_v1c", **ARCHS["resnet50_v1c"])
    port.init_weights(torch.Generator().manual_seed(0))
    for name, m in port.named_modules():
        if isinstance(m, TorchConv):
            o, _, kh, kw = m.weight.shape
            std = float(m.weight.detach().std())
            assert abs(std / np.sqrt(2.0 / (kh * kw * o)) - 1) < 0.1, name
        elif isinstance(m, TorchBatchNorm):
            last = name.endswith(".bn3")
            assert torch.all(m.weight == (0.0 if last else 1.0)), name
            assert torch.all(m.bias == 0.0), name
    # the names and shapes: the JAX package's init tree (traced, not run)
    # is the tree of the port's state_dict, leaf for leaf
    jm = JaxResNet(model_type="resnet50_v1c", strides=(1, 2, 1, 1),
                   dilations=(1, 1, 2, 4))
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3), jnp.float32))
    mine = convert_state_dict(port.state_dict())

    def leaves(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat}

    assert leaves(mine) == leaves(dict(init))
    assert port.layer1[0].downsample is not None  # the stride-1 downsample
    assert port.layer3[0].conv2.dilation == (2, 2)
    assert port.layer4[1].conv2.dilation == (4, 4)
