"""The port's data-parallel building blocks (``refign_tpu_torch/
parallel/mesh.py`` and its users) on gloo ranks on the CPU, against one
process on the global batch and against the JAX package.

One group of 2 ranks and one of 4 run every case (``tests/
torch_dist_ranks.py:layers_case``): sync-BN's output, running statistics
and input and parameter gradients (and the same behind a conv under
``remat_call``, which must reduce once in the forward and once in the
backward); ``gather_rows`` and the evaluation row spread, exact; the IoU
confusion matrix of predictions whose rows were spread over the ranks,
exact on every rank and equal to JAX's ``iou_update`` on the 8-device
mesh; SparseEPE's accumulators summed over
the ranks (the counts exact); DACS (the confident share, the ClassMix
masks from the classes present on every rank); the feature distance's and
the flow loss's masked means; DropPath's and Dropout2d's masks, the
global batch's draws sliced per rank.

Tolerances (fp32): 1e-6 relative where the ranks' sums take another order
than one process's (sync-BN's statistics, the masked means, the confident
share); exact where the values are integers or a single process's rows;
sync-BN against JAX's ``TorchBatchNorm`` at the BN tolerance of
``tests/test_torch_train_layers.py`` (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import torch_dist_ranks as R
from refign_tpu.alignment.losses import _masked_mean as jax_masked_mean
from refign_tpu.metrics import iou_init as jax_iou_init
from refign_tpu.metrics import iou_update as jax_iou_update
from refign_tpu.nn.layers import TorchBatchNorm as JaxBN
from refign_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from refign_tpu.uda import dacs as jax_dacs
from refign_tpu.uda.refine import masked_feat_dist as jax_masked_feat_dist
from refign_tpu_torch.metrics import iou_init, iou_update
from test_torch_uda import _jax_dacs_draws

REL = 1e-6
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def dacs_draws():
    return _jax_dacs_draws(jax.random.PRNGKey(3), 4, 0.2, True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, dacs_draws):
    return {w: R.spawn(R.layers_case, w,
                       str(tmp_path_factory.mktemp(f"layers{w}")),
                       dacs_draws) for w in WORLDS}


def _cat(outs, *keys):
    def get(o):
        for k in keys:
            o = o[k]
        return o
    return torch.cat([get(o) for o in outs])


def _close(got, want, rel=REL, what="", scale=None):
    """max |got - want| within ``rel`` of ``scale`` (default: want's
    largest |value|)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if scale is None:
        scale = want.abs().max().clamp_min(1e-30)
    err = float((got - want).abs().max() / scale)
    assert err <= rel, f"{what}: {err:.3g} > {rel}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("remat", [False, True])
def test_sync_bn_matches_one_process(ranks, world, remat):
    outs = ranks[world]
    key = "bn_remat" if remat else "bn"
    single = R.bn_run(None, None, remat=remat)
    _close(_cat(outs, key, "y"), single["y"], what="output")
    # each rank's input gradient is that of the sum of the ranks' losses
    _close(_cat(outs, key, "dx") / world, single["dx"], what="dx")
    for o in outs:
        for k in ("mean", "var"):
            _close(o[key][k], single[k], what=k)
        # parameter gradients against the module's largest: the conv bias
        # before the BN has a zero gradient in exact arithmetic
        grads = [k for k in single if k.startswith("d") and k != "dx"]
        scale = max(float(single[k].abs().max()) for k in grads)
        for k in grads:
            _close(o[key][k], single[k], what=k, scale=scale)


@pytest.mark.parametrize("world", WORLDS)
def test_remat_reduces_once_each_way(ranks, world):
    # forward statistics, their gradients in the backward, and one bucket
    # of parameter gradients; the recompute replays the statistics
    assert all(o["bn_remat_collectives"] == 3 for o in ranks[world])


@pytest.mark.parametrize("world", WORLDS)
def test_sync_bn_matches_jax_on_the_global_batch(ranks, world):
    x, w, b, lw = R.bn_inputs()
    bn = JaxBN()
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.zeros(7), "var": jnp.ones(7)}}
    y, mut = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                      mutable=["batch_stats"])
    outs = ranks[world]
    np.testing.assert_allclose(_cat(outs, "bn", "y").numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for o in outs:
        np.testing.assert_allclose(o["bn"]["mean"].numpy(),
                                   np.asarray(mut["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["bn"]["var"].numpy(),
                                   np.asarray(mut["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_rows_and_row_spread_are_exact(ranks, world):
    g = torch.arange(24, dtype=torch.float32).reshape(8, 3) * 1.1
    z = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    for o in ranks[world]:
        assert torch.equal(o["gather_f"], g)
        assert torch.equal(o["gather_i"], torch.arange(8) * 7)
        assert torch.equal(o["spread5"], z * 2 + 1)
        assert torch.equal(o["spread3"], z[:3] * 2 + 1)


@pytest.mark.parametrize("world", WORLDS)
def test_confusion_matrix_of_spread_rows_is_exact_and_equals_jax_mesh(
        ranks, world):
    logits, labels = R.iou_inputs()
    single = iou_update(iou_init(19), torch.from_numpy(logits),
                        torch.from_numpy(labels))
    mesh = make_mesh()
    assert len(mesh.devices) == 8
    sharded = shard_batch(mesh, {"logits": logits, "labels": labels})
    want = jax.jit(lambda cm, lg, y: jax_iou_update(cm, lg, y))(
        replicate(mesh, jax_iou_init(19)), sharded["logits"],
        sharded["labels"])
    np.testing.assert_array_equal(single.numpy(), np.asarray(want))
    for o in ranks[world]:
        assert torch.equal(o["confmat"], single)


@pytest.mark.parametrize("world", WORLDS)
def test_sparse_epe_sums_over_ranks(ranks, world):
    single = R.epe_run(slice(None))._packed()
    local = [o["epe_local"] for o in ranks[world]]
    for o in ranks[world]:
        got = o["epe"]
        # the accumulators are a plain sum of the ranks'; the counts are
        # the single process's exactly (PCK counts, valid
        # correspondences, samples)
        np.testing.assert_allclose(got, np.sum(local, axis=0), rtol=1e-15)
        assert got[1:7] == single[1:7]
        np.testing.assert_allclose(got, single, rtol=1e-12)
    assert single[6] == 8 and single[5] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_dacs_mix_global_statistics(ranks, world, dacs_draws):
    single = R.dacs_run(dacs_draws, None)
    outs = ranks[world]
    for k in ("masks", "lbl"):
        assert torch.equal(_cat(outs, "dacs", k), single[k]), k
    for k in ("img", "weight"):
        _close(_cat(outs, "dacs", k), single[k], what=k)
    # against JAX's ClassMix and DACS on the global batch with the same
    # draws: the classes present are every rank's (class 7 only on the
    # last half)
    img_t, img_s, logits, gt = R.dacs_inputs()
    rng = jax.random.PRNGKey(3)
    k_masks = jax.random.split(rng, 4)[2]
    want_masks = jax_dacs.get_class_masks(k_masks, jnp.asarray(gt))
    np.testing.assert_array_equal(_cat(outs, "dacs", "masks").numpy(),
                                  np.asarray(want_masks))
    want = jax_dacs.dacs_mix(rng, jnp.asarray(img_t),
                             jax.nn.softmax(jnp.asarray(logits), -1),
                             jnp.asarray(img_s), jnp.asarray(gt),
                             pseudo_label_threshold=0.6, color_jitter_p=0.0)
    np.testing.assert_array_equal(_cat(outs, "dacs", "lbl").numpy(),
                                  np.asarray(want[1]))
    np.testing.assert_allclose(_cat(outs, "dacs", "weight").numpy(),
                               np.asarray(want[2]), rtol=1e-6)
    np.testing.assert_allclose(_cat(outs, "dacs", "img").numpy(),
                               np.asarray(want[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_masked_means_over_ranks(ranks, world):
    single = R.masked_means_run(None)
    f1, f2, mask, flow = R.fdist_inputs()
    want = {"fdist": jax_masked_feat_dist(jnp.asarray(f1), jnp.asarray(f2),
                                          jnp.asarray(mask)),
            "flow": jax_masked_mean(jnp.abs(jnp.asarray(flow)).sum(-1),
                                    jnp.asarray(mask)),
            "empty": 0.0}
    outs = ranks[world]
    for k in single:
        # the mean over the ranks of each rank's share
        got = torch.stack([o["masked"][k] for o in outs]).mean()
        _close(got, single[k], what=k)
        np.testing.assert_allclose(float(got), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("blocks", [1, 2])
def test_dropout_draws_the_global_batch(ranks, world, blocks):
    single = R.drop_run(None, blocks)
    outs = ranks[world]
    for k in ("drop_path", "dropout2d"):
        got = torch.cat([o[f"drop{blocks}"][k].reshape(
            blocks, 8 // world, 3, 3, 16) for o in outs], dim=1)
        assert torch.equal(got.reshape(-1, 3, 3, 16), single[k]), k
        assert (single[k] == 0).any() and (single[k] != 0).any()
