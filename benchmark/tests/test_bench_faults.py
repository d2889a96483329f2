"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a small
size on the CPU, with each fault the cell can have planted in the port's
call.  One chip, so no exchange between chips to leave out."""
import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.run import run
from benchmark.tests.conftest import SMALL, cpu_context


def uda_frozen(tr, batch, draws):
    """A step that returns its state unchanged: the losses, no update."""
    from refign_tpu_torch.uda.trainer import forward_backward
    return forward_backward(tr, batch, draws)


def uda_half(tr, batch, draws):
    """Half of the batch left out, the mean taken over the rest."""
    from refign_tpu_torch.uda.trainer import train_step
    n = batch["image_trg"].shape[0] // 2
    d = dataclasses.replace(draws, dacs=draws.dacs.rows(slice(0, n)))
    return train_step(tr, {k: v[:n] for k, v in batch.items()}, d)


def align_frozen(tr, batch, draws):
    from refign_tpu_torch.alignment.trainer import forward_backward
    return forward_backward(tr, batch, draws)


def align_half(tr, batch, draws):
    from refign_tpu_torch.alignment.trainer import train_step
    n = batch["image_trg"].shape[0] // 2
    d = dataclasses.replace(draws, prime_trg_idx=draws.prime_trg_idx[:n],
                            photometric=draws.photometric[:n],
                            flows=draws.flows[:n])
    return train_step(tr, {k: v[:n] for k, v in batch.items()}, d)


def infer_altered(model, x, crop, stride):
    """An answer altered where it is produced: two classes' logits
    swapped."""
    from refign_tpu_torch.entry import hrda_slide_forward
    out = hrda_slide_forward(model, x, crop, stride)
    return out[..., [1, 0] + list(range(2, out.shape[-1]))]


def infer_half(model, x, crop, stride):
    """Half of the slide's rows left out: the rest stand in for them."""
    from refign_tpu_torch.models.segmentor import slide_inference

    def whole(rows):
        n = max(1, rows.shape[0] // 2)
        out = model.whole(rows[:n])
        return torch.cat([out] * (rows.shape[0] // n + 1))[:rows.shape[0]]
    with torch.inference_mode():
        return slide_inference(whole, x, crop, stride)


FAULTS = [("hrda_star.uda_step", "step", uda_frozen),
          ("hrda_star.uda_step", "step", uda_half),
          ("uawarpc_s1.train_step", "step", align_frozen),
          ("uawarpc_s1.train_step", "step", align_half),
          ("hrda_star.slide_1080p", "forward", infer_altered),
          ("hrda_star.slide_1080p", "forward", infer_half)]


@pytest.mark.parametrize("cell,where,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_fault_is_not_correct(cell, where, fault):
    ctx = cpu_context(cell, overrides=SMALL[cell], faults={where: fault})
    line = run(ctx, harness.manifest())
    assert not line["correct"], line["checks"]
