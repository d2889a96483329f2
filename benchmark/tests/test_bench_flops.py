"""The FLOP count is the model's work: the plain reference's count of a
student step equals the port's with remat off, and the port's with remat
on counts more (its recompute), which the count leaves out."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.reference import build

SMALL = {"backbone": "mit_b0", "channels": 32}


def reference_step_flops():
    m = build.segmentor(harness.config("refign_hrda_star"), True, "meta",
                        SMALL)
    x = torch.empty(2, 3, 128, 128, device="meta")
    return flops.count(lambda: flops.backward_of(m.hrda_train(x, (0, 0))[:2]))


def port_step_flops(remat):
    from refign_tpu_torch.models.heads.daformer import DAFormerHead
    from refign_tpu_torch.models.heads.segformer import SegFormerHead
    from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
    from refign_tpu_torch.models.segmentor import Segmentor
    bb = MixVisionTransformer("mit_b0", drop_path_rate=0.0, remat=remat)
    dims = bb.embed_dims
    m = Segmentor(bb, DAFormerHead(19, dims, channels=32, embed_dims=32,
                                   dropout_ratio=0.0),
                  SegFormerHead(19, dims, channels=32, dropout_ratio=0.0))
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.randn(2, 128, 128, 3)
    with FlopCounterMode(display=False) as fc:
        flops.backward_of(m.hrda_train(x, (0, 0))[:2])
    return float(fc.get_total_flops())


def test_reference_counts_the_ports_work_without_recompute():
    ref = reference_step_flops()
    assert ref == port_step_flops(False) > 0
    assert port_step_flops(True) > ref


def test_cell_counts():
    from benchmark.tests.conftest import cpu_context
    from benchmark.drivers import align_step, slide_infer, uda_step
    uda = uda_step.flops(cpu_context("hrda_star.uda_step"))
    assert uda["align"] > uda["ref_as_target"] > 0
    assert align_step.flops(cpu_context("uawarpc_s1.train_step"))["step"] > 0
    assert slide_infer.flops(cpu_context("hrda_star.slide_1080p"))["frame"] > 0
