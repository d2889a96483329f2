"""The frozen roofline arithmetic gives the repository's kernel-table
bounds: K1 0.957 ms and K2 3.19 ms a 1080x1920 forward (30 rows of 540^2,
MiT-B5's 52 blocks), K3 0.0774 ms fused bf16 at the align shapes."""
from benchmark import harness, roofline


def per_frame_ms(kernel):
    w = harness.workload("hrda_star.slide_1080p")
    return 1e3 * sum(c["calls"] * roofline.bound_s(c)
                     for c in w["kernel_calls"]["frame"]
                     if c["kernel"] == kernel)


def test_k1_k2_per_1080p_forward():
    assert round(per_frame_ms("K1"), 3) == 0.957
    assert round(per_frame_ms("K2"), 2) == 3.19


def test_k3_fused_bf16_at_the_align_shapes():
    w = harness.workload("hrda_star.uda_step")
    ms = 1e3 * sum(c["calls"] * roofline.bound_s(c)
                   for c in w["kernel_calls"]["align"] if c["kernel"] == "K3")
    assert round(ms, 4) == 0.0774


def test_bound_is_the_larger_of_bytes_and_operations():
    # fp32 products are CUDA-core work at 67 TFLOP/s
    t = roofline.k1((1, 4096, 4096, 8), 4)
    assert t == 4.0 * 8 * 4096 * 4096 * 64 / roofline.FP32_FLOPS
