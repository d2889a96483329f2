"""The port's spans and host-sync counter (``refign_tpu_torch/utils/
profiling.py``) against the card's own clock and its synchronizations.

Marked ``cuda``: every test skips without a CUDA device.  On a machine with
one (the H100):

    python -m pytest tests/test_torch_profiling_cuda.py -q

* a ``torch.cuda._sleep`` kernel launched inside a span and synchronized
  inside it lies within the span on the profiler's clock, within 0.2 ms at
  each end (the span is the kernel's launch and its wait, so an offset
  between the host's and the card's clocks of more than 0.2 ms plus the
  launch latency or the wait's return pushes the kernel out of one end);
* one pageable host-to-device copy inside a span counts exactly one sync,
  under that span; outside the recorder nothing is counted and the
  sync-debug mode is what it was.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from refign_tpu_torch.utils.profiling import Recorder, span

pytestmark = pytest.mark.cuda

SLACK_NS = 200_000
SLEEP_CYCLES = 2_000_000          # about 1 ms at the H100's clocks


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python -m pytest "
                    "tests/test_torch_profiling_cuda.py)")
    torch.cuda._sleep(SLEEP_CYCLES)
    torch.cuda.synchronize()
    return torch.device("cuda", 0)


def test_spans_and_device_events_share_one_clock(card):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with Recorder() as rec:
            for _ in range(5):
                with span("sleep"):
                    torch.cuda._sleep(SLEEP_CYCLES)
                    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda)
    # the recorder launches nothing of its own
    assert len(kernels) == len(rec.spans) == 5
    # (kernel start - span start, span end - kernel end), ns
    slack = [(a - s.start_ns, s.end_ns - b)
             for (a, b), s in zip(kernels, rec.spans)]
    print("sleep kernels within their spans, ns:", slack)
    for (a, b), (lead, tail) in zip(kernels, slack):
        assert b - a > 500_000, (a, b)
        assert lead >= -SLACK_NS and tail >= -SLACK_NS, slack


def test_one_pageable_copy_counts_one_sync_under_its_span(card):
    mode = torch.cuda.get_sync_debug_mode()
    host = torch.arange(1024, dtype=torch.float32)
    with Recorder() as rec:
        with span("outer"):
            with span("copy"):
                x = host.to(card)
            y = x * 2                   # launches, does not block
    assert [m.span for m in rec.syncs] == [1]
    inner = rec.spans[1]
    assert inner.start_ns <= rec.syncs[0].t_ns <= inner.end_ns
    assert torch.cuda.get_sync_debug_mode() == mode
    host.to(card)
    assert len(rec.syncs) == 1
    assert float(y[3]) == 6.0
