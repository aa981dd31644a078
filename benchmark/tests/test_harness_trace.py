"""The traced window on the card: device operations come back from the
profiler, their union fits inside the window, and the marker ties the
device clock to the host's. Needs a CUDA device; decided in the fixture."""

import pytest

from benchmark import trace


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tracer_reads_device_operations(cuda_device):
    import time

    import torch

    x = torch.randn(2048, 2048, device=cuda_device)
    with trace.Tracer(cuda_device) as tr:
        t = time.perf_counter_ns()
        for _ in range(20):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize(cuda_device)
        u = time.perf_counter_ns()
    assert len(tr.ops) >= 40
    busy = trace.busy_s(tr.ops)
    assert 0 < busy <= tr.window_s
    first = min(o.start_ns for o in tr.ops[1:]) - tr.offset_ns
    assert t - 1_000_000 <= first <= u
    assert trace.top_ops(tr.ops)[0][1] > 0
