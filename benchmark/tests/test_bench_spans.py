"""The readers of the program's spans (``metrics/_spans.py`` and the eight
metrics on it): a tiny traced run of each cell on the CPU, and the counting
rules on a hand-made trace with CUDA runtime calls."""

import time

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.run_cell import RunData, run
from benchmark.harness.trace import Interval, Trace
from benchmark.tests._tiny import tiny

torch.set_num_threads(1)
CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]
TIMES = ("env_step_ms", "act_ms", "prepare_ms", "backward_ms", "optimizer_ms")
COUNTS = ("act_launches", "minibatch_launches", "update_syncs")


def _read(name, data):
    return spec.reader(name).read(data)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reads_the_span_times_and_no_count_on_the_cpu(name):
    res = run(tiny(name), 2 ** 31 + 11, 0.05, True, "cpu", time.perf_counter(),
              lambda s: None)
    data = res["data"]
    for m in TIMES:
        value = _read(m, data)
        assert value is not None and value > 0, m
    # the CPU has no CUDA runtime calls to count: nothing, never 0
    for m in COUNTS:
        assert _read(m, data) is None, m
    names = {m["name"] for m in spec.metrics_of(name, True)}
    assert set(TIMES) | set(COUNTS) <= names


def _data(host, window=(0.0, 10.0)):
    return RunData(trace=Trace(window=window, device=[], host=host))


def _iv(name, start, end=None):
    return Interval(name, start, start + 1e-6 if end is None else end)


def test_counts_are_the_runtime_calls_that_start_inside_each_span():
    host = [
        _iv("eavit.update", 1.0, 5.0),
        _iv("eavit.minibatch", 1.0, 2.0), _iv("eavit.minibatch", 2.0, 3.0),
        _iv("eavit.minibatch", 3.0, 4.0),
        _iv("eavit.act", 6.0, 6.5), _iv("eavit.act", 7.0, 7.5), _iv("eavit.act", 8.0, 8.5),
        # launches, one from another thread inside the second minibatch
        _iv("cudaLaunchKernel", 1.1), _iv("cuLaunchKernelEx", 1.2),
        _iv("cudaLaunchKernelExC", 2.5), _iv("cudaLaunchKernel", 2.6),
        _iv("cudaLaunchCooperativeKernel", 2.7),
        _iv("cudaLaunchKernel", 3.5),
        _iv("cudaLaunchKernel", 6.1), _iv("cudaLaunchKernel", 7.1), _iv("cudaLaunchKernel", 7.2),
        _iv("cudaLaunchKernel", 8.1),
        _iv("cudaLaunchKernel", 5.5),  # outside every span
        # one wait inside the update, one outside it; an async copy is no wait
        _iv("cudaStreamSynchronize", 4.5), _iv("cudaMemcpyAsync", 4.6),
        _iv("cudaDeviceSynchronize", 9.0),
        _iv("aten::add", 1.5, 1.6),
    ]
    data = _data(host)
    assert _read("minibatch_launches", data) == 2  # 2, 3 and 1
    assert _read("act_launches", data) == 1  # 1, 2 and 1
    assert _read("update_syncs", data) == 1
    assert _read("act_ms", data) == pytest.approx(500.0)
    assert _read("prepare_ms", data) is None  # no such span


def test_a_count_reads_zero_only_where_the_runtime_was_traced():
    host = [_iv("eavit.update", 1.0, 5.0), _iv("cudaLaunchKernel", 1.5)]
    assert _read("update_syncs", _data(host)) == 0
    assert _read("update_syncs", _data(host[:1])) is None
    assert _read("minibatch_launches", _data(host)) is None


def test_spans_outside_the_window_are_not_read():
    host = [_iv("eavit.backward", 0.5, 0.7), _iv("eavit.backward", 1.0, 1.2),
            _iv("eavit.backward", 9.9, 10.5)]
    assert _read("backward_ms", _data(host, window=(0.9, 10.0))) == pytest.approx(200.0)
    assert _read("env_step_ms", _data(host, window=(0.9, 10.0))) is None
