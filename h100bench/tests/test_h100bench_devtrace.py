"""How a traced stretch is read: the union of device intervals, the idle
gaps, and each kernel's layer from the host events open around its launch
(never from its name)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from h100bench import devtrace  # noqa: E402
from h100bench.devtrace import HostEvent, Kernel  # noqa: E402


def test_union_counts_overlaps_once():
    assert devtrace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25


def test_gaps_outside_the_union():
    assert devtrace.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]


def _launch(name, start, corr, thread=1):
    return HostEvent(name, start, start + 1, thread, corr=corr)


def test_classify_by_launch_not_by_kernel_name():
    host = [
        # a convolution and a GroupNorm span with its forward operation
        HostEvent("aten::convolution", 0, 100, 1),
        _launch("cudaLaunchKernel", 10, corr=1),
        HostEvent("h100bench::groupnorm", 200, 300, 1),
        HostEvent("aten::native_group_norm", 210, 290, 1, seq=7),
        _launch("cudaLaunchKernel", 220, corr=2),
        # its backward on the autograd thread, matched by sequence number
        HostEvent("autograd::engine::evaluate_function: X", 400, 500, 2,
                  seq=7, fwd_thread=1, backward=True),
        _launch("cudaLaunchKernel", 410, corr=3, thread=2),
        # a convolution's backward, and something else
        HostEvent("aten::convolution_backward", 600, 700, 2),
        _launch("cudaLaunchKernel", 610, corr=4, thread=2),
        _launch("cudaLaunchKernel", 800, corr=5),
    ]
    dev = [Kernel("gemm_that_looks_like_a_norm", 1000, 3000, 1),
           Kernel("conv_named_kernel", 3000, 4000, 2),
           Kernel("k", 4000, 4500, 3),
           Kernel("k", 4500, 5500, 4),
           Kernel("k", 5500, 6000, 5)]
    out = devtrace.classify(host, dev)
    assert out == {"conv": 3000 / 1e9, "groupnorm": 1500 / 1e9,
                   "other": 500 / 1e9}


def test_kernel_linked_to_an_operation_without_its_launch():
    host = [HostEvent("h100bench::haar", 0, 50, 1, corr=9)]
    dev = [Kernel("anything", 100, 104, corr=0, link=9)]
    assert devtrace.classify(host, dev) == {"haar": 4 / 1e9}


def test_idle_gaps_named_by_the_main_threads_innermost_event():
    host = [HostEvent("Optimizer.step", 0, 100, 1),
            HostEvent("aten::item", 40, 60, 1),
            HostEvent("other", 0, 100, 2)]
    out = devtrace.idle_by_host(host, [(45, 55), (150, 160)])
    assert out == [["aten::item", 10 / 1e9], ["python", 10 / 1e9]]
