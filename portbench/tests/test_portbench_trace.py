"""The device trace's reduction: busy time as the union of device
intervals, idle gaps named by the host's operations, kernel names mapped
to stages by `stages.json`."""

import _portbench_toy as toy  # noqa: F401  (puts the benchmark on sys.path)
from harness import trace


def test_union_and_gaps():
    busy, gaps = trace._union([(10, 15), (0, 5), (3, 8), (20, 21)])
    assert busy == (8 + 5 + 1) * 1e-6
    assert gaps == [(8, 10), (15, 20)]


def test_gap_names():
    cpu = [("aten::item", 0, 10), ("cudaLaunchKernel", 12, 13), ("aten::mul", 20, 30),
           ("aten::_local_scalar_dense", 2, 6)]
    assert trace._host_op(cpu, 3, 5) == "aten::_local_scalar_dense"
    assert trace._host_op(cpu, 14, 18) == "host between cudaLaunchKernel and aten::mul"
    assert trace._host_op([], 1, 2) == "host between start and end"


def test_stage_map():
    stages = trace.stage_map()
    assert trace.stage_of("void fused_frontend_kernel<3>(...)", stages) == "k1_frontend"
    for k in ("upfront_kernel", "onesweep_pass_kernel", "tile_edges_kernel"):
        assert trace.stage_of(k, stages) == "k2_sort"
    assert trace.stage_of("composite_v2_kernel", stages) == "k3_composite"
    assert trace.stage_of("at::native::elementwise_kernel", stages) is None
