"""The reader of `viewer.graph_hit_pct` on hand-set counts of the port's
tracing module: the share of frames issued as one graph launch, and None
where the port has no such counter or counted no frame."""

import pytest

import _portbench_toy as toy  # noqa: F401  (puts the benchmark on sys.path)
from harness import spec
from wgpu_3dgs_viewer_app_tpu_torch.utils import trace


def _read():
    return spec.metric_reader("viewer.graph_hit_pct")({"trace": None})


@pytest.mark.parametrize("counts,want", [
    ({"replayed": 18, "captured": 1, "eager": 1}, 95.0),
    ({"replayed": 0, "captured": 0, "eager": 4}, 0.0),
    ({"replayed": 7, "captured": 0, "eager": 0}, 100.0),
    ({"replayed": 0, "captured": 0, "eager": 0}, None)])
def test_graph_hit_share(monkeypatch, counts, want):
    monkeypatch.setattr(trace, "graph_frames", counts)
    assert _read() == (None if want is None else pytest.approx(want))


def test_graph_hit_share_without_the_counter(monkeypatch):
    """A port without the counter (the parent of the change that added it)
    reads None."""
    monkeypatch.delattr(trace, "graph_frames")
    assert _read() is None
