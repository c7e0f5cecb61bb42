"""The roofline counts against hand-worked values, and their independence
from the port's slot capacity."""

import copy

import pytest

import _portbench_toy as toy  # noqa: F401  (puts the benchmark on sys.path)
from harness import counts, reference, scene

PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def test_pod_bytes():
    # position 12, colour 4, f16 covariance 12, norm8 SH: 45 bytes + range 8
    assert counts.pod_bytes_per_splat("norm8", "half", 3) == 81
    assert counts.pod_bytes_per_splat("single", "single", 3) == 12 + 4 + 24 + 180
    assert counts.pod_bytes_per_splat("half", "half", 1) == 12 + 4 + 12 + 18
    assert counts.pod_bytes_per_splat("norm8", "half", 0) == 28


def test_hand_worked_frame():
    # 10 splats, 30 live entries, 64 tiles, 1000 blends over 40 entries read,
    # a 16x16 image.
    assert counts.k1(10, 30, 81, 3) == (10 * 81 + 30 * 16, 10 * (230 + 4 * 45) + 40 * 30)
    assert counts.k1(10, 30, 81, 3) == (1290, 5300)
    assert counts.k2(30, 64) == (1472, 1020)
    assert counts.k3(1000, 40, 256) == (4736, 22000)
    s, by = counts.bound_s((4736, 22000), PEAKS)
    assert by == "bytes" and s == pytest.approx(4736 / 3.35e12)
    s, by = counts.bound_s((100, 22000), PEAKS)
    assert by == "operations" and s == pytest.approx(22000 / 67e12)


def test_peaks_file():
    assert counts.peaks()["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks()["f32_ops_per_s"] == 67e12


def _frame_stats(config, models, max_dup):
    c = copy.deepcopy(config)
    c["max_dup"] = max_dup
    st = {}
    reference.Reference(c, models, "cpu").frame(reference.camera_at(c, 0.7), stats=st)
    return st


def test_counts_do_not_depend_on_slot_capacity():
    """The same frame at max_dup 16 and 32: the same live entries (no splat
    of this frame needs more than 16 tiles), so the same bounds, though the
    port's entry buffer doubles."""
    cell = toy.toy_cell("inria6m.orbit", splats=4000, size=128)
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    a = _frame_stats(cell.config, models, 16)
    b = _frame_stats(cell.config, models, 32)
    assert a["live_entries"] == b["live_entries"] > 0
    for key in ("splats", "blends", "entries_read", "n_tiles", "pixels"):
        assert a[key] == b[key]
    pod = counts.pod_bytes_per_splat("norm8", "half", 3)
    for f in (lambda s: counts.k1(s["splats"], s["live_entries"], pod, 3),
              lambda s: counts.k2(s["live_entries"], s["n_tiles"]),
              lambda s: counts.k3(s["blends"], s["entries_read"], s["pixels"])):
        assert counts.bound_s(f(a), PEAKS) == counts.bound_s(f(b), PEAKS)
