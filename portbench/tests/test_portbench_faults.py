"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the port runs its plain versions on
the CPU at a toy size) and the rest of a run is driven as on the card, with
each fault a cell can have planted in the port: a frame that leaves its
state unchanged (the last image returned again), half of the splats left
out of the front-end, an answer altered where it is produced (a tile of
the composited frame, mask bits, the served file). A sound run of each
cell comes out correct. (No cell spans chips, so no exchange can be left
out.)"""

import pytest
import torch

import _portbench_toy as toy
from wgpu_3dgs_viewer_app_tpu_torch.viewer import viewer as viewer_mod

CELLS = ["inria6m.orbit", "multi3x1m.orbit", "inria6m.edit", "inria6m.served"]


def _run(name, **traffic):
    cell = toy.toy_cell(name, gesture_every=3, **traffic)
    return toy.run_toy(cell, seconds=0.6)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["device"]["platform"] == "cpu"


def _stale(monkeypatch):
    cls = viewer_mod.MultiModelViewer
    render = cls.render
    kept = {}

    def stale(self, *a, **kw):
        img = render(self, *a, **kw)
        return kept.setdefault("img", img).clone()
    monkeypatch.setattr(cls, "render", stale)


def _half_splats(monkeypatch):
    fused = viewer_mod.enumerate_entries_fused

    def half(pod, comp, cfg, *a, **kw):
        out = fused(pod, comp, cfg, *a, **kw)
        n = pod["color0"].shape[-1]
        rows = out[(n // 2) * cfg.max_dup: n * cfg.max_dup]
        rows[:, 0] = -1          # SENTINEL: a dead slot
        rows[:, 1:] = 0
        return out
    monkeypatch.setattr(viewer_mod, "enumerate_entries_fused", half)


def _altered_pixels(monkeypatch):
    composite = viewer_mod.composite_tiles_v2

    def altered(*a, **kw):
        img = composite(*a, **kw).clone()
        img[32:64, 32:64, :3] += 0.1     # one 32-px tile of K3's output
        return img
    monkeypatch.setattr(viewer_mod, "composite_tiles_v2", altered)


FAULTS = {"state_unchanged": _stale, "half_the_splats": _half_splats,
          "answer_altered": _altered_pixels}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_altered_mask_bits_are_not_correct(monkeypatch):
    from wgpu_3dgs_viewer_app_tpu_torch.mask import evaluate

    ev = evaluate.MaskEvaluator.evaluate

    def flipped(self, *a, **kw):
        bits = ev(self, *a, **kw).clone()
        bits[:5] ^= 1
        return bits
    monkeypatch.setattr(evaluate.MaskEvaluator, "evaluate", flipped)
    res = _run("inria6m.edit")
    assert not res["correct"] and res["checks"]["mask_bits_differ"]["value"] > 0


def test_altered_served_file_is_not_correct(monkeypatch):
    import wgpu_3dgs_viewer_app_tpu_torch.app.server as server_mod

    encode = server_mod.encode_frame

    def altered(img, *a, **kw):
        img = img.clone()
        img[100:132, 100:132] = torch.clamp(img[100:132, 100:132] + 0.2, 0, 1)
        return encode(img, *a, **kw)
    monkeypatch.setattr(server_mod, "encode_frame", altered)
    res = _run("inria6m.served")
    assert not res["correct"], res["checks"]


def test_a_few_hundred_altered_pixels_are_not_correct():
    """At a cell's own size the 99.99th percentile leaves out ~620 channel
    values, so a fault confined to a few hundred pixels (one mis-projected
    splat) passes it; the count of gaps over 0.1 fails it."""
    from harness import check, spec

    want = torch.zeros(1080, 1920, 3)
    got = want.clone()
    got[500:510, 900:920] += 0.3          # 200 pixels, 600 channel values
    numbers = {}
    mx, tail, mean, wide = check.image_gaps(got, want)
    numbers.update({"img_gap_p9999": tail, "img_mean_abs": mean, "img_gaps_over_0.1": wide})
    limits = spec.load_json(spec.HERE / "limits" / "inria6m.orbit.json")
    assert tail <= limits["img_gap_p9999"] and mean <= limits["img_mean_abs"]
    ok, _ = check.verdict(numbers, {k: limits[k] for k in numbers})
    assert wide == 600 and not ok
