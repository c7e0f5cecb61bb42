"""Comparisons shared by the tests and `chip_smoke.py`: front-end entries
against entries, sorted entries against sorted entries.

Entry tolerance (front-end vs front-end, slot for slot). Two front-ends fed
the same pod may round a transcendental (log, exp, rsqrt) an ulp apart, so:
at least `min_identical` (99.9%) of the slots that are live in either must
be bit-identical, and every other such slot must be live in both, in the
same tile, with each quantised field within one step: log-depth and alpha
byte of the key, u12 means and blue byte of p1, f16 conic bit patterns of
p2/p3 and the red and green bytes.
"""

from __future__ import annotations

import numpy as np

SENTINEL = 0xFFFFFFFF


def _require(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def _u32(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32).reshape(-1, 4).astype(np.int64)


def _fields(e: np.ndarray, tile_shift: int, depth_bits: int) -> list:
    key, p1, p2, p3 = e.T
    return [
        (key >> 8) & ((1 << depth_bits) - 1),  # log-depth
        key & 0xFF,                            # alpha8
        p1 & 0xFFF, (p1 >> 12) & 0xFFF,       # mean x, mean y (u12)
        p1 >> 24,                              # b8
        p2 & 0xFFFF, p2 >> 16, p3 & 0xFFFF,    # conic a, b, c (f16 bits)
        (p3 >> 16) & 0xFF, p3 >> 24,           # r8, g8
    ]


def compare_entries(a, b, cfg, min_identical: float = 0.999) -> dict:
    """Check two (N * D, 4) entry arrays slot for slot (tolerance above).
    Returns stats; raises AssertionError when out of tolerance. The model
    field must be 0 (single-model frames)."""
    ea, eb = _u32(a), _u32(b)
    _require(ea.shape == eb.shape, f"shapes differ: {ea.shape} vs {eb.shape}")
    live_a, live_b = ea[:, 0] != SENTINEL, eb[:, 0] != SENTINEL
    either = live_a | live_b
    same = (ea == eb).all(axis=1)
    diff = either & ~same
    n_either = int(either.sum())
    ident = 1.0 - float(diff.sum()) / max(n_either, 1)
    da, db = ea[diff], eb[diff]
    both = (da[:, 0] != SENTINEL) & (db[:, 0] != SENTINEL)
    near = both & ((da[:, 0] >> cfg._tile_shift) == (db[:, 0] >> cfg._tile_shift))
    max_step = 0
    for fa, fb in zip(_fields(da, cfg._tile_shift, cfg.v2_depth_bits),
                      _fields(db, cfg._tile_shift, cfg.v2_depth_bits)):
        step = np.abs(fa - fb)
        near &= step <= 1
        if step.size:
            max_step = max(max_step, int(step[both].max(initial=0)))
    stats = {"live_a": int(live_a.sum()), "live_b": int(live_b.sum()), "compared": n_either,
             "identical": ident, "differing": int(diff.sum()), "far": int((~near).sum()),
             "max_field_step": max_step}
    _require(ident >= min_identical, f"only {ident:.5f} of live slots identical: {stats}")
    _require(stats["far"] == 0, f"{stats['far']} slots differ by more than one step: {stats}")
    return stats


def compare_sorted(a, b) -> dict:
    """Check two SortedEntries: equal live counts and tile ranges, sorted
    keys bit-equal, and equal (key, p1, p2, p3) multisets (tie order free)."""
    _require(a.n_valid == b.n_valid, f"live counts differ: {a.n_valid} vs {b.n_valid}")
    ea, eb = _u32(a.entries)[: a.n_valid], _u32(b.entries)[: b.n_valid]
    _require(np.array_equal(ea[:, 0], eb[:, 0]), "sorted keys differ")
    _require((np.diff(ea[:, 0]) >= 0).all(), "keys not ascending")
    _require((ea[:, 0] != SENTINEL).all(), "sentinel inside the live prefix")
    order_a = np.lexsort(ea.T[::-1])
    order_b = np.lexsort(eb.T[::-1])
    _require(np.array_equal(ea[order_a], eb[order_b]), "per-key payload multisets differ")
    for name in ("tile_starts", "tile_counts"):
        va, vb = (np.asarray(getattr(x, name).cpu()) for x in (a, b))
        _require(np.array_equal(va, vb), f"{name} differ")
    return {"n_valid": a.n_valid}
