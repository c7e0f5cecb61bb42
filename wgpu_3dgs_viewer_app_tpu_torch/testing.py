"""Comparisons shared by the CPU tests and the card tests: front-end entries
against entries, sorted entries against sorted entries, per-splat
preprocess outputs against preprocess outputs (within a tolerance, or bit
for bit).

Entry tolerance (front-end vs front-end, slot for slot). Two front-ends fed
the same pod may round a transcendental (log, exp, rsqrt) an ulp apart, so:
at least `min_identical` (99.9%) of the slots that are live in either must
be bit-identical, and every other such slot must be live in both, in the
same tile and with the same model rank, with each quantised field within
one step: log-depth and alpha byte of the key, u12 means and blue byte of
p1, f16 conic bit patterns of p2/p3 and the red and green bytes.
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


def _fields(e: np.ndarray, depth_bits: int) -> list:
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
    Returns stats; raises AssertionError when out of tolerance. `cfg` is the
    config both were made under (the merged one for ranked entries): tile
    and model rank are compared together, as the key bits above the depth."""
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
    rank_shift = cfg.v2_depth_bits + 8
    near = both & ((da[:, 0] >> rank_shift) == (db[:, 0] >> rank_shift))
    max_step = 0
    for fa, fb in zip(_fields(da, cfg.v2_depth_bits), _fields(db, cfg.v2_depth_bits)):
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


def compare_sorted(a, b, stable: bool = False) -> dict:
    """Check two SortedEntries: equal live counts and tile ranges, sorted
    keys bit-equal, and equal (key, p1, p2, p3) multisets (tie order free).
    With `stable`, the live prefixes must be equal row for row: two stable
    sorts of the same slots keep equal keys in slot order, so every payload
    word sits in the same row (the bar K2 meets against its plain version)."""
    _require(a.n_valid == b.n_valid, f"live counts differ: {a.n_valid} vs {b.n_valid}")
    ea, eb = _u32(a.live()), _u32(b.live())
    _require(np.array_equal(ea[:, 0], eb[:, 0]), "sorted keys differ")
    _require((np.diff(ea[:, 0]) >= 0).all(), "keys not ascending")
    _require((ea[:, 0] != SENTINEL).all(), "sentinel inside the live prefix")
    if stable:
        rows = np.flatnonzero((ea != eb).any(axis=1))
        _require(rows.size == 0, f"{rows.size} rows differ (ties out of slot order), first at "
                                 f"row {rows[:1].tolist()}")
    else:
        order_a = np.lexsort(ea.T[::-1])
        order_b = np.lexsort(eb.T[::-1])
        _require(np.array_equal(ea[order_a], eb[order_b]), "per-key payload multisets differ")
    for name in ("tile_starts", "tile_counts"):
        va, vb = (np.asarray(getattr(x, name).cpu()) for x in (a, b))
        _require(np.array_equal(va, vb), f"{name} differ")
    return {"n_valid": a.n_valid}


PRE_FIELDS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "col_r", "col_g", "col_b",
              "alpha", "depth", "radius")


def compare_preprocess(a, b, min_valid_equal: float = 0.999, rtol: float = 1e-6,
                       atol: float = 1e-6) -> dict:
    """Check two PreprocessOut splat for splat: `valid` equal on at least
    `min_valid_equal` of the splats, and every field within rtol/atol where
    both are valid (a kernel and its plain version on the card are expected
    to agree to the bit; the tolerance allows an ulp of a transcendental).
    Returns stats, with the largest absolute field difference and the share
    of bit-identical values; raises AssertionError when out of tolerance."""
    va, vb = (np.asarray(x.valid.detach().cpu()) for x in (a, b))
    _require(va.shape == vb.shape, f"shapes differ: {va.shape} vs {vb.shape}")
    both = va & vb
    same_valid = float((va == vb).mean()) if va.size else 1.0
    max_err, identical, worst = 0.0, 0, ""
    for f in PRE_FIELDS:
        x = np.asarray(getattr(a, f).detach().cpu())[both]
        y = np.asarray(getattr(b, f).detach().cpu())[both]
        d = np.abs(x.astype(np.float64) - y)
        identical += int((x.view(np.uint32) == y.view(np.uint32)).sum())
        bad = d > atol + rtol * np.abs(y)
        if d.size and float(d.max()) > max_err:
            max_err = float(d.max())
        if bad.any():
            worst = f"{f}: {int(bad.sum())} values out of tolerance, max abs {float(d.max())}"
    stats = {"splats": int(va.size), "valid": int(both.sum()), "valid_equal": same_valid,
             "identical": identical / max(both.sum() * len(PRE_FIELDS), 1),
             "max_abs_err": max_err}
    _require(same_valid >= min_valid_equal, f"validity differs on too many splats: {stats}")
    _require(not worst, f"{worst}: {stats}")
    return stats


def compare_preprocess_bits(a, b) -> dict:
    """Check two PreprocessOut bit for bit on every splat, valid or not:
    each of the 11 f32 fields as its bit pattern, and `valid`. Returns
    {"splats", "valid"}; raises AssertionError naming the count of
    differing splats of each field that differs."""
    va, vb = (np.asarray(x.valid.detach().cpu()) for x in (a, b))
    _require(va.shape == vb.shape, f"shapes differ: {va.shape} vs {vb.shape}")
    differ = {"valid": int((va != vb).sum())}
    for f in PRE_FIELDS:
        x, y = (np.ascontiguousarray(getattr(p, f).detach().cpu().numpy()).view(np.uint32)
                for p in (a, b))
        _require(x.shape == y.shape, f"{f}: shapes differ: {x.shape} vs {y.shape}")
        differ[f] = int((x != y).sum())
    bad = {k: v for k, v in differ.items() if v}
    _require(not bad, f"splats that differ, by field, of {va.size}: {bad}")
    return {"splats": int(va.size), "valid": int(va.sum())}
