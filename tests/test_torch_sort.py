"""Port entry sort (plain version of kernel K2) against the JAX package's
entry sort on its plain path (`sort_entries_interleaved(impl="xla")`, a
`lax.sort`) and the JAX tile edges: live keys exact, per-key payload
multisets equal. The JAX package's own tests hold its Pallas sort chain
(compaction -> block sort -> merge levels) to `lax.sort`:
`tests/test_compact.py::test_merge_sort_with_compact_matches_lax` and
`tests/test_sort.py::test_merge_sort_interpret`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops.sort import sort_entries_interleaved
from wgpu_3dgs_viewer_app_tpu_torch.ops import SENTINEL, SortedEntries, TileConfig
from wgpu_3dgs_viewer_app_tpu_torch.ops import sort_entries, sort_entries_plain
from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_sorted

# 1080p at 16-px tiles: 8160 tiles, 13 tile bits, so every key of a tile
# id >= 4096 has bit 31 set and must sort as unsigned.
CFG = TileConfig(1920, 1080, tile=16, max_dup=4)


def _entries(e, frac_sentinel, seed=0, n_tiles=CFG.n_tiles):
    """(e, 4) u32 entries: keys in real tiles (random depth/alpha bits, many
    duplicate keys), `frac_sentinel` of the slots dead."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, n_tiles, e, dtype=np.uint64)
    low = rng.integers(0, 1 << 10, e, dtype=np.uint64)  # coarse: plenty of key ties
    keys = ((tiles << np.uint64(CFG._tile_shift)) | low).astype(np.uint32)
    keys[rng.random(e) < frac_sentinel] = SENTINEL
    pay = rng.integers(0, 2**32, (e, 3), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([keys[:, None], pay], axis=1)


def _as_tensor(ent, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(ent).view(np.int32)).to(device)


def test_sort_matches_jax_sort():
    """E = 65536 with ~44% sentinels against the JAX package's
    `sort_entries_interleaved(impl="xla")`: the live prefix, its payload
    multisets and the tile edges agree."""
    ent = _entries(65536, 0.44)
    ks, _, s1, s2, s3 = sort_entries_interleaved(*(jnp.asarray(ent[:, i]) for i in range(4)),
                                                 impl="xla")
    ks = np.asarray(ks)
    n_live = int((ent[:, 0] != SENTINEL).sum())
    assert (ks[n_live:] == SENTINEL).all() and (ks[:n_live] != SENTINEL).all()
    edges = np.array(jbin._tile_edges(jnp.asarray(ks), jbin.TileConfig(1920, 1080, tile=16)))
    ref_ent = np.stack([ks, np.asarray(s1), np.asarray(s2), np.asarray(s3)], axis=1)[:n_live]
    ref = SortedEntries(entries=_as_tensor(ref_ent), tile_starts=torch.from_numpy(edges[:-1]),
                        tile_counts=torch.from_numpy(np.diff(edges)), n_valid=int(edges[-1]))
    got = sort_entries(_as_tensor(ent), CFG)
    assert got.n_valid == n_live
    compare_sorted(got, ref)


@pytest.mark.parametrize("e,frac", [(0, 0.0), (1000, 1.0), (1, 0.0), (5000, 0.3)])
def test_sort_plain_edge_cases(e, frac):
    """Empty input, all-sentinel input, one entry, and unsigned key order
    against numpy's stable sort."""
    ent = _entries(e, frac, seed=3)
    got = sort_entries_plain(_as_tensor(ent), CFG)
    live = ent[ent[:, 0] != SENTINEL]
    ref = live[np.argsort(live[:, 0], kind="stable")]
    assert got.n_valid == len(live)
    assert np.array_equal(got.entries.numpy().view(np.uint32).reshape(-1, 4), ref)
    counts = got.tile_counts.numpy()
    assert counts.sum() == len(live) and (counts >= 0).all()
    starts = got.tile_starts.numpy()
    for t in np.unique(ref[:, 0] >> CFG._tile_shift)[:50]:
        run = ref[starts[t]:starts[t] + counts[t], 0] >> CFG._tile_shift
        assert (run == t).all()


def test_compare_sorted_stable_rejects_swapped_tie():
    """`compare_sorted(stable=True)` accepts two stable sorts of the same
    slots and rejects one whose tied entries swapped rows, which the
    multiset check lets through."""
    ent = _as_tensor(_entries(4000, 0.25, seed=5, n_tiles=2))  # ~3000 live on 2048 keys
    a, b = sort_entries_plain(ent, CFG), sort_entries_plain(ent.clone(), CFG)
    compare_sorted(a, b, stable=True)
    keys = a.entries[:, 0]
    tie = int(torch.nonzero(keys[1:] == keys[:-1])[0, 0])
    swapped = a.entries.clone()
    swapped[[tie, tie + 1]] = swapped[[tie + 1, tie]]
    assert not torch.equal(swapped, a.entries)
    c = SortedEntries(entries=swapped, tile_starts=a.tile_starts, tile_counts=a.tile_counts,
                      n_valid=a.n_valid)
    compare_sorted(a, c)
    with pytest.raises(AssertionError, match="rows differ"):
        compare_sorted(a, c, stable=True)
