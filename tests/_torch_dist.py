"""Ranks of the sharded-renderer tests (`test_torch_parallel.py`).

`spawn_ranks` starts `world` processes (spawn) that join one gloo group
through a file in the test's temporary directory (no TCP port, so parallel
test workers cannot collide). Each runs `run_rank` on the scene the test
wrote (`scene.pkl`) and saves what it rendered to `rank<r>.npz`. This
module imports torch and the port only: each rank starts from a fresh
import.
"""

import datetime
import os
import pickle
import time

import numpy as np

# A rank that waits longer than this in a collective fails instead of hanging.
COLLECTIVE_TIMEOUT_S = 120


def _send_matrix(pod, mesh, comp, cfg, view, proj, sh_degree):
    """(world, world) entries each rank sends each slab owner, counted from
    the sorted keys' tile field (not by the module's routing code), and
    each rank's receive capacity at capacity_factor 0.05."""
    import torch
    import torch.distributed as dist

    from wgpu_3dgs_viewer_app_tpu_torch.core.f16 import u32
    from wgpu_3dgs_viewer_app_tpu_torch.ops import (enumerate_entries_from_pre, preprocess,
                                                    sort_entries)
    from wgpu_3dgs_viewer_app_tpu_torch.parallel import slab_config

    pre = preprocess(pod, comp, view, proj, np.eye(4, dtype=np.float32), cfg.width, cfg.height,
                     sh_degree=sh_degree)
    entries = enumerate_entries_from_pre(pre, cfg)
    se = sort_entries(entries, cfg)
    slab_cfg, _, _ = slab_config(cfg, mesh.world)
    owner = (u32(se.entries[:, 0]) >> cfg._tile_shift) // (slab_cfg.tiles_y * cfg.tiles_x)
    row = torch.cat([torch.bincount(owner, minlength=mesh.world),
                     torch.tensor([-(-int(0.05 * entries.shape[0]) // 128) * 128])])
    rows = [torch.empty_like(row) for _ in range(mesh.world)]
    dist.all_gather(rows, row)
    return torch.stack(rows).numpy()


def run_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with open(os.path.join(out_dir, "scene.pkl"), "rb") as f:
        scene = pickle.load(f)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        from wgpu_3dgs_viewer_app_tpu_torch.app.server import _sharded_stats
        from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions
        from wgpu_3dgs_viewer_app_tpu_torch.ops import TileConfig
        from wgpu_3dgs_viewer_app_tpu_torch.parallel import (make_mesh, render_frame_sharded_multi,
                                                             render_sharded, shard_pod)
        from wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded import last_stats

        comp = Compressions()
        mesh = make_mesh()
        assert (mesh.rank, mesh.world, mesh.device.type) == (rank, world, "cpu")
        cfg = TileConfig(64, 64, tile=16, max_dup=8)
        view, proj = scene["view"], scene["proj"]
        pod = shard_pod(scene["pod"], mesh)
        out = {"shard": np.asarray([pod["color0"].shape[-1]])}

        img, st = render_sharded(pod, mesh, comp, cfg, view, proj, sh_degree=3, return_stats=True)
        out["frame"], out["frame_overflow"] = img.numpy(), st["overflow"]
        dmesh = make_mesh(init_device_mesh("cpu", (world,), mesh_dim_names=("splats",)))
        assert (dmesh.rank, dmesh.world, dmesh.device.type) == (rank, world, "cpu")
        out["frame_device_mesh"] = render_sharded(shard_pod(scene["pod"], dmesh), dmesh, comp,
                                                  cfg, view, proj, sh_degree=3).numpy()

        cfg48 = TileConfig(64, 48, tile=16, max_dup=8)
        out["nondiv"] = render_sharded(pod, mesh, comp, cfg48, view, scene["proj48"],
                                       sh_degree=3).numpy()

        pods = (shard_pod(scene["pod_a"], mesh), shard_pod(scene["pod_b"], mesh))
        img, overflow = render_frame_sharded_multi(pods, mesh, "splats", comp, cfg, view, proj,
                                                   scene["models"], scene["ranks"],
                                                   np.zeros(3, np.float32), sh_degree=3)
        out["multi"], out["multi_overflow"] = img[:cfg.height].numpy(), overflow

        img, st = render_sharded(pod, mesh, comp, cfg, view, proj, sh_degree=0,
                                 capacity_factor=0.05, return_stats=True)
        out["small_cap"], out["small_cap_overflow"] = img.numpy(), st["overflow"]
        out["send_matrix"] = _send_matrix(pod, mesh, comp, cfg, view, proj, sh_degree=0)

        _, st = render_sharded(pod, mesh, comp, cfg, view, proj, sh_degree=0, return_stats=True)
        out["default_overflow"] = st["overflow"]
        out["last_stats"] = np.asarray([last_stats()["overflow"], last_stats()["n_devices"]])
        srv = _sharded_stats()
        out["server_stats"] = np.asarray([srv["overflow"], srv["n_devices"]])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, scene: dict, out_dir: str, timeout_s: float = 300.0) -> list:
    """Run `run_rank` on `world` spawned processes; returns each rank's
    results (dicts of numpy arrays). Raises if a rank fails or the ranks
    outlast `timeout_s`."""
    import torch.multiprocessing as mp

    # The scene goes through a file: arguments larger than a pipe's buffer
    # would hold up each start until the rank before has imported torch.
    with open(os.path.join(out_dir, "scene.pkl"), "wb") as f:
        pickle.dump(scene, f)
    ctx = mp.start_processes(run_rank, args=(world, f"file://{out_dir}/rendezvous", out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results
