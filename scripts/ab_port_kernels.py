#!/usr/bin/env python3
"""Old against new on one card: the front-end kernels K1 and K5, the
compositors K3 and K6 and the config-1 frame of this tree against those of
another checkout of the port (the parent commit, unpacked with `git
archive` under a git-ignored directory), on the same inputs, timed in turns
(other, this, this, other).

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/ab_port_kernels.py --parent _archive/parent [--parts frontend,frame]

The other checkout's package is imported under another name, so both kernel
libraries are built and loaded in one process. `--parts` picks what runs
(default all):
- frontend: K1 ungated and gated (every gate) on the config-1 scene (6M
  splats), K1 with model rank 1 of model_bits 2 and the model's edits on one
  config-2 model (1M), K5 on the plain preprocess of both (6M at rank 0, 1M
  at rank 2 of model_bits 2), and K4, which shares splat.cuh with K1, on
  the config-3 scene (2M, ungated and with the mask and edit gates). The
  two trees' outputs must be equal bit for bit. Each is timed three ways
  (`card.wrapper_times`): CUDA events around 20 calls of the
  wrapper, the kernel alone under torch.profiler, and the host's time to
  issue a call. Also ptxas's registers and spills of both trees' K1 and K5
  (each tree's fused.cu and enum_pack.cu compiled with this tree's flags).
- compositors: K3 on the config-1 and config-2 sorted entries at tile 32 in
  every mode of `composite_tiles_v2` that differs on the card: transposed
  Horner (the viewer's call), row-major Horner and the quadratic basis
  (`mxu`); K6 on the config-1 EntryPlanes at tiles 32, 64 and 128 and in
  flat mode on the config-0 shapes, and at tile 32 also with each of its
  layouts forced (1 and 4 pixels a thread, this tree only). Each time is
  the mean of 20 calls by CUDA events (`card.cuda_ms`). The two
  trees' images must agree within 1e-4; whether they are equal bit for bit
  is printed.
- cells: K3 on the benchmark's own frames (`scripts/profile_port_frame.py`
  builds them through `portbench/harness`): the `inria6m.orbit` and
  `multi3x1m.orbit` scenes at `--yaws` orbit yaws spread over the circle,
  and the `inria6m.edit` session's gated frame (mask and the warm-up's rect
  selection) at its start yaw, each as the cell's viewer sorts it. The two
  trees' images must be equal bit for bit; each side's K3 device time (the
  sum of its `composite_v2_kernel` launches, under torch.profiler) is taken
  in turns.
- frame: the config-1 frame through each tree's `Viewer.render`, 5 frames
  after 2 warm-ups by the host clock, in turns.
- session: BASELINE config 4 through each tree's `GaussianSplattingSession`
  (the config-1 scene added to the viewer directly, the three mask shapes
  and `(0 | 1) - 2` evaluated, a measurement pair from two hit queries):
  `update()` (5 frames after 2 warm-ups, host clock), `Viewer.render` alone
  and `render_overlays` alone (CUDA events), and a served dirty frame
  (`ViewerServer.frame_jpeg(85)` after an orbit event, no HTTP: 5 after 2
  warm-ups, with its update/device/copy/host split), each in turns. The two
  trees' `update()` frames and JPEG bytes must be equal bit for bit.
Prints one line per comparison, the card's name and power limit, and a JSON
record as the last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = "wgpu_3dgs_viewer_app_tpu_torch"


def load_other(root: str, alias: str = "other_port"):
    """The port package of another checkout, imported as `alias`."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops")


def compare(name: str, other, this, reps: int = 20) -> dict:
    """The two trees' images (within 1e-4, and whether bit for bit equal)
    and their times in turns (other, this, this, other); prints one line."""
    import torch

    a, b = other(), this()
    d = float((a - b).abs().max())
    if d > 1e-4:
        raise AssertionError(f"{name}: this vs other max abs {d} > 1e-4")
    a1, b1, b2, a2 = (card.cuda_ms(f, reps) for f in (other, this, this, other))
    r = {"other_ms": [a1, a2], "this_ms": [b1, b2], "vs_other_max": d,
         "bit_equal": bool(torch.equal(a, b))}
    print(f"{name}: this vs other max abs {d:.3e}, bit for bit {r['bit_equal']}; other "
          f"{r['other_ms']}, this {r['this_ms']} ms", flush=True)
    return r


def k6_layout(ops, planes, cfg, flat: bool, px: int):
    """K6 of this tree with its pixels a thread forced (tiles up to 32 px),
    through the measurement-only launcher `gs_composite_v1_px`."""
    import torch

    ent, k = planes.ent, ops.kernels
    out = torch.empty((cfg.height, cfg.width, 4), dtype=torch.float32, device=ent.device)
    k.check(k.library().gs_composite_v1_px(
        k.ptr(ent), ent.shape[1], k.ptr(planes.row_starts), k.ptr(planes.tile_counts),
        cfg.n_tiles, cfg.tile, cfg.tiles_x, cfg.width, cfg.height, int(flat), px, None,
        k.ptr(out), k.stream()), "gs_composite_v1_px")
    return out


def layouts(ops, name: str, planes, cfg, flat: bool = False) -> dict:
    """K6 at 1 and at 4 pixels a thread, in turns, against its own default."""
    import torch

    auto = ops.composite_tiles(planes, cfg, flat_mode=flat)
    for px in (1, 4):
        if not torch.equal(k6_layout(ops, planes, cfg, flat, px), auto):
            raise AssertionError(f"{name}: K6 at {px} px a thread differs from its default")
    t = [card.cuda_ms(lambda: k6_layout(ops, planes, cfg, flat, px), 20)
         for px in (1, 4, 4, 1)]
    r = {"px1_ms": [t[0], t[3]], "px4_ms": [t[1], t[2]]}
    print(f"{name}: K6 layouts (this tree), 1 px a thread {r['px1_ms']}, 4 px {r['px4_ms']} ms; "
          f"equal images", flush=True)
    return r


def bit_equal(a, b) -> bool:
    """Tensors, or dataclasses of tensors field by field, equal bit for bit."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(a):
        return all(bit_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return bool(torch.equal(a, b))


def entries_ab(name: str, other, this, part: str) -> dict:
    """The two trees' outputs, which must be equal bit for bit, and their
    times in turns (`card.wrapper_times`); prints one line."""
    equal = bit_equal(other(), this())
    print(f"{name}: this tree's output equals the other's bit for bit: {equal}", flush=True)
    if not equal:
        raise AssertionError(f"{name}: the output differs from the other tree's")
    t = [card.wrapper_times(f, part) for f in (other, this, this, other)]
    r = {f"{side}_{k}": [t[i][k], t[j][k]] for side, (i, j) in (("other", (0, 3)),
                                                                ("this", (1, 2)))
         for k in ("ms", "device_ms", "host_ms")}
    r["bit_equal"] = equal
    print(f"{name}: device only: other {r['other_device_ms']}, this {r['this_device_ms']} ms; "
          f"events around the wrapper: other {r['other_ms']}, this {r['this_ms']} ms; host to "
          f"issue: other {r['other_host_ms']}, this {r['this_host_ms']} ms", flush=True)
    return r


def ptxas_report(root: str) -> dict:
    """ptxas's registers and spills of K1 and K5 in the checkout at `root`."""
    import tempfile
    from pathlib import Path

    from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels

    csrc = Path(root) / PKG / "csrc"
    srcs = [csrc / "fused.cu", csrc / "enum_pack.cu"]
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        usage = kernels.compile_objects(srcs, [Path(tmp) / f"{p.stem}.o" for p in srcs])
    rows = {**card.ptxas_rows("fused_frontend_kernel", usage),
            **card.ptxas_rows("enum_pack_kernel", usage)}
    for label, u in rows.items():
        print(f"ptxas, {root}: {label}: {u['registers']} registers, {u.get('stack', 0)} B "
              f"stack, {u.get('spill_stores', 0)} B spill stores, {u.get('spill_loads', 0)} B "
              f"spill loads", flush=True)
    return rows


def other_comp(comp):
    """`comp` as the other checkout's Compressions (its wrappers key on their
    own enums)."""
    d = importlib.import_module("other_port.data")
    return d.Compressions(d.ShCompression(comp.sh.value), d.Cov3dCompression(comp.cov3d.value))


def frontend(old, ops, parent: str) -> dict:
    """K1 and K5, old against new (see the module's docstring)."""
    import numpy as np
    import torch

    rec = {"ptxas": {"other": ptxas_report(parent), "this": ptxas_report(REPO)}}
    eye = np.eye(4, dtype=np.float32)
    g1, cam1 = card.config1_scene()
    comp, pod = card.pod_tensors(g1, "cuda")
    n = g1.count
    del g1
    cfg1 = ops.TileConfig(1920, 1080, tile=32, max_dup=4)
    args = (pod, comp, cfg1, cam1.view(), cam1.projection(1920 / 1080), eye)
    oargs = (pod, other_comp(comp), *args[2:])
    k1 = "fused_frontend_kernel"
    rec["k1_config1"] = entries_ab("K1 ungated, config 1 (6M)",
                                   lambda: old.enumerate_entries_fused(*oargs),
                                   lambda: ops.enumerate_entries_fused(*args), k1)
    gkw = card.gates(n, "cuda")
    rec["k1_config1_gated"] = entries_ab("K1 gated (every gate), config 1 (6M)",
                                         lambda: old.enumerate_entries_fused(*oargs, **gkw),
                                         lambda: ops.enumerate_entries_fused(*args, **gkw), k1)
    del gkw
    pre = ops.preprocess(pod, comp, *args[3:], 1920, 1080)
    rec["k5_config1"] = entries_ab("K5, config-1 scene (6M)",
                                   lambda: old.enumerate_entries_from_pre(pre, cfg1),
                                   lambda: ops.enumerate_entries_from_pre(pre, cfg1),
                                   "enum_pack_kernel")
    del pre, pod, args, oargs
    torch.cuda.empty_cache()

    comp, pod, cfg_m, view, proj, mmat, edit = card.config2_model(1, "cuda")
    w, h = card.CONFIG2_SIZE
    args = (pod, comp, cfg_m, view, proj, mmat)
    oargs = (pod, other_comp(comp), *args[2:])
    rec["k1_config2_ranked"] = entries_ab(
        "K1 rank 1 of model_bits 2 + edits, one config-2 model (1M)",
        lambda: old.enumerate_entries_fused(*oargs, model_rank=1, edit=edit),
        lambda: ops.enumerate_entries_fused(*args, model_rank=1, edit=edit), k1)
    pre = ops.preprocess(pod, comp, *args[3:], w, h, edit=edit)
    rec["k5_config2"] = entries_ab(
        "K5 rank 2 of model_bits 2, one config-2 model (1M)",
        lambda: old.enumerate_entries_from_pre(pre, cfg_m, model_rank=2),
        lambda: ops.enumerate_entries_from_pre(pre, cfg_m, model_rank=2), "enum_pack_kernel")
    del pre, pod
    torch.cuda.empty_cache()

    # K4 shares splat.cuh with K1: the config-3 shapes, ungated and gated.
    g3, cam3 = card.config3_scene()
    comp, pod = card.pod_tensors(g3, "cuda")
    g4 = {k: v for k, v in card.gates(g3.count, "cuda", seed=5).items()
          if k in ("mask_bits", "edit")}
    args = (pod, comp, cam3.view(), cam3.projection(1920 / 1080), eye, 1920, 1080)
    oargs = (pod, other_comp(comp), *args[2:])
    for key, kw in (("k4_config3", {}), ("k4_config3_gated", g4)):
        rec[key] = entries_ab(
            f"K4 query geometry{' gated (mask, edits)' if kw else ''}, config 3 (2M)",
            lambda: old.preprocess_geometry_fused(*oargs, **kw),
            lambda: ops.preprocess_geometry_fused(*args, **kw), "geometry_kernel")
    del pod, g4
    torch.cuda.empty_cache()
    return rec


def compositors(old, ops, smi: str) -> dict:
    """K3 and K6, old against new (see the module's docstring)."""
    import numpy as np
    import torch

    g1, cam1 = card.config1_scene()
    comp, pod = card.pod_tensors(g1, "cuda")
    cfg1 = ops.TileConfig(1920, 1080, tile=32, max_dup=4)
    ent1 = ops.enumerate_entries_fused(pod, comp, cfg1, cam1.view(), cam1.projection(1920 / 1080),
                                       np.eye(4, dtype=np.float32))
    del pod, g1
    v2 = card.config2_viewer(card.config2_models(), "cuda")
    ent2, cfg2 = v2.merged_entries(v2.model_order())
    del v2
    torch.cuda.empty_cache()

    rec = {}
    for cell, ent, cfg in (("config1", ent1, cfg1), ("config2", ent2, cfg2)):
        se = ops.sort_entries(ent, cfg)
        r = {"slots": ent.shape[0], "live": se.n_valid}
        for mode, kw in (("transposed_horner", {}), ("rows_horner", {"transposed": False}),
                         ("rows_basis", {"transposed": False, "mxu": True})):
            r[mode] = compare(f"{cell} K3 {mode} [{smi}]",
                              lambda: old.composite_tiles_v2(se, cfg, **kw),
                              lambda: ops.composite_tiles_v2(se, cfg, **kw))
        rec[cell] = r
        del se
    del ent1, ent2
    torch.cuda.empty_cache()
    # K6 on the config-1 EntryPlanes at tiles 32, 64 and 128.
    g1, cam1 = card.config1_scene()
    comp, pod = card.pod_tensors(g1, "cuda")
    for tile in (32, 64, 128):
        cfg = ops.TileConfig(1920, 1080, tile=tile, max_dup=4)
        planes = card.v1_planes(pod, comp, cfg, cam1)
        key = "k6" if tile == 32 else f"k6_tile{tile}"
        rec["config1"][key] = compare(f"config1 K6 tile {tile} ({planes.ent.shape[1]} rows)",
                                      lambda: old.composite_tiles(planes, cfg),
                                      lambda: ops.composite_tiles(planes, cfg))
        if tile == 32:
            rec["config1"]["k6_layouts"] = layouts(ops, "config1 tile 32", planes, cfg)
        del planes
    del pod
    # K6 in flat mode on the config-0 shapes (sparse tiles).
    g0, cam0 = card.config0_scene()
    comp0, pod0 = card.pod_tensors(g0, "cuda")
    cfg0 = ops.TileConfig(800, 600, tile=32, max_dup=4)
    planes0 = card.v1_planes(pod0, comp0, cfg0, cam0, sh_degree=0, display_mode=2)
    rec["config0_flat_k6"] = compare(
        "config0 flat K6", lambda: old.composite_tiles(planes0, cfg0, flat_mode=True),
        lambda: ops.composite_tiles(planes0, cfg0, flat_mode=True))
    rec["config0_flat_k6"]["layouts"] = layouts(ops, "config0 flat", planes0, cfg0, flat=True)
    del planes0, pod0
    torch.cuda.empty_cache()
    return rec


def k3_device_ms(fn, reps: int = 20):
    """K3's device time a call of fn(): its `composite_v2_kernel` launches
    (one or two passes) under torch.profiler, and the other device
    operations fn() ran beside them, by name; (None, {}) where the profiler
    saw no device time."""
    found = card.device_kernel_ms(fn, reps)
    if found is None:
        return None, {}
    k3 = sum(v for k, v in found[0].items() if "composite_v2_kernel" in k)
    return k3, {k: v for k, v in found[0].items() if "composite_v2_kernel" not in k}


def cells(old, ops, yaws: int, seed: int) -> dict:
    """K3 on the benchmark's frames, old against new (the module's
    docstring)."""
    import math

    import torch

    import profile_port_frame as ppf

    def one(label: str, se, cfg) -> dict:
        a = old.composite_tiles_v2(se, cfg)
        b = ops.composite_tiles_v2(se, cfg)
        equal = bool(torch.equal(a, b))
        if not equal:
            raise AssertionError(f"{label}: K3's image differs from the other tree's "
                                 f"(max abs {float((a - b).abs().max()):.3e})")
        t = [k3_device_ms(lambda: side.composite_tiles_v2(se, cfg))
             for side in (old, ops, ops, old)]
        r = {"bit_equal": equal, "other_device_ms": [t[0][0], t[3][0]],
             "this_device_ms": [t[1][0], t[2][0]], "this_other_ops": t[1][1]}
        print(f"{label}: bit for bit {equal}; K3 device only: other {r['other_device_ms']}, "
              f"this {r['this_device_ms']} ms; this tree's other device ops "
              f"{ {k[:40]: round(v, 4) for k, v in t[1][1].items()} }", flush=True)
        return r

    rec = {}
    for name in ("inria6m.orbit", "multi3x1m.orbit"):
        cell, d, v = ppf.cell_driver(name, seed)
        for k in range(yaws):
            yaw = 2.0 * math.pi * k / yaws
            se, cfg = ppf.cell_sorted(cell, v, yaw)
            rec[f"{name}@{math.degrees(yaw):.0f}"] = one(
                f"{name} seed {seed} yaw {math.degrees(yaw):.0f} deg", se, cfg)
            del se
        del d, v
        torch.cuda.empty_cache()
    cell, d, v = ppf.cell_driver("inria6m.edit", seed)
    se, cfg = ppf.cell_sorted(cell, v, d.yaw0)
    gates = sorted(k for k, t in (("mask", v.models[d.key].buffers.mask),
                                  ("selection", v.models[d.key].buffers.selection))
                   if t is not None)
    rec["inria6m.edit"] = one(f"inria6m.edit seed {seed} gated frame ({', '.join(gates)})",
                              se, cfg)
    del se, d, v
    torch.cuda.empty_cache()
    return rec


def frame(old) -> dict:
    """The config-1 frame through each tree's `Viewer.render`, in turns."""
    from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

    g1, cam1 = card.config1_scene()
    old_viewer = importlib.import_module("other_port.viewer")
    views = {"other": old_viewer.Viewer(g1, 1920, 1080, tile=32, max_dup=4, device="cuda"),
             "this": Viewer(g1, 1920, 1080, tile=32, max_dup=4, device="cuda")}
    frames = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        ms = card.timed_frames(lambda: views[side].render(cam1))
        frames[side].append(ms)
    d = float((views["this"].render(cam1) - views["other"].render(cam1)).abs().max())
    rec = {"other_ms": frames["other"], "this_ms": frames["this"], "vs_other_max": d}
    print(f"config1 frame (Viewer.render, 5 frames after 2 warm-ups): other {frames['other']}, "
          f"this {frames['this']} ms; images max abs {d:.3e}", flush=True)
    return rec


def session(old) -> dict:
    """Config 4 through each tree's app session, in turns (see the module
    docstring)."""
    import numpy as np
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch import app

    g, _ = card.config1_scene()
    w, h = card.CONFIG4_SIZE
    apps = {"other": importlib.import_module("other_port.app"), "this": app}
    masks = {"other": importlib.import_module("other_port.mask"),
             "this": importlib.import_module("wgpu_3dgs_viewer_app_tpu_torch.mask")}
    # Each tree's span collector, which fills `ViewerServer.frame_ms` (a tree
    # without one fills it always), from an empty record list each frame.
    def collector(pkg: str):
        try:
            tr = importlib.import_module(f"{pkg}.utils.trace")
        except ImportError:
            return contextlib.nullcontext

        def collect():
            tr.reset()
            return tr.collect()
        return collect
    collecting = {"other": collector("other_port"),
                  "this": collector("wgpu_3dgs_viewer_app_tpu_torch")}
    sessions, servers, frames = {}, {}, {}
    for side, a in apps.items():
        s = a.GaussianSplattingSession(width=w, height=h, device="cuda", tile=32, max_dup=4)
        s.camera.control.target = np.zeros(3, np.float32)
        s.camera.control.pos = np.array([0.0, 0.0, -6.0], np.float32)
        s.viewer.add_model("config4.ply", g)
        s.selected_key = "config4.ply"
        mk = masks[side]
        for kind, pos, scale in card.CONFIG4_SHAPES:
            s.mask.add_shape(mk.MaskShape(kind=mk.MaskShapeKind(kind),
                                          pos=np.array(pos, np.float32),
                                          scale=np.full(3, scale, np.float32)))
        s.mask.op_code = card.CONFIG4_OP
        s.evaluate_mask(s.mask.parse_op())
        assert all(s.locate_hit(px, 0, i) for i, px in enumerate(card.CONFIG4_HITS))
        sessions[side], servers[side] = s, a.ViewerServer(s)
        frames[side] = s.viewer.render(s.camera.control)
    rec = {k: {"other": [], "this": []} for k in ("update_ms", "render_ms", "overlay_ms",
                                                  "served_ms")}
    rec["served_split_ms"] = {"other": [], "this": []}
    orbit = {"type": "orbit", "dx": 10.0, "dy": 0.0}
    for side in ("other", "this", "this", "other"):
        s, vs = sessions[side], servers[side]
        rec["update_ms"][side].append(card.timed_frames(s.update))
        rec["render_ms"][side].append(card.cuda_ms(
            lambda: s.viewer.render(s.camera.control), 5))
        rec["overlay_ms"][side].append(card.cuda_ms(
            lambda: s.render_overlays(frames[side]), 10))
        rows = []
        for i in range(7):
            vs.handle_event(orbit)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with collecting[side]():
                vs.frame_jpeg(85)
            assert set(vs.frame_ms) == {"update", "device", "copy", "host"}, vs.frame_ms
            if i >= 2:
                rows.append(((time.perf_counter() - t0) * 1e3, dict(vs.frame_ms)))
        rec["served_ms"][side].append(sum(r[0] for r in rows) / len(rows))
        rec["served_split_ms"][side].append(
            {k: sum(r[1][k] for r in rows) / len(rows) for k in rows[0][1]})
    imgs = {side: s.update() for side, s in sessions.items()}
    blobs = {side: servers[side].frame_jpeg(85) for side in sessions}
    rec["update_bit_for_bit"] = bit_equal(imgs["other"], imgs["this"])
    rec["served_bytes_equal"] = blobs["other"] == blobs["this"]
    if not (rec["update_bit_for_bit"] and rec["served_bytes_equal"]):
        raise AssertionError(f"config 4: the trees' frames differ: update() bit for bit "
                             f"{rec['update_bit_for_bit']}, served bytes equal "
                             f"{rec['served_bytes_equal']}")
    for k in ("update_ms", "render_ms", "overlay_ms", "served_ms"):
        print(f"config4 {k} (other, this, this, other): other {rec[k]['other']}, this "
              f"{rec[k]['this']}", flush=True)
    print(f"config4 served split: other {rec['served_split_ms']['other']}, this "
          f"{rec['served_split_ms']['this']}; update() frames bit for bit, served JPEG bytes "
          f"equal", flush=True)
    return rec


def main() -> int:
    import torch

    from wgpu_3dgs_viewer_app_tpu_torch import ops

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other checkout")
    ap.add_argument("--parts", default="frontend,compositors,frame",
                    help="comma-separated: frontend, compositors, cells, frame, session")
    ap.add_argument("--yaws", type=int, default=10, help="cells: orbit yaws a scene")
    ap.add_argument("--seed", type=int, default=3200000003, help="cells: the cells' seed")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= {"frontend", "compositors", "cells", "frame", "session"}:
        ap.error(f"unknown parts in {args.parts}")
    if not torch.cuda.is_available():
        print("ab_port_kernels: no CUDA device", file=sys.stderr)
        return 1
    old = load_other(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    ops.kernels.library()
    old.kernels.library()
    print(f"kernel build seconds (nvcc, all sources at once): other {old.kernels.build_seconds}, "
          f"this {ops.kernels.build_seconds}", flush=True)

    rec = {}
    if "frontend" in parts:
        rec["frontend"] = frontend(old, ops, args.parent)
    if "compositors" in parts:
        rec.update(compositors(old, ops, smi))
    if "cells" in parts:
        rec["cells"] = cells(old, ops, args.yaws, args.seed)
    if "frame" in parts:
        rec["config1_frame"] = frame(old)
    if "session" in parts:
        rec["config4_session"] = session(old)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
