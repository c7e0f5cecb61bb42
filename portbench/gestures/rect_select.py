"""Gesture `rect_select`: a seeded rect (each side `rect.min_frac` to
`rect.max_frac` of the viewport's) through the session's QueryToolset
(start, update, end; SET), with the mix's selection edit and the
highlight on. `selection_bits` is the reference's side: the same rect at
the camera and mask the gesture saw."""

from harness import reference as ref


def apply(d) -> None:
    from wgpu_3dgs_viewer_app_tpu_torch.app import Action, SelectionEdit
    from wgpu_3dgs_viewer_app_tpu_torch.query import QuerySelectionOp, QueryToolset

    t = d.traffic["rect"]
    w, h = d.config["width"], d.config["height"]
    fw, fh = d.rng.uniform(t["min_frac"], t["max_frac"], 2)
    x0 = float(d.rng.uniform(0, 1 - fw)) * w
    y0 = float(d.rng.uniform(0, 1 - fh)) * h
    tl, br = (x0, y0), (x0 + float(fw) * w, y0 + float(fh) * h)
    s = d.session
    s.action = Action.SELECTION
    s.toolset.set_use_texture(False)
    s.toolset.start(QueryToolset.RECT, QuerySelectionOp.SET, tl)
    s.toolset.update_pos(br)
    s.end_selection_gesture()
    s.selection.edit = SelectionEdit(**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in d.traffic["selection_edit"].items()})
    d.selection = {"gesture": "rect_select", "yaw": d.yaw, "rect": (tl, br),
                   "shapes": [dict(x) for x in d.shapes]}


def selection_bits(R, sel: dict, mask_then):
    """The reference's selection bits of the gesture's inputs `sel`, gated
    by the mask as it stood then."""
    return R.selection_bits(ref.camera_at(R.config, sel["yaw"]), sel["rect"], mask_then)
