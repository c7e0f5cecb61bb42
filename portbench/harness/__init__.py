"""The benchmark of the port `wgpu_3dgs_viewer_app_tpu_torch`: one cell
(a configuration under a traffic mix) a run. `run.py` is the entry point;
`spec` finds a cell's files by name, `scene` makes its scene from the seed,
`drive` offers its traffic to the port, `reference` and `check` decide
`correct`, `trace` and `counts` read the device trace."""
