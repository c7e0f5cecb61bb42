"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and nothing of the port is in the reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wgpu_3dgs_viewer_app_tpu")


def test_harness_loads_no_jax():
    """Import the harness, every configuration, traffic mix and metric
    reader, the reference, and the port's modules the drivers use, in a
    fresh process; no module's top-level name is JAX's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    code = f"""
import json, sys
from pathlib import Path
sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]
import run
from harness import check, counts, drive, reference, scene, spec, trace
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.resolve(w["name"], bench)
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
for m in bench["end_to_end"]:
    spec.end_to_end_reader(m["name"])
for kind in ("entries", "gestures", "end_to_end", "metrics"):
    for f in sorted((spec.HERE / kind).glob("*.py")):
        spec.load(kind, f.stem)
import wgpu_3dgs_viewer_app_tpu_torch.viewer, wgpu_3dgs_viewer_app_tpu_torch.app
import wgpu_3dgs_viewer_app_tpu_torch.app.server, wgpu_3dgs_viewer_app_tpu_torch.ops.kernels
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "gsref").rglob("*.py")) + [HERE / "harness" / "reference.py"]
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"wgpu_3dgs_viewer_app_tpu_torch", *FORBIDDEN}
        assert not bad, f"{f} imports {bad}"


def test_forbidden_check_compares_whole_names():
    import types

    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import run

    probes = {"wgpu_3dgs_viewer_app_tpu.probe": True, "jaxlib.probe": True,
              "wgpu_3dgs_viewer_app_tpu_torch_probe": False, "jaxy_probe": False}
    try:
        for name in probes:
            sys.modules[name] = types.ModuleType(name)
        found = run.forbidden_modules()
        assert {n for n in probes if n in found} == {n for n, bad in probes.items() if bad}
    finally:
        for name in probes:
            sys.modules.pop(name, None)
