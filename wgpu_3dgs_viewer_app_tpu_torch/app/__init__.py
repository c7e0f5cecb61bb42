"""The app layer: the session (`GaussianSplattingSession`), streaming load,
measurement, export, the saved state and the web viewer (`ViewerServer`,
`serve`). `cli` is imported on its own."""

from .export import ExportChoice, export_models, serialize_exports, snapshot_exports
from .loader import Loadable, StreamingLoader
from .measurement import (Measurement, MeasurementHit, MeasurementHitPair,
                          render_measurement_overlay)
from .persistence import load_compressions, restore_state, save_state
from .server import ViewerServer, make_handler, serve
from .state import (Action, FpsCounter, GaussianSplattingSession, MaskState, SceneCommand,
                    SceneCommandKind, Selection, SelectionEdit, SelectionMethod)

__all__ = [
    "ExportChoice",
    "export_models",
    "serialize_exports",
    "snapshot_exports",
    "Loadable",
    "StreamingLoader",
    "Measurement",
    "MeasurementHit",
    "MeasurementHitPair",
    "render_measurement_overlay",
    "Action",
    "FpsCounter",
    "GaussianSplattingSession",
    "MaskState",
    "SceneCommand",
    "SceneCommandKind",
    "Selection",
    "SelectionEdit",
    "SelectionMethod",
    "load_compressions",
    "restore_state",
    "save_state",
    "ViewerServer",
    "make_handler",
    "serve",
]
