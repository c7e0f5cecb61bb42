from .buffers import GaussianBuffers
from .viewer import MultiModelViewer, Viewer, ViewerModel, render_frame

__all__ = ["GaussianBuffers", "MultiModelViewer", "Viewer", "ViewerModel", "render_frame"]
