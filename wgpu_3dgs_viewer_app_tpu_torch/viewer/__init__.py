from .buffers import GaussianBuffers
from .viewer import MultiModelViewer, Viewer, ViewerModel

__all__ = ["GaussianBuffers", "MultiModelViewer", "Viewer", "ViewerModel"]
