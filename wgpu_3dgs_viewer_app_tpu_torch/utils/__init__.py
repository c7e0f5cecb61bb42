from .format import human_readable_size
from .log import configure as configure_logging
from .log import get_logger
from .tasks import exec_task

__all__ = ["human_readable_size", "exec_task", "get_logger", "configure_logging"]
