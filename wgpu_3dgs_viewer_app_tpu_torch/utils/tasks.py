"""Background task execution.

Parity with reference `src/util.rs:3-28` (`exec_task` / `exec_blocking_task`):
the reference spawns a native thread (or wasm task) per background job; here a
daemon thread is the host-side equivalent, used for streaming PLY parses and
background work so the frame loop never blocks.
"""

import threading
from typing import Callable


def exec_task(fn: Callable, *args, **kwargs) -> threading.Thread:
    """Run `fn` on a daemon thread; returns the thread handle."""
    t = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=True)
    t.start()
    return t
