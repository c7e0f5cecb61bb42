"""Logging facade over resource lifecycle and IO.

The reference logs resource creation/teardown and loader progress through
the `log` crate behind env_logger (`RUST_LOG=debug`, e.g.
`src/tab/scene.rs:352-356` parse-skip warnings, model add/remove debug
lines). The port routes the same events through Python `logging` under
the `gs3d` namespace; `configure()` wires the env-var switch (`GS_LOG`,
default WARNING) so the CLI behaves like env_logger.
"""

from __future__ import annotations

import logging
import os

_ROOT = "gs3d"


def get_logger(name: str = "") -> logging.Logger:
    """`gs3d`-namespaced logger, e.g. get_logger('viewer')."""
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def configure(level: str | None = None) -> None:
    """Install a stderr handler on the gs3d root at `level` (or $GS_LOG,
    default WARNING). Idempotent — repeated calls only adjust the level."""
    lg = logging.getLogger(_ROOT)
    lvl = (level or os.environ.get("GS_LOG", "WARNING")).upper()
    lg.setLevel(getattr(logging, lvl, logging.WARNING))
    if not lg.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname).1s %(name)s] %(message)s",
                              datefmt="%H:%M:%S")
        )
        lg.addHandler(h)
        lg.propagate = False
