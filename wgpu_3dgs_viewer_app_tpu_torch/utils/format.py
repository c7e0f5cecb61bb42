"""Formatting helpers.

Parity with reference `src/util.rs:71-94` (`human_readable_size`).
"""


def human_readable_size(size: int | float) -> str:
    """Format a byte count as a human-readable string (B, KB, MB, GB, TB).

    Mirrors reference `src/util.rs:71-94`: 1024-based units, two decimals.
    """
    size = float(size)
    for unit in ("B", "KB", "MB", "GB"):
        if size < 1024.0:
            if unit == "B":
                return f"{int(size)} {unit}"
            return f"{size:.2f} {unit}"
        size /= 1024.0
    return f"{size:.2f} TB"
