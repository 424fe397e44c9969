"""Crash-safe atomic file writes: the port's copy of the discipline the
corpus uses,

    write tmp -> flush -> fsync(tmp fd) -> rename -> fsync(directory)

so a reader never sees a torn file and a crash leaves the old version or
the new one. The directory fsync persists the rename itself.
"""

from __future__ import annotations

import json
import os


def fsync_dir(dirpath: str) -> None:
    """Persist a just-performed rename in `dirpath`. Best-effort: a
    filesystem that refuses a directory fsync degrades to a rename
    without it, never to an error on the write path."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Atomically replace `path` with `text` (tmp + fsync + rename +
    dir-fsync)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, doc, *, indent: int = 1, sort_keys: bool = True) -> None:
    atomic_write_text(path, json.dumps(doc, indent=indent, sort_keys=sort_keys) + "\n")
