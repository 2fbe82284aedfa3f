"""Checkpoint files of the search engines (search/outer.py, the streams of
search/fused_stream.py, the batch of search/chunked.py and the sweep tool):
np.savez under exactly the name given, written whole or not at all."""

from __future__ import annotations

import os
import tempfile

import numpy as np


def savez_exact(path: str, blob: dict) -> None:
    """np.savez of `blob` to exactly `path` (given a name, np.savez itself
    appends `.npz` when it is missing), through a temporary file in the
    same directory and os.replace: a kill during the write leaves the
    previous file at `path` whole."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
