"""Atomic JSON checkpoint store for resumable protocols, copied from the
JAX package's `robustness/checkpoint.py`.

The heavy-hitters Leader persists its sweep frontier here after every
completed level; a process restarted mid-sweep reloads the last
completed level and continues instead of starting over. Writes are
torn-write-proof: the payload lands in `<path>.tmp` and is
`os.replace`d into place, so `load` only ever sees a whole checkpoint
or none. A checkpoint that exists but does not parse (disk rot, a
truncating copy) raises `CheckpointError` — silently treating it as
"no checkpoint" would restart long work without telling the operator
why.
"""

from __future__ import annotations

import json
import os
from typing import Optional

__all__ = ["CheckpointError", "CheckpointStore"]


class CheckpointError(RuntimeError):
    """The checkpoint file exists but cannot be read back."""


class CheckpointStore:
    """One JSON document at `path`, written atomically."""

    def __init__(self, path: str):
        self.path = str(path)

    def save(self, payload: dict) -> None:
        tmp = self.path + ".tmp"
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> Optional[dict]:
        """The stored payload, or None when no checkpoint exists."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"unreadable checkpoint {self.path}: {e}"
            ) from e

    def delete(self) -> None:
        for path in (self.path, self.path + ".tmp"):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
