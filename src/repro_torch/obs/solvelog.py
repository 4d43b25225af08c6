"""Structured per-solve result records — the predictor's training log.

Every CMVM solve appends one flat record (matrix statistics → solver
outcome) to a bounded in-memory ring; when ``REPRO_SOLVE_LOG=/path.jsonl``
is set (or :func:`set_path` is called) records are also appended to a
JSONL file.  This is the data a rule4ml-style learned resource
estimator (PAPERS.md, arXiv 2408.05314) trains on: predict adders /
cost bits / depth / wall seconds from cheap matrix features without
running the solver.

Record schema (all scalars, JSON-ready)::

    {
      "kind": "cmvm", "engine": "arena", "dc": 2, "decomposed": true,
      "d_out": 64, "d_in": 64, "nnz": 4032, "w_max_abs": 127,
      "bits_in": 8, "adders": 312, "cost_bits": 4120, "depth": 9,
      "wall_s": 0.41, "cache_hit": false
    }

The in-memory ring is always on (a dict append per solve — solves are
milliseconds at minimum, so this is free); the JSONL sink is opt-in and
guarded by a lock because compile solves run on a thread pool.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

__all__ = ["log_solve", "records", "reset", "set_path", "get_path"]

_RING_CAP = 4096

_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_CAP)
_path: str | None = os.environ.get("REPRO_SOLVE_LOG") or None


def set_path(path: str | None) -> None:
    """Set (or clear, with None) the JSONL sink for solve records."""
    global _path
    with _lock:
        _path = path


def get_path() -> str | None:
    return _path


def log_solve(record: dict) -> None:
    """Append one per-solve record to the ring (and JSONL sink if set)."""
    _ring.append(record)  # deque.append is atomic under the GIL
    p = _path
    if p is not None:
        line = json.dumps(record, sort_keys=True)
        with _lock:
            with open(p, "a") as fh:
                fh.write(line + "\n")


def records() -> list[dict]:
    """Snapshot of the in-memory ring, oldest first."""
    return list(_ring)


def reset() -> None:
    _ring.clear()
