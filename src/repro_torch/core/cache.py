"""Content-addressed CMVM solution cache.

``solve_cmvm`` is deterministic: the resulting :class:`DAISProgram` is a
pure function of (integer matrix, input qints, input depths, dc, solver
options).  This module hashes exactly that tuple and memoizes the solved
program, so repeated compiles — conv layers sharing one CMVM, benchmark
reruns, serve restarts — skip the solver entirely:

  * key: sha256 over the matrix bytes/shape, the (lo, hi, exp) triple of
    every input qint, the input depths, and every solver option
    (:func:`solve_key`);
  * value: the program serialized with ``DAISProgram.to_arrays`` (plain
    int64 arrays, exact round-trip) plus the integer matrix and solution
    metadata;
  * storage: in-memory LRU, optionally backed by a directory of ``.npz``
    files (``np.savez_compressed``, no pickle) that survives processes.

``get`` rebuilds a fresh ``Solution`` per call (no aliasing between
callers); hits carry ``stats={"cache_hit": True}`` and a near-zero
``solver_time_s`` so callers can assert that solves were skipped.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from collections.abc import Sequence

import numpy as np

from .dais import DAISProgram
from .fixed_point import QInterval

_KEY_VERSION = b"da4ml-solution-cache-v1"


def solve_key(
    m_int: np.ndarray,
    qint_in: Sequence[QInterval],
    depth_in: Sequence[int],
    **options,
) -> str:
    """Content hash of one CMVM solve request."""
    h = hashlib.sha256(_KEY_VERSION)
    m = np.ascontiguousarray(np.asarray(m_int, dtype=np.int64))
    h.update(repr(m.shape).encode())
    h.update(m.tobytes())
    for q in qint_in:
        h.update(f"q{q.lo},{q.hi},{q.exp};".encode())
    h.update(("d" + ",".join(str(int(d)) for d in depth_in)).encode())
    for name in sorted(options):
        h.update(f"o{name}={options[name]!r};".encode())
    return h.hexdigest()


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    disk_hits: int = 0
    skipped_unserializable: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def pack_solution(sol) -> dict:
    """Serialize a Solution to plain int64 numpy arrays (no pickle).

    Shared by the cache entries and any artifact code that persists
    solved programs.  Raises ``OverflowError`` if the program's qints do
    not fit in int64."""
    entry = dict(sol.program.to_arrays())
    entry["matrix"] = np.ascontiguousarray(sol.matrix, dtype=np.int64)
    entry["meta"] = np.array(
        [sol.out_scale_exp, sol.dc, int(sol.decomposed)], dtype=np.int64
    )
    return entry


_PROGRAM_ARRAY_KEYS = ("rows", "outputs", "n_inputs")


def program_arrays_of(entry: dict) -> dict:
    """The packed-program slice of a cache entry (the dict layout of
    ``DAISProgram.to_arrays``).  Threaded into ``Solution.program_arrays``
    so consumers (``design.programs``) reuse the already-packed arrays
    instead of round-tripping unpack -> repack."""
    return {k: entry[k] for k in _PROGRAM_ARRAY_KEYS}


def unpack_solution(entry: dict, lookup_s: float = 0.0):
    """Exact inverse of :func:`pack_solution` (fresh Solution per call).

    The returned Solution carries ``program_arrays`` aliasing the entry's
    packed program (treated read-only by all consumers), so a warm-cache
    compile never repacks a program it just unpacked."""
    from .solver import Solution  # local import: solver imports this module

    program = DAISProgram.from_arrays(entry)
    out_scale_exp, dc, decomposed = entry["meta"].tolist()
    return Solution(
        program=program,
        matrix=np.array(entry["matrix"], dtype=np.int64),
        out_scale_exp=int(out_scale_exp),
        dc=int(dc),
        solver_time_s=lookup_s,
        decomposed=bool(decomposed),
        stats={"cache_hit": True},
        program_arrays=program_arrays_of(entry),
    )


@dataclass
class SolutionCache:
    """In-memory LRU of solved CMVM programs, with optional disk backing."""

    max_items: int = 256
    disk_dir: str | None = None
    stats: CacheStats = field(default_factory=CacheStats)

    def __post_init__(self) -> None:
        self._mem: OrderedDict[str, dict] = OrderedDict()
        if self.disk_dir is not None:
            Path(self.disk_dir).mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._mem)

    def clear(self) -> None:
        self._mem.clear()
        self.stats = CacheStats()

    # ------------------------------------------------------------------
    def get(self, key: str):
        """Return a fresh ``Solution`` for ``key`` or None on miss."""
        t0 = time.perf_counter()
        entry = self._mem.get(key)
        if entry is not None:
            self._mem.move_to_end(key)
        elif self.disk_dir is not None:
            path = Path(self.disk_dir) / f"{key}.npz"
            if path.exists():
                with np.load(path, allow_pickle=False) as z:
                    entry = {name: z[name] for name in z.files}
                self.stats.disk_hits += 1
                self._remember(key, entry)
        if entry is None:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return self._to_solution(entry, time.perf_counter() - t0)

    def put(self, key: str, sol) -> None:
        """Store a Solution; silently skipped if not int64-serializable.

        On success the Solution's ``program_arrays`` is populated with
        the freshly packed program, so even a cold compile that caches
        its solves never packs the same program twice."""
        try:
            entry = pack_solution(sol)
        except OverflowError:
            self.stats.skipped_unserializable += 1
            return
        sol.program_arrays = program_arrays_of(entry)
        self._remember(key, entry)
        self.stats.puts += 1
        if self.disk_dir is not None:
            path = Path(self.disk_dir) / f"{key}.npz"
            if not path.exists():
                tmp = path.with_suffix(".tmp.npz")
                np.savez_compressed(tmp, **entry)
                tmp.replace(path)

    # ------------------------------------------------------------------
    def _remember(self, key: str, entry: dict) -> None:
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_items:
            self._mem.popitem(last=False)

    @staticmethod
    def _to_solution(entry: dict, lookup_s: float):
        return unpack_solution(entry, lookup_s)
