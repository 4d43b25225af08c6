"""Build the port's CUDA sources into shared libraries and load them.

Every ``kernels/*/csrc/*.cu`` is compiled by its own ``nvcc`` into a
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Builds run
at first use, never on import; all sources that are not built yet are
compiled together, one ``nvcc`` process each, started at once.  The
output goes to ``src/repro_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, its headers and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  A build, load or
launch failure raises :class:`KernelError`.  nvcc's output of a build, ptxas's resource report
included, is kept beside the library (:func:`build_log`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills, kept in the log
)



class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched.

    Callers that may degrade around other faults (the serve engine's
    interpreter fallback) let this one through: the work of a kernel
    that fails never moves to the CPU."""


_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_n_sms: dict[int, int] = {}


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Build every kernel source that is not built yet, all in parallel;
    returns name -> library path.  Raises :class:`KernelError` naming each
    source that failed, with nvcc's output."""
    targets = {name: (src, _target(src)) for name, src in sources().items()}
    todo = {n: st for n, st in targets.items() if not st[1].exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                out.with_suffix(".log").write_text(log)
                tmp.replace(out)
        if failed:
            raise KernelError("nvcc failed for " + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def build_log(name: str) -> str:
    """nvcc's output when it built kernel ``name`` (built first if need
    be), ptxas's ``-v`` resource report included."""
    return build_all()[name].with_suffix(".log").read_text()


class LaunchCounter:
    """A thread-safe count of kernel launches: each wrapper adds one where
    it launches its kernel, and nowhere else.

    Inside a CUDA-graph capture on the calling thread (:func:`tally`)
    nothing runs, so a wrapper's ``add`` goes to the capture's tally
    instead; the graph adds the tally to the counters at every replay
    (``graphs.CapturedGraph.replay``)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        pending = getattr(_capturing, "tally", None)
        if pending is not None:
            pending[self] = pending.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


_capturing = threading.local()


@contextlib.contextmanager
def tally():
    """Collect the launches the calling thread's wrappers make in the
    ``with`` body into a dict (counter -> launches) instead of counting
    them: the body is a capture, which launches nothing."""
    if getattr(_capturing, "tally", None) is not None:
        raise RuntimeError("a capture is already being tallied on this thread")
    _capturing.tally = launches = {}
    try:
        yield launches
    finally:
        _capturing.tally = None


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise KernelError(f"no CUDA source for kernel {name!r}")
            try:
                lib = ctypes.CDLL(str(paths[name]))
            except OSError as e:
                raise KernelError(f"cannot load kernel library {paths[name]}: {e}") from e
            _loaded[name] = lib
        return lib


def sm_count(device) -> int:
    """The SMs of a CUDA device (read once per device); the launch plans
    size their grids by it."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _n_sms.get(index)
    if n is None:
        n = _n_sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n
