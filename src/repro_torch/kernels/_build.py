"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, by ``nvcc`` alone, into its own shared library under ``build/kernels``
at the root of the checkout, then loaded with ``ctypes``. The library's
file name carries a digest of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. :func:`build`
starts one ``nvcc`` per missing library, all at once, and waits for them.

Nothing here runs at import time: the module imports on a machine with no
CUDA toolkit, and only a wrapper that is given a CUDA tensor gets here.

Calling convention of every entry point: pointers and the CUDA stream are
``c_void_p`` (the stream is PyTorch's current stream), sizes ``c_int``,
float scalars ``c_float``; the entry returns ``cudaGetLastError()`` right
after its launch, and :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("photonic_mvm", "conv_chain", "ca_pool", "conv_strip",
           "epilogue")
# -Xptxas -v reports registers, shared memory and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, or its launch reported a CUDA error."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise KernelError("nvcc not found: the CUDA kernels are built on first "
                      "use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed kernel whose library is missing, in parallel.

    Returns seconds spent per compiled kernel (empty when all were built).
    Raises :class:`KernelError` with the compiler's output on failure.
    """
    names = tuple(names) if names is not None else KERNELS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{threading.get_ident()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        tmp.replace(out)
    if failures:
        raise KernelError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed.

    ``signatures`` maps each entry point to its ``argtypes``; every entry
    returns an ``int`` (the CUDA error code).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")


# the launches a thread records into a CUDA graph it is capturing (see
# ``kernels.recording_launches``): a wrapper called during a capture records
# its kernel into the graph and launches nothing
_capturing = threading.local()


class LaunchCounter:
    """Kernel launches of one wrapper: incremented only where it launches.

    While the calling thread captures a CUDA graph, :meth:`inc` adds to
    that capture's tally instead; each replay of the graph then credits the
    tally back through :meth:`add`.
    """

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + 1
            return
        with self._lock:
            self._n += 1

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
