"""Build and load the CUDA C++ kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The library
goes to ``build/`` beside this file (listed in ``.gitignore``), named by a
digest of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  The missing libraries are built in parallel, one
``nvcc`` for each source, all started together.  A failed build raises.
Nothing is built when the module is imported.

Every wrapper launches its kernel through a ``Kernel`` (the library's
entry with its argument types, bound on the first launch, run on a tensor's
device with the current stream appended, a non-zero return raised); a C
function that is no kernel entry is bound with ``bind``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
# seconds from the start of the builds to the end of each source's nvcc, in
# this process (built sources only)
BUILD_SECONDS: dict[str, float] = {}


@functools.cache
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def require_hopper(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device of compute capability 9.0."""
    if t.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got one on {t.device}")
    cap = _capability(t.device.index if t.device.index is not None
                      else torch.cuda.current_device())
    if cap != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a (H100/H200); {t.device} has capability {cap}")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together, and record each one's seconds in ``BUILD_SECONDS``.
    Returns name -> library path; raises with the tail of ``nvcc``'s log if
    a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {src.stem: target(src) for src in sources()}
    running = {}
    t0 = time.perf_counter()
    for src in sources():
        lib = out[src.stem]
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = open(lib.with_suffix(".log"), "w")
            running[src] = (subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                             stdout=log, stderr=subprocess.STDOUT), log, tmp)
    errors = []
    while running:
        for src, (proc, log, tmp) in list(running.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[src.stem] = time.perf_counter() - t0
            log.close()
            del running[src]
            if proc.returncode == 0:
                os.replace(tmp, out[src.stem])
            else:
                errors.append(f"{src.name}: nvcc exit {proc.returncode}\n"
                              f"{Path(log.name).read_text()[-4000:]}")
        time.sleep(0.05)
    if errors:
        raise RuntimeError("kernel build failed: " + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all()[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


@functools.cache
def bind(lib: str | Path, symbol: str, restype, argtypes: tuple):
    """The C function ``symbol`` of ``lib`` (the name of a source in
    ``csrc/``, or the path of a library built elsewhere), its ``restype``
    and ``argtypes`` set; bound once per process."""
    fn = getattr(load(lib) if isinstance(lib, str) else ctypes.CDLL(str(lib)), symbol)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


@dataclasses.dataclass(frozen=True)
class Kernel:
    """The kernel entry ``symbol`` of ``lib`` (as in ``bind``): a C function
    that takes ``argtypes`` and then a CUDA stream and returns a CUDA error
    code.  ``kernel(t, *args)`` launches it on ``t``'s device and current
    stream and raises on an error; the library is loaded, and built if need
    be, at the first launch."""
    lib: str | Path
    symbol: str
    argtypes: tuple

    @functools.cached_property
    def fn(self):
        return bind(self.lib, self.symbol, ctypes.c_int, (*self.argtypes, ctypes.c_void_p))

    def __call__(self, t: torch.Tensor, *args) -> None:
        with torch.cuda.device(t.device):
            rc = self.fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} kernel launch failed: CUDA error {rc}")
