"""Hand-written CUDA kernels for Hopper — the native compute tier of the port
(the JAX package's counterpart is its Pallas tier, ``pai_tpu/kernels``).

The sources live in ``csrc/`` (``*.cu``, and ``*.cuh`` headers they share)
and are compiled for ``sm_90a`` with ``nvcc`` the first time a kernel is
launched, one ``nvcc`` process per source file, all started together, into
``build/`` next to this file (git-ignored). nvcc's stderr of each build,
``ptxas``'s resource report (registers, spills per kernel instantiation)
among it, is kept beside the library and read with ``build_log``. Each source
exposes a plain C interface and is loaded with ``ctypes``; nothing is built or
loaded when a module is imported, so hosts without a CUDA toolkit can import
every module of the package.

Each kernel ships with a plain PyTorch version of the same function in the
same module. A wrapper takes the plain version only for a tensor that lies on
the CPU; for a CUDA tensor it launches the kernel or raises. There is no
switch that forces the plain version on the card.

``launch_counts`` holds one plain integer per kernel; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels. Under a CUDA graph's capture a wrapper's launch is
recorded, not run: ``captured_launches`` takes those adds back and keeps
them with the graph, and each replay adds them again (``add_launches``), so
the counts stay the launches that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterator, Mapping, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One library per source file: name -> source under csrc/.
SOURCES = {"ssim": "ssim.cu", "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_split": "flash_split.cu"}

launch_counts: Dict[str, int] = {"ssim_map": 0, "ssim_scalar": 0,
                                 "flash_fwd": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0, "flash_split": 0}

# Floating-point operations of the kernels launched so far that PyTorch's
# ``FlopCounterMode`` cannot see (a ``ctypes`` launch is opaque to it). A
# wrapper adds its launch's operations where it adds to ``launch_counts``;
# ``utils.flops.count_flops`` zeroes this before a forward and adds it after.
launched_flops: int = 0

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None  # wall time of the nvcc builds, once built


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source; carries the compiler's stderr."""


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph's capture: yields a dict that holds, once the
    block has ended, the launches the capture recorded per kernel (what each
    replay runs); the counts (and ``launched_flops``) are as before the
    block."""
    global launched_flops
    before, flops = dict(launch_counts), launched_flops
    recorded: Dict[str, int] = {}
    yield recorded
    for name in launch_counts:
        recorded[name] = launch_counts[name] - before[name]
        launch_counts[name] = before[name]
    launched_flops = flops


def add_launches(recorded: Mapping[str, int]) -> None:
    """One replay of a graph whose capture recorded ``recorded``."""
    for name, count in recorded.items():
        launch_counts[name] += count


def find_nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelCompileError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of pai_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def _library_path(name: str) -> str:
    """The library's path, named by a digest of its source, every shared
    header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpai_{name}_{digest.hexdigest()[:16]}.so")


def _build_all() -> None:
    """Compile every source whose library is missing, in parallel."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    jobs = []
    for name, source in SOURCES.items():
        out = _library_path(name)
        if os.path.exists(out) and os.path.exists(out + ".log"):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        jobs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, cmd, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{stderr}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(stderr)
            # atomic, log first: a reader never sees half a file, nor a
            # library without its log
            os.replace(f"{tmp}.log", out + ".log")
            os.replace(tmp, out)
    if failures:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failures))
    if build_seconds is None:
        build_seconds = time.perf_counter() - start


def build_log(name: str) -> str:
    """nvcc's stderr of the build of one kernel library (with ``-Xptxas -v``:
    registers and spills of every kernel instantiation), built first if need
    be; it is kept beside the library, so it outlives the process that built
    it."""
    load_library(name)
    with open(_library_path(name) + ".log") as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built first if need be. The
    caller declares ``argtypes``/``restype`` of the functions it uses."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            _build_all()
            lib = ctypes.CDLL(_library_path(name))
            _libraries[name] = lib
        return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA error {code} at launch (the kernel did not run)")
