"""Host-side native code of the port: the C++ PNG codec, antialiased resize
and threaded batch decoder (``png_codec.cc``, a copy of the JAX package's
``pai_tpu/native/png_codec.cc`` with the same C interface), bound with
``ctypes`` in ``png_native.py``.

The library is compiled with the host's C++ compiler (``$CXX``, else ``g++``
or ``c++`` on ``PATH``) the first time it is needed, never at import, with
the flags of ``pai_tpu/native/Makefile``, into ``build/`` next to this file
(git-ignored). Its name carries a digest of the source and the flags, so an
edited source is rebuilt; it is written to a temporary file and renamed into
place, with the compiler's stderr kept beside it, so processes that build at
once never load half a file. A build that fails raises ``NativeBuildError``
with the compiler's stderr: nothing stands in for the codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "png_codec.cc")
BUILD_DIR = os.path.join(_HERE, "build")

CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lz", "-lpthread")

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused the source; carries its
    stderr."""


def find_compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name:
            found = shutil.which(name)
            if found:
                return found
    raise NativeBuildError(
        "no C++ compiler found ($CXX, g++, c++ on PATH): pai_tpu_torch's PNG "
        "codec is built from source at first use")


def library_path(build_dir: str = BUILD_DIR) -> str:
    """The library's path, named by a digest of the source and the flags."""
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir,
                        f"libpai_png_codec_{digest.hexdigest()[:16]}.so")


def build(compiler: Optional[str] = None, build_dir: str = BUILD_DIR) -> str:
    """Compile the codec unless its library (and build log) exist; return the
    library's path. ``compiler`` defaults to ``find_compiler()``."""
    global build_seconds
    out = library_path(build_dir)
    if os.path.exists(out) and os.path.exists(out + ".log"):
        return out
    os.makedirs(build_dir, exist_ok=True)
    start = time.perf_counter()
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler or find_compiler(), *CXXFLAGS, SOURCE, *LDFLAGS,
           "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:  # the compiler does not exist or cannot run
        raise NativeBuildError(f"{' '.join(cmd)}\n{exc}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stderr)
    # log first: a reader never sees a library without its log
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - start
    return out


def load_library() -> ctypes.CDLL:
    """The codec's ``ctypes`` handle, built first if need be. The caller
    declares ``argtypes``/``restype`` (``png_native._lib``)."""
    global _library
    with _lock:
        if _library is None:
            _library = ctypes.CDLL(build())
        return _library
