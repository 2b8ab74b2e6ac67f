"""Build the port's native ingest library with the host's g++.

    g++ -O3 -std=c++17 -march=native -shared -fPIC -pthread \
        -o motionstyle_torch/_build/ingest-<hash>.so native/src/ingest.cc

No pybind11 and no Python.h: native/ingest.py binds the extern "C" symbols
with ctypes. The library goes to motionstyle_torch/_build/ (listed in
.gitignore), named by a hash of the source, the flags and, with
-march=native, the host CPU's feature flags, so an edited source or another
CPU builds anew and an unchanged one loads from the file. Where g++ refuses
-march=native (an emulated or cross host) the build is retried without it,
as motionstyle/native/build.py does. A build that fails raises with the
compiler's message: nothing falls back to numpy behind the caller's back.
Building happens at first use, never at import.
"""
from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(NATIVE_DIR, "src", "ingest.cc")
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "_build")
CXX = "g++"
BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ARCH_FLAG = "-march=native"

_lock = threading.Lock()
# what the last build() of this process took: path, flags, compile seconds
last_build: dict = {}


def _cpu_features() -> str:
    """The host CPU's feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path(flags: tuple) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    if ARCH_FLAG in flags:
        digest.update(_cpu_features().encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"ingest-{digest.hexdigest()[:16]}.so")


def _compile(flags: tuple, out: str) -> subprocess.CompletedProcess:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *flags, SRC, "-o", tmp], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        return proc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build() -> tuple:
    """The library's path, built if missing: with -march=native first, then
    without it. Returns (path, flags, seconds spent compiling; 0.0 when the
    library was already built). Raises RuntimeError with the compiler's
    message when no build succeeds."""
    with _lock:
        tries = [BASE_FLAGS[:2] + (ARCH_FLAG,) + BASE_FLAGS[2:], BASE_FLAGS]
        for flags in tries:
            if os.path.exists(library_path(flags)):
                last_build.update(path=library_path(flags), flags=flags, seconds=0.0)
                return library_path(flags), flags, 0.0
        if shutil.which(CXX) is None:
            raise RuntimeError(f"the native loader needs {CXX}, which this host lacks")
        errors = []
        t0 = time.perf_counter()
        for flags in tries:
            out = library_path(flags)
            proc = _compile(flags, out)
            if proc.returncode == 0:
                secs = time.perf_counter() - t0
                last_build.update(path=out, flags=flags, seconds=secs)
                return out, flags, secs
            errors.append(f"$ {CXX} {' '.join(flags)} {SRC}\n{proc.stderr.strip()}")
        raise RuntimeError("building the native ingest library failed:\n" + "\n".join(errors))


if __name__ == "__main__":
    path, flags, secs = build()
    print(f"{path} ({' '.join(flags)}; {secs:.3f} s)")
