"""Build-on-first-use of the port's native sources: the CUDA kernels
(``csrc/*.cu``, with ``nvcc``) and the host pass (``native/*.cpp``, with
``g++``).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so``, where the hash covers the source and the
compiler flags, so an edited source rebuilds and an unchanged one is
reused. :func:`build` starts one ``nvcc`` per source, all at once, and
waits for them; :func:`library` builds one source if needed and loads it
with ctypes. A missing ``nvcc`` or a failed build raises: there is no
version of the port that runs on the card without its kernels.

:func:`native_library` does the same for ``native/<name>.cpp`` with
``g++ -O3 -march=native``; its hash also covers the host CPU's model and
feature flags, so a tree copied to another machine rebuilds instead of
running code built for another instruction set. The build writes a
temporary file and renames it under a file lock, so processes that build
at once (test workers) never load a half-written library. A missing
``g++`` or a failed build raises here; the caller
(``native/__init__.py``) falls back to the Python pass.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "_build"

#: ``sm_90a`` keeps Hopper's arch-specific instructions available to the
#: kernels; ``-Xptxas -v`` puts registers, shared memory and spills of each
#: kernel into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: The host pass: optimised for the CPU that builds it.
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Compiler output (the ptxas resource report) of every build this
#: process ran, by source name.
build_logs: Dict[str, str] = {}


def sources() -> list:
    """Names (file stems) of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started: tuple) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)


def build(names: Optional[Iterable[str]] = None) -> float:
    """Build the named sources (default: all) that are not built yet, one
    ``nvcc`` each, all started together. Returns the seconds it took."""
    t0 = time.perf_counter()
    names = list(sources() if names is None else names)
    started = {}
    try:
        for name in names:
            s = _start(name)
            if s is not None:
                started[name] = s
    finally:
        # Every process started is waited for, even when a later start
        # failed, so no compiler outlives the call.
        errors = []
        for name, s in started.items():
            try:
                _finish(name, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def host_cpu_model() -> str:
    """The host CPU's model name and feature flags (``/proc/cpuinfo``),
    which ``-march=native`` compiles for."""
    fields: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    fields.setdefault(key, value.strip())
    except OSError:
        pass
    return "|".join(f"{k}={fields[k]}" for k in sorted(fields)) or (
        f"{platform.machine()}|{platform.processor()}"
    )


def native_library_path(name: str) -> Path:
    """Where the built library of ``native/<name>.cpp`` lives for this
    host."""
    h = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(host_cpu_model().encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build_native(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native host pass cannot "
                               "be built")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [gxx, *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed on native/{name}.cpp (exit {proc.returncode}):\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)


def native_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use."""
    key = f"native/{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            out = native_library_path(name)
            if not out.exists():
                _build_native(name, out)
            lib = ctypes.CDLL(str(out))
            _libs[key] = lib
        return lib
