"""Numerical operators of the port: distances, batched linear algebra and
the native (C++ / CUDA) libraries it builds at first use."""
from __future__ import annotations

import hashlib
import os
import subprocess

__all__ = ["build_shared_library", "host_cpu_flags"]

#: git-ignored directory that holds every library the port builds
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def host_cpu_flags() -> str:
    """The host CPU's feature flags (Linux), for digests of ``-march=native``
    builds: a library tuned for one CPU must not be loaded on another."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


def build_shared_library(name: str, sources: list[str], cmd: list[str],
                         timeout: float, key: str = "") -> tuple[str, str]:
    """Compile ``sources`` into ``_build/<name>_<digest>.so`` unless it exists.

    ``cmd`` is the compiler command without its ``-o`` output and sources.
    The digest covers the command, ``key`` and the sources' bytes, so an
    edited source or flag builds a new file and a stale library is never
    loaded.
    The compiler writes to a private temporary name that is renamed into
    place, so concurrent test workers never load a half-written file.
    Returns ``(path, compiler output)``; the output is empty when the
    library was already built. Raises ``RuntimeError`` if compiling fails.
    """
    h = hashlib.sha256((" ".join(cmd) + key).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(cmd + ["-o", tmp] + sources, capture_output=True,
                              text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {name} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr
