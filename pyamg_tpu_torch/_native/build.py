"""How the port builds its native code: one source file compiled into a
shared library at first use, in the port's git-ignored ``_build/``
directory, named by a hash of the source and the compiler's command line,
so a change to either builds a new library and an unchanged pair reuses
the old one.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

from .. import _trace

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def shared_library(source: str, cmd: list, name: str) -> dict:
    """Run ``cmd + ["-o", <library>, source]`` unless a library built from
    this source with this command exists; return ``{"path", "seconds",
    "log"}``, where ``log`` holds the compiler's output when a build ran
    and ``seconds`` its time (0.0 where the library was found): the span
    ``native.build`` (attributes ``library`` and ``built``)."""
    with _trace.span("native.build", library=name, built=False) as span:
        digest = hashlib.sha256()
        with open(source, "rb") as f:
            digest.update(f.read())
        digest.update("\0".join(cmd).encode())
        path = os.path.join(BUILD_DIR,
                            f"lib{name}-{digest.hexdigest()[:16]}.so")
        log = ""
        if not os.path.exists(path):
            span.attrs["built"] = True
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run([*cmd, "-o", tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                                   f"({proc.returncode}):\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, path)
            log = proc.stdout + proc.stderr
    if not span.attrs["built"]:
        return {"path": path, "seconds": 0.0, "log": ""}
    _trace.count("native.builds")
    return {"path": path, "seconds": span.seconds, "log": log}


# nvcc for Hopper: sm_90a, a plain C ABI in a shared library; -Xptxas -v
# puts each kernel's registers and spills into the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def cuda_library(source: str, name: str) -> dict:
    """``shared_library`` of a CUDA source, compiled with ``nvcc`` for
    ``sm_90a`` (the CUDA toolkit is needed at first use)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return shared_library(source, [nvcc, *NVCC_FLAGS], name)
