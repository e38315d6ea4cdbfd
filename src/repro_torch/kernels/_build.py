"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``repro_torch/csrc/<name>.cu`` becomes one shared library with a plain
C interface, ``build/repro_torch_kernels/<hash>/lib<name>.so`` under the
checkout root, where ``<hash>`` covers every source and the flags, so an
edited source builds anew and an unchanged one is reused.  All sources are
compiled at first use, one nvcc process each, started together.  A failed
build raises with nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's stderr per source (ptxas: registers, shared memory, spills), kept
#: as ``lib<name>.log`` beside each library and read back when it is reused
BUILD_LOGS: Dict[str, str] = {}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (one nvcc per source, in parallel) and
    load all of them; returns ``{name: CDLL}``."""
    with _lock:
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        pending = {}
        for src in _sources():
            lib = out_dir / f"lib{src.stem}.so"
            if src.stem in _libs or lib.exists():
                log = lib.with_suffix(".log")
                if src.stem not in BUILD_LOGS and log.exists():
                    BUILD_LOGS[src.stem] = log.read_text()
                continue
            tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            pending[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in pending.items():
            stdout, stderr = proc.communicate()
            BUILD_LOGS[name] = stdout + stderr
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu (exit "
                              f"{proc.returncode}):\n{stderr}")
                continue
            lib.with_suffix(".log").write_text(BUILD_LOGS[name])
            os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in _sources():
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
