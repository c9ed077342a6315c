"""Build and load the CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/kernels/lib<name>_<hash>.so`` at the repository root, then
loaded with ``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt at its
first use and an unchanged one is reused.
Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: sm_90a: Hopper with its architecture-specific features; --fmad=false keeps
#: every product rounded before the sum, as PyTorch's elementwise ops do
#: (see the numerics note in csrc/slab_march.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already there
    log: str  # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str, csrc: Path = CSRC) -> Built:
    """Compile ``<csrc>/<name>.cu`` unless an up-to-date library exists.
    nvcc's output is kept beside the library (``.log``), so a reused build
    still reports its registers and spills."""
    src = Path(csrc) / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(Path(csrc).glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return Built(out, 0.0, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Built(out, time.perf_counter() - t0, log.read_text())


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    return ctypes.CDLL(str(build(name).path))
