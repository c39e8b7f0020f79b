"""Build and load the port's CUDA kernels (route: nvcc -> shared library ->
ctypes).

Each ``cocodet_tpu_torch/csrc/<name>.cu`` becomes
``build/kernels/lib<name>-<hash>.so`` at the repository root, where the hash
covers the source, the headers beside it and the flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: a kernel's wrapper builds its library at first use, and
``build()`` builds all of them at once, one ``nvcc`` process per source,
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> Tuple[str, ...]:
    """Names of the kernel sources under csrc/ (without the .cu suffix)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    headers beside it (``csrc/*.cuh``, which a source may include) and the
    flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that has no library yet, all in parallel.

    Returns ``{name: (seconds, compiler output)}`` for what was compiled.
    Raises with the compiler's output if any build fails.
    """
    names = sources() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if missing."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
