"""Build and load the port's host (CPU) native libraries (route: g++ ->
shared library -> ctypes), the counterpart of ``ops/cuda/build.py`` for
``cocodet_tpu_torch/csrc/host/*.cpp``.

Each ``csrc/host/<name>.cpp`` becomes ``build/host/lib<name>-<hash>.so`` at
the repository root, where the hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: a binding loads its library at first use,
and ``build()`` builds all of them at once, one ``g++`` process per source,
started together. The flags are those of the JAX package's native builds
(cocodet_tpu/layers/fast_preproc/__init__.py:29-33), so the letterbox copied
from it rounds the same way.

There is no quiet fallback: a library that fails to build, or fails its
binding's load-time probe, raises (the JAX package's bindings return None
there and its callers take the plain versions unasked).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Tuple[str, ...]:
    """Names of the host sources under csrc/host/ (without the .cpp suffix)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cpp")))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source that has no library yet, all in parallel.
    Returns ``{name: seconds}`` for what was compiled; raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(CSRC / f"{name}.cpp"), "-o", str(tmp)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            failed.append(f"{name}.cpp (g++ exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        done[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("host library build failed:\n" + "\n".join(failed))
    return done


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/host/<name>.cpp``, built first if missing.
    ``bind`` declares its functions' types and runs a probe that raises if
    the library computes wrongly; it runs once a process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _loaded[name] = lib
    return lib


def ptr(a, ctype):
    """A ctypes pointer to a numpy array's data."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))
