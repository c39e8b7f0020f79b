"""Build and run csrc/train_aug.cu's kernels on the CPU, for the tests.

The kernels' own source (without the nvcc launchers, cp.async as a copy) is
compiled by g++ against ``cuda_emu/cuda_runtime.h``, a CPU stand-in
for the CUDA it uses, with the f32 operations IEEE and uncontracted, as
nvcc's ``--fmad=false`` builds them; ``cuda_emu/train_aug_emu.cpp``
runs a block as 256 threads that meet at its barriers. Each launch runs in a
child process (``python torch_cuda_emu.py LIB FUNCTION IN OUT``) with a time
limit, so a kernel whose barriers deadlock fails its test, not the run.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE.parent / "cocodet_tpu_torch" / "csrc" / "train_aug.cu"
CXX = ("g++", "-std=c++20", "-O2", "-ffp-contract=off", "-pthread", "-shared", "-fPIC", "-w")
# each function's pointer arguments (the output last) and its count of ints
SPECS = {
    "emu_mosaic_canvas": (("tiles", "hw5", "nhw5", "yc", "xc", "out"), 5),
    "emu_affine_warp": (("canvas", "m6", "out"), 3),
    "emu_mixup": (("tiles", "hw5", "nhw5", "warped", "mrand", "out"), 7),
    "emu_train_aug": (("img", "hw", "nhw", "gains", "flip", "fallback", "out"), 5),
}


def kernels_source() -> str:
    """train_aug.cu's kernels and helpers, as g++ takes them."""
    src = SOURCE.read_text()
    src = src[:src.index("}  // namespace")].replace("namespace {", "")
    src, n1 = re.subn(r"(__device__ __forceinline__ void cp_async16\(void\* smem, const void\* "
                      r"gmem\) \{).*?\n\}", r"\1 memcpy(smem, gmem, 16); }", src, flags=re.S)
    src, n2 = re.subn(r"(__device__ __forceinline__ void cp_async_wait_all\(\) \{).*?\n\}",
                      r"\1 }", src, flags=re.S)
    if (n1, n2) != (1, 1):
        raise RuntimeError("train_aug.cu: cp_async16 or cp_async_wait_all not found")
    return src


def build(out_dir: Path) -> Path:
    """Compile the emulated kernels into ``out_dir``; raises with g++'s output."""
    out_dir = Path(out_dir)
    (out_dir / "kernels.inc").write_text(kernels_source())
    lib = out_dir / "libtrain_aug_emu.so"
    cmd = [*CXX, f"-I{HERE / 'cuda_emu'}", f"-I{out_dir}", "-o", str(lib),
           str(HERE / "cuda_emu" / "train_aug_emu.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    return lib


def run(lib: Path, function: str, inputs, out_shape, out_dtype, ints, timeout=300.0):
    """One launch of ``function`` on numpy ``inputs`` (its pointer arguments
    but the output, in order), in a child process: the output array."""
    names, n_ints = SPECS[function]
    if len(inputs) != len(names) - 1 or len(ints) != n_ints:
        raise ValueError(f"{function}: {len(names) - 1} arrays and {n_ints} ints")
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {n: np.ascontiguousarray(a) for n, a in zip(names, inputs)}
        arrays["out"] = np.zeros(out_shape, out_dtype)
        arrays["ints"] = np.asarray(ints, np.int64)
        np.savez(Path(tmp) / "in.npz", **arrays)
        cmd = [sys.executable, __file__, str(lib), function, str(Path(tmp) / "in.npz"),
               str(Path(tmp) / "out.npy")]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"{function} failed ({res.returncode}):\n{res.stderr}")
        return np.load(Path(tmp) / "out.npy")


def _child(lib: str, function: str, inp: str, out: str) -> None:
    names, _ = SPECS[function]
    data = np.load(inp)
    arrays = [np.ascontiguousarray(data[n]) for n in names]
    ints = [int(v) for v in data["ints"]]
    fn = getattr(ctypes.CDLL(lib), function)
    fn.argtypes = [ctypes.c_void_p] * len(arrays) + [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_int
    rc = fn(*[a.ctypes.data for a in arrays], *ints)
    if rc != 0:
        raise SystemExit(f"{function} returned {rc}")
    np.save(out, arrays[-1])


if __name__ == "__main__":
    _child(*sys.argv[1:5])
