"""Build and run csrc/train_aug.cu's, csrc/bn_act.cu's and
csrc/soft_nms.cu's kernels on the CPU, for the tests.

The kernels' own source (without the nvcc launchers, cp.async as a copy) is
compiled by g++ against ``cuda_emu/cuda_runtime.h``, a CPU stand-in
for the CUDA it uses, with the f32 operations IEEE and uncontracted, as
nvcc's ``--fmad=false`` builds them; ``cuda_emu/train_aug_emu.cpp``
runs a block as 256 threads that meet at its barriers, and
``cuda_emu/bn_act_emu.cpp`` a cluster's CTAs at once, each with its own
shared memory; ``cuda_emu/soft_nms_emu.cpp`` a block as 288 threads, a
warp's 32 of them meeting at each ``__ballot_sync``.
Each launch runs in a child process (``python
torch_cuda_emu.py LIB FUNCTION IN OUT``) with a time limit, so a kernel
whose barriers deadlock fails its test, not the run.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "cocodet_tpu_torch" / "csrc"
# -fno-strict-aliasing: the kernels load and store 16-byte vectors through a
# uint4 view of an array of another type, as CUDA code does (nvcc keeps
# those accesses; g++ at -O2 may drop the reads that follow them)
CXX = ("g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
       "-shared", "-fPIC", "-w")
# each function's pointer arguments (the output last) and its count of ints
SPECS = {
    "emu_mosaic_canvas": (("tiles", "hw5", "nhw5", "yc", "xc", "out"), 5),
    "emu_affine_warp": (("canvas", "m6", "out"), 3),
    "emu_mixup": (("tiles", "hw5", "nhw5", "warped", "mrand", "out"), 7),
    "emu_train_aug": (("img", "hw", "nhw", "gains", "flip", "fallback", "out"), 5),
    "emu_soft_decay": (("boxes", "valid", "scores", "out"), 2),
}


# Per source, the device functions the CPU cannot run (inline PTX, the
# dynamic shared memory), each with the body it runs instead
STUBS = {
    "train_aug": {"void cp_async16(void* smem, const void* gmem)": "memcpy(smem, gmem, 16);",
                  "void cp_async_wait_all()": ""},
    "bn_act": {"void cp_async16(void* smem, const void* gmem)": "memcpy(smem, gmem, 16);",
               "void cp_async_commit()": "", "void cp_async_wait(int n)": "(void)n;",
               "uint8_t* resident_smem()": "return emu_dynamic_smem();"},
    "soft_nms": {},
}


def kernels_source(name: str = "train_aug") -> str:
    """The kernels and helpers of ``csrc/<name>.cu`` (everything before the
    first anonymous namespace closes: the nvcc launchers come after), as g++
    takes them, with the bodies of STUBS[name]."""
    src = (CSRC / f"{name}.cu").read_text()
    src = src[:src.index("}  // namespace")].replace("namespace {", "")
    for sig, body in STUBS[name].items():
        head = f"__device__ __forceinline__ {sig}"
        src, n = re.subn(re.escape(head) + r" \{.*?\n\}", lambda _: f"{head} {{ {body} }}",
                         src, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{name}.cu: {sig!r} found {n} times")
    return src


def build(out_dir: Path, name: str = "train_aug") -> Path:
    """Compile the emulated kernels of ``csrc/<name>.cu`` into ``out_dir``;
    raises with g++'s output."""
    out_dir = Path(out_dir)
    (out_dir / "kernels.inc").write_text(kernels_source(name))
    lib = out_dir / f"lib{name}_emu.so"
    cmd = [*CXX, f"-I{HERE / 'cuda_emu'}", f"-I{out_dir}", f"-I{CSRC}", "-o", str(lib),
           str(HERE / "cuda_emu" / f"{name}_emu.cpp")]
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


def run_struct(lib: Path, function: str, args: ctypes.Structure, arrays: dict,
               timeout: float = 120.0) -> dict:
    """One launch of ``function(const Args*)`` in a child process: ``args``
    a ctypes struct whose pointer fields named in ``arrays`` point at those
    numpy arrays (the others null). Returns every array as the launch left
    it."""
    fields = {n: getattr(type(args), n).offset for n, _ in args._fields_}
    for n in arrays:
        if n not in fields:
            raise ValueError(f"{function}: no field {n!r}")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "in.npz", **{n: np.ascontiguousarray(a) for n, a in arrays.items()})
        (Path(tmp) / "args.json").write_text(json.dumps(
            {"bytes": bytes(args).hex(), "offsets": {n: fields[n] for n in arrays}}))
        cmd = [sys.executable, __file__, str(lib), function, tmp, "struct"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"{function} failed ({res.returncode}):\n{res.stderr}")
        with np.load(Path(tmp) / "out.npz") as out:
            return {n: out[n] for n in out.files}


def _child_struct(lib: str, function: str, tmp: str) -> None:
    data = np.load(Path(tmp) / "in.npz")
    arrays = {n: np.ascontiguousarray(data[n]) for n in data.files}
    spec = json.loads((Path(tmp) / "args.json").read_text())
    raw = ctypes.create_string_buffer(bytes.fromhex(spec["bytes"]))
    for n, off in spec["offsets"].items():
        ctypes.c_void_p.from_buffer(raw, off).value = arrays[n].ctypes.data
    fn = getattr(ctypes.CDLL(lib), function)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.addressof(raw))
    if rc != 0:
        raise SystemExit(f"{function} returned {rc}")
    np.savez(Path(tmp) / "out.npz", **arrays)


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
    if sys.argv[4:] == ["struct"]:
        _child_struct(*sys.argv[1:4])
    else:
        _child(*sys.argv[1:5])
