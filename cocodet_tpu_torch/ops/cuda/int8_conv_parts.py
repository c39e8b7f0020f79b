"""Where the int8 conv kernel's time goes, on one CUDA card.

    python3 -m cocodet_tpu_torch.ops.cuda.int8_conv_parts

Builds ``csrc/int8_conv.cu`` as it is and three variants, each with one part
taken out: the quantize of the halo patches, the wgmma products, and the
whole loop over the input channels (which leaves a block's set-up and its
epilogue). Runs each, as served (bf16, fused hard-swish), on the inputs of
the 127 w8a8 convs of one batch of 16 640x640 images through
``entry.build_headline`` (weights from numpy seed 0), and prints the device
time summed over the 127 launches. The variants compute wrong outputs; the
differences of the sums are the parts' shares. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess

from . import build, int8_conv

# The text a variant removes from csrc/int8_conv.cu (each must occur once),
# or (old, new, count) to replace.
VARIANTS = {
    "no quantize": [("      quantize_patch<__nv_bfloat16, false>(p, raw, a, scale, ct, 0);\n", "", 1),
                    ("      quantize_patch<float, false>(p, raw, a, scale, ct, 0);\n", "", 1)],
    "no products": [("          wgmma_s8<NW <= 3 ? NW : 1>(&acc[mb][0][0], da, "
                     "gmma_desc_sw32(b_addr));\n", "", 1),
                    ("          wgmma_s8<2>(&acc[mb][0][0], da, gmma_desc_sw32(b_addr));\n",
                     "", 1),
                    ("          wgmma_s8<2>(&acc[mb][2][0], da, "
                     "gmma_desc_sw32(b_addr + 64 * 32));\n", "", 1)],
    "set-up and epilogue only": [("ci < p.chunks", "ci < 0", 3)],
}


def variant_library(name: str, edits) -> ctypes.CDLL:
    src = (build.CSRC / f"{int8_conv._SOURCE}.cu").read_text()
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in the kernel {count} times")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / name.replace(" ", "_")
    stem.with_suffix(".cu").write_text(src)
    so = stem.with_suffix(".so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(stem.with_suffix(".cu"))],
                   check=True, capture_output=True)
    return int8_conv.bind(ctypes.CDLL(str(so)))


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn in ms, with the card held by a sleep kernel
    while the calls are queued (as chip_smoke.py::cuda_ms)."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import numpy as np
    import torch

    from ...entry import build_headline
    from ...models.blocks import Conv2d

    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_parts: no CUDA device")
    libs = {"whole kernel": int8_conv._lib()}
    libs.update({name: variant_library(name, edits) for name, edits in VARIANTS.items()})
    model = build_headline(device="cuda").model
    calls = []
    for m in model.modules():
        if isinstance(m, Conv2d) and m.quant == "w8a8":
            m.register_forward_hook(lambda mod, args, out: calls.append((mod, args[0], out.dtype)))
    images = np.random.RandomState(4).uniform(0, 255, (16, 640, 640, 3)).astype(np.float32)
    with torch.inference_mode():
        model(torch.from_numpy(images).cuda())
    if len(calls) != 127:
        raise SystemExit(f"int8_conv_parts: {len(calls)} w8a8 convs, expected 127")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0])
    for name, lib in libs.items():
        int8_conv._lib = lambda lib=lib: lib  # the wrapper launches this library
        total, seen = 0.0, {}
        with torch.inference_mode():
            for m, x, dtype in calls:
                key = (tuple(x.shape), x.dtype, tuple(m.weight.shape), m.stride)
                if key not in seen:
                    seen[key] = device_ms(lambda: int8_conv.conv2d_w8a8(
                        x, m.weight, m.act_scale, m.w_scale, m.bias.to(dtype), m.stride,
                        m.padding, dtype=dtype, act="hard_swish"))
                total += seen[key]
        print(f"{name}: {total:.4f} ms summed over the 127 launches of a batch of 16")


if __name__ == "__main__":
    main()
