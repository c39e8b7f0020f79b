"""Deployment compression of the port (counterparts of cocodet_tpu/compress):
the magnitude chain (``magnitude.py``), the BN-folded deployment tree and
channel slimming (``merge.py``), int8 PTQ (``quantize.py``) and its
quantization-aware fine-tune (``qat.py``). The weight math is numpy, so on
the same arrays it is bit-equal to the JAX package's."""

from .magnitude import (generate_magnitude_masks, inject_masks, magnitude_threshold,
                        sparsity_report)
from .merge import count_effective_params, load_slim_spec, merge_for_deployment, slim_channels
from .quantize import (build_quant_tree, calibrate, int4_kernel_paths, pack_int4_tree,
                       quantization_report, quantize_model, quantize_weights, tree_has_int4,
                       unpack_int4_tree)
from .qat import act_scale_tree, make_qat_step, qat_ema, qat_optimizer, requantize
