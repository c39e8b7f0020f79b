"""Deployment compression of the port (counterparts of cocodet_tpu/compress):
the magnitude chain (``magnitude.py``), the BN-folded deployment tree and
channel slimming (``merge.py``), int8 PTQ (``quantize.py``). The weight
math is numpy, so on the same arrays it is bit-equal to the JAX package's."""

from .magnitude import (generate_magnitude_masks, inject_masks, magnitude_threshold,
                        sparsity_report)
from .merge import count_effective_params, load_slim_spec, merge_for_deployment, slim_channels
from .quantize import (build_quant_tree, calibrate, quantization_report,
                       quantize_model, quantize_weights)
