"""Deployment compression of the port: channel-slim specs and int8 PTQ
(counterparts of cocodet_tpu/compress/merge.py and quantize.py). The weight
math is numpy, so on the same statistics it is bit-equal to the JAX
package's."""

from .merge import count_effective_params, load_slim_spec
from .quantize import (build_quant_tree, calibrate, quantization_report,
                       quantize_model, quantize_weights)
