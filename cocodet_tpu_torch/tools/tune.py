"""The tune CLI (tools/tune.py) on the port: the argument surface of
``tools/train.py`` running the Tuner (fine-tuning with optional
distillation, core/tuner.py):

    python -m cocodet_tpu_torch.tools.tune \
        -f cocodet_tpu_torch/exps/tune/yolox_m_p6_tune_distill.py -b 16 \
        data_dir <COCO dir> init_ckpt <the Pruner's checkpoint>

It tunes on the card; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default: the command line), build the exp and run
    the Tuner (``tools/train.py::launch``: ``-d`` ranks on this host);
    returns it, or the ``TrainRun`` of several ranks."""
    from cocodet_tpu_torch.core.tuner import Tuner
    from cocodet_tpu_torch.tools.train import launch

    return launch(Tuner, argv)


if __name__ == "__main__":
    main()
