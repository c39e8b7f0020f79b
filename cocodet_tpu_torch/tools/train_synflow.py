"""The SynFlow training CLI (tools/train_synflow.py) on the port: the
argument surface of ``tools/train.py`` running ``TrainerSynFlow``
(core/trainer_synflow.py):

    python -m cocodet_tpu_torch.tools.train_synflow \
        -f cocodet_tpu_torch/exps/synflow/yolox_m_synflow.py -b 16 data_dir <COCO dir>

It trains on the card (``-d N``: N ranks, as ``tools/train.py``); ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, rank_hook: Optional[Callable] = None):
    """Parse ``argv`` (default: the command line), build the exp and run
    the TrainerSynFlow (``tools/train.py::launch``: ``-d`` ranks on this host);
    returns it, or the ``TrainRun`` of several ranks (``rank_hook``:
    ``launch``'s)."""
    from cocodet_tpu_torch.core.trainer_synflow import TrainerSynFlow
    from cocodet_tpu_torch.tools.train import launch

    return launch(TrainerSynFlow, argv, rank_hook)


if __name__ == "__main__":
    main()
