"""The prune CLI (tools/prune.py) on the port: the argument surface of
``tools/train.py`` running the Pruner (iterative channel pruning with
distillation, core/pruner.py):

    python -m cocodet_tpu_torch.tools.prune \
        -f cocodet_tpu_torch/exps/prune/yolox_m_p6_prune.py -b 16 \
        data_dir <COCO dir> init_ckpt <checkpoint>

It prunes on the card (``-d N``: N ranks, as ``tools/train.py``); ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, rank_hook: Optional[Callable] = None):
    """Parse ``argv`` (default: the command line), build the exp and run
    the Pruner (``tools/train.py::launch``: ``-d`` ranks on this host);
    returns it, or the ``TrainRun`` of several ranks (``rank_hook``:
    ``launch``'s)."""
    from cocodet_tpu_torch.core.pruner import Pruner
    from cocodet_tpu_torch.tools.train import launch

    return launch(Pruner, argv, rank_hook)


if __name__ == "__main__":
    main()
