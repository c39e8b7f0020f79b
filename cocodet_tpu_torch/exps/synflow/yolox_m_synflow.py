"""SynFlow pruning config, the port's copy of exps/synflow/yolox_m_synflow.py
(YOLOX-M: three levels, depth 0.67, width 0.75; ref exps/prune/
yolox_l_synflow.py), on the port's experiment classes: 100 scoring rounds
to half the masked kernels' weights, at epoch 10."""

import os

from cocodet_tpu_torch.exp import SynFlowExp


class Exp(SynFlowExp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.prune_iters = 100
        self.prune_ratio = 0.5
        self.prune_epoch = 10
