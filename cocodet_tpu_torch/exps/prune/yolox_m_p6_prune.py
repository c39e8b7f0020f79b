"""Channel-pruning run config, the port's copy of
exps/prune/yolox_m_p6_prune.py: the Pruner's schedule on the competition
YOLOX-M-P6 (core/pruner.py)."""

import os

from cocodet_tpu_torch.exp import CustomP6Exp


class Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.init_ckpt = "weights/best_ckpt.msgpack"  # teacher + student init
        self.max_epoch = 30
        self.no_aug_epochs = 30          # pruning runs without mosaic
        self.basic_lr_per_img = 0.001 / 64.0
        self.warmup_epochs = 0
        self.ema = False                  # forced off by the Pruner anyway

        # the pruning schedule (ref pruner.py:362-448)
        self.prune_interval = 0.5         # fraction of an epoch between prunes
        self.prune_channels = 64          # channels removed per prune event
        self.prune_start_epoch = 0
        self.prune_end_epoch = None       # epochs from here train without new
        # prune events (None: prune to the end, as the reference does)
        self.prune_score_batches = 8

        # the ranking (beyond the reference's raw global sort)
        self.prune_site_floor = 8         # min alive channels per conv site
        self.prune_max_frac = 0.75        # cap on the pruned share of a site
        self.prune_normalize = "mean"     # scale-free cross-site ranking

        self.eval_interval = 1
