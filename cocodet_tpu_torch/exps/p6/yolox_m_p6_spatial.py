"""YOLOX-M-P6 phase-1 training on a (data x space) mesh of ranks: the
port's copy of exps/p6/yolox_m_p6_spatial.py.

``spatial_devices`` 2 splits each image's height over two ranks of a data
row (``parallel/mesh.py::make_mesh_2d``): each rank holds half the rows of
every activation, with the conv halos exchanged between them, and the step
is the one-process step on the global batch. The device mosaic runs the
mosaic, affine, mixup, letterbox, HSV and flip on the card; the host keeps
the decode and the draws. Multiscale runs at stride 128 so that every
bucket (640/768/896) keeps at least two evenly divided rows of the
stride-64 map on each space rank (``Trainer._check_spatial_sizes``).

    python -m cocodet_tpu_torch.tools.train -f cocodet_tpu_torch/exps/p6/yolox_m_p6_spatial.py \
        -d 8 -b 128 data_dir <COCO dir>          # a (4 data x 2 space) mesh
"""

import os

from cocodet_tpu_torch.exps.p6.yolox_m_p6 import Exp as _BaseExp


class Exp(_BaseExp):
    def __init__(self):
        super().__init__()
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
        # 2 spatial columns; the data axis takes the remaining ranks
        self.spatial_devices = 2
        # decode and draws on the host; the rest as CUDA kernels on the card
        self.device_mosaic = True
        # stride-128 multiscale so every bucket passes the spatial guard
        self.multiscale_step = 128
        self.multiscale_range = (-1, 1)  # 640 / 768 / 896
