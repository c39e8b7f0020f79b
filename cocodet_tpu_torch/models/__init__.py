from .blocks import (
    Bottleneck,
    Conv2d,
    ConvBnAct,
    CSPLayer,
    DWConv,
    DWConvNoP,
    Focus,
    SPPBottleneck,
    get_activation,
    max_pool_same,
    space_to_depth,
    upsample2x,
)
from .darknet import BACKBONE_STAGES, CSPBackbone
from .head import YOLOXHead
from .pafpn import PAFPN_VARIANTS, YOLOPAFPN
from .yolox import MODEL_SPECS, ModelSpec, YOLOX, build_model
