from .blocks import (
    Bottleneck,
    Conv2d,
    ConvBnAct,
    CSPLayer,
    DWConv,
    DWConvNoP,
    Focus,
    ResLayer,
    SPPBottleneck,
    get_activation,
    max_pool_same,
    space_to_depth,
    upsample2x,
)
from .anchor_zoo import (
    ANCHOR_MODELS,
    AffineGate,
    AnchorDetector,
    BottleneckCSP,
    BottleneckCSP2,
    C3,
    SPPCSP,
    SPPF,
    VBottleneck,
    VConv,
    build_anchor_model,
    decode_anchor_outputs,
    make_divisible,
    mish,
)
from .darknet import BACKBONE_STAGES, CSPBackbone, Darknet
from .head import YOLOXHead
from .pafpn import PAFPN_VARIANTS, YOLOPAFPN
from .yolo_fpn import YOLOFPN
from .yolox import MODEL_SPECS, ModelSpec, YOLOX, build_model
