from .base_exp import BaseExp, get_exp, get_exp_by_file, get_exp_by_name, register_exp
from .yolox_exp import CustomExp, CustomP6Exp, CustomP6v2Exp, Exp, SynFlowExp

# the name registry of cocodet_tpu/exp/__init__.py (ref yolox/exp/build.py:20-35)
for _name, _over in {
    "yolox-s": dict(depth=0.33, width=0.50),
    "yolox-m": dict(depth=0.67, width=0.75),
    "yolox-l": dict(depth=1.00, width=1.00),
    "yolox-x": dict(depth=1.33, width=1.25),
    "yolox-tiny": dict(depth=0.33, width=0.375, input_size=(416, 416),
                       test_size=(416, 416), enable_mixup=False, mosaic_scale=(0.5, 1.5)),
    "yolox-nano": dict(depth=0.33, width=0.25, input_size=(416, 416),
                       test_size=(416, 416), enable_mixup=False, mosaic_scale=(0.5, 1.5),
                       model_name="yolox-dw"),
}.items():
    register_exp(_name, "cocodet_tpu_torch.exp.yolox_exp.Exp", **_over)

register_exp("yolox-m-p6", "cocodet_tpu_torch.exp.yolox_exp.CustomP6Exp", depth=0.67, width=0.75)
register_exp("yolox-m-p6v2", "cocodet_tpu_torch.exp.yolox_exp.CustomP6v2Exp",
             depth=0.67, width=0.75)
register_exp("yolov3", "cocodet_tpu_torch.exp.yolox_exp.Exp", depth=1.0, width=1.0,
             model_name="yolov3")
