"""VOC fine-tune example (parity: ref exps/example/yolox_voc/yolox_voc_s.py):
YOLOX-S with 20 classes, trained on VOCdevkit 2007+2012 trainval on the
host mosaic path and evaluated on 2007 test by the VOC evaluator.

The port's copy of exps/example/yolox_voc/yolox_voc_s.py, on the port's
experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.num_classes = 20
        self.depth = 0.33
        self.width = 0.50
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

    def get_dataset(self, cache: bool = False):
        from cocodet_tpu_torch.data.transforms import TrainTransform
        from cocodet_tpu_torch.data.voc import VOCDetection

        return VOCDetection(
            data_dir=os.path.join(self.data_dir or "datasets", "VOCdevkit"),
            image_sets=(("2007", "trainval"), ("2012", "trainval")),
            img_size=self.input_size,
            preproc=TrainTransform(max_labels=self.max_labels, flip_prob=self.flip_prob,
                                   hsv_prob=self.hsv_prob),
        )

    def get_evaluator(self, batch_size, is_distributed=False, testdev=False, legacy=False):
        from cocodet_tpu_torch.data.voc import VOCDetection
        from cocodet_tpu_torch.evaluators.voc_evaluator import VOCEvaluator

        dataset = VOCDetection(
            data_dir=os.path.join(self.data_dir or "datasets", "VOCdevkit"),
            image_sets=(("2007", "test"),),
            img_size=self.test_size,
        )
        return VOCEvaluator(dataset, img_size=self.test_size, conf_threshold=self.test_conf,
                            nms_threshold=self.nms_threshold, num_classes=self.num_classes,
                            batch_size=batch_size)
