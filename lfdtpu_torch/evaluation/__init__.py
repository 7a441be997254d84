# Evaluation (`lfdtpu/evaluation/`): numpy COCO mAP and its streaming evaluator,
# the TT100K matcher and the WIDERFACE SIO writer.

from .base import Evaluator
from .coco_eval import COCOEvaluator, coco_map
from .widerface import SIO_evaluation
from .tt100k import tt100k_eval, results_to_tt100k_annos

__all__ = [
    "Evaluator",
    "COCOEvaluator",
    "coco_map",
    "SIO_evaluation",
    "tt100k_eval",
    "results_to_tt100k_annos",
]
