from .bev_map import MAPCalculator, box_iou_aabb, cosine_similarity, evaluate_ap, obj2arrays_bev
from .nuscenes_eval import NuScenesEvaluator, format_results

__all__ = ['MAPCalculator', 'NuScenesEvaluator', 'box_iou_aabb', 'cosine_similarity',
           'evaluate_ap', 'format_results', 'obj2arrays_bev']
