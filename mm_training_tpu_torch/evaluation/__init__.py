from .bev_map import MAPCalculator, box_iou_aabb, cosine_similarity, evaluate_ap, obj2arrays_bev

__all__ = ['MAPCalculator', 'box_iou_aabb', 'cosine_similarity', 'evaluate_ap', 'obj2arrays_bev']
