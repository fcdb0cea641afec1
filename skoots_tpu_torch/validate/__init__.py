from skoots_tpu_torch.validate.metrics import (
    accuracies_from_iou,
    box_iou,
    contingency,
    f1_score,
    get_segmentation_errors,
    mask_dice,
    mask_iou,
    mask_soft_cldice,
    mask_to_bbox,
)

__all__ = [
    "accuracies_from_iou",
    "box_iou",
    "contingency",
    "f1_score",
    "get_segmentation_errors",
    "mask_dice",
    "mask_iou",
    "mask_soft_cldice",
    "mask_to_bbox",
]
