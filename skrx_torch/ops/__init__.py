from .initializers import get_initializer
from .metrics import mask_items, topk_scores_and_indices

__all__ = ["get_initializer", "mask_items", "topk_scores_and_indices"]
