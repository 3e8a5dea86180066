from .dataset import CFData, ImplicitFeedback, PaddedPositives, RSDataset
from . import synthetic

__all__ = ["CFData", "ImplicitFeedback", "PaddedPositives", "RSDataset",
           "synthetic"]
