from .base import TorchRecommender
from .common import ChunkedDotPredictMixin

__all__ = ["TorchRecommender", "ChunkedDotPredictMixin"]
