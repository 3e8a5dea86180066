from .dataset import (CFData, ImplicitFeedback, MMData, PaddedPositives,
                      RSDataset, UserGroup, group_users_by_interactions)
from . import synthetic

__all__ = ["CFData", "ImplicitFeedback", "MMData", "PaddedPositives",
           "RSDataset", "UserGroup", "group_users_by_interactions",
           "synthetic"]
