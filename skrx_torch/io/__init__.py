from .batch_iterator import BatchIterator
from .dataset import (CFData, ImplicitFeedback, KGData, KnowledgeGraph,
                      MMData, PaddedPositives, RSDataset, SocialData,
                      SocialNetwork, UserGroup, group_users_by_interactions)
from .data_iterator import (InteractionIterator, ItemVecIterator,
                            KGPairwiseIterator, PairwiseIterator,
                            PointwiseIterator, SequentialPairwiseIterator,
                            SequentialPointwiseIterator, UserVecIterator)
from .preprocessor import Preprocessor
from .movielens import MovieLens100k
from . import synthetic
# Logger lives in utils and is re-exported here, as the JAX package does
from ..utils.logger import Logger

__all__ = ["BatchIterator", "CFData", "ImplicitFeedback", "KGData",
           "KnowledgeGraph", "MMData", "PaddedPositives", "RSDataset",
           "SocialData", "SocialNetwork", "UserGroup",
           "group_users_by_interactions", "InteractionIterator",
           "ItemVecIterator", "KGPairwiseIterator", "PairwiseIterator",
           "PointwiseIterator", "SequentialPairwiseIterator",
           "SequentialPointwiseIterator", "UserVecIterator", "Preprocessor",
           "MovieLens100k", "synthetic", "Logger"]
