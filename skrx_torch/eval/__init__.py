from .evaluator import (EarlyStopping, MetricReport, RankingEvaluator,
                        fused_family)

__all__ = ["EarlyStopping", "MetricReport", "RankingEvaluator",
           "fused_family"]
