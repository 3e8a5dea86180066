from .evaluator import EarlyStopping, MetricReport, RankingEvaluator

__all__ = ["EarlyStopping", "MetricReport", "RankingEvaluator"]
