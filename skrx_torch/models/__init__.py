from .base import TorchRecommender
from .common import ChunkedDotPredictMixin

MODEL_NAMES = [
    "Pop", "BPRMF", "AOBPR", "FPMC", "TransRec", "CML", "CDAE", "MultVAE",
    "GRU4Rec", "GRU4RecPlus", "SASRec", "BERT4Rec", "Caser", "HGN", "SRGNN",
    "SGAT", "LightGCN", "LayerGCN", "DENS", "LightGCL", "SelfCF", "LATTICE",
    "SLMRec", "BM3", "FREEDOM", "MGCN",
]

__all__ = ["TorchRecommender", "ChunkedDotPredictMixin", "MODEL_NAMES"]


def __getattr__(name):
    """``skrx_torch.models.BPRMF`` imports the module on first use; the
    model class is ``skrx_torch.models.<Name>.<Name>`` (the registry's
    contract)."""
    if name in MODEL_NAMES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
