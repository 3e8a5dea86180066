"""Loss functions and distances, element-wise: the port of
``skrx.ops.losses`` (same names, same formulas; callers reduce)."""
import torch
import torch.nn.functional as F

__all__ = ["inner_product", "euclidean_distance", "l2_distance", "bpr_loss",
           "l2_loss", "sigmoid_cross_entropy", "square_loss", "hinge_loss",
           "top1_loss", "bpr_max_loss", "top1_max_loss", "info_nce_loss",
           "log_loss"]


def inner_product(a, b, axis: int = -1):
    return torch.sum(a * b, dim=axis)


def euclidean_distance(a, b, axis: int = -1):
    return torch.sqrt(torch.sum(torch.square(a - b), dim=axis) + 1e-12)


l2_distance = euclidean_distance


def bpr_loss(y_pos, y_neg):
    """-log sigmoid(y_pos - y_neg), element-wise."""
    return -F.logsigmoid(y_pos - y_neg)


def l2_loss(*weights):
    """sum(||w||^2) / 2 over all given tensors."""
    return 0.5 * sum(torch.sum(torch.square(w)) for w in weights)


def sigmoid_cross_entropy(y_pre, y_true):
    """Numerically stable BCE with logits, element-wise."""
    y_true = torch.as_tensor(y_true, dtype=y_pre.dtype, device=y_pre.device)
    return (torch.clamp(y_pre, min=0) - y_pre * y_true
            + torch.log1p(torch.exp(-torch.abs(y_pre))))


def square_loss(y_pre, y_true):
    y_true = torch.as_tensor(y_true, dtype=y_pre.dtype, device=y_pre.device)
    return torch.square(y_pre - y_true)


def hinge_loss(y_pos, y_neg, margin: float = 1.0):
    """max(0, margin - (y_pos - y_neg))."""
    return torch.clamp(margin - (y_pos - y_neg), min=0.0)


def log_loss(logits):
    """-log sigmoid(logits), for pointwise positive-only objectives."""
    return -F.logsigmoid(logits)


def top1_loss(y_pos, y_neg):
    """TOP1: sigmoid(neg - pos) + sigmoid(neg^2), averaged over negatives.
    y_pos (...,); y_neg (..., n_neg)."""
    diff = y_neg - y_pos[..., None]
    return torch.mean(torch.sigmoid(diff) + torch.sigmoid(torch.square(y_neg)),
                      dim=-1)


def bpr_max_loss(y_pos, y_neg, reg: float = 0.0):
    """BPR-max with softmax-weighted negatives and score regularization.
    ``y_neg`` holds negatives only (mask an in-batch diagonal to -inf
    first)."""
    w = torch.softmax(y_neg, dim=-1)
    p = torch.sum(w * torch.sigmoid(y_pos[..., None] - y_neg), dim=-1)
    loss = -torch.log(p + 1e-24)
    if reg:
        loss = loss + reg * torch.sum(w * torch.square(y_neg), dim=-1)
    return loss


def top1_max_loss(y_pos, y_neg):
    """TOP1-max: softmax-weighted TOP1 (same in-batch caveat as
    :func:`bpr_max_loss`)."""
    w = torch.softmax(y_neg, dim=-1)
    diff = y_neg - y_pos[..., None]
    return torch.sum(w * (torch.sigmoid(diff)
                          + torch.sigmoid(torch.square(y_neg))), dim=-1)


def _unit(x):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


def info_nce_loss(anchor, positive, temperature: float = 0.2,
                  negatives=None):
    """InfoNCE over (B, D) ``anchor`` and ``positive``; with
    ``negatives=None`` the other rows' positives are the negatives, else
    ``negatives`` (B, n, D). Returns (B,) losses."""
    anchor, positive = _unit(anchor), _unit(positive)
    pos_logit = torch.sum(anchor * positive, dim=-1) / temperature
    if negatives is None:
        logits = anchor @ positive.T / temperature
        return torch.logsumexp(logits, dim=-1) - pos_logit
    neg_logits = torch.einsum("bd,bnd->bn", anchor,
                              _unit(negatives)) / temperature
    all_logits = torch.cat([pos_logit[:, None], neg_logits], dim=-1)
    return torch.logsumexp(all_logits, dim=-1) - pos_logit
