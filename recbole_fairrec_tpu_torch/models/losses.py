"""Loss primitives.

Counterpart of ``recbole_fairrec_tpu/models/losses.py``: plain functions on
tensors returning scalars (``bce_elementwise`` returns the elementwise
terms).
"""

from __future__ import annotations

import torch


def bpr_loss(pos_score, neg_score, gamma=1e-10):
    """−log σ(pos − neg), mean over batch."""
    return -torch.log(gamma + torch.sigmoid(pos_score - neg_score)).mean()


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


class _BCEElementwise(torch.autograd.Function):
    """Forward: each log term clamped at −100, so a probability of exactly 0
    or 1 gives a large finite loss, never 0 · −inf. Backward:
    (p − t) / max(p(1 − p), 1e-12) rather than the derivative of the clamped
    logs, which is ±inf times a zero selector at exact saturation."""

    @staticmethod
    def forward(ctx, pred_prob, target):
        ctx.save_for_backward(pred_prob, target)
        logp = torch.log(pred_prob).clamp_min(-100.0)
        log1mp = torch.log(1.0 - pred_prob).clamp_min(-100.0)
        return -(target * logp + (1.0 - target) * log1mp)

    @staticmethod
    def backward(ctx, grad_out):
        p, t = ctx.saved_tensors
        grad_p = grad_out * (p - t) / (p * (1.0 - p)).clamp_min(1e-12)
        if grad_p.shape != p.shape:  # target broadcast against the probabilities
            grad_p = grad_p.sum_to_size(p.shape)
        return grad_p, None


def bce_elementwise(pred_prob, target):
    """Elementwise binary cross-entropy on probabilities, saturation-safe in
    value and in gradient (see :class:`_BCEElementwise`). The target gets no
    gradient."""
    return _BCEElementwise.apply(pred_prob, target)


def bce_loss(pred_prob, target):
    """Mean binary cross-entropy; see :func:`bce_elementwise`."""
    return torch.mean(bce_elementwise(pred_prob, target))


def cross_entropy_loss(logits, labels):
    """Softmax cross-entropy over integer labels, mean over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def _smooth_l1_elem(input, target):
    diff = torch.abs(input - target)
    return torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)


def smooth_l1_loss(input, target):
    """Smooth-L1 with beta = 1: 0.5 x² for |x| < 1 else |x| − 0.5."""
    return torch.mean(_smooth_l1_elem(input, target))


def masked_smooth_l1_loss(input, target, mask):
    """Smooth-L1 averaged only over the rows where ``mask`` is 1."""
    denom = mask.sum().clamp_min(1.0)
    return torch.sum(_smooth_l1_elem(input, target) * mask) / denom


def reg_loss(parameters):
    """Sum of squared L2 norms of a list of parameter tensors."""
    return sum(torch.linalg.vector_norm(p.reshape(-1)) ** 2 for p in parameters)


def emb_loss(embeddings, norm=2, require_pow=False):
    """Regularization over embedding activations."""
    total = 0.0
    batch = embeddings[-1].shape[0]
    for emb in embeddings:
        if require_pow:
            total = total + torch.sum(torch.abs(emb) ** norm)
        else:
            total = total + torch.linalg.vector_norm(emb.reshape(-1), ord=norm)
    if require_pow:
        return total / norm / batch
    return total / batch


def emb_margin_loss(embeddings, margin=1.0):
    """Margin-based embedding regularization."""
    total = 0.0
    for emb in embeddings:
        norm2 = torch.sum(emb**2, dim=-1, keepdim=True)
        total = total + torch.sum((norm2 - margin).clamp_min(0.0))
    return total
