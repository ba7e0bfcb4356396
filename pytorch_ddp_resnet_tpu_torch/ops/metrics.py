"""Losses and classification metrics, in f32 (counterpart of
pytorch_ddp_resnet_tpu/ops/metrics.py).

- ``cross_entropy_loss``: mean softmax cross-entropy over the batch,
  ``logsumexp(logits) - logits[label]``;
- ``top_k_err``: 1 - mean(any of the top-k predictions equals the label),
  k clamped to the class count;
- both take optional per-sample weights for exact masked means.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _weighted_mean(v: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return v.mean()
    w = weights.to(torch.float32)
    return (v * w).sum() / w.sum().clamp_min(1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """logits (B, C) float, labels (B,) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return _weighted_mean(logz - ll, weights)


def top_k_err(logits: torch.Tensor, labels: torch.Tensor, k: int,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logits.detach().to(torch.float32)
    topk = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).indices
    matches = (topk == labels.long()[:, None]).sum(-1).to(torch.float32)
    return 1.0 - _weighted_mean(matches, weights)


def compute_losses_and_metrics(logits: torch.Tensor, labels: torch.Tensor,
                               weights: Optional[torch.Tensor] = None
                               ) -> Dict[str, torch.Tensor]:
    return {
        "loss": cross_entropy_loss(logits, labels, weights),
        "top1_err": top_k_err(logits, labels, k=1, weights=weights),
        "top5_err": top_k_err(logits, labels, k=5, weights=weights),
    }
