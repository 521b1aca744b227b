"""Evaluation metrics on torch tensors (counterpart of
nasa_niswan_tpu/evalx/metrics.py).  Only ``r2``, the metric the training
step computes, is ported so far."""

from __future__ import annotations

import torch


def r2(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Coefficient of determination on flattened inputs (sklearn r2_score
    semantics: residuals vs variance around the true mean)."""
    y_true = torch.as_tensor(y_true).reshape(-1)
    y_pred = torch.as_tensor(y_pred).reshape(-1)
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    return 1.0 - ss_res / ss_tot
