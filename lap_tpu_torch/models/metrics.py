"""Training metrics on the device (port of ``lap_tpu/models/metrics.py``):
token accuracy (overall / critical / number / direction), masked per-sample
losses, and per-VQA-dataset breakdowns.
"""

from __future__ import annotations

import torch


def _at_least_one(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.sum().to(torch.float32), min=1.0)


def compute_token_accuracy_metrics(
    predictions,
    labels,
    per_token_loss,
    token_mask,
    critical_mask=None,
    number_mask=None,
    direction_mask=None,
) -> dict:
    metrics = {}
    correct = (predictions == labels).to(torch.float32)
    metrics["token_accuracy"] = (correct * token_mask).sum() / _at_least_one(token_mask)
    metrics["per_token_loss"] = per_token_loss
    metrics["labels"] = labels

    for name, mask in (
        ("critical", critical_mask),
        ("number", number_mask),
        ("direction", direction_mask),
    ):
        if mask is None:
            continue
        hit = correct * mask
        metrics[f"{name}_token_accuracy"] = hit.sum() / _at_least_one(mask)
        metrics[f"per_sample_{name}_correct"] = hit.sum(dim=-1)
        metrics[f"per_sample_{name}_total"] = mask.sum(dim=-1)
    return metrics


def compute_sample_specific_metrics(per_sample_loss, sample_mask, prefix: str) -> dict:
    return {f"{prefix}loss": (per_sample_loss * sample_mask).sum() / _at_least_one(sample_mask)}


def compute_per_vqa_dataset_metrics(
    per_sample_loss, vqa_dataset_ids, vqa_mask, id_to_name: dict[int, str]
) -> dict:
    metrics = {}
    for dataset_id, dataset_name in id_to_name.items():
        mask = ((vqa_dataset_ids == dataset_id) & vqa_mask).to(torch.float32)
        num = mask.sum()
        metrics[f"vqa_{dataset_name}_loss"] = (per_sample_loss * mask).sum() / torch.clamp(num, min=1.0)
        metrics[f"vqa_{dataset_name}_num_samples"] = num
    return metrics
