"""Segmentation losses, PyTorch.

Port of ``segmamba_tpu/train/losses.py`` (all six functions) on the port's
layout: logits ``(batch, C, *spatial)`` (NCDHW) and integer labels
``(batch, *spatial)``. Label value -1 (``ignore_index``) is ignored. Every
loss is computed in float32 whatever the logits' dtype.

- ``cross_entropy_loss`` — the loss the BraTS recipe trains with: mean
  softmax CE over the valid voxels (0 when none is valid).
- ``topk_loss`` — mean CE over the hardest k% of the voxels.
- ``soft_dice_loss`` — nnU-Net soft dice, per sample or pooled over the
  batch (``batch_dice``), smooth term, optional background skip.
- ``dice_and_ce_loss`` — CE + soft dice.
- ``dice_and_bce_loss`` — sigmoid BCE + soft dice for region targets
  ``(batch, C, *spatial)``.
- ``deep_supervision_loss`` — weights 1, 1/2, 1/4, ... normalized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _voxel_ce(logits, labels):
    """Per-voxel softmax CE in float32; labels < 0 read as class 0."""
    return F.cross_entropy(logits.float(), labels.clamp_min(0).long(),
                           reduction="none")


def cross_entropy_loss(logits, labels, ignore_index: int = -1, weights=None):
    """Mean softmax cross entropy over valid voxels."""
    valid = (labels != ignore_index).float()
    ce = _voxel_ce(logits, labels)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=logits.device)
        ce = ce * w[labels.clamp_min(0).long()]
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


def topk_loss(logits, labels, k_percent: float = 10.0,
              ignore_index: int = -1):
    """Mean CE over the hardest k% voxels."""
    ce = _voxel_ce(logits, labels)
    ce = torch.where(labels != ignore_index, ce,
                     torch.full_like(ce, -torch.inf)).reshape(-1)
    k = max(1, int(ce.numel() * k_percent / 100))
    top = torch.topk(ce, k).values
    finite = torch.isfinite(top)
    top = torch.where(finite, top, torch.zeros_like(top))
    return top.sum() / finite.sum().clamp_min(1)


def _one_hot(labels, num_classes):
    """(batch, *spatial) -> (batch, C, *spatial) float32; -1 reads as 0."""
    oh = F.one_hot(labels.clamp_min(0).long(), num_classes).float()
    return oh.movedim(-1, 1)


def soft_dice_loss(logits, labels, smooth: float = 1e-5,
                   include_background: bool = True,
                   batch_dice: bool = False, ignore_index: int = -1,
                   apply_softmax: bool = True):
    """nnU-Net soft dice: 1 - mean_c (2 tp + s) / (2 tp + fp + fn + s)."""
    num_classes = logits.shape[1]
    probs = (torch.softmax(logits.float(), dim=1) if apply_softmax
             else logits.float())
    valid = (labels != ignore_index).float().unsqueeze(1)
    lab = _one_hot(labels, num_classes) * valid
    probs = probs * valid
    axes = ((0,) if batch_dice else ()) + tuple(range(2, logits.dim()))
    tp = (probs * lab).sum(axes)
    fp = (probs * (1 - lab)).sum(axes)
    fn = ((1 - probs) * lab).sum(axes)
    if not include_background:
        tp, fp, fn = tp[..., 1:], fp[..., 1:], fn[..., 1:]
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth).clamp_min(1e-8)
    return 1.0 - dc.mean()


def dice_and_ce_loss(logits, labels, weight_ce: float = 1.0,
                     weight_dice: float = 1.0, ignore_index: int = -1,
                     include_background: bool = True,
                     batch_dice: bool = False):
    """CE + soft dice (DC_and_CE compound)."""
    ce = cross_entropy_loss(logits, labels, ignore_index)
    dc = soft_dice_loss(logits, labels, ignore_index=ignore_index,
                        include_background=include_background,
                        batch_dice=batch_dice)
    return weight_ce * ce + weight_dice * dc


def dice_and_bce_loss(logits, region_labels, weight_ce: float = 1.0,
                      weight_dice: float = 1.0):
    """Sigmoid BCE + soft dice on sigmoid probabilities for region-based
    (possibly overlapping) binary targets ``(batch, C, *spatial)``."""
    lf = logits.float()
    lab = region_labels.float()
    bce = F.binary_cross_entropy_with_logits(lf, lab)
    probs = torch.sigmoid(lf)
    axes = tuple(range(2, logits.dim()))
    tp = (probs * lab).sum(axes)
    fp = (probs * (1 - lab)).sum(axes)
    fn = ((1 - probs) * lab).sum(axes)
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5).clamp_min(1e-8)
    return weight_ce * bce + weight_dice * (1.0 - dc.mean())


def deep_supervision_loss(loss_fn, logits_list, labels_list):
    """Weighted multi-scale loss: weights 1, 1/2, 1/4, ... normalized."""
    n = len(logits_list)
    w = torch.tensor([0.5 ** i for i in range(n)])
    w = w / w.sum()
    total = 0.0
    for i, (lo, la) in enumerate(zip(logits_list, labels_list)):
        total = total + w[i] * loss_fn(lo, la)
    return total
