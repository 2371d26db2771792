"""Training layer of the port: losses, LR schedules, the train state and
step, checkpoints and the trainer (counterpart of ``segmamba_tpu/train``).
``python -m segmamba_tpu_torch.train`` is the BraTS training command."""

from segmamba_tpu_torch.train.losses import (
    cross_entropy_loss,
    deep_supervision_loss,
    dice_and_bce_loss,
    dice_and_ce_loss,
    soft_dice_loss,
    topk_loss,
)
from segmamba_tpu_torch.train.lr_schedules import (
    constant_with_warmup_schedule,
    cosine_with_warmup_schedule,
    linear_warmup_cosine_annealing,
    poly_schedule,
    poly_with_warmup,
)
from segmamba_tpu_torch.train.train_state import (
    TrainState,
    create_train_state,
    default_optimizer,
    eval_step,
    train_step,
)
from segmamba_tpu_torch.train.trainer import Trainer

__all__ = [
    "cross_entropy_loss",
    "topk_loss",
    "soft_dice_loss",
    "dice_and_ce_loss",
    "dice_and_bce_loss",
    "deep_supervision_loss",
    "poly_schedule",
    "poly_with_warmup",
    "cosine_with_warmup_schedule",
    "constant_with_warmup_schedule",
    "linear_warmup_cosine_annealing",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "train_step",
    "eval_step",
    "Trainer",
]
