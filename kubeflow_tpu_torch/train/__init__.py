"""Training runtime of the PyTorch port: the one-device train step,
optax-semantics optimizers and schedules, losses, the checkpoint service
and the ``KFTPU_*`` runner."""

from kubeflow_tpu_torch.train.checkpoint import CheckpointService
from kubeflow_tpu_torch.train.losses import cross_entropy_loss, softmax_accuracy
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer, TrainState

__all__ = [
    "cross_entropy_loss",
    "softmax_accuracy",
    "TrainConfig",
    "Trainer",
    "TrainState",
    "CheckpointService",
]
