"""Device choice, logging, metrics and the HTTP router of the port."""

from kubeflow_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger"]
