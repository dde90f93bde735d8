"""PyTorch/CUDA port of kubeflow_tpu's compute tier.

A second package beside ``kubeflow_tpu`` that imports nothing from it: the
JAX package is the reference each part is held against. Two slices are
ported: the Llama serving path (``serving.server`` -> ``serving.engine``
-> ``models.llama``) with prefill attention in a CUDA kernel for sm_90a
(``ops/csrc/flash_attention_fwd.cu``), and one-device Llama training
(``train.runner`` -> ``train.trainer`` -> ``models.llama``) with the
attention backward in a second one (``ops/csrc/flash_attention_bwd.cu``).
Entry points run on ``cuda`` unless the caller asks for the CPU
(``utils.device.resolve_device``).
"""
