"""Attention, normalisation and rotary ops of the PyTorch port.

``flash_attention`` launches the hand-written CUDA kernel on CUDA tensors
and runs its plain PyTorch version on CPU tensors; the rest is plain
tensor code."""
