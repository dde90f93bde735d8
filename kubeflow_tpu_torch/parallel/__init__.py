"""Parallel layers of the PyTorch port: the top-2 MoE dispatch
(``parallel/moe.py``). Meshes and collectives come with the multi-GPU
slice."""
