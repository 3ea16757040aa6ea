"""PyTorch/CUDA port of the dLLM-Serve reproduction (``repro``), for one
NVIDIA H100. Imports torch, never jax, and nothing of ``repro``."""
