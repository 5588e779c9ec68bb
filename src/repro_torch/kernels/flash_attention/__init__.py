"""Causal / sliding-window GQA flash attention (CUDA: ``csrc/flash_attention.cu``)."""
