"""Fused link-load matmul + utilization metrics (CUDA: ``csrc/linkload.cu``)."""
