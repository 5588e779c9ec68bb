"""Fused link-load matmul + fluid-queue loss scan (CUDA: ``csrc/queueloss.cu``)."""
