"""Mamba2 SSD chunked scan (CUDA: ``csrc/ssd_chunk.cu``)."""
