"""RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t (CUDA: ``csrc/rglru_scan.cu``)."""
