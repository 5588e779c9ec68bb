"""The model stack on PyTorch — the counterpart of ``repro.models`` for
serving: the ``dense``, ``hybrid`` (RG-LRU + local attention) and ``ssm``
(Mamba2 SSD) families, full-sequence forward (prefill) and one-token decode.
The full-sequence forward runs the hand-written kernels (flash attention,
the RG-LRU scan, the SSD chunk scan); decode is plain PyTorch, as in the
reference.  ``moe``, ``vlm``, ``audio`` and training are later slices."""
