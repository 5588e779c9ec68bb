"""The model stack on PyTorch — the counterpart of ``repro.models``: the
``dense``, ``moe``, ``vlm``, ``hybrid`` (RG-LRU + local attention) and ``ssm``
(Mamba2 SSD) families (:mod:`.transformer`) and the ``audio``
encoder-decoder (:mod:`.encdec`); full-sequence forward (prefill and
training's loss) and one-token decode.  The full-sequence forward runs the
hand-written kernels (flash attention, the RG-LRU scan, the SSD chunk scan),
and training differentiates through all three (their backward kernels);
decode is plain PyTorch, as in the reference."""
