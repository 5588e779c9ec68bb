"""Optimizer and gradient compression on PyTorch — the counterpart of
``repro.optim``: AdamW with the reference's schedule and arithmetic
(:mod:`.adamw`), top-k / int8 compression with error feedback
(:mod:`.compression`), over the parameter trees of :mod:`.tree`."""
