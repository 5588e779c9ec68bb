"""repro_torch — the Gemini controller ported to PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``repro``, with the same module
layout: ``core/`` (controller engines, PDHG routing solver, scoring,
predictor, baselines), ``serve/`` (the streaming controller), ``burst/``
(burst expander and fluid-queue loss), ``kernels/`` (hand-written CUDA
kernels with their plain-PyTorch versions) and ``obs/`` (tracing, solver
telemetry, metrics, decision audit).  It imports neither ``jax`` nor
``repro``.

Entry points: :func:`repro_torch.core.run_controller` (offline, batched or
sequential) and :class:`repro_torch.serve.StreamingController` (online).
They run on the CUDA device unless the caller passes ``device="cpu"``, and
raise when no card is present (:func:`repro_torch.device.resolve_device`).
"""
