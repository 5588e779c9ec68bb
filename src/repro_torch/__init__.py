"""repro_torch — the Gemini controller ported to PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``repro``, with the same module
layout: ``core/`` (controller, engine, PDHG routing solver, scoring),
``burst/`` (burst expander and fluid-queue loss), ``kernels/`` (hand-written
CUDA kernels with their plain-PyTorch versions) and ``obs/`` (tracing and
solver telemetry).  It imports neither ``jax`` nor ``repro``.

Entry point: :func:`repro_torch.core.run_controller`.  It runs on the CUDA
device unless the caller passes ``device="cpu"``, and raises when no card is
present (:func:`repro_torch.device.resolve_device`).
"""
