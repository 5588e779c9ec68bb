"""Checkpoints in the reference's on-disk layout — the counterpart of
``repro.checkpoint``."""
