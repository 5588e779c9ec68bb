"""The synthetic token pipeline — the counterpart of ``repro.data``."""
