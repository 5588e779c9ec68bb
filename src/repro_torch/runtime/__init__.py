"""The training runtime and the collective and cost tools — the
counterpart of ``repro.runtime``."""
