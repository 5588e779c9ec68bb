"""The training runtime — the counterpart of ``repro.runtime`` (the HLO
tools are a later slice)."""
