"""Launchers of the model stack: the serving steps and the batched serving
loop — the counterpart of ``repro.launch`` (training and the dry run are
later slices)."""
