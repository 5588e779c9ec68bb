"""Launchers of the model stack: the train and serving steps, the batched
serving loop and the training command line — the counterpart of
``repro.launch``, with the device meshes and the dry run."""
