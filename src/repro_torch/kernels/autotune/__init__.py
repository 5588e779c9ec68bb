"""Kernel autotuning: per-(backend, device, shape) body/knob table + tuner —
the counterpart of ``repro.kernels.autotune``.

See :mod:`repro_torch.kernels.autotune.table` for the lookup/cache layers and
the correctness contract, :mod:`repro_torch.kernels.autotune.tuner` for the
search.
"""

from repro_torch.kernels.autotune.table import (BODIES, DEFAULT_SOLVER_KNOBS,
                                                DEFAULT_TILES, TABLE_VERSION,
                                                TuneTable, body_for,
                                                device_kind, enabled,
                                                get_table, pad_to,
                                                reset_table, resolve_tiles,
                                                shape_bucket, shrink_bt,
                                                solver_key, solver_knobs,
                                                tile_key)
from repro_torch.kernels.autotune.tuner import (FAMILIES, tile_candidates,
                                                tune_solver, tune_tiles)

__all__ = [
    "BODIES", "DEFAULT_SOLVER_KNOBS", "DEFAULT_TILES", "TABLE_VERSION",
    "TuneTable", "body_for", "device_kind", "enabled", "get_table", "pad_to",
    "reset_table", "resolve_tiles", "shape_bucket", "shrink_bt", "solver_key",
    "solver_knobs", "tile_key", "FAMILIES", "tile_candidates", "tune_solver",
    "tune_tiles",
]
