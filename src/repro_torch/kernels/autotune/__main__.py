"""Re-tune the standard kernel shapes and PDHG knobs on the card and persist
the winners.

    PYTHONPATH=src python -m repro_torch.kernels.autotune [--tiny] [--reps N]
        [--write-defaults [DIR]]

Writes the user cache (``~/.cache/repro-autotune/torch_table_v1.json``, or
under ``REPRO_AUTOTUNE_CACHE``); later processes pick the winners up.
``--tiny`` tunes the small shapes only.  ``--write-defaults`` also writes
this card's entries to ``<device-kind>.json`` in DIR, by default the
package's committed defaults (``defaults/``).  Runs on the CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.kernels.autotune import (FAMILIES, device_kind, get_table,
                                          tune_solver, tune_tiles)
from repro_torch.kernels.autotune.table import _DEFAULTS_DIR

# (t, c, e) per scale: "controller" is the engines' block (T = 3 rows of
# link load, TS = 36 queue sub-steps, at F21's C = E = 132), "bench" the
# reference's bench shape, "tiny" its small sweeps
SHAPES = {"controller": {"linkload": (3, 132, 132), "queueloss": (36, 132, 132)},
          "bench": (512, 132, 132), "tiny": (96, 56, 56)}
# the PDHG shapes: F21 (12 pods) and F17 (6 pods, the 8-pod bucket), 12
# critical TMs (ControllerConfig's default)
SOLVER_SPECS = (20, 16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="tune the small shapes only")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--write-defaults", nargs="?", const=str(_DEFAULTS_DIR),
                    metavar="DIR",
                    help="write this card's entries to DIR/<kind>.json "
                         "(default: the package's defaults/)")
    args = ap.parse_args(argv)
    shapes = {"tiny": SHAPES["tiny"]} if args.tiny else SHAPES
    for name, shape in shapes.items():
        for family in FAMILIES:
            t, c, e = shape[family.split("_")[0]] if isinstance(shape, dict) else shape
            entry = tune_tiles(family, t, c, e, reps=args.reps)
            print(f"{name} {family} (t={t}, c={c}, e={e}): {json.dumps(entry)}")
    if not args.tiny:
        from repro_torch.core.fleet import FLEET_SPECS, make_fabric

        for idx in SOLVER_SPECS:
            fab = make_fabric(FLEET_SPECS[idx])
            entry = tune_solver(fab, 12, reps=args.reps)
            print(f"pdhg {fab.name} (V={fab.n_pods}, m=12): {json.dumps(entry)}")
    if args.write_defaults:
        kind = device_kind()
        mine = {k: v for k, v in get_table().entries().items()
                if f"/{kind}/" in k}
        path = pathlib.Path(args.write_defaults) / f"{kind}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(mine, indent=1, sort_keys=True) + "\n")
        print(f"wrote {len(mine)} entries to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
