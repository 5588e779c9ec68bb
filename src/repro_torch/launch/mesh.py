"""Production and host meshes — the counterpart of ``repro/launch/mesh.py``.

Single pod: 16×16 = 256 chips, axes ("data", "model").
Multi-pod:  2×16×16 = 512 chips, axes ("pod", "data", "model") — the "pod"
axis is the Gemini-managed DCNI dimension.

The production meshes carry only names and sizes (the spec functions of
:mod:`repro_torch.parallel.sharding` need nothing else): they are virtual,
and execute a step on ``meta`` tensors alone (the dry run).  The host mesh
spans the ranks of the ``torch.distributed`` process group, one rank per
card.
"""

from __future__ import annotations

import numpy as np

from repro_torch.parallel.sharding import Mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model_axis: int = 1, ranks=None) -> Mesh:
    """``(n // model_axis, model_axis)`` mesh with axes ("data", "model") over
    the ``n`` ranks of the process group (one rank per visible card), or
    ``(1, 1)`` over this process when no process group is initialised.  With
    ``model_axis`` > 1 it also creates the process groups of each axis and
    of the model axis's blocks (:meth:`Mesh.build_process_groups`).

    ``ranks`` (a list of ranks of the group) builds the mesh over those
    alone — elastic downsizing.  Every rank of the group must make that
    call, since it creates a process group; a rank outside ``ranks`` gets
    the mesh but is not one of its members (``rank_index`` is ``None``).
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        if ranks not in (None, [0], (0,)):
            raise ValueError(f"ranks {ranks} without a process group")
        return Mesh((1, 1), ("data", "model"), ranks=[0])
    world = list(range(dist.get_world_size()))
    sub = world if ranks is None else [int(r) for r in ranks]
    if not set(sub) <= set(world) or len(set(sub)) != len(sub):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {len(world)}")
    model_axis = max(1, min(model_axis, len(sub)))
    n = len(sub) // model_axis * model_axis
    sub = sub[:n]
    group = None if sub == world else dist.new_group(sub)
    mesh = Mesh((n // model_axis, model_axis), ("data", "model"),
                ranks=np.asarray(sub), group=group)
    if model_axis > 1:  # the sub-groups of tensor parallelism
        mesh.build_process_groups()
    return mesh
