"""Atomic, keep-k checkpoints in the reference's on-disk layout — the
counterpart of ``repro/checkpoint/manager.py``.

Layout: ``<dir>/step_<n:08d>/`` holding ``arrays.npz`` (the flattened state,
keyed by the reference's "/"-joined paths, every layer group stacked along a
leading axis as the reference stacks it, bfloat16 upcast to float32 — exact)
and ``meta.json`` (step and the caller's metadata).  Writes go to
``<dir>/.tmp_<n>`` and are renamed into place, so a preemption mid-save
never corrupts the latest checkpoint; the ``keep`` newest are kept.  A
checkpoint written by either package restores in the other.

A checkpoint always holds the *logical* (whole) arrays.  With ``shardings``
(a tree of :class:`~repro_torch.parallel.sharding.NamedSharding`, or
``None`` for a replicated leaf, mirroring the state) ``save`` gathers each
rank's shards and only the mesh's first rank writes, and ``restore`` gives
each rank its tile of the logical arrays (cut along the dims split over the
dp axes and over the model axis): a checkpoint written on a 2×2 mesh
restores on one rank, or the reverse, to the same logical state.

A state is a tree: nested dicts of tensors (or numpy arrays, or numbers),
lists for layer groups, ``Params`` modules (their parameter tree).
"""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.optim.tree import as_tree
from repro_torch.parallel.sharding import gather_tensor, shard_tensor

__all__ = ["CheckpointManager"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # npz cannot hold bfloat16
            x = x.float()  # exact upcast
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": array}: one entry per leaf path; the leaves of a layer list
    share their path's entry, stacked along a new leading axis."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {key: arr for k, v in tree.items()
                for key, arr in _flatten(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        layers = [_flatten(v, prefix) for v in tree]
        return {key: np.stack([layer[key] for layer in layers]) for key in layers[0]}
    return {prefix[:-1]: _host(tree)}


def _zip_map(tree, shardings, fn):
    """``fn(leaf, sharding)`` over ``tree``, with ``shardings`` mirroring it
    (``None`` for the whole tree: every leaf replicated)."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return {k: _zip_map(v, None if shardings is None else shardings[k], fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(v, None if shardings is None else shardings[i], fn)
                for i, v in enumerate(tree)]
    return fn(tree, shardings)


def _first_sharding(shardings):
    if isinstance(shardings, dict):
        shardings = list(shardings.values())
    if isinstance(shardings, (list, tuple)):
        for s in shardings:
            found = _first_sharding(s)
            if found is not None:
                return found
        return None
    return shardings


def _unflatten_into(template, flat: dict, prefix: str = "", index=(),
                    shardings=None):
    """``template``'s structure with each leaf read from ``flat`` (a layer
    list's entries from the stacked arrays), on the template leaf's device
    and in its dtype; with ``shardings``, this rank's shard of it."""
    template = as_tree(template)
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/", index,
                                   None if shardings is None else shardings[k])
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_into(v, flat, prefix, index + (i,),
                                None if shardings is None else shardings[i])
                for i, v in enumerate(template)]
    arr = flat[prefix[:-1]][index] if index else flat[prefix[:-1]]
    if shardings is not None:  # this rank's tile: cut over the dp and model axes
        arr = shard_tensor(arr, shardings)
    if isinstance(template, torch.Tensor):  # cast on the template's device
        # (ascontiguousarray makes a 0-d array 1-d: keep the saved shape)
        t = torch.from_numpy(np.ascontiguousarray(arr).reshape(np.shape(arr)))
        t = t.to(template.device)
        return t.to(template.dtype)
    return np.asarray(arr).astype(np.asarray(template).dtype)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, state: dict, meta: dict | None = None,
             shardings=None):
        """Write ``state``'s logical arrays as step ``step``.  With
        ``shardings`` every rank of their mesh calls this: the shards are
        gathered, the mesh's first rank writes, and all wait for it."""
        final = self.dir / f"step_{step:08d}"
        mesh = None
        if shardings is not None:
            state = _zip_map(state, shardings, lambda x, s: x if s is None
                             else gather_tensor(x, s))
            mesh = _first_sharding(shardings).mesh
            if mesh.rank_index != 0:
                _barrier(mesh)
                return final
        self._write(step, state, meta)
        if mesh is not None:
            _barrier(mesh)
        return final

    def _write(self, step: int, state: dict, meta: dict | None):
        tmp = self.dir / f".tmp_{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **_flatten(state))
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, **(meta or {})}, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic on POSIX
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old)

    def latest_step(self) -> int | None:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, template, step: int | None = None,
                shardings=None) -> tuple[dict, dict]:
        """(state in ``template``'s structure — tensors on its leaves'
        devices and in their dtypes —, meta) of ``step`` (default the
        latest).  With ``shardings`` (mirroring ``template``, whose leaves
        are then this rank's shards) each leaf is this rank's shard of the
        logical array, whatever mesh wrote it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "arrays.npz") as archive:
            flat = {key: archive[key] for key in archive.files}
        state = _unflatten_into(template, flat, shardings=shardings)
        meta = json.loads((path / "meta.json").read_text())
        return state, meta


def _barrier(mesh) -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size(mesh.group) > 1:
        dist.barrier(group=mesh.group)
