"""Meshes, partition specs and the leading-axis split over the cards of one
host — the counterpart of ``repro/parallel/sharding.py``.

The reference names every sharding in *logical* axes and lets XLA place the
data; here the names are the same, and what they say is carried out by hand
with ``torch.distributed`` collectives (:mod:`repro_torch.launch.steps`) or
by one host thread per card (:func:`shard_leading`).

Logical → physical convention (as the reference's):
  "dp"     → ("pod", "data") if the mesh has a pod axis, else ("data",)
  "tp"     → "model"           (Megatron tensor parallelism)
  "sp"     → "model"           (sequence sharding of the residual stream)
  None     → replicated

Parameter rules are path-regex → :class:`PartitionSpec`, FSDP-style: every
large matrix shards one dim over "tp" and the other over the dp axes, so
parameter and optimizer memory scale with the device count (ZeRO-3).  Each
rank holds the tile of every leaf that its coordinates name: its dp dim cut
by the rank's index over the dp axes, its tp dim by its ``model`` index.
A leaf is gathered over the dp axes only — the ranks that share its model
index — and its gradient reduce-scattered over the same group
(:func:`gather_for_use`, :func:`reduce_gradient`).  Over the ``model`` axis
a tp-sharded leaf either stays in its tile, where the model's layers run
Megatron tensor parallelism on it (:func:`tp_copy`, :func:`tp_reduce`) —
on the rank's share of the heads (:func:`head_range`: unequal shares where
the axis does not divide the head count, each read from a block of
consecutive ranks' tiles) —, or is gathered whole (:class:`LeafPlan`);
which one is the step's plan
(:func:`repro_torch.launch.steps.leaf_plans`).  A decode step keeps
each cache leaf in the tile its spec names (:func:`dim_axes` reads which
axes split a dim): attention combines its partial softmaxes over the
cache's sequence axes, the recurrent layers update their share of the
state (:func:`repro_torch.launch.steps.make_serve_step`).

Every collective goes through one path (:func:`all_gather`,
:func:`reduce_scatter`, :func:`all_reduce`), which appends it to the open
records of :func:`repro_torch.runtime.hlo_traffic.record_collectives` with
its replica groups in global device ids (a device's row-major index in the
mesh).  A mesh built from names and sizes alone (the production meshes) is
*virtual*: it executes only on ``meta`` tensors, each collective recorded
as rank 0 sees it and answered with a ``meta`` tensor of the result's
shape; any other tensor raises ``ValueError``.  The spec functions read
only a mesh's axis names and sizes, so they answer for any mesh shape.

The port's parameters keep each layer group as a list of per-layer modules
(``blocks.3.attn.wq``) where the reference stacks the group along a leading
axis (``blocks/attn/wq``, shape (L, ...)).  The parameter names are
otherwise the reference's, key for key, so :func:`_path_str` is the whole
mapping: it drops the layer indices.  A port leaf's spec is the reference's
spec of the stacked array without its leading layer entries, which the rules
always leave replicated.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import re
import threading
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch import obs
from repro_torch.optim.tree import as_tree, unflatten
from repro_torch.runtime import hlo_traffic

__all__ = [
    "PartitionSpec", "P", "Mesh", "NamedSharding", "set_profile", "get_profile",
    "set_active_mesh", "active_mesh", "use_mesh", "fleet_mesh", "shard_leading",
    "dp_axes", "spec", "constrain", "PARAM_RULES", "param_spec_for", "fit_spec",
    "param_shardings", "check_executable", "shard_tensor",
    "gather_tensor", "reduce_gradient", "host_sync_point", "dim_axes", "tile_slice",
    "LeafPlan", "param_paths", "gather_for_use", "all_gather", "reduce_scatter", "all_reduce",
    "tp_copy", "tp_reduce", "tp_sum", "tp_gather", "tp_max", "tp_rank", "tp_size",
    "tp_heads", "head_range", "batch_mean", "axis_index", "batch_axes",
]

_ACTIVE_MESH = None

# Parameter-sharding profile (the reference's knob):
#   "fsdp"     — params sharded over (dp × tp): ZeRO-3 memory, per-use gathers
#   "fsdp_pod" — FSDP over the intra-pod "data" axis only
#   "tp"       — params sharded over "model" only (replicated across dp)
_PROFILE = "fsdp"


def _canonical(part):
    """JAX's form of one entry: an empty tuple is ``None``, a one-name
    tuple the name."""
    if isinstance(part, (tuple, list)):
        if not part:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class PartitionSpec(tuple):
    """Per-dimension mesh axes: an axis name, a tuple of names, or ``None``
    (replicated) for each dim — the counterpart of JAX's ``PartitionSpec``,
    equal to it entry for entry (entries in JAX's canonical form)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over cards or process ranks.

    ``shape`` maps each axis name to its size, in order.  A mesh is backed by
    ``devices`` (a flat list, row-major over the axes: :func:`fleet_mesh`),
    by ``ranks`` of a ``torch.distributed`` process group (``group``, ``None``
    for the default group: :func:`repro_torch.launch.mesh.make_host_mesh`),
    or by nothing at all: the spec functions read only the names and sizes,
    so a 256-card production mesh is built and queried without any card.
    """

    def __init__(self, shape, axis_names, *, devices=None, ranks=None, group=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in rank")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")
        self.ranks = None if ranks is None else np.asarray(ranks, np.int64).reshape(shape)
        self.group = group
        self._groups = {}  # (axes, block) -> this rank's process group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def virtual(self) -> bool:
        """Names and sizes only: no cards, no ranks.  Executes on ``meta``
        tensors alone, as rank 0 (:func:`all_gather`)."""
        return self.devices is None and self.ranks is None

    def virtual_copy(self) -> "Mesh":
        """A virtual mesh of this mesh's names and sizes."""
        return Mesh(tuple(self.shape.values()), self.axis_names)

    def coords(self) -> dict:
        """This rank's index along each axis (rank 0's on a virtual mesh)."""
        pos = self.rank_index
        if pos is None:
            raise ValueError(f"this rank is not one of the mesh's ({self})")
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(pos, tuple(self.shape.values())))))

    def groups(self, axes, block: int | None = None) -> np.ndarray:
        """The replica groups of a collective over ``axes`` (names in mesh
        order): one row for each combination of the other axes, holding the
        device ids (row-major positions) that vary along ``axes``, in
        row-major order over them — the groups of the reference's iota
        replica groups.  ``block`` splits each row into consecutive groups
        of that many ids (a part of the model axis)."""
        axes = tuple(axes)
        names = self.axis_names
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"axes {axes} are not in the order of the mesh's {names}")
        other = [i for i in range(len(names)) if i not in idx]
        ids = np.arange(self.size).reshape(tuple(self.shape.values()))
        g = ids.transpose(other + idx).reshape(-1, math.prod(self.shape[a] for a in axes))
        if block:
            if g.shape[1] % block:
                raise ValueError(f"a block of {block} does not divide groups of {g.shape[1]}")
            g = g.reshape(-1, block)
        return g

    def group_size(self, axes, block: int | None = None) -> int:
        return block or math.prod(self.shape[a] for a in axes)

    def process_group(self, axes, block: int | None = None):
        """This rank's ``torch.distributed`` group for a collective over
        ``axes`` (``mesh.group`` when it spans the whole mesh)."""
        if self.group_size(axes, block) == self.size:
            return self.group
        if block == math.prod(self.shape[a] for a in axes):
            block = None  # a block of the whole axis is the axis's group
        key = (tuple(axes), block)
        if key not in self._groups:
            raise ValueError(f"{self} has no process groups over {axes} "
                             f"(block {block}): make_host_mesh builds them")
        return self._groups[key]

    def build_process_groups(self) -> None:
        """Create the process groups of every proper sub-group a step can
        ask for: each axis alone, and consecutive blocks of the ``model``
        axis (a replicated KV head's ranks).  Every rank of the process
        group's world calls this, in the same order."""
        import torch.distributed as dist

        keys = [((a,), None) for a in self.axis_names]
        keys += [(("model",), b) for b in range(2, self.shape.get("model", 1))
                 if self.shape["model"] % b == 0]
        pos = self.rank_index
        for axes, block in keys:
            n = self.group_size(axes, block)
            if n in (1, self.size):
                continue
            for row in self.groups(axes, block):
                pg = dist.new_group([int(r) for r in self.ranks.reshape(-1)[row]])
                if pos is not None and pos in row:
                    self._groups[(axes, block)] = pg

    @property
    def rank_index(self) -> int | None:
        """This process's position among the mesh's ranks (row-major), or
        ``None`` if it is not one of them; 0 for a mesh without ranks."""
        if self.ranks is None:
            return 0
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        hits = np.flatnonzero(self.ranks.reshape(-1) == rank)
        return int(hits[0]) if hits.size else None

    def __repr__(self) -> str:
        back = ("" if self.devices is None and self.ranks is None else
                f", devices={[str(d) for d in self.devices]}" if self.devices is not None
                else f", ranks={self.ranks.reshape(-1).tolist()}")
        return f"Mesh({self.shape}{back})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`."""

    mesh: Mesh
    spec: PartitionSpec


def set_profile(profile: str):
    global _PROFILE
    assert profile in ("fsdp", "fsdp_pod", "tp")
    _PROFILE = profile


def get_profile() -> str:
    return _PROFILE


def set_active_mesh(mesh: Mesh | None):
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


@contextmanager
def use_mesh(mesh: Mesh):
    prev = _ACTIVE_MESH
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def check_executable(mesh: Mesh, kind: str = "train") -> None:
    """Raise unless the port can execute a step of ``kind`` on ``mesh``:
    a train, prefill or decode step executes on any mesh (a virtual one on
    ``meta`` tensors alone)."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"a step of kind {kind!r} is not train, prefill or decode")


def fleet_mesh(devices=None) -> Mesh:
    """1-D mesh with axis ``"fleet"`` over the visible CUDA devices, or over
    ``devices``.

    The fleet engine (:mod:`repro_torch.core.fleet_engine`) shards its
    flattened fabric×epoch batch over this mesh.  A list that repeats one
    device (``[dev] * D``) is accepted: it places D shards on that one card
    (or on the CPU), each on its own thread and stream — a form for checks
    of the deal, not for speed.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fleet_mesh() spans the visible CUDA devices and "
                               "torch.cuda.is_available() is False; pass devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    return Mesh((len(devices),), ("fleet",), devices=devices)


def _deal(n: int, d: int):
    """The round-robin deal of ``n`` elements over ``d`` shards: (gather,
    inverse, rows), or ``None`` when ``d`` is 1 or divides ``n`` (the
    contiguous split, as the reference's ``shard_map`` does).  Position
    ``p`` (shard-major) holds element ``((p % rows) * d + p // rows) % n``;
    element ``e`` sits at position ``(e % d) * rows + e // d``."""
    if d == 1 or n % d == 0:
        return None
    rows = -(-n // d)
    p = np.arange(rows * d)
    e = np.arange(n)
    return ((p % rows) * d + p // rows) % n, (e % d) * rows + e // d, rows


def _out_leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


class _RoundRobin:
    """The host as a baton the shard threads pass round: the holder issues
    its work, and hands the baton on at a point where it would wait for the
    device (:func:`host_sync_point`), so each card runs while the others'
    launches are issued, and only one thread runs Python at a time."""

    def __init__(self, n: int):
        self._cv = threading.Condition()
        self._live = list(range(n))
        self._turn = 0

    def _after(self, i: int) -> int:
        later = [j for j in self._live if j > i]
        return later[0] if later else self._live[0]

    def take(self, i: int) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._turn == i)

    def pass_on(self, i: int) -> None:
        with self._cv:
            self._turn = self._after(i)
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._turn == i)

    def leave(self, i: int) -> None:
        with self._cv:
            if i not in self._live:
                return
            nxt = self._after(i) if len(self._live) > 1 else None
            self._live.remove(i)
            if self._turn == i and nxt is not None:
                self._turn = nxt
            self._cv.notify_all()


_SHARD = threading.local()  # (round robin, shard index) on a shard's thread


def host_sync_point() -> None:
    """Mark a point where the caller is about to wait for its device (read
    a result back).  On a shard's thread (:func:`shard_leading`) it hands
    the host to the next shard first; elsewhere it does nothing."""
    turn = getattr(_SHARD, "turn", None)
    if turn is not None:
        turn[0].pass_on(turn[1])


def _run_shards(fn, devices, parts):
    """``fn(*parts[i])`` on ``devices[i]`` for every shard: one host thread
    per shard, under ``torch.cuda.device`` and on a stream of its own.
    ``fn`` reads results back to the host (the PDHG loop's convergence check
    does, once per check), so a plain loop would run the cards one after
    another; free-running threads contend for the interpreter lock at every
    small launch (D = 4 shards on one H100 ran 6.7× the unsharded time,
    PERF.md).  So the threads take turns (:class:`_RoundRobin`): each issues
    its launches up to its next read-back, then hands the host on, and reads
    back when its turn comes round; a shard done issuing leaves the round
    before it waits for its card."""
    ready = [torch.cuda.current_stream(d) if d.type == "cuda" else None
             for d in devices]
    n_threads = torch.get_num_threads()  # a new thread starts at the default
    turns = _RoundRobin(len(devices))

    def one(i):
        dev = devices[i]
        torch.set_num_threads(n_threads)
        turns.take(i)
        _SHARD.turn = (turns, i)
        try:
            with obs.span("sharding.shard", shard=i, device=str(dev),
                          n=int(parts[i][0].shape[0])):
                if dev.type != "cuda":
                    return fn(*parts[i])
                with torch.cuda.device(dev):
                    stream = torch.cuda.Stream(dev)
                    stream.wait_stream(ready[i])
                    with torch.cuda.stream(stream):
                        out = fn(*parts[i])
                    turns.leave(i)
                    stream.synchronize()
                    return out
        finally:
            _SHARD.turn = None
            turns.leave(i)

    if len(devices) == 1:
        outs = [one(0)]
    else:
        with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
            outs = [f.result() for f in [pool.submit(one, i) for i in range(len(devices))]]
    for dev, stream, out in zip(devices, ready, outs):
        if stream is not None:  # made on the shard's stream, read on this one
            for o in _out_leaves(out):
                o.record_stream(stream)
    return outs


def shard_leading(fn, mesh: Mesh, repack: bool = False):
    """Split a batched function over the leading axis of every input and
    output, along ``mesh``'s devices.

    ``fn`` must be elementwise along its leading batch axis (a batched
    per-element solve), so sharding it is a pure data split — no
    collectives: each shard's inputs move to its device, ``fn`` runs there
    (:func:`_run_shards`: the shards' launches interleave on the host and
    their cards run at once), and the outputs (a tensor or a tuple of
    tensors) are gathered back to the mesh's first device.

    With ``repack=False`` the batch must be a multiple of the device count
    (shard ``s`` takes the ``s``-th contiguous block).  With
    ``repack=True`` any batch size works: the wrapper pads the remainder by
    replaying real leading elements and deals elements **round-robin** —
    element ``i`` lands on shard ``i % D`` — so neighbouring elements of
    correlated difficulty spread over the cards; outputs are inverse-permuted
    and trimmed, so results are elementwise those of the unsharded call.
    D = 1, or a batch that D divides, takes the contiguous split and skips
    the gathers.
    """
    devices = list(mesh.devices)
    d = len(devices)
    first = devices[0]

    def split(args):
        n = int(args[0].shape[0])
        if n % d:
            raise ValueError(f"shard_leading: batch {n} is not a multiple of {d} "
                             "shards (use repack=True)")
        rows = n // d
        parts = [[a[s * rows:(s + 1) * rows].to(dev) for a in args]
                 for s, dev in enumerate(devices)]
        outs = _run_shards(fn, devices, parts)
        if isinstance(outs[0], torch.Tensor):
            return torch.cat([o.to(first) for o in outs])
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(len(outs[0])))

    if not repack:
        return lambda *args: split(args)

    def repacked(*args):
        deal = _deal(int(args[0].shape[0]), d)
        if deal is None:
            return split(args)
        gather, inv, _ = deal
        g = torch.as_tensor(gather, device=args[0].device)
        out = split([a[g] for a in args])
        inv = torch.as_tensor(inv, device=first)
        if isinstance(out, torch.Tensor):
            return out[inv]
        return tuple(o[inv] for o in out)

    return repacked


def dp_axes(mesh: Mesh | None = None):
    mesh = mesh or _ACTIVE_MESH
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def _resolve(axis):
    if axis is None:
        return None
    if axis == "dp":
        return dp_axes()
    if axis in ("tp", "sp"):
        return "model"
    return axis


def spec(*axes) -> PartitionSpec:
    return PartitionSpec(*[_resolve(a) for a in axes])


def constrain(x, *axes):
    """The activation constraint of the reference's model code.  It leaves
    ``x`` as it is: each rank's activations are already its slice of the
    batch over the dp axes, whole over the model axis (the port shards no
    sequence), and tensor parallelism places its own collectives
    (:func:`tp_copy`, :func:`tp_reduce`)."""
    return x


# ---- parameter partition rules ---------------------------------------------
# (regex on param path, PartitionSpec in logical axes). First match wins.
# Paths look like "blocks/attn/wq", "embed", "blocks/moe/w_gate", ...
# Stacked-layer leading axes (L or n_super) are replicated (None prefix added
# automatically for arrays with more dims than the rule).

PARAM_RULES = [
    (r"embed$", ("tp", "dp")),  # (V, d): vocab over tp, d over dp
    (r"unembed$", ("dp", "tp")),  # (d, V)
    (r"router$", (None, None)),  # tiny
    (r"moe/(w_gate|w_up|w_down)$", ("tp", "dp", None)),  # (E, d|ff, ·): EP over tp
    (r"(w_gate|w_up)$", ("dp", "tp")),  # (d, ff)
    (r"w_down$", ("tp", "dp")),  # (ff, d)
    (r"w(q|k|v)$", ("dp", "tp")),  # (d, H*hd): heads over tp
    (r"wo$", ("tp", "dp")),  # (H*hd, d)
    (r"(w_in|w_in_gate|w_in_rec)$", ("dp", "tp")),
    (r"w_out$", ("tp", "dp")),
    (r"(w_a|w_x)$", ("dp", "tp")),
    (r"conv_w$", (None, "tp")),
    (r".*", (None,)),  # norms, biases, scalars: replicated
]


def _path_str(path) -> str:
    """The reference's parameter path of a port parameter: the dict keys
    joined by "/", the layer-list indices dropped (the reference stacks a
    layer group along a leading axis).  ``path`` is a sequence of keys and
    indices, or a ``state_dict`` name (``"blocks.3.attn.wq"``)."""
    if isinstance(path, str):
        path = path.split(".")
    return "/".join(str(k) for k in path
                    if not isinstance(k, int) and not str(k).isdigit())


def _resolve_param(axis):
    """Parameter-dim resolver honoring the sharding profile."""
    if axis == "dp":
        if _PROFILE == "tp":
            return None
        if _PROFILE == "fsdp_pod":
            return "data"
        return dp_axes()
    return _resolve(axis)


def param_spec_for(path: str, ndim: int) -> PartitionSpec:
    """The rule's spec for the reference-layout array at ``path`` of rank
    ``ndim`` (a stacked layer group counts its layer axes)."""
    for pattern, axes in PARAM_RULES:
        if re.search(pattern, path):
            resolved = [_resolve_param(a) for a in axes]
            if len(resolved) < ndim:  # stacked layer/expert leading axes
                resolved = [None] * (ndim - len(resolved)) + resolved
            elif len(resolved) > ndim:
                resolved = resolved[-ndim:] if ndim else []
            return PartitionSpec(*resolved)
    return PartitionSpec()


def fit_spec(mesh: Mesh, shape, pspec: PartitionSpec) -> PartitionSpec:
    """Drop axes whose size does not divide the dim (non-dividing dims stay
    replicated — e.g. odd vocab sizes, mamba2's 3352-wide in-projection)."""
    out = []
    for d, axes in enumerate(tuple(pspec) + (None,) * (len(shape) - len(tuple(pspec)))):
        if axes is None:
            out.append(None)
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        size = 1
        for a in ax_tuple:
            size *= mesh.shape[a]
        out.append(axes if shape[d] % size == 0 else None)
    return PartitionSpec(*out)


def _param_leaves(tree, path=(), layers=()):
    """(path, layer counts around the leaf, leaf) for every leaf of a
    parameter tree, in ``repro_torch.optim.tree.leaves`` order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _param_leaves(v, path + (k,), layers)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _param_leaves(v, path + (i,), layers + (len(tree),))
    else:
        yield path, layers, tree


def param_paths(params_shape_tree) -> list:
    """The reference path (:func:`_path_str`) of every parameter leaf, in
    ``repro_torch.optim.tree.leaves`` order."""
    return [_path_str(path) for path, _, _ in _param_leaves(params_shape_tree)]


def param_shardings(mesh: Mesh, params_shape_tree):
    """A :class:`NamedSharding` per parameter (divisibility-safe), in the
    structure of ``params_shape_tree`` (a parameter tree or ``Params``
    module; tensors on the ``meta`` device serve).  Each spec is the
    reference's for the stacked array (:func:`param_spec_for` on the
    leaf's reference path and stacked rank, then :func:`fit_spec`), without
    its leading layer entries: which dim of the port's tensor is sharded
    over which axes."""
    out = []
    for path, layers, leaf in _param_leaves(params_shape_tree):
        shape = tuple(layers) + tuple(leaf.shape)
        full = fit_spec(mesh, shape, param_spec_for(_path_str(path), len(shape)))
        if any(a is not None for a in full[:len(layers)]):
            raise ValueError(f"{_path_str(path)}: the rule shards a layer axis "
                             f"({full}); the port keeps layers as a list")
        out.append(NamedSharding(mesh, PartitionSpec(*full[len(layers):])))
    return unflatten(params_shape_tree, out)


# ---- executing a sharding: tiles, collectives, tensor parallelism ------------

def _entry_axes(axes) -> tuple:
    return () if axes is None else (axes if isinstance(axes, tuple) else (axes,))


def _sharded_dims(sharding: NamedSharding, axes=None):
    """(dim, entry axes) of every dim that ``sharding`` splits over more
    than one rank; with ``axes``, only the dims whose entry lies in them."""
    mesh = sharding.mesh
    out = []
    for dim, entry in enumerate(sharding.spec):
        names = _entry_axes(entry)
        if not names or math.prod(mesh.shape[a] for a in names) == 1:
            continue
        if axes is not None and not set(names) <= set(axes):
            if set(names) & set(axes):
                raise ValueError(f"{sharding.spec}: dim {dim} mixes axes {names} "
                                 f"inside and outside {tuple(axes)}")
            continue
        out.append((dim, names))
    return out


def dim_axes(sharding: NamedSharding | None, dim: int) -> tuple:
    """The mesh axes that split ``dim`` of a tensor placed by ``sharding``
    over more than one rank; ``()`` where the dim is whole (or there is no
    sharding)."""
    if sharding is None:
        return ()
    return next((names for d, names in _sharded_dims(sharding) if d == dim), ())


def batch_axes(mesh: Mesh) -> tuple:
    """The mesh's dp axes: the ranks along them hold different slices of
    the batch; ranks that differ only in their model index hold the same."""
    return tuple(a for a in dp_axes(mesh) if a in mesh.shape)


def axis_index(mesh: Mesh, axes) -> int:
    """This rank's row-major index over ``axes``."""
    c = mesh.coords()
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + c[a]
    return i


def tile_slice(n_loc: int, mesh: Mesh, axes) -> slice:
    """This rank's ``n_loc`` entries of a dim split over ``axes``."""
    i = axis_index(mesh, axes)
    return slice(i * n_loc, (i + 1) * n_loc)


def _cut(x, n: int, dim: int, i: int):
    """The ``i``-th of ``n`` chunks of ``x`` along ``dim``, a copy (a view
    would keep the whole tensor alive)."""
    if isinstance(x, torch.Tensor):
        return x.chunk(n, dim)[i].clone(memory_format=torch.contiguous_format)
    return np.split(np.asarray(x), n, axis=dim)[i].copy()


def shard_tensor(x, sharding: NamedSharding, axes=None):
    """This rank's tile of the logical ``x`` (a tensor or numpy array): each
    dim that ``sharding`` splits (over ``axes`` only, if given) cut to this
    rank's chunk, a contiguous copy; ``x`` itself when nothing is split."""
    for dim, names in _sharded_dims(sharding, axes):
        n = math.prod(sharding.mesh.shape[a] for a in names)
        x = _cut(x, n, dim, axis_index(sharding.mesh, names))
    return x


def _dist_fn(name: str, old: str):
    """A ``torch.distributed`` collective by its current name, or by its
    older one on a release that lacks it."""
    import torch.distributed as dist

    return getattr(dist, name, None) or getattr(dist, old)


def _issue(kind: str, mesh: Mesh, axes, block, x: torch.Tensor, out_shape) -> bool:
    """Record one collective over ``axes`` of ``mesh`` whose result has
    ``out_shape`` and ``x``'s dtype.  Returns whether the caller must run it
    (False for a group of one, and on a virtual mesh, which takes ``meta``
    tensors only)."""
    if mesh.group_size(axes, block) == 1:
        return False
    if mesh.virtual and x.device.type != "meta":
        raise ValueError(f"{kind} on a virtual mesh {mesh} takes meta tensors only, "
                         f"got one on {x.device}")
    hlo_traffic.record(kind, math.prod(out_shape), str(x.dtype).removeprefix("torch."),
                       mesh.groups(axes, block))
    return not mesh.virtual


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh, axes, block=None) -> torch.Tensor:
    """The chunks of ``x`` of every rank of this rank's group over ``axes``
    (``block``: its part of the axis), concatenated along ``dim`` in the
    group's order."""
    n = mesh.group_size(axes, block)
    out_shape = list(x.shape)
    out_shape[dim] *= n
    if not _issue("all-gather", mesh, axes, block, x, out_shape):
        return x if n == 1 else x.new_empty(out_shape)
    buf = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)  # the chunks one after another
    _dist_fn("all_gather_single", "all_gather_into_tensor")(
        buf, x.contiguous(), group=mesh.process_group(axes, block))
    return torch.cat(buf.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh, axes, block=None) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over its group."""
    n = mesh.group_size(axes, block)
    out_shape = list(x.shape)
    out_shape[dim] //= n
    if not _issue("reduce-scatter", mesh, axes, block, x, out_shape):
        return x if n == 1 else x.new_empty(out_shape)
    chunks = torch.stack(x.chunk(n, dim))  # (n, ...): member r's chunk at r
    out = torch.empty(chunks.shape[1:], dtype=x.dtype, device=x.device)
    _dist_fn("reduce_scatter_single", "reduce_scatter_tensor")(
        out, chunks.flatten(0, 1), group=mesh.process_group(axes, block))
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``op`` "sum" or "max") over this rank's group over
    ``axes``; a new tensor unless the group is one rank."""
    import torch.distributed as dist

    if not _issue("all-reduce", mesh, axes, None, x, x.shape):
        return x if mesh.group_size(axes) == 1 else x.new_empty(x.shape)
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.process_group(axes))
    return x


def gather_tensor(x: torch.Tensor, sharding: NamedSharding, axes=None) -> torch.Tensor:
    """The logical tensor from every rank's tile ``x``: an all-gather along
    each dim that ``sharding`` splits (over ``axes`` only, if given), over
    the ranks that differ only along that dim's axes; ``x`` when nothing is
    split."""
    for dim, names in _sharded_dims(sharding, axes):
        x = all_gather(x, dim, sharding.mesh, names)
    return x


def head_range(n: int, m: int, r: int) -> tuple:
    """Model rank ``r``'s heads of ``n`` on a model axis of ``m``:
    ``[⌊r·n/m⌋, ⌊(r+1)·n/m⌋)``.  Equal shares where ``m`` divides ``n``;
    otherwise they differ by one head at most (a rank may hold none), and
    each block of ``m / gcd(n, m)`` consecutive ranks holds ``n / gcd(n,
    m)`` whole heads: exactly the columns of the block's tiles when the
    heads' columns are split evenly over the ``m`` ranks."""
    return r * n // m, (r + 1) * n // m


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a step uses one parameter leaf over the mesh's model axis.

    ``mode`` "data": the leaf is not split over the model axis; "megatron":
    the model's layer runs tensor parallel on the rank's model tile (with
    ``block`` > 1 the tile is first gathered over that many consecutive
    model ranks: a KV head replicated over them, or the tiles that hold a
    block of whole heads); "gathered": the leaf is gathered whole over the
    model axis too, and its layer runs whole on every model rank.

    ``heads``: the leaf's model dim holds that many heads of
    ``head_size`` entries each, and the model axis does not divide them
    (set only then): the rank reads its own heads (:func:`head_range`), cut
    from its block's tiles gathered over ``block = m / gcd(heads, m)``
    ranks, and the cut's gradient is put back in place in the block (zeros
    elsewhere) and reduce-scattered over it into the tile.  The ranks of a
    block read disjoint heads, so each entry of the sum has one nonzero
    term: the tile's gradient is the rank's own, exactly.

    ``model_sum``: a Megatron layer reads only a part of the leaf — the
    rank's heads or channels of a leaf whole on every model rank (qk-norm's
    scales, SSD's ``a_log``), or its columns of a leaf whose tile does not
    align with what the layer splits (SSD's ``w_in``: [z | x | B | C | dt]
    cut by plain column blocks; every rank reads B and C).  Such a leaf is
    used whole (a split one gathered over the model axis first), so each
    rank's gradient is a partial sum: zero outside what it read, its own
    contribution where several ranks read the same entries.  The gradient
    is summed over the model axis into the rank's tile (an all-reduce for a
    leaf whole over the model axis, a reduce-scatter along the tile's dim
    for a split one).  ``relayout`` is the case where the part read is a
    block along another dim: the reference's ``embed$`` rule gives the
    unembedding (d, V) its d over the model axis, where the vocab-parallel
    product wants V; the leaf is gathered whole and cut along ``relayout``
    by the model index, and the cut's gradient is put back in place (zeros
    elsewhere) before the same sum."""

    sharding: NamedSharding
    mode: str = "data"
    block: int = 0
    relayout: int | None = None
    model_sum: bool = False
    heads: int = 0
    head_size: int = 0

    @property
    def tp_dim(self) -> int | None:
        dims = _sharded_dims(self.sharding, ("model",))
        return dims[0][0] if dims else None

    def head_cut(self) -> tuple:
        """(start, size, length) of this rank's heads along the model dim of
        its block's tiles gathered, ``length`` entries long."""
        mesh = self.sharding.mesh
        m, r = mesh.shape["model"], mesh.coords()["model"]
        first = r - r % self.block  # the block's first rank
        lo, hi = head_range(self.heads, m, r)
        n = self.head_size
        return ((lo - head_range(self.heads, m, first)[0]) * n, (hi - lo) * n,
                self.heads * self.block // m * n)


def gather_for_use(x: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """The tensor a step's layer takes from the rank's tile ``x``: gathered
    over the dp axes (the ranks that share its model index), then over the
    model axis as ``plan`` says."""
    mesh = plan.sharding.mesh
    x = gather_tensor(x, plan.sharding, batch_axes(mesh))
    if plan.mode == "gathered" or (plan.model_sum and plan.tp_dim is not None):
        x = gather_tensor(x, plan.sharding, ("model",))
        if plan.relayout is not None:
            x = _cut(x, mesh.shape["model"], plan.relayout, mesh.coords()["model"])
    elif plan.block > 1:
        x = all_gather(x, plan.tp_dim, mesh, ("model",), plan.block)
    if plan.heads:
        start, size, _ = plan.head_cut()
        x = x.narrow(plan.tp_dim, start, size).clone(memory_format=torch.contiguous_format)
    return x


def _put_back(g: torch.Tensor, dim: int, length: int, start: int) -> torch.Tensor:
    """``g`` at ``[start, start + g.shape[dim])`` along ``dim`` of a tensor
    of zeros ``length`` long there."""
    shape = list(g.shape)
    shape[dim] = length
    out = g.new_zeros(shape)
    out.narrow(dim, start, g.shape[dim]).copy_(g)
    return out


def reduce_gradient(g: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """This rank's tile of the mean over the dp ranks of the gradients
    ``g`` of :func:`gather_for_use`'s tensor, in float32.

    Over the model axis first: a ``model_sum`` leaf's partial sums (a
    re-laid leaf's cut first put back in place) are summed over the model
    axis into the rank's tile — a reduce-scatter along its model dim, or an
    all-reduce for a leaf whole over the model axis; a replicated KV head's
    gradient is summed over its ranks and scattered back (a reduce-scatter
    over the block), and so is the gradient of a rank's uneven share of the
    heads, put back in place in its block first; a gathered leaf's gradient
    is the same on every model rank, which keeps its own chunk.  Then over
    the dp axes: a reduce-scatter along the dp dim (an all-reduce over the
    dp axes the leaf is not split over, or over all of them for a leaf
    replicated over dp), then a division by the dp rank count (exact for a
    power of two; a world of one changes no bit)."""
    mesh = plan.sharding.mesh
    g = g.float()
    if plan.model_sum:
        if plan.relayout is not None:
            n = g.shape[plan.relayout]
            g = _put_back(g, plan.relayout, n * mesh.shape["model"],
                          n * mesh.coords()["model"])
        if plan.tp_dim is None:
            g = all_reduce(g, mesh, ("model",))
        else:
            g = reduce_scatter(g, plan.tp_dim, mesh, ("model",))
    elif plan.mode == "gathered":
        for dim, names in _sharded_dims(plan.sharding, ("model",)):
            g = _cut(g, math.prod(mesh.shape[a] for a in names), dim,
                     axis_index(mesh, names))
    elif plan.block > 1:
        if plan.heads:
            start, _, length = plan.head_cut()
            g = _put_back(g, plan.tp_dim, length, start)
        g = reduce_scatter(g, plan.tp_dim, mesh, ("model",), plan.block)
    batch = batch_axes(mesh)
    split = _sharded_dims(plan.sharding, batch)
    done = set()
    for dim, names in split:
        g = reduce_scatter(g, dim, mesh, names)
        done |= set(names)
    rest = tuple(a for a in batch if a not in done and mesh.shape[a] > 1)
    if rest:
        g = all_reduce(g, mesh, rest)
    n = math.prod(mesh.shape[a] for a in batch)
    return g / n if n > 1 else g


# ---- tensor parallelism over the model axis (Megatron) -----------------------

def _tp_mesh() -> Mesh:
    if _ACTIVE_MESH is None or _ACTIVE_MESH.shape.get("model", 1) == 1:
        raise ValueError("a layer runs tensor parallel on split weights, but no "
                         "mesh with a model axis is active (use_mesh)")
    return _ACTIVE_MESH


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over the model axis:
    a tensor-parallel block's input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("model",)), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model axis forward, identity backward: a
    tensor-parallel block's output (the partial sums of its row-parallel
    product)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    """All-reduce over the model axis forward and backward: a sum that
    every model rank's output depends on (the gated norm's sum of squares
    over the ranks' channels), whose downstream gradient differs by rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("model",)), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` over the model axis forward, reduce-scatter
    of the gradient backward: every rank reads every rank's share, and each
    rank's gradient of the whole is a partial sum."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(x, dim, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.mesh, ("model",)), None, None


class _MeanOverBatch(torch.autograd.Function):
    """Mean over the mesh's dp ranks forward, identity backward: a
    statistic of the global batch that every dp rank's loss repeats (the
    step averages the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes) / math.prod(mesh.shape[a] for a in axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the dp ranks of the active mesh in a
    differentiable step (its gradient passes through: each dp rank's loss
    holds the same mean, and the step averages their gradients); ``x``
    itself without a mesh, with one dp rank, or without grad (serving)."""
    mesh = _ACTIVE_MESH
    axes = () if mesh is None else tuple(a for a in batch_axes(mesh) if mesh.shape[a] > 1)
    if not axes or not torch.is_grad_enabled():
        return x
    return _MeanOverBatch.apply(x, mesh, axes)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel block on the active mesh."""
    return _CopyToModel.apply(x, _tp_mesh())


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor-parallel block's partial outputs over the active
    mesh's model axis (its gradient passes through unchanged: every model
    rank holds the same output gradient)."""
    return _ReduceFromModel.apply(x, _tp_mesh())


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active mesh's model axis where each rank's
    use of the sum differs: its gradient is summed over the axis too."""
    return _SumOverModel.apply(x, _tp_mesh())


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's share of ``x`` concatenated along ``dim`` (in
    model order), on the active mesh; its gradient reduce-scattered back."""
    return _GatherFromModel.apply(x, dim % x.dim(), _tp_mesh())


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum of ``x`` over the active mesh's model axis, without a
    gradient."""
    return all_reduce(x.detach(), _tp_mesh(), ("model",), op="max")


def tp_rank() -> int:
    """This rank's model index on the active mesh."""
    return _tp_mesh().coords()["model"]


def tp_size() -> int:
    """The size of the active mesh's model axis."""
    return _tp_mesh().shape["model"]


def tp_heads(n: int) -> tuple:
    """This rank's heads ``[h0, h1)`` of ``n`` on the active mesh's model
    axis (:func:`head_range`)."""
    return head_range(n, tp_size(), tp_rank())
