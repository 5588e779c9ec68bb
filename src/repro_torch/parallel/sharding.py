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
parameter and optimizer memory scale with the device count (ZeRO-3).  The
port executes meshes whose ``model`` axis has size 1: the dp dim of each
leaf is split over the ranks, and a ``model`` axis larger than 1 (tensor
parallelism in execution) raises ``NotImplementedError`` (ROADMAP 2.11).
The spec functions read only a mesh's axis names and sizes, so they answer
for any mesh shape, the 16×16 and 2×16×16 production meshes included.

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

__all__ = [
    "PartitionSpec", "P", "Mesh", "NamedSharding", "set_profile", "get_profile",
    "set_active_mesh", "active_mesh", "use_mesh", "fleet_mesh", "shard_leading",
    "dp_axes", "spec", "constrain", "PARAM_RULES", "param_spec_for", "fit_spec",
    "param_shardings", "check_executable", "shard_dim", "shard_tensor",
    "gather_tensor", "reduce_gradient", "host_sync_point", "TP_ROADMAP",
]

TP_ROADMAP = "ROADMAP 2.11: tensor parallelism in execution"

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

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

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


def check_executable(mesh: Mesh) -> None:
    """Raise unless the port can execute on ``mesh``: a ``model`` axis
    larger than 1 is tensor parallelism, a later slice."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with a model axis of {mesh.shape['model']} shards tensors "
            f"over the model axis; executing it is a later slice of the port "
            f"({TP_ROADMAP}); the specs of such a mesh are answered")


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
    """The activation constraint of the reference's model code.  With no
    active mesh, or one whose ``model`` axis has size 1, it leaves ``x`` as
    it is: each rank's tensors are already its local slice of the data
    axes.  A ``model`` axis larger than 1 raises (ROADMAP 2.11)."""
    if _ACTIVE_MESH is None:
        return x
    check_executable(_ACTIVE_MESH)
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


# ---- executing a data-axis sharding (FSDP) ----------------------------------

def shard_dim(sharding: NamedSharding) -> int | None:
    """The dim that ``sharding`` splits over the mesh's ranks: the first
    entry naming a data axis ("data" or "pod") whose size exceeds 1, or
    ``None`` (replicated).  Raises on a mesh the port cannot execute."""
    mesh = sharding.mesh
    check_executable(mesh)
    for dim, axes in enumerate(sharding.spec):
        names = axes if isinstance(axes, tuple) else (axes,)
        if any(a in ("data", "pod") for a in names if a is not None) and \
                math.prod(mesh.shape[a] for a in names if a is not None) > 1:
            return dim
    return None


def _collective(name: str, old: str):
    """A ``torch.distributed`` collective by its current name, or by its
    older one on a release that lacks it."""
    import torch.distributed as dist

    return getattr(dist, name, None) or getattr(dist, old)


def _group_size(mesh: Mesh) -> int:
    import torch.distributed as dist

    return dist.get_world_size(mesh.group) if dist.is_initialized() else 1


def shard_tensor(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the logical tensor ``x`` (a contiguous copy of
    its chunk along :func:`shard_dim`; ``x`` itself when replicated)."""
    dim = shard_dim(sharding)
    if dim is None:
        return x
    n = sharding.mesh.size
    return x.chunk(n, dim)[sharding.mesh.rank_index].contiguous()


def gather_tensor(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The logical tensor from every rank's shard ``x`` (an all-gather over
    the mesh's group along :func:`shard_dim`; ``x`` when replicated)."""
    import torch.distributed as dist

    dim = shard_dim(sharding)
    if dim is None:
        return x
    n = sharding.mesh.size
    buf = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)  # the shards one after another
    _collective("all_gather_single", "all_gather_into_tensor")(
        buf, x.contiguous(), group=sharding.mesh.group)
    return torch.cat(buf.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def reduce_gradient(g: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the mean over the ranks of the full gradients
    ``g``, in float32: a reduce-scatter along :func:`shard_dim`, or an
    all-reduce for a replicated leaf, then a division by the rank count
    (exact for a power of two; a world of one changes no bit)."""
    import torch.distributed as dist

    g = g.float()
    n = _group_size(sharding.mesh)
    if n == 1:
        return g
    dim = shard_dim(sharding)
    if dim is None:
        g = g.clone()
        dist.all_reduce(g, group=sharding.mesh.group)
        return g / n
    chunks = torch.stack(g.chunk(n, dim))  # (n, ...): rank r's chunk at r
    out = torch.empty(chunks.shape[1:], dtype=torch.float32, device=g.device)
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, chunks.flatten(0, 1), group=sharding.mesh.group)
    return out / n
