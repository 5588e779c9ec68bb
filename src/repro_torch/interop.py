"""Carry the reference's state across to the port.

In the controller what stands in for parameters is the fabric, the trace, the
configurations and, for the streaming controller, the PDHG iterates carried
from one epoch to the next; in the model stack it is the parameter pytree.
These helpers rebuild the port's objects from numpy arrays and plain dicts
(for example ``dataclasses.asdict`` of the reference's objects), so both
packages can be handed the same state without the port importing the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.burst import BurstParams, LossConfig
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.graph import Fabric
from repro_torch.core.pdhg import RoutingWarmState
from repro_torch.core.solver import SolverConfig, Strategy
from repro_torch.core.traffic import Trace
from repro_torch.device import resolve_device
from repro_torch.failures import FailureConfig
from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamWState
from repro_torch.serve import ServeConfig
from repro_torch.transition import TransitionConfig

__all__ = ["fabric_from_numpy", "trace_from_numpy", "strategy_from_dict",
           "solver_config_from_dict", "loss_config_from_dict",
           "controller_config_from_dict", "serve_config_from_dict",
           "warm_state_from_numpy", "model_from_numpy", "model_to_numpy",
           "adamw_state_from_numpy", "adamw_state_to_numpy"]

# the reference's metrics backends → the port's
_BACKENDS = {"pallas": "torch", "jax": "torch", "numpy": "numpy"}


def fabric_from_numpy(name: str, radix, speed) -> Fabric:
    return Fabric(name=name, radix=np.asarray(radix), speed=np.asarray(speed))


def trace_from_numpy(name: str, demand, interval_minutes: float,
                     n_pods: int) -> Trace:
    return Trace(name, np.asarray(demand, np.float64), float(interval_minutes),
                 int(n_pods))


def strategy_from_dict(d: dict) -> Strategy:
    return Strategy(**d)


def solver_config_from_dict(d: dict) -> SolverConfig:
    return SolverConfig(**d)


def loss_config_from_dict(d: dict | None) -> LossConfig | None:
    if d is None:
        return None
    d = dict(d)
    return LossConfig(burst=BurstParams(**d.pop("burst")), **d)


def controller_config_from_dict(d: dict) -> ControllerConfig:
    """``ControllerConfig`` from the reference's fields.  ``backend`` maps
    "pallas"/"jax" to "torch" and keeps "numpy"; ``transition`` and
    ``failures`` (the reference's ``TransitionConfig`` and ``FailureConfig``
    fields) become the port's."""
    d = dict(d)
    d["backend"] = _BACKENDS[d["backend"]]
    d["loss"] = loss_config_from_dict(d.get("loss"))
    if d.get("transition") is not None:
        d["transition"] = TransitionConfig(**d["transition"])
    if d.get("failures") is not None:
        d["failures"] = FailureConfig(**d["failures"])
    return ControllerConfig(**d)


def serve_config_from_dict(d: dict) -> ServeConfig:
    return ServeConfig(**d)


def warm_state_from_numpy(d: dict, device=None) -> RoutingWarmState:
    """The port's :class:`RoutingWarmState` from the reference's fields
    (``f1``, ``y1``, ``f2``, ``y2``, ``z2``, ``y3``) as numpy arrays or
    ``None``; the tensors are float32 on ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)

    def put(x):
        return (None if x is None
                else torch.from_numpy(np.array(x, np.float32)).to(dev))

    return RoutingWarmState(**{k: put(d.get(k)) for k in
                               ("f1", "y1", "f2", "y2", "z2", "y3")})


# parameters the reference keeps in float32 whatever the model's dtype
_F32_LEAVES = frozenset({"lambda_raw", "a_log", "d_skip", "dt_bias", "router"})
# groups whose leaves the reference stacks along a leading layer axis
_STACKED = frozenset({"blocks", "super", "tail", "enc_blocks", "dec_blocks"})


def _unstack_groups(tree: dict, leaf):
    """The port's tree from the reference's: stacked groups split into one
    dict per layer, every array through ``leaf(name, array)``."""
    def convert(t):
        return {k: leaf(k, v) if not isinstance(v, dict) else convert(v)
                for k, v in t.items()}

    def unstack(t, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}

    def depth(t):
        v = next(iter(t.values()))
        return depth(v) if isinstance(v, dict) else len(v)

    out = {}
    for key, value in tree.items():
        if key in _STACKED:
            out[key] = [convert(unstack(value, i)) for i in range(depth(value))]
        elif isinstance(value, dict):
            out[key] = convert(value)
        else:
            out[key] = leaf(key, value)
    return out


def _numpy_stacked(tree) -> dict:
    """A port tree (or ``Params`` module) as the reference's stacked tree of
    float32 numpy arrays (bfloat16 upcast exactly)."""
    def host(t):
        return t.detach().float().cpu().numpy()

    return tree_util.stacked(tree_util.unflatten(
        tree, [host(t) for t in tree_util.leaves(tree)]), stack=np.stack)


def model_from_numpy(cfg: ArchConfig, params: dict, device=None, dtype=None):
    """The port's model from the reference's parameter pytree as nested
    dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    Stacked layer groups (``blocks``, ``super``, ``tail``, and the audio
    family's ``enc_blocks`` and ``dec_blocks``: leading axis L) become one
    entry per layer; an moe block's expert weights stay stacked along their
    expert axis, (E, d, ff) per layer.  The audio family gives an
    ``EncDecLM``, every other a ``DecoderLM``.  Each array is read as float32, which is
    exact for bfloat16 (numpy's ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` does not take, included), and stored in ``dtype``
    (default ``cfg.dtype``) on ``device`` (``None`` = CUDA), except the
    parameters the reference keeps in float32.
    """
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg)

    def leaf(name, x):
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name in _F32_LEAVES else dt)

    out = _unstack_groups(params, leaf)
    return EncDecLM(cfg, out) if cfg.family == "audio" else DecoderLM(cfg, out)


def model_to_numpy(model_params) -> dict:
    """The reference's parameter pytree (nested dicts, layer groups stacked
    along a leading axis) of the port's model, as float32 numpy arrays
    (bfloat16 parameters upcast exactly; cast with the reference's dtypes
    to hand it back)."""
    return _numpy_stacked(model_params)


def adamw_state_from_numpy(d: dict, params, device=None) -> AdamWState:
    """The port's :class:`AdamWState` from the reference's fields as numpy
    (``step``; ``mu`` and ``nu`` stacked like its parameter pytree), shaped
    like ``params`` (the port's model or tree): float32 moments on
    ``device`` (``None`` = CUDA), the step as int32."""
    dev = resolve_device(device)

    def moments(tree):
        return _unstack_groups(tree, lambda name, x: torch.from_numpy(
            np.array(x, dtype=np.float32)).to(dev))

    mu, nu = moments(d["mu"]), moments(d["nu"])
    for m in (mu, nu):  # the same structure as the parameters
        tree_util.unflatten(params, tree_util.leaves(m))
    return AdamWState(step=torch.tensor(int(np.asarray(d["step"])), dtype=torch.int32,
                                        device=dev), mu=mu, nu=nu)


def adamw_state_to_numpy(state: AdamWState) -> dict:
    """The reference's AdamW fields of ``state``: ``step`` (int32) and
    ``mu``/``nu`` stacked like its parameter pytree, as numpy."""
    return {"step": np.int32(int(state.step)), "mu": _numpy_stacked(state.mu),
            "nu": _numpy_stacked(state.nu)}
