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
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import ServeConfig
from repro_torch.transition import TransitionConfig

__all__ = ["fabric_from_numpy", "trace_from_numpy", "strategy_from_dict",
           "solver_config_from_dict", "loss_config_from_dict",
           "controller_config_from_dict", "serve_config_from_dict",
           "warm_state_from_numpy", "model_from_numpy"]

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
_STACKED = frozenset({"blocks", "super", "tail"})


def model_from_numpy(cfg: ArchConfig, params: dict, device=None,
                     dtype=None) -> DecoderLM:
    """The port's model from the reference's parameter pytree as nested
    dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    Stacked layer groups (``blocks``, ``super``, ``tail``: leading axis L)
    become one entry per layer; an moe block's expert weights stay stacked
    along their expert axis, (E, d, ff) per layer.  Each array is read as float32, which is
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

    def convert(tree):
        return {k: leaf(k, v) if not isinstance(v, dict) else convert(v)
                for k, v in tree.items()}

    def unstack(tree, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    def depth(tree):
        v = next(iter(tree.values()))
        return depth(v) if isinstance(v, dict) else len(v)

    out = {}
    for key, value in params.items():
        if key in _STACKED:
            out[key] = [convert(unstack(value, i)) for i in range(depth(value))]
        elif isinstance(value, dict):
            out[key] = convert(value)
        else:
            out[key] = leaf(key, value)
    return DecoderLM(cfg, out)
