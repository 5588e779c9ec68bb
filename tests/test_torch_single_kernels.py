"""Port vs reference: single-block scoring — the kernels #3/#4 path.

* ``link_metrics`` / ``queue_loss`` (the port's plain PyTorch versions on CPU
  tensors) against the reference's ``ops`` with the Pallas kernels in
  interpret mode and with the float64 numpy oracle, ragged shapes and dead
  links included: rtol 3e-4, atol 1e-4 (the contract of
  ``tests/test_kernels_linkload.py`` / ``test_kernels_queueloss.py``).
  Observed on the CPU: max relative error 1.8e-7 (linkload) and 2.6e-7
  (queueloss).
* ``route_metrics`` / ``interval_loss`` of the port on ``backend="torch"``
  against its float64 numpy path, and against the reference's: 1e-5 rtol/atol
  (``tests/test_backend_parity.py``).  Observed: 1.2e-6 worst relative.
* The (uniform, VLB) and Clos baselines against the reference's at 1e-5.
"""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.burst.queue import interval_loss as ref_interval_loss
from repro.core import baselines as ref_baselines
from repro.core.simulator import route_metrics as ref_route_metrics
from repro.kernels.linkload import ops as ref_llops
from repro.kernels.queueloss import ops as ref_qlops
from repro_torch import interop
from repro_torch.burst import interval_loss
from repro_torch.core import baselines
from repro_torch.core.simulator import route_metrics
from repro_torch.kernels.linkload import ops as llops
from repro_torch.kernels.queueloss import ops as qlops

torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4
TOL = 1e-5
NAMES = ("mlu", "alu", "olr", "tot")
FIELDS = ("mlu", "alu", "olr", "stretch", "loss")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=6, buffer_ms=25.0, seed=3)


def _link_inputs(seed, t, c, e):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 10.0, (t, c))
    w = rng.random((c, e)) * (rng.random((c, e)) > 0.5)
    cap = rng.uniform(50, 500, e)
    cap[rng.random(e) < 0.1] = 0.0  # dead links
    return d, w, cap


def _queue_inputs(seed, ts, c, e):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 5.0, (ts, c))
    d *= 1.0 + 3.0 * (rng.random((ts, c)) < 0.05)  # bursts overflow buffers
    w = rng.random((c, e)) * (rng.random((c, e)) < 0.3)
    cap = rng.uniform(20.0, 60.0, e)
    cap[rng.random(e) < 0.1] = 0.0  # dead links
    return d, w, cap, cap * 0.025


@pytest.mark.parametrize("t,c,e", [(3, 132, 132), (13, 30, 200), (7, 56, 40)])
def test_link_metrics_matches_reference(t, c, e):
    d, w, cap = _link_inputs(t * 1000 + e, t, c, e)
    ref_pallas = ref_llops.link_metrics(d, w, cap, 0.8, backend="pallas")
    ref_numpy = ref_llops.link_metrics(d, w, cap, 0.8, backend="numpy")
    out = llops.link_metrics(d, w, cap, 0.8, backend="torch", device="cpu")
    for a, r, p, name in zip(out, ref_numpy, ref_pallas, NAMES):
        assert a.shape == (t,), name
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a, p, rtol=RTOL, atol=ATOL, err_msg=name)
    # the port's numpy oracle is the reference's, line for line
    for a, r in zip(llops.link_metrics(d, w, cap, 0.8, backend="numpy"), ref_numpy):
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("ts,c,e", [(36, 30, 30), (150, 20, 45)])
def test_queue_loss_matches_reference(ts, c, e):
    """The queue starts empty at the call and carries across every sub-step
    (150 is more than the reference's 128-row time tile)."""
    d, w, cap, buf = _queue_inputs(ts + e, ts, c, e)
    ref = ref_qlops.queue_loss(d, w, cap, buf, 25.0, backend="pallas")
    ref_np = ref_qlops.queue_loss(d, w, cap, buf, 25.0, backend="numpy")
    out = qlops.queue_loss(d, w, cap, buf, 25.0, backend="torch", device="cpu")
    assert ref_np[0].sum() > 0.0, "parity must be exercised on real drops"
    for a, r, p in zip(out, ref_np, ref):
        assert a.shape == (ts,) and a.dtype == np.float64
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, p, rtol=RTOL, atol=ATOL)
    for a, r in zip(qlops.queue_loss(d, w, cap, buf, 25.0, backend="numpy"),
                    ref_np):
        np.testing.assert_array_equal(a, r)


def test_single_block_is_the_batched_kernel_at_one_epoch():
    """Both wrappers at B = 1 give the single-block results (the CUDA entries
    launch the same body)."""
    d, w, cap, buf = (torch.from_numpy(x.astype(np.float32))
                      for x in _queue_inputs(5, 40, 20, 24))
    ic = torch.where(cap > 0, 1.0 / torch.clamp(cap, min=1e-9), 0.0)
    for a, b in zip(llops.linkload(d, w, ic, 0.8),
                    llops.linkload_batched(d[None], w[None], ic[None], 0.8)):
        torch.testing.assert_close(a, b[0])
    for a, b in zip(qlops.queueloss(d, w, cap, buf, 25.0),
                    qlops.queueloss_batched(d[None], w[None], cap[None],
                                            buf[None], 25.0)):
        torch.testing.assert_close(a, b[0])


def _queueloss_cluster_schedule(demand, w, cap, buf, dt, *, cluster=8):
    """The redesigned single-block kernel's split (``csrc/queueloss.cu``) in
    float32: E cut into ``cluster`` slices of ceil(E / cluster) links; every
    load summed over each quarter of c in order, then the quarters added; each
    link's queue walked in order; per slice and sub-step the sum over its
    links in order, then the slices in rank order.  Returns (drop, load),
    each (TS,), and the drops per (sub-step, link)."""
    ts, c = demand.shape
    e = w.shape[1]
    quarter = -(-c // 4)
    load = None
    for lo in range(0, 4 * quarter, quarter):
        acc = torch.zeros((ts, e))
        for ci in range(lo, min(c, lo + quarter)):
            acc = acc + demand[:, ci:ci + 1] * w[ci]
        load = acc if load is None else load + acc
    drops = torch.empty((ts, e))
    q = torch.zeros(e)
    for k in range(ts):
        x = q + (load[k] - cap) * dt
        drops[k] = torch.clamp(x - buf, min=0.0)
        q = torch.minimum(torch.clamp(x, min=0.0), buf)
    es = -(-e // cluster)
    out = []
    for v in (drops, load):
        total = torch.zeros(ts)
        for r in range(cluster):
            part = torch.zeros(ts)
            for j in range(min(e, r * es), min(e, (r + 1) * es)):
                part = part + v[:, j]
            total = total + part
        out.append(total)
    return out[0], out[1], drops


@pytest.mark.parametrize("ts,c,e", [(1, 30, 45), (36, 30, 45), (45, 20, 60),
                                    (36, 12, 7)])  # the last: 7 links, 8 slices
def test_queueloss_cluster_schedule_matches_reference(ts, c, e):
    """The one-launch kernel's load-then-scan split and its order of sums
    over links give the reference's Pallas kernel's answer (interpret mode);
    padded links (cap = buf = 0, no load) never drop."""
    d, w, cap, buf = _queue_inputs(7 * ts + e, ts, c, e)
    cap[-1] = buf[-1] = 0.0  # at least one dead link
    w[:, cap == 0.0] = 0.0  # dead links carry nothing, as padded ones
    ref = ref_qlops.queue_loss(d, w, cap, buf, 25.0, backend="pallas")
    drop, load, per_link = _queueloss_cluster_schedule(
        *(torch.from_numpy(x.astype(np.float32)) for x in (d, w, cap, buf)), 25.0)
    assert ref[0].sum() > 0.0, "parity must be exercised on real drops"
    assert float(per_link[:, torch.from_numpy(cap == 0.0)].abs().sum()) == 0.0
    for a, r in zip((drop, load), ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=ATOL)


def _butterfly(v, op=torch.add):
    """Lane 0's value after a warp's xor butterfly over the last axis (32
    lanes): ``v[i] = op(v[i], v[i ^ off])`` for off = 16, 8, 4, 2, 1."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[..., lane ^ off])
    return v[..., 0]


def _lanes(x):
    """``x`` (..., E) cut into rounds of 32 lanes (..., rounds, 32): lane l
    owns the links l, l + 32, ... in order; past E, zeros."""
    e = x.shape[-1]
    rounds = -(-e // 32)
    return torch.nn.functional.pad(x, (0, 32 * rounds - e)).reshape(
        x.shape[:-1] + (rounds, 32))


def _linkload_single_schedule(demand, w, inv_cap, thr):
    """The single-block linkload body's split (``csrc/linkload.cu``) in
    float32: every load summed over each quarter of c in order, then the
    quarters added in order; util = load * inv_cap; per row, each lane folds
    max, sum util, #(util > thr) and sum load over its links in order
    (starting from 0), then a warp butterfly.  Returns (mlu, alu_sum,
    olr_count, load_sum), each (T,)."""
    t, c = demand.shape
    quarter = -(-c // 4)
    load = None
    for lo in range(0, 4 * quarter, quarter):
        acc = torch.zeros((t, w.shape[1]))
        for ci in range(lo, min(c, lo + quarter)):
            acc = acc + demand[:, ci:ci + 1] * w[ci]
        load = acc if load is None else load + acc
    util = load * inv_cap
    u, l = _lanes(util), _lanes(load)
    m = a = n = s = torch.zeros((t, 32))
    for r in range(u.shape[1]):
        m = torch.maximum(m, u[:, r])
        a = a + u[:, r]
        n = n + (u[:, r] > thr).float()
        s = s + l[:, r]
    return (_butterfly(m, torch.maximum), _butterfly(a), _butterfly(n),
            _butterfly(s))


def _dyadic_link_inputs(seed, t, c, e):
    """Demand in {0..15} and weights in sixteenths: every load is exact in
    f32 whatever the order of its sum, so OLR cannot flip on a rounding
    tie; capacities put utilizations on both sides of 0.8."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 16, (t, c)).astype(np.float64)
    w = rng.integers(0, 17, (c, e)) / 16.0 * (rng.random((c, e)) < 0.3)
    load = d @ w
    cap = np.maximum(load.max(axis=0), 1.0) * rng.uniform(0.6, 1.6, e)
    cap[rng.random(e) < 0.1] = 0.0  # dead links
    return d, w, cap


@pytest.mark.parametrize("t,c,e,dyadic", [
    (3, 132, 132, False),  # the streaming controller's block
    (1, 30, 45, False), (13, 30, 200, False),  # one row; ragged, E > 128
    (6, 12, 7, False),     # fewer links than lanes, C < 4 per quarter
    (3, 132, 132, True), (11, 56, 40, True)])
def test_linkload_single_schedule_matches_reference(t, c, e, dyadic):
    """The one-CTA kernel's quarters of C and its order of sums over links
    give the reference's Pallas kernel's answer (interpret mode); on dyadic
    data, where every load is exact, the OLR counts are equal."""
    make = _dyadic_link_inputs if dyadic else _link_inputs
    d, w, cap = make(31 * t + e, t, c, e)
    ref = ref_llops.link_metrics(d, w, cap, 0.8, backend="pallas")
    live = cap > 1e-9
    n_live = max(int(live.sum()), 1)
    inv_cap = np.where(live, 1.0 / np.maximum(cap, 1e-9), 0.0)
    out = _linkload_single_schedule(
        *(torch.from_numpy(x.astype(np.float32)) for x in (d, w, inv_cap)), 0.8)
    mlu, alu_sum, olr_cnt, tot = (x.numpy() for x in out)
    for a, r, name in zip((mlu, alu_sum / n_live, olr_cnt / n_live, tot), ref, NAMES):
        assert a.shape == (t,), name
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
    if dyadic:
        assert 0 < olr_cnt.sum() < t * n_live  # the threshold bites, not everywhere
        np.testing.assert_array_equal(olr_cnt / n_live, ref[2].astype(np.float32))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    d, w = torch.zeros((3, 4)), torch.zeros((4, 5))
    with pytest.raises(ValueError, match="disagree"):
        llops.linkload(d, w, torch.zeros(4), 0.8)
    with pytest.raises(ValueError, match="float32"):
        llops.linkload(d.double(), w, torch.zeros(5), 0.8)
    with pytest.raises(ValueError, match="disagree"):
        qlops.queueloss(d, w, torch.zeros(5), torch.zeros(4), 1.0)
    with pytest.raises(ValueError, match="unknown backend"):
        llops.link_metrics(np.zeros((1, 2)), np.zeros((2, 2)), np.ones(2),
                           backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        qlops.queue_loss(np.zeros((1, 2)), np.zeros((2, 2)), np.ones(2),
                         np.ones(2), 1.0, backend="pallas")


@pytest.fixture(scope="module")
def block(small_fabric, small_trace):
    """Ten intervals under mostly-direct routing (bursts overflow), one dead
    trunk."""
    from repro.core.graph import uniform_topology

    cap = small_fabric.capacities(uniform_topology(small_fabric))
    cap[:2] = 0.0
    vlb = ref_baselines.vlb_weights(small_fabric.n_pods)
    w = 0.2 * vlb + 0.8 * np.eye(cap.size)
    return small_trace.demand[40:50], w, cap


def test_route_metrics_matches_numpy_and_reference(block):
    demand, w, cap = block
    port_loss = interop.loss_config_from_dict(dataclasses.asdict(LOSS))
    kw = dict(interval_seconds=3600.0)
    out = route_metrics(demand, w, cap, 0.8, backend="torch",
                        loss_cfg=port_loss, device="cpu", **kw)
    oracle = route_metrics(demand, w, cap, 0.8, backend="numpy",
                           loss_cfg=port_loss, **kw)
    ref = ref_route_metrics(demand, w, cap, 0.8, backend="pallas",
                            loss_cfg=LOSS, **kw)
    ref_np = ref_route_metrics(demand, w, cap, 0.8, backend="numpy",
                               loss_cfg=LOSS, **kw)
    assert oracle.loss.max() > 0.0, "parity must be exercised on real loss"
    for field in FIELDS:
        a = getattr(out, field)
        assert a.shape == (demand.shape[0],), field
        for r in (getattr(oracle, field), getattr(ref, field)):
            np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=field)
        # the numpy path is the reference's, letter for letter
        np.testing.assert_array_equal(getattr(oracle, field),
                                      getattr(ref_np, field), err_msg=field)


def test_interval_loss_matches_reference(block):
    demand, w, cap = block
    out = interval_loss(demand, w, cap, 3600.0,
                        interop.loss_config_from_dict(dataclasses.asdict(LOSS)),
                        backend="torch", device="cpu")
    ref = ref_interval_loss(demand, w, cap, 3600.0, LOSS, backend="numpy")
    assert ref.max() > 0.0
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert interval_loss(demand[:0], w, cap, 3600.0, LOSS, device="cpu").shape == (0,)


def test_baselines_match_reference(small_fabric, small_trace):
    fab = interop.fabric_from_numpy(small_fabric.name, small_fabric.radix,
                                    small_fabric.speed)
    trace = interop.trace_from_numpy(small_trace.name, small_trace.demand,
                                     small_trace.interval_minutes,
                                     small_trace.n_pods)
    np.testing.assert_array_equal(baselines.vlb_weights(fab.n_pods),
                                  ref_baselines.vlb_weights(fab.n_pods))
    ref = ref_baselines.uniform_vlb_metrics(small_fabric, small_trace)
    out = baselines.uniform_vlb_metrics(fab, trace, device="cpu")
    for field in ("mlu", "alu", "olr", "stretch"):
        np.testing.assert_allclose(getattr(out, field), getattr(ref, field),
                                   rtol=TOL, atol=TOL, err_msg=field)
    ref_c = ref_baselines.clos_metrics(small_fabric, small_trace)
    out_c = baselines.clos_metrics(fab, trace)
    for field in ("mlu", "alu", "olr", "stretch"):
        np.testing.assert_array_equal(getattr(out_c, field), getattr(ref_c, field))
