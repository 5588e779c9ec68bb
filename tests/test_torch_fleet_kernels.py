"""Port vs reference: the fleet-batched scoring path — kernels #5/#6 and
what scores a fleet bucket through them.

The same numpy inputs, made from a seed, go through the reference's fleet
functions (``backend="pallas"``: the fleet Pallas kernels in interpret mode,
as ``tests/test_fleet_engine.py`` runs them) and the port's (the plain
PyTorch versions on the CPU, and the float64 numpy oracle).  The inputs are
ragged (fabrics with fewer blocks than the bucket's ``b_max``, whose padded
blocks are all zeros), carry dead links, and sit in a padded-pod layout
(:func:`repro.core.fleet.commodity_slots`).

Tolerances:
* port vs the Pallas side: the kernel contract, rtol 3e-4 / atol 1e-4
  (``tests/test_kernels_linkload.py``: float32 against float64);
* the port's fleet path vs its own per-fabric batched path: rtol 1e-5 /
  atol 1e-6, the reference's fleet-vs-batched contract
  (``tests/test_fleet_engine.py:256``);
* ``interval_loss_fleet`` on numpy: bit-equal to the reference's
  (``tests/test_fleet_engine.py:207``: same expansion seeds, same queue).
"""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.burst import interval_loss_fleet as ref_interval_loss_fleet
from repro.core.fleet import commodity_slots, scatter_pad
from repro.core.simulator import route_metrics_fleet as ref_route_metrics_fleet
from repro.kernels.linkload import ops as ref_llops
from repro.kernels.queueloss import ops as ref_qlops
from repro_torch import interop
from repro_torch.burst import interval_loss_batched, interval_loss_fleet
from repro_torch.core.simulator import route_metrics_batched, route_metrics_fleet
from repro_torch.kernels.linkload import ops as llops
from repro_torch.kernels.queueloss import ops as qlops

torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4  # kernel contract vs the Pallas side
FLEET_RTOL, FLEET_ATOL = 1e-5, 1e-6  # fleet vs per-fabric batched
NAMES = ("mlu", "alu", "olr", "tot")
FIELDS = ("mlu", "alu", "olr", "stretch", "loss")
LOSS = LossConfig(burst=BurstParams(rate=0.2, shape=1.6, scale=2.0, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
PORT_LOSS = interop.loss_config_from_dict(dataclasses.asdict(LOSS))


def _fleet_arrays(seed, f, b, t, c, e, n_blocks):
    """(F, B, T, C) demand, (F, B, C, E) weights, (F, B, E) capacities with
    fabric ``fi``'s blocks past ``n_blocks[fi]`` all zero (padded) and ~10 %
    dead links."""
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 10.0, (f, b, t, c))
    w = rng.random((f, b, c, e)) * (rng.random((f, b, c, e)) > 0.5)
    cap = rng.uniform(50, 500, (f, b, e))
    cap[rng.random((f, b, e)) < 0.1] = 0.0
    for fi, nb in enumerate(n_blocks):
        d[fi, nb:], w[fi, nb:], cap[fi, nb:] = 0.0, 0.0, 0.0
    return d, w, cap


@pytest.mark.parametrize("f,b,t,c,e,n_blocks", [
    (3, 4, 3, 56, 56, (4, 2, 3)),  # the 8-pod bucket's width
    (2, 3, 13, 30, 30, (3, 1)),
])
def test_link_metrics_fleet_matches_reference(f, b, t, c, e, n_blocks):
    d, w, cap = _fleet_arrays(f * 100 + t, f, b, t, c, e, n_blocks)
    ref_pallas = ref_llops.link_metrics_fleet(d, w, cap, 0.8, backend="pallas")
    ref_numpy = ref_llops.link_metrics_fleet(d, w, cap, 0.8, backend="numpy")
    out = llops.link_metrics_fleet(d, w, cap, 0.8, backend="torch", device="cpu")
    for a, r, p, name in zip(out, ref_numpy, ref_pallas, NAMES):
        assert a.shape == (f, b, t), name
        np.testing.assert_allclose(a, p, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
    # padded blocks (no live link) score zeros, as the n_live clamp makes them
    assert all((x[1, n_blocks[1]:] == 0).all() for x in out)
    for a, r in zip(llops.link_metrics_fleet(d, w, cap, 0.8, backend="numpy"),
                    ref_numpy):
        np.testing.assert_array_equal(a, r)


def test_link_metrics_fleet_matches_batched_per_fabric():
    """Every (fabric, block) pair is scored on its own: the fleet call equals
    the epoch-batched call fabric by fabric."""
    d, w, cap = _fleet_arrays(7, 3, 4, 5, 30, 30, (4, 2, 3))
    out = llops.link_metrics_fleet(d, w, cap, 0.8, device="cpu")
    for fi in range(3):
        ref = llops.link_metrics_batched(d[fi], w[fi], cap[fi], 0.8,
                                         device="cpu")
        for a, r, name in zip(out, ref, NAMES):
            np.testing.assert_allclose(a[fi], r, rtol=FLEET_RTOL,
                                       atol=FLEET_ATOL, err_msg=name)


@pytest.mark.parametrize("f,b,ts,c,e,n_blocks", [
    (2, 3, 10, 12, 12, (3, 2)),  # tests/test_fleet_engine.py's shape
    (3, 2, 13, 56, 56, (2, 1, 2)),
])
def test_queue_loss_fleet_matches_reference(f, b, ts, c, e, n_blocks):
    rng = np.random.default_rng(f * 10 + ts)
    demand = rng.uniform(0.0, 6.0, size=(f, b, ts, c))
    w = rng.uniform(0.0, 1.0, size=(f, b, c, e))
    cap = rng.uniform(1.0, 3.0, size=(f, b, e))
    cap[rng.random((f, b, e)) < 0.1] = 0.0  # dead links
    for fi, nb in enumerate(n_blocks):
        demand[fi, nb:], w[fi, nb:], cap[fi, nb:] = 0.0, 0.0, 0.0
    buf = 0.02 * cap
    ref = ref_qlops.queue_loss_fleet(demand, w, cap, buf, 1.0, backend="pallas")
    ref_np = ref_qlops.queue_loss_fleet(demand, w, cap, buf, 1.0, backend="numpy")
    out = qlops.queue_loss_fleet(demand, w, cap, buf, 1.0, device="cpu")
    assert float(ref[0].sum()) > 0.0  # the scenario drops
    for a, r, name in zip(out, ref, ("drop", "tot")):
        assert a.shape == (f, b, ts)
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
    for a, r in zip(qlops.queue_loss_fleet(demand, w, cap, buf, 1.0,
                                           backend="numpy"), ref_np):
        np.testing.assert_array_equal(a, r)
    # the queue starts empty in every (fabric, block) pair
    for fi in range(f):
        d_b, t_b = qlops.queue_loss_batched(demand[fi], w[fi], cap[fi], buf[fi],
                                            1.0, device="cpu")
        np.testing.assert_allclose(out[0][fi], d_b, rtol=FLEET_RTOL, atol=1e-4)
        np.testing.assert_allclose(out[1][fi], t_b, rtol=FLEET_RTOL, atol=1e-4)


def _butterfly(v, op=torch.add):
    """Lane 0's value after a warp's xor butterfly over the last axis (32
    lanes): ``v[i] = op(v[i], v[i ^ off])`` for off = 16, 8, 4, 2, 1."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[..., lane ^ off])
    return v[..., 0]


def _queueloss_fleet_schedule(demand, w, cap, buf, dt):
    """The fleet queue-loss body's order (``csrc/queueloss.cu``) in float32:
    per (fabric, block) pair every load summed over c in order (the W slabs
    and register tiles keep that order); each link's queue walked from empty
    through the sub-steps; per sub-step, the drops and the loads of each
    warp's 32 links (link 32 w + lane) summed by a warp butterfly, then the
    warps in order.  Returns (drop, load), each (F, B, TS), and the drops per
    (sub-step, link), (F, B, TS, E)."""
    f, b, ts, c = demand.shape
    e = w.shape[3]
    load = torch.zeros((f, b, ts, e))
    for ci in range(c):
        load = load + demand[..., ci:ci + 1] * w[:, :, ci:ci + 1, :]
    drops = torch.empty((f, b, ts, e))
    q = torch.zeros((f, b, e))
    for k in range(ts):
        x = q + (load[:, :, k] - cap) * dt
        drops[:, :, k] = torch.clamp(x - buf, min=0.0)
        q = torch.minimum(torch.clamp(x, min=0.0), buf)
    warps = -(-e // 32)
    out = []
    for v in (drops, load):
        per_warp = _butterfly(torch.nn.functional.pad(v, (0, 32 * warps - e)).reshape(
            (f, b, ts, warps, 32)))
        total = torch.zeros((f, b, ts))
        for wi in range(warps):
            total = total + per_warp[..., wi]
        out.append(total)
    return out[0], out[1], drops


@pytest.mark.parametrize("f,b,ts,c,n_blocks,pods", [
    (2, 3, 10, 12, (3, 2), None),          # tests/test_fleet_engine.py's shape
    (3, 2, 13, 56, (2, 1, 2), None),       # the 8-pod bucket's width
    (3, 3, 9, 56, (3, 1, 2), (6, 8, 7)),   # padded pods in the 8-pod layout
    (1, 2, 36, 132, (2,), None)])          # the 12-pod bucket's width, E > 128
def test_queueloss_fleet_schedule_matches_reference(f, b, ts, c, n_blocks, pods):
    """The fleet kernel's load-then-walk split and its order of sums over
    links give the reference's fleet Pallas kernel's answer (interpret
    mode), over ragged blocks (all-zero padded blocks), dead links and padded
    pods; padded links (no load, cap = buf = 0) never drop."""
    rng = np.random.default_rng(17 * ts + c)
    demand = rng.uniform(0.0, 6.0, size=(f, b, ts, c))
    w = rng.uniform(0.0, 1.0, size=(f, b, c, c)) * (rng.random((f, b, c, c)) < 0.4)
    cap = rng.uniform(1.0, 3.0, size=(f, b, c))
    cap[rng.random((f, b, c)) < 0.1] = 0.0  # dead links
    padded = np.zeros((f, c), bool)
    for fi, nb in enumerate(n_blocks):
        demand[fi, nb:], w[fi, nb:], cap[fi, nb:] = 0.0, 0.0, 0.0
        if pods is not None:
            padded[fi] = True
            padded[fi, commodity_slots(pods[fi], 8)] = False
            demand[fi][..., padded[fi]] = 0.0
            w[fi][:, padded[fi], :] = 0.0
            w[fi][:, :, padded[fi]] = 0.0
            cap[fi][:, padded[fi]] = 0.0
    buf = 0.02 * cap
    ref = ref_qlops.queue_loss_fleet(demand, w, cap, buf, 1.0, backend="pallas")
    drop, load, per_link = _queueloss_fleet_schedule(
        *(torch.from_numpy(x.astype(np.float32)) for x in (demand, w, cap, buf)), 1.0)
    assert float(ref[0].sum()) > 0.0  # the scenario drops
    for a, r, name in zip((drop, load), ref, ("drop", "tot")):
        assert a.shape == (f, b, ts)
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    for fi, nb in enumerate(n_blocks):
        assert float(per_link[fi, nb:].abs().sum()) == 0.0  # padded blocks
        assert float(per_link[fi][..., torch.from_numpy(padded[fi])].abs().sum()) == 0.0


@pytest.mark.parametrize("b,ts,c", [(3, 36, 132), (4, 13, 56), (2, 9, 12)])
def test_queueloss_batched_schedule_matches_reference(b, ts, c):
    """The batched entry takes the fleet body over its epochs: the fleet
    schedule at F = 1 (E > 128 among the shapes) gives the reference's
    epoch-batched Pallas kernel's answer (interpret mode), with dead links and
    the queue empty at the start of every epoch."""
    rng = np.random.default_rng(23 * ts + c)
    demand = rng.uniform(0.0, 6.0, size=(b, ts, c))
    w = rng.uniform(0.0, 1.0, size=(b, c, c)) * (rng.random((b, c, c)) < 0.4)
    cap = rng.uniform(1.0, 3.0, size=(b, c))
    cap[rng.random((b, c)) < 0.1] = 0.0  # dead links
    w *= (cap > 0.0)[:, None, :]  # dead links carry nothing, as padded ones
    buf = 0.02 * cap
    ref = ref_qlops.queue_loss_batched(demand, w, cap, buf, 1.0, backend="pallas")
    drop, load, per_link = _queueloss_fleet_schedule(
        *(torch.from_numpy(x.astype(np.float32))[None] for x in (demand, w, cap, buf)), 1.0)
    assert float(ref[0].sum()) > 0.0  # the scenario drops
    for a, r, name in zip((drop[0], load[0]), ref, ("drop", "tot")):
        assert a.shape == (b, ts)
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    dead = torch.from_numpy(cap == 0.0)[:, None, :].expand_as(per_link[0])
    assert float(per_link[0][dead].abs().sum()) == 0.0  # dead links never drop


def _linkload_staged_schedule(demand, w, inv_cap, thr):
    """The fleet linkload's staged body (``csrc/linkload.cu``) in float32, per
    (fabric, block) pair: every load summed over each quarter of c in order,
    then the quarters added in order; util = load * inv_cap; per row, lane l
    folds max, sum util, #(util > thr) and sum load over the links l, l + 32,
    ... in order (from 0), then a warp butterfly.  Returns (mlu, alu_sum,
    olr_count, load_sum), each (F, B, T)."""
    c, e = w.shape[-2:]
    quarter = -(-c // 4)
    load = None
    for lo in range(0, 4 * quarter, quarter):
        acc = torch.zeros(demand.shape[:-1] + (e,))
        for ci in range(lo, min(c, lo + quarter)):
            acc = acc + demand[..., ci:ci + 1] * w[..., ci:ci + 1, :]
        load = acc if load is None else load + acc
    util = load * inv_cap[..., None, :]
    rounds = -(-e // 32)

    def lanes(x):  # (..., E) -> (..., rounds, 32), zeros past E
        x = torch.nn.functional.pad(x, (0, 32 * rounds - e))
        return x.reshape(x.shape[:-1] + (rounds, 32))

    u, l = lanes(util), lanes(load)
    m = a = n = s = torch.zeros(util.shape[:-1] + (32,))
    for r in range(rounds):
        m = torch.maximum(m, u[..., r, :])
        a = a + u[..., r, :]
        n = n + (u[..., r, :] > thr).float()
        s = s + l[..., r, :]
    return (_butterfly(m, torch.maximum), _butterfly(a), _butterfly(n),
            _butterfly(s))


@pytest.mark.parametrize("f,b,t,c,n_blocks,pods,dyadic", [
    (2, 3, 3, 56, (3, 1), None, False),          # the 8-pod bucket's width
    (3, 3, 3, 56, (3, 1, 2), (6, 8, 7), False),  # padded pods in the 8-pod layout
    (1, 2, 3, 132, (2,), None, False),           # the 12-pod bucket's width, E > 128
    (2, 2, 5, 132, (2, 1), None, True),          # E > 128, a tie-free OLR
    (3, 2, 7, 56, (2, 1, 2), (8, 6, 7), True)])  # padded pods, a tie-free OLR
def test_linkload_staged_schedule_matches_reference(f, b, t, c, n_blocks, pods,
                                                  dyadic):
    """The fleet kernel's quarters of C and its order of sums over links give
    the reference's fleet Pallas kernel's answer (interpret mode), over
    ragged blocks (all-zero padded blocks score zeros), dead links and padded
    pods; on dyadic data, where every load is exact in float32, the OLR counts
    are equal."""
    rng = np.random.default_rng(19 * t + c + f)
    if dyadic:  # demand in {0..15}, weights in sixteenths
        demand = rng.integers(0, 16, (f, b, t, c)).astype(np.float64)
        w = rng.integers(0, 17, (f, b, c, c)) / 16.0 * (rng.random((f, b, c, c)) < 0.3)
        load = np.einsum("fbtc,fbce->fbte", demand, w)
        cap = np.maximum(load.max(axis=2), 1.0) * rng.uniform(0.6, 1.6, (f, b, c))
    else:
        demand = rng.gamma(2.0, 10.0, (f, b, t, c))
        w = rng.random((f, b, c, c)) * (rng.random((f, b, c, c)) < 0.5)
        cap = rng.uniform(50, 500, (f, b, c))
    cap[rng.random((f, b, c)) < 0.1] = 0.0  # dead links
    padded = np.zeros((f, c), bool)
    for fi, nb in enumerate(n_blocks):
        demand[fi, nb:], w[fi, nb:], cap[fi, nb:] = 0.0, 0.0, 0.0
        if pods is not None:
            padded[fi] = True
            padded[fi, commodity_slots(pods[fi], 8)] = False
            demand[fi][..., padded[fi]] = 0.0
            w[fi][:, padded[fi], :] = 0.0
            w[fi][:, :, padded[fi]] = 0.0
            cap[fi][:, padded[fi]] = 0.0
    ref = ref_llops.link_metrics_fleet(demand, w, cap, 0.8, backend="pallas")
    live = cap > 1e-9
    n_live = np.maximum(live.sum(axis=-1), 1)[..., None]
    inv_cap = np.where(live, 1.0 / np.maximum(cap, 1e-9), 0.0)
    out = _linkload_staged_schedule(
        *(torch.from_numpy(x.astype(np.float32)) for x in (demand, w, inv_cap)), 0.8)
    mlu, alu_sum, olr_cnt, tot = (x.numpy() for x in out)
    for a, r, name in zip((mlu, alu_sum / n_live, olr_cnt / n_live, tot), ref, NAMES):
        assert a.shape == (f, b, t), name
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
    for fi, nb in enumerate(n_blocks):  # padded blocks score zeros
        assert all(float(np.abs(x[fi, nb:]).sum()) == 0.0 for x in (mlu, alu_sum, olr_cnt, tot))
    if dyadic:
        assert 0 < olr_cnt.sum() < olr_cnt.size * c  # the threshold bites, not everywhere
        np.testing.assert_array_equal(olr_cnt, np.rint(ref[2] * n_live))


def _ragged_fleet(seed, vp, pods, lo, hi):
    """Per-fabric native blocks (ragged block counts and lengths) plus their
    bucket-layout embeddings (``vp`` padded pods), weights and capacities
    with dead links, and burst seeds."""
    rng = np.random.default_rng(seed)
    cp = vp * (vp - 1)
    native, padded, w_f, caps_f, seeds_f, slots_f = [], [], [], [], [], []
    for fi, v in enumerate(pods):
        c = v * (v - 1)
        slots = commodity_slots(v, vp)
        nb = 2 + fi
        blocks = [rng.uniform(lo, hi, size=(3 + 2 * bi, c)) for bi in range(nb)]
        w = np.zeros((nb, cp, cp))
        w[:, slots[:, None], slots[None, :]] = rng.uniform(0.0, 1.0, (nb, c, c))
        caps = scatter_pad(rng.uniform(5.0, 10.0, (nb, c)), slots, cp, axis=1)
        caps[:, slots[-2:]] = 0.0  # dead links in every fabric
        native.append(blocks)
        padded.append([scatter_pad(bl, slots, cp, axis=1) for bl in blocks])
        w_f.append(w)
        caps_f.append(caps)
        seeds_f.append([100 * fi + bi for bi in range(nb)])
        slots_f.append(slots)
    return native, padded, w_f, caps_f, seeds_f, slots_f


def test_interval_loss_fleet_matches_reference():
    """Burst expansion on each fabric's native blocks with the same seeds,
    scattered into the padded bucket layout: bit-equal to the reference on
    numpy; on the plain PyTorch version, within the kernel contract of the
    Pallas side, and paired with the port's own per-fabric path."""
    native, _, w_f, caps_f, seeds_f, slots_f = _ragged_fleet(1, 8, (6, 7, 8),
                                                             0.0, 20.0)
    ref_np = ref_interval_loss_fleet(native, w_f, caps_f, 60.0, LOSS, seeds_f,
                                     backend="numpy", slots_fleet=slots_f)
    out_np = interval_loss_fleet(native, w_f, caps_f, 60.0, PORT_LOSS, seeds_f,
                                 backend="numpy", slots_fleet=slots_f)
    ref_pl = ref_interval_loss_fleet(native, w_f, caps_f, 60.0, LOSS, seeds_f,
                                     backend="pallas", slots_fleet=slots_f)
    out = interval_loss_fleet(native, w_f, caps_f, 60.0, PORT_LOSS, seeds_f,
                              slots_fleet=slots_f, device="cpu")
    assert any(l.max() > 0 for row in ref_np for l in row)  # it drops
    for fi in range(len(native)):
        for a, r in zip(out_np[fi], ref_np[fi]):
            np.testing.assert_array_equal(a, r)
        for a, r in zip(out[fi], ref_pl[fi]):
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)
        # paired with the per-fabric batched path in the fabric's own layout
        sl = slots_f[fi]
        own = interval_loss_batched(native[fi], w_f[fi][:, sl][:, :, sl],
                                    caps_f[fi][:, sl], 60.0, PORT_LOSS,
                                    seeds_f[fi],
                                    device="cpu")
        for a, r in zip(out[fi], own):
            np.testing.assert_allclose(a, r, rtol=FLEET_RTOL, atol=FLEET_ATOL)


@pytest.mark.parametrize("with_loss", [False, True])
def test_route_metrics_fleet_matches_reference(with_loss):
    """One fused scoring pass over a ragged, padded bucket against the
    reference's (Pallas kernels in interpret mode) and against the port's
    own per-fabric batched scoring."""
    native, padded, w_f, caps_f, seeds_f, slots_f = _ragged_fleet(
        2, 8, (6, 8, 7), 0.0, 40.0)
    kw = {}
    if with_loss:
        kw = dict(loss_cfg=LOSS, loss_seeds_fleet=seeds_f, interval_seconds=60.0,
                  loss_blocks_fleet=native, loss_slots_fleet=slots_f)
    ref = ref_route_metrics_fleet(padded, w_f, caps_f, backend="pallas", **kw)
    port_kw = dict(kw, loss_cfg=PORT_LOSS) if with_loss else {}
    out = route_metrics_fleet(padded, w_f, caps_f, device="cpu", **port_kw)
    fields = FIELDS if with_loss else FIELDS[:4]
    for fi in range(len(native)):
        for name in fields:
            a, r = getattr(out[fi], name), getattr(ref[fi], name)
            assert a.shape == r.shape == (sum(len(bl) for bl in native[fi]),)
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
        own = route_metrics_batched(
            padded[fi], w_f[fi], caps_f[fi], device="cpu",
            loss_cfg=port_kw.get("loss_cfg"), interval_seconds=60.0,
            loss_seeds=seeds_f[fi] if with_loss else None)
        for name in fields:
            if name == "loss":  # batched expands in the padded layout: unpaired
                continue
            np.testing.assert_allclose(getattr(out[fi], name),
                                       getattr(own, name), rtol=FLEET_RTOL,
                                       atol=FLEET_ATOL, err_msg=name)
    if not with_loss:
        assert all(m.loss is None for m in out)
