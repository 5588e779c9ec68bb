"""Port vs reference: the collective and cost tools —
``repro_torch.runtime.hlo_traffic`` and ``repro_torch.runtime.hlo_cost``.

(a) The copies of ``CollectiveOp`` (its ring accounting),
    ``collective_summary`` and ``pod_traffic_matrix`` give the reference's
    results bit for bit (exact equality, no tolerance) on seeded random
    ``CollectiveOp`` lists.  The port keeps no reader of HLO text: it
    compiles none.
(b) The recorder: a collective the port issues on ``meta`` tensors of a
    virtual mesh records what the reference's ``parse_collectives`` reads
    from XLA's HLO line for the same collective (kind, result bytes, group
    size, groups; exactly), on the reference's own HLO lines
    (``tests/test_hlo_analysis.py``); the groups of a collective over any
    set of axes of a virtual (2, 2, 2) mesh equal the reference's iota
    replica groups for the same axes (exactly).
(c) ``measure_step``: the flops of the reference's scan and nested-scan
    programs, run eagerly as loops, equal the reference's ``analyze`` of
    their compiled HLO, which expands the loops by their trip counts
    (exactly); the flops of a one-device prefill of reduced llama3 and
    reduced mamba2 (two SSD chunks, S = 128) within 1 % of the reference's
    ``analyze`` of the same compiled step.  llama3's are equal; mamba2's
    differ by the reference's depthwise convolution, an einsum (a dot in
    HLO) where the port sums shifted products (-0.8 %).  A train step's
    flops do not depend on its microbatch count; its collectives outside
    the model axis are, op for op and in order, and in the pod matrix,
    those ``dryrun.planned_collectives`` counts for that count (a block's
    leaves gathered once a microbatch and again under remat, every
    gradient reduced once a microbatch, as the reference's scan over its
    checkpointed layers); the model axis's all-reduces come once a
    microbatch, the same bytes in all.
"""

import itertools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.hlo_cost as ref_cost
import repro.runtime.hlo_traffic as ref_traffic
from repro.configs import get_arch as ref_get_arch
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.launch.steps import StepConfig, make_prefill_step, make_train_step
from repro_torch.models.api import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import hlo_cost, hlo_traffic

torch.set_num_threads(1)

# the reference's HLO lines that the port's collectives express: each with
# the mesh, the collective, its input and the axes it runs over.  The first
# line's groups are written in iota form: of an explicit list
# ({{0,1,2,3},{4,5,6,7}}) the reference's reader keeps the first group only
HLO_ISSUES = [
    ("  %ar = f32[1024]{0} all-reduce(%x), channel_id=1, "
     "replica_groups=[2,4]<=[8], to_apply=%add",
     (2, 4), ("data", "model"), "all_reduce", (1024,), torch.float32, ("model",)),
    ("  %ag = bf16[64,128]{1,0} all-gather(%x), channel_id=2, "
     "replica_groups=[16,32]<=[2,16,16]T(1,0,2), dimensions={0}",
     (2, 16, 16), ("pod", "data", "model"), "all_gather", (2, 128), torch.bfloat16,
     ("pod", "model")),
    ("  %rs = f32[32]{0} reduce-scatter(%x), "
     "replica_groups=[32,16]<=[512], dimensions={0}, to_apply=%add",
     (2, 16, 16), ("pod", "data", "model"), "reduce_scatter", (512,), torch.float32,
     ("model",)),
    ("  %agd = bf16[16,8]{1,0} all-gather(%y), "
     "replica_groups=[4,4]<=[4,4]T(1,0), dimensions={0}",
     (4, 4), ("data", "model"), "all_gather", (4, 8), torch.bfloat16, ("data",)),
]


def _fields(op):
    return (op.kind, op.result_bytes, op.group_size, op.groups)


@pytest.mark.parametrize("line,shape,names,fn,x_shape,dtype,axes", HLO_ISSUES,
                         ids=range(len(HLO_ISSUES)))
def test_recorder_records_what_the_reference_parses(line, shape, names, fn, x_shape,
                                                    dtype, axes):
    want = ref_traffic.parse_collectives(line)
    mesh = sh.Mesh(shape, names)
    x = torch.empty(x_shape, dtype=dtype, device="meta")
    with hlo_traffic.record_collectives() as ops:
        if fn == "all_reduce":
            sh.all_reduce(x, mesh, axes)
        else:
            getattr(sh, fn)(x, 0, mesh, axes)
    assert [_fields(o) for o in ops] == [_fields(o) for o in want] and want
    assert [o.wire_bytes_per_chip() for o in ops] == [o.wire_bytes_per_chip() for o in want]


@pytest.mark.parametrize("seed", range(4))
def test_summary_and_pod_matrix_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_pods, per_pod = 4, 8
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
    ref_ops, port_ops = [], []
    for _ in range(40):
        g = int(rng.integers(1, 9))
        groups = [sorted(rng.choice(n_pods * per_pod, g, replace=False).tolist())
                  for _ in range(int(rng.integers(0, 4)))]
        args = (kinds[rng.integers(len(kinds))], int(rng.integers(0, 1 << 30)), g, groups)
        ref_ops.append(ref_traffic.CollectiveOp(*args))
        port_ops.append(hlo_traffic.CollectiveOp(*args))
    assert hlo_traffic.collective_summary(port_ops) == ref_traffic.collective_summary(ref_ops)
    ref_tm = ref_traffic.pod_traffic_matrix(ref_ops, per_pod, n_pods)
    port_tm = hlo_traffic.pod_traffic_matrix(port_ops, per_pod, n_pods)
    assert np.array_equal(port_tm, ref_tm) and ref_tm.sum() > 0


def _scan(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    return jax.lax.scan(body, x, None, length=7)[0]


def _nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, x, None, length=5)[0]


def _torch_scan(x, w):
    for _ in range(7):
        x = torch.tanh(x @ w)
    return x


def _torch_nested(x, w):
    for _ in range(5):
        for _ in range(3):
            x = x @ w
    return x


@pytest.mark.parametrize("fn,port_fn,shapes", [(_scan, _torch_scan, ((64, 128), (128, 128))),
                                               (_nested, _torch_nested, ((32, 64), (64, 64)))],
                         ids=["scan", "nested"])
def test_measure_step_counts_loops_as_the_reference_analyze_expands_them(fn, port_fn,
                                                                         shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    ref = ref_cost.analyze(hlo)
    got = hlo_cost.measure_step(port_fn, *(torch.empty(s, device="meta") for s in shapes))
    assert got.flops == ref.flops > 0, (got.flops, ref.flops)
    assert got.unknown_trip_loops == ref.unknown_trip_loops == 0
    assert got.collective_ops == ref.collective_ops == []


_AXES = [axes for n in (1, 2, 3) for axes in itertools.combinations(("pod", "data", "model"), n)]


@pytest.mark.parametrize("axes", _AXES, ids=["-".join(a) for a in _AXES])
def test_recorder_groups_are_the_reference_iota_groups(axes):
    mesh = sh.Mesh((2, 2, 2), ("pod", "data", "model"))
    names = mesh.axis_names
    perm = [i for i in range(3) if names[i] not in axes] + [names.index(a) for a in axes]
    size = 2 ** len(axes)
    line = (f"  %ar = f32[16]{{0}} all-reduce(%x), replica_groups=[{8 // size},{size}]"
            f"<=[2,2,2]T({','.join(map(str, perm))}), to_apply=%add")
    want = ref_traffic.parse_collectives(line)[0].groups
    assert mesh.groups(axes).tolist() == want
    with hlo_traffic.record_collectives() as ops:
        out = sh.all_reduce(torch.empty(16, device="meta"), mesh, axes)
    assert out.device.type == "meta" and out.shape == (16,)
    assert [o.groups for o in ops] == [want] and ops[0].result_bytes == 64
    assert ops[0].dtype == "f32" and ops[0].group_size == size
    pods = [{d // 4 for d in g} for g in want]
    assert all(len(p) == (2 if "pod" in axes else 1) for p in pods)


def test_virtual_mesh_takes_meta_tensors_only():
    mesh = sh.Mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="meta"):
        sh.all_gather(torch.ones(2, 2), 0, mesh, ("data",))
    with hlo_traffic.record_collectives() as ops:
        out = sh.all_gather(torch.empty(2, 3, dtype=torch.bfloat16, device="meta"),
                            1, mesh, ("model",))
    assert out.shape == (2, 6) and ops[0].result_bytes == 24 and ops[0].dtype == "bf16"


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_measure_step_flops_match_the_reference_analyze(arch):
    """Prefill of (2, 128) tokens on one device: the port on ``meta`` under
    ``measure_step`` against ``analyze`` of the reference's compiled step,
    within 1 %."""
    b, s = 2, 128
    ref_model = ref_build_model(ref_get_arch(arch).reduced())
    spec = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    hlo = jax.jit(ref_prefill_step(ref_model)).lower(
        ref_model.param_shapes(), spec).compile().as_text()
    want = ref_cost.analyze(hlo).flops
    model = Model(get_arch(arch).reduced(), torch.device("meta"))
    got = hlo_cost.measure_step(make_prefill_step(model), model.param_shapes(),
                                {"tokens": torch.empty((b, s), dtype=torch.int32,
                                                       device="meta")})
    assert abs(got.flops / want - 1) <= 0.01, (got.flops, want)
    if arch == "llama3-8b":
        assert got.flops == want
    assert got.hbm_bytes > 0 and got.collective_ops == [] and got.unknown_trip_loops == 0


def test_train_flops_do_not_depend_on_microbatches_and_collectives_are_planned():
    """The dry run may take one microbatch where the reference's table says
    more: the step's products scale with the tokens; its collectives over
    the dp axes follow the count — each block's leaves gathered once a
    microbatch and again in the rematerialised backward, the top-level
    leaves once a microbatch, every gradient reduced once a microbatch —
    and equal ``planned_collectives`` at each count, op for op and in the
    pod matrix; the activations' all-reduces over the model axis split by
    microbatch."""
    from repro_torch.launch import dryrun

    model = Model(get_arch("llama3-8b").reduced(), torch.device("meta"))
    mesh = sh.Mesh((2, 1, 2), ("pod", "data", "model"))
    from repro_torch.launch.steps import leaf_plans, module_like
    from repro_torch.optim import tree as tree_util

    shapes = model.param_shapes()
    shards = module_like(shapes, [sh.shard_tensor(x, p.sharding) for x, p in
                                  zip(tree_util.leaves(shapes), leaf_plans(model, mesh))])
    batch = {k: torch.empty((4, 32), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    out = []
    for mb in (1, 4):
        opt = AdamW()
        step = make_train_step(model, opt, StepConfig(microbatches=mb), mesh)
        out.append(hlo_cost.measure_step(step, shards, opt.init(shards), batch))
    assert out[0].flops == out[1].flops > 0
    model_groups = mesh.groups(("model",)).tolist()

    def split(ops):
        return ([_fields(o) for o in ops if o.groups != model_groups],
                Counter((o.kind, o.result_bytes) for o in ops if o.groups == model_groups))

    dps, layers = [], []
    for mb, cost in ((1, out[0]), (4, out[1])):
        planned = dryrun.planned_collectives(model, mesh, microbatches=mb)
        (dp, tp), (dp_plan, tp_plan) = split(cost.collective_ops), split(planned)
        assert dp == dp_plan != []
        assert np.array_equal(hlo_traffic.pod_traffic_matrix(cost.collective_ops, 2, 2),
                              hlo_traffic.pod_traffic_matrix(planned, 2, 2))
        # over the model axis: the plan's own (its gathers and sums, counted
        # by planned_collectives) and the layers' activations'
        assert tp_plan <= tp
        layers.append(sum(f[1] * n for f, n in (tp - tp_plan).items()))
        dps.append(dp)
    assert layers[0] == layers[1] > 0 and len(dps[1]) > len(dps[0])
