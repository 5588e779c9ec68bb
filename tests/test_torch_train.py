"""The port's training against the reference's on the same parameters and
batches, one reduced config per family: dense (llama3-8b), moe
(mixtral-8x7b), vlm (internvl2-1b), hybrid (recurrentgemma-9b), ssm
(mamba2-130m) and audio (seamless-m4t-large-v2), and the dense features
that ``reduced()`` hides (gemma3-12b's global layer among its locals at a
query width other than d_model, deepseek-7b's MHA), in float32 (``dataclasses.replace(cfg.reduced(),
dtype="float32")``; the moe family is float32-only for the reason in
``tests/test_torch_models.py``: top-k routing flips at near-ties in bf16).

The reference initializes each model; its parameters reach the port through
``interop.model_from_numpy`` and come back through ``interop.model_to_numpy``
(layer groups stacked as the reference stacks them); its AdamW state through
``interop.adamw_state_from_numpy``.  On the CPU the port's flash attention,
RG-LRU scan and SSD chunk scan run their plain versions and their plain
backward (``attention_bwd_ref``, the reversed scan, ``ssd_chunk_ref_bwd``).  Tolerances: the loss at 1e-5
relative, each gradient leaf at 1e-4 of the leaf's largest magnitude, the
parameters and moments after two AdamW steps (the first step's learning rate
is 0 in the reference's schedule) at 1e-5.  The microbatched and compressed
steps are in ``tests/test_torch_train_steps.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.steps import StepConfig as RefStepConfig
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.api import build_model as ref_build_model
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch.steps import StepConfig, make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW

torch.set_num_threads(1)

B, S = 2, 16
FAMILIES = {"dense": "llama3-8b", "moe": "mixtral-8x7b", "vlm": "internvl2-1b",
            "hybrid": "recurrentgemma-9b", "ssm": "mamba2-130m",
            "audio": "seamless-m4t-large-v2"}
LOSS_REL, GRAD_REL, STEP_TOL = 1e-5, 1e-4, 1e-5
# eps 1e-3, not the default 1e-8: Adam's step m/(sqrt(v) + eps) of an entry
# whose gradient is at the level of float32 summation noise (~1e-8 here) is
# noise of order one in either package, and the two packages sum in
# different orders; with eps = 1e-3 such entries move by ~lr·|g|/eps and the
# comparison holds the update's arithmetic (tests/test_torch_optim.py holds
# AdamW at its default eps on identical gradients)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)


# the dense features that reduced() hides (tests/test_torch_models.py's
# cases): gemma3's global layer 5 among its locals at a query width of
# 4 × 48 against d_model 128, and deepseek's MHA (a GQA group of 1)
DENSE_FEATURES = {"gemma3-12b": {"n_layers": 7, "window": 8, "head_dim": 48},
                  "deepseek-7b": {"n_kv_heads": 4}}


def configs(family, over=None):
    """The reduced float32 configs of a family of ``FAMILIES`` (or of an
    architecture by name) with ``over`` replaced."""
    arch = FAMILIES.get(family, family)
    over = dict(over or {}, dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def numpy_batch(cfg, seed=3, b=B, s=S):
    """tokens and labels (B, S) and the family's frames (B, S, d) or patches
    (B, Np, d, in front of the tokens), from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 1, (b, cfg.frontend_tokens,
                                             cfg.d_model)).astype(np.float32)
    return batch


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def setup(family, seed=0, over=None):
    """(ref model, its params, the port's model, the same params as the
    port's module, the batch as numpy)."""
    ref_cfg, cfg = configs(family, over)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(seed))
    model = build_model(cfg, device="cpu")
    net = interop.model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    return ref_model, params, model, net, numpy_batch(cfg)


def assert_tree_close(ours: dict, theirs, rtol, atol, label="", flips=0.0):
    """Every leaf of the port's numpy tree against the reference's; with
    ``flips`` > 0, up to that share of a leaf's entries (at least one) may
    miss the tolerance (a compressed gradient entry on the other side of a
    threshold or rounding boundary)."""
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(ours)), label
    for path, leaf in flat:
        mine = ours
        for p in path:
            mine = mine[p.key]
        theirs_ = np.asarray(leaf, np.float32)
        where = f"{label} {jax.tree_util.keystr(path)}"
        if not flips:
            np.testing.assert_allclose(mine, theirs_, rtol=rtol, atol=atol, err_msg=where)
            continue
        bad = int((np.abs(mine - theirs_) > atol + rtol * np.abs(theirs_)).sum())
        assert bad <= max(1, int(flips * theirs_.size)), (where, bad, theirs_.size)


def port_grads(model, net, batch, remat):
    net.requires_grad_(True)
    loss, _ = model.loss(net, port_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, tree_util.leaves(net))
    return loss.detach(), tree_util.unflatten(net, list(grads))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family):
    ref_model, params, model, net, batch = setup(family)
    rb = ref_batch(batch)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, rb)[0]))(params)
    loss, grads = port_grads(model, net, batch, remat=True)
    assert abs(float(loss) - float(ref_loss)) <= LOSS_REL * abs(float(ref_loss))
    ours = interop.model_to_numpy(grads)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_grads)[0]:
        mine = ours
        for p in path:
            mine = mine[p.key]
        theirs = np.asarray(leaf, np.float32)
        scale = float(np.abs(theirs).max())
        err = float(np.abs(mine - theirs).max())
        assert err <= GRAD_REL * scale + 1e-12, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_modes_give_equal_grads(family):
    """``remat`` False, True and ``"dots"`` recompute the same operations on
    the same inputs: the same loss and gradients."""
    _, _, model, net, batch = setup(family)
    base_loss, base = port_grads(model, net, batch, remat=False)
    for remat in (True, "dots"):
        loss, grads = port_grads(model, net, batch, remat=remat)
        assert float(loss) == float(base_loss), remat
        for a, b in zip(tree_util.leaves(grads), tree_util.leaves(base)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def ref_steps(ref_model, params, batch, step_cfg, n=2):
    opt = RefAdamW(**OPT)
    state = opt.init(params)
    step = jax.jit(ref_make_train_step(ref_model, opt, step_cfg))
    metrics = []
    for _ in range(n):
        params, state, m = step(params, state, ref_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def port_steps(model, net, params, batch, step_cfg, n=2):
    opt = AdamW(**OPT)
    state = interop.adamw_state_from_numpy(
        interop.adamw_state_to_numpy(opt.init(net)), net, device="cpu")
    step = make_train_step(model, opt, step_cfg)
    metrics = []
    for _ in range(n):
        net, state, m = step(net, state, port_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return net, state, metrics


def check_steps(family, flips=0.0, over=None, **step_over):
    """Two updates of both packages from the same state, held at
    ``STEP_TOL`` (``flips``: see :func:`assert_tree_close`; ``over``: config
    fields replaced, see :func:`configs`)."""
    ref_model, params, model, net, batch = setup(family, over=over)
    rp, rs, rm = ref_steps(ref_model, params, batch, RefStepConfig(**step_over))
    net, st, pm = port_steps(model, net, params, batch, StepConfig(**step_over))
    for a, b in zip(pm, rm):
        assert a.keys() == b.keys()
        for key in a:
            assert abs(a[key] - b[key]) <= STEP_TOL * (1 + abs(b[key])), (key, a, b)
    assert_tree_close(interop.model_to_numpy(net), rp, STEP_TOL, STEP_TOL, "params",
                      flips)
    ours = interop.adamw_state_to_numpy(st)
    assert int(ours["step"]) == int(rs.step) == 2
    assert_tree_close(ours["mu"], rs.mu, STEP_TOL, STEP_TOL, "mu", flips)
    assert_tree_close(ours["nu"], rs.nu, STEP_TOL, STEP_TOL, "nu", flips)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    """Two ``make_train_step`` updates (remat on, no compression) from the
    same parameters and AdamW state as the reference's."""
    check_steps(family)


@pytest.mark.parametrize("arch", sorted(DENSE_FEATURES))
def test_train_step_matches_reference_with_dense_features(arch):
    """Two updates as above of gemma3 (a global layer among its locals, a
    query width other than d_model) and deepseek (MHA)."""
    check_steps(arch, over=DENSE_FEATURES[arch])
