"""The port's serving launcher (``repro_torch.launch.serve.serve``) and
serve steps on reduced configs on the CPU, against the reference's decode
step by step on the same parameters (tolerance: the reference's bfloat16
decode contract 6e-2, ``tests/test_arch_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.steps import make_prefill_step as ref_make_prefill_step
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.api import build_model

torch.set_num_threads(1)

KEYS = {"arch", "requests", "tokens_generated", "throughput_tok_s",
        "mean_batch_latency_s", "wall_s", "device"}


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_serve_matches_reference_decode(arch):
    out = serve(arch, requests=5, batch=2, prompt_len=6, gen_len=4, device="cpu")
    assert set(out) == KEYS
    assert out["arch"] == f"{arch}-reduced" and out["device"] == "cpu"
    assert out["requests"] == 5 and out["tokens_generated"] == 5 * 4
    assert out["throughput_tok_s"] > 0 and out["wall_s"] > 0

    # serve's loop on the reference's parameters: three lockstep batches
    # (2, 2, 1) of serve's prompts, each 5 prompt steps and 4 greedy decode
    # steps, against the reference's decode step by step
    ref_model = ref_build_model(ref_get_arch(arch).reduced())
    params = ref_model.init(jax.random.key(0))
    model = build_model(get_arch(arch).reduced(), device="cpu")
    net = model_from_numpy(model.cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    prompts = np.random.default_rng(0).integers(0, model.cfg.vocab, (5, 6))
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    for ids in ([0, 1], [2, 3], [4]):
        cache, ref_cache = model.init_cache(len(ids), 10), ref_model.init_cache(len(ids), 10)
        tok = prompts[ids, :1]
        for pos in range(9):
            logits, cache = model.decode(net, cache, torch.as_tensor(tok), pos)
            ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok, jnp.int32),
                                         jnp.int32(pos))
            logits = logits.float().numpy()
            np.testing.assert_allclose(logits, np.asarray(ref_logits, np.float32),
                                       rtol=6e-2, atol=6e-2, err_msg=f"{ids} pos {pos}")
            tok = prompts[ids, pos + 1:pos + 2] if pos < 5 else logits[:, -1:].argmax(-1)


def test_steps_match_reference():
    """``make_prefill_step`` and ``make_serve_step`` give the reference's
    greedy tokens (float32, where argmax cannot flip on rounding)."""
    import dataclasses

    ref_cfg = dataclasses.replace(ref_get_arch("mamba2-130m").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(), dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(1))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (3, 16))
    ref_next = ref_make_prefill_step(ref_model)(params, {"tokens": jnp.asarray(tokens)})
    model = build_model(cfg, device="cpu")
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    nxt = make_prefill_step(model)(net, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))
    serve_step = make_serve_step(model)
    cache = model.init_cache(3, 16)
    for pos in range(16):
        tok, cache = serve_step(net, cache, torch.as_tensor(tokens[:, pos:pos + 1]), pos)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_next))
