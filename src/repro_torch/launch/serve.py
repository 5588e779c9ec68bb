"""Batched serving launcher: prefill + lockstep decode with a request queue —
the counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --requests 16 --batch 4 --prompt-len 32 --gen-len 32

Requests run in lockstep batches: each batch warms its cache by running the
prompt token by token through the decode step, then decodes ``gen_len``
tokens greedily.  The audio family (an encoder-decoder) instead encodes
``prompt_len`` random frames into its cache and decodes from each prompt's
first token, as the reference does.  Everything runs under
``torch.inference_mode``.  Runs on the CUDA device (:func:`serve` takes ``device``;
the command line always uses the card).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import encdec
from repro_torch.models.api import build_model
from repro_torch.models.layers import dtype_of

__all__ = ["serve", "main"]


@torch.inference_mode()
def serve(arch: str = "mamba2-130m", requests: int = 16, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 32, full: bool = False, *,
          device=None) -> dict:
    """Serve ``requests`` random prompts (numpy seed 0, as the reference)
    in batches of ``batch``; returns the reference's JSON keys plus the
    device's name.

    ``full`` serves the architecture at its published size, else its
    ``reduced()`` variant, with random parameters from seed 0.  Every
    batch's latency ends in a device synchronize.
    """
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if not full:
        cfg = cfg.reduced()
    model = build_model(cfg, dev)
    params = model.init(0)
    max_seq = prompt_len + gen_len
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (requests, prompt_len))

    synchronize(dev)
    served, tokens_out, latencies = 0, 0, []
    t0 = time.perf_counter()
    while served < requests:
        ids = list(range(served, min(served + batch, requests)))
        bsz = len(ids)
        t_req = time.perf_counter()
        cache = model.init_cache(bsz, max_seq, enc_len=max_seq)
        toks = torch.as_tensor(prompts[ids], dtype=torch.int64, device=dev)
        if cfg.family == "audio":
            frames = torch.as_tensor(rng.normal(0, 1, (bsz, prompt_len, cfg.d_model)),
                                     dtype=torch.float32, device=dev).to(dtype_of(cfg))
            cache["enc_out"][:, :prompt_len] = encdec.encode(params, frames, cfg)
            cur, start = toks[:, :1], 0
        else:
            # prefill token by token through the decode path (cache warm-up)
            for pos in range(prompt_len - 1):
                _, cache = model.decode(params, cache, toks[:, pos:pos + 1], pos)
            cur, start = toks[:, -1:], prompt_len - 1
        for g in range(gen_len):
            logits, cache = model.decode(params, cache, cur, start + g)
            cur = logits[:, -1].argmax(dim=-1, keepdim=True)
            tokens_out += bsz
        synchronize(dev)
        served += bsz
        latencies.append(time.perf_counter() - t_req)
    wall = time.perf_counter() - t0
    return {
        "arch": cfg.name, "requests": served,
        "tokens_generated": tokens_out,
        "throughput_tok_s": round(tokens_out / wall, 1),
        "mean_batch_latency_s": round(float(np.mean(latencies)), 3),
        "wall_s": round(wall, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(serve(args.arch, args.requests, args.batch, args.prompt_len,
                           args.gen_len, args.full), indent=2))


if __name__ == "__main__":
    main()
