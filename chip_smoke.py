#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the JSON result):

1. The card: ``nvidia-smi`` name and power limit, the torch device name and
   count.  No CUDA device means exit 1.
2. Build the six CUDA libraries from ``src/repro_torch/csrc`` (one ``nvcc``
   each, in parallel: linkload and queueloss, each with a batched, a
   single-block and a fleet entry; flash attention, its backward, the RG-LRU
   scan and the SSD chunk scan) and print ptxas' registers/spills.
3. Hold each of the nine kernel entries against its plain PyTorch version
   on the card: the batched ones at the batched engine's shapes (B=96 epochs
   of phase 4 and B=672 of a 14-day sweep, T=3 / TS=36, C=E=132), the batched
   linkload also at a ragged shape, at its staged body's row cut and one row
   past it (the batched body) and with W at a storage offset, and bit for bit
   against the single-block and fleet entries, the batched
   queue loss also past its fleet body (TS=512: the E-tiled body), the
   single-block ones at the streaming controller's shapes (T=3 / TS=36),
   linkload also at the whole-trace shape (T=4032), at one row, on both sides
   of its staged body's row cut (the batched body over one pair past it) and
   with W at a storage offset, the single-block queue loss also at one
   sub-step and at TS=512 (past its cluster's shared memory: the E-tiled body
   over one pair), the fleet ones at phase 7's two buckets (F=15 fabrics x
   B=96 blocks at C=E=132, F=7 x 96 at C=E=56) and past their bodies (the
   linkload one row past the staged body's cut: the batched body; the queue
   loss at TS=512: the E-tiled body over the F*B pairs), the fleet linkload
   also with W at a storage offset, each also at a ragged shape with dead
   links (the fleet ones: fabrics with fewer blocks than the bucket and a
   padded-pod layout); time kernel, plain version and the ``torch.bmm`` /
   ``torch.mm`` yardstick with CUDA events, each redesigned controller kernel
   beside the body it launched before on the same inputs (the batched
   linkload body through its comparison entry, which counts no launch; the
   batched linkload at both batched shapes; the single-block
   linkload over T = 3, 12, 36, the cut, one past it and 4032; the fleet
   linkload also at the cut, and beside a sum of its W and after an L2 flush
   by reads), an empty kernel through the single-block queue loss's ctypes
   path (the launch floor) and the single-block wrappers' host time a call.
   A small batched PDHG solve is held against scipy/HiGHS.  The
   model kernels at the shapes of phase 8's prefill and at ragged ones:
   flash attention at recurrentgemma-9b's (B=2, S=4096, H=16, KV=1, hd=256,
   window 2048, bf16; yardstick ``scaled_dot_product_attention`` with the
   same mask), at phase 12's prefills (mixtral-8x7b: B=1, S=8192, H=32,
   KV=8, hd=128, window 4096; dbrx-132b: B=1, S=4096, H=48, KV=8, hd=128;
   internvl2-1b: B=4, S=4096, H=14, KV=2, hd=64; causal, bf16, each timed
   beside the yardstick), at a tensor-parallel rank's unequal share of the
   heads (``TP_FLASH``: internvl2-1b's 4 or 3 of 14 on a model axis of 4 at
   B=4, S=2048, hd=64; qwen3-14b's 3 or 2 of 40 on 16 at B=1, S=4096,
   hd=128; one KV head, causal, bf16, timed beside the yardstick, bit for
   bit against a second call; their backward too, GQA groups of 3 on a
   cluster of 3 CTAs), at a 1×4 rank's share of the moe family's heads at
   the 4-card entry's published-depth prefills (``MOE_TP_FLASH``:
   mixtral-8x7b's 8 of 32 heads on 2 KV heads at B=1, S=8192, window 4096;
   dbrx-132b's 12 of 48 on 2 at S=4096, causal; timed beside the
   yardstick, bit for bit against a second call), at phase 16's dense
   prefills (``DENSE_FLASH``:
   gemma3-12b's B=1, S=8192, H=16, KV=8, hd=256 at window 1024 and global;
   deepseek-7b's B=2, S=4096, H=KV=32, hd=128; timed beside the yardstick,
   bit for bit against a second call; their backward at phase 16's training
   shapes), at a rank's microbatch in the 4-card entry's dense_full steps
   (``DENSE_FULL_FLASH``: gemma3-12b and deepseek-7b on 4×1 and 2×2, bf16
   at S=4096 and float32 at S=2048; forward and backward, timed beside the
   yardstick, bit for bit against a second call) and at a ragged shape (hd=100, non-causal window
   48) in f32 and bf16, the RG-LRU scan at (2, 4096, 4096), at B=1, at a
   tensor-parallel rank's 2048 channels and at ragged S and D, the SSD chunk
   scan at mamba2-130m's (B=4, H=24, S=4096, P=64, N=128, chunk 64, also
   against itself at chunk 128) and at a rank's 12, 6, 2 and 1 heads (its
   backward too; each bit for bit against a second call).  The eight redesigned
   kernels (RG-LRU, SSD, and the batched, single-block and fleet linkload and
   queue loss) are also held bit for bit against a second call.  Flash
   attention's backward (the gradient training takes through
   ``FlashAttention``: the forward with its log-sum-exp, then the backward
   kernels) at llama3-8b's training shape (B=2, S=2048, H=32, KV=8, hd=128,
   causal), recurrentgemma-9b's local attention, seamless-m4t-large-v2's
   cross-attention (B=4, Sq=256, Sk=1024, H=KV=16, hd=64, non-causal; the
   forward at Sq != Sk too) in bf16 and a ragged f32 shape (hd=100, a
   non-causal window, Sq=300 != Sk=500), against the plain backward and
   autograd through the plain forward (f32 1e-4·(1+|ref|); bf16 within the
   bf16 gradient rounding bound), bit for bit against a second call, timed
   (its dQ and dK/dV launches also alone, each time with its rate) beside its
   plain version and ``scaled_dot_product_attention``'s backward, its bound
   at the rate of the shape's dtype; and checked at five edge shapes
   (``FLASH_BWD_EDGES``: tile-ragged Sq and Sk, windows across tile edges,
   GQA groups of 1, 2, 12 and 16, hd 64 to 256 and 100 in bf16);
   the RG-LRU backward (two launches: the forward and the reversed scan) at
   (2, 4096, 4096) against autograd through its plain version at 1e-4; and
   the SSD chunk backward (#9b, the entry ``ssd_chunk_bwd`` through
   ``ssd_scan_bwd``) against ``ssd_chunk_ref_bwd`` (autograd through the
   plain version) at mamba2-130m's training shape (B=4, H=24, S=4096, P=64,
   N=128, chunk 64) and at the forward's edge shapes (``SSD_BWD``: a chunk
   halved to 32, chunks of 128, one chunk, Q, N, P not multiples of 4),
   each of its five gradients within 1e-3 of its own max |ref|, bit for bit
   against a second call, at the training shape also within 1e-4 of each
   max |g| between chunks of 32 and 64 (which TF32 alone would break), and
   timed there beside the plain backward with three bounds (3xTF32 tensor
   cores, the route's and the share's; f32 CUDA cores; bytes; no single
   PyTorch call computes it), and its launches timed apart by
   ``torch.profiler`` (the scan, both state walks, the gradient kernel and
   da's sum: device ms a call).
4. The batched engine: ``repro_torch.core.run_controller`` over fabric F21
   (12 pods), an 8-day trace at 5-minute TMs, the paper's default controller
   (routing every 15 min, topology daily, 7-day aggregation) at 4 critical
   TMs (``SWEEP_K``, the paper's 12 cut for the script's time, as phases 5
   and 9 are), Gemini with burst-loss tracking: 96 routing epochs, one joint
   topology solve, batched PDHG and one launch of each batched kernel;
   re-scored through the float64 numpy oracle.
5. The streaming controller: ``repro_torch.serve.StreamingController`` on
   the first 7 1/8 days of the same trace and configuration at 4 critical
   TMs (``SERVE_K``), warm-started PDHG: 12 decisions (the first crosses
   the joint topology solve), each finished epoch scored with one launch of
   each single-block kernel.  Held against the same epochs of the batched
   engine run over the trace at 4 critical TMs and re-scored through the
   numpy oracle; prints time-to-new-weights.
6. The sequential walk (``engine="sequential"``) on F21 over 7 1/24 days
   (uniform topology + hedging, 4 epochs) against the batched engine, and
   the (uniform, VLB) baseline over a 14-day trace: one whole-trace launch
   of the single-block linkload kernel, against the numpy oracle.
7. The fleet engine: ``repro_torch.core.run_fleet`` over all 22 fabrics of
   the synthetic fleet, each with its own 8-day trace at 5-minute TMs, the
   paper's default controller, uniform topology + hedging and one shared
   burst-loss configuration: two buckets (12 and 8 padded pods), each solved
   in one flattened PDHG batch and scored with one launch of each fleet
   kernel.  Held against the per-fabric batched engine on F21 (12 pods), F1
   (11, padded to 12) and F17 (6, padded to 8), and every job re-scored
   through the numpy oracle.
8. Model serving at full width and depth (random weights from a seed):
   the prefill step (``repro_torch.launch.steps.make_prefill_step``) on
   recurrentgemma-9b (bf16, B=2, S=4096: 12 flash-attention and 26 RG-LRU
   launches) and on mamba2-130m (bf16, B=4, S=4096: 24 SSD launches), with
   finite logits, times and peak memory; the kernels' forward against the
   plain token-by-token decode in float32 (TF32 off) at B=2, S=64; and
   ``repro_torch.launch.serve.serve`` with ``--full`` and the launcher's
   defaults (16 requests, batch 4, prompt 32, gen 32) for both.
9. The transition sweep: phase 4's configuration (4 critical TMs) and a
   topology update every 12 hours (two joint solves) executed as drain
   stages over 4 patch panels (``TransitionConfig(n_panels=4,
   stage_intervals=1, decide=False)``).  One plan walk (the joint solves and the §4.6 gate,
   whose old/new/stage routing re-solves are one PDHG batch), then
   ``execute_plan`` twice on the same plan: as planned (the stage blocks on
   the batch axis of one launch each of the batched kernels) and with the
   staging dropped.  Bit-equal splits and bit-equal metrics outside the
   staged epochs; the staged epochs against the float64 numpy oracle from
   the gate's stage weights and capacities.  Then a second, short plan walk
   with the gate deciding (``decide=True``) on the 9-pod F5 over a 2.5-day
   hourly trace (three joint solves), failure-aware: its benefit and
   disruption blended with their worst over phase 10's 64 contingencies
   (``contingency_weight`` 0.5), it skips both updates as the CPU run does,
   and the plain rule on the same logged benefits and disruptions applies
   the first and skips the second, as the CPU run held to the reference
   does.
10. Failure contingencies and bf16 PDHG on phase 9's plan (no new joint
   solve): ``execute_plan`` with 64 fixed-routing scenarios of link, trunk,
   panel and pod failures (``repro_torch.failures``; one launch each of the
   fleet kernels over the 64 x 98 (scenario, block) rows), bit-equal to
   phase 9's staged execute in its own metrics and splits, against the
   per-scenario loop of ``route_metrics_batched`` (#1/#2) and the float64
   oracle; #5/#6 on the operands of that fused launch (dead links carrying
   live W) against their plain versions, timed; re-solve mode (8 scenarios:
   one PDHG batch of 8 x 98 elements) no worse than fixed routing; the
   fleet engine with 16 scenarios on F21, F1 and F17 against the per-fabric
   engine; and the execute with ``solver_precision="bf16"`` against f32
   (per-epoch u* within 3 %, the p99.9 MLU within 1 %).
11. The autotune table (``repro_torch.kernels.autotune``) in a temporary
   cache: ``tune_solver`` at F21's shape (V=12, m=12, one rep, its solves
   capped at 1,000 iterations), a fresh
   ``TorchRoutingSolver(dual_topk=None)`` resolving the recorded knob and
   ``REPRO_AUTOTUNE=0`` pinning 128, and one batch of four F21 epochs under
   each knob held to HiGHS's stage-1 u* at 2·tol.
12. The moe and vlm families at full width (bf16, random weights from a
   seed): the prefill step of mixtral-8x7b at 8 of its 32 layers (B=1,
   S=8192, the 4096 window masking: 8 flash-attention launches), then 32
   greedy tokens through ``make_serve_step(ring=True)`` on a
   ``window_cache`` ring, and its sorted dispatch against the one-hot one
   on a full-width layer (rel 2e-2); dbrx-132b at 2 of its 40 layers (B=1,
   S=4096: 2 launches); internvl2-1b at full size (B=4, S=4096 = 256
   patches + 3840 tokens: 24 launches), then ``serve`` with ``--full`` and
   the launcher's defaults; the exact launch counts, finite logits,
   tokens/s and peak memory; and mixtral's reduced config in float32 (TF32
   off) at window 16, decoded through its ring past the window against the
   kernels' forward (1e-3·(1+|logit|)).
13. The audio family and training (bf16, random weights from a seed):
   seamless-m4t-large-v2's prefill at full size (B=4, 1024 frames + 256
   tokens: exactly 72 flash-attention launches, 24 non-causal in the
   encoder, 24 causal and 24 cross in the decoder), ``serve`` of 4 requests
   x 16 tokens, and its reduced config in float32 decoded against its
   forward (1e-3·(1+|logit|)); mamba2-130m at full size (24 layers, bf16
   weights with the SSD in f32, B=4, S=4096, remat, AdamW lr 3e-4) trained
   through ``repro_torch.runtime.trainer.Trainer`` for 4 steps with a
   checkpoint every 2, then restarted from the step-2 checkpoint to step 4:
   the restarted losses bit-equal to the uninterrupted run's, exactly 192
   SSD forward and 96 backward (#9b) launches (48 and 24 a step), finite
   losses and gradient norms, the third loss moved, step time, tokens/s,
   model-FLOPs utilisation, peak memory and #9b's device time a step (CUDA
   events around its entry) against the step's time; llama3-8b at full
   width (2 of its 32 layers; B=2, S=2048), recurrentgemma-9b at full width
   (one super-block: rec, rec, local attention) and seamless at 4 + 4
   layers, three steps each through ``make_train_step`` (flash attention
   forward and backward, the RG-LRU scan forward and backward, counted), in
   each run the flash backward's device time a step against the step's
   time.
14. Sharding on one card: the fleet over F21, F1 and F17 (7 routing epochs
   each) unsharded and dealt over ``fleet_mesh([dev] * D)`` for D = 2 and 4
   (``repro_torch.parallel.sharding.shard_leading``: the round-robin deal,
   one host thread and stream a shard, the inverse permutation), each job's
   splits, u*, PDHG iterations, gaps and metrics held to the unsharded run
   bit for bit, one launch of each fleet kernel a bucket; mamba2-130m at full
   size through ``Trainer`` on ``make_host_mesh()`` over a one-rank NCCL
   process group (the FSDP step) for 3 steps, its losses bit-equal to
   ``mesh=None``'s; then llama3-8b's decode (2 layers, bf16, B=4, a 4096
   cache) through ``make_serve_step`` on that mesh, its cache cut by
   ``shard_cache``, logits and tokens bit-equal to ``mesh=None``'s.
15. The dry run and the training-traffic bridge: llama3-8b train_4k,
   prefill_32k and decode_32k, mamba2-130m train_4k and long_500k,
   dbrx-132b decode_32k and qwen3-14b train_4k (unequal shares of its 40
   heads on 16 model ranks) on the 2×16×16 virtual mesh on ``meta`` (each
   in a worker process started before phase 1; no leaf gathered whole in a
   train or prefill cell), each pod matrix equal to the
   count from the shardings (``dryrun.planned_collectives``), llama3-8b
   decode_32k's cache 2^30 B a device, dbrx-132b's parameters 16,528,650,240
   B a device (one expert a model rank); llama3-8b's inter-pod bytes
   through ``run_controller`` on the card; ``Trainer.extract_traffic`` on
   one rank.

16. The dense family at its published widths (run after phase 12; random
   weights from a seed): the prefill step of gemma3-12b at all 48 layers
   (bf16, B=1, S=8192: 5:1 local:global attention, 16 query heads on 8 KV
   heads at hd 256 with qk-norm, a tied 262,144-word vocabulary) and of
   deepseek-7b at all 30 (MHA, B=2, S=4096), one flash-attention launch a
   layer and no other, finite logits, the step's token; each at full width
   in float32 (TF32 off) with its depth cut (gemma3 6 layers, one
   local:global period, its window cut to 16; deepseek 2) decoded over
   ``DECODE_LEN`` tokens against the kernels' forward; ``serve`` of 8
   requests with ``--full``; three bf16 training steps each through
   ``make_train_step`` (gemma3 6 layers at B=1, S=4096; deepseek 2 at B=2,
   S=2048) with exact flash-attention forward and backward launches, MFU
   (each layer's attention at its own window) and the backward's share of
   a step.

The multi-card entry, ``phase_multicard()``, is not part of ``main()``; it
runs on every visible card (four on a host with four H100s):

    python3 -c "import sys; sys.path.insert(0, 'src'); import chip_smoke as cs; \
        cs.phase_card(); cs.phase_build(); cs.phase_multicard()"

the 22-fabric ``run_fleet`` on one card and dealt over all of them;
mamba2-130m at full size, llama3-8b and mixtral-8x7b at full width (2
layers), recurrentgemma-9b's first super-block and seamless (2 + 2 layers)
trained with FSDP, one process a card, against one card on the same global
batches, mamba2-130m and recurrentgemma-9b with a checkpoint written on
four ranks restored on one, a restart and a remesh to two ranks (each
rank drawing its tiles straight from the seed); FSDP × TP training
(``MULTI_TP``: llama3-8b, mixtral-8x7b's
experts on 2×2 and 1×4, qwen3-14b, mamba2-130m's SSD heads,
recurrentgemma-9b's RG-LRU channels and seamless on 2×2, internvl2-1b at
full size on unequal shares of its 14 heads on 1×4, no leaf gathered
whole); and decode on the sharded mesh (``MULTI_DECODE``: llama3-8b on 2×2
and 1×4, and at B=1, mamba2-130m, recurrentgemma-9b, seamless and
mixtral-8x7b on 2×2, internvl2-1b on 1×4), 32 steps from a 32,768-position
cache in float32 and bf16 against one card; and the moe family at its
published depth, which no single card holds (``MOE_FULL``: mixtral-8x7b's 32
layers and dbrx-132b's 40 on 1×4, each rank's tiles drawn straight from the
seed, prefilled and decoded, held against a one-card truth that streams the
model a layer at a time).  ``parts`` picks among "fleet", "fsdp", "tp",
"decode" and "moe_full".

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
LINK_RTOL, LINK_ATOL = 3e-4, 1e-4  # kernel contracts (f32 vs plain/f64)
SCORE_TOL = 1e-5  # scoring vs the float64 numpy oracle
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, bf16 dense on the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM data sheet, TF32 dense on the tensor cores
LIBRARIES = ("linkload", "queueloss", "flash_attention", "flash_attention_bwd",
             "rglru_scan", "ssd_chunk")
# phase 8's prefill shapes: (arch, batch, seq) and the kernel launches of one
# forward at full depth
PREFILL = (("recurrentgemma-9b", 2, 4096,
            {"flash_attention": 12, "rglru_scan": 26, "ssd_chunk": 0}),
           ("mamba2-130m", 4, 4096,
            {"flash_attention": 0, "rglru_scan": 0, "ssd_chunk": 24}))
# phase 12's prefills: (arch, layers kept (None = all), batch, sequence
# incl. patches, flash-attention launches); mixtral (93 GB) and dbrx (264 GB)
# do not fit one card in bf16, so their depth is cut here (the 4-card entry's
# moe_full part runs them whole on 1×4)
FAMILY_RUNS = (("mixtral-8x7b", 8, 1, 8192, 8), ("dbrx-132b", 2, 1, 4096, 2),
               ("internvl2-1b", None, 4, 4096, 24))
# flash attention at those prefills: ((B, S, H, KV, hd), window)
FAMILY_FLASH = {"mixtral-8x7b": ((1, 8192, 32, 8, 128), 4096),
                "dbrx-132b": ((1, 4096, 48, 8, 128), 0),
                "internvl2-1b": ((4, 4096, 14, 2, 64), 0)}
# flash attention's backward (phase 3): (label, (B, Sq, Sk, H, KV, hd, causal,
# window, dtype)) — llama3-8b's training shape (phase 13's), recurrentgemma-9b's
# local attention, seamless-m4t-large-v2's cross-attention, and a ragged
# float32 shape (hd 100, a non-causal window, Sq != Sk)
# flash attention at a tensor-parallel rank's uneven share of the heads
# (bf16, causal, one KV head a rank): internvl2-1b's 14 heads on a model axis
# of 4 (3 or 4 a rank, at the 4-card entry's B = 4, S = 2048) and qwen3-14b's
# 40 on 16 (2 or 3 a rank, B = 1 at S = 4096); label: (B, S, H, KV, hd).
# Groups of 3 split over a cluster of 3 CTAs in the backward
TP_FLASH = (("internvl2_1x4_h4", (4, 2048, 4, 1, 64)),
            ("internvl2_1x4_h3", (4, 2048, 3, 1, 64)),
            ("qwen3_16_h3", (1, 4096, 3, 1, 128)),
            ("qwen3_16_h2", (1, 4096, 2, 1, 128)))
# flash attention at a 1×4 rank's share of the moe family's heads at its
# published depth (the 4-card entry's moe_full part): mixtral-8x7b's 8 of 32
# heads on 2 of 8 KV heads at B = 1, S = 8192, window 4096, and dbrx-132b's
# 12 of 48 on 2 of 8 at S = 4096, causal; label: ((B, S, H, KV, hd), window)
MOE_TP_FLASH = (("mixtral_1x4_h8", ((1, 8192, 8, 2, 128), 4096)),
                ("dbrx_1x4_h12", ((1, 4096, 12, 2, 128), 0)))
# flash attention at the dense family's prefills (phase 16): gemma3-12b's
# local (window 1024) and global layers at B = 1, S = 8192 (16 heads on 8 KV
# heads, hd 256) and deepseek-7b's MHA (32 on 32, hd 128) at B = 2, S = 4096,
# causal, bf16; label: ((B, S, H, KV, hd), window)
DENSE_FLASH = (("gemma3_local", ((1, 8192, 16, 8, 256), 1024)),
               ("gemma3_global", ((1, 8192, 16, 8, 256), 0)),
               ("deepseek", ((2, 4096, 32, 32, 128), 0)))
# flash attention at a rank's microbatch in the 4-card entry's dense_full
# steps (4×1: one sequence, every head; 2×2: two sequences, half the heads):
# gemma3-12b's local (window 1024) and global layers and deepseek-7b's MHA,
# bf16 at S = 4096 and float32 at S = 2048 (gemma3 on 2×2, deepseek on
# 4×1), causal; label: ((B, S, H, KV, hd), window, dtype)
DENSE_FULL_FLASH = (("gemma3_4x1_local", ((1, 4096, 16, 8, 256), 1024, "bfloat16")),
                    ("gemma3_4x1_global", ((1, 4096, 16, 8, 256), 0, "bfloat16")),
                    ("gemma3_2x2_local", ((2, 4096, 8, 4, 256), 1024, "bfloat16")),
                    ("gemma3_2x2_global", ((2, 4096, 8, 4, 256), 0, "bfloat16")),
                    ("deepseek_4x1", ((1, 4096, 32, 32, 128), 0, "bfloat16")),
                    ("deepseek_2x2", ((2, 4096, 16, 16, 128), 0, "bfloat16")),
                    ("gemma3_2x2_f32_local", ((2, 2048, 8, 4, 256), 1024, "float32")),
                    ("gemma3_2x2_f32_global", ((2, 2048, 8, 4, 256), 0, "float32")),
                    ("deepseek_4x1_f32", ((1, 2048, 32, 32, 128), 0, "float32")))
FLASH_BWD = (("llama3", (2, 2048, 2048, 32, 8, 128, True, 0, "bfloat16")),
             ("recurrentgemma", (2, 4096, 4096, 16, 1, 256, True, 2048, "bfloat16")),
             ("seamless_cross", (4, 256, 1024, 16, 16, 64, False, 0, "bfloat16")),
             ("ragged_f32", (1, 300, 500, 8, 2, 100, False, 48, "float32")),
             *((label, (b, s, s, h, kv, hd, True, 0, "bfloat16"))
               for label, (b, s, h, kv, hd) in TP_FLASH),
             # the dense family's training shapes (phase 16's steps)
             ("gemma3_train_local", (1, 4096, 4096, 16, 8, 256, True, 1024, "bfloat16")),
             ("gemma3_train_global", (1, 4096, 4096, 16, 8, 256, True, 0, "bfloat16")),
             ("deepseek_train", (2, 2048, 2048, 32, 32, 128, True, 0, "bfloat16")),
             # dense_full's (gemma3's on 4×1 are gemma3_train_local/global)
             *((label, (b, s, s, h, kv, hd, True, window, dt))
               for label, ((b, s, h, kv, hd), window, dt) in DENSE_FULL_FLASH
               if not label.startswith("gemma3_4x1")))
FLASH_BWD_F32_TOL = 1e-4  # f32 gradients: 1e-4·(1 + |ref|)
# the backward's edge shapes at small sizes (checked, not timed): Sq and Sk
# off every tile, windows that straddle tile edges, GQA groups of 2, 1, 16
# and 12 (which the 8-CTA cluster does not divide), non-causal Sq != Sk,
# hd 64 / 128 / 256 and 100 in bf16
FLASH_BWD_EDGES = (("hd64_ragged_g2", (1, 1000, 1000, 4, 2, 64, True, 0, "bfloat16")),
                   ("hd128_cross_g1", (1, 300, 700, 4, 4, 128, False, 0, "bfloat16")),
                   ("hd256_window_g16", (1, 1000, 1000, 16, 1, 256, True, 100, "bfloat16")),
                   ("hd128_window_g12", (1, 500, 500, 12, 1, 128, True, 70, "bfloat16")),
                   ("hd100_bf16", (1, 300, 500, 8, 2, 100, False, 48, "bfloat16")))
# the SSD chunk backward (#9b, phase 3): mamba2-130m's training shape (phase
# 13's), the same at a tensor-parallel rank's 12 and 6 of its 24 heads (a
# model axis of 2 and 4) and at 2 and 1 (the uneven shares on 16), and the
# edge shapes of the forward's gpu tests (a chunk halved to 32,
# chunks of 128 (the backward walks 64), one chunk, 32 chunks of 128, and Q,
# N, P not multiples of 4), an odd head count and chunks of 16 (one MMA row
# tile): (label, (B, H, S, P, N, chunk))
SSD_BWD = (("mamba2", (4, 24, 4096, 64, 128, 64)),
           ("mamba2_h12", (4, 12, 4096, 64, 128, 64)),
           ("mamba2_h6", (4, 6, 4096, 64, 128, 64)),
           ("mamba2_h2", (4, 2, 4096, 64, 128, 64)),
           ("mamba2_h1", (4, 1, 4096, 64, 128, 64)),
           ("ragged", (1, 3, 96, 32, 16, 64)),
           ("chunk128", (2, 2, 256, 64, 128, 128)),
           ("one_chunk", (1, 2, 64, 64, 128, 64)),
           ("long128", (2, 2, 4096, 64, 128, 128)),
           ("odd", (1, 2, 37, 30, 18, 37)),
           ("heads5", (1, 5, 256, 64, 128, 64)),
           ("chunk16", (1, 2, 256, 64, 128, 16)))
SSD_BWD_REL_TOL = 1e-3  # each gradient within 1e-3 of its own max |ref|
SSD_BWD_INVARIANCE_TOL = 1e-4  # chunks of 32 vs 64, relative to each max |g|
SPLIT_CALLS = 5  # warm calls profiled for a backward entry's launches apart
MOE_SORTED_REL_TOL = 2e-2  # sorted vs one-hot dispatch (tests/test_arch_smoke.py:155)
FAMILY_DECODE = 32  # greedy tokens of mixtral through its ring cache
TUNE_MAX_ITERS = 1000  # phase 11's cap on the solver tuner's stage-1 solves
# the model kernels' contracts (tests/test_kernels_sweep.py): flash attention
# 2e-3 in f32, RG-LRU 1e-4, SSD relative 1e-3; flash attention in bf16 is held
# to its float32 plain version within the bound on bf16 rounding
# (flash_attention/ref.py: bf16_rounding_bound), not to the reference's flat
# 3e-2, which is as large as a typical output at the 2048-key window
FLASH_F32_TOL, RGLRU_TOL, SSD_REL_TOL = 2e-3, 1e-4, 1e-3
# decode (plain) against the kernels' forward in float32 at B=2, S=64: at
# reduced widths on the CPU the two differ by at most 1.3e-5, on the card at
# full width by 4.2e-4 on |logits| <= 3 (PERF.md); the reference's bf16 contract is 6e-2
# (tests/test_arch_smoke.py)
DECODE_TOL, DECODE_LEN = 1e-3, 64
MAIN_B, MAIN_T, MAIN_TS, MAIN_C = 96, 3, 36, 132  # phase 4's batch
# phase 4's critical TMs per joint topology solve: 4 of the paper's 12, which
# cuts its one host joint solve (91.1 s of phase 4's 98.5 s at 12 on one
# H100's host, 112.2 s of 124.8 s on a slower one) to keep the whole script
# well inside its time limit
SWEEP_K = 4
# phase 5 streams phase 4's first 7 1/8 days: the 7-day window, then 12
# routing decisions (the first with the joint topology solve), at 4 critical
# TMs (phase 9's cut: the joint solve at 12 took ~75 s of the script on one
# H100's host),
# held against the batched engine at the same 4
SERVE_DAYS = 7.125
SERVE_K = 4
# phase 7's buckets: (fabrics, blocks per fabric, commodities) of the 12-pod
# and the 8-pod bucket of the 22-fabric fleet
FLEET_BUCKETS = {"V12": (15, 96, 132), "V8": (7, 96, 56)}
FLEET_TOL = 1e-3  # fleet vs per-fabric engine (tests/test_fleet_engine.py:96)
SWEEP14_B = 672  # a 14-day sweep's batch (the batched kernels' PR 11 shape)
TRACE_T = 4032  # 14 days of 5-minute TMs: the whole-trace baseline's block
METRICS = ("mlu", "alu", "olr", "stretch", "loss")  # every phase tracks loss
# card clock cycles time_cuda holds the card for before each timed call: 10 ms
# at the H100's 1.98 GHz, above the host's time to issue any timed call (the
# plain versions' Python loops included)
HOLD_CYCLES = 20_000_000


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---- timing and bounds -------------------------------------------------------


def time_cuda(fn, reps: int = 20, flush_bytes: int = 256 << 20,
              read_flush: bool = False):
    """Median milliseconds of ``fn()`` on the card, CUDA events around each
    call, with the 50 MB L2 flushed before every call (the engine finds its
    inputs freshly copied, not resident).  After the flush the card is held
    busy (``HOLD_CYCLES``) until the host has issued the call and the end
    event, so that a call whose host side outlasts the flush is timed by its
    device work alone, not by the host's time to issue it.  The flush zeroes
    a buffer, which leaves L2 full of dirty lines that the timed call writes
    back as it reads; ``read_flush`` flushes by summing the buffer instead,
    which leaves clean lines."""
    import torch

    flush = torch.zeros(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call of ``fn()`` (issue only: the card
    is synchronized once, after the last call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(n_bytes: float, n_flops: float, flop_rate: float = F32_FLOP_PER_S):
    """Least time on an H100 SXM: bytes over HBM rate vs operations over
    ``flop_rate`` (f32 unless the work is bf16); returns
    (ms, "bytes" | "operations")."""
    tb, tf = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def max_errs(outs, refs):
    """Max abs error, max rel error, and the allclose contract's worst ratio."""
    abs_e = rel_e = worst = 0.0
    for a, r in zip(outs, refs):
        r = r.double()
        d = (a.double() - r).abs()
        nz = r.abs() > 1e-6
        abs_e = max(abs_e, float(d.max()))
        if bool(nz.any()):
            rel_e = max(rel_e, float((d[nz] / r[nz].abs()).max()))
        worst = max(worst, float((d / (LINK_ATOL + LINK_RTOL * r.abs())).max()))
    return abs_e, rel_e, worst


# ---- phases --------------------------------------------------------------------


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name!r} x{count}; nvidia-smi name, power limit: {smi}")
    return smi, name, count


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build(LIBRARIES)
    log(f"phase 2: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per library {({k: round(v, 2) for k, v in secs.items()})})")
    for name, text in sorted(_build.logs().items()):
        for line in text.splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "error" in line):
                log(f"  ptxas {name}: {line.strip()}")


def _linkload_inputs(b, t, c, e, gen, exact: bool):
    """Inputs on the card.  ``exact``: demand in {0..15} and weights in
    sixteenths, so every load is exact in f32 whatever the summation order and
    the OLR count cannot flip on a rounding tie."""
    import torch

    dev = "cuda"
    if exact:
        d = torch.randint(0, 16, (b, t, c), generator=gen, device=dev).float()
        w = torch.randint(0, 17, (b, c, e), generator=gen, device=dev).float() / 16
        w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.05)
        cap = 20.0 + 40.0 * torch.rand((b, e), generator=gen, device=dev)
    else:
        d = torch.rand((b, t, c), generator=gen, device=dev) * 40.0
        w = torch.rand((b, c, e), generator=gen, device=dev)
        w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.5)
        cap = 50.0 + 450.0 * torch.rand((b, e), generator=gen, device=dev)
    dead = torch.rand((b, e), generator=gen, device=dev) < 0.1
    inv_cap = torch.where(dead, 0.0, 1.0 / cap)
    return d.contiguous(), w.contiguous(), inv_cap.contiguous()


def _queueloss_inputs(b, ts, c, e, gen):
    import torch

    dev = "cuda"
    d = torch.rand((b, ts, c), generator=gen, device=dev) * 20.0
    d = d * (1.0 + 4.0 * (torch.rand((b, ts, c), generator=gen, device=dev) < 0.05))
    w = torch.rand((b, c, e), generator=gen, device=dev)
    w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.08)
    cap = 40.0 + 80.0 * torch.rand((b, e), generator=gen, device=dev)
    cap = torch.where(torch.rand((b, e), generator=gen, device=dev) < 0.1, 0.0, cap)
    buf = cap * 0.025
    return d.contiguous(), w.contiguous(), cap.contiguous(), buf.contiguous()


def phase_kernels():
    import torch

    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.linkload.ref import linkload_metrics_batched_ref
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.kernels.queueloss.ref import queueloss_batched_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # linkload: main-path shapes (exact-arithmetic data), a ragged shape, the
    # staged body's longest block and one row past it (the batched body), and
    # W at a storage offset; bit for bit against a second call; at the two
    # main shapes timed beside the batched body it launched before (through
    # the comparison entry, which counts no launch) on the same inputs
    t, c, e = MAIN_T, MAIN_C, MAIN_C
    cut = _single_rows_cut(c, e)
    llib = llops._library()[0]
    timed = {}
    for label, shape, exact in (("main", (MAIN_B, t, c, e), True),
                                ("sweep14", (SWEEP14_B, t, c, e), True),
                                ("ragged", (4, 13, 30, 200), False),
                                ("at_cut", (8, cut, c, e), True),
                                ("past_cut", (8, cut + 1, c, e), True),
                                ("unaligned_w", (MAIN_B, t, c, e), True)):
        args = _linkload_inputs(*shape, gen, exact)
        if label == "unaligned_w":
            args = (args[0], _unaligned(args[1]), args[2])
        out = llops.linkload_batched(*args, 0.8)
        ref = linkload_metrics_batched_ref(*args, 0.8)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        # no atomics: a second call gives the same bits
        same = all(torch.equal(x, y)
                   for x, y in zip(llops.linkload_batched(*args, 0.8), out))
        body = ("the staged body" if llops._single_fits(*shape[1:])
                else "the batched body")
        log(f"phase 3: linkload {label} {shape} ({body}): max abs err {abs_e:.3e}, "
            f"max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) {worst:.3f}; "
            f"second call bit-equal {same}")
        if worst > 1.0 or not all(bool(torch.isfinite(x).all()) for x in out):
            fail(f"linkload {label} disagrees with its plain version")
        if not same:
            fail(f"linkload {label} is not deterministic")
        if label not in ("main", "sweep14"):
            continue
        b = shape[0]
        # one body, one order of sums: each epoch's bits are the single-block
        # entry's and the fleet entry's at F = 1
        fleet = llops.linkload_fleet(*(x[None] for x in args), 0.8)
        equal = all(torch.equal(x, y[0]) for x, y in zip(out, fleet)) and all(
            torch.equal(x[bi], y)
            for bi in (0, b // 2, b - 1)
            for x, y in zip(out, llops.linkload(*(a[bi] for a in args), 0.8)))
        ms = time_cuda(lambda: llops.linkload_batched(*args, 0.8))
        old = time_cuda(lambda: llops._linkload_tiles(*args, 0.8))
        plain = time_cuda(lambda: linkload_metrics_batched_ref(*args, 0.8))
        bmm = time_cuda(lambda: torch.bmm(args[0], args[1]))
        n_bytes = 4 * (b * t * c + b * c * e + b * e + 4 * b * t)
        n_flops = 2 * b * t * c * e + 5 * b * t * e
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"  linkload {label} times: kernel {ms:.4f} ms, the batched body it "
            f"launched before {old:.4f} ms, plain {plain:.4f} ms, torch.bmm of the "
            f"load alone {bmm:.4f} ms, bound {bnd:.4f} ms ({by}: "
            f"{n_bytes / 1e6:.1f} MB, {n_flops / 1e6:.1f} MFLOP); a CTA of "
            f"{llib.linkload_staged_threads(t, e)} threads and "
            f"{llib.linkload_single_smem_bytes(t, c, e)} B of shared memory an "
            f"epoch; bit-equal to the single-block and fleet entries {equal}")
        if not equal:
            fail(f"linkload {label}: the staged body's bits differ between entries")
        timed[label] = {"max_abs_err": abs_e, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by, "yardstick_bmm_ms": bmm,
                        "batched_body_ms": old, "shape": list(shape)}
    rows["linkload"] = {
        "name": "linkload_batched", "route": "cuda",
        "source": "src/repro_torch/csrc/linkload.cu",
        "replaces": "src/repro/kernels/linkload/linkload.py:136",
        **timed["main"], "library_ms": None, "sweep14": timed["sweep14"],
        "status": "redesigned"}

    # queueloss: main-path shapes, a ragged shape with dead links and a block
    # past the fleet body (the E-tiled body and its partials pass); the
    # redesigned entry also bit for bit against a second call and timed beside
    # the E-tiled body it launched before on the same inputs
    qlib = qlops._library()[0]
    timed = {}
    for label, shape in (("main", (MAIN_B, MAIN_TS, c, e)),
                         ("sweep14", (SWEEP14_B, MAIN_TS, c, e)),
                         ("ragged", (4, 45, 30, 300)),
                         ("past_fits", (4, 512, c, e))):
        args = _queueloss_inputs(*shape, gen)
        out = qlops.queueloss_batched(*args, 30.0)
        ref = queueloss_batched_ref(*args, 30.0)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        drops = float(ref[0].sum())
        # no atomics: a second call gives the same bits
        same = all(torch.equal(x, y)
                   for x, y in zip(qlops.queueloss_batched(*args, 30.0), out))
        body = ("the fleet body, one launch" if qlops._fleet_fits(*shape[1:])
                else "the E-tiled body, two launches")
        log(f"phase 3: queueloss {label} {shape} ({body}): max abs err {abs_e:.3e}, "
            f"max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) {worst:.3f}, "
            f"total drop {drops:.3f} Gb; second call bit-equal {same}")
        if worst > 1.0 or drops <= 0.0:
            fail(f"queueloss {label} disagrees with its plain version "
                 f"(or drops nothing)")
        if not same:
            fail(f"queueloss {label} is not deterministic")
        if label in ("ragged", "past_fits"):
            continue
        bq, ts = shape[0], shape[1]
        ms = time_cuda(lambda: qlops.queueloss_batched(*args, 30.0))
        old = time_cuda(lambda: qlops._queueloss_tiles(*args, 30.0))
        plain = time_cuda(lambda: queueloss_batched_ref(*args, 30.0))
        # the fleet body sums the links in the E-tiled body's order at E <= 160
        equal = all(torch.equal(x, y)
                    for x, y in zip(out, qlops._queueloss_tiles(*args, 30.0)))
        smem = qlib.queueloss_fleet_smem_bytes(ts, c, e)
        n_bytes = 4 * (bq * ts * c + bq * c * e + 2 * bq * e + 2 * bq * ts)
        n_flops = 2 * bq * ts * c * e + 6 * bq * ts * e
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"  queueloss {label} times: kernel {ms:.4f} ms, the E-tiled body it "
            f"launched before {old:.4f} ms (bit-equal outputs {equal}), plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
            f"{n_flops / 1e6:.1f} MFLOP); {smem} B of shared memory a CTA")
        timed[label] = {"max_abs_err": abs_e, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by, "tiled_body_ms": old,
                        "bit_equal_to_tiled_body": equal, "smem_bytes": smem,
                        "shape": list(shape)}
    rows["queueloss"] = {
        "name": "queueloss_batched", "route": "cuda",
        "source": "src/repro_torch/csrc/queueloss.cu",
        "replaces": "src/repro/kernels/queueloss/queueloss.py:178",
        **timed["main"], "library_ms": None, "sweep14": timed["sweep14"],
        "status": "redesigned"}
    return rows


def _single_rows_cut(c: int, e: int) -> int:
    """The longest block the single-block linkload body takes at (C, E)."""
    from repro_torch.kernels.linkload import ops as llops

    t = 0
    while llops._single_fits(t + 1, c, e):
        t += 1
    return t


def _unaligned(t):
    """A contiguous copy of ``t`` one element past an aligned allocation: a
    view with a storage offset, not 16-byte aligned."""
    import torch

    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    return view


def _linkload_entry_setup():
    """What the linkload wrapper did on every launch before it kept its
    library: look the library up and set an entry's argument types."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.library("linkload")
    fn = lib.linkload_single
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.linkload_max_commodities.restype = ctypes.c_int
    lib.linkload_max_commodities()


def phase_single_kernels():
    """The single-block entries at the streaming controller's shapes (T=3,
    TS=36), linkload also at the whole-trace shape (T=4032), at one row, on
    both sides of its staged body's row cut, with W at a storage offset,
    and each at a ragged shape with dead links too; the redesigned bodies
    also bit for bit against a second call, and timed beside the bodies they
    replaced."""
    import torch

    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.linkload.ref import linkload_metrics_ref
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.kernels.queueloss.ref import queueloss_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    c = e = MAIN_C
    rows = {}
    timed = {}
    stream = torch.cuda.current_stream().cuda_stream
    qlib = qlops._library()[0]
    floor = time_cuda(lambda: qlib.queueloss_noop(stream))
    cut = _single_rows_cut(c, e)
    log(f"phase 3: linkload (single) body takes T <= {cut} at C=E={c} "
        f"({llops._library()[0].linkload_single_smem_bytes(cut, c, e)} B of shared "
        f"memory there, {llops._library()[0].linkload_single_smem_bytes(MAIN_T, c, e)} "
        f"B at T={MAIN_T}); an empty kernel through the ctypes path {floor:.4f} ms")
    grid = {}
    for label, (t, cc, ee), exact in (("serve", (MAIN_T, c, e), True),
                                      ("trace", (TRACE_T, c, e), True),
                                      ("ragged", (13, 30, 200), False),
                                      ("one_row", (1, c, e), True),
                                      ("unaligned_w", (MAIN_T, c, e), True),
                                      ("rows12", (12, c, e), True),
                                      ("rows36", (36, c, e), True),
                                      ("at_cut", (cut, c, e), True),
                                      ("past_cut", (cut + 1, c, e), True)):
        d, w, ic = (x[0].contiguous()
                    for x in _linkload_inputs(1, t, cc, ee, gen, exact))
        if label == "unaligned_w":
            w = _unaligned(w)
        out = llops.linkload(d, w, ic, 0.8)
        ref = linkload_metrics_ref(d, w, ic, 0.8)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        # no atomics: a second call gives the same bits
        same = all(torch.equal(x, y) for x, y in zip(llops.linkload(d, w, ic, 0.8), out))
        body = ("the staged body" if llops._single_fits(t, cc, ee)
                else "the batched body over one pair")
        log(f"phase 3: linkload (single) {label} {(t, cc, ee)} ({body}): max abs err "
            f"{abs_e:.3e}, max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) "
            f"{worst:.3f}; second call bit-equal {same}")
        if worst > 1.0 or not all(bool(torch.isfinite(x).all()) for x in out):
            fail(f"linkload (single) {label} disagrees with its plain version")
        if not same:
            fail(f"linkload (single) {label} is not deterministic")
        if label in ("serve", "trace", "rows12", "rows36", "at_cut", "past_cut"):
            # the entry beside the batched body over one pair (the path it
            # took before its own body), at every T of the grid
            new = time_cuda(lambda: llops.linkload(d, w, ic, 0.8))
            old = time_cuda(lambda: llops._linkload_tiles(d[None], w[None], ic[None], 0.8))
            grid[t] = {"entry_ms": new, "batched_body_ms": old, "body": body}
            log(f"  linkload (single) T={t}: entry ({body}) {new:.4f} ms, the batched "
                f"body over one pair {old:.4f} ms")
        if label not in ("serve", "trace"):
            continue
        ms = grid[t]["entry_ms"]
        plain = time_cuda(lambda: linkload_metrics_ref(d, w, ic, 0.8))
        mm = time_cuda(lambda: torch.mm(d, w))
        n_bytes = 4 * (t * c + c * e + e + 4 * t)
        n_flops = 2 * t * c * e + 5 * t * e
        bnd, by = bound_ms(n_bytes, n_flops)
        msg = ""
        if label == "serve":
            host = host_us(lambda: llops.linkload(d, w, ic, 0.8))
            host_before = host_us(lambda: (_linkload_entry_setup(),
                                           llops.linkload(d, w, ic, 0.8)))
            msg = (f"; the wrapper's host time {host:.1f} us a call, "
                   f"{host_before:.1f} us with the per-call library lookup and "
                   f"argtypes reset it did before")
            timed["host"] = (host, host_before)
        log(f"  linkload (single) {label} times: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, torch.mm of the load alone {mm:.4f} ms, bound "
            f"{bnd:.5f} ms ({by}: {n_bytes / 1e6:.4f} MB, "
            f"{n_flops / 1e6:.3f} MFLOP){msg}")
        timed[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                        "bound_by": by, "yardstick_mm_ms": mm,
                        "batched_body_ms": grid[t]["batched_body_ms"],
                        "max_abs_err": abs_e}
    rows["linkload"] = {
        "name": "linkload", "route": "cuda",
        "source": "src/repro_torch/csrc/linkload.cu",
        "replaces": "src/repro/kernels/linkload/linkload.py:69",
        **timed["serve"], "library_ms": None, "launch_floor_ms": floor,
        "host_us_per_call": timed["host"][0],
        "host_us_per_call_with_per_call_setup": timed["host"][1],
        "shape": [MAIN_T, c, e], "single_max_rows": cut,
        "t_grid": {str(k): v for k, v in grid.items()},
        "whole_trace": dict(timed["trace"], shape=[TRACE_T, c, e]),
        "status": "redesigned"}

    # the redesigned single-block queue loss: the serve shape, a ragged one
    # with dead links, one sub-step, and a long block (past one CTA's shared
    # memory: the E-tiled body over one pair)
    for label, (ts, cc, ee) in (("serve", (MAIN_TS, c, e)),
                                ("ragged", (45, 30, 300)),
                                ("one_step", (1, c, e)),
                                ("long", (512, c, e))):
        d, w, cap, buf = (x[0].contiguous()
                          for x in _queueloss_inputs(1, ts, cc, ee, gen))
        out = qlops.queueloss(d, w, cap, buf, 30.0)
        ref = queueloss_ref(d, w, cap, buf, 30.0)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        drops = float(ref[0].sum())
        # no atomics: a second call gives the same bits
        same = all(torch.equal(x, y)
                   for x, y in zip(qlops.queueloss(d, w, cap, buf, 30.0), out))
        body = ("one launch" if qlops._single_fits(ts, cc, ee)
                else "the E-tiled body over one pair, two launches")
        log(f"phase 3: queueloss (single) {label} {(ts, cc, ee)} ({body}): max "
            f"abs err {abs_e:.3e}, max rel err {rel_e:.3e}, worst "
            f"|err|/(atol+rtol|ref|) {worst:.3f}, total drop {drops:.3f} Gb; "
            f"second call bit-equal {same}")
        if worst > 1.0 or drops <= 0.0:
            fail(f"queueloss (single) {label} disagrees with its plain version "
                 f"(or drops nothing)")
        if not same:
            fail(f"queueloss (single) {label} is not deterministic")
        if label != "serve":
            continue
        ms = time_cuda(lambda: qlops.queueloss(d, w, cap, buf, 30.0))
        plain = time_cuda(lambda: queueloss_ref(d, w, cap, buf, 30.0))
        # the path this entry took before its own body: the E-tiled body over
        # one pair, then the partial sums (two launches)
        batched = [x[None] for x in (d, w, cap, buf)]
        prev = time_cuda(lambda: qlops._queueloss_tiles(*batched, 30.0))
        host = host_us(lambda: qlops.queueloss(d, w, cap, buf, 30.0))
        n_bytes = 4 * (ts * c + c * e + 2 * e + 2 * ts)
        n_flops = 2 * ts * c * e + 6 * ts * e
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"  queueloss (single) times: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, an empty kernel through the same ctypes path "
            f"{floor:.4f} ms, the E-tiled body over one pair {prev:.4f} ms, "
            f"bound {bnd:.5f} ms ({by}: {n_bytes / 1e6:.4f} MB, "
            f"{n_flops / 1e6:.3f} MFLOP); the wrapper's host time {host:.1f} us "
            f"a call")
        rows["queueloss"] = {
            "name": "queueloss", "route": "cuda",
            "source": "src/repro_torch/csrc/queueloss.cu",
            "replaces": "src/repro/kernels/queueloss/queueloss.py:92",
            "max_abs_err": abs_e, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "launch_floor_ms": floor, "tiled_body_ms": prev,
            "host_us_per_call": host, "shape": [ts, c, e], "status": "redesigned"}
    return rows


def _fleet_inputs(f, b, t, c, gen, n_blocks=None, n_pods=None, vp=None,
                  queue=False):
    """Fleet-kernel inputs on the card: ``n_blocks[fi]`` real blocks per
    fabric (the rest all zeros, as the engine pads a ragged bucket) and, with
    ``n_pods``, each fabric's commodities embedded in the ``vp``-pod layout
    (zero demand, weights and capacity on padded commodities and links)."""
    import torch

    from repro_torch.core.fleet import commodity_slots

    make = _queueloss_inputs if queue else (
        lambda *a: _linkload_inputs(*a, exact=True))
    args = [x.reshape((f, b) + x.shape[1:]).clone()
            for x in make(f * b, t, c, c, gen)]
    for fi in range(f):
        if n_blocks is not None:
            for x in args:
                x[fi, n_blocks[fi]:] = 0.0
        if n_pods is not None:
            keep = torch.zeros(c, dtype=torch.bool, device="cuda")
            keep[torch.as_tensor(commodity_slots(n_pods[fi], vp),
                                 device="cuda")] = True
            args[0][fi][..., ~keep] = 0.0  # demand of padded commodities
            args[1][fi][:, ~keep, :] = 0.0  # their routes ...
            args[1][fi][:, :, ~keep] = 0.0  # ... and padded links' load
            for x in args[2:]:
                x[fi][:, ~keep] = 0.0  # dead padded links
    if queue:
        args[3] = args[2] * 0.025  # buffers follow the capacities
    return [x.contiguous() for x in args]


def phase_fleet_kernels():
    """The fleet entries (kernels #5/#6) at phase 7's two buckets, at a ragged
    padded bucket and past their bodies' limits (the linkload one row past its
    staged body's cut: the batched body; the queue loss at TS=512: the E-tiled
    body), the linkload also with W at a storage offset, against their plain
    versions and bit for bit against a second call; times at both buckets
    beside the bodies they launched before on the same pairs (the batched
    linkload body, the E-tiled queue-loss body), the linkload's also beside
    ``torch.bmm`` of the load alone and a sum of W (a read of its bytes), each
    also after an L2 flush by reads, and at the staged body's row cut."""
    import torch

    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.linkload.ref import linkload_metrics_fleet_ref
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.kernels.queueloss.ref import queueloss_fleet_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    ragged = dict(n_blocks=(5, 2, 4), n_pods=(6, 8, 7), vp=8)
    llib, qlib = llops._library()[0], qlops._library()[0]
    cut = _single_rows_cut(MAIN_C, MAIN_C)
    rows, timed = {}, {"linkload": {}, "queueloss": {}}
    for label, (f, b, c) in (*FLEET_BUCKETS.items(), ("ragged", (3, 5, 56)),
                             ("past_fits", (2, 3, 132)), ("unaligned_w", (3, 5, 132))):
        extra = ragged if label == "ragged" else {}
        for name, t in (("linkload", MAIN_T), ("queueloss", MAIN_TS)):
            queue = name == "queueloss"
            if label == "unaligned_w" and queue:
                continue
            if label == "past_fits":
                # one row past the staged body's cut; (512, 132) tiles outnumber
                # one CTA's threads
                t = 512 if queue else cut + 1
            args = _fleet_inputs(f, b, t, c, gen, queue=queue, **extra)
            if label == "unaligned_w":
                args[1] = _unaligned(args[1])
            if queue:
                def kernel():
                    return qlops.queueloss_fleet(*args, 30.0)

                def plain():
                    return queueloss_fleet_ref(*args, 30.0)

                body = ("the fleet body, one launch" if qlops._fleet_fits(t, c, c)
                        else "the E-tiled body over the F*B pairs, two launches")
            else:
                def kernel():
                    return llops.linkload_fleet(*args, 0.8)

                def plain():
                    return linkload_metrics_fleet_ref(*args, 0.8)

                body = ("the staged body" if llops._single_fits(t, c, c)
                        else "the batched body over the F*B pairs")
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            abs_e, rel_e, worst = max_errs(out, ref)
            # no atomics: a second call gives the same bits
            same = all(torch.equal(x, y) for x, y in zip(kernel(), out))
            msg = (f"phase 3: {name} (fleet) {label} {(f, b, t, c, c)} ({body}): max "
                   f"abs err {abs_e:.3e}, max rel err {rel_e:.3e}, worst "
                   f"|err|/(atol+rtol|ref|) {worst:.3f}; second call bit-equal {same}")
            if queue:
                msg += f", total drop {float(ref[0].sum()):.3f} Gb"
            log(msg)
            if (worst > 1.0 or not all(bool(torch.isfinite(x).all()) for x in out)
                    or (queue and float(ref[0].sum()) <= 0.0)):
                fail(f"{name} (fleet) {label} disagrees with its plain version "
                     f"(or drops nothing)")
            if not same:
                fail(f"{name} (fleet) {label} is not deterministic")
            if label not in FLEET_BUCKETS:
                continue
            fb = f * b
            ms, plain_ms = time_cuda(kernel), time_cuda(plain)
            n_outs = 2 if queue else 4
            n_bytes = 4 * (fb * t * c + fb * c * c + (2 if queue else 1) * fb * c
                           + n_outs * fb * t)
            n_flops = 2 * fb * t * c * c + (6 if queue else 5) * fb * t * c
            bnd, by = bound_ms(n_bytes, n_flops)
            row = {"max_abs_err": abs_e, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by, "shape": [f, b, t, c, c]}
            msg = (f"  {name} (fleet) {label} times: kernel {ms:.4f} ms, plain "
                   f"{plain_ms:.4f} ms")
            flat = [x.reshape((fb,) + x.shape[2:]) for x in args]
            if queue:
                row["tiled_body_ms"] = time_cuda(
                    lambda: qlops._queueloss_tiles(*flat, 30.0))
                row["smem_bytes"] = qlib.queueloss_fleet_smem_bytes(t, c, c)
                # the two bodies sum in the same order at E <= 160: a check of
                # what the fleet engine sees against the per-fabric engine
                row["bit_equal_to_tiled_body"] = all(
                    torch.equal(x.reshape(fb, t), y)
                    for x, y in zip(out, qlops._queueloss_tiles(*flat, 30.0)))
                msg += (f", the E-tiled body over the same F*B pairs "
                        f"{row['tiled_body_ms']:.4f} ms (bit-equal outputs "
                        f"{row['bit_equal_to_tiled_body']}); {row['smem_bytes']} B "
                        f"of shared memory a CTA")
            else:
                row["batched_body_ms"] = time_cuda(
                    lambda: llops._linkload_tiles(*flat, 0.8))
                row["yardstick_bmm_ms"] = time_cuda(lambda: torch.bmm(*flat[:2]))
                row["yardstick_w_sum_ms"] = time_cuda(lambda: args[1].sum())
                # the flush by zeroing leaves ~50 MB of dirty lines in L2, which
                # the timed call writes back; a flush by reads leaves clean ones
                row["read_flush_ms"] = time_cuda(kernel, read_flush=True)
                row["read_flush_w_sum_ms"] = time_cuda(lambda: args[1].sum(),
                                                       read_flush=True)
                row["threads"] = llib.linkload_staged_threads(t, c)
                row["smem_bytes"] = llib.linkload_single_smem_bytes(t, c, c)
                # one body, one order of sums: each pair's bits are the
                # single-block entry's
                row["bit_equal_to_single_entry"] = all(
                    torch.equal(x[fi, bi], y)
                    for fi, bi in ((0, 0), (f - 1, b - 1))
                    for x, y in zip(out, llops.linkload(
                        *(a[fi, bi].contiguous() for a in args), 0.8)))
                msg += (f", the batched body over the same F*B pairs "
                        f"{row['batched_body_ms']:.4f} ms, torch.bmm of the load "
                        f"alone {row['yardstick_bmm_ms']:.4f} ms, a sum of W "
                        f"{row['yardstick_w_sum_ms']:.4f} ms; after an L2 flush by "
                        f"reads: kernel {row['read_flush_ms']:.4f} ms, sum of W "
                        f"{row['read_flush_w_sum_ms']:.4f} ms; a CTA of "
                        f"{row['threads']} threads and {row['smem_bytes']} B of "
                        f"shared memory a pair; bit-equal to the single-block "
                        f"entry {row['bit_equal_to_single_entry']}")
            log(f"{msg}, bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
                f"{n_flops / 1e6:.1f} MFLOP)")
            timed[name][label] = row
    # the staged body at its longest block beside the batched body it hands
    # longer blocks to, over the 12-pod bucket's pairs of four fabrics
    args = _fleet_inputs(4, 96, cut, MAIN_C, gen)
    flat = [x.reshape((4 * 96,) + x.shape[2:]) for x in args]
    at_cut = {"shape": [4, 96, cut, MAIN_C, MAIN_C],
              "ms": time_cuda(lambda: llops.linkload_fleet(*args, 0.8)),
              "batched_body_ms": time_cuda(lambda: llops._linkload_tiles(*flat, 0.8))}
    log(f"  linkload (fleet) at the staged body's cut T={cut} (4, 96): staged body "
        f"{at_cut['ms']:.4f} ms, the batched body over the same pairs "
        f"{at_cut['batched_body_ms']:.4f} ms")
    for name, entry, line in (("linkload", "linkload_fleet", 209),
                              ("queueloss", "queueloss_fleet", 266)):
        rows[name] = {
            "name": entry, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/{name}.py:{line}",
            **timed[name]["V12"], "library_ms": None, "bucket_V8": timed[name]["V8"],
            "status": "redesigned"}
    rows["linkload"]["at_cut"] = at_cut
    return rows


def _band_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs inside the mask of one attention row."""
    total = 0
    for qi in range(sq):
        hi = min(sk - 1, qi) if causal else sk - 1
        lo = max(0, qi - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _flash_backward_check(label, shape, gen, dev):
    """#7's backward at one shape: the gradients through ``FlashAttention``
    (the training path: the forward with its log-sum-exp, then the backward
    kernels) against the plain backward and against autograd through the
    plain forward, in float32 at ``FLASH_BWD_F32_TOL`` or, for bf16 inputs,
    within the bf16 rounding bound (``bf16_grad_rounding_bound``); bit for
    bit against a second call; at Sq != Sk also the forward against its plain
    version.  Returns (inputs, forward output, lse, the numbers)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref,
                                                         bf16_grad_rounding_bound,
                                                         bf16_rounding_bound)

    b, sq, sk, h, kv, hd, causal, window, dt = shape
    dtype = getattr(torch, dt)
    q, k, v, do = (torch.randn((b * n, s_, hd), generator=gen, device=dev).to(dtype)
                   for n, s_ in ((h, sq), (kv, sk), (kv, sk), (h, sq)))
    m = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
    o, lse = faops.flash_attention_rows(q, k, v, with_lse=True, **m)
    if sq != sk:  # the forward at Sq != Sk (cross-attention)
        if dtype == torch.bfloat16:
            ref, tol = bf16_rounding_bound(q, k, v, **m)
        else:
            ref, tol = attention_ref(q, k, v, **m), FLASH_F32_TOL
        fwd_worst = float(((o.float() - ref).abs() / tol).max())
        log(f"phase 3: flash_attention forward {label} (Sq={sq} != Sk={sk}): worst "
            f"|err|/tol {fwd_worst:.4f}")
        if not fwd_worst <= 1.0:
            fail(f"flash_attention forward at Sq != Sk ({label}) disagrees")
        del ref, tol
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(faops.FlashAttention.apply(qg, kg, vg, h, kv, causal,
                                                         window), (qg, kg, vg), do)
    again = torch.autograd.grad(faops.FlashAttention.apply(qg, kg, vg, h, kv, causal,
                                                           window), (qg, kg, vg), do)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    # the f32 gradient by autograd through the plain forward, a batch row
    # at a time (its (H, Sq, Sk) float32 intermediates)
    auto = [[], [], []]
    for i in range(b):
        rows_q, rows_k = slice(i * h, (i + 1) * h), slice(i * kv, (i + 1) * kv)
        qf, kf, vf = (t[r].float().requires_grad_() for t, r in
                      ((q, rows_q), (k, rows_k), (v, rows_k)))
        out_f = attention_ref(qf, kf, vf, **m)
        for j, g in enumerate(torch.autograd.grad(out_f, (qf, kf, vf),
                                                  do[rows_q].float())):
            auto[j].append(g)
        del qf, kf, vf, out_f
    auto = [torch.cat(x) for x in auto]
    if dtype == torch.bfloat16:
        plain, bound = bf16_grad_rounding_bound(q, k, v, do, **m)
        contract = "the bf16 gradient rounding bound"
    else:
        plain = attention_bwd_ref(q, k, v, o, do, attention_lse_ref(q, k, **m), **m)
        bound = tuple(FLASH_BWD_F32_TOL * (1 + r.abs()) for r in plain)
        contract = f"{FLASH_BWD_F32_TOL}·(1+|ref|)"
    worst_plain = max(float(((g.float() - r).abs() / t).max())
                      for g, r, t in zip(got, plain, bound))
    worst_auto = max(float(((g.float() - r).abs() / t).max())
                     for g, r, t in zip(got, auto, bound))
    err = max(float((g.float() - r).abs().max()) for g, r in zip(got, plain))
    log(f"phase 3: flash_attention backward {label} (B={b}, Sq={sq}, Sk={sk}, H={h}, "
        f"KV={kv}, hd={hd}, causal={causal}, window={window}, {dt}): max abs err "
        f"{err:.3e}; worst |err|/tol against the plain backward {worst_plain:.4f}, "
        f"against autograd through the plain forward {worst_auto:.4f} (tol: "
        f"{contract}); second call bit-equal {same}")
    if not worst_plain <= 1.0 or not worst_auto <= 1.0:
        fail(f"flash_attention backward {label} disagrees with its plain version")
    if not same:
        fail(f"flash_attention backward {label} is not deterministic")
    del got, auto, plain, bound
    torch.cuda.empty_cache()
    return (q, k, v, do), o, lse, {"shape": list(shape[:6]) + [int(causal), window, dt],
                                   "max_abs_err": err, "worst_plain": worst_plain,
                                   "worst_autograd": worst_auto}


def _flash_backward(gen, dev):
    """Flash attention's backward (#7b) at the ``FLASH_BWD`` shapes and the
    ``FLASH_BWD_EDGES`` ones, each checked by ``_flash_backward_check``; at
    the ``FLASH_BWD`` shapes the times of the backward entry, of each of its
    two launches alone (dQ with D, dK/dV), of its plain version in the input dtype
    and of ``scaled_dot_product_attention``'s backward, each with its rate
    on the bound's operations.  The bound takes the work at the rate of the
    shape's dtype: bf16 on the tensor cores, float32 on the CUDA cores (the
    kernel uses no TF32).  Returns the kernels-line row (the llama3 shape)
    with every shape's numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    shapes, edges = {}, {}
    for label, shape in FLASH_BWD_EDGES:
        tensors, o, lse, row = _flash_backward_check(label, shape, gen, dev)
        edges[label] = row
        del tensors, o, lse
        torch.cuda.empty_cache()
    for label, shape in FLASH_BWD:
        (q, k, v, do), o, lse, row = _flash_backward_check(label, shape, gen, dev)
        b, sq, sk, h, kv, hd, causal, window, dt = shape
        m = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
        pairs = _band_pairs(sq, sk, causal, window) * b * h
        n_flops = 2.5 * 4 * hd * pairs
        n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
        ms = time_cuda(lambda: faops.flash_attention_bwd_rows(q, k, v, o, do, lse, **m))
        part_ms = {name: time_cuda(lambda: faops._launch_backward(
            q, k, v, o, do, lse, dev, parts=bit, **m))
                   for name, bit in (("dQ and D", 1), ("dK/dV", 2))}
        plain_ms = time_cuda(lambda: attention_bwd_ref(q, k, v, o, do, lse, **m))
        q4, k4, v4 = (t.view(b, n, s_, hd).detach().requires_grad_()
                      for t, n, s_ in ((q, h, sq), (k, kv, sk), (v, kv, sk)))
        kw = dict(enable_gqa=True)
        if window:
            i = torch.arange(sq, device=dev)[:, None]
            j = torch.arange(sk, device=dev)[None, :]
            kw["attn_mask"] = (j > i - window) & ((j <= i) if causal else True)
        else:
            kw["is_causal"] = causal
        out4 = F.scaled_dot_product_attention(q4, k4, v4, **kw)
        do4 = do.view(b, h, sq, hd)
        lib_ms = time_cuda(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                       retain_graph=True))
        rate, rate_name = ((F32_FLOP_PER_S, "the f32 CUDA-core rate") if dt == "float32"
                           else (BF16_FLOP_PER_S, "the bf16 tensor-core rate"))
        bnd, by = bound_ms(n_bytes, n_flops, rate)

        def tflops(t):
            return f"{t:.4f} ms ({n_flops / t / 1e9:.1f} TFLOP/s)"

        log(f"  flash_attention backward {label} times: kernel {tflops(ms)} (alone: "
            + ", ".join(f"{n} {t:.4f}" for n, t in part_ms.items())
            + f" ms), plain {tflops(plain_ms)}, scaled_dot_product_attention backward "
            f"{tflops(lib_ms)}, bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
            f"{n_flops / 1e9:.3f} GFLOP = 2.5 x the forward's on {pairs} (q, k) pairs at "
            f"{rate_name}, {rate / 1e12:.0f} TFLOP/s)")
        shapes[label] = dict(row, ms=ms, part_ms=part_ms, plain_ms=plain_ms, bound_ms=bnd,
                             bound_by=by, library_ms=lib_ms, tflops=n_flops / ms / 1e9)
        del q, k, v, do, o, lse, q4, k4, v4, out4, do4
        torch.cuda.empty_cache()
    main = shapes["llama3"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"],
            "status": "redesigned (wgmma; dK/dV on clusters that split the GQA group)",
            "shapes": shapes, "edge_shapes": edges}


def _ssd_flops(b: int, h: int, s: int, p: int, n: int, q: int) -> float:
    """Operations the SSD forward needs at chunk q, two a multiply-add: the
    causal lower triangle of C·Bᵀ (T = Q(Q+1)/2 entries of N, a chunk,
    shared by the heads), then per head and chunk the masked product with x
    (TP) and the state's read and update (2QNP)."""
    nc, tri = s // q, q * (q + 1) // 2
    return 2.0 * (b * nc * tri * n + b * h * nc * (tri * p + 2 * q * n * p))


def _ssd_bwd_flops(b: int, h: int, s: int, p: int, n: int, q: int) -> float:
    """Operations the SSD gradient needs at chunk q, two a multiply-add,
    counting only causal lower triangles (T = Q(Q+1)/2) of the masked
    Q x Q products: C·Bᵀ (TN a chunk, shared by the heads); per head and
    chunk the forward and the reverse state walks, Gᵀ B, G x and S_in dy
    (QNP each), dy·xᵀ and Aᵀ dy (TP each), Wᵀ C and W B (TN each), the dots
    of C with S_in dy and of B with G x (QN each) and ⟨S_in, G⟩ (NP).  The
    entry does more: full Q x Q tiles, and C·S_in as a product of its own."""
    nc, tri = s // q, q * (q + 1) // 2
    per_head = 5 * q * n * p + 2 * tri * p + 2 * tri * n + 2 * q * n + n * p
    return 2.0 * (b * nc * tri * n + b * h * nc * per_head)


def _launch_split(fn) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by name, from
    ``torch.profiler`` over ``SPLIT_CALLS`` warm calls (no L2 flush between
    them)."""
    import torch

    for _ in range(3):
        fn()
    _, _, top = _device_profile(lambda: [fn() for _ in range(SPLIT_CALLS)],
                                torch.device("cuda"), top=16)
    # "void (anonymous namespace)::ssd_walks_kernel(float const*, ..." -> ssd_walks_kernel
    return {name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]:
            round(ms / SPLIT_CALLS, 4) for name, ms, _ in top}


def _ssd_backward(gen, dev):
    """#9b against ``ssd_chunk_ref_bwd`` (autograd through the plain version)
    at ``SSD_BWD``'s shapes: each gradient within ``SSD_BWD_REL_TOL`` of its
    own max |ref|, the same bits from a second call; at mamba2-130m's
    training shape also timed beside the plain backward, with its bound."""
    import torch

    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref_bwd

    row = None
    names = ("dx", "ddt", "da", "db", "dc")
    for label, (b, h, s, p, n, chunk) in SSD_BWD:
        x = torch.randn((b, h, s, p), generator=gen, device=dev)
        dt = 0.001 + 0.099 * torch.rand((b, h, s, 1), generator=gen, device=dev)
        a = -(1.0 + 7.0 * torch.rand((h, 1, 1, 1), generator=gen, device=dev))
        bm = torch.randn((b, 1, s, n), generator=gen, device=dev)
        cm = torch.randn((b, 1, s, n), generator=gen, device=dev)
        dy = torch.randn((b, h, s, p), generator=gen, device=dev)
        args = (x, dt, a, bm, cm, dy)
        q_len = min(chunk, s)
        while s % q_len:
            q_len //= 2
        before = sdops.bwd_launches
        got = sdops.ssd_scan_bwd(*args, chunk)
        want = ssd_chunk_ref_bwd(*args, q_len)
        torch.cuda.synchronize()
        errs = {k: float((g - w).abs().max()) for k, g, w in zip(names, got, want)}
        rels = {k: errs[k] / float(w.abs().max()) for k, w in zip(names, want)}
        same = all(torch.equal(g, r) for g, r in zip(sdops.ssd_scan_bwd(*args, chunk), got))
        n_launch = sdops.bwd_launches - before
        log(f"phase 3: ssd_chunk_bwd {label} (B={b}, H={h}, S={s}, P={p}, N={n}, chunk "
            f"{q_len}): max abs err {errs}, relative to each max |ref| "
            f"{ {k: round(v, 8) for k, v in rels.items()} } (contract {SSD_BWD_REL_TOL}); "
            f"second call bit-equal {same}; {n_launch} launches")
        if not all(v < SSD_BWD_REL_TOL for v in rels.values()):
            fail(f"ssd_chunk_bwd {label} disagrees with autograd through the plain version")
        if not same:
            fail(f"ssd_chunk_bwd {label} is not deterministic")
        if n_launch != 2:
            fail(f"ssd_chunk_bwd {label}: {n_launch} launches, expected 2")
        if label.startswith("mamba2_h"):  # a tensor-parallel rank's heads
            ms = time_cuda(lambda: sdops.ssd_scan_bwd(*args, chunk))
            row.setdefault("rank_heads_ms", {})[h] = ms
            log(f"  ssd_chunk_bwd at a rank's {h} heads: kernel {ms:.4f} ms")
        if label != "mamba2":
            continue
        # chunk invariance (tests/test_torch_gpu.py's 1e-4): the gradients at
        # chunks of 32 and 64 differ only in the order of sums.  It separates
        # float32 accuracy from TF32's (a lo term or the split lost), which
        # the 1e-3 contract above does not.
        inv = {k: float((u - v).abs().max()) / float(v.abs().max())
               for k, u, v in zip(names, sdops.ssd_scan_bwd(*args, 32), got)}
        log(f"  ssd_chunk_bwd chunk 32 vs 64: max |diff| relative to each max |g| "
            f"{ {k: round(v, 8) for k, v in inv.items()} } (contract "
            f"{SSD_BWD_INVARIANCE_TOL})")
        if not all(v <= SSD_BWD_INVARIANCE_TOL for v in inv.values()):
            fail("ssd_chunk_bwd is not chunk-invariant")
        q_bwd = min(q_len, sdops.MAX_BWD_CHUNK)
        n_flops = _ssd_bwd_flops(b, h, s, p, n, q_bwd)
        # inputs x, dt, a, b, c, dy read once; dx, ddt, da, db, dc written once
        n_bytes = 4 * (2 * (x.numel() + dt.numel() + a.numel() + bm.numel() + cm.numel())
                       + dy.numel())
        ms = time_cuda(lambda: sdops.ssd_scan_bwd(*args, chunk))
        plain = time_cuda(lambda: ssd_chunk_ref_bwd(*args, q_len))
        # three bounds: the route's, on the tensor cores at float32 accuracy
        # (3xTF32: three TF32 products for each; the share is taken against
        # it), the f32 CUDA cores', and the bytes alone
        bnd, by = bound_ms(n_bytes, 3 * n_flops, TF32_FLOP_PER_S)
        bnd_cores = bound_ms(n_bytes, n_flops)[0]
        bnd_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  ssd_chunk_bwd times: kernel {ms:.4f} ms, plain (autograd through the "
            f"plain version, for the record) {plain:.4f} ms; bounds ({n_bytes / 1e6:.1f} "
            f"MB, {n_flops / 1e9:.2f} GFLOP at chunk {q_bwd}): 3xTF32 tensor cores "
            f"{bnd:.4f} ms ({by}; the share's: {bnd / ms:.4f}), f32 CUDA cores "
            f"{bnd_cores:.4f} ms (share {bnd_cores / ms:.4f}), bytes {bnd_bytes:.4f} ms; "
            f"no single PyTorch call computes this gradient")
        split = _launch_split(lambda: sdops.ssd_scan_bwd(*args, chunk))
        log(f"  ssd_chunk_bwd launches apart (torch.profiler, device ms a call, mean "
            f"of {SPLIT_CALLS} warm calls, L2 warm): {split}")
        row = {"name": "ssd_chunk_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/ssd_chunk.cu",
               "replaces": "the gradient of src/repro/kernels/ssd_chunk/ssd_chunk.py:72 "
                           "(no pallas_call: XLA's autodiff of ssd_chunked, "
                           "src/repro/models/ssd.py:128)",
               "max_abs_err": max(errs.values()), "max_rel_err": max(rels.values()),
               "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
               "bound_f32_cores_ms": bnd_cores, "bound_bytes_ms": bnd_bytes,
               "share_against": "bound_ms (3xTF32 tensor cores, the route taken)",
               "chunk_invariance": inv, "launch_ms": split,
               "library_ms": None, "shape": [b, h, s, p, n, chunk],
               "status": "redesigned (3xTF32 mma.sync, cp.async ring, one launch of "
                         "both walks)"}
        del x, dt, a, bm, cm, dy, args, got, want
    torch.cuda.empty_cache()
    return row


def phase_model_kernels():
    """Kernels #7-#9 at phase 8's prefill shapes and at ragged ones, against
    their plain versions on the card, and the backward entries #7b, #8's and
    #9b; times at the prefill and training shapes, with
    ``scaled_dot_product_attention`` (same mask, ``enable_gqa``) as flash
    attention's yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import attention_ref, bf16_rounding_bound
    from repro_torch.kernels.rglru_scan import ops as rlops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    rows, family_rows = {}, {}

    # 7. flash attention: recurrentgemma-9b's local attention, a ragged
    # shape (hd 100, H/KV 4, non-causal window) in f32 and bf16, the
    # prefills of phase 12 (FAMILY_FLASH), a tensor-parallel rank's uneven
    # head shares (TP_FLASH), a 1×4 rank's share of mixtral's and dbrx's
    # heads (MOE_TP_FLASH), the dense family's prefills (DENSE_FLASH) and
    # its 4-card steps (DENSE_FULL_FLASH, bf16 and float32), the last four
    # also bit for bit against a second call
    rank_rows, dense_rows = {}, {}
    for label, (b, s, h, kv, hd, causal, window, dtype) in (
            ("main", (2, 4096, 16, 1, 256, True, 2048, torch.bfloat16)),
            ("ragged", (1, 1000, 8, 2, 100, False, 48, torch.float32)),
            ("ragged_bf16", (1, 1000, 8, 2, 100, False, 48, torch.bfloat16)),
            *((arch, (*shape, True, window, torch.bfloat16))
              for arch, (shape, window) in FAMILY_FLASH.items()),
            *((label, (*shape, True, 0, torch.bfloat16)) for label, shape in TP_FLASH),
            *((label, (*shape, True, window, torch.bfloat16))
              for label, (shape, window) in MOE_TP_FLASH + DENSE_FLASH),
            *((label, (*shape, True, window, getattr(torch, dt)))
              for label, (shape, window, dt) in DENSE_FULL_FLASH)):
        q, k, v = (torch.randn((b * n, s, hd), generator=gen, device=dev).to(dtype)
                   for n in (h, kv, kv))
        args = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
        out = faops.flash_attention_rows(q, k, v, **args)
        if dtype == torch.bfloat16:
            ref, tol = bf16_rounding_bound(q, k, v, **args)
            contract = "the bf16 rounding bound 2^-7 (sum w|v| + |out|) + 1e-6"
        else:
            ref, tol = attention_ref(q, k, v, **args), FLASH_F32_TOL
            contract = f"{FLASH_F32_TOL}"
        torch.cuda.synchronize()
        d = (out.float() - ref).abs()
        err, worst = float(d.max()), float((d / tol).max())
        del d, tol
        log(f"phase 3: flash_attention {label} (B={b}, S={s}, H={h}, KV={kv}, "
            f"hd={hd}, causal={causal}, window={window}, {dtype}): max abs err "
            f"{err:.3e} against the float32 plain version, median |out| "
            f"{float(ref.abs().median()):.3e}, worst |err|/tol {worst:.4f} "
            f"(tol: {contract})")
        if not worst <= 1.0 or not bool(torch.isfinite(out.float()).all()):
            fail(f"flash_attention {label} disagrees with its plain version")
        if label.startswith("ragged"):
            continue
        pairs = _band_pairs(s, s, causal, window) * b * h
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        n_flops = 4 * hd * pairs
        q4, k4, v4 = q.view(b, h, s, hd), k.view(b, kv, s, hd), v.view(b, kv, s, hd)
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window)
                                             if window else True)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  enable_gqa=True)

        sdpa_err = float((sdpa().float().reshape(out.shape) - out.float()).abs().max())
        ms = time_cuda(lambda: faops.flash_attention_rows(q, k, v, **args))
        plain = time_cuda(lambda: attention_ref(q, k, v, **args))
        lib = time_cuda(sdpa)
        # the float32 entry runs float32 FMAs on the CUDA cores (no TF32)
        rate, rate_name = ((F32_FLOP_PER_S, "f32 CUDA-core") if dtype == torch.float32
                           else (BF16_FLOP_PER_S, "bf16"))
        bnd, by = bound_ms(n_bytes, n_flops, rate)
        log(f"  flash_attention {label} times: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, scaled_dot_product_attention {lib:.4f} ms (max abs diff to the "
            f"kernel {sdpa_err:.3e}), bound {bnd:.4f} ms ({by}: "
            f"{n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.1f} GFLOP on {pairs} "
            f"(q, k) pairs at the {rate_name} rate)")
        if label != "main":
            row = {"shape": [b, s, h, kv, hd, window], "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": lib}
            shares = dict(TP_FLASH + MOE_TP_FLASH)
            if label in shares or label in dict(DENSE_FLASH + DENSE_FULL_FLASH):
                same = bool(torch.equal(faops.flash_attention_rows(q, k, v, **args), out))
                log(f"  flash_attention {label} second call bit-equal {same}")
                if not same:
                    fail(f"flash_attention {label} is not deterministic")
                (rank_rows if label in shares else dense_rows)[label] = row
            else:
                family_rows[label] = row
            del q, k, v, out, ref, q4, k4, v4
            torch.cuda.empty_cache()
            continue
        rows["flash_attention"] = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "shape": [b, s, h, kv, hd, window],
            "status": "redesigned"}
        del q, k, v, out, ref, q4, k4, v4

    rows["flash_attention_bwd"] = _flash_backward(gen, dev)

    # 8. RG-LRU scan: recurrentgemma-9b's (B, S, d_model), the same at B = 1
    # and at a tensor-parallel rank's 2048 channels (a model axis of 2), and
    # ragged shapes (S past a segment of the kernel, D not a multiple of 32)
    b1_ms = rank_ms = None
    for label, (b, s, d) in (("main", (2, 4096, 4096)), ("b1", (1, 4096, 4096)),
                             ("rank", (2, 4096, 2048)),
                             ("ragged", (3, 37, 31)), ("ragged2", (2, 513, 130)),
                             ("ragged3", (2, 4097, 4096))):
        a = 0.8 + 0.199 * torch.rand((b, s, d), generator=gen, device=dev)
        x = 0.5 * torch.randn((b, s, d), generator=gen, device=dev)
        out, ref = rlops.rglru_scan(a, x), rglru_scan_ref(a, x)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        worst = float(((out - ref).abs() / (RGLRU_TOL + RGLRU_TOL * ref.abs())).max())
        # no atomics, a fixed order of the chunks: a second call, the same bits
        same = bool(torch.equal(rlops.rglru_scan(a, x), out))
        log(f"phase 3: rglru_scan {label} {(b, s, d)}: max abs err {err:.3e}, "
            f"worst |err|/(atol+rtol|ref|) {worst:.4f} (contract {RGLRU_TOL}); "
            f"second call bit-equal {same}")
        if worst > 1.0:
            fail(f"rglru_scan {label} disagrees with its plain version")
        if not same:
            fail(f"rglru_scan {label} is not deterministic")
        n_bytes, n_flops = 3 * 4 * a.numel(), 2 * a.numel()
        if label in ("b1", "rank"):
            ms = time_cuda(lambda: rlops.rglru_scan(a, x))
            b1_ms, rank_ms = (ms, rank_ms) if label == "b1" else (b1_ms, ms)
            log(f"  rglru_scan at {(b, s, d)}: kernel {ms:.4f} ms, bound "
                f"{bound_ms(n_bytes, n_flops)[0]:.4f} ms")
        if label != "main":
            del a, x, out, ref
            continue
        ms = time_cuda(lambda: rlops.rglru_scan(a, x))
        plain = time_cuda(lambda: rglru_scan_ref(a, x))
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"  rglru_scan times: kernel {ms:.4f} ms, plain (log-step scan) "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB)")
        rows["rglru_scan"] = {
            "name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:40",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "shape": [b, s, d],
            "status": "redesigned"}
        del a, x, out, ref
    rows["rglru_scan"]["b1_ms"] = b1_ms
    rows["rglru_scan"]["rank_2048_ms"] = rank_ms
    rows["flash_attention"]["family_shapes"] = family_rows
    rows["flash_attention"]["rank_shapes"] = rank_rows
    rows["flash_attention"]["dense_shapes"] = dense_rows

    # 8, backward: the reversed scan, one more launch of the kernel
    a = (0.8 + 0.199 * torch.rand((2, 4096, 4096), generator=gen, device=dev)
         ).requires_grad_()
    x = (0.5 * torch.randn((2, 4096, 4096), generator=gen, device=dev)).requires_grad_()
    dh = torch.randn((2, 4096, 4096), generator=gen, device=dev)
    rlops.launches = 0
    got = torch.autograd.grad(rlops.rglru_scan(a, x), (a, x), dh)
    n_launch = rlops.launches
    want = torch.autograd.grad(rglru_scan_ref(a, x), (a, x), dh)
    worst = max(float(((g - w).abs() / (RGLRU_TOL + RGLRU_TOL * w.abs())).max())
                for g, w in zip(got, want))
    log(f"phase 3: rglru_scan backward (2, 4096, 4096): {n_launch} launches (forward "
        f"and the reversed scan); worst |err|/(atol+rtol|ref|) {worst:.4f} against "
        f"autograd through the plain version (contract {RGLRU_TOL})")
    if n_launch != 2 or not worst <= 1.0:
        fail("rglru_scan backward disagrees with autograd through its plain version")
    rows["rglru_scan"]["backward_worst"] = worst
    del a, x, dh, got, want

    # 9. SSD chunk scan: mamba2-130m's prefill, the same at a tensor-parallel
    # rank's 12, 6, 2 and 1 heads (a model axis of 2, 4, and 16's uneven
    # shares), and a ragged shape whose chunk halves to 32
    rank_ms = {}
    for label, (b, h, s, p, n, chunk) in (("main", (4, 24, 4096, 64, 128, 64)),
                                          ("heads12", (4, 12, 4096, 64, 128, 64)),
                                          ("heads6", (4, 6, 4096, 64, 128, 64)),
                                          ("heads2", (4, 2, 4096, 64, 128, 64)),
                                          ("heads1", (4, 1, 4096, 64, 128, 64)),
                                          ("ragged", (1, 3, 96, 32, 16, 64))):
        x = torch.randn((b, h, s, p), generator=gen, device=dev)
        dt = 0.001 + 0.099 * torch.rand((b, h, s, 1), generator=gen, device=dev)
        a = -(1.0 + 7.0 * torch.rand((h, 1, 1, 1), generator=gen, device=dev))
        bm = torch.randn((b, 1, s, n), generator=gen, device=dev)
        cm = torch.randn((b, 1, s, n), generator=gen, device=dev)
        args = (x, dt, a, bm, cm)
        q_len = chunk if s % chunk == 0 else 32
        out, ref = sdops.ssd_scan(*args, chunk), ssd_chunk_ref(*args, q_len)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        log(f"phase 3: ssd_chunk {label} (B={b}, H={h}, S={s}, P={p}, N={n}, "
            f"chunk {q_len}): max abs err {err:.3e}, relative {rel:.3e} "
            f"(contract {SSD_REL_TOL})")
        if not rel < SSD_REL_TOL:
            fail(f"ssd_chunk {label} disagrees with its plain version")
        if label.startswith("heads"):
            same = bool(torch.equal(sdops.ssd_scan(*args, chunk), out))
            rank_ms[h] = time_cuda(lambda: sdops.ssd_scan(*args, chunk))
            log(f"  ssd_chunk at a rank's {h} heads: kernel {rank_ms[h]:.4f} ms; second "
                f"call bit-equal {same}")
            if not same:
                fail(f"ssd_chunk {label} is not deterministic")
        if label != "main":
            continue
        # chunk invariance, the reference's 1e-4 (tests/test_kernels_sweep.py:104)
        o128 = sdops.ssd_scan(*args, 128)
        worst = float(((o128 - out).abs() / (1e-4 + 1e-4 * out.abs())).max())
        log(f"  ssd_chunk chunk 64 vs 128: max abs diff "
            f"{float((o128 - out).abs().max()):.3e}, worst |diff|/(atol+rtol|y|) "
            f"{worst:.3f}")
        if not worst <= 1.0:
            fail("ssd_chunk is not chunk-invariant")
        del o128
        # no atomics: a second call gives the same bits
        same = bool(torch.equal(sdops.ssd_scan(*args, chunk), out))
        log(f"  ssd_chunk second call bit-equal to the first: {same}")
        if not same:
            fail("ssd_chunk is not deterministic")
        n_chunks = b * h * (s // chunk)
        n_flops = _ssd_flops(b, h, s, p, n, chunk)
        n_bytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + 2 * bm.numel())
        ms = time_cuda(lambda: sdops.ssd_scan(*args, chunk))
        plain = time_cuda(lambda: ssd_chunk_ref(*args, chunk))
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"  ssd_chunk times: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} "
            f"GFLOP over {n_chunks} chunks)")
        rows["ssd_chunk"] = {
            "name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/ssd_chunk.py:65",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "shape": [b, h, s, p, n, chunk],
            "status": "redesigned"}
        del x, dt, a, bm, cm, args, out, ref
    torch.cuda.empty_cache()
    rows["ssd_chunk"]["rank_heads_ms"] = rank_ms
    # 9b. its backward
    rows["ssd_chunk_bwd"] = _ssd_backward(gen, dev)
    return rows


def phase_pdhg_check():
    """A small batched PDHG solve on the card against scipy/HiGHS."""
    import numpy as np

    from repro_torch.core.clustering import critical_tms
    from repro_torch.core.engine import _pad_tms, routing_solver_for
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.core.graph import uniform_topology
    from repro_torch.core.lp import LpBuilder
    from repro_torch.core.paths import build_paths

    spec = FLEET_SPECS[17]  # F18, 6 pods
    fab = make_fabric(spec)
    tr = make_trace(spec, fab, days=4.0, interval_minutes=60.0)
    cap = fab.capacities(uniform_topology(fab))
    tms = [critical_tms(tr.demand[i * 12: i * 12 + 24], k=4, seed=i, device="cuda")
           for i in range(4)]
    tol = 1e-2
    solver = routing_solver_for(fab, 4, 3000, tol, device="cuda")
    out = solver.solve_routing_batch(np.stack([_pad_tms(t, 4) for t in tms]),
                                     np.stack([cap] * 4), hedging=False)
    paths = build_paths(fab.n_pods)
    worst = 0.0
    for i, t in enumerate(tms):
        u_ref = LpBuilder(fab, paths, t).solve_stage1_fixed_topology(cap).scalar
        worst = max(worst, abs(out["u_star"][i] - u_ref) / u_ref)
    log(f"phase 3: PDHG vs HiGHS stage-1 u* on F18, 4 epochs: worst rel err "
        f"{worst:.3e} (contract ≤ 2·tol = {2 * tol})")
    if not worst <= 2 * tol:
        fail("PDHG u* disagrees with HiGHS")


def sweep_config(days: float = 8.0, interval_minutes: float = 5.0, spec_index=20,
                 **cc_over):
    """The batched engine's configuration: fabric, trace, strategy, configs."""
    from repro_torch.burst import LossConfig
    from repro_torch.core import ControllerConfig, SolverConfig, Strategy
    from repro_torch.core.fleet import (FLEET_SPECS, make_fabric, make_trace,
                                        sub_burst_params)

    spec = FLEET_SPECS[spec_index]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=days, interval_minutes=interval_minutes)
    cc = ControllerConfig(solver_backend="pdhg", backend="torch",
                          loss=LossConfig(burst=sub_burst_params(spec)), **cc_over)
    return fab, trace, Strategy(nonuniform=True, hedging=True), cc, SolverConfig()


def phase_sweep(fab, trace, strategy, cc, sc, device):
    """Run the main path once with the launch counters zeroed around it,
    check it, and return (counts, result)."""
    import torch

    from repro_torch.core import run_controller
    from repro_torch.core.engine import plan_controller
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops

    log(f"phase 4: {fab.name} ({fab.n_pods} pods), trace {trace.demand.shape} "
        f"at {trace.interval_minutes} min, {cc}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    synchronize(device)
    llops.launches = 0
    qlops.launches = 0
    t0 = time.perf_counter()
    res = run_controller(fab, trace, strategy, cc, sc, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.launches, "queueloss": qlops.launches}
    log(f"  sweep wall {wall:.3f} s; n_routing_updates {res.n_routing_updates}, "
        f"n_topology_updates {res.n_topology_updates}")
    log(f"  stage_times {res.stage_times}")
    topo_s = res.solver_seconds - res.stage_times["solve"]
    log(f"  plan: the {res.n_topology_updates} joint topology solves (host, "
        f"scipy/HiGHS) took {topo_s:.3f} s of the plan's "
        f"{res.stage_times['plan']:.3f} s")
    log(f"  summary {res.summary}")
    st = res.solver_stats
    med, mx = _pdhg_iters(st)
    log(f"  PDHG median iterations {med}, max {mx}, capped share "
        f"{st.frac_capped():.4f}, fallbacks {st.n_fallbacks}")
    log(f"  kernel launches in the sweep {counts}")
    if device.type == "cuda":
        log(f"  torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} B")

    if counts["linkload"] < 1 or counts["queueloss"] < 1:
        fail(f"the sweep did not launch both kernels: {counts}")
    plan = plan_controller(trace, cc, strategy.nonuniform)
    _check_result(res, trace.n_intervals - plan.agg, "batched")
    t0 = time.perf_counter()
    worst = _rescore(trace, cc, res, [ep.start for ep in plan.epochs],
                     [ep.stop for ep in plan.epochs])
    log(f"  numpy-oracle re-score ({time.perf_counter() - t0:.2f} s): worst "
        f"|err|/(atol+rtol|ref|) per metric {worst}")
    if max(worst.values()) > 1.0:
        fail("the sweep's scores disagree with the numpy oracle")
    return counts, res


def _rescore(trace, cc, res, starts, stops):
    """Worst |err|/(atol+rtol|ref|) per metric of ``res.metrics`` against the
    float64 numpy oracle on the run's own splits and capacities."""
    import numpy as np

    from repro_torch.core.paths import build_paths, routing_weight_matrices
    from repro_torch.core.simulator import route_metrics_batched

    blocks = [trace.demand[a: b] for a, b in zip(starts, stops)]
    w_b = routing_weight_matrices(build_paths(trace.n_pods), res.splits)
    oracle = route_metrics_batched(
        blocks, w_b, res.capacities, cc.overload_threshold, backend="numpy",
        loss_cfg=cc.loss, loss_seeds=[cc.loss.seed + a for a in starts],
        interval_seconds=trace.interval_minutes * 60.0)
    return {field: float(np.max(np.abs(getattr(res.metrics, field) - r)
                                / (SCORE_TOL + SCORE_TOL * np.abs(r))))
            for field in METRICS for r in [getattr(oracle, field)]}


def _check_result(res, n_intervals, label):
    import numpy as np

    for field in METRICS:
        arr = getattr(res.metrics, field)
        if arr is None or arr.shape != (n_intervals,) or not np.isfinite(arr).all():
            fail(f"{label}: metric {field} is missing, mis-shaped or not finite")
    if not all(np.isfinite(v) for v in res.summary.values()):
        fail(f"{label}: non-finite summary {res.summary}")
    if not 1.0 <= res.summary["p999_stretch"] <= 2.0:
        fail(f"{label}: p999_stretch {res.summary['p999_stretch']} outside [1, 2]")


def _agree(label, on, off, tol):
    """``on`` against the batched engine's ``off`` on the same trace: the
    same counts and final topology; per-epoch u* within 2·tol (both solves
    are certified to tol); p999 ALU within 5·tol and p999 MLU within 0.15.
    The MLU of intervals scored under two certified but different splits is
    not itself certified: 0.15 is the reference's own PDHG-vs-LP controller
    contract (tests/test_core_engine.py:69); the 5·tol of its serve replay
    test (tests/test_serve.py:180) held on F1 but not on F21 (PERF.md)."""
    import numpy as np

    rel = {k: abs(on.summary[k] - off.summary[k]) / max(abs(off.summary[k]), 1e-12)
           for k in on.summary if k.startswith("p999")}
    u_rel = float(np.max(np.abs(on.u_star - off.u_star) / off.u_star))
    mlu_rel = np.abs(on.metrics.mlu - off.metrics.mlu) / off.metrics.mlu
    log(f"  {label} vs batched engine: n_routing {on.n_routing_updates} / "
        f"{off.n_routing_updates}, n_topology {on.n_topology_updates} / "
        f"{off.n_topology_updates}, per-epoch u* worst rel diff {u_rel:.3e}, "
        f"p999 rel diffs {rel}; per-interval MLU rel diff median "
        f"{float(np.median(mlu_rel)):.3e}, max {float(mlu_rel.max()):.3e}, "
        f"share above 5·tol {float((mlu_rel > 5 * tol).mean()):.4f}")
    if (on.n_routing_updates != off.n_routing_updates
            or on.n_topology_updates != off.n_topology_updates
            or not np.array_equal(on.final_topology, off.final_topology)):
        fail(f"{label}: decisions differ from the batched engine")
    if not u_rel <= 2 * tol:
        fail(f"{label}: per-epoch u* differs from the batched engine by "
             f"{u_rel:.3e} (contract {2 * tol})")
    for k, bound in (("p999_alu", 5 * tol), ("p999_mlu", 0.15)):
        if not rel[k] <= bound:
            fail(f"{label}: {k} differs from the batched engine by "
                 f"{rel[k]:.3e} (contract {bound})")


def _pdhg_iters(st):
    import numpy as np

    return ({k: float(np.median(v.iters)) for k, v in st.stages.items()},
            {k: int(np.max(v.iters)) for k, v in st.stages.items()})


def _batched_prefix(res, trace, cc, nonuniform, n_epochs):
    """The batched engine's result ``res`` cut to its first ``n_epochs``
    routing epochs (counts, u*, metrics and their summary), for a run over
    the trace's prefix; it must hold no later topology solve."""
    import dataclasses
    import types

    from repro_torch.core.engine import plan_controller
    from repro_torch.core.simulator import summarize

    epochs = plan_controller(trace, cc, nonuniform).epochs
    n_topo = sum(ep.topo_solve for ep in epochs[:n_epochs])
    if sum(ep.topo_solve for ep in epochs) != n_topo:
        fail("serve: phase 4 solves its topology again after the streamed prefix")
    rows = epochs[n_epochs - 1].stop - epochs[0].start
    metrics = dataclasses.replace(res.metrics, **{
        f: getattr(res.metrics, f)[:rows] for f in METRICS})
    return types.SimpleNamespace(
        n_routing_updates=n_epochs, n_topology_updates=n_topo,
        final_topology=res.final_topology, u_star=res.u_star[:n_epochs],
        metrics=metrics, summary=summarize(metrics))


def phase_serve(fab, trace, strategy, cc, sc, device, days: float = SERVE_DAYS,
                k_critical: int = SERVE_K):
    """The streaming controller with the single-block kernels, on the
    batched engine's configuration at ``k_critical`` critical TMs over the
    trace's first ``days``, held against the same epochs of the batched
    engine's result on the whole trace at the same configuration."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import run_controller
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.serve import ServeConfig, StreamingController, TMStream

    full = trace
    cc = dataclasses.replace(cc, k_critical=k_critical)
    t0 = time.perf_counter()
    batched = run_controller(fab, full, strategy, cc, sc, device=device)
    synchronize(device)
    log(f"phase 5: the batched engine at {k_critical} critical TMs over phase 4's "
        f"trace, the reference: {time.perf_counter() - t0:.3f} s")
    n = int(round(days * 24 * 60 / trace.interval_minutes))
    trace = dataclasses.replace(trace, demand=trace.demand[:n])
    log(f"phase 5: serve {fab.name}, the first {days} days of phase 4's trace "
        f"{trace.demand.shape} at {trace.interval_minutes} min, the configuration "
        f"of phase 4 at {k_critical} critical TMs")
    ctrl = StreamingController(fab, TMStream.from_trace(trace), strategy, cc, sc,
                               serve=ServeConfig(warm_start=True,
                                                 auto_strategy=False),
                               device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    synchronize(device)
    llops.single_launches = 0
    qlops.single_launches = 0
    t0 = time.perf_counter()
    out = ctrl.run()
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.single_launches, "queueloss": qlops.single_launches}
    res = out.result
    q = out.latency_quantiles()
    med, mx = _pdhg_iters(res.solver_stats)
    n_blocks = len(out.decisions)
    log(f"  serve wall {wall:.3f} s, {out.n_intervals} intervals, "
        f"{out.intervals_per_s:.3f} intervals/s, {n_blocks} decisions, "
        f"{res.n_topology_updates} topology solves")
    log(f"  time-to-new-weights p50 {q['p50_s']:.4f} s, p99 {q['p99_s']:.4f} s, "
        f"max {q['max_s']:.4f} s; first decision (joint topology solve) "
        f"{out.latencies_s[0]:.3f} s, routing-only median "
        f"{float(np.median(out.latencies_s[1:])):.4f} s")
    log(f"  stage_times {res.stage_times}")
    log(f"  summary {res.summary}")
    log(f"  PDHG median iterations {med}, max {mx}, capped share "
        f"{res.solver_stats.frac_capped():.4f}, fallbacks "
        f"{res.solver_stats.n_fallbacks}")
    log(f"  single-block kernel launches {counts} for {n_blocks} scored blocks")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    log(f"  torch.cuda.max_memory_allocated {peak} B")
    if counts != {"linkload": n_blocks, "queueloss": n_blocks}:
        fail(f"serve: expected one launch of each single-block kernel per "
             f"scored block ({n_blocks}), got {counts}")
    _check_result(res, trace.n_intervals - ctrl.agg, "serve")
    starts = [d.start for d in out.decisions]
    stops = starts[1:] + [trace.n_intervals]
    worst = _rescore(trace, cc, res, starts, stops)
    log(f"  numpy-oracle re-score: worst |err|/(atol+rtol|ref|) {worst}")
    if max(worst.values()) > 1.0:
        fail("serve: scores disagree with the numpy oracle")
    _agree("serve", res, _batched_prefix(batched, full, cc, strategy.nonuniform,
                                         n_blocks), cc.pdhg_tol)
    return counts, {"wall_s": wall, **q, "intervals_per_s": out.intervals_per_s,
                    "decisions": n_blocks, "pdhg_median_iters": med,
                    "pdhg_max_iters": mx, "peak_bytes": peak}


def phase_sequential(device, days: float = 7.0 + 1.0 / 24.0,
                     baseline_days: float = 14.0, **config):
    """The sequential walk on F21 (uniform topology + hedging) against the
    batched engine, and the whole-trace (uniform, VLB) baseline.  ``config``
    goes to :func:`sweep_config` (a smaller rehearsal on the CPU)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import Strategy, run_controller
    from repro_torch.core.baselines import uniform_vlb_metrics
    from repro_torch.core.engine import plan_controller
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops

    fab, trace, _, cc, sc = sweep_config(days=days, **config)
    strategy = Strategy(nonuniform=False, hedging=True)
    seq_cc = dataclasses.replace(cc, engine="sequential")
    log(f"phase 6: sequential {fab.name}, trace {trace.demand.shape}, "
        f"{strategy.name}")
    llops.single_launches = 0
    qlops.single_launches = 0
    t0 = time.perf_counter()
    res = run_controller(fab, trace, strategy, seq_cc, sc, device=device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.single_launches, "queueloss": qlops.single_launches}
    med, mx = _pdhg_iters(res.solver_stats)
    log(f"  sequential wall {wall:.3f} s, {res.n_routing_updates} epochs, "
        f"stage_times {res.stage_times}")
    log(f"  PDHG median iterations {med}, max {mx}; single-block launches "
        f"{counts}")
    if counts != {"linkload": res.n_routing_updates,
                  "queueloss": res.n_routing_updates}:
        fail(f"sequential: expected one launch of each single-block kernel per "
             f"epoch, got {counts}")
    _check_result(res, trace.n_intervals - plan_controller(trace, cc, False).agg,
                  "sequential")
    t0 = time.perf_counter()
    off = run_controller(fab, trace, strategy, cc, sc, device=device)
    log(f"  batched engine on the same trace: {time.perf_counter() - t0:.3f} s")
    _agree("sequential", res, off, cc.pdhg_tol)

    spec = FLEET_SPECS[config.get("spec_index", 20)]
    full = make_trace(spec, make_fabric(spec), days=baseline_days,
                      interval_minutes=trace.interval_minutes)
    llops.single_launches = 0
    t0 = time.perf_counter()
    vlb = uniform_vlb_metrics(fab, full, backend="torch", device=device)
    wall_vlb = time.perf_counter() - t0
    n_vlb = llops.single_launches
    ref = uniform_vlb_metrics(fab, full, backend="numpy")
    worst = max(float(np.max(np.abs(getattr(vlb, f) - getattr(ref, f))
                             / (SCORE_TOL + SCORE_TOL * np.abs(getattr(ref, f)))))
                for f in ("mlu", "alu", "olr", "stretch"))
    log(f"  uniform+VLB baseline over {full.demand.shape}: {wall_vlb:.3f} s, "
        f"{n_vlb} linkload launch(es), worst |err|/(atol+rtol|ref|) vs numpy "
        f"{worst:.4f}, p999_mlu {vlb.mlu.max():.4f}")
    if n_vlb != 1 or worst > 1.0:
        fail("uniform+VLB baseline: not one whole-trace launch, or disagrees "
             "with the numpy oracle")
    return {"linkload": counts["linkload"] + n_vlb,
            "queueloss": counts["queueloss"]}


def fleet_config(days: float = 8.0, interval_minutes: float = 5.0,
                 spec_indices=None, **cc_over):
    """Phase 7's jobs: every fleet fabric with its own trace, uniform topology
    + hedging, the paper's default controller and one burst-loss
    configuration for all (``cc.loss`` is part of the bucket key, so one
    shared config keeps the fleet in its two padded-pod buckets)."""
    from repro_torch.burst import LossConfig
    from repro_torch.core import ControllerConfig, FleetJob, SolverConfig, Strategy
    from repro_torch.core.fleet import (FLEET_SPECS, make_fabric, make_trace,
                                        sub_burst_params)

    cc = ControllerConfig(solver_backend="pdhg", backend="torch",
                          loss=LossConfig(burst=sub_burst_params(FLEET_SPECS[20])),
                          **cc_over)
    jobs = []
    for i in (range(len(FLEET_SPECS)) if spec_indices is None else spec_indices):
        spec = FLEET_SPECS[i]
        fab = make_fabric(spec)
        jobs.append(FleetJob(fab, make_trace(spec, fab, days=days,
                                             interval_minutes=interval_minutes),
                             Strategy(nonuniform=False, hedging=True), cc,
                             SolverConfig()))
    return jobs


def _agree_fleet(job, fl, off, label: str = "fleet vs per-fabric engine"):
    """A fleet job's result against the per-fabric batched engine's on the
    same trace and config: equal counts, final topology and metric shapes;
    p999 summaries rel ``FLEET_TOL`` (abs 1e-6) and transit fraction abs
    ``FLEET_TOL`` — the reference's fleet contract
    (tests/test_fleet_engine.py:96-115); per-epoch u* rel 2·tol."""
    import numpy as np

    name = job.fabric.name
    rel = {k: abs(fl.summary[k] - off.summary[k]) / max(abs(off.summary[k]), 1e-12)
           for k in fl.summary if k.startswith("p999")}
    u_rel = float(np.max(np.abs(fl.u_star - off.u_star) / off.u_star))
    tf = abs(fl.transit_fraction - off.transit_fraction)
    same_iters = {k: int(np.sum(np.asarray(v.iters)
                                == np.asarray(off.solver_stats.stages[k].iters)))
                  for k, v in fl.solver_stats.stages.items()}
    log(f"  {name} ({job.fabric.n_pods} pods) {label}: "
        f"n_routing {fl.n_routing_updates} / {off.n_routing_updates}, "
        f"per-epoch u* worst rel diff {u_rel:.3e}, transit fraction diff "
        f"{tf:.3e}, p999 rel diffs {rel}; epochs with equal PDHG iterations "
        f"per stage {same_iters}; capped share {fl.solver_stats.frac_capped():.6f} "
        f"/ {off.solver_stats.frac_capped():.6f}")
    if (fl.n_routing_updates != off.n_routing_updates
            or fl.n_topology_updates != off.n_topology_updates
            or not np.array_equal(fl.final_topology, off.final_topology)
            or fl.metrics.mlu.shape != off.metrics.mlu.shape):
        fail(f"fleet {name}: counts, topology or shapes differ from the "
             f"per-fabric engine")
    if not u_rel <= 2 * job.cc.pdhg_tol:
        fail(f"fleet {name}: per-epoch u* differs by {u_rel:.3e}")
    bad = {k: v for k, v in rel.items()
           if abs(fl.summary[k] - off.summary[k]) > FLEET_TOL * abs(off.summary[k]) + 1e-6}
    if bad or tf > FLEET_TOL:
        fail(f"fleet {name}: p999 {bad} / transit fraction {tf:.3e} outside "
             f"the fleet contract {FLEET_TOL}")


def phase_fleet(jobs, device, check=("F21", "F1", "F17")):
    """Run ``jobs`` through the fleet engine once with the fleet kernels'
    counters zeroed around it, check every result, and hold the fabrics
    named in ``check`` against the per-fabric batched engine."""
    import numpy as np
    import torch

    from repro_torch.core import run_controller, run_fleet
    from repro_torch.core.engine import plan_controller
    from repro_torch.core.fleet import fleet_bucket_key
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.obs import SolverStats

    buckets = {}
    for pos, j in enumerate(jobs):
        buckets.setdefault(fleet_bucket_key(j.fabric, j.cc, j.sc, j.trace), []).append(pos)
    log(f"phase 7: fleet of {len(jobs)} fabrics, traces {jobs[0].trace.demand.shape[0]} "
        f"intervals at {jobs[0].trace.interval_minutes} min, {jobs[0].strategy.name}; "
        f"buckets {[(k[0], len(v)) for k, v in buckets.items()]}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    synchronize(device)
    llops.fleet_launches = 0
    qlops.fleet_launches = 0
    t0 = time.perf_counter()
    results = run_fleet(jobs, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.fleet_launches, "queueloss": qlops.fleet_launches}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    plan_s = sum(r.stage_times["plan"] for r in results)
    log(f"  fleet wall {wall:.3f} s: plan {plan_s:.3f} s ({len(jobs)} host plan walks), "
        f"solve {sum(r.stage_times['solve'] for r in results):.3f} s (anchor "
        f"{sum(r.stage_times['anchor'] for r in results):.3f} s), score "
        f"{sum(r.stage_times['score'] for r in results):.3f} s; peak device "
        f"memory {peak} B")
    for key, pos in buckets.items():
        st = SolverStats.merge([results[i].solver_stats for i in pos])
        med, mx = _pdhg_iters(st)
        capped = {jobs[i].fabric.name: round(results[i].solver_stats.frac_capped(), 6)
                  for i in pos if results[i].solver_stats.frac_capped() > 0}
        log(f"  bucket V={key[0]}: {len(pos)} fabrics, "
            f"{sum(results[i].n_routing_updates for i in pos)} PDHG elements, "
            f"solve {sum(results[i].stage_times['solve'] for i in pos):.3f} s, "
            f"anchor {sum(results[i].stage_times['anchor'] for i in pos):.3f} s; "
            f"PDHG median iterations {med}, max {mx}, fallbacks {st.n_fallbacks}, "
            f"capped share per fabric where > 0 {capped}")
    log(f"  fleet kernel launches {counts} for {len(buckets)} buckets")
    if counts != {"linkload": len(buckets), "queueloss": len(buckets)}:
        fail(f"fleet: expected one launch of each fleet kernel per bucket "
             f"({len(buckets)}), got {counts}")
    t0 = time.perf_counter()
    worst = {}
    for j, res in zip(jobs, results):
        plan = plan_controller(j.trace, j.cc, False)
        _check_result(res, j.trace.n_intervals - plan.agg, f"fleet {j.fabric.name}")
        w = _rescore(j.trace, j.cc, res, [ep.start for ep in plan.epochs],
                     [ep.stop for ep in plan.epochs])
        worst = {k: max(worst.get(k, 0.0), v) for k, v in w.items()}
    log(f"  numpy-oracle re-score of all {len(jobs)} jobs "
        f"({time.perf_counter() - t0:.2f} s): worst |err|/(atol+rtol|ref|) "
        f"per metric {worst}")
    if max(worst.values()) > 1.0:
        fail("fleet: scores disagree with the numpy oracle")
    t0 = time.perf_counter()
    for j, res in zip(jobs, results):
        if j.fabric.name in check:
            off = run_controller(j.fabric, j.trace, j.strategy, j.cc, j.sc,
                                 device=device)
            _agree_fleet(j, res, off)
    log(f"  per-fabric checks {list(check)}: {time.perf_counter() - t0:.3f} s")
    p999 = {j.fabric.name: round(r.summary["p999_mlu"], 6)
            for j, r in zip(jobs, results)}
    log(f"  p999 MLU per fabric {p999}; mean p999 loss "
        f"{float(np.mean([r.summary['p999_loss'] for r in results])):.4e}")
    return counts, {"wall_s": wall, "peak_bytes": peak}


# phase 9's critical TMs per joint topology solve: 4 of the paper's 12, which
# cuts the two host joint solves (191.5 s of the 202 s plan walk at 12 on a
# slow host) to keep the whole script inside 70 % of its time limit
TRANSITION_K = 4


def transition_config(days: float = 8.0, interval_minutes: float = 5.0,
                      spec_index=20, topology_interval_days: float = 0.5,
                      k_critical: int = TRANSITION_K, **cc_over):
    """Phase 9's configuration: phase 4's (F21, Gemini, burst loss) with
    ``k_critical`` critical TMs and a topology update every
    ``topology_interval_days`` (two joint solves over the 8-day trace's scored
    day: the gate runs at the second) executed as drain stages over 4 patch
    panels, one interval a stage, every update applied (``decide=False``
    forces the staging)."""
    from repro_torch.transition import TransitionConfig

    return sweep_config(days=days, interval_minutes=interval_minutes,
                        spec_index=spec_index,
                        topology_interval_days=topology_interval_days,
                        k_critical=k_critical,
                        transition=TransitionConfig(n_panels=4, stage_intervals=1,
                                                    decide=False), **cc_over)


def phase_transition(fab, trace, strategy, cc, sc, device):
    """The transition sweep: one plan walk (the joint topology solves and
    the §4.6 gate, whose old/new/stage routing re-solves are one PDHG batch),
    then the batched execute twice on the same plan — as planned, and with
    every epoch's drain staging dropped.  The two give bit-equal splits (the
    same PDHG batch on the same inputs) and bit-equal metrics wherever no
    stage scored: every interval of the unstaged epochs, and the link
    metrics of a staged epoch's remaining intervals (each block is its own
    CTA of kernels #1/#2, so the extra stage blocks move no other block's
    bits; a staged epoch's remainder starts its own queue under its own
    burst seed, so its loss is held to the oracle instead).  A staged
    epoch's intervals are re-scored through the float64 numpy oracle from
    the gate's stage weights and capacities.  Returns the launch counts of
    the planned execute and the phase's times."""
    import dataclasses

    import numpy as np

    from repro_torch.core.engine import execute_plan, plan_artifacts
    from repro_torch.core.paths import build_paths, routing_weight_matrices
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.core.simulator import route_metrics_batched
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.transition import stage_partition

    log(f"phase 9: transition sweep {fab.name} ({fab.n_pods} pods), trace "
        f"{trace.demand.shape} at {trace.interval_minutes} min, {cc}")
    batches = []  # the PDHG batches of the plan walk: the gate's
    solve_batch = TorchRoutingSolver.solve_routing_batch

    def counted(self, tms, caps, *args, **kwargs):
        batches.append(int(np.shape(caps)[0]))
        return solve_batch(self, tms, caps, *args, **kwargs)

    TorchRoutingSolver.solve_routing_batch = counted
    t0 = time.perf_counter()
    try:
        art = plan_artifacts(fab, trace, strategy, cc, sc, device=device)
    finally:
        TorchRoutingSolver.solve_routing_batch = solve_batch
    synchronize(device)
    t_plan = time.perf_counter() - t0
    staged = [i for i, ev in enumerate(art.staging) if ev is not None]
    log(f"  plan walk {t_plan:.3f} s: {art.n_topology} topology updates "
        f"({art.plan.n_topology} joint solves, {art.solver_seconds - art.transition_seconds:.3f} s), "
        f"gate {art.transition_seconds:.3f} s in {len(batches)} PDHG batch(es) of "
        f"{batches} elements; staged epochs {staged}")
    for e in art.transition_log:
        log(f"  transition {e}")
    if art.plan.n_topology < 2 or not art.transition_log or not staged:
        fail(f"transition: expected two joint solves and a staged update, got "
             f"{art.plan.n_topology} solves, log {art.transition_log}")
    for i in staged:
        ev = art.staging[i]
        if ev.n_stages < 1 or not np.isfinite(ev.stage_u).all():
            fail(f"transition: epoch {i} has {ev.n_stages} stages, u {ev.stage_u}")
    if len(batches) != len(art.transition_log):
        fail(f"transition: expected one PDHG batch per evaluated update, got {batches}")

    runs, counts, walls = {}, {}, {}
    for label, a in (("staged", art),
                     ("unstaged", dataclasses.replace(
                         art, staging=(None,) * len(art.staging)))):
        synchronize(device)
        llops.launches = qlops.launches = 0
        llops.single_launches = qlops.single_launches = 0
        t0 = time.perf_counter()
        runs[label] = execute_plan(fab, trace, strategy, cc, sc, a, device=device)
        synchronize(device)
        walls[label] = time.perf_counter() - t0
        counts[label] = {"linkload": llops.launches, "queueloss": qlops.launches,
                         "single": llops.single_launches + qlops.single_launches}
        log(f"  execute ({label}) {walls[label]:.3f} s: stage_times "
            f"{runs[label].stage_times}; kernel launches {counts[label]}")
        if counts[label] != {"linkload": 1, "queueloss": 1, "single": 0}:
            fail(f"transition: the {label} execute did not launch #1 and #2 once")
    on, off = runs["staged"], runs["unstaged"]
    _check_result(on, trace.n_intervals - art.plan.agg, "transition")
    same_splits = bool(np.array_equal(on.splits, off.splits))

    # intervals (metric rows) of each staged epoch: its stage spans, then its
    # remainder on the new steady topology
    agg = art.plan.agg
    stage_rows = np.zeros(on.metrics.mlu.shape, bool)
    epoch_rows = np.zeros(on.metrics.mlu.shape, bool)
    w_b = routing_weight_matrices(build_paths(fab.n_pods), on.splits)
    blocks, ws, caps, seeds = [], [], [], []
    for i in staged:
        ep, ev = art.plan.epochs[i], art.staging[i]
        block = trace.demand[ep.start: ep.stop]
        spans, sp_seeds, rem_lo, rem_seed = stage_partition(
            ev, block.shape[0], ep.start, cc.loss.seed)
        for (k, lo, hi), seed in zip(spans, sp_seeds):
            blocks.append(block[lo:hi])
            ws.append(ev.stage_w[k])
            caps.append(ev.stage_caps[k])
            seeds.append(seed)
            stage_rows[ep.start - agg + lo: ep.start - agg + hi] = True
        if rem_lo < block.shape[0]:
            blocks.append(block[rem_lo:])
            ws.append(w_b[i])
            caps.append(art.caps[i])
            seeds.append(rem_seed)
        epoch_rows[ep.start - agg: ep.stop - agg] = True
    oracle = route_metrics_batched(
        blocks, np.stack(ws), np.stack(caps), cc.overload_threshold,
        backend="numpy", loss_cfg=cc.loss, loss_seeds=seeds,
        interval_seconds=trace.interval_minutes * 60.0)
    worst = {f: float(np.max(np.abs(getattr(on.metrics, f)[epoch_rows] - r)
                             / (SCORE_TOL + SCORE_TOL * np.abs(r))))
             for f in METRICS for r in [getattr(oracle, f)]}
    rest = ~epoch_rows
    link = ("mlu", "alu", "olr", "stretch")
    equal_rest = {f: bool(np.array_equal(getattr(on.metrics, f)[rest],
                                         getattr(off.metrics, f)[rest]))
                  for f in METRICS}
    rem_rows = epoch_rows & ~stage_rows
    equal_rem = {f: bool(np.array_equal(getattr(on.metrics, f)[rem_rows],
                                        getattr(off.metrics, f)[rem_rows]))
                 for f in link}
    moved = float(np.max(np.abs(on.metrics.mlu[stage_rows] - off.metrics.mlu[stage_rows])))
    log(f"  staged vs unstaged execute: splits bit-equal {same_splits}; the "
        f"{int(rest.sum())} intervals of unstaged epochs bit-equal per metric "
        f"{equal_rest}; the {int(rem_rows.sum())} remaining intervals of staged "
        f"epochs bit-equal per link metric {equal_rem}; the {int(stage_rows.sum())} "
        f"stage intervals' MLU moved by up to {moved:.4e}")
    log(f"  staged epochs' {int(epoch_rows.sum())} intervals vs the float64 "
        f"oracle from the gate's stage weights and capacities: worst "
        f"|err|/(atol+rtol|ref|) per metric {worst}")
    log(f"  summaries: staged {on.summary}; unstaged {off.summary}")
    if not same_splits:
        fail("transition: the two executes' splits differ")
    if not all(equal_rest.values()) or not all(equal_rem.values()):
        fail("transition: metrics outside the staged spans moved")
    if max(worst.values()) > 1.0:
        fail("transition: staged intervals disagree with the numpy oracle")
    return counts["staged"], {"plan_s": t_plan, "gate_s": art.transition_seconds,
                              "gate_batches": batches,
                              "execute_s": walls["staged"],
                              "execute_unstaged_s": walls["unstaged"],
                              "staged_epochs": staged,
                              "n_stages": [art.staging[i].n_stages for i in staged],
                              "art": art, "staged_result": on}


# phase 9's second walk: the gate deciding (decide=True) on the 9-pod F5,
# a 2.5-day hourly trace, 1-day aggregation, 3-hour routing and a topology
# solve every 12 hours; tests/test_torch_transition.py holds the same walk
# to the reference on the CPU, which applies the first update and skips the
# second
GATE_DECIDE = dict(spec_index=4, days=2.5, interval_minutes=60.0,
                   routing_interval_hours=3.0, topology_interval_days=0.5,
                   aggregation_days=1.0, k_critical=4)
GATE_DECISIONS = [True, False]
# the same walk's gate blending in the worst contingency
# (``FailureConfig.contingency_weight``): under phase 10's failure mix (64
# scenarios, seed 0) the first update's worst contingency has a negative
# benefit, so at weight 0.5 the blend vetoes the update the plain gate
# applies, and skips the second; the walk then evaluates the second from the
# old topology, and the plain rule on its logged benefit and disruption
# still gives ``GATE_DECISIONS`` (the CPU run's)
GATE_CONTINGENCY_WEIGHT = 0.5
GATE_BLENDED_DECISIONS = [False, False]


def phase_gate_decide(device):
    """The §4.6 gate deciding on the card, failure-aware: one plan walk of
    ``GATE_DECIDE`` with ``TransitionConfig(n_panels=4, stage_intervals=1)``
    (``decide`` on) and ``FailureConfig(**FAILURES,
    contingency_weight=GATE_CONTINGENCY_WEIGHT)``, whose gate re-solves each
    evaluated update's old/new/stage routings in one PDHG batch and blends
    its benefit and disruption with their worst over the sampled
    contingencies (``transition_worst_case``, fixed routings re-scored
    under the masks).  Fails unless it applies and skips the updates the
    CPU run does (``GATE_BLENDED_DECISIONS``), and unless the plain rule
    (``should_reconfigure`` on each logged benefit and disruption,
    recomputed on the host) gives ``GATE_DECISIONS``."""
    import numpy as np

    from repro_torch.core import ControllerConfig, SolverConfig, Strategy
    from repro_torch.core.engine import plan_artifacts
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.device import synchronize
    from repro_torch.failures import FailureConfig
    from repro_torch.transition import TransitionConfig, should_reconfigure

    cfg = dict(GATE_DECIDE)
    spec = FLEET_SPECS[cfg.pop("spec_index")]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=cfg.pop("days"),
                       interval_minutes=cfg.pop("interval_minutes"))
    cc = ControllerConfig(solver_backend="pdhg", backend="torch",
                          transition=TransitionConfig(n_panels=4, stage_intervals=1),
                          failures=FailureConfig(
                              **FAILURES, contingency_weight=GATE_CONTINGENCY_WEIGHT),
                          **cfg)
    batches = []
    solve_batch = TorchRoutingSolver.solve_routing_batch

    def counted(self, tms, caps, *args, **kwargs):
        batches.append(int(np.shape(caps)[0]))
        return solve_batch(self, tms, caps, *args, **kwargs)

    TorchRoutingSolver.solve_routing_batch = counted
    t0 = time.perf_counter()
    try:
        art = plan_artifacts(fab, trace, Strategy(True, True), cc, SolverConfig(),
                             device=device)
    finally:
        TorchRoutingSolver.solve_routing_batch = solve_batch
    synchronize(device)
    wall = time.perf_counter() - t0
    decisions = [e["applied"] for e in art.transition_log]
    plain = [should_reconfigure(e["benefit"], e["disruption"]) for e in art.transition_log]
    log(f"phase 9: the gate deciding (decide=True) on {fab.name} ({fab.n_pods} "
        f"pods), trace {trace.demand.shape} at {trace.interval_minutes} min, blending "
        f"the worst of {cc.failures.n_scenarios} contingencies at weight "
        f"{GATE_CONTINGENCY_WEIGHT}: plan walk {wall:.3f} s, {art.plan.n_topology} "
        f"joint solves, gate {art.transition_seconds:.3f} s in PDHG batches of "
        f"{batches}; applied {art.n_topology - 1} and skipped {art.n_skipped} updates; "
        f"decisions {decisions} (the CPU run's {GATE_BLENDED_DECISIONS}), the plain "
        f"rule on the same benefits and disruptions {plain} ({GATE_DECISIONS})")
    for e in art.transition_log:
        log(f"  decision at interval {e['start']}: applied {e['applied']}, "
            f"benefit {e['benefit']:.6f}, disruption {e['disruption']:.6f}, "
            f"u_old {e['u_old']:.6f}, u_new {e['u_new']:.6f}")
    if decisions != GATE_BLENDED_DECISIONS or len(batches) != len(decisions):
        fail(f"gate: decisions {decisions} in PDHG batches {batches}, expected "
             f"{GATE_BLENDED_DECISIONS} in one batch each (the CPU run's)")
    if plain != GATE_DECISIONS:
        fail(f"gate: the plain rule on the logged benefits and disruptions gives "
             f"{plain}, expected {GATE_DECISIONS}")
    return {"wall_s": wall, "gate_s": art.transition_seconds,
            "decisions": decisions, "plain_decisions": plain, "gate_batches": batches}


# phase 10's failure model: a mix of link, trunk, panel and pod
# failures; 64 scenarios for fixed routing, 8 for the re-solve, 16 a fleet job
FAILURES = dict(p_link=0.02, p_trunk=0.01, p_panel=0.1, p_pod=0.02)
CONT_REL_TOL = 1e-3  # fleet vs per-fabric contingency (tests/test_failures.py:152)
BF16_REL_TOL = 0.01  # the reference's bf16 accuracy target (tests/test_solver_precision.py)
# upper limit on a bf16 epoch's u* above f32's: over the worst sound readings
# on F21 (1.60 % on the card, 2.10 % on the CPU sweep; PERF.md §6), so that a
# bf16 path that stops converging crosses it
BF16_EPOCH_REL_LIMIT = 0.03


def _fused_kernel_rows(captured, n_pairs_shape):
    """#5 and #6 on the operands the fused contingency launch gave them:
    against their plain versions, bit for bit against a second call, timed
    beside the plain versions, with their bounds."""
    import torch

    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.linkload.ref import linkload_metrics_fleet_ref
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.kernels.queueloss.ref import queueloss_fleet_ref

    rows = {}
    for name, entry, ref in (
            ("linkload", llops.linkload_fleet, linkload_metrics_fleet_ref),
            ("queueloss", qlops.queueloss_fleet, queueloss_fleet_ref)):
        args = captured[name]
        f, b, t, c = args[0].shape
        e = args[1].shape[3]
        queue = name == "queueloss"
        dead = int((args[2] == 0).sum())  # inv_cap (#5) or cap (#6) of dead links
        live_w_on_dead = float((args[1].sum(dim=2) * (args[2] == 0)).sum())

        def kernel():
            return entry(*args)

        def plain():
            return ref(*args)

        out, want = kernel(), plain()
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, want)
        same = all(torch.equal(x, y) for x, y in zip(kernel(), out))
        ms, plain_ms = time_cuda(kernel), time_cuda(plain)
        fb = f * b
        n_outs = 2 if queue else 4
        n_bytes = 4 * (fb * t * c + fb * c * e + (2 if queue else 1) * fb * e
                       + n_outs * fb * t)
        n_flops = 2 * fb * t * c * e + (6 if queue else 5) * fb * t * e
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"phase 10: {name} (fleet) at the fused contingency shape "
            f"{(f, b, t, c, e)} ({n_pairs_shape}): {dead} dead (pair, link) "
            f"entries carrying {live_w_on_dead:.1f} of W; max abs err {abs_e:.3e}, "
            f"max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) {worst:.3f}; "
            f"second call bit-equal {same}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
            f"{n_flops / 1e6:.1f} MFLOP)")
        if worst > 1.0 or not same or dead == 0 or live_w_on_dead <= 0.0:
            fail(f"failures: {name} (fleet) at the fused shape disagrees with its "
                 f"plain version, is not deterministic, or saw no dead link "
                 f"carrying W")
        rows[name] = {"shape": [f, b, t, c, e], "max_abs_err": abs_e, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}
    return rows


def phase_failures(fab, trace, strategy, cc, sc, art, staged, device):
    """Failure contingencies and bf16 PDHG on phase 9's plan (no new joint
    solve): (1) ``execute_plan`` with 64 fixed-routing scenarios — its
    metrics and splits bit-equal to phase 9's staged execute, its one fused
    launch of #5/#6 against the per-scenario loop of #1/#2 and the float64
    oracle; (2) #5/#6 at that fused shape on the plan's own operands (dead
    links carrying live W) against their plain versions; (3) re-solve mode
    (8 scenarios: one PDHG batch over scenario × block) no worse than fixed
    routing; (4) the fleet engine with 16 scenarios on F21, F1 and F17
    against the per-fabric engine; (5) the execute with bf16 PDHG against
    f32 (its reported u the float32 evaluation of its flows; every epoch's
    u* between the f32 solve's certified bound and 3 % above f32's; the
    p99.9 MLU under the solved routing within 1 % of f32's; the time per
    iteration reported).  Returns the fleet kernels' launches in (1) and
    the phase's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import run_controller, run_fleet
    from repro_torch.core.engine import execute_plan, plan_score_blocks
    from repro_torch.core.paths import build_paths, routing_weight_matrices
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.core.simulator import p999, route_metrics_batched
    from repro_torch.device import synchronize
    from repro_torch.failures import (FailureConfig, contingency_metrics,
                                      report_from_metrics, sample_masks)
    from repro_torch.transition import stage_partition
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops

    fcfg = FailureConfig(n_scenarios=64, **FAILURES)
    cc_f = dataclasses.replace(cc, failures=fcfg)
    log(f"phase 10: failure contingencies on phase 9's plan ({fab.name}, "
        f"{len(art.plan.epochs)} epochs), {fcfg}")
    out = {}

    # (1) fixed routing: the main path, counts zeroed around it
    torch.cuda.reset_peak_memory_stats()
    synchronize(device)
    llops.launches = qlops.launches = 0
    llops.fleet_launches = qlops.fleet_launches = 0
    t0 = time.perf_counter()
    res = execute_plan(fab, trace, strategy, cc_f, sc, art, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.fleet_launches, "queueloss": qlops.fleet_launches}
    batched = {"linkload": llops.launches, "queueloss": qlops.launches}
    rep = res.contingency
    peak = torch.cuda.max_memory_allocated()
    log(f"  execute with {fcfg.n_scenarios} fixed-routing scenarios {wall:.3f} s: "
        f"stage_times {res.stage_times}; launches: fleet {counts}, batched "
        f"{batched}; peak device memory {peak} B")
    log(f"  report: worst / mean p99.9 MLU {rep.worst_p999_mlu:.6f} / "
        f"{float(rep.p999_mlu.mean()):.6f}, worst / mean p99.9 loss "
        f"{rep.worst_p999_loss:.6e} / {float(rep.p999_loss.mean()):.6e}; failed "
        f"links per scenario min {int(rep.n_failed_links.min())} max "
        f"{int(rep.n_failed_links.max())}")
    if counts != {"linkload": 1, "queueloss": 1} or batched != {
            "linkload": 1, "queueloss": 1}:
        fail(f"failures: expected one launch each of #1/#2 (scoring) and of "
             f"#5/#6 (the contingencies), got {batched} / {counts}")
    same_splits = bool(np.array_equal(res.splits, staged.splits))
    same_metrics = {f: bool(np.array_equal(getattr(res.metrics, f),
                                           getattr(staged.metrics, f)))
                    for f in METRICS}
    log(f"  against phase 9's staged execute: splits bit-equal {same_splits}, "
        f"metrics bit-equal {same_metrics}")
    if not same_splits or not all(same_metrics.values()):
        fail("failures: the execute with contingencies moved the plan's own "
             "scores (the failures=None contract)")
    out.update(execute_s=wall, failures_s=res.stage_times["failures"],
               peak_bytes=peak, worst_p999_mlu=rep.worst_p999_mlu,
               worst_p999_loss=rep.worst_p999_loss)

    # the scoring inputs the evaluator saw, rebuilt from the plan
    w_b = routing_weight_matrices(build_paths(fab.n_pods), res.splits)
    blocks, block_w, block_caps, seeds, _ = plan_score_blocks(
        trace, art, w_b, art.caps, cc)
    w_all, caps_all = np.stack(block_w), np.stack(block_caps)
    scen, masks = sample_masks(fab, fcfg)
    kw = dict(loss_cfg=cc.loss, loss_seeds=seeds,
              interval_seconds=trace.interval_minutes * 60.0)
    # (2) the fused launch again, its operands captured for the kernel checks
    captured = {}
    wrapped = {"linkload": (llops, "linkload_fleet"),
               "queueloss": (qlops, "queueloss_fleet")}
    originals = {k: getattr(m, n) for k, (m, n) in wrapped.items()}
    for key, (mod, attr) in wrapped.items():
        def keep(*args, _key=key):
            captured[_key] = args
            return originals[_key](*args)
        setattr(mod, attr, keep)
    try:
        synchronize(device)
        t0 = time.perf_counter()
        fused = contingency_metrics(blocks, w_all, caps_all, masks,
                                    cc.overload_threshold, backend="torch",
                                    device=device, **kw)
        synchronize(device)
        t_fused = time.perf_counter() - t0
    finally:
        for key, (mod, attr) in wrapped.items():
            setattr(mod, attr, originals[key])
    again = report_from_metrics(scen, fused, resolve=False)
    if not (np.array_equal(again.p999_mlu, rep.p999_mlu)
            and np.array_equal(again.p999_loss, rep.p999_loss)):
        fail("failures: the fused call does not reproduce the execute's report")
    kernel_rows = _fused_kernel_rows(
        captured, f"{fcfg.n_scenarios} scenarios x {len(blocks)} blocks")
    captured.clear()
    torch.cuda.empty_cache()
    # the per-scenario loop on #1/#2 and the float64 oracle
    t0 = time.perf_counter()
    loop_worst = 0.0
    for k in range(fcfg.n_scenarios):
        loop = route_metrics_batched(
            blocks, w_all, caps_all * masks[k][None, :], cc.overload_threshold,
            backend="torch", device=device, **kw)
        loop_worst = max(loop_worst, max(
            float(np.max(np.abs(getattr(fused[k], f) - getattr(loop, f))))
            for f in METRICS))
    t_loop = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = contingency_metrics(blocks, w_all, caps_all, masks,
                                 cc.overload_threshold, backend="numpy", **kw)
    t_oracle = time.perf_counter() - t0
    oracle_worst = {f: max(float(np.max(np.abs(getattr(a, f) - getattr(o, f))
                                        / (SCORE_TOL + SCORE_TOL
                                           * np.abs(getattr(o, f)))))
                           for a, o in zip(fused, oracle))
                    for f in METRICS}
    log(f"  fused call {t_fused:.3f} s; per-scenario loop of "
        f"{fcfg.n_scenarios} route_metrics_batched calls ({t_loop:.3f} s): worst "
        f"|fused - loop| {loop_worst:.3e}; float64 oracle ({t_oracle:.3f} s): worst "
        f"|err|/(atol+rtol|ref|) per metric {oracle_worst}")
    if loop_worst > SCORE_TOL or max(oracle_worst.values()) > 1.0:
        fail("failures: the fused contingency launch disagrees with the "
             "per-scenario loop or the numpy oracle")
    out.update(fused_s=t_fused, loop_s=t_loop, oracle_s=t_oracle)

    # (3) re-solve mode: one PDHG batch over (scenario x block)
    fc8 = FailureConfig(n_scenarios=8, resolve=True, **FAILURES)
    batches = []
    solve_batch = TorchRoutingSolver.solve_routing_batch

    def counted(self, tms, caps, *args, **kwargs):
        batches.append(int(np.shape(caps)[0]))
        return solve_batch(self, tms, caps, *args, **kwargs)

    TorchRoutingSolver.solve_routing_batch = counted
    synchronize(device)
    t0 = time.perf_counter()
    try:
        res_r = execute_plan(fab, trace, strategy,
                             dataclasses.replace(cc, failures=fc8), sc, art,
                             device=device)
    finally:
        TorchRoutingSolver.solve_routing_batch = solve_batch
    synchronize(device)
    t_rs = time.perf_counter() - t0
    scen8, masks8 = sample_masks(fab, fc8)
    fixed8 = report_from_metrics(
        scen8, contingency_metrics(blocks, w_all, caps_all, masks8,
                                  cc.overload_threshold, backend="torch",
                                  device=device, **kw), resolve=False)
    log(f"  re-solve execute {t_rs:.3f} s (failures stage "
        f"{res_r.stage_times['failures']:.3f} s): PDHG batches {batches}, "
        f"{res_r.contingency.n_fallbacks} scipy fallbacks; worst p99.9 MLU "
        f"re-solved {res_r.contingency.worst_p999_mlu:.6f} vs fixed routing "
        f"{fixed8.worst_p999_mlu:.6f} on the same 8 scenarios")
    if not (res_r.contingency.resolve and len(batches) == 2
            and batches[1] == fc8.n_scenarios * len(blocks)):
        fail(f"failures: re-solve did not run one PDHG batch of "
             f"{fc8.n_scenarios} x {len(blocks)} elements ({batches})")
    if not res_r.contingency.worst_p999_mlu <= fixed8.worst_p999_mlu + 1e-6:
        fail("failures: re-solved routing is worse than fixed routing")
    out.update(resolve_s=res_r.stage_times["failures"],
               resolve_fallbacks=res_r.contingency.n_fallbacks)

    # (4) the fleet engine with contingencies against the per-fabric engine
    jobs = fleet_config(spec_indices=(20, 0, 16), failures=FailureConfig(
        n_scenarios=16, **FAILURES))
    llops.fleet_launches = qlops.fleet_launches = 0
    synchronize(device)
    t0 = time.perf_counter()
    fleet = run_fleet(jobs, device=device)
    synchronize(device)
    t_fleet = time.perf_counter() - t0
    fleet_counts = {"linkload": llops.fleet_launches,
                    "queueloss": qlops.fleet_launches}
    log(f"  fleet of {[j.fabric.name for j in jobs]} with 16 scenarios each "
        f"{t_fleet:.3f} s; fleet kernel launches {fleet_counts} (scoring and "
        f"contingencies, per bucket)")
    t0 = time.perf_counter()
    for j, fl in zip(jobs, fleet):
        off = run_controller(j.fabric, j.trace, j.strategy, j.cc, j.sc,
                             device=device)
        rel = {k: abs(fl.summary[k] - off.summary[k]) / max(abs(off.summary[k]), 1e-12)
               for k in ("cont_worst_p999_mlu", "cont_mean_p999_mlu")}
        log(f"  {j.fabric.name} fleet vs per-fabric contingencies: fleet "
            f"{fl.contingency.worst_p999_mlu:.6f} / {float(fl.contingency.p999_mlu.mean()):.6f}, "
            f"per-fabric {off.contingency.worst_p999_mlu:.6f} / "
            f"{float(off.contingency.p999_mlu.mean()):.6f}; rel diffs {rel}")
        if max(rel.values()) > CONT_REL_TOL:
            fail(f"failures: fleet {j.fabric.name} contingencies outside rel "
                 f"{CONT_REL_TOL} of the per-fabric engine")
    log(f"  per-fabric checks {time.perf_counter() - t0:.3f} s")
    out.update(fleet_s=t_fleet)

    # (5) bf16 PDHG on the same plan against f32 (phase 9's staged execute).
    # Held: the reported u is the float32 evaluation of the flows; every
    # epoch's u* lies between the f32 solve's certified lower bound
    # u*(1 - tol) and BF16_EPOCH_REL_LIMIT above f32's (the reference's 1 %
    # per epoch is out of reach on F21: the bf16 iterate stalls above it,
    # PERF.md); the sweep's p99.9 MLU under the solved routing is within
    # BF16_REL_TOL of f32's; the scores are finite.  Reported: the time per
    # iteration.
    cc_b = dataclasses.replace(cc, solver_precision="bf16")
    synchronize(device)
    t0 = time.perf_counter()
    res_b = execute_plan(fab, trace, strategy, cc_b, sc, art, device=device)
    synchronize(device)
    t_b = time.perf_counter() - t0
    _check_result(res_b, trace.n_intervals - art.plan.agg, "bf16 execute")
    u_rel = (res_b.u_star - staged.u_star) / staged.u_star
    agg = art.plan.agg
    solved = np.ones(res_b.metrics.mlu.shape, bool)  # rows under the solved routing
    for i, ev in enumerate(art.staging):
        if ev is not None:
            ep = art.plan.epochs[i]
            spans = stage_partition(ev, ep.stop - ep.start, ep.start,
                                    cc.loss.seed)[0]
            for _, lo, hi in spans:
                solved[ep.start - agg + lo: ep.start - agg + hi] = False
    p999_f32 = p999(staged.metrics.mlu[solved])
    p999_rel = (p999(res_b.metrics.mlu[solved]) - p999_f32) / p999_f32
    med_b, _ = _pdhg_iters(res_b.solver_stats)
    med_f, _ = _pdhg_iters(staged.solver_stats)
    tms, caps = art.tms_padded(cc.k_critical), art.caps
    per_iter, s1 = {}, None
    for precision in ("f32", "bf16"):
        # the stage-1 loop at a fixed count (tol 0: no element exits early)
        solver = TorchRoutingSolver(fab, cc.k_critical, max_iters=300, tol=0.0,
                                    precision=precision, device=device)
        d3, ic = solver._dense_tms(tms), solver._dense_inv_cap(caps)
        valid = solver.valid.expand(caps.shape[0], -1, -1, -1)
        inits = solver._mlu_inits(d3, ic, valid)
        solver._mlu_core(d3, ic, valid, *inits)  # warm-up
        synchronize(device)
        t0 = time.perf_counter()
        solver._mlu_core(d3, ic, valid, *inits)
        synchronize(device)
        per_iter[precision] = (time.perf_counter() - t0) / 300 * 1e3
    # the stage-1 u a bf16 solve reports is the float32 evaluation of its flows
    solver = TorchRoutingSolver(fab, cc.k_critical, max_iters=cc.pdhg_max_iters,
                                tol=cc.pdhg_tol, precision="bf16", device=device)
    s1 = solver.solve_routing_batch(tms, caps, hedging=False, skip_stage3=True)
    f3 = torch.zeros((caps.shape[0], solver.V ** 3), device=device)
    f3[:, torch.as_tensor(solver._path_slot, device=device)] = torch.from_numpy(
        s1["f"].astype(np.float32)).to(device)
    u32 = solver._util_f32(f3.reshape((-1,) + (solver.V,) * 3),
                           solver._dense_tms(tms), solver._dense_inv_cap(caps))
    u_is_f32 = bool(np.array_equal(
        u32.reshape(caps.shape[0], -1).amax(1).cpu().numpy().astype(np.float64),
        s1["u_star"]))
    above_bound = float((res_b.u_star / (staged.u_star * (1 - cc.pdhg_tol))).min())
    capped = float(np.mean(np.asarray(res_b.solver_stats.stages["stage1"].iters)
                           >= cc.pdhg_max_iters))
    log(f"  bf16 PDHG execute {t_b:.3f} s: solve {res_b.stage_times['solve']:.3f} s "
        f"(anchor {res_b.stage_times['anchor']:.3f} s) vs f32 "
        f"{staged.stage_times['solve']:.3f} s (anchor "
        f"{staged.stage_times['anchor']:.3f} s); median iterations bf16 {med_b}, "
        f"f32 {med_f}; bf16 stage 1 capped at {cc.pdhg_max_iters} in "
        f"{capped:.3f} of the epochs; stage-1 loop per iteration at B = "
        f"{caps.shape[0]}: f32 {per_iter['f32']:.3f} ms, bf16 "
        f"{per_iter['bf16']:.3f} ms")
    log(f"  bf16 vs f32 per-epoch u*: rel diff median {float(np.median(u_rel)):.3e}, "
        f"max {float(u_rel.max()):.3e}, min {float(u_rel.min()):.3e}, share within "
        f"1 % {float(np.mean(np.abs(u_rel) <= BF16_REL_TOL)):.3f}; p99.9 MLU over the "
        f"{int(solved.sum())} intervals under the solved routing rel diff "
        f"{p999_rel:.3e}; min u*_bf16 / (u*_f32 (1 - tol)) {above_bound:.6f}; "
        f"stage-1 u is the f32 evaluation of the flows {u_is_f32}")
    if not u_is_f32 or above_bound < 1.0 - 1e-6:
        fail("failures: a bf16 u is not the float32 evaluation of its flows, or "
             "falls below the f32 solve's certified lower bound")
    if float(u_rel.max()) > BF16_EPOCH_REL_LIMIT:
        fail(f"failures: a bf16 epoch's u* lies {float(u_rel.max()):.3e} above "
             f"f32's, over the {BF16_EPOCH_REL_LIMIT} limit")
    if abs(p999_rel) > BF16_REL_TOL:
        fail(f"failures: the bf16 sweep's p99.9 MLU is {p999_rel:.3e} off f32's, "
             f"outside {BF16_REL_TOL}")
    out.update(bf16_solve_s=res_b.stage_times["solve"],
               f32_solve_s=staged.stage_times["solve"], bf16_iters=med_b,
               f32_iters=med_f, per_iter_ms=per_iter,
               u_rel_max=float(u_rel.max()), p999_rel=p999_rel)
    return counts, kernel_rows, out


def phase_autotune(device, spec_index: int = 20, m: int = 12, n_check: int = 4,
                   days: float = 8.0, interval_minutes: float = 5.0):
    """The autotune table on the card (phase 11), in a temporary cache:
    ``tune_solver`` at F21's shape (V = 12, m = 12) with ``reps=1``; a fresh
    ``TorchRoutingSolver(dual_topk=None)`` resolves the recorded knob and
    ``REPRO_AUTOTUNE=0`` pins 128; one batch of ``n_check`` F21 epochs
    solved under each knob, both held to HiGHS's stage-1 u* at 2·tol.  The
    search's solves stop at ``TUNE_MAX_ITERS``: its random inputs take every
    candidate to the solver's 3,000-iteration cap (PERF.md), 7-11 s a solve
    on the card, which the CLI pays and this phase's budget does not."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.clustering import critical_tms
    from repro_torch.core.engine import _pad_tms
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.core.graph import uniform_topology
    from repro_torch.core.lp import LpBuilder
    from repro_torch.core.paths import build_paths
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.kernels import autotune

    spec = FLEET_SPECS[spec_index]
    fab = make_fabric(spec)
    saved = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE_CACHE", "REPRO_AUTOTUNE")}
    out = {}
    with tempfile.TemporaryDirectory() as cache:
        os.environ["REPRO_AUTOTUNE_CACHE"] = cache
        os.environ.pop("REPRO_AUTOTUNE", None)
        autotune.reset_table()
        try:
            t0 = time.perf_counter()
            entry = autotune.tune_solver(fab, m, reps=1, max_iters=TUNE_MAX_ITERS,
                                         device=device)
            out["tune_s"] = time.perf_counter() - t0
            knob = entry["dual_topk"]
            log(f"phase 11: tune_solver on {fab.name} (V={fab.n_pods}, m={m}) in "
                f"{out['tune_s']:.3f} s, key {autotune.solver_key(fab.n_pods, m, device)}: "
                f"{json.dumps(entry)}")
            fresh = TorchRoutingSolver(fab, m, device=device).dual_topk
            os.environ["REPRO_AUTOTUNE"] = "0"
            pinned = TorchRoutingSolver(fab, m, device=device).dual_topk
            os.environ.pop("REPRO_AUTOTUNE")
            log(f"  a fresh TorchRoutingSolver(dual_topk=None) resolves {fresh}; "
                f"with REPRO_AUTOTUNE=0 {pinned}")
            if fresh != knob or pinned != autotune.DEFAULT_SOLVER_KNOBS["dual_topk"]:
                fail(f"autotune: resolved {fresh} (recorded {knob}), pinned {pinned}")
            # one batch of the fabric's epochs under each knob against HiGHS
            tr = make_trace(spec, fab, days=days, interval_minutes=interval_minutes)
            cap = fab.capacities(uniform_topology(fab))
            step = tr.n_intervals // (n_check + 1)
            tms = [critical_tms(tr.demand[i * step: i * step + step], k=m, seed=i,
                                device=device) for i in range(n_check)]
            paths = build_paths(fab.n_pods)
            u_ref = np.array([LpBuilder(fab, paths, t).solve_stage1_fixed_topology(
                cap).scalar for t in tms])
            tol = 1e-2
            for k in sorted({knob, pinned}):
                solver = TorchRoutingSolver(fab, m, tol=tol, dual_topk=k, device=device)
                t0 = time.perf_counter()
                res = solver.solve_routing_batch(
                    np.stack([_pad_tms(t, m) for t in tms]), np.stack([cap] * n_check),
                    hedging=False, skip_stage3=True)
                wall = time.perf_counter() - t0
                worst = float(np.max(np.abs(res["u_star"] - u_ref) / u_ref))
                log(f"  dual_topk {k}: {n_check} {fab.name} epochs in {wall:.3f} s, stage-1 "
                    f"iterations {res['stats']['stage1']['iters'].tolist()}, worst rel u* "
                    f"err vs HiGHS {worst:.3e} (contract ≤ 2·tol = {2 * tol})")
                if not worst <= 2 * tol:
                    fail(f"autotune: dual_topk {k} disagrees with HiGHS")
                out[f"solve_{k}_s"] = wall
            out["entry"] = entry
        finally:
            for key, val in saved.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            autotune.reset_table()
    return out


def _device_profile(fn, device, top: int = 8):
    """One call of ``fn`` under ``torch.profiler``: the host wall time (ending
    in a synchronize), the summed device time of its kernels, their share of
    the wall time (the device's busy share; on one stream kernels do not
    overlap) and the ``top`` kernels by device time, as (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import synchronize

    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6  # us -> s
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return wall, busy, [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                        for e in kernels[:top]]


def _decode_vs_forward(model, params, full, tokens, cache, **decode_kw):
    """``tokens`` (B, S) decoded one at a time from ``cache`` (updated in
    place) against the forward's logits ``full`` (B, S, V): (max abs err,
    worst |err|/(DECODE_TOL + DECODE_TOL·|ref|))."""
    worst = err = 0.0
    for pos in range(tokens.shape[1]):
        logits, cache = model.decode(params, cache, tokens[:, pos:pos + 1], pos,
                                     **decode_kw)
        d = (logits[:, 0] - full[:, pos]).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (DECODE_TOL * (1 + full[:, pos].abs()))).max()))
    return err, worst


def phase_models(device):
    """Model serving (phase 8): the prefill step of each ``PREFILL`` model at
    full width and depth with the kernel counters zeroed around it, the
    kernels' forward against the plain decode in float32 over
    ``DECODE_LEN`` tokens, and the serving launcher."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.rglru_scan import ops as rlops
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.api import build_model

    wrappers = {"flash_attention": faops, "rglru_scan": rlops, "ssd_chunk": sdops}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def config(arch, dtype=None):
        cfg = get_arch(arch)
        return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg

    def release():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    counts = dict.fromkeys(wrappers, 0)
    out = {}
    gen = torch.Generator(device=device).manual_seed(8)
    for arch, batch, s, expect in PREFILL:
        cfg = config(arch)
        model = build_model(cfg, device)
        release()
        t0 = time.perf_counter()
        params = model.init(0)
        synchronize(device)
        t_init = time.perf_counter() - t0
        tokens = torch.randint(0, cfg.vocab, (batch, s), generator=gen, device=device)
        step = make_prefill_step(model)
        synchronize(device)
        zero_counts()
        t0 = time.perf_counter()
        nxt = step(params, {"tokens": tokens})
        synchronize(device)
        t_step = time.perf_counter() - t0
        got = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens})
        synchronize(device)
        t_fwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        same = bool(torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt))
        n_params = sum(p.numel() for p in params.parameters())
        log(f"phase 8: {cfg.name} prefill ({cfg.dtype}, {n_params} parameters, "
            f"B={batch}, S={s}): init {t_init:.3f} s; prefill step {t_step:.3f} s "
            f"({batch * s / t_step:.1f} tokens/s), warm forward {t_fwd:.3f} s "
            f"({batch * s / t_fwd:.1f} tokens/s); kernel launches {got}; logits "
            f"{tuple(logits.shape)} {logits.dtype}, finite {finite}, last-position "
            f"argmax equals the step's token {same}; peak device memory {peak} B")
        if got != expect:
            fail(f"{cfg.name} prefill: expected kernel launches {expect}, got {got}")
        if logits.shape != (batch, s, cfg.vocab) or not finite or not same:
            fail(f"{cfg.name} prefill: logits mis-shaped, not finite, or not the "
                 f"step's token")
        for k, n in got.items():
            counts[k] += n
        del logits
        wall, busy, top = _device_profile(
            lambda: model.forward(params, {"tokens": tokens}), device)
        log(f"  profiled forward: wall {wall:.3f} s, kernels {busy:.3f} s on the "
            f"device (busy share {busy / wall:.3f}); top kernels (name, ms, "
            f"calls) {[(n, round(ms, 3), c) for n, ms, c in top]}")
        out[arch] = {"init_s": t_init, "prefill_step_s": t_step, "forward_s": t_fwd,
                     "peak_bytes": peak, "params": n_params,
                     "profiled_busy_share": busy / wall}
        del params, tokens, nxt

    # the kernels' forward against the plain token-by-token decode, float32
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch, *_ in PREFILL:
            cfg = config(arch, "float32")
            model = build_model(cfg, device)
            release()
            params = model.init(0)
            tokens = torch.randint(0, cfg.vocab, (2, DECODE_LEN), generator=gen,
                                   device=device)
            t0 = time.perf_counter()
            full = model.forward(params, {"tokens": tokens})
            cache = model.init_cache(2, DECODE_LEN)
            err, worst = _decode_vs_forward(model, params, full, tokens, cache)
            synchronize(device)
            log(f"phase 8: {cfg.name} float32 (TF32 off) decode vs forward, B=2, "
                f"S={DECODE_LEN}: {time.perf_counter() - t0:.3f} s; max abs err "
                f"{err:.3e}, |logits| max {float(full.abs().max()):.3f}, worst "
                f"|err|/(tol+tol|ref|) {worst:.4f} (tol {DECODE_TOL}); peak device "
                f"memory {torch.cuda.max_memory_allocated()} B")
            if not worst <= 1.0:
                fail(f"{cfg.name}: float32 decode disagrees with the forward")
            out[arch]["decode_vs_forward_max_abs_err"] = err
            del params, full, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # the serving launcher with --full and its defaults
    for arch, *_ in PREFILL:
        release()
        zero_counts()
        res = serve(arch, requests=16, batch=4, prompt_len=32, gen_len=32,
                    full=True, device=device)
        got = {k: w.launches for k, w in wrappers.items()}
        log(f"phase 8: serve {json.dumps(res)}; kernel launches {got} (decode "
            f"runs none); peak device memory {torch.cuda.max_memory_allocated()} B")
        if res["requests"] != 16 or res["tokens_generated"] != 16 * 32:
            fail(f"serve {arch}: {res}")
        out[arch]["serve"] = res
    release()
    return counts, out


def phase_families(device):
    """The moe and vlm families (phase 12), bf16, random weights from a
    seed: the prefill step of each ``FAMILY_RUNS`` model with the
    flash-attention counter zeroed around it (exact launches, finite
    logits, tokens/s, peak memory); mixtral's greedy decode through its
    ring cache and its sorted dispatch against the one-hot one on a
    full-width layer; mixtral's reduced config in float32 (TF32 off) at
    window 16, decoded past the window through the ring against the kernels'
    forward; and the serving launcher on internvl2-1b at full size."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe
    from repro_torch.models.api import build_model

    def release():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    gen = torch.Generator(device=device).manual_seed(12)
    launches, out = 0, {}
    for arch, n_layers, batch, s, expect in FAMILY_RUNS:
        full = get_arch(arch)
        cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
        release()
        model = build_model(cfg, device)
        t0 = time.perf_counter()
        params = model.init(0)
        synchronize(device)
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
        n_patch = cfg.frontend_tokens if cfg.family == "vlm" else 0
        b = {"tokens": torch.randint(0, cfg.vocab, (batch, s - n_patch), generator=gen,
                                     device=device)}
        if n_patch:
            b["patches"] = torch.randn((batch, n_patch, cfg.d_model), generator=gen,
                                       device=device).to(torch.bfloat16)
        step = make_prefill_step(model)
        synchronize(device)
        faops.launches = 0
        t0 = time.perf_counter()
        nxt = step(params, b)
        synchronize(device)
        t_step = time.perf_counter() - t0
        got = faops.launches
        t0 = time.perf_counter()
        logits = model.forward(params, b)
        synchronize(device)
        t_fwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        same = bool(torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt))
        log(f"phase 12: {cfg.name} prefill ({cfg.dtype}, {cfg.n_layers} of "
            f"{full.n_layers} layers, {n_params} parameters, {n_bytes} B; B={batch}, "
            f"S={s}{f' = {n_patch} patches + {s - n_patch} tokens' if n_patch else ''}): "
            f"init {t_init:.3f} s; prefill step {t_step:.3f} s "
            f"({batch * s / t_step:.1f} tokens/s), warm forward {t_fwd:.3f} s "
            f"({batch * s / t_fwd:.1f} tokens/s); flash-attention launches {got} "
            f"(expected {expect}); logits {tuple(logits.shape)} {logits.dtype}, finite "
            f"{finite}, last-position argmax equals the step's token {same}; peak "
            f"device memory {peak} B")
        if got != expect:
            fail(f"{cfg.name} prefill: expected {expect} flash-attention launches, got {got}")
        if (logits.shape != (batch, s - n_patch, cfg.vocab) or not finite
                or not same):
            fail(f"{cfg.name} prefill: logits mis-shaped, not finite, or not the "
                 f"step's token")
        launches += got
        out[arch] = {"layers": cfg.n_layers, "params": n_params, "init_s": t_init,
                     "prefill_step_s": t_step, "forward_s": t_fwd,
                     "prefill_tokens_per_s": batch * s / t_step, "peak_bytes": peak}
        del logits
        if arch == "mixtral-8x7b":
            release()
            serve_step = make_serve_step(model, ring=True)
            cache = model.init_cache(batch, s + FAMILY_DECODE, window_cache=True)
            ring = cache["blocks"][0]["k"].shape[1]
            tok, toks = nxt, []
            synchronize(device)
            t0 = time.perf_counter()
            for pos in range(FAMILY_DECODE):
                tok, cache = serve_step(params, cache, tok, pos)
                toks.append(tok)
            synchronize(device)
            t_dec = time.perf_counter() - t0
            ok = all(bool(((t >= 0) & (t < cfg.vocab)).all()) for t in toks)
            log(f"  {FAMILY_DECODE} greedy tokens through make_serve_step(ring=True) "
                f"on a {ring}-slot ring: {t_dec:.3f} s ({batch * FAMILY_DECODE / t_dec:.1f} "
                f"tokens/s); peak device memory {torch.cuda.max_memory_allocated()} B")
            if ring != cfg.window or not ok:
                fail(f"{cfg.name} ring decode: ring {ring}, tokens in range {ok}")
            out[arch]["decode_tokens_per_s"] = batch * FAMILY_DECODE / t_dec
            del cache
            # sorted dispatch against one-hot on one full-width layer
            x = torch.randn((1, 2048, cfg.d_model), generator=gen,
                            device=device).to(torch.bfloat16)
            y1, a1 = moe.moe_ffn_onehot(params.blocks[0].moe, x, cfg)
            y2, a2 = moe.moe_ffn_sorted(params.blocks[0].moe, x, cfg)
            rel = float((y1.float() - y2.float()).abs().max() / y1.float().abs().max())
            log(f"  moe_ffn_sorted vs moe_ffn_onehot on layer 0 (T=2048, d="
                f"{cfg.d_model}, E={cfg.n_experts}, top-{cfg.top_k}): max rel diff "
                f"{rel:.3e} (bound {MOE_SORTED_REL_TOL}), aux {float(a1):.6f} / "
                f"{float(a2):.6f}")
            if not rel < MOE_SORTED_REL_TOL or abs(float(a1) - float(a2)) > 1e-5:
                fail(f"{cfg.name}: sorted dispatch disagrees with one-hot")
            out[arch]["sorted_vs_onehot_rel"] = rel
            del x, y1, y2
        del params, model, b, nxt

    # mixtral's reduced config in float32 past its window: ring decode
    # against the kernels' forward
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        release()
        cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), dtype="float32",
                                  window=16)
        model = build_model(cfg, device)
        params = model.init(0)
        tokens = torch.randint(0, cfg.vocab, (2, DECODE_LEN), generator=gen,
                               device=device)
        faops.launches = 0
        full = model.forward(params, {"tokens": tokens})
        launches += faops.launches
        cache = model.init_cache(2, DECODE_LEN, window_cache=True)
        err, worst = _decode_vs_forward(model, params, full, tokens, cache, ring=True)
        log(f"phase 12: {cfg.name} float32 (TF32 off), window {cfg.window}, ring "
            f"decode of {DECODE_LEN} tokens on a {cache['blocks'][0]['k'].shape[1]}-slot "
            f"ring vs the kernels' forward ({faops.launches} flash launches): max abs "
            f"err {err:.3e}, worst |err|/(tol+tol|ref|) {worst:.4f} (tol {DECODE_TOL})")
        if not worst <= 1.0:
            fail(f"{cfg.name}: float32 ring decode disagrees with the forward")
        out["mixtral-reduced-ring"] = {"max_abs_err": err, "worst": worst}
        del params, full, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    release()
    res = serve("internvl2-1b", requests=16, batch=4, prompt_len=32, gen_len=32,
                full=True, device=device)
    log(f"phase 12: serve {json.dumps(res)}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    if res["requests"] != 16 or res["tokens_generated"] != 16 * 32:
        fail(f"serve internvl2-1b: {res}")
    out["internvl2-1b"]["serve"] = res
    release()
    return launches, out


# phase 13: seamless-m4t-large-v2's prefill (B, frames, tokens) and its flash
# launches (24 encoder non-causal + 24 decoder causal + 24 cross); training
# runs: (arch, layers kept, B, S); llama3-8b through the Trainer for
# TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY; the other two
# for SHORT_STEPS steps on one batch (AdamW's first update runs at lr 0, so
# the third step's loss is the first that an update moves)
AUDIO_PREFILL = (4, 1024, 256, 72)
# phase 13's training runs: (arch, layers kept (None = all), batch, sequence
# [, decoder tokens]); mamba2-130m at full size through the Trainer, the
# others at full width, depth cut to fit one card
TRAIN_SSM = ("mamba2-130m", None, 4, 4096)
TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2
SHORT_STEPS = 3
TRAIN_LLAMA = ("llama3-8b", 2, 2, 2048)
TRAIN_HYBRID = ("recurrentgemma-9b", 3, 1, 4096)
TRAIN_AUDIO = ("seamless-m4t-large-v2", 4, 2, 1024, 256)


def _train_flops(cfg, n_params_matmul: int, b: int, s: int) -> float:
    """Model FLOPs of one training step (forward + backward, no remat):
    6 · (parameters in matrix products) · tokens + 3 · the attention's
    forward products (4 · hd a visible (q, k) pair, causal, each layer at its
    own window: gemma3's global layers see every earlier key) or, for the
    ssm family, 3 · the SSD scan's forward products (``_ssd_flops``)."""
    if cfg.family == "ssm":
        from repro_torch.models import ssd

        _, h, n = ssd.dims(cfg)
        mix = _ssd_flops(b, h, s, ssd.HEAD_P, n, cfg.ssd_chunk)
        return 6.0 * n_params_matmul * b * s + 3.0 * mix * cfg.n_layers
    if cfg.family == "hybrid":  # one attention block a super-block, at cfg.window
        windows = [cfg.window] * (cfg.n_layers // 3)
    else:
        from repro_torch.models.transformer import layer_window

        windows = [layer_window(cfg, i) for i in range(cfg.n_layers)]
    pairs = {w: _band_pairs(s, s, True, w) for w in set(windows)}
    attn = 4 * cfg.resolved_head_dim * b * cfg.n_heads * sum(pairs[w] for w in windows)
    return 6.0 * n_params_matmul * b * s + 3.0 * attn


class _BackwardTimer:
    """While active, CUDA events around every call of a backward entry's
    wrapper (``name`` in the ops module ``ops``: #7b's
    ``flash_attention_bwd_rows``, #9b's ``ssd_scan_bwd``): the device time of
    its launches inside training steps, which ride the step's stream between
    the two events."""

    def __init__(self, ops, name: str):
        self._ops, self._name, self.events = ops, name, []

    def __enter__(self):
        import torch

        inner = self._inner = getattr(self._ops, self._name)

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self._ops, self._name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._ops, self._name, self._inner)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _backward_share(name, timer, n_steps, step_ms, smi, tag="phase 13"):
    """Log and return a backward entry's device time a step (the mean over
    the timed steps) against a step's time (the caller's median)."""
    bwd = timer.ms() / n_steps
    log(f"{tag}: {name}: the backward entry (CUDA events around "
        f"{timer._name}, {len(timer.events) // n_steps} calls a step) "
        f"{bwd:.3f} ms a step of the step's {step_ms:.1f} ms: share "
        f"{bwd / step_ms:.4f} ({smi})")
    return {"bwd_ms_per_step": bwd, "step_ms": step_ms, "share": bwd / step_ms}


def _short_train(tag, arch, n_layers, b, s, s_dec=None, *, device, gen, smi=""):
    """``SHORT_STEPS`` bf16 steps of ``arch`` at full width with ``n_layers``
    layers (the encoder-decoder's encoder too) through ``make_train_step``
    (remat, AdamW lr 3e-4) on one random batch (B=``b``, S=``s``; ``s_dec``
    decoder tokens for the audio family): the losses and gradient norms
    finite, the third loss moved by the update, the model kernels' launches
    exact (with remat each attention runs its forward twice and its backward
    once a step, an RG-LRU block its scan twice forward and once backward);
    the step times, tokens/s, model-FLOPs utilisation (``_train_flops`` at
    the median step; the audio family's is not counted), peak memory and
    #7b's device time a step against the step's.  Logged under ``tag``;
    returns the numbers with the launch counts."""
    import numpy as np
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    cfg = _train_cfg(arch, n_layers, None)
    model = build_model(cfg, device)
    params = model.init(0)
    n_params = sum(p.numel() for p in params.parameters())
    opt = AdamW(lr=3e-4, warmup_steps=1)
    state = opt.init(params)
    train = make_train_step(model, opt, StepConfig(remat=True))
    s_dec = s_dec or s
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s_dec), generator=gen,
                                     device=device),
             "labels": torch.randint(0, cfg.vocab, (b, s_dec), generator=gen,
                                     device=device)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=device).to(torch.bfloat16)
    _zero_launches()
    losses, norms, times = [], [], []
    with _BackwardTimer(faops, "flash_attention_bwd_rows") as bwd_timer:
        for _ in range(SHORT_STEPS):
            synchronize(device)
            t0 = time.perf_counter()
            params, state, m = train(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
    got = _launch_counts()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if cfg.family == "hybrid":
        n_attn, n_rec = n_layers // 3, n_layers - n_layers // 3
    else:
        n_attn = (cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
                  else cfg.n_layers)
        n_rec = 0
    expect = {"flash_fwd": SHORT_STEPS * 2 * n_attn, "flash_bwd": SHORT_STEPS * n_attn,
              "rglru": SHORT_STEPS * 3 * n_rec, "ssd": 0, "ssd_bwd": 0}
    n_tok = b * (s + s_dec) if cfg.family == "audio" else b * s
    step_s = float(np.median(times))
    # the tied embedding is the unembedding's matrix product (its gather is not)
    n_matmul = n_params if cfg.tie_embeddings else n_params - cfg.vocab * cfg.d_model
    mfu = (None if cfg.family == "audio"
           else _train_flops(cfg, n_matmul, b, s) / step_s / BF16_FLOP_PER_S)
    log(f"{tag}: {cfg.name} training ({n_layers} layers"
        f"{' + ' + str(n_layers) + ' encoder layers' if cfg.family == 'audio' else ''}"
        f", {n_params} parameters, bf16, B={b}, S={s}"
        f"{f', {s_dec} tokens' if cfg.family == 'audio' else ''}, remat): "
        f"{SHORT_STEPS} steps on one batch, losses {losses}, grad norms {norms}, step "
        f"times {[round(t, 4) for t in times]} s, median {step_s * 1e3:.1f} ms "
        f"({n_tok / step_s:.1f} tokens/s), model-FLOPs utilisation "
        f"{'not counted' if mfu is None else f'{mfu:.4f}'} of "
        f"{BF16_FLOP_PER_S:.3g} FLOP/s bf16 ({smi}); launches {got} (expected "
        f"{expect}); peak device memory {peak} B")
    if got != expect:
        fail(f"{cfg.name} training: launches {got}, expected {expect}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"{cfg.name} training: losses or gradient norms not finite")
    if losses[-1] == losses[-2]:
        fail(f"{cfg.name} training: the update did not move the loss ({losses})")
    share = _backward_share(cfg.name, bwd_timer, SHORT_STEPS, step_s * 1e3, smi, tag)
    del model, params, state, batch
    return {"family": cfg.family, "layers": n_layers, "params": n_params,
            "losses": losses, "grad_norms": norms, "step_times_s": times,
            "step_ms": step_s * 1e3, "tokens_per_s": n_tok / step_s, "mfu": mfu,
            "peak_bytes": peak, "launches": got, "backward_share": share}


def phase_audio_train(device, smi: str = ""):
    """The audio family and training (phase 13), bf16, random weights from a
    seed: seamless-m4t-large-v2's prefill at full size (exact flash launches,
    finite logits, tokens/s, peak memory), ``serve`` of 4 requests and its
    reduced float32 config's decode against its forward; mamba2-130m at full
    size (24 layers, B=4, S=4096) trained through ``Trainer`` for 4 steps,
    keeping the step-2 checkpoint (its parameters moved from the initial
    ones, its moments nonzero), then restarted from step 2 to 4 (the
    restarted losses bit-equal to the uninterrupted run's; exact SSD
    launches: 2·L·steps of #9 with remat, L·steps of #9b; #9b's device time
    a step); llama3-8b at full width (2 of 32 layers), recurrentgemma-9b at
    full width (one super-block) and seamless at 4 + 4 layers, three steps
    each through ``make_train_step`` on one batch, the third loss moved by
    the update (#7 forward and backward, #8 forward and backward, counted;
    #7b's device time a step).
    ``smi`` (the card's name and power limit) goes beside the training times.
    Returns ({"ssd", "ssd_bwd": the mamba2 run's #9 and #9b launches,
    "flash_bwd": the llama3 run's #7b launches, "rglru": the hybrid run's
    RG-LRU launches}, numbers)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import synchronize
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import StepConfig, make_prefill_step
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def release():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    zero, counts = _zero_launches, _launch_counts

    def expected(**launches):
        return {"flash_fwd": 0, "flash_bwd": 0, "rglru": 0, "ssd": 0, "ssd_bwd": 0,
                **launches}

    def save_only(trainer, keep):  # write the one checkpoint the restart reads
        save = trainer._save
        trainer._save = lambda step, *a: save(step, *a) if step == keep else None

    gen = torch.Generator(device=device).manual_seed(13)
    out = {}

    # seamless-m4t-large-v2 serving at full size
    cfg = get_arch("seamless-m4t-large-v2")
    b, s_enc, s_dec, expect = AUDIO_PREFILL
    release()
    model = build_model(cfg, device)
    params = model.init(0)
    n_params = sum(p.numel() for p in params.parameters())
    batch = {"frames": torch.randn((b, s_enc, cfg.d_model), generator=gen,
                                   device=device).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (b, s_dec), generator=gen,
                                     device=device)}
    step = make_prefill_step(model)
    step(params, batch)  # warm
    synchronize(device)
    zero()
    t0 = time.perf_counter()
    nxt = step(params, batch)
    synchronize(device)
    t_step = time.perf_counter() - t0
    got = counts()
    logits = model.forward(params, batch)
    finite = bool(torch.isfinite(logits).all())
    same = bool(torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt))
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 13: {cfg.name} prefill (bf16, {n_params} parameters, B={b}, "
        f"{s_enc} frames + {s_dec} tokens): prefill step {t_step:.3f} s "
        f"({b * (s_enc + s_dec) / t_step:.1f} tokens/s, frames and tokens); launches "
        f"{got} (expected {expect} forward: {cfg.encoder_layers} encoder, "
        f"{cfg.n_layers} causal, {cfg.n_layers} cross); logits {tuple(logits.shape)}, "
        f"finite {finite}, argmax equals the step's token {same}; peak device memory "
        f"{peak} B")
    if got["flash_fwd"] != expect or got["flash_bwd"] or not finite or not same:
        fail(f"{cfg.name} prefill: launches {got}, finite {finite}, same {same}")
    out["seamless_prefill"] = {"step_s": t_step, "tokens_per_s": b * (s_enc + s_dec) / t_step,
                               "peak_bytes": peak, "launches": got["flash_fwd"]}
    del model, params, batch, logits, nxt
    release()
    res = serve(cfg.name, requests=4, batch=4, prompt_len=32, gen_len=16, full=True,
                device=device)
    log(f"phase 13: serve {json.dumps(res)}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    if res["requests"] != 4 or res["tokens_generated"] != 4 * 16:
        fail(f"serve {cfg.name}: {res}")
    out["seamless_serve"] = res

    # the reduced config in float32: decode against the kernels' forward
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        release()
        rcfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        model = build_model(rcfg, device)
        params = model.init(0)
        frames = torch.randn((2, DECODE_LEN, rcfg.d_model), generator=gen, device=device)
        tokens = torch.randint(0, rcfg.vocab, (2, DECODE_LEN), generator=gen, device=device)
        full = model.forward(params, {"frames": frames, "tokens": tokens})
        cache = model.init_cache(2, DECODE_LEN, enc_len=DECODE_LEN)
        with torch.inference_mode():
            cache["enc_out"][:] = encdec.encode(params, frames, rcfg)
        err, worst = _decode_vs_forward(model, params, full, tokens, cache)
        log(f"phase 13: {rcfg.name} float32 (TF32 off) decode vs forward, B=2, "
            f"S={DECODE_LEN}: max abs err {err:.3e}, worst |err|/(tol+tol|ref|) "
            f"{worst:.4f} (tol {DECODE_TOL})")
        if not worst <= 1.0:
            fail(f"{rcfg.name}: float32 decode disagrees with the forward")
        out["seamless_reduced_decode_err"] = err
        del model, params, full, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # mamba2-130m at full size through the Trainer, then a restart
    arch, _, b, s = TRAIN_SSM
    cfg = get_arch(arch)
    release()
    model = build_model(cfg, device)
    opt = AdamW(lr=3e-4, warmup_steps=1)
    data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    (ROOT / "build").mkdir(exist_ok=True)  # the checkpoint, in the checkout
    ckdir = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    try:
        tc = TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY)
        trainer = Trainer(model, opt, None, data, StepConfig(remat=True), tc, ckdir)
        norms, inner = [], trainer._step_fn

        def recording(*args):  # the step's grad norm, which the Trainer drops
            p_, st_, m_ = inner(*args)
            norms.append(m_["grad_norm"])
            return p_, st_, m_

        trainer._step_fn = recording
        save_only(trainer, TRAIN_CKPT_EVERY)
        zero()
        t0 = time.perf_counter()
        with _BackwardTimer(sdops, "ssd_scan_bwd") as bwd_timer:
            run = trainer.run(resume=False)
        t_run = time.perf_counter() - t0
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in run["params"].parameters())
        # the tied embedding is the unembedding's matrix product (its gather
        # is not one); norms, the conv and the SSD's per-head scalars are
        # left in (0.03 % of the parameters)
        n_matmul = n_params if cfg.tie_embeddings else n_params - cfg.vocab * cfg.d_model
        norms = [float(n) for n in norms]
        losses, times = run["losses"], run["stats"]["step_times"]
        del run, trainer, inner, recording
        step_s = float(np.median(times[1:]))
        mfu = _train_flops(cfg, n_matmul, b, s) / step_s / BF16_FLOP_PER_S
        # with remat each block's forward runs twice (the step and the
        # recompute in the backward), its backward once
        expect = expected(ssd=2 * cfg.n_layers * TRAIN_STEPS,
                          ssd_bwd=cfg.n_layers * TRAIN_STEPS)
        log(f"phase 13: {cfg.name} training (all {cfg.n_layers} layers, {n_params} "
            f"parameters, bf16 with the SSD in f32, B={b}, S={s}, remat, AdamW lr 3e-4) "
            f"through Trainer: {TRAIN_STEPS} steps in {t_run:.3f} s with the checkpoint "
            f"at step {TRAIN_CKPT_EVERY}; "
            f"losses {losses}; grad norms {norms}; step times "
            f"{[round(t, 4) for t in times]} s, median after the first "
            f"{step_s * 1e3:.1f} ms = {b * s / step_s:.1f} tokens/s, model-FLOPs "
            f"utilisation {mfu:.4f} of {BF16_FLOP_PER_S:.3g} FLOP/s bf16 ({smi}); "
            f"launches {got} (expected {expect}); peak device memory {peak} B")
        if got != expect:
            fail(f"{cfg.name} training: launches {got}, expected {expect}")
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f"{cfg.name} training: losses or gradient norms not finite")
        if losses[-1] == losses[-2]:
            fail(f"{cfg.name} training: the update did not move the loss ({losses})")
        bwd_share = _backward_share(cfg.name, bwd_timer, TRAIN_STEPS, step_s * 1e3, smi)
        # the checkpoint holds moved parameters and nonzero moments, so the
        # restart below reads an update's state, not the initial weights
        release()
        init = tree_util.as_tree(model.init(0))
        w0 = np.stack([blk["ssd"]["w_in"].float().cpu().numpy() for blk in init["blocks"]])
        del init
        with np.load(ckdir / f"step_{TRAIN_CKPT_EVERY:08d}" / "arrays.npz") as ck:
            moved = float(np.mean(ck["params/blocks/ssd/w_in"] != w0))
            mu_nonzero = float(np.mean(ck["opt/mu/blocks/ssd/w_in"] != 0))
            ck_step = int(ck["opt/step"])
        ck_bytes = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
        log(f"phase 13: the step-{TRAIN_CKPT_EVERY} checkpoint ({ck_bytes} B on disk): "
            f"optimizer step {ck_step}; share of the ssd w_in entries moved from the "
            f"initial weights {moved:.4f}, of its mu entries nonzero {mu_nonzero:.4f}")
        if ck_step != TRAIN_CKPT_EVERY or not moved > 0 or not mu_nonzero > 0:
            fail(f"{cfg.name}: the step-{TRAIN_CKPT_EVERY} checkpoint holds no update "
                 f"(step {ck_step}, moved {moved}, mu nonzero {mu_nonzero})")
        del w0
        t0 = time.perf_counter()
        restart = Trainer(model, opt, None, data, StepConfig(remat=True), tc, ckdir)
        save_only(restart, None)
        zero()
        again = restart.run(resume=True)
        t_restart = time.perf_counter() - t0
        got_restart = counts()
        n_again = TRAIN_STEPS - TRAIN_CKPT_EVERY
        expect_restart = expected(ssd=2 * cfg.n_layers * n_again,
                                  ssd_bwd=cfg.n_layers * n_again)
        equal = again["losses"] == losses[TRAIN_CKPT_EVERY:]
        log(f"phase 13: {cfg.name} restarted from step {TRAIN_CKPT_EVERY}: "
            f"{t_restart:.3f} s; losses {again['losses']}, bit-equal to the "
            f"uninterrupted run's {equal}; restarts {again['stats']['restarts']}; "
            f"launches {got_restart} (expected {expect_restart})")
        if not equal or again["stats"]["restarts"] != 1:
            fail(f"{cfg.name}: the restarted losses differ from the uninterrupted run's")
        if got_restart != expect_restart:
            fail(f"{cfg.name} restart: launches {got_restart}, expected {expect_restart}")
        out["ssm_train"] = {"losses": losses, "grad_norms": norms, "step_times_s": times,
                            "step_ms": step_s * 1e3, "tokens_per_s": b * s / step_s,
                            "mfu": mfu, "peak_bytes": peak, "run_s": t_run,
                            "restart_s": t_restart, "checkpoint_bytes": ck_bytes,
                            "launches": got, "ssd_w_in_moved": moved,
                            "backward_share": bwd_share}
        del again, restart
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del model
    release()

    train_counts = {"ssd": out["ssm_train"]["launches"]["ssd"],
                    "ssd_bwd": out["ssm_train"]["launches"]["ssd_bwd"]}

    # llama3-8b (2 layers), recurrentgemma-9b (one super-block) and seamless
    # (4 + 4 layers): SHORT_STEPS steps each through make_train_step
    for arch, n_layers, b, s, *rest in (TRAIN_LLAMA, TRAIN_HYBRID, TRAIN_AUDIO):
        release()
        rec = _short_train("phase 13", arch, n_layers, b, s, *rest, device=device,
                           gen=gen, smi=smi)
        got = rec["launches"]
        if rec["family"] == "hybrid":
            train_counts["rglru"] = got["rglru"]
        if rec["family"] == "dense":
            train_counts["flash_bwd"] = got["flash_bwd"]
        out[f"{rec['family']}_train"] = rec
    release()
    return train_counts, out


# ---- phase 16: the dense family at its published widths ----------------------

# prefill at full width and depth in bf16: (arch, batch, sequence), one #7
# launch a layer.  gemma3-12b's S = 8192 spans eight of its locals' 1024-key
# windows (weights 23.5 GB, logits 4.3 GB); deepseek-7b is MHA (13.8 GB)
DENSE_RUNS = (("gemma3-12b", 1, 8192), ("deepseek-7b", 2, 4096))
# float32 (TF32 off) decode of DECODE_LEN tokens at B = 2 against the
# kernels' forward, full width, depth cut: (arch, layers kept, window (None:
# the config's)).  gemma3's six layers are one local:global period (0-4
# local, 5 global), its window cut to 16 so that the 64 positions cross it
# (9.4 GB of weights); deepseek's two layers 5 GB
DENSE_DECODE = (("gemma3-12b", 6, 16), ("deepseek-7b", 2, None))
# serve(..., full=True) of each DENSE_RUNS model: (requests, batch, prompt
# tokens, generated tokens), the launcher's defaults but 8 requests, not 16:
# its decode is host-bound (gemma3-12b 103-136 ms a step on one NVIDIA H100
# 80GB HBM3 at 700.00 W, against 7.0 ms to read its weights), and 16 took
# 54.3 s of the script there
DENSE_SERVE = (8, 4, 32, 32)
# SHORT_STEPS bf16 training steps at full width, depth cut to fit one card:
# (arch, layers kept, B, S).  gemma3's six layers are one local:global
# period (2.35 G parameters: bf16 weights, f32 gradient sums and AdamW's two
# moments, the f32 262,144-wide logits and their gradient peak at 48.5 GB
# on an NVIDIA H100 80GB HBM3 at 700.00 W); deepseek's two 1.24 G (23.4 GB)
DENSE_TRAIN = (("gemma3-12b", 6, 1, 4096), ("deepseek-7b", 2, 2, 2048))


def phase_dense(device, smi: str = ""):
    """The dense family at its published widths (phase 16), random weights
    from a seed: gemma3-12b (5:1 local:global attention, 16 query heads on 8
    KV heads at hd 256 with qk-norm, a query width of 4096 against d_model
    3840, a tied 262,144-word vocabulary) and deepseek-7b (MHA: 32 KV
    heads).  (1) The prefill step of each ``DENSE_RUNS`` model at full depth
    in bf16, the kernel counters zeroed around it: one #7 launch a layer and
    no other, finite logits (B, S, vocab), the last position's argmax equal
    to the step's token; init, step and warm-forward seconds, tokens/s, peak
    memory.  (2) ``DENSE_DECODE``: float32 (TF32 off) decode against the
    kernels' forward within ``DECODE_TOL``, gemma3's across its cut window
    and through its global layer.  (3) ``serve(..., full=True)`` of each with
    ``DENSE_SERVE`` (its decode launches no kernel).  (4) ``DENSE_TRAIN``:
    ``SHORT_STEPS`` steps through ``_short_train`` (exact #7 and #7b
    launches, MFU with each layer at its own window, #7b's share of a
    step).  Each run releases its memory before the next.  Returns
    ({"flash_attention": #7's launches, "flash_attention_bwd": #7b's},
    numbers)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import synchronize
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import layer_window

    def release():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    zero, counts = _zero_launches, _launch_counts

    def windows(cfg):
        ws = [layer_window(cfg, i) for i in range(cfg.n_layers)]
        return {w: ws.count(w) for w in sorted(set(ws))}

    t_phase = time.perf_counter()
    none = dict.fromkeys(counts(), 0)
    gen = torch.Generator(device=device).manual_seed(16)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    out = {}

    # (1) prefill at full width and depth
    for arch, batch, s in DENSE_RUNS:
        cfg = get_arch(arch)
        release()
        model = build_model(cfg, device)
        t0 = time.perf_counter()
        params = model.init(0)
        synchronize(device)
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
        tokens = torch.randint(0, cfg.vocab, (batch, s), generator=gen, device=device)
        step = make_prefill_step(model)
        synchronize(device)
        zero()
        t0 = time.perf_counter()
        nxt = step(params, {"tokens": tokens})
        synchronize(device)
        t_step = time.perf_counter() - t0
        got = counts()
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens})
        synchronize(device)
        t_fwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        same = bool(torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt))
        expect = dict(none, flash_fwd=cfg.n_layers)
        log(f"phase 16: {cfg.name} prefill ({cfg.dtype}, all {cfg.n_layers} layers, "
            f"layers a window (0 = global) {windows(cfg)}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads at hd {cfg.resolved_head_dim}, {n_params} "
            f"parameters (the config's count {cfg.param_count()}), {n_bytes} B; "
            f"B={batch}, S={s}): init {t_init:.3f} s; prefill step {t_step:.3f} s "
            f"({batch * s / t_step:.1f} tokens/s), warm forward {t_fwd:.3f} s "
            f"({batch * s / t_fwd:.1f} tokens/s); launches {got} (expected {expect}); "
            f"logits {tuple(logits.shape)} {logits.dtype}, finite {finite}, "
            f"last-position argmax equals the step's token {same}; peak device memory "
            f"{peak} B ({smi})")
        if got != expect:
            fail(f"{cfg.name} prefill: launches {got}, expected {expect}")
        if logits.shape != (batch, s, cfg.vocab) or not finite or not same:
            fail(f"{cfg.name} prefill: logits mis-shaped, not finite, or not the "
                 f"step's token")
        launches["flash_attention"] += got["flash_fwd"]
        out[arch] = {"params": n_params, "param_bytes": n_bytes, "init_s": t_init,
                     "prefill_step_s": t_step, "forward_s": t_fwd,
                     "prefill_tokens_per_s": batch * s / t_step, "peak_bytes": peak}
        del logits, params, model, tokens, nxt, step

    # (2) the kernels' forward against the plain token-by-token decode, float32
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch, n_layers, window in DENSE_DECODE:
            base = get_arch(arch)
            cfg = dataclasses.replace(base, n_layers=n_layers, dtype="float32",
                                      window=base.window if window is None else window)
            release()
            model = build_model(cfg, device)
            params = model.init(0)
            tokens = torch.randint(0, cfg.vocab, (2, DECODE_LEN), generator=gen,
                                   device=device)
            zero()
            t0 = time.perf_counter()
            full = model.forward(params, {"tokens": tokens})
            got = counts()
            cache = model.init_cache(2, DECODE_LEN)
            err, worst = _decode_vs_forward(model, params, full, tokens, cache)
            synchronize(device)
            log(f"phase 16: {cfg.name} float32 (TF32 off) decode vs the kernels' "
                f"forward, B=2, S={DECODE_LEN}, {n_layers} of {base.n_layers} layers, "
                f"window {cfg.window} (the config's {base.window}), layers a window "
                f"{windows(cfg)}: {time.perf_counter() - t0:.3f} s; forward launches "
                f"{got}; max abs err {err:.3e}, |logits| max "
                f"{float(full.abs().max()):.3f}, worst |err|/(tol+tol|ref|) "
                f"{worst:.4f} (tol {DECODE_TOL}); peak device memory "
                f"{torch.cuda.max_memory_allocated()} B")
            if got != dict(none, flash_fwd=n_layers):
                fail(f"{cfg.name} float32 forward: launches {got}")
            if not worst <= 1.0:
                fail(f"{cfg.name}: float32 decode disagrees with the forward")
            launches["flash_attention"] += got["flash_fwd"]
            out[arch]["decode"] = {"layers": n_layers, "window": cfg.window,
                                   "max_abs_err": err, "worst": worst}
            del params, model, full, cache, tokens
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # (3) the serving launcher at full size
    requests, bsz, prompt, n_gen = DENSE_SERVE
    for arch, *_ in DENSE_RUNS:
        release()
        zero()
        res = serve(arch, requests=requests, batch=bsz, prompt_len=prompt,
                    gen_len=n_gen, full=True, device=device)
        got = counts()
        log(f"phase 16: serve {json.dumps(res)}; launches {got} (decode runs none); "
            f"peak device memory {torch.cuda.max_memory_allocated()} B")
        if res["requests"] != requests or res["tokens_generated"] != requests * n_gen:
            fail(f"serve {arch}: {res}")
        if got != none:
            fail(f"serve {arch}: decode launched {got}")
        out[arch]["serve"] = res

    # (4) training steps at full width, depth cut
    for arch, n_layers, b, s in DENSE_TRAIN:
        release()
        rec = _short_train("phase 16", arch, n_layers, b, s, device=device, gen=gen,
                           smi=smi)
        launches["flash_attention"] += rec["launches"]["flash_fwd"]
        launches["flash_attention_bwd"] += rec["launches"]["flash_bwd"]
        out[arch]["train"] = rec
    release()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['seconds']:.1f} s; launches {launches}")
    return launches, out


# ---- phase 14: sharding on one card; the multi-card entry --------------------

# phase 14's fleet: F21, F1 and F17 over 3 routing epochs each (a 7 3/96-day
# trace at 5-minute TMs), so the 12-pod bucket (6 elements) takes the
# round-robin deal at D = 4, the 8-pod one (3) at D = 2 and 4.  Its PDHG
# stages stop at their first check (100 iterations): the check is the
# deal's, and D shards on one card issue D times the launches of one (the
# phase took 116.8 s over 7 epochs uncapped on one H100, PERF.md)
DEAL_DAYS = 7.0 + 3.0 / 96.0
DEAL_SPECS = (20, 0, 16)
DEAL_SHARDS = (2, 4)
DEAL_MAX_ITERS = 100
MESH_STEPS = 3  # training steps of phase 14's one-rank mesh and the multi-card runs
# the multi-card training runs, FSDP alone: (arch, layers kept (None = all),
# global batch (one sequence a card on four), sequence): mamba2-130m at full
# size, llama3-8b and mixtral-8x7b at full width (2 layers; mixtral's bf16
# diff printed, not held), recurrentgemma-9b's first super-block (3 layers)
# and seamless (2 encoder and 2 decoder layers; frames from a seeded
# generator)
MULTI_TRAIN = (("mamba2-130m", None, 4, 4096), ("llama3-8b", 2, 4, 2048),
               ("mixtral-8x7b", 2, 4, 2048), ("recurrentgemma-9b", 3, 4, 2048),
               ("seamless-m4t-large-v2", 2, 4, 1024))
# the FSDP runs whose bf16 run also writes its checkpoints, restores the
# 4-rank one on one card, restarts from step 2 and remeshes to two ranks
# (through ``Trainer.run``, which draws tokens alone, so not seamless; not
# mixtral, whose 31.6 GB of state a checkpoint would write three times;
# recurrentgemma's is 17.1 GB, mamba2-130m's 1.3 GB)
MULTI_TRAIN_RESTART = ("mamba2-130m", "recurrentgemma-9b")
# four ranks against one card on the same global batch.  float32 (TF32 off,
# AdamW eps 1e-3, lr 1e-3): the card-vs-CPU train-step contract of
# tests/test_torch_gpu.py, losses at 1e-5 relative.  bf16 (the models' own
# dtype, phase 13's AdamW): the ranks' GEMMs run at a quarter of the rows and
# the gradients are averaged in float32 after the backward instead of
# summed inside it, so the bits of every bf16 rounding can move; Adam (eps
# 1e-8) can turn an entry whose gradient is within that rounding of zero to
# the other sign.  The bound is one bf16 rounding step of the loss, 2^-8
# relative (the reduced configs on the CPU moved by at most 3.9e-4 in three
# steps)
MULTI_F32_REL, MULTI_BF16_REL = 1e-5, 2.0 ** -8
# the multi-card entry's tensor-parallel runs: (arch, layers kept, global
# batch, sequence, model axis) on make_host_mesh(model_axis=...): llama3-8b at
# full width (Megatron attention — its 32 heads and 8 KV heads split over the
# model axis —, MLP and vocabulary) on 2×2 and 1×4, qwen3-14b on 2×2 (its
# qk-norm scales whole on every rank, their gradients summed over the model
# axis), mamba2-130m on 2×2 (SSD on 12 of its 24 heads a rank, its
# vocabulary Megatron), mixtral-8x7b (2 layers) on 2×2 and 1×4 (expert
# parallelism: 4 and 2 of its 8 experts a rank), recurrentgemma-9b's first
# super-block on 2×2 (RG-LRU on 2048 of its 4096 channels a rank), seamless
# (2 encoder and 2 decoder layers; frames from a seeded generator) on 2×2
# and internvl2-1b at full size on 1×4 (3, 4, 3, 4 of its 14 heads a rank,
# each rank's heads cut from its pair of ranks' tiles; 1792 tokens after
# 256 patch embeddings from a seeded generator: 2048 positions): no leaf
# gathered whole
MULTI_TP = (("llama3-8b", 2, 4, 2048, 2), ("llama3-8b", 2, 4, 2048, 4),
            ("qwen3-14b", 2, 4, 2048, 2), ("mamba2-130m", None, 4, 4096, 2),
            ("mixtral-8x7b", 2, 4, 2048, 2), ("mixtral-8x7b", 2, 4, 2048, 4),
            ("recurrentgemma-9b", 3, 4, 2048, 2), ("seamless-m4t-large-v2", 2, 4, 1024, 2),
            ("internvl2-1b", None, 4, 1792, 4))
# the multi-card entry's decode runs on make_host_mesh(model_axis=...):
# (arch, layers kept (None = all), batch, model axis): llama3-8b at full
# width (2 layers) on 2×2 and 1×4 at B = 4 and on 2×2 at B = 1 (the batch
# cannot take the dp axis: the cache's sequence spans all four cards),
# mamba2-130m at full size (its 24 heads split over the model axis),
# recurrentgemma-9b's first super-block (3 layers: its KV head on both model
# ranks, h and conv split with the RG-LRU weights' channels), seamless with 2
# decoder layers (its encoder output split over T, cross attention on the
# rank's heads) and mixtral-8x7b (2 layers, 4 of its 8 experts a rank), each
# on 2×2, and internvl2-1b at full size on 1×4 (unequal shares of its 14
# heads: q padded to 4 heads a rank for the gather)
MULTI_DECODE = (("llama3-8b", 2, 4, 2), ("llama3-8b", 2, 4, 4), ("llama3-8b", 2, 1, 2),
                ("mamba2-130m", None, 4, 2), ("recurrentgemma-9b", 3, 4, 2),
                ("seamless-m4t-large-v2", 2, 4, 2), ("mixtral-8x7b", 2, 4, 2),
                ("internvl2-1b", None, 4, 4))
# decode_32k's cache length (and encoder length); the KV slots below
# MULTI_DECODE_START and every recurrent state filled from the seed, then
# MULTI_DECODE_STEPS greedy steps on tokens drawn from the seed
MULTI_DECODE_LEN, MULTI_DECODE_START, MULTI_DECODE_STEPS = 32768, 32704, 32
# f32 decode on the mesh: its logits within MULTI_F32_REL of one card's
# decoding the rank's rows, or within this many times the largest move of
# one card's own logits when every cache value is perturbed by one ulp
# (x (1 ± 2^-23)), if that is larger.  A recurrence over random states
# amplifies rounding: one ulp of mamba2-130m's cache moves its 32 steps'
# logits by 2.1e-5 to 4.6e-5 of the largest (full size on the CPU, two
# runs), and its TP step — the gated norm's and w_out's sums split over the
# ranks in each of 24 layers at every step — by 8.0e-5 (4 gloo ranks of the
# CPU; 7.05e-5 on four H100s); llama3's TP decode moves 2e-6
DECODE_F32_FACTOR = 8.0
# bf16 decode on the mesh: its logits' largest error against one card's
# float32 logits at most this many times one card's bf16 error (Megatron's
# partial sums round once a rank: reduced configs on 4 gloo ranks gave
# 0.93-1.20 times, the full-width runs on four H100s 0.99-1.09;
# multicard_decode)
DECODE_BF16_FACTOR = 2.0
# phase 14's one-rank-mesh decode: (arch, layers kept, batch, cache length, steps)
MESH_DECODE = ("llama3-8b", 2, 4, 4096, 8)
# the 4-card entry's moe_full part: the moe family at its published depth
# on make_host_mesh(model_axis=4), which no single card holds (bf16:
# mixtral-8x7b 93.4 GB, dbrx-132b 263.2 GB): (arch, prefills ((dtype,
# sequence) at B = 1), decode dtypes).  mixtral-8x7b: 2 of its 8 experts, 8
# of its 32 heads on 2 of its 8 KV heads and 8,000 words of its vocabulary a
# rank; bf16 prefill at S = 8192 (its 4096 window masking, as phase 12's),
# float32 (TF32 off) at S = 4096, decode_32k in both.  dbrx-132b: 4 of 16
# experts, 12 of 48 heads on 2 of 8, 25,088 words a rank; bf16 prefill at
# S = 4096 and bf16 decode_32k (its float32 weights would take 526 GB).
# Decode: MOE_FULL_DECODE_B sequences, MULTI_DECODE_STEPS steps from
# MULTI_DECODE_START of a MULTI_DECODE_LEN cache filled tile by tile
MOE_FULL = (("mixtral-8x7b", (("bfloat16", 8192), ("float32", 4096)),
             ("bfloat16", "float32")),
            ("dbrx-132b", (("bfloat16", 4096),), ("bfloat16",)))
MOE_FULL_DECODE_B = 4
# a rank's peak device memory while it draws its tiles (``init_tiles``)
# stays under its tiles' bytes, one whole float32 leaf (the model's largest)
# and this many bytes: no rank ever holds the whole model
MOE_DRAW_SLACK = 2e9
# a routing disagreement between the mesh and the one-card truth is a
# near-tie when the truth's gap between its k-th and (k+1)-th router logits
# at that token is under this share of the layer's largest |router logit|
# (ROADMAP §3: a flip at a near-tie is no fault of the arithmetic)
MOE_NEAR_TIE = 1e-5
# the 4-card entry's dense_full part: the dense family at its published
# depth trained with FSDP a block gathered at a time (make_train_step), on
# make_host_mesh(model_axis=...): (arch, dtype, model axis, global batch,
# sequence), MESH_STEPS steps each at DENSE_FULL_MICROBATCHES microbatches
# with remat, each rank's tiles drawn from the seed (Trainer.run).  bf16
# (phase_multicard's bf16 AdamW): gemma3-12b (48 layers, its tied
# 262,144-word table gathered once for both uses) and deepseek-7b (30) on
# 4×1 (FSDP) and 2×2 (FSDP × TP) at S = 4096; float32 (TF32 off, the f32
# AdamW): deepseek-7b on 4×1 and gemma3-12b on 2×2 at S = 2048, each held
# to the one-card truth of step 0 (_dense_truth).  No card trains either:
# the f32 moments alone are 94.1 GB (gemma3-12b) and 55.3 GB (deepseek-7b).
# A rank's activations in these runs, reckoned from the shapes by
# _dense_act_bytes (an upper bound; the head's float32 logits the most):
# 30.20, 32.72, 13.77, 15.85, 8.23 and 20.02 GB, beside a reckoned state of
# 48.57, 44.88, 30.44, 27.31, 35.97 and 51.99 GB (tiles, moments, float32
# gradient tiles, the top-level leaves and one block gathered and their
# float32 gradients): caps of 78.77, 77.59, 44.20, 43.16, 44.20 and 72.00 GB
DENSE_FULL = (("gemma3-12b", "bfloat16", 1, 8, 4096), ("gemma3-12b", "bfloat16", 2, 8, 4096),
              ("deepseek-7b", "bfloat16", 1, 8, 4096), ("deepseek-7b", "bfloat16", 2, 8, 4096),
              ("deepseek-7b", "float32", 1, 8, 2048), ("gemma3-12b", "float32", 2, 8, 2048))
DENSE_FULL_MICROBATCHES = 2
# the float32 runs against the truth: the gradient's norm, each leaf's norm
# and its projection on a seeded ±1 tensor (``_probe``: seed
# DENSE_PROBE_SEED + the leaf's place in tree order) within this share of
# the leaf's norm — or within DECODE_F32_FACTOR × the truth's own move
# when its embedding output is one ulp off (x (1 + 2^-23)), where that is
# larger (f32 decode's mesh rule; the move is computed only where a reading
# passes 1e-4)
DENSE_GRAD_REL = 1e-4
DENSE_PROBE_SEED = 7000


def _fleet_run(jobs, device, mesh):
    """``run_fleet`` once with the fleet kernels' counters zeroed around it:
    (results, wall seconds, launches, buckets)."""
    import torch  # noqa: F401

    from repro_torch.core import run_fleet
    from repro_torch.core.fleet import fleet_bucket_key
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops

    n_buckets = len({fleet_bucket_key(j.fabric, j.cc, j.sc, j.trace) for j in jobs})
    synchronize(device)
    llops.fleet_launches = qlops.fleet_launches = 0
    t0 = time.perf_counter()
    res = run_fleet(jobs, mesh=mesh, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.fleet_launches, "queueloss": qlops.fleet_launches}
    if counts != {"linkload": n_buckets, "queueloss": n_buckets}:
        fail(f"fleet (mesh {mesh}): expected one launch of each fleet kernel per "
             f"bucket ({n_buckets}), got {counts}")
    return res, wall, counts, n_buckets


def _stage_sums(results) -> dict:
    return {k: round(sum(r.stage_times[k] for r in results), 3)
            for k in ("plan", "solve", "anchor", "score")}


def _check_sharded_fleet(label, jobs, base, got) -> bool:
    """Each job's sharded result against the unsharded one: splits, u*, the
    per-stage PDHG iterations and gaps and every interval metric bit for
    bit; where a bit moved, the fleet contract (``FLEET_TOL``,
    ``_agree_fleet``) and the differences logged.  Returns bit-equality."""
    import numpy as np

    diffs = {}
    for j, a, b in zip(jobs, base, got):
        d = {"splits": float(np.max(np.abs(a.splits - b.splits))),
             "u_star": float(np.max(np.abs(a.u_star - b.u_star)))}
        d["iters"] = sum(int(np.sum(np.asarray(st.iters)
                                    != np.asarray(b.solver_stats.stages[k].iters)))
                         for k, st in a.solver_stats.stages.items())
        d["gaps"] = all(np.array_equal(np.asarray(st.gaps),
                                       np.asarray(b.solver_stats.stages[k].gaps),
                                       equal_nan=True)
                        for k, st in a.solver_stats.stages.items())
        d["metrics"] = all(np.array_equal(getattr(a.metrics, m), getattr(b.metrics, m))
                           for m in METRICS)
        if d["splits"] or d["u_star"] or d["iters"] or not d["gaps"] or not d["metrics"]:
            diffs[j.fabric.name] = d
    exact = not diffs
    log(f"  {label}: {len(jobs)} jobs, splits, u*, PDHG iterations and gaps and "
        f"interval metrics bit-equal to the unsharded run: {exact}"
        + ("" if exact else f"; differences {diffs}"))
    if not exact:  # a library op's bits at another batch size: the fleet contract
        for j, a, b in zip(jobs, base, got):
            _agree_fleet(j, b, a, label=f"{label} vs unsharded")
    return exact


def phase_sharding(device, smi: str = ""):
    """Phase 14 on one card: (a) the fleet over F21, F1 and F17 unsharded,
    then dealt over ``fleet_mesh([dev] * D)`` for D = 2 and 4 (D shards on
    the one card, each on its own host thread and stream): the deal, the
    per-shard solves and the inverse permutation held to the unsharded run,
    bit for bit (or, where a library op's bits move with the batch size, the
    fleet contract), and exactly one launch of each fleet kernel a bucket;
    (b) mamba2-130m at full size through ``Trainer`` for ``MESH_STEPS`` steps
    with ``mesh=None`` and on ``make_host_mesh()`` over a one-rank NCCL
    process group (the FSDP step: gathers, reduce-scatters and the sharded
    update, each the identity on one rank): the losses bit-equal, the SSD
    launches exact; then llama3-8b's decode on that mesh against
    ``mesh=None``, bit for bit (:func:`_mesh_decode`).  Returns the
    numbers."""
    import shutil
    import tempfile

    import os
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.launch.train import _free_port
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.sharding import fleet_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    out = {}
    jobs = fleet_config(days=DEAL_DAYS, spec_indices=DEAL_SPECS,
                        pdhg_max_iters=DEAL_MAX_ITERS)
    base, wall, counts, n_buckets = _fleet_run(jobs, device, None)
    sizes = sorted({j.fabric.n_pods for j in jobs})
    log(f"phase 14: fleet of {[j.fabric.name for j in jobs]} ({sizes} pods), "
        f"{[r.n_routing_updates for r in base]} routing epochs, {n_buckets} buckets: "
        f"unsharded {wall:.3f} s, stages {_stage_sums(base)}; launches {counts}")
    out["fleet"] = {"unsharded_s": wall}
    for d in DEAL_SHARDS:
        got, wall, counts, _ = _fleet_run(jobs, device, fleet_mesh([device] * d))
        log(f"phase 14: the same fleet dealt over fleet_mesh([{device}] * {d}): "
            f"{wall:.3f} s, stages {_stage_sums(got)}; launches {counts}")
        out["fleet"][f"D{d}"] = {"s": wall, "bit_equal": _check_sharded_fleet(
            f"D = {d} on one card", jobs, base, got)}

    arch, _, b, s = TRAIN_SSM
    cfg = get_arch(arch)
    model = build_model(cfg, device)
    data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    (ROOT / "build").mkdir(exist_ok=True)

    def train(mesh):
        ckdir = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
        try:
            tr = Trainer(model, AdamW(lr=3e-4, warmup_steps=1), mesh, data,
                         StepConfig(remat=True),
                         TrainerConfig(total_steps=MESH_STEPS, checkpoint_every=10 ** 9),
                         ckdir)
            tr._save = lambda *a: None  # phase 13 and the multi-card entry save
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sdops.launches = sdops.bwd_launches = 0
            run = tr.run(resume=False)
            return (run["losses"], run["stats"]["step_times"],
                    {"ssd": sdops.launches, "ssd_bwd": sdops.bwd_launches},
                    torch.cuda.max_memory_allocated())
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)

    want, t_none, _, _ = train(None)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        losses, times, counts, peak = train(mesh)
        out["mesh_decode"] = _mesh_decode(device, mesh, smi)
    finally:
        dist.destroy_process_group()
    expect = {"ssd": 2 * cfg.n_layers * MESH_STEPS, "ssd_bwd": cfg.n_layers * MESH_STEPS}
    equal = losses == want
    log(f"phase 14: {cfg.name} (B={b}, S={s}) through Trainer on {mesh} (one NCCL "
        f"rank): losses {losses}, bit-equal to mesh=None's {want}: {equal}; step times "
        f"{[round(t, 4) for t in times]} s against {[round(t, 4) for t in t_none]} s; "
        f"launches {counts} (expected {expect}); peak device memory {peak} B ({smi})")
    if not equal:
        fail(f"{cfg.name}: the one-rank mesh's losses differ from mesh=None's")
    if counts != expect:
        fail(f"{cfg.name} on the one-rank mesh: launches {counts}, expected {expect}")
    out["mesh_train"] = {"losses": losses, "step_times_s": times, "launches": counts,
                         "peak_bytes": peak}
    del model
    torch.cuda.empty_cache()
    return out


def _mesh_decode(device, mesh, smi: str = "") -> dict:
    """Phase 14's decode on the one-rank mesh: ``MESH_DECODE``'s model
    (bf16) through ``make_serve_step`` on ``mesh`` (this rank's tiles of the
    parameters and of a cache filled from the seed, ``shard_cache``)
    against ``mesh=None`` on the same cache: every cache axis has one rank,
    so the step takes the unsharded arithmetic, logits and tokens bit for
    bit."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import (cache_tile_shardings, leaf_plans,
                                          make_serve_step, module_like, shard_cache)
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    arch, layers, b, length, steps = MESH_DECODE
    cfg = _train_cfg(arch, layers, None)
    model = build_model(cfg, device)
    params = model.init(0)
    shape = ShapeConfig("decode", length, b, "decode")
    start = length - steps
    whole = _filled_cache(model, b, length, start, 1, device)
    tokens = _decode_tokens(cfg, b, steps, device)
    step = make_serve_step(model, mesh=mesh, logits=True,
                           cache_sh=cache_tile_shardings(mesh, cfg, shape, whole))
    shards = module_like(params, [sh.shard_tensor(x, p.sharding) for x, p in
                                  zip(tree_util.leaves(params), leaf_plans(model, mesh))])
    got, got_tok, t_mesh = _run_decode(step, shards, shard_cache(whole, mesh, cfg, shape),
                                       tokens, start, device)
    want, want_tok, t_none = _run_decode(make_serve_step(model, logits=True), params, whole,
                                         tokens, start, device)
    equal = bool(np.array_equal(got, want) and np.array_equal(got_tok, want_tok))
    ms = (float(np.median(t_mesh[1:])) * 1e3, float(np.median(t_none[1:])) * 1e3)
    log(f"phase 14: {cfg.name} ({layers} layers, bf16) decode, B={b}, cache {length} from "
        f"{start}, {steps} steps on {mesh} (one NCCL rank) against mesh=None: logits and "
        f"tokens bit-equal {equal}; {ms[0]:.3f} vs {ms[1]:.3f} ms a token ({smi})")
    if not equal:
        fail(f"{cfg.name}: the one-rank mesh's decode differs from mesh=None's")
    del params, shards, whole, model
    torch.cuda.empty_cache()
    return {"bit_equal": equal, "ms_a_token": ms[0], "unsharded_ms_a_token": ms[1]}


def _train_cfg(arch, n_layers, dtype):
    """``arch``'s config (a ``-reduced`` suffix: its reduced one, for CPU
    rehearsals) with ``n_layers`` layers (the encoder-decoder's encoder
    too) and ``dtype`` where given."""
    import dataclasses

    from repro_torch.configs import get_arch

    base = arch.removesuffix("-reduced")
    cfg = get_arch(base) if base == arch else get_arch(base).reduced()
    over = {} if n_layers is None else {"n_layers": n_layers}
    if n_layers is not None and cfg.family == "audio":
        over["encoder_layers"] = n_layers
    if dtype is not None:
        over["dtype"] = dtype
    return dataclasses.replace(cfg, **over) if over else cfg


def _state_digest(params, opt_state) -> str:
    """SHA-256 of every leaf's bytes (parameters, step, moments), in order."""
    import hashlib

    import torch

    from repro_torch.optim import tree as tree_util

    h = hashlib.sha256()
    leaves = (tree_util.leaves(params) + [opt_state.step] + tree_util.leaves(opt_state.mu)
              + tree_util.leaves(opt_state.nu))
    for x in leaves:
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _global_batch(cfg, b, s, step, world, device):
    """The global batch of ``step`` whose rank ``r`` slice the pipeline hands
    rank ``r`` of ``world``: the ranks' slices one after another."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, n_hosts=world)
    parts = [SyntheticLM(dataclasses.replace(dc, host_id=h)).batch_at(step)
             for h in range(world)]
    batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(
        device=device, dtype=torch.int64) for k in parts[0]}
    embeds = _EMBEDS.get(cfg.family)
    if embeds is not None:
        batch[embeds[0]] = embeds[1](cfg, b, s, step, device)
    return batch


def _frames(cfg, b, s, step, device):
    """The encoder-decoder's frame embeddings (B, S, d) of ``step`` (the
    token pipeline draws none), from a generator on ``device`` seeded by the
    step: the same values on every card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1000 + step)
    return torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(
        getattr(torch, cfg.dtype))


def _patches(cfg, b, s, step, device):
    """The vlm's patch embeddings (B, frontend_tokens, d) of ``step``, drawn
    as :func:`_frames` draws frames."""
    import torch

    gen = torch.Generator(device=device).manual_seed(2000 + step)
    return torch.randn((b, cfg.frontend_tokens, cfg.d_model), generator=gen,
                       device=device).to(getattr(torch, cfg.dtype))


# the inputs a family's batch takes beside the tokens, which the token
# pipeline does not draw: (key, generator)
_EMBEDS = {"audio": ("frames", _frames), "vlm": ("patches", _patches)}


def _multicard_rank(rank, world, arch, n_layers, b, s, dtype, opt_kw, ckdir, extras,
                    device_type="cuda", model_axis=1):
    """One rank of a multi-card training run (``run_ranks``): ``MESH_STEPS``
    steps through ``Trainer`` on ``make_host_mesh(model_axis)``.  With
    ``extras``: the step-2 and step-3 checkpoints in ``ckdir`` (gathered,
    the first rank writes) and the logical state's digest; on a mesh of
    one model index also a restart from step 2 and a remesh to ranks 0 and 1
    with one step there.  With a model axis, one more step is recorded
    (``record_collectives``) and compared, op for op, with the same step on
    a virtual copy of the mesh on ``meta`` (``Trainer.extract_traffic``).
    Each rank draws its tiles straight from the seed (``init_tiles``, as
    ``Trainer.run`` does)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.rglru_scan import ops as rgops
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, init_tiles
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = _train_cfg(arch, n_layers, dtype)
    model = build_model(cfg, dev)
    mesh = make_host_mesh(model_axis=model_axis)
    data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)

    def trainer():
        tr = Trainer(model, AdamW(**opt_kw), mesh, data, StepConfig(remat=True),
                     TrainerConfig(total_steps=MESH_STEPS, checkpoint_every=2), ckdir)
        if not extras:
            tr._save = lambda *a: None
        return tr

    def counts():
        return {"flash_fwd": faops.launches, "flash_bwd": faops.bwd_launches,
                "rglru": rgops.launches, "ssd": sdops.launches,
                "ssd_bwd": sdops.bwd_launches}

    faops.launches = faops.bwd_launches = sdops.launches = sdops.bwd_launches = 0
    rgops.launches = 0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    tr = trainer()
    embeds = _EMBEDS.get(cfg.family)
    rows = sh.tile_slice(b // mesh.shape["data"], mesh, ("data",))

    def rank_batch(step):  # this rank's dp slice (frames and patches: the
        batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(step))
        if embeds is not None:  # token pipeline draws neither)
            batch[embeds[0]] = embeds[1](cfg, b, s, step, dev)[rows]
        return batch

    if embeds is not None:  # Trainer.run draws tokens alone: its step on the same batches
        params = init_tiles(model, tr._step_fn.plans)
        state = tr.opt.init(params)
        losses, times = [], []
        for i in range(MESH_STEPS):
            batch = rank_batch(i)
            synchronize(dev)
            t0 = time.perf_counter()
            params, state, m = tr._step_fn(params, state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        run = {"params": params, "opt_state": state, "losses": losses,
               "stats": {"step_times": times}}
        del params, state
    else:
        run = tr.run(resume=False)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    shard_bytes = sum(x.numel() * x.element_size() for x in
                      tree_util.leaves(run["params"]) + tree_util.leaves(run["opt_state"].mu)
                      + tree_util.leaves(run["opt_state"].nu))
    out = {"losses": run["losses"], "step_times": run["stats"]["step_times"],
           "peak_bytes": peak, "shard_bytes": shard_bytes, "launches": counts()}
    if model_axis > 1:
        out["modes"] = sorted({pl.mode for pl in tr._step_fn.plans})
    if not extras and model_axis == 1:
        return out
    import pathlib

    ckdir = pathlib.Path(ckdir)
    p, o = tr.logical(run["params"], run["opt_state"])
    out["digest"] = _state_digest(p, o)
    out["logical_bytes"] = sum(x.numel() * x.element_size() for x in
                               tree_util.leaves(p) + tree_util.leaves(o.mu)
                               + tree_util.leaves(o.nu))
    del p, o
    if model_axis > 1:
        batch = rank_batch(MESH_STEPS)
        tr.extract_traffic(run["params"], run["opt_state"], batch)
        with record_collectives() as real:
            tr._step_fn(run["params"], run["opt_state"], batch)
        key = [(op.kind, op.result_bytes, op.group_size, op.groups, op.dtype) for op in real]
        out["ops_equal"] = key == [(op.kind, op.result_bytes, op.group_size, op.groups,
                                    op.dtype) for op in tr.collective_ops]
        out["n_ops"] = len(real)
        out["wire_bytes_per_chip"] = tr.collectives["total_wire_bytes_per_chip"]
        return out
    # restart from step 2: the uninterrupted run's step-3 checkpoint moves
    # aside (kept for the one-card restore), the restart writes its own
    if rank == 0:
        (ckdir / "kept").mkdir()
        shutil.move(str(ckdir / f"step_{MESH_STEPS:08d}"), str(ckdir / "kept"))
    dist.barrier()
    again = trainer().run(resume=True)
    out["restart_losses"] = again["losses"]
    del again
    # elastic downsizing: ranks 0 and 1 take over the live state
    sub = make_host_mesh(ranks=[0, 1])
    p2, o2 = tr.remesh(sub, run["params"], run["opt_state"])
    out["remesh_events"] = tr.stats["remesh_events"]
    if p2 is not None:
        lp, lo = tr.logical(p2, o2)
        out["remesh_digest"] = _state_digest(lp, lo)
        del lp, lo
        batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(MESH_STEPS))
        _, _, m = tr._step_fn(p2, o2, batch)
        out["remesh_step_loss"] = float(m["loss"])
    return out


def _one_card_run(arch, n_layers, b, s, dtype, opt_kw, world, device):
    """The multi-card run's steps on one card, unsharded, on the same global
    batches: (losses, step times, peak bytes, launches)."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.rglru_scan import ops as rgops
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = _train_cfg(arch, n_layers, dtype)
        model = build_model(cfg, device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(0)
        opt = AdamW(**opt_kw)
        state = opt.init(params)
        step = make_train_step(model, opt, StepConfig(remat=True))
        faops.launches = faops.bwd_launches = sdops.launches = sdops.bwd_launches = 0
        rgops.launches = 0
        losses, times = [], []
        for i in range(MESH_STEPS):
            batch = _global_batch(cfg, b, s, i, world, device)
            synchronize(device)
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        launches = {"flash_fwd": faops.launches, "flash_bwd": faops.bwd_launches,
                    "rglru": rgops.launches, "ssd": sdops.launches,
                    "ssd_bwd": sdops.bwd_launches}
        peak = torch.cuda.max_memory_allocated() if cuda else None
        del params, state, model
        if cuda:
            torch.cuda.empty_cache()
        return losses, times, peak, launches
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _restore_digest(arch, n_layers, dtype, opt_kw, ckdir, device) -> str:
    """The digest of the checkpoint in ``ckdir`` restored on one card."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, AdamWState

    model = build_model(_train_cfg(arch, n_layers, dtype), device)
    params = model.init(0)
    state, _ = CheckpointManager(ckdir).restore(
        {"params": params, "opt": AdamW(**opt_kw).init(params)._asdict()})
    tree = state["params"]
    digest = _state_digest({"p": tree}, AdamWState(**state["opt"]))
    del params, state, tree
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return digest


def multicard_fleet(dev, n: int, smi: str = "") -> dict:
    """The multi-card entry's fleet: ``run_fleet`` over all 22 fabrics
    unsharded on one card, then dealt over ``n`` (``mesh="auto"`` on CUDA:
    every visible card), both timed with their stages, each job held as in
    phase 14."""
    from repro_torch.parallel.sharding import fleet_mesh

    jobs = fleet_config()
    one, wall1, counts1, n_buckets = _fleet_run(jobs, dev, None)
    many, walln, countsn, _ = _fleet_run(
        jobs, dev, "auto" if dev.type == "cuda" else fleet_mesh([dev] * n))
    log(f"multicard: run_fleet over {len(jobs)} fabrics ({n_buckets} buckets, "
        f"{sum(r.n_routing_updates for r in one)} PDHG elements): one card "
        f"{wall1:.3f} s, stages {_stage_sums(one)}; {n} cards (mesh='auto') "
        f"{walln:.3f} s, stages {_stage_sums(many)}; cut {1 - walln / wall1:.4f}; "
        f"launches {counts1} / {countsn} ({smi})")
    return {"one_card_s": wall1, "cards_s": walln,
            "one_card_stages": _stage_sums(one), "cards_stages": _stage_sums(many),
            "bit_equal": _check_sharded_fleet(f"{n} cards", jobs, one, many)}


def _filled_cache(model, b: int, length: int, start: int, seed: int, device, tiles=None):
    """A whole decode cache of ``length`` positions (and encoder frames)
    whose KV slots below ``start``, recurrent states and encoder output are
    drawn from ``seed`` (a generator on ``device``: the same values on every
    card), leaf by leaf in the cache's order.  With ``tiles`` (mesh, shape):
    this rank's tile of every leaf instead, each cut as soon as it is filled
    (``init_cache_tiles``): the tiles ``shard_cache`` cuts from the whole
    cache, which is never held."""
    import torch

    from repro_torch.launch.steps import init_cache_tiles
    from repro_torch.parallel import sharding as sh

    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(name, leaf):
        if name in ("k", "v"):
            n = min(start, leaf.shape[1])
            leaf[:, :n] = torch.randn((leaf.shape[0], n) + tuple(leaf.shape[2:]),
                                      generator=gen, device=device).to(leaf.dtype)
        else:
            leaf.copy_(torch.randn(tuple(leaf.shape), generator=gen, device=device))

    if tiles is not None:
        mesh, shape = tiles
        return init_cache_tiles(model, mesh, shape, fill, enc_len=length)
    cache = model.init_cache(b, length, enc_len=length)
    for path, _, leaf in sh._param_leaves(cache):
        fill(next(str(k) for k in reversed(path) if isinstance(k, str)), leaf)
    return cache


def _decode_tokens(cfg, b: int, steps: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    return torch.randint(0, cfg.vocab, (steps, b, 1), generator=gen, device=device)


def _run_decode(step, params, cache, tokens, start: int, device, record=None):
    """``step`` over ``tokens`` from position ``start``: (the last logits
    of every step, float32 on the host, (steps, B, V); the greedy tokens
    (steps, B); each step's host seconds, ending in a synchronize).  With
    ``record`` (a list), the first step's collectives are appended to it."""
    import numpy as np
    import torch

    from repro_torch.device import synchronize
    from repro_torch.runtime.hlo_traffic import record_collectives

    logits, toks, times = [], [], []
    for i in range(tokens.shape[0]):
        synchronize(device)
        t0 = time.perf_counter()
        if i == 0 and record is not None:
            with record_collectives() as ops:
                tok, cache, out = step(params, cache, tokens[i], start + i)
            record += ops
        else:
            tok, cache, out = step(params, cache, tokens[i], start + i)
        synchronize(device)
        times.append(time.perf_counter() - t0)
        logits.append(out[:, -1].float().cpu())
        toks.append(tok[:, 0].cpu())
    return torch.stack(logits).numpy(), torch.stack(toks).numpy().astype(np.int64), times


def _op_keys(ops) -> list:
    """What two records of collectives must agree on, op for op."""
    return [(op.kind, op.result_bytes, op.group_size, op.groups, op.dtype) for op in ops]


def _virtual_decode_ops(cfg, mesh, b: int, length: int, start: int, rows) -> list:
    """The collectives (``_op_keys``) of one decode step at ``start`` on a
    virtual copy of ``mesh``, on ``meta`` tensors, for the rank's ``rows``
    of the batch: what the dry run records for the same step."""
    import torch

    from repro_torch.launch.steps import (cache_tile_shardings, leaf_plans, make_serve_step,
                                          module_like, shard_cache)
    from repro_torch.models.api import Model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives

    shape = ShapeConfig("decode_32k", length, b, "decode")
    vmesh = mesh.virtual_copy()
    vmodel = Model(cfg, torch.device("meta"))
    vshapes = vmodel.param_shapes()
    vshards = module_like(vshapes, [sh.shard_tensor(x, p.sharding) for x, p in
                                    zip(tree_util.leaves(vshapes), leaf_plans(vmodel, vmesh))])
    vwhole = vmodel.init_cache(b, length, enc_len=length)
    vstep = make_serve_step(vmodel, mesh=vmesh, logits=True,
                            cache_sh=cache_tile_shardings(vmesh, cfg, shape, vwhole))
    vtok = torch.empty((rows.stop - rows.start, 1), dtype=torch.int64, device="meta")
    with record_collectives() as vops:
        vstep(vshards, shard_cache(vwhole, vmesh, cfg, shape), vtok, start)
    return _op_keys(vops)


def _decode_rank(rank, world, arch, n_layers, b, model_axis, run, device_type="cuda"):
    """One rank of a multi-card decode run: for float32 (TF32 off) and the
    model's bf16, ``MULTI_DECODE_STEPS`` steps of ``make_serve_step`` on
    ``make_host_mesh(model_axis)`` from this rank's tiles of the parameters
    and of a cache filled from the seed, each drawn tile by tile
    (``init_tiles``, ``_filled_cache(tiles=...)``): its logits and
    tokens (its batch rows and vocabulary columns), step times, peak memory
    and cache bytes, and whether the first step's collectives equal, op for
    op, the same step's on a virtual copy of the mesh on ``meta``.  ``run``
    is (cache length, start position, steps): a spawned rank reads no
    constant its parent changed."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (cache_tile_shardings, init_tiles, input_shardings,
                                          leaf_plans, make_serve_step)
    from repro_torch.models.api import Model, build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device(device_type)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(model_axis=model_axis)
    length, start, steps = run
    shape = ShapeConfig("decode_32k", length, b, "decode")
    out = {}
    for dtype in ("float32", None):
        cfg = _train_cfg(arch, n_layers, dtype)
        model = build_model(cfg, dev)
        shards = init_tiles(model, leaf_plans(model, mesh))
        tiles = _filled_cache(model, b, length, start, 1, dev, tiles=(mesh, shape))
        cache_sh = cache_tile_shardings(mesh, cfg, shape, Model(cfg, torch.device("meta"))
                                        .init_cache(b, length, enc_len=length))
        tokens = _decode_tokens(cfg, b, steps, dev)
        tok_sh = input_shardings(mesh, cfg, shape, {"token": tokens[0]})["token"]
        step = make_serve_step(model, mesh=mesh, cache_sh=cache_sh, logits=True)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        ops = []
        logits, toks, times = _run_decode(
            step, shards, tiles, torch.stack([sh.shard_tensor(t, tok_sh) for t in tokens]),
            start, dev, ops)
        rows = sh.dim_axes(tok_sh, 0)
        rows = sh.tile_slice(toks.shape[1], mesh, rows) if rows else slice(0, b)
        cols = (sh.tile_slice(logits.shape[-1], mesh, ("model",))
                if logits.shape[-1] != cfg.vocab else slice(0, cfg.vocab))
        out[cfg.dtype] = {
            "logits": logits, "tokens": toks, "rows": (rows.start, rows.stop),
            "cols": (cols.start, cols.stop), "times": times,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "cache_bytes": sum(x.numel() * x.element_size() for x in tree_util.leaves(tiles)),
            "n_ops": len(ops),
            "ops_equal": _op_keys(ops) == _virtual_decode_ops(cfg, mesh, b, length, start, rows),
            "wire_bytes_per_chip": float(sum(op.wire_bytes_per_chip() for op in ops))}
        del shards, tiles, step, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def _one_card_decode(arch, n_layers, b, dtype, device, rows=None, perturb=0.0):
    """The multi-card decode run's steps on one card, unsharded: (logits,
    tokens, step times, peak bytes, cache bytes).  ``rows`` (a slice of the
    batch): decode only those sequences of the same cache and tokens.
    ``perturb``: every cache value multiplied by ``1 + perturb`` first."""
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    rows = rows or slice(0, b)
    try:
        cfg = _train_cfg(arch, n_layers, dtype)
        model = build_model(cfg, device)
        params = model.init(0)
        cache = _filled_cache(model, b, MULTI_DECODE_LEN, MULTI_DECODE_START, 1, device)
        cache = tree_util.unflatten(cache, [x[rows].clone() * (1 + perturb) if perturb
                                            else x[rows].clone()
                                            for x in tree_util.leaves(cache)])
        cache_bytes = sum(x.numel() * x.element_size() for x in tree_util.leaves(cache))
        tokens = _decode_tokens(cfg, b, MULTI_DECODE_STEPS, device)[:, rows]
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        logits, toks, times = _run_decode(make_serve_step(model, logits=True), params, cache,
                                          tokens, MULTI_DECODE_START, device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        del params, cache, model
        if cuda:
            torch.cuda.empty_cache()
        return logits, toks, times, peak, cache_bytes
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _rel_err(got, ref, scale):
    """Each row's largest |got - ref| over its largest |logit| (``scale``)."""
    import numpy as np

    return np.abs(got - ref).max(axis=-1) / scale


def _decode_agree(ranks, dtype, want, want_tok, truth=None, truth_tok=None):
    """How the ranks' shares of the logits and tokens of ``dtype`` agree
    with one card's (``want``, ``want_tok``: (steps, B, V), (steps, B)):
    ``worst``, the largest difference over the row's largest logit;
    ``tokens``, whether the tokens are equal.  With one card's float32 run
    (``truth``, ``truth_tok``; for bf16) also each side's largest error
    against it (``err_cards``, ``err_one``), and the tokens compared with
    float32's wherever its top-2 margin exceeds twice the ranks' error in
    that row (where the logits are within it, so must the token be)."""
    import numpy as np

    out = {"worst": 0.0, "tokens": True, "err_cards": 0.0, "err_one": 0.0, "clear": 1.0}
    clear = []
    for r in ranks:
        got = r[dtype]
        rows, cols = slice(*got["rows"]), slice(*got["cols"])
        scale = np.abs(want[:, rows]).max(axis=-1)  # (steps, rows)
        err = _rel_err(got["logits"], want[:, rows, cols], scale)
        out["worst"] = max(out["worst"], float(err.max()))
        if truth is None:
            out["tokens"] &= bool(np.array_equal(got["tokens"], want_tok[:, rows]))
            continue
        scale = np.abs(truth[:, rows]).max(axis=-1)
        err = _rel_err(got["logits"], truth[:, rows, cols], scale)
        out["err_cards"] = max(out["err_cards"], float(err.max()))
        out["err_one"] = max(out["err_one"], float(
            _rel_err(want[:, rows, cols], truth[:, rows, cols], scale).max()))
        top2 = np.sort(truth[:, rows], axis=-1)[..., -2:]
        ok = (top2[..., 1] - top2[..., 0]) > 2 * err * scale
        clear.append(ok)
        out["tokens"] &= bool(np.array_equal(got["tokens"][ok], truth_tok[:, rows][ok]))
    if clear:
        out["clear"] = float(np.mean(np.concatenate(clear)))
    return out


def multicard_decode(n: int, dev, smi: str, backend: str, device_type: str) -> dict:
    """The multi-card entry's decode part: each run of ``MULTI_DECODE`` on
    ``n`` ranks (float32 and bf16 in one start of the ranks), then on one
    card, both timed a step.  float32: the ranks' logits within
    ``MULTI_F32_REL`` of the largest logit of one card decoding each dp
    rank's rows (the card's GEMMs round by their row count: against all
    rows at once the difference is printed), or within
    ``DECODE_F32_FACTOR`` times the move of one card's logits under a
    one-ulp perturbation of its cache where that is larger (a recurrence
    over random states amplifies rounding), the tokens equal.  bf16:
    Megatron's row-parallel products round each rank's partial sum to bf16
    before the sum over the model axis, where one card rounds once, and a
    bf16 rounding of the hidden state moves the logits by as much as bf16
    moves them from float32 (reduced configs on the CPU: up to 2.2e-2 of
    the largest logit either way, ``MULTI_BF16_REL`` out of reach); so the
    ranks' bf16 logits are held within ``DECODE_BF16_FACTOR`` times one
    card's bf16 error against one card's float32 logits, and their tokens
    equal float32's wherever its top-2 margin clears twice the ranks' error
    in the row; their difference from one card's bf16 logits is printed.
    NCCL's collectives equal the virtual record."""
    import numpy as np

    from repro_torch.launch.train import run_ranks

    out = {}
    smi = "; ".join(dict.fromkeys(smi.splitlines()))  # one line for identical cards
    for arch, layers, b, model_axis in MULTI_DECODE:
        dp = n // model_axis
        t0 = time.perf_counter()
        ranks = run_ranks(_decode_rank, n, arch, layers, b, model_axis,
                          (MULTI_DECODE_LEN, MULTI_DECODE_START, MULTI_DECODE_STEPS),
                          device_type, backend=backend, timeout=900)
        t_ranks = time.perf_counter() - t0
        truth = truth_tok = None
        for dtype in ("float32", "bfloat16"):
            want, want_tok, t_one, peak_one, cache_one = _one_card_decode(
                arch, layers, b, None if dtype == "bfloat16" else dtype, dev)
            if dtype == "float32":
                truth, truth_tok = want, want_tok
                # one card at each dp rank's rows: the card's GEMMs round by
                # their row count, so the sharded arithmetic shows alone
                want, want_tok = np.empty_like(truth), np.empty_like(truth_tok)
                for rows in {tuple(r[dtype]["rows"]) for r in ranks}:
                    sl = slice(*rows)
                    want[:, sl], want_tok[:, sl] = _one_card_decode(
                        arch, layers, b, dtype, dev, sl)[:2]
                agree = _decode_agree(ranks, dtype, want, want_tok)
                whole = _decode_agree(ranks, dtype, truth, truth_tok)["worst"]
                # one card's own sensitivity: its logits with the cache one ulp off
                moved = max(float(_rel_err(
                    _one_card_decode(arch, layers, b, dtype, dev, perturb=sign * 2.0 ** -23)[0],
                    truth, np.abs(truth).max(axis=-1)).max()) for sign in (1, -1))
                bound = max(MULTI_F32_REL, DECODE_F32_FACTOR * moved)
                ok = agree["worst"] <= bound and agree["tokens"]
                held = (f"worst logit diff over the largest logit {agree['worst']:.3e} "
                        f"against one card decoding the rank's rows (bound {bound:.3e}: "
                        f"{MULTI_F32_REL:.0e} or {DECODE_F32_FACTOR:g} x one card's move "
                        f"with its cache one ulp off either way, {moved:.3e}; {whole:.3e} against all "
                        f"{b} rows at once), tokens equal {agree['tokens']}")
                agree["ulp_moved"] = moved
            else:
                agree = _decode_agree(ranks, dtype, want, want_tok, truth, truth_tok)
                bound = DECODE_BF16_FACTOR * agree["err_one"]
                # moe in bf16 is printed, not held (a routing flip at a near-tie)
                moe = _train_cfg(arch, layers, None).family == "moe"
                ok = moe or (agree["err_cards"] <= bound and agree["tokens"])
                held = (f"{'moe in bf16, printed, not held: ' if moe else ''}"
                        f"against one card's float32: {n} cards {agree['err_cards']:.3e}, "
                        f"one card {agree['err_one']:.3e} (bound {bound:.3e}); against "
                        f"one card's bf16 {agree['worst']:.3e}; tokens equal float32's "
                        f"where its margin clears twice the cards' error "
                        f"({agree['clear']:.3f} of them): {agree['tokens']}")
            r0 = ranks[0][dtype]
            step_n = float(np.median(r0["times"][1:]))
            step_1 = float(np.median(t_one[1:]))
            label = (f"decode {arch}{'' if layers is None else f' ({layers} layers)'} "
                     f"{dtype} B={b} on {dp}x{model_axis}")
            log(f"multicard: {label}, cache {MULTI_DECODE_LEN} positions from "
                f"{MULTI_DECODE_START}, {MULTI_DECODE_STEPS} steps ({t_ranks:.1f} s for both "
                f"dtypes with the ranks' start): {held}; {step_n * 1e3:.3f} ms a token on {n} cards vs "
                f"{step_1 * 1e3:.3f} ms on one ({b / step_n:.1f} vs {b / step_1:.1f} "
                f"tokens/s); peak memory per card "
                f"{[r[dtype]['peak_bytes'] for r in ranks]} B vs {peak_one} B; cache bytes "
                f"per card {[r[dtype]['cache_bytes'] for r in ranks]} vs {cache_one}; NCCL "
                f"= virtual {[r[dtype]['ops_equal'] for r in ranks]} ({r0['n_ops']} ops, "
                f"{r0['wire_bytes_per_chip']:.6e} wire bytes per chip a step) ({smi})")
            if not (np.isfinite(r0["logits"]).all() and ok):
                fail(f"{label}: {n} cards' logits or tokens disagree with one card's")
            if not all(r[dtype]["ops_equal"] for r in ranks):
                fail(f"{label}: the recorded collectives differ from the virtual mesh's")
            out[label] = {**agree, "ms_a_token": step_n * 1e3,
                          "one_card_ms_a_token": step_1 * 1e3,
                          "peak_bytes": [r[dtype]["peak_bytes"] for r in ranks],
                          "one_card_peak_bytes": peak_one,
                          "cache_bytes": [r[dtype]["cache_bytes"] for r in ranks],
                          "one_card_cache_bytes": cache_one, "n_ops": r0["n_ops"],
                          "wire_bytes_per_chip": r0["wire_bytes_per_chip"]}
    return out


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _moe_reckoning(cfg, mesh, run) -> dict:
    """A rank's bytes on ``mesh`` (a virtual mesh serves) before any weight
    is drawn, from the shapes alone: its parameter tiles (``leaf_plans``),
    its decode cache tiles (``cache_tile_shardings``), the whole model's and
    cache's, and the model's largest leaf drawn in float32."""
    import torch

    from repro_torch.launch.steps import cache_tile_shardings, leaf_plans
    from repro_torch.models.api import Model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    length, _, _, b = run
    model = Model(cfg, torch.device("meta"))
    shapes = tree_util.leaves(model.param_shapes())
    tiles = [sh.shard_tensor(x, p.sharding)
             for x, p in zip(shapes, leaf_plans(model, mesh, "prefill"))]
    cache = model.init_cache(b, length, enc_len=length)
    cache_sh = tree_util.leaves_of(cache_tile_shardings(
        mesh, cfg, ShapeConfig("decode_32k", length, b, "decode"), cache))
    cache = tree_util.leaves(cache)
    return {"param_bytes": _nbytes(tiles), "whole_param_bytes": _nbytes(shapes),
            "cache_bytes": _nbytes(sh.shard_tensor(x, t) for x, t in zip(cache, cache_sh)),
            "whole_cache_bytes": _nbytes(cache),
            "f32_leaf_bytes": 4 * max(x.numel() for x in shapes)}


def _recording_routes(sink):
    """A context in which every moe layer's routing also goes to
    ``sink(experts, gap, scale)``: the chosen experts of each token (T, k),
    sorted (the set decides the output), the gap between its k-th and
    (k+1)-th router logits (T,), and the layer's largest |router logit|;
    left on the device until read.  ``sink=None``: nothing recorded."""
    import contextlib

    import torch

    from repro_torch.models import moe

    @contextlib.contextmanager
    def patched():
        if sink is None:
            yield
            return
        route = moe._route

        def recorded(p, xt, k):
            probs, gates, idx = route(p, xt, k)
            logits = (xt.float() @ p.router).reshape(-1, p.router.shape[-1])
            top = torch.topk(logits, k + 1, dim=-1).values
            sink(idx.reshape(-1, k).sort(dim=-1).values, top[:, k - 1] - top[:, k],
                 logits.abs().max())
            return probs, gates, idx

        moe._route = recorded
        try:
            yield
        finally:
            moe._route = route

    return patched()


def _routes_host(calls) -> list:
    """Recorded routings (``_recording_routes``) read to the host."""
    return [(e.cpu().numpy(), g.cpu().numpy(), float(s)) for e, g, s in calls]


def _prefill_tokens(cfg, s: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(3)
    return torch.randint(0, cfg.vocab, (1, s), generator=gen, device=device)


def _moe_prefill(model, mesh, params, s: int, dev, record: bool) -> dict:
    """The moe_full part's prefill of ``s`` tokens through
    ``make_prefill_step(mesh=, logits=True)``: a first call (its flash
    launches counted, its collectives and, with ``record``, its routing
    recorded), then a second timed alone."""
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives

    tokens = _prefill_tokens(model.cfg, s, dev)
    step = make_prefill_step(model, mesh=mesh, logits=True)
    calls = []
    faops.launches = 0
    with record_collectives() as ops, _recording_routes(
            (lambda *r: calls.append(r)) if record else None):
        tok, logits = step(params, {"tokens": tokens})
    synchronize(dev)
    launches = faops.launches
    cols = (sh.tile_slice(logits.shape[-1], mesh, ("model",))
            if logits.shape[-1] != model.cfg.vocab else slice(0, model.cfg.vocab))
    share = logits[0].float().cpu().numpy()
    del logits
    faops.launches = 0
    synchronize(dev)
    t0 = time.perf_counter()
    tok2, logits = step(params, {"tokens": tokens})
    synchronize(dev)
    seconds = time.perf_counter() - t0
    del logits
    return {"logits": share, "cols": (cols.start, cols.stop), "token": int(tok[0, 0]),
            "token_again": int(tok2[0, 0]), "launches": [launches, faops.launches],
            "seconds": seconds, "routes": _routes_host(calls), "n_ops": len(ops),
            "wire_bytes_per_chip": float(sum(op.wire_bytes_per_chip() for op in ops))}


def _moe_decode(model, mesh, params, run, dev, record: bool) -> dict:
    """The moe_full part's decode: ``make_serve_step(mesh=, cache_sh=)``
    over a cache filled tile by tile from the seed (``_filled_cache(...,
    tiles=)``), ``steps`` teacher-forced steps from ``start`` (with
    ``record``, every step's routing recorded on the device)."""
    import torch

    from repro_torch.launch.steps import cache_tile_shardings, input_shardings, make_serve_step
    from repro_torch.models.api import Model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    cfg = model.cfg
    length, start, steps, b = run
    shape = ShapeConfig("decode_32k", length, b, "decode")
    cache = _filled_cache(model, b, length, start, 1, dev, tiles=(mesh, shape))
    cache_sh = cache_tile_shardings(mesh, cfg, shape, Model(cfg, torch.device("meta"))
                                    .init_cache(b, length, enc_len=length))
    tokens = _decode_tokens(cfg, b, steps, dev)
    tok_sh = input_shardings(mesh, cfg, shape, {"token": tokens[0]})["token"]
    step = make_serve_step(model, mesh=mesh, cache_sh=cache_sh, logits=True)
    ops, calls = [], []
    cache_bytes = _nbytes(tree_util.leaves(cache))
    with _recording_routes((lambda *r: calls.append(r)) if record else None):
        logits, toks, times = _run_decode(
            step, params, cache, torch.stack([sh.shard_tensor(t, tok_sh) for t in tokens]),
            start, dev, ops)
    rows = sh.dim_axes(tok_sh, 0)
    rows = sh.tile_slice(toks.shape[1], mesh, rows) if rows else slice(0, b)
    cols = (sh.tile_slice(logits.shape[-1], mesh, ("model",))
            if logits.shape[-1] != cfg.vocab else slice(0, cfg.vocab))
    return {"logits": logits, "tokens": toks, "rows": (rows.start, rows.stop),
            "cols": (cols.start, cols.stop), "times": times, "cache_bytes": cache_bytes,
            "routes": _routes_host(calls), "n_ops": len(ops),
            "ops_equal": _op_keys(ops) == _virtual_decode_ops(cfg, mesh, b, length, start,
                                                              rows),
            "wire_bytes_per_chip": float(sum(op.wire_bytes_per_chip() for op in ops))}


def _moe_full_rank(rank, world, arch, prefills, decodes, run, device_type="cuda"):
    """One rank of the moe_full part on ``make_host_mesh(model_axis=world)``:
    for each dtype, the rank's tiles drawn straight from the seed
    (``init_tiles``; its bytes, the draw's seconds and the peak memory while
    it draws), then that dtype's prefills (``_moe_prefill``) and decode
    (``_moe_decode``), and the peak memory over all of it.  Rank 0 records
    the routing.  ``run``: (cache length, start, steps, batch)."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import init_tiles, leaf_plans
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device(device_type)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(model_axis=world)
    out = {}
    for dtype in dict.fromkeys([d for d, _ in prefills] + list(decodes)):
        model = build_model(_train_cfg(arch, None, dtype), dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        t0 = time.perf_counter()
        params = init_tiles(model, leaf_plans(model, mesh, "prefill"))
        synchronize(dev)
        got = {"draw_s": time.perf_counter() - t0,
               "draw_peak": torch.cuda.max_memory_allocated(dev) - base if cuda else None,
               "param_bytes": _nbytes(tree_util.leaves(params)),
               "prefill": {s: _moe_prefill(model, mesh, params, s, dev, rank == 0)
                           for d, s in prefills if d == dtype}}
        if dtype in decodes:
            got["decode"] = _moe_decode(model, mesh, params, run, dev, rank == 0)
        got["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base if cuda else None
        out[dtype] = got
        del params, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def _streamed_init(cfg, arch, device) -> tuple:
    """``init``'s draws replayed from the seed for a truth that streams a
    model a block at a time, in float32: the top-level leaves (``Params`` of
    the embedding, the final norm and, untied, the unembedding) and the
    generator, which then draws the blocks in order (``tf._attn_block``).
    Fails unless ``init`` draws the embedding, the unembedding (untied) and
    the first block first."""
    import torch

    from repro_torch.launch.steps import _draw_paths
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import Model
    from repro_torch.models.layers import init_dense
    from repro_torch.models.params import Params

    heads = [("embed",)] + ([] if cfg.tie_embeddings else [("unembed",)])
    first = _draw_paths(Model(cfg, torch.device("meta")))[:len(heads) + 1]
    if first != heads + [("blocks", 0, "attn", "wq")]:
        fail(f"{arch}: init draws {first} first, not the embedding, the unembedding "
             f"and the first block, as the truth streams them")
    gen = torch.Generator(device=device).manual_seed(0)
    tree = {"embed": init_dense(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                                dtype=torch.float32, device=device),
            "final_norm": tf._norm(cfg, device)}
    if not cfg.tie_embeddings:
        tree["unembed"] = init_dense(gen, (cfg.d_model, cfg.vocab),
                                     dtype=torch.float32, device=device)
    return Params(tree), gen


def _moe_truth(arch, seqs, run, device, ulp: bool = False) -> dict:
    """The one-card truth of a moe model no card holds, in float32 (TF32
    off), streamed a layer at a time: the same leaves drawn in ``init``'s
    order from the same seed (the float32 draws the bf16 model rounds),
    the embedding and unembedding kept, each block drawn, applied with the
    port's own block functions (``_attn_block_fwd`` to the prefills of
    ``seqs`` tokens, ``_attn_step`` to every decode step over that layer's
    cache, drawn as ``_filled_cache`` draws it) and freed.  With ``ulp``
    the decode runs twice more, its cache one ulp off either way
    (x (1 ± 2^-23)).  Returns the logits (prefills (S, V), decode (steps,
    B, V)), the routing of every layer (``_recording_routes``) and the
    seconds."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.params import Params

    cfg = _train_cfg(arch, None, "float32")
    length, start, steps, b = run
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    routes = {("prefill", s): [] for s in seqs}
    routes["decode"] = []
    sink = {"to": None}
    signs = (0, 1, -1) if ulp else (0,)
    try:
        with torch.inference_mode(), _recording_routes(lambda *r: sink["to"].append(r)):
            head, gen = _streamed_init(cfg, arch, device)
            cgen = torch.Generator(device=device).manual_seed(1)
            xs = {s: tf._embed(head, _prefill_tokens(cfg, s, device), cfg) for s in seqs}
            tokens = _decode_tokens(cfg, b, steps, device)
            xd = {sign: [tf._embed(head, t, cfg) for t in tokens] for sign in signs}
            kv_shape = (b, length, cfg.n_kv_heads, cfg.resolved_head_dim)
            for layer in range(cfg.n_layers):
                blk = Params(tf._attn_block(gen, cfg, device))
                window = tf.layer_window(cfg, layer)
                for s in seqs:
                    sink["to"] = routes[("prefill", s)]
                    xs[s] = tf._attn_block_fwd(blk, xs[s], cfg, window)[0]
                kv = {}
                for name in ("k", "v"):  # the cache's leaf order
                    kv[name] = torch.zeros(kv_shape, dtype=torch.float32, device=device)
                    n = min(start, length)
                    kv[name][:, :n] = torch.randn((b, n) + kv_shape[2:], generator=cgen,
                                                  device=device)
                for sign in signs:
                    sink["to"] = routes["decode"] if sign == 0 else []
                    cache = {k: v * (1 + sign * 2.0 ** -23) if sign else v.clone()
                             for k, v in kv.items()}
                    for i in range(steps):
                        xd[sign][i], cache = tf._attn_step(blk, xd[sign][i], cache,
                                                           start + i, cfg, window)
                    del cache
                del blk, kv
            out = {"prefill": {s: tf._project_logits(head, rms_norm(x, head.final_norm),
                                                     cfg)[0].cpu().numpy()
                               for s, x in xs.items()}}
            for sign in signs:
                out[("decode", sign)] = torch.stack([
                    tf._project_logits(head, rms_norm(x, head.final_norm), cfg)[:, -1]
                    for x in xd[sign]]).cpu().numpy()
            out["routes"] = {k: _routes_host(v) for k, v in routes.items()}
        del head, xs, xd
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _route_flips(got, want, n_layers: int, steps: int = 0) -> dict:
    """The mesh's recorded routing (``got``) against the truth's (``want``),
    token by token and layer by layer.  A disagreement is first-order where
    nothing upstream of it disagreed: no earlier layer at a token at or
    before it (a prefill, causal), or no earlier layer of the same step or
    earlier step of the same sequence (a decode, ``steps`` > 0: ``got``
    step-major, ``want`` layer-major); only a first-order one is judged, a
    near-tie when the truth's gap under it is below ``MOE_NEAR_TIE`` of its
    layer's largest |router logit|.  Returns the counts, the first-order
    disagreements that are no near-tie, and where the logits stay clean:
    ``clean_from`` (a prefill: every position before it; a decode: per
    sequence, every step before it)."""
    import numpy as np

    flips, judged, far = 0, 0, []
    if steps == 0:
        dirty = np.inf
        for layer in range(n_layers):
            e, (w, gap, scale) = got[layer][0], want[layer]
            bad = np.flatnonzero((e != w).any(-1))
            flips += bad.size
            first = bad[bad < dirty]
            judged += first.size
            far += [(layer, int(t), float(gap[t] / scale)) for t in first
                    if not gap[t] < MOE_NEAR_TIE * scale]
            if bad.size:
                dirty = min(dirty, int(bad.min()))
        return {"flips": flips, "first_order": judged, "not_near_ties": far,
                "clean_from": dirty}
    b = got[0][0].shape[0]
    dirty = np.full(b, np.inf)
    for i in range(steps):
        for layer in range(n_layers):
            e = got[i * n_layers + layer][0]
            w, gap, scale = want[layer * steps + i]
            bad = np.flatnonzero((e != w).any(-1))
            flips += bad.size
            first = bad[i < dirty[bad]]
            judged += first.size
            far += [(i, layer, int(r), float(gap[r] / scale)) for r in first
                    if not gap[r] < MOE_NEAR_TIE * scale]
            dirty[bad] = np.minimum(dirty[bad], i)
    return {"flips": flips, "first_order": judged, "not_near_ties": far,
            "clean_from": dirty.tolist()}


def _moe_full_check(arch, ranks, truth, reck, prefills, decodes, run, n, smi, t_ranks):
    """Holds and prints one moe_full model's run (the ranks' results, the
    one-card truth, the reckoning a dtype) as ``multicard_moe_full`` says."""
    import numpy as np

    cfg = _train_cfg(arch, None, None)
    length, start, steps, b = run
    out = {}
    for dtype, want in reck.items():
        got = [r[dtype] for r in ranks]
        held = dtype == "float32"
        label = f"moe_full {arch} ({cfg.n_layers} layers) {dtype} on 1x{n}"
        pb, cb = [g["param_bytes"] for g in got], [g["decode"]["cache_bytes"]
                                                   for g in got if "decode" in g]
        bound = want["param_bytes"] + want["f32_leaf_bytes"] + MOE_DRAW_SLACK
        peaks = [g["draw_peak"] for g in got]
        log(f"multicard: {label}: parameter bytes a card {pb} (reckoned "
            f"{want['param_bytes']}), cache bytes a card {cb or '-'} (reckoned "
            f"{want['cache_bytes']}); drawn in {[round(g['draw_s'], 3) for g in got]} s, "
            f"peak while drawing {peaks} B (bound {bound:.6e}: tiles + one float32 leaf "
            f"{want['f32_leaf_bytes']} + {MOE_DRAW_SLACK:.0e}); peak a card over the part "
            f"{[g['peak_bytes'] for g in got]} B ({smi})")
        if any(x != want["param_bytes"] for x in pb) or any(x != want["cache_bytes"]
                                                            for x in cb):
            fail(f"{label}: the bytes a card differ from the reckoning")
        if any(p is not None and p > bound for p in peaks):
            fail(f"{label}: a rank's peak while drawing passed its tiles, one float32 "
                 f"leaf and {MOE_DRAW_SLACK:.0e} B")
        res = {"param_bytes": pb, "cache_bytes": cb, "draw_s": [g["draw_s"] for g in got],
               "draw_peak_bytes": peaks, "peak_bytes": [g["peak_bytes"] for g in got]}
        for s, p0 in got[0]["prefill"].items():
            ref = truth["prefill"][s]
            flips = _route_flips(p0["routes"], truth["routes"][("prefill", s)], cfg.n_layers)
            clean = min(s, flips["clean_from"])
            scale = np.abs(ref).max(axis=-1)  # (S,)
            worst = max(float((np.abs(g["prefill"][s]["logits"][:clean]
                                      - ref[:clean, slice(*g["prefill"][s]["cols"])]).max(-1)
                               / scale[:clean]).max()) if clean else 0.0 for g in got)
            top2 = np.sort(ref[-1])[-2:]
            token_clear = clean == s and top2[1] - top2[0] > 2 * worst * scale[-1]
            token_ok = all(g["prefill"][s]["token"] == int(ref[-1].argmax())
                           and g["prefill"][s]["token_again"] == g["prefill"][s]["token"]
                           for g in got)
            launches = [g["prefill"][s]["launches"] for g in got]
            secs = p0["seconds"]
            log(f"multicard: {label} prefill B=1, S={s}: {secs:.3f} s ({s / secs:.1f} "
                f"tokens/s); flash launches a rank {launches} (expected {cfg.n_layers} "
                f"each call); routing against the one-card truth: {flips['flips']} "
                f"disagreements, {flips['first_order']} first-order, not near-ties "
                f"{flips['not_near_ties']}; logits against the truth (the first {clean} "
                f"positions, before any disagreement): worst diff over the row's largest "
                f"{worst:.3e} ({f'bound {MULTI_F32_REL:.0e}' if held else 'bf16: printed'}); "
                f"the greedy token {p0['token']} vs the truth's {int(ref[-1].argmax())} "
                f"(equal {token_ok}, margin clear {token_clear}); {p0['n_ops']} "
                f"collectives, {p0['wire_bytes_per_chip']:.6e} wire bytes a chip")
            if any(x != [cfg.n_layers, cfg.n_layers] for x in launches):
                fail(f"{label} prefill S={s}: flash launches {launches}")
            if not all(np.isfinite(g["prefill"][s]["logits"]).all() for g in got):
                fail(f"{label} prefill S={s}: logits not finite")
            if held and (flips["not_near_ties"] or worst > MULTI_F32_REL
                         or (token_clear and not token_ok)):
                fail(f"{label} prefill S={s}: disagrees with the one-card truth")
            res[f"prefill_{s}"] = {"seconds": secs, "tokens_per_s": s / secs,
                                   "launches": launches, "worst_rel": worst, "clean": clean,
                                   "wire_bytes_per_chip": p0["wire_bytes_per_chip"],
                                   **{k: flips[k] for k in ("flips", "first_order")}}
        if dtype in decodes:
            d0 = got[0]["decode"]
            ref = truth[("decode", 0)]
            flips = _route_flips(d0["routes"], truth["routes"]["decode"], cfg.n_layers, steps)
            clean = np.arange(steps)[:, None] < np.asarray(flips["clean_from"])[None, :]
            scale = np.abs(ref).max(axis=-1)  # (steps, B)
            moved = max((float((np.abs(truth[("decode", sg)] - ref).max(-1) / scale).max())
                         for sg in (1, -1) if ("decode", sg) in truth), default=0.0)
            bound = max(MULTI_F32_REL, DECODE_F32_FACTOR * moved)
            worst, tokens_ok, clear = 0.0, True, []
            for g in got:
                d = g["decode"]
                rows, cols = slice(*d["rows"]), slice(*d["cols"])
                err = np.abs(d["logits"] - ref[:, rows, cols]).max(-1) / scale[:, rows]
                ok = clean[:, rows]
                worst = max(worst, float(err[ok].max()) if ok.any() else 0.0)
                top2 = np.sort(ref[:, rows], axis=-1)[..., -2:]
                sure = ok & (top2[..., 1] - top2[..., 0] > 2 * err * scale[:, rows])
                clear.append(sure)
                tokens_ok &= bool(np.array_equal(d["tokens"][sure],
                                                 ref[:, rows].argmax(-1)[sure]))
            ms = float(np.median(d0["times"][1:])) * 1e3
            rule = (f"bound {bound:.3e}: {MULTI_F32_REL:.0e} or {DECODE_F32_FACTOR:g} x the "
                    f"truth's move with its cache one ulp off, {moved:.3e}" if held
                    else "bf16: printed")
            log(f"multicard: {label} decode B={b}, cache {length} from {start}, {steps} "
                f"steps: {ms:.3f} ms a token ({b / ms * 1e3:.1f} tokens/s); routing "
                f"against the one-card truth: {flips['flips']} disagreements, "
                f"{flips['first_order']} first-order, not near-ties "
                f"{flips['not_near_ties']}; logits against the truth where clean "
                f"({float(clean.mean()):.3f} of the steps): worst diff over the row's "
                f"largest {worst:.3e} ({rule}); "
                f"greedy tokens equal the truth's where its margin clears twice the error "
                f"({float(np.mean(np.concatenate(clear))):.3f} of them): {tokens_ok}; "
                f"NCCL = virtual {[g['decode']['ops_equal'] for g in got]} "
                f"({d0['n_ops']} ops, {d0['wire_bytes_per_chip']:.6e} wire bytes a chip "
                f"a step)")
            if not all(np.isfinite(g["decode"]["logits"]).all() for g in got):
                fail(f"{label} decode: logits not finite")
            if not all(g["decode"]["ops_equal"] for g in got):
                fail(f"{label} decode: the recorded collectives differ from the virtual "
                     f"mesh's")
            if held and (flips["not_near_ties"] or worst > bound or not tokens_ok):
                fail(f"{label} decode: disagrees with the one-card truth")
            res["decode"] = {"ms_a_token": ms, "worst_rel": worst, "bound": bound,
                             "ulp_moved": moved, "tokens_equal": tokens_ok,
                             "n_ops": d0["n_ops"],
                             "wire_bytes_per_chip": d0["wire_bytes_per_chip"],
                             **{k: flips[k] for k in ("flips", "first_order")}}
        out[dtype] = res
    log(f"multicard: moe_full {arch}: {t_ranks:.1f} s for the ranks (start included), "
        f"the one-card truth {truth['seconds']:.1f} s")
    return out


def multicard_moe_full(n: int, dev, smi: str, backend: str, device_type: str) -> dict:
    """The 4-card entry's moe_full part: each model of ``MOE_FULL`` at its
    published depth on ``make_host_mesh(model_axis=n)``.  Before any weight
    is drawn, a rank's parameter and cache bytes are reckoned from the
    shapes on a virtual mesh; then the ranks draw their tiles straight from
    the seed and run the prefills and decodes (``_moe_full_rank``); then,
    on the first card with the ranks gone, the one-card truth streams the
    same model a layer at a time in float32 (``_moe_truth``).  Held: the
    bytes a card equal the reckoning; a rank's peak while drawing stays
    under its tiles, one float32 leaf and ``MOE_DRAW_SLACK``; #7 launches
    once a layer a rank in each prefill; the decode's collectives equal
    the virtual mesh's op for op; the float32 logits (the rank's share of
    the vocabulary) within ``MULTI_F32_REL`` of the truth's (the decode's
    within ``DECODE_F32_FACTOR`` times the truth's move with its cache one
    ulp off, where that is larger: f32 decode's rule on a mesh) wherever
    the routing agreed upstream, every first-order routing disagreement a
    near-tie (``MOE_NEAR_TIE``), and the greedy tokens the truth's where its
    margin clears twice the error.  bf16 against the truth is printed, not
    held (a bf16 routing flip at a near-tie, ROADMAP §3)."""
    import os

    import torch

    from repro_torch.launch.train import run_ranks
    from repro_torch.parallel.sharding import Mesh

    smi = "; ".join(dict.fromkeys(smi.splitlines()))
    run = (MULTI_DECODE_LEN, MULTI_DECODE_START, MULTI_DECODE_STEPS, MOE_FULL_DECODE_B)
    vmesh = Mesh((1, n), ("data", "model"))
    out = {}
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    # the ranks' allocators: a draw's whole leaf and its tile freed and taken
    # again leaf after leaf fragment fixed segments
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for arch, prefills, decodes in MOE_FULL:
            dtypes = dict.fromkeys([d for d, _ in prefills] + list(decodes))
            reck = {dt: _moe_reckoning(_train_cfg(arch, None, dt), vmesh, run)
                    for dt in dtypes}
            for dt, r in reck.items():
                log(f"multicard: moe_full {arch} {dt} on 1x{n}, reckoned before any "
                    f"weight is drawn: parameters {r['param_bytes']} B a card of "
                    f"{r['whole_param_bytes']} B ({r['param_bytes'] / 1e9:.2f} of "
                    f"{r['whole_param_bytes'] / 1e9:.2f} GB), decode cache (B="
                    f"{MOE_FULL_DECODE_B}, {MULTI_DECODE_LEN} slots) {r['cache_bytes']} B "
                    f"a card of {r['whole_cache_bytes']} B, the largest leaf in float32 "
                    f"{r['f32_leaf_bytes']} B")
            if device_type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = run_ranks(_moe_full_rank, n, arch, prefills, decodes, run, device_type,
                              backend=backend, timeout=1500)
            t_ranks = time.perf_counter() - t0
            truth = _moe_truth(arch, [s for _, s in prefills], run, dev,
                               ulp="float32" in decodes)
            out[arch] = _moe_full_check(arch, ranks, truth, reck, prefills, decodes, run, n,
                                        smi, t_ranks)
            del ranks, truth
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    return out


def _probe(shape, j: int, device):
    """Leaf ``j``'s (its place in tree order) seeded ±1 tensor of ``shape``,
    float32, the same on every card: the direction its gradient is read
    along."""
    import torch

    gen = torch.Generator(device=device).manual_seed(DENSE_PROBE_SEED + j)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return out.bernoulli_(0.5, generator=gen).mul_(2).sub_(1)


def _grad_reading(g, j: int, probe=None) -> tuple:
    """(sum of squares, projection on leaf ``j``'s ``_probe``) of a gradient
    ``g`` (``probe``: the probe's cut that matches ``g``)."""
    import torch

    g = g.detach().float()
    p = _probe(g.shape, j, g.device) if probe is None else probe
    return (float(torch.linalg.vector_norm(g)) ** 2,
            float(torch.dot(g.reshape(-1), p.reshape(-1))))


def _dense_truth(arch, b, s, dp, k, device, perturb: float = 0.0, n_layers=None,
                 hosts: int = 4) -> dict:
    """The one-card float32 truth (TF32 off) of step 0 of a dense_full run,
    for a model no card trains, streamed a block at a time: ``init``'s
    draws replayed from the seed, the top-level leaves kept and, for each
    block, the generator's state at its first draw saved.  Forward: the
    global batch of step 0 (``_global_batch`` of ``hosts`` slices, as the
    ranks take it) through one block at a time with the port's own block
    function (``_attn_block_fwd``), each block's input kept and the block
    freed;
    then the loss a microbatch at a time, as the step takes them (``dp`` ×
    ``k`` slices of ``b / (dp·k)`` sequences, each loss's gradient scaled
    by ``1 / (dp·k)``).  Backward: from the last block to the first, each
    block drawn again from its saved state, recomputed from its saved input
    and back-propagated; each leaf's gradient reduced to its sum of squares
    and its projection on ``_probe`` and dropped.  ``perturb``: the
    embedding output scaled by ``1 + perturb``.  Returns the loss (the
    slices' mean), the gradient's norm, each leaf's (sum of squares,
    projection) in tree order and the seconds."""
    import torch

    from repro_torch.launch.steps import block_leaves
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import Model
    from repro_torch.models.layers import rms_norm, softmax_cross_entropy
    from repro_torch.models.params import Params
    from repro_torch.optim import tree as tree_util

    cfg = _train_cfg(arch, n_layers, "float32")
    if cfg.family != "dense":
        fail(f"{arch}: the streamed truth of training takes the dense family only")
    top, blocks = block_leaves(Model(cfg, torch.device("meta")).param_shapes())
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reads = [None] * (len(top) + sum(len(blk) for blk in blocks))
    try:
        batch = _global_batch(cfg, b, s, 0, hosts, device)
        head, gen = _streamed_init(cfg, arch, device)
        head_leaves = tree_util.leaves(head)
        states, xs = [], []
        with torch.no_grad():
            x = tf._embed(head, batch["tokens"], cfg)
            if perturb:
                x = x * (1 + perturb)
            for i in range(cfg.n_layers):
                states.append(gen.get_state())
                blk = Params(tf._attn_block(gen, cfg, device))
                xs.append(x)
                x = tf._attn_block_fwd(blk, x, cfg, tf.layer_window(cfg, i))[0]
                del blk
        n = dp * k
        rows = b // n
        g = torch.empty_like(x)
        head_grads = [torch.zeros_like(w) for w in head_leaves]
        losses = []
        head.requires_grad_(True)
        for c in range(n):
            part = slice(c * rows, (c + 1) * rows)
            xc = x[part].detach().requires_grad_(True)
            logits = tf._project_logits(head, rms_norm(xc, head.final_norm), cfg)
            loss = softmax_cross_entropy(logits, batch["labels"][part])
            got = torch.autograd.grad(loss / n, [xc] + head_leaves, allow_unused=True)
            g[part] = got[0]
            for acc, gw in zip(head_grads, got[1:]):
                if gw is not None:
                    acc.add_(gw)
            losses.append(loss.detach())
            del logits, loss, got, xc
        del x
        for i in reversed(range(cfg.n_layers)):
            gen.set_state(states[i])
            blk = Params(tf._attn_block(gen, cfg, device))
            blk.requires_grad_(True)
            x_in = xs[i].requires_grad_(True)
            xs[i] = None
            with torch.enable_grad():
                out = tf._attn_block_fwd(blk, x_in, cfg, tf.layer_window(cfg, i))[0]
            leaves = tree_util.leaves(blk)
            got = torch.autograd.grad(out, [x_in] + leaves, g, allow_unused=True)
            g = got[0]
            for j, w, gw in zip(blocks[i], leaves, got[1:]):
                reads[j] = _grad_reading(torch.zeros_like(w) if gw is None else gw, j)
            del blk, out, got, leaves, x_in
        with torch.enable_grad():  # the embedding's own use of the table
            x0 = tf._embed(head, batch["tokens"], cfg)
            if perturb:
                x0 = x0 * (1 + perturb)
            head_grads[0].add_(torch.autograd.grad(x0, head.embed, g)[0])
        del x0, g
        for j, gw in zip(top, head_grads):
            reads[j] = _grad_reading(gw, j)
        loss = float(torch.stack(losses).mean())
        del head, head_leaves, head_grads, xs, states, batch
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": loss, "grad_norm": sum(r[0] for r in reads) ** 0.5, "reads": reads,
            "seconds": time.perf_counter() - t0}


def _dense_act_bytes(cfg, rows: int, s: int, m: int) -> int:
    """A rank's activation bytes in a dense_full step, reckoned from the
    shapes as an upper bound, for ``rows`` sequences of ``s`` tokens a
    microbatch on a model axis of ``m`` (T = rows · s tokens, e the
    model's bytes a value, H' = H / m and KV' = max(1, KV / m) the rank's
    heads, F' = d_ff / m and V' = V / m its hidden units and words):
      * every block's checkpointed input: L · T · d · e;
      * the head at its widest: the logits in the model's dtype, their
        float32 copy, two float32 temporaries of the log-sum-exp, their
        gradient in float32 twice (the gather's and the log-sum-exp's,
        added) and once in the dtype: T · V' · (2e + 20);
      * one block recomputed in the backward with its gradients, every
        value counted as float32: the norms' and residuals' copies and
        their gradients (16 · d), q, k, v and the attention's output with
        their gradients (4 · (H' + KV') · hd), the MLP's three hidden
        products with their gradients (6 · F'): T · (16 d + 4 (H' + KV')
        hd + 6 F') · 4."""
    e = 2 if cfg.dtype == "bfloat16" else 4
    t = rows * s
    heads = cfg.n_heads // m + max(1, cfg.n_kv_heads // m)
    block = t * (16 * cfg.d_model + 4 * heads * cfg.resolved_head_dim
                 + 6 * cfg.d_ff // m) * 4
    return cfg.n_layers * t * cfg.d_model * e + t * (cfg.vocab // m) * (2 * e + 20) + block


def _dense_reckoning(cfg, mesh, rows: int, s: int) -> dict:
    """A rank's bytes in a dense_full run on ``mesh`` (a virtual mesh
    serves) before any weight is drawn, from the shapes alone: its tiles
    (``leaf_plans``), their float32 moments and float32 gradient tiles, the
    parameters a step holds gathered at once and their float32 gradients
    (``dryrun.peak_param_bytes``), the activations (``_dense_act_bytes``),
    and the whole model's and moments' bytes."""
    import torch

    from repro_torch.launch.dryrun import peak_param_bytes
    from repro_torch.launch.steps import leaf_plans
    from repro_torch.models.api import Model
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    model = Model(cfg, torch.device("meta"))
    shapes = tree_util.leaves(model.param_shapes())
    tiles = [sh.shard_tensor(x, p.sharding)
             for x, p in zip(shapes, leaf_plans(model, mesh, "train"))]
    n = sum(x.numel() for x in tiles)
    gathered, grads = peak_param_bytes(model, mesh, "train")
    out = {"tile_bytes": _nbytes(tiles), "moment_bytes": 8 * n, "grad_tile_bytes": 4 * n,
           "peak_gathered_bytes": gathered, "peak_gradient_bytes": grads,
           "act_bytes": _dense_act_bytes(cfg, rows, s, mesh.shape["model"]),
           "whole_param_bytes": _nbytes(shapes),
           "whole_moment_bytes": 8 * sum(x.numel() for x in shapes)}
    out["state_bytes"] = sum(out[key] for key in ("tile_bytes", "moment_bytes",
                                                  "grad_tile_bytes", "peak_gathered_bytes",
                                                  "peak_gradient_bytes"))
    return out


def _mu_reading(model, plans, mesh, state, metrics, opt, device) -> list:
    """The mesh's step-0 gradient read from the moments without changing
    the step: at step 0 the learning rate is 0 and ``mu`` is ``(1 - b1) ·
    s · g`` (``s`` the clip's scale), so each rank divides its ``mu`` tile
    by that and reads it as ``_grad_reading`` reads a leaf, along its cut
    of the leaf's ``_probe``; a tile that other ranks hold too counts on the
    first of them alone; the ranks' sums are added (one all-reduce over the
    whole mesh).  Every rank gets each leaf's (sum of squares, projection),
    in tree order."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.steps import _split_axes
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    scale = torch.clamp(opt.grad_clip / (metrics["grad_norm"] + 1e-9), max=1.0)
    coef = (1 - opt.b1) * scale
    coords = mesh.coords()
    shapes = tree_util.leaves(model.param_shapes())
    out = torch.zeros((len(plans), 2), dtype=torch.float64, device=device)
    for j, (mu, plan, leaf) in enumerate(zip(tree_util.leaves(state.mu), plans, shapes)):
        split = _split_axes(plan)
        if any(coords[a] for a in mesh.axis_names if a not in split):
            continue  # a replica of a tile another rank reads
        probe = sh.shard_tensor(_probe(leaf.shape, j, device), plan.sharding)
        out[j, 0], out[j, 1] = _grad_reading(mu / coef, j, probe.contiguous())
        del probe
    if dist.is_initialized():
        dist.all_reduce(out)
    return out.tolist()


def _dense_full_rank(rank, world, arch, dtype, model_axis, b, s, opt_kw, read, ckdir,
                     device_type="cuda"):
    """One rank of a dense_full run: ``MESH_STEPS`` steps through
    ``Trainer.run`` (its tiles drawn from the seed) on
    ``make_host_mesh(model_axis)`` at ``DENSE_FULL_MICROBATCHES``
    microbatches with remat, each on the rank's dp rows of the same global
    batch whatever the layout (``_global_batch`` of ``world`` slices, in
    place of the pipeline's); each step's #7/#7b launches; the peak device
    memory from the first step's start; with ``read`` the step-0 gradient
    read from the moments (``_mu_reading``); then one more step recorded
    over NCCL and compared, op for op, with the same step on a virtual copy
    of the mesh on ``meta`` (``Trainer.extract_traffic``)."""
    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.device import synchronize
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device(device_type)
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = _train_cfg(arch, None, dtype)
    model = build_model(cfg, dev)
    mesh = make_host_mesh(model_axis=model_axis)
    tr = Trainer(model, AdamW(**opt_kw), mesh,
                 DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b),
                 StepConfig(microbatches=DENSE_FULL_MICROBATCHES, remat=True),
                 TrainerConfig(total_steps=MESH_STEPS, checkpoint_every=MESH_STEPS + 1), ckdir)
    tr._save = lambda *a: None
    inner = tr._step_fn
    seen = {"launches": [], "reading": None, "metrics0": None}
    rows = sh.tile_slice(b // mesh.shape["data"], mesh, ("data",))

    def global_slice(i):
        """This rank's dp rows of step ``i``'s global batch of ``world``
        pipeline slices (``_global_batch``): the same global batches on
        4×1 and 2×2 (the pipeline's own slices depend on the dp count)."""
        return {key: x[rows] for key, x in _global_batch(cfg, b, s, i, world, dev).items()}

    def step(params, state, batch):
        batch = global_slice(len(seen["launches"]))
        if not seen["launches"] and cuda:  # the peak over the steps, not the draw
            synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = (faops.launches, faops.bwd_launches)
        params, state, metrics = inner(params, state, batch)
        seen["launches"].append([faops.launches - before[0],
                                 faops.bwd_launches - before[1]])
        if seen["metrics0"] is None:
            seen["metrics0"] = {key: float(v) for key, v in metrics.items()}
            if read:
                seen["reading"] = _mu_reading(model, inner.plans, mesh, state, metrics,
                                              tr.opt, dev)
        return params, state, metrics

    step.plans = inner.plans
    tr._step_fn = step
    run = tr.run(resume=False)
    if cuda:
        synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    params, state = run["params"], run["opt_state"]
    out = {"losses": run["losses"], "step_times": run["stats"]["step_times"],
           "peak_bytes": peak, "launches": seen["launches"], "metrics0": seen["metrics0"],
           "reading": seen["reading"] if rank == 0 else None,
           "tile_bytes": _nbytes(tree_util.leaves(params)),
           "moment_bytes": _nbytes(tree_util.leaves(state.mu) + tree_util.leaves(state.nu))}
    batch = global_slice(MESH_STEPS)
    tr.extract_traffic(params, state, batch)
    with record_collectives() as real:
        inner(params, state, batch)
    key = [(op.kind, op.result_bytes, op.group_size, op.groups, op.dtype) for op in real]
    out["ops_equal"] = key == [(op.kind, op.result_bytes, op.group_size, op.groups, op.dtype)
                               for op in tr.collective_ops]
    out["n_ops"] = len(real)
    out["wire_bytes_per_chip"] = tr.collectives["total_wire_bytes_per_chip"]
    return out


def _dense_truth_check(label, arch, b, s, dp, ranks, dev, smi, problems, hosts) -> dict:
    """The float32 run ``ranks`` of ``arch`` against ``_dense_truth``:
    step 0's loss within ``MULTI_F32_REL``; the gradient's norm, each
    leaf's norm and its projection within ``DENSE_GRAD_REL`` of the leaf's
    norm, or ``DECODE_F32_FACTOR`` × the truth's own move with its
    embedding output one ulp off where that is larger (computed only where
    a reading passes ``DENSE_GRAD_REL``).  Appends what fails to
    ``problems``."""
    import numpy as np

    k = DENSE_FULL_MICROBATCHES
    truth = _dense_truth(arch, b, s, dp, k, dev, hosts=hosts)
    got = np.asarray(ranks[0]["reading"])
    want = np.asarray(truth["reads"])
    norms = np.sqrt(want[:, 0])

    def diffs(reads):
        """Each leaf's norm and projection off the truth's, over its norm."""
        scale = np.where(norms > 0, norms, 1.0)
        return (np.abs(np.sqrt(reads[:, 0]) - norms) / scale,
                np.abs(reads[:, 1] - want[:, 1]) / scale)

    err_norm, err_proj = diffs(got)
    loss0, gn0 = ranks[0]["metrics0"]["loss"], ranks[0]["metrics0"]["grad_norm"]
    loss_rel = abs(loss0 - truth["loss"]) / abs(truth["loss"])
    gn_rel = abs(gn0 - truth["grad_norm"]) / truth["grad_norm"]
    bound = np.full(len(norms), DENSE_GRAD_REL)
    gn_bound, moved = DENSE_GRAD_REL, None
    if max(err_norm.max(), err_proj.max(), gn_rel) > DENSE_GRAD_REL:
        off = _dense_truth(arch, b, s, dp, k, dev, perturb=2.0 ** -23, hosts=hosts)
        moved = np.maximum(*diffs(np.asarray(off["reads"])))
        bound = np.maximum(bound, DECODE_F32_FACTOR * moved)
        gn_bound = max(gn_bound, DECODE_F32_FACTOR * abs(off["grad_norm"] - truth["grad_norm"])
                       / truth["grad_norm"])
    worst = int(np.argmax(np.maximum(err_norm, err_proj) / bound))
    rule = ("DENSE_GRAD_REL" if moved is None else
            f"the larger of DENSE_GRAD_REL and DECODE_F32_FACTOR x the ulp move, "
            f"{moved[worst]:.3e} there")
    log(f"multicard: {label} against the one-card truth ({truth['seconds']:.1f} s, "
        f"streamed a block at a time): step-0 loss {loss0!r} vs {truth['loss']!r} (rel "
        f"{loss_rel:.3e}, bound {MULTI_F32_REL:.0e}); grad_norm {gn0!r} vs "
        f"{truth['grad_norm']!r} (rel {gn_rel:.3e}, bound {gn_bound:.3e}); {len(norms)} "
        f"leaves: worst norm diff {err_norm.max():.3e}, worst projection diff "
        f"{err_proj.max():.3e} of the leaf's norm; the leaf nearest its bound #{worst} "
        f"(norm {err_norm[worst]:.3e}, projection {err_proj[worst]:.3e}, bound "
        f"{bound[worst]:.3e}: {rule}) ({smi})")
    if loss_rel > MULTI_F32_REL:
        problems.append(f"{label}: step-0 loss {loss0} vs the truth's {truth['loss']}")
    if gn_rel > gn_bound:
        problems.append(f"{label}: grad_norm {gn0} vs the truth's {truth['grad_norm']}")
    bad = np.flatnonzero((err_norm > bound) | (err_proj > bound))
    if bad.size:
        problems.append(f"{label}: leaves {bad.tolist()[:20]} disagree with the truth")
    return {"truth_seconds": truth["seconds"], "loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "worst_norm_rel": float(err_norm.max()), "worst_proj_rel": float(err_proj.max()),
            "bound": float(bound[worst]), "ulp_move_computed": moved is not None}


def multicard_dense_full(n: int, dev, smi: str, backend: str, device_type: str) -> dict:
    """The 4-card entry's dense_full part: each run of ``DENSE_FULL``.
    Before any weight is drawn a rank's bytes are reckoned from the shapes
    on a virtual copy of the mesh (``_dense_reckoning``); then the ranks
    train (``_dense_full_rank``); then, on the first card with the ranks
    gone, the float32 runs' one-card truth (``_dense_truth_check``).  Held:
    each rank's tiles and moments equal the reckoning to the byte and its
    peak over the steps stays under the reckoning plus the activations;
    #7 launches layers × microbatches × 2 (the rematerialised forward) a
    step a rank and #7b layers × microbatches; the ranks' losses finite and
    equal; the recorded NCCL collectives of a step equal the virtual
    mesh's; each model's bf16 losses on 4×1 and 2×2 within
    ``MULTI_BF16_REL`` of each other at every step; the float32 runs
    within bound of the truth.  Printed: step ms, tokens/s, MFU
    (``_train_flops``, each layer at its window, over the cards' peak for
    the dtype), peak GB a card and wire bytes a chip a step.  Every check
    runs before the part fails on any."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.train import run_ranks
    from repro_torch.parallel.sharding import Mesh

    smi = "; ".join(dict.fromkeys(smi.splitlines()))
    opts = {"float32": dict(lr=1e-3, warmup_steps=1, eps=1e-3),
            "bfloat16": dict(lr=3e-4, warmup_steps=1)}
    k = DENSE_FULL_MICROBATCHES
    out, problems, bf16 = {}, [], {}
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="dense_full_", dir=ROOT / "build")
    try:
        for arch, dtype, m, b, s in DENSE_FULL:
            dp = n // m
            cfg = _train_cfg(arch, None, dtype)
            label = f"dense_full {arch} ({cfg.n_layers} layers) {dtype} on {dp}x{m}"
            reck = _dense_reckoning(cfg, Mesh((dp, m), ("data", "model")), b // dp // k, s)
            log(f"multicard: {label}, B={b}, S={s}, {k} microbatches, reckoned before any "
                f"weight is drawn: a rank's tiles {reck['tile_bytes']} B (of "
                f"{reck['whole_param_bytes']}), moments {reck['moment_bytes']} B (of "
                f"{reck['whole_moment_bytes']}), float32 gradient tiles "
                f"{reck['grad_tile_bytes']} B, gathered at once (peak_param_bytes) "
                f"{reck['peak_gathered_bytes']} B and their float32 gradients "
                f"{reck['peak_gradient_bytes']} B: {reck['state_bytes'] / 1e9:.2f} GB; "
                f"activations {reck['act_bytes'] / 1e9:.2f} GB")
            if device_type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = run_ranks(_dense_full_rank, n, arch, dtype, m, b, s, opts[dtype],
                              dtype == "float32", ckdir, device_type, backend=backend,
                              timeout=480)
            t_ranks = time.perf_counter() - t0
            r0 = ranks[0]
            losses = r0["losses"]
            step_s = float(np.median(r0["step_times"][1:]))
            n_matmul = sum(x.numel() for x in _meta_params(cfg))
            if not cfg.tie_embeddings:
                n_matmul -= cfg.vocab * cfg.d_model
            peak_rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
            mfu = _train_flops(cfg, n_matmul, b, s) / step_s / (n * peak_rate)
            want_launches = [cfg.n_layers * k * 2, cfg.n_layers * k]
            peaks = [r["peak_bytes"] for r in ranks]
            cap = reck["state_bytes"] + reck["act_bytes"]
            log(f"multicard: {label}: {MESH_STEPS} steps ({t_ranks:.1f} s with the ranks' "
                f"start and draw): losses {losses} (all ranks equal "
                f"{all(r['losses'] == losses for r in ranks)}); step {step_s * 1e3:.1f} ms "
                f"({b * s / step_s:.1f} tokens/s), MFU {mfu:.4f} of {n} x "
                f"{peak_rate:.3g} FLOP/s {dtype}; peak a card over the steps "
                f"{[None if p is None else round(p / 1e9, 2) for p in peaks]} GB (reckoned "
                f"{reck['state_bytes'] / 1e9:.2f} + activations {reck['act_bytes'] / 1e9:.2f} "
                f"= {cap / 1e9:.2f}); tiles {sorted({r['tile_bytes'] for r in ranks})} B, "
                f"moments {sorted({r['moment_bytes'] for r in ranks})} B; #7/#7b launches a "
                f"step on rank 0 {r0['launches']} (expected {want_launches} each step; "
                f"all ranks equal {all(r['launches'] == r0['launches'] for r in ranks)}); "
                f"NCCL = virtual {[r['ops_equal'] for r in ranks]} "
                f"({r0['n_ops']} ops, {r0['wire_bytes_per_chip']:.6e} wire bytes a chip a "
                f"step) ({smi})")
            if not all(r["losses"] == losses for r in ranks) or not np.isfinite(losses).all():
                problems.append(f"{label}: losses {[r['losses'] for r in ranks]}")
            if any(r["tile_bytes"] != reck["tile_bytes"] or r["moment_bytes"]
                   != reck["moment_bytes"] for r in ranks):
                problems.append(f"{label}: the bytes a card differ from the reckoning")
            if any(p is not None and p > cap for p in peaks):
                problems.append(f"{label}: a peak {peaks} passed the reckoning {cap}")
            if any(step != want_launches for r in ranks for step in r["launches"]):
                problems.append(f"{label}: #7/#7b launches {r0['launches']} on rank 0, "
                                f"not {want_launches} a step")
            if not all(r["ops_equal"] for r in ranks):
                problems.append(f"{label}: the recorded collectives differ from the "
                                f"virtual mesh's")
            res = {"losses": losses, "step_ms": step_s * 1e3, "tokens_per_s": b * s / step_s,
                   "mfu": mfu, "peak_bytes": peaks, "reckoned_bytes": cap,
                   "tile_bytes": r0["tile_bytes"], "moment_bytes": r0["moment_bytes"],
                   "launches": r0["launches"], "n_ops": r0["n_ops"],
                   "wire_bytes_per_chip": r0["wire_bytes_per_chip"], "seconds": t_ranks}
            if dtype == "float32":
                res.update(_dense_truth_check(label, arch, b, s, dp, ranks, dev, smi,
                                              problems, n))
            else:
                bf16.setdefault(arch, {})[f"{dp}x{m}"] = losses
            out[label] = res
            del ranks
        for arch, runs in bf16.items():
            if len(runs) < 2:
                continue
            (ma, la), (mb, lb) = list(runs.items())[:2]
            worst = max(abs(a - c) / abs(c) for a, c in zip(la, lb))
            log(f"multicard: dense_full {arch} bf16 losses on {ma} {la} vs {mb} {lb}: worst "
                f"rel diff {worst:.3e} (bound {MULTI_BF16_REL:.3e})")
            out[f"dense_full {arch} bf16 {ma} vs {mb}"] = worst
            if worst > MULTI_BF16_REL:
                problems.append(f"dense_full {arch}: bf16 losses on {ma} and {mb} differ "
                                f"by {worst:.3e}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    if problems:
        fail("dense_full: " + "; ".join(problems))
    return out


def _meta_params(cfg) -> list:
    """``cfg``'s parameters on ``meta``, in tree order."""
    import torch

    from repro_torch.models.api import Model
    from repro_torch.optim import tree as tree_util

    return tree_util.leaves(Model(cfg, torch.device("meta")).param_shapes())


def phase_multicard(smi: str | None = None, device_type: str = "cuda",
                    backend: str = "nccl", world: int | None = None,
                    parts=("fleet", "fsdp", "tp", "decode", "moe_full", "dense_full")):
    """The multi-card entry (every visible card, four on a host with four
    H100s; not part of ``main()``): (1) ``run_fleet`` over all 22
    fabrics unsharded on one card, then with ``mesh="auto"`` (the warm PDHG
    stages dealt over every card), both sweeps timed with their stages, each
    job held as in phase 14; (2) ``MULTI_TRAIN``: mamba2-130m at full size,
    llama3-8b and mixtral-8x7b at full width (2 layers), recurrentgemma-9b's
    first super-block and seamless (2 + 2 layers), one sequence a card,
    ``MESH_STEPS`` steps through ``Trainer`` on ``make_host_mesh()`` (FSDP
    over NCCL, one process a card), each in float32 (TF32 off; losses within
    ``MULTI_F32_REL`` of one card's on the same global batches) and in the
    models' bf16 (within ``MULTI_BF16_REL``, mixtral's printed; step time,
    tokens/s, each card's peak memory and the bytes of its shards, launches
    a card one card's); the bf16 runs of ``MULTI_TRAIN_RESTART`` also write
    gathered checkpoints, restore the 4-rank one on one card (its digest
    bit-equal to the logical state's), restart from step 2 (losses
    bit-equal) and remesh to two ranks (the logical state bit-equal, one
    step there); (3) FSDP × TP (``MULTI_TP``): llama3-8b at full width
    (2 layers) on 2×2 and 1×4, qwen3-14b (2 layers, qk-norm) on 2×2,
    mamba2-130m (SSD heads) on 2×2, mixtral-8x7b (2 layers, expert
    parallelism) on 2×2 and 1×4, recurrentgemma-9b (3 layers, RG-LRU
    channels) and seamless (2 + 2 layers) on 2×2, internvl2-1b at full size
    on 1×4 (unequal shares of its 14 heads), no leaf gathered whole,
    each in float32 and in bf16 against one card on the same global batches
    (those of the dp ranks' pipelines) within the same bounds (moe in bf16
    printed, not held), with the same numbers, the
    collectives recorded in the NCCL run equal op for op to the virtual
    mesh's record of the same step, and mamba2's bf16 2×2 checkpoint
    restored on one card bit for bit; (4) decode on the sharded mesh
    (``MULTI_DECODE``, :func:`multicard_decode`): ``make_serve_step`` with
    every cache leaf in its tile, ``MULTI_DECODE_STEPS`` steps from position
    ``MULTI_DECODE_START`` of a ``MULTI_DECODE_LEN`` cache filled from the seed, in
    float32 and bf16 against one card (logits within the same bounds of the
    largest logit, tokens equal), ms a token against one card, each card's
    peak memory and cache bytes, and NCCL's collectives equal to the virtual
    record; (5) the moe family at its published depth on 1×4
    (``MOE_FULL``, :func:`multicard_moe_full`); (6) the dense family at its
    published depth trained on 4×1 and 2×2, a block gathered at a time
    (``DENSE_FULL``, :func:`multicard_dense_full`).  ``parts`` picks among
    the six.  A CPU rehearsal passes
    ``device_type="cpu"``, ``backend="gloo"`` and ``world`` (with the
    configurations shrunk)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.train import run_ranks

    n = torch.cuda.device_count() if device_type == "cuda" else world
    if n is None or n < 2:
        fail(f"the multi-card entry needs several cards, sees {n}")
    if smi is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device(device_type)
    out = {}
    t_start = time.perf_counter()

    if "fleet" in parts:
        out["fleet"] = multicard_fleet(dev, n, smi)

    (ROOT / "build").mkdir(exist_ok=True)
    f32 = ("float32", dict(lr=1e-3, warmup_steps=1, eps=1e-3), MULTI_F32_REL)
    bf16 = (None, dict(lr=3e-4, warmup_steps=1), MULTI_BF16_REL)
    runs = []
    if "fsdp" in parts:
        runs += [(arch, layers, b, s, 1, *kind) for kind in (f32, bf16)
                 for arch, layers, b, s in MULTI_TRAIN]
    if "tp" in parts:
        runs += [(arch, layers, b, s, m, *kind) for kind in (f32, bf16)
                 for arch, layers, b, s, m in MULTI_TP]
    for arch, layers, b, s, model_axis, dtype, opt_kw, rel in runs:
        dp = n // model_axis
        label = f"{arch}{'' if layers is None else f' ({layers} layers)'} " \
                f"{dtype or 'bf16'}{'' if model_axis == 1 else f' on {dp}x{model_axis}'}"
        # the TP runs restore mamba2's 2×2 checkpoint alone
        restart = MULTI_TRAIN_RESTART if model_axis == 1 else ("mamba2-130m",)
        extras = dtype is None and arch.removesuffix("-reduced") in restart
        ckdir = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
        if device_type == "cuda":
            torch.cuda.empty_cache()
        try:
            t0 = time.perf_counter()
            ranks = run_ranks(_multicard_rank, n, arch, layers, b, s, dtype, opt_kw,
                              ckdir, extras, device_type, model_axis, backend=backend,
                              timeout=900)
            t_ranks = time.perf_counter() - t0
            want, t_one, peak_one, launch_one = _one_card_run(
                arch, layers, b, s, dtype, opt_kw, dp, dev)
            losses = ranks[0]["losses"]
            worst = max(abs(a - w) / abs(w) for a, w in zip(losses, want))
            # moe in bf16 is printed, not held: a routing flip at a near-tie
            # of two experts' bf16 probabilities makes one card's loss no
            # reference for four's (ROADMAP §3)
            held = not (dtype is None and _train_cfg(arch, layers, dtype).family == "moe")
            step_n = float(np.median(ranks[0]["step_times"][1:]))
            step_1 = float(np.median(t_one[1:]))
            log(f"multicard: {label}, B={b} ({b // dp} a dp rank, {dp} dp ranks), S={s}, "
                f"{MESH_STEPS} steps ({t_ranks:.1f} s with the ranks' start): losses "
                f"{losses} on {n} ranks (all ranks equal "
                f"{all(r['losses'] == losses for r in ranks)}) vs {want} on one card: "
                f"worst rel diff {worst:.3e} "
                f"({f'bound {rel:.3e}' if held else 'moe in bf16: printed, not held'}); "
                f"step {step_n * 1e3:.1f} ms "
                f"({b * s / step_n:.1f} tokens/s) vs {step_1 * 1e3:.1f} ms "
                f"({b * s / step_1:.1f} tokens/s); peak memory per card "
                f"{[r['peak_bytes'] for r in ranks]} B vs {peak_one} B; shard bytes "
                f"(parameters + moments) per card {[r['shard_bytes'] for r in ranks]}; "
                f"launches per card {[r['launches'] for r in ranks]} vs one card "
                f"{launch_one} ({smi})")
            if not all(r["losses"] == losses for r in ranks):
                fail(f"{label}: the ranks report different losses")
            if not (np.isfinite(losses).all() and (worst <= rel or not held)):
                fail(f"{label}: {n} ranks' losses {losses} vs one card's {want}")
            if any(r["launches"] != launch_one for r in ranks):
                fail(f"{label}: launches per card {[r['launches'] for r in ranks]} "
                     f"differ from one card's {launch_one}")
            out[label] = {"losses": losses, "one_card_losses": want, "worst_rel": worst,
                          "step_ms": step_n * 1e3, "one_card_step_ms": step_1 * 1e3,
                          "tokens_per_s": b * s / step_n,
                          "one_card_tokens_per_s": b * s / step_1,
                          "peak_bytes": [r["peak_bytes"] for r in ranks],
                          "one_card_peak_bytes": peak_one,
                          "shard_bytes": [r["shard_bytes"] for r in ranks],
                          "launches": ranks[0]["launches"]}
            if model_axis > 1:
                r0 = ranks[0]
                log(f"multicard: {label}: modes {r0['modes']}; the step's collectives "
                    f"recorded over NCCL equal the virtual mesh's op for op: "
                    f"{[r['ops_equal'] for r in ranks]} ({r0['n_ops']} ops, "
                    f"{r0['wire_bytes_per_chip']:.6e} wire bytes per chip)")
                if not all(r["ops_equal"] for r in ranks):
                    fail(f"{label}: the recorded collectives differ from the virtual "
                         f"mesh's")
                if "gathered" in r0["modes"]:
                    fail(f"{label}: a leaf is gathered whole over the model axis")
                out[label].update(modes=r0["modes"], n_ops=r0["n_ops"],
                                  wire_bytes_per_chip=r0["wire_bytes_per_chip"])
                if extras:
                    restored = _restore_digest(arch, layers, dtype, opt_kw, ckdir, dev)
                    log(f"multicard: {label}: the {dp}x{model_axis} step-{MESH_STEPS} "
                        f"checkpoint restored on one card bit-equal "
                        f"{restored == r0['digest']}")
                    if restored != r0["digest"]:
                        fail(f"{label}: the {dp}x{model_axis} checkpoint restored on one "
                             f"card differs")
                    out[label]["restore_bit_equal"] = True
            elif extras:
                r0 = ranks[0]
                restored = _restore_digest(arch, layers, dtype, opt_kw,
                                           pathlib.Path(ckdir) / "kept", dev)
                again = r0["restart_losses"]
                log(f"multicard: {label}: logical state (parameters + moments) "
                    f"{r0['logical_bytes']} B, per card {r0['shard_bytes']} B "
                    f"(share {r0['shard_bytes'] / r0['logical_bytes']:.4f}); the "
                    f"{n}-rank step-{MESH_STEPS} checkpoint restored on one card "
                    f"bit-equal {restored == r0['digest']}; restart from step 2 losses "
                    f"{again} vs {losses[2:]}: bit-equal {again == losses[2:]}; "
                    f"remesh {n} -> 2 ranks: logical state bit-equal "
                    f"{[r.get('remesh_digest') == r0['digest'] for r in ranks[:2]]}, "
                    f"events {[r['remesh_events'] for r in ranks]}, one step there: "
                    f"loss {[r.get('remesh_step_loss') for r in ranks[:2]]}")
                if restored != r0["digest"]:
                    fail(f"{label}: the {n}-rank checkpoint restored on one card differs")
                if again != losses[2:]:
                    fail(f"{label}: the restart's losses differ")
                if any(r.get("remesh_digest") != r0["digest"] for r in ranks[:2]) or \
                        not all(np.isfinite(r["remesh_step_loss"]) for r in ranks[:2]) or \
                        ranks[0]["remesh_step_loss"] != ranks[1]["remesh_step_loss"]:
                    fail(f"{label}: remesh to two ranks lost state or its step failed")
                out[label].update(restore_bit_equal=True, restart_bit_equal=True,
                                  remesh_loss=ranks[0]["remesh_step_loss"])
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
    if "decode" in parts:
        out["decode"] = multicard_decode(n, dev, smi, backend, device_type)
    if "moe_full" in parts:
        out["moe_full"] = multicard_moe_full(n, dev, smi, backend, device_type)
    if "dense_full" in parts:
        out["dense_full"] = multicard_dense_full(n, dev, smi, backend, device_type)
    log(f"multicard: total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"multicard": out}, default=float))
    return out


# ---- phase 15: the dry run and the training-traffic bridge -------------------

# the dry-run cells of phase 15 on 2×16×16: (arch, shape).  One microbatch:
# the flops do not depend on the count and the pod matrix is
# planned_collectives' at it (tests/test_torch_hlo_tools.py), and a step on
# meta costs host time per operator, so the reference's 8 would take ~4× as
# long
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
                ("mamba2-130m", "train_4k"), ("llama3-8b", "decode_32k"),
                ("mamba2-130m", "long_500k"), ("dbrx-132b", "decode_32k"),
                ("qwen3-14b", "train_4k"))
# llama3-8b decode_32k's cache a device on 2×16×16: 32 × 2 × 128 × 32768 × 8
# × 128 × 2 B over 512 devices
DRYRUN_CACHE_BYTES = {("llama3-8b", "decode_32k"): 2 ** 30}
# dbrx-132b decode_32k's parameter bytes a device as its layers take them,
# from the specs: 254,345,687,040 with every expert gathered whole, less
# 15/16 of the experts' 3·16·6144·10752·40 bf16 weights (253,671,505,920 B)
# with one of the 16 experts a model rank (expert parallelism)
DRYRUN_GATHERED_BYTES = {("dbrx-132b", "decode_32k"): 254_345_687_040
                         - 253_671_505_920 * 15 // 16}
# the bridge: llama3-8b's train_4k steps per second (benchmarks/bench_ml_fabric.py's
# JOBS), two jobs of two pods on a 4-pod fabric re-placed every two days
BRIDGE_STEPS_PER_S = 0.5
BRIDGE_PODS, BRIDGE_DAYS, BRIDGE_CHURN = 4, 6.0, 48
def _model_launches() -> tuple:
    """The model kernels' launch counts in this process: flash attention's
    forward and backward, the RG-LRU scan, the SSD chunk's forward and
    backward."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.rglru_scan import ops as rgops
    from repro_torch.kernels.ssd_chunk import ops as sdops

    return (faops.launches, faops.bwd_launches, rgops.launches, sdops.launches,
            sdops.bwd_launches)


def _launch_counts() -> dict:
    """``_model_launches()`` by name."""
    return dict(zip(("flash_fwd", "flash_bwd", "rglru", "ssd", "ssd_bwd"),
                    _model_launches()))


def _zero_launches():
    """Set the model kernels' launch counters to 0."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.rglru_scan import ops as rgops
    from repro_torch.kernels.ssd_chunk import ops as sdops

    faops.launches = faops.bwd_launches = rgops.launches = 0
    sdops.launches = sdops.bwd_launches = 0


def _dryrun_cell(arch, shape):
    """One phase-15 cell in a worker process (``run_cell`` on meta): its
    record, and the worker's model kernel launch counts before and after."""
    from repro_torch.launch import dryrun

    before = _model_launches()
    rec = dryrun.run_cell(arch, shape, True, force=True, microbatches=1, tag="mb1")
    return rec, before, _model_launches()


def _bridge_trace(interpod_bytes: float, seed: int = 0):
    """A 4-pod trace of churning llama3-8b jobs: each job on two pods sends
    ``interpod_bytes`` a step each way between them at ``BRIDGE_STEPS_PER_S``
    (in Gb/s, the fabric's unit), times a lognormal load factor per hour; the
    jobs re-place every ``BRIDGE_CHURN`` hours, as
    ``benchmarks/bench_ml_fabric.py`` builds its fleet."""
    import numpy as np

    from repro_torch.core.traffic import Trace

    v, t = BRIDGE_PODS, int(BRIDGE_DAYS * 24)
    gbps = interpod_bytes * BRIDGE_STEPS_PER_S * 8 / 1e9
    rng = np.random.default_rng(seed)
    demand = np.zeros((t, v * (v - 1)))
    pairs = []
    for step in range(t):
        if step % BRIDGE_CHURN == 0:
            pods = rng.permutation(v)
            pairs = [(int(pods[0]), int(pods[1])), (int(pods[2]), int(pods[3]))]
        for a, b in pairs:
            burst = rng.lognormal(0, 0.3)
            for i, j in ((a, b), (b, a)):
                demand[step, i * (v - 1) + (j if j < i else j - 1)] += gbps * burst
    return Trace("llama3-bridge", demand, 60.0, v), gbps


def _one_rank_traffic(device):
    """``Trainer.extract_traffic`` of mamba2-130m on the card's one-rank
    mesh: the reference's (1, 1) zero matrix."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_arch("mamba2-130m")
    model = build_model(cfg, device)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=1)
    tr = Trainer(model, AdamW(), make_host_mesh(), data, StepConfig(),
                 TrainerConfig(total_steps=1, devices_per_pod=1), ROOT / "build" / "ck15")
    params, state = tr.shard(model.init(0))
    tm = tr.extract_traffic(params, state, SyntheticLM(tr.data_config()).batch_at(0))
    log(f"dryrun: Trainer.extract_traffic on the one-rank mesh {dict(tr.mesh.shape)}: "
        f"{tm.tolist()}, collectives {tr.collectives['total_wire_bytes_per_chip']} B")
    if tm.shape != (1, 1) or tm.sum() != 0:
        fail(f"extract_traffic on one rank: {tm.tolist()} is not the (1, 1) zero matrix")
    del params, state, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return tm.tolist()


def start_dryrun_cells():
    """Start phase 15's dry-run cells, each in a worker process of its own
    (they run on ``meta`` and need no card): (pool, futures).  ``main()``
    starts them before the first phase, so the host's work overlaps the
    card's phases; the caller shuts the pool down."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        len(DRYRUN_CELLS), mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(_dryrun_cell, arch, shape) for arch, shape in DRYRUN_CELLS]


def phase_dryrun(device, smi: str = "", cells=None):
    """Phase 15 on one card: (a) the dry run (``repro_torch.launch.dryrun``)
    of llama3-8b train_4k, prefill_32k and decode_32k, of mamba2-130m
    train_4k (its SSD on unequal shares of its 24 heads on 16) and long_500k
    (its SSD leaves whole: the state split over N), of dbrx-132b decode_32k
    (expert parallelism: its parameter bytes a device held to the count from
    the specs, ``DRYRUN_GATHERED_BYTES``) and of qwen3-14b train_4k
    (attention on unequal shares of its 40 heads) on the 2×16×16 virtual
    mesh, each on ``meta`` in a worker process of its own, no leaf gathered
    whole in a train or prefill cell:
    flops per device,
    wire bytes per chip by kind, the 2×2 pod matrix, each matrix held to be
    symmetric, zero on the diagonal and equal to the count from
    ``param_shardings`` alone (``dryrun.planned_collectives``; decode's with
    the attention's combine), llama3-8b decode_32k's cache bytes a device
    (``DRYRUN_CACHE_BYTES``); (b) the bridge on the card: llama3-8b's
    inter-pod bytes a step, at ``BRIDGE_STEPS_PER_S``, placed as churning
    jobs on a 4-pod fabric, through ``repro_torch.core.run_controller`` on
    the H100 (p99.9 MLU finite, the batched linkload kernel launched: the
    bridge's controller configures no burst loss, so no queue loss); (c) ``Trainer.extract_traffic`` on the card's one-rank mesh,
    the reference's (1, 1) zero matrix, while the cells' workers run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import ControllerConfig, Strategy, run_controller
    from repro_torch.core.graph import Fabric
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.api import Model
    from repro_torch.models.config import ALL_SHAPES
    from repro_torch.runtime.hlo_traffic import pod_traffic_matrix

    t0 = time.perf_counter()
    model_launches = _model_launches()
    pool, futures = start_dryrun_cells() if cells is None else (None, cells)
    try:
        out = {"extract_traffic": _one_rank_traffic(device)}  # while the cells run
        if _model_launches() != model_launches:
            fail("dry run: Trainer.extract_traffic launched a kernel on meta tensors")
        done = [f.result() for f in futures]
    finally:
        if pool is not None:
            pool.shutdown()
    t_cells = time.perf_counter() - t0
    mesh = make_production_mesh(multi_pod=True)
    out["cells"] = {}
    for (arch, shape), (rec, before, after) in zip(DRYRUN_CELLS, done):
        label = f"{arch} {shape}"
        if before != after:
            fail(f"dry run {label}: a kernel launched on meta tensors in its worker "
                 f"(launch counts {before} -> {after})")
        if rec["status"] != "ok":
            fail(f"dry run {label}: {rec['status']}: {rec.get('error')}\n"
                 f"{rec.get('traceback', '')}")
        tm = np.asarray(rec["pod_tm_bytes"])
        cell = {s.name: s for s in ALL_SHAPES}[shape]
        planned = pod_traffic_matrix(dryrun.planned_collectives(
            Model(get_arch(arch), torch.device("meta")), mesh, cell.kind, cell), 256, 2)
        wire = {k: v["wire_bytes_per_chip"] for k, v in rec["collectives"].items()
                if isinstance(v, dict)}
        log(f"dryrun: {label} 2x16x16 (one microbatch): {rec['seconds']:.1f} s on meta, "
            f"flops per device {rec['flops']:.6e}, hbm bytes (unfused bound) "
            f"{rec['hbm_bytes']:.6e}, wire bytes per chip {wire}, pod TM "
            f"{tm.tolist()} (planned {planned.tolist()}), "
            f"{rec['n_collective_ops']} collectives, argument bytes "
            f"{rec['memory_analysis']['argument_bytes']}, gradient bytes "
            f"{rec['memory_analysis']['gradient_bytes']}, parameter bytes as the layers "
            f"take them {rec['memory_analysis']['gathered_param_bytes']}, cache bytes "
            f"{rec['memory_analysis']['cache_bytes']}, tensor parallel "
            f"{rec['tensor_parallel']}")
        if cell.kind != "decode" and rec["tensor_parallel"]["gathered"]:
            fail(f"dry run {label}: leaves gathered whole over the model axis: "
                 f"{rec['tensor_parallel']['gathered']}")
        want_cache = DRYRUN_CACHE_BYTES.get((arch, shape))
        if want_cache is not None and rec["memory_analysis"]["cache_bytes"] != want_cache:
            fail(f"dry run {label}: {rec['memory_analysis']['cache_bytes']} B of cache a "
                 f"device, expected {want_cache}")
        want_held = DRYRUN_GATHERED_BYTES.get((arch, shape))
        held = rec["memory_analysis"]["gathered_param_bytes"]
        if want_held is not None:
            log(f"dryrun: {label}: {held} B of parameters a device as the layers take "
                f"them (expected from the specs {want_held})")
            if held != want_held:
                fail(f"dry run {label}: {held} B of parameters a device, expected "
                     f"{want_held}")
        if not (tm.shape == (2, 2) and tm[0, 1] == tm[1, 0] > 0 and tm[0, 0] == tm[1, 1] == 0):
            fail(f"dry run {label}: pod TM {tm.tolist()} is not symmetric with a zero "
                 f"diagonal")
        if not np.array_equal(tm, planned):
            fail(f"dry run {label}: pod TM {tm.tolist()} != the count from "
                 f"param_shardings {planned.tolist()}")
        out["cells"][label] = {"seconds": rec["seconds"], "flops": rec["flops"],
                               "wire": wire, "pod_tm": tm.tolist()}
    log(f"dryrun: the cells' records {t_cells:.1f} s after the phase's start (a worker "
        f"each; {'started by main() before phase 1' if cells is not None else 'started here'})")

    # (b) the bridge: llama3-8b's measured inter-pod bytes a step on the card
    interpod = float(np.asarray(out["cells"]["llama3-8b train_4k"]["pod_tm"])[0, 1])
    trace, gbps = _bridge_trace(interpod)
    fabric = Fabric.homogeneous("bridge", BRIDGE_PODS, radix=64, speed=100.0)
    cc = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=2.0,
                          aggregation_days=1.0, k_critical=2)
    synchronize(device)
    llops.launches = qlops.launches = 0
    t1 = time.perf_counter()
    res = run_controller(fabric, trace, Strategy(False, True), cc, device=device)
    synchronize(device)
    t_bridge = time.perf_counter() - t1
    launches = {"linkload": llops.launches, "queueloss": qlops.launches}
    log(f"dryrun: bridge: {interpod:.6e} B a step each way between a job's pods at "
        f"{BRIDGE_STEPS_PER_S} steps/s = {gbps:.3f} Gb/s per direction; 2 jobs on a "
        f"{BRIDGE_PODS}-pod fabric (radix 64 × 100 Gb/s), {BRIDGE_DAYS} days hourly, "
        f"re-placed every {BRIDGE_CHURN} h: run_controller on {device} "
        f"{t_bridge:.3f} s, p99.9 MLU {res.summary['p999_mlu']:.6f}, stage_times "
        f"{ {k: round(v, 3) for k, v in res.stage_times.items()} }, launches {launches} "
        f"({smi})")
    if not np.isfinite(res.summary["p999_mlu"]):
        fail(f"bridge: p99.9 MLU {res.summary['p999_mlu']}")
    if launches["linkload"] < 1:  # scoring (no burst loss configured: no queue loss)
        fail(f"bridge: the linkload kernel did not launch: {launches}")
    out["bridge"] = {"gbps": gbps, "p999_mlu": res.summary["p999_mlu"],
                     "seconds": t_bridge, "launches": launches}

    out["seconds"] = time.perf_counter() - t0
    log(f"dryrun: phase 15 {out['seconds']:.1f} s")
    return launches, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    marks = {}
    dry_pool, dry_cells = start_dryrun_cells()  # phase 15's host work, from the start
    try:
        return _main(t_start, dev, marks, dry_cells)
    finally:
        dry_pool.shutdown(wait=True, cancel_futures=True)


def _main(t_start, dev, marks, dry_cells) -> int:
    def mark(phase):
        marks[phase] = round(time.perf_counter() - t_start, 3)

    smi, name, count = phase_card()
    phase_build()
    mark("build")
    rows = phase_kernels()
    single = phase_single_kernels()
    fleet = phase_fleet_kernels()
    model_rows = phase_model_kernels()
    phase_pdhg_check()
    mark("kernels")
    config = sweep_config(k_critical=SWEEP_K)
    counts, _ = phase_sweep(*config, device=dev)
    mark("batched")
    serve_counts, _ = phase_serve(*config, device=dev)
    mark("serve")
    seq_counts = phase_sequential(dev)
    mark("sequential")
    fleet_counts, _ = phase_fleet(fleet_config(), dev)
    mark("fleet")
    model_counts, _ = phase_models(dev)
    mark("models")
    config9 = transition_config()
    transition_counts, phase9 = phase_transition(*config9, device=dev)
    mark("transition")
    phase_gate_decide(dev)
    mark("gate_decide")
    failure_counts, fused_rows, _ = phase_failures(
        *config9, phase9["art"], phase9["staged_result"], device=dev)
    del phase9
    mark("failures")
    phase_autotune(dev)
    mark("autotune")
    family_launches, _ = phase_families(dev)
    mark("families")
    dense_launches, _ = phase_dense(dev, smi)
    mark("dense")
    train_counts, _ = phase_audio_train(dev, smi)
    mark("audio_train")
    phase_sharding(dev, smi)
    mark("sharding")
    bridge_counts, _ = phase_dryrun(dev, smi, dry_cells)
    mark("dryrun")
    for key in rows:
        rows[key]["launches"] = counts[key]
        rows[key]["launches_transition_phase"] = transition_counts[key]
        rows[key]["launches_bridge_phase"] = bridge_counts[key]
    for key in single:
        single[key]["launches"] = serve_counts[key]
        single[key]["launches_sequential_phase"] = seq_counts[key]
        fleet[key]["launches"] = fleet_counts[key]
        fleet[key]["launches_failures_phase"] = failure_counts[key]
        fleet[key]["failures_shape"] = fused_rows[key]
    for key in model_counts:
        model_rows[key]["launches"] = model_counts[key]
    model_rows["flash_attention"]["launches_families_phase"] = family_launches
    model_rows["flash_attention"]["launches_dense_phase"] = dense_launches["flash_attention"]
    model_rows["flash_attention_bwd"]["launches_dense_phase"] = \
        dense_launches["flash_attention_bwd"]
    model_rows["rglru_scan"]["launches_train_phase"] = train_counts["rglru"]
    model_rows["ssd_chunk"]["launches_train_phase"] = train_counts["ssd"]
    model_rows["flash_attention_bwd"]["launches"] = train_counts["flash_bwd"]
    model_rows["ssd_chunk_bwd"]["launches"] = train_counts["ssd_bwd"]
    log(f"phase end times (s since start) {marks}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows["linkload"], rows["queueloss"],
                                  single["linkload"], single["queueloss"],
                                  fleet["linkload"], fleet["queueloss"],
                                  model_rows["flash_attention"],
                                  model_rows["rglru_scan"],
                                  model_rows["ssd_chunk"],
                                  model_rows["flash_attention_bwd"],
                                  model_rows["ssd_chunk_bwd"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
