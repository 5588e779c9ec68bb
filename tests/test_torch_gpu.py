"""The CUDA kernels against their plain PyTorch versions on the card: the
batched entries at the batched engine's chip-scale shapes (B=672 and 96
epochs, T=3 / TS=36, C=E=132), the batched linkload also on both sides of its
staged body's row cut, with W at a storage offset, bit for bit against the
single-block and fleet entries, and its old body through the comparison
entry, the batched queue loss also past its fleet body (TS=512), the
single-block entries at the streaming controller's (T=3 /
TS=36), the whole-trace baseline's (T=4032) and, for the queue loss, one
sub-step and a block past one cluster's shared memory (TS=512), the fleet
entries at the 22-fabric fleet's 12-pod bucket (F=15 fabrics, B=96 blocks,
C=E=132) and 8-pod bucket (F=7, C=E=56), the fleet queue loss also past its
fleet body (TS=512), the single-block and fleet linkload on both sides of
their staged body's row cut and the single-block one at one row, and all at
ragged shapes (fleet: all-zero padded blocks);
the model kernels (flash attention, the RG-LRU scan, the SSD chunk scan) at
the model shapes of recurrentgemma-9b (the RG-LRU scan also at B = 1) and
mamba2-130m and at ragged ones; the redesigned RG-LRU, SSD, batched,
single-block and fleet linkload and queue-loss kernels give the same bits on
two calls, and the linkload entries and the model kernels take tensors that
are not 16-byte aligned; a small transition sweep, whose drain-stage
blocks move no other block's bits; the contingency evaluator's fused launch
of the fleet kernels, with dead links still carrying live W; a bf16 PDHG
batch; the moe prefill (mixtral with its window masking, dbrx) with the
sorted dispatch against the one-hot one, ring decode past the window against
the forward, the vlm prefill with patches, and the autotune table's round
trip (bodies launched through the wrappers, the PDHG knob resolved); flash
attention forward and backward at the dense family's head layouts
(gemma3-12b's 16/8 at hd 256, local and global; deepseek-7b's MHA) and its
backward at chip_smoke's four phase-3 shapes and five edge
shapes (bit for bit on a second call), the RG-LRU backward (two launches),
the SSD chunk backward (#9b) at mamba2-130m's training shape and the
forward's edge shapes (bit for bit on a second call, chunk-invariant, one
launch through ``SSDScan``), two train steps of the reduced llama3,
recurrentgemma and mamba2 models against the same steps on the CPU,
and seamless' reduced prefill (against the CPU's) and decode; the fleet
PDHG's deal over two shards of one card, and the FSDP step on a one-rank
NCCL mesh, each against the unsharded run.
Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one.  Run on the card with
``PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports the JAX package, which the
card's machine does not have).

Tolerances are the plain-version contracts: rtol 3e-4, atol 1e-4 for the
controller's kernels; for the model's those of the reference's kernel tests
(``tests/test_kernels_sweep.py``): flash attention 2e-3 in float32, the
RG-LRU scan 1e-4, the SSD scan relative 1e-3 (its backward: each gradient
within 1e-3 of its own max |ref|).  Flash attention in bfloat16 is
held to its float32 plain version within the bound on bf16 rounding
(``bf16_rounding_bound``), not to the reference's flat 3e-2, which is as large
as a typical output at a 256-key window.
"""

import pytest
import torch

from repro_torch.kernels.linkload import ops as llops
from repro_torch.kernels.linkload.ref import (linkload_metrics_batched_ref,
                                              linkload_metrics_fleet_ref,
                                              linkload_metrics_ref)
from repro_torch.kernels.flash_attention import ops as faops
from repro_torch.kernels.flash_attention.ref import attention_ref, bf16_rounding_bound
from repro_torch.kernels.queueloss import ops as qlops
from repro_torch.kernels.queueloss.ref import (queueloss_batched_ref,
                                               queueloss_fleet_ref,
                                               queueloss_ref)
from repro_torch.kernels.rglru_scan import ops as rlops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd_chunk import ops as sdops
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_chunk_ref_bwd

RTOL, ATOL = 3e-4, 1e-4


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _batched_linkload_inputs(gen, b, t, c, e):
    # dyadic data: every load is exact in f32, so OLR cannot flip on a tie
    d = torch.randint(0, 16, (b, t, c), generator=gen, device="cuda").float()
    w = torch.randint(0, 17, (b, c, e), generator=gen, device="cuda").float() / 16
    cap = 20.0 + 40.0 * torch.rand((b, e), generator=gen, device="cuda")
    inv_cap = torch.where(torch.rand((b, e), generator=gen, device="cuda") < 0.1,
                          0.0, 1.0 / cap)
    return d, w, inv_cap


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c,e", [(672, 3, 132, 132), (4, 13, 30, 200),
                                     (96, 3, 132, 132),        # the batched engine's
                                     (5, "cut", 132, 132),      # the staged body's longest
                                     (5, "past_cut", 132, 132)])  # the batched body
def test_linkload_kernel_matches_plain(gen, b, t, c, e):
    """The staged body over the epochs up to its row cut, the batched body
    past it; one launch counted either way, the same bits on a second call."""
    if isinstance(t, str):
        t = _single_rows_cut(c, e) + (t == "past_cut")
    assert llops._single_fits(t, c, e) == (t <= _single_rows_cut(c, e))
    d, w, inv_cap = _batched_linkload_inputs(gen, b, t, c, e)
    before = llops.launches
    out = llops.linkload_batched(d, w, inv_cap, 0.8)
    ref = linkload_metrics_batched_ref(d, w, inv_cap, 0.8)
    assert llops.launches == before + 1
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
    second = llops.linkload_batched(d, w, inv_cap, 0.8)
    assert all(torch.equal(x, y) for x, y in zip(out, second))


@pytest.mark.gpu
def test_linkload_kernel_takes_unaligned_w(gen):
    """W at a storage offset (not 16-byte aligned) takes the 4-byte copies."""
    d, w, inv_cap = _batched_linkload_inputs(gen, 96, 3, 132, 132)
    out = llops.linkload_batched(d, _unaligned(w), inv_cap, 0.8)
    for a, r in zip(out, linkload_metrics_batched_ref(d, w, inv_cap, 0.8)):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [96, 672])
def test_linkload_kernel_is_the_single_and_fleet_entries_bits(gen, b):
    """One body, one order of sums: each epoch's bits are the single-block
    entry's and the fleet entry's at F = 1, so the batched engine scores an
    epoch as the streaming controller and the fleet engine do."""
    args = _batched_linkload_inputs(gen, b, 3, 132, 132)
    out = llops.linkload_batched(*args, 0.8)
    fleet = llops.linkload_fleet(*(x[None] for x in args), 0.8)
    assert all(torch.equal(x, y[0]) for x, y in zip(out, fleet))
    for bi in (0, b // 2, b - 1):
        single = llops.linkload(*(x[bi] for x in args), 0.8)
        assert all(torch.equal(x[bi], y) for x, y in zip(out, single))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c,e", [(96, 3, 132, 132), (4, 13, 30, 200)])
def test_linkload_batched_body_matches_plain(gen, b, t, c, e):
    """The comparison entry (the batched body whatever the shape) against
    the plain version; it counts no launch."""
    d, w, inv_cap = _batched_linkload_inputs(gen, b, t, c, e)
    before = llops.launches
    out = llops._linkload_tiles(d, w, inv_cap, 0.8)
    assert llops.launches == before
    for a, r in zip(out, linkload_metrics_batched_ref(d, w, inv_cap, 0.8)):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


def _batched_queueloss_inputs(gen, b, ts, c, e):
    d = torch.rand((b, ts, c), generator=gen, device="cuda") * 20.0
    w = torch.rand((b, c, e), generator=gen, device="cuda")
    w = w * (torch.rand((b, c, e), generator=gen, device="cuda") < 0.08)
    cap = 40.0 + 80.0 * torch.rand((b, e), generator=gen, device="cuda")
    cap = torch.where(torch.rand((b, e), generator=gen, device="cuda") < 0.1, 0.0, cap)
    return d, w, cap, cap * 0.025


@pytest.mark.gpu
@pytest.mark.parametrize("b,ts,c,e", [(672, 36, 132, 132), (4, 45, 30, 300),
                                      (96, 36, 132, 132),   # the batched engine's
                                      (4, 512, 132, 132)])  # past the fleet body
def test_queueloss_kernel_matches_plain(gen, b, ts, c, e):
    """The fleet body over the epochs where it fits, the E-tiled body and its
    partials pass past it (TS = 512); one launch counted either way."""
    assert qlops._fleet_fits(ts, c, e) == (ts != 512)
    d, w, cap, buf = _batched_queueloss_inputs(gen, b, ts, c, e)
    before = qlops.launches
    out = qlops.queueloss_batched(d, w, cap, buf, 30.0)
    ref = queueloss_batched_ref(d, w, cap, buf, 30.0)
    assert qlops.launches == before + 1
    assert float(ref[0].sum()) > 0.0
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_batched_queueloss_kernel_is_deterministic(gen):
    """No atomics: two calls at the batched engine's shape give the same
    bits, one launch counted each; at E <= 160 they are the E-tiled body's
    bits too (the fleet body sums the links in its order)."""
    args = _batched_queueloss_inputs(gen, 96, 36, 132, 132)
    before = qlops.launches
    first = qlops.queueloss_batched(*args, 30.0)
    second = qlops.queueloss_batched(*args, 30.0)
    assert qlops.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(first, qlops._queueloss_tiles(*args, 30.0)))


def _single_rows_cut(c, e):
    """The longest block the staged linkload body takes at (C, E)."""
    t = 0
    while llops._single_fits(t + 1, c, e):
        t += 1
    return t


def _single_linkload_inputs(gen, t, c, e):
    # dyadic data: every load is exact in f32, so OLR cannot flip on a tie
    d = torch.randint(0, 16, (t, c), generator=gen, device="cuda").float()
    w = torch.randint(0, 17, (c, e), generator=gen, device="cuda").float() / 16
    cap = 20.0 + 40.0 * torch.rand(e, generator=gen, device="cuda")
    inv_cap = torch.where(torch.rand(e, generator=gen, device="cuda") < 0.1,
                          0.0, 1.0 / cap)
    return d, w, inv_cap


@pytest.mark.gpu
@pytest.mark.parametrize("t,c,e", [(3, 132, 132), (4032, 132, 132), (13, 30, 200),
                                   (1, 132, 132), ("cut", 132, 132),
                                   ("past_cut", 132, 132)])
def test_single_linkload_kernel_matches_plain(gen, t, c, e):
    """The single-block body up to its row cut, the batched body over one
    pair past it (the whole-trace T = 4032 among them); one launch each."""
    if isinstance(t, str):
        t = _single_rows_cut(c, e) + (t == "past_cut")
    assert llops._single_fits(t, c, e) == (t <= _single_rows_cut(c, e))
    if t == 4032:
        assert not llops._single_fits(t, c, e)
    d, w, inv_cap = _single_linkload_inputs(gen, t, c, e)
    before = llops.single_launches
    out = llops.linkload(d, w, inv_cap, 0.8)
    ref = linkload_metrics_ref(d, w, inv_cap, 0.8)
    assert llops.single_launches == before + 1
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_single_linkload_kernel_takes_unaligned_w(gen):
    """W at a storage offset (not 16-byte aligned) takes the 4-byte copies."""
    d, w, inv_cap = _single_linkload_inputs(gen, 3, 132, 132)
    out = llops.linkload(d, _unaligned(w), inv_cap, 0.8)
    for a, r in zip(out, linkload_metrics_ref(d, w, inv_cap, 0.8)):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_single_linkload_kernel_is_deterministic(gen):
    """No atomics: two calls at the streaming controller's shape give the
    same bits, one launch counted each."""
    args = _single_linkload_inputs(gen, 3, 132, 132)
    before = llops.single_launches
    first = llops.linkload(*args, 0.8)
    second = llops.linkload(*args, 0.8)
    assert llops.single_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _single_queueloss_inputs(gen, ts, c, e):
    d = torch.rand((ts, c), generator=gen, device="cuda") * 20.0
    w = torch.rand((c, e), generator=gen, device="cuda")
    w = w * (torch.rand((c, e), generator=gen, device="cuda") < 0.08)
    cap = 40.0 + 80.0 * torch.rand(e, generator=gen, device="cuda")
    cap = torch.where(torch.rand(e, generator=gen, device="cuda") < 0.1, 0.0, cap)
    return d, w, cap, cap * 0.025


@pytest.mark.gpu
@pytest.mark.parametrize("ts,c,e", [(36, 132, 132), (45, 30, 300), (1, 132, 132),
                                    (512, 132, 132)])  # the last: two launches
def test_single_queueloss_kernel_matches_plain(gen, ts, c, e):
    d, w, cap, buf = _single_queueloss_inputs(gen, ts, c, e)
    before = qlops.single_launches
    out = qlops.queueloss(d, w, cap, buf, 30.0)
    ref = queueloss_ref(d, w, cap, buf, 30.0)
    assert qlops.single_launches == before + 1
    assert float(ref[0].sum()) > 0.0
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_single_queueloss_kernel_is_deterministic(gen):
    """No atomics: two calls at the streaming controller's shape give the
    same bits, one launch counted each."""
    args = _single_queueloss_inputs(gen, 36, 132, 132)
    before = qlops.single_launches
    first = qlops.queueloss(*args, 30.0)
    assert qlops.single_launches == before + 1
    second = qlops.queueloss(*args, 30.0)
    assert qlops.single_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _pad_blocks(n_blocks, *tensors):
    """Zero every fabric's blocks past its own count (a ragged bucket)."""
    for t in tensors:
        for fi, nb in enumerate(n_blocks):
            t[fi, nb:] = 0.0


def _fleet_linkload_inputs(gen, f, b, t, c, e, n_blocks=None):
    # dyadic data: every load is exact in f32, so OLR cannot flip on a tie
    d = torch.randint(0, 16, (f, b, t, c), generator=gen, device="cuda").float()
    w = torch.randint(0, 17, (f, b, c, e), generator=gen, device="cuda").float() / 16
    cap = 20.0 + 40.0 * torch.rand((f, b, e), generator=gen, device="cuda")
    inv_cap = torch.where(torch.rand((f, b, e), generator=gen, device="cuda") < 0.1,
                          0.0, 1.0 / cap)
    if n_blocks is not None:
        _pad_blocks(n_blocks, d, w, inv_cap)
    return d, w, inv_cap


@pytest.mark.gpu
@pytest.mark.parametrize("f,b,t,c,e,n_blocks", [
    (15, 96, 3, 132, 132, None), (3, 5, 13, 30, 200, (5, 2, 4)),
    (7, 96, 3, 56, 56, None),          # the 8-pod bucket
    (2, 3, "cut", 132, 132, None),     # the staged body's longest block
    (2, 3, "past_cut", 132, 132, None)])  # past it: the batched body
def test_fleet_linkload_kernel_matches_plain(gen, f, b, t, c, e, n_blocks):
    """The staged body up to its row cut, the batched body over the F*B
    pairs past it; one launch counted either way."""
    if isinstance(t, str):
        t = _single_rows_cut(c, e) + (t == "past_cut")
    assert llops._single_fits(t, c, e) == (t <= _single_rows_cut(c, e))
    d, w, inv_cap = _fleet_linkload_inputs(gen, f, b, t, c, e, n_blocks)
    before = llops.fleet_launches
    out = llops.linkload_fleet(d, w, inv_cap, 0.8)
    ref = linkload_metrics_fleet_ref(d, w, inv_cap, 0.8)
    assert llops.fleet_launches == before + 1
    for a, r in zip(out, ref):
        assert a.shape == (f, b, t)
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fleet_linkload_kernel_is_deterministic(gen):
    """No atomics: two calls at the 12-pod bucket give the same bits, one
    launch counted each; each pair's bits are the single-block entry's (one
    body, one order of sums)."""
    args = _fleet_linkload_inputs(gen, 15, 96, 3, 132, 132)
    before = llops.fleet_launches
    first = llops.linkload_fleet(*args, 0.8)
    second = llops.linkload_fleet(*args, 0.8)
    assert llops.fleet_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    for fi, bi in ((0, 0), (7, 50), (14, 95)):
        single = llops.linkload(*(x[fi, bi].contiguous() for x in args), 0.8)
        assert all(torch.equal(x[fi, bi], y) for x, y in zip(first, single))


@pytest.mark.gpu
def test_fleet_linkload_kernel_takes_unaligned_w(gen):
    """W at a storage offset (not 16-byte aligned) takes the 4-byte copies."""
    d, w, inv_cap = _fleet_linkload_inputs(gen, 15, 96, 3, 132, 132)
    out = llops.linkload_fleet(d, _unaligned(w), inv_cap, 0.8)
    for a, r in zip(out, linkload_metrics_fleet_ref(d, w, inv_cap, 0.8)):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


def _fleet_queueloss_inputs(gen, f, b, ts, c, e, n_blocks):
    d = torch.rand((f, b, ts, c), generator=gen, device="cuda") * 20.0
    w = torch.rand((f, b, c, e), generator=gen, device="cuda")
    w = w * (torch.rand((f, b, c, e), generator=gen, device="cuda") < 0.08)
    cap = 40.0 + 80.0 * torch.rand((f, b, e), generator=gen, device="cuda")
    cap = torch.where(torch.rand((f, b, e), generator=gen, device="cuda") < 0.1,
                      0.0, cap)
    if n_blocks is not None:
        _pad_blocks(n_blocks, d, w, cap)
    return d, w, cap, cap * 0.025


@pytest.mark.gpu
@pytest.mark.parametrize("f,b,ts,c,e,n_blocks", [
    (15, 96, 36, 132, 132, None), (3, 4, 45, 30, 300, (4, 1, 3)),
    (7, 96, 36, 56, 56, None),     # the 8-pod bucket
    (2, 3, 512, 132, 132, None)])  # past the fleet body: the batched body
def test_fleet_queueloss_kernel_matches_plain(gen, f, b, ts, c, e, n_blocks):
    assert qlops._fleet_fits(ts, c, e) == (ts != 512)
    d, w, cap, buf = _fleet_queueloss_inputs(gen, f, b, ts, c, e, n_blocks)
    before = qlops.fleet_launches
    out = qlops.queueloss_fleet(d, w, cap, buf, 30.0)
    ref = queueloss_fleet_ref(d, w, cap, buf, 30.0)
    assert qlops.fleet_launches == before + 1
    assert float(ref[0].sum()) > 0.0
    for a, r in zip(out, ref):
        assert a.shape == (f, b, ts)
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fleet_queueloss_kernel_is_deterministic(gen):
    """No atomics: two calls at the 12-pod bucket give the same bits, one
    launch counted each."""
    args = _fleet_queueloss_inputs(gen, 15, 96, 36, 132, 132, None)
    before = qlops.fleet_launches
    first = qlops.queueloss_fleet(*args, 30.0)
    second = qlops.queueloss_fleet(*args, 30.0)
    assert qlops.fleet_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_in", [("linkload", 3), ("queueloss", 4)])
def test_fleet_entry_refuses_an_oversize_grid(gen, name, n_in):
    """F·B pairs whose CTA count passes gridDim.x's limit (2^31 - 1) are
    refused with cudaErrorInvalidConfiguration before anything launches:
    the count is formed in 64 bits, never truncated, so the null pointers
    below never reach a kernel."""
    import ctypes

    from repro_torch.kernels import _build

    fn = getattr(_build.library(name), f"{name}_fleet")
    # n_in inputs, the threshold / dt, four outputs, F, B, T, C, E, stream
    fn.argtypes = ([ctypes.c_void_p] * n_in + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(*[None] * n_in, 0.8, *[None] * 4, 1 << 16, 1 << 16, 8, 4, 4,
            torch.cuda.current_stream().cuda_stream)  # 2^32 pairs
    assert rc == 9  # cudaErrorInvalidConfiguration
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,dtype,tol", [
    (1, 1024, 4, 1, 256, True, 256, torch.bfloat16, None),  # recurrentgemma
    (1, 4096, 2, 1, 256, True, 2048, torch.bfloat16, None),  # its band at S 4096
    # ragged bf16: hd not a multiple of 16, Sq not a multiple of the q-tile
    (1, 1000, 8, 2, 100, False, 48, torch.bfloat16, None),
    (2, 130, 4, 2, 32, True, 0, torch.bfloat16, None),
    # a tensor-parallel rank's uneven head shares: internvl2-1b's 14 heads on
    # a model axis of 4 (4 or 3 a rank), qwen3-14b's 40 on 16 (3 or 2)
    (4, 2048, 4, 1, 64, True, 0, torch.bfloat16, None),
    (4, 2048, 3, 1, 64, True, 0, torch.bfloat16, None),
    (1, 4096, 3, 1, 128, True, 0, torch.bfloat16, None),
    (1, 4096, 2, 1, 128, True, 0, torch.bfloat16, None),
    # the dense family's head layouts (chip_smoke's DENSE_FLASH at a small S):
    # gemma3-12b's 16 heads on 8 KV heads at hd 256, local (window 1024) and
    # global; deepseek-7b's MHA, 32 on 32 at hd 128
    (1, 2048, 16, 8, 256, True, 1024, torch.bfloat16, None),
    (1, 2048, 16, 8, 256, True, 0, torch.bfloat16, None),
    (1, 1024, 32, 32, 128, True, 0, torch.bfloat16, None),
    (1, 1024, 4, 1, 256, True, 256, torch.float32, 2e-3),
    (1, 1000, 4, 1, 100, False, 48, torch.float32, 2e-3),   # ragged
    (2, 130, 4, 2, 32, True, 0, torch.float32, 2e-3)])
def test_flash_attention_kernel_matches_plain(gen, b, s, h, kv, hd, causal,
                                              window, dtype, tol):
    q = torch.randn((b * h, s, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b * kv, s, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b * kv, s, hd), generator=gen, device="cuda").to(dtype)
    args = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
    before = faops.launches
    out = faops.flash_attention_rows(q, k, v, **args)
    assert faops.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    if tol is None:  # bf16: the float32 plain version within bf16 rounding
        ref, bound = bf16_rounding_bound(q, k, v, **args)
        assert float(((out.float() - ref).abs() / bound).max()) <= 1.0
    else:
        torch.testing.assert_close(out, attention_ref(q, k, v, **args),
                                   rtol=tol, atol=tol)


def _unaligned(t):
    """A contiguous copy of ``t`` one element past an aligned allocation, so
    its address is not a multiple of 16 bytes."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.gpu
def test_flash_attention_kernel_takes_unaligned_views(gen):
    """Tensors that are not 16-byte aligned take the element-by-element copies."""
    q, k, v = (torch.randn((n, 300, 64), generator=gen, device="cuda").bfloat16()
               for n in (4, 2, 2))
    args = dict(n_heads=2, n_kv=1, causal=True, window=0)
    ref, bound = bf16_rounding_bound(q, k, v, **args)
    before = faops.launches
    out = faops.flash_attention_rows(*map(_unaligned, (q, k, v)), **args)
    assert faops.launches == before + 1
    assert float(((out.float() - ref).abs() / bound).max()) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(2, 4096, 4096), (3, 37, 31), (2, 513, 130),
                                   (1, 4096, 4096), (2, 4097, 4096),
                                   (2, 4096, 2048)])  # a tensor-parallel rank's channels
def test_rglru_scan_kernel_matches_plain(gen, b, s, d):
    a = 0.8 + 0.199 * torch.rand((b, s, d), generator=gen, device="cuda")
    x = 0.5 * torch.randn((b, s, d), generator=gen, device="cuda")
    before = rlops.launches
    out = rlops.rglru_scan(a, x)
    assert rlops.launches == before + 1
    torch.testing.assert_close(out, rglru_scan_ref(a, x), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_rglru_scan_kernel_is_deterministic(gen):
    """The chunks combine in a fixed order: two calls at recurrentgemma-9b's
    shape give the same bits, one launch counted each."""
    a = 0.8 + 0.199 * torch.rand((2, 4096, 4096), generator=gen, device="cuda")
    x = 0.5 * torch.randn((2, 4096, 4096), generator=gen, device="cuda")
    before = rlops.launches
    first = rlops.rglru_scan(a, x)
    assert rlops.launches == before + 1
    second = rlops.rglru_scan(a, x)
    assert rlops.launches == before + 2
    assert torch.equal(first, second)


def _ssd_inputs(gen, b, h, s, p, n):
    x = torch.randn((b, h, s, p), generator=gen, device="cuda")
    dt = 0.001 + 0.099 * torch.rand((b, h, s, 1), generator=gen, device="cuda")
    a = -(1.0 + 7.0 * torch.rand((h, 1, 1, 1), generator=gen, device="cuda"))
    bm = torch.randn((b, 1, s, n), generator=gen, device="cuda")
    cm = torch.randn((b, 1, s, n), generator=gen, device="cuda")
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (4, 24, 4096, 64, 128, 64),  # mamba2-130m
    (4, 12, 4096, 64, 128, 64),  # its heads on a model axis of 2
    (4, 6, 4096, 64, 128, 64),   # and of 4
    (4, 2, 4096, 64, 128, 64),   # its uneven shares on 16 (1 or 2 a rank)
    (4, 1, 4096, 64, 128, 64),
    (1, 3, 96, 32, 16, 64),      # ragged: the chunk halves to 32
    (2, 2, 256, 64, 128, 128),
    (1, 2, 64, 64, 128, 64),     # one chunk: nothing carries
    (2, 2, 4096, 64, 128, 128),  # 32 chunks of 128
    (1, 2, 37, 30, 18, 37)])     # Q, N, P not multiples of 4: scalar copies
def test_ssd_chunk_kernel_matches_plain(gen, b, h, s, p, n, chunk):
    args = _ssd_inputs(gen, b, h, s, p, n)
    before = sdops.launches
    out = sdops.ssd_scan(*args, chunk)
    assert sdops.launches == before + 1
    ref = ssd_chunk_ref(*args, chunk=min(chunk, 32) if s % chunk else chunk)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-3


@pytest.mark.gpu
def test_ssd_chunk_kernel_is_chunk_invariant(gen):
    args = _ssd_inputs(gen, 1, 2, 256, 64, 64)
    torch.testing.assert_close(sdops.ssd_scan(*args, 64), sdops.ssd_scan(*args, 128),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ssd_chunk_kernel_is_deterministic(gen):
    """No atomics: two calls at mamba2-130m's shape give the same bits."""
    args = _ssd_inputs(gen, 4, 24, 4096, 64, 128)
    before = sdops.launches
    first = sdops.ssd_scan(*args, 64)
    assert sdops.launches == before + 1
    second = sdops.ssd_scan(*args, 64)
    assert sdops.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_ssd_chunk_kernel_takes_unaligned_views(gen):
    """Tensors that are not 16-byte aligned take the element-by-element copies."""
    args = _ssd_inputs(gen, 1, 2, 256, 64, 64)
    before = sdops.launches
    out = sdops.ssd_scan(*map(_unaligned, args), 64)
    assert sdops.launches == before + 1
    ref = ssd_chunk_ref(*args, chunk=64)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-3


def _ssd_bwd_check(got, want):
    """Each of the five gradients within 1e-3 of its own max |ref| (the SSD
    forward's contract)."""
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) < 1e-3 * float(w.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (4, 24, 4096, 64, 128, 64),  # mamba2-130m's training shape
    (4, 12, 4096, 64, 128, 64),  # its heads on a model axis of 2
    (4, 6, 4096, 64, 128, 64),   # and of 4
    (4, 2, 4096, 64, 128, 64),   # its uneven shares on 16 (1 or 2 a rank)
    (4, 1, 4096, 64, 128, 64),
    (1, 3, 96, 32, 16, 64),      # ragged: the chunk halves to 32
    (2, 2, 256, 64, 128, 128),   # chunks of 128: the backward walks 64
    (1, 2, 64, 64, 128, 64),     # one chunk: nothing carries
    (2, 2, 4096, 64, 128, 128),  # 32 chunks of 128
    (1, 2, 37, 30, 18, 37),      # Q, N, P not multiples of 4: scalar copies
    (1, 5, 256, 64, 128, 64),    # an odd head count: the copy ring's slots rotate unevenly
    (1, 2, 256, 64, 128, 16)])   # chunks of 16: a single MMA row tile
def test_ssd_chunk_backward_matches_plain(gen, b, h, s, p, n, chunk):
    args = _ssd_inputs(gen, b, h, s, p, n)
    dy = torch.randn((b, h, s, p), generator=gen, device="cuda")
    before = sdops.bwd_launches
    got = sdops.ssd_scan_bwd(*args, dy, chunk)
    assert sdops.bwd_launches == before + 1
    _ssd_bwd_check(got, ssd_chunk_ref_bwd(*args, dy, min(chunk, 32) if s % chunk else chunk))


@pytest.mark.gpu
def test_ssd_chunk_backward_is_deterministic(gen):
    """No atomics: two calls at mamba2-130m's shape give the same bits."""
    args = _ssd_inputs(gen, 4, 24, 4096, 64, 128)
    dy = torch.randn((4, 24, 4096, 64), generator=gen, device="cuda")
    first = sdops.ssd_scan_bwd(*args, dy, 64)
    second = sdops.ssd_scan_bwd(*args, dy, 64)
    assert all(torch.equal(f, g) for f, g in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("short,long", [(32, 64), (64, 128)])
def test_ssd_chunk_backward_is_chunk_invariant(gen, short, long):
    """The gradients at two chunk lengths agree within 1e-4 of each one's
    max |g| (the forward's chunk invariance); chunk 128 is walked as 64."""
    args = _ssd_inputs(gen, 1, 2, 256, 64, 64)
    dy = torch.randn((1, 2, 256, 64), generator=gen, device="cuda")
    for g, w in zip(sdops.ssd_scan_bwd(*args, dy, short),
                    sdops.ssd_scan_bwd(*args, dy, long)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.gpu
def test_ssd_scan_with_grad_launches_the_backward_kernel(gen):
    """``ssd_scan`` with grad on CUDA tensors goes through ``SSDScan``: one
    forward launch, one backward launch, the plain version on neither."""
    args = [t.requires_grad_() for t in _ssd_inputs(gen, 2, 4, 256, 64, 128)]
    dy = torch.randn((2, 4, 256, 64), generator=gen, device="cuda")
    fwd, bwd = sdops.launches, sdops.bwd_launches
    got = torch.autograd.grad(sdops.ssd_scan(*args, 64), args, dy)
    assert (sdops.launches, sdops.bwd_launches) == (fwd + 1, bwd + 1)
    _ssd_bwd_check(got, ssd_chunk_ref_bwd(*args, dy, 64))


@pytest.mark.gpu
def test_transition_sweep_moves_no_unstaged_block(gen):
    """A small transition sweep on the card (F18, 6 pods, forced staging):
    one plan, executed as planned and with its drain staging dropped.  The
    splits are bit-equal (the same PDHG batch), and so is every interval of
    an unstaged epoch: each block is its own CTA of #1 and #2, so the extra
    stage blocks move no other block's bits.  The stage intervals do move,
    and each execute launches #1 and #2 once."""
    import dataclasses

    import numpy as np

    from repro_torch.burst import LossConfig
    from repro_torch.core import ControllerConfig, SolverConfig, Strategy
    from repro_torch.core.engine import execute_plan, plan_artifacts
    from repro_torch.core.fleet import (FLEET_SPECS, make_fabric, make_trace,
                                        sub_burst_params)
    from repro_torch.transition import TransitionConfig

    spec = FLEET_SPECS[17]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=4.0, interval_minutes=60.0)
    cc = ControllerConfig(routing_interval_hours=3.0, topology_interval_days=1.0,
                          aggregation_days=2.0, k_critical=4,
                          loss=LossConfig(burst=sub_burst_params(spec)),
                          transition=TransitionConfig(decide=False))
    strategy, sc = Strategy(True, True), SolverConfig()
    art = plan_artifacts(fab, trace, strategy, cc, sc, device="cuda")
    staged = [i for i, ev in enumerate(art.staging) if ev is not None]
    assert staged and art.transition_log
    runs = []
    for a in (art, dataclasses.replace(art, staging=(None,) * len(art.staging))):
        before = (llops.launches, qlops.launches)
        runs.append(execute_plan(fab, trace, strategy, cc, sc, a, device="cuda"))
        assert (llops.launches, qlops.launches) == (before[0] + 1, before[1] + 1)
    on, off = runs
    np.testing.assert_array_equal(on.splits, off.splits)
    rows = np.zeros(on.metrics.mlu.shape, bool)
    for i in staged:
        ep = art.plan.epochs[i]
        rows[ep.start - art.plan.agg: ep.stop - art.plan.agg] = True
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        np.testing.assert_array_equal(getattr(on.metrics, field)[~rows],
                                      getattr(off.metrics, field)[~rows])
    assert not np.array_equal(on.metrics.mlu[rows], off.metrics.mlu[rows])


@pytest.mark.gpu
def test_fused_contingency_launch_matches_plain_with_dead_links(gen):
    """The contingency evaluator's fused launch of the fleet kernels: K = 16
    scenario rows of one F21 plan (C = E = 132), the masks killing whole
    links while the plan's W still points at them (``inv_cap = 0``,
    ``buf = 0``).  The card against the plain versions on the CPU at the
    kernels' rtol/atol, against the float64 oracle at 1e-5 (the contingency
    contract), one launch of each fleet kernel, the same bits on a second
    call."""
    import numpy as np

    from repro_torch.burst import LossConfig
    from repro_torch.core.fleet import (FLEET_SPECS, make_fabric, make_trace,
                                        sub_burst_params)
    from repro_torch.core.graph import uniform_topology
    from repro_torch.core.paths import build_paths, routing_weight_matrices
    from repro_torch.core.rounding import realize
    from repro_torch.failures import (FailureConfig, contingency_metrics,
                                      sample_masks)

    spec = FLEET_SPECS[20]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=1.0, interval_minutes=5.0)
    paths = build_paths(fab.n_pods)
    rng = np.random.default_rng(0)
    b = 12
    f = rng.random((b, paths.n_paths))
    for ps in paths.commodity_paths:
        f[:, ps] /= f[:, ps].sum(axis=1, keepdims=True)
    w = routing_weight_matrices(paths, f)
    caps = np.stack([fab.capacities(realize(fab, uniform_topology(fab))[0])] * b)
    blocks = [trace.demand[3 * i: 3 * i + 3] for i in range(b)]
    _, masks = sample_masks(fab, FailureConfig(n_scenarios=16, p_link=0.05,
                                               p_trunk=0.1, p_panel=0.3,
                                               p_pod=0.1))
    assert (masks == 0).any()
    kw = dict(loss_cfg=LossConfig(burst=sub_burst_params(spec)),
              loss_seeds=list(range(b)), interval_seconds=300.0)
    before = (llops.fleet_launches, qlops.fleet_launches)
    card = contingency_metrics(blocks, w, caps, masks, backend="torch",
                               device="cuda", **kw)
    assert (llops.fleet_launches, qlops.fleet_launches) == (before[0] + 1,
                                                            before[1] + 1)
    plain = contingency_metrics(blocks, w, caps, masks, backend="torch",
                                device="cpu", **kw)
    oracle = contingency_metrics(blocks, w, caps, masks, backend="numpy", **kw)
    again = contingency_metrics(blocks, w, caps, masks, backend="torch",
                                device="cuda", **kw)
    for a, p, o, s in zip(card, plain, oracle, again):
        for field in ("mlu", "alu", "olr", "stretch", "loss"):
            x = getattr(a, field)
            np.testing.assert_allclose(x, getattr(p, field), rtol=RTOL,
                                       atol=ATOL, err_msg=field)
            np.testing.assert_allclose(x, getattr(o, field), atol=1e-5,
                                       err_msg=field)
            np.testing.assert_array_equal(x, getattr(s, field))


@pytest.mark.gpu
def test_bf16_pdhg_batch_on_the_card(gen):
    """bf16 PDHG on the card: its bf16 GEMMs with a float32 output give the
    CPU's upcast arithmetic up to the order of sums, the batch's u* is
    within 1 % of the f32 batch's on the card, and the reported u is the
    float32 evaluation of the returned flows."""
    import numpy as np

    from repro_torch.core.clustering import critical_tms
    from repro_torch.core.engine import _pad_tms
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.core.graph import uniform_topology
    from repro_torch.core.pdhg import TorchRoutingSolver, _bmm_bf16

    a = torch.rand((64, 12, 12), generator=gen, device="cuda").to(torch.bfloat16)
    bm = torch.rand((64, 12, 12), generator=gen, device="cuda").to(torch.bfloat16)
    out = _bmm_bf16(a, bm)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), _bmm_bf16(a.cpu(), bm.cpu()),
                               rtol=1e-6, atol=1e-6)
    spec = FLEET_SPECS[20]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=2.0, interval_minutes=30.0)
    cap = fab.capacities(uniform_topology(fab))
    tms = np.stack([_pad_tms(critical_tms(trace.demand[8 * i: 8 * i + 48],
                                          k=12, seed=i, device="cuda"), 12)
                    for i in range(8)])
    caps = np.stack([cap] * 8)
    runs = {}
    for precision in ("f32", "bf16"):
        solver = TorchRoutingSolver(fab, 12, precision=precision,
                                    device="cuda")
        runs[precision] = (solver, solver.solve_routing_batch(
            tms, caps, hedging=False, skip_stage3=True))
    np.testing.assert_allclose(runs["bf16"][1]["u_star"],
                               runs["f32"][1]["u_star"], rtol=0.01)
    solver, out16 = runs["bf16"]
    d3, ic = solver._dense_tms(tms), solver._dense_inv_cap(caps)
    f3 = torch.zeros((8, solver.V ** 3), device="cuda")
    f3[:, torch.as_tensor(solver._path_slot, device="cuda")] = torch.from_numpy(
        out16["f"].astype(np.float32)).cuda()
    u = solver._util_f32(f3.reshape((8,) + (solver.V,) * 3), d3, ic)
    np.testing.assert_array_equal(
        u.reshape(8, -1).amax(1).cpu().numpy().astype(np.float64),
        out16["u_star"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_layers,b,s,expect", [
    ("mixtral-8x7b", 2, 1, 8192, 2),  # the 4096 window masks
    ("dbrx-132b", 1, 1, 2048, 1)])
def test_moe_prefill_on_the_card(gen, arch, n_layers, b, s, expect):
    """An moe model at full width, depth cut: one flash-attention launch a
    layer, finite logits, the sorted dispatch within the reference's bf16
    bound of the one-hot one on a full-width layer."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    before = faops.launches
    nxt = make_prefill_step(model)(params, {"tokens": tokens})
    assert faops.launches == before + expect
    logits = model.forward(params, {"tokens": tokens})
    assert logits.shape == (b, s, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt)
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda").bfloat16()
    y1, a1 = moe.moe_ffn_onehot(params.blocks[0].moe, x, cfg)
    y2, a2 = moe.moe_ffn_sorted(params.blocks[0].moe, x, cfg)
    assert float((y1.float() - y2.float()).abs().max() / y1.float().abs().max()) < 2e-2
    assert abs(float(a1) - float(a2)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 0])
def test_ring_decode_matches_forward_on_the_card(gen, window):
    """mixtral's reduced config in float32 (TF32 off): decode through a
    ``window``-slot ring (``window_cache=True``, ``ring=True``) past the
    window's end against the kernels' windowed forward at 1e-3·(1+|logit|);
    without a window the cache keeps every position."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                                  dtype="float32", window=window)
        model = build_model(cfg)
        params = model.init(1)
        s = 64
        tokens = torch.randint(0, cfg.vocab, (2, s), generator=gen, device="cuda")
        full = model.forward(params, {"tokens": tokens})
        cache = model.init_cache(2, s, window_cache=True)
        assert cache["blocks"][0]["k"].shape[1] == (window or s)
        for pos in range(s):
            logits, cache = model.decode(params, cache, tokens[:, pos:pos + 1], pos,
                                         ring=True)
            d = (logits[:, 0] - full[:, pos]).abs()
            assert float((d / (1e-3 * (1 + full[:, pos].abs()))).max()) <= 1.0, pos
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_vlm_prefill_on_the_card(gen):
    """internvl2-1b at full size: patches in front of the tokens, one
    flash-attention launch a layer, finite logits over the tokens only,
    tied embeddings."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.api import build_model

    cfg = get_arch("internvl2-1b")
    assert cfg.tie_embeddings
    model = build_model(cfg)
    params = model.init(0)
    assert "unembed" not in params
    b, s, n_patch = 2, 1024, cfg.frontend_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s - n_patch), generator=gen,
                                     device="cuda"),
             "patches": torch.randn((b, n_patch, cfg.d_model), generator=gen,
                                    device="cuda").bfloat16()}
    before = faops.launches
    nxt = make_prefill_step(model)(params, batch)
    assert faops.launches == before + cfg.n_layers
    logits = model.forward(params, batch)
    assert logits.shape == (b, s - n_patch, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert torch.equal(logits[:, -1].argmax(-1, keepdim=True).int(), nxt)
    # the patches reach the tokens' logits
    other = dict(batch, patches=torch.zeros_like(batch["patches"]))
    assert not torch.equal(model.forward(params, other), logits)


@pytest.mark.gpu
def test_autotune_round_trip_on_the_card(gen, tmp_path, monkeypatch):
    """The table on the card: ``tune_tiles`` records a body certified
    bit-identical to the entry's own and the wrappers launch it (one launch
    counted); ``tune_solver`` records a knob that a fresh solver resolves,
    and ``REPRO_AUTOTUNE=0`` pins 128 and the entries' own bodies."""
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric
    from repro_torch.core.pdhg import TorchRoutingSolver
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    autotune.reset_table()
    try:
        for family in autotune.FAMILIES:
            t = 36 if family.startswith("queueloss") else 3
            entry = autotune.tune_tiles(family, t, 132, 132, reps=1)
            assert entry["body"] in ("auto", *autotune.BODIES[family])
            assert autotune.resolve_tiles(family, t, 132, 132) == entry["body"]
        d, w, inv_cap = _batched_linkload_inputs(gen, 8, 3, 132, 132)
        outs = {}
        for body in ("auto", "staged", "batched"):
            before = llops.launches
            outs[body] = llops.linkload_batched(d, w, inv_cap, 0.8, body=body)
            assert llops.launches == before + 1
        for a, b in zip(outs["auto"], outs["staged"]):
            assert torch.equal(a, b)
        for a, b in zip(outs["auto"], outs["batched"]):  # dyadic data: exact
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        fab = make_fabric(FLEET_SPECS[16])
        entry = autotune.tune_solver(fab, 4, reps=1, batch=4)
        assert TorchRoutingSolver(fab, 4).dual_topk == entry["dual_topk"]
        assert (tmp_path / "torch_table_v1.json").is_file()
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        assert TorchRoutingSolver(fab, 4).dual_topk == 128
        assert autotune.body_for("linkload", 3, 132, 132, torch.device("cuda")) == "auto"
    finally:
        autotune.reset_table()


# ---- training: #7's backward, the RG-LRU backward, train steps, audio ------

@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,dtype", [
    (2, 2048, 2048, 32, 8, 128, True, 0, torch.bfloat16),    # llama3-8b
    (2, 4096, 4096, 16, 1, 256, True, 2048, torch.bfloat16),  # recurrentgemma-9b
    (4, 256, 1024, 16, 16, 64, False, 0, torch.bfloat16),    # seamless cross
    (1, 300, 500, 8, 2, 100, False, 48, torch.float32),     # ragged
    # edge shapes of the tiling (chip_smoke's FLASH_BWD_EDGES): Sq and Sk off
    # every tile, windows across tile edges, groups of 2, 1, 16 and 12 (which
    # the 8-CTA cluster does not divide), non-causal Sq != Sk, hd 100 in bf16
    (1, 1000, 1000, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 300, 700, 4, 4, 128, False, 0, torch.bfloat16),
    (1, 1000, 1000, 16, 1, 256, True, 100, torch.bfloat16),
    (1, 500, 500, 12, 1, 128, True, 70, torch.bfloat16),
    (1, 300, 500, 8, 2, 100, False, 48, torch.bfloat16),
    # a tensor-parallel rank's uneven head shares (chip_smoke's TP_FLASH):
    # groups of 4, 3 (a cluster of 3 CTAs) and 2 on one KV head
    (4, 2048, 2048, 4, 1, 64, True, 0, torch.bfloat16),
    (4, 2048, 2048, 3, 1, 64, True, 0, torch.bfloat16),
    (1, 4096, 4096, 3, 1, 128, True, 0, torch.bfloat16),
    (1, 4096, 4096, 2, 1, 128, True, 0, torch.bfloat16),
    # the dense family's head layouts (chip_smoke's dense training shapes at
    # a small S): gemma3-12b's 16/8 at hd 256, window 1024 and global, and
    # deepseek-7b's MHA, 32/32 at hd 128
    (1, 2048, 2048, 16, 8, 256, True, 1024, torch.bfloat16),
    (1, 2048, 2048, 16, 8, 256, True, 0, torch.bfloat16),
    (1, 1024, 1024, 32, 32, 128, True, 0, torch.bfloat16)])
def test_flash_attention_backward_matches_plain(gen, b, sq, sk, h, kv, hd, causal,
                                                window, dtype):
    """The backward kernels through ``FlashAttention`` at chip_smoke's phase-3
    shapes and edge shapes: float32 at 1e-4·(1 + |ref|) of the plain
    backward, bfloat16 within the bf16 gradient rounding bound; one backward
    launch; the same bits on a second call."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         bf16_grad_rounding_bound)

    q, k, v, do = (torch.randn((b * n, s, hd), generator=gen, device="cuda").to(dtype)
                   for n, s in ((h, sq), (kv, sk), (kv, sk), (h, sq)))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    before = faops.bwd_launches
    got = torch.autograd.grad(faops.FlashAttention.apply(qg, kg, vg, h, kv, causal,
                                                         window), (qg, kg, vg), do)
    assert faops.bwd_launches == before + 1
    again = torch.autograd.grad(faops.FlashAttention.apply(qg, kg, vg, h, kv, causal,
                                                           window), (qg, kg, vg), do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    args = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
    if dtype == torch.bfloat16:
        ref, bound = bf16_grad_rounding_bound(q, k, v, do, **args)
    else:
        ref = attention_bwd_ref(q, k, v, attention_ref(q, k, v, **args), do,
                                attention_lse_ref(q, k, **args), **args)
        bound = tuple(1e-4 * (1 + r.abs()) for r in ref)
    for g, r, t in zip(got, ref, bound):
        assert g.dtype == dtype
        assert float(((g.float() - r).abs() / t).max()) <= 1.0


@pytest.mark.gpu
def test_rglru_scan_backward_is_two_launches(gen):
    a = (0.8 + 0.199 * torch.rand((2, 4096, 4096), generator=gen, device="cuda")
         ).requires_grad_()
    x = (0.5 * torch.randn((2, 4096, 4096), generator=gen, device="cuda")).requires_grad_()
    dh = torch.randn((2, 4096, 4096), generator=gen, device="cuda")
    before = rlops.launches
    got = torch.autograd.grad(rlops.rglru_scan(a, x), (a, x), dh)
    assert rlops.launches == before + 2
    want = torch.autograd.grad(rglru_scan_ref(a, x), (a, x), dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b", "mamba2-130m"])
def test_train_steps_match_the_cpu(gen, arch):
    """Two train steps of a reduced float32 model (TF32 off) on the card —
    the kernels forward and backward — against the same steps on the CPU
    (the plain versions): losses at 1e-5 relative, parameters at 1e-4 (Adam's
    eps 1e-3, as in tests/test_torch_train.py)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, "cuda")
        cpu_net = cpu_model.init(0)
        gpu_net = copy.deepcopy(cpu_net).cuda()
        tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device="cuda")
        labels = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device="cuda")
        results = []
        for model, net, dev in ((cpu_model, cpu_net, "cpu"), (gpu_model, gpu_net, "cuda")):
            opt = AdamW(lr=1e-3, warmup_steps=1, eps=1e-3)
            state = opt.init(net)
            step = make_train_step(model, opt, StepConfig(remat=True))
            batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
            fa_before, rl_before = faops.bwd_launches, rlops.launches
            sd_before = sdops.bwd_launches
            losses = []
            for _ in range(2):
                net, state, m = step(net, state, batch)
                losses.append(float(m["loss"]))
            if dev == "cuda":
                assert (faops.bwd_launches > fa_before) == (cfg.family != "ssm")
                assert (rlops.launches > rl_before) == (cfg.family == "hybrid")
                # one SSD backward launch a layer and step
                assert sdops.bwd_launches - sd_before == (
                    2 * cfg.n_layers if cfg.family == "ssm" else 0)
            results.append((losses, [p.detach().cpu() for p in tree_util.leaves(net)]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = results
    for a, b in zip(gpu_losses, cpu_losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(gpu_params, cpu_params):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_seamless_prefill_and_decode_on_the_card(gen):
    """The audio family's reduced config in float32 (TF32 off): the card's
    forward (flash attention non-causal in the encoder, causal and cross in
    the decoder: 3 launches a layer pair) against the CPU's, and decode
    against the forward."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_arch("seamless-m4t-large-v2").reduced(), dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model, model = build_model(cfg, "cpu"), build_model(cfg, "cuda")
        cpu_net = cpu_model.init(0)
        net = copy.deepcopy(cpu_net).cuda()
        frames = torch.randn((2, 48, cfg.d_model), generator=gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device="cuda")
        before = faops.launches
        full = model.forward(net, {"frames": frames, "tokens": tokens})
        assert faops.launches == before + cfg.encoder_layers + 2 * cfg.n_layers
        want = cpu_model.forward(cpu_net, {"frames": frames.cpu(), "tokens": tokens.cpu()})
        torch.testing.assert_close(full.cpu(), want, rtol=2e-3, atol=2e-3)
        cache = model.init_cache(2, 32, enc_len=48)
        with torch.inference_mode():
            cache["enc_out"][:] = encdec.encode(net, frames, cfg)
        for pos in range(32):
            logits, cache = model.decode(net, cache, tokens[:, pos:pos + 1], pos)
            d = (logits[:, 0] - full[:, pos]).abs()
            assert float((d / (1e-3 * (1 + full[:, pos].abs()))).max()) <= 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _deal_bucket(dev):
    """An 8-pod PDHG bucket of three fabrics (6, 7 and 8 pods) with 2, 2
    and 3 epochs, 7 elements; stages capped at 300 iterations."""
    import numpy as np

    from repro_torch.core.fleet import (FLEET_SPECS, commodity_slots, make_fabric,
                                        scatter_pad)
    from repro_torch.core.graph import Fabric, uniform_topology
    from repro_torch.core.pdhg import TorchRoutingSolver

    vp, m = 8, 4
    cp = vp * (vp - 1)
    solver = TorchRoutingSolver(Fabric("bucket-V8", np.full(vp, 2), np.ones(vp)), m,
                                max_iters=300, tol=1e-2, device=dev)
    rng = np.random.default_rng(5)
    tms, caps, valids, deltas, anchor_elems, anchor_of = ([] for _ in range(6))
    n = 0
    for fi, (idx, b) in enumerate(((16, 2), (1, 2), (8, 3))):
        fab = make_fabric(FLEET_SPECS[idx])
        slots = commodity_slots(fab.n_pods, vp)
        cap = scatter_pad(fab.capacities(uniform_topology(fab)), slots, cp)
        nc = fab.n_pods * (fab.n_pods - 1)
        for e in range(b):
            tms.append(scatter_pad(rng.gamma(2.0, 1.0, (m, nc)), slots, cp, axis=1))
            caps.append(cap)
            valids.append(solver.valid_for_pods(fab.n_pods))
            deltas.append(0.0 if (fi, e) == (1, 0) else 0.5)
        anchor_of += [fi] * b
        anchor_elems.append(n + b // 2)
        n += b
    args = (np.stack(tms), np.stack(caps), np.stack(valids),
            np.asarray(anchor_elems), np.asarray(anchor_of))
    return solver, args, dict(hedging=True, deltas=np.asarray(deltas))


@pytest.mark.gpu
def test_fleet_deal_on_one_card(gen):
    """Two shards of one card (``fleet_mesh([cuda] * 2)``: two host threads,
    two streams) deal a 7-element bucket 4 + 4 (one replayed): every
    element's f, u*, r*, iterations and gaps bit-equal to the unsharded
    call's."""
    import numpy as np

    from repro_torch.parallel.sharding import fleet_mesh

    dev = torch.device("cuda")
    solver, args, kw = _deal_bucket(dev)
    want = solver.solve_routing_fleet(*args, **kw)
    got = solver.solve_routing_fleet(*args, **kw, mesh=fleet_mesh([dev] * 2))
    for key in ("f", "u_star", "r_star"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for stage in ("stage1", "stage2", "stage3"):
        for field in ("iters", "gap"):
            np.testing.assert_array_equal(got["stats"][stage][field],
                                          want["stats"][stage][field])


@pytest.mark.gpu
def test_one_rank_mesh_step_on_the_card(gen, tmp_path):
    """``Trainer(mesh=make_host_mesh())`` over a one-rank NCCL process group
    (the FSDP step: gathers, reduce-scatters and the sharded update, each
    the identity on one rank) gives ``mesh=None``'s losses bit for bit."""
    import os
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_arch("mamba2-130m").reduced()
    model = build_model(cfg, "cuda")

    def losses(mesh, name):
        tr = Trainer(model, AdamW(lr=3e-3, warmup_steps=1), mesh,
                     DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2),
                     StepConfig(), TrainerConfig(total_steps=3, checkpoint_every=2),
                     tmp_path / name)
        return tr.run(resume=False)["losses"]

    want = losses(None, "none")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        got = losses(make_host_mesh(), "mesh")
    finally:
        dist.destroy_process_group()
    assert got == want


@pytest.mark.gpu
def test_tp_step_on_one_rank_mesh_on_the_card(gen, tmp_path):
    """The FSDP × TP step of ``make_train_step`` (its leaf plans, gathers,
    reductions and clip over the mesh's axes) on the card's one-rank mesh
    gives ``mesh=None``'s losses bit for bit for llama3 (every collective
    the identity on one rank), and ``Trainer.extract_traffic`` there the
    reference's (1, 1) zero matrix, with no kernel launched on ``meta``."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_arch("llama3-8b").reduced()
    model = build_model(cfg, "cuda")
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2)
    batches = [{k: torch.from_numpy(v).long().cuda() for k, v in
                SyntheticLM(data).batch_at(i).items()} for i in range(3)]

    def losses(mesh):
        params, opt = model.init(0), AdamW(lr=3e-3, warmup_steps=1)
        params.requires_grad_(True)
        state = opt.init(params)
        step = make_train_step(model, opt, StepConfig(), mesh)
        return [float(step(params, state, b)[2]["loss"]) for b in batches]

    assert losses(make_host_mesh()) == losses(None)
    tr = Trainer(model, AdamW(), make_host_mesh(), data, StepConfig(),
                 TrainerConfig(total_steps=1, devices_per_pod=1), tmp_path)
    params, state = tr.shard(model.init(0))
    before = (faops.launches, faops.bwd_launches)
    tm = tr.extract_traffic(params, state, SyntheticLM(data).batch_at(0))
    assert tm.shape == (1, 1) and tm.sum() == 0
    assert (faops.launches, faops.bwd_launches) == before
