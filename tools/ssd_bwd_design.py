"""Design runs of the SSD chunk backward (#9b) on the card.

Each alternative is a text patch of the committed ``csrc/ssd_chunk.cu``,
built beside it (one ``nvcc`` each, all at once, under ``build/design``)
and loaded in the same process, so the variants are held to the plain
version and timed alternately on one card.  No JAX.

    python3 tools/ssd_bwd_design.py [precision] [grid] [forward]

- ``precision``: ``x1`` drops every product's lo terms (1xTF32) from the
  committed 3xTF32.  Both at ``chip_smoke.SSD_BWD``'s shapes against
  autograd through the plain version (phase 3's check), and the gradients
  at chunks of 32 against 64 (chunk invariance).
- ``grid``: ``w16`` runs the gradient kernel at 16 warps (so at most 128
  registers a thread), and ``a2`` at two CTAs per (b, chunk) of 12 heads
  each.  ``a2`` sums neither CTA's db and dc into the other's: a lower bound
  on a cluster split over head groups, timed only.
- ``forward``: ``fwd_walks`` walks the forward's states with the backward's
  ``ssd_walks_kernel`` (its forward blocks alone; chunks of at most 64) in
  place of ``ssd_state_kernel``.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NAMES = ("dx", "ddt", "da", "db", "dc")


def _patch(src: str, edits) -> str:
    """Apply (old, new, count) edits, each old found exactly count times."""
    for old, new, count in edits:
        if src.count(old) != count:
            raise ValueError(f"patch: {old[:60]!r} found {src.count(old)} times, not {count}")
        src = src.replace(old, new)
    return src


def _grad_body(src: str, edits) -> str:
    """``_patch`` inside ``ssd_grad_kernel`` only."""
    i = src.index("ssd_grad_kernel(const float*")
    j = src.index("// 4. da_h = the sum")
    return src[:i] + _patch(src[i:j], edits) + src[j:]


def x1(src: str) -> str:
    lo = ("  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);\n"
          "  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);\n")
    return _patch(src, [(lo, "", 1), (lo.replace("(d,", "(dl,"), "", 1)])


def w16(src: str) -> str:
    """The gradient kernel's work spread over 16 warps: the triangle's 20
    tiles at 2 a warp, g, V, db and dc in 16 x 32 tiles (one t strip a
    warp), the shared-memory layout unchanged but for 8 more warp sums."""
    src = _patch(src, [
        ("constexpr int kTiles = 20;            // 16 x 8 tiles of a Q x Q triangle (s >= t)\n",
         "constexpr int kTiles = 20;            // 16 x 8 tiles of a Q x Q triangle (s >= t)\n"
         "constexpr int kGradThreads = 512;\n", 1),
        ("  static constexpr int last = red + kThreads / 32;",
         "  static constexpr int last = red + kGradThreads / 32;", 1),
        ("i += kThreads) {\n    const int r = i / per_row", "i += kGradThreads) {\n    const int r = i / per_row", 1),
        ("i < kGQ * (kMaxN / 4); i += kThreads)", "i < kGQ * (kMaxN / 4); i += kGradThreads)", 1),
        ("i < kGQ * kMaxN; i += kThreads)", "i < kGQ * kMaxN; i += kGradThreads)", 1),
        ("__launch_bounds__(kThreads, 1)\nssd_grad_kernel", "__launch_bounds__(kGradThreads, 1)\nssd_grad_kernel", 1),
        ("ssd_grad_kernel<<<dim3((unsigned)n_grad), kThreads,",
         "ssd_grad_kernel<<<dim3((unsigned)n_grad), kGradThreads,", 1)])
    return _grad_body(src, [
        ("warp + 8 * m", "warp + 16 * m", 5),
        ("for (int m = 0; m < 3; ++m)", "for (int m = 0; m < 2; ++m)", 6),
        ("int ti[3], tj[3];", "int ti[2], tj[2];", 1),
        ("float cbt[3][4], wsum[3][4];", "float cbt[2][4], wsum[2][4];", 1),
        ("float acc[3][4], accx[3][4];", "float acc[2][4], accx[2][4];", 1),
        ("float db_acc[2][4][4], dc_acc[2][4][4];", "float db_acc[1][4][4], dc_acc[1][4][4];", 1),
        ("""  const int rbase = (warp & 1) * 32, nbase = (warp >> 1) * 32;  // V, db, dc tiles
  const int quarter = warp >> 1;                                // g's 16 columns
  const int strip_a = warp & 1, strip_b = 3 - strip_a;          // g's t strips""",
         """  const int rbase = (warp & 3) * 16, nbase = (warp >> 2) * 32;
  const int quarter = warp >> 2;
  const int strip_a = warp & 3, strip_b = 0;""", 1),
        ("float gi[2][2][4], bg[2][2][4], bgx[2][2][4];", "float gi[1][2][4], bg[1][2][4], bgx[1][2][4];", 1),
        ("for (int u = 0; u < 2; ++u)", "for (int u = 0; u < 1; ++u)", 4),
        ("float vacc[2][4][4];", "float vacc[1][4][4];", 1),
        ("Frag af[2][4], bf[4][2];", "Frag af[1][4], bf[4][2];", 2),
        ("for (int i = 0; i < 2; ++i)", "for (int i = 0; i < 1; ++i)", 9),
        ("i < kMaxN * (kMaxP / 4); i += kThreads)", "i < kMaxN * (kMaxP / 4); i += kGradThreads)", 1),
        ("for (int k = 0; k < kThreads / 32; ++k) ssg += red[k];",
         "for (int k = 0; k < kGradThreads / 32; ++k) ssg += red[k];", 1),
        ("if (warp == kThreads / 32 - 1) {", "if (warp == kGradThreads / 32 - 1) {", 1)])


def a2(src: str) -> str:
    src = _grad_body(src, [
        ("float* __restrict__ da_part, int H, int S,", "float* __restrict__ da_part, int Hall, int S,", 1),
        ("  extern __shared__ __align__(16) float smem[];\n",
         "  extern __shared__ __align__(16) float smem[];\n"
         "  const int hg = blockIdx.x & 1, H = Hall / 2, H0 = hg * H;\n", 1),
        ("const int c = blockIdx.x % nc, bi = blockIdx.x / nc;",
         "const int c = (blockIdx.x >> 1) % nc, bi = (blockIdx.x >> 1) / nc;", 1),
        ("(size_t)bi * H + h", "(size_t)bi * Hall + H0 + h", 2),
        ("(long long)bi * H + h", "(long long)bi * Hall + H0 + h", 1),
        ("a[h]", "a[H0 + h]", 1)])
    return _patch(src, [("ssd_grad_kernel<<<dim3((unsigned)n_grad),",
                         "ssd_grad_kernel<<<dim3((unsigned)(2 * n_grad)),", 1)])


def fwd_walks(src: str) -> str:
    tiles = "((N + kWalkRows - 1) / kWalkRows)"
    return _patch(src, [
        ("  if (err == cudaSuccess) err = opt_in((const void*)ssd_out_kernel, smem_out);\n",
         "  if (err == cudaSuccess) err = opt_in((const void*)ssd_out_kernel, smem_out);\n"
         "  if (err == cudaSuccess)\n"
         "    err = opt_in((const void*)ssd_walks_kernel, sizeof(float) * 2 * kWalkStage);\n", 1),
        ("""  ssd_state_kernel<<<dim3((unsigned)n_state), kStateThreads, smem_state, st>>>(
      xf, bf, w, decay, sf, H, S, P, N, Q, nc, n_tiles, vec);""",
         f"""  ssd_walks_kernel<<<dim3((unsigned)(B * H * {tiles})), kThreads,
                     sizeof(float) * 2 * kWalkStage, st>>>(
      xf, bf, w, nullptr, nullptr, nullptr, decay, sf, nullptr, H, S, P, N, Q, nc, {tiles},
      B * H * {tiles}, vec);""", 1)])


VARIANTS = {"x1": x1, "w16": w16, "a2": a2, "fwd_walks": fwd_walks}


def build(names) -> dict:
    """The committed source as ``base`` and the named variants, each built to
    its own library and loaded; prints ptxas' registers and spills."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    out = ROOT / "build" / "design"
    out.mkdir(parents=True, exist_ok=True)
    texts = {"base": src, **{n: VARIANTS[n](src) for n in names}}
    t0 = time.perf_counter()
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = next((k for k in ("ssd_grad_kernel", "ssd_walks_kernel", "ssd_state_kernel")
                               if k in line), None)
            elif kernel and ("Used" in line or "spill stores" in line):
                print(f"{name} {kernel}: {line.split(':')[-1].strip()}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    print(f"built {sorted(texts)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def inputs(gen, b, h, s, p, n):
    import torch

    x = torch.randn((b, h, s, p), generator=gen, device="cuda")
    dt = 0.001 + 0.099 * torch.rand((b, h, s, 1), generator=gen, device="cuda")
    a = -(1.0 + 7.0 * torch.rand((h, 1, 1, 1), generator=gen, device="cuda"))
    bm = torch.randn((b, 1, s, n), generator=gen, device="cuda")
    cm = torch.randn((b, 1, s, n), generator=gen, device="cuda")
    dy = torch.randn((b, h, s, p), generator=gen, device="cuda")
    return x, dt, a, bm, cm, dy


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ops as sdops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_chunk_ref_bwd

    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    runs = argv or ["precision", "grid", "forward"]
    names = (["x1"] if "precision" in runs else []) + (["w16", "a2"] if "grid" in runs else []) \
        + (["fwd_walks"] if "forward" in runs else [])
    libs = build(names)

    def use(name):
        _build._LIBS["ssd_chunk"] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(3)
    main_shape = (4, 24, 4096, 64, 128)
    if "precision" in runs or "grid" in runs:
        checked = ["base"] + [n for n in ("x1", "w16") if n in libs]
        for label, (b, h, s, p, n, chunk) in cs.SSD_BWD:
            args = inputs(gen, b, h, s, p, n)
            q = min(chunk, s)
            while s % q:
                q //= 2
            want = ssd_chunk_ref_bwd(*args, q)
            for v in checked:
                use(v)
                got = sdops.ssd_scan_bwd(*args, chunk)
                rel = {k: float((g - w).abs().max() / w.abs().max())
                       for k, g, w in zip(NAMES, got, want)}
                same = all(torch.equal(g, r) for g, r in zip(sdops.ssd_scan_bwd(*args, chunk), got))
                print(f"{v} {label}: worst {max(rel.values()):.3e} (contract "
                      f"{cs.SSD_BWD_REL_TOL}) {rel}; bit-equal {same}", flush=True)
        for shape in ((1, 2, 256, 64, 64), main_shape):
            args = inputs(gen, *shape)
            for v in checked:
                use(v)
                inv = {k: float((u - w).abs().max() / w.abs().max()) for k, u, w in
                       zip(NAMES, sdops.ssd_scan_bwd(*args, 32), sdops.ssd_scan_bwd(*args, 64))}
                print(f"{v} chunk 32 vs 64 {shape}: worst {max(inv.values()):.3e} (contract "
                      f"{cs.SSD_BWD_INVARIANCE_TOL}) {inv}", flush=True)
    if "grid" in runs:
        args = inputs(gen, *main_shape)
        for v in ("base", "w16", "a2", "a2", "w16", "base"):
            use(v)
            print(f"{v} ssd_chunk_bwd: {cs.time_cuda(lambda: sdops.ssd_scan_bwd(*args, 64)):.4f} ms",
                  flush=True)
        for v in ("base", "w16", "a2"):
            use(v)
            print(f"{v} launches apart: {cs._launch_split(lambda: sdops.ssd_scan_bwd(*args, 64))}",
                  flush=True)
    if "forward" in runs:
        args = inputs(gen, *main_shape)[:5]
        ref = ssd_chunk_ref(*args, 64)
        for v in ("base", "fwd_walks"):
            use(v)
            out = sdops.ssd_scan(*args, 64)
            print(f"{v} ssd_chunk: relative error {float((out - ref).abs().max() / ref.abs().max()):.3e} "
                  f"(contract {cs.SSD_REL_TOL}); bit-equal {torch.equal(sdops.ssd_scan(*args, 64), out)}",
                  flush=True)
        for v in ("base", "fwd_walks", "fwd_walks", "base"):
            use(v)
            print(f"{v} ssd_chunk: {cs.time_cuda(lambda: sdops.ssd_scan(*args, 64)):.4f} ms", flush=True)
        for v in ("base", "fwd_walks"):
            use(v)
            print(f"{v} launches apart: {cs._launch_split(lambda: sdops.ssd_scan(*args, 64))}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
