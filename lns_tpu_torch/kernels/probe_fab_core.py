"""Where kernel 2's bf16 time goes, on the card.

    python3 -m lns_tpu_torch.kernels.probe_fab_core

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
nvcc. At each c-space FAB shape of the inference paths (NS2d's 16x16 and
32x32, SW's 24x48 and 48x96; c = 64, 8 heads, d = 64, the block's mean from
its GroupNorm inputs as ``FABlock2D`` gives it) it prints:

  * the registers and spills of the bf16 kernels (ptxas);
  * per call: CUDA-event time, device time (a CUDA graph of 20 calls),
    the host's enqueue time, and each pass's device time under
    ``torch.profiler`` (mean, statistics, moments, output);
  * the statistics pass by phase: a copy of ``csrc/`` with ``clock64()``
    marks (consumer warpgroup 0's first thread and the producer thread);
    thousands of cycles per block, averaged over the blocks of one call:
    start (the barriers and k_x), step A and its waits for u's ring, step
    B, the Gram and bb's store, the epilogue, the final cluster barrier,
    and the producer's total and its waits for free ring stages.

Each variant of ``VARIANTS`` (``base``: the source as it is) is built from a
copy of ``csrc/`` into ``lns_tpu_torch/_build/probe/`` (git-ignored) and
timed and held to the plain version (1e-2 x max|plain|, at most 2 % of the
elements differing) at every shape, variants in turn, then in reverse.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time

import torch

from lns_tpu_torch.kernels import _build, _probe

SHAPES = [(116, 16, 16, 64), (116, 32, 32, 64), (32, 32, 32, 64), (336, 24, 48, 64),
          (336, 48, 96, 64)]
N_HEADS, D_HEAD = 8, 64
PHASES = ["total", "start", "A wait", "A", "B", "Gram+store", "epilogue", "cluster end",
          "blocks", "producer waits", "producer"]

# (anchor, replacement) pairs that add the clock64() marks
MARKS = [
    ("constexpr int kConsumers = 128 * kStatsWGs;",
     "__device__ unsigned long long g_prof[16];\nconstexpr int kConsumers = 128 * kStatsWGs;"),
    ("    lns::mbar_wait(kxbar, 0);\n    int f = 0;",
     "    long long T0 = clock64(), tAw = 0, tA = 0, tB = 0, tG = 0, tS = 0, t1, t2;\n"
     "    lns::mbar_wait(kxbar, 0);\n    tS = clock64() - T0;\n    int f = 0;"),
    ("      lns::mbar_wait(&kyfull[kb], (t >> 1) & 1);",
     "      t2 = clock64();\n      lns::mbar_wait(&kyfull[kb], (t >> 1) & 1);"),
    ("        lns::mbar_wait(&full[st], (f / p.S) & 1);",
     "        t1 = clock64();\n        lns::mbar_wait(&full[st], (f / p.S) & 1);\n"
     "        tAw += clock64() - t1;"),
    ("      lns::fence_async_shared();  // a's stores, visible to wgmma\n"
     "      lns::bar_sync(1, kConsumers);",
     "      lns::fence_async_shared();  // a's stores, visible to wgmma\n"
     "      lns::bar_sync(1, kConsumers);\n      tA += clock64() - t2; t2 = clock64();"),
    ("      lns::fence_async_shared();  // bb's stores, visible to wgmma and the TMA store\n"
     "      lns::bar_sync(1, kConsumers);",
     "      lns::fence_async_shared();  // bb's stores, visible to wgmma and the TMA store\n"
     "      lns::bar_sync(1, kConsumers);\n      tB += clock64() - t2; t2 = clock64();"),
    ("      lns::bar_sync(1, kConsumers);  // the tile's bb is read before the next tile's a\n"
     "    }",
     "      lns::bar_sync(1, kConsumers);  // the tile's bb is read before the next tile's a\n"
     "      tG += clock64() - t2;\n    }\n    const long long TE = clock64();"),
    ("    if (p.cs > 1) lns::cluster_sync();\n  }\n}",
     "    const long long TX = clock64();\n    if (p.cs > 1) lns::cluster_sync();\n"
     "    if (tid == 0) {\n"
     "      const long long v[9] = {TX - T0, tS, tAw, tA, tB, tG, TX - TE, clock64() - TX, 1};\n"
     "      for (int i = 0; i < 9; ++i) atomicAdd(&g_prof[i], (unsigned long long)v[i]);\n"
     "    }\n  }\n}"),
    ("      int f = 0;\n      for (int t = 0; t < p.tiles; ++t) {",
     "      long long tPw = 0, P0 = clock64(), t1;\n      int f = 0;\n"
     "      for (int t = 0; t < p.tiles; ++t) {"),
    ("          if (f >= p.S) lns::mbar_wait(&empty[st], ((f / p.S) - 1) & 1);",
     "          t1 = clock64();\n"
     "          if (f >= p.S) lns::mbar_wait(&empty[st], ((f / p.S) - 1) & 1);\n"
     "          tPw += clock64() - t1;"),
    ("                lns::tma_load(dst, &map_u, &full[st], 64 * ca, c1, c2, s);\n"
     "            }\n        }\n      }\n",
     "                lns::tma_load(dst, &map_u, &full[st], 64 * ca, c1, c2, s);\n"
     "            }\n        }\n      }\n"
     "      atomicAdd(&g_prof[9], (unsigned long long)tPw);\n"
     "      atomicAdd(&g_prof[10], (unsigned long long)(clock64() - P0));\n"),
]
# variants of the source, by (anchor, replacement): the statistics pass with
# one consumer warpgroup (and so up to 255 registers a thread) in place of two
VARIANTS = {"base": [],
            "one_wg": [("constexpr int kStatsWGs = 2;", "constexpr int kStatsWGs = 1;")]}
READER = """
extern "C" int lns_fab_probe(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {};
  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(g_prof, z, sizeof z);
  return e;
}
"""


def _inputs(gen, dev, b, h, w, c):
    kx = (torch.randn(b, N_HEADS, h, h, generator=gen) / h).to(dev, torch.bfloat16)
    ky = (torch.randn(b, N_HEADS, w, w, generator=gen) / w).to(dev, torch.bfloat16)
    w_in = (torch.randn(c, N_HEADS, D_HEAD, generator=gen) / c ** 0.5).to(dev)
    w_o1 = (torch.randn(N_HEADS, D_HEAD, c, generator=gen) / D_HEAD ** 0.5).to(dev)
    x = (torch.randn(b, h, w, c, generator=gen) * 1.5 + 0.3).to(dev, torch.bfloat16)
    sc = (1 + 0.2 * torch.randn(b, c, generator=gen)).to(dev, torch.bfloat16)
    sh = torch.randn(b, c, generator=gen).to(dev, torch.bfloat16)
    u = x * sc[:, None, None] + sh[:, None, None]
    mf = (x, torch.stack([sc, sh], 1).float(), kx.float().sum(2), ky.float().sum(2))
    return u, kx, ky, w_in, w_o1, mf


def registers(msgs):
    fn = None
    for line in msgs.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"fab_(bb_stats|out|block_mean)_bf16", fn) and (
                "spill" in line or "Used" in line):
            name = re.search(r"fab_\w+?_bf16(ILi\d)?", fn).group(0)
            print(f"    {name}: {line.strip().removeprefix('ptxas info    : ')}")


def timings(dev, label):
    from torch.profiler import ProfilerActivity, profile

    from lns_tpu_torch.kernels import fab_core

    gen = torch.Generator().manual_seed(1)
    for b, h, w, c in SHAPES:
        u, kx, ky, w_in, w_o1, mf = _inputs(gen, dev, b, h, w, c)

        def call():
            return fab_core.fab_fused_core(u, kx, ky, w_in, w_o1, mean_from=mf)

        out, ref = call(), fab_core.fab_core_plain(u, kx, ky, w_in, w_o1, mean_from=mf)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        differ = (out != ref).float().mean().item()
        ok = err <= 1e-2 and differ <= 0.02 and torch.equal(out, call())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        t = time.perf_counter()
        for _ in range(10):
            call()
        host = (time.perf_counter() - t) / 10 * 1e3
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(20):
                call()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        dms = start.elapsed_time(end) / 60
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            for key in ("fab_block_mean", "fab_bb_stats", "fab_moments", "fab_out"):
                if key in e.key:
                    passes[key] = passes.get(key, 0.0) + e.device_time_total / 5e3
        print(f"    {label} b{b} {h}x{w} c{c}: {'ok' if ok else 'FAIL'} (err {err:.2e} x "
              f"max|plain|, {differ:.2%} differ, bitwise rerun), events {ms:.4f} ms, device "
              f"{dms:.4f} ms, host enqueue {host:.4f} ms; passes "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()), flush=True)


def sass_size():
    """SASS instructions of each bf16 kernel in the current library."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    count, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn and re.search(r"fab_(bb_stats|out|block_mean)_bf16", fn) and re.match(
                r"\s+/\*[0-9a-f]{4,}\*/", line):
            count[fn] = count.get(fn, 0) + 1
    for fn, k in count.items():
        print(f"    {re.search(r'fab_\w+?_bf16(ILi\d)?', fn).group(0)}: {k} SASS instructions")


def phases(dev, name):
    _probe.use_copy("probe_fab_core_" + name + "_marked", "fab_core.cu", VARIANTS[name] + MARKS,
                    READER)
    lib = _build.library()
    lib.lns_fab_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    from lns_tpu_torch.kernels import fab_core

    gen = torch.Generator().manual_seed(1)
    buf = (ctypes.c_ulonglong * 16)()
    for b, h, w, c in SHAPES:
        u, kx, ky, w_in, w_o1, mf = _inputs(gen, dev, b, h, w, c)
        for reset in range(2):  # the first call warms up
            fab_core.fab_fused_core(u, kx, ky, w_in, w_o1, mean_from=mf)
            torch.cuda.synchronize()
            _build.check(lib.lns_fab_probe(buf, 1), "lns_fab_probe")
        blocks = max(buf[8], 1)
        print(f"  b{b} {h}x{w} c{c} ({buf[8]} blocks), kcycles per block: " + ", ".join(
            f"{k} {buf[i] / blocks / 1e3:.1f}" for i, k in enumerate(PHASES) if k != "blocks"),
            flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_fab_core: needs a CUDA card")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    names = list(VARIANTS)
    for name in names + names[::-1]:
        print(f"variant {name}:")
        registers(_probe.use_copy("probe_fab_core_" + name, "fab_core.cu", VARIANTS[name],
                                  ptxas_verbose=True))
        sass_size()
        timings(dev, name)
    for name in names:
        print(f"the statistics pass by phase (clock64 marks), {name}:")
        phases(dev, name)



if __name__ == "__main__":
    main()
