"""Where kernel 1's bf16 time goes, on the card: builds variant copies of
``csrc/prop_rollout.cu`` side by side with nvcc and times each one.

    python3 -m lns_tpu_torch.kernels.probe_rollout

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
nvcc. The copies and their libraries go to ``lns_tpu_torch/_build/probe/``
(git-ignored). Variants:

  * ``base``: the source as it is;
  * ``no_mma``: without the tensor-core products (what the rest costs);
  * ``local_store``: each block stores its layer outputs only into its own
    shared memory (what the DSMEM stores to the peers cost; wrong results);
  * ``cluster4``, ``cluster8_b16``: clusters of 4 at every batch, and of 8
    up to B16 (against 8 for B <= 8);
  * ``phases``: ``clock64()`` marks summed per warp in registers and written
    once at the end, for blocks 0 and 1: the wait and barrier before each
    weight chunk, issuing its copies, the product loop, the epilogues, the
    cluster barriers after the products, the norms (with their own
    barriers), and the whole kernel.

It prints each variant's registers, SASS instruction and HMMA counts and its
times (CUDA events, mean of 3 after a warm-up) at NS2d's 8x8 latent (C 128,
C_lat 16) and SW's 12x24 (C_lat 64), 29 steps, alternating variants, then
the phase table at B32.
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import torch

from lns_tpu_torch.kernels import _build
from lns_tpu_torch.kernels.prop_rollout import _WRAP, pack_simple_cnn

OUT = _build.BUILD_DIR / "probe"
SRC = (_build.SOURCE_DIR / "prop_rollout.cu").read_text()

_WAIT = ("    lns::cp_async_wait<kStages - 2>();  // this chunk's copies have landed ...\n"
         "    __syncthreads();                     // ... for every thread; the oldest slot is free\n"
         "    issue_next(x, p);\n")
_MMA = ("          lns::mma_bf16(acc[j][0], a, bw[0], bw[1]);\n",
        "          lns::mma_bf16(acc[j][1], a, bw[2], bw[3]);\n")
_PHASES = ("wait+barrier", "issue copies", "product loop", "epilogue", "cluster barriers",
           "norms", "kernel")


def _patch(s: str, old: str, new: str) -> str:
    if old not in s:
        raise RuntimeError(f"probe_rollout: the source no longer holds {old!r}")
    return s.replace(old, new)


def _phases(s: str) -> str:
    s = _patch(s, "namespace {\n", "__device__ long long g_prof[2][8][8];\nnamespace {\n")
    s = _patch(s, "  int used, issued;  // weight chunks consumed and issued\n",
               "  int used, issued;\n  long long prof[8];\n")
    s = _patch(s, _WAIT, "    long long t0 = clock64();\n" + _WAIT.replace(
        "    issue_next(x, p);\n",
        "    long long t1 = clock64(); x.prof[0] += t1 - t0;\n"
        "    issue_next(x, p); long long t2 = clock64(); x.prof[1] += t2 - t1;\n"))
    s = _patch(s, "    k0 += m.kc;\n", "    x.prof[2] += clock64() - t2;\n    k0 += m.kc;\n")
    s = _patch(s, "  if (!active) return;\n",
               "  long long te = clock64();\n  if (!active) { x.prof[3] += clock64() - te; return; }\n")
    end = ("          if (epi == kOutZ) *reinterpret_cast<uint32_t*>(gout + pos * p.C_lat + n) = "
           "packed;\n        }\n      }\n    }\n  }\n}\n")
    s = _patch(s, end, end[:-2] + "  x.prof[3] += clock64() - te;\n}\n")
    s = _patch(s, "        cluster.sync();  // the output is in every block",
               "        { long long tc = clock64(); cluster.sync(); x.prof[4] += clock64() - tc; }"
               "  //")
    for call in ("gng_to_all(x, p, cluster, p.out_gn_s + x.col0, p.out_gn_b + x.col0, x.f0);",
                 "gn1_to_all(x, p, cluster, p.gn_s + k, p.gn_b + k, x.f0);"):
        s = _patch(s, call, "{ long long tg = clock64(); " + call
                   + " x.prof[5] += clock64() - tg; }")
    start = "  cluster.sync();  // every block of the cluster runs before the first DSMEM store\n"
    s = _patch(s, start, start + "  for (int k = 0; k < 8; ++k) x.prof[k] = 0;\n"
               "  long long tk = clock64();\n")
    s = _patch(s, "  lns::cp_async_wait<0>();\n}\n",
               "  lns::cp_async_wait<0>();\n  x.prof[6] = clock64() - tk;\n"
               "  if (threadIdx.x % 32 == 0 && blockIdx.x < 2)\n"
               "    for (int k = 0; k < 8; ++k) g_prof[blockIdx.x][threadIdx.x / 32][k] = x.prof[k];\n"
               "}\n")
    return s + ("\nextern \"C\" int probe_read(long long* o) {\n"
                "  return cudaMemcpyFromSymbol(o, g_prof, sizeof(g_prof));\n}\n")


def variants() -> dict:
    return {
        "base": SRC,
        "no_mma": _patch(_patch(SRC, _MMA[0], ""), _MMA[1], ""),
        "local_store": SRC.replace("for (int r = 0; r < x.pl.cl; ++r)",
                                   "for (int r = x.rank; r == x.rank; ++r)"),
        "cluster4": _patch(SRC, "  if (B <= 8 && C % 128 == 0) return 8;\n", ""),
        "cluster8_b16": _patch(SRC, "  if (B <= 8 && C % 128 == 0) return 8;\n",
                               "  if (B <= 16 && C % 128 == 0) return 8;\n"),
        "phases": _phases(SRC),
    }


def build(srcs: dict) -> dict:
    """nvcc every variant side by side; returns {name: (library, ptxas text)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.cuda_tool(), {}
    for name, s in srcs.items():
        (OUT / f"{name}.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.SOURCE_DIR), "-shared",
             "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.lns_prop_rollout.argtypes = _build._SIGNATURES["lns_prop_rollout"]
        libs[name] = (lib, text)
    return libs


def sass_counts(path) -> dict:
    """{kernel: (instructions, HMMA)} of the bf16 kernels in a library."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn and "/*" in line and ";" in line:
            counts[fn][0] += 1
            counts[fn][1] += "HMMA" in line
    return {f.split("rollout_bf16_kernel")[1][:6]: tuple(c) for f, c in counts.items()
            if "rollout_bf16" in f}


def main() -> None:
    from lns_tpu_torch.models.propagator import SimpleCNN
    from lns_tpu_torch.ops.initializers import init_weights_

    if not torch.cuda.is_available():
        raise SystemExit("probe_rollout: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    libs = build(variants())
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    for name, (_, text) in libs.items():
        regs = [line.strip() for line in text.splitlines() if "registers" in line]
        print(f"  {name}: {sass_counts(OUT / f'{name}.so')} (instructions, HMMA) per NT; "
              f"{regs[-1] if regs else ''}")

    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    shapes = {}  # name -> (h, w, c_lat, padding, packed, z0 for 32 samples)
    for name, h, w, c_lat, pm in (("NS2d 8x8", 8, 8, 16, "circular"),
                                  ("SW 12x24", 12, 24, 64, "half_periodic_x")):
        cnn = init_weights_(SimpleCNN(c_lat, 3, 128, 2), gen).to(dev)
        z0 = torch.randn(32, h, w, c_lat, generator=gen).to(dev, torch.bfloat16)
        shapes[name] = (h, w, c_lat, pm, pack_simple_cnn(cnn, torch.bfloat16), z0)

    def launch(lib, shape, b, steps=29):
        h, w, c_lat, pm, packed, z0 = shapes[shape]
        z = z0[:b].contiguous()
        out = torch.empty((steps, b, h, w, c_lat), device=dev, dtype=torch.bfloat16)
        rc = lib.lns_prop_rollout(1, z.data_ptr(), *(t.data_ptr() for t in packed),
                                  out.data_ptr(), None, b, h, w, c_lat, 128, 3, 2, *_WRAP[pm], 32,
                                  steps,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "probe lns_prop_rollout")
        return out

    def ms(lib, shape, b):
        launch(lib, shape, b)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            launch(lib, shape, b)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3

    cases = [("NS2d 8x8", b) for b in (1, 8, 16, 32)] + [("SW 12x24", b) for b in (4, 16)]
    print("ms, 29 steps: " + ", ".join(f"{s} B{b}" for s, b in cases))
    order = list(libs)
    for name in order + order[::-1]:
        lib = libs[name][0]
        print(f"  {name}: " + " ".join(f"{ms(lib, s, b):.4f}" for s, b in cases), flush=True)

    lib = libs["phases"][0]
    launch(lib, "NS2d 8x8", 32)
    torch.cuda.synchronize()
    prof = (ctypes.c_longlong * 128)()
    lib.probe_read(prof)
    print("phases at NS2d B32, clock64 cycles over 29 steps per warp of blocks 0-1: "
          + ", ".join(_PHASES))
    for blk in range(2):
        for warp in range(8):
            row = [prof[blk * 64 + warp * 8 + k] for k in range(len(_PHASES))]
            print(f"  block {blk} warp {warp}: " + " ".join(f"{v:>9d}" for v in row))


if __name__ == "__main__":
    main()
