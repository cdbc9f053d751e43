"""Where kernel 3's bf16 time goes, on the card: builds variant copies of
``csrc/group_norm.cu`` side by side with nvcc and times each one.

    python3 -m lns_tpu_torch.kernels.probe_group_norm

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
nvcc. The copies and their libraries go to ``lns_tpu_torch/_build/probe/``
(git-ignored). Variants:

  * ``base``: the source as it is;
  * ``scalar``: the bf16 affine and swish one element at a time in f32,
    rounded to bf16 after every op (the same bits; what the bf16x2
    instructions save);
  * ``no_fill``: clusters sized by shared memory alone, without doubling
    them while the blocks would leave SMs idle.

It prints each variant's registers and SASS instruction count, then the
device time of one call (a CUDA graph of 20 calls, replayed 3 times between
CUDA events) at every bf16 GroupNorm site of NS2d's predict, with its launch
plan, variants alternated (in order, then in reverse), and the decoder
tail's time without the swish.
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import torch

from lns_tpu_torch.kernels import _build

OUT = _build.BUILD_DIR / "probe"
SRC = (_build.SOURCE_DIR / "group_norm.cu").read_text()

_PACKED_START = "    // pairs of T: the x2 instructions"
_PACKED_END = ("      *reinterpret_cast<uint4*>(yg + static_cast<size_t>(r) * C + c0) = v;\n"
               "    }\n  }\n}\n")
_SCALAR = """    float sc[VW], sh[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      sc[k] = coef[c0 + k];
      sh[k] = coef[C + c0 + k];
    }
    for (int r = row0; r < nrows; r += pstep) {
      uint4 v = *reinterpret_cast<const uint4*>(xs + r * C + c0);
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        float y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(ld(e[k]), sc[k])), sh[k]));
        if (kSwish) {
          const float d = rnd<T>(__fadd_rn(1.f, rnd<T>(expf(-y))));
          y = rnd<T>(__fmul_rn(y, rnd<T>(__fdiv_rn(1.f, d))));
        }
        e[k] = lns::cvt<T>(y);
      }
""" + _PACKED_END
_FILL = "  while (cl < kMaxCluster && B * cl < sms && S >= 2 * cl) cl *= 2;\n"

# NS2d's bf16 GroupNorm sites: (batch, h, w, C, groups, eps, swish, calls per predict)
SITES = [(32, 64, 64, 64, 32, 1e-6, True, 2), (32, 32, 32, 64, 32, 1e-6, True, 2),
         (32, 16, 16, 64, 32, 1e-6, True, 1), (32, 16, 16, 128, 32, 1e-6, True, 1),
         (32, 8, 8, 128, 32, 1e-6, True, 3), (116, 8, 8, 128, 32, 1e-6, True, 64),
         (116, 16, 16, 128, 32, 1e-6, True, 8), (116, 16, 16, 64, 32, 1e-6, True, 8),
         (116, 16, 16, 64, 1, 1e-5, False, 8), (116, 32, 32, 64, 32, 1e-6, True, 16),
         (116, 32, 32, 64, 1, 1e-5, False, 8), (116, 64, 64, 64, 8, 1e-5, True, 8)]


def _patch(s: str, old: str, new: str) -> str:
    if old not in s:
        raise RuntimeError(f"probe_group_norm: the source no longer holds {old!r}")
    return s.replace(old, new)


def variants() -> dict:
    start = SRC.index(_PACKED_START)
    end = SRC.index(_PACKED_END, start) + len(_PACKED_END)
    return {"base": SRC, "scalar": SRC[:start] + _SCALAR + SRC[end:],
            "no_fill": _patch(SRC, _FILL, "  (void)sms;\n")}


def build(srcs: dict) -> dict:
    """nvcc every variant side by side; returns {name: (library, ptxas text)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.cuda_tool(), {}
    for name, s in srcs.items():
        (OUT / f"gn_{name}.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.SOURCE_DIR), "-shared",
             "-o", str(OUT / f"gn_{name}.so"), str(OUT / f"gn_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(OUT / f"gn_{name}.so"))
        lib.lns_group_norm.argtypes = _build._SIGNATURES["lns_group_norm"]
        lib.lns_group_norm_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        libs[name] = (lib, text)
    return libs


def sass_counts(path) -> dict:
    """{kernel instantiation: SASS instructions} in a library."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and "/*" in line and ";" in line:
            counts[fn] += 1
    return {f.split("gn_kernel")[1][:24]: n for f, n in counts.items() if "gn_kernel" in f}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_group_norm: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    libs = build(variants())
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    for name, (_, text) in libs.items():
        regs = [line.strip() for line in text.splitlines() if "registers" in line]
        print(f"  {name}: SASS instructions {sass_counts(OUT / f'gn_{name}.so')}; "
              f"{' | '.join(regs)}")

    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    data = []
    for b, h, w, c, g, eps, swish, calls in SITES:
        x = (torch.randn(b, h, w, c, generator=gen) * 2 + 0.5).to(dev, torch.bfloat16)
        data.append((x, torch.ones(c, device=dev), torch.zeros(c, device=dev),
                     torch.empty_like(x)))

    def call(lib, i, swish=None):
        b, h, w, c, g, eps, sw, _ = SITES[i]
        x, scale, bias, out = data[i]
        rc = lib.lns_group_norm(1, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), None, b, h * w, c, g, eps,
                                int(sw if swish is None else swish),
                                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "probe lns_group_norm")

    def device_ms(lib, i, swish=None, calls=20, reps=3):
        call(lib, i, swish)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                call(lib, i, swish)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (calls * reps)

    for name, (lib, _) in libs.items():
        plans = []
        for b, h, w, c, g, *_ in SITES:
            res = (ctypes.c_int * 5)()
            _build.check(lib.lns_group_norm_plan(1, b, h * w, c, g, res), "probe plan")
            plans.append(f"CL{res[0]}/{res[2]}B/{res[3]}cl")
        print(f"  {name} plans (cluster / shared memory per block / clusters at once): "
              + " ".join(plans))
    print("device ms per call (CUDA graph replays), bf16: "
          + ", ".join(f"B{b} {h}x{w}x{c} G{g}{'+sw' if sw else ''}"
                      for b, h, w, c, g, _, sw, _ in SITES) + "; per predict")
    order = list(libs)
    for name in order + order[::-1]:
        lib = libs[name][0]
        t = [device_ms(lib, i) for i in range(len(SITES))]
        total = sum(ms * site[-1] for ms, site in zip(t, SITES))
        print(f"  {name}: " + " ".join(f"{ms:.4f}" for ms in t) + f"; {total:.4f}", flush=True)
    tail = len(SITES) - 1
    for name in order:
        lib = libs[name][0]
        print(f"  {name}: decoder tail without swish {device_ms(lib, tail, swish=False):.4f} ms, "
              f"with {device_ms(lib, tail):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
