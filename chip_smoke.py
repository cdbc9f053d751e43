#!/usr/bin/env python3
"""Drive the PyTorch port's NS2d (also with the autoencoder's Fourier
layers), SW, two-phase and conditional two-phase inference rollouts, the
conditional encoder, the library blocks, the stage-2 and stage-1 training
of each family, its evaluate and convert entry points, its data-parallel
training and predict, the corpus solvers, the debug and profiling
helpers and the ports of the TPU probe scripts once on one CUDA card.

    python3 chip_smoke.py            # everything below, on one card
    python3 chip_smoke.py --ranks    # the 2- and 4-rank runs of phases 8 and 9 alone
    python3 chip_smoke.py --parent DIR  # phase 10 also times the tree at DIR's
                                        # copy, FAB passes and chains

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
CUDA PyTorch and nvcc. It imports nothing of JAX. In order it:

  1. prints the card (torch and nvidia-smi); fails if there is no CUDA card;
  2. builds the CUDA kernels from lns_tpu_torch/csrc (nvcc, sm_90a, one
     process per source), and counts the tensor-core instructions (HMMA /
     HGMMA, from the toolkit's cuobjdump) in the bf16 code of the kernels
     that run on tensor cores (1, 2, 4, 5 and 6, the probe's FAB passes,
     ``dot_general`` at each of its block tiles and the bf16 chains); a
     count of 0
     fails (of HGMMA for kernel 2 and the two FAB passes, on ``wgmma``);
     the f32 ``dot_general`` and ``chain_scr2_f32`` fail on any HMMA
     (TF32) or on no FFMA; the bulk route of ``blocked_copy`` must show
     UBLKCP (TMA bulk copies), and ``csrc/fab_mega.cu`` compiled alone with
     ``-Xptxas -v`` no note that ptxas serialized either pass's ``wgmma``;
  3. holds each of the seven hand-written kernels against its plain PyTorch
     version on the card, at the shapes the paths give it (and, for the
     library kernels off the paths, at the TPU package's shapes; kernels 1,
     2, 3 and 6 also at shapes that take their other code paths: kernel 1 at
     SW's 12x24 latent, every padding mode and batches that leave SMs idle,
     one step against the plain version from its own carry at every step of
     the NS2d, the SW and the two-phase (zeros, 7x15) rollout, twice
     bitwise-identical, and in f32 at SW's latent (its activations in a
     global workspace) and at the two-phase latent; its FiLM plan
     (``check_cond_rollout``) on path 5's conditional propagator at B2048,
     B1 and a ragged batch, each step from its own carry (also in the rms
     distance, which a control with the f32 stretch in bf16 must fail),
     twice bitwise-identical, B2048 x 78 timed; kernel 3 in bf16 and
     f32 at every GroupNorm site of the five paths (SW's 96x192 fields take
     its split plan; the conditional propagator's GN(1) sites in bf16 and
     f32, one of them over one row per sample, and its GN(32), each also
     with its gradient), and also in f16 at an odd field, 3 channels per
     group, batch 1, the largest f32 slab a cluster holds and two slabs past
     it, printing each launch plan, twice bitwise-identical, and at the
     GroupNorm sites of a stage-2 train step's forward of each family, found
     by recording the calls of one ``rollout_loss`` on the card; kernel 2
     also at SW's 24x48 and 48x96 c64 at batch 336; kernels 4 and 5 in bf16, f16 and
     f32 at the paths' and the decode chunk's shapes and at sides and
     channel counts off their tiles, kernel 4 with the norm, without it and
     with its statistics output, printing each launch plan and each d-tile's
     device time, twice bitwise-identical), TF32 off, and times both with
     CUDA events beside the least time the card could take (the bound) and,
     for kernels 3-7, the same function in PyTorch library calls (kernels 3,
     4 and 5 also by CUDA graph replays, without the host's launch cost);
     checks that shapes outside the limits of kernels 1-5 raise naming the
     limit; holds the d-space FAB core's kernel path to its plain version
     and times the c-space and the d-space core at every FAB shape of the
     paths; compares GELU, swish and the SABlock's softmax in bf16 on the
     card with the CPU, where the tests pin them to the JAX package;
  4. runs ``LatentDynamics.predict`` at full width (bf16 activations, f32
     weights from a seeded generator) on four paths: ``ns2d_config()``
     (path 1) and the same model with attention in the encoder,
     ``use_attn_enc=True`` (path 2, whose 16x16 c128 encoder FAB takes the
     d-space core), each at batch 32, 29 steps and 116-frame decode chunks,
     ``sw_config()`` (path 3: batch 8, 42 steps, the 336 frames decoded at
     once, as the JAX package's SW benchmark), ``twophase_config()``
     (path 4: batch 8, 78 steps, the 624 frames decoded at once, as its
     two-phase benchmark) and ``twophase_conditional_config()`` (path 5:
     path 4's workload with a parameter per sample that conditions every
     step; its propagator runs kernel 1's FiLM plan, one launch, after its
     conditioning's GroupNorms on kernel 3; its
     zero-initialised gates filled from the generator too, so the
     conditioning is live; one plain step from each bf16 carry against the
     next, and another parameter giving another output), and
     ``fourier_config()`` (path 6: path 1 with the autoencoder's Fourier
     layers, ``final_smoothing`` and ``fourier_resolutions`` [64, 32]:
     FourierBasicBlocks at the encoder's 64x64 and 32x32 levels and after
     the decoder's last conv, their FFTs cuFFT's; batch 32, 29 steps,
     116-frame chunks). For each path it sets
     every launch count to 0, runs one predict, checks the output and that
     every kernel launched as often as the model's layer specs imply,
     compares the kernel path with the all-plain path in f32 on a small
     input, times frames/s of both and the host's enqueue time per predict,
     prints the peak device memory of one predict, and profiles one predict
     of each (device busy and idle, largest kernels, the FFTs' share).
     Path 6 also: its f32 decode on the card against the CPU (cuFFT
     against pocketfft, 3e-4), a profiled decode chunk (the FFTs' share)
     and one stage-1 train step's gradients, kernel path against plain
     (``check_fourier``). Path 7 (``drive_cond_encoder``):
     ``ConditionalSimpleAutoencoder`` on ``twophase_conditional_config()``
     at batch 32 in bf16, one forward and backward with its launch counts
     (kernel 3 at every GroupNorm of the forward, none in the backward),
     the f32 forward and the gradients against the plain path, kernel 3 at
     each of the encoder's new GroupNorm sites against its plain version.
     The library blocks (``drive_library``: the library propagators,
     LABlock, CABlock, the FNO mixers, CondFourierBasicBlock, the 1D and
     3D spectral convs, SirenNet, EmbeddingWrapper at sizes a user would
     run): f32 on the card against the CPU, kernel path against plain,
     bf16 with launch counts, kernel 3 at each of their GroupNorm sites;
  5. trains stage 2 at full NS2d width (``Stage2Trainer``, bf16): a
     synthetic corpus of 64 cases x 30 frames, a seeded AE saved as a
     stage-1 ``.pt`` and loaded (bitwise), the encode pre-pass (kernel 3 at
     every encoder GN site, each call held to the plain version on its own
     input; its corpus against an all-plain encode in bf16 and f32), one
     train step's gradients on the kernel path against the plain path (f32
     and bf16; kernel 3 launched in the forward through its autograd
     Function, each launch held to the plain version on its own input with
     its gradient, every GroupNorm parameter with a gradient), kernels 1
     and 5-7 and kernel 4 with its norm refusing a gradient, two epochs
     (96 steps) with three
     validations through ``predict`` (kernels 1-3), launch counts, finite
     losses, a frozen AE, checkpoints and a resume; then validation on the
     trained weights against the plain path (every kernel call of its
     predict on its own input, ``validate`` on the plain path, and the f32
     latents at its shape); ``evaluate_checkpoint`` on the run's
     ``model_best.pt`` equal to its ``meta_best.json`` value, its launches
     one validation's, its frames/s, and in f32 the kernel path within 3e-4
     of the plain path; ``model_best.pt`` and the AE's ``.pt`` through
     ``.msgpack`` and back with ``lns_tpu_torch.cli.convert``, bitwise,
     with no flax or msgpack module; prints train ms per step, steps/s,
     encode frames/s, validate ms and a profile of five train steps;
  6. trains stage 1 at full NS2d width (``Stage1Trainer``, bf16, batch 32,
     the frames on the card) on the same synthetic corpus: one train step's
     launches (kernel 3 at every AE GroupNorm site and kernel 2 at each FAB
     in the forward, nothing in the backward) and gradients, kernel path
     against the plain path (f32 and bf16; every AE parameter with a
     gradient; each kernel 2 and 4 call held on its own input with its
     gradient), on path 1 and on path 2 (whose encoder FAB runs kernel 4
     under grad); two epochs (108 steps, three validations) with launch
     counts, finite and falling losses, checkpoints and a resume; the
     trained AE's validation against the plain path (every kernel 2 and 3
     call held to accuracy parity, kernel 2's conditioning on the trained
     decode printed); the final checkpoint loaded into ``LatentDynamics``
     for one full-size predict on kernels 1-3; prints train ms per step,
     steps/s, frames/s, validate ms, the backward's share in the plain
     recomputes and a profile of five train steps;
  7. trains the SW family at full width on a synthetic 96x192 corpus (12
     training and 4 test cases x 24 frames), the two-phase family on a
     61x121 linear-sloshing corpus (``make_sloshing_dir``, 20 training and
     3 test cases x 16 frames, each of its own depth) and the conditional
     two-phase family on one of its own driving frequency per case
     (``vary="freq"``): stage 1 (``Stage1Trainer``, bf16, batch 32,
     two epochs; the two-phase loss on denormalised fields) with one train
     step's launches and gradients against the plain path (as phase 6),
     then stage 2 (``Stage2Trainer`` on that checkpoint, batch 32, out_tw
     5, three epochs) with its encode pre-pass and one train step's
     gradients against the plain path (f32 within 2 x the plain path's own
     change under a one-ulp move of its input, bf16 at accuracy parity);
     launch counts, finite and falling losses, the per-channel validation
     losses, the final checkpoint resumed bitwise, train ms per step and a
     profile of three steps each; ``evaluate_checkpoint`` on each family's
     ``model_best.pt`` equal to its ``meta_best.json`` value;
  8. trains NS2d at full width with data parallelism (``lns_tpu_torch.
     parallel``; 16 cases x 10 frames, batch 32, bf16, one epoch per run):
     two plain stage-2 runs on cuDNN's default algorithms, printed as
     bitwise alike or not; then, cuDNN held to its deterministic
     algorithms, the host path (side-stream prefetch) against
     ``device_data``, bitwise, and a process group of world size 1 over
     NCCL in which each trainer (stage 2 and stage 1) wraps its loss
     module in ``DistributedDataParallel`` and gives the plain trainer's
     losses, parameters and launches bitwise; prints both step times and
     the NCCL kernels' device time in one profiled step; two ranks where
     there are two cards, else one line saying so;
  9. runs the predict data-parallel (``lns_tpu_torch.parallel.
     sharded_predict``) at world size 1 over NCCL on paths 1, 3 and 5 at
     full width: bitwise equal to ``model.predict``, with its launches of
     kernels 1-3, timed beside it (``--ranks``: 2 and 4 ranks against one
     process in f32, within 1e-3 x max|ref|); traces one path-1 predict
     with ``utils.profiling.trace`` (kernels 1-3 named in the trace file,
     the predict's spans each holding its range on the profiler's clock),
     uses ``Timer`` and ``time_fn`` on the card, and
     checks that ``utils.debug.nan_debugging`` raises on a NaN planted in
     the predict's input and ``assert_finite`` names a planted infinity;
     then the corpus solvers: ``simulate_ns2d`` at full width (128 cases
     of 64x64, two records of 200 steps) on the card against the CPU
     (cuFFT against pocketfft, within 1e-4 x max|cpu|, the share of
     differing elements printed), the generator CLI
     (``python -m lns_tpu_torch.cli.generate_ns2d``) at its defaults with
     its wall seconds, steps/s and the corpus's statistics (fewer records,
     printed, where the solver's rate says the defaults take past 120 s;
     the solver's step eager against the same steps replayed from a CUDA
     graph, steps/s and bitwise equality printed),
     ``make_sw_solver_store`` at its defaults (96x192, 77 cases, 100
     records) with its wall seconds and a finite store, and one bf16
     stage-1 train step at full NS2d width on the generated corpus
     (kernels 2 and 3 launched as the specs imply, a finite loss);
 10. runs the ports of the TPU probe scripts once, untimed, with their own
     checks (``kernels/probe_layouts.py``, ``probe_fab_mega.py`` at b116,
     ``probe_bw.py`` at one s, ``probe_dots.py``'s 19 cases) and their
     launch counts, then holds each of their six kernels at its probe's
     shape against its plain version and times it beside its bound and
     library call: ``blocked_copy`` at [928, 2, 128, 2048] bf16 and at the
     reshapes (bitwise; at every s of ``probe_bw``'s sweep on both routes,
     as C reports them: the bulk one for these rows, the per-thread one for
     rows of odd bytes), ``fab_mega_stats`` (G and s 1e-3 x max|plain|, at
     b116 n8, twice bitwise, and at b1 n1 and b3 n5), ``fab_mega_apply``
     (1e-2, at most 2 % differing, at b116 n8, twice bitwise, and at b1 n1
     and b3 n3), the device ms of the copy, both passes and each chain
     (with ``--parent DIR``, a ``git archive`` of the parent commit, also
     the parent tree's, by ``probe_axial.py --tree DIR``), ``interior_dot``
     (``dot_general``'s straight x transposed orientation; 1e-2, at most 2 %
     differing, twice bitwise, its device ms beside the parent tree's);
     kernel 7 at the probes' transpose bitwise, kernel 6 at their dot to
     its tolerances; ``dot_general`` and ``dot_chain`` at each of the 19
     cases of ``benchmarks/probe_mosaic_dots.py`` (bf16 outputs of one
     product one ulp of max|plain| in at most 1 %, f32 1e-5, the moments
     1e-3, the chains with bf16 intermediates 1e-2; each operand's feed
     and each single dot's plan printed; each chain's two runs bitwise
     equal; the device ms of each single dot and chain beside the parent
     tree's), ``dot_general`` also off the probe's cases (every block tile
     the rule picks, the staged feed, ragged sizes, K = 200 and K off 32,
     a transposed view, f32 and mixed operands, sum_batch at batch 3 and
     13, the moments at one and at three row tiles a rank; each twice
     bitwise), and both refusing what their limits do not take;
 11. prints one JSON line of per-kernel results (launches per path or
     phase, and ms / plain_ms / bound_ms per predict, summed over one
     predict of each inference path, kernel 3 also over path 7's encoder
     sites and the library blocks' sites; kernel 1's FiLM plan,
     ``prop_rollout_film``, per call at the conditional cell's B2048 x 78;
     the probe kernels' per call at
     their probes' shapes), then the closing JSON line.

Any failed check or exception exits non-zero before the closing line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

BATCH, STEPS, CHUNK = 32, 29, 116
# the SW predict (path 3): the reference's SW rollout, batch 8 x 42 steps,
# decoded all at once (benchmarks/run_benchmarks.py:88, 113-116)
SW_BATCH, SW_STEPS = 8, 42
# the two-phase predict (path 4): batch 8 x 78 steps, the 624 frames decoded
# at once (benchmarks/run_benchmarks.py:89, 113-116)
TP_BATCH, TP_STEPS = 8, 78
LATENTS_BATCH = 256  # NS2d's ensemble screened in latent space: kernel 1's sample plan
COND_BATCH = 2048  # the conditional cell's tank cases (twophase_cond.latents.b2048): the FiLM plan
# the FiLM plan's per-step bound on its rms distance from the plain version,
# relative to the plain step's rms: above the kernel's readings (at most
# 0.92 % on an H100), below those of the same step with its f32 stretch in
# bf16 (at least 1.12 %; check_cond_rollout, PERF.md)
FILM_STEP_RMS = 1e-2
REPS = 3  # timed predicts per path and round (two rounds per path)
_FAILS: list = []


def _check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        _FAILS.append(what)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean time of fn() in ms by CUDA events around `reps` calls, after one
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, rel_tol, reps=5, max_differ=1.0):
    """Run both versions on the same inputs; error relative to max|plain|,
    and at most `max_differ` of the elements not equal."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    differ = (out != ref).float().mean().item() if out.shape == ref.shape else 1.0
    _check(finite and out.shape == ref.shape and err <= rel_tol * scale and differ <= max_differ,
           f"{name}: max_abs_err {err:.3e} <= {rel_tol:.0e} x max|plain| "
           f"({rel_tol * scale:.3e}); {differ:.2%} of elements differ"
           + (f" (<= {max_differ:.0%})" if max_differ < 1 else ""))
    ms, plain_ms = cuda_ms(kernel_fn, reps), cuda_ms(plain_fn, reps)
    print(f"      {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return err, ms, plain_ms


# the H100 SXM's published peaks (dense): bf16 tensor cores, f32 on CUDA
# cores, HBM3 bytes
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


class Bound:
    """The least time the card could take for a kernel's calls: per call the
    larger of its operations at the peak rate for their type and the bytes
    it must move (each input read once, each output written once) at the
    memory rate, summed over calls."""

    def __init__(self):
        self.ms, self.by = 0.0, {}

    def add(self, flops, nbytes, calls=1, rate=PEAK_BF16):
        ops_ms, bytes_ms = flops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        self.ms += calls * max(ops_ms, bytes_ms)
        self.by[by] = self.by.get(by, 0.0) + calls * max(ops_ms, bytes_ms)
        return self

    def result(self):
        return {"bound_ms": self.ms, "bound_by": max(self.by, key=self.by.get) if self.by else None}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# -- phase 2b: the bf16 kernels run on tensor cores --------------------------

# the redesigned kernels' bf16 entry points, by a piece of their SASS names
# (kernels 4 and 5: axial_tc<bf16, rows first> and <bf16, columns first>;
# kernel 2: the statistics pass with both axial applies and the Gram, the
# output pass with bb . m; kernel 1's sample and FiLM plans on wgmma; the probe's FAB
# passes; dot_general's bf16
# kernel, each of its block tiles, and the chains whose products include
# bf16 ones)
TENSOR_CORE_KERNELS = {"prop_rollout": ("rollout_bf16",),
                       "prop_rollout_samples": ("rollout_bf16_kernel_samples",),
                       "prop_rollout_film": ("rollout_film_kernel",),
                       "fab_core": ("fab_bb_stats_bf16", "fab_out_bf16"),
                       "fab_axial_in_fused": ("axial_tcI13__nv_bfloat16Lb1",),
                       "axial_kernel_apply_headmajor": ("axial_tcI13__nv_bfloat16Lb0",),
                       "bmm_blockdiag": ("bmm_bf16_kernel",),
                       "fab_mega_stats": ("fab_mega_stats_wgmma",),
                       "fab_mega_apply": ("fab_mega_apply_wgmma",),
                       "mosaic_dots": ("dot_general_bf16",
                                       *(f"dot_chain_kernelILi{c}E" for c in (0, 1, 2, 3, 4, 6)))}
# the kernels whose products must run on wgmma (HGMMA; HMMA alone fails)
WGMMA_KERNELS = ("prop_rollout_samples", "prop_rollout_film", "fab_core", "fab_mega_stats",
                 "fab_mega_apply")
# the kernels that must copy by TMA bulk copies (UBLKCP in their SASS), and
# the sources whose wgmma kernels ptxas must not serialize (its notes C7514,
# C7515, C7520 naming one of them fail)
BULK_COPY_KERNELS = ("blocked_copy_bulk",)
UNSERIALIZED_WGMMA = {"fab_mega.cu": ("fab_mega_stats_wgmma", "fab_mega_apply_wgmma"),
                      "prop_rollout.cu": ("rollout_bf16_kernel_samples", "rollout_film_kernel")}
# the f32 instantiations whose products must stay in full f32 on the CUDA
# cores: FFMA, and no HMMA or HGMMA (which would mean TF32)
CUDA_CORE_KERNELS = {"mosaic_dots": ("dot_general_f32", "dot_chain_kernelILi5E")}


def check_tensor_cores():
    """Count the tensor-core instructions (HMMA, or HGMMA for wgmma) in the
    SASS of each redesigned kernel's bf16 instantiation, read with the
    toolkit's cuobjdump from the built library; fails on a count of 0 (of
    HGMMA alone for the kernels in WGMMA_KERNELS) or a missing cuobjdump.
    The f32 instantiations of CUDA_CORE_KERNELS fail on any HMMA or HGMMA,
    or on no FFMA; BULK_COPY_KERNELS on no UBLKCP; UNSERIALIZED_WGMMA on a
    ptxas note that serializes one of its kernels' wgmma."""
    from lns_tpu_torch.kernels import _build

    try:
        tool = _build.cuda_tool("cuobjdump")
    except RuntimeError as e:
        _check(False, f"tensor cores: {e}")
        return
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    per_fn, fn = {}, None  # {function: [HMMA, HGMMA, FFMA, UBLKCP]}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            per_fn.setdefault(fn, [0, 0, 0, 0])
        elif fn is not None:
            for i, op in enumerate(("HMMA", "HGMMA", "FFMA", "UBLKCP")):
                per_fn[fn][i] += op in line
    for kernel, parts in TENSOR_CORE_KERNELS.items():
        wgmma = kernel in WGMMA_KERNELS
        for part in parts:
            found = {f: k[1] if wgmma else k[0] + k[1] for f, k in per_fn.items() if part in f}
            count = sum(found.values())
            ffma = sum(k[2] for f, k in per_fn.items() if part in f)
            _check(bool(found) and all(found.values()),
                   f"tensor cores: {kernel} bf16 {part}: {count} "
                   f"{'HGMMA' if wgmma else 'HMMA/HGMMA'} in {len(found)} instantiation(s) "
                   f"{sorted(found.values())}; {ffma} FFMA")
    for kernel, parts in CUDA_CORE_KERNELS.items():
        for part in parts:
            found = {f: k for f, k in per_fn.items() if part in f}
            _check(bool(found) and all(k[0] + k[1] == 0 and k[2] > 0 for k in found.values()),
                   f"CUDA cores: {kernel} f32 {part}: HMMA/HGMMA "
                   f"{sum(k[0] + k[1] for k in found.values())}, FFMA "
                   f"{sum(k[2] for k in found.values())} in {len(found)} instantiation(s)")
    for part in BULK_COPY_KERNELS:
        found = {f: k[3] for f, k in per_fn.items() if part in f}
        _check(bool(found) and all(found.values()),
               f"bulk copies: {part}: {sum(found.values())} UBLKCP in {len(found)} function(s)")
    for source, parts in UNSERIALIZED_WGMMA.items():
        notes = ptxas_notes(source)
        for part in parts:
            bad = [n for n in notes
                   if part in n and any(c in n for c in ("C7514", "C7515", "C7520"))]
            _check(not bad, f"wgmma: ptxas serializes none of {part}'s wgmma ({source}, "
                            f"-Xptxas -v){': ' + bad[0] if bad else ''}")


def ptxas_notes(source: str) -> list:
    """ptxas's -v lines for one csrc/ source, compiled alone with the
    library's flags into a scratch object (a few seconds)."""
    import tempfile

    from lns_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        out = subprocess.run([_build.cuda_tool(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              os.path.join(tmp, "probe.o"), str(_build.SOURCE_DIR / source)],
                             capture_output=True, text=True, timeout=600)
    _check(out.returncode == 0, f"wgmma: nvcc -Xptxas -v {source} exit {out.returncode}")
    return (out.stdout + out.stderr).splitlines()


# -- phase 3: each kernel against its plain version --------------------------

def _rollout_work(b, h, w, c_lat, c, steps, n_block, packed):
    """(FLOP, bytes) of one rollout call: every step's products (in-proj,
    n_block x (three 3x3 convs, two FFN matrices), out-proj); z0, the
    outputs and the packed weights moved once."""
    p = h * w
    flops = 2 * steps * b * p * (c_lat * c + n_block * 29 * c * c + c * c_lat)
    dt = packed.in_w.element_size()
    return flops, (1 + steps) * b * p * c_lat * dt + _nbytes(*packed)


def check_rollout(dev, gen, calls, tp_prop):
    """calls: rollout launches in one predict of each NS2d path; SW's
    predict (path 3) and the two-phase predict (path 4, whose propagator is
    `tp_prop`) add one call each at their shapes."""
    from lns_tpu_torch.kernels.prop_rollout import (fused_rollout, fused_rollout_plain,
                                                    pack_simple_cnn, rollout_plan)
    from lns_tpu_torch.models.propagator import SimpleCNN
    from lns_tpu_torch.ops.initializers import init_weights_

    bf16 = torch.bfloat16

    def packed_for(c_lat, c, dt):
        cnn = init_weights_(SimpleCNN(c_lat, 3, c, 2, padding_mode="circular"), gen)
        return pack_simple_cnn(cnn.to(dev), dt)

    errs = []
    # (tag, dtype, batch, H, W, C_lat, C, steps, padding, dilation, rel_tol).
    # f32 over several steps: summation order only, grown over the steps.
    # bf16, one step: both versions round at the same points; an f32 sum in
    # another order can move a value across a bf16 rounding boundary (about
    # half the elements then differ by an ulp, which the next layers carry).
    # The bf16 cases take each launch shape: clusters of 4 (B > 16) and 8,
    # 1, 3 and 5 row tiles per warp, C 64 (clusters of 4 with 16 channels
    # each), every padding mode, dilation 1 and 2, SW's 12x24 C_lat 64.
    cases = [
        (f"f32 {STEPS} steps circular B{BATCH} 8x8 C128", torch.float32, BATCH, 8, 8, 16, 128,
         STEPS, "circular", 2, 1e-4),
        ("f32 4 steps zeros B2 7x15 C64", torch.float32, 2, 7, 15, 64, 64, 4, "zeros", 2, 2e-5),
        ("f32 4 steps half_periodic_x B2 6x12 C64", torch.float32, 2, 6, 12, 64, 64, 4,
         "half_periodic_x", 2, 2e-5),
        ("f32 4 steps half_periodic_y B2 12x6 C64", torch.float32, 2, 12, 6, 64, 64, 4,
         "half_periodic_y", 2, 2e-5),
        (f"bf16 1 step circular B{BATCH} 8x8 C_lat 16 C128", bf16, BATCH, 8, 8, 16, 128, 1,
         "circular", 2, 2e-2),
        ("bf16 1 step circular B2 8x8 C_lat 16 C128", bf16, 2, 8, 8, 16, 128, 1, "circular", 2,
         2e-2),
        ("bf16 1 step half_periodic_x B4 12x24 C_lat 64 C128 (SW)", bf16, 4, 12, 24, 64, 128, 1,
         "half_periodic_x", 2, 2e-2),
        ("bf16 1 step half_periodic_x B20 12x24 C_lat 64 C128 (SW)", bf16, 20, 12, 24, 64, 128,
         1, "half_periodic_x", 2, 2e-2),
        ("bf16 1 step half_periodic_y B4 12x6 C_lat 16 C128", bf16, 4, 12, 6, 16, 128, 1,
         "half_periodic_y", 2, 2e-2),
        ("bf16 1 step zeros B3 7x15 C_lat 64 C64", bf16, 3, 7, 15, 64, 64, 1, "zeros", 2, 2e-2),
        ("bf16 1 step zeros B20 7x15 C_lat 64 C128 dilation 1", bf16, 20, 7, 15, 64, 128, 1,
         "zeros", 1, 2e-2),
    ]
    for tag, dt, b, h, w, c_lat, c, steps, pm, dil, tol in cases:
        packed = packed_for(c_lat, c, dt)
        z0 = torch.randn(b, h, w, c_lat, generator=gen).to(dev)
        if dt == bf16:
            print(f"      prop_rollout {tag}: launch {rollout_plan(b, h, w, c_lat, c)}", flush=True)
        errs.append(compare(
            f"prop_rollout {tag}",
            lambda: fused_rollout(z0, packed, steps, 3, dil, pm),
            lambda: fused_rollout_plain(z0, packed, steps, 3, dil, pm), tol, reps=3)[0])

    # the main path's call: bf16, all steps, B = 32
    packed = packed_for(16, 128, bf16)
    z0 = torch.randn(BATCH, 8, 8, 16, generator=gen).to(dev)
    plan = rollout_plan(BATCH, 8, 8, 16, 128)
    _check(plan["cluster"] >= 2 and plan["blocks"] == BATCH * plan["cluster"]
           and plan["max_active_clusters"] >= BATCH,
           f"prop_rollout bf16 B{BATCH} 8x8 C_lat 16 C128 launch: {plan['cluster']} blocks per "
           f"sample, {plan['blocks']} blocks of {plan['smem_bytes']} bytes of shared memory, "
           f"{plan['tiles_per_warp']} row tile(s) per warp; the card holds "
           f"{plan['max_active_clusters']} such clusters at once")
    err, ms, plain_ms, bound = _path_rollout("main path", z0, packed, STEPS, 3, 2, "circular")
    errs.append(err)
    errs += check_rollout_sample_plan(dev, gen, packed_for)

    # SW's call (path 3): bf16, B8 x 42 steps at 12x24, C_lat 64, C 128, 4
    # residual blocks, dilation 3, half_periodic_x
    sw = init_weights_(SimpleCNN(64, 4, 128, 3, padding_mode="half_periodic_x"), gen).to(dev)
    z0 = torch.randn(SW_BATCH, 12, 24, 64, generator=gen).to(dev)
    print(f"      prop_rollout bf16 B{SW_BATCH} 12x24 C_lat 64 C128 (SW): launch "
          f"{rollout_plan(SW_BATCH, 12, 24, 64, 128)}", flush=True)
    sw_err, sw_ms, sw_plain_ms, sw_bound = _path_rollout(
        "SW", z0, pack_simple_cnn(sw, bf16), SW_STEPS, 4, 3, "half_periodic_x")
    errs.append(sw_err)

    # f32 keeps one block per sample; SW's activations (517,888 bytes per
    # sample) live in the workspace the wrapper allocates. Over 4 steps,
    # summation order only (the f32 cases above)
    z0 = torch.randn(2, 12, 24, 64, generator=gen).to(dev)
    packed32 = pack_simple_cnn(sw, torch.float32)
    err, _, _ = compare(
        "prop_rollout f32 4 steps half_periodic_x B2 12x24 C_lat 64 C128, 4 blocks, dilation 3 "
        "(SW; the activations in the workspace)",
        lambda: fused_rollout(z0, packed32, 4, 4, 3, "half_periodic_x"),
        lambda: fused_rollout_plain(z0, packed32, 4, 4, 3, "half_periodic_x"), 2e-5, reps=3)
    errs.append(err)

    # the two-phase call (path 4): bf16, B8 x 78 steps at 7x15, C_lat 64, C
    # 128, 4 residual blocks, dilation 2, zeros; the JAX package runs zeros
    # mode as its XLA scan, the port launches kernel 1 (the times printed
    # here, kernel against the plain step loop, are why)
    z0 = torch.randn(TP_BATCH, 7, 15, 64, generator=gen).to(dev)
    print(f"      prop_rollout bf16 B{TP_BATCH} 7x15 C_lat 64 C128 (two-phase): launch "
          f"{rollout_plan(TP_BATCH, 7, 15, 64, 128)}", flush=True)
    tp_err, tp_ms, tp_plain_ms, tp_bound = _path_rollout(
        "two-phase", z0, pack_simple_cnn(tp_prop, bf16), TP_STEPS, 4, 2, "zeros")
    errs.append(tp_err)
    z0 = torch.randn(2, 7, 15, 64, generator=gen).to(dev)
    packed32 = pack_simple_cnn(tp_prop, torch.float32)
    err, _, _ = compare(
        "prop_rollout f32 4 steps zeros B2 7x15 C_lat 64 C128, 4 blocks, dilation 2 (two-phase)",
        lambda: fused_rollout(z0, packed32, 4, 4, 2, "zeros"),
        lambda: fused_rollout_plain(z0, packed32, 4, 4, 2, "zeros"), 2e-5, reps=3)
    errs.append(err)
    return {"max_abs_err": max(errs), "ms": ms * calls + sw_ms + tp_ms,
            "plain_ms": plain_ms * calls + sw_plain_ms + tp_plain_ms,
            "bound_ms": bound.ms * calls + sw_bound.ms + tp_bound.ms,
            "bound_by": bound.result()["bound_by"], "library_ms": None}


def check_rollout_sample_plan(dev, gen, packed_for):
    """Kernel 1's sample plan (a block per two samples, wgmma, weights
    multicast to a cluster): the plan the C side reports at NS2d's B256
    (samples) against B32 and SW's B8 (clusters); NS2d's B256 x 29 steps
    circular, and B256 x 4 steps in zeros, half_periodic_x and
    half_periodic_y, each step from the kernel's own carry against a plain
    step at kernel 1's bound, two runs bitwise equal. Returns the errors."""
    from lns_tpu_torch.kernels.prop_rollout import rollout_plan

    for b, h, w, c_lat, want in ((LATENTS_BATCH, 8, 8, 16, "samples"), (BATCH, 8, 8, 16, "cluster"),
                                 (SW_BATCH, 12, 24, 64, "cluster")):
        plan = rollout_plan(b, h, w, c_lat, 128)
        _check(plan["plan"] == want, f"prop_rollout bf16 B{b} {h}x{w} C_lat {c_lat} C128 takes the "
                                     f"{want} plan: {plan}")
    errs = []
    for steps, pm in ((STEPS, "circular"), (4, "zeros"), (4, "half_periodic_x"),
                      (4, "half_periodic_y")):
        packed = packed_for(16, 128, torch.bfloat16)
        z0 = torch.randn(LATENTS_BATCH, 8, 8, 16, generator=gen).to(dev)
        errs.append(_path_rollout(f"sample plan, {pm}", z0, packed, steps, 3, 2, pm)[0])
    return errs


def check_cond_rollout(dev, gen, model):
    """Kernel 1's FiLM plan (``fused_cond_rollout``: a block per sample at a
    time, one m64 half per consumer warpgroup, wgmma, weights multicast to a
    cluster, the batch walked persistently) on `model`'s conditional
    propagator (bf16, its gates open), at 7x15: the launch the C side
    reports at B2048 (the conditional cell's batch), B1 and a batch whose
    last pass leaves blocks idle; at each (B2048 x 4, B1 x 78 and that
    batch x 4 steps) every step from the kernel's own carry against one
    plain step (``fused_cond_rollout_plain``) within 2e-2 x max|plain|
    (kernel 1's per-step bound) and within FILM_STEP_RMS in the rms
    distance, which the same steps with the f32 stretch in bf16
    (``_film_bf16_stretch``, the control) must exceed, and two runs bitwise
    equal; B2048 x 78 timed against the plain version and the bound; a
    shape past the limit refused with the C side's text; one predict of
    `model` naming plan "film" on ``lns.rollout``, launching the kernel
    once and stepping no sample through the module loop. Returns the
    kernel's result (largest error, per predict ms, plain ms, bound ms)."""
    from lns_tpu_torch.kernels.prop_rollout import (cond_rollout_plan, cond_terms, film_takes,
                                                    fused_cond_rollout, fused_cond_rollout_plain,
                                                    pack_cond_simple_cnn)
    from lns_tpu_torch.models import latent_dynamics
    from lns_tpu_torch.utils import profiling

    p = model.propagator
    c_lat, c = p.in_proj.weight.shape[1], p.in_proj.weight.shape[0]
    nb, dil = p.prop_n_block, p.dilation
    packed = pack_cond_simple_cnn(p, torch.bfloat16)
    plan = cond_rollout_plan(COND_BATCH, 7, 15)
    ragged = plan["max_active_clusters"] * plan["cluster"] + 1  # two passes, some blocks idle
    errs = []
    for b, steps in ((COND_BATCH, 4), (1, TP_STEPS), (ragged, 4)):
        pl = cond_rollout_plan(b, 7, 15)
        idle = pl["blocks"] * pl["passes"] - b
        print(f"      prop_rollout film B{b} 7x15: launch {pl}; {idle} idle block-passes",
              flush=True)
        z0 = torch.randn(b, 7, 15, c_lat, generator=gen).to(dev, torch.bfloat16)
        cond = (torch.rand(b, generator=gen) * 0.6 + 0.3).to(dev)
        with torch.no_grad():
            e, cf = cond_terms(p.conditioning(cond))
            label = f"prop_rollout film bf16 {steps} steps B{b} 7x15"
            zs, zs2 = (fused_cond_rollout(z0, packed, e, cf, steps, nb, dil) for _ in range(2))
            torch.cuda.synchronize()
            _check(torch.equal(zs, zs2), f"{label}: two runs bitwise identical")
            prev = torch.cat([z0[None], zs[:-1]]).reshape(-1, 7, 15, c_lat)
            er, cr = e.repeat(1, steps, 1), cf.repeat(1, steps, 1)
            one = fused_cond_rollout_plain(prev, packed, er, cr, 1, nb, dil)
            one = one.reshape(zs.shape).float()
            ctl = _film_bf16_stretch(prev, packed, er, cr, nb, dil).reshape(zs.shape).float()
        err = (one - zs.float()).abs().amax(dim=(1, 2, 3, 4))
        ratio = (err / one.abs().amax(dim=(1, 2, 3, 4))).max().item()
        differ = (one != zs.float()).float().mean().item()
        rms, ctl_rms = _rms_ratio(zs, one), _rms_ratio(ctl, one)
        ctl_ratio = ((ctl - one).abs().amax(dim=(1, 2, 3, 4))
                     / one.abs().amax(dim=(1, 2, 3, 4))).max().item()
        _check(bool(torch.isfinite(zs).all()) and ratio <= 2e-2 and rms <= FILM_STEP_RMS,
               f"{label}, every step from the kernel's own carry: max_abs_err <= {ratio:.2e} x "
               f"max|plain| (<= 2e-2), rms distance <= {rms:.3e} x rms(plain) (<= "
               f"{FILM_STEP_RMS:.0e}); {differ:.2%} of elements differ")
        _check(ctl_rms > FILM_STEP_RMS,
               f"{label}, the control (f32 stretch in bf16): rms distance >= {ctl_rms:.3e} x "
               f"rms(plain) (> {FILM_STEP_RMS:.0e}), max_abs_err <= {ctl_ratio:.2e} x max|plain|")
        errs.append(err.max().item())

    b, steps = COND_BATCH, TP_STEPS
    z0 = torch.randn(b, 7, 15, c_lat, generator=gen).to(dev, torch.bfloat16)
    with torch.no_grad():
        e, cf = cond_terms(p.conditioning(torch.rand(b, generator=gen).to(dev)))
        ms = cuda_ms(lambda: fused_cond_rollout(z0, packed, e, cf, steps, nb, dil), 3)
        plain_ms = cuda_ms(lambda: fused_cond_rollout_plain(z0, packed, e, cf, steps, nb, dil), 1)
    rows = 7 * 15
    flops = 2 * b * steps * rows * (2 * c_lat * c + nb * (3 * 9 + 2) * c * c)
    bound = Bound().add(flops, _nbytes(z0, *packed, e, cf) + steps * _nbytes(z0))
    print(f"      prop_rollout film bf16 {steps} steps B{b} 7x15: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound.ms:.4f} ms ({bound.result()['bound_by']}), "
          f"{100 * bound.ms / ms:.1f} % of it", flush=True)

    z = torch.zeros(2, 12, 24, c_lat, device=dev, dtype=torch.bfloat16)
    try:
        fused_cond_rollout(z, packed, e[:, :2].contiguous(), cf[:, :2].contiguous(), 1, nb,
                           dil)
        refused = "nothing"
    except ValueError as exc:
        refused = str(exc)
    _check("H*W <= 128" in refused, f"prop_rollout film B2 12x24 refused: {refused}")
    _check(not film_takes(z, c, "zeros") and film_takes(z0, c, "zeros"),
           f"film_takes: B2 12x24 refused, B{b} 7x15 taken")

    x = torch.randn(4, model.cfg.Ly, model.cfg.Lx, model.cfg.in_channels, generator=gen).to(dev)
    key, launched = latent_dynamics.LOOP_STEPS, "prop_rollout.fused_cond_rollout.launches"
    before = profiling.counters()
    profiling.reset()
    with profiling.recording():
        model.predict_latents(x, 3, torch.rand(4, generator=gen).to(dev))
    after = profiling.counters()
    (roll,) = [r for r in profiling.spans() if r.name == "lns.rollout"]
    _check(roll.attrs.get("plan") == "film" and roll.attrs.get("path") == "kernel"
           and after.get(key, 0) == before.get(key, 0)
           and after.get(launched, 0) - before.get(launched, 0) == 1,
           f"conditional predict B4 x 3 steps: lns.rollout {roll.attrs}, loop_steps "
           f"+{after.get(key, 0) - before.get(key, 0)}, FiLM launches "
           f"+{after.get(launched, 0) - before.get(launched, 0)}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms,
            "bound_by": bound.result()["bound_by"], "library_ms": None}


def _rms_ratio(out, ref):
    """The largest over steps (the leading axis) of the rms distance of out
    from ref relative to ref's rms."""
    d = (out.float() - ref.float()).flatten(1)
    return (d.norm(dim=1) / ref.float().flatten(1).norm(dim=1)).max().item()


def _film_bf16_stretch(z, packed, e, c, n_block, dilation):
    """The control of the FiLM plan's check: one step of
    ``fused_cond_rollout_plain`` (bf16, zeros) with the f32 stretch in bf16:
    u (conv1.3's product, its bias and e) rounded before its GN(1), that GN
    and the GELU after it in bf16, and the FiLM product (h + g)(1 + c) from
    the rounded residual, in bf16, as is its GN(1)."""
    from lns_tpu_torch.kernels.prop_rollout import _conv3, _gn, _gn_module
    from lns_tpu_torch.ops.activations import gelu

    p, dt = packed, torch.bfloat16
    ev, cv = (t.float()[:, :, None, None, :] for t in (e, c))
    h = torch.matmul(z.to(dt), p.in_w) + p.in_b.to(dt)
    for i in range(n_block):
        t = _gn_module(h, p.gn_s[i, 0], p.gn_b[i, 0], 1, 1e-5)
        t = gelu(_conv3(t, p.conv_w[i, 0], p.conv_b[i, 0], 1, "zeros"))
        u = (_conv3(t, p.conv_w[i, 1], None, dilation, "zeros").float()
             + p.conv_b[i, 1].to(dt).float() + ev[i]).to(dt)
        u = gelu(_gn(u, p.gn_s[i, 1], p.gn_b[i, 1], 1, 1e-5))
        g = _conv3(u, p.conv_w[i, 2], p.conv_b[i, 2], 1, "zeros")
        f = _gn((h + g) * (1 + cv[i]).to(dt), p.gn_s[i, 2], p.gn_b[i, 2], 1, 1e-5)
        h = (h + g) + torch.matmul(gelu(torch.matmul(f, p.ffn_w[i, 0])), p.ffn_w[i, 1])
    h = _gn_module(h, p.out_gn_s, p.out_gn_b, 32, 1e-6)
    return torch.matmul(h, p.out_w) + p.out_b.to(dt)


def _path_rollout(tag, z0, packed, steps, n_block, dil, pm):
    """A path's rollout call (bf16, all its steps): two runs bitwise equal;
    every step from the kernel's own carry, one plain step from z_k against
    the kernel's z_(k+1), within the one-step bound (bf16's growth over a
    rollout does not enter); the kernel's and the plain version's time and
    the bound. Returns (max error, ms, plain ms, Bound)."""
    from lns_tpu_torch.kernels.prop_rollout import fused_rollout, fused_rollout_plain

    b, h, w, c_lat = z0.shape
    label = f"prop_rollout bf16 {steps} steps B{b} {h}x{w} ({tag})"
    run = lambda: fused_rollout(z0, packed, steps, n_block, dil, pm)  # noqa: E731
    zs, zs2 = run(), run()
    torch.cuda.synchronize()
    _check(torch.equal(zs, zs2), f"{label}: two runs bitwise identical")
    prev = torch.cat([z0.to(torch.bfloat16)[None], zs[:-1]])
    one = fused_rollout_plain(prev.reshape(-1, h, w, c_lat), packed, 1, n_block, dil, pm)
    one = one.reshape(zs.shape).float()
    err = (one - zs.float()).abs().amax(dim=(1, 2, 3, 4))
    ratio = (err / one.abs().amax(dim=(1, 2, 3, 4))).max().item()
    differ = (one != zs.float()).float().mean().item()
    _check(bool(torch.isfinite(zs).all()) and ratio <= 2e-2,
           f"{label}, every step from the kernel's own carry: max_abs_err <= {ratio:.2e} x "
           f"max|plain| (<= 2e-2); {differ:.2%} of elements differ")
    ms = cuda_ms(run, 3)
    plain_ms = cuda_ms(lambda: fused_rollout_plain(z0, packed, steps, n_block, dil, pm), 3)
    bound = Bound().add(*_rollout_work(b, h, w, c_lat, packed.in_w.shape[1], steps, n_block,
                                       packed))
    print(f"      {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound.ms:.4f} ms "
          f"({bound.result()['bound_by']})", flush=True)
    return err.max().item(), ms, plain_ms, bound


def _block_mean_inputs(gen, dev, b, h, w, c, kx, ky):
    """bf16 inputs of the FAB core as ``FABlock2D`` gives them: u the
    GroupNorm(1) output bf16(bf16(x sc) + sh) of a block input x, and
    mean_from (x, the coefficients [b, 2, c], the kernels' f32 row sums,
    each 5 % off the sums of the rounded kernels, as the unrounded products'
    sums are off them by less). Offsets sh of O(1) give each channel a mean
    that the statistics must carry."""
    x = (torch.randn(b, h, w, c, generator=gen) * 1.5 + 0.3).to(dev, torch.bfloat16)
    sc = (1 + 0.2 * torch.randn(b, c, generator=gen)).to(dev, torch.bfloat16)
    sh = torch.randn(b, c, generator=gen).to(dev, torch.bfloat16)
    u = x * sc[:, None, None] + sh[:, None, None]
    sums = [k.float().sum(2) * (1 + 0.05 * torch.randn(k.shape[:3], generator=gen).to(dev))
            for k in (kx, ky)]
    return u, (x, torch.stack([sc, sh], 1).float(), *sums)


def check_fab_core(dev, gen, sites, n, d, extras=True):
    """sites: {(batch, h, w, c): c-space FAB core calls per predict}; with
    `extras`, also the shapes that take the kernel's other code paths. bf16
    takes its inputs as the FAB block gives them (``_block_mean_inputs``),
    the mean formed inside the call, so the times include it; with
    `extras`, at one shape also the block's mean scaled so that the
    variance about it cancels, for some (sample, head, d) or most, where
    both take ``_batched_gram_core``'s clamp to 0."""
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core, phi_moments

    errs, ms_sum, plain_sum, bound = [], 0.0, 0.0, Bound()
    # the paths' fields, then both orientations of a non-square one (both
    # versions apply k_x first for w > h, k_y first for w <= h), odd sides
    # (partly filled tiles, sides padded to 16), fields whose u is held in
    # shared memory at c 96 and 128 (there the statistics' G overwrites u
    # once it is read), and fields whose u does not fit in shared memory
    # (bf16 streams it through the ring: 48x40, 64x64 and 80x40 also take
    # the apply kernel's 3-5 row tiles per warp, 128x24 its 8 with k_x
    # loaded per head, c128 four Gram blocks per warp); SW's 24x48 and
    # 48x96 (run transposed with a compact a: 231,872 bytes), and a 128-wide
    # 40x128
    shapes = sorted(sites) + [(4, 12, 24, 64), (4, 24, 12, 64), (2, 15, 31, 64),
                              (32, 16, 16, 128), (8, 16, 16, 96),
                              (2, 48, 40, 64), (1, 64, 64, 64), (2, 32, 32, 128),
                              (2, 80, 40, 64), (1, 128, 24, 32),
                              (4, 24, 48, 64), (2, 48, 96, 64), (1, 40, 128, 32)] * extras
    # last, u and w_o1 off 16-byte boundaries (the wrapper copies them)
    for (b, h, w, c), off in [(s, False) for s in shapes] + [((2, 16, 16, 64), True)] * extras:
        u = torch.randn(b, h, w, c, generator=gen)
        kx = torch.randn(b, n, h, h, generator=gen) / h
        ky = torch.randn(b, n, w, w, generator=gen) / w
        w_in = torch.randn(c, n, d, generator=gen) / c ** 0.5
        w_o1 = torch.randn(n, d, c, generator=gen) / d ** 0.5
        args = [t.to(dev) for t in (u, kx, ky, w_in, w_o1)]
        # f32: sums over h*w*c terms in another order. bf16: both apply k_y
        # first for w <= h and k_x first for w > h (as _batched_gram_core)
        # and round a, bb, m, the bias, the head sum and the output to bf16
        # at the same points, so they differ only where an f32 sum in another
        # order crosses a rounding boundary: about one bf16 ulp of the
        # largest value (1e-2) in a few elements per thousand (at most 2 %;
        # with a, bb, m in f32, or the output rounded once, a quarter or
        # more differ)
        for dt, tol, differ in ((torch.float32, 1e-4, 1.0), (torch.bfloat16, 1e-2, 0.02)):
            a = [args[0].to(dt), args[1].to(dt), args[2].to(dt), args[3], args[4]]
            mf = None
            if dt == torch.bfloat16:
                a[0], mf = _block_mean_inputs(gen, dev, b, h, w, c, a[1], a[2])
            if off:
                a[0], a[4] = _off_16(a[0]), _off_16(a[4])
                mf = mf and (_off_16(mf[0]),) + mf[1:]
            err, ms, plain_ms = compare(
                f"fab_core {str(dt)[6:]} b{b} {h}x{w} c{c} n{n}"
                + (", the block's mean" if mf else "")
                + (" (u, w_o1, x off 16-byte boundaries)" if off else ""),
                lambda: fab_fused_core(*a, mean_from=mf),
                lambda: fab_core_plain(*a, mean_from=mf), tol, max_differ=differ)
            errs.append(err)
            if extras and mf and (b, h, w, c) == (4, 12, 24, 64):
                for scale in (4.0, 30.0):
                    ms_ = (mf[0], mf[1], mf[2] * scale, mf[3])
                    ex2, mean = phi_moments(*a[:4], mean_from=ms_)
                    errs.append(compare(
                        f"fab_core bf16 b{b} {h}x{w} c{c} n{n}, the block's mean x {scale}: the "
                        f"variance cancelled to <= 0 at {int((ex2 - mean.square() <= 0).sum())} "
                        f"of {ex2.numel()} (sample, head, d)",
                        lambda: fab_fused_core(*a, mean_from=ms_),
                        lambda: fab_core_plain(*a, mean_from=ms_), tol,
                        max_differ=differ)[0])
            if dt == torch.bfloat16 and not off:
                print_fab_plan(b, h, w, c, d, w_o1.shape[-1], n)
            if dt == torch.bfloat16 and (b, h, w, c) in sites and not off:
                runs = [fab_fused_core(*a, mean_from=mf) for _ in range(2)]
                _check(torch.equal(*runs),
                       f"fab_core bf16 b{b} {h}x{w} c{c}: two runs bitwise equal")
                ms_sum += ms * sites[(b, h, w, c)]
                plain_sum += plain_ms * sites[(b, h, w, c)]
                # per (sample, head): k_y and k_x applied, the c x c Gram, the
                # output product, the two means and m's and E[phi^2]'s small
                # products
                o = c
                flops = 2 * b * n * (h * w * w * c + h * h * w * c + h * w * c * c + h * w * c * o
                                     + 2 * h * w * c + c * c * d + c * d * o)
                bound.add(flops, _nbytes(*a[:3], a[0], *mf) + c * n * d * 2 + _nbytes(a[4]),
                          sites[(b, h, w, c)])
    return {"max_abs_err": max(errs), "ms": ms_sum, "plain_ms": plain_sum, **bound.result(),
            "library_ms": None}


def check_fab_core_heads(dev, gen):
    """Kernel 2 at head counts whose clusters are not 8 blocks (the
    statistics pass clusters the largest divisor of n up to 8: n = 1, 3, 4,
    12 take clusters of 1, 3, 4 and 6) and a d that is not a multiple of 4
    (the moments pass pads it), in f32 and bf16 at ``check_fab_core``'s
    bounds, bf16 with the block's mean."""
    from lns_tpu_torch.kernels.fab_core import bf16_plan, fab_core_plain, fab_fused_core

    for (b, h, w, c), n, d in (((2, 16, 16, 64), 1, 18), ((2, 16, 16, 64), 3, 18),
                               ((2, 12, 24, 64), 4, 64), ((2, 24, 48, 64), 12, 64)):
        kx = (torch.randn(b, n, h, h, generator=gen) / h).to(dev)
        ky = (torch.randn(b, n, w, w, generator=gen) / w).to(dev)
        w_in = (torch.randn(c, n, d, generator=gen) / c ** 0.5).to(dev)
        w_o1 = (torch.randn(n, d, c, generator=gen) / d ** 0.5).to(dev)
        u32 = torch.randn(b, h, w, c, generator=gen).to(dev)
        for dt, tol, differ in ((torch.float32, 1e-4, 1.0), (torch.bfloat16, 1e-2, 0.02)):
            a = [u32.to(dt), kx.to(dt), ky.to(dt), w_in, w_o1]
            mf = None
            if dt == torch.bfloat16:
                a[0], mf = _block_mean_inputs(gen, dev, b, h, w, c, a[1], a[2])
            label = f"fab_core {str(dt)[6:]} b{b} {h}x{w} c{c} n{n} d{d}"
            if dt == torch.bfloat16:
                label += f" (a cluster of {bf16_plan(h, w, c, d, c, n)['cluster']})"
            compare(label, lambda: fab_fused_core(*a, mean_from=mf),
                    lambda: fab_core_plain(*a, mean_from=mf), tol, max_differ=differ)


def print_fab_plan(b, h, w, c, d, o, n):
    """Kernel 2's bf16 launch plan at a shape: the statistics pass's cluster,
    blocks, shared memory and clusters resident at once, its tile and ring,
    the moments and output passes' blocks and shared memory, and the bb and
    G scratch."""
    from lns_tpu_torch.kernels.fab_core import bf16_plan

    p = bf16_plan(h, w, c, d, o, n)
    out_blocks = -(-h * w // 128) * -(-o // 64) * b
    print(f"      fab_core plan b{b} {h}x{w} c{c} n{n}: statistics {n * b} blocks in clusters of "
          f"{p['cluster']} ({p['active_clusters']} clusters at once), {p['stats_smem']} bytes "
          f"of shared memory, {p['tiles']} tile(s) of {p['tile_cols']} columns, u ring "
          f"{p['ring_stages']} x {p['ring_rows']} rows; moments {n * b} blocks, "
          f"{p['moments_smem']} bytes; output {out_blocks} blocks, {p['out_smem']} bytes; "
          f"scratch: bb {b * n * h * w * p['cp'] * 2} bytes, G {b * n * c * c * 4}", flush=True)


def _off_16(t):
    """A contiguous copy of t that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


def check_fab_core_limits(dev, n, d):
    """A bf16 shape outside kernel 2's limits raises in the wrapper, naming
    the limit the C side states, and launches nothing."""
    from lns_tpu_torch.kernels.fab_core import fab_fused_core

    for h, w, c, o, limit in ((16, 16, 24, 64, "c a multiple of 16"),
                              (16, 16, 256, 64, "c a multiple of 16"),
                              (16, 16, 64, 40, "o a multiple of 16"),
                              (129, 16, 64, 64, "h, w in [1, 128]"),
                              (128, 128, 128, 128, "shared memory per block")):
        bf = torch.bfloat16
        args = (torch.zeros(1, h, w, c, device=dev, dtype=bf),
                torch.zeros(1, n, h, h, device=dev, dtype=bf),
                torch.zeros(1, n, w, w, device=dev, dtype=bf),
                torch.zeros(c, n, d, device=dev), torch.zeros(n, d, o, device=dev))
        before = _launched("fab_core.fab_fused_core")
        try:
            fab_fused_core(*args)
            msg = "no error"
        except ValueError as e:
            msg = str(e)
        _check(limit in msg and _launched("fab_core.fab_fused_core") == before,
               f"fab_core bf16 {h}x{w} c{c} o{o} raises naming '{limit}': {msg}")


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one fn() in ms with the host's launch cost taken out:
    `calls` calls captured in one CUDA graph, the graph replayed `reps`
    times between CUDA events (after one warm-up call and one replay)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del g
    return ms


def _gn_library(xd, scale, bias, groups, eps, swish, cast):
    """One PyTorch call of the same function: F.group_norm on the NCHW view
    of the channels-last memory (weights cast to the activations' dtype when
    `cast`), then F.silu at the swish sites (a second call)."""
    import torch.nn.functional as F

    w, b = (scale.to(xd.dtype), bias.to(xd.dtype)) if cast else (scale, bias)
    y = F.group_norm(xd.movedim(-1, 1), groups, w, b, eps)
    return F.silu(y) if swish else y


def _gn_library_casts(dev):
    """Whether F.group_norm needs its weights cast to bf16 for a bf16 input
    (it refuses f32 weights with bf16 input)."""
    x0 = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    try:
        _gn_library(x0, torch.ones(32, device=dev), torch.zeros(32, device=dev), 32, 1e-6,
                    False, False)
        return False
    except RuntimeError:
        return True


def check_group_norm(dev, gen, sites, train_sites, label="both NS2d paths", extras=True):
    """Kernel 3 at every GroupNorm site of the paths (sites: {(batch,
    spatial, C, groups, eps, swish): calls per predict}), at every site of a
    stage-2 train step's forward (train_sites: {site: calls per train
    step}) and, with `extras`, at shapes that take its other plans, in bf16
    and f32 (f16 too at those shapes); two runs bitwise equal at the largest
    site; with `extras`, a shape outside its limits raises naming the
    limit. Slabs that a cluster of 8 blocks cannot hold (SW's 96x192 fields)
    take the split plan; its launch is printed like the cluster's."""
    from lns_tpu_torch.kernels.group_norm import (fused_group_norm_swish, group_norm_plan,
                                                  group_norm_swish_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # an odd field, 3 channels per group, G1 at another batch, batch 1, the
    # largest slab f32 takes in a cluster (8 blocks of ~200 KB), and slabs
    # past it that take the split plan (f32 64x64x128, bf16 128x128 without
    # the swish)
    extra = [(4, (7, 15), 64, 32, 1e-6, True), (4, (16, 16), 96, 32, 1e-6, True),
             (2, (32, 32), 64, 1, 1e-5, False), (1, (64, 64), 64, 8, 1e-5, True),
             (2, (64, 64), 96, 32, 1e-6, True), (2, (64, 64), 128, 32, 1e-6, True),
             (3, (128, 128), 64, 8, 1e-5, False)] if extras else []
    cast = _gn_library_casts(dev)
    print(f"      library call: F.group_norm (+ F.silu at swish sites) on the NCHW view"
          f"{'; bf16 weights (F.group_norm refuses f32 weights with bf16 input)' if cast else ''}",
          flush=True)
    errs, bound = [], Bound()
    ms_sum = dev_sum = plain_sum = lib_sum = 0.0
    train = dict.fromkeys(("ms", "dev", "plain", "lib"), 0.0)
    per_site = {site: [calls, 0] for site, calls in sites.items()}
    for site, calls in train_sites.items():
        per_site.setdefault(site, [0, 0])[1] = calls
    cases = sorted(per_site.items()) + [(e, [0, 0]) for e in extra]
    for (b, spatial, c, g, eps, swish), (calls, train_calls) in cases:
        x = (torch.randn((b,) + spatial + (c,), generator=gen) * 2 + 0.5).to(dev)
        scale = (torch.randn(c, generator=gen) * 0.1 + 1).to(dev)
        bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
        s = x.numel() // (b * c)
        tag = f"{b}x{'x'.join(map(str, spatial))}x{c} G{g} eps{eps:g}{' +swish' if swish else ''}"
        # f32: statistics summed in another order. bf16 (and f16, by the
        # same rule, at the extra shapes): both round sc, sh, the product,
        # the sum and every op of the swish at the same points; an f32 sum in
        # another order can move one (sample, channel)'s sc or sh by one
        # ulp, and some of that channel's elements with it
        dtypes = [(f32, 1e-5, 1.0), (bf16, 1e-2, 0.02)]
        timed = calls or train_calls
        for dt, tol, differ in dtypes + ([] if timed else [(torch.float16, 1e-2, 0.02)]):
            xd = x.to(dt)
            plan = group_norm_plan(dt, b, s, c, g)
            if plan["chunks"]:
                print(f"      group_norm {str(dt)[6:]} {tag}: split plan (x read twice), "
                      f"{plan['chunks']} chunks of {plan['rows_per_block']} rows per sample, "
                      f"{plan['blocks']} blocks of {plan['smem_bytes']} bytes of shared memory "
                      f"per pass; the card holds {plan['max_active_clusters']} such blocks at "
                      "once", flush=True)
            else:
                print(f"      group_norm {str(dt)[6:]} {tag}: cluster {plan['cluster']}, "
                      f"{plan['blocks']} blocks of {plan['smem_bytes']} bytes of shared memory, "
                      f"{plan['rows_per_block']} rows each; the card holds "
                      f"{plan['max_active_clusters']} such clusters at once", flush=True)
            err, ms, plain_ms = compare(
                f"group_norm {str(dt)[6:]} {tag}",
                lambda: fused_group_norm_swish(xd, scale, bias, g, eps, swish),
                lambda: group_norm_swish_plain(xd, scale, bias, g, eps, swish), tol,
                max_differ=differ)
            errs.append(err)
            if dt != f32:  # the per-sample coefficients the FAB core reads
                (yk, ck), (_, cp) = (fn(xd, scale, bias, g, eps, swish, with_coef=True)
                                     for fn in (fused_group_norm_swish, group_norm_swish_plain))
                cerr = (ck - cp).abs().max().item() / cp.abs().max().item()
                _check(torch.equal(yk, fused_group_norm_swish(xd, scale, bias, g, eps, swish))
                       and ck.shape == (b, 2, c) and cerr <= 1e-2,
                       f"group_norm {str(dt)[6:]} {tag} with its coefficients: the same output "
                       f"bitwise; sc and sh [{b}, 2, {c}] within {cerr:.2e} x max|plain| "
                       f"(<= 1e-2, a {str(dt)[6:]} ulp); {(ck != cp).float().mean().item():.2%} "
                       "differ")
            if dt == bf16 and timed:
                # a graph of 20 calls, fewer for slabs of hundreds of MB (each
                # captured call keeps its output)
                n_graph = max(2, min(20, int(4e9 // (2 * _nbytes(xd)))))
                dms = graph_ms(lambda: fused_group_norm_swish(xd, scale, bias, g, eps, swish),
                               calls=n_graph)
                lms = cuda_ms(lambda: _gn_library(xd, scale, bias, g, eps, swish, cast))
                one = Bound().add(8 * xd.numel(), 2 * _nbytes(xd) + _nbytes(scale, bias),
                                  rate=PEAK_F32)
                print(f"      group_norm bf16 {tag}: device {dms:.4f} ms (CUDA graph of "
                      f"{n_graph} calls), events {ms:.4f} ms, library {lms:.4f} ms, bound "
                      f"{one.ms:.4f} ms ({one.result()['bound_by']}); {calls} calls per "
                      f"predict, {train_calls} per train step", flush=True)
                for k, v in (("ms", ms), ("dev", dms), ("plain", plain_ms), ("lib", lms)):
                    train[k] += v * train_calls
                ms_sum += ms * calls
                dev_sum += dms * calls
                plain_sum += plain_ms * calls
                lib_sum += lms * calls
                # x read and y written once; ~8 f32 operations per element
                bound.add(8 * xd.numel(), 2 * _nbytes(xd) + _nbytes(scale, bias), calls, PEAK_F32)

    # the largest site twice: the same bits (statistics added in rank order,
    # or in chunk order in the split plan)
    (b, spatial, c, g, eps, swish) = max(sites, key=lambda k: k[0] * math.prod(k[1]) * k[2])
    for dt in (bf16, f32):
        x = (torch.randn((b,) + spatial + (c,), generator=gen) * 2 + 0.5).to(dev, dt)
        one = torch.ones(c, device=dev)
        y1 = fused_group_norm_swish(x, one, one * 0.1, g, eps, swish)
        y2 = fused_group_norm_swish(x, one, one * 0.1, g, eps, swish)
        torch.cuda.synchronize()
        _check(torch.equal(y1, y2), f"group_norm {str(dt)[6:]} {b}x{'x'.join(map(str, spatial))}"
               f"x{c} G{g}: two runs bitwise identical")
        del x, y1, y2

    # outside the limits: raises naming the limit the C side states, no launch
    limits = [((1, 8, 8, 60), 4, bf16, "C a multiple of 8")] if extras else []
    for (b, h, w, c), g, dt, limit in limits:
        before = _launched("group_norm.fused_group_norm_swish")
        try:
            fused_group_norm_swish(torch.zeros(b, h, w, c, device=dev, dtype=dt),
                                   torch.ones(c, device=dev), torch.zeros(c, device=dev), g)
            msg = "no error"
        except ValueError as e:
            msg = str(e)
        _check(limit in msg and _launched("group_norm.fused_group_norm_swish") == before,
               f"group_norm {str(dt)[6:]} {b}x{h}x{w}x{c} G{g} raises naming '{limit}': {msg}")
    print(f"      group_norm per predict (bf16, {label}): kernel {ms_sum:.4f} ms by CUDA "
          f"events, {dev_sum:.4f} ms device (CUDA graphs), plain {plain_sum:.4f} ms, library "
          f"{lib_sum:.4f} ms, bound {bound.ms:.4f} ms", flush=True)
    print(f"      group_norm per stage-2 train step's forward (bf16, {label}): kernel "
          f"{train['ms']:.4f} ms "
          f"by CUDA events, {train['dev']:.4f} ms device (CUDA graphs), plain "
          f"{train['plain']:.4f} ms, library {train['lib']:.4f} ms", flush=True)
    return {"max_abs_err": max(errs), "ms": ms_sum, "device_ms": dev_sum, "plain_ms": plain_sum,
            **bound.result(), "library_ms": lib_sum}


def cond_gn_sites(model, dev, batch, steps):
    """The conditional propagator's GroupNorm calls in one predict of
    `batch` samples and `steps` steps, as its layers call kernel 3 on the
    card (its conditioning once, then every step): {(dtype, batch, spatial,
    C, groups, eps, swish): calls per predict}."""
    from lns_tpu_torch.ops import norms

    cfg = model.cfg
    with torch.no_grad():
        z = model.encode(torch.zeros(1, cfg.Ly, cfg.Lx, cfg.in_channels, device=dev))
        z = torch.zeros((batch,) + tuple(z.shape[1:]), device=dev, dtype=model.dtype)
        with recording(norms, "fused_group_norm_swish") as once:
            shared = model.conditioning(torch.full((batch,), 0.5, device=dev))
        with recording(norms, "fused_group_norm_swish") as per_step:
            model._step(z, shared)
    sites = _gn_site_counts(once, with_dtype=True)
    for site, n in _gn_site_counts(per_step, with_dtype=True).items():
        sites[site] = sites.get(site, 0) + steps * n
    return sites


def check_cond_group_norm(dev, gen, sites, train_sites, label="conditional propagator",
                          per="predict (path 5)"):
    """Kernel 3 at the conditional propagator's GroupNorm sites (sites:
    {(dtype, batch, spatial, C, groups, eps, swish): calls per predict};
    train_sites: the same per stage-2 train step's forward): GN(1) over the
    latent in bf16 (conv1) and in f32 (cond_conv1 and ffn, which the f32
    FiLM branch promotes), GN(1) over one row per sample in f32 (cond_conv2
    on the embedding's projection) and GN(32) in bf16 (out_proj). Each
    shape in bf16 and in f32 against the plain version at
    ``check_group_norm``'s bounds, with its launch plan, and its gradient
    through ``GroupNormSwishFunction`` (the kernel's forward) bitwise equal
    to plain autograd's for a seeded upstream gradient; timed in the dtype
    the site runs in (CUDA events, device time by graph replays, the library
    call ``F.group_norm``, the bound: bytes at the memory rate or ~8 f32
    operations per element). Returns the kernel's result summed over one
    predict. Other sites (the conditional encoder's, the library blocks')
    are held so too, under their `label`, their calls counted per `per`."""
    from lns_tpu_torch.kernels.group_norm import (fused_group_norm_swish, group_norm_plan,
                                                  group_norm_swish_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    cast = _gn_library_casts(dev)
    per_site = {site: [calls, 0] for site, calls in sites.items()}
    for site, calls in train_sites.items():
        per_site.setdefault(site, [0, 0])[1] = calls
    errs, bound = [], Bound()
    total = dict.fromkeys(("ms", "dev", "plain", "lib"), 0.0)
    train = dict.fromkeys(("ms", "dev", "plain", "lib"), 0.0)
    shapes = {site[1:] for site in per_site}
    for b, spatial, c, g, eps, swish in sorted(shapes):
        x = (torch.randn((b,) + spatial + (c,), generator=gen) * 2 + 0.5).to(dev)
        scale = (torch.randn(c, generator=gen) * 0.1 + 1).to(dev)
        bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
        s = x.numel() // (b * c)
        tag = f"{b}x{'x'.join(map(str, spatial))}x{c} G{g} eps{eps:g}{' +swish' if swish else ''}"
        for dt, tol, differ in ((f32, 1e-5, 1.0), (bf16, 1e-2, 0.02)):
            xd = x.to(dt)
            calls, train_calls = per_site.get((dt, b, spatial, c, g, eps, swish), (0, 0))
            plan = group_norm_plan(dt, b, s, c, g)
            print(f"      group_norm {str(dt)[6:]} {tag} ({label}; {calls} calls "
                  f"per {per}, {train_calls} per train step): "
                  + (f"split plan, {plan['chunks']} chunks" if plan["chunks"] else
                     f"cluster {plan['cluster']}, {plan['blocks']} blocks of "
                     f"{plan['smem_bytes']} bytes of shared memory, {plan['rows_per_block']} rows "
                     f"each; the card holds {plan['max_active_clusters']} such clusters at once"),
                  flush=True)
            err, ms, plain_ms = compare(
                f"group_norm {str(dt)[6:]} {tag} ({label})",
                lambda: fused_group_norm_swish(xd, scale, bias, g, eps, swish),
                lambda: group_norm_swish_plain(xd, scale, bias, g, eps, swish), tol,
                max_differ=differ)
            errs.append(err)
            go = torch.randn(xd.shape, generator=gen).to(dev, dt)
            grads = []
            for fn in (fused_group_norm_swish, group_norm_swish_plain):
                leaves = [t.clone().requires_grad_() for t in (xd, scale, bias)]
                grads.append(torch.autograd.grad(fn(*leaves, g, eps, swish), leaves, go))
            _check(all(torch.equal(a, b_) for a, b_ in zip(*grads)),
                   f"group_norm {str(dt)[6:]} {tag} ({label}): gradients w.r.t. "
                   "x, scale, bias through GroupNormSwishFunction bitwise equal to plain "
                   "autograd's")
            if not (calls or train_calls):
                continue
            dms = graph_ms(lambda: fused_group_norm_swish(xd, scale, bias, g, eps, swish))
            lms = cuda_ms(lambda: _gn_library(xd, scale, bias, g, eps, swish, cast and dt == bf16))
            one = Bound().add(8 * xd.numel(), 2 * _nbytes(xd) + _nbytes(scale, bias),
                              rate=PEAK_F32)
            print(f"      group_norm {str(dt)[6:]} {tag} ({label}): device "
                  f"{dms:.4f} ms (CUDA graph of 20 calls), events {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lms:.4f} ms, bound {one.ms:.4f} ms "
                  f"({one.result()['bound_by']})", flush=True)
            for acc, n in ((total, calls), (train, train_calls)):
                for k, v in (("ms", ms), ("dev", dms), ("plain", plain_ms), ("lib", lms)):
                    acc[k] += v * n
            bound.add(8 * xd.numel(), 2 * _nbytes(xd) + _nbytes(scale, bias), calls, PEAK_F32)
    for what, acc in ((per, total), ("stage-2 train step's forward", train)):
        if acc is train and not train_sites:
            continue
        print(f"      group_norm per {what} at the sites of the {label}: kernel "
              f"{acc['ms']:.4f} ms by CUDA events, {acc['dev']:.4f} ms device (CUDA graphs), "
              f"plain {acc['plain']:.4f} ms, library {acc['lib']:.4f} ms"
              + (f", bound {bound.ms:.4f} ms" if acc is total else ""), flush=True)
    return {"max_abs_err": max(errs), "ms": total["ms"], "device_ms": total["dev"],
            "plain_ms": total["plain"], **bound.result(), "library_ms": total["lib"]}


def _axial_inputs(gen, dev, g_shape, h, w, d):
    """kx [*g_shape, h, h], ky [*g_shape, w, w] (scaled to keep values of
    order 1 through both applies) and phi [*g_shape, h, w, d]."""
    kx = torch.randn(*g_shape, h, h, generator=gen) / h ** 0.5
    ky = torch.randn(*g_shape, w, w, generator=gen) / w ** 0.5
    phi = torch.randn(*g_shape, h, w, d, generator=gen)
    return kx.to(dev), ky.to(dev), phi.to(dev)


# (tolerance x max|plain|, share of elements that may differ). f32: the same
# sums in another order. bf16 / f16: each apply is rounded to T in both
# versions, and an f32 sum in another order can move a value across a
# rounding boundary, which the next apply and the norm carry on: a few ulps
# of the largest value in a few elements per thousand (measured up to 0.54 %
# in f16, the finer type, and 0.01 % in bf16)
_AXIAL_TOL = {torch.float32: (2e-5, 1.0), torch.bfloat16: (2e-2, 0.02),
              torch.float16: (2e-2, 0.02)}


def _axial_library(kx, ky, p, rows_first):
    """The yardstick: the two applies as two cuBLAS calls in p's dtype
    (torch.bmm over the rows, torch.matmul with ky broadcast over the rows
    for the columns); no single PyTorch call computes the function."""
    g, h, w, d = p.shape

    def rows(x):
        return torch.bmm(kx, x.reshape(g, h, w * d)).view(g, h, w, d)

    def cols(x):
        return torch.matmul(ky[:, None], x)

    return cols(rows(p)) if rows_first else rows(cols(p))


def _stats_check(name, y, stats):
    """Kernel 4's statistics output against the f32 sums of its own output
    y (the sums of the same values in another order): within 1e-5 of the
    sums of |y| and of y^2."""
    from lns_tpu_torch.kernels.axial import axial_stats_plain

    ref = axial_stats_plain(y)
    scale = axial_stats_plain(y.abs())[..., 0]
    gap = (stats - ref).abs()
    ok = bool((gap[..., 0] <= 1e-5 * scale).all() and (gap[..., 1] <= 1e-5 * ref[..., 1]).all())
    _check(ok and bool(torch.isfinite(stats).all()),
           f"{name} stats: sums of y and y^2 within 1e-5 x (sum |y|, sum y^2) of its own "
           f"output's; largest gaps {gap[..., 0].max().item():.3e}, {gap[..., 1].max().item():.3e}")


def check_axial(dev, gen, sites, n, d):
    """Kernel 4 at the paths' d-space FAB shapes (sites: {(batch, h, w, c):
    calls per predict}), at the decode chunk's 32x32, at an odd 15x31 and at
    edge cases (sides not multiples of 16, d not a multiple of 8 or 16, a
    plane that takes 8 channels per block), with the norm, without it, and
    with the statistics output; kernel 5 at G = batch x heads 16x16, an odd
    7x15 d 128 and edge cases; bf16, f16 and f32. Prints each launch plan
    and, at the main shapes, each d-tile's device time; two runs bitwise
    equal; shapes outside the limits raise with the C text."""
    from lns_tpu_torch.kernels import axial

    bf16 = torch.bfloat16
    errs4, ms4, dev4, plain4, lib4, bound4 = [], 0.0, 0.0, 0.0, 0.0, Bound()

    def work(g, h, w, dd, p):  # both applies; phi in, out, k_x and k_y in phi's dtype
        return 2 * g * dd * (h * h * w + h * w * w), 2 * _nbytes(p) + g * (h * h + w * w) * 2

    def plan(dt, g, h, w, dd):
        pl = axial.axial_plan(dt, g, h, w, dd)
        return (f"{pl['d_tile']} channels per block, {pl['blocks']} blocks of "
                f"{pl['smem_bytes']} bytes, {pl['blocks_per_sm']} per SM")

    # (batch, heads, h, w, d, calls per predict)
    cases = [(b, n, h, w, d, calls) for (b, h, w, _), calls in sorted(sites.items())] + [
        (CHUNK, n, 32, 32, d, 0), (2, 4, 15, 31, 128, 0), (2, 3, 24, 40, 12, 0),
        (2, 3, 7, 9, 20, 0), (3, 2, 20, 33, 24, 0), (1, 2, 96, 64, 16, 0)]
    for b, nh, h, w, dd, calls in cases:
        kx, ky, phi = _axial_inputs(gen, dev, (b, nh), h, w, dd)
        for dt, (tol, differ) in _AXIAL_TOL.items():
            p = phi.to(dt)
            tag = f"fab_axial_in_fused {str(dt)[6:]} [{b},{nh},{h},{w},{dd}]"
            print(f"      {tag}: launch {plan(dt, b * nh, h, w, dd)}", flush=True)
            for with_in in (True, False):
                err, ms, plain_ms = compare(
                    f"{tag} {'IN' if with_in else 'no IN'}",
                    lambda: axial.fab_axial_in_fused(kx, ky, p, with_in),
                    lambda: axial.fab_axial_in_plain(kx, ky, p, with_in), tol, max_differ=differ)
                errs4.append(err)
                if dt == bf16 and with_in and calls:
                    g = b * nh
                    dms = graph_ms(lambda: axial.fab_axial_in_fused(kx, ky, p))
                    kxd, kyd = kx.view(g, h, h).to(dt), ky.view(g, w, w).to(dt)
                    lms = cuda_ms(lambda: _axial_library(kxd, kyd, p.view(g, h, w, dd), True))
                    print(f"      {tag} IN: device {dms:.4f} ms (CUDA graph of 20 calls), "
                          f"library {lms:.4f} ms (two calls); {calls} call(s) per predict",
                          flush=True)
                    ms4, dev4 = ms4 + ms * calls, dev4 + dms * calls
                    plain4, lib4 = plain4 + plain_ms * calls, lib4 + lms * calls
                    bound4.add(*work(g, h, w, dd, p), calls)
            y, st = axial.fab_axial_in_fused(kx, ky, p, False, stats=True)
            _stats_check(tag, y, st)
            if calls:  # the d-space core's call: heads last, [b, h, w, n, d]
                phl = p.permute(0, 2, 3, 1, 4).contiguous()
                err, _, _ = compare(
                    f"{tag} heads last, stats",
                    lambda: axial.fab_axial_in_fused(kx, ky, phl, False, stats=True,
                                                     heads_last=True)[0],
                    lambda: axial.fab_axial_in_plain(kx, ky, phl, False, heads_last=True), tol,
                    max_differ=differ)
                errs4.append(err)
                y, st = axial.fab_axial_in_fused(kx, ky, phl, False, stats=True, heads_last=True)
                _stats_check(f"{tag} heads last", y.permute(0, 3, 1, 2, 4), st)
    errs5, res5 = [], None
    for g, h, w, dd in ((BATCH * n, 16, 16, d), (16, 7, 15, 128), (6, 20, 33, 24),
                        (4, 9, 17, 12)):
        kx, ky, phi = _axial_inputs(gen, dev, (g,), h, w, dd)
        for dt, (tol, differ) in _AXIAL_TOL.items():
            p = phi.to(dt)
            tag = f"axial_kernel_apply_headmajor {str(dt)[6:]} [{g},{h},{w},{dd}]"
            print(f"      {tag}: launch {plan(dt, g, h, w, dd)}", flush=True)
            err, ms, plain_ms = compare(
                tag, lambda: axial.axial_kernel_apply_headmajor(kx, ky, p),
                lambda: axial.axial_kernel_apply_headmajor_plain(kx, ky, p), tol,
                max_differ=differ)
            errs5.append(err)
            if res5 is None and dt == bf16:
                dms = graph_ms(lambda: axial.axial_kernel_apply_headmajor(kx, ky, p))
                kxd, kyd = kx.to(dt), ky.to(dt)
                lms = cuda_ms(lambda: _axial_library(kxd, kyd, p, False))
                print(f"      {tag}: device {dms:.4f} ms (CUDA graph of 20 calls), library "
                      f"{lms:.4f} ms (two calls)", flush=True)
                res5 = {"ms": ms, "device_ms": dms, "plain_ms": plain_ms,
                        **Bound().add(*work(g, h, w, dd, p)).result(), "library_ms": lms}

    # the d-tile the plan picks, against the others, by device time at the
    # main shapes (rows first with the norm, and columns first)
    for g, h, w, dd in ((BATCH * n, 16, 16, d), (CHUNK * n, 32, 32, d)):
        kx, ky, phi = _axial_inputs(gen, dev, (g,), h, w, dd)
        p = phi.to(bf16)
        times = []
        for tile in (8, 16, 32, 64):
            dims = (g, h, w, dd, dd)
            t4 = graph_ms(lambda: axial.launch("probe", kx, ky, p, dims, True, 1, 1e-5, d_tile=tile))
            t5 = graph_ms(lambda: axial.launch("probe", kx, ky, p, dims, False, 0, 0.0, d_tile=tile))
            times.append(f"{tile}: {t4:.4f} / {t5:.4f}")
        print(f"      axial bf16 [{g},{h},{w},{dd}] device ms by d-tile (kernel 4 IN / kernel 5): "
              f"{', '.join(times)}; the plan takes {axial.axial_plan(bf16, g, h, w, dd)['d_tile']}",
              flush=True)

    # two runs: the same bits (statistics summed in a fixed order)
    kx, ky, phi = _axial_inputs(gen, dev, (BATCH, n), 16, 16, d)
    p = phi.to(bf16)
    runs = [(axial.fab_axial_in_fused(kx, ky, p), axial.fab_axial_in_fused(kx, ky, p, False, stats=True),
             axial.axial_kernel_apply_headmajor(kx.flatten(0, 1), ky.flatten(0, 1), p.flatten(0, 1)))
            for _ in range(2)]
    torch.cuda.synchronize()
    _check(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1][1], runs[1][1][1])
           and torch.equal(runs[0][2], runs[1][2]),
           f"axial bf16 [{BATCH},{n},16,16,{d}]: two runs bitwise identical (IN, stats, kernel 5)")

    # outside the limits: raises naming the limit the C side states, no launch
    for (g, h, w, dd), dt, limit in (((1, 129, 16, 64), bf16, "h, w in [1, 128]"),
                                     ((1, 128, 128, 64), bf16, "shared memory per block"),
                                     ((1, 128, 128, 8), torch.float32, "shared memory per block")):
        before = _launched("axial.axial_kernel_apply_headmajor")
        try:
            axial.axial_kernel_apply_headmajor(torch.zeros(g, h, h, device=dev, dtype=dt),
                                               torch.zeros(g, w, w, device=dev, dtype=dt),
                                               torch.zeros(g, h, w, dd, device=dev, dtype=dt))
            msg = "no error"
        except ValueError as e:
            msg = str(e)
        _check(limit in msg and _launched("axial.axial_kernel_apply_headmajor") == before,
               f"axial {str(dt)[6:]} {h}x{w} d{dd} raises naming '{limit}': {msg}")
    return ({"max_abs_err": max(errs4), "ms": ms4, "device_ms": dev4, "plain_ms": plain4,
             **bound4.result(), "library_ms": lib4}, {"max_abs_err": max(errs5), **res5})


def check_pipeline(dev, gen, n, d):
    """Kernel 6 at the TPU probes' [B, 2, 128, 2048] with B = one decode
    chunk and at ragged shapes, kernel 7 at a decode chunk's head-major
    32x32 value."""
    from lns_tpu_torch.kernels.axial_pipeline import (bmm_blockdiag, bmm_blockdiag_plain,
                                                      transpose_hw, transpose_hw_plain)

    errs6, res6 = [], None
    # the TPU probes' shape (full 128 x 128 tiles, 16-byte copies), ragged
    # tiles with 16-byte copies (M, N multiples of 8), element-wise copies
    # (M, N not), and x off a 16-byte boundary (element-wise too)
    for shape, off in (((CHUNK, 2, 128, 2048), False), ((2, 3, 24, 40), False),
                       ((2, 3, 20, 37), False), ((2, 3, 24, 40), True)):
        b, g, m, nn = shape
        kb = (torch.randn(b, g, m, m, generator=gen) / m ** 0.5).to(dev)
        x = torch.randn(*shape, generator=gen).to(dev)
        # f32: m-term sums in another order; bf16: both sum in f32 and round
        # once, so at most about one bf16 ulp apart
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            xd = _off_16(x.to(dt)) if off else x.to(dt)
            err, ms, plain_ms = compare(
                f"bmm_blockdiag {str(dt)[6:]} [{b},{g},{m},{nn}]"
                + (" (x off a 16-byte boundary)" if off else ""),
                lambda: bmm_blockdiag(kb, xd), lambda: bmm_blockdiag_plain(kb, xd), tol)
            errs6.append(err)
            if res6 is None and dt == torch.bfloat16:
                # the library call: one bf16 torch.matmul (the plain version
                # upcasts to f32)
                kbd = kb.to(dt)
                res6 = {"ms": ms, "plain_ms": plain_ms,
                        **Bound().add(2 * b * g * m * m * nn, _nbytes(kbd, xd, xd)).result(),
                        "library_ms": cuda_ms(lambda: torch.matmul(kbd, xd))}
                print(f"      bmm_blockdiag bf16 [{b},{g},{m},{nn}]: torch.matmul "
                      f"{res6['library_ms']:.4f} ms", flush=True)
    del kb, x
    y = torch.randn(CHUNK, n, 32, 32, d, generator=gen).to(dev)
    errs7, res7 = [], None
    for dt in (torch.float32, torch.bfloat16):  # data movement: exactly equal
        yd = y.to(dt)
        err, ms, plain_ms = compare(f"transpose_hw {str(dt)[6:]} [{CHUNK},{n},32,32,{d}]",
                                    lambda: transpose_hw(yd), lambda: transpose_hw_plain(yd), 0.0)
        errs7.append(err)
        if dt == torch.bfloat16:  # the library call is the plain version itself
            res7 = {"ms": ms, "plain_ms": plain_ms, **Bound().add(0, 2 * _nbytes(yd)).result(),
                    "library_ms": cuda_ms(lambda: yd.transpose(2, 3).contiguous())}
    return ({"max_abs_err": max(errs6), **res6}, {"max_abs_err": max(errs7), **res7})


def _fab_inputs(gen, dev, b, h, w, c, n, d, dt):
    u = torch.randn(b, h, w, c, generator=gen).to(dev, dt)
    kx = (torch.randn(b, n, h, h, generator=gen) / h).to(dev, dt)
    ky = (torch.randn(b, n, w, w, generator=gen) / w).to(dev, dt)
    w_in = (torch.randn(c, n, d, generator=gen) / c ** 0.5).to(dev)
    w_o1 = (torch.randn(n, d, c, generator=gen) / d ** 0.5).to(dev)
    return u, kx, ky, w_in, w_o1


def check_activations(dev, gen):
    """GELU, swish and the SABlock's softmax in bf16 on the card against the
    same functions on the CPU, where the tests pin them bitwise to the JAX
    package: the card's erfc, exp and sums may differ from the CPU's by an
    f32 ulp, which moves a bf16 rounding now and then (bound 1 % of the
    elements; the share is printed)."""
    from lns_tpu_torch.ops.activations import gelu, swish
    from lns_tpu_torch.ops.attention import softmax_last

    x = (torch.randn(200_000, generator=gen) * 3).to(torch.bfloat16)
    a = torch.randn(8, 4, 64, 64, generator=gen).mul(4).to(torch.bfloat16)
    for name, fn, t in (("gelu", gelu, x), ("swish", swish, x),
                        ("softmax (SABlock, dim_head 64)", lambda v: softmax_last(v, 64 ** -0.5), a)):
        card, cpu = fn(t.to(dev)).cpu(), fn(t)
        differ = (card != cpu).float().mean().item()
        err = (card.float() - cpu.float()).abs().max().item()
        _check(differ <= 0.01, f"{name} bf16 on the card vs the CPU: {differ:.4%} of "
               f"{t.numel()} elements differ (<= 1 %), max_abs_err {err:.3e}")


def check_fab_cores(dev, gen, shapes, n, d):
    """The d-space core's kernel path against its plain version at the
    paths' d-space shapes, then both cores' kernel paths (and plain
    versions) timed at every FAB shape of the paths, bf16."""
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core
    from lns_tpu_torch.ops.factorized_attention import (_fab_impl_for, fab_dspace_core,
                                                        fab_dspace_core_plain)

    for b, h, w, c in shapes:
        if _fab_impl_for(c, d) != "batched":
            continue
        # f32: sums in another order; bf16: both round phi, both applies,
        # wp = inv W and the bias where _batched_core does and take the
        # statistics from the rounded x, so they differ where an f32 sum in
        # another order crosses a rounding boundary (kernel 2's bound)
        for dt, tol, differ in ((torch.float32, 1e-4, 1.0), (torch.bfloat16, 1e-2, 0.02)):
            a = _fab_inputs(gen, dev, b, h, w, c, n, d, dt)
            compare(f"fab_dspace_core {str(dt)[6:]} b{b} {h}x{w} c{c} n{n} d{d}",
                    lambda: fab_dspace_core(*a), lambda: fab_dspace_core_plain(*a), tol,
                    max_differ=differ)
    print("      both FAB cores, bf16, ms (CUDA events): c-space kernel / plain, "
          "d-space kernel path / plain", flush=True)
    for b, h, w, c in shapes:
        a = _fab_inputs(gen, dev, b, h, w, c, n, d, torch.bfloat16)
        t = [cuda_ms(lambda: f(*a)) for f in (fab_fused_core, fab_core_plain, fab_dspace_core,
                                               fab_dspace_core_plain)]
        print(f"      FAB b{b} {h}x{w} c{c} (rule: {_fab_impl_for(c, d)}): c-space {t[0]:.4f} / "
              f"{t[1]:.4f}, d-space {t[2]:.4f} / {t[3]:.4f}", flush=True)


# -- the model's kernel call sites and expected launch counts ---------------

def call_sites(model, dev, batch=BATCH, steps=STEPS, chunk=CHUNK):
    """Every GroupNorm and FAB-block call of one encode (batch `batch`) and
    of the decode of `batch` x `steps` frames in chunks of `chunk` (all at
    once when None), found with forward hooks on a one-frame run of the
    plain path. Returns ({(batch, spatial, C, groups, eps, swish): calls per
    predict}, {(part, batch, h, w, c, formulation): calls per predict})."""
    from lns_tpu_torch.ops.factorized_attention import FABlock2D
    from lns_tpu_torch.ops.norms import GroupNorm

    chunk = chunk or batch * steps
    n_chunks = -(-batch * steps // chunk)
    seen, hooks = [], []
    for name, m in model.named_modules():
        if not name.startswith(model.ae_name + ".") or not isinstance(m, (GroupNorm, FABlock2D)):
            continue
        part = name.split(".")[1]

        def hook(mod, args, kwargs, out, part=part):
            _, c, *spatial = args[0].shape
            if isinstance(mod, FABlock2D):
                seen.append((part, "fab", (*spatial, c, mod.impl)))
            else:  # GroupNormWrapper passes apply_swish by position
                swish = kwargs.get("apply_swish", args[1] if len(args) > 1 else False)
                seen.append((part, "gn", (tuple(spatial), mod.weight.numel(), mod.num_groups,
                                          mod.eps, bool(swish))))
        hooks.append(m.register_forward_hook(hook, with_kwargs=True))
    cfg = model.cfg
    model.use_kernels(False)
    with torch.no_grad():
        model.decode(model.encode(torch.zeros(1, cfg.Ly, cfg.Lx, cfg.in_channels, device=dev)))
    model.use_kernels(True)
    for h in hooks:
        h.remove()
    gn, fab = {}, {}
    for part, what, key in seen:
        b, calls = (batch, 1) if part == "encoder" else (chunk, n_chunks)
        site = (b,) + key if what == "gn" else (part, b) + key
        sites = gn if what == "gn" else fab
        sites[site] = sites.get(site, 0) + calls
    return gn, fab


def _map_tuple(fn, t):
    """fn over a tuple's items, keeping a named tuple's type."""
    items = [fn(a) for a in t]
    return type(t)(*items) if hasattr(t, "_fields") else tuple(items)


@contextlib.contextmanager
def recording(module, name):
    """Every call of ``module.<name>`` (a kernel's wrapper, by the name a
    layer calls it) while open, in a list: its arguments, tensors detached
    and copied (in tuples too), and its keyword arguments as a last dict
    where it had any.
    The calls go on to the wrapper, which counts its launches."""
    real, calls = getattr(module, name), []

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        return _map_tuple(copy, a) if isinstance(a, tuple) else a

    def record(*args, **kwargs):
        calls.append(copy(args) + (({k: copy(v) for k, v in kwargs.items()},) if kwargs else ()))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def train_gn_sites(model, dev):
    """Every GroupNorm call of one stage-2 train step's forward
    (``rollout_loss`` at batch S2_BATCH, ``out_tw`` propagator steps; a
    conditional model with a parameter per sample), as the layers call
    kernel 3 on the card: {(batch, spatial, C, groups, eps, swish): calls
    per train step}; with the dtype in front of each key
    (``with_dtype``) for the conditional propagator, whose sites run in
    bf16 and in f32."""
    from lns_tpu_torch.ops import norms

    cfg = model.cfg
    with torch.no_grad():
        z = model.encode(torch.zeros(1, cfg.Ly, cfg.Lx, cfg.in_channels, device=dev))
        z_in = torch.zeros((S2_BATCH, 1) + tuple(z.shape[1:]), device=dev)
        z_out = torch.zeros((S2_BATCH, cfg.out_tw) + tuple(z.shape[1:]), device=dev)
        cond = torch.full((S2_BATCH,), 0.5, device=dev) if model.conditional else None
        with recording(norms, "fused_group_norm_swish") as calls:
            model.rollout_loss(z_in, z_out, cond)
    return _gn_site_counts(calls, with_dtype=model.conditional)


def _gn_site_counts(calls, with_dtype=False):
    """Recorded kernel-3 calls -> {(batch, spatial, C, groups, eps, swish):
    calls}, keyed also by the input's dtype in front `with_dtype`."""
    sites = {}
    for x, scale, _, g, eps, swish, *_ in calls:
        site = (x.shape[0], tuple(x.shape[1:-1]), x.shape[-1], g, eps, bool(swish))
        site = (x.dtype,) + site if with_dtype else site
        sites[site] = sites.get(site, 0) + 1
    return sites


def train_step_gn(cfg):
    """Kernel-3 launches in one stage-2 train step's forward: the
    SimpleCNN's GN(1) twice per block and out_proj's GN(32) per step; the
    conditional propagator's GN(1) three times per block (conv1,
    cond_conv1, ffn) and GN(32) per step, and cond_conv2's GN(1) once per
    block for the whole rollout (the conditioning is computed once)."""
    nb, t = cfg.prop_n_block, cfg.out_tw
    return (3 * nb + 1) * t + nb if cfg.is_conditional else (2 * nb + 1) * t


def expected_launches(cfg, n_chunks=None, encodes=1, steps=None):
    """Launches per predict that the layer specs imply: the rollout once
    (kernel 1; a conditional propagator in a bf16 predict on the card,
    ``cfg.mixed_precision``, runs kernel 1's FiLM plan once,
    ``prop_rollout_film``, after its conditioning's GroupNorms; in f32 it
    steps as modules, whose
    GroupNorms launch kernel 3 ``train_step_gn``'s way over `steps` steps;
    the autoencoder's counts alone when `steps` is None);
    per FAB block, once per encode or decode chunk, the FAB core (c-space)
    or the axial kernel (d-space), as ``_fab_impl_for`` picks from the
    block's dim and dim_head; the GroupNorm kernel once per GN site (two per
    ResidualBlock, one per GN layer and per FAB ``in_norm``; none in a
    ``FourierBasicBlock``, whose FFTs are cuFFT's) per encode or decode
    chunk. `n_chunks` decode chunks (those of the main paths' predict
    when None) and `encodes` encoder calls; a ResidualBlock and a
    HalfPeriodicResBlock2d alike; with ``n_chunks=0`` (an encode
    pass alone) the rollout is not counted."""
    from lns_tpu_torch.models.specs import decoder_spec, encoder_spec
    from lns_tpu_torch.ops.factorized_attention import _fab_impl_for

    if n_chunks is None:
        n_chunks = -(-BATCH * STEPS // CHUNK)
    parts = ((encoder_spec(cfg), encodes), (decoder_spec(cfg), n_chunks))

    def count(per_spec):
        return sum(calls * sum(per_spec(s) for s in specs) for specs, calls in parts)

    def fabs(impl):
        return count(lambda s: s.kind == "fablock"
                     and _fab_impl_for(s.kw["dim"], s.kw["dim_head"]) == impl)

    out = {"prop_rollout": int(n_chunks > 0), "fab_core": fabs("batchedgram"),
           "fab_axial_in_fused": fabs("batched"),
           "group_norm": count(lambda s: {"resblock": 2, "hp_resblock": 2, "gn": 1,
                                          "fablock": 1, "fourier": 0}.get(s.kind, 0))}
    if cfg.is_conditional:
        out["prop_rollout"] = 0
        if n_chunks > 0 and steps is not None and cfg.mixed_precision:
            out["prop_rollout_film"] = 1
            out["group_norm"] += cfg.prop_n_block  # cond_conv2's GN(1), once per predict
        elif n_chunks > 0 and steps is not None:
            out["group_norm"] += train_step_gn(cfg.replace(out_tw=steps))
    return out


# -- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lns_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    msgs = _build.build(ptxas_verbose="-v" in sys.argv)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {_build.library_path().name})")
    if msgs:
        print(msgs.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--ranks" in sys.argv:  # the multi-rank runs alone
        drive_ranks(dev, smi)
        return 1 if _FAILS else 0
    check_tensor_cores()

    kernels = run(dev, smi)
    print(json.dumps({"kernels": kernels}))
    if _FAILS:
        print(f"chip_smoke: {len(_FAILS)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _counted():
    """Every kernel wrapper's key in the counter registry
    (``utils.profiling``: ``<module>.<wrapper>``) by the name the kernels
    JSON line gives it."""
    return {"prop_rollout": "prop_rollout.fused_rollout",
            "prop_rollout_film": "prop_rollout.fused_cond_rollout",
            "fab_core": "fab_core.fab_fused_core",
            "group_norm": "group_norm.fused_group_norm_swish",
            "fab_axial_in_fused": "axial.fab_axial_in_fused",
            "axial_kernel_apply_headmajor": "axial.axial_kernel_apply_headmajor",
            "bmm_blockdiag": "axial_pipeline.bmm_blockdiag",
            "transpose_hw": "axial_pipeline.transpose_hw",
            "blocked_copy": "blocked_copy.blocked_copy",
            "fab_mega_stats": "fab_mega.fab_mega_stats",
            "fab_mega_apply": "fab_mega.fab_mega_apply", "interior_dot": "fab_mega.interior_dot",
            "dot_general": "mosaic_dots.dot_general", "dot_chain": "mosaic_dots.dot_chain"}


def _launched(key: str) -> int:
    """The launches of the wrapper `key` so far (the counter registry)."""
    from lns_tpu_torch.utils import profiling

    return profiling.counters().get(f"{key}.launches", 0)


def _launches(counted: dict, since: dict = None) -> dict:
    """The launches of each wrapper of `counted` (``_counted()``) so far, or
    since the counts `since` (an earlier call's result)."""
    now = {k: _launched(key) for k, key in counted.items()}
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def drive_path(label, model, expect, gen, dev, batch=BATCH, steps=STEPS, chunk=CHUNK):
    """One path (batch `batch`, `steps` steps, decode chunks of `chunk`
    frames, or all at once when None; a conditional model with a parameter
    per sample from `gen` in [0, 1]): the launch counts of one predict, the
    f32 kernel-vs-plain check, frames/s of both paths and the peak device
    memory of one predict; a conditional model's steps too
    (``check_cond_steps``). Returns the launch counts."""
    from lns_tpu_torch.models import LatentDynamics

    cfg = model.cfg
    print(f"-- {label}: predict, batch {batch}, {steps} steps, decode chunk "
          f"{chunk or 'none (all frames at once)'}, bf16", flush=True)
    x = torch.randn(batch, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
    cond = torch.rand(batch, generator=gen).to(dev) if model.conditional else None
    counted = _counted()
    base = _launches(counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = model.predict(x, steps, cond, decode_chunk=chunk)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = _launches(counted, base)
    print(f"      {label}: peak device memory of one predict {peak / 2**30:.3f} GiB "
          "(torch.cuda.max_memory_allocated, the model included)", flush=True)
    _check(tuple(y.shape) == (batch, steps, cfg.Ly, cfg.Lx, cfg.in_channels),
           f"{label}: output shape {tuple(y.shape)}")
    _check(bool(torch.isfinite(y).all()), f"{label}: output finite")
    for k, n in launches.items():
        want = expect.get(k, 0)  # the library kernels (5-7) run on no path
        _check(n == want and (n > 0) == (k in expect), f"{label}: {k} launches {n} == {want}")

    # the kernel path against the all-plain path, f32, small input; the
    # JAX package holds its own predict to 3e-4 (tests/test_torch_export.py)
    m32 = LatentDynamics(cfg, device=dev)
    m32.load_state_dict(model.state_dict())
    xs, cs = x[:2].float(), None if cond is None else cond[:2]
    yk = m32.use_kernels(True).predict(xs, 4, cs, decode_chunk=chunk)
    yp = m32.use_kernels(False).predict(xs, 4, cs, decode_chunk=chunk)
    err = (yk - yp).abs().max().item()
    _check(bool(torch.isfinite(yk).all()) and err <= 3e-4,
           f"{label}: f32 predict B2 4 steps, kernels vs plain: max_abs_err {err:.3e} <= 3e-4")
    del m32, yk, yp
    if cond is not None:
        check_cond_steps(label, model, x, cond, steps)

    # frames/s: each predict timed alone by CUDA events (it ends on the host
    # with a synchronize), paths alternated plain, kernel, kernel, plain; the
    # host's enqueue time of the same predict: a host clock around predict
    # (which synchronizes nowhere), read before the synchronize
    frames = batch * steps
    times, enqueue = {True: [], False: []}, {True: [], False: []}
    for flag in (False, True):
        model.use_kernels(flag)
        model.predict(x, steps, cond, decode_chunk=chunk)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the kernel path's predict waits for the card nowhere
    try:
        model.predict(x, steps, cond, decode_chunk=chunk)
        sync = "none"
    except RuntimeError as e:
        sync = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _check(sync == "none", f"{label}: one predict on the kernel path under "
           f"torch.cuda.set_sync_debug_mode('error'): synchronizing calls: {sync}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for flag in (False, True, True, False):
        model.use_kernels(flag)
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            model.predict(x, steps, cond, decode_chunk=chunk)
            end.record()
            enqueue[flag].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[flag].append(start.elapsed_time(end))
    model.use_kernels(True)
    for flag, path in ((True, "kernel path"), (False, "plain path")):
        t, e = sorted(times[flag]), sorted(enqueue[flag])
        med = t[len(t) // 2]
        print(f"      {label} predict {path}: median {med:.2f} ms (min {t[0]:.2f}, "
              f"max {t[-1]:.2f}, n={len(t)}), {frames / med * 1e3:.1f} frames/s; host enqueue "
              f"median {e[len(e) // 2]:.2f} ms (min {e[0]:.2f}, max {e[-1]:.2f})", flush=True)
    for flag, path in ((True, "kernel path"), (False, "plain path")):
        model.use_kernels(flag)
        profile_device(lambda: model.predict(x, steps, cond, decode_chunk=chunk),
                       f"{label} {path}")
    model.use_kernels(True)
    return launches


def _open_gates(model, gen):
    """Fill the zero-initialised gates (``cond_conv1.2``, ``cond_conv2.3``)
    from `gen` as ``init_weights_`` fills a conv: at zero they make each
    block's gated conv and FiLM scale vanish, and no check would see the
    conditioning."""
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "zero_init", False):
                bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
    return model


def check_cond_steps(label, model, x, cond, steps):
    """A conditional model's bf16 rollout on the kernel path (kernel 1's
    FiLM plan where the card takes its shape), each step against one plain step
    (``use_kernels(False)``) from the kernel path's own carry, within 2e-2 x
    max|plain| (the bf16 bound of kernel 1's per-step check: an f32 sum in
    another order moves a GroupNorm's rounded coefficients and whole
    channels by an ulp); and every parameter moved by 0.5 (mod 1) gives
    another prediction."""
    with torch.no_grad():
        z0 = model.encode(x).to(model.dtype)
        zs = model.predict_latents(x, steps, cond)
        shared = model.conditioning(cond)
        model.use_kernels(False)
        worst, differ = (0, 0.0), 0.0
        for t in range(steps):
            carry = z0 if t == 0 else zs[:, t - 1]
            ref = model._step(carry, shared)
            e = (zs[:, t].float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            worst = max(worst, (t, e), key=lambda w: w[1])
            differ = max(differ, (zs[:, t] != ref).float().mean().item())
        model.use_kernels(True)
        _check(bool(torch.isfinite(zs).all()) and worst[1] <= 2e-2,
               f"{label}: every bf16 step of the kernel path against one plain step from its "
               f"own carry ({steps} steps): max_abs_err <= {worst[1]:.2e} x max|plain| (<= "
               f"2e-2; step {worst[0]}); at most {differ:.2%} of a step's elements differ")
        other = model.predict(x, steps, (cond + 0.5) % 1.0)
        same = model.predict(x, steps, cond)
        gap = (other.float() - same.float()).abs().max().item()
        _check(gap > 1e-2 * same.float().abs().max().item(),
               f"{label}: every parameter moved by 0.5 (mod 1) moves the prediction by "
               f"{gap:.3e} (> 1e-2 x max|y|): the conditioning is live")


def _device_rows(prof):
    """A profile's device-side entries as (ms, calls, name): an operator's
    entry, or a user annotation's (the optimizer's step), repeats its
    kernels' time, so only the kernels and copies are kept."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if (ev.device_type == DeviceType.CUDA and us > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((us / 1e3, ev.count, ev.key))
    return rows


def profile_device(fn, label, top=8):
    """fn() (one predict, or a few train steps, after the timed ones) under
    torch.profiler: its wall time by CUDA events, the device's busy time
    (every kernel and copy) and idle share, the kernels that take the most
    device time, and the FFTs' device time and share where there are any.
    Returns {wall_ms, busy_ms, fft_ms}."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    rows = _device_rows(prof)
    busy, ops = sum(r[0] for r in rows), sum(r[1] for r in rows)
    print(f"      profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{max(0.0, 1 - busy / wall):.1%}, {ops} device ops", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"        {ms:9.3f} ms {count:6d}x  {key[:90]}")
    for label_k, parts in (("kernel 2 (fab_*)", ("fab_",)),
                           ("kernel 2's mean pass (fab_block_mean_bf16)", ("fab_block_mean",)),
                           ("kernel 2's statistics pass (fab_bb_stats_bf16)", ("fab_bb_stats",)),
                           ("kernel 2's moments pass (fab_moments_bf16)", ("fab_moments",)),
                           ("kernel 2's output pass (fab_out_bf16)", ("fab_out_bf16",)),
                           ("kernel 2 in f32 (fab_stats_f32, fab_apply_f32)",
                            ("fab_stats_f32", "fab_apply_f32")),
                           ("kernel 3 (gn_kernel; split plan gn_partials, gn_apply)",
                            ("::gn_kernel<", "::gn_partials<", "::gn_apply<")),
                           ("kernel 4 (axial_tc)", ("axial_tc",))):
        found = [r for r in rows if any(p in r[2] for p in parts)]
        if found:
            print(f"        {label_k}: {sum(r[0] for r in found):.3f} ms of device time in "
                  f"{sum(r[1] for r in found)} calls", flush=True)
    fft = [r for r in rows if "fft" in r[2].lower()]
    if fft:  # the spectral layers' transforms (cuFFT, and torch.fft's own kernels)
        fft_ms = sum(r[0] for r in fft)
        print(f"        FFT (kernels named *fft*: cuFFT and torch.fft's): {fft_ms:.3f} ms of "
              f"device time in {sum(r[1] for r in fft)} calls, {fft_ms / busy:.1%} of the "
              "device's busy time", flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "fft_ms": sum(r[0] for r in fft)}


# -- phase 5: stage-2 training ------------------------------------------------

# the stage-2 corpus: synthetic 64x64 cases of 30 frames; 64 cases split
# into 57 training cases (27 windows each: 48 steps of batch 32 per epoch)
# and 7 validation cases (a 29-step rollout each)
S2_CASES, S2_CASE_LEN, S2_EPOCHS, S2_BATCH = 64, 30, 2, 32


def _refusal_calls(dev):
    """Each kernel that refuses a gradient (kernels 1 and 5-7, and kernel 4
    with its norm), by its JSON name, called on small tensors on the card
    that require grad."""
    from lns_tpu_torch.kernels import axial, axial_pipeline, prop_rollout

    def t(*shape):
        return torch.ones(shape, device=dev, requires_grad=True)

    packed = prop_rollout.PackedSimpleCNN(
        t(16, 128), t(128), t(3, 2, 128), t(3, 2, 128), t(3, 3, 3, 3, 128, 128), t(3, 3, 128),
        t(3, 2, 128, 128), t(128), t(128), t(128, 16), t(16))
    return {
        "prop_rollout": lambda: prop_rollout.fused_rollout(t(2, 8, 8, 16), packed, 1, 3, 2,
                                                           "circular"),
        "fab_axial_in_fused": lambda: axial.fab_axial_in_fused(t(1, 8, 16, 16), t(1, 8, 16, 16),
                                                               t(1, 8, 16, 16, 64)),
        "axial_kernel_apply_headmajor": lambda: axial.axial_kernel_apply_headmajor(
            t(8, 16, 16), t(8, 16, 16), t(8, 16, 16, 64)),
        "bmm_blockdiag": lambda: axial_pipeline.bmm_blockdiag(t(1, 2, 128, 128),
                                                              t(1, 2, 128, 256)),
        "transpose_hw": lambda: axial_pipeline.transpose_hw(t(1, 8, 32, 32, 64)),
    }


def check_gn_calls(where, calls, gen=None):
    """Kernel 3 on the inputs its call sites really received (`calls`, from
    ``recording``), each call against the plain version at
    ``check_group_norm``'s bounds: bf16 within 1e-2 x max|plain| with at most
    2 % of the elements differing, f32 within 1e-5 x max|plain|. With `gen`,
    also the gradient through ``GroupNormSwishFunction`` (the kernel's
    forward, the plain version's backward) for a seeded upstream gradient,
    against plain autograd's: bitwise equal, since the backward recomputes
    the plain version from the same inputs."""
    from lns_tpu_torch.kernels.group_norm import fused_group_norm_swish, group_norm_swish_plain

    for i, (x, scale, bias, g, eps, swish, *_) in enumerate(calls):
        args = (g, eps, bool(swish))
        with torch.no_grad():
            yk = fused_group_norm_swish(x, scale, bias, *args).float()
            yp = group_norm_swish_plain(x, scale, bias, *args).float()
        bf16 = x.dtype == torch.bfloat16
        tol = 1e-2 if bf16 else 1e-5
        ratio = (yk - yp).abs().max().item() / max(yp.abs().max().item(), 1e-30)
        differ = (yk != yp).float().mean().item()
        msg = (f"{where}, call {i} ({str(x.dtype)[6:]} {'x'.join(map(str, x.shape))} G{g} "
               f"eps{eps:g}{' +swish' if swish else ''}), kernel 3 vs plain on its own input: "
               f"max_abs_err {ratio:.2e} x max|plain| (<= {tol:.0e}); {differ:.2%} of elements "
               f"differ{' (<= 2 %)' if bf16 else ''}")
        ok = bool(torch.isfinite(yk).all()) and ratio <= tol and (differ <= 0.02 or not bf16)
        if gen is not None:
            go = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
            grads = []
            for fn in (fused_group_norm_swish, group_norm_swish_plain):
                leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
                y = fn(*leaves, *args)
                grads.append(torch.autograd.grad(y, leaves, go))
            same = all(torch.equal(a, b) for a, b in zip(*grads))
            ok = ok and same
            msg += f"; gradients w.r.t. x, scale, bias bitwise equal to plain autograd's: {same}"
        _check(ok, msg)


def _step_grads(model, z_in, z_out, use_kernel, cond=None):
    """One train step's gradients w.r.t. every propagator parameter, and
    kernel 3's launches in its forward and in its backward."""
    key = "group_norm.fused_group_norm_swish"
    model.use_kernels(use_kernel)
    params = dict(model.propagator.named_parameters())
    before = _launched(key)
    loss = model.rollout_loss(z_in, z_out, cond)
    fwd = _launched(key) - before
    grads = torch.autograd.grad(loss, list(params.values()))
    model.use_kernels(True)
    return dict(zip(params, grads)), fwd, _launched(key) - before - fwd


def check_stage2_gradients(trainer, m32, dev):
    """One train step's gradients w.r.t. every propagator parameter, kernel
    path against ``use_kernels(False)`` (TF32 off), on a batch of the
    corpus: f32 within 1e-4 x max|g| per tensor (sums in another order);
    bf16 cosine similarity >= 0.999 per tensor (the forwards differ by
    bf16 roundings, the backward is the same plain recompute); every
    GroupNorm scale and shift with a nonzero gradient; kernel 3 launched
    7 x out_tw times in the forward (GN(1) twice in each of 3 blocks, and
    out_proj's GN(32), per step) and never in the backward. Each of those
    launches is also held to the plain version on its own input, with its
    gradient (``check_gn_calls``)."""
    from lns_tpu_torch.ops import norms

    cfg = trainer.cfg
    z_in, z_out = _s2_batch(trainer, dev)
    per_step = 2 * cfg.prop_n_block + 1
    gen = torch.Generator().manual_seed(2)
    for label, model in (("f32", m32), ("bf16", trainer.model)):
        with recording(norms, "fused_group_norm_swish") as calls, torch.no_grad():
            model.rollout_loss(z_in, z_out)
        _check(len(calls) == per_step * cfg.out_tw,
               f"stage-2 {label} train step: {len(calls)} GroupNorm calls in the forward")
        check_gn_calls(f"stage-2 {label} train step", calls, gen)
        del calls
        gk, fwd, bwd = _step_grads(model, z_in, z_out, True)
        gp, fwd_p, _ = _step_grads(model, z_in, z_out, False)
        worst = (None, 0.0) if label == "f32" else (None, 1.0)
        for k, g in gk.items():
            ref = gp[k].float()
            if label == "f32":
                r = (g - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                worst = max(worst, (k, r), key=lambda w: w[1])
            else:
                c = torch.nn.functional.cosine_similarity(g.flatten().float(), ref.flatten(),
                                                          dim=0).item()
                worst = min(worst, (k, c), key=lambda w: w[1])
        ok = worst[1] <= 1e-4 if label == "f32" else worst[1] >= 0.999
        _check(ok and all(bool(torch.isfinite(g).all()) for g in gk.values()),
               f"stage-2 {label} train-step gradients, kernel path vs plain, {len(gk)} tensors: "
               + (f"max_abs_err <= {worst[1]:.2e} x max|g| (<= 1e-4)" if label == "f32" else
                  f"cosine similarity >= {worst[1]:.6f} (>= 0.999)") + f", worst {worst[0]}")
        gn = {k: g for k, g in gk.items() if ".conv.0." in k or ".ffn.0." in k or ".gn." in k}
        _check(len(gn) == 2 * per_step and all(g.abs().max().item() > 0 for g in gn.values()),
               f"stage-2 {label}: all {len(gn)} GroupNorm scales and shifts have a nonzero "
               f"gradient (smallest max|g| {min(g.abs().max().item() for g in gn.values()):.3e})")
        _check(fwd == per_step * cfg.out_tw and bwd == 0 and fwd_p == 0,
               f"stage-2 {label}: kernel 3 launched {fwd} times in the forward of a train step "
               f"(== {per_step} x out_tw {cfg.out_tw}), {bwd} in its backward, {fwd_p} on the "
               f"plain path")


def _s2_batch(trainer, dev):
    """The first S2_BATCH windows of the corpus, on the card."""
    import numpy as np

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in trainer.train_ds.get_batch(np.arange(S2_BATCH)))


def check_stage2_corpus(trainer, m32, dev):
    """The encode pre-pass's latent corpus (kernel 3 at every encoder GN
    site) against an all-plain encode of the same frames, in bf16 (the
    trainer's) and f32 (`m32`, the same weights). f32: within 1e-4 x
    max|plain| (sums in another order). bf16: within 2e-2 x max|plain| with
    at most 2 % of the elements differing: kernel 3 matches the plain
    version bitwise on most inputs, but an f32 sum in another order can move
    one (sample, channel)'s scale or shift by an ulp, and the encoder's
    later layers carry that on through the whole frame (one kernel call
    alone is held to 1e-2; kernel 1's 2e-2 bounds one composed propagator
    step alike). So the frames that differ are counted, and each GroupNorm
    call of the first encode call that holds one is held to 1e-2 on its own
    input (``check_gn_calls``). Returns the seconds of the bf16 pre-pass run
    again, timed by the host clock (it ends in the copy to the host)."""
    import numpy as np

    from lns_tpu_torch.ops import norms

    ds = trainer.train_ds
    corpus = ds.encoded
    for label, model, tol in (("bf16", trainer.model, 2e-2), ("f32", m32, 1e-4)):
        t0 = time.perf_counter()
        ds.encode_dataset(model.encode, dev)
        if label == "bf16":
            secs = time.perf_counter() - t0
        kern = ds.encoded
        model.use_kernels(False)
        ds.encode_dataset(model.encode, dev)
        plain = ds.encoded
        model.use_kernels(True)
        err, scale = float(np.abs(kern - plain).max()), float(np.abs(plain).max())
        differ = float((kern != plain).mean())
        ok = bool(np.isfinite(kern).all()) and err <= tol * scale
        if label == "bf16":
            ok = ok and differ <= 0.02 and np.array_equal(kern, corpus)
            # (case, t) of each frame that differs, as an index into the
            # frames the pre-pass encodes 64 at a time
            case, t = np.nonzero((kern != plain).reshape(*kern.shape[:2], -1).any(-1))
            frames = case * ds.case_len + t * ds.interval
        _check(ok, f"stage-2 latent corpus {tuple(kern.shape)} {label}, kernel path vs an "
               f"all-plain encode: max_abs_err {err:.3e} <= {tol:.0e} x max|plain| "
               f"({tol * scale:.3e}); {differ:.2%} of elements differ"
               + (f" (<= 2 %), in {len(frames)} of {kern.shape[0] * kern.shape[1]} frames and "
                  f"{len(set(frames // 64))} of {-(-ds.n_cases * ds.case_len // 64)} encode "
                  "calls; the pre-pass run again: bitwise equal" if label == "bf16" else ""))
    ds.encoded = corpus

    call = int(frames[0] // 64) if len(frames) else 0
    x = ds.normalize(np.moveaxis(ds.data, -1, 0))[..., None].astype(np.float32)
    x = x.reshape(-1, *x.shape[2:])[call * 64: call * 64 + 64]
    x = np.concatenate([x, np.repeat(x[-1:], 64 - len(x), axis=0)])  # padded as the pre-pass does
    with recording(norms, "fused_group_norm_swish") as calls, torch.no_grad():
        trainer.model.encode(torch.from_numpy(x).to(dev))
    check_gn_calls(f"stage-2 pre-pass bf16 encode call {call}"
                   + (" (the first whose frames differ)" if len(frames) else ""), calls)
    return secs


def _parity(where, kern, plain, ref, more=""):
    """One kernel call on the inputs its call site really received, held to
    accuracy parity with its plain version: its largest distance from
    `ref` (the plain version evaluated in f32 on the same inputs) at most
    1.5 x the plain bf16 version's. Prints the kernel's distance from the
    plain version and the share of elements that differ beside it."""
    kern, plain = kern.float(), plain.float()
    scale = max(ref.abs().max().item(), 1e-30)
    ek, ep = ((kern - ref).abs().max().item() / scale, (plain - ref).abs().max().item() / scale)
    kp = (kern - plain).abs().max().item() / max(plain.abs().max().item(), 1e-30)
    _check(bool(torch.isfinite(kern).all()) and ek <= 1.5 * ep,
           f"{where}: max_abs_err from the plain version in f32 {ek:.2e} x max|ref| (<= 1.5 x "
           f"the plain bf16 version's, {ep:.2e}); against the plain version {kp:.2e} x "
           f"max|plain|, {(kern != plain).float().mean().item():.2%} of elements differ{more}")


def _split_call(call):
    """A call that ``recording`` kept as (positional arguments, keyword
    arguments)."""
    if call and isinstance(call[-1], dict):
        return call[:-1], call[-1]
    return call, {}


def _cpu_spread(plain_fn, args, plain, kw=None):
    """The plain version on the CPU (sums in another order) against the
    card's `plain`, as text: max_abs_err / max|plain| and the share of
    elements that differ."""
    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        return _map_tuple(cpu, a) if isinstance(a, tuple) else a

    cpu = plain_fn(*[cpu(a) for a in args], **{k: cpu(v) for k, v in (kw or {}).items()}).float()
    plain = plain.float().cpu()
    return (f"; the plain version on the CPU against the card's: "
            f"{(cpu - plain).abs().max().item() / max(plain.abs().max().item(), 1e-30):.2e} x "
            f"max|plain|, {(cpu != plain).float().mean().item():.2%} of elements differ")


def check_stage2_validation(trainer, val_kernel, tmp, dev):
    """Validation on the trained weights against the plain path.

    bf16 (the trainer's model): validate's predict (the validation cases in
    one batch, 29 steps, decoded 116 frames at a time, the last chunk
    zero-padded) once more on the kernel path, every call of kernels 1-3
    recorded. The trained propagator's latents are small and the decoder's
    features nearly flat, so these functions are ill-conditioned there:
    the plain version on the CPU (sums in another order) misses the bounds
    that random inputs are held to. Each call is held to accuracy parity
    instead (``_parity``: no farther from the plain version in f32 than
    1.5 x the plain bf16 version); the kernel against the plain version,
    and for kernels 1 and 2 the plain version on the CPU against the
    card's, are printed beside it. Kernel 1: each step from its own carry.
    Then ``validate`` on the plain path (``use_kernels(False)``): its
    val_seq_rel_l2 within 1e-2 (relative) of the kernel path's
    (`val_kernel`, the run's last validation, on these weights); printed
    beside it, the two paths' predictions' difference and the plain path's
    own under a one-ulp change of its input.

    f32 (the same weights in an f32 model): the latent rollout at that
    shape, kernel 1 against the plain path at every step within 1e-4 x
    max|plain| (kernel 1's f32 bound over 29 steps). The decode of those
    latents is printed, kernel path against plain, beside the plain
    decode's own change under a one-ulp change of the latents."""
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core
    from lns_tpu_torch.kernels.group_norm import fused_group_norm_swish, group_norm_swish_plain
    from lns_tpu_torch.kernels.prop_rollout import fused_rollout_plain, pack_simple_cnn
    from lns_tpu_torch.models import LatentDynamics, latent_dynamics
    from lns_tpu_torch.ops import factorized_attention, norms
    from lns_tpu_torch.train.logging_utils import MetricLogger

    cfg, model, ds = trainer.cfg, trainer.model, trainer.val_ds
    x0, y = ds.eval_trajectories()
    x, steps = torch.from_numpy(x0[:, 0]).to(dev), y.shape[1]
    _check(x.shape[0] <= 8, f"stage-2 validate: {x.shape[0]} cases, one predict (batch 8)")
    with recording(latent_dynamics, "fused_rollout") as k1, \
            recording(factorized_attention, "fab_fused_core") as k2, \
            recording(norms, "fused_group_norm_swish") as k3:
        yk = model.predict(x, steps, decode_chunk=cfg.decode_chunk)
    where = f"stage-2 validate bf16 (B{x.shape[0]}, decode chunk {cfg.decode_chunk})"
    _check(len(k1) == 1 and len(k2) > 0 and len(k3) > 0,
           f"{where}: kernel calls recorded: {len(k1)} / {len(k2)} / {len(k3)} (kernels 1 / 2 / 3)")
    with torch.no_grad():
        p32 = pack_simple_cnn(model.propagator, torch.float32)
        for z0, packed, n, n_block, dil, pm in k1:
            zs = latent_dynamics.fused_rollout(z0, packed, n, n_block, dil, pm)
            prev = torch.cat([z0.to(zs.dtype)[None], zs[:-1]]).reshape(-1, *z0.shape[1:])
            args = (prev, packed, 1, n_block, dil, pm)
            plain = fused_rollout_plain(*args).reshape(zs.shape)
            ref = fused_rollout_plain(prev.float(), p32, 1, n_block, dil, pm).reshape(zs.shape)
            cpu_packed = type(packed)(*[t.cpu() for t in packed])
            more = _cpu_spread(fused_rollout_plain, (prev, cpu_packed) + args[2:],
                               plain.reshape(prev.shape))
            _parity(f"{where}, kernel 1, every step of {n} (B{z0.shape[0]}) from its own carry",
                    zs, plain, ref, more)
        for i, (args, kw) in enumerate(map(_split_call, k2)):
            plain = fab_core_plain(*args, **kw)
            _parity(f"{where}, kernel 2 call {i} (u {'x'.join(map(str, args[0].shape))})",
                    fab_fused_core(*args, **kw), plain,
                    fab_core_plain(*[a.float() for a in args], **kw),
                    _cpu_spread(fab_core_plain, args, plain, kw))
        for i, (xg, scale, bias, g, eps, swish, *_) in enumerate(k3):
            a = (scale, bias, g, eps, bool(swish))
            _parity(f"{where}, kernel 3 call {i} ({'x'.join(map(str, xg.shape))} G{g})",
                    fused_group_norm_swish(xg, *a), group_norm_swish_plain(xg, *a),
                    group_norm_swish_plain(xg.float(), *a))
    del k1, k2, k3

    logger, log_dir = trainer.logger, os.path.join(tmp, "log_plain_validate")
    os.makedirs(log_dir)
    trainer.logger = MetricLogger(log_dir, use_wandb=False)
    model.use_kernels(False)
    yp = model.predict(x, steps, decode_chunk=cfg.decode_chunk)
    yq = model.predict(x * (1 + 2 ** -8), steps, decode_chunk=cfg.decode_chunk)
    val_plain = trainer.validate("plain")
    model.use_kernels(True)
    trainer.logger.finish()
    trainer.logger = logger
    y_norm = ds.denormalize(torch.from_numpy(y).to(dev)).flatten(1).norm(dim=1)

    def spread(a, b):  # mean over cases of ||a - b|| / ||y||, denormalised as validate does
        d = (ds.denormalize(a).float() - ds.denormalize(b).float()).flatten(1)
        return (d.norm(dim=1) / y_norm).mean().item()

    _check(math.isfinite(val_plain) and abs(val_kernel - val_plain) <= 1e-2 * val_plain,
           f"stage-2 validate bf16, kernel path vs plain on the same weights: val_seq_rel_l2 "
           f"{val_kernel:.6f} vs {val_plain:.6f}, within {abs(val_kernel / val_plain - 1):.2e} "
           f"(<= 1e-2); the predictions differ by {spread(yk, yp):.3e} (mean ||y_kernel - "
           f"y_plain|| / ||y||); the plain path's own, with its input moved one bf16 ulp: "
           f"{spread(yq, yp):.3e}")

    m32 = LatentDynamics(cfg, device=dev)
    m32.load_state_dict(model.state_dict())
    zk = m32.use_kernels(True).predict(x, steps, to_x=False)
    zp = m32.use_kernels(False).predict(x, steps, to_x=False)
    ratio = ((zk - zp).abs().amax(dim=(0, 2, 3, 4)) / zp.abs().amax(dim=(0, 2, 3, 4))).max().item()
    _check(bool(torch.isfinite(zk).all()) and ratio <= 1e-4,
           f"stage-2 validate f32 latents (B{x.shape[0]}, {steps} steps), kernel 1 vs the plain "
           f"path at every step: max_abs_err <= {ratio:.2e} x max|plain| (<= 1e-4)")
    lat = zk.flatten(0, 1)[: cfg.decode_chunk]
    with torch.no_grad():
        dk = m32.decode(lat)
        m32.use_kernels(False)
        dp, dq = m32.decode(lat), m32.decode(lat * (1 + 2 ** -23))
        m32.use_kernels(True)
    top = dp.abs().max().item()
    print(f"      stage-2 validate f32 decode of {lat.shape[0]} of those latents: kernel path vs "
          f"plain {(dk - dp).abs().max().item() / top:.2e} x max|plain|; the plain decode's own "
          f"change with the latents moved one ulp: {(dq - dp).abs().max().item() / top:.2e} x "
          "max|plain|", flush=True)


def drive_stage2(dev, smi):
    """The stage-2 trainer at full NS2d width on the card: returns the
    kernels' launches over its encode pre-pass and its training run."""
    import tempfile

    import numpy as np

    from lns_tpu_torch.config import ns2d_config
    from lns_tpu_torch.data.synthetic import make_ns2d_npz
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_
    from lns_tpu_torch.train import checkpoint
    from lns_tpu_torch.train.stage2 import Stage2Trainer

    t_phase = time.perf_counter()
    counted = _counted()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ns2d_config().replace(
            data_dir=make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=S2_CASES,
                                   case_len=S2_CASE_LEN, h=64, w=64),
            case_len=S2_CASE_LEN, num_case=S2_CASES, dataset_stat=os.path.join(tmp, "stat.npz"),
            batch_size=S2_BATCH, epochs=S2_EPOCHS, learning_rate=5e-4, mixed_precision=True,
            ckpt_every=1, decode_chunk=CHUNK, log_dir=os.path.join(tmp, "log"),
            overwrite_exist=True)
        ae = init_weights_(LatentDynamics(cfg, device="cpu"), torch.Generator().manual_seed(1))
        ae_path = os.path.join(tmp, "ae.pt")
        checkpoint.save(checkpoint.state_dict_cpu(ae.vq_ae), ae_path)
        cfg = cfg.replace(pretrained_checkpoint_path=ae_path)
        print(f"-- stage-2 training: {S2_CASES} cases x {S2_CASE_LEN} frames of "
              f"{cfg.resolution}x{cfg.resolution}, batch {S2_BATCH}, {S2_EPOCHS} epochs, "
              f"out_tw {cfg.out_tw}, bf16 activations", flush=True)

        base = _launches(counted)
        t0 = time.perf_counter()
        trainer = Stage2Trainer(cfg, seed=1234, use_wandb=False, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        prepass = _launches(counted, base)
        ds, n_frames = trainer.train_ds, trainer.train_ds.n_cases * S2_CASE_LEN
        print(f"      trainer built in {build_s:.2f} s ({len(ds)} windows, "
              f"{trainer.steps_per_epoch} steps per epoch, {len(trainer.val_ds)} validation "
              f"cases); encode pre-pass launches {prepass}", flush=True)

        saved = torch.load(ae_path, weights_only=True)
        ae_now = trainer.model.vq_ae.state_dict()
        _check(saved.keys() == ae_now.keys()
               and all(torch.equal(ae_now[k].cpu(), v) for k, v in saved.items()),
               f"stage-2: the AE loaded bit-identical to the saved .pt ({len(saved)} tensors)")

        encodes = -(-n_frames // 64)
        want = expected_launches(cfg, n_chunks=0, encodes=encodes)
        _check(all(prepass[k] == want.get(k, 0) for k in prepass) and prepass["group_norm"] > 0,
               f"stage-2 encode pre-pass: group_norm launched {prepass['group_norm']} times "
               f"(== {want['group_norm'] // encodes} encoder GN sites x {encodes} encode calls), "
               "no other kernel")
        m32 = LatentDynamics(cfg, device=dev)
        m32.load_state_dict(trainer.model.state_dict())
        enc_s = check_stage2_corpus(trainer, m32, dev)
        check_stage2_gradients(trainer, m32, dev)
        del m32
        for name, call in _refusal_calls(dev).items():
            before = _launched(counted[name])
            try:
                call()
                msg = "no error"
            except RuntimeError as e:
                msg = str(e)
            _check("has no gradient" in msg and _launched(counted[name]) == before,
                   f"stage-2: {name} under grad on a tensor that requires grad raises before "
                   f"launching: {msg}")

        ae0 = {k: v.clone() for k, v in trainer.model.vq_ae.state_dict().items()}
        step_events, val_ms, launches, train_s = _timed_train(trainer)

        n_steps = S2_EPOCHS * trainer.steps_per_epoch
        n_val, steps = len(trainer.val_ds), S2_CASE_LEN - 1
        want = {k: 0 for k in launches}
        for _ in range(S2_EPOCHS + 1):  # validate at every epoch (ckpt_every 1) and at the end
            for i in range(0, n_val, 8):  # validate's predict batches
                b = min(8, n_val - i)
                for k, v in expected_launches(cfg, n_chunks=-(-b * steps // CHUNK)).items():
                    want[k] += v
        want["group_norm"] += n_steps * (2 * cfg.prop_n_block + 1) * cfg.out_tw
        _check(launches == want, f"stage-2 training run: launches {launches} == {want} "
               f"({S2_EPOCHS + 1} validations, {n_steps} train steps)")

        log = cfg.log_dir
        with open(os.path.join(log, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss = [r["loss"] for r in recs if "loss" in r]
        val = [r["val_seq_rel_l2"] for r in recs if "val_seq_rel_l2" in r]
        _check(len(loss) == n_steps and all(math.isfinite(v) for v in loss),
               f"stage-2: {len(loss)} train losses, all finite (first {loss[0]:.5f}, last "
               f"{loss[-1]:.5f})")
        _check(len(val) == S2_EPOCHS + 1 and all(math.isfinite(v) for v in val),
               f"stage-2: val_seq_rel_l2 finite at each validation: {val}")
        _check(all(torch.equal(v, ae0[k]) and torch.equal(v.cpu(), saved[k])
                   for k, v in trainer.model.vq_ae.state_dict().items()),
               "stage-2: the AE is bit-identical to the loaded one after training")
        ckpt = os.path.join(log, "checkpoints")
        files = ("model_best.pt", "model_final.pt", "optim_final.pt", "meta_final.json",
                 "model_1.pt", "optim_1.pt", "meta_1.json")
        _check(all(os.path.exists(os.path.join(ckpt, f)) for f in files),
               f"stage-2: checkpoints written: {', '.join(files)}")

        resumed = Stage2Trainer(cfg.replace(log_dir=os.path.join(tmp, "log_resumed"),
                                            resume_training=True,
                                            resume_ckpt=os.path.join(ckpt, "model_1.pt")),
                                seed=1234, use_wandb=False, device=dev)
        saved1 = torch.load(os.path.join(ckpt, "model_1.pt"), weights_only=True)
        opt_steps = {int(st["step"].item()) for st in resumed.opt.state_dict()["state"].values()}
        _check(resumed.start_epoch == 1 and opt_steps == {trainer.steps_per_epoch}
               and resumed.sched.last_epoch == trainer.steps_per_epoch
               and all(torch.equal(v.cpu(), saved1[k])
                       for k, v in resumed.model.state_dict().items()),
               f"stage-2: a trainer resumed from model_1 restores epoch {resumed.start_epoch} "
               f"(== 1), optimizer steps {sorted(opt_steps)} and schedule step "
               f"{resumed.sched.last_epoch} (== {trainer.steps_per_epoch}), and its parameters "
               "equal the saved ones bitwise")
        del resumed
        check_stage2_validation(trainer, val[-1], tmp, dev)
        evaluated = check_evaluate("stage-2 NS2d", cfg, ckpt, dev, smi, f32=True)
        check_msgpack_round_trip("stage-2 NS2d", cfg, tmp,
                                 ("dynamics", os.path.join(ckpt, "model_best.pt")), ("ae", ae_path))
        z_in, z_out = _s2_batch(trainer, dev)
        profile_device(lambda: [trainer.train_step(z_in, z_out, 0, i) for i in range(5)],
                       "stage-2 5 train steps (bf16, batch 32)")
        del trainer

    ms = sorted(s.elapsed_time(e) for s, e in step_events)
    med = ms[len(ms) // 2]
    print(f"      stage-2 train step (bf16, batch {S2_BATCH}, out_tw {cfg.out_tw}): median "
          f"{med:.3f} ms by CUDA events (min {ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
          f"{1e3 / med:.1f} steps/s; train() {train_s:.2f} s for {n_steps} steps, "
          f"{len(val_ms)} validations and {S2_EPOCHS + 2} checkpoint saves; {smi}", flush=True)
    print(f"      stage-2 encode pre-pass: {n_frames} frames in {enc_s * 1e3:.1f} ms, "
          f"{n_frames / enc_s:.1f} frames/s (host clock, ends in the copy to the host); {smi}",
          flush=True)
    print(f"      stage-2 validate ({n_val} cases, {steps} steps, decode chunk {CHUNK}): wall "
          f"{', '.join(f'{v:.1f}' for v in val_ms)} ms; {smi}", flush=True)
    print(f"      stage-2 phase wall {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {k: prepass[k] + launches[k] for k in launches}, evaluated


# -- phase 6: stage-1 training ------------------------------------------------

# the stage-1 corpus: the stage-2 phase's 64 cases x 30 frames of 64x64; 57
# training cases (1,710 frames: 54 steps of batch 32 per epoch, the last of
# 14) and 7 validation cases (210 frames, reconstructed 64 at a time)
S1_CASES, S1_CASE_LEN, S1_EPOCHS, S1_BATCH = 64, 30, 2, 32


def _ae_step(model, x, use_kernel, denormalize=None):
    """The stage-1 loss of frames x on `model` (``reconstruction_loss``,
    the trainer's; on fields denormalised by `denormalize` where the
    family's trainer takes it so) and its gradient w.r.t. every parameter;
    each kernel's launches in the forward and in the backward."""
    from lns_tpu_torch.train.stage1 import reconstruction_loss

    counted = _counted()
    model.use_kernels(use_kernel)
    params = dict(model.named_parameters())
    before = _launches(counted)
    loss = reconstruction_loss(model, x, denormalize)
    mid = _launches(counted)
    grads = torch.autograd.grad(loss, list(params.values()))
    model.use_kernels(True)
    return (dict(zip(params, grads)), {k: mid[k] - before[k] for k in counted},
            _launches(counted, mid))


def check_fab_calls(where, core_calls, axial_calls):
    """Kernels 2 and 4 on the inputs their call sites really received in a
    train step's forward (from ``recording``), each against the plain
    version, and the gradient w.r.t. every input through its autograd
    Function (the kernel's forward, the plain version's backward) for
    seeded upstream gradients against plain autograd's: bitwise equal,
    since the backward recomputes the plain version from the same inputs.

    f32: at ``check_fab_core``'s and ``check_axial``'s bounds (kernel 2
    1e-4 x max|plain|, kernel 4 2e-5; kernel 4's statistics as
    ``_stats_check``). bf16: these inputs (the AE's features of smooth
    frames) can be nearly flat, where the FAB core's variance, E[x^2] -
    mean^2 as in ``_batched_gram_core``, cancels and a sum in another order
    moves many elements; so each call is held to accuracy parity
    (``_parity``: no farther from the plain version in f32 than 1.5 x the
    plain bf16 version), and whether it also meets the bounds random inputs
    meet (1e-2 x max|plain| for kernel 2, 2e-2 for kernel 4; at most 2 % of
    elements differing) is printed beside it."""
    from lns_tpu_torch.kernels.axial import fab_axial_in_fused, fab_axial_in_plain
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core

    cases = [("kernel 2", fab_fused_core, fab_core_plain, *_split_call(c), c[0], 1e-2, 1e-4)
             for c in core_calls]
    cases += [("kernel 4", fab_axial_in_fused, fab_axial_in_plain, *_split_call(c), c[2], 2e-2,
               2e-5) for c in axial_calls]
    for i, (name, kern, plain, args, kw, main, tol_bf16, tol_f32) in enumerate(cases):
        bf16 = main.dtype == torch.bfloat16
        label = f"{where}, {name} call {i} ({str(main.dtype)[6:]} {'x'.join(map(str, main.shape))})"
        with torch.no_grad():
            yk, yp = kern(*args, **kw), plain(*args, **kw)
            y32 = plain(*[a.float() for a in args], **kw) if bf16 else None
        if isinstance(yk, tuple):  # heads last: _stats_check takes y head-major
            _stats_check(label, yk[0].permute(0, 3, 1, 2, 4), yk[1])
        yk, yp = (yk if isinstance(yk, tuple) else (yk,)), (yp if isinstance(yp, tuple) else (yp,))
        ratio = ((yk[0].float() - yp[0].float()).abs().max().item()
                 / max(yp[0].float().abs().max().item(), 1e-30))
        differ = (yk[0] != yp[0]).float().mean().item()
        if bf16:
            y32 = y32[0] if isinstance(y32, tuple) else y32
            inside = ratio <= tol_bf16 and differ <= 0.02
            _parity(label, yk[0], yp[0], y32,
                    f"; {'within' if inside else 'outside'} the bounds random inputs meet "
                    f"({tol_bf16:.0e} x max|plain|, 2 %)")
        else:
            _check(bool(torch.isfinite(yk[0]).all()) and ratio <= tol_f32,
                   f"{label}, kernel vs plain on its own input: max_abs_err {ratio:.2e} x "
                   f"max|plain| (<= {tol_f32:.0e}); {differ:.2%} of elements differ")
        gen = torch.Generator().manual_seed(i)
        gos = [torch.randn(t.shape, generator=gen).to(t.device, t.dtype) for t in yk]
        grads = []
        for fn in (kern, plain):  # every tensor input, kernel 2's kernel sums too
            leaves = [a.clone().requires_grad_() for a in args]
            kwl = dict(kw)
            if kw.get("mean_from"):  # x and the coefficients carry no gradient
                x, coef, kx_s, ky_s = kw["mean_from"]
                sums = [kx_s.clone().requires_grad_(), ky_s.clone().requires_grad_()]
                kwl["mean_from"] = (x, coef, *sums)
            ys = fn(*leaves, **kwl)
            if kw.get("mean_from"):
                leaves += sums
            grads.append(torch.autograd.grad(ys if isinstance(ys, tuple) else (ys,), leaves, gos))
        _check(all(torch.equal(a, b) for a, b in zip(*grads)),
               f"{label}: gradients w.r.t. its {len(grads[0])} inputs through its autograd "
               "Function bitwise equal to plain autograd's")


def _hold_gradients(where, dt, gk, gp, gq, g32):
    """A train step's gradients {tensor: g} on the kernel path (gk) against
    the plain path (gp), under the rules the stage-1 phase holds a sensitive
    function to:
    f32, per tensor max|g_kernel - g_plain| / max|g_plain| at most 2 x the
    largest such change of the plain path's own gradient (gq) under a
    one-ulp move of its input; bf16, per tensor accuracy parity: the kernel
    path's gradient no farther (L2) from the f32 plain path's (g32) than
    1.5 x the plain bf16 path's. Prints the largest f32 ratio or the
    smallest bf16 cosine between the two paths beside, and for bf16 the
    largest ratio also with the plain path's distance taken as at least
    one bf16 unit of the gradient (2^-8 |g32|), for comparison only."""
    def rel(a, b):
        return {k: (a[k] - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1e-30)
                for k in a}

    def cos(a, b):
        return {k: torch.nn.functional.cosine_similarity(a[k].flatten().float(),
                                                         b[k].flatten().float(), dim=0).item()
                for k in a}

    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    if dt == "f32":
        score, own = rel(gk, gp), rel(gq, gp)
        worst, worst_own = max(score.items(), key=lambda kv: kv[1]), max(own.values())
        _check(finite and worst[1] <= 2 * worst_own,
               f"{where}: gradients, kernel path vs plain, {len(gk)} tensors: max_abs_err <= "
               f"{worst[1]:.2e} x max|g| ({worst[0]}), <= 2 x the plain path's own change "
               f"with its input moved one ulp ({worst_own:.2e} x max|g|)")
        return
    score, own = cos(gk, gp), cos(gq, gp)
    worst, worst_own = min(score.items(), key=lambda kv: kv[1]), min(own.values())
    dk = {k: (gk[k].float() - g32[k]).norm().item() for k in gk}
    dp = {k: (gp[k].float() - g32[k]).norm().item() for k in gk}
    parity = {k: dk[k] / max(dp[k], 1e-30) for k in gk}
    floored = {k: dk[k] / max(dp[k], 2 ** -8 * g32[k].norm().item(), 1e-30) for k in gk}
    top, top_f = max(parity, key=parity.get), max(floored, key=floored.get)
    _check(finite and parity[top] <= 1.5,
           f"{where}: gradients, {len(gk)} tensors, distance from the f32 plain "
           f"gradient, kernel path / plain path: at most {parity[top]:.3f} (<= 1.5; "
           f"{top}, {gk[top].numel()} elements); cosine similarity kernel path vs plain >= "
           f"{worst[1]:.6f} ({worst[0]}); the plain path's own with its input moved one ulp "
           f">= {worst_own:.6f}; with the plain path's distance at least 2^-8 |g32| (not "
           f"applied) at most {floored[top_f]:.3f} ({top_f})")


def check_stage1_step(label, model, m32, x, denormalize=None):
    """One stage-1 train step's loss gradient w.r.t. every AE parameter, on
    frames x (the loss on fields denormalised by `denormalize` where the
    family's trainer takes it so), kernel path against
    ``use_kernels(False)`` (TF32 off), in f32 (`m32`, the same weights) and
    in bf16 (`model`).

    The AE's gradient is sensitive to its forward at the ulp level: the
    plain path's own gradient moves by some 1e-5 to 1e-4 x max|g| in f32
    (cosine 0.9-0.99 in bf16) when its input moves one ulp, and the kernel
    path's forward differs from the plain path's by sums in another order
    (a few f32 ulps in kernels 2-4, some bf16 elements an ulp apart). So:
    f32, per tensor max|g_kernel - g_plain| / max|g_plain| at most 2 x the
    largest such change of the plain path's own gradient under a one-ulp
    move of its input; bf16, per tensor accuracy parity: the kernel path's
    gradient no farther from the f32 plain path's (L2) than 1.5 x the
    plain bf16 path's. The largest f32 ratio and the smallest bf16 cosine
    between the two paths are printed beside.

    Every parameter tensor gets a nonzero gradient, the FAB blocks'
    ``in_proj``, ``to_out[1]``, ``in_norm`` and low-rank-kernel weights
    named among them. The forward launches kernel 3 once per AE GroupNorm
    site and each FAB block's core once (kernel 2 c-space, kernel 4
    d-space), as the layer specs imply; the backward and the plain path
    launch nothing. Each kernel 2 and 4 call of the forward is also held on
    its own input, with its gradient (``check_fab_calls``)."""
    from lns_tpu_torch.ops import factorized_attention
    from lns_tpu_torch.ops.factorized_attention import FABlock2D

    want = expected_launches(model.cfg, n_chunks=1)  # one encode, one decode
    want["prop_rollout"] = 0
    fab_names = [f"{p}.{w}" for p, m in model.named_modules() if isinstance(m, FABlock2D)
                 for w in ("in_proj.weight", "to_out.1.weight", "in_norm.weight", "in_norm.bias",
                           "low_rank_kernel_x.to_qk.weight", "low_rank_kernel_y.to_qk.weight")]
    for dt, m in (("f32", m32), ("bf16", model)):
        where = f"stage-1 {label} {dt} train step (batch {x.shape[0]})"
        with recording(factorized_attention, "fab_fused_core") as k2, \
                recording(factorized_attention, "fab_axial_in_fused") as k4, torch.no_grad():
            m(x)
        check_fab_calls(where, k2, k4)
        del k2, k4
        gk, fwd, bwd = _ae_step(m, x, True, denormalize)
        gp, fwd_p, bwd_p = _ae_step(m, x, False, denormalize)
        # the plain path's own gradient with its input moved one ulp: how
        # far the gradient moves for a change of the forward's size
        gq, _, _ = _ae_step(m, x * (1 + (2 ** -23 if dt == "f32" else 2 ** -8)), False,
                            denormalize)
        _check(all(fwd[k] == want.get(k, 0) for k in fwd)
               and not any(bwd.values()) and not any(fwd_p.values()) and not any(bwd_p.values()),
               f"{where}: launches in the forward {({k: v for k, v in fwd.items() if v})} == "
               f"{({k: v for k, v in want.items() if v})} (the layer specs), in the backward "
               f"{sum(bwd.values())}, on the plain path "
               f"{sum(fwd_p.values()) + sum(bwd_p.values())}")
        if dt == "f32":
            g32 = gp
        _hold_gradients(where, dt, gk, gp, gq, g32)
        top = {k: g.abs().max().item() for k, g in gk.items()}
        low = min(top, key=top.get)
        fab_low = (f" (smallest {top[min(fab_names, key=top.get)]:.3e}, "
                   f"{min(fab_names, key=top.get)})" if fab_names else "")
        _check(all(v > 0 for v in top.values()) and set(fab_names) <= top.keys(),
               f"{where}: all {len(top)} parameter tensors have a nonzero gradient (smallest "
               f"max|g| {top[low]:.3e}, {low}); the {len(fab_names)} FAB in_proj, to_out[1], "
               f"in_norm and low-rank-kernel tensors among them{fab_low}")


def backward_recompute_share(trainer, x, reps=3):
    """The backward of `reps` train steps' losses on frames x (after one
    warm-up), each between CUDA events, and the spans of the autograd
    Functions' backward recomputes (kernels 2, 3 and 4: the plain version
    re-run under grad) between CUDA events inside it. Returns [(backward
    ms, recompute ms, recomputes, backward host ms)] per step. The step is
    host-bound, so these spans read the host's pace as much as the card's."""
    from lns_tpu_torch.kernels.axial import AxialInFunction
    from lns_tpu_torch.kernels.fab_core import FabCoreFunction
    from lns_tpu_torch.kernels.group_norm import GroupNormSwishFunction

    spans = []

    def timed(real):
        def backward(ctx, *grads):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(ctx, *grads)
            ev[1].record()
            spans.append(ev)
            return out
        return staticmethod(backward)

    fns = (FabCoreFunction, GroupNormSwishFunction, AxialInFunction)
    reals = [f.backward for f in fns]
    for f in fns:
        f.backward = timed(f.backward)
    res = []
    try:
        for _ in range(reps + 1):
            loss = trainer._loss(x)
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            loss.backward()
            end.record()
            torch.cuda.synchronize()
            res.append((start.elapsed_time(end), sum(s.elapsed_time(e) for s, e in spans),
                        len(spans), (time.perf_counter() - t0) * 1e3))
    finally:
        for f, real in zip(fns, reals):
            f.backward = staticmethod(real)
        trainer.opt.zero_grad(set_to_none=True)
    return res[1:]


def cancellations(calls):
    """Over recorded bf16 kernel 2 calls (their mean_from given): how often
    the variance of phi per (sample, head, d), E[phi^2] - mean^2 with the
    block's mean, cancels to <= 0, where ``_batched_gram_core``'s clamp
    scales the channel by rsqrt(eps); from the plain version's moments, as
    text."""
    from lns_tpu_torch.kernels.fab_core import phi_moments

    total = hit = calls_hit = 0
    with torch.no_grad():
        for args, kw in map(_split_call, calls):
            if not kw.get("mean_from"):
                continue
            ex2, mean = phi_moments(*args[:4], mean_from=kw["mean_from"])
            cancelled = int((ex2 - mean.square() <= 0).sum())
            total, hit, calls_hit = total + ex2.numel(), hit + cancelled, calls_hit + (cancelled > 0)
    return (f"E[phi^2] - mean^2 <= 0 at {hit} of {total} (sample, head, d), in {calls_hit} of "
            f"{len(calls)} calls")


def check_stage1_validation(trainer, val_kernel, tmp):
    """Validation of the trained AE against the plain path, and kernel 2's
    conditioning on the trained AE's decode.

    bf16: one validation call (64 frames of the held-out trajectories)
    reconstructed on the kernel path, every call of kernels 2 and 3
    recorded; each held to accuracy parity with its plain version
    (``_parity``: no farther from the plain version in f32 than 1.5 x the
    plain bf16 version). For kernel 2 also printed: against its plain
    version (max error, share of elements that differ) beside the bounds
    that random inputs meet (1e-2 x max|plain|, 2 %), the plain version on
    the CPU against the card's, and the kernel in f32 against the plain
    version in f32 on the same inputs beside its random-input bound (1e-4):
    whether the trained AE keeps the decode well-conditioned. Then
    ``validate`` on the plain path (``use_kernels(False)``): its
    val_recon_loss within 1e-2 (relative) of the kernel path's
    (`val_kernel`, the run's last validation, on these weights)."""
    from lns_tpu_torch.kernels.fab_core import fab_core_plain, fab_fused_core
    from lns_tpu_torch.kernels.group_norm import fused_group_norm_swish, group_norm_swish_plain
    from lns_tpu_torch.ops import factorized_attention, norms
    from lns_tpu_torch.train.logging_utils import MetricLogger

    traj = trainer.val_ds.eval_trajectories()
    frames = traj.reshape(-1, *traj.shape[2:])[:64]
    with recording(factorized_attention, "fab_fused_core") as k2, \
            recording(norms, "fused_group_norm_swish") as k3:
        trainer.reconstruct(frames)
    where = f"stage-1 validate bf16 (trained AE, {frames.shape[0]} held-out frames)"
    _check(len(k2) > 0 and len(k3) > 0,
           f"{where}: kernel calls recorded: {len(k2)} / {len(k3)} (kernels 2 / 3)")
    conditioned = True
    with torch.no_grad():
        for i, (args, kw) in enumerate(map(_split_call, k2)):
            yk, plain = fab_fused_core(*args, **kw), fab_core_plain(*args, **kw)
            _parity(f"{where}, kernel 2 call {i} (u {'x'.join(map(str, args[0].shape))})",
                    yk, plain, fab_core_plain(*[a.float() for a in args], **kw),
                    _cpu_spread(fab_core_plain, args, plain, kw))
            a32 = [a.float() for a in args]  # f32 takes the mean from u (mean_from is bf16's)
            k32, p32 = fab_fused_core(*a32), fab_core_plain(*a32)
            r16 = (yk.float() - plain.float()).abs().max().item() / plain.float().abs().max().item()
            d16 = (yk != plain).float().mean().item()
            r32 = (k32 - p32).abs().max().item() / p32.abs().max().item()
            d32 = (k32 != p32).float().mean().item()
            ok = r16 <= 1e-2 and d16 <= 0.02 and r32 <= 1e-4
            conditioned = conditioned and ok
            print(f"      {where}, kernel 2 call {i}: bf16 kernel vs plain {r16:.2e} x max|plain| "
                  f"(random inputs: <= 1e-2), {d16:.2%} of elements differ (<= 2 %); f32 kernel "
                  f"vs plain {r32:.2e} x max|plain| (<= 1e-4), {d32:.2%} differ: "
                  f"{'within' if ok else 'outside'} the random-input bounds", flush=True)
        for i, (xg, scale, bias, g, eps, swish, *_) in enumerate(k3):
            a = (scale, bias, g, eps, bool(swish))
            _parity(f"{where}, kernel 3 call {i} ({'x'.join(map(str, xg.shape))} G{g})",
                    fused_group_norm_swish(xg, *a), group_norm_swish_plain(xg, *a),
                    group_norm_swish_plain(xg.float(), *a))
    print(f"      {where}: kernel 2's variance: {cancellations(k2)}", flush=True)
    print(f"      {where}: conditioning of the FAB core on the trained AE's decode: "
          + ("every kernel 2 call within the bounds random inputs meet: well-conditioned"
             if conditioned else "some kernel 2 call outside the bounds random inputs meet: "
             "ill-conditioned"), flush=True)
    del k2, k3

    logger, log_dir = trainer.logger, os.path.join(tmp, "log_plain_validate")
    os.makedirs(log_dir)
    trainer.logger = MetricLogger(log_dir, use_wandb=False)
    trainer.model.use_kernels(False)
    val_plain = trainer.validate("plain")
    trainer.model.use_kernels(True)
    trainer.logger.finish()
    trainer.logger = logger
    _check(math.isfinite(val_plain) and abs(val_kernel - val_plain) <= 1e-2 * val_plain,
           f"stage-1 validate bf16, kernel path vs plain on the same weights: val_recon_loss "
           f"{val_kernel:.6f} vs {val_plain:.6f}, within {abs(val_kernel / val_plain - 1):.2e} "
           "(<= 1e-2)")
    return conditioned


def check_handoff(cfg, path, frames, dev):
    """The trained AE's ``vqgan_epoch_final.pt`` loaded strictly into a
    ``LatentDynamics`` (a seeded propagator), bitwise, and one predict at
    the main path's size (batch BATCH, STEPS steps, CHUNK-frame decode
    chunks, bf16) from `frames`: finite, of its shape, on kernels 1-3 as
    often as the layer specs imply."""
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_
    from lns_tpu_torch.train import checkpoint

    model = init_weights_(LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                                         device="cpu"), torch.Generator().manual_seed(3)).to(dev)
    checkpoint.load_autoencoder_checkpoint(path, model.vq_ae)
    saved = torch.load(path, weights_only=True)
    now = model.vq_ae.state_dict()
    _check(saved.keys() == now.keys()
           and all(torch.equal(now[k].cpu(), v) for k, v in saved.items()),
           f"stage-1 hand-off: vqgan_epoch_final.pt ({len(saved)} tensors) loaded strictly into "
           "LatentDynamics.vq_ae, bitwise")
    counted = _counted()
    base = _launches(counted)
    y = model.predict(frames, STEPS, decode_chunk=CHUNK)
    torch.cuda.synchronize()
    launches = _launches(counted, base)
    want = expected_launches(cfg)
    _check(tuple(y.shape) == (frames.shape[0], STEPS) + tuple(frames.shape[1:])
           and bool(torch.isfinite(y).all())
           and all(launches[k] == want.get(k, 0) for k in launches),
           f"stage-1 hand-off: predict from the trained AE, batch {frames.shape[0]}, {STEPS} "
           f"steps: output {tuple(y.shape)} finite; launches "
           f"{({k: v for k, v in launches.items() if v})} == "
           f"{({k: v for k, v in want.items() if v})}")


def drive_stage1(dev, smi):
    """The stage-1 trainer at full NS2d width on the card: returns the
    kernels' launches over its training run."""
    import tempfile

    import numpy as np

    from lns_tpu_torch.config import ns2d_config
    from lns_tpu_torch.data import epoch_batches
    from lns_tpu_torch.data.synthetic import make_ns2d_npz
    from lns_tpu_torch.models import SimpleAutoencoder
    from lns_tpu_torch.ops.initializers import init_weights_
    from lns_tpu_torch.train.stage1 import Stage1Trainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ns2d_config().replace(
            data_dir=make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=S1_CASES,
                                   case_len=S1_CASE_LEN, h=64, w=64),
            case_len=S1_CASE_LEN, num_case=S1_CASES, dataset_stat=os.path.join(tmp, "stat.npz"),
            batch_size=S1_BATCH, epochs=S1_EPOCHS, learning_rate=5e-4, mixed_precision=True,
            ckpt_every=1, device_data=True, log_dir=os.path.join(tmp, "log"),
            overwrite_exist=True)
        print(f"-- stage-1 training: {S1_CASES} cases x {S1_CASE_LEN} frames of "
              f"{cfg.resolution}x{cfg.resolution}, batch {S1_BATCH}, {S1_EPOCHS} epochs, bf16 "
              "activations, frames on the card", flush=True)
        trainer = Stage1Trainer(cfg, seed=1234, use_wandb=False, device=dev)
        ds = trainer.train_ds
        n, n_val = len(ds), trainer.val_ds.n_cases * S1_CASE_LEN
        steps_per_epoch = -(-n // S1_BATCH)
        x = torch.from_numpy(ds.get_batch(np.arange(S1_BATCH))).to(dev)

        m32 = SimpleAutoencoder(cfg).to(dev)
        m32.load_state_dict(trainer.model.state_dict())
        check_stage1_step("path 1", trainer.model, m32, x)
        cfg2 = cfg.replace(use_attn_enc=True)
        ae2 = init_weights_(SimpleAutoencoder(cfg2, dtype=torch.bfloat16),
                            torch.Generator().manual_seed(2)).to(dev)
        m32 = SimpleAutoencoder(cfg2).to(dev)
        m32.load_state_dict(ae2.state_dict())
        check_stage1_step("path 2 use_attn_enc", ae2, m32, x)
        del m32, ae2

        step_events, val_ms, launches, train_s = _timed_train(trainer)

        n_steps = S1_EPOCHS * steps_per_epoch
        calls = -(-n_val // 64)  # validate's reconstruct calls
        want = {k: 0 for k in launches}
        for k, v in expected_launches(cfg, n_chunks=1).items():
            want[k] += n_steps * v + (S1_EPOCHS + 1) * calls * v
        want["prop_rollout"] = 0
        _check(launches == want, f"stage-1 training run: launches {launches} == {want} "
               f"({n_steps} train steps, {S1_EPOCHS + 1} validations of {calls} calls)")

        with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss = [r["rec_loss"] for r in recs if "rec_loss" in r]
        val = [r["val_recon_loss"] for r in recs if "val_recon_loss" in r]
        first, last = np.mean(loss[:steps_per_epoch]), np.mean(loss[-steps_per_epoch:])
        _check(len(loss) == n_steps and all(math.isfinite(v) for v in loss) and last < first,
               f"stage-1: {len(loss)} train losses, all finite, falling: epoch means "
               f"{first:.5f} -> {last:.5f} (first {loss[0]:.5f}, last {loss[-1]:.5f})")
        _check(len(val) == S1_EPOCHS + 1 and all(math.isfinite(v) for v in val)
               and val[-1] < val[0], f"stage-1: val_recon_loss finite and falling: {val}")
        ckpt = os.path.join(cfg.log_dir, "checkpoints")
        files = ("vqgan_epoch_best.pt", "meta_epoch_best.json", "vqgan_epoch_final.pt",
                 "optim_epoch_final.pt", "meta_epoch_final.json", "vqgan_epoch_1.pt",
                 "optim_epoch_1.pt", "meta_epoch_1.json")
        _check(all(os.path.exists(os.path.join(ckpt, f)) for f in files),
               f"stage-1: checkpoints written: {', '.join(files)}")

        resumed = Stage1Trainer(cfg.replace(log_dir=os.path.join(tmp, "log_resumed"),
                                            resume_training=True,
                                            resume_ckpt=os.path.join(ckpt, "vqgan_epoch_1.pt")),
                                seed=999, use_wandb=False, device=dev)
        saved = torch.load(os.path.join(ckpt, "vqgan_epoch_1.pt"), weights_only=True)
        opt_saved = torch.load(os.path.join(ckpt, "optim_epoch_1.pt"), map_location="cpu",
                               weights_only=True)["state"]
        opt_now = resumed.opt.state_dict()["state"]
        order = [next(epoch_batches(n, S1_BATCH, np.random.default_rng([s, 1])))
                 for s in (resumed.seed, trainer.seed)]
        _check(resumed.start_epoch == 1 and resumed.seed == trainer.seed
               and np.array_equal(*order)
               and all(torch.equal(v.cpu(), saved[k])
                       for k, v in resumed.model.state_dict().items())
               and opt_now.keys() == opt_saved.keys()
               and all(torch.equal(v.cpu(), opt_saved[i][k])
                       for i, st in opt_now.items() for k, v in st.items()),
               f"stage-1: a trainer resumed from vqgan_epoch_1 with seed 999 passed restores "
               f"epoch {resumed.start_epoch} (== 1), seed {resumed.seed} (so epoch 1's batch "
               f"order), the parameters and the optimizer state of {len(opt_now)} tensors, "
               "bitwise")
        del resumed

        conditioned = check_stage1_validation(trainer, val[-1], tmp)
        frames = torch.from_numpy(ds.get_batch(np.arange(BATCH) * S1_CASE_LEN)).to(dev)
        check_handoff(cfg, os.path.join(ckpt, "vqgan_epoch_final.pt"), frames, dev)
        share = backward_recompute_share(trainer, x)
        profile_device(lambda: [trainer.train_step(x) for _ in range(5)],
                       f"stage-1 5 train steps (bf16, batch {S1_BATCH})")
        del trainer

    ms = sorted(s.elapsed_time(e) for s, e in step_events)
    med = ms[len(ms) // 2]
    print(f"      stage-1 train step (bf16, batch {S1_BATCH}, the last of each epoch "
          f"{n - (steps_per_epoch - 1) * S1_BATCH}): median {med:.3f} ms by CUDA events (min "
          f"{ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), {1e3 / med:.1f} steps/s, "
          f"{S1_BATCH * 1e3 / med:.1f} frames/s; train() {train_s:.2f} s for {n_steps} steps, "
          f"{len(val_ms)} validations and {S1_EPOCHS + 2} checkpoint saves; {smi}", flush=True)
    print(f"      stage-1 validate ({n_val} frames in {calls} calls of 64): wall "
          f"{', '.join(f'{v:.1f}' for v in val_ms)} ms; {smi}", flush=True)
    bw = sorted(share)
    print(f"      stage-1 backward (bf16, batch {S1_BATCH}, after one warm-up), by CUDA events: "
          + "; ".join(f"{b:.2f} ms, of which {r:.2f} ms ({r / b:.1%}) in {k} plain recomputes "
                      f"(kernels 2 and 3), host {h:.2f} ms" for b, r, k, h in bw)
          + f"; {smi}", flush=True)
    print(f"      stage-1: the trained AE's decode {'keeps' if conditioned else 'does not keep'} "
          f"kernel 2 within its random-input bounds; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return launches


# -- phase 7: the SW and two-phase families' training -------------------------

# the SW corpus: synthetic 96x192 fields (u, v, pres) from make_sw_store, 12
# training and 4 test cases of 24 frames. Stage 1: 264 training frames (9
# steps of batch 32 per epoch, the last of 8), two epochs; stage 2: out_tw
# 5 at the hard-coded interval 2, 120 windows (3 steps of batch 32 per
# epoch), three epochs. Each validates before its first epoch and at the end.
SW_CASES, SW_CASE_LEN, SW_TRAIN_BATCH, SW_S1_EPOCHS, SW_S2_EPOCHS = 12, 24, 32, 2, 3
# the two-phase corpus: 61x121 linear-sloshing fields (vx, vy, prs, vof) from
# make_sloshing_dir(vary="depth"), the non-conditional "varying height"
# corpus, 23 cases of 16 frames (the seed-44 split: 20 training, 3 test).
# Stage 1: 320 training frames (10 steps of batch 32 per epoch), two epochs;
# stage 2: in_tw 1, out_tw 5, 200 windows (6 steps of batch 32), three epochs
TP_CASES, TP_CASE_LEN, TP_TRAIN_BATCH, TP_S1_EPOCHS, TP_S2_EPOCHS = 23, 16, 32, 2, 3
# the conditional two-phase family: the same sizes on make_sloshing_dir(
# vary="freq"), a driving frequency per case at a fixed depth, the corpus
# its parameter comes from; its stage 2 validates each test case with it


def _sw_train_config(tmp, **over):
    """``sw_config()`` on a synthetic corpus under `tmp`, bf16, batch 32,
    validating only before the first epoch and at the end."""
    from lns_tpu_torch.config import sw_config
    from lns_tpu_torch.data.synthetic import make_sw_store

    data = os.path.join(tmp, "sw")
    if not os.path.exists(data):
        make_sw_store(data, ncase=SW_CASES, case_len=SW_CASE_LEN, h=96, w=192, seed=0)
    return sw_config().replace(
        train_data_dir=os.path.join(data, "train.zarr"), test_data_dir=os.path.join(data, "test.zarr"),
        dataset_stat=os.path.join(data, "normstats.npz"), case_len=SW_CASE_LEN,
        num_case=SW_CASES, batch_size=SW_TRAIN_BATCH, mixed_precision=True, ckpt_every=1000,
        overwrite_exist=True, **over)


def _tp_train_config(tmp, **over):
    """``twophase_config()`` on a sloshing corpus under `tmp`, bf16, batch
    32, validating only before the first epoch and at the end."""
    from lns_tpu_torch.config import twophase_config
    from lns_tpu_torch.data.sloshing_solver import make_sloshing_dir

    data = os.path.join(tmp, "sloshing")
    if not os.path.exists(data):
        make_sloshing_dir(data, ncase=TP_CASES, case_len=TP_CASE_LEN, seed=3, vary="depth")
    return twophase_config().replace(
        data_dir=data, dataset_stat=os.path.join(tmp, "twophase_stat.npz"), case_len=TP_CASE_LEN,
        num_case=TP_CASES, batch_size=TP_TRAIN_BATCH, mixed_precision=True, ckpt_every=1000,
        overwrite_exist=True, **over)


def _tpc_train_config(tmp, **over):
    """``twophase_conditional_config()`` on a sloshing corpus of one
    driving frequency per case under `tmp`, bf16, batch 32, validating only
    before the first epoch and at the end."""
    from lns_tpu_torch.config import twophase_conditional_config
    from lns_tpu_torch.data.sloshing_solver import make_sloshing_dir

    data = os.path.join(tmp, "sloshing_freq")
    if not os.path.exists(data):
        make_sloshing_dir(data, ncase=TP_CASES, case_len=TP_CASE_LEN, seed=3, vary="freq")
    return twophase_conditional_config().replace(
        data_dir=data, dataset_stat=os.path.join(tmp, "twophase_cond_stat.npz"),
        case_len=TP_CASE_LEN, num_case=TP_CASES, batch_size=TP_TRAIN_BATCH,
        mixed_precision=True, ckpt_every=1000, overwrite_exist=True, **over)


# each family's training phases: its config on its corpus, the batch, the
# epochs and the optimizer settings of the JAX package's convergence runs
# (benchmarks/convergence_families.py: SW :117-128, two-phase and its
# conditional family :140-153; cut: the corpus and the epochs), its channels
# and what its corpus is
FAMILIES = {
    "SW": dict(config=_sw_train_config, batch=SW_TRAIN_BATCH, epochs=(SW_S1_EPOCHS, SW_S2_EPOCHS),
               s1=dict(learning_rate=3e-5, beta1=0.5, beta2=0.9), s2=dict(learning_rate=3e-4),
               channels=("vx", "vy", "prs"),
               corpus=f"{SW_CASES} cases x {SW_CASE_LEN} frames of 96x192x3 (make_sw_store)"),
    "two-phase": dict(config=_tp_train_config, batch=TP_TRAIN_BATCH,
                      epochs=(TP_S1_EPOCHS, TP_S2_EPOCHS),
                      s1=dict(learning_rate=3e-5, beta1=0.5, beta2=0.9),
                      s2=dict(learning_rate=5e-4, in_tw=1, out_tw=5),
                      channels=("vx", "vy", "prs", "vof"),
                      corpus=f"{TP_CASES} cases x {TP_CASE_LEN} frames of 61x121x4 "
                             "(make_sloshing_dir, vary='depth')"),
    "conditional two-phase": dict(config=_tpc_train_config, batch=TP_TRAIN_BATCH,
                                  epochs=(TP_S1_EPOCHS, TP_S2_EPOCHS),
                                  s1=dict(learning_rate=3e-5, beta1=0.5, beta2=0.9),
                                  s2=dict(learning_rate=5e-4, in_tw=1, out_tw=5),
                                  channels=("vx", "vy", "prs", "vof"),
                                  corpus=f"{TP_CASES} cases x {TP_CASE_LEN} frames of 61x121x4, "
                                         "a driving frequency each (make_sloshing_dir, "
                                         "vary='freq')"),
}


def _timed_train(trainer):
    """trainer.train() with each train step between CUDA events and each
    validation by the host clock between synchronizes; returns (step
    events, validation ms, launches per kernel, seconds)."""
    counted = _counted()
    step_events, val_ms = [], []
    step_fn, validate = trainer.train_step, trainer.validate

    def timed_step(*args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step_fn(*args)
        ev[1].record()
        step_events.append(ev)
        return out

    def timed_validate(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = validate(*args)
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t0) * 1e3)
        return v

    trainer.train_step, trainer.validate = timed_step, timed_validate
    base = _launches(counted)
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    trainer.train_step, trainer.validate = step_fn, validate
    return step_events, val_ms, _launches(counted, base), secs


def _check_family_run(where, log_dir, loss_key, val_keys, steps_per_epoch, epochs):
    """The run's train losses finite and falling (epoch means), each
    validation key logged before the first epoch and at the end, finite."""
    import numpy as np

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    loss = [r[loss_key] for r in recs if loss_key in r]
    first, last = np.mean(loss[:steps_per_epoch]), np.mean(loss[-steps_per_epoch:])
    _check(len(loss) == epochs * steps_per_epoch and all(math.isfinite(v) for v in loss)
           and last < first,
           f"{where}: {len(loss)} train losses, all finite, falling: epoch means {first:.5f} -> "
           f"{last:.5f} (first {loss[0]:.5f}, last {loss[-1]:.5f})")
    vals = {k: [r[k] for r in recs if k in r] for k in val_keys}
    _check(all(len(v) == 2 and all(math.isfinite(x) for x in v) for v in vals.values()),
           f"{where}: validation before the first epoch and at the end, finite: "
           + ", ".join(f"{k} {v}" for k, v in vals.items()))


def _print_steps(where, step_events, secs, batch, smi):
    ms = sorted(s.elapsed_time(e) for s, e in step_events)
    med = ms[len(ms) // 2]
    print(f"      {where} train step (bf16, batch {batch}): median {med:.3f} ms by CUDA events "
          f"(min {ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), {1e3 / med:.1f} steps/s; train() "
          f"{secs:.2f} s; {smi}", flush=True)


def _same_state(model, path):
    """Whether `model`'s state dict equals the ``.pt`` at `path`, bitwise."""
    saved = torch.load(path, weights_only=True)
    return saved.keys() == model.state_dict().keys() and all(
        torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())


def drive_family_stage1(fam, dev, smi, tmp):
    """The stage-1 trainer of family `fam` (``FAMILIES``) at full width on
    the card: one train step's launches and gradients against the plain
    path, a timed run with its launch counts and falling losses, and a
    trainer resumed from its final checkpoint. Returns the kernels'
    launches over the run and the path of its final checkpoint."""
    import numpy as np

    from lns_tpu_torch.models import SimpleAutoencoder
    from lns_tpu_torch.train.stage1 import Stage1Trainer

    spec = FAMILIES[fam]
    t_phase = time.perf_counter()
    epochs, batch = spec["epochs"][0], spec["batch"]
    cfg = spec["config"](tmp, epochs=epochs, device_data=True,
                         log_dir=os.path.join(tmp, "s1"), **spec["s1"])
    print(f"-- {fam} stage-1 training: {spec['corpus']}, batch {batch}, {epochs} epochs, lr "
          f"{cfg.learning_rate:g}, betas ({cfg.beta1}, {cfg.beta2}), bf16 activations, frames "
          "on the card", flush=True)
    trainer = Stage1Trainer(cfg, seed=1234, use_wandb=False, device=dev)
    traj = trainer.val_ds.eval_trajectories()
    n, n_val = len(trainer.train_ds), traj.shape[0] * traj.shape[1]
    steps_per_epoch = -(-n // batch)
    x = torch.from_numpy(trainer.train_ds.get_batch(np.arange(batch))).to(dev)
    m32 = SimpleAutoencoder(cfg).to(dev)
    m32.load_state_dict(trainer.model.state_dict())
    check_stage1_step(fam, trainer.model, m32, x, trainer._loss_denorm)
    del m32

    step_events, val_ms, launches, secs = _timed_train(trainer)
    n_steps = epochs * steps_per_epoch
    calls = -(-n_val // 64)  # validate's reconstruct calls
    want = {k: (n_steps + 2 * calls) * v
            for k, v in expected_launches(cfg, n_chunks=1).items()}
    want["prop_rollout"] = 0
    _check(all(launches[k] == want.get(k, 0) for k in launches),
           f"{fam} stage-1 training run: launches {({k: v for k, v in launches.items() if v})} "
           f"== {({k: v for k, v in want.items() if v})} ({n_steps} train steps, 2 validations "
           f"of {calls} calls)")
    per_step = {k: v for k, v in expected_launches(cfg, n_chunks=1).items()
                if v and k != "prop_rollout"}
    print(f"      {fam} stage-1 launches per train step: {per_step}", flush=True)
    _check_family_run(f"{fam} stage-1", cfg.log_dir, "rec_loss",
                      ("val_recon_loss",) + tuple(f"val_recon_loss_{c}" for c in spec["channels"]),
                      steps_per_epoch, epochs)
    ckpt = os.path.join(cfg.log_dir, "checkpoints")
    files = ("vqgan_epoch_final.pt", "optim_epoch_final.pt", "meta_epoch_final.json",
             "vqgan_epoch_best.pt")
    _check(all(os.path.exists(os.path.join(ckpt, f)) for f in files),
           f"{fam} stage-1: checkpoints written: {', '.join(files)}")
    resumed = Stage1Trainer(cfg.replace(log_dir=os.path.join(tmp, "s1_resumed"),
                                        resume_training=True,
                                        resume_ckpt=os.path.join(ckpt, "vqgan_epoch_final.pt")),
                            seed=999, use_wandb=False, device=dev)
    opt_saved = torch.load(os.path.join(ckpt, "optim_epoch_final.pt"), map_location="cpu",
                           weights_only=True)["state"]
    opt_now = resumed.opt.state_dict()["state"]
    _check(resumed.start_epoch == epochs and resumed.seed == 1234
           and _same_state(resumed.model, os.path.join(ckpt, "vqgan_epoch_final.pt"))
           and opt_now.keys() == opt_saved.keys()
           and all(torch.equal(v.cpu(), opt_saved[i][k]) for i, st in opt_now.items()
                   for k, v in st.items()),
           f"{fam} stage-1: a trainer resumed from vqgan_epoch_final with seed 999 passed "
           f"restores epoch {resumed.start_epoch} (== {epochs}), seed {resumed.seed}, the "
           f"parameters and the optimizer state of {len(opt_now)} tensors, bitwise")
    del resumed
    profile_device(lambda: [trainer.train_step(x) for _ in range(3)],
                   f"{fam} stage-1 3 train steps (bf16, batch {batch})")
    del trainer
    _print_steps(f"{fam} stage-1", step_events, secs, batch, smi)
    print(f"      {fam} stage-1 validate ({n_val} frames in {calls} calls of 64): wall "
          f"{', '.join(f'{v:.1f}' for v in val_ms)} ms; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return launches, os.path.join(ckpt, "vqgan_epoch_final.pt")


def check_family_stage2_gradients(fam, trainer, m32):
    """One stage-2 train step's gradients w.r.t. every propagator
    parameter, kernel path against ``use_kernels(False)`` (TF32 off), on the
    batch's first windows of the corpus (and, conditional, their
    parameters), under the stage-1 phase's rules (``_hold_gradients``);
    every parameter tensor with a nonzero gradient; kernel 3 launched
    ``train_step_gn`` times in the forward and never in the backward. A
    conditional model's gates start at zero, and with them the gradient of
    all that feeds them (the conditioning MLP, each block's projection and
    FiLM branch): it is held on copies with the gates filled from a seeded
    generator. Returns the batch: (z_in, z_out) and, conditional, the
    parameters."""
    import numpy as np

    from lns_tpu_torch.models import LatentDynamics

    cfg = trainer.cfg
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(trainer.device)
                  for a in trainer.train_ds.get_batch(np.arange(cfg.batch_size)))
    z_in, z_out, *cond = batch
    per_step = train_step_gn(cfg)
    mbf = trainer.model
    if cfg.is_conditional:
        _open_gates(m32, torch.Generator().manual_seed(7))
        mbf = LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                             device=trainer.device)
        mbf.load_state_dict(m32.state_dict())
    for dt, model in (("f32", m32), ("bf16", mbf)):
        where = f"{fam} stage-2 {dt} train step (batch {z_in.shape[0]}, out_tw {cfg.out_tw})"
        gk, fwd, bwd = _step_grads(model, z_in, z_out, True, *cond)
        gp, fwd_p, _ = _step_grads(model, z_in, z_out, False, *cond)
        gq, _, _ = _step_grads(model, z_in * (1 + (2 ** -23 if dt == "f32" else 2 ** -8)), z_out,
                               False, *cond)
        if dt == "f32":
            g32 = gp
        _hold_gradients(where, dt, gk, gp, gq, g32)
        top = {k: g.abs().max().item() for k, g in gk.items()}
        low = min(top, key=top.get)
        _check(all(v > 0 for v in top.values()),
               f"{where}: all {len(top)} parameter tensors have a nonzero gradient (smallest "
               f"max|g| {top[low]:.3e}, {low})")
        _check(fwd == per_step and bwd == 0 and fwd_p == 0,
               f"{where}: kernel 3 launched {fwd} times in the forward (== {per_step}, out_tw "
               f"{cfg.out_tw}), {bwd} in its backward, {fwd_p} on the plain path")
    return batch


def drive_family_stage2(fam, dev, smi, tmp, ae_path):
    """The stage-2 trainer of family `fam` at full width on the card, on its
    stage-1 phase's final checkpoint: the encode pre-pass's launches, one
    train step's gradients against the plain path, a timed run with its
    launch counts and falling losses, and a trainer resumed from its final
    checkpoint. Returns the kernels' launches over the pre-pass and the
    run."""
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.train.stage2 import Stage2Trainer

    spec = FAMILIES[fam]
    t_phase = time.perf_counter()
    epochs, batch = spec["epochs"][1], spec["batch"]
    cfg = spec["config"](tmp, epochs=epochs, pretrained_checkpoint_path=ae_path,
                         log_dir=os.path.join(tmp, "s2"), **spec["s2"])
    print(f"-- {fam} stage-2 training: the stage-1 checkpoint, batch {batch}, out_tw "
          f"{cfg.out_tw}, {epochs} epochs, lr {cfg.learning_rate:g}, bf16 activations",
          flush=True)
    counted = _counted()
    base = _launches(counted)
    t0 = time.perf_counter()
    trainer = Stage2Trainer(cfg, seed=1234, use_wandb=False, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prepass = _launches(counted, base)
    frames = trainer.train_ds.fields.shape[0] * trainer.train_ds.fields.shape[1]
    encodes = -(-frames // 32)  # the pre-pass's calls of 32 frames
    want = expected_launches(cfg, n_chunks=0, encodes=encodes)
    _check(all(prepass[k] == want.get(k, 0) for k in prepass) and prepass["group_norm"] > 0,
           f"{fam} stage-2 encode pre-pass: group_norm launched {prepass['group_norm']} times "
           f"(== {want['group_norm'] // encodes} encoder GN sites x {encodes} encode calls), no "
           f"other kernel; trainer built in {build_s:.2f} s ({len(trainer.train_ds)} windows, "
           f"{trainer.steps_per_epoch} steps per epoch)")
    _check(_same_state(trainer.model.autoencoder, ae_path),
           f"{fam} stage-2: the stage-1 checkpoint loaded bit-identical")
    m32 = LatentDynamics(cfg, device=dev)
    m32.load_state_dict(trainer.model.state_dict())
    z_in, z_out, *cond = check_family_stage2_gradients(fam, trainer, m32)
    del m32

    step_events, val_ms, launches, secs = _timed_train(trainer)
    n_steps = epochs * trainer.steps_per_epoch
    n_val = len(trainer.val_ds)
    steps = trainer.val_ds.eval_trajectories()[1].shape[1]
    want = {k: 2 * v * -(-n_val // 8)
            for k, v in expected_launches(cfg, n_chunks=1, steps=steps).items()}
    want["group_norm"] += n_steps * train_step_gn(cfg)
    _check(launches == {k: want.get(k, 0) for k in launches},
           f"{fam} stage-2 training run: launches {({k: v for k, v in launches.items() if v})} "
           f"== {({k: v for k, v in want.items() if v})} (2 validations of {n_val} cases"
           f"{', each with its parameter' if cond else ''}, {n_steps} train steps)")
    print(f"      {fam} stage-2 launches per train step: group_norm {train_step_gn(cfg)}",
          flush=True)
    _check_family_run(f"{fam} stage-2", cfg.log_dir, "loss",
                      ("val_seq_rel_l2",) + tuple(f"val_pred_loss_{c}" for c in spec["channels"]),
                      trainer.steps_per_epoch, epochs)
    ckpt = os.path.join(cfg.log_dir, "checkpoints")
    resumed = Stage2Trainer(cfg.replace(log_dir=os.path.join(tmp, "s2_resumed"),
                                        resume_training=True,
                                        resume_ckpt=os.path.join(ckpt, "model_final.pt")),
                            seed=1234, use_wandb=False, device=dev)
    opt_steps = {int(st["step"].item()) for st in resumed.opt.state_dict()["state"].values()}
    _check(resumed.start_epoch == epochs and opt_steps == {n_steps}
           and resumed.sched.last_epoch == n_steps
           and _same_state(resumed.model, os.path.join(ckpt, "model_final.pt")),
           f"{fam} stage-2: a trainer resumed from model_final restores epoch "
           f"{resumed.start_epoch} (== {epochs}), optimizer steps {sorted(opt_steps)} and "
           f"schedule step {resumed.sched.last_epoch} (== {n_steps}), and its parameters "
           "equal the saved ones bitwise")
    del resumed
    evaluated = check_evaluate(f"{fam} stage-2", cfg, ckpt, dev, smi)
    profile_device(lambda: [trainer.train_step(z_in, z_out, 0, i, *cond) for i in range(3)],
                   f"{fam} stage-2 3 train steps (bf16, batch {batch})")
    del trainer
    _print_steps(f"{fam} stage-2", step_events, secs, batch, smi)
    print(f"      {fam} stage-2 validate ({n_val} cases, {steps} steps, decoded at once): wall "
          f"{', '.join(f'{v:.1f}' for v in val_ms)} ms; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {k: prepass[k] + launches[k] for k in launches}, evaluated


# -- phase 8: the entry points around training, data parallelism ---------------

def check_evaluate(where, cfg, ckpt_dir, dev, smi, f32=False):
    """``evaluate_checkpoint`` (``lns_tpu_torch.cli.evaluate``) on the run's
    ``model_best.pt``, kernels 1-3 in the trainer's dtype: every metric key,
    ``seq_rel_l2`` equal to ``meta_best.json``'s ``val_seq_rel_l2`` (one
    scoring function on the same weights), launches as one validation's;
    frames/s of a second, timed evaluate of the loaded model. With `f32`,
    the same weights in f32 scored on the kernel path and on the plain path,
    every number within 3e-4 (relative). Returns the launches of the
    evaluate call."""
    from lns_tpu_torch.cli.evaluate import evaluate_checkpoint, evaluate_model, load_model
    from lns_tpu_torch.train.stage2 import STAGE2_DATASETS

    path = os.path.join(ckpt_dir, "model_best.pt")
    with open(os.path.join(ckpt_dir, "meta_best.json")) as f:
        best = json.load(f)
    counted = _counted()
    base = _launches(counted)
    metrics = evaluate_checkpoint(cfg, path, device=dev)
    launches = _launches(counted, base)
    n, steps = metrics["num_trajectories"], metrics["rollout_steps"]
    want = {k: 0 for k in launches}
    for i in range(0, n, 8):  # evaluate's predict batches
        chunks = -(-min(8, n - i) * steps // cfg.decode_chunk) if cfg.decode_chunk else 1
        for k, v in expected_launches(cfg, n_chunks=chunks, steps=steps).items():
            want[k] = want.get(k, 0) + v
    keys = {"rollout_steps", "num_trajectories", "seq_rel_l2_per_channel", "seq_rel_l2",
            "frame_rel_l2_vs_time", "training_best_checkpoint"}
    _check(metrics.keys() == keys and metrics["seq_rel_l2"] == best["val_seq_rel_l2"]
           and metrics["training_best_checkpoint"] == best and launches == want,
           f"{where} evaluate_checkpoint(model_best.pt): seq_rel_l2 {metrics['seq_rel_l2']!r} == "
           f"meta_best.json's val_seq_rel_l2 {best['val_seq_rel_l2']!r} (epoch {best['epoch']}), "
           f"{n} trajectories x {steps} steps, the JAX CLI's keys, launches "
           f"{({k: v for k, v in launches.items() if v})} == one validation's")
    model = load_model(cfg, path, dev)
    val_ds = STAGE2_DATASETS[cfg.workload](cfg, train_mode=False)
    evaluate_model(model, val_ds, dev, 8, cfg.decode_chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_model(model, val_ds, dev, 8, cfg.decode_chunk)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"      {where} evaluate: {n * steps} frames in {secs * 1e3:.1f} ms, "
          f"{n * steps / secs:.1f} frames/s (host clock over evaluate_model after one untimed "
          f"call: predict in batches of 8, denormalise, score; bf16, kernels 1-3); {smi}",
          flush=True)
    del model
    if f32:
        m32 = load_model(cfg.replace(mixed_precision=False), path, dev)
        kern = evaluate_model(m32, val_ds, dev, 8, cfg.decode_chunk)
        plain = evaluate_model(m32.use_kernels(False), val_ds, dev, 8, cfg.decode_chunk)
        worst = max(abs(a - b) / abs(b) for k in ("seq_rel_l2_per_channel", "seq_rel_l2",
                                                  "frame_rel_l2_vs_time")
                    for a, b in zip(*(([m[k]] if isinstance(m[k], float) else m[k])
                                      for m in (kern, plain))))
        _check(worst <= 3e-4, f"{where} evaluate in f32, kernel path against the plain path: "
               f"largest relative difference over every metric {worst:.3e} <= 3e-4 "
               f"(seq_rel_l2 {kern['seq_rel_l2']:.6f} / {plain['seq_rel_l2']:.6f})")
        del m32
    return launches


def check_msgpack_round_trip(where, cfg, tmp, *kind_paths):
    """``.pt -> .msgpack -> .pt`` through ``lns_tpu_torch.cli.convert`` on
    this machine: every parameter back bitwise, the rotary frequencies (a
    constant the JAX tree does not hold) as ``torch_export`` computes them;
    no flax, msgpack or JAX module imported on the way."""
    import importlib.util

    import numpy as np

    from lns_tpu_torch.cli.convert import convert
    from lns_tpu_torch.utils.convert import key_table

    for kind, src in kind_paths:
        mid, back = (os.path.join(tmp, f"round_trip_{kind}.{e}") for e in ("msgpack", "pt"))
        convert(cfg, src, mid, kind)
        convert(cfg, mid, back, kind)
        a, b = (torch.load(p, weights_only=True) for p in (src, back))
        rotary = {e.key: e.dim for e in key_table(cfg, kind) if e.path is None}
        params = [k for k in a if k not in rotary]
        _check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in params)
               and all(np.array_equal(b[k].numpy(), 1.0 / (10000 ** (
                   np.arange(0, d, 2, dtype=np.float32) / d))) for k, d in rotary.items()),
               f"{where}: {os.path.basename(src)} -> .msgpack ({os.path.getsize(mid)} bytes) -> "
               f".pt ({kind}): {len(params)} parameter tensors bitwise, {len(rotary)} rotary "
               "buffers recomputed")
    found = {m: importlib.util.find_spec(m) is not None for m in ("flax", "msgpack", "jax")}
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("flax", "msgpack", "jax"))
    _check(not loaded, f"{where}: the conversion imported none of flax, msgpack, jax "
           f"(installed here: {found})")


# the data-parallel phase's corpus: 16 synthetic 64x64 cases of 10 frames
# (the NS2d split: 14 training cases, 2 validation cases). Stage 2: 112
# windows, 3 steps of the global batch 32 and a 9-step validation rollout;
# stage 1: 140 frames, 5 steps of batch 32 (the last of 12)
DDP_CASES, DDP_CASE_LEN, DDP_BATCH = 16, 10, 32

# one rank of a multi-rank run (``check_ranks``): argv[1] is a JSON spec
# (cfg, out, device, init). It trains stage 2, saves its parameters and, on
# the card, times 10 steps and profiles one on its rows of one global batch
# (rank 0 writes out/timing.json)
_RANK_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import chip_smoke
from lns_tpu_torch.config import Config
from lns_tpu_torch.parallel import ddp
from lns_tpu_torch.train import checkpoint
from lns_tpu_torch.train.stage2 import Stage2Trainer

spec = json.loads(sys.argv[1])
dev = ddp.init_from_env(spec["device"], init_method=spec["init"])
cfg = Config(spec["cfg"])
trainer = Stage2Trainer(cfg, seed=1234, use_wandb=False, device=dev)
trainer.train()
torch.save(checkpoint.state_dict_cpu(trainer.model),
           os.path.join(spec["out"], f"rank{ddp.rank()}.pt"))
if dev.type == "cuda":
    rows = ddp.shard_rows(np.arange(cfg.batch_size), ddp.rank(), ddp.world_size())
    batch = tuple(torch.from_numpy(a).to(dev) for a in trainer.train_ds.get_batch(rows)) + (0, 0)
    ms = chip_smoke._step_ms(trainer, batch)
    busy, ops, nccl = chip_smoke._profile_step(trainer, batch)
    if ddp.is_main():
        with open(os.path.join(spec["out"], "timing.json"), "w") as f:
            json.dump(dict(ms=ms, busy=busy, ops=ops, nccl=nccl), f)
ddp.shutdown()
"""


def check_ranks(tmp, cfg, world, ref_loss, smi, device=None):
    """`world` ranks of stage-2 training on `cfg` (``_RANK_WORKER``: one
    process per card over NCCL, or over gloo with ``device="cpu"``; a
    ``file://`` rendezvous): every rank exits 0, their final parameters
    are bitwise equal, and each step's loss (the mean over the ranks) is
    within 1e-2 (relative) of `ref_loss`, one process's over the same
    global batches (bf16: each rank's convs run at batch / world). Prints
    rank 0's step ms and its NCCL kernels in one profiled step."""
    ranks, log = os.path.join(tmp, f"ranks{world}"), os.path.join(tmp, f"world{world}")
    os.makedirs(ranks)
    spec = json.dumps(dict(cfg=cfg.replace(log_dir=log).to_dict(), out=ranks, device=device,
                           init="file://" + os.path.join(tmp, f"rendezvous{world}")))
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_WORKER, spec], cwd=root,
                              env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                                       LOCAL_RANK=str(r), PYTHONPATH=root))
             for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    finals = [torch.load(os.path.join(ranks, f"rank{r}.pt"), weights_only=True)
              for r in range(world) if codes[r] == 0]
    loss = []
    if os.path.exists(os.path.join(log, "metrics.jsonl")):
        with open(os.path.join(log, "metrics.jsonl")) as f:
            loss = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    worst = max((abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)), default=float("inf"))
    _check(codes == [0] * world and len(finals) == world
           and all(torch.equal(v, f[k]) for f in finals[1:] for k, v in finals[0].items())
           and len(loss) == len(ref_loss) and worst <= 1e-2,
           f"{world} ranks over {'gloo' if device == 'cpu' else 'NCCL'}: exit codes {codes}, the "
           f"ranks' final parameters bitwise equal, {len(loss)} step losses within {worst:.2e} "
           f"(<= 1e-2, relative) of one process's over the same global batches ({loss} / "
           f"{ref_loss})")
    timing = os.path.join(ranks, "timing.json")
    if os.path.exists(timing):
        with open(timing) as f:
            t = json.load(f)
        print(f"      {world} ranks, stage-2 train step (bf16, global batch {cfg.batch_size}, "
              f"{cfg.batch_size // world} per rank, 10 steps on one batch, median by CUDA "
              f"events on rank 0): {t['ms']:.3f} ms; one profiled step on rank 0: device busy "
              f"{t['busy']:.3f} ms in {t['ops']} device ops, NCCL kernels "
              f"{sum(r[0] for r in t['nccl']):.4f} ms in {sum(r[1] for r in t['nccl'])} launches "
              f"({'; '.join(f'{r[2][:60]} {r[0]:.4f} ms' for r in t['nccl']) or 'none'}); {smi}",
              flush=True)


def _ddp_run(cls, cfg, dev):
    """One epoch of trainer `cls` on `cfg`, timed (``_timed_train``); returns
    (trainer, step events, launches, losses)."""
    trainer = cls(cfg, seed=1234, use_wandb=False, device=dev)
    events, _, launches, _ = _timed_train(trainer)
    key = "loss" if hasattr(trainer, "sched") else "rec_loss"
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        loss = [r[key] for r in map(json.loads, f) if key in r]
    return trainer, events, launches, loss


@contextlib.contextmanager
def world_one(dev, tmp):
    """A process group of world size 1 over NCCL on `dev` for the block
    (torchrun's variables set, a ``file://`` rendezvous under `tmp`),
    checked on entry; left, and the variables removed, on exit."""
    from lns_tpu_torch.parallel import ddp

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        rank_dev = ddp.init_from_env(dev, init_method="file://" + os.path.join(tmp, "rendezvous"))
        _check(ddp.distributed() and torch.distributed.get_backend() == "nccl"
               and ddp.world_size() == 1 and rank_dev == torch.device("cuda", 0),
               f"init_from_env: NCCL process group of world size {ddp.world_size()} on "
               f"{rank_dev}")
        yield rank_dev
    finally:
        ddp.shutdown()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k, None)
    _check(not ddp.distributed(), "the process group is shut down after the phase")


def _bitwise(a, b):
    """Two runs' losses and final parameters equal, bitwise."""
    sa, sb = a[0].model.state_dict(), b[0].model.state_dict()
    return a[3] == b[3] and sa.keys() == sb.keys() and all(torch.equal(v, sb[k])
                                                           for k, v in sa.items())


def _median_ms(events):
    ms = sorted(s.elapsed_time(e) for s, e in events)
    return ms[len(ms) // 2]


def _step_ms(trainer, batch, n=10):
    """Median ms of `n` train steps on one batch, each by CUDA events."""
    events = []
    for _ in range(n):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        trainer.train_step(*batch)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return _median_ms(events)


def _profile_step(trainer, batch):
    """One profiled train step: (device busy ms, device ops, [(ms, calls,
    name)] of its NCCL kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    return (sum(r[0] for r in rows), sum(r[1] for r in rows),
            [r for r in rows if "nccl" in r[2].lower()])


_PREDICT_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import chip_smoke
from lns_tpu_torch.parallel import ddp

spec = json.loads(sys.argv[1])
dev = ddp.init_from_env("cuda", init_method=spec["init"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for label in chip_smoke.SHARDED_PATHS:
    model, x, cond, steps, chunk = chip_smoke.sharded_case(label, dev)
    y = ddp.sharded_predict(model, x, steps, cond, decode_chunk=chunk)
    if ddp.is_main():
        np.save(os.path.join(spec["out"], label.split()[1] + ".npy"), y.cpu().numpy())
    del model, y
ddp.shutdown()
"""


def sharded_case(label, dev):
    """Path `label`'s model (f32, initialised from a seeded generator on
    the CPU, then moved to `dev`) and its predict's input: (model, x,
    cond, steps, decode chunk); the same in every process."""
    from lns_tpu_torch.config import ns2d_config, sw_config, twophase_conditional_config
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_

    cfg, (b, steps, chunk) = {
        "path 1 NS2d": (ns2d_config(), (BATCH, STEPS, CHUNK)),
        "path 3 SW": (sw_config(), (SW_BATCH, SW_STEPS, None)),
        "path 5 conditional two-phase": (twophase_conditional_config(),
                                         (TP_BATCH, TP_STEPS, None))}[label]
    gen = torch.Generator().manual_seed(21)
    model = init_weights_(LatentDynamics(cfg, device="cpu"), gen)
    if cfg.is_conditional:
        _open_gates(model, gen)
    x = torch.randn(b, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen)
    cond = torch.rand(b, generator=gen).to(dev) if cfg.is_conditional else None
    return model.to(dev).eval(), x.to(dev), cond, steps, chunk


def check_sharded_ranks(tmp, world, smi):
    """``sharded_predict`` on `world` ranks over NCCL (``_PREDICT_WORKER``,
    one process per card) at paths 1, 3 and 5's batch and steps, f32:
    every rank exits 0 and rank 0's global result is within 1e-3 x max|ref|
    of one process's ``model.predict`` (each rank runs batch / world rows,
    so a convolution may take another algorithm); bitwise equality is
    printed, not required."""
    import numpy as np

    out = os.path.join(tmp, f"predict{world}")
    os.makedirs(out)
    spec = json.dumps(dict(out=out, init="file://" + os.path.join(tmp, f"predict_rdv{world}")))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _PREDICT_WORKER, spec], cwd=root,
                              env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                                       LOCAL_RANK=str(r), PYTHONPATH=root))
             for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    _check(codes == [0] * world, f"sharded_predict on {world} ranks: exit codes {codes}")
    for label in SHARDED_PATHS:
        path = os.path.join(out, label.split()[1] + ".npy")
        if not os.path.exists(path):
            continue
        model, x, cond, steps, chunk = sharded_case(label, torch.device("cuda", 0))
        ref = model.predict(x, steps, cond, decode_chunk=chunk).cpu()
        y = torch.from_numpy(np.load(path))
        err = (y - ref).abs().max().item() / ref.abs().max().item()
        _check(y.shape == ref.shape and err <= 1e-3,
               f"{label}: sharded_predict on {world} ranks (f32, B{x.shape[0]} x {steps} steps, "
               f"{x.shape[0] // world} rows a rank) against one process: {err:.3e} x max|ref| "
               f"(<= 1e-3), {'bitwise equal' if torch.equal(y, ref) else 'not bitwise equal'}")
        del model
    print(f"      sharded predict on {world} ranks: {wall:.1f} s of wall for the three paths "
          f"(processes, builds and predicts); {smi}", flush=True)


def drive_ranks(dev, smi, worlds=(2, 4)):
    """``python3 chip_smoke.py --ranks``: on a machine with several cards,
    one plain stage-2 run of phase 8's configuration, then ``check_ranks``
    and ``check_sharded_ranks`` at each world size in `worlds` that the
    cards allow."""
    import tempfile

    from lns_tpu_torch.train.stage2 import Stage2Trainer

    with tempfile.TemporaryDirectory() as tmp:
        _, s2 = ddp_configs(tmp)
        _, events, _, losses = _ddp_run(Stage2Trainer, s2.replace(log_dir=os.path.join(tmp, "one")),
                                        dev)
        print(f"-- {DDP_CASES} cases x {DDP_CASE_LEN} frames, global batch {DDP_BATCH}, bf16: one "
              f"process's step losses {losses}, step median {_median_ms(events):.3f} ms; {smi}",
              flush=True)
        for world in worlds:
            if world <= torch.cuda.device_count():
                t0 = time.perf_counter()
                check_ranks(tmp, s2, world, losses, smi)
                print(f"      {world} ranks: {time.perf_counter() - t0:.1f} s of wall", flush=True)
                check_sharded_ranks(tmp, world, smi)


def ddp_configs(tmp):
    """The data-parallel phase's NS2d configs on a synthetic corpus under
    `tmp`: stage 1, and stage 2 (input noise 0.01) on a seeded AE saved as
    a stage-1 ``.pt``; bf16, one epoch."""
    from lns_tpu_torch.config import ns2d_config
    from lns_tpu_torch.data.synthetic import make_ns2d_npz
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_
    from lns_tpu_torch.train import checkpoint

    base = ns2d_config().replace(
        data_dir=make_ns2d_npz(os.path.join(tmp, "ns2d.npz"), ncase=DDP_CASES,
                               case_len=DDP_CASE_LEN, h=64, w=64),
        case_len=DDP_CASE_LEN, num_case=DDP_CASES, dataset_stat=os.path.join(tmp, "stat.npz"),
        batch_size=DDP_BATCH, epochs=1, learning_rate=5e-4, mixed_precision=True,
        ckpt_every=1, decode_chunk=CHUNK, overwrite_exist=True)
    ae = init_weights_(LatentDynamics(base, device="cpu"), torch.Generator().manual_seed(3))
    ae_path = os.path.join(tmp, "ae.pt")
    checkpoint.save(checkpoint.state_dict_cpu(ae.vq_ae), ae_path)
    return base, base.replace(pretrained_checkpoint_path=ae_path, noise_level=0.01)


def drive_ddp(dev, smi):
    """Data-parallel training at world size 1 over NCCL (a ``file://``
    rendezvous) at full NS2d width, bf16, batch 32, one epoch per run.
    Two plain stage-2 runs first: where they are not bitwise alike (a
    cuDNN algorithm with atomics), the comparisons below run on cuDNN's
    deterministic algorithms, and the line says so. Checks: the host
    path's side-stream prefetch gives the device_data path's losses,
    parameters and launches bitwise; under the process group each
    trainer's loss module is a ``DistributedDataParallel`` and its losses,
    parameters and launches equal the plain trainer's, bitwise, in both
    stages. Prints the step ms of both (10 steps each on one batch, plain,
    DDP, DDP, plain) and one profiled step of each: device busy ms, device
    ops and the NCCL kernels. With two or more cards, two ranks as well.
    Returns the launches of each run."""
    import tempfile

    import numpy as np
    from torch.nn.parallel import DistributedDataParallel

    from lns_tpu_torch.train.stage1 import Stage1Trainer
    from lns_tpu_torch.train.stage2 import Stage2Trainer

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base, s2 = ddp_configs(tmp)
        print(f"-- data parallelism: {DDP_CASES} cases x {DDP_CASE_LEN} frames of 64x64, batch "
              f"{DDP_BATCH}, bf16, one epoch per run (stage 2 with input noise 0.01)", flush=True)

        def run(cls, cfg, label):
            return _ddp_run(cls, cfg.replace(log_dir=os.path.join(tmp, label)), dev)

        plain2, again = run(Stage2Trainer, s2, "plain2"), run(Stage2Trainer, s2, "again")
        repeatable = _bitwise(plain2, again)
        print(f"      two plain stage-2 runs on cuDNN's default algorithms: losses and parameters "
              f"{'bitwise equal' if repeatable else 'NOT bitwise equal'} (losses {plain2[3]} / "
              f"{again[3]}); the comparisons below on cuDNN's "
              f"{'default' if repeatable else 'deterministic'} algorithms", flush=True)
        del again
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic or not repeatable
        try:
            if not repeatable:
                plain2 = run(Stage2Trainer, s2, "plain2_deterministic")
            on_dev = run(Stage2Trainer, s2.replace(device_data=True), "device2")
            _check(_bitwise(plain2, on_dev) and plain2[2] == on_dev[2],
                   f"host path with side-stream prefetch against device_data over one epoch "
                   f"({len(plain2[3])} steps): losses, parameters and launches bitwise equal")
            out["stage-2 training, host path with prefetch"] = plain2[2]
            out["stage-2 training, device_data"] = on_dev[2]
            del on_dev
            plain1 = run(Stage1Trainer, base, "plain1")
            with world_one(dev, tmp):
                for stage, plain, cls, cfg in ((2, plain2, Stage2Trainer, s2),
                                               (1, plain1, Stage1Trainer, base)):
                    par = run(cls, cfg, f"ddp{stage}")
                    module = par[0].loss_module if stage == 2 else par[0].ddp_model
                    _check(isinstance(module, DistributedDataParallel) and _bitwise(plain, par)
                           and par[2] == plain[2],
                           f"stage-{stage} DDP at world size 1 against the plain trainer over "
                           f"the same {len(par[3])} batches: losses and parameters bitwise "
                           f"equal, launches {({k: v for k, v in par[2].items() if v})} "
                           "unchanged")
                    out[f"stage-{stage} training, DDP world size 1"] = par[2]
                    rows = par[0].train_ds.get_batch(np.arange(DDP_BATCH))
                    batch = ((tuple(torch.from_numpy(a).to(dev) for a in rows) + (0, 0))
                             if stage == 2 else (torch.from_numpy(rows).to(dev),))
                    ms = {"plain": [], "DDP": []}
                    for who in ("plain", "DDP", "DDP", "plain"):
                        ms[who].append(_step_ms((plain if who == "plain" else par)[0], batch))
                    prof = {who: _profile_step(t[0], batch) for who, t in (("plain", plain),
                                                                           ("DDP", par))}
                    nccl = prof["DDP"][2]
                    print(f"      stage-{stage} train step (bf16, batch {DDP_BATCH}, 10 steps on "
                          "one batch, median by CUDA events; rounds plain, DDP, DDP, plain): "
                          f"DDP world 1 {', '.join(f'{v:.3f}' for v in ms['DDP'])} ms, plain "
                          f"{', '.join(f'{v:.3f}' for v in ms['plain'])} ms; the runs' own "
                          f"steps {_median_ms(par[1]):.3f} / {_median_ms(plain[1]):.3f} ms (n="
                          f"{len(par[1])}); one profiled step: DDP device busy "
                          f"{prof['DDP'][0]:.3f} ms in {prof['DDP'][1]} device ops, plain "
                          f"{prof['plain'][0]:.3f} ms in {prof['plain'][1]}; NCCL kernels "
                          f"{sum(r[0] for r in nccl):.4f} ms in {sum(r[1] for r in nccl)} "
                          f"launches ({'; '.join(f'{r[2][:60]} {r[0]:.4f} ms' for r in nccl) or 'none'}"
                          f"); {smi}", flush=True)
                    del par
        finally:
            torch.backends.cudnn.deterministic = deterministic
        ref_loss = plain2[3]
        del plain1, plain2
        if torch.cuda.device_count() >= 2:
            check_ranks(tmp, s2, 2, ref_loss, smi)
        else:
            print(f"      two ranks not run: {torch.cuda.device_count()} card here, two needed",
                  flush=True)
    print(f"      data-parallel phase wall {time.perf_counter() - t_phase:.1f} s; {smi}",
          flush=True)
    return out


# -- path 6 (the Fourier layers), path 7 (the conditional encoder) and the
# library blocks --------------------------------------------------------------

def fourier_config():
    """Path 6: NS2d with the autoencoder's Fourier layers, the two switches of
    the shipped autoencoder: ``fourier_resolutions`` [64, 32] puts a
    ``FourierBasicBlock`` after the encoder's 64x64 (c64, modes 10x10) and
    32x32 (c64, modes 6x6) levels, ``final_smoothing`` one after the
    decoder's last 3x3 conv (64x64, c64, modes 16x16)."""
    from lns_tpu_torch.config import ns2d_config

    return ns2d_config().replace(final_smoothing=True, fourier_resolutions=[64, 32])


def check_fourier(dev, smi):
    """Path 6 beyond its predict (``drive_path``): the f32 decode of two
    latents on the card (cuFFT) against the same model on the CPU (pocketfft)
    within 3e-4; one decode chunk of CHUNK frames profiled in bf16 (the
    FFTs' share of its device time); one stage-1 train step's gradients at
    batch BATCH, kernel path against the plain path (``check_stage1_step``:
    its launches, f32 and bf16 rules, every parameter's gradient nonzero,
    the spectral banks' through ``torch.fft`` among them)."""
    from lns_tpu_torch.models import SimpleAutoencoder
    from lns_tpu_torch.ops.initializers import init_weights_

    t0 = time.perf_counter()
    cfg = fourier_config()
    gen = torch.Generator().manual_seed(6)
    print("-- path 6 NS2d Fourier layers: decode on the card against the CPU, a profiled "
          f"decode chunk of {CHUNK} frames, one stage-1 train step (batch {BATCH})", flush=True)
    cpu = init_weights_(SimpleAutoencoder(cfg), gen)
    z = torch.randn(2, cfg.latent_resolution, cfg.latent_resolution, cfg.latent_dim,
                    generator=gen)
    m32 = SimpleAutoencoder(cfg).to(dev)
    m32.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        ref = cpu.use_kernels(False).decode(z)
        out = m32.decode(z.to(dev)).cpu()
    err = (out - ref).abs().max().item()
    _check(tuple(out.shape) == (2, cfg.Ly, cfg.Lx, cfg.in_channels) and err <= 3e-4,
           f"path 6: f32 decode of 2 latents, the card (kernels, cuFFT) against the CPU (plain, "
           f"pocketfft): max_abs_err {err:.3e} <= 3e-4")
    # each Fourier layer at the batch the predict gives it (the encoder's
    # BATCH frames, a decode chunk's CHUNK), f32, the card against the CPU
    for part, batch in (("encoder", BATCH), ("decoder", CHUNK)):
        for i, spec in enumerate(getattr(cpu, part).specs):
            if spec.kind != "fourier":
                continue
            res = cfg.resolution >> sum(s.kind == "down" for s in getattr(cpu, part).specs[:i])
            c = spec.kw["in_planes"]
            xf = torch.randn(batch, res, res, c, generator=gen).movedim(-1, 1)
            with torch.no_grad():
                want = getattr(cpu, part).model[i](xf)
                got = getattr(m32, part).model[i](xf.to(dev)).cpu()
            err = (got - want).abs().max().item() / want.abs().max().item()
            _check(err <= 1e-5, f"path 6: {part} Fourier layer {i} ({batch}x{res}x{res}x{c}, "
                   f"modes {spec.kw['modes']}), f32, the card against the CPU: max_abs_err "
                   f"{err:.2e} x max|cpu| (<= 1e-5)")
    model = SimpleAutoencoder(cfg, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(cpu.state_dict())
    zc = torch.randn(CHUNK, cfg.latent_resolution, cfg.latent_resolution, cfg.latent_dim,
                     generator=gen).to(dev, torch.bfloat16)
    with torch.no_grad():
        model.decode(zc)  # warm-up: cuFFT plans
        prof = profile_device(lambda: model.decode(zc), f"path 6 decode chunk of {CHUNK} frames")
    if prof:
        print(f"      path 6 decode chunk of {CHUNK} frames (bf16, kernel path): FFTs "
              f"{prof['fft_ms']:.3f} ms of {prof['busy_ms']:.3f} ms device busy "
              f"({prof['fft_ms'] / prof['busy_ms']:.1%}); {smi}", flush=True)
    x = torch.randn(BATCH, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
    check_stage1_step("path 6 NS2d Fourier layers", model, m32, x)
    print(f"      path 6 checks took {time.perf_counter() - t0:.1f} s", flush=True)


def _cond_ae_grads(model, x, p, target, use_kernel):
    """The mean square reconstruction error of frames x under parameters p
    and its gradient w.r.t. every parameter, on the kernel path or the
    plain path."""
    model.use_kernels(use_kernel)
    params = dict(model.named_parameters())
    loss = (model(x, p).float() - target).square().mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    model.use_kernels(True)
    return dict(zip(params, grads))


def drive_cond_encoder(dev, smi):
    """Path 7: ``ConditionalSimpleAutoencoder`` on ``twophase_conditional_config()``
    (61x121x4 -> 7x15x64, a 64-wide parameter embedding; its encoder of
    ``CondResidualBlock``s conditioned on each sample's parameter, the
    two-phase decoder), weights from a seeded generator with the
    zero-initialised conv2 of every block filled too (``_open_gates``).
    At batch BATCH in bf16: one forward and backward with the launch counts
    set to 0 before and read after (kernel 3 at every GroupNorm of the
    forward, nothing in the backward), shapes, finite values and a nonzero
    gradient for every parameter; the f32 forward at batch 2, kernel path
    against the plain path, within 3e-4; the gradients at batch BATCH,
    kernel path against the plain path (f32 and bf16, ``_hold_gradients``'
    rules); kernel 3 at each of the encoder's GroupNorm sites against its
    plain version (``check_cond_group_norm``); forward-and-backward ms of
    both paths. Returns the launches and kernel 3's result at the
    encoder's sites."""
    from lns_tpu_torch.config import twophase_conditional_config
    from lns_tpu_torch.models import ConditionalSimpleAutoencoder
    from lns_tpu_torch.ops import norms
    from lns_tpu_torch.ops.initializers import init_weights_

    t0 = time.perf_counter()
    cfg = twophase_conditional_config()
    gen = torch.Generator().manual_seed(7)
    label = "path 7 conditional encoder"
    print(f"-- {label}: ConditionalSimpleAutoencoder, {cfg.Ly}x{cfg.Lx}x{cfg.in_channels} -> "
          f"{cfg.latent_resolution}x15x{cfg.latent_dim}, embedding {cfg.cond_emb_channels}, "
          f"batch {BATCH}, bf16, forward and backward", flush=True)
    cpu = _open_gates(init_weights_(ConditionalSimpleAutoencoder(cfg), gen), gen)
    model = ConditionalSimpleAutoencoder(cfg, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(cpu.state_dict())
    m32 = ConditionalSimpleAutoencoder(cfg).to(dev)
    m32.load_state_dict(cpu.state_dict())
    x = torch.randn(BATCH, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
    p = torch.rand(BATCH, generator=gen).to(dev)
    n_blocks = (len(cfg.encoder_channels) - 1) * cfg.encoder_res_blocks + 1
    enc_gn = 2 * n_blocks + 1  # norm1 and norm2 per block, to_out's GN(32)
    want = enc_gn + expected_launches(cfg, n_chunks=1, encodes=0)["group_norm"]

    counted = _counted()
    base = _launches(counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = model(x, p)
    fwd = _launches(counted, base)
    loss = (y.float() - x).square().mean()
    loss.backward()
    torch.cuda.synchronize()
    launches = _launches(counted, base)
    peak = torch.cuda.max_memory_allocated()
    _check(tuple(y.shape) == tuple(x.shape) and bool(torch.isfinite(y).all())
           and math.isfinite(loss.item()),
           f"{label}: output {tuple(y.shape)} finite, loss {loss.item():.4f}")
    _check(fwd == {k: (want if k == "group_norm" else 0) for k in counted} and launches == fwd,
           f"{label}: launches in the forward {({k: v for k, v in fwd.items() if v})} == "
           f"group_norm {want} ({enc_gn} in the encoder: 2 per CondResidualBlock x {n_blocks} "
           "+ to_out's GN(32)), in the backward "
           f"{sum(launches.values()) - sum(fwd.values())}")
    top = {k: q.grad.abs().max().item() for k, q in model.named_parameters()}
    low = min(top, key=top.get)
    _check(all(math.isfinite(v) and v > 0 for v in top.values()),
           f"{label}: all {len(top)} parameter tensors have a finite nonzero gradient "
           f"(smallest max|g| {top[low]:.3e}, {low}); peak device memory "
           f"{peak / 2**30:.3f} GiB")
    model.zero_grad(set_to_none=True)

    with torch.no_grad():
        yk = m32.use_kernels(True)(x[:2], p[:2])
        yp = m32.use_kernels(False)(x[:2], p[:2])
    m32.use_kernels(True)
    err = (yk - yp).abs().max().item()
    _check(bool(torch.isfinite(yk).all()) and err <= 3e-4,
           f"{label}: f32 forward at batch 2, kernels vs plain: max_abs_err {err:.3e} <= 3e-4")

    # the gradients, kernel path against the plain path (and the plain
    # path's own change under a one-ulp move of its input)
    g32 = None
    for dt, m, ulp in (("f32", m32, 2 ** -23), ("bf16", model, 2 ** -8)):
        gk = _cond_ae_grads(m, x, p, x, True)
        gp = _cond_ae_grads(m, x, p, x, False)
        gq = _cond_ae_grads(m, x * (1 + ulp), p, x, False)
        g32 = gp if dt == "f32" else g32
        _hold_gradients(f"{label} {dt} (batch {BATCH})", dt, gk, gp, gq, g32)
        del gk, gq

    for flag, path in ((True, "kernel path"), (False, "plain path")):
        model.use_kernels(flag)
        ms = cuda_ms(lambda: (model(x, p).float() - x).square().mean().backward(), reps=3)
        print(f"      {label} forward and backward, batch {BATCH}, bf16, {path}: {ms:.2f} ms; "
              f"{smi}", flush=True)
    model.use_kernels(True)
    model.zero_grad(set_to_none=True)

    with recording(norms, "fused_group_norm_swish") as calls, torch.no_grad():
        model.encode(x, p)
    sites = _gn_site_counts(calls, with_dtype=True)
    del calls
    _check(sum(sites.values()) == enc_gn,
           f"{label}: the encoder's GroupNorm calls found {sites} == {enc_gn}")
    res = check_cond_group_norm(dev, gen, sites, {}, label="conditional encoder",
                                per=f"forward (path 7, batch {BATCH})")
    print(f"      {label} took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, res


def _library_blocks(gen):
    """Each library block at a size a user would run, with its inputs
    (channel-first views of channels-last memory, as the paths give them):
    the library propagators on the NS2d latent (batch BATCH, 8x8x16, width
    128; ConditionalResNet 8 heads x 64 and a context of 4 tokens x 64),
    LABlock and CABlock at 16x16 c64, the FNO mixers and
    CondFourierBasicBlock at 64x64 c64 modes 16x16 (batch 8, a 64-wide
    conditioning vector), SpectralConv1d at 1,024 x c64, SpectralConv3d at
    16^3 x c32 (modes 6), SirenNet (2 -> 256 x 4 -> 64 on 256 points) and
    EmbeddingWrapper (a SIREN, a table and a linear key) at batch BATCH."""
    from lns_tpu_torch.models import ConditionalResNet, SimpleMLP, SimpleResNet
    from lns_tpu_torch.ops import attention, embedding, fno, fourier_cond, spectral

    def cl(*shape):  # [B, *spatial, C] memory as [B, C, *spatial]
        return torch.randn(*shape, generator=gen).movedim(-1, 1)

    b = BATCH
    z, ctx = torch.randn(b, 8, 8, 16, generator=gen), torch.randn(b, 4, 64, generator=gen)
    f16, f64, v = cl(b, 16, 16, 64), cl(8, 64, 64, 64), torch.randn(8, 64, generator=gen)
    emb_keys = ["coef_emb", "case_emb", "vel_emb"]
    emb_settings = [dict(encoder="siren", in_channels=2, hidden_channels=128, out_channels=64,
                         num_layers=3),
                    dict(encoder="embedding", in_channels=1, num_embeddings=16, out_channels=64),
                    dict(encoder="linear", in_channels=3, out_channels=64)]
    ctx_in = {"coef": torch.rand(b, 1, 2, generator=gen) * 2 - 1,
              "case": torch.randint(0, 16, (b, 1), generator=gen).float(),
              "vel": torch.randn(b, 3, generator=gen)}
    return [("SimpleResNet", SimpleResNet(16, 128), (z,)),
            ("ConditionalResNet", ConditionalResNet(16, 128, 64, heads=8, dim_head=64), (z, ctx)),
            ("SimpleMLP", SimpleMLP(16, 8, 128), (z,)),
            ("LABlock", attention.LABlock(64, 8, 8), (f16,)),
            ("CABlock", attention.CABlock(64, 64, 8, 8), (f16, ctx)),
            ("ResFNOMixerBlock ln", fno.ResFNOMixerBlock(64, 64, (16, 16), norm="ln"), (f64,)),
            ("ResFNOMixerBlock in", fno.ResFNOMixerBlock(64, 64, (16, 16), norm="in"), (f64,)),
            ("CondResFNOMixerBlock ln", fno.CondResFNOMixerBlock(64, 64, (16, 16), norm="ln"),
             (f64, v)),
            ("CondFourierBasicBlock", fourier_cond.CondFourierBasicBlock(64, 64, (16, 16)),
             (f64, v)),
            ("SpectralConv1d", spectral.SpectralConv1d(64, 64, 16), (cl(b, 1024, 64),)),
            ("SpectralConv3d", spectral.SpectralConv3d(32, 32, 6, 6, 6), (cl(8, 16, 16, 16, 32),)),
            ("SirenNet", embedding.SirenNet(2, 256, 64, 4), (torch.rand(b, 256, 2, generator=gen),)),
            ("EmbeddingWrapper", embedding.EmbeddingWrapper(emb_keys, emb_settings), (ctx_in,))]


def _to(a, dev, dt=None):
    """A block's input on `dev`; field inputs (not the f32 conditioning
    vectors, nor a context dict's values) cast to `dt`."""
    if isinstance(a, dict):
        return {k: v.to(dev) for k, v in a.items()}
    return a.to(dev, dt) if dt is not None and a.dim() >= 3 else a.to(dev)


def drive_library(dev, smi):
    """The library blocks (``_library_blocks``), weights from a seeded
    generator (the zero-initialised gates filled too): each in f32 on the
    card against the same block on the CPU within 1e-4 x max|cpu| (cuFFT,
    cuDNN and cuBLAS against the CPU's libraries); the blocks with a
    GroupNorm also kernel path against plain path on the card, f32, within
    1e-4 x max|plain|; then every block in bf16 (the fields cast, the
    conditioning vectors f32) with the launch counts set to 0 before and
    read after: shapes, finite values, within 5e-2 x max|f32| of the f32
    output (a sanity bound for bf16 through a few layers), kernel 3 once
    per GroupNorm module; kernel 3 at each of their GroupNorm sites against
    its plain version (``check_cond_group_norm``). Returns the launches and
    kernel 3's result at those sites."""
    import copy

    from lns_tpu_torch.ops import norms
    from lns_tpu_torch.ops.initializers import init_weights_

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(8)
    print(f"-- library blocks (batch {BATCH} unless stated): f32 card vs CPU, kernel vs plain, "
          "bf16 with launch counts", flush=True)
    blocks = []
    for name, block, args in _library_blocks(gen):
        block = _open_gates(init_weights_(block, gen), gen).eval()
        with torch.no_grad():
            ref = block(*args)
            card = copy.deepcopy(block).to(dev)
            dargs = tuple(_to(a, dev) for a in args)
            out = card(*dargs)
            err = (out.cpu() - ref).abs().max().item() / ref.abs().max().item()
            _check(out.shape == ref.shape and bool(torch.isfinite(out).all()) and err <= 1e-4,
                   f"library {name}: {tuple(out.shape)}, f32 on the card against the CPU: "
                   f"max_abs_err {err:.2e} x max|cpu| (<= 1e-4)")
            gns = sum(isinstance(m, norms.GroupNorm) for m in card.modules())
            if gns:
                for m in card.modules():
                    if hasattr(m, "use_kernel"):
                        m.use_kernel = False
                plain = card(*dargs)
                for m in card.modules():
                    if hasattr(m, "use_kernel"):
                        m.use_kernel = True
                err = (out - plain).abs().max().item() / plain.abs().max().item()
                _check(err <= 1e-4, f"library {name}: f32 on the card, kernel path ({gns} "
                       f"GroupNorms) against plain: max_abs_err {err:.2e} x max|plain| (<= 1e-4)")
        blocks.append((name, card, dargs, out, gns))

    # the library fault SpectralConv1d steps round (ops.spectral.irfft_modes):
    # cuFFT's batched 1D c2r at 2,048 transforms of 1,024 points, shown, not used
    spec = torch.randn(2048, 513, dtype=torch.complex64, generator=gen)
    spec[:, 16:] = 0
    want = torch.fft.irfft(spec, n=1024, dim=1)
    got = torch.fft.irfft(spec.to(dev), n=1024, dim=1).cpu()
    print(f"      torch.fft.irfft on the card, 2,048 x 1,024 points (16 modes): "
          f"{(got - want).abs().max().item() / want.abs().max().item():.2e} x max|cpu| from "
          "the CPU's (the port's SpectralConv1d synthesises by matmul, irfft_modes)", flush=True)

    counted = _counted()
    base = _launches(counted)
    outs = {}
    with recording(norms, "fused_group_norm_swish") as calls, torch.no_grad():
        for name, card, dargs, _, _ in blocks:  # the SIREN stacks take coordinates in f32
            dt = None if name in ("SirenNet", "EmbeddingWrapper") else torch.bfloat16
            outs[name] = (dt, card(*(_to(a, dev, dt) for a in dargs)))
    torch.cuda.synchronize()
    launches = _launches(counted, base)
    want = sum(g for *_, g in blocks)
    _check(launches == {k: (want if k == "group_norm" else 0) for k in counted},
           f"library blocks in bf16: launches {({k: v for k, v in launches.items() if v})} == "
           f"group_norm {want} (one per GroupNorm module)")
    for name, _, _, out32, _ in blocks:
        dt, y = outs[name]
        y = y.float()
        err = (y - out32).abs().max().item() / out32.abs().max().item()
        _check(y.shape == out32.shape and bool(torch.isfinite(y).all()) and err <= 5e-2,
               f"library {name} {'bf16' if dt else 'f32, again'}: {tuple(y.shape)} finite, "
               f"within {err:.2e} x max|f32| (<= 5e-2)")
    sites = _gn_site_counts(calls, with_dtype=True)
    del calls, outs
    res = check_cond_group_norm(dev, gen, sites, {}, label="library blocks",
                                per="bf16 forward of the library blocks")
    print(f"      library blocks took {time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    return launches, res


# -- phase 9: the sharded predict, the corpus solvers, the debug and
# profiling helpers ------------------------------------------------------------

# the paths whose predict runs sharded (the three families of the JAX
# package's dryrun_multichip: NS2d, SW, conditional two-phase)
SHARDED_PATHS = ("path 1 NS2d", "path 3 SW", "path 5 conditional two-phase")
# the NS2d solver on the card against the CPU: full width (128 cases of
# 64x64, the generator CLI's visc and dt), two records of 200 steps; f32,
# cuFFT against pocketfft, bounded relative to max|cpu|
NS_CASES, NS_N, NS_T_RECORD, NS_TOL = 128, 64, 0.05, 1e-4
# the generator CLI at its defaults: 42 records of 4,000 steps
GEN_RECORDS, GEN_STEPS_PER_REC, GEN_SPINUP = 42, 4000, 10
GEN_LIMIT_S = 120  # past this (estimated from the solver's rate) fewer records are run
# make_sw_solver_store at its defaults: 64 + 13 cases, 12 + 88 records of 25 RK4 steps
SW_STORE_CASES, SW_STORE_RECORDS, SW_STORE_STEPS = 77, 100, 25


def drive_sharded(dev, smi, paths, gen):
    """``sharded_predict`` at world size 1 over NCCL on `paths` (paths 1, 3
    and 5 at full width): each bitwise equal to ``model.predict`` on the
    same input, its launches (every count set to 0 just before the sharded
    predict and read just after) those the layer specs imply and the
    predict's; both timed by CUDA events in rounds predict, sharded,
    sharded, predict. Returns the launches per path."""
    import tempfile

    from lns_tpu_torch.parallel import ddp

    out = {}
    print("-- sharded predict (lns_tpu_torch.parallel.sharded_predict) at world size 1 over "
          "NCCL, bf16", flush=True)
    with tempfile.TemporaryDirectory() as tmp, world_one(dev, tmp):
        for label, model, expect, (b, steps, chunk) in paths:
            cfg = model.cfg
            x = torch.randn(b, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
            cond = torch.rand(b, generator=gen).to(dev) if model.conditional else None
            counted = _counted()
            base = _launches(counted)
            ref = model.predict(x, steps, cond, decode_chunk=chunk)
            plain = _launches(counted, base)
            base = _launches(counted)
            torch.cuda.synchronize()
            y = ddp.sharded_predict(model, x, steps, cond, decode_chunk=chunk)
            torch.cuda.synchronize()
            launches = _launches(counted, base)
            want = {k: expect.get(k, 0) for k in launches}
            _check(tuple(y.shape) == tuple(ref.shape) and torch.equal(y, ref),
                   f"{label}: sharded_predict at world 1 (B{b} x {steps} steps) bitwise equal to "
                   f"model.predict, shape {tuple(y.shape)}")
            _check(launches == want == plain,
                   f"{label}: sharded_predict launches {({k: v for k, v in launches.items() if v})}"
                   f" == the specs' {({k: v for k, v in want.items() if v})} == model.predict's")
            ms = {"predict": [], "sharded": []}
            for who in ("predict", "sharded", "sharded", "predict"):
                fn = (lambda: model.predict(x, steps, cond, decode_chunk=chunk)) \
                    if who == "predict" else \
                    (lambda: ddp.sharded_predict(model, x, steps, cond, decode_chunk=chunk))
                ms[who].append(cuda_ms(fn, reps=REPS))
            print(f"      {label}: sharded_predict world 1 {', '.join(f'{v:.3f}' for v in ms['sharded'])}"
                  f" ms, model.predict {', '.join(f'{v:.3f}' for v in ms['predict'])} ms (mean of "
                  f"{REPS} by CUDA events per round; rounds predict, sharded, sharded, predict); "
                  f"{smi}", flush=True)
            out[f"{label} sharded predict, world 1"] = launches
    return out


def _span_offsets(spans, prof):
    """Per span of ``utils.profiling`` (each the n-th of its name), the ns
    from its start to its range's start in the profiler's events and from
    the range's end to its end; None unless every span has one range of
    its name and every ``lns.*`` range a span."""
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lns.") and e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    named = {}
    for r in sorted(spans, key=lambda r: r.start_ns):
        named.setdefault(r.name, []).append(r)
    if {k: len(v) for k, v in ranges.items()} != {k: len(v) for k, v in named.items()}:
        return None
    return [(start - r.start_ns, r.end_ns - end) for name, rs in named.items()
            for r, (start, end) in zip(rs, sorted(ranges[name]))]


def check_debug_tools(dev, model, gen, smi):
    """``utils.profiling.trace`` around one path-1 predict: the written
    trace names kernels 1-3 (``rollout_bf16_kernel``, kernel 2's bf16
    passes, ``gn_kernel`` / ``gn_partials``), and the predict's spans
    (``utils.profiling.span``, one per phase and decode chunk) each hold
    their range in the profiler's events, the offsets printed; ``Timer``
    stopped on the predict's output and ``time_fn`` of one propagator step
    on the card; ``utils.debug.nan_debugging`` raises
    ``FloatingPointError`` on a NaN planted in the predict's input, naming
    the first module whose output holds it, and ``assert_finite`` names a
    NaN planted in a copy of the state dict."""
    import glob
    import tempfile

    from lns_tpu_torch.utils import debug, profiling

    cfg = model.cfg
    x = torch.randn(BATCH, cfg.Ly, cfg.Lx, cfg.in_channels, generator=gen).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        model.predict(x, STEPS, decode_chunk=CHUNK)  # warm-up
        torch.cuda.synchronize()
        profiling.reset()
        with profiling.trace(tmp) as prof:
            model.predict(x, STEPS, decode_chunk=CHUNK)
            torch.cuda.synchronize()
        spans = profiling.spans()
        offsets = _span_offsets(spans, prof)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        names = set()
        for path in files:
            with open(path) as f:
                names |= {e.get("name", "") for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel"}
        found = {k: sorted(n[:40] for n in names if any(p in n for p in pats))
                 for k, pats in (("prop_rollout", ("rollout_bf16_kernel",)),
                                 ("fab_core", ("fab_bb_stats_bf16", "fab_out_bf16")),
                                 ("group_norm", ("gn_kernel", "gn_partials")))}
        _check(len(files) == 1 and all(found.values()),
               f"utils.profiling.trace around one path-1 predict: {len(files)} trace file, "
               f"{len(names)} kernel names, kernels 1-3 among them {found}")
    chunks = -(-BATCH * STEPS // CHUNK)
    starts = sorted(a for a, _ in offsets or [(0, 0)])
    _check(offsets is not None and len(spans) == 5 + chunks
           and all(a >= 0 and b >= 0 for a, b in offsets),
           f"utils.profiling spans of the traced predict: {len(spans)} (lns.predict, encode, "
           f"propagate, pack, rollout, {chunks} decode chunks), each holding its range in the "
           f"profiler's events; range start after the span's start: median "
           f"{starts[len(starts) // 2] / 1e3:.1f} us, max {starts[-1] / 1e3:.1f} us")
    timer = profiling.Timer()
    timer.start("path-1 predict")
    y = model.predict(x, STEPS, decode_chunk=CHUNK)
    timer.stop("path-1 predict", sync_value=y)
    with torch.no_grad():
        z = model.encode(x).to(model.dtype or torch.float32)
        step_s = profiling.time_fn(model.propagate, z, n=20)
    print(f"      profiling on the card: Timer '{timer.report()}'; time_fn of one propagator step "
          f"(B{BATCH}, module path, 20 chained by CUDA events) {step_s * 1e3:.4f} ms; {smi}",
          flush=True)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("nan")
    try:
        with debug.nan_debugging():
            model.predict(bad, 2, decode_chunk=CHUNK)
        msg = "nothing raised"
    except FloatingPointError as e:
        msg = str(e)
    _check(msg.startswith("NaN in the output of ") and not torch.is_anomaly_enabled(),
           f"utils.debug.nan_debugging on a NaN planted in a path-1 predict's input on the "
           f"card: {msg!r}; anomaly mode off again after")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    debug.assert_finite(state, "state")
    key = next(k for k, v in state.items() if v.is_floating_point())
    state[key].view(-1)[0] = float("inf")
    try:
        debug.assert_finite(state, "state")
        msg = "nothing raised"
    except FloatingPointError as e:
        msg = str(e)
    _check(msg == f"non-finite values in state[{key!r}]",
           f"utils.debug.assert_finite on the card's state dict with one infinity: {msg!r}")


def graph_steps(dev, w0, visc, dt, smi, captured=200, rounds=10):
    """The NS2d solver's step (``spectral_step``) on `w0`'s spectrum:
    `captured` x `rounds` eager steps against the same steps as replays of
    one CUDA graph of `captured` steps, both timed by the host clock
    between synchronizes; prints steps/s of both and whether they agree
    bitwise (a measurement for capturing the solver as a graph, which the
    solver does not do)."""
    import numpy as np

    from lns_tpu_torch.data.ns2d_solver import spectral_step

    step = spectral_step(w0.shape[-1], visc, dt, dev)
    w_init = torch.fft.rfft2(torch.from_numpy(np.asarray(w0, np.float32)).to(dev))
    w = w_init
    for _ in range(3):  # cuFFT plans
        w = step(w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = w_init
    for _ in range(captured * rounds):
        eager = step(eager)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    static = w_init.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = static
        for _ in range(captured):
            out = step(out)
    static.copy_(w_init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        graph.replay()
        static.copy_(out)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    n = captured * rounds
    print(f"      NS2d solver step, {w0.shape[0]} cases x {w0.shape[-1]}x{w0.shape[-1]}: eager "
          f"{n / eager_s:.1f} steps/s, as {rounds} replays of a CUDA graph of {captured} steps "
          f"{n / graph_s:.1f} steps/s (host clock, {n} steps each), "
          f"{'bitwise equal' if torch.equal(out, eager) else 'NOT bitwise equal'}; {smi}",
          flush=True)
    del graph


def drive_solvers(dev, smi):
    """The corpus solvers on the card: ``simulate_ns2d`` at full width
    against the same function on the CPU (cuFFT against pocketfft; the
    share of differing elements printed); the generator CLI
    (``python -m lns_tpu_torch.cli.generate_ns2d``) at its defaults, or
    with fewer records where the solver's rate says the defaults take past
    ``GEN_LIMIT_S`` (the cut printed), with its wall seconds, steps/s and
    the corpus's statistics; ``make_sw_solver_store`` at its defaults with
    its wall seconds and a finite store; then one bf16 stage-1 train step
    at full NS2d width on the generated corpus with kernels 2 and 3 (the
    counts set to 0 just before it and read just after). Returns the
    step's launches."""
    import tempfile

    import numpy as np

    from lns_tpu_torch.config import ns2d_config
    from lns_tpu_torch.data import shallow_water
    from lns_tpu_torch.data.ns2d_solver import gaussian_random_field, simulate_ns2d
    from lns_tpu_torch.data.sw_solver import make_sw_solver_store
    from lns_tpu_torch.data.zarr_reader import open_zarr
    from lns_tpu_torch.train.stage1 import Stage1Trainer

    t_phase = time.perf_counter()
    print("-- corpus solvers on the card", flush=True)
    w0 = gaussian_random_field(np.random.default_rng(0), NS_N, NS_CASES)
    kw = dict(visc=1e-4, t_record=NS_T_RECORD, n_records=2, dt=2.5e-4)
    steps = 2 * int(round(NS_T_RECORD / kw["dt"]))
    simulate_ns2d(w0[:2], **dict(kw, n_records=1), device=dev)  # cuFFT plans, warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = simulate_ns2d(w0, device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = simulate_ns2d(w0, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    share = float((card != cpu).mean())
    rate = steps / card_s
    _check(card.shape == cpu.shape == (NS_CASES, 2, NS_N, NS_N) and np.isfinite(card).all()
           and err <= NS_TOL,
           f"simulate_ns2d {NS_CASES} cases x {NS_N}x{NS_N}, 2 records of {steps // 2} steps (visc "
           f"1e-4, dt 2.5e-4): card against CPU {err:.3e} x max|cpu| (<= {NS_TOL}), "
           f"{share:.2%} of elements differ; card {card_s:.3f} s ({rate:.1f} steps/s), CPU "
           f"{cpu_s:.3f} s; {smi}")

    graph_steps(dev, w0, kw["visc"], kw["dt"], smi)

    with tempfile.TemporaryDirectory() as tmp:
        est = GEN_RECORDS * GEN_STEPS_PER_REC / rate
        case_len = 30
        if est > GEN_LIMIT_S:
            records = max(3, int(GEN_LIMIT_S * rate / GEN_STEPS_PER_REC) - GEN_SPINUP)
            case_len = max(1, records - 2)
            print(f"      generator CLI: the defaults' {GEN_RECORDS} records would take ~{est:.0f} s "
                  f"at {rate:.1f} steps/s (> {GEN_LIMIT_S} s): run with --case-len {case_len} "
                  f"({GEN_SPINUP + case_len + 2} records)", flush=True)
        out = os.path.join(tmp, "ns2d_solver.npz")
        argv = [sys.executable, "-m", "lns_tpu_torch.cli.generate_ns2d", "--out", out]
        if case_len != 30:
            argv += ["--case-len", str(case_len)]
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                              capture_output=True, text=True, timeout=900)
        gen_s = time.perf_counter() - t0
        n_steps = (GEN_SPINUP + case_len + 2) * GEN_STEPS_PER_REC
        ok = proc.returncode == 0 and os.path.exists(out)
        stats = "none"
        if ok:
            with np.load(out) as d:
                center = d["all_sol_center"]
                ok = center.shape == (case_len, 64, 64, 128) and bool(np.isfinite(center).all())
                # the spectrum's decay: a red spectrum, low wavenumbers over high
                spec = np.abs(np.fft.fft2(center[-1].transpose(2, 0, 1))).mean(axis=0)
                stats = (f"mean {center.mean():.6f}, std {center.std():.6f}, |w_hat| at k=(1,1) "
                         f"{spec[1, 1]:.3f} vs k=(20,20) {spec[20, 20]:.3f}")
                ok = ok and spec[1, 1] > 10 * spec[20, 20]
        _check(ok, f"python -m lns_tpu_torch.cli.generate_ns2d {' '.join(argv[4:])}: exit "
               f"{proc.returncode}, {case_len} frames x 128 cases of 64x64, finite; {stats}; "
               f"{gen_s:.1f} s of wall for {n_steps} steps ({n_steps / gen_s:.1f} steps/s, the "
               f"process's start and torch's import included); its own line "
               f"{proc.stdout.strip()[-120:]!r}{proc.stderr[-2000:] if proc.returncode else ''}; "
               f"{smi}")

        t0 = time.perf_counter()
        try:
            paths = make_sw_solver_store(os.path.join(tmp, "sw"), device=dev)
            sw_ok = all(np.isfinite(open_zarr(p)[ch].read_all()).all() for p in paths[:2]
                        for ch in shallow_water.CHANNELS)
            msg = ""
        except FloatingPointError as e:
            sw_ok, msg = False, f" ({e})"
        sw_s = time.perf_counter() - t0
        _check(sw_ok, f"make_sw_solver_store at its defaults (96x192, {SW_STORE_CASES} cases, "
               f"{SW_STORE_RECORDS} records of {SW_STORE_STEPS} RK4 steps) on the card: finite "
               f"zarr stores{msg}; {sw_s:.1f} s of wall "
               f"({SW_STORE_RECORDS * SW_STORE_STEPS / sw_s:.1f} RK4 steps/s, the store's "
               f"writes included); {smi}")

        launches = {}
        if ok:
            cfg = ns2d_config().replace(
                data_dir=out, case_len=case_len, num_case=128,
                dataset_stat=os.path.join(tmp, "stat.npz"), batch_size=32, epochs=1,
                learning_rate=5e-4, mixed_precision=True, log_dir=os.path.join(tmp, "log"),
                overwrite_exist=True)
            trainer = Stage1Trainer(cfg, seed=1234, use_wandb=False, device=dev)
            x = torch.from_numpy(trainer.train_ds.get_batch(np.arange(32))).to(dev)
            counted = _counted()
            base = _launches(counted)
            loss = trainer.train_step(x)
            torch.cuda.synchronize()
            launches = _launches(counted, base)
            want = expected_launches(cfg, n_chunks=1)
            want["prop_rollout"] = 0
            _check(launches == {k: want.get(k, 0) for k in launches}
                   and launches["fab_core"] > 0 and launches["group_norm"] > 0
                   and bool(torch.isfinite(loss)),
                   f"stage-1 train step (bf16, batch 32) on the solver corpus: launches "
                   f"{({k: v for k, v in launches.items() if v})} == the specs' "
                   f"{({k: v for k, v in want.items() if v})}, loss {float(loss):.6f} finite")
            del trainer
    print(f"      solver phase wall {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"NS2d solver-corpus stage-1 step": launches}


# -- phase 10: the probe kernels ---------------------------------------------

# launches of one untimed run of the four probes (``probe_layouts.run``:
# per dtype 2 copies, 3 products, 2 swaps; ``probe_fab_mega.run_pieces``: 2
# interior dots, each a ``dot_general`` launch, 1 swap, 2 copies, and
# ``run_passes``; ``probe_bw.run`` at s = 2: 1 copy, 1 product;
# ``probe_dots.run``: one launch per case, 12 single dots and 7 chains)
PROBE_LAUNCHES = {"bmm_blockdiag": 7, "transpose_hw": 5, "blocked_copy": 7, "fab_mega_stats": 1,
                  "fab_mega_apply": 1, "interior_dot": 2, "dot_general": 14, "dot_chain": 7}


def parent_ms(names):
    """Device ms of `names` (``probe_axial.py``'s cases) in the tree that
    ``--parent DIR`` names (a ``git archive`` of the parent commit), by
    ``probe_axial.py --tree DIR`` in a process of its own, or None without
    ``--parent``."""
    if "--parent" not in sys.argv:
        return None
    tree = sys.argv[sys.argv.index("--parent") + 1]
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lns_tpu_torch", "kernels",
                          "probe_axial.py")
    proc = subprocess.run([sys.executable, script, "--tree", tree, "--label", "parent", "--only",
                           ",".join(names)], capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"probe_axial.py --tree {tree}: exit {proc.returncode}"
                                 f"{'' if proc.returncode == 0 else ': ' + proc.stderr[-2000:]}")
    if proc.returncode:
        return None
    times = json.loads(proc.stdout.strip().splitlines()[-1])["times"]
    return {k: times[k]["device_ms"] for k in names}


def _parent_text(parent, name):
    if parent is None:
        return "the parent tree not measured (python3 chip_smoke.py --parent DIR times it)"
    return f"the parent tree {parent[name]:.4f} ms (probe_axial.py --tree)"


def check_probes(dev):
    """The kernels of the TPU probe scripts' ports: each launch count set to
    0, one untimed run of ``probe_layouts``, ``probe_fab_mega`` (pieces and
    passes, b116), ``probe_bw`` (s = 2) and ``probe_dots`` (its 19 cases)
    with their own checks, the counts read; then each new kernel at its
    probe's shape held to its plain version and timed beside its bound and
    library call (the copy and the reshapes bitwise, the copy on both
    routes at every s and on rows of odd bytes, kernel 7's uses bitwise,
    kernel 6's to its tolerances, G and s 1e-3 x max|plain| also at b1 n1
    and b3 n5, the apply pass and the interior dot 1e-2 with at most 2 %
    differing, the apply pass twice bitwise and also at b1 n1 and b3 n3;
    the device ms of the copy, both passes and each chain, and with
    ``--parent DIR`` the parent tree's (``parent_ms``); ``dot_general`` and
    ``dot_chain`` per case, ``check_mosaic_dots``).
    Returns (launches, {kernel: result})."""
    from lns_tpu_torch.kernels import probe_bw, probe_dots, probe_fab_mega, probe_layouts
    from lns_tpu_torch.kernels.axial_pipeline import (bmm_blockdiag, bmm_blockdiag_plain,
                                                      transpose_hw, transpose_hw_plain)
    from lns_tpu_torch.kernels.blocked_copy import blocked_copy, blocked_copy_plain
    from lns_tpu_torch.kernels.fab_mega import (fab_mega_apply, fab_mega_apply_plain,
                                                fab_mega_stats, fab_mega_stats_plain,
                                                interior_dot, interior_dot_plain)
    from lns_tpu_torch.kernels.mosaic_dots import CASES, CHAINS, dot_general

    print("-- probe kernels against their plain versions (probe_layouts, probe_fab_mega, "
          "probe_bw, probe_dots, untimed; then each new kernel at its probe's shape)", flush=True)
    t0 = time.perf_counter()
    counted = _counted()
    base = _launches(counted)
    ok = all(r["ok"] for r in probe_layouts.run(dev, timed=False).values())
    ok &= all(r["ok"] for r in probe_fab_mega.run_pieces(dev, timed=False).values())
    ok &= all(r["ok"] for r in probe_fab_mega.run_passes(dev, timed=False).values())
    ok &= probe_bw.run(dev, timed=False, samples=(2,))[1]
    ok &= all(r["ok"] for r in probe_dots.run(dev, timed=False).values())
    torch.cuda.synchronize()
    launches = _launches(counted, base)
    _check(ok, "probes: every form of probe_layouts, probe_fab_mega, probe_bw and probe_dots held "
           "to its plain version")
    _check(launches == {k: PROBE_LAUNCHES.get(k, 0) for k in launches},
           f"probes: launches {({k: v for k, v in launches.items() if v})} == {PROBE_LAUNCHES}")

    gen = torch.Generator().manual_seed(17)
    bf = torch.bfloat16
    res, errs = {}, {k: [] for k in ("blocked_copy", "interior_dot")}
    x = torch.randn(probe_bw.SHAPE, generator=torch.Generator(dev).manual_seed(17),
                    device=dev).to(bf)
    b, g = x.shape[:2]
    label = f"blocked_copy bf16 {list(x.shape)} s=2 ({b // 2 * g} blocks)"
    err, ms, plain_ms = compare(label, lambda: blocked_copy(x, 2), lambda: blocked_copy_plain(x),
                                0.0, max_differ=0.0)
    _check(blocked_copy.route == "bulk", f"{label}: the bulk route (C reports "
                                         f"{blocked_copy.route})")
    errs["blocked_copy"].append(err)
    y = torch.empty_like(x)
    res["blocked_copy"] = {"ms": ms, "plain_ms": plain_ms,
                           **Bound().add(0, 2 * _nbytes(x)).result(),
                           "library_ms": cuda_ms(lambda: y.copy_(x))}
    print(f"      {label}: {2 * _nbytes(x) / ms / 1e6:.1f} GB/s by events; Tensor.copy_ "
          f"{res['blocked_copy']['library_ms']:.4f} ms", flush=True)
    del y
    # both routes at every s of the sweep, bitwise, on the route C reports:
    # these rows take the bulk route; rows of a size that is no multiple of
    # 16 bytes (odd ones too) the per-thread route
    for name, a, route, samples in (
            ("bf16 " + str(list(x.shape)), x, "bulk", probe_bw.SAMPLES),
            ("uint8 [928, 2, 4099]", torch.randint(0, 256, (928, 2, 4099), generator=gen,
                                                   dtype=torch.uint8).to(dev),
             "threads", probe_bw.SAMPLES),
            ("uint8 [5, 3, 7, 5]", (torch.rand(5, 3, 7, 5, generator=gen) * 100).to(dev, torch.uint8),
             "threads", (1, 2, 4)),
            ("bf16 [9, 2, 3, 7]", torch.randn(9, 2, 3, 7, generator=gen).to(dev, bf), "threads",
             (1, 2, 4))):
        row = math.prod(a.shape[2:]) * a.element_size()
        for s in samples:
            out = blocked_copy(a, s)
            same = torch.equal(out, a)
            _check(same and blocked_copy.route == route,
                   f"blocked_copy {name} ({row}-byte rows) s={s}: {blocked_copy.route} route "
                   f"(expected {route}), bitwise")
            errs["blocked_copy"].append(0.0 if same else float("inf"))
            del out
    new_ms = graph_ms(lambda: blocked_copy(x, 2), calls=5)
    parent = parent_ms(["blocked_copy bf16 [928,2,128,2048] s=2",
                        "fab_mega_stats bf16 b116 n8 32x32 c64",
                        "fab_mega_apply bf16 b116 n8 32x32 c64",
                        *(f"dot_chain {c}" for c in CHAINS),
                        *(f"dot_general {k}" for k, c in CASES.items() if c.route == "dot_general"),
                        "interior_dot [32,32] . [32,32,64]"])
    print(f"      blocked_copy s=2 device: {new_ms:.4f} ms (this tree, bulk route); "
          + _parent_text(parent, "blocked_copy bf16 [928,2,128,2048] s=2"), flush=True)
    res["blocked_copy"]["device_ms"] = new_ms
    del x
    for dt in (torch.float32, bf):  # the reshapes: a copy viewed anew, bitwise
        for shape, view in (((128, 32, 64), (128, 2048)), ((128, 2048), (128, 32, 64)),
                            ((32, 32, 64), (1024, 64)), ((32, 2048), (32, 32, 64))):
            a = torch.randn(shape, generator=gen).to(dev, dt)
            err, _, _ = compare(f"blocked_copy {str(dt)[6:]} {list(shape)} -> {list(view)}",
                                lambda: blocked_copy(a.reshape(shape[0], 1, -1), 1).reshape(view),
                                lambda: a.reshape(view).clone(), 0.0, max_differ=0.0)
            errs["blocked_copy"].append(err)
        a = torch.randn(1, 4, 32, 32, 64, generator=gen).to(dev, dt)  # kernel 7: bitwise
        compare(f"transpose_hw {str(dt)[6:]} [1,4,32,32,64] (transpose_4d)",
                lambda: transpose_hw(a), lambda: transpose_hw_plain(a), 0.0, max_differ=0.0)
        k = torch.randn(1, 1, 128, 128, generator=gen).to(dev, dt)  # kernel 6: its tolerances
        a = torch.randn(1, 1, 128, 2048, generator=gen).to(dev, dt)
        compare(f"bmm_blockdiag {str(dt)[6:]} [1,1,128,2048] (rank3_dot)",
                lambda: bmm_blockdiag(k, a), lambda: bmm_blockdiag_plain(k, a),
                1e-5 if dt == torch.float32 else 1e-2)

    u, u_t, kx, ky, m, bias = probe_fab_mega.inputs(dev)
    bb, n, h, w, c = (getattr(probe_fab_mega, k) for k in "BNHWC")
    flops = 2 * 2 * bb * n * h * w * w * c + 2 * bb * n * h * w * c * c  # two applies, Gram / b2 m
    shape = f"b{bb} n{n} {h}x{w} c{c}"
    gs, ss = fab_mega_stats(u_t, kx, ky)
    gp, sp = fab_mega_stats_plain(u_t, kx, ky)
    s_err = (ss - sp).abs().max().item()
    _check(s_err <= 1e-3 * sp.abs().max().item(),
           f"fab_mega_stats {shape} s: max_abs_err {s_err:.3e} <= 1e-3 x max|plain| "
           f"({1e-3 * sp.abs().max().item():.3e})")
    g2, s2 = fab_mega_stats(u_t, kx, ky)
    _check(torch.equal(g2, gs) and torch.equal(s2, ss), f"fab_mega_stats {shape}: two runs bitwise")
    err, ms, plain_ms = compare(f"fab_mega_stats {shape} G", lambda: fab_mega_stats(u_t, kx, ky)[0],
                                lambda: fab_mega_stats_plain(u_t, kx, ky)[0], 1e-3)
    res["fab_mega_stats"] = {"max_abs_err": max(err, s_err), "ms": ms, "plain_ms": plain_ms,
                             **Bound().add(flops, _nbytes(u_t, kx, ky, gs, ss)).result(),
                             "library_ms": cuda_ms(lambda: probe_fab_mega.einsum_stats(u, kx, ky))}
    new_ms = graph_ms(lambda: fab_mega_stats(u_t, kx, ky))
    print(f"      fab_mega_stats {shape} device: {new_ms:.4f} ms (this tree, a block per sample, "
          "wgmma); " + _parent_text(parent, "fab_mega_stats bf16 b116 n8 32x32 c64"), flush=True)
    res["fab_mega_stats"]["device_ms"] = new_ms
    # the edges of the per-sample loop: one sample and head; 3 samples of 5
    # heads (an odd head count: the kx, ky ring's two buffers in turn)
    for eb, en in ((1, 1), (3, 5)):
        eu = torch.randn(eb, w, h, c, generator=gen).to(dev, bf)
        ekx = (torch.randn(eb, en, h, h, generator=gen) / h).to(dev, bf)
        eky = (torch.randn(eb, en, w, w, generator=gen) / w).to(dev, bf)
        eg, es = fab_mega_stats(eu, ekx, eky)
        pg, ps = fab_mega_stats_plain(eu, ekx, eky)
        e_g, e_s = (eg - pg).abs().max().item(), (es - ps).abs().max().item()
        _check(e_g <= 1e-3 * pg.abs().max().item() and e_s <= 1e-3 * ps.abs().max().item(),
               f"fab_mega_stats b{eb} n{en} {h}x{w} c{c}: G max_abs_err {e_g:.3e}, s {e_s:.3e} "
               "<= 1e-3 x max|plain|")
        res["fab_mega_stats"]["max_abs_err"] = max(res["fab_mega_stats"]["max_abs_err"], e_g, e_s)
    out = fab_mega_apply(u_t, kx, ky, m, bias)
    _check(torch.equal(fab_mega_apply(u_t, kx, ky, m, bias), out),
           f"fab_mega_apply {shape}: two runs bitwise")
    err, ms, plain_ms = compare(f"fab_mega_apply {shape}",
                                lambda: fab_mega_apply(u_t, kx, ky, m, bias),
                                lambda: fab_mega_apply_plain(u_t, kx, ky, m, bias), 1e-2,
                                max_differ=0.02)
    res["fab_mega_apply"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             **Bound().add(flops, _nbytes(u_t, kx, ky, m, bias, out)).result(),
                             "library_ms": cuda_ms(lambda: probe_fab_mega.einsum_full(
                                 u, kx, ky, m, bias))}
    new_ms = graph_ms(lambda: fab_mega_apply(u_t, kx, ky, m, bias))
    lib_ms = graph_ms(lambda: probe_fab_mega.einsum_full(u, kx, ky, m, bias))
    print(f"      fab_mega_apply {shape} device: {new_ms:.4f} ms (this tree, a block per sample, "
          f"wgmma; its einsum chain {lib_ms:.4f} ms device); "
          + _parent_text(parent, "fab_mega_apply bf16 b116 n8 32x32 c64"), flush=True)
    res["fab_mega_apply"]["device_ms"] = new_ms
    # the edges of the apply pass's ring of two slots: one sample and head;
    # 3 samples of 3 heads (the slots and the heads out of step)
    for eb, en in ((1, 1), (3, 3)):
        ea = (torch.randn(eb, w, h, c, generator=gen).to(dev, bf),
              (torch.randn(eb, en, h, h, generator=gen) / h).to(dev, bf),
              (torch.randn(eb, en, w, w, generator=gen) / w).to(dev, bf),
              (torch.randn(eb, en, c, c, generator=gen) / c).to(dev, bf),
              torch.randn(eb, c, generator=gen).to(dev, bf))
        e_err, _, _ = compare(f"fab_mega_apply b{eb} n{en} {h}x{w} c{c}",
                              lambda ea=ea: fab_mega_apply(*ea),
                              lambda ea=ea: fab_mega_apply_plain(*ea), 1e-2, reps=1,
                              max_differ=0.02)
        res["fab_mega_apply"]["max_abs_err"] = max(res["fab_mega_apply"]["max_abs_err"], e_err)
    for k in ("fab_mega_stats", "fab_mega_apply"):
        print(f"      {k} {shape}: kernel {res[k]['ms']:.4f} ms, bound {res[k]['bound_ms']:.4f} ms "
              f"({res[k]['bound_by']}), einsum chain {res[k]['library_ms']:.4f} ms", flush=True)
    del u, u_t, kx, ky, m, bias, gs, ss, gp, sp, out
    kx = (torch.randn(32, 32, generator=gen) / 32).to(dev, bf)  # the pieces A and B2
    a = torch.randn(32, 32, 64, generator=gen).to(dev, bf)
    first = interior_dot(kx, a)
    err, ms, plain_ms = compare("interior_dot [32,32] . [32,32,64] (dot_general; feeds "
                                f"{', '.join(dot_general.feeds or ('none',))}; "
                                f"{probe_dots.plan_text()})",
                                lambda: interior_dot(kx, a), lambda: interior_dot_plain(kx, a),
                                1e-2, max_differ=0.02)
    _check(torch.equal(interior_dot(kx, a), first), "interior_dot [32,32] . [32,32,64]: two runs "
                                                    "bitwise equal")
    errs["interior_dot"].append(err)
    res["interior_dot"] = {"ms": ms, "plain_ms": plain_ms,
                           **Bound().add(2 * 32 * 32 * 32 * 64, 2 * _nbytes(a) + _nbytes(kx))
                           .result(),
                           "library_ms": cuda_ms(lambda: torch.einsum("ih,lhc->ilc", kx, a))}
    new_ms = graph_ms(lambda: interior_dot(kx, a))
    res["interior_dot"]["device_ms"] = new_ms
    print(f"      interior_dot device: {new_ms:.4f} ms (this tree, dot_general); its einsum "
          f"{graph_ms(lambda: torch.einsum('ih,lhc->ilc', kx, a)):.4f} ms device; "
          + _parent_text(parent, "interior_dot [32,32] . [32,32,64]"), flush=True)
    del first
    for k, e in errs.items():
        res[k]["max_abs_err"] = max(e)
    # shapes outside the kernels' limits raise naming the limit (the text
    # from C), before anything launches
    z = torch.zeros(2, 32, 32, 32, device=dev, dtype=bf)
    zk = torch.zeros(2, 1, 32, 32, device=dev, dtype=bf)
    for what, call, limit, fn in (
            ("fab_mega_stats c32", lambda: fab_mega_stats(z, zk, zk), "c 64",
             "fab_mega.fab_mega_stats"),
            ("interior_dot f32", lambda: interior_dot(kx.float(), a.float()), "bf16",
             "fab_mega.interior_dot"),
            ("blocked_copy s=0", lambda: blocked_copy(z, 0), "samples per block >= 1",
             "blocked_copy.blocked_copy")):
        before, msg = _launched(fn), ""
        try:
            call()
        except ValueError as e:
            msg = str(e)
        _check(limit in msg and _launched(fn) == before, f"{what} raises naming '{limit}': {msg}")
    res.update(check_mosaic_dots(dev, parent))
    print(f"      the probe phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, res


def check_dot_general_edges(dev, x):
    """``dot_general`` off the probe's cases, against its plain version, each
    case twice bitwise: every block tile the rule (C ``tile_of``) picks,
    checked against the plan C reports (32x32 at sides off the tile, 32x64,
    64x32 and 64x64 on grids that fill half the card), K = 200 (the ring of 4
    stages wraps) and K off 32, the staged feed (a batch dim with unit
    stride; a base off 16 bytes), ragged sizes (rows of whole 16-byte pieces
    and rows of odd ones), an operand given as a transposed view, f32 and
    mixed operands on the CUDA cores, sum_batch over clusters of 3 and of 8
    at batch 13 (not a multiple of the cluster: ranks of 1 and 2 batches),
    the moments over a cluster of 1 and at three row tiles a rank (bf16
    outputs one ulp of max|plain| in at most 1 %, f32 1e-5, the moments
    1e-3)."""
    from lns_tpu_torch.kernels import probe_dots
    from lns_tpu_torch.kernels.mosaic_dots import dot_general, dot_general_plain

    gen = torch.Generator().manual_seed(19)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, bf)

    odd = rnd(1 + 37 * 45)[1:].view(37, 45)  # 2 bytes past a 16-byte boundary
    none = ((), ())
    # (label, a, b, contract, batch, out dtype, epilogue, the tile the rule picks or None)
    cases = [
        ("1024x64 . 1024x64", rnd(1024, 64), rnd(1024, 64), ((1,), (1,)), none, bf, None,
         "64x64"),
        ("8192x32 . 20x32, rows of odd bytes", rnd(8192, 32), rnd(20, 32), ((1,), (1,)), none,
         bf, None, "64x32"),
        ("20x40 . 40x8192, K 40", rnd(20, 40), rnd(40, 8192), ((1,), (0,)), none, f32, None,
         "32x64"),
        ("50x24 . 70x24, straight", rnd(50, 24), rnd(70, 24), ((1,), (1,)), none, bf, None,
         "32x32"),
        ("96x200 . 200x80, K 200", rnd(96, 200), rnd(200, 80), ((1,), (0,)), none, bf, None,
         None),
        ("96x200 . 200x80, K 200, f32 out", rnd(96, 200), rnd(200, 80), ((1,), (0,)), none, f32,
         None, None),
        ("batch minor, staged", x["q"], x["q"], ((1,), (1,)), ((2,), (2,)), f32, None, None),
        ("37x45 . 45x70, staged", rnd(37, 45), rnd(45, 70), ((1,), (0,)), none, bf, None, None),
        ("a base off 16 bytes", odd, rnd(45, 70), ((1,), (0,)), none, bf, None, None),
        ("a transposed view", x["u"][:, 0, :].t(), x["m"], ((1,), (0,)), none, f32, None, None),
        ("f32 x f32", x["u"].float(), x["k2"].float(), ((2,), (1,)), none, f32, None, "64x64"),
        ("bf16 x f32", x["u"], x["k2"].float(), ((2,), (1,)), none, f32, None, "64x64"),
        ("sum_batch, batch 3", x["q"][:3], x["q"][:3], ((2,), (2,)), ((0,), (0,)), f32,
         "sum_batch", None),
        ("sum_batch, batch 13, K 72", rnd(13, 48, 72), rnd(13, 40, 72), ((2,), (2,)),
         ((0,), (0,)), f32, "sum_batch", None),
        ("sum_batch, batch 13, bf16 out", rnd(13, 48, 72), rnd(13, 40, 72), ((2,), (2,)),
         ((0,), (0,)), bf, "sum_batch", None),
        ("moments, one row tile", x["q"][:2], x["m"], ((1,), (0,)), none, f32, "moments", None),
        ("moments, three row tiles a rank", rnd(1480, 64), rnd(64, 48), ((1,), (0,)), none, f32,
         "moments", "64x64"),
        ("moments, 24 columns", rnd(1480, 64), rnd(64, 24), ((1,), (0,)), none, f32, "moments",
         "64x32"),
    ]
    tiles = set()
    for label, a, b, contract, batch, out_dtype, epi, tile in cases:
        args = (a, b, contract, batch, out_dtype, epi)
        rel, differ = ((1e-3, 1.0) if epi == "moments" else (2.0 ** -7, 0.01) if out_dtype == bf
                       else (1e-5, 1.0))
        first = dot_general(*args)
        plan = dot_general.plan or {"tile": None}
        tiles.add(plan["tile"])
        name = (f"dot_general {label} {list(a.shape)} . {list(b.shape)}; feeds "
                f"{', '.join(dot_general.feeds or ('none',))}; {probe_dots.plan_text()}")
        if tile is not None:
            _check(plan["tile"] == tile, f"{name}: the rule's tile {tile}")
        compare(name, lambda: dot_general(*args), lambda: dot_general_plain(*args), rel,
                max_differ=differ, reps=1)
        _check(torch.equal(dot_general(*args), first), f"dot_general {label}: two runs bitwise")
    _check(tiles >= {"32x32", "32x64", "64x32", "64x64"},
           f"dot_general: the edges take every tile the rule picks ({sorted(map(str, tiles))})")


def check_mosaic_dots(dev, parent=None):
    """``dot_general`` and ``dot_chain`` at the TPU probe's shapes: each of
    the 19 cases held to its plain version (``probe_dots.tolerance``: bf16
    outputs of one product one ulp of max|plain| in at most 1 %, f32 1e-5,
    the moments 1e-3, the chains with bf16 intermediates 1e-2 and at most 2 %
    of a bf16 output) and timed beside its bound and library call, printing
    each operand's feed (and a single dot's plan); each case's two runs
    bitwise equal, its device ms printed beside the parent tree's (`parent`,
    from ``parent_ms``); each kernel
    refusing what its limit (stated in C) does not take, before anything
    launches. Returns {kernel: result} summed over its cases."""
    from lns_tpu_torch.kernels import mosaic_dots, probe_dots

    x = probe_dots.inputs(dev, seed=18)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
           for k in ("dot_general", "dot_chain")}
    bound_by = {k: {} for k in res}  # the bound's ms by what bounds it
    for key, spec in mosaic_dots.CASES.items():
        rel, differ = probe_dots.tolerance(key)
        out = mosaic_dots.run_case(key, x)
        feeds = probe_dots.feeds(key, out.is_cuda)
        err, ms, plain_ms = compare(f"{spec.route} {key} ({spec.desc}); feeds {feeds}",
                                    lambda: mosaic_dots.run_case(key, x),
                                    lambda: mosaic_dots.run_case(key, x, plain=True), rel,
                                    max_differ=differ)
        _check(torch.equal(out, mosaic_dots.run_case(key, x)),
               f"{spec.route} {key}: two runs bitwise equal")
        print(f"      {spec.route} {key} device: "
              f"{graph_ms(lambda: mosaic_dots.run_case(key, x)):.4f} ms (this tree); "
              + _parent_text(parent, f"{spec.route} {key}"), flush=True)
        bound_ms, by = probe_dots.bound_ms(*probe_dots.work(key, x, out))
        row = res[spec.route]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
        row["library_ms"] += cuda_ms(probe_dots.library(key, x))
        bound_by[spec.route][by] = bound_by[spec.route].get(by, 0.0) + bound_ms
        print(f"      {key}: bound {bound_ms * 1e3:.3f} us ({by}; {bound_ms / ms:.2%} of the "
              "kernel's time by events)", flush=True)
    for k in res:
        res[k]["bound_by"] = max(bound_by[k], key=bound_by[k].get)
    check_dot_general_edges(dev, x)
    # shapes and dtypes outside the kernels' limits raise naming the limit
    # (the text from C), before anything launches
    small = dict(x, u=x["u"][:, :16])
    for what, call, limit, fn in (
            ("dot_general f16", lambda: mosaic_dots.dot_general(x["u"].half(), x["k2"].half(),
                                                                ((2,), (1,))),
             "bf16 or f32 operands", "mosaic_dots.dot_general"),
            ("dot_chain u [64, 16, 32]", lambda: mosaic_dots.dot_chain("apply_chain",
                                                                      *small.values()),
             "H = W = L = I = 32", "mosaic_dots.dot_chain")):
        before, msg = _launched(fn), ""
        try:
            call()
        except ValueError as e:
            msg = str(e)
        _check(limit in msg and _launched(fn) == before, f"{what} raises naming '{limit}': {msg}")
    return res


def run(dev, smi=""):
    """Phases 3-10 on `dev`; returns the per-kernel results."""
    import tempfile

    from lns_tpu_torch.config import (ns2d_config, sw_config, twophase_conditional_config,
                                      twophase_config)
    from lns_tpu_torch.models import LatentDynamics
    from lns_tpu_torch.ops.initializers import init_weights_

    gen = torch.Generator().manual_seed(0)
    cond_gen = torch.Generator().manual_seed(5)  # path 5's weights and GroupNorm inputs
    paths = []  # (label, model, expected launches, batch, steps, decode chunk)
    gn_sites, fab_sites = {}, {}  # summed over one predict of each NS2d path
    for label, cfg, size in (
            ("path 1 NS2d", ns2d_config(), (BATCH, STEPS, CHUNK)),
            ("path 2 NS2d use_attn_enc", ns2d_config().replace(use_attn_enc=True),
             (BATCH, STEPS, CHUNK)),
            ("path 3 SW", sw_config(), (SW_BATCH, SW_STEPS, None)),
            ("path 4 two-phase", twophase_config(), (TP_BATCH, TP_STEPS, None)),
            ("path 5 conditional two-phase", twophase_conditional_config(),
             (TP_BATCH, TP_STEPS, None)),
            ("path 6 NS2d Fourier layers", fourier_config(), (BATCH, STEPS, CHUNK))):
        # initialised on the CPU from the seeded generator, then moved
        g0 = cond_gen if cfg.is_conditional else gen
        model = init_weights_(LatentDynamics(cfg, dtype=torch.bfloat16, ae_dtype=torch.bfloat16,
                                             device="cpu"), g0)
        if cfg.is_conditional:
            _open_gates(model, g0)
        model = model.to(dev)
        b, steps, chunk = size
        gn, fab = call_sites(model, dev, b, steps, chunk)
        n_chunks = -(-b * steps // (chunk or b * steps))
        # bf16 on the card: a conditional propagator runs kernel 1's FiLM plan
        expect = expected_launches(cfg.replace(mixed_precision=True), n_chunks=n_chunks,
                                   steps=steps)
        ae_gn = expected_launches(cfg, n_chunks=n_chunks)["group_norm"]
        _check(sum(gn.values()) == ae_gn,
               f"{label}: autoencoder GroupNorm calls found {sum(gn.values())} == spec count "
               f"{ae_gn}")
        for impl, k in (("batchedgram", "fab_core"), ("batched", "fab_axial_in_fused")):
            found = {s: c for s, c in fab.items() if s[-1] == impl}
            _check(sum(found.values()) == expect[k],
                   f"{label}: {impl} FAB calls found {found} == spec count {expect[k]}")
        paths.append((label, model, {k: v for k, v in expect.items() if v}, size))
        if cfg.workload == "sw":
            sw_gn, sw_fab = gn, fab
            continue
        if cfg.workload == "twophase":
            tp_gn = gn
            continue
        if cfg.is_conditional:  # its autoencoder's sites are path 4's
            # the module step's sites (the f32 predict and training step as modules)
            tpc_gn = cond_gn_sites(model, dev, b, steps)
            loop_gn = expected_launches(cfg, n_chunks=n_chunks, steps=steps)["group_norm"]
            _check(sum(tpc_gn.values()) == loop_gn - ae_gn,
                   f"{label}: propagator GroupNorm calls found {sum(tpc_gn.values())} == "
                   f"{steps} steps x {3 * cfg.prop_n_block + 1} + {cfg.prop_n_block} "
                   f"({loop_gn - ae_gn}) as modules; the bf16 predict launches kernel 3 "
                   f"{expect['group_norm']} times and kernel 1's FiLM plan once")
            continue
        for sites, new in ((gn_sites, gn), (fab_sites, fab)):
            for s, c in new.items():
                sites[s] = sites.get(s, 0) + c

    def fab_shapes(sites, impl):  # {(batch, h, w, c): calls}
        out = {}
        for (_, b, h, w, c, i), calls in sites.items():
            if i == impl:
                out[(b, h, w, c)] = out.get((b, h, w, c), 0) + calls
        return out

    cfg = paths[0][1].cfg
    n, d = cfg.attn_heads, cfg.attn_dim
    train_sites = train_gn_sites(paths[0][1], dev)
    _check(sum(train_sites.values()) == (2 * cfg.prop_n_block + 1) * cfg.out_tw,
           f"stage-2 train step: GroupNorm calls found {train_sites} == "
           f"{2 * cfg.prop_n_block + 1} per step x out_tw {cfg.out_tw}")
    sw, tp, tpc = paths[2][1], paths[3][1], paths[4][1]
    fam_train_sites = {}
    for fam, m in (("SW", sw), ("two-phase", tp), ("conditional two-phase", tpc)):
        found = fam_train_sites[fam] = train_gn_sites(m, dev)
        _check(sum(found.values()) == train_step_gn(m.cfg),
               f"{fam} stage-2 train step: GroupNorm calls found {found} == "
               f"{train_step_gn(m.cfg)} (out_tw {m.cfg.out_tw})")
    print("-- kernels against their plain versions (TF32 off)", flush=True)
    t0 = time.perf_counter()
    res = {"prop_rollout": check_rollout(dev, gen, 2, tp.propagator),
           "fab_core": _summed(check_fab_core(dev, gen, fab_shapes(fab_sites, "batchedgram"),
                                              n, d),
                               check_fab_core(dev, gen, fab_shapes(sw_fab, "batchedgram"),
                                              sw.cfg.decoder_attn_heads, sw.cfg.decoder_attn_dim,
                                              extras=False)),
           "group_norm": _summed(
               _summed(check_group_norm(dev, gen, gn_sites, train_sites,
                                        label="NS2d paths 1, 2 and 6"),
                       check_group_norm(dev, gen, sw_gn, fam_train_sites["SW"], label="SW",
                                        extras=False)),
               tp_res := check_group_norm(dev, gen, tp_gn, fam_train_sites["two-phase"],
                                          label="two-phase", extras=False))}
    # path 5: its autoencoder's sites are path 4's (checked and timed there,
    # counted again per predict), and its propagator's module-step sites
    # (its f32 predict and its training step; the bf16 predict takes kernel
    # 1's FiLM plan, held here on path 5's propagator)
    res["group_norm"] = _summed(_summed(res["group_norm"], tp_res), check_cond_group_norm(
        dev, cond_gen, tpc_gn, fam_train_sites["conditional two-phase"]))
    res["prop_rollout_film"] = check_cond_rollout(dev, cond_gen, tpc)
    check_fab_core_limits(dev, n, d)
    check_fab_core_heads(dev, gen)
    res["fab_axial_in_fused"], res["axial_kernel_apply_headmajor"] = check_axial(
        dev, gen, fab_shapes(fab_sites, "batched"), n, d)
    res["bmm_blockdiag"], res["transpose_hw"] = check_pipeline(dev, gen, n, d)
    check_fab_cores(dev, gen, sorted({**fab_shapes(fab_sites, "batchedgram"),
                                      **fab_shapes(fab_sites, "batched")}), n, d)
    check_activations(dev, gen)
    print(f"      comparisons took {time.perf_counter() - t0:.1f} s", flush=True)

    by_path = {}
    for label, model, expect, (b, steps, chunk) in paths:
        by_path[label] = drive_path(label, model, expect, gen, dev, b, steps, chunk)
        del model
    shard_gen = torch.Generator().manual_seed(9)
    by_path.update(drive_sharded(dev, smi, [p for p in paths if p[0] in SHARDED_PATHS],
                                 shard_gen))
    check_debug_tools(dev, paths[0][1], shard_gen, smi)
    del paths, sw, tp, tpc
    check_fourier(dev, smi)
    by_path["path 7 conditional encoder"], cond_enc_res = drive_cond_encoder(dev, smi)
    by_path["library blocks"], library_res = drive_library(dev, smi)
    res["group_norm"] = _summed(_summed(res["group_norm"], cond_enc_res), library_res)
    by_path["stage-2 training"], by_path["evaluate NS2d"] = drive_stage2(dev, smi)
    by_path["stage-1 training"] = drive_stage1(dev, smi)
    for fam in FAMILIES:
        with tempfile.TemporaryDirectory() as tmp:
            by_path[f"{fam} stage-1 training"], ae_path = drive_family_stage1(fam, dev, smi, tmp)
            by_path[f"{fam} stage-2 training"], by_path[f"evaluate {fam}"] = \
                drive_family_stage2(fam, dev, smi, tmp, ae_path)
    by_path.update(drive_ddp(dev, smi))
    by_path.update(drive_solvers(dev, smi))
    by_path["probe kernels"], probe_res = check_probes(dev)
    res.update(probe_res)

    src, tpu, probes = "lns_tpu_torch/csrc/", "lns_tpu/pallas_kernels/", "benchmarks/"
    kernels = [
        ("prop_rollout", "cuda", src + "prop_rollout.cu", tpu + "prop_rollout.py:292"),
        # the JAX package steps a conditional propagator as modules (its scan)
        ("prop_rollout_film", "cuda", src + "prop_rollout.cu",
         "lns_tpu/models/latent_dynamics.py:175"),
        ("fab_core", "cuda", src + "fab_core.cu", tpu + "fab_core.py:170"),
        ("group_norm", "cuda", src + "group_norm.cu", tpu + "group_norm.py:50"),
        ("fab_axial_in_fused", "cuda", src + "axial.cu", tpu + "axial_fused.py:132"),
        ("axial_kernel_apply_headmajor", "cuda", src + "axial.cu", tpu + "axial_attention.py:75"),
        ("bmm_blockdiag", "cuda", src + "axial_pipeline.cu", tpu + "axial_pipeline.py:59"),
        ("transpose_hw", "cuda", src + "axial_pipeline.cu", tpu + "axial_pipeline.py:87"),
        ("blocked_copy", "cuda", src + "blocked_copy.cu", probes + "probe_pallas_bw.py:53"),
        ("fab_mega_stats", "cuda", src + "fab_mega.cu", probes + "probe_fab_mega.py:167"),
        ("fab_mega_apply", "cuda", src + "fab_mega.cu", probes + "probe_fab_mega.py:230"),
        ("interior_dot", "cuda", src + "mosaic_dots.cu", probes + "probe_fab_mega.py:81"),
        ("dot_general", "cuda", src + "mosaic_dots.cu", probes + "probe_mosaic_dots.py:305"),
        ("dot_chain", "cuda", src + "mosaic_dots.cu", probes + "probe_mosaic_dots.py:305"),
    ]
    return [{"name": name, "route": route, "source": source, "replaces": rep,
             "launches": sum(counts[name] for counts in by_path.values()),
             "launches_by_path": {label: counts[name] for label, counts in by_path.items()},
             **res[name]} for name, route, source, rep in kernels]


def _summed(a, b):
    """Two kernel results (each summed over its paths' predicts) as one:
    times and bounds added, the larger error, the bound's larger part."""
    out = {"max_abs_err": max(a["max_abs_err"], b["max_abs_err"])}
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
        if k in a:
            out[k] = None if a[k] is None else a[k] + b[k]
    out["bound_by"] = a["bound_by"] if a["bound_ms"] >= b["bound_ms"] else b["bound_by"]
    return out


if __name__ == "__main__":
    sys.exit(main())
