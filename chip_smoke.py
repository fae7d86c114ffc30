"""Drive the PyTorch port on one CUDA card and check it: the evaluation and
train steps, the visualization render, the entry points, the dense-list
configuration, the value scatter, adversarial scenes for the visibility and
fused-interp backward kernels and adversarial uvs for the fused trilinear
sampler, the tracker loop, the NeRSemble path (the calibrated 16-view
step with the teeth head, track_nersemble, and the NeRF-dataset export),
preprocess (the FAN, STAR and matting networks, then a video through
preprocess, annotation inside the tracker and tracking), the native frame
loader, the synthetic FAN and matting trainers, the headless viewer and
editor, and batch-axis data parallelism (parallel/sharding.py).

    python3 chip_smoke.py               # every phase, one card
    python3 chip_smoke.py --multi-card  # phases 1-2 and 30d alone

Runs vhap_tpu_torch's evaluation energy (the render and energy of one
tracking step, forward) and one `rgb_sequential_tracking` train step
(render -> energy with the stage's regularizers and the cluster
disturbance -> backward -> leaf-lr Adam) at the bench's full width: batch
16, 512x512, texture 2048, n_shape=300, n_expr=100, SH lighting,
antialias, residual texture and static offset, on the FLAME asset loader's
head (a synthetic stand-in unless the FLAME files are present); see
vhap_tpu_torch/tools/eval_slice.py and train_slice.py.

Phases (any failure ends the run with a non-zero exit):
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build the CUDA kernels from vhap_tpu_torch/csrc (nvcc), printing the
     build seconds and ptxas' register and spill lines;
  3. the eval path: launch counts set to 0, one evaluation step through
     the kernels, counts read back; K1, K2f and K3 must each have launched
     once, and the outputs must be finite and plausible;
  4. K1, K2f and K3 against their plain PyTorch versions on the eval
     step's own inputs (K1 visibility: tri_id identical; K2f fused interp:
     1e-5 * max(1, |ref|) on foreground pixels); K3 (the fused trilinear
     sample) and K4 (its backward) at the step's own sampler launch
     (check_sampler: out 1e-5 absolute on every pixel and 0 pixels whose
     taps, formed by the kernels' own tap code, choose another level or
     texel; d_uv and d_uv_da 1e-4, dflat 1e-5 of max|ref| per channel
     against the plain backward in float64); each kernel timed by its
     device ms
     (torch.profiler, summed over 20 calls, L2 flushed before each) and
     its wrapper's CUDA-event ms (median of 20 launches after warm-up),
     with the bound from this run's bytes and operations;
  5. the whole eval step through the plain versions: E_total and the
     photometric term agree to 1e-4 relative and the landmark term
     exactly; then the step's time, frames/s and peak memory;
  6. the train path: launch counts set to 0, one train step through the
     kernels with the disturbance on, counts read back; K1, K2f, K3, K2b
     and K4 must each have launched once; E and every gradient finite,
     every optimizable leaf changed, every frozen leaf bit-identical, the
     stage's regularizer terms in the log;
  7. K2b (fused interp backward) against its plain version at the train
     step's own launch (its saved (B, F, C) table, tri_id and per-output
     cotangents, captured in phase 6; the timed call) and for a seeded
     random cotangent on every output group (1e-4 * max|ref| per table
     row); K3 and K4 at the step's own sampler launch and cotangent, as in
     4 (the timed K4 call); timed and bounded as in 4;
  8. the train step through the plain versions, disturbance off, against
     the kernels' with the disturbance off: E_total and each log term to
     1e-4 relative, each optimizable leaf's gradient to 1e-3 * max|g|;
     then the train step's time (disturbance on), tracked frames/s =
     16 / (50 * step) (bench.py:186), peak memory and the plain step's time;
     the zero fills and adds one train step makes on per-pixel tensors
     (torch.profiler with shapes), those on the (B, 20 + nf, H, W) channel
     buffer beside the previous design's (a constant);
  9. the vis path (tools/vis_slice.py, the eval step's scene): launch
     counts set to 0, one `render_rgba_vis` and one gradient of the
     nvdiffrast-style chain (rasterize -> interpolate -> texture_sample ->
     shade -> antialias_rast) with a seeded random cotangent, counts read
     back; K5 (the visibility kernel under rasterize()), K6 forward and
     backward, K3 and K4 must each have launched; outputs finite, gradients
     finite and nonzero; K3 and K4 at the gradient's own sampler launch;
 10. K5: rasterize()'s tri_id identical to visibility_plain at the vis
     inputs (cull on) and on the UV layout at 2048^2 (cull off, batch 1);
 11. K6 forward bit-identical to torch.gather at each of the path's gathers
     (rast planes C=12, corner normals 9, corner uvs 6, AA planes 6 and
     vertex ids 3); 12. K6 backward within 1e-5 * max|ref| per channel of a
     float64 scatter_add_, for a random cotangent on every pixel; both
     timed and bounded as in 4, with torch.gather / scatter_add_ as the
     library calls;
 13. the vis render through the kernels vs use_kernels=False, every output
     within 1e-5 absolute, and K3 and K4 at the render's own (unmasked)
     sampler launch;
 14. the chain's gradients (vertices, texture) through the kernels vs the
     plain versions within 1e-3 * max|g|; the vis render's time and
     frames/s, kernels and plain;
 15. the entry points on the card, into a temporary directory:
     make_synthetic_sequence (16 frames at 512^2), generate_multiview (16
     cameras x 2 frames at 512^2) and generate_flame_uvmask (2048^2, the
     synthetic head's regions), timed per frame;
 16. the dense configuration (render.bin_mode='dense', the JAX package's
     K7 path): the eval and train steps rebuilt with it, counts zeroed
     before each and read after (K1, K2f, K3 once in the eval step; K1, K2f,
     K3, K2b, K4 once in the train step; K3 and K4 at each step's own
     sampler launch); against the flat configuration on
     the same inputs and generator seed, outputs within 1e-6 absolute,
     energy and terms 1e-6 relative, overflow 0, gradients within
     DENSE_GRAD_TOL * max|g|, beside two flat runs' own differences (the
     atomics' order); K2f timed at these inputs and K2b at the dense train
     step's own launch are the K7 rows;
 17. K8 (scatter_taps) on the train step's own taps (trilinear_taps of its
     sampler launch) with vals = wgt * g for the step's own cotangent
     (16 x 8 x 3 x 262,144, ~400 MB), counts zeroed: one launch; within
     1e-5 * max|ref| of a float64 index_add_ and of K4's dflat for the same
     uv, uv_da and g; timed and bounded as in 4, float32 index_add_ as the
     library call;
 18. K1 and K2b on the adversarial scenes of tools/raster_scenes.py
     (equal-z ties and -0.0, a face over most of the image, near-plane
     straddlers, a tile of 256 winning faces over 1256 candidates, ragged
     sizes), each at its own size and at 250 x 333: tri_id identical to
     visibility_plain; K2b within 1e-4 * max|ref| per row of its plain
     version for nf = 0 and 2 with some output groups' cotangent None;
     then K3 and K4 as in 4 on tools/texture_cases.py's uvs at the train
     step's width and texture (integer lods, lod L - 1, fx2 == fy2 ties,
     texel-centre uvs, uvs on and beyond [0, 1], masked and zero-cotangent
     pixels), uv and uv_da as plane views;
 19. the tracker loop: GlobalTracker at full width (batch 16, 512^2,
     texture 2048, 300/100, SH, static offset, residual texture,
     disturbance on) and reduced depth (tools/loader_ab.MONO_STEPS, one
     global epoch) on a 32-frame sequence from the port's generator, media
     every 25 steps into a temporary directory, counts zeroed before and
     read after: K1, K2f, K3 once per rgb train step and evaluation
     render, K2b, K4 once per rgb train step; K3 and K4 checked as in 4 at
     the last rgb step's sampler launch; the batch-0 eval energy falls;
     the checkpoint has the reference npz schema; per-stage median ms/step,
     the loop's ms/step against the single train step's (phase 8), wall per
     tracked frame, the media split and peak memory; then a second tracker
     resumed from the run state written after the sequential phase runs
     the global phase; every batch of the run through the native frame
     loader (none through PIL), and the rgb stages' ms/step beside their
     figures before it (PRIOR_STAGE_MS);
 20. GT recovery: tools/validate.py's reduced schedule (16 frames at 256^2,
     batch 8) must PASS its rule (rot < 0.1 rad, trans < 0.02);
 21. the calibrated multiview step at full width (tools/multiview_slice.py):
     a rig of 16 cameras x MV_TRACK_FRAMES timesteps at 512^2 written by
     tools/make_synthetic_multiview.py with the teeth head of
     tools/surgery_regions.py, its inner lips removed so that the teeth
     show (3,192 vertices, 6,128 faces), and a seeded near-identity affine
     colour correction per camera, read through the port's
     NeRSembleDataset; one eval step (counts zeroed: K1, K2f, K3 once) and
     one train step of bench.py's metric-3 configuration
     (BaseTrackingConfig's rgb_sequential_tracking, texture optimized)
     with the disturbance on (all five once), 16 views of one timestep;
     there must be pixels won by teeth faces; K1, K2f, K3 at the eval
     step's own launch, K2b, K3 and K4 at the train step's, each against
     its plain version as in 4 and 7, K3 and K4 also on the teeth pixels
     alone; the eval step against the plain path (1e-4) and the train
     step's terms (1e-4 relative) and gradients (1e-3 * max|g|), the
     disturbance off; the step's ms (median of 10 after 2 warm-ups),
     device-busy ms (torch.profiler) and peak memory;
 22. `python -m vhap_tpu_torch.track_nersemble` through its main() on that
     rig, full width, reduced depth (tools/loader_ab.MV_STEPS: landmark
     stages, the rgb stages, one global epoch, disturbance on), counts zeroed before
     and read after (K1, K2f, K3 once per rgb step and evaluation render,
     K2b and K4 once per rgb step; K3 and K4 checked at the last rgb
     step's launch); GT recovery (mean |d translation| < 0.02, mean |d
     rotation| < 0.08), no focal_length in the npz, timestep 0's eval
     energy below its value at the initial parameters (main() returns the
     run's summary: the run state is read into a second tracker of the
     same config for that energy); every batch through
     the native loader (colour correction in C++), the rgb stages' ms/step
     beside PRIOR_STAGE_MS;
 23. export_as_nerf_dataset of that run (FLAME on the card, the mask from
     the mesh on) and once more without the mask, then
     combine_nerf_datasets of the two: transforms*.json schema and splits,
     every flame_param npz, canonical_flame_param.npz, and the mask taking
     foreground below the neck line and none above it;
 24. the preprocess networks at full width (preprocess/{fan,star,matting}
     .py): FAN(4) (4 modules, depth 4, 256 features, 68 landmarks; seeded,
     its BN statistics baked by finalize_bn_stats on the card), STAR (4
     stacks, depth 4, 256 features; seeded), the bundled FAN and U-Net on
     seeded 256^2 crops at batch 1 and 16, the U-Net also on 512^2 frames;
     cuDNN TF32 left on process-wide (torch's default) so that the
     networks' own full_float32() is what is tested; each output of the
     batch-1 call against the same module in float64 on the CPU and the
     batch-16 call against the batch-1 call (PRE_TOL * max|ref| per
     output; the last heatmaps' argmaxes equal wherever the float64 top-2
     margin is over the tolerance); ms per image at batch 1, images/s at
     batch 16 (CUDA events), device ms (torch.profiler), convolution
     TFLOP/s and the peak memory above the resident at batch 16;
 25. preprocess -> track: a 16-frame 512^2 sequence from the port's
     generator written as an mp4 with OpenCV, then `preprocess` (OpenCV
     frame extraction, 'matting_jax': the bundled U-Net on the card) and
     GlobalTracker with landmark_source 'fan-jax' and its default 8
     detector threads, which annotates on construction with the bundled
     FAN on the card and tracks at phase 19's depth, counts zeroed before
     and read after (K1, K2f, K3 once per rgb step and evaluation render,
     K2b and K4 once per rgb step), every parameter finite; the first and
     last frames' detections (both passes' heatmaps within PRE_TOL, the
     box equal unless a whole-image argmax lies under the top-2 margin,
     landmarks over the margin equal) and alpha maps (the U-Net's within
     ALPHA_TOL, refined within REFINED_ALPHA_TOL) against the port's CPU
     run on the same JPEGs; ms per frame for matting and detection, the
     chain's wall. Landmark accuracy is not gated: the bundled FAN was
     trained on renders of the FLAME template and misses on the stand-in;
     every tracker batch through the native loader;
 26. the native frame loader (data/native_loader.py): built from
     vhap_tpu_torch/native by g++ (a failed build fails the run); one
     timestep of a 16-camera rig with per-camera colour correction, alpha
     maps and a white background, at 512^2 and at NeRSemble's raw 3208 x
     2200 scaled by 0.25 to 802 x 550, through load_batch_native and
     through PIL (getitem_single_image per view): within NATIVE_TOL, ms
     per 16-frame batch of each;
 27. train_fan_synthetic's main() at the tool's full width (batch 8,
     256^2, the bundled FAN's width: 64 features, 1 module, depth 3, 70
     landmarks; head 50/30, texture 256), TRAIN_STEPS deep, its weights
     under build/, counts zeroed before and read after: K5 and K3 once per
     render, K6 forward a whole number of times per render; at the last
     render the render through the kernels against use_kernels=False
     (1e-5), K5 tri_id identical, every plane gather bit-identical, K3 as
     in 4 (check_k3); ms per step split into render and network, device ms
     per step, peak memory above the resident, the held-out error (batch 1,
     stored BN statistics), the weights through LandmarkDetectorFANNet;
 28. train_matting_synthetic's main() likewise (the bundled U-Net),
     the held-out mean |d alpha|, the weights through MattingUNet; the
     bundled weights' sha256 unchanged by 27-28;
 29. flame_viewer's main() on phase 22's tracked archive with the teeth
     head at 768^2 (PNG frames; mp4 only with ffmpeg) and flame_editor's
     main() jaw sweep, counts zeroed before and read after each; the
     kernels at the last render as in 27; every frame not blank and
     within VIEW_LEVELS on VIEW_SHARE of the values of the same call with
     use_kernels=False; a highlighted region; ms per frame;
 30. batch-axis data parallelism (parallel/sharding.py) on phase 21's rig:
     30a two gloo ranks on cuda:0 (sharding.launch), each the 16-view step
     on its 8 views (tools/multiview_slice.py on the process group): with
     the disturbance off, E (the sum of the ranks' shares) within 1e-5
     relative and every all-reduced gradient within 1e-3 * max|g| of the
     one-process step on the same card, the gradients bit-identical across
     ranks; on rank 0, K1 identical to its plain version and K3 within
     1e-5 at the rank's own eval-step launch; then SHARD_STEPS steps with
     the disturbance on through the tracker's graphed step, every call
     eager under gloo, counts zeroed before and read after (K1..K4 once
     per step on each rank), the parameters bit-identical across ranks;
     each rank's ms per step and peak memory, all_reduce_grads' bytes and
     ms; 30b GlobalTracker with track_nersemble's config at phase 22's
     depth on the two gloo ranks (counts per rank as in 22, every batch
     native, multiview GT recovery at phase 22's gate, rank 0's folder
     with phase 22's file names), then a resume from the run state after
     the sequential phase (the global stage alone, recovery again); 30c
     NCCL at world 1 through the same launcher, at 30a's gates, the step
     captured with its collectives on its second call and replayed after
     it (K1..K4 once per replay), K3/K4 held to their plain versions at
     rank 0's last replayed launch; 30d as 30c across min(4, count) cards
     where there are two or more, on a rig of 16 views at 802x550 (on four
     cards 4 views a rank, the nersemble16.seq.x4 cell's batch), else a
     line saying it was not run;
each phase group's seconds are printed as it ends, and each kernel's time
beside the previous kernels' time, a constant (PRIOR_MS); then one JSON
line of the kernels (each row's `launches` from the train step, and
`launches_by_path` with its count on every path above that runs it),
nvidia-smi's line, and the result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPS = 20

# Published H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM3 bytes/s
# and float32 (non-tensor-core) FLOP/s, at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# flops per unit of work, counted from the kernels' source
K1_FLOPS_PER_CANDIDATE = 23   # pixel center, 3 edge planes, z plane, signs
K2_FLOPS_PER_FG_PIXEL = 118   # csrc/interp.cu, one foreground pixel
K1_ROW_FIELDS_READ = 17       # setup row fields visibility.cu reads (A0X..VALID)
# csrc/interp_bwd.cu, one foreground pixel: 85 to recompute the forward's
# intermediates, ~197 for the adjoint, 38 row adds (36 + nf, nf = 2)
K2B_FLOPS_PER_FG_PIXEL = 320
# csrc/trilinear.cuh + texture_fetch.cu, one covered pixel: the lod 18, the
# level share 1, two levels' corners 2 x 16, the 8 tap weights 8
K3_FLOPS_PER_PIXEL = 59
K3_FLOPS_PER_LIVE_TAP = 6         # 3 channels x (mul + add)
# csrc/texture_scatter.cu, one live pixel: the taps again 59, 8 texel . g
# 40, the bilinear and level-share adjoints 2 x 31, d_uv 8, the lod chain
# to d_uv_da 16
K4_FLOPS_PER_LIVE_PIXEL = 185
K4_FLOPS_PER_LIVE_TAP = 6         # dflat: 3 channels x (mul + atomic add)
# each kernel's time measured by this script on the previous kernels (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md), printed in the log beside this run's and
# never in the kernels line: the wrapper's CUDA-event ms. K3/K4 were a
# gather and a scatter of (B, 8, P) idx/wgt taps formed in eager PyTorch;
# the other kernels are unchanged and show the call-to-call drift
PRIOR_MS = {"K1 visibility": 0.0526, "K2f fused_interp": 0.1611,
            "K3 trilinear_sample": 0.1165, "K2b fused_interp_bwd": 0.0849,
            "K4 trilinear_sample_bwd": 0.1280, "K5 visibility": 0.0534,
            "K6f plane_gather": 0.0879, "K6b plane_gather_bwd": 0.1330,
            "K7f fused_interp (dense)": 0.2154,
            "K7b fused_interp_bwd (dense)": 0.0846, "K8 scatter_taps": 0.2864}
# the train step's zero fills and adds on the (16, 22, 512, 512) channel
# buffer when the render sliced one channel tensor (calls, device ms;
# tools/profile_eval.py, same card)
PRIOR_CHANNEL_BUFFER_OPS = {"aten::zero_": (9, 1.0062), "aten::add_": (8, 2.8595)}
TRAIN_STEPS_PER_BATCH = 50        # bench.py STEPS_PER_BATCH: frames/s = B / (50 step)
UV_RES = 2048                     # the UV-mask bake (generate_flame_uvmask's default)
SEQ_FRAMES = 16                   # make_synthetic_sequence frames at 512^2
MV_CAMS, MV_FRAMES = 16, 2        # generate_multiview cameras x frames at 512^2
# dense vs flat configuration: the same kernels on the same inputs. The
# atomics' order (K2b, K4, index_add_ in the vertex normals and autograd's
# index backward) varies between runs: two runs of the flat configuration
# differ by up to 6e-5 of a leaf's max|g| on the bench's scene, so the
# gradients are held as the kernels are held against the plain path
DENSE_GRAD_TOL = 1e-3
# the tracker loop: full width (batch 16, 512^2, texture 2048, 300/100),
# reduced depth (tools/loader_ab.mono_config, MONO_STEPS)
LOOP_FRAMES = 32
# the NeRSemble path (phases 21-23): a 16-view rig of MV_TRACK_FRAMES
# timesteps at 512^2 with the teeth head; track_nersemble at full width,
# reduced depth (tools/loader_ab.mv_argv, MV_STEPS)
MV_TRACK_FRAMES = 4
RECOVERY_SCHEDULE_SCALE = 1.0     # tools/validate.py's reduced schedule
# the preprocess networks (phases 24-25): the detectors' 256^2 crops at
# batch 1 (what they run) and 16, the U-Net also on 512^2 frames; card
# outputs (full float32) against the same module in float64 on the CPU:
# every output within PRE_TOL * max|ref|, alpha within ALPHA_TOL
PRE_CROP, PRE_FRAME, PRE_BATCH = 256, 512, 16
PRE_TOL = 1e-4
ALPHA_TOL = 1e-4
# the refined alpha: the guided filter (host float32, the JAX package's
# algorithm) takes its box means from float32 integral images of the 512^2
# frame (sums up to 2.6e5, ulp 1/64), so a 2.6e-6 change in the U-Net's
# alpha moved the refined alpha by 1.16e-3 (NVIDIA H100 80GB HBM3, frame 15)
REFINED_ALPHA_TOL = 1e-2
PRE_FRAMES = 16                   # phase 25's sequence at PRE_FRAME^2
# the native frame loader (phase 26): NeRSemble's raw camera frames (portrait
# 2200 x 3208, vhap_tpu_torch/native/frameloader.cpp) cut by scale_factor 0.25
# to the 802x550 recipe; native against PIL within the bound of
# tests/test_native_loader.py where a resize runs
NATIVE_FRAME = (3208, 2200)       # (H, W)
NATIVE_SCALE = 0.25
NATIVE_TOL = 3 / 255
# ms/step of phases 19 and 22 through PIL, before the native loader (PERF.md
# §5; NVIDIA H100 80GB HBM3, 700 W), printed beside this run's (constants)
PRIOR_STAGE_MS = {"tracker loop": {"rgb_sequential_tracking": 106.468,
                                   "rgb_global_tracking": 142.692},
                  "track_nersemble": {"rgb_sequential_tracking": 97.649,
                                      "rgb_global_tracking": 443.435}}
# the synthetic trainers (phases 27-28) at the tools' full width (batch 8,
# 256^2, the bundled FAN's and U-Net's widths, head 50/30, texture 256), depth
# cut from 1,500 (FAN) and 1,200 (U-Net) steps
TRAIN_STEPS = {"fan": 150, "matting": 150}
TRAIN_BATCH = 8
# the viewers (phase 29) at 768^2: each card frame against the same call with
# use_kernels=False (outputs within 1e-5 before the uint8 cast) within one
# level on at most 0.1 % of the values
VIEW_LEVELS, VIEW_SHARE = 1, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class L2Flush:
    """A 64 MB device-to-device copy before each timed launch (the eval
    step meets these inputs cold); the profiler names it "Memcpy DtoD",
    apart from every kernel's own ops."""

    def __init__(self):
        self.src = torch.zeros(64 * 2**20 // 4, device="cuda")
        self.dst = torch.empty_like(self.src)

    def __call__(self):
        self.dst.copy_(self.src)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() over `reps` launches, L2 flushed
    before each: the wrapper's time, host work between the events
    included."""
    flush = L2Flush()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, reps: int = REPS):
    """Device ms per call of fn() by device op name: torch.profiler over
    `reps` calls, L2 flushed before each as in cuda_ms, the flush's copies
    left out. A session that records no device op is run once more, over
    more calls; {} if that one records none either."""
    from torch.profiler import ProfilerActivity, profile
    flush = L2Flush()
    fn()
    torch.cuda.synchronize()
    for n in (reps, 3 * reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush()
                fn()
            torch.cuda.synchronize()
        ops = {ev.key[:48]: ev.self_device_time_total / 1e3 / n
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.key.startswith("Memcpy DtoD")}
        if ops:
            return ops
    return {}


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script measures the port on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return line


def build_kernels() -> None:
    from vhap_tpu_torch.ops import kernels
    rep = kernels.build()
    log(f"[build] {'built' if rep.built else 'cached'} {rep.path.name} "
        f"in {rep.seconds:.2f} s")
    for ln in rep.log.splitlines():
        if ln.startswith("==") or any(k in ln for k in (
                "Compiling entry", "registers", "spill")):
            log(f"[build]   {ln.strip()}")
    kernels.library()


def run_step(energy_fn, params, batch):
    with torch.no_grad():
        out = energy_fn(params, batch)
    torch.cuda.synchronize()
    return out


def check_k1(s, verts_clip):
    """K1 against visibility_plain: tri_id identical on every pixel."""
    from vhap_tpu_torch.ops.rasterize import (_Visibility, face_setup,
                                              pack_setup_rows, visibility,
                                              visibility_plain)
    (H, W), B, faces = s.image_size, verts_clip.shape[0], s.head.faces
    tri_k, _ = visibility(verts_clip, faces, H, W)
    tri_p, _ = visibility_plain(verts_clip, faces, H, W)
    n_diff = int((tri_k != tri_p).sum())
    if n_diff:
        raise RuntimeError(f"K1: tri_id differs from the plain version on "
                           f"{n_diff} pixels")
    setup = face_setup(verts_clip, faces)
    rows = pack_setup_rows(setup)
    n_cand = k1_candidates(setup, H, W)
    n_valid = int(setup["valid"].sum())
    n_rows = rows.shape[0] * rows.shape[1]
    # timed: the launch on the packed setup rows (the plain version's time
    # includes its own face setup, a few small elementwise ops)
    return tri_k, dict(
        name="K1 visibility", source="vhap_tpu_torch/csrc/visibility.cu",
        replaces="vhap_tpu/ops/rasterize_pallas.py:208", max_abs_err=0.0,
        kernel=lambda: _Visibility.apply(rows, H, W),
        plain=lambda: visibility_plain(verts_clip, faces, H, W),
        # the fields of a valid face's row read, only VALID of the others;
        # the id map written
        n_bytes=(n_valid * K1_ROW_FIELDS_READ + (n_rows - n_valid)) * 4
                + B * H * W * 4,
        n_flops=n_cand * K1_FLOPS_PER_CANDIDATE,
        note=f"tri_id identical on {B * H * W} pixels; {tile_bins(rows, H, W)}")


def check_k2(s, verts_clip, verts, tri_id, name="K2f fused_interp",
             replaces="vhap_tpu/ops/interp_pallas.py:379"):
    """K2 against fused_interp_plain: 1e-5 * max(1, |ref|) on foreground."""
    from vhap_tpu_torch.ops.interp import (fused_interp, fused_interp_plain,
                                           join_channels)
    from vhap_tpu_torch.ops.render import pack_face_tables
    from vhap_tpu_torch.tracker.energy import render_verts_uv
    packed = pack_face_tables(verts_clip, verts, s.head.faces,
                              render_verts_uv(s.head, "cuda"), s.head.textures_idx)
    ch_k = join_channels(fused_interp(packed, tri_id, 0)[0])
    ch_p, _ = fused_interp_plain(packed, tri_id, 0)
    fg = (tri_id > 0)[:, None]
    diff = (ch_k - ch_p).abs() * fg
    err = float(diff.max())
    rel = float((diff / ch_p.abs().clamp(min=1.0)).max())
    if not rel <= 1e-5:
        raise RuntimeError(f"{name}: error {rel} over 1e-5 * max(1, |ref|)")
    n_fg = int(fg.sum())
    n_faces = int(torch.unique(tri_id[tri_id > 0]).numel())
    return ch_k, dict(
        name=name, source="vhap_tpu_torch/csrc/interp.cu",
        replaces=replaces, max_abs_err=err,
        max_rel_err=rel,
        kernel=lambda: fused_interp(packed, tri_id, 0),
        plain=lambda: fused_interp_plain(packed, tri_id, 0),
        # tri_id read, channels written, each visible face's row read once
        n_bytes=tri_id.numel() * 4 + ch_k.numel() * 4 + n_faces * packed.shape[1] * 4,
        n_flops=n_fg * K2_FLOPS_PER_FG_PIXEL,
        note=f"abs err {err:.3g}, rel err {rel:.3g} on {n_fg} foreground "
             f"pixels, {n_faces} faces")


@contextlib.contextmanager
def capture_sampler(keep_last: bool = False):
    """Record the arguments of every fused-sampler launch inside the block:
    {"fwd": [(flat1, uv, uv_da, mask, offsets, sizes)], "bwd": [(flat1, uv,
    uv_da, mask, offsets, sizes, g)]} (K3 through trilinear_sample, K4
    through ops/texture_fetch._launch_bwd); the wrappers still launch.
    keep_last keeps only the newest of each. A K4 launch recorded into a
    CUDA graph goes to "graph_bwd" as (graph, arguments), the tensors cloned
    inside the graph: a replay calls no wrapper, but rewrites the clones
    with its own launch's arguments (keep_last keeps those of the last two
    graphs captured, one step's pair); replayed_launch() picks the graph
    that replayed last, whose clones no later replay has overwritten (a
    graph's clones may lie in pool memory the other graph's replay reuses).
    K4's arguments hold K3's; K3 launches recorded into a graph are left
    out."""
    from vhap_tpu_torch.ops import texture_fetch as tf
    captured = {"fwd": [], "bwd": [], "graph_bwd": [], "replayed": None}
    sampler, launch_bwd = tf._TrilinearSample, tf._launch_bwd
    Graph = torch.cuda.CUDAGraph
    begin, replay = Graph.capture_begin, Graph.replay
    capturing, order = [None], []

    def record(kind, args):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            if kind == "bwd":
                args = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)
                captured["graph_bwd"].append((capturing[0], args))
            return
        if keep_last:
            captured[kind].clear()
        captured[kind].append(args)

    def capture_begin(graph, *args, **kwargs):
        capturing[0] = graph
        order.append(graph)
        if keep_last:
            del order[:-2]
            captured["graph_bwd"][:] = [r for r in captured["graph_bwd"]
                                        if any(r[0] is g for g in order)]
        return begin(graph, *args, **kwargs)

    def replaying(graph, *args, **kwargs):
        captured["replayed"] = id(graph)
        return replay(graph, *args, **kwargs)

    class Recording:
        @staticmethod
        def apply(*args):
            record("fwd", args)
            return sampler.apply(*args)

    def recording_bwd(*args):
        record("bwd", args)
        return launch_bwd(*args)

    tf._TrilinearSample, tf._launch_bwd = Recording, recording_bwd
    Graph.capture_begin, Graph.replay = capture_begin, replaying
    try:
        yield captured
    finally:
        tf._TrilinearSample, tf._launch_bwd = sampler, launch_bwd
        Graph.capture_begin, Graph.replay = begin, replay


def replayed_launch(captured):
    """The arguments of the K4 launch of capture_sampler's graph that
    replayed last, as its last replay wrote them (None if it holds none)."""
    return next((args for graph, args in captured["graph_bwd"]
                 if id(graph) == captured["replayed"]), None)


def check_sampler(where, args, g=None, seed=3, focus=None):
    """K3 and K4 against their plain versions at one launch's arguments
    (flat1, uv, uv_da, mask, offsets, sizes): K3's out within 1e-5 absolute
    on every pixel, and 0 pixels whose taps (level and texels, formed by
    the kernels' own tap code) differ from trilinear_taps'; K4 for the
    launch's own cotangent g, or a seeded random one on the masked-in
    pixels: d_uv and d_uv_da within 1e-4 and dflat within 1e-5 of max|ref|
    per channel, the reference trilinear_sample_bwd_plain for a float64
    texture and cotangent (the exact chain rule of the float32 forward's
    taps; the float32 plain version's own error is logged beside).
    focus = (name, (B, H, W) bool) holds the same gates on those pixels
    alone (and dflat on the texels their taps touch), and fails if none of
    them is sampled. Returns the K3 and K4 rows' checks, timed at these
    inputs."""
    from vhap_tpu_torch.ops.texture_fetch import (trilinear_sample,
                                                  trilinear_sample_bwd,
                                                  trilinear_sample_bwd_plain,
                                                  trilinear_sample_plain,
                                                  trilinear_taps,
                                                  trilinear_taps_card)
    flat1, uv, uv_da, mask, offsets, sizes = args[:6]
    size = tuple(sizes[0])
    B, Hi, Wi = uv.shape[:3]
    P, N = Hi * Wi, flat1.shape[0]
    with torch.no_grad():
        out_k = trilinear_sample(flat1, size, offsets, sizes, uv, uv_da, mask)
        out_p = trilinear_sample_plain(flat1, size, offsets, sizes, uv, uv_da, mask)
        idx_k, wgt_k = trilinear_taps_card(size, offsets, sizes, uv, uv_da, mask)
        idx, wgt = trilinear_taps(size, offsets, sizes, uv, uv_da, mask)
    err = float((out_k - out_p).abs().max())
    other = (idx_k != idx).any(dim=1)                        # (B, P)
    n_other = int(other.sum())
    err_taps = float((wgt_k - wgt).abs().max())
    covered = (torch.ones((B, P), dtype=torch.bool, device="cuda") if mask is None
               else mask.reshape(B, P))
    if focus is not None:
        focus_name, fpx = focus[0], focus[1].reshape(B, P) & covered
        n_focus = int(fpx.sum())
        err_f = float((out_k - out_p).reshape(B, P, -1)[fpx].abs().max()) if n_focus else 0.0
        n_other_f = int((other & fpx).sum())
        if not (n_focus > 0 and err_f <= 1e-5 and n_other_f == 0):
            raise RuntimeError(f"K3 at {where} on the {n_focus} sampled {focus_name} "
                               f"pixels (none is a failure): out error {err_f} "
                               f"(1e-5), {n_other_f} pixels with other taps")
    del idx_k, wgt_k, out_k, out_p, other
    if not (err <= 1e-5 and n_other == 0):
        raise RuntimeError(f"K3 at {where}: out error {err} (1e-5), {n_other} "
                           f"pixels with other taps than the plain version's")
    if g is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = torch.randn((B, P, 3), generator=gen, device="cuda") * covered[..., None]
    d_uv, d_da, dflat = trilinear_sample_bwd(flat1, size, offsets, sizes, uv,
                                             uv_da, mask, g)
    refs = trilinear_sample_bwd_plain(flat1.double(), size, offsets, sizes,
                                      uv, uv_da, mask, g.double())
    plain32 = trilinear_sample_bwd_plain(flat1, size, offsets, sizes, uv,
                                         uv_da, mask, g)

    def rel(x, ref, rows=None):
        """Error over max|ref| per channel (the scale taken on all rows),
        on `rows` of the (-1, C) view alone where given."""
        ref2 = ref.reshape(-1, ref.shape[-1])
        scale = ref2.abs().amax(0)
        e2 = (x.double().reshape(-1, ref.shape[-1]) - ref2).abs()
        e = (e2 if rows is None else e2[rows]).amax(0)
        return float((e / scale.clamp(min=1e-30)).max()), float(e.max())

    (rel_uv, _), (rel_da, _), (rel_flat, err_flat) = (
        rel(x, r) for x, r in zip((d_uv, d_da, dflat), refs))
    rel_p32 = [rel(x, r)[0] for x, r in zip(plain32, refs)]
    focus_note = ""
    if focus is not None:
        texels = torch.zeros(N, dtype=torch.bool, device="cuda")
        texels[idx[fpx[:, None].expand_as(idx) & (wgt != 0)].long()] = True
        rel_f = [rel(x, r, rows)[0] for x, r, rows in
                 zip((d_uv, d_da, dflat), refs, (fpx.reshape(-1),) * 2 + (texels,))]
        if not (rel_f[0] <= 1e-4 and rel_f[1] <= 1e-4 and rel_f[2] <= 1e-5):
            raise RuntimeError(f"K4 at {where} on the {focus_name} pixels: d_uv "
                               f"{rel_f[0]}, d_uv_da {rel_f[1]} of max|ref| "
                               f"(1e-4), dflat on their {int(texels.sum())} "
                               f"texels {rel_f[2]} (1e-5)")
        focus_note = (f"; on the {n_focus} sampled {focus_name} pixels: K3 out "
                      f"abs err {err_f:.3g}, 0 with other taps, K4 d_uv "
                      f"{rel_f[0]:.3g}, d_uv_da {rel_f[1]:.3g}, dflat on their "
                      f"{int(texels.sum())} texels {rel_f[2]:.3g}")
    del refs, plain32, d_uv, d_da, dflat
    if not (rel_uv <= 1e-4 and rel_da <= 1e-4 and rel_flat <= 1e-5):
        raise RuntimeError(f"K4 at {where}: d_uv {rel_uv}, d_uv_da {rel_da} of "
                           f"max|ref| (1e-4), dflat {rel_flat} (1e-5); the "
                           f"float32 plain version: {rel_p32}")
    live = covered & (g.abs().sum(-1) > 0)
    n_cov, n_live = int(covered.sum()), int(live.sum())
    live_tap = wgt != 0
    n_taps = int(live_tap.sum())
    n_texels = int(torch.unique(idx[live_tap]).numel())
    n_taps_k4 = int((live_tap & live[:, None]).sum())
    n_texels_k4 = int(torch.unique(idx[live[:, None].expand_as(idx)]).numel())
    flat_rows = (wgt[..., None] * g[:, None]).reshape(-1, 3)   # formed untimed
    idx_flat = idx.reshape(-1).long()
    del idx, wgt, live_tap
    mask_bytes = 0 if mask is None else B * P
    log(f"[sampler] {where}: K3 out abs err {err:.3g}, 0 pixels with other taps "
        f"(taps' weight err {err_taps:.3g}); K4 d_uv {rel_uv:.3g}, d_uv_da "
        f"{rel_da:.3g}, dflat {rel_flat:.3g} of max|ref| against float64 (the "
        f"float32 plain version: " + ", ".join(f"{x:.3g}" for x in rel_p32)
        + f"); {n_cov} covered, {n_live} with a cotangent of {B * P} pixels"
        + focus_note)
    k3 = dict(
        name="K3 trilinear_sample", source="vhap_tpu_torch/csrc/texture_fetch.cu",
        replaces="vhap_tpu/ops/texture_grad_pallas.py:476", max_abs_err=err,
        max_abs_err_taps=err_taps, pixels_other_taps=n_other,
        kernel=lambda: trilinear_sample(flat1, size, offsets, sizes, uv, uv_da, mask),
        plain=lambda: trilinear_sample_plain(flat1, size, offsets, sizes, uv,
                                             uv_da, mask),
        library=None,
        # the mask of every pixel, uv and uv_da of a covered one, each texel
        # a live tap touches read once, out written
        n_bytes=mask_bytes + n_cov * 24 + n_texels * 12 + B * P * 12,
        n_flops=n_cov * K3_FLOPS_PER_PIXEL + n_taps * K3_FLOPS_PER_LIVE_TAP,
        note=f"at {where}: abs err {err:.3g}, 0 pixels with other taps; "
             f"{n_cov} covered pixels, {n_taps} live taps on {n_texels} texels")
    k4 = dict(
        name="K4 trilinear_sample_bwd",
        source="vhap_tpu_torch/csrc/texture_scatter.cu",
        replaces="vhap_tpu/ops/texture_grad_pallas.py:338", max_abs_err=err_flat,
        max_rel_err=rel_flat, max_rel_err_d_uv=max(rel_uv, rel_da),
        kernel=lambda: trilinear_sample_bwd(flat1, size, offsets, sizes, uv,
                                            uv_da, mask, g),
        plain=lambda: trilinear_sample_bwd_plain(flat1, size, offsets, sizes,
                                                 uv, uv_da, mask, g),
        library=lambda: torch.zeros((N, 3), device="cuda").index_add_(
            0, idx_flat, flat_rows),
        # the mask and g of every pixel; uv, uv_da and the texels of the 8
        # taps of a live pixel (each texel once); d_uv and d_uv_da of every
        # pixel and the whole dflat written once
        n_bytes=mask_bytes + B * P * 12 + n_live * 24 + n_texels_k4 * 12
                + B * P * 24 + N * 12,
        n_flops=n_live * K4_FLOPS_PER_LIVE_PIXEL + n_taps_k4 * K4_FLOPS_PER_LIVE_TAP,
        note=f"at {where}: against float64, dflat {rel_flat:.3g} of max|ref| "
             f"(abs {err_flat:.3g}), d_uv {rel_uv:.3g}, d_uv_da {rel_da:.3g}; "
             f"{n_taps_k4} live taps of {n_live} live pixels, their 8 taps on "
             f"{n_texels_k4} texels; library: index_add_ of the texel gradient "
             f"alone (all {B * 8 * P} taps, wgt * g formed before the timed "
             f"region)")
    return k3, k4


def check_replayed_sampler(where, captured):
    """K3 and K4 against their plain versions at the K4 launch of the last
    CUDA graph replay (capture_sampler), K4 with the replay's own
    cotangent; fails if the last replay's graph holds no sampled launch.
    Returns check_sampler's rows."""
    args = replayed_launch(captured)
    if args is None:
        raise RuntimeError(f"{where}: the last CUDA graph replay launched no sampled K4")
    return check_sampler(f"{where}'s last graph replay", args[:6], g=args[6])


def check_sampler_launches(where, captured, n_fwd, n_bwd, focus=None):
    """The fused sampler's wrappers ran n_fwd / n_bwd times in a captured
    run; K3 and K4 checked at its last launch, with the backward's own
    cotangent where it ran (focus: as check_sampler's)."""
    if (len(captured["fwd"]), len(captured["bwd"])) != (n_fwd, n_bwd):
        raise RuntimeError(f"{where}: the sampler's wrappers ran "
                           f"{len(captured['fwd'])} / {len(captured['bwd'])} "
                           f"times, expected {n_fwd} / {n_bwd}")
    if captured["bwd"]:
        args = captured["bwd"][-1]
        return check_sampler(where, args[:6], g=args[6], focus=focus)
    return check_sampler(where, captured["fwd"][-1], focus=focus)


def check_adversarial_sampler(size, tex_res):
    """Phase 18b: K3 and K4 on tools/texture_cases.py's inputs at the train
    step's width (integer lods, lod L - 1, ties, texel-centre uvs, uvs on
    and beyond [0, 1], masked and zero-cotangent pixels), uv and uv_da as
    views of (B, c, H, W) planes."""
    from vhap_tpu_torch.ops.texture import build_mip_pyramid
    from vhap_tpu_torch.tools import texture_cases
    B, (H, W) = size
    c = texture_cases.build(B, H, W, tex_res, seed=11)
    flat, offsets, sizes = build_mip_pyramid(torch.as_tensor(c["tex"], device="cuda"))
    uv, da = (torch.as_tensor(c[k], device="cuda").permute(0, 3, 1, 2)
              .contiguous().permute(0, 2, 3, 1) for k in ("uv", "uv_da"))
    mask = torch.as_tensor(c["mask"], device="cuda")
    g = torch.as_tensor(c["g"], device="cuda")
    check_sampler(f"texture_cases {B}x{H}x{W} tex {tex_res}",
                  (flat[0].contiguous(), uv, da, mask, offsets, sizes), g=g)


def check_k2b(captured, name="K2b fused_interp_bwd",
              replaces="vhap_tpu/ops/interp_pallas.py:421"):
    """K2b against its plain version, 1e-4 * max|ref| per table row: at the
    train step's own launch (its saved (B, F, C) table, tri_id and
    per-group cotangents, captured in phase 6), which is also the timed
    call, and for a seeded random cotangent on every group (masked to the
    foreground), so that every row is held."""
    from vhap_tpu_torch.ops.interp import (GROUPS, N_FIXED_OUT, _launch_bwd,
                                           _plain_bwd, fused_interp_bwd,
                                           fused_interp_bwd_plain, group_slices)
    table, tri_id, grads, nf = captured
    packed = table.transpose(1, 2)
    B, F, C = table.shape
    H, W = tri_id.shape[1:]
    gen = torch.Generator(device="cuda").manual_seed(2)
    fg = (tri_id > 0)[:, None]
    g = torch.randn((B, N_FIXED_OUT + nf, H, W), generator=gen,
                    device="cuda") * fg

    def row_rel(d_k, d_p):
        row_err = (d_k - d_p).abs().amax(dim=(0, 2))            # (C,)
        row_ref = d_p.abs().amax(dim=(0, 2))
        rel = torch.where(row_ref > 0, row_err / row_ref.clamp(min=1e-30),
                          torch.where(row_err > 0, float("inf"), 0.0))
        return float(rel.max()), int(rel.argmax()), float(row_err.max())

    rel_step, worst_step, err = row_rel(_launch_bwd(table, tri_id, grads, nf),
                                        _plain_bwd(packed, tri_id, grads, nf))
    rel_rand, worst_rand, err_rand = row_rel(
        fused_interp_bwd(packed.contiguous(), tri_id, g, nf),
        fused_interp_bwd_plain(packed, tri_id, g, nf))
    for rel, worst, what in ((rel_step, worst_step, "the train step's cotangents"),
                             (rel_rand, worst_rand, "a random cotangent")):
        if not rel <= 1e-4:
            raise RuntimeError(f"{name}: row {worst} error {rel} over 1e-4 * "
                               f"max|ref| for {what}")
    have = [k for k, gk in zip(GROUPS, grads) if gk is not None]
    n_cot = sum(group_slices(nf)[k].stop - group_slices(nf)[k].start
                if isinstance(group_slices(nf)[k], slice) else 1 for k in have)
    n_fg = int(fg.sum())
    n_faces = int(torch.unique(tri_id[tri_id > 0]).numel())
    return dict(
        name=name, source="vhap_tpu_torch/csrc/interp_bwd.cu",
        replaces=replaces, max_abs_err=max(err, err_rand),
        max_rel_err=max(rel_step, rel_rand),
        kernel=lambda: _launch_bwd(table, tri_id, grads, nf),
        plain=lambda: _plain_bwd(packed, tri_id, grads, nf),
        library=None,
        # tri_id of every pixel, the n_cot cotangent channels the step has of
        # each foreground pixel, each visible face's rows read once, the
        # whole gradient table written once
        n_bytes=tri_id.numel() * 4 + n_fg * n_cot * 4 + n_faces * C * 4
                + B * F * C * 4,
        n_flops=n_fg * K2B_FLOPS_PER_FG_PIXEL,
        note=f"the train step's launch: cotangents of {have} ({n_cot} of "
             f"{N_FIXED_OUT - 1 + nf} channels), worst row rel err "
             f"{rel_step:.3g}; random cotangent on every group: {rel_rand:.3g}; "
             f"abs err {max(err, err_rand):.3g} on {n_fg} foreground pixels, "
             f"{n_faces} faces")


def kernel_row(r, launches):
    """Time one check's kernel (device ms from torch.profiler, and the
    wrapper's CUDA-event ms), plain version and library call; the JSON row
    of the kernels line. The share of the bound is taken from the device
    ms."""
    split = device_split(r["kernel"])
    dev_ms = sum(split.values()) if split else None
    ms, plain_ms = cuda_ms(r["kernel"]), cuda_ms(r["plain"])
    lib_ms = cuda_ms(r["library"]) if r.get("library") else None
    b_ms, b_by = bound(r["n_bytes"], r["n_flops"])
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    dev = ("not measured (the profiler recorded no device op)" if dev_ms is None
           else f"{dev_ms:.4f} ms ({b_ms / dev_ms:.1%} of the bound) = "
           + " + ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"[kernel] {r['name']}: {r['note']}; device {dev}; wrapper {ms:.4f} ms "
        f"(previous kernels, a constant: {PRIOR_MS.get(r['name'])} ms), plain "
        f"{plain_ms:.4f} ms, library {lib}, bound {b_ms:.4f} ms by {b_by} "
        f"({r['n_bytes'] / 1e6:.1f} MB, {r['n_flops'] / 1e9:.3f} GFLOP)")
    row = {
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": launches,
        "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "device_ms": dev_ms}
    for extra in ("max_rel_err", "max_abs_err_taps", "max_rel_err_d_uv",
                  "max_abs_err_vs_k4", "pixels_other_taps"):
        if extra in r:
            row[extra] = r[extra]
    return row


@contextlib.contextmanager
def capture_k2b():
    """Record the arguments of every K2b launch inside the block (its
    wrapper, ops/interp._launch_bwd, still launches)."""
    from vhap_tpu_torch.ops import interp
    captured = []
    launch_bwd = interp._launch_bwd

    def capture(table, tri_id, grads, n_flags):
        captured.append((table, tri_id, list(grads), n_flags))
        return launch_bwd(table, tri_id, grads, n_flags)

    interp._launch_bwd = capture
    try:
        yield captured
    finally:
        interp._launch_bwd = launch_bwd


TRAIN_TERMS = {"lmk", "photo", "smooth_pose", "reg_joint", "smooth_joint",
               "reg_expr", "smooth_expr", "reg_tex_tv", "reg_offset_lap",
               "reg_offset", "total", "rast_overflow"}


def check_train_step(ts, kernels, per_step, want=TRAIN_TERMS, where="train"):
    """Phase 6 (and 21): one train step through the kernels, disturbance
    on; `want` are the log terms the stage must report. Also returns K2b's
    arguments in it (table, tri_id, per-group cotangents, nf) and the fused
    sampler's (capture_sampler), for phase 7."""
    s = ts.eval
    init, step = ts.make_step(True, True)
    params = s.params
    opt_state = init(params)
    gen = ts.generator(0)
    for k in kernels.values():
        k.launches = 0
    with capture_k2b() as captured, capture_sampler() as sampled:
        new, state, E, logs = step(params, opt_state, s.batch, gen)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[{where}] launches in one train step: {launches}")
    for name, n in launches.items():
        if n != per_step:
            raise RuntimeError(f"{name} launched {n} times in the {where} train "
                               f"step, expected {per_step}")
    # Adam's first moment after one step is 0.1 * g: finite iff g is
    bad = [k for k, m in state["mu"].items() if not torch.isfinite(m).all()]
    if bad or not torch.isfinite(E):
        raise RuntimeError(f"train step: E {float(E)}, non-finite gradients {bad}")
    unchanged = [k for k in ts.opt_leaves if torch.equal(new[k], params[k])]
    moved = [k for k in params if k not in ts.opt_leaves
             and not (new[k] is params[k] and torch.equal(new[k], params[k]))]
    if unchanged or moved:
        raise RuntimeError(f"optimizable leaves unchanged {unchanged}, frozen "
                           f"leaves changed {moved}")
    if not want <= set(logs):
        raise RuntimeError(f"{where} train log lacks {sorted(want - set(logs))}")
    log(f"[{where}] E_total {float(E):.6f}; " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in logs.items()))
    log(f"[{where}] optimizable {sorted(ts.opt_leaves)} changed, frozen "
        f"{sorted(set(params) - ts.opt_leaves)} bit-identical, gradients finite")
    if len(captured) != 1:
        raise RuntimeError(f"K2b's wrapper ran {len(captured)} times in the step")
    return launches, captured[0], sampled


def check_train_plain(ts, where="train"):
    """Phase 8a (and 21): kernels vs plain versions, disturbance off."""
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    s = ts.eval
    (Ek, lk, gk), (Ep, lp, gp) = (
        loss_and_grads(ts.make_energy(use_kernels, False), s.params,
                       ts.opt_leaves, s.batch, ts.generator(1))
        for use_kernels in (True, False))
    if set(lk) != set(lp):
        raise RuntimeError(f"train log keys differ: {sorted(lk)} vs {sorted(lp)}")
    # a term equal on both paths (the regularizers that are 0 here) counts 0
    worst_term = max(abs(float(lk[k] - lp[k])) / abs(float(lp[k]))
                     if float(lk[k] - lp[k]) else 0.0 for k in lp)
    if not worst_term <= 1e-4:
        raise RuntimeError(f"train energy terms disagree: worst rel {worst_term}")
    worst_grad = {}
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        worst_grad[k] = err / scale if scale > 0 else err
        if not err <= 1e-3 * scale:
            raise RuntimeError(f"gradient of {k}: error {err} over 1e-3 * {scale}")
    log(f"[{where}] kernels vs plain (disturbance off): E_total {float(Ek):.6f} "
        f"vs {float(Ep):.6f}, worst term rel {worst_term:.3g}; gradient err / "
        f"max|g|: " + ", ".join(f"{k} {v:.3g}" for k, v in worst_grad.items()))


def train_timing(ts, t0):
    """Phase 8b: the train step's time, frames/s and peak memory."""
    s = ts.eval
    B = s.batch["rgb"].shape[0]

    def step_ms(use_kernels, warmup, reps):
        init, step = ts.make_step(use_kernels, True)
        params, state = s.params, init(s.params)
        gen = ts.generator(4)
        times = []
        for _ in range(warmup + reps):
            t = time.perf_counter()
            params, state, E, _ = step(params, state, s.batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if not torch.isfinite(E):
            raise RuntimeError(f"train step E {float(E)} after {warmup + reps} steps")
        return statistics.median(times[warmup:]) * 1e3

    torch.cuda.reset_peak_memory_stats()
    ms_k = step_ms(True, 2, 10)
    peak = torch.cuda.max_memory_allocated()
    ms_p = step_ms(False, 1, 3)
    log(f"[step] train step {ms_k:.3f} ms (median of 10), "
        f"{B / (TRAIN_STEPS_PER_BATCH * ms_k * 1e-3):.4f} tracked frames/s, "
        f"peak memory {peak / 2**30:.3f} GiB; through the plain versions "
        f"{ms_p:.3f} ms (median of 3); run {time.perf_counter() - t0:.1f} s")
    return ms_k


def check_cotangent_traffic(ts):
    """Phase 8c: the zero fills and in-place adds one train step makes on
    per-pixel tensors; those on the fused interpolation's (B, 20 + nf, H, W)
    channel buffer beside the previous design's."""
    from vhap_tpu_torch.tools.profile_eval import buffer_ops
    s = ts.eval
    init, step = ts.make_step(True, True)
    state = {"params": s.params, "opt": init(s.params)}
    gen = ts.generator(5)

    def one():
        state["params"], state["opt"], _, _ = step(state["params"], state["opt"],
                                                   s.batch, gen)
        torch.cuda.synchronize()

    one()
    B, (H, W) = s.batch["rgb"].shape[0], s.image_size
    ops = buffer_ops(one, B, H, W)
    total = {}
    for k, v in ops.items():
        t = total.setdefault(k.split()[0], [0, 0.0])
        t[0] += v["calls"]
        t[1] += v["device_ms"]
    channel = [k for k in ops  # keys "<op> (B, c, H, W)"
               if ast.literal_eval(k.split(" ", 1)[1])[1:] in
               [(c, H, W) for c in range(20, 64)]]
    log("[cotangent] one train step's zero fills and adds on per-pixel "
        "tensors: " + (", ".join(f"{k}: {v['calls']} calls, "
                                 f"{v['device_ms']:.4f} device ms"
                                 for k, v in ops.items()) or "none")
        + "; in all " + ", ".join(f"{k} {n} calls {ms:.4f} device ms"
                                  for k, (n, ms) in total.items())
        + f"; on the (B, >=20, H, W) channel buffer {len(channel)} shapes, "
        + ", ".join(f"{k}: {ops[k]['calls']} calls" for k in channel)
        + "; the previous design's there (a constant): "
        + ", ".join(f"{k} {n} calls, {ms} device ms"
                    for k, (n, ms) in PRIOR_CHANNEL_BUFFER_OPS.items()))
    return ops


def check_vis_path(vs, kernels):
    """Phase 9: the vis path through the kernels, counts zeroed before and
    read after: one render_rgba_vis and one gradient of the differentiable
    chain (tools/vis_slice.py) with a seeded random cotangent."""
    B = vs.verts.shape[0]
    H, W = vs.image_size
    gen = torch.Generator(device="cuda").manual_seed(6)
    cot = torch.randn((B, H, W, 4), generator=gen, device="cuda")
    for k in kernels.values():
        k.launches = 0
    with capture_sampler() as sampled:
        out = vs.render(True)
        verts = vs.verts.clone().requires_grad_(True)
        tex = vs.tex.clone().requires_grad_(True)
        gv, gt = torch.autograd.grad(vs.grad_loss(verts, tex, cot, True),
                                     (verts, tex))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[vis] launches in one vis render + its gradient: {launches}")
    for name in ("K5 visibility", "K6f plane_gather", "K6b plane_gather_bwd",
                 "K3 trilinear_sample", "K4 trilinear_sample_bwd"):
        if launches[name] < 1:
            raise RuntimeError(f"{name} was not launched on the vis path")
    for key, shape in (("rgba", (B, H, W, 4)), ("albedo", (B, H, W, 3)),
                       ("normal", (B, H, W, 3)), ("diffuse", (B, H, W, 3))):
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise RuntimeError(f"vis {key}: shape {tuple(out[key].shape)}, "
                               f"expected {shape}, or values not finite")
    fg_share = float(out["rgba"][..., 3].gt(0).float().mean())
    if not (0.02 < fg_share < 0.9 and torch.isfinite(gv).all()
            and torch.isfinite(gt).all() and float(gv.abs().max()) > 0
            and float(gt.abs().max()) > 0):
        raise RuntimeError(f"implausible vis path: fg share {fg_share}, "
                           f"gradients finite and nonzero?")
    log(f"[vis] fg share {fg_share:.4f}; max|g| verts {float(gv.abs().max()):.6g} "
        f"tex {float(gt.abs().max()):.6g}")
    check_sampler_launches("the vis gradient's launch", sampled, 2, 1)
    return launches, cot, sampled


def check_k5(vs):
    """K5: rasterize()'s visibility through the kernel, tri_id identical to
    visibility_plain at the vis inputs (cull on) and on the UV layout at
    2048^2 (cull off, batch 1)."""
    from vhap_tpu_torch.ops.rasterize import (_Visibility, face_setup,
                                              pack_setup_rows, rasterize,
                                              visibility_plain)
    from vhap_tpu_torch.ops.render_uvmap import transform_vt
    head, (H, W) = vs.eval.head, vs.image_size
    clip = cam_clip(vs)
    notes = []
    for name, vc, faces, size, cull in (
            ("vis", clip, head.faces, (H, W), True),
            ("uv", transform_vt(head.verts_uvs), head.textures_idx,
             (UV_RES, UV_RES), False)):
        with torch.no_grad():
            tri_k = rasterize(vc, faces, size, cull_backfaces=cull)[2]
        tri_p, _ = visibility_plain(vc, faces, *size, cull)
        n_diff = int((tri_k != tri_p).sum())
        if n_diff:
            raise RuntimeError(f"K5 ({name}): tri_id differs from the plain "
                               f"version on {n_diff} pixels")
        rows = pack_setup_rows(face_setup(vc, faces, cull))
        ms = cuda_ms(lambda: _Visibility.apply(rows, *size))
        notes.append(f"{name} {size[0]}x{size[1]} B{vc.shape[0]} cull "
                     f"{'on' if cull else 'off'}: identical on {tri_k.numel()} "
                     f"pixels, {int((tri_k > 0).sum())} covered, kernel "
                     f"{ms:.4f} ms")
        if name == "vis":
            tri_vis = tri_k
    log("[K5] " + "; ".join(notes))
    setup = face_setup(clip, head.faces, True)
    rows = pack_setup_rows(setup)
    n_rows, n_valid = rows.shape[0] * rows.shape[1], int(setup["valid"].sum())
    return tri_vis, dict(
        name="K5 visibility", source="vhap_tpu_torch/csrc/visibility.cu",
        replaces="vhap_tpu/ops/rasterize_pallas.py:62", max_abs_err=0.0,
        kernel=lambda: _Visibility.apply(rows, H, W),
        plain=lambda: visibility_plain(clip, head.faces, H, W),
        # as K1: the used fields of a valid face's row, VALID of the others,
        # the id map written; the candidates its valid faces test
        n_bytes=(n_valid * K1_ROW_FIELDS_READ + (n_rows - n_valid)) * 4
                + clip.shape[0] * H * W * 4,
        n_flops=k1_candidates(setup, H, W) * K1_FLOPS_PER_CANDIDATE,
        note="rasterize() through K1's kernel, timed at the vis inputs; "
             + "; ".join(notes))


def cam_clip(vs):
    from vhap_tpu_torch.ops import camera as cam
    return cam.camera_to_clip(cam.world_to_camera(vs.verts, vs.RT), vs.K,
                              vs.image_size)


def tile_bins(rows, H, W) -> str:
    """K1's binning of these setup rows (ops/rasterize.tile_bins_plain):
    large faces, the most candidates of a tile and the tiles whose list
    spills to the shared list."""
    from vhap_tpu_torch.ops.rasterize import VIS_TILE_CAP, tile_bins_plain
    listed, large = tile_bins_plain(rows, H, W)
    per_tile = listed.sum(-1)
    return (f"{int(large.sum())} large faces, at most {int(per_tile.max())} "
            f"listed a tile, {int((per_tile > VIS_TILE_CAP).sum())} of "
            f"{per_tile.numel()} tiles spill")


def k1_candidates(setup, H, W) -> float:
    """Pixel centers the valid faces test: their widened, clamped bboxes."""
    span = (setup["bbox"] + 1.0) / torch.tensor(
        [2.0 / W, 2.0 / H, 2.0 / W, 2.0 / H], device="cuda") - 0.5
    nw = (torch.clamp(torch.ceil(span[..., 2]) + 1, max=W - 1)
          - torch.clamp(torch.floor(span[..., 0]) - 1, min=0) + 1).clamp(min=0)
    nh = (torch.clamp(torch.ceil(span[..., 3]) + 1, max=H - 1)
          - torch.clamp(torch.floor(span[..., 1]) - 1, min=0) + 1).clamp(min=0)
    return float((nw * nh * setup["valid"]).sum())


def check_k6(vs, tri_id):
    """K6 forward bit-identical to its plain version at each of the vis
    path's gathers; the backward within 1e-5 * max|ref| per channel of a
    float64 scatter_add_ for a random cotangent on every pixel (face 0
    takes every background pixel's)."""
    from vhap_tpu_torch.ops.antialias import aa_tables
    from vhap_tpu_torch.ops.plane_gather import (plane_gather, plane_gather_bwd,
                                                 plane_gather_bwd_plain,
                                                 plane_gather_plain)
    from vhap_tpu_torch.ops.rasterize import corner_tables, rast_tables
    from vhap_tpu_torch.ops.shading import compute_v_normals
    head = vs.eval.head
    clip = cam_clip(vs)
    with torch.no_grad():
        aa, vid = aa_tables(clip, head.faces)
        tables = {"rast planes": rast_tables(clip, head.faces),
                  "corner normals": corner_tables(
                      compute_v_normals(vs.verts, head.faces), head.faces),
                  "corner uvs": corner_tables(vs.verts_uv[None], head.textures_idx),
                  "AA planes": aa, "vertex ids": vid}
        for name, t in tables.items():
            if not torch.equal(plane_gather(t, tri_id), plane_gather_plain(t, tri_id)):
                raise RuntimeError(f"K6 forward differs from torch.gather at the "
                                   f"{name} ({tuple(t.shape)})")
    log("[K6] forward bit-identical to the plain version at " + ", ".join(
        f"{n} C={t.shape[1]} (table batch {t.shape[0]})" for n, t in tables.items()))

    packed = tables["rast planes"].contiguous()
    B, C, F = packed.shape
    H, W = tri_id.shape[1:]
    P = H * W
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn((B, C, H, W), generator=gen, device="cuda")
    d_k = plane_gather_bwd(tri_id, g, B, F)
    d_ref = plane_gather_bwd_plain(tri_id, g.double(), B, F)
    d_p32 = plane_gather_bwd_plain(tri_id, g, B, F)
    scale = d_ref.abs().amax(dim=(0, 2))
    rel = float(((d_k.double() - d_ref).abs().amax(dim=(0, 2)) / scale).max())
    rel_p32 = float(((d_p32.double() - d_ref).abs().amax(dim=(0, 2)) / scale).max())
    if not rel <= 1e-5:
        raise RuntimeError(f"K6 backward: error {rel} of a channel's max|ref|")
    err = float((d_k.double() - d_ref).abs().max())
    n_bg = int((tri_id == 0).sum())
    n_faces = int(torch.unique(torch.clamp(tri_id - 1, min=0)).numel())
    idx = torch.clamp(tri_id.long() - 1, min=0).reshape(B, 1, P).expand(B, C, P)
    g_flat = g.reshape(B, C, P)
    fwd = dict(
        name="K6f plane_gather", source="vhap_tpu_torch/csrc/plane_gather.cu",
        replaces="vhap_tpu/ops/plane_pallas.py:75", max_abs_err=0.0,
        kernel=lambda: plane_gather(packed, tri_id),
        plain=lambda: plane_gather_plain(packed, tri_id),
        library=lambda: torch.gather(packed, 2, idx),
        # tri_id read, the planes written, each touched face's rows read once
        n_bytes=B * P * 4 + B * C * P * 4 + n_faces * C * 4, n_flops=0.0,
        note=f"C={C} rast planes, bit-identical; {n_faces} faces touched "
             f"(face 0 by {n_bg} background pixels); library: torch.gather "
             f"with its index formed before the timed region")
    bwd = dict(
        name="K6b plane_gather_bwd", source="vhap_tpu_torch/csrc/plane_gather.cu",
        replaces="vhap_tpu/ops/plane_pallas.py:90", max_abs_err=err,
        max_rel_err=rel,
        kernel=lambda: plane_gather_bwd(tri_id, g, B, F),
        plain=lambda: plane_gather_bwd_plain(tri_id, g, B, F),
        library=lambda: torch.zeros((B, C, F), device="cuda").scatter_add_(
            2, idx, g_flat),
        # the cotangent and tri_id read, the whole table written
        n_bytes=B * C * P * 4 + B * P * 4 + B * C * F * 4,
        n_flops=float(B * C * P),
        note=f"C={C}, cotangent on all {B * P} pixels ({n_bg} background); "
             f"worst channel {rel:.3g} of max|ref| against float64 "
             f"scatter_add_ (float32 scatter_add_: {rel_p32:.3g}); library: "
             f"scatter_add_ with its index formed before the timed region")
    return fwd, bwd


def check_vis_plain(vs, cot, sampled):
    """Phase 13-14: the vis render and its gradient through the kernels
    against the plain versions (use_kernels=False): every output within
    1e-5 absolute, each gradient within 1e-3 * max|g|; K3 and K4 at the
    render's own (unmasked) sampler launch from phase 9; the render's
    time."""
    out_k, out_p = vs.render(True), vs.render(False)
    errs = {k: float((out_k[k] - out_p[k]).abs().max()) for k in out_k}
    if not all(e <= 1e-5 for e in errs.values()):
        raise RuntimeError(f"vis render, kernels vs plain: {errs}")
    grads = []
    for use_kernels in (True, False):
        verts = vs.verts.clone().requires_grad_(True)
        tex = vs.tex.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(
            vs.grad_loss(verts, tex, cot, use_kernels), (verts, tex)))
    g_err = {}
    for name, gk, gp in zip(("verts", "tex"), *grads):
        scale = float(gp.abs().max())
        g_err[name] = float((gk - gp).abs().max()) / scale
        if not g_err[name] <= 1e-3:
            raise RuntimeError(f"vis gradient of {name}: {g_err[name]} of max|g|")
    log("[vis] kernels vs plain: max abs error " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; gradient err / max|g| "
        + ", ".join(f"{k} {v:.3g}" for k, v in g_err.items()))

    # K3 at the render's own launch: every pixel fetches (no coverage mask)
    # K3 and K4 at the render's own launch: every pixel fetches (no coverage
    # mask); K4 for the cotangent the vis gradient's sampler took (phase 9),
    # which composites the background away
    check_sampler("the vis render's launch (no mask)", sampled["fwd"][0],
                  g=sampled["bwd"][0][6])

    def render_ms(use_kernels, warmup, reps):
        times = []
        for _ in range(warmup + reps):
            t = time.perf_counter()
            vs.render(use_kernels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times[warmup:]) * 1e3

    B = vs.verts.shape[0]
    torch.cuda.reset_peak_memory_stats()
    ms_k = render_ms(True, 2, 10)
    peak = torch.cuda.max_memory_allocated()
    ms_p = render_ms(False, 1, 3)
    log(f"[step] vis render {ms_k:.3f} ms (median of 10), {B / ms_k * 1e3:.2f} "
        f"frames/s, peak memory {peak / 2**30:.3f} GiB; through the plain "
        f"versions {ms_p:.3f} ms (median of 3), {B / ms_p * 1e3:.2f} frames/s")


def check_entry_points(vs):
    """Phase 15: the synthetic generators and the UV-mask baker on the card,
    writing into a temporary directory, timed per frame."""
    import tempfile
    from pathlib import Path

    from vhap_tpu_torch.generate_flame_uvmask import generate as bake
    from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        generate(root / "seq", n_frames=SEQ_FRAMES, size=512)
        t_seq = time.perf_counter() - t
        n = len(list((root / "seq" / "images").glob("*.jpg")))
        t = time.perf_counter()
        _, cams = generate_multiview(root / "mv", n_cams=MV_CAMS, n_frames=MV_FRAMES,
                                     size=512)
        t_mv = time.perf_counter() - t
        n_mv = len(list((root / "mv" / "001" / "SEN-01" / "images").glob("*.jpg")))
        t = time.perf_counter()
        masks = bake(root / "uv", resolution=UV_RES, head=vs.eval.head)
        t_uv = time.perf_counter() - t
        if n != SEQ_FRAMES or n_mv != MV_CAMS * MV_FRAMES or not masks or not all(
                m.shape == (UV_RES, UV_RES) and m.any() for m in masks.values()):
            raise RuntimeError(f"entry points wrote {n} sequence frames, {n_mv} "
                               f"multiview images, masks {list(masks)}")
        cover = statistics.mean(float(m.mean()) for m in masks.values())
    log(f"[entry] make_synthetic_sequence: {SEQ_FRAMES} frames at 512^2 in "
        f"{t_seq:.2f} s, {t_seq / SEQ_FRAMES * 1e3:.1f} ms per frame (render, "
        f"JPEG, landmarks; head built once)")
    log(f"[entry] generate_multiview: {MV_CAMS} cameras x {MV_FRAMES} frames at "
        f"512^2 in {t_mv:.2f} s, {t_mv / MV_FRAMES * 1e3:.1f} ms per frame of "
        f"{MV_CAMS} views")
    log(f"[entry] generate_flame_uvmask: {len(masks)} regions at {UV_RES}^2 in "
        f"{t_uv:.2f} s ({t_uv / len(masks) * 1e3:.1f} ms per region, PNG "
        f"included); mean mask coverage {cover:.4f}")


def dense_config_energies(ts):
    """The eval and train energies of the existing slices with
    render.bin_mode='dense' (the JAX package's K7 path)."""
    import copy

    from vhap_tpu_torch.tools.eval_slice import N_TIMESTEPS
    from vhap_tpu_torch.tracker.energy import make_energy_fn
    s = ts.eval
    cfg = copy.deepcopy(s.cfg)
    cfg.render.bin_mode = "dense"
    eval_fn = make_energy_fn(s.head, cfg, s.get_albedo, s.image_size,
                             N_TIMESTEPS, None, with_aux=True, device="cuda")
    train_fn = make_energy_fn(s.head, cfg, s.get_albedo, s.image_size,
                              N_TIMESTEPS, ts.stage, with_aux=False, device="cuda")
    return eval_fn, train_fn


def check_dense_path(ts, kernels):
    """Phase 16: the dense configuration's eval and train steps through the
    kernels, counts zeroed before and read after, against the flat
    configuration on the same inputs and generator seed."""
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    s = ts.eval
    eval_dense, train_dense = dense_config_energies(ts)
    for k in kernels.values():
        k.launches = 0
    with capture_sampler() as eval_sampled:
        Ed, (ld, ad) = run_step(eval_dense, s.params, s.batch)
    eval_launches = {name: k.launches for name, k in kernels.items()}
    for k in kernels.values():
        k.launches = 0
    with capture_k2b() as k2b_args, capture_sampler() as train_sampled:
        Etd, ltd, gd = loss_and_grads(train_dense, s.params, ts.opt_leaves,
                                      s.batch, ts.generator(8))
    torch.cuda.synchronize()
    train_launches = {name: k.launches for name, k in kernels.items()}
    log(f"[dense] launches in one dense eval step: {eval_launches}; in one "
        f"dense train step: {train_launches}")
    for name, n in eval_launches.items():
        want = 0 if name in ("K2b fused_interp_bwd", "K4 trilinear_sample_bwd") else 1
        if n != want:
            raise RuntimeError(f"{name} launched {n} times in the dense eval "
                               f"step, expected {want}")
    for name, n in train_launches.items():
        if n != 1:
            raise RuntimeError(f"{name} launched {n} times in the dense train "
                               f"step, expected 1")
    check_sampler_launches("the dense eval step's launch", eval_sampled, 1, 0)
    check_sampler_launches("the dense train step's launch", train_sampled, 1, 1)
    # the flat configuration on the same inputs and generator seed, twice:
    # its two runs give the noise floor of the atomics' order (K2b, K4 and
    # the index_add_ of the vertex normals and of autograd's index backward)
    flat = [(run_step(s.make_energy(True), s.params, s.batch),
             loss_and_grads(ts.make_energy(True, True), s.params, ts.opt_leaves,
                            s.batch, ts.generator(8))) for _ in range(2)]

    def diffs(ev_a, tr_a, ev_b, tr_b):
        (Ea, (_, aa)), (_, la, ga) = ev_a, tr_a
        (Eb, (_, ab)), (_, lb, gb) = ev_b, tr_b
        out = max(float((aa[k] - ab[k]).abs().max())
                  for k in ("pred_rgb", "pred_alpha", "pred_lmk2d"))
        E = abs(float(Ea) - float(Eb)) / abs(float(Eb))
        term = max(abs(float(la[k]) - float(lb[k])) / max(abs(float(lb[k])), 1e-30)
                   for k in lb)
        grad = {k: float((ga[k] - gb[k]).abs().max()) / max(float(gb[k].abs().max()), 1e-30)
                for k in gb}
        return out, E, term, grad

    out_d, E_d, term_d, grad_d = diffs((Ed, (ld, ad)), (Etd, ltd, gd), *flat[0])
    out_f, E_f, term_f, grad_f = diffs(*flat[0], *flat[1])
    overflow = float(ld["rast_overflow"]) + float(ltd["rast_overflow"])
    log(f"[dense] dense vs flat (flat vs flat): eval outputs max abs diff "
        f"{out_d:.3g} ({out_f:.3g}), eval E rel {E_d:.3g} ({E_f:.3g}); train "
        f"worst term rel {term_d:.3g} ({term_f:.3g}); gradient diff / max|g|: "
        + ", ".join(f"{k} {grad_d[k]:.3g} ({grad_f[k]:.3g})" for k in grad_d)
        + f"; overflow {overflow}")
    if not (out_d <= 1e-6 and E_d <= 1e-6 and term_d <= 1e-6 and overflow == 0.0):
        raise RuntimeError("the dense configuration's outputs differ from the "
                           "flat configuration's")
    worst = max(grad_d.values())
    if not worst <= DENSE_GRAD_TOL:
        raise RuntimeError(f"dense vs flat gradients: {worst} of max|g| over "
                           f"{DENSE_GRAD_TOL}")
    return eval_launches, train_launches, k2b_args[0]


def check_k8(args, kernels):
    """Phase 17: K8 (scatter_taps) on the train step's own taps (formed by
    trilinear_taps from the step's sampler arguments), vals = wgt * g for
    the step's own cotangent: launched once with the counts zeroed; within
    1e-5 * max|ref| of a float64 index_add_ and of K4's dflat for the same
    uv, uv_da and g."""
    from vhap_tpu_torch.ops.texture_fetch import (scatter_taps,
                                                  scatter_vals_plain,
                                                  trilinear_sample_bwd,
                                                  trilinear_taps)
    flat1, uv, uv_da, mask, offsets, sizes, g = args
    size = tuple(sizes[0])
    N = flat1.shape[0]
    with torch.no_grad():
        idx, wgt = trilinear_taps(size, offsets, sizes, uv, uv_da, mask)
    B, K, P = idx.shape
    vals = (wgt[:, :, None, :] * g.permute(0, 2, 1)[:, None]).contiguous()
    del wgt
    for k in kernels.values():
        k.launches = 0
    dflat, ovf = scatter_taps(idx, vals, N)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    if launches["K8 scatter_taps"] != 1 or ovf != 0:
        raise RuntimeError(f"K8: launches {launches}, overflow {ovf}")
    ref64 = scatter_vals_plain(idx, vals.double(), N)
    scale = float(ref64.abs().max())
    err = float((dflat.double() - ref64).abs().max())
    dflat_k4 = trilinear_sample_bwd(flat1, size, offsets, sizes, uv, uv_da,
                                    mask, g)[2]
    err_k4 = float((dflat - dflat_k4).abs().max())
    err_p32 = float((scatter_vals_plain(idx, vals, N).double() - ref64).abs().max())
    del ref64
    if not (err <= 1e-5 * scale and err_k4 <= 1e-5 * float(dflat_k4.abs().max())):
        raise RuntimeError(f"K8: error {err} against float64 (max|ref| {scale}), "
                           f"{err_k4} against K4's dflat")
    live = (vals != 0).any(dim=2)
    n_live = int(live.sum())
    n_texels = int(torch.unique(idx[live]).numel())
    rows = vals.permute(0, 1, 3, 2).reshape(-1, 3).contiguous()
    idx_flat = idx.reshape(-1).long()
    log(f"[K8] {B}x{K}x3x{P} vals ({vals.numel() * 4 / 1e6:.1f} MB), {n_live} "
        f"live taps on {n_texels} texels; launches {launches}")
    return launches, dict(
        name="K8 scatter_taps", source="vhap_tpu_torch/csrc/texture_scatter.cu",
        replaces="vhap_tpu/ops/texture_grad_pallas.py:313", max_abs_err=err,
        max_abs_err_vs_k4=err_k4,
        kernel=lambda: scatter_taps(idx, vals, N),
        plain=lambda: scatter_vals_plain(idx, vals, N),
        library=lambda: torch.zeros((N, 3), device="cuda").index_add_(
            0, idx_flat, rows),
        # every value read (a dead tap is known only by reading its zeros),
        # the index of each live tap, the whole dflat written once
        n_bytes=vals.numel() * 4 + n_live * 4 + N * 12,
        n_flops=float(n_live * 3),
        note=f"the train step's taps and cotangent: abs err {err:.3g} against "
             f"float64 index_add_ (max|ref| {scale:.3g}; float32 index_add_ "
             f"{err_p32:.3g}), {err_k4:.3g} against K4's dflat for the same uv, "
             f"uv_da and g; {n_live} live taps on {n_texels} texels; "
             f"library: float32 index_add_ of all {B * K * P} taps, rows "
             f"permuted before the timed region")


def check_adversarial():
    """Phase 18: K1 (through visibility) and K2b (through its wrapper)
    against their plain versions on tools/raster_scenes.py's scenes, each
    at its own size and at 250 x 333: tri_id identical; K2b within 1e-4 *
    max|ref| per table row for nf = 0 and 2, with some groups' cotangent
    None."""
    from vhap_tpu_torch.ops.interp import GROUPS, _launch_bwd, _plain_bwd
    from vhap_tpu_torch.ops.rasterize import (face_setup, pack_setup_rows,
                                              visibility, visibility_plain)
    from vhap_tpu_torch.tools import raster_scenes as rs
    worst = 0.0
    for name in rs.SCENES:
        for size in (None, (250, 333)):
            sc = rs.build(name, size=size, device="cuda")
            clip, faces, H, W, cull = (sc[k] for k in ("clip", "faces", "H", "W",
                                                       "cull"))
            tri_k, _ = visibility(clip, faces, H, W, cull)
            tri_p, _ = visibility_plain(clip, faces, H, W, cull)
            n_diff = int((tri_k != tri_p).sum())
            if n_diff:
                raise RuntimeError(f"K1 on {name} {H}x{W}: tri_id differs from "
                                   f"the plain version on {n_diff} pixels")
            bins = tile_bins(pack_setup_rows(face_setup(clip, faces, cull)), H, W)
            rels = []
            for nf, none in ((0, ("zw", "vids")), (2, ("normal", "flags"))):
                packed, grads = rs.interp_inputs(sc, nf, tri_k, seed=nf, none=none)
                g = [grads[k] for k in GROUPS]
                d_k = _launch_bwd(packed.transpose(1, 2).contiguous(), tri_k, g, nf)
                d_p = _plain_bwd(packed, tri_k, g, nf)
                row_err = (d_k - d_p).abs().amax(dim=(0, 2))
                row_ref = d_p.abs().amax(dim=(0, 2))
                if not bool((row_err <= 1e-4 * row_ref).all()):
                    raise RuntimeError(
                        f"K2b on {name} {H}x{W} nf={nf}: row error over 1e-4 * "
                        f"max|ref|: {(row_err / row_ref.clamp(min=1e-30)).tolist()}")
                rels.append(float((row_err / row_ref.clamp(min=1e-30)).max()))
            worst = max(worst, *rels)
            extra = ""
            if name == "crowded_tile":
                extra = (f", {int(torch.unique(tri_k[0, 32:48, 48:64]).numel())} "
                         f"faces win in the crowded tile")
            log(f"[adversarial] {name} {H}x{W} B{clip.shape[0]} cull "
                f"{'on' if cull else 'off'}: K1 identical on {tri_k.numel()} "
                f"pixels ({int((tri_k > 0).sum())} covered, {faces.shape[0]} "
                f"faces, {bins}){extra}; K2b worst row rel err "
                f"{rels[0]:.3g} (nf 0), {rels[1]:.3g} (nf 2)")
    return worst


def check_tracker_loop(kernels, single_step_ms):
    """Phase 18: GlobalTracker at full width and reduced depth on a 32-frame
    generated sequence, counts zeroed before and read after; then a second
    tracker resumed from the run state written after the sequential phase."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from vhap_tpu_torch.tools.loader_ab import mono_config
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        generate(root / "seq", n_frames=LOOP_FRAMES, size=512, n_shape=300,
                 n_expr=100, device="cuda")
        t_gen = time.perf_counter() - t
        cfg = mono_config(root, root / "out", "cuda")
        tr = GlobalTracker(cfg)
        snapshot = root / "run_state_global.npz"
        save_state = tr.save_run_state

        def save_and_keep(phase, cursor, epoch=0):   # keep the mid-run state
            save_state(phase, cursor, epoch)
            if phase == "global":
                shutil.copy(tr.out_dir / "run_state.npz", snapshot)
        tr.save_run_state = save_and_keep

        batch0 = tr._make_batch(list(range(cfg.batch_size)))
        E0 = float(tr._eval_energy()(tr.params, batch0)[0])
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        tr.eval_calls = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with capture_sampler(keep_last=True) as sampled:
            tr.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        launches = {name: k.launches for name, k in kernels.items()}
        rgb_steps = sum(n for st, n in tr.steps_by_stage.items()
                        if st.startswith("rgb"))
        evals = tr.eval_calls
        E1 = float(tr._eval_energy()(tr.params, batch0)[0])
        log(f"[loop] {LOOP_FRAMES} frames at 512^2 generated in {t_gen:.2f} s; "
            f"steps by stage {dict(tr.steps_by_stage)}; {evals} evaluation "
            f"renders; launches {launches}")
        want = {"K1 visibility": rgb_steps + evals, "K2f fused_interp": rgb_steps + evals,
                "K3 trilinear_sample": rgb_steps + evals,
                "K2b fused_interp_bwd": rgb_steps, "K4 trilinear_sample_bwd": rgb_steps}
        for name, n in want.items():
            if launches[name] != n:
                raise RuntimeError(f"{name} launched {launches[name]} times in the "
                                   f"tracker loop, expected {n}")
        args = sampled["bwd"][0]
        check_sampler("the tracker loop's last eager rgb step", args[:6], g=args[6])
        check_replayed_sampler("the tracker loop", sampled)
        del sampled, args
        if not (np.isfinite(E1) and E1 < E0):
            raise RuntimeError(f"batch-0 eval energy did not fall: {E0} -> {E1}")
        ckpt = sorted(tr.out_dir.glob("tracked_flame_params_*.npz"))[-1]
        z = np.load(ckpt)
        T, V = LOOP_FRAMES, tr.head.num_verts
        schema = {"rotation": (T, 3), "translation": (T, 3), "neck_pose": (T, 3),
                  "jaw_pose": (T, 3), "eyes_pose": (T, 6), "shape": (300,),
                  "expr": (T, 100), "timestep_id": (T,), "n_processed_frames": (),
                  "image_size": (2,), "focal_length": (1,),
                  "tex_extra": (3, 2048, 2048), "lights": (9, 3),
                  "static_offset": (1, V, 3)}
        got = {k: z[k].shape for k in z.files}
        if got != schema or not all(np.isfinite(z[k]).all() for k in z.files
                                    if z[k].dtype.kind == "f"):
            raise RuntimeError(f"checkpoint {ckpt.name}: {got}, expected {schema}")
        stage_ms = {st: tr.step_timer.median_ms(st) for st in tr.steps_by_stage}
        loop_ms = stage_ms["rgb_sequential_tracking"]
        n_media = len(list(tr.out_dir.glob("*/image_grid/*")))
        log(f"[loop] batch-0 eval E {E0:.6f} -> {E1:.6f}; checkpoint {ckpt.name} "
            f"has the reference schema; median ms/step by stage: " + ", ".join(
                f"{st} {ms:.3f}" for st, ms in stage_ms.items() if ms is not None))
        log(f"[loop] rgb_sequential_tracking {loop_ms:.3f} ms/step in the loop vs "
            f"{single_step_ms:.3f} ms for the single train step "
            f"({loop_ms / single_step_ms - 1:+.1%}); wall {wall:.2f} s = "
            f"{wall / LOOP_FRAMES * 1e3:.1f} ms per tracked frame; media "
            f"{n_media} grids, media_write_s {tr.media_write_s:.3f}, "
            f"media_blocked_s {tr.media_blocked_s:.3f}; peak memory "
            f"{peak / 2**30:.3f} GiB")
        check_native_batches(tr.dataset, "tracker loop")
        log_stage_ms("tracker loop", stage_ms)

        # resume after the sequential phase: the global phase only
        tr2 = GlobalTracker(cfg)
        t = time.perf_counter()
        tr2.optimize(resume_state_path=snapshot)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t
        with np.load(snapshot) as snap:
            step0 = int(snap["global_step"])
        if dict(tr2.steps_by_stage) != {"rgb_global_tracking": 2} or \
                tr2.global_step != step0 + 2 or \
                not sorted(tr2.out_dir.glob("tracked_flame_params_*.npz")):
            raise RuntimeError(f"resumed run: steps {dict(tr2.steps_by_stage)}, "
                               f"global step {tr2.global_step} from {step0}")
        log(f"[loop] resumed from the run state after the sequential phase "
            f"(global step {step0}): global phase done in {t_resume:.2f} s, "
            f"global step {tr2.global_step}")
    return launches


def check_multiview_step(root, kernels, t0):
    """Phase 21: the calibrated multiview step at full width
    (tools/multiview_slice.py: bench.py's metric-3 step, 16 views of one
    timestep, 512^2, texture 2048, 300/100, texture optimized, plus the
    teeth head with its mouth open) on the rig at root. Counts zeroed
    before and read after one eval step (K1, K2f, K3 once) and one train
    step with the disturbance on (all five once); each kernel held against
    its plain version at this path's own launch, K3 and K4 also on the
    pixels won by teeth faces alone (there must be some); the eval step and
    the train step (disturbance off) against the plain path; the step's
    ms, device-busy ms and peak memory."""
    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice
    from vhap_tpu_torch.tracker.energy import fill_cam_params
    ts = build_multiview_slice(root, device="cuda")
    s = ts.eval
    B, (H, W) = s.batch["rgb"].shape[0], s.image_size
    head = s.head
    log(f"[mv] {B} calibrated views of timestep 0 at {H}x{W}, tex "
        f"{s.cfg.model.tex_resolution}, {s.cfg.model.n_shape}/{s.cfg.model.n_expr}; "
        f"teeth head V={head.num_verts} F={head.num_faces} "
        f"({len(head.masks.f['teeth'])} teeth faces); stage {ts.stage}, "
        f"optimizable {sorted(ts.opt_leaves)}, focal length "
        f"{'in' if 'focal_length' in s.params else 'not in'} the parameters")
    eval_kernels = {k: v for k, v in kernels.items()
                    if k in ("K1 visibility", "K2f fused_interp", "K3 trilinear_sample")}
    for k in kernels.values():
        k.launches = 0
    with capture_sampler() as sampled:
        E, (logs, aux) = run_step(s.make_energy(True), s.params, s.batch)
    eval_launches = {name: k.launches for name, k in eval_kernels.items()}
    log(f"[mv] launches in one eval step: {eval_launches}")
    if any(n != 1 for n in eval_launches.values()):
        raise RuntimeError(f"multiview eval step launches {eval_launches}, expected 1 each")
    n_lmk = head.lmk_faces_idx.shape[0]
    for key, shape in (("pred_rgb", (B, H, W, 3)), ("pred_alpha", (B, H, W, 1)),
                       ("pred_lmk2d", (B, n_lmk, 2))):
        if tuple(aux[key].shape) != shape or not torch.isfinite(aux[key]).all():
            raise RuntimeError(f"multiview {key}: shape {tuple(aux[key].shape)}, "
                               f"expected {shape}, or values not finite")
    fg = aux["pred_alpha"].gt(0).float().mean(dim=(1, 2, 3))
    if not (float(fg.min()) > 0.005 and torch.isfinite(E)):
        raise RuntimeError(f"implausible multiview render: fg share per view {fg}")
    K, RT = fill_cam_params(s.batch, s.params, True, (H, W))
    verts = aux["verts"]
    verts_clip = cam.camera_to_clip(cam.world_to_camera(verts, RT), K, (H, W))
    tri_id, r1 = check_k1(s, verts_clip)
    teeth = torch.zeros(head.num_faces + 1, dtype=torch.bool, device="cuda")
    teeth[1 + torch.as_tensor(head.masks.f["teeth"], device="cuda")] = True
    teeth_px = teeth[tri_id.long()]
    n_teeth_px = int(teeth_px.sum())
    if n_teeth_px == 0:
        raise RuntimeError("no pixel of the multiview step is won by a teeth face")
    _, r2 = check_k2(s, verts_clip, verts, tri_id)
    r3, _ = check_sampler_launches("the multiview eval step's launch", sampled, 1, 0,
                                   focus=("teeth", teeth_px))
    Ep, (logs_p, _) = run_step(s.make_energy(False), s.params, s.batch)
    rel = abs(float(E) - float(Ep)) / abs(float(Ep))
    rel_photo = abs(float(logs["photo"]) - float(logs_p["photo"])) / abs(float(logs_p["photo"]))
    if not (rel <= 1e-4 and rel_photo <= 1e-4 and float(logs["lmk"]) == float(logs_p["lmk"])):
        raise RuntimeError(f"multiview eval energy through the kernels disagrees "
                           f"with the plain path: E rel {rel}, photo rel {rel_photo}")
    log(f"[mv] eval E_total {float(E):.6f} (plain: rel {rel:.3g}, photo rel "
        f"{rel_photo:.3g}, lmk equal); fg share per view {float(fg.min()):.4f}-"
        f"{float(fg.max()):.4f}; {n_teeth_px} pixels won by teeth faces; "
        f"{r1['note']}; K2f {r2['note']}")
    del aux, sampled, r1, r2, r3, teeth_px
    train_launches, k2b_args, train_sampled = check_train_step(ts, kernels, 1,
                                                               where="mv")
    r4 = check_k2b(k2b_args)
    log(f"[mv] K2b at the train step's launch: {r4['note']}")
    _, r5 = check_sampler_launches("the multiview train step's launch",
                                   train_sampled, 1, 1,
                                   focus=("teeth", teeth[k2b_args[1].long()]))
    del k2b_args, train_sampled, r4, r5
    check_train_plain(ts, where="mv")

    init, step = ts.make_step(True, True)
    state = {"params": s.params, "opt": init(s.params)}
    gen = ts.generator(4)

    def one():
        state["params"], state["opt"], E, _ = step(state["params"], state["opt"],
                                                   s.batch, gen)
        return E

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(12):
        t = time.perf_counter()
        E = one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[2:]) * 1e3
    if not torch.isfinite(E):
        raise RuntimeError(f"multiview step E {float(E)} after 12 steps")
    del state
    # device busy from a fresh process: late, short profiler sessions in
    # this one lose device events
    prof = subprocess.run(
        [sys.executable, "-m", "vhap_tpu_torch.tools.profile_eval", "--stage",
         ts.stage, "--multiview", str(root), "--steps", "5", "--top", "8"],
        capture_output=True, text=True, timeout=600)
    if prof.returncode != 0:
        raise RuntimeError(f"profile_eval --multiview failed: {prof.stderr[-2000:]}")
    rep = json.loads(prof.stdout.strip().splitlines()[-1])
    log(f"[mv] multiview train step {ms:.3f} ms (median of 10 after 2), "
        f"{1.0 / (TRAIN_STEPS_PER_BATCH * ms * 1e-3):.4f} tracked timesteps/s at "
        f"{TRAIN_STEPS_PER_BATCH} steps per timestep; peak memory "
        f"{peak / 2**30:.3f} GiB; run {time.perf_counter() - t0:.1f} s")
    log(f"[mv] profile_eval --multiview (5 steps, {rep['card']}): wall "
        f"{rep['wall_ms_per_step']:.3f} ms per step under the profiler, device busy "
        f"{rep['device_busy_ms_per_step']} ms, idle share {rep['device_idle_share']}, "
        f"{rep['device_launches_per_step']} device launches per step, peak "
        f"{rep['peak_memory_gib']:.3f} GiB; top: " + ", ".join(
            f"{r['name'][:40]} {r['ms_per_step']:.3f}" for r in rep["top"]))
    return eval_launches, train_launches


def check_track_nersemble(root, kernels):
    """Phase 22: `python -m vhap_tpu_torch.track_nersemble` (through main())
    on the rig at root, full width, reduced depth (loader_ab.MV_STEPS, one
    global epoch, disturbance on), counts zeroed before and read after: K1,
    K2f, K3 once per rgb step and evaluation render, K2b and K4 once per rgb
    step. GT recovery (mean |d translation| < 0.02, mean |d rotation| <
    0.08), no focal length in the npz, the eval energy of timestep 0 falls
    from the initial parameters to the run state's (read into a second
    tracker of the same config). Returns the launches and the run folder."""
    import contextlib
    import io

    import numpy as np

    from vhap_tpu_torch import track_nersemble
    from vhap_tpu_torch.config.cli import parse_cli
    from vhap_tpu_torch.config.nersemble import NersembleTrackingConfig
    from vhap_tpu_torch.tools.loader_ab import mv_argv
    from vhap_tpu_torch.tracker import params as P
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    argv = mv_argv(root, root / "track")
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as yml, \
            capture_sampler(keep_last=True) as sampled:
        info = track_nersemble.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    rgb_steps = sum(n for st, n in info["steps_by_stage"].items() if st.startswith("rgb"))
    evals = info["eval_calls"]
    out_dir = Path(info["out_dir"])
    # the run's config in a tracker of its own, holding the run's result
    cfg = parse_cli(NersembleTrackingConfig,
                    mv_argv(root, root / "track_check") + ["--device", "cuda"])
    tr = GlobalTracker(cfg)
    tr.load_run_state(out_dir / "run_state.npz")
    log(f"[nersemble] track_nersemble.main (its config printed, "
        f"{len(yml.getvalue().splitlines())} lines): {info['n_timesteps']} timesteps x "
        f"{tr.dataset.num_cameras} views at {tr.image_size}, head "
        f"V={tr.head.num_verts}; steps by stage {info['steps_by_stage']}; "
        f"{evals} evaluation renders; launches {launches}; wall {wall:.2f} s")
    if not (info["world"] == 1 and info["calibrated"] and info["batchify_all_views"]
            and info["n_timesteps"] >= 4 and info["color_correction"]
            and cfg.model.add_teeth and cfg.model.remove_lip_inside):
        raise RuntimeError("track_nersemble did not run the calibrated path with "
                           "teeth (mouth open) and colour correction")
    want = {"K1 visibility": rgb_steps + evals, "K2f fused_interp": rgb_steps + evals,
            "K3 trilinear_sample": rgb_steps + evals,
            "K2b fused_interp_bwd": rgb_steps, "K4 trilinear_sample_bwd": rgb_steps}
    for name, n in want.items():
        if launches[name] != n:
            raise RuntimeError(f"{name} launched {launches[name]} times in "
                               f"track_nersemble, expected {n}")
    args = sampled["bwd"][0]
    check_sampler("track_nersemble's last eager rgb step", args[:6], g=args[6])
    check_replayed_sampler("track_nersemble", sampled)
    del sampled, args
    ckpt = sorted(out_dir.glob("tracked_flame_params_*.npz"))[-1]
    z = dict(np.load(ckpt))
    with np.load(tr.dataset.sequence_path / "gt_params.npz") as gt:
        d_trans = float(np.abs(z["translation"] - gt["translation"]).mean())
        d_rot = float(np.abs(z["rotation"] - gt["rotation"]).mean())
    batch0 = tr._make_batch([0])
    init = P.init_params(tr.n_timesteps, cfg.model.n_shape, cfg.model.n_expr,
                         cfg.model.n_tex, tr.head.num_verts, cfg.model.tex_resolution,
                         cfg.model.tex_painted, cfg.model.tex_extra,
                         cfg.render.lighting_type == "SH", cfg.model.use_static_offset,
                         cfg.model.use_dynamic_offset, True, device="cuda")
    energy = tr._eval_energy()
    E0, E1 = (float(energy(p, batch0)[0]) for p in (init, tr.params))
    stage_ms = info["ms_per_step"]
    log(f"[nersemble] GT recovery: mean |d translation| {d_trans:.6f} (< 0.02), "
        f"mean |d rotation| {d_rot:.6f} (< 0.08); npz {ckpt.name} keys "
        f"{sorted(z)}; eval E of timestep 0 {E0:.6f} -> {E1:.6f}; median "
        f"ms/step by stage: " + ", ".join(f"{st} {ms:.3f}" for st, ms in
                                          stage_ms.items() if ms is not None)
        + f"; {wall / info['n_timesteps']:.2f} s per tracked timestep at this depth; "
        f"media_write_s {info['media_write_s']:.3f}, media_blocked_s "
        f"{info['media_blocked_s']:.3f}")
    check_native_batches(tr.dataset, "track_nersemble", info)
    log_stage_ms("track_nersemble", stage_ms)
    if not (d_trans < 0.02 and d_rot < 0.08):
        raise RuntimeError(f"multiview GT recovery failed: translation {d_trans}, "
                           f"rotation {d_rot}")
    if "focal_length" in z or not all(np.isfinite(v).all() for v in z.values()
                                      if v.dtype.kind == "f"):
        raise RuntimeError(f"checkpoint {ckpt.name}: focal_length present or "
                           f"values not finite")
    if not (np.isfinite(E1) and E1 < E0):
        raise RuntimeError(f"eval energy of timestep 0 did not fall: {E0} -> {E1}")
    return launches, out_dir


def check_export(run_dir, root):
    """Phase 23: export the run as a NeRF dataset through the port's
    export_as_nerf_dataset (FLAME on the card, the mask from the mesh on),
    export it again without the mask, and combine the two through
    combine_nerf_datasets; check the transforms schema and splits, every
    flame_param npz, the canonical npz, and that the mask took foreground
    below the neck line and nothing elsewhere."""
    import json
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from vhap_tpu_torch.combine_nerf_datasets import combine
    from vhap_tpu_torch.export_as_nerf_dataset import (MaskFromFLAME, export,
                                                       infer_flame_params,
                                                       load_config)
    parent = root / "export"
    t = time.perf_counter()
    export(run_dir, parent / "001_masked", flame_mode="param",
           create_mask_from_mesh=True, device="cuda")
    t_export = time.perf_counter() - t
    export(run_dir, parent / "001_plain", flame_mode="param",
           create_mask_from_mesh=False, device="cuda")
    tgt = parent / "001_masked"
    db = json.load(open(tgt / "transforms.json"))
    top = {"frames", "timestep_indices", "camera_indices", "cx", "cy", "fl_x",
           "fl_y", "h", "w", "camera_angle_x", "camera_angle_y"}
    per_frame = {"timestep_index", "timestep_index_original", "timestep_id",
                 "camera_index", "camera_id", "cx", "cy", "fl_x", "fl_y", "h", "w",
                 "camera_angle_x", "camera_angle_y", "transform_matrix", "file_path",
                 "fg_mask_path", "flame_param_path"}
    n_t, n_c = len(db["timestep_indices"]), len(db["camera_indices"])
    if not (top <= set(db) and all(set(f) == per_frame for f in db["frames"])
            and len(db["frames"]) == n_t * n_c and n_c == MV_CAMS):
        raise RuntimeError(f"transforms.json: keys {sorted(db)}, {len(db['frames'])} "
                           f"frames of {n_t} timesteps x {n_c} cameras")
    splits = {d: json.load(open(tgt / f"transforms_{d}.json"))
              for d in ("train", "val", "test")}
    if splits["val"]["camera_indices"] != [8] or not splits["test"]["frames"] \
            or len(splits["train"]["frames"]) + len(splits["val"]["frames"]) \
            + len(splits["test"]["frames"]) != len(db["frames"]):
        raise RuntimeError("the train/val/test splits do not partition the frames")
    shapes = {"translation": (1, 3), "rotation": (1, 3), "neck_pose": (1, 3),
              "jaw_pose": (1, 3), "eyes_pose": (1, 6), "shape": (300,),
              "expr": (1, 100)}
    npzs = sorted((tgt / "flame_param").glob("*.npz"))
    for path in npzs:
        z = dict(np.load(path))
        got = {k: v.shape for k, v in z.items() if k in shapes}
        if got != shapes or "static_offset" not in z or not all(
                np.isfinite(v).all() for v in z.values()):
            raise RuntimeError(f"{path.name}: {sorted(z)}, shapes {got}")
    cano = dict(np.load(tgt / "canonical_flame_param.npz"))
    if len(npzs) != n_t or not np.allclose(cano["jaw_pose"], [[0.3, 0, 0]]):
        raise RuntimeError(f"{len(npzs)} flame_param files for {n_t} timesteps; "
                           f"canonical jaw {cano['jaw_pose']}")
    # the mask against the same frames unmasked: foreground taken below the
    # neck line (the mask < 1 there), nothing taken above it
    _, cfg = load_config(run_dir)
    masker = MaskFromFLAME(cfg.data, cfg.model, tgt, None, device="cuda")
    n_taken = n_outside = 0
    for i in range(0, len(masker.dataset), MV_CAMS + 1):
        frame = masker.dataset[i]
        rel = Path(frame["fg_mask_path"]).relative_to(tgt)
        fg_m = np.asarray(Image.open(tgt / rel)).astype(np.int16)
        fg_p = np.asarray(Image.open(parent / "001_plain" / rel)).astype(np.int16)
        verts = infer_flame_params(masker.flame_model, frame["flame_param"], [0])
        line = masker.get_mask_tilted_line(verts, frame["extrinsics"][None, :3],
                                           frame["intrinsics"][None],
                                           frame["image_height"], frame["image_width"])
        taken = fg_m < fg_p
        n_taken += int(taken.sum())
        n_outside += int((taken & (line >= 1.0)).sum())
    if n_taken == 0 or n_outside:
        raise RuntimeError(f"neck-line mask: {n_taken} foreground pixels taken, "
                           f"{n_outside} of them above the line")
    combine([parent / "001_masked", parent / "001_plain"], parent / "UNION_001",
            division_mode="last")
    union = parent / "UNION_001"
    te = json.load(open(union / "transforms_test.json"))
    tr = json.load(open(union / "transforms_train.json"))
    if te["timestep_indices"] != list(range(n_t, 2 * n_t)) or \
            not tr["frames"][0]["file_path"].startswith("../001_masked/") or \
            not (union / "canonical_flame_param.npz").exists():
        raise RuntimeError("combine_nerf_datasets: wrong test timesteps or paths")
    log(f"[export] export_as_nerf_dataset (mask from mesh): {len(db['frames'])} "
        f"frames, {len(npzs)} flame_param files in {t_export:.2f} s "
        f"({t_export / len(db['frames']) * 1e3:.1f} ms per frame); schema, splits "
        f"and canonical npz hold; the neck-line mask took {n_taken} foreground "
        f"pixels of the frames checked, all below the line; combine: "
        f"{len(tr['frames'])} train and {len(te['frames'])} test frames")


def check_recovery():
    """Phase 19: GT recovery, tools/validate.py's reduced schedule on the
    card (16 frames at 256^2, batch 8); it must PASS its rule."""
    import tempfile
    from pathlib import Path

    from vhap_tpu_torch.tools.validate import run
    with tempfile.TemporaryDirectory() as tmp:
        report, ok, _ = run(Path(tmp), frames=16, size=256, batch_size=8,
                            schedule_scale=RECOVERY_SCHEDULE_SCALE, device="cuda")
    note = ("" if RECOVERY_SCHEDULE_SCALE == 1.0 else
            f" (schedule scaled by {RECOVERY_SCHEDULE_SCALE} to fit the time limit)")
    log(f"[recovery] validate{note}: rot_err_rad {report['rot_err_rad']:.5f}, "
        f"trans_err_m {report['trans_err_m']:.6f}, expr_err "
        f"{report['expr_err']:.5f}; wall {report['wall_s']} s, "
        f"{report['wall_s_per_frame']} s per frame; "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"GT recovery failed: {report}")


def conv_flops(net, x) -> float:
    """Multiply-adds x 2 of every convolution in one forward of net on x
    (counted from the shapes by forward hooks)."""
    total = [0.0]

    def count(mod, _, out):
        k = mod.weight.shape
        total[0] += 2.0 * out.numel() * k[1] * k[2] * k[3]

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def net_outputs(name, out):
    """A preprocess network's outputs as {label: tensor}."""
    if name.startswith("STAR"):
        hms, lmks = out
        return dict({f"stack {i} heatmaps": h for i, h in enumerate(hms)},
                    landmarks=lmks)
    if name.startswith("FAN"):
        return {f"module {i} heatmaps": h for i, h in enumerate(out)}
    return {"alpha logits": out}


def argmax_margins(hm_card, hm_ref, tol):
    """Landmarks (B, L) of heatmaps (B, L, H, W): how many have their argmax
    differ between card and reference with the reference's top-2 margin
    over tol, and the mask of those under it (where an argmax may rightly
    differ)."""
    ref = hm_ref.flatten(2)
    top2 = ref.topk(2, dim=-1).values
    under = (top2[..., 0] - top2[..., 1]) <= tol
    differ = hm_card.flatten(2).double().argmax(-1).cpu() != ref.argmax(-1)
    return int((differ & ~under).sum()), under


def check_preprocess_nets(smi_line):
    """Phase 24: the preprocess networks at full width on the card: card
    outputs against the same module in float64 on the CPU, the batch-16
    call against the batch-1 call; times, device ms and peak memory."""
    import numpy as np
    log(f"[pre] times below on {smi_line}")

    from vhap_tpu_torch.preprocess import fan, matting, star
    assets = "vhap_tpu_torch/assets/"
    rng = np.random.default_rng(0)
    crops = torch.from_numpy(rng.uniform(0, 1, (PRE_BATCH, 3, PRE_CROP, PRE_CROP))
                             .astype(np.float32))
    frames = torch.from_numpy(rng.uniform(0, 1, (PRE_BATCH, 3, PRE_FRAME, PRE_FRAME))
                              .astype(np.float32))
    t = time.perf_counter()
    fan4 = fan.init_fan_params(torch.Generator().manual_seed(0))
    bn_batches = [rng.uniform(0, 1, (PRE_BATCH, PRE_CROP, PRE_CROP, 3)).astype(np.float32)
                  for _ in range(2)]
    fan4 = fan.finalize_bn_stats(fan4, bn_batches, device="cuda")
    log(f"[pre] FAN(4) initialized and its BN statistics baked over "
        f"{len(bn_batches)} batches of {PRE_BATCH} on the card in "
        f"{time.perf_counter() - t:.2f} s")
    nets = [("FAN(4)", fan.FAN, fan4, crops),
            ("STAR", star.STAR, star.init_star_params(torch.Generator().manual_seed(1)), crops),
            ("FAN bundled", fan.FAN, fan.load_fan_params(assets + "fan_weights.npz"), crops),
            ("U-Net bundled 256", matting.UNet,
             fan.load_fan_params(assets + "matting_weights.npz"), crops),
            ("U-Net bundled 512", matting.UNet,
             fan.load_fan_params(assets + "matting_weights.npz"), frames)]
    # the networks guard their own precision: TF32 stays on (torch's
    # default) around these phases, full_float32() turns it off per call
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            for name, cls, params, x in nets:
                check_preprocess_net(name, cls, params, x)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def check_preprocess_net(name, cls, params, x):
    """One network of phase 24 on the crops or frames x (B, 3, H, W)."""
    from vhap_tpu_torch.preprocess.fan import full_float32
    net = cls.from_params(params, "cuda")
    ref_net = cls.from_params(params, "cpu").double()
    n_params = sum(p.numel() for p in ref_net.state_dict().values())
    x16 = x.cuda()
    x1 = x16[:1]
    with full_float32():
        out1 = net_outputs(name, net(x1))
        out16 = net_outputs(name, net(x16))
    ref = net_outputs(name, ref_net(x[:1].double()))
    errs = {}
    for k, r in ref.items():
        scale = float(r.abs().max())
        err = float((out1[k].double().cpu() - r).abs().max()) / scale
        err16 = float((out16[k][:1] - out1[k]).abs().max()) / scale
        errs[k] = err
        if not (torch.isfinite(out16[k]).all() and err <= PRE_TOL and err16 <= PRE_TOL):
            raise RuntimeError(f"{name} {k}: card vs float64 {err:.3g}, batch 16 vs 1 "
                               f"{err16:.3g} of max|ref| {scale:.4g} (tolerance {PRE_TOL})")
    last = [k for k in ref if k.endswith("heatmaps")][-1:]
    lmk_note = ""
    if last:
        k = last[0]
        tol = PRE_TOL * float(ref[k].abs().max())
        bad, under = argmax_margins(out1[k], ref[k], tol)
        under = int(under.sum())
        if bad:
            raise RuntimeError(f"{name}: {bad} heatmap argmaxes differ from float64 "
                               f"where the top-2 margin exceeds {tol:.3g}")
        lmk_note = (f"; {k} argmax equal on every landmark with a top-2 margin over "
                    f"the tolerance, {under} of {ref[k].shape[1]} under it")
    with full_float32():
        flops = conv_flops(net, x1)
        ms1 = cuda_ms(lambda: net(x1))
        ms16 = cuda_ms(lambda: net(x16))
        split1, split16 = device_split(lambda: net(x1)), device_split(lambda: net(x16))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net(x16)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    dev1 = sum(split1.values()) if split1 else None
    dev16 = sum(split16.values()) if split16 else None
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    rate = ("" if dev16 is None else
            f", {16 * flops / dev16 / 1e9:.2f} TFLOP/s on the device "
            f"({16 * flops / dev16 / 1e9 / (PEAK_F32_FLOP_S / 1e12):.1%} of the float32 peak)")
    H, W = x.shape[-2:]
    log(f"[pre] {name}: {n_params / 1e6:.3f} M parameters, {H}x{W} input, "
        f"{flops / 1e9:.3f} GFLOP of convolutions per image; card vs float64 "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" of max|ref| (tolerance {PRE_TOL}){lmk_note}")
    log(f"[pre] {name}: batch 1 {ms1:.4f} ms per image (device {fmt(dev1)}); batch "
        f"{PRE_BATCH} {ms16:.4f} ms = {PRE_BATCH / ms16 * 1e3:.1f} images/s (device "
        f"{fmt(dev16)}{rate}); peak {peak / 2**20:.1f} MiB above the resident "
        f"at batch {PRE_BATCH}")


def detect_recorded(det, img):
    """det.detect_single_image(img) and the heatmaps of its passes."""
    seen = []
    heatmaps = det.heatmaps
    det.heatmaps = lambda crops: seen.append(heatmaps(crops)) or seen[-1]
    try:
        bb, lmks = det.detect_single_image(img)
    finally:
        del det.heatmaps
    return bb, lmks, [torch.from_numpy(h).double() for h in seen]


def check_detections(seq, frame_ids):
    """Phase 25's hold: the card's detections and alpha maps of the frames
    against the port's CPU run on the same JPEGs, logged frame by frame."""
    import numpy as np
    from PIL import Image

    from vhap_tpu_torch.preprocess.landmarks import LandmarkDetectorFANNet
    from vhap_tpu_torch.preprocess.matting import MattingUNet
    z = np.load(seq / "landmark2d" / "fan-jax.npz")
    dets = {d: LandmarkDetectorFANNet(device=d) for d in ("cuda", "cpu")}
    mats = {d: MattingUNet(device=d) for d in ("cuda", "cpu")}
    for i in frame_ids:
        img = np.array(Image.open(seq / "images" / f"{i:06d}.jpg"))
        (bb_c, l_c, hm_c), (bb_r, l_r, hm_r) = (detect_recorded(dets[d], img)
                                                for d in ("cuda", "cpu"))
        if not (np.allclose(z["bounding_box"][i], bb_c, rtol=0, atol=1e-6)
                and np.allclose(z["face_landmark_2d"][i], l_c, rtol=0, atol=1e-6)):
            raise RuntimeError(f"frame {i}: the tracker's annotation differs from "
                               f"the card detector's")
        # pass 1 (the whole image) fixes the box, pass 2 (the box's crop)
        # the landmarks: each pass's heatmaps within PRE_TOL of the CPU's,
        # argmaxes equal where the CPU's top-2 margin is over the tolerance
        errs, under = [], []
        for p, (c, r) in enumerate(zip(hm_c, hm_r)):
            errs.append(float((c - r).abs().max()) / float(r.abs().max()))
            bad, low = argmax_margins(c, r, PRE_TOL * float(r.abs().max()))
            under.append(low[0])
            if errs[-1] > PRE_TOL or bad:
                raise RuntimeError(f"frame {i} pass {p + 1}: heatmaps {errs[-1]:.3g} of "
                                   f"max|ref| from the CPU's, {bad} argmaxes over the "
                                   f"margin differing")
            if p == 0 and not np.array_equal(bb_c, bb_r):
                if not low.any():
                    raise RuntimeError(f"frame {i}: card box {bb_c} vs the CPU's {bb_r}")
                break      # an argmax under the margin moved the box: pass 2 differs
        if len(hm_c) != len(hm_r):
            raise RuntimeError(f"frame {i}: card {len(hm_c)} passes, CPU {len(hm_r)}")
        conf_err = float(np.abs(l_c[:, 2] - l_r[:, 2]).max())
        if len(errs) == 2:
            ok = ~under[1].numpy()
            lmk_err = float(np.abs(l_c[ok, :2] - l_r[ok, :2]).max())
            if lmk_err > 1e-6 or conf_err > PRE_TOL:
                raise RuntimeError(f"frame {i}: landmarks over the margin {lmk_err:.3g} "
                                   f"from the CPU's, confidences {conf_err:.3g}")
        x = img.astype(np.float32) / 255.0
        net_err = float(np.abs(mats["cuda"].alpha(x[None]) - mats["cpu"].alpha(x[None])).max())
        a_c, a_r = mats["cuda"].predict(x), mats["cpu"].predict(x)
        a_err = float(np.abs(a_c - a_r).max())
        written = np.asarray(Image.open(seq / "alpha_maps" / f"{i:06d}.jpg"), np.int32)
        buf = io.BytesIO()
        Image.fromarray((a_r * 255).astype(np.uint8)).save(buf, "JPEG", quality=95)
        jpeg_err = int(np.abs(written - np.asarray(Image.open(buf), np.int32)).max())
        if net_err > ALPHA_TOL or a_err > REFINED_ALPHA_TOL:
            raise RuntimeError(f"frame {i}: the U-Net's alpha {net_err:.3g} from the "
                               f"CPU's (tolerance {ALPHA_TOL}), refined {a_err:.3g} "
                               f"(tolerance {REFINED_ALPHA_TOL})")
        log(f"[pre->track] frame {i}: bbox {np.round(bb_c[:4], 4).tolist()} "
            f"{'equal' if np.array_equal(bb_c, bb_r) else 'differs'}, heatmaps "
            f"{[f'{e:.3g}' for e in errs]} of max|ref| by pass, landmarks under the "
            f"top-2 margin by pass {[int(u.sum()) for u in under]}, conf "
            f"{conf_err:.3g}; U-Net alpha {net_err:.3g}, refined {a_err:.3g}; the "
            f"written alpha JPEG {jpeg_err} levels from the CPU alpha's JPEG")


def check_preprocess_track(kernels, smi_line):
    """Phase 25: preprocess -> track on a generated 16-frame 512^2 sequence
    written as an mp4: `preprocess` extracts its frames and the bundled U-Net
    mattes them ('matting_jax'), GlobalTracker annotates them with the
    bundled FAN on construction (landmark_source 'fan-jax') and tracks them
    at phase 19's depth, counts zeroed before and read after."""
    import tempfile
    from pathlib import Path

    import cv2
    import numpy as np
    from PIL import Image

    from vhap_tpu_torch.preprocess import landmarks, video
    from vhap_tpu_torch.tools.loader_ab import mono_config
    from vhap_tpu_torch.tools.make_synthetic_sequence import generate
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    torch.backends.cudnn.allow_tf32 = True     # as in phase 24
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            generate(root / "render", n_frames=PRE_FRAMES, size=PRE_FRAME, n_shape=300,
                     n_expr=100, device="cuda")
            writer = cv2.VideoWriter(str(root / "seq.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                     25, (PRE_FRAME, PRE_FRAME))
            for f in sorted((root / "render" / "images").glob("*.jpg")):
                writer.write(np.asarray(Image.open(f))[..., ::-1])
            writer.release()
            seq = root / "seq"
            matted = []
            matting = video.matting_unet

            def timed_matting(*args, **kw):
                t = time.perf_counter()
                matting(*args, **kw)
                matted.append(time.perf_counter() - t)
            video.matting_unet = timed_matting
            t0 = time.perf_counter()
            try:
                video.preprocess(root / "seq.mp4", target_fps=25,
                                 matting_method="matting_jax", device="cuda")
            finally:
                video.matting_unet = matting
            t_pre = time.perf_counter() - t0
            t_mat = matted[0]
            n_frames = len(list((seq / "images").glob("*.jpg")))
            n_alpha = len(list((seq / "alpha_maps").glob("*.jpg")))
            cfg = mono_config(root, root / "out", "cuda")
            cfg.data.background_color = "white"     # composited with the matted alpha
            cfg.data.landmark_source = "fan-jax"
            cfg.__post_init__()
            for k in kernels.values():
                k.launches = 0
            annotate, t_det = landmarks.annotate_landmarks, []

            def timed_annotate(*args, **kw):
                t = time.perf_counter()
                annotate(*args, **kw)
                t_det.append(time.perf_counter() - t)
            landmarks.annotate_landmarks = timed_annotate
            t = time.perf_counter()
            try:
                tr = GlobalTracker(cfg)
            finally:
                landmarks.annotate_landmarks = annotate
            t_build = time.perf_counter() - t
            if len(t_det) != 1:
                raise RuntimeError(f"the tracker annotated {len(t_det)} times, expected 1")
            if not (n_frames == n_alpha == PRE_FRAMES
                    and (seq / "landmark2d" / "fan-jax.npz").exists()):
                raise RuntimeError(f"preprocess wrote {n_frames} frames and {n_alpha} "
                                   f"alpha maps of {PRE_FRAMES}; fan-jax.npz "
                                   f"{(seq / 'landmark2d' / 'fan-jax.npz').exists()}")
            t = time.perf_counter()
            tr.optimize()
            torch.cuda.synchronize()
            t_track = time.perf_counter() - t
            check_native_batches(tr.dataset, "preprocess -> track")
            launches = {name: k.launches for name, k in kernels.items()}
            rgb_steps = sum(n for st, n in tr.steps_by_stage.items() if st.startswith("rgb"))
            evals = tr.eval_calls
            want = {"K1 visibility": rgb_steps + evals, "K2f fused_interp": rgb_steps + evals,
                    "K3 trilinear_sample": rgb_steps + evals,
                    "K2b fused_interp_bwd": rgb_steps, "K4 trilinear_sample_bwd": rgb_steps}
            for name, n in want.items():
                if launches[name] != n:
                    raise RuntimeError(f"{name} launched {launches[name]} times on "
                                       f"preprocess -> track, expected {n}")
            bad = [k for k, v in tr.params.items() if not torch.isfinite(v).all()]
            if bad:
                raise RuntimeError(f"parameters not finite after tracking: {bad}")
            z = np.load(seq / "landmark2d" / "fan-jax.npz")
            faces = int((z["bounding_box"][:, 0] >= 0).sum())
            check_detections(seq, (0, PRE_FRAMES - 1))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    t_det = t_det[0]
    log(f"[pre->track] times below on {smi_line}")
    log(f"[pre->track] preprocess (OpenCV frame extraction from the mp4, then the "
        f"matting) {t_pre:.2f} s; matting {t_mat:.2f} s = {t_mat / PRE_FRAMES * 1e3:.1f} "
        f"ms per frame ({PRE_FRAMES} frames at {PRE_FRAME}^2, JPEG IO and guided filter "
        f"included); detection in the tracker's construction {t_det:.2f} s = "
        f"{t_det / PRE_FRAMES * 1e3:.1f} ms per frame ({cfg.data.landmark_detector_njobs} "
        f"threads, faces found on {faces} of {PRE_FRAMES} frames; construction "
        f"{t_build:.2f} s in all); tracking {t_track:.2f} s; chain wall "
        f"{t_pre + t_build + t_track:.2f} s = {(t_pre + t_build + t_track) / PRE_FRAMES:.3f} "
        f"s per frame; steps by stage {dict(tr.steps_by_stage)}, {evals} evaluation "
        f"renders; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phases 26-29: the native frame loader, the synthetic trainers, the viewers
# ---------------------------------------------------------------------------

def check_native_batches(ds, where, summary=None):
    """A dataset the C++ loader covers took it on every batch of the run
    (phases 19, 22 and 25): the batches counted on ds, or in the run's
    summary when another tracker ran it."""
    if not ds.supports_native_batch():
        raise RuntimeError(f"{where}: the dataset's configuration is not the native "
                           f"loader's")
    native, pil = ((ds.native_batches, ds.pil_batches) if summary is None
                   else (summary["native_batches"], summary["pil_batches"]))
    if not (native > 0 and pil == 0):
        raise RuntimeError(f"{where}: {native} batches through the native "
                           f"loader and {pil} through PIL; the loader "
                           f"must take every batch")
    log(f"[native] {where}: {native} batches through the native loader, "
        f"{pil} through PIL")


def log_stage_ms(where, stage_ms):
    """The rgb stages' ms/step beside the figures before the native loader."""
    prior = PRIOR_STAGE_MS[where]
    ratio = lambda d: d["rgb_global_tracking"] / d["rgb_sequential_tracking"]
    log(f"[native] {where}: " + ", ".join(
        f"{st} {stage_ms[st]:.3f} ms/step (before the native loader: {prior[st]})"
        for st in prior) + f"; global / sequential {ratio(stage_ms):.2f}x (before: "
        f"{ratio(prior):.2f}x)")


def write_camera_frames(seq_dir, size, seed=0):
    """Overwrite a rig's frames and alpha maps with seeded JPEGs of `size`
    (H, W): a lit gradient with a bright soft-edged blob, per-camera gains
    and sensor noise, and the blob's alpha."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image
    H, W = size
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    yy, xx = yy / H, xx / W
    r = np.hypot(xx - 0.5, (yy - 0.45) * H / W)
    alpha = np.clip((0.28 - r) / 0.02, 0, 1)[..., None]
    bg = np.stack([0.3 + 0.4 * xx, 0.25 + 0.5 * yy, 0.6 - 0.3 * xx * yy], -1)
    fg = np.stack([0.8 - 0.3 * r, 0.6 - 0.2 * r, 0.5 + 0.1 * np.sin(40 * xx)], -1)
    img0 = bg * (1 - alpha) + fg * alpha
    alpha_u8 = (alpha[..., 0] * 255).astype(np.uint8)

    def write(i_path):
        i, path = i_path
        g = np.random.default_rng(seed + i)
        img = img0 * g.uniform(0.9, 1.1, 3).astype(np.float32) \
            + g.normal(0, 0.01, (H, W, 1)).astype(np.float32)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path, quality=95)
        Image.fromarray(alpha_u8).save(seq_dir / "alpha_maps" / path.name, quality=95)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, enumerate(sorted((seq_dir / "images").glob("*.jpg")))))


def loader_timing(root, scale_factor, reps):
    """One timestep's views of the rig at root through the C++ loader
    (median of reps calls) and through PIL (getitem_single_image per view),
    colour-corrected, scaled, composited on white; the two within
    NATIVE_TOL."""
    import numpy as np

    from vhap_tpu_torch.config.nersemble import NersembleDataConfig
    from vhap_tpu_torch.data.nersemble_dataset import NeRSembleDataset
    cfg = NersembleDataConfig(root_folder=root, subject="001", sequence="SEN-01",
                              align_cameras_to_axes=False, use_color_correction=True,
                              background_color="white", use_alpha_map=True,
                              scale_factor=scale_factor, use_landmark=False)
    ds = NeRSembleDataset(cfg, img_to_tensor=True)
    idx = list(range(ds.num_cameras))
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        nat = ds.load_batch_native(idx)
        times.append(time.perf_counter() - t)
        if nat is None:
            raise RuntimeError("the native loader returned no batch")
    t = time.perf_counter()
    items = [ds.getitem_single_image(i) for i in idx]
    t_pil = time.perf_counter() - t
    rgb, alpha = (np.stack([it[k] for it in items]) for k in ("rgb", "alpha_map"))
    err, err_a = float(np.abs(nat[0] - rgb).max()), float(np.abs(nat[1] - alpha).max())
    if not (nat[0].shape == rgb.shape and err <= NATIVE_TOL and err_a <= NATIVE_TOL):
        raise RuntimeError(f"native batch {nat[0].shape} vs PIL {rgb.shape}: rgb error "
                           f"{err}, alpha error {err_a} (bound {NATIVE_TOL:.5f})")
    H, W = ds._resolve_image_hw()
    return dict(frames=len(idx), src=(H, W), out=nat[0].shape[1:3],
                native_ms=statistics.median(times) * 1e3, pil_ms=t_pil * 1e3,
                err=err, err_a=err_a, share=float((nat[0] != rgb).mean()))


def check_native_loader(smi_line):
    """Phase 26: the C++ frame loader built from the checkout (a failed
    build fails the run), one timestep of a 16-camera colour-corrected rig
    at 512^2 and at NeRSemble's 3208 x 2200 (scale 0.25) through it and
    through PIL: within NATIVE_TOL, ms per 16-frame batch of each."""
    import os
    import tempfile
    from pathlib import Path

    import PIL

    from vhap_tpu_torch.data import native_loader
    from vhap_tpu_torch.tools.make_synthetic_multiview import generate_multiview
    t = time.perf_counter()
    so = native_loader.build()
    t_build = time.perf_counter() - t
    log(f"[native] {so.name} ready in {t_build:.2f} s (g++, linked against Pillow "
        f"{PIL.__version__}'s {native_loader.pillow_libjpeg().name}, headers of "
        f"libjpeg-turbo 2.1.5, JPEG_LIB_VERSION 62); {os.cpu_count()} host cores, "
        f"4 loader threads")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        generate_multiview(root, n_cams=MV_CAMS, n_frames=1, size=512, device="cuda",
                           color_correction=True)
        rows = [loader_timing(root, 1.0, reps=5)]
        t = time.perf_counter()
        write_camera_frames(root / "001" / "SEN-01", NATIVE_FRAME)
        t_write = time.perf_counter() - t
        rows.append(loader_timing(root, NATIVE_SCALE, reps=3))
    log(f"[native] times below on {smi_line}; {NATIVE_FRAME[0]}x{NATIVE_FRAME[1]} "
        f"frames written in {t_write:.2f} s")
    for r in rows:
        log(f"[native] {r['frames']} views {r['src'][0]}x{r['src'][1]} -> "
            f"{r['out'][0]}x{r['out'][1]} (colour correction, white background): "
            f"native {r['native_ms']:.3f} ms per batch (median), PIL "
            f"{r['pil_ms']:.3f} ms ({r['pil_ms'] / r['native_ms']:.2f}x); max |d| rgb "
            f"{r['err']:.6f}, alpha {r['err_a']:.6f} (bound {NATIVE_TOL:.6f}), "
            f"{r['share']:.4%} of rgb values differ")
    return rows


@contextlib.contextmanager
def capture_vis(*modules):
    """Record the arguments of the newest render_rgba_vis call that each
    module makes inside the block (it still renders): [(args, kwargs)]."""
    captured, originals = [], [m.render_rgba_vis for m in modules]

    def wrap(fn):
        def render(*args, **kwargs):
            captured[:] = [(args, kwargs)]
            return fn(*args, **kwargs)
        return render

    for m, fn in zip(modules, originals):
        m.render_rgba_vis = wrap(fn)
    try:
        yield captured
    finally:
        for m, fn in zip(modules, originals):
            m.render_rgba_vis = fn


def same_outputs(a, b):
    """Max |a - b| with NaN where both are NaN taken as equal; inf where
    only one is."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    return float((a - b).abs().masked_fill(nan_a, 0).max())


def check_k3(where, args):
    """K3 alone at one launch's arguments (flat1, uv, uv_da, mask, offsets,
    sizes), on a path that takes no texture gradient: check_sampler's K3
    gate (out within 1e-5 absolute, 0 pixels whose taps differ from
    trilinear_taps'). Returns the error and the kernel's and plain
    version's calls."""
    from vhap_tpu_torch.ops.texture_fetch import (trilinear_sample,
                                                  trilinear_sample_plain,
                                                  trilinear_taps, trilinear_taps_card)
    flat1, uv, uv_da, mask, offsets, sizes = args[:6]
    size = tuple(sizes[0])
    kernel = lambda: trilinear_sample(flat1, size, offsets, sizes, uv, uv_da, mask)
    plain = lambda: trilinear_sample_plain(flat1, size, offsets, sizes, uv, uv_da, mask)
    with torch.no_grad():
        err = float((kernel() - plain()).abs().max())
        idx_k, _ = trilinear_taps_card(size, offsets, sizes, uv, uv_da, mask)
        idx, _ = trilinear_taps(size, offsets, sizes, uv, uv_da, mask)
    n_other = int((idx_k != idx).any(dim=1).sum())
    if not (err <= 1e-5 and n_other == 0):
        raise RuntimeError(f"K3 at {where}: out error {err} (1e-5), {n_other} "
                           f"pixels with other taps than the plain version's")
    return err, kernel, plain


def check_vis_launch(where, call, sampled):
    """K5, K6 forward and K3 at one render_rgba_vis call's inputs: the
    render through the kernels against use_kernels=False (every output
    within 1e-5), tri_id identical to visibility_plain, each of the
    render's plane gathers bit-identical to plane_gather_plain, K3 at the
    render's own sampler launch (check_k3); each kernel's and plain
    version's CUDA-event ms there."""
    from dataclasses import replace

    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.ops.antialias import aa_tables
    from vhap_tpu_torch.ops.plane_gather import plane_gather, plane_gather_plain
    from vhap_tpu_torch.ops.rasterize import (_Visibility, corner_tables, face_setup,
                                              pack_setup_rows, rast_tables, rasterize,
                                              visibility_plain)
    from vhap_tpu_torch.ops.render import render_rgba_vis
    from vhap_tpu_torch.ops.shading import compute_v_normals
    args, kw = call
    verts, faces, RT, K, (H, W), settings = args[:6]
    with torch.no_grad():
        out_k = render_rgba_vis(*args, **kw)
        out_p = render_rgba_vis(*args[:5], replace(settings, use_kernels=False),
                                *args[6:], **kw)
        errs = {k: same_outputs(out_k[k], out_p[k]) for k in out_k}
        if not max(errs.values()) <= 1e-5:
            raise RuntimeError(f"vis render at {where}: kernels vs plain {errs}")
        clip = cam.world_to_clip(verts, RT, K, (H, W))
        cull = settings.cull_backfaces
        tri_id = rasterize(clip, faces, (H, W), cull)[2]
        tri_p, _ = visibility_plain(clip, faces, H, W, cull)
        n_diff = int((tri_id != tri_p).sum())
        if n_diff:
            raise RuntimeError(f"K5 at {where}: tri_id differs on {n_diff} pixels")
        albedo = (corner_tables(kw["verts_uv"][None], kw["faces_uv"])
                  if kw.get("tex") is not None else
                  corner_tables(kw["v_color"].reshape(-1, verts.shape[1], 3), faces))
        aa, vid = aa_tables(clip, faces)
        tables = {"rast planes": rast_tables(clip, faces),
                  "corner normals": corner_tables(compute_v_normals(verts, faces), faces),
                  "corner albedo": albedo, "AA planes": aa, "vertex ids": vid}
        for name, tab in tables.items():
            if not torch.equal(plane_gather(tab, tri_id), plane_gather_plain(tab, tri_id)):
                raise RuntimeError(f"K6 forward at {where} differs from its plain version "
                                   f"at the {name} ({tuple(tab.shape)})")
    rows = pack_setup_rows(face_setup(clip, faces, cull))
    planes = tables["rast planes"]
    ms = {"K5": (cuda_ms(lambda: _Visibility.apply(rows, H, W)),
                 cuda_ms(lambda: visibility_plain(clip, faces, H, W, cull), reps=3, warmup=1)),
          "K6f rast planes": (cuda_ms(lambda: plane_gather(planes, tri_id)),
                              cuda_ms(lambda: plane_gather_plain(planes, tri_id)))}
    note = "no texture"
    if sampled["fwd"]:
        err, kernel, plain = check_k3(where, sampled["fwd"][-1])
        ms["K3"] = (cuda_ms(kernel), cuda_ms(plain, reps=3, warmup=1))
        note = f"K3 abs err {err:.3g}, 0 pixels with other taps"
    log(f"[vis] {where}: B{verts.shape[0]} {H}x{W}, F={faces.shape[0]}: render vs "
        f"use_kernels=False max |d| {max(errs.values()):.3g}; K5 tri_id identical "
        f"({int((tri_id > 0).sum())} covered pixels); K6 forward bit-identical at "
        + ", ".join(f"{n} C={t.shape[1]}" for n, t in tables.items()) + f"; {note}; "
        + ", ".join(f"{k} {a:.4f} ms (plain {b:.4f})" for k, (a, b) in ms.items()))


def check_path_launches(where, launches, renders, textured=True):
    """K5 (and K3 on a textured render) once per render, K6 forward a
    whole number of times per render."""
    want = {"K5 visibility": renders, "K3 trilinear_sample": renders if textured else 0}
    per = launches["K6f plane_gather"] / renders
    if any(launches[k] != n for k, n in want.items()) or per != int(per) or per < 1:
        raise RuntimeError(f"{where}: launches {launches} in {renders} renders")
    log(f"[{where}] launches in {renders} renders: {launches} (K6 forward {int(per)} "
        f"per render)")


def asset_hashes():
    """sha256 of the bundled preprocess weights."""
    import hashlib
    from pathlib import Path
    assets = Path(__file__).resolve().parent / "vhap_tpu_torch" / "assets"
    return {name: hashlib.sha256((assets / name).read_bytes()).hexdigest()
            for name in ("fan_weights.npz", "matting_weights.npz")}


def check_trainer(tool, kernels, smi_line):
    """Phases 27-28: a synthetic trainer through its main() at the tool's
    full width, TRAIN_STEPS deep, writing under build/, counts zeroed before
    and read after; K5, K6 forward and K3 at its last render; ms per step
    split into the render (with the crop and augmentation) and the
    network's forward, backward and Adam; device ms per step
    (torch.profiler over 10 more steps); peak memory above the resident;
    the held-out error;
    the written weights through the port's detector or matting class."""
    from pathlib import Path

    import numpy as np

    from vhap_tpu_torch.preprocess.landmarks import LandmarkDetectorFANNet
    from vhap_tpu_torch.preprocess.matting import MattingUNet
    from vhap_tpu_torch.tools import train_fan_synthetic as tf
    from vhap_tpu_torch.tools import train_matting_synthetic as tm
    steps = TRAIN_STEPS[tool]
    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / f"{tool}_weights.npz"
    for k in kernels.values():
        k.launches = 0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with capture_sampler(keep_last=True) as sampled, capture_vis(tf) as rendered, \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        tr = (tf if tool == "fan" else tm).main(
            ["--steps", str(steps), "--batch", str(TRAIN_BATCH), "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - resident
    launches = {name: k.launches for name, k in kernels.items()}
    result = printed.getvalue().strip().splitlines()[-1]
    if not result.startswith("RESULT: err=") or not np.isfinite(tr.err):
        raise RuntimeError(f"{tool} trainer printed {result!r}, err {tr.err}")
    # renders: the steps, the FAN's 16 BN-statistics batches, 4 held-out batches
    renders = steps + (16 if tool == "fan" else 0) + 4
    check_path_launches(f"{tool}_train", launches, renders)
    check_vis_launch(f"the {tool} trainer's last render", rendered[0], sampled)
    del sampled, rendered
    split = device_split(tr.step, reps=10)
    dev_ms = sum(split.values()) if split else None
    img = (tr.render(tr.sample())[0] if tool == "fan" else
           tr.render(*tr.sample())[0])[0].cpu().numpy()
    if tool == "fan":
        det = LandmarkDetectorFANNet(str(out)).detect_single_image(
            (img * 255).astype(np.uint8))
        loaded = f"LandmarkDetectorFANNet ran on a held-out render ({type(det).__name__})"
    else:
        alpha = MattingUNet(str(out)).predict(img)
        loaded = f"MattingUNet predicted a held-out alpha {alpha.shape}"
    dev = ("not measured (the profiler recorded no device op)" if dev_ms is None
           else f"{dev_ms:.3f} ms")
    log(f"[{tool}_train] times below on {smi_line}")
    log(f"[{tool}_train] {steps} steps at batch {TRAIN_BATCH}, {tf.IMG_SIZE}^2: "
        f"{wall:.2f} s in all ({'BN statistics, ' if tool == 'fan' else ''}held-out "
        f"error and save included); per step "
        f"{(tr.render_s + tr.net_s) / steps * 1e3:.3f} ms = render "
        f"{tr.render_s / steps * 1e3:.3f} + network forward, backward and Adam "
        f"{tr.net_s / steps * 1e3:.3f}; device {dev} per step; peak memory "
        f"{peak / 2**30:.3f} GiB above the resident {resident / 2**30:.3f}; held-out "
        f"error {tr.err:.4f}"
        f"{' px (batch 1, stored BN statistics)' if tool == 'fan' else ' (mean |d alpha|)'}; "
        f"{result}; {out.name} written, {loaded}")
    return launches


def check_viewers(kernels, ckpt, asset_dir, smi_line):
    """Phase 29: flame_viewer's main() on phase 22's tracked archive with the
    teeth head at 768^2 (PNG frames; no mp4 without ffmpeg) and
    flame_editor's main() jaw sweep, counts zeroed before and read after
    each; K5, K6 forward and K3 at the last render; every viewer frame and
    the sweep against the same call with use_kernels=False, frames not
    blank; a highlighted region; ms per frame."""
    import shutil
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from vhap_tpu_torch import flame_editor, flame_viewer

    def same_frames(where, a, b):
        d = np.abs(a.astype(int) - b.astype(int))
        share = float((d > 0).mean())
        if not (a.shape == b.shape and d.max() <= VIEW_LEVELS and share <= VIEW_SHARE):
            raise RuntimeError(f"{where}: card vs use_kernels=False differ by up to "
                               f"{d.max()} levels on {share:.3%} of the values")
        return int(d.max()), share

    def not_blank(where, frame):
        fg = float((frame < 250).any(-1).mean())
        if not (fg > 0.02 and frame.std() > 5):
            raise RuntimeError(f"{where}: a blank frame (foreground share {fg})")
        return fg

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        with capture_sampler(keep_last=True) as sampled, \
                capture_vis(flame_viewer) as rendered:
            viewer = flame_viewer.main(["--param_path", str(ckpt), "--out_dir",
                                        str(root / "viewer"), "--model.asset_dir",
                                        str(asset_dir), "--video"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches["viewer"] = {name: k.launches for name, k in kernels.items()}
        T = viewer.n_timesteps
        pngs = sorted((root / "viewer" / "frames").glob("*.png"))
        mp4 = (root / "viewer" / "sequence.mp4").exists()
        if len(pngs) != T or mp4 != bool(shutil.which("ffmpeg")):
            raise RuntimeError(f"viewer wrote {len(pngs)} PNGs of {T}, mp4 {mp4}")
        check_path_launches("viewer", launches["viewer"], T)
        check_vis_launch("the viewer's last frame", rendered[0], sampled)
        del sampled, rendered
        frames = [np.asarray(Image.open(p)) for p in pngs]
        fg = [not_blank(f"viewer frame {t}", f) for t, f in enumerate(frames)]
        times = []
        for _ in range(5):
            t = time.perf_counter()
            viewer.render_frame(0)
            times.append(time.perf_counter() - t)
        viewer.settings = replace(viewer.settings, use_kernels=False)
        diffs = [same_frames(f"viewer frame {t}", frames[t], viewer.render_frame(t))
                 for t in range(T)]
        log(f"[viewer] times below on {smi_line}")
        log(f"[viewer] main(): {T} frames of {ckpt.name} at {viewer.H}x{viewer.W}, head "
            f"V={viewer.head.num_verts} F={viewer.head.num_faces} (teeth), texture "
            f"{tuple(viewer.tex.shape[-2:])}, in {wall:.2f} s = {wall / T * 1e3:.1f} ms "
            f"per frame (PNG included; head built once); render_frame "
            f"{statistics.median(times) * 1e3:.3f} ms (median of 5); foreground share "
            f"{min(fg):.3f}-{max(fg):.3f}; against use_kernels=False at most "
            f"{max(d for d, _ in diffs)} level on {max(s for _, s in diffs):.4%} of "
            f"the values; mp4 {'written' if mp4 else 'skipped (no ffmpeg)'}")

        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        with capture_sampler(keep_last=True) as sampled, \
                capture_vis(flame_editor) as rendered:
            ed = flame_editor.main(["--out", str(root / "editor"), "--param", "jaw",
                                    "--model.asset_dir", str(asset_dir)])
        torch.cuda.synchronize()
        t_sweep = time.perf_counter() - t
        launches["editor"] = {name: k.launches for name, k in kernels.items()}
        n = 7                                        # the CLI's default sweep
        check_path_launches("editor", launches["editor"], n, textured=False)
        check_vis_launch("the editor's last frame", rendered[0], sampled)
        del sampled, rendered
        grid = np.asarray(Image.open(root / "editor" / "sweep_jaw.png"))
        W = ed.W
        if grid.shape != (ed.H, n * W, 3) or np.array_equal(grid[:, :W], grid[:, -W:]):
            raise RuntimeError(f"editor sweep {grid.shape}: the jaw did not move")
        not_blank("editor sweep", grid[:, :W])
        ed.settings = replace(ed.settings, use_kernels=False)
        d_sweep = same_frames("editor sweep", grid, ed.render_sweep(
            root / "editor_plain", "jaw", -0.3, 0.3, n))
        hl = flame_editor.FlameEditor(asset_dir=asset_dir, highlight_region="face")
        img = hl.render()
        red = float(((img[..., 0] > img[..., 1] + 60) & (img[..., 0] > 150)).mean())
        hl.settings = replace(hl.settings, use_kernels=False)
        same_frames("editor highlight", img, hl.render())
        if not red > 0.01:
            raise RuntimeError(f"editor: the highlighted face region covers {red} of the frame")
    log(f"[editor] main() jaw sweep of {n} frames at {ed.H}x{ed.W} in {t_sweep:.2f} s "
        f"= {t_sweep / n * 1e3:.1f} ms per frame (head built once, PNG included); "
        f"against use_kernels=False at most {d_sweep[0]} level on {d_sweep[1]:.4%} "
        f"of the values; highlight 'face' on {red:.3f} of the frame")
    return launches


# ---------------------------------------------------------------------------
# phase 30: batch-axis data parallelism (parallel/sharding.py)
# ---------------------------------------------------------------------------

SHARD_STEPS = 5                   # 30a's train steps, disturbance on
X4_SIZE = (802, 550)              # 30d's frames: the nersemble16 cell's (H, W)
SHARD_TIMEOUT, SHARD_JOIN = 300, 900   # collective and whole-run limits (s)


def _kernel_counters():
    from vhap_tpu_torch.ops.interp import FUSED_INTERP, FUSED_INTERP_BWD
    from vhap_tpu_torch.ops.rasterize import VISIBILITY
    from vhap_tpu_torch.ops.texture_fetch import TRILINEAR_SAMPLE, TRILINEAR_SAMPLE_BWD
    return {"K1 visibility": VISIBILITY, "K2f fused_interp": FUSED_INTERP,
            "K3 trilinear_sample": TRILINEAR_SAMPLE,
            "K2b fused_interp_bwd": FUSED_INTERP_BWD,
            "K4 trilinear_sample_bwd": TRILINEAR_SAMPLE_BWD}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def sharded_mv_step(device, root, with_grads):
    """One rank of phases 30a, 30c and 30d: the 16-view step of the rig at
    `root` on this rank's views (tools/multiview_slice.py on the process
    group). Its E share and the all-reduced gradients with the disturbance
    off (the gradients returned when `with_grads`, else their digests); on
    rank 0 K1 and K3 at the rank's own eval-step launch (check_k1,
    check_k3); then SHARD_STEPS train steps with the disturbance on through
    the tracker's graphed step (tracker/step_graph.py: under NCCL the first
    call eager, the second captured with its collectives, the rest
    replayed; under gloo every call eager), counts zeroed before and read
    after and again from the third call on (the replays'), the calls
    counted eager, captured and replayed, ms per step and peak memory; on
    rank 0, K3 and K4 against their plain versions at the last replay's K4
    launch (check_replayed_sampler) where the step replayed; the
    parameters' digests after the steps; all_reduce_grads' bytes and ms
    (median of 5 on the step's gradients)."""
    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.parallel import sharding
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice
    from vhap_tpu_torch.tracker.energy import fill_cam_params
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    from vhap_tpu_torch.tracker.step_graph import StepGraphs, graphed_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ts = build_multiview_slice(root, device=device)
    s = ts.eval
    (H, W), B = s.image_size, s.batch["rgb"].shape[0]
    res = {"rank": sharding.rank(), "world": sharding.world(), "rows": B,
           "weight": s.batch["weight"].tolist(), "backend": torch.distributed.get_backend()}

    def progress(what):
        log(f"[shard] {res['backend']} rank {res['rank']}: {what} at "
            f"{time.perf_counter() - t0:.1f} s")
    progress(f"{B} views of {H}x{W} built")
    E, logs, g = loss_and_grads(ts.make_energy(True, False), s.params, ts.opt_leaves,
                                s.batch, ts.generator(1))
    res["E"] = float(E)
    res["grad_digest"] = {k: _digest(v) for k, v in g.items()}
    if with_grads:
        res["grads"] = {k: v.cpu() for k, v in g.items()}
    with capture_sampler() as sampled:
        _, (_, aux) = run_step(s.make_energy(True), s.params, s.batch)
    if sharding.rank() == 0:
        K, RT = fill_cam_params(s.batch, s.params, True, (H, W))
        verts_clip = cam.camera_to_clip(cam.world_to_camera(aux["verts"], RT), K, (H, W))
        _, r1 = check_k1(s, verts_clip)
        err3, _, _ = check_k3("rank 0's eval-step launch", sampled["fwd"][0])
        res["k1"], res["k3_err"] = r1["note"], err3
    del aux, sampled
    progress("gradients and rank 0's eval-step checks done")
    kernels = _kernel_counters()
    graphs = StepGraphs()
    init, step = graphed_train_step(ts.make_energy(True, True), ts.opt_leaves,
                                    ts.lr_map, 1.0, graphs)
    params, state, gen = s.params, init(s.params), ts.generator(sharding.rank())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    with capture_sampler(keep_last=True) as sampled:
        for i in range(SHARD_STEPS):
            if i == 2:
                before = {name: k.launches for name, k in kernels.items()}
            t = time.perf_counter()
            params, state, E, _ = step(params, state, s.batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    res["E_last"] = float(E)
    res["launches"] = {name: k.launches for name, k in kernels.items()}
    res["replay_launches"] = {name: k.launches - before[name]
                              for name, k in kernels.items()}
    res["step_graph"] = graphs.counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    progress(f"{SHARD_STEPS} train steps run, calls {res['step_graph']}")
    if sharding.rank() == 0 and graphs.replays:
        k3, k4 = check_replayed_sampler(f"{res['backend']} rank 0", sampled)
        res["replayed_k3_k4"] = f"K3 {k3['note']}; K4 {k4['note']}"
    del sampled
    res["step_ms"] = times
    res["param_digest"] = {k: _digest(v) for k, v in params.items()}
    ar = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sharding.all_reduce_grads(g)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t) * 1e3)
    res["allreduce_ms"] = statistics.median(ar)
    res["allreduce_bytes"] = sharding.step_collectives()["grads"]["bytes"]
    progress("all_reduce_grads timed")
    return res


def check_sharded_step(root, devices, backend, ref, where):
    """Phases 30a, 30c, 30d: sharded_mv_step on `devices` under `backend`
    against the one-process step `ref` (E, gradients) on the same card: E
    within 1e-5 relative, every gradient within 1e-3 * max|g| (K4's and
    the vertex normals' atomics change the order), the gradients and, after
    SHARD_STEPS steps, the parameters bit-identical across ranks, K1..K4
    once per step on every rank; under NCCL every rank's step captured on
    its second call and replayed after it (K1..K4 once per replay), rank
    0's last replayed K3/K4 launch within check_sampler's gates; under gloo
    every call eager. Returns rank 0's launches."""
    from vhap_tpu_torch.parallel import sharding
    t = time.perf_counter()
    out = sharding.launch(sharded_mv_step, devices, backend, args=(str(root), True),
                          timeout=SHARD_TIMEOUT, join_timeout=SHARD_JOIN)
    wall = time.perf_counter() - t
    E_ref, g_ref = ref
    E = sum(r["E"] for r in out)
    rel = abs(E - E_ref) / abs(E_ref)
    worst = {}
    for k, gr in g_ref.items():
        scale = float(gr.abs().max())
        worst[k] = float((out[0]["grads"][k] - gr).abs().max()) / scale
    for r in out[1:]:
        if r["grad_digest"] != out[0]["grad_digest"]:
            raise RuntimeError(f"{where}: the all-reduced gradients differ between ranks")
        if r["param_digest"] != out[0]["param_digest"]:
            raise RuntimeError(f"{where}: parameters differ between ranks after "
                               f"{SHARD_STEPS} steps")
    if not (rel <= 1e-5 and max(worst.values()) <= 1e-3):
        raise RuntimeError(f"{where}: E rel {rel} (1e-5), gradient err / max|g| {worst} (1e-3)")
    graphed = backend == "nccl"
    want = ({"captures": 1, "replays": SHARD_STEPS - 2, "eager": 1} if graphed
            else {"captures": 0, "replays": 0, "eager": SHARD_STEPS})
    for r in out:
        bad = {k: n for k, n in r["launches"].items() if n != SHARD_STEPS}
        if bad:
            raise RuntimeError(f"{where}: rank {r['rank']} launched {bad} in "
                               f"{SHARD_STEPS} steps, expected {SHARD_STEPS} each")
        if r["step_graph"] != want:
            raise RuntimeError(f"{where}: rank {r['rank']}'s step calls {r['step_graph']}, "
                               f"expected {want}")
        bad = {k: n for k, n in r["replay_launches"].items() if n != SHARD_STEPS - 2}
        if bad:
            raise RuntimeError(f"{where}: rank {r['rank']} launched {bad} in its calls "
                               f"3-{SHARD_STEPS}, expected {SHARD_STEPS - 2} each")
    if graphed != ("replayed_k3_k4" in out[0]):
        raise RuntimeError(f"{where}: rank 0's replayed K3/K4 launch "
                           f"{'not ' if graphed else ''}checked")
    log(f"[shard] {where}: {len(devices)} {backend} ranks on {', '.join(devices)} "
        f"(launch wall {wall:.1f} s), rows per rank {out[0]['rows']}, weights "
        f"{[r['weight'] for r in out]}; E (sum of shares) {E:.6f} vs one process "
        f"{E_ref:.6f}, rel {rel:.3g}; gradient err / max|g| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items())
        + f"; gradients and parameters after {SHARD_STEPS} steps bit-identical "
        f"across ranks; K1 on rank 0: {out[0]['k1']}; K3 on rank 0: err "
        f"{out[0]['k3_err']:.3g}; step calls on every rank {want}"
        + (f"; rank 0's last replay: {out[0]['replayed_k3_k4']}" if graphed else ""))
    for r in out:
        ms = r["step_ms"]
        log(f"[shard] {where} rank {r['rank']}: launches in {SHARD_STEPS} steps "
            f"{r['launches']}, in calls 3-{SHARD_STEPS} {r['replay_launches']}; ms per "
            f"step {statistics.median(ms[1:]):.3f} (median "
            f"of steps 2-{SHARD_STEPS}; all {[round(x, 3) for x in ms]}); peak "
            f"{r['peak_gib']:.3f} GiB; all_reduce_grads {r['allreduce_bytes']} "
            f"bytes per step, {r['allreduce_ms']:.3f} ms (median of 5)")
    return out[0]["launches"]


def sharded_track(device, root, out, kept):
    """One rank of phase 30b: GlobalTracker with track_nersemble's config
    on phase 22's rig and depth (tools/loader_ab.mv_config), counts zeroed
    before and read after; a copy of the run state written after the
    sequential phase kept at `kept` (rank 0), then a second tracker resumed
    from it. Returns both runs' summaries with their launches."""
    import shutil

    from vhap_tpu_torch.tools.loader_ab import mv_config
    from vhap_tpu_torch.tracker.tracker import GlobalTracker
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mv_config(Path(root), Path(out), str(device))
    cfg.exp.num_devices = 2
    kernels = _kernel_counters()
    res = {}
    for name in ("run", "resume"):
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        tr = GlobalTracker(cfg, device)
        if name == "run":
            save = tr.save_run_state

            def save_and_keep(phase, cursor, epoch=0, tr=tr, save=save):
                save(phase, cursor, epoch)
                if phase == "global" and tr.lead:
                    shutil.copy(tr.out_dir / "run_state.npz", kept)
            tr.save_run_state = save_and_keep
            tr.optimize()
        else:
            tr.optimize(resume_state_path=kept)
        torch.cuda.synchronize()
        res[name] = dict(tr.summary(), wall=time.perf_counter() - t,
                         launches={n: k.launches for n, k in kernels.items()},
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         native=tr.dataset.supports_native_batch())
    return res


def check_sharded_track(root, run_dir):
    """Phase 30b: sharded_track on two gloo ranks on cuda:0: every rank K1,
    K2f, K3 once per rgb step and evaluation render and K2b, K4 once per rgb
    step; every batch native; multiview GT recovery at phase 22's gate;
    rank 0's output folder with phase 22's file names (tensorboard's event
    file named by time and host); the resumed run the global stage alone,
    its recovery passing too. Returns rank 0's launches."""
    import numpy as np

    from vhap_tpu_torch.parallel import sharding
    kept = root / "sharded_run_state.npz"
    out = sharding.launch(sharded_track, ["cuda:0", "cuda:0"], "gloo",
                          args=(str(root), str(root / "track_sharded"), str(kept)),
                          timeout=SHARD_TIMEOUT, join_timeout=SHARD_JOIN)

    def names(d):
        return sorted("events.out.tfevents*" if p.name.startswith("events.out.tfevents")
                      else str(p.relative_to(d)) for p in Path(d).rglob("*"))

    for r in out:
        for name, m in r.items():
            rgb = sum(n for st, n in m["steps_by_stage"].items() if st.startswith("rgb"))
            want = {"K1 visibility": rgb + m["eval_calls"],
                    "K2f fused_interp": rgb + m["eval_calls"],
                    "K3 trilinear_sample": rgb + m["eval_calls"],
                    "K2b fused_interp_bwd": rgb, "K4 trilinear_sample_bwd": rgb}
            if m["launches"] != want:
                raise RuntimeError(f"sharded track_nersemble ({name}) rank {m['rank']}: "
                                   f"launches {m['launches']}, expected {want}")
            if not (m["native"] and m["native_batches"] > 0 and m["pil_batches"] == 0):
                raise RuntimeError(f"sharded track_nersemble ({name}) rank {m['rank']}: "
                                   f"{m['native_batches']} native, {m['pil_batches']} PIL "
                                   f"batches")
    run, resume = out[0]["run"], out[0]["resume"]
    if set(resume["steps_by_stage"]) != {"rgb_global_tracking"}:
        raise RuntimeError(f"the resumed run ran {resume['steps_by_stage']}")
    if names(run["out_dir"]) != names(run_dir):
        a, b = set(names(run["out_dir"])), set(names(run_dir))
        raise RuntimeError(f"rank 0's files differ from phase 22's: only sharded "
                           f"{sorted(a - b)[:10]}, only phase 22 {sorted(b - a)[:10]}")
    with np.load(Path(root) / "data" / "001" / "SEN-01" / "gt_params.npz") as gt:
        gt = dict(gt)
    rec = {}
    for name, m in (("run", run), ("resume", resume)):
        z = np.load(sorted(Path(m["out_dir"]).glob("tracked_flame_params_*.npz"))[-1])
        rec[name] = (float(np.abs(z["translation"] - gt["translation"]).mean()),
                     float(np.abs(z["rotation"] - gt["rotation"]).mean()))
        if not (rec[name][0] < 0.02 and rec[name][1] < 0.08):
            raise RuntimeError(f"sharded track_nersemble ({name}): GT recovery "
                               f"failed: translation {rec[name][0]}, rotation {rec[name][1]}")
    for r in out:
        m = r["run"]
        log(f"[shard] 30b rank {m['rank']}: steps {m['steps_by_stage']}, {m['eval_calls']} "
            f"evaluation renders, launches {m['launches']}; ms per step by stage "
            + ", ".join(f"{st} {ms:.3f}" for st, ms in m["ms_per_step"].items()
                        if ms is not None)
            + f"; wall {m['wall']:.2f} s ({m['wall'] / m['n_timesteps']:.2f} s per "
            f"timestep); {m['native_batches']} native batches, {m['pil_batches']} PIL; "
            f"peak {m['peak_gib']:.3f} GiB; resume: global stage "
            f"{r['resume']['steps_by_stage']}, {r['resume']['wall']:.2f} s")
    log(f"[shard] 30b GT recovery: mean |d translation| {rec['run'][0]:.6f} (< 0.02), "
        f"|d rotation| {rec['run'][1]:.6f} (< 0.08); resumed {rec['resume'][0]:.6f}, "
        f"{rec['resume'][1]:.6f}; rank 0's folder holds phase 22's "
        f"{len(names(run_dir))} file names")
    return run["launches"]


def sharding_reference(root):
    """The one-process 16-view step on the card (phase 21's, disturbance
    off): (E, gradients on the host), what phase 30 compares with."""
    from vhap_tpu_torch.tools.multiview_slice import build_multiview_slice
    from vhap_tpu_torch.tracker.optim import loss_and_grads
    ts = build_multiview_slice(root, device="cuda")
    s = ts.eval
    E, _, g = loss_and_grads(ts.make_energy(True, False), s.params, ts.opt_leaves,
                             s.batch, ts.generator(1))
    ref = (float(E), {k: v.cpu() for k, v in g.items()})
    del ts, s, g
    torch.cuda.empty_cache()
    return ref


def check_multi_card(root):
    """Phase 30d: NCCL across min(4, count) cards where there are two or
    more, on a rig of MV_CAMS views at X4_SIZE written under root/x4 (on
    four cards each rank's batch is the nersemble16.seq.x4 cell's, 4 views
    of 802x550), against the one-process step on that rig; else one line
    saying it was not run."""
    from vhap_tpu_torch.tools.multiview_slice import write_rig
    n = min(4, torch.cuda.device_count())
    if n < 2:
        log(f"[shard] 30d not run: {torch.cuda.device_count()} card(s) visible, "
            f"NCCL across cards needs two or more")
        return
    rig = Path(root) / "x4"
    write_rig(rig, n_cams=MV_CAMS, n_frames=MV_TRACK_FRAMES, size=X4_SIZE, device="cuda")
    check_sharded_step(rig, [f"cuda:{i}" for i in range(n)], "nccl",
                       sharding_reference(rig), "30d")


def check_sharding(root, run_dir, smi_line):
    """Phase 30: 30a two gloo ranks on cuda:0 (check_sharded_step), 30b
    the tracker on them (check_sharded_track), 30c NCCL at world 1 through
    the same launcher, 30d (check_multi_card). Returns {path: launches}
    for the kernels line."""
    log(f"[shard] phase 30 on {smi_line}")
    ref = sharding_reference(root)
    paths = {"sharded mv step (per rank)": check_sharded_step(
        root, ["cuda:0", "cuda:0"], "gloo", ref, "30a")}
    paths["sharded track_nersemble (per rank)"] = check_sharded_track(root, run_dir)
    check_sharded_step(root, ["cuda:0"], "nccl", ref, "30c")
    check_multi_card(root)
    return paths


def main() -> int:
    smi_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    laps = [t0]

    def lap(phases: str) -> None:
        now = time.perf_counter()
        log(f"[time] phases {phases}: {now - laps[-1]:.1f} s (run {now - t0:.1f} s)")
        laps.append(now)

    build_kernels()
    lap("1-2 (card, build)")

    from vhap_tpu_torch.ops import camera as cam
    from vhap_tpu_torch.ops.interp import FUSED_INTERP, FUSED_INTERP_BWD
    from vhap_tpu_torch.ops.rasterize import VISIBILITY
    from vhap_tpu_torch.ops.texture_fetch import TRILINEAR_SAMPLE, TRILINEAR_SAMPLE_BWD
    from vhap_tpu_torch.tools.train_slice import build_train_slice
    from vhap_tpu_torch.tracker.energy import fill_cam_params

    ts = build_train_slice(device="cuda")
    s = ts.eval
    B = s.batch["rgb"].shape[0]
    H, W = s.image_size
    log(f"[slice] B={B} {H}x{W} tex {s.cfg.model.tex_resolution} "
        f"n_shape={s.cfg.model.n_shape} n_expr={s.cfg.model.n_expr}; head "
        f"V={s.head.num_verts} F={s.head.num_faces} (synthetic: "
        f"{list(s.head.assets.synthetic_parts)}); train stage {ts.stage}, "
        f"disturbance rates {s.cfg.render.disturb_rate_fg} / "
        f"{s.cfg.render.disturb_rate_bg}, pool stride "
        f"{s.cfg.render.disturb_pool_stride}; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. the eval path: one eval step through the kernels ----
    kernels = {"K1 visibility": VISIBILITY, "K2f fused_interp": FUSED_INTERP,
               "K3 trilinear_sample": TRILINEAR_SAMPLE}
    per_step = {name: 1 for name in kernels}
    paths = {}      # path -> {kernel row name: launches}, for the kernels line
    eval_kernels = s.make_energy(True)
    for k in kernels.values():
        k.launches = 0
    with capture_sampler() as eval_sampled:
        E, (logs, aux) = run_step(eval_kernels, s.params, s.batch)
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"[main] launches in one eval step: {launches}")
    paths["eval step"] = launches
    for name, n in launches.items():
        if n != per_step[name]:
            raise RuntimeError(f"{name} launched {n} times on the main path, "
                               f"expected {per_step[name]}")
    n_lmk = s.head.lmk_faces_idx.shape[0]
    for key, shape in (("pred_rgb", (B, H, W, 3)), ("pred_alpha", (B, H, W, 1)),
                       ("pred_lmk2d", (B, n_lmk, 2))):
        if tuple(aux[key].shape) != shape or not torch.isfinite(aux[key]).all():
            raise RuntimeError(f"{key}: shape {tuple(aux[key].shape)}, "
                               f"expected {shape}, or values not finite")
    fg_share = float(aux["pred_alpha"].gt(0).float().mean())
    if not (0.02 < fg_share < 0.9 and torch.isfinite(E)):
        raise RuntimeError(f"implausible render: fg share {fg_share}, E {E}")
    log(f"[main] E_total {float(E):.6f} lmk {float(logs['lmk']):.6f} "
        f"photo {float(logs['photo']):.6f} fg share {fg_share:.4f}")

    # ---- 4. each kernel against its plain version, on the path's inputs ----
    K, RT = fill_cam_params(s.batch, s.params, False, (H, W))
    verts = aux["verts"]
    verts_clip = cam.camera_to_clip(cam.world_to_camera(verts, RT), K, (H, W))
    tri_id, r1 = check_k1(s, verts_clip)
    _, r2 = check_k2(s, verts_clip, verts, tri_id)
    r3, _ = check_sampler_launches("the eval step's launch", eval_sampled, 1, 0)

    # ---- 5. the whole step through the plain versions; step timing ----
    eval_plain = s.make_energy(False)
    Ep, (logs_p, _) = run_step(eval_plain, s.params, s.batch)
    rel = abs(float(E) - float(Ep)) / abs(float(Ep))
    rel_photo = (abs(float(logs["photo"]) - float(logs_p["photo"]))
                 / abs(float(logs_p["photo"])))
    if not (rel <= 1e-4 and rel_photo <= 1e-4
            and float(logs["lmk"]) == float(logs_p["lmk"])):
        raise RuntimeError(f"eval energy through the kernels disagrees with the "
                           f"plain path: E rel {rel}, photo rel {rel_photo}, lmk "
                           f"{float(logs['lmk'])} vs {float(logs_p['lmk'])}")
    lap("3-4 (eval path, K1 K2f K3 K4)")
    log(f"[energy] kernels vs plain: E_total rel {rel:.3g}, photo rel "
        f"{rel_photo:.3g}, lmk equal")

    def step_ms(fn, warmup, reps):
        times = []
        for _ in range(warmup + reps):
            t = time.perf_counter()
            run_step(fn, s.params, s.batch)
            times.append(time.perf_counter() - t)
        return statistics.median(times[warmup:]) * 1e3

    torch.cuda.reset_peak_memory_stats()
    ms_k = step_ms(eval_kernels, 2, 10)
    peak = torch.cuda.max_memory_allocated()
    ms_p = step_ms(eval_plain, 1, 3)
    log(f"[step] eval step {ms_k:.3f} ms (median of 10), {B / ms_k * 1e3:.2f} "
        f"frames/s, peak memory {peak / 2**30:.3f} GiB; through the plain "
        f"versions {ms_p:.3f} ms (median of 3); run {time.perf_counter() - t0:.1f} s")

    # ---- 6. the train path: one train step through the kernels ----
    train_kernels = dict(kernels, **{"K2b fused_interp_bwd": FUSED_INTERP_BWD,
                                     "K4 trilinear_sample_bwd": TRILINEAR_SAMPLE_BWD})
    train_launches, k2b_args, train_sampled = check_train_step(ts, train_kernels, 1)
    paths["train step"] = train_launches

    # ---- 7. K2b and K4 against their plain versions; 4 and 7 timed ----
    r4 = check_k2b(k2b_args)
    _, r5 = check_sampler_launches("the train step's launch", train_sampled, 1, 1)
    rows_out = [kernel_row(r, train_launches[r["name"]])
                for r in (r1, r2, r3, r4, r5)]

    # ---- 8. the train step through the plain versions; step timing ----
    lap("5-7 (eval timing, train path, K2b K4)")
    check_train_plain(ts)
    single_step_ms = train_timing(ts, t0)
    check_cotangent_traffic(ts)
    lap("8 (train vs plain, timing)")

    # ---- 9. the vis path: render_rgba_vis + its gradient through the kernels ----
    from vhap_tpu_torch.ops.plane_gather import PLANE_GATHER, PLANE_GATHER_BWD
    from vhap_tpu_torch.tools.vis_slice import vis_slice_from_eval
    vs = vis_slice_from_eval(s)
    vis_kernels = {"K5 visibility": VISIBILITY, "K6f plane_gather": PLANE_GATHER,
                   "K6b plane_gather_bwd": PLANE_GATHER_BWD,
                   "K3 trilinear_sample": TRILINEAR_SAMPLE,
                   "K4 trilinear_sample_bwd": TRILINEAR_SAMPLE_BWD,
                   "K2f fused_interp": FUSED_INTERP,
                   "K2b fused_interp_bwd": FUSED_INTERP_BWD}
    vis_launches, cot, vis_sampled = check_vis_path(vs, vis_kernels)
    paths["vis render + gradient"] = vis_launches

    # ---- 10-12. K5 and K6 against their plain versions, timed ----
    tri_vis, r6 = check_k5(vs)
    r7, r8 = check_k6(vs, tri_vis)
    rows_out += [kernel_row(r, vis_launches[r["name"]]) for r in (r6, r7, r8)]

    # ---- 13-14. the vis render and gradient vs the plain path; timing ----
    check_vis_plain(vs, cot, vis_sampled)
    del vis_sampled
    lap("9-14 (vis path, K5 K6)")

    # ---- 15. the entry points ----
    check_entry_points(vs)
    lap("15 (entry points)")

    # ---- 16. the dense configuration (K7): eval and train steps ----
    from vhap_tpu_torch.ops.texture_fetch import SCATTER_VALS
    dense_eval, dense_train, dense_k2b_args = check_dense_path(ts, train_kernels)
    # the dense configuration's K2f and K2b launches are its K7f and K7b
    dense_name = {"K2f fused_interp": "K7f fused_interp (dense)",
                  "K2b fused_interp_bwd": "K7b fused_interp_bwd (dense)"}
    paths["dense eval step"] = {dense_name.get(k, k): n for k, n in dense_eval.items()}
    paths["dense train step"] = {dense_name.get(k, k): n for k, n in dense_train.items()}
    # K7f's inputs: the render builds them as the flat configuration's (the
    # port has one path), from the same parameters; K7b at the dense train
    # step's own launch
    _, r9 = check_k2(s, verts_clip, verts, tri_id, name="K7f fused_interp (dense)",
                     replaces="vhap_tpu/ops/interp_pallas.py:259")
    r10 = check_k2b(dense_k2b_args, name="K7b fused_interp_bwd (dense)",
                    replaces="vhap_tpu/ops/interp_pallas.py:291")
    rows_out += [kernel_row(r9, dense_eval["K2f fused_interp"]),
                 kernel_row(r10, dense_train["K2b fused_interp_bwd"])]
    lap("16 (dense configuration, K7)")

    # ---- 17. K8: scatter_taps on the train step's taps ----
    k8_launches, r11 = check_k8(train_sampled["bwd"][0],
                                {"K8 scatter_taps": SCATTER_VALS})
    paths["K8 call"] = k8_launches
    rows_out.append(kernel_row(r11, k8_launches["K8 scatter_taps"]))
    lap("17 (K8)")

    # ---- 18. K1 and K2b on adversarial scenes; K3 and K4 on adversarial uvs ----
    check_adversarial()
    del train_sampled
    check_adversarial_sampler((B, (H, W)), s.cfg.model.tex_resolution)
    lap("18 (adversarial scenes and uvs, K1 K2b K3 K4)")

    # ---- 19. the tracker loop; 20. GT recovery ----
    loop_launches = check_tracker_loop(train_kernels, single_step_ms)
    paths["tracker loop"] = loop_launches
    lap("19 (tracker loop + resume)")
    check_recovery()
    lap("20 (GT recovery)")

    # ---- 21. the multiview step; 22. track_nersemble; 23. export, combine ----
    import tempfile
    from pathlib import Path

    from vhap_tpu_torch.tools.multiview_slice import write_rig
    with tempfile.TemporaryDirectory() as tmp:
        mv_root = Path(tmp)
        t = time.perf_counter()
        write_rig(mv_root, n_cams=MV_CAMS, n_frames=MV_TRACK_FRAMES, size=512,
                  device="cuda")
        log(f"[mv] rig: {MV_CAMS} cameras x {MV_TRACK_FRAMES} timesteps at 512^2 "
            f"with the teeth head and per-camera colour correction, written in "
            f"{time.perf_counter() - t:.2f} s")
        mv_eval, mv_train = check_multiview_step(mv_root, train_kernels, t0)
        paths["multiview eval step"] = mv_eval
        paths["multiview train step"] = mv_train
        lap("21 (multiview step, K1 K2f K3 K2b K4)")
        nersemble_launches, run_dir = check_track_nersemble(mv_root, train_kernels)
        paths["track_nersemble"] = nersemble_launches
        lap("22 (track_nersemble)")
        check_export(run_dir, mv_root)
        lap("23 (export, combine)")

        # ---- 24. the preprocess networks; 25. preprocess -> track ----
        check_preprocess_nets(smi_line)
        lap("24 (preprocess networks)")
        paths["preprocess → track"] = check_preprocess_track(train_kernels, smi_line)
        lap("25 (preprocess -> track)")

        # ---- 26. the native loader; 27-28. the trainers; 29. the viewers ----
        check_native_loader(smi_line)
        lap("26 (native frame loader)")
        render_kernels = {k: vis_kernels[k] for k in
                          ("K5 visibility", "K6f plane_gather", "K3 trilinear_sample")}
        hashes = asset_hashes()
        paths["fan_train"] = check_trainer("fan", render_kernels, smi_line)
        lap("27 (FAN trainer)")
        paths["matting_train"] = check_trainer("matting", render_kernels, smi_line)
        if asset_hashes() != hashes:
            raise RuntimeError("the trainers changed the bundled weights")
        log("[assets] bundled weights unchanged: " + ", ".join(
            f"{k} sha256 {v}" for k, v in hashes.items()))
        lap("28 (matting trainer)")
        ckpt = sorted(run_dir.glob("tracked_flame_params_*.npz"))[-1]
        paths.update(check_viewers(render_kernels, ckpt, mv_root / "assets", smi_line))
        lap("29 (viewer, editor)")

        # ---- 30. batch-axis data parallelism: 30a-30d ----
        paths.update(check_sharding(mv_root, run_dir, smi_line))
        lap("30 (data parallelism)")
    log(f"[done] run {time.perf_counter() - t0:.1f} s")

    for row in rows_out:
        row["launches_by_path"] = {p: n[row["name"]] for p, n in paths.items()
                                   if row["name"] in n}

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_multi_card() -> int:
    """`python3 chip_smoke.py --multi-card`: phases 1-2 and 30d alone (its
    rig and the one-process step it is compared with), for a machine with
    several cards."""
    import tempfile
    smi_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[time] phases 1-2: {time.perf_counter() - t0:.1f} s")
        log(f"[shard] phase 30d on {smi_line}")
        check_multi_card(tmp)
        log(f"[time] 30d: run {time.perf_counter() - t0:.1f} s")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_multi_card() if sys.argv[1:] == ["--multi-card"] else main())
