#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the main path from `iip_uavsal_saliency_tpu_torch/csrc/` with
   nvcc for sm_90a, one nvcc per source, all started together.
2. Holds each kernel against its plain PyTorch version on the card:
   K1 (`ops/twa.py::twa_scan`) vs `twa_scan_ref`: the persistent kernel
   (one launch per clip, bf16) at the flagship shape (S=20, 45x80x256) for
   V=1, 2 and 4, also against the per-frame bf16 kernel on the same inputs
   and for equal bits on 20 more runs (a stale read of h_{s-1} between blocks
   would be rare, so one repeat is not enough); the per-frame kernel at the flagship
   shape in f32 (and for equal bits on 20 more runs) and at a ragged shape
   (V=2, S=3, 13x7x24) in bf16 and f32;
   and shard invariance, the content of the JAX package's
   `twa_scan_sharded`: K1 on V=4 (S=3, 13x7x24 and 45x80x256, bf16 and f32)
   equals, bit for bit, K1 on x[:2] and x[2:] concatenated. The bf16
   per-frame kernel (`wgmma`, W_h packed by `pack_twa_weights_bf16`) forced
   onto it at 1x20x45x80x256, 4x20x45x80x256 and 720x1280 serving's
   1x20x90x160x256, and the ragged 2x3x13x7x24, against the plain version,
   the persistent kernel where it takes the shape, its own bits over 20
   more runs, V=4 against V=2 + V=2 (45x80 and 90x160), and the pack's
   layout constants against the source's (`twa_bf16_layout`). K2 (`ops/dwblock.py::
   fused_dwblock_kernel`) vs `dwblock_ref` at 20x45x80 with C=256->256,
   E=1536, residual, with C=320->256, E=1920, and at a ragged 2x13x7 with
   C=24->16, in bf16 and f32; and, with phase 3, at every shape the main
   path gives it: each DWBlock that K2's gate admits, on the block's own
   packed weights and the input it receives in a serving step, in bf16 and
   f32. Then the gradient wrappers `fused_dwblock` and `twa_scan`, kernel
   forward in f32, against autograd through the plain versions.
3. Drives the port's main paths at full width: UAVSal at 360x640 with
   seeded random weights (numpy -> JAX variable tree -> `from_jax_variables`
   -> BatchNorm folded into the convs, through `load_model_for_inference`),
   the baked bf16 serving step, and `predict_videos` over one synthetic
   uint8 video of 3 clips of S=20 frames with the state carried, postprocessed to a native
   540x960 uint8. Launch counts are reset just before and read just after;
   a bf16 run must launch the persistent K1 exactly 3 times (once per clip)
   and the per-frame K1 never, an f32 run the per-frame K1 exactly 60 times
   and the persistent one never. Outputs must be finite, in
   [0, 1], the state must change from clip to clip, and the bf16 saliency
   must agree with an f32 run of the port on the card (CC >= 0.99 per frame).
   What K1 was given and what it returned in each clip of the bf16 runs is
   kept, and the persistent kernel's served output is held against the
   per-frame kernel and the plain version on those same inputs.
   The same video then goes through the fused-dwBlock path
   (`load_model_for_inference(..., fused_dwblock=True)`): every DWBlock the
   kernel's gate admits is one launch of K2, so the run must launch K1 as
   above and K2 once per admitted block and clip, exactly; its bf16 maps
   must agree with the f32 run and with the bf16 run without K2 (CC >= 0.99
   per frame), and its f32 maps with the f32 run without K2.
   Each of the four paths runs twice: with the eager step (the checks
   above, whose recorders need Python to run on every call) and as a user
   runs it, the step replayed from a CUDA graph (`graph_step`) through the
   pipelined `predict_videos`, under the profiler. The graph's own kernel
   nodes must be the eager run's launches per clip, exactly, and the trace
   must show each of them running (the profiler drops records, so it does
   not count them); the wrappers count none there (a replay runs without
   them). It must give the eager run's uint8 maps bit for bit, and over the
   3 carried clips the eager step's saliency and state bit for bit. The
   `launches` of the kernels line are the eager runs' counts.
3b. Drives the JAX `UAVSal`'s other configurations at the same width
   (seeded numpy weights of each configuration's own -> JAX-layout tree ->
   `load_model_for_inference(..., cnn_type=, num_stblock=, bias_type=)`):
   ResNet-50 (bf16 with K2 off and on, f32) and VGG16 (bf16 and f32)
   through every check above (3 carried clips, K1's launches exact, K2's
   once per admitted block and clip, graphed equal to eager bit for bit,
   the bf16 maps against the f32 run at CC >= 0.99 per frame), each f32
   run's first clip against the port on the CPU (with two TF32 controls
   that the bounds must catch), their graphed bf16 steps
   and the runner over 20 clips timed in turns with the flagship's, one
   step of each profiled (`build/chip_smoke_profile_{resnet50,vgg16}.txt`,
   K1's share); then ResNet-18/34/101/152 and the flagship with
   `bias_type` (1,0,1) and (0,0,0), one eager bf16 clip each: K1 once,
   finite saliency in [0, 1], a new state. Each configuration's launches
   are printed, and listed in the kernels line (`config_launches`).
3c. Serves the flagship at `--iosize 720,1280,90,160` (UAV2's native
   size; the 90x160x256 state is too wide for the persistent K1): bf16 with
   K2 off and f32, one synthetic 720x1280 video of 3 carried clips of S=20,
   eager and graphed through every check of phase 3 (bf16 launches K1's
   per-frame kernel exactly 20 times a clip and the persistent one never;
   K1 as served the bits of the kernel alone and within TOL_BF16 of the
   plain version in f32), bf16 against f32 at CC >= 0.99 per frame, and the
   launches of one bf16 mixed train step at that size (10); then its
   graphed step and the runner over 20 clips in turns with the flagship's,
   and a profile of one step (`build/chip_smoke_profile_720p.txt`, K1's
   share).
4. Times the serving step with K2 off and on, eager and graphed (ms per
   clip, FPS), the host's time to issue one step (eager against one
   replay), the pipelined `predict_videos` end to end, graphed and eager,
   K2 off and on, in turns, five runs each over 3 clips and over 20 clips
   (host clock), the runner alone (a step that does no work) and the idle
   share of the serving stream over one graphed 20-clip run under the
   profiler (`build/chip_smoke_profile_runner.txt`), and each
   kernel (its time per launch, its plain version's, one PyTorch call's, and
   its bound) with CUDA events after warm-up, each the median of 7 timed
   windows; K1's two kernels and its library yardstick in turns (per-frame,
   persistent, library, library, persistent, per-frame) at V=1 and V=4 in
   bf16, and the per-frame kernel beside the yardstick at 720x1280's
   1x20x90x160x256, with the fastest window beside each median, and the per-frame
   kernel in f32 (3xTF32), as the f32 paths launch it, beside its own f32
   yardstick, plain version and bound (3xTF32, with the FMA bound beside
   it); the f32 serving step, graphed, K2 off and on, in turns; K2 at each
   admitted block of the bf16 path and
   of the f32 path on that block's own input beside the block as three
   cuDNN convs (f32: TF32 off) and its bound, with the sums per step; and
   writes a profiler table of one clip of each path to
   `build/chip_smoke_profile.txt` and `build/chip_smoke_profile_k2.txt`.
4b. Runs the reference's released-weights flow: the seeded flagship's
   weights written as a reference `.pth` (with BatchNorm's
   `num_batches_tracked` and torchvision's unused `features.18`), `cli
   convert` to a `.ckpt` that must hold the seeded variables' bits, and
   `runners/export.py::export_serving` of it in bf16 with K2 off and on
   and in f32 (K1 and K2 are the custom ops `uavsal::twa_scan` and
   `uavsal::dwblock` in the exported graph), each saved and loaded back
   with `ExportedServing` (export and load seconds, MB) and served over 3
   carried clips of S=20, eager and graphed: launches exactly the live
   paths' (bf16 `twa_scan` 3, `dwblock` 66 with K2 on, f32 `twa_step` 60;
   graphed from the graph's own nodes, the wrappers counting none), the
   saliency and state against the live baked step (0 expected; held to
   TOL_F32 / TOL_BF16, printed), graphed equal to eager bit for bit, the
   uint8 maps through `predict_videos` the live path's. Then the
   request->response latency (`runners/latency.py`: the saliency fetched
   to the host every dispatch, the state chained) of the graphed live step
   and the graphed artifact, K2 off and on, in turns, bf16, V=1, S=20,
   200 dispatches each, as `latency_summary` percentiles, and the same
   steps' ms per clip (CUDA events, median of 7 windows, in turns).
5. Trains at full width (360x640, S=10 = batch_size 2 x time_dims 5, V=1)
   on seeded weights from `init_model`: one f32 train step on the card
   against the same step on the CPU (TF32 off); the bf16 mixed and the f32
   step with K1 (forward) and its gradient (`uavsal::twa_scan`'s registered
   autograd, backward recomputed
   through the plain scan) against the same step with `ConvTWA.scan =
   twa_scan_ref`; the launches of one train step, exactly bf16
   {twa_scan 1, twa_step 0, dwblock 0} and f32 {0, 10, 0}, with the fused
   dwBlock off and on (K2 is refused in train mode); TBPTT over 3 carried
   clips and the loss falling over 10 steps on one clip, f32 and bf16; the
   trainer's own loop (2 epochs over in-memory videos), its `_final.ckpt`
   read back through `load_model_for_inference` and served to the trained
   model's maps; then ms per train step f32 and bf16 in turns, frames/s,
   peak memory, the eval step, the TWA backward's recompute timed alone and
   a profile of one bf16 step (`build/chip_smoke_profile_train.txt`).
   Phase 4 also times K2's f32 kernel (3xTF32) at the flagship block beside
   its three cuDNN convs (TF32 off), its plain version and its bound (3xTF32,
   with the plain-FMA bound beside it).
5d. Trains the rest of the JAX package's options (360x640, seeded
   `init_model` weights, TF32 off, the trainer's masked loss): two videos
   a step (V=2, `videos_per_step`), one f32 step on the card against the
   CPU at S=5 a video (`TOL_TRAIN_*`); at S=10 a video (video 1 a padded
   ragged clip) the bf16 mixed and f32 steps with K1 against the plain
   scan, their launches exactly bf16 {1, 0, 0} and f32 {0, 10, 0}, the f32
   eval step's {0, 10, 0}; the same steps with `remat` against the plain
   ones (loss, state and BN stats within `TOL_TRAIN_K1_*`, the gradient
   within 2e-2) and their launches, exactly twice the plain step's; ms per
   step (V=1, V=2 and V=2 remat in turns, bf16 and f32), frames/s, peak
   memory (remat's at most 1.05 of the plain step's); the lock-step
   `Trainer(videos=...)` over 3 videos of 20, 10 and 15 frames for 2
   epochs, against 1 epoch and a resumed second (the files, the epoch
   means, the weights and Adam's moments within bounds stated there), its
   `_final.ckpt` served back to the trained model's maps.
5b. Trains ResNet-50 UAVSal: one f32 step on the card against the CPU at
   128x224, S=10; at 360x640, S=10, the f32 and the bf16 mixed step with
   K1's launches exact (10 and 1), the loss falling over 10 steps on one
   clip, ms per step in turns, peak memory and K1's share of a profiled
   bf16 step.
5c. Runs the reference's three-stage recipe on synthetic SALICON arrays
   at 480x640 (8 train and 4 val images, batch 2; the machine has no cv2,
   so `data/images.py`'s array entry): one f32 image train step of
   `SRFNetImage` on the card against the CPU at full size (TF32 off,
   `TOL_TRAIN_*`; the parameters after Adam within 2 lr), `train_salicon`
   over 2 epochs with its `_final.ckpt` read back, the image train step
   and `predict_images` on 8 images timed (median of 7 windows, ms and
   images/s, peak memory; one step profiled, its device time and top ops,
   `build/chip_smoke_profile_recipe.txt`), `predict_images` on the card
   against the CPU (uint8 within one level, the pixels that differ
   counted), the trained
   neck transplanted into the flagship video `Trainer` (360x640, S=10:
   the trainer's own bf16 mixed epoch of 3 steps and its f32 val clip,
   launches exactly {twa_scan 3, twa_step 10, dwblock 0}; 3 f32 steps,
   {0, 10, 0} each; the neck's parameters the image checkpoint's bits),
   and the trained video `_final.ckpt` served graphed in bf16 over 3
   carried clips of S=20 (the replays' tally {3, 0, 0}); then its wall
   time.
6. Evaluates (`evaluation/scorer.py::_score_video`, all seven metrics; no
   kernel of ours): phase 3's graphed K2-off maps (540x960, 60 frames)
   against seeded synthetic ground truth with one frame without fixations,
   on the card and on the CPU from one RandomState seed (RandomState equal
   after, six metrics within 1e-5 per frame, the jittered AUC-Judd within
   the most a tie order can move it, NaN rows in the same place), and the
   host path's AUC means within a Monte-Carlo bound; then at UAV2-TE's
   720x1280 over 300 frames of tied uint8 saliency in batches of 32:
   frames/s (median of 3 runs), the device time of one batch by part, the
   host's sampling per batch, the card's busy share under the profiler
   (`build/chip_smoke_profile_eval.txt`), peak memory, the host path's
   frames/s, and `device_dispatch_ms` with the image drivers' choice.
7. Data parallelism over videos (`parallel/`, `--dp_devices`) on the one
   card, and `planes=128`: two gloo ranks on the card (one spawn,
   `tests/_dp_runs.py::run_jobs`) serve 4 synthetic videos of 2 clips at
   360x640, bf16, graphed, K2 off and on, one video a rank a group: each
   rank's uint8 maps the bits of one process serving the video at V=1,
   CC >= 0.99 per frame against one process at V=2, K1 and K2 per rank
   from the graphs' own nodes exactly phase 3's per replay (frames/s of
   the two ranks printed, which measure no scaling: they share the card);
   the same ranks take one train step with a video each (the padded ragged
   clip of phase 5d in video 1), bf16 mixed and f32, against one process's
   V=2 step whose train-mode BatchNorms reduce the batch as the two ranks
   do (`cross_rank_batch_norm(parts=2)`, the same sums in the same order):
   f32 at `TOL_TRAIN_K1_*`, bf16 mixed at `TOL_TRAIN_BF16_*` (an H100 read
   the state's bits equal, the loss 8.1e-8 and the gradient 0.025 apart in
   bf16: each rank rounds its share of a gradient to bf16 before the
   all-reduce); f32 also against the plain one-process step at
   `TOL_TRAIN_*` (an f32 run's drift through ~100 train-mode BatchNorms).
   In bf16 the plain step is not held: a BatchNorm output one bf16 ulp
   off, which another order of the same f32 sums gives now and then, moves
   a random network's gradients and state by O(1) through the BatchNorms
   after it, so the ranks' distance from it is printed beside one
   process's own between `F.batch_norm` and the cross-rank sums over one
   part (an H100 read gradient 1.39 and 1.26, state 5.12 and 5.53);
   launches exact, the replicas' bits equal; one rank through an NCCL
   group takes the f32 step between two plain steps, deterministic
   algorithms on, and must give their bits; then UAVSal(planes=128) with seeded weights through phase
   3's `drive` in bf16 with K2 off and on and in f32 (launches exact, K1
   as served and K2 at each admitted block against their plain versions,
   graphed equal to eager, bf16 against f32 at CC >= 0.99), and K1's f32
   kernel at 1x20x45x80x128 against the plain version; the phase's seconds.
8. The spatial axis (`spatial_phase`): two gloo ranks on this card, each
   holding half of the image's rows, serve the flagship at 720x1280 over 2
   carried clips of S=20 (`make_infer_step(mesh=)`, eager), bf16 K2 off and
   on and f32, their bands put back together against one process's step:
   f32 within `TOL_F32` of the largest value, bf16 at CC >= 0.99 per frame
   (the largest uint8 difference printed); K1 once per frame per rank on
   its band with halo rows and K2 once per admitted DWBlock call, exactly;
   an f32 train step at 720x1280, S=5, on the same ranks against one
   process's at `TOL_TRAIN_*`; each rank's peak memory, the phase's
   seconds.

The line before the last is a JSON object with one entry per kernel
(`twa_scan`, `twa_step` for K1's per-frame kernel as the f32 paths launch
it, `twa_step_bf16` for it as bf16 720x1280 serving launches it, `dwblock`
for K2 in bf16 and `dwblock_f32` for K2 in f32, each with
`train_step_launches`, its launches counted in one train step of the dtype
it serves (`twa_step_bf16`: bf16 mixed at 720x1280), K2's with the fused
dwBlock on, and `config_launches`, its launches on each path of phase 3b,
3c and 5b, under `recipe` those of 5c, under `lockstep` those of 5d,
under `artifact` those of the three artifacts of 4b, under `dp` phase 7's
per rank (serving: a replay's graph nodes; training: one step), under
`planes128` phase 7's planes=128 paths per 3 clips and under `spatial`
phase 8's per rank (serving: per clip; training: one step));
the
last line is `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line is printed. Needs no network and starts no process that
outlives it.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: K2's depthwise, and each f32 bound on FMA alone
PEAK_TF32_FLOPS = 495e12  # K1's and K2's f32 routes: 3xTF32 on the tensor cores
PEAK_BYTES = 3.35e12

# K1 tolerances, max abs error against twa_scan_ref on the same inputs.
# f32: the kernel and cuDNN (TF32 off) sum 9*C products in different orders.
# bf16: the reference rounds the conv output and the gate to bf16 each step,
# the kernel keeps them in f32; the two drift apart by two bf16 ulps (0.0156)
# of values of order 1 over 20 steps.
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
# K1's persistent kernel against its per-frame bf16 kernel on the same inputs:
# both accumulate in f32 and round once per frame, at the store of h_s, so
# they differ by summation order (and the last f32 bits of the gate), which
# moves a stored value to the neighbouring bf16 now and then. |h| < 4 here,
# where one bf16 ulp is 2^-6; the card showed 2^-7.
TOL_K1_KERNELS = 2.0 ** -6
REPEATS = 20   # further runs of the persistent kernel that must give the first run's bits
CC_MIN = 0.99  # bf16 vs f32 saliency, Pearson CC per frame
# K2 tolerances, max abs error against dwblock_ref on the same inputs.
# f32: the kernel's 3xTF32 products (each within about 2^-21 of the f32
# product) and the plain version's matmuls summed in other orders (outputs
# of order 1 to 10).
# bf16: both round e, d and the output to bf16 at the same points, so they
# differ only where f32 sums that differ in their last bits round to the
# other neighbour: one bf16 ulp of the output, 2^-5 for the outputs below 8
# that these inputs give (checked).
TOL_K2_F32 = 2e-5
TOL_K2_BF16 = 2.0 ** -5
# The admitted blocks get the activations of a serving step, whose outputs
# are not all below 8: there the tolerances above scale with the largest
# output, as one bf16 ulp does (2^-8 of the power of two at or below it).
# f32 serving with K2 on against f32 serving with K2 off: saliency in [0, 1]
# after the sum-order differences of every admitted block and 20 TWA steps.
TOL_F32_PATHS = 1e-4
# gradients through the kernel forward against autograd through the plain
# version: the backward is the same recompute, fed the kernel's f32 output
TOL_GRAD = 2e-4

# training: train-mode step against the port on the CPU (f32, TF32 off), and
# K1's path against the plain scan. Each f32 run drifts from the exact answer
# through ~100 train-mode BatchNorms (tests/test_torch_train_step.py: at
# 64x128 the CPU's f32 loss 1e-5 relative from f64, its gradient 2.5-3.4%
# relative L2, up to 9.6% on a leaf, BN stats 4e-5, the state 1.6e-3); these
# bounds are those of that test. Gradients are read relative L2, each leaf's
# norm floored at 1e-4 of the whole gradient's (a BatchNorm bias before
# another BatchNorm has an exact gradient of 0, and its f32 value is noise).
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 0.1
TOL_TRAIN_GRAD_LEAF = 0.25
TOL_TRAIN_BN = 1e-4    # relative to the stat's scale (`bn_scale`)
TOL_TRAIN_STATE = 5e-3
# K1 against the plain scan in the same step on the card. f32: the two sum
# each frame's 9*C products in other orders (TOL_F32 of K1 alone) and the
# rest of the step is the same code on the same card; an H100 read the loss
# equal, the gradient 7.5e-5, the worst leaf 2.6e-3, BN stats 6.4e-8, the
# state 1.55e-5. The leaf bound holds every leaf, ConvTWA's among them.
TOL_TRAIN_K1_LOSS = 1e-6
TOL_TRAIN_K1_GRAD = TOL_GRAD
TOL_TRAIN_K1_LEAF = 1e-2
TOL_TRAIN_K1_BN = 1e-6
TOL_TRAIN_K1_STATE = 1e-4
# bf16 mixed: K1 keeps conv and gate in f32 where the plain scan rounds both
# to bf16 every frame, about two bf16 ulps of h (TOL_BF16) that the head, the
# loss and the backward carry on; an H100 read loss 6.4e-5, gradient 0.076,
# BN stats 9.9e-5, state 0.094 (values up to 8), each bound a few times that.
# A leaf is not held here: a BatchNorm bias before another BatchNorm has an
# exact gradient of 0, and in bf16 its value is noise of either step.
TOL_TRAIN_BF16_LOSS = 3e-4
TOL_TRAIN_BF16_GRAD = 0.2
TOL_TRAIN_BF16_BN = 3e-4
TOL_TRAIN_BF16_STATE = 0.3
TRAIN_S = 10        # batch_size 2 x time_dims 5, as the trainer's clips
TRAIN_REPEATS = 10  # steps on one repeated clip, over which the loss must fall
TRAIN_LR, TRAIN_WD = 1e-4, 5e-5  # the trainer's defaults

V, S, CLIPS = 1, 20, 3
# `cli test --iosize 720,1280,90,160`: UAV2 served at its native size, a
# 90x160x256 state, wider than the persistent K1 takes (phase 3c)
NATIVE_IO = (720, 1280, 90, 160)
LONG_CLIPS = 20  # the runner's steady state is timed over a video of this many clips
E2E_RUNS = 5     # end-to-end runs per path, in turns
IN_H, IN_W, OUT_H, OUT_W = 360, 640, 45, 80
NATIVE_H, NATIVE_W = 540, 960
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, windows: int = 7) -> float:
    """Milliseconds per call of fn() on the card: after one warm-up call,
    `windows` windows of `reps` calls each are timed with CUDA events, and
    the median window's mean is returned."""
    return float(np.median(cuda_windows(fn, reps, windows)))


def cuda_windows(fn, reps: int, windows: int = 7) -> list:
    """The windows of `cuda_ms`, each its mean in ms per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def random_state_dict(model, rng):
    """Seeded weights for every entry of the model's state_dict: conv
    kernels with std sqrt(1 / fan_in), which keeps activations of order 1
    and the random network from amplifying rounding (larger gains make the
    bf16 and f32 maps decorrelate), and non-trivial BatchNorm statistics."""
    import torch

    sd = {}
    for key, ref in model.state_dict().items():
        if key.endswith("running_mean"):
            a = rng.normal(0.0, 0.1, ref.shape)
        elif key.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1 and key.endswith("weight"):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1:
            a = rng.normal(0.0, 0.1, ref.shape)
        else:
            fan_in = np.prod(ref.shape[1:])  # 4-D kernels, and 5-D ones of the 3-D convs
            a = rng.normal(0.0, np.sqrt(1.0 / fan_in), ref.shape)
        sd[key] = torch.tensor(a, dtype=torch.float32)
    return sd


def synthetic_video(rng, n: int, h: int = IN_H, w: int = IN_W) -> np.ndarray:
    """(n, h, w, 3) uint8: a bright disk moving over a noisy gradient (at
    360x640 by default; scaled with h at another size)."""
    k = h / IN_H
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 0.2 / k + yy * 0.1 / k).astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        cy, cx = h / 2 + 80 * k * np.sin(t / 7.0), (60 + t * 8) * k
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2 < (40 * k) ** 2) * 180.0
        img = base[..., None] + disk[..., None] + rng.normal(0, 12, (h, w, 3))
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def k1_arrays(rng, shape):
    v, s, h, w, c = shape
    return [rng.normal(0, 0.5, shape), rng.normal(0, 0.5, shape),
            rng.normal(0, np.sqrt(2.0 / (9 * c)), (3, 3, c, c)),
            rng.normal(0, 0.5, (v, h, w, c))]


def k1_case(torch, rng, shape, dtype, arrays=None):
    return [torch.tensor(a, dtype=torch.float32).to("cuda", dtype)
            for a in arrays or k1_arrays(rng, shape)]


def check_k1(torch, kernels, twa, rng):
    """Phase 2: K1's two kernels against twa_scan_ref and each other, and
    shard invariance. Returns the flagship errors of the persistent kernel
    (bf16) and of the per-frame kernel as the main paths launch it (f32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the main generator gives the flagship and the ragged case and then goes
    # on to K2's cases and the model's weights; the other cases have their own
    flagship, ragged = (1, S, OUT_H, OUT_W, 256), (2, 3, 13, 7, 24)
    drawn = {flagship: k1_arrays(rng, flagship), ragged: k1_arrays(rng, ragged)}
    rng = np.random.default_rng(SEED + 1)

    def held(what, shape, dtype, ys, h_last, args, tol):
        ref, ref_last = twa.twa_scan_ref(*args)
        err = (ys.float() - ref.float()).abs().max().item()
        err_last = (h_last.float() - ref_last.float()).abs().max().item()
        v, s, h, w, c = shape
        name = str(dtype).replace("torch.", "")
        print(f"K1 {what} {name} V={v} S={s} {h}x{w}x{c}: max_abs_err {err:.3g} "
              f"(h_last {err_last:.3g}), tolerance {tol}")
        if not (err <= tol and err_last <= tol):
            fail(f"K1 ({what}) disagrees with twa_scan_ref in {name} at {shape}: {err}")
        return err

    def scan(args, route, frames):
        """`twa_scan` on the route its gate must pick, counted."""
        if twa.kernel_route(args[0].shape, args[0].dtype) != route:
            fail(f"K1's gate does not send {tuple(args[0].shape)} {args[0].dtype} to {route}")
        kernels.reset_launches()
        out = twa.twa_scan(*args)
        torch.cuda.synchronize()
        want = {"twa_scan": int(route == "twa_scan"),
                "twa_step": frames if route == "twa_step" else 0, "dwblock": 0}
        if kernels.launches != want:
            fail(f"K1 at {tuple(args[0].shape)}: launched {kernels.launches}, expected {want}")
        return out

    # the persistent kernel: flagship frame, V = 1, 2, 4
    errs = {}
    for v in (1, 2, 4):
        shape = (v, S, OUT_H, OUT_W, 256)
        args = k1_case(torch, rng, shape, torch.bfloat16, drawn.get(shape))
        ys, h_last = scan(args, "twa_scan", S)
        err = held("persistent", shape, torch.bfloat16, ys, h_last, args, TOL_BF16)
        step, step_last = twa._twa_scan_cuda(*args, route="twa_step")
        for run in range(REPEATS):
            again, again_last = twa.twa_scan(*args)
            if not (torch.equal(again, ys) and torch.equal(again_last, h_last)):
                fail(f"K1 (persistent) gives other bits on run {run + 2} at V={v}")
        diff = (ys.float() - step.float()).abs().max().item()
        print(f"K1 persistent vs per-frame bf16 kernel V={v}: max abs diff {diff:.3g} "
              f"({(ys != step).float().mean().item():.3%} of values differ), tolerance "
              f"{TOL_K1_KERNELS}; {REPEATS + 1} persistent runs give equal bits")
        if not diff <= TOL_K1_KERNELS:
            fail(f"K1's two bf16 kernels disagree at V={v}: {diff}")
        if v == 1:
            errs["twa_scan"] = err
            held("per-frame", shape, torch.bfloat16, step, step_last, args, TOL_BF16)
    # the per-frame kernel: f32 at the flagship shape, the ragged shape in both
    for shape, dtype, tol in [(flagship, torch.float32, TOL_F32), (ragged, torch.float32, TOL_F32),
                              (ragged, torch.bfloat16, TOL_BF16)]:
        args = k1_case(torch, rng, shape, dtype, drawn[shape])
        ys, h_last = scan(args, "twa_step", shape[1])
        err = held("per-frame", shape, dtype, ys, h_last, args, tol)
        if (shape, dtype) == (flagship, torch.float32):
            errs["twa_step"] = err
            for run in range(REPEATS):
                again, again_last = twa.twa_scan(*args)
                if not (torch.equal(again, ys) and torch.equal(again_last, h_last)):
                    fail(f"K1 (per-frame, f32) gives other bits on run {run + 2}")
            print(f"K1 per-frame f32: {REPEATS + 1} runs give equal bits")
    # shard invariance: whole V against the two halves, bit for bit
    for hwc in ((13, 7, 24), (OUT_H, OUT_W, 256)):
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            shape = (4, 3, *hwc)
            x, gx, w_h, h0 = k1_case(torch, rng, shape, dtype)
            ys, h_last = twa.twa_scan(x, gx, w_h, h0)
            halves = [twa.twa_scan(x[i:i + 2].contiguous(), gx[i:i + 2].contiguous(), w_h,
                                   h0[i:i + 2].contiguous()) for i in (0, 2)]
            torch.cuda.synchronize()
            route = twa.kernel_route(shape, dtype)
            held(f"whole V ({route})", shape, dtype, ys, h_last, (x, gx, w_h, h0), tol)
            if not (torch.equal(torch.cat([p[0] for p in halves]), ys)
                    and torch.equal(torch.cat([p[1] for p in halves]), h_last)):
                fail(f"K1 ({route}) on x[:2], x[2:] gives other bits than on x at {shape} {dtype}")
            print(f"K1 {route} V=4 equals V=2 + V=2 bit for bit at {shape} "
                  f"{str(dtype).replace('torch.', '')}")
    errs["twa_step_bf16"] = check_k1_bf16_step(torch, kernels, twa, rng, drawn, held)
    return errs


def check_k1_bf16_step(torch, kernels, twa, rng, drawn, held):
    """Phase 2: K1's bf16 per-frame kernel (`wgmma`), forced onto it where the
    persistent kernel takes the shape: the flagship frame at V = 1 and 4,
    720x1280 serving's 90x160 state and the ragged 13x7x24, against the
    plain version (`TOL_BF16`) and, where it takes the shape, the persistent
    kernel (`TOL_K1_KERNELS`); the same bits on 20 more runs; V = 4 against
    V = 2 + V = 2 bit for bit at the flagship width and at 90x160; the pack's
    layout constants against the source's. Returns the error at 90x160."""
    values = [ctypes.c_int() for _ in range(3)]
    twa._lib().twa_bf16_layout(*[ctypes.byref(v) for v in values])
    layout = [v.value for v in values]
    if layout != [twa.BF16_CHUNK, twa.BF16_COLUMNS, twa.BF16_PLANE]:
        fail(f"the bf16 pack's layout constants are not the kernel's: {layout}")
    flagship, ragged = (1, S, OUT_H, OUT_W, 256), (2, 3, 13, 7, 24)
    err = None
    for shape in (flagship, (4, S, OUT_H, OUT_W, 256), (1, S, *NATIVE_IO[2:], 256), ragged):
        args = k1_case(torch, rng, shape, torch.bfloat16, drawn.get(shape))
        kernels.reset_launches()
        ys, h_last = twa._twa_scan_cuda(*args, route="twa_step")
        torch.cuda.synchronize()
        want = {"twa_scan": 0, "twa_step": shape[1], "dwblock": 0}
        if kernels.launches != want:
            fail(f"K1 per-frame bf16 at {shape}: launched {kernels.launches}, expected {want}")
        e = held("per-frame (wgmma)", shape, torch.bfloat16, ys, h_last, args, TOL_BF16)
        if shape[2:4] == NATIVE_IO[2:]:
            err = e
        for run in range(REPEATS):
            again, again_last = twa._twa_scan_cuda(*args, route="twa_step")
            if not (torch.equal(again, ys) and torch.equal(again_last, h_last)):
                fail(f"K1 (per-frame, bf16) gives other bits on run {run + 2} at {shape}")
        line = f"K1 per-frame bf16 at {shape}: {REPEATS + 1} runs give equal bits"
        if twa.clip_takes(shape[3], shape[4]):
            clip, _ = twa._twa_scan_cuda(*args, route="twa_scan")
            diff = (ys.float() - clip.float()).abs().max().item()
            line += (f"; vs the persistent kernel max abs diff {diff:.3g} "
                     f"({(ys != clip).float().mean().item():.3%} of values differ), tolerance "
                     f"{TOL_K1_KERNELS}")
            if not diff <= TOL_K1_KERNELS:
                fail(f"K1's two bf16 kernels disagree at {shape}: {diff}")
        print(line)
    for hw in ((OUT_H, OUT_W), NATIVE_IO[2:]):
        shape = (4, 3, *hw, 256)
        x, gx, w_h, h0 = k1_case(torch, rng, shape, torch.bfloat16)
        ys, h_last = twa._twa_scan_cuda(x, gx, w_h, h0, route="twa_step")
        halves = [twa._twa_scan_cuda(x[i:i + 2].contiguous(), gx[i:i + 2].contiguous(), w_h,
                                     h0[i:i + 2].contiguous(), route="twa_step") for i in (0, 2)]
        torch.cuda.synchronize()
        held("per-frame (wgmma), whole V", shape, torch.bfloat16, ys, h_last, (x, gx, w_h, h0),
             TOL_BF16)
        if not (torch.equal(torch.cat([p[0] for p in halves]), ys)
                and torch.equal(torch.cat([p[1] for p in halves]), h_last)):
            fail(f"K1 (per-frame, bf16) on x[:2], x[2:] gives other bits than on x at {shape}")
        print(f"K1 per-frame bf16 V=4 equals V=2 + V=2 bit for bit at {shape}")
    return err


def dw_case(rng, n, h, w, c, e, co):
    """Folded-block inputs (x, W1, b1, Wd, bd, W2, b2) whose e, d and output
    are all of order 1."""
    return [rng.normal(0, 0.5, (n, h, w, c)), rng.normal(0, np.sqrt(2.0 / c), (c, e)),
            rng.normal(0, 0.5, (e,)), rng.normal(0, 0.3, (3, 3, e)), rng.normal(0, 0.5, (e,)),
            rng.normal(0, np.sqrt(1.0 / e), (e, co)), rng.normal(0, 0.5, (co,))]


K2_FLAGSHIP = (V * S, OUT_H, OUT_W, 256, 1536, 256)


def check_k2(torch, dwblock, rng):
    """Phase 2: K2 against dwblock_ref. Returns the flagship errors by dtype."""
    flagship_err = {}
    for shape, residual in [(K2_FLAGSHIP, True), ((V * S, OUT_H, OUT_W, 320, 1920, 256), False),
                            ((2, 13, 7, 24, 144, 16), False)]:
        arrays = dw_case(rng, *shape)
        for dtype, tol in ((torch.float32, TOL_K2_F32), (torch.bfloat16, TOL_K2_BF16)):
            args = [torch.tensor(a, dtype=torch.float32).to("cuda", dtype) for a in arrays]
            out = dwblock.fused_dwblock_kernel(*args, residual)
            torch.cuda.synchronize()
            ref = dwblock.dwblock_ref(*args, residual)
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            name = str(dtype).replace("torch.", "")
            print(f"K2 {name} N,H,W,C,E,Co={shape} residual={residual}: max_abs_err {err:.3g}, "
                  f"max |ref| {top:.3g}, tolerance {tol}")
            if out.shape != ref.shape or not err <= tol or not top < 8:
                fail(f"K2 disagrees with dwblock_ref in {name} at {shape}: {err}")
            if shape == K2_FLAGSHIP:
                flagship_err[dtype] = err
    return flagship_err


def check_k2_admitted(torch, dwblock, DWBlock, model, step, clip, state):
    """K2 against dwblock_ref at every shape the main path gives it: one
    serving step with a hook on each DWBlock keeps the input of every block
    the gate admits; K2 and the plain version then run on that input and the
    block's own weights as `DWBlock.pack` made them (for bf16 the packed
    layout too). Returns the admitted (name, shape) list and, per block,
    (name, module, input)."""
    taken = []
    hooks = [m.register_forward_pre_hook(
        lambda m, inp, name=name: taken.append((name, m, inp[0].clone()))
        if m.takes_kernel(inp[0].shape, inp[0].dtype) else None)
        for name, m in model.named_modules() if isinstance(m, DWBlock)]
    step(clip, state)
    for hook in hooks:
        hook.remove()
    if not taken:
        fail("the gate admits no DWBlock of the model")
    worst = 0.0
    for name, m, x in taken:
        weights, blobs = m.kernel_weights(x.dtype)
        if x.dtype == torch.bfloat16 and blobs is None:
            fail(f"{name}: the served bf16 block has no packed weights")
        args = (x.permute(0, 2, 3, 1), *weights, m.use_res)
        out = dwblock.fused_dwblock_kernel(*args, blobs)
        torch.cuda.synchronize()
        ref = dwblock.dwblock_ref(*args)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        scale = max(1.0, 2.0 ** np.floor(np.log2(max(top, 1e-30))) / 4)  # 1 below 8
        tol = (TOL_K2_BF16 if x.dtype == torch.bfloat16 else TOL_K2_F32) * scale
        n, c, h, w = x.shape
        print(f"  {name} N,H,W,C,E,Co={(n, h, w, c, args[1].shape[1], out.shape[3])} "
              f"residual={m.use_res}: max_abs_err {err:.3g}, max |ref| {top:.3g}, "
              f"tolerance {tol:.3g}")
        if out.shape != ref.shape or not torch.isfinite(out).all() or not err <= tol:
            fail(f"K2 disagrees with dwblock_ref in {name} ({x.dtype}) at {tuple(x.shape)}: {err}")
        worst = max(worst, err / tol)
    print(f"K2 holds dwblock_ref at all {len(taken)} admitted blocks of {len(hooks)} DWBlocks "
          f"in {str(x.dtype).replace('torch.', '')}; largest error {worst:.3g} of its tolerance")
    return [(name, tuple(x.shape)) for name, _, x in taken], taken


def k2_bound(n, h, w, c, e, co, route="bf16"):
    """(ms, bound_by) the card needs at least for one block: x, the weights
    and the output moved once, or the three convs' operations at the rate of
    `route`: "bf16" all at the bf16 tensor-core peak; "3xtf32" (the f32
    kernel) the two GEMMs three times at the TF32 peak and the depthwise at
    the FMA peak; "fma" all at the FMA peak (f32 without the tensor cores)."""
    gemm, depthwise = 2.0 * n * h * w * (c * e + e * co), 2.0 * n * h * w * 9 * e
    if route == "bf16":
        flops_s = (gemm + depthwise) / PEAK_BF16_FLOPS
    elif route == "3xtf32":
        flops_s = 3 * gemm / PEAK_TF32_FLOPS + depthwise / PEAK_F32_FLOPS
    else:
        flops_s = (gemm + depthwise) / PEAK_F32_FLOPS
    itemsize = 2 if route == "bf16" else 4
    bytes_moved = (n * h * w * (c + co) + c * e + 11 * e + e * co + co) * itemsize
    flops_ms, bytes_ms = flops_s * 1e3, bytes_moved / PEAK_BYTES * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes"


def graph_ms(torch, fn, reps: int = 10) -> float:
    """Device milliseconds per call of fn() with the host's issue time taken
    out: fn is captured once in a CUDA graph, after three warm-up calls on a
    side stream (cuDNN's autotuning included), and the graph's replays are
    timed as in `cuda_ms`."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernel's launcher sets its shared-memory attribute on every call
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, reps)


def time_k2_admitted(torch, dwblock, taken):
    """K2 at each admitted block of one path (bf16 or f32, the dtype of the
    inputs in `taken`), on that block's own input and packed weights, beside
    the same block as its three cuDNN convs (the module with the kernel off,
    as the K2-off path serves it: conv, bias, ReLU6, residual;
    `cudnn.benchmark` on; in f32 with TF32 off, as phase 3 leaves it) and its
    bound (f32: 3xTF32); device us per launch, each captured in a CUDA graph
    so that the host's issue time of a small block does not stand in for the
    card's; one line per block, then the sums per serving step. Returns the
    sums (kernel, convs, bound) in ms."""
    torch.backends.cudnn.benchmark = True
    sums = np.zeros(3)
    dtype = "bf16" if taken[0][2].dtype == torch.bfloat16 else "f32"
    route = "bf16" if dtype == "bf16" else "3xtf32"
    print(f"K2 {dtype} per admitted block (device us per launch, CUDA graphs): kernel, three "
          f"cuDNN convs, bound ({route})")
    for name, m, x in taken:
        weights, blobs = m.kernel_weights(x.dtype)
        xn = x.permute(0, 2, 3, 1)
        kernel_ms = graph_ms(torch, lambda: dwblock.fused_dwblock_kernel(xn, *weights, m.use_res,
                                                                          blobs))
        m.use_kernel = False
        try:
            with torch.no_grad():
                convs_ms = graph_ms(torch, lambda: m(x))
        finally:
            m.use_kernel = True
        n, c, h, w = x.shape
        e, co = weights[0].shape[1], weights[4].shape[1]
        bound_ms, bound_by = k2_bound(n, h, w, c, e, co, route)
        sums += (kernel_ms, convs_ms, bound_ms)
        print(f"  {name} N,H,W,C,E,Co={(n, h, w, c, e, co)}: kernel {kernel_ms * 1e3:.2f}, "
              f"convs {convs_ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} ({bound_by}); "
              f"kernel/convs {kernel_ms / convs_ms:.3f}, kernel/bound {kernel_ms / bound_ms:.2f}")
    torch.backends.cudnn.benchmark = False
    print(f"K2 {dtype} over the {len(taken)} admitted blocks: kernel {sums[0] * 1e3:.2f} us, "
          f"convs {sums[1] * 1e3:.2f} us, bound {sums[2] * 1e3:.2f} us per step; "
          f"kernel/convs {sums[0] / sums[1]:.3f}")
    return sums


def check_gradients(torch, kernels, dwblock, twa, rng):
    """Phase 2: the gradient wrappers with the kernel forward, f32, against
    autograd through the plain versions, for a sum of squares."""
    def grads(fn, arrays):
        args = [torch.tensor(a, dtype=torch.float32, device="cuda").requires_grad_()
                for a in arrays]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o ** 2).sum() for o in outs).backward()
        return [a.grad for a in args]

    dw = dw_case(rng, 2, 6, 9, 16, 96, 16)
    tw = [rng.normal(0, 0.5, (2, 3, 6, 5, 8)), rng.normal(0, 0.5, (2, 3, 6, 5, 8)),
          rng.normal(0, 0.15, (3, 3, 8, 8)), rng.normal(0, 0.5, (2, 6, 5, 8))]
    kernels.reset_launches()
    pairs = {"fused_dwblock": (grads(lambda *a: dwblock.fused_dwblock(*a, True), dw),
                               grads(lambda *a: dwblock.dwblock_ref(*a, True), dw)),
             "twa_scan": (grads(twa.twa_scan, tw), grads(twa.twa_scan_ref, tw))}
    if kernels.launches != {"twa_scan": 0, "twa_step": 3, "dwblock": 1}:  # f32: per frame
        fail(f"the gradient phase launched {kernels.launches}")
    for name, (got, want) in pairs.items():
        err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
                  for g, w in zip(got, want))
        print(f"gradients of {name} (kernel forward, f32) vs autograd through the plain "
              f"version, {len(got)} arguments: max error {err:.3g} of the largest entry, "
              f"tolerance {TOL_GRAD}")
        if not err <= TOL_GRAD:
            fail(f"gradients of {name} disagree with the plain version: {err}")


def time_k2(torch, F, dwblock, rng, dtype=None):
    """K2 time per launch at the flagship shape (20x45x80, C=256, E=1536,
    residual), bf16 (`dtype` None) or f32, beside its plain version, the
    library yardstick (the folded block as three cuDNN convs with bias and
    ReLU6, `cudnn.benchmark` on; TF32 off, as phase 3 leaves it) and the
    bound (f32: 3xTF32, the kernel's route; the FMA bound is printed
    beside it). All in ms per launch."""
    dtype = dtype or torch.bfloat16
    n, h, w, c, e, co = K2_FLAGSHIP
    args = [torch.tensor(a, dtype=torch.float32).to("cuda", dtype)
            for a in dw_case(rng, *K2_FLAGSHIP)]
    x, w1, b1, wd, bd, w2, b2 = args
    blobs = dwblock.pack_dwblock_weights(w1, b1, wd, bd, w2)  # packed once, as served
    kernel_ms = cuda_ms(lambda: dwblock.fused_dwblock_kernel(*args, True, blobs), 10)
    plain_ms = cuda_ms(lambda: dwblock.dwblock_ref(*args, True), 3)

    cl = torch.channels_last
    xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    w1c = w1.t().reshape(e, c, 1, 1).contiguous(memory_format=cl)
    wdc = wd.permute(2, 0, 1).reshape(e, 1, 3, 3).contiguous()
    w2c = w2.t().reshape(co, e, 1, 1).contiguous(memory_format=cl)

    def library_block():
        y = F.relu6(F.conv2d(xn, w1c, b1))
        y = F.relu6(F.conv2d(y, wdc, bd, padding=1, groups=e))
        return F.conv2d(y, w2c, b2) + xn

    torch.backends.cudnn.benchmark = True
    library_ms = cuda_ms(library_block, 10)
    torch.backends.cudnn.benchmark = False
    bound_ms, bound_by = k2_bound(n, h, w, c, e, co,
                                  "bf16" if dtype == torch.bfloat16 else "3xtf32")
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


def frame_cc(torch, a, b):
    """Pearson CC per frame between two (T, H, W) stacks of maps."""
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
    return (a * b).sum(dim=(1, 2)) / (a.norm(dim=(1, 2)) * b.norm(dim=(1, 2)))


def k1_library(torch, F, x, gx, w_h, h0):
    """K1's library yardstick on these inputs: per frame one cuDNN conv in
    channels-last memory, a sigmoid and a lerp."""
    w_oihw = w_h.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xs, gxs = x.permute(1, 0, 4, 2, 3), gx.permute(1, 0, 4, 2, 3)  # channels-last views
    hp = h0.permute(0, 3, 1, 2)

    def library_frames():
        hh = hp
        for t in range(x.shape[1]):
            g = torch.sigmoid(gxs[t] + F.conv2d(hh, w_oihw, padding=1))
            hh = torch.lerp(hh, xs[t], g)

    return library_frames


def k1_bound(shape, itemsize, peak_flops):
    """(ms, bound_by) the card needs at least for a scan of this shape: x, gx,
    h_{s-1} and h_s of every frame and W_h once, or 9*C*C FMA per pixel."""
    v, s, h, w, c = shape
    flops_ms = 2.0 * s * v * h * w * 9 * c * c / peak_flops * 1e3
    bytes_ms = (4.0 * s * v * h * w * c + 9 * c * c) * itemsize / PEAK_BYTES * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes"


def k1_vjp_bound(shape, itemsize, peak_flops):
    """(ms, bound_by) the card needs at least for K1's backward as the port
    runs it (the recompute through the plain scan, then autograd's
    gradients of x, gx and W_h): per frame the recompute's 3x3 conv of
    h_{s-1}, the conv that takes the gradient back to h_{s-1} and the one
    that forms W_h's, 3 times the forward's 2*9*C*C flops per pixel; x, gx
    and the gradient of ys read once, h0 and W_h once, the gradients of x
    and gx and of W_h written once."""
    v, s, h, w, c = shape
    flops_ms = 3 * 2.0 * s * v * h * w * 9 * c * c / peak_flops * 1e3
    bytes_ms = (5.0 * s * v * h * w * c + v * h * w * c + 2 * 9 * c * c) * itemsize \
        / PEAK_BYTES * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes"


def time_k1(torch, F, twa, rng, v, hw=(OUT_H, OUT_W)):
    """K1 at V x 20 x H x W x 256 in bf16 (45x80 by default): the per-frame
    kernel (W_h packed once, as served), the persistent kernel where its gate
    takes the shape, and the library yardstick (one cuDNN conv + sigmoid +
    lerp per frame, `cudnn.benchmark` on, autotuned in the warm-up call),
    timed in turns (per-frame, persistent, library, library, persistent,
    per-frame), 7 windows of 10 clips a turn; then the plain version and the
    bound. Returns ms per clip: {name: (median, fastest window)} over a
    name's 14 windows, and the bound."""
    s, (h, w), c = S, hw, 256
    x, gx, w_h, h0 = k1_case(torch, rng, (v, s, h, w, c), torch.bfloat16)
    packed = twa.pack_twa_weights_bf16(w_h)
    calls = {"per-frame": lambda: twa._twa_scan_cuda(x, gx, w_h, h0, route="twa_step",
                                                     packed=packed),
             "library": k1_library(torch, F, x, gx, w_h, h0)}
    if twa.clip_takes(w, c):
        calls["persistent"] = lambda: twa.twa_scan(x, gx, w_h, h0)
    windows = {name: [] for name in calls}
    torch.backends.cudnn.benchmark = True
    for name in ("per-frame", "persistent", "library", "library", "persistent", "per-frame"):
        if name not in calls:
            continue
        turn = cuda_windows(calls[name], 10)
        windows[name] += turn
        print(f"K1 V={v} {h}x{w} {name}: median {np.median(turn) / s * 1e3:.2f} us/frame, "
              f"fastest window {min(turn) / s * 1e3:.2f}")
    torch.backends.cudnn.benchmark = False
    times = {name: (float(np.median(ws)), min(ws)) for name, ws in windows.items()}
    times["plain"] = (cuda_ms(lambda: twa.twa_scan_ref(x, gx, w_h, h0), 3), None)
    bound_ms, bound_by = k1_bound(x.shape, 2, PEAK_BF16_FLOPS)  # per clip
    for name, (med, fastest) in times.items():
        best = "" if fastest is None else f", fastest window {fastest / s * 1e3:.2f}"
        print(f"K1 bf16 at {v}x{s}x{h}x{w}x{c}, {name}: {med / s * 1e3:.2f} us/frame{best}")
    print(f"K1 bf16 at {v}x{s}x{h}x{w}x{c}, bound: {bound_ms / s * 1e3:.2f} us/frame ({bound_by})")
    return times, bound_ms, bound_by


def time_k1_f32(torch, F, twa, rng):
    """The per-frame kernel as the f32 main paths launch it, 1 x 45 x 80 x 256
    in f32 (3xTF32 on the tensor cores), 20 launches a clip: beside its
    library yardstick (one cuDNN conv, TF32 off, + sigmoid + lerp per frame),
    in turns (kernel, library, library, kernel), then the plain version and
    the bound: 3xTF32 at the TF32 peak, with the bound on FMA alone beside
    it. Returns ms per launch."""
    s, h, w, c = S, OUT_H, OUT_W, 256
    x, gx, w_h, h0 = k1_case(torch, rng, (1, s, h, w, c), torch.float32)
    if twa.kernel_route(x.shape, x.dtype) != "twa_step":
        fail("K1's gate does not send f32 to the per-frame kernel")
    calls = {"kernel": lambda: twa.twa_scan(x, gx, w_h, h0),
             "library": k1_library(torch, F, x, gx, w_h, h0)}
    windows = {name: [] for name in calls}
    torch.backends.cudnn.benchmark = True
    for name in ("kernel", "library", "library", "kernel"):
        windows[name] += cuda_windows(calls[name], 5)
    torch.backends.cudnn.benchmark = False
    out = {name: float(np.median(ws)) / s for name, ws in windows.items()}
    out["plain"] = cuda_ms(lambda: twa.twa_scan_ref(x, gx, w_h, h0), 3) / s
    out["bound"], out["bound_by"] = k1_bound((1, 1, h, w, c), 4, PEAK_TF32_FLOPS / 3)
    out["bound_fma"] = k1_bound((1, 1, h, w, c), 4, PEAK_F32_FLOPS)[0]
    print(f"K1 per-frame kernel, f32 at 1x{s}x{h}x{w}x{c}: {out['kernel'] * 1e3:.2f} us/frame "
          f"(fastest window {min(windows['kernel']) / s * 1e3:.2f}), library "
          f"{out['library'] * 1e3:.2f} (fastest {min(windows['library']) / s * 1e3:.2f}), plain "
          f"{out['plain'] * 1e3:.2f}, bound {out['bound'] * 1e3:.2f} ({out['bound_by']}, 3xTF32 "
          f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; {out['bound_fma'] * 1e3:.2f} on FMA at "
          f"{PEAK_F32_FLOPS / 1e12:.0f}); kernel/library {out['kernel'] / out['library']:.3f}")
    return out


def check_k1_served(torch, twa, name, taken):
    """K1 where it is served: `taken` holds, per clip of a bf16 main path,
    the arguments `twa_scan` was called with and what it returned. The
    served output must be the bits the kernel of its route gives on those
    inputs alone (the per-frame kernel: from W_h packed here, not the pack
    ConvTWA made at load), and hold the plain version computed in f32 on
    the same bf16 inputs within `TOL_BF16`, which is for values below 2 and
    grows as a bf16 ulp does. On the persistent route it must also agree
    with the per-frame kernel within one bf16 ulp of the largest value
    (`TOL_K1_KERNELS` below 4); the persistent kernel does not take the
    per-frame route's shapes. The plain version in bf16, which rounds conv
    and gate every frame, is read against the same f32 result beside it."""
    for k, ((x, gx, w_h, h0), (ys, h_last)) in enumerate(taken):
        args = (x, gx, w_h.to(x.dtype), h0.to(x.dtype))
        route = twa.kernel_route(x.shape, x.dtype)
        alone, alone_last = twa._twa_scan_cuda(*args, route=route)
        exact = twa.twa_scan_ref(*(a.float() for a in args))[0]
        plain_err = (twa.twa_scan_ref(*args)[0].float() - exact).abs().max().item()
        torch.cuda.synchronize()
        top = exact.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
        tol_exact, tol_step = TOL_BF16 * max(1.0, ulp * 2 ** 7), max(TOL_K1_KERNELS, ulp)
        err = (ys.float() - exact).abs().max().item()
        diff = 0.0
        if route == "twa_scan":
            step, _ = twa._twa_scan_cuda(*args, route="twa_step")
            diff = (ys.float() - step.float()).abs().max().item()
        same = torch.equal(alone, ys) and torch.equal(alone_last, h_last)
        print(f"K1 as served ({route}), {name}, clip {k}: max |h| {top:.3g}; vs the plain "
              f"version in f32 {err:.3g} (tolerance {tol_exact:.3g}; the plain version in bf16 "
              f"{plain_err:.3g})"
              + (f", vs per-frame kernel {diff:.3g} (tolerance {tol_step:.3g})"
                 if route == "twa_scan" else "") + f", equal bits alone: {same}")
        if not same:
            fail(f"{name} clip {k}: K1's served output is not what it gives on the same inputs")
        if not (err <= tol_exact and diff <= tol_step):
            fail(f"{name} clip {k}: K1's served output disagrees: {err} vs the plain version "
                 f"in f32, {diff} vs the per-frame kernel")


# ---------------------------------------------------------------------------
# 3b. The other configurations at full width (360x640)

# served as phase 3 serves the flagship, every check of it: (cnn_type,
# num_stblock, bias_type)
FULL_CONFIGS = {"ResNet-50": ("resnet50", 2, (1, 1, 1)), "VGG16": ("vgg16", 2, (1, 1, 1))}
# served one eager bf16 clip each
CLIP_CONFIGS = {"ResNet-18": ("resnet18", 2, (1, 1, 1)), "ResNet-34": ("resnet34", 2, (1, 1, 1)),
                "ResNet-101": ("resnet101", 2, (1, 1, 1)),
                "ResNet-152": ("resnet152", 2, (1, 1, 1)),
                "MobileNetV2, bias_type (1, 0, 1)": ("mobilenet_v2", 2, (1, 0, 1)),
                "MobileNetV2, bias_type (0, 0, 0)": ("mobilenet_v2", 2, (0, 0, 0))}
# f32 serving on the card (cuDNN with TF32 off, K1 as 3xTF32) against the
# port on the CPU, one clip from a zero state: the same f32 math summed in
# other orders through some 60 to 100 layers; saliency absolute, state
# relative to its largest value. Each bound lies between the sound run's
# readings and the controls' (TF32 let into the f32 path: cuDNN's convs, or
# K1's scan alone), which the phase reads and holds above it. On an H100
# (ResNet-50, VGG16): sound 4.17e-7 and 5.96e-7 (saliency), 2.47e-6 and
# 2.38e-6 (state); K1's scan at TF32 4.32e-6 and 4.14e-6, 2.62e-5 and
# 3.66e-5; cuDNN at TF32 2.1e-4 to 2.5e-4, 1.25e-3 to 1.29e-3. Each bound is
# near the geometric mean of the largest sound reading and the smallest
# control's.
TOL_SERVE_CPU = 1.5e-6
TOL_SERVE_CPU_STATE = 8e-6
# ResNet-50's f32 train step, the card against the CPU, at a reduced
# 128x224 (the CPU's step at 360x640 would take minutes). On the CPU the f32
# step lies from the f64 step (the exact answer) at: loss 2.1e-5, gradient
# 0.063, worst leaf 0.078, BN stats 7.5e-5, state 3.8e-3 (about twice the
# flagship's drift: some 150 train-mode BatchNorms against 100); the card's
# f32 step lies as far on another side, so each bound is 2.5 to 5 times that.
TRAIN_SMALL_H, TRAIN_SMALL_W = 128, 224
TOL_R50_TRAIN_LOSS = 1e-4
TOL_R50_TRAIN_GRAD = 0.2
TOL_R50_TRAIN_GRAD_LEAF = 0.4
TOL_R50_TRAIN_BN = 3e-4
TOL_R50_TRAIN_STATE = 1.5e-2
CONFIG_TRAIN_STEPS = 10  # steps on one repeated clip, over which the loss must fall


def config_kwargs(cfg):
    cnn_type, num_stblock, bias_type = cfg
    return {"cnn_type": cnn_type, "num_stblock": num_stblock, "bias_type": bias_type}


def config_variables(cfg, seed):
    """Seeded weights of the configuration's UAVSal as a JAX-layout tree,
    and their sum |w|: `random_state_dict` from a generator of its own,
    with VGG16's backbone kernels sqrt(2) times larger, since its convs are
    followed by a ReLU and no BatchNorm, and at std sqrt(1 / fan_in) each
    of its 13 ReLUs halves the signal (the maps then flatten and bf16
    against f32 fell to CC 0.991 at 128x256 on the CPU; 0.998 with the
    factor)."""
    from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal

    model = UAVSal(**config_kwargs(cfg))
    sd = random_state_dict(model, np.random.default_rng(seed))
    if cfg[0] == "vgg16":
        for key, t in sd.items():
            if key.startswith("sfnet.features.") and t.dim() == 4:
                t.mul_(np.sqrt(2.0))
    checksum = sum(t.double().abs().sum().item() for t in sd.values())
    return to_jax_variables(sd, table_of(model)), checksum


def tf32_controls(torch, step, clip):
    """The f32 served `step` on `clip` from a zero state with TF32 let into
    the f32 path, as controls for the card-vs-CPU bounds: {what: (saliency,
    state)} with cuDNN's convs at TF32 (K1 stays 3xTF32), and with K1's scan
    replaced by its plain version whose convs run at TF32 (the rest stays
    f32)."""
    from iip_uavsal_saliency_tpu_torch.models import recurrent
    from iip_uavsal_saliency_tpu_torch.ops import twa

    def tf32_scan(x, gx, w_h, h0, packed=None):
        torch.backends.cudnn.allow_tf32 = True
        try:
            return twa.twa_scan_ref(x, gx, w_h, h0)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    zero = torch.zeros((V, OUT_H, OUT_W, 256), device="cuda")
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["cuDNN's convs at TF32"] = step(clip, zero)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    recurrent.twa_scan = tf32_scan
    try:
        out["K1 as a plain scan at TF32"] = step(clip, zero)
    finally:
        recurrent.twa_scan = twa.twa_scan
    torch.cuda.synchronize()
    return out


def configs_phase(torch, kernels, dwblock, DWBlock, serve, drive, compare, video, native,
                  first_clip, flagship):
    """3b. The other configurations at 360x640 on seeded weights (numpy ->
    JAX-layout tree -> `load_model_for_inference` with the configuration).
    ResNet-50 and VGG16 go through phase 3's checks (`drive`): 3 carried
    clips of S=20, eager and graphed, K1's launches exact (bf16 the
    persistent kernel once per clip, f32 the per-frame kernel once per
    frame) and for ResNet-50 with K2 on once per admitted block and clip,
    graphed equal to eager bit for bit, the bf16 maps against the f32 run
    (CC per frame); then the card's f32 clip against the port on the CPU.
    Their graphed bf16 steps and the pipelined runner over `LONG_CLIPS`
    clips are timed in turns with the flagship's (`flagship` = its graphed
    step and model), and one step of each is profiled. The other
    configurations serve one eager bf16 clip each: K1's count, finite
    output in [0, 1], a new state. Returns each configuration's launches."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.runners.infer import (load_model_for_inference,
                                                             predict_videos)
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step

    results, timed, profiles = {}, {"flagship (MobileNetV2)": flagship}, {}
    zero16 = torch.zeros((V, OUT_H, OUT_W, 256), dtype=torch.bfloat16, device="cuda")
    gauss = get_gauss_priors(OUT_H, OUT_W, 8)
    for k, (name, cfg) in enumerate(FULL_CONFIGS.items()):
        tree, checksum = config_variables(cfg, SEED + 20 + k)
        config = config_kwargs(cfg)
        print(f"{name} ({config}): seeded weights, sum |w| {checksum:.6f}")
        launches = {}
        m16, s16, spy16, seen16 = serve(torch.bfloat16, False, tree, config)
        launches["bf16"], g16, sal16, _ = drive(f"{name}, K2 off (bf16)", m16, s16, spy16,
                                                seen16, True, 0)
        sal16k = None
        if cfg[0] == "resnet50":
            m16k, s16k, spy16k, seen16k = serve(torch.bfloat16, True, tree, config)
            print(f"K2 bf16 at the admitted blocks of one {name} serving step:")
            admitted, _ = check_k2_admitted(torch, dwblock, DWBlock, m16k, s16k, first_clip,
                                            zero16)
            if any(n.startswith(("sfnet.features.", "sfnet.lv5_aspp")) for n, _ in admitted):
                fail(f"{name}: K2's gate admits a block it must refuse (C <= 352): {admitted}")
            launches["bf16, K2 on"], _, sal16k, _ = drive(
                f"{name}, K2 on (bf16)", m16k, s16k, spy16k, seen16k, True,
                len(admitted) * CLIPS)
            del m16k, s16k, spy16k, seen16k
        m32, s32, spy32, seen32 = serve(None, False, tree, config)
        launches["f32"], g32, sal32, _ = drive(f"{name}, K2 off (f32)", m32, s32, spy32, seen32,
                                               False, 0)
        print(f"{name}: f32 map mean {sal32.mean().item():.4g} std {sal32.std().item():.4g}")
        compare(f"{name}: bf16 vs f32 saliency", sal16, sal32)
        if sal16k is not None:
            compare(f"{name}: bf16 K2 on vs f32 saliency", sal16k, sal32)
        # the card's f32 clip against the port on the CPU
        cpu_model = load_model_for_inference(tree, fold_bn=True, device="cpu", **config)
        cpu_step = make_baked_infer_step(cpu_model, gauss, flagship[2])
        t0 = time.perf_counter()
        out_c, st_c = cpu_step(first_clip.cpu(), cpu_model.init_state(IN_H, IN_W, V))
        cpu_s = time.perf_counter() - t0

        def from_cpu(out_g, st_g):
            return ((out_c - out_g.cpu()).abs().max().item(),
                    (st_c - st_g.cpu()).abs().max().item() / st_c.abs().max().item())

        out_g, _, st_g = seen32[0]
        d_sal, d_st = from_cpu(out_g, st_g)
        print(f"{name}: f32 clip on the card against the CPU ({cpu_s:.1f} s there): saliency "
              f"max abs diff {d_sal:.3g} (tolerance {TOL_SERVE_CPU}), state {d_st:.3g} of its "
              f"largest value {st_c.abs().max().item():.3g} (tolerance {TOL_SERVE_CPU_STATE})")
        if not (d_sal <= TOL_SERVE_CPU and d_st <= TOL_SERVE_CPU_STATE):
            fail(f"{name}: the card's f32 clip disagrees with the CPU's")
        for control, (sal_c, state_c) in tf32_controls(torch, s32, first_clip).items():
            c_sal, c_st = from_cpu(sal_c, state_c)
            print(f"{name}: control, {control}: saliency {c_sal:.3g}, state {c_st:.3g} "
                  f"against the CPU")
            if not (c_sal > TOL_SERVE_CPU and c_st > TOL_SERVE_CPU_STATE):
                fail(f"{name}: the bounds on the f32 clip do not catch {control}")
        del cpu_model, cpu_step, m32, s32, spy32, seen32, g32
        profiles[name] = write_profile(torch, s16, first_clip, zero16,
                                       f"chip_smoke_profile_{cfg[0]}.txt")
        results[name] = launches
        timed[name] = (g16, m16)
        torch.cuda.empty_cache()

    # the graphed bf16 steps and the runner over LONG_CLIPS clips, in turns
    names = list(timed)
    step_ms = {n: [] for n in names}
    for n in names + names[::-1]:
        graphed = timed[n][0]
        step_ms[n].append(cuda_ms(lambda: graphed(first_clip, zero16), 10))
    long_video = np.concatenate([video] * -(-LONG_CLIPS * S // len(video)))[:LONG_CLIPS * S]
    secs = {n: [] for n in names}
    for rep in range(E2E_RUNS):
        for n in (names if rep % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_videos(timed[n][0], timed[n][1], [long_video], native, batch_size=4)
            torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t0)
    n_frames = len(long_video)
    for n in names:
        a, b = step_ms[n]
        fps = ", ".join(f"{n_frames / t:.1f}" for t in secs[n])
        print(f"{n}: graphed bf16 step (V={V}, S={S}, 360x640) {a:.3f} and {b:.3f} ms per clip "
              f"({V * S / a * 1e3:.1f} and {V * S / b * 1e3:.1f} FPS); runner end to end, "
              f"graphed, over {LONG_CLIPS} clips, {E2E_RUNS} runs in turns: FPS {fps}; median "
              f"{n_frames / float(np.median(secs[n])):.1f}"
              + (f"; one eager step's device time {profiles[n][0]:.3f} ms, K1 "
                 f"{profiles[n][1]:.3f} ms ({profiles[n][1] / profiles[n][0]:.1%})"
                 if n in profiles else ""))
    del timed, step_ms
    torch.cuda.empty_cache()

    # the other configurations, one eager bf16 clip each
    want = {"twa_scan": 1, "twa_step": 0, "dwblock": 0}
    for k, (name, cfg) in enumerate(CLIP_CONFIGS.items()):
        tree, checksum = config_variables(cfg, SEED + 30 + k)
        config = config_kwargs(cfg)
        model = load_model_for_inference(tree, fold_bn=True, device="cuda", **config)
        step = make_baked_infer_step(model, gauss if cfg[2][0] else None,
                                     flagship[2] if cfg[2][1] else None,
                                     compute_dtype=torch.bfloat16)
        step(first_clip, zero16)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, new_state = step(first_clip, zero16)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"{name} ({config}; sum |w| {checksum:.6f}): one eager bf16 clip, launches "
              f"{launches}, saliency in [{out.min().item():.4g}, {out.max().item():.4g}], "
              f"std {out.std().item():.4g}")
        if launches != want:
            fail(f"{name}: launched {launches}, expected {want}")
        if (out.shape != (V, S, OUT_H, OUT_W, 1) or not torch.isfinite(out).all()
                or out.min().item() < 0 or out.max().item() > 1):
            fail(f"{name}: saliency of shape {tuple(out.shape)} is not finite in [0, 1]")
        if not torch.isfinite(new_state).all() or torch.equal(new_state, zero16):
            fail(f"{name}: the state did not change or is not finite")
        results[name] = {"bf16": launches}
        del model, step, out, new_state
        torch.cuda.empty_cache()
    for name, launches in results.items():
        print(f"configuration {name}: launches per path {json.dumps(launches)}")
    return results


# ---------------------------------------------------------------------------
# 3c. The flagship served at UAV2's native 720x1280


def native_phase(torch, kernels, twa, serve, drive, compare, flagship):
    """3c. The flagship served at iosize `NATIVE_IO`, as `cli test --iosize
    720,1280,90,160` serves UAV2 at its native size: the 90x160x256 state is
    wider than the persistent K1 takes, so every frame is one launch of the
    bf16 per-frame kernel. bf16 with K2 off, and f32, one synthetic
    720x1280 video of 3 carried clips of S=20 through phase 3's checks
    (`drive`: K1's launches exact, bf16 {twa_scan 0, twa_step 20, dwblock 0}
    per clip; the graph's kernel nodes the eager run's; graphed equal to
    eager bit for bit; K1 as served the bits of the kernel alone and within
    TOL_BF16 of the plain version in f32), bf16 against f32 at CC >= 0.99
    per frame, and the launches of one bf16 mixed train step at this size
    (the per-frame kernel once per frame). Then the graphed bf16 step and
    the runner over `LONG_CLIPS` clips in turns with the flagship's
    (`flagship` = its graphed step, model, video, native sizes, first clip
    and zero state), and one eager step profiled
    (`build/chip_smoke_profile_720p.txt`, K1's share). Returns the launches
    of each path."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
    from iip_uavsal_saliency_tpu_torch.runners.infer import predict_videos
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    in_h, in_w, out_h, out_w = NATIVE_IO
    if twa.kernel_route((V, S, out_h, out_w, 256), torch.bfloat16) != "twa_step":
        fail(f"K1's gate does not send the {out_h}x{out_w}x256 state to the per-frame kernel")
    rng = np.random.default_rng(SEED + 12)  # its own: the other phases' draws stay as they were
    priors = (get_gauss_priors(out_h, out_w, 8),
              rng.uniform(0.0, 1.0, (out_h, out_w, 20)).astype(np.float32))
    video = synthetic_video(rng, V * S * CLIPS, in_h, in_w)
    native = [(in_h, in_w)]
    name = f"flagship at {in_h}x{in_w}"
    launches = {}
    m16, s16, spy16, seen16 = serve(torch.bfloat16, False, priors=priors)
    launches["bf16"], g16, sal16, _ = drive(f"{name}, K2 off (bf16)", m16, s16, spy16, seen16,
                                            True, 0, video, native)
    m32, s32, spy32, seen32 = serve(None, False, priors=priors)
    launches["f32"], _, sal32, _ = drive(f"{name}, K2 off (f32)", m32, s32, spy32, seen32, False,
                                         0, video, native)
    compare(f"{name}: bf16 vs f32 saliency", sal16, sal32)
    del m32, s32, spy32, seen32, sal32
    torch.cuda.empty_cache()

    # one bf16 mixed train step at this size
    cuda = torch.device("cuda")
    start = init_model(UAVSal(), torch.Generator().manual_seed(SEED)).state_dict()
    model = train_model(torch, start, cuda)
    step = make_train_step(create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD)),
                           compute_dtype=torch.bfloat16)
    gaze = rng.uniform(0.0, 1.0, (1, TRAIN_S, out_h, out_w, 2)).astype(np.float32)
    gaze[..., 1] = gaze[..., 1] < 0.01
    gaze[:, :, out_h // 2, out_w // 2, 1] = 1.0
    x, y = torch.from_numpy(video[None, :TRAIN_S]).to(cuda), torch.from_numpy(gaze).to(cuda)
    g, o = (torch.from_numpy(p).to(cuda) for p in priors)
    zero = torch.zeros((1, out_h, out_w, 256), device=cuda)
    kernels.reset_launches()
    loss, _ = step(x, g, o, zero, y)
    torch.cuda.synchronize()
    launches["bf16 mixed train step"] = one = dict(kernels.launches)
    want = {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}
    print(f"{name}: one bf16 mixed train step (S={TRAIN_S}): loss {float(loss):.6f}, "
          f"launches {one}")
    if one != want or not np.isfinite(float(loss)):
        fail(f"{name}: the bf16 mixed train step launched {one} (expected {want}), loss {loss}")
    del model, step, x, y, zero
    torch.cuda.empty_cache()

    # the graphed bf16 steps and the runner over LONG_CLIPS clips, in turns
    # with the flagship's
    flag_graphed, flag_model, flag_video, flag_native, flag_clip, flag_zero = flagship
    clip = torch.from_numpy(video[None, :S]).to(cuda)
    zero16 = torch.zeros((V, out_h, out_w, 256), dtype=torch.bfloat16, device=cuda)
    paths = {"flagship at 360x640": (flag_graphed, flag_model, flag_video, flag_native,
                                     flag_clip, flag_zero),
             name: (g16, m16, video, native, clip, zero16)}
    names = list(paths)
    step_ms = {n: [] for n in names}
    for n in names + names[::-1]:
        graphed, _, _, _, c, z = paths[n]
        step_ms[n].append(cuda_ms(lambda: graphed(c, z), 10))
    secs = {n: [] for n in names}
    long = {n: np.concatenate([p[2]] * -(-LONG_CLIPS * S // len(p[2])))[:LONG_CLIPS * S]
            for n, p in paths.items()}
    for rep in range(E2E_RUNS):
        for n in (names if rep % 2 == 0 else names[::-1]):
            graphed, model, _, nat, _, _ = paths[n]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_videos(graphed, model, [long[n]], nat, batch_size=4)
            torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t0)
    total, k1 = write_profile(torch, s16, clip, zero16, "chip_smoke_profile_720p.txt")
    for n in names:
        a, b = step_ms[n]
        fps = ", ".join(f"{LONG_CLIPS * S / t:.1f}" for t in secs[n])
        print(f"{n}: graphed bf16 step (V={V}, S={S}) {a:.3f} and {b:.3f} ms per clip "
              f"({V * S / a * 1e3:.1f} and {V * S / b * 1e3:.1f} FPS); runner end to end, "
              f"graphed, over {LONG_CLIPS} clips, {E2E_RUNS} runs in turns: FPS {fps}; median "
              f"{LONG_CLIPS * S / float(np.median(secs[n])):.1f}")
    print(f"{name}: one eager bf16 step's device time {total:.3f} ms, K1 (20 per-frame "
          f"launches) {k1:.3f} ms ({k1 / total:.1%}), {k1 / S * 1e3:.2f} us per frame")
    del paths, long, g16, m16, s16, spy16, seen16
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 3d. The ablation zoo at full width (360x640)

# label -> (model_name, st_type): the JAX `MODEL_ZOO`'s 8 other names at the
# flagship's widths (MobileNetV2, 256 planes, time_dims 5, 2 ST blocks), and
# `uavsal_stblocks_type` at its other orderings
ZOO = {"uavsal_spconv": ("uavsal_spconv", "st"), "uavsal_teconv": ("uavsal_teconv", "st"),
       "uavsal_stblocks": ("uavsal_stblocks", "st"),
       "uavsal_stblocks_type": ("uavsal_stblocks_type", "st"),
       "uavsal_stblocks_type s2t": ("uavsal_stblocks_type", "s2t"),
       "uavsal_stblocks_type t2s": ("uavsal_stblocks_type", "t2s"),
       "uavsal_stblocks_type s_s2t": ("uavsal_stblocks_type", "s_s2t"),
       "uavsal_stc3d": ("uavsal_stc3d", "st"), "uavsal_stc2_3d": ("uavsal_stc2_3d", "st"),
       "uavsal_mp": ("uavsal_mp", "st"), "uavsal_lstm": ("uavsal_lstm", "st")}
# the f32 clip on the card against the port on the CPU (ConvLSTM's state;
# STC23D's 2-D and 3-D convs), with cuDNN's convs at TF32 as the control
# that each bound must catch, as TOL_SERVE_CPU is set. On an H100:
# uavsal_lstm read 4.17e-7 (saliency) and 1.62e-6 (state, of its largest
# value) against the control's 1.9e-4 and 8.22e-4; uavsal_stc2_3d 7.75e-7
# against 3.42e-4 (its state a dummy). The bounds sit between, as 3b's.
ZOO_CPU = ("uavsal_lstm", "uavsal_stc2_3d")
TOL_ZOO_CPU = 1.5e-6
TOL_ZOO_CPU_STATE = 8e-6
# the pipelined runner over LONG_CLIPS clips, in turns with the flagship's
ZOO_RUNNER = ("uavsal_lstm", "uavsal_stc3d")
# the f32 train step, the card against the CPU at TRAIN_SMALL_H x
# TRAIN_SMALL_W, S=10, as 5b holds ResNet-50's, within the flagship's
# bounds (TOL_TRAIN_*): each f32 step drifts from the exact answer through
# some 50 to 100 train-mode BatchNorms as the flagship's does, and
# tests/test_torch_zoo_train*.py hold every zoo model's f32 step (the JAX
# package's and the port's) to the port's f64 step within the same bounds
ZOO_TRAIN = ("uavsal_lstm", "uavsal_stc3d")
ZOO_TRAIN_STEPS = 10  # bf16 mixed steps of uavsal_lstm on one clip; the loss must fall
# uavsal_lstm's seeded head expand kernel is drawn this many times larger.
# ConvLSTM's output, o * tanh(c), is bounded by 1; ConvTWA's carries the
# features' scale. On an H100 the phase printed their std over one bf16
# clip as 0.1582 and 0.7543, and this is their ratio: it gives the head the
# flagship's input scale, as VGG16's factor restores its backbone's
# (config_variables). Unscaled, the random head left maps of std 0.0023
# around 0.51, below bf16's output step there (2^-8), and bf16 against f32
# read CC 0.77 per frame while no value moved by more than 0.0025.
LSTM_HEAD_GAIN = 4.8
# bf16 against f32 on each zoo name's maps, besides CC (which says nothing of
# a near-constant map): the max abs diff over the 3 clips in bf16 steps at
# the f32 map's largest value (`bf16_step`), a reading that does not depend
# on the map's spread. The maps are sigmoids in (0, 1) carried in bf16
# through every layer. For uavsal_lstm a control must exceed the bound: its
# bf16 clips 2 and 3 each served from a zero state (a recurrence that
# forgets what it carried) against the f32 clips carried.
ZOO_BF16_STEPS = 4


def zoo_variables(torch, model_name, st_type, seed):
    """Seeded weights of a zoo model as a JAX-layout tree (numpy ->
    `random_state_dict` from a generator of its own, uavsal_lstm's head
    scaled by `LSTM_HEAD_GAIN` -> the model's bridge table), and their sum
    |w|."""
    from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
    from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables

    model = build_adapted_model(model_name, filter_kwargs=True, st_type=st_type)
    sd = random_state_dict(model, np.random.default_rng(seed))
    if model_name == "uavsal_lstm":
        sd["conv_out_st.conv.0.0.weight"].mul_(LSTM_HEAD_GAIN)
    checksum = sum(t.double().abs().sum().item() for t in sd.values())
    return to_jax_variables(sd, table_of(model)), checksum


def bf16_step(level):
    """The spacing of bf16 numbers (8 significant bits) at `level` > 0."""
    return 2.0 ** (np.floor(np.log2(level)) - 7)


def zoo_bf16_steps(torch, label, name, step16, zero16, video, sal16, sal32):
    """`ZOO_BF16_STEPS` on one zoo name (see there), and uavsal_lstm's
    control."""
    unit = bf16_step(sal32.abs().max().item())
    d16 = (sal16 - sal32).abs().max().item()
    print(f"{label}: bf16 vs f32 max abs diff {d16:.3g} = {d16 / unit:.3g} bf16 steps at the f32 "
          f"map's largest value (bound {ZOO_BF16_STEPS})")
    if not d16 <= ZOO_BF16_STEPS * unit:
        fail(f"{label}: bf16 vs f32 max abs diff {d16} > {ZOO_BF16_STEPS} bf16 steps ({unit})")
    if name != "uavsal_lstm":
        return
    forgot = []
    for k in range(1, CLIPS):
        clip = torch.from_numpy(video[None, k * S:(k + 1) * S]).cuda()
        forgot.append(step16(clip, zero16)[0][0, :, :, :, 0].double())
    d_c = (torch.cat(forgot) - sal32[S:]).abs().max().item()
    print(f"{label}: control, bf16 clips 2 and 3 each from a zero state against f32 carried: "
          f"max abs diff {d_c:.3g} = {d_c / unit:.3g} bf16 steps")
    if not d_c > ZOO_BF16_STEPS * unit:
        fail(f"{label}: the bf16 steps bound does not catch a recurrence that forgets its state")


def zoo_phase(torch, kernels, serve, drive, compare, video, native, first_clip, flagship):
    """3d. The ablation zoo at 360x640 on seeded weights (numpy -> the
    model's bridge table -> JAX-layout tree -> `load_model_for_inference(
    model_name=, st_type=)`), every name of `ZOO`: bf16 and f32, 3 carried
    clips of S=20 through phase 3's checks (`drive`: launches exact, here
    neither K1 nor K2, and ConvTWA never called; finite maps in [0, 1];
    ConvLSTM's state changing every clip, the others' dummy zeros passed
    through; graphed equal to eager bit for bit, the graph holding no K1 or
    K2 node), bf16 against f32 at CC >= 0.99 per frame and within
    `ZOO_BF16_STEPS` (uavsal_lstm with its control); the f32 clip of
    `ZOO_CPU` against the port on the CPU (with a TF32 control); each
    eager bf16 step profiled (its top ops), the graphed bf16 steps timed in
    turns with the flagship's (`flagship` = its graphed step, model, ob
    prior and eager step), the runner over `LONG_CLIPS` clips for `ZOO_RUNNER`; then the
    f32 train step of `ZOO_TRAIN` on the card against the CPU at the reduced
    size and `ZOO_TRAIN_STEPS` bf16 mixed steps of uavsal_lstm at 360x640
    (no K1 or K2 launch; the loss falls). Returns the launches of each path,
    and of the train steps."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.runners.infer import (load_model_for_inference,
                                                             predict_videos)
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step

    t_phase = time.perf_counter()
    none = {"twa_scan": 0, "twa_step": 0, "dwblock": 0}
    results, timed, profiles = {}, {"flagship (uavsal)": (flagship[0], flagship[1], None)}, {}
    gauss, ob = get_gauss_priors(OUT_H, OUT_W, 8), flagship[2]
    for k, (label, (name, st_type)) in enumerate(ZOO.items()):
        tree, checksum = zoo_variables(torch, name, st_type, SEED + 50 + k)
        config = {"model_name": name, "st_type": st_type}
        print(f"{label}: seeded weights, sum |w| {checksum:.6f}")
        launches = {}
        m16, s16, spy16, seen16 = serve(torch.bfloat16, False, tree, config)
        launches["bf16"], g16, sal16, _ = drive(f"{label} (bf16)", m16, s16, spy16, seen16,
                                                True, 0, k1=False)
        m32, s32, spy32, seen32 = serve(None, False, tree, config)
        launches["f32"], g32, sal32, _ = drive(f"{label} (f32)", m32, s32, spy32, seen32,
                                               False, 0, k1=False)
        if launches != {"bf16": none, "f32": none}:
            fail(f"{label}: launched {launches}; a zoo model but uavsal launches no kernel")
        zero16 = m16.init_state(IN_H, IN_W, V, dtype=torch.bfloat16, device="cuda")
        if name == "uavsal_lstm":
            zero = torch.zeros((V, OUT_H, OUT_W, 256), dtype=torch.bfloat16, device="cuda")
            twa = rnn_spread(torch, flagship[1], flagship[3], first_clip, zero)
            lstm = rnn_spread(torch, m16, s16, first_clip, zero16)
            print(f"the recurrence's output std over one bf16 clip from a zero state: flagship "
                  f"(ConvTWA) {twa:.4g}, {label} (ConvLSTM; its head's expand kernel drawn "
                  f"{LSTM_HEAD_GAIN} times larger) {lstm:.4g}")
        print(f"{label}: f32 map mean {sal32.mean().item():.4g} std {sal32.std().item():.4g}")
        compare(f"{label}: bf16 vs f32 saliency", sal16, sal32)
        zoo_bf16_steps(torch, label, name, s16, zero16, video, sal16, sal32)
        if label in ZOO_CPU:
            zoo_against_cpu(torch, label, tree, config, s32, seen32, first_clip, gauss, ob)
        del m32, s32, spy32, seen32, g32
        profiles[label] = write_profile(torch, s16, first_clip, zero16,
                                        f"chip_smoke_profile_zoo_{label.replace(' ', '_')}.txt",
                                        top=4)
        results[label] = launches
        timed[label] = (g16, m16, zero16)
        torch.cuda.empty_cache()

    # the graphed bf16 steps in turns with the flagship's, and the runner
    names = list(timed)
    zero_flag = torch.zeros((V, OUT_H, OUT_W, 256), dtype=torch.bfloat16, device="cuda")
    step_ms = {n: [] for n in names}
    for n in names + names[::-1]:
        graphed, _, zero = timed[n]
        z = zero_flag if zero is None else zero
        step_ms[n].append(cuda_ms(lambda: graphed(first_clip, z), 10))
    long_video = np.concatenate([video] * -(-LONG_CLIPS * S // len(video)))[:LONG_CLIPS * S]
    runner = [names[0]] + list(ZOO_RUNNER)
    secs = {n: [] for n in runner}
    for rep in range(E2E_RUNS):
        for n in (runner if rep % 2 == 0 else runner[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_videos(timed[n][0], timed[n][1], [long_video], native, batch_size=4)
            torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t0)
    n_frames = len(long_video)
    for n in names:
        a, b = step_ms[n]
        line = (f"{n}: graphed bf16 step (V={V}, S={S}, 360x640) {a:.3f} and {b:.3f} ms per clip "
                f"({V * S / a * 1e3:.1f} and {V * S / b * 1e3:.1f} FPS)")
        if n in secs:
            line += (f"; runner end to end, graphed, over {LONG_CLIPS} clips, {E2E_RUNS} runs in "
                     f"turns: FPS {', '.join(f'{n_frames / t:.1f}' for t in secs[n])}; median "
                     f"{n_frames / float(np.median(secs[n])):.1f}")
        if n in profiles:
            line += f"; one eager step's device time {profiles[n][0]:.3f} ms"
        print(line)
    del timed, step_ms
    torch.cuda.empty_cache()
    results["train steps"] = zoo_train(torch, kernels)
    print(f"phase 3d (the zoo) took {time.perf_counter() - t_phase:.1f} s")
    return results


def rnn_spread(torch, model, step, clip, state):
    """The std of the recurrence's output over one eager step."""
    seen = []
    hook = model.rnn.register_forward_hook(lambda m, i, out: seen.append(out[0].float().std()))
    step(clip, state)
    torch.cuda.synchronize()
    hook.remove()
    return seen[0].item()


def zoo_against_cpu(torch, label, tree, config, step32, seen32, first_clip, gauss, ob):
    """The card's f32 first clip (`seen32[0]`, from a zero state) against the
    port on the CPU: the saliency absolute, a recurrent state relative to
    its largest value (a dummy state must be zeros on both); and the same
    clip with cuDNN's convs at TF32 as the control the bounds must catch."""
    from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step

    cpu_model = load_model_for_inference(tree, fold_bn=True, device="cpu", **config)
    cpu_step = make_baked_infer_step(cpu_model, gauss, ob)
    t0 = time.perf_counter()
    out_c, st_c = cpu_step(first_clip.cpu(), cpu_model.init_state(IN_H, IN_W, V))
    cpu_s = time.perf_counter() - t0
    top = st_c.abs().max().item()

    def from_cpu(out_g, st_g):
        d_st = (st_c - st_g.float().cpu()).abs().max().item()
        return (out_c - out_g.float().cpu()).abs().max().item(), d_st / top if top else d_st

    out_g, _, st_g = seen32[0]
    d_sal, d_st = from_cpu(out_g, st_g)
    print(f"{label}: f32 clip on the card against the CPU ({cpu_s:.1f} s there): saliency max "
          f"abs diff {d_sal:.3g} (tolerance {TOL_ZOO_CPU}), state {d_st:.3g}"
          + (f" of its largest value {top:.3g} (tolerance {TOL_ZOO_CPU_STATE})" if top
             else " (a dummy: must be 0)"))
    if not (d_sal <= TOL_ZOO_CPU and d_st <= (TOL_ZOO_CPU_STATE if top else 0.0)):
        fail(f"{label}: the card's f32 clip disagrees with the CPU's")
    zero = cpu_model.init_state(IN_H, IN_W, V, device="cuda")
    torch.backends.cudnn.allow_tf32 = True
    try:
        sal_t, st_t = step32(first_clip, zero)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    c_sal, c_st = from_cpu(sal_t, st_t)
    print(f"{label}: control, cuDNN's convs at TF32: saliency {c_sal:.3g}, state {c_st:.3g} "
          "against the CPU")
    if not (c_sal > TOL_ZOO_CPU and (c_st > TOL_ZOO_CPU_STATE or not top)):
        fail(f"{label}: the bounds on the f32 clip do not catch cuDNN's convs at TF32")


def zoo_train(torch, kernels):
    """The zoo's training on seeded `init_model` weights: for `ZOO_TRAIN`,
    one f32 train step on the card against the same step on the CPU at
    TRAIN_SMALL_H x TRAIN_SMALL_W, S=10 (held as 5b holds ResNet-50's, to
    the flagship's bounds);
    then `ZOO_TRAIN_STEPS` bf16 mixed steps of uavsal_lstm on one clip at
    360x640, S=10 (the loss must fall). No step launches K1 or K2. Returns
    the launches of each step."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    none = {"twa_scan": 0, "twa_step": 0, "dwblock": 0}
    rng = np.random.default_rng(SEED + 60)
    launches = {}
    h, w = TRAIN_SMALL_H, TRAIN_SMALL_W
    for name in ZOO_TRAIN:
        config = {"model_name": name}
        shape_of = build_adapted_model(name, filter_kwargs=True)
        start = init_model(shape_of, torch.Generator().manual_seed(SEED)).state_dict()
        x = torch.from_numpy(rng.integers(0, 256, (1, TRAIN_S, h, w, 3)).astype(np.uint8))
        ymap = rng.uniform(0.0, 1.0, (1, TRAIN_S, h // 8, w // 8, 1))
        ypts = rng.uniform(0.0, 1.0, (1, TRAIN_S, h // 8, w // 8, 1)) < 0.05
        ypts[:, :, 3, 4] = True
        y = torch.from_numpy(np.concatenate([ymap, ypts], -1).astype(np.float32))
        state = shape_of.init_state(h, w, 1)
        if state.dim() == 5:  # ConvLSTM's h and c, seeded
            state = torch.from_numpy(rng.normal(0.0, 0.5, tuple(state.shape)).astype(np.float32))
        small = (x, y, torch.from_numpy(get_gauss_priors(h // 8, w // 8, 8)),
                 torch.from_numpy(rng.uniform(0.0, 1.0, (h // 8, w // 8, 20)).astype(np.float32)),
                 state)
        t0 = time.perf_counter()
        on_cpu = one_train_step(torch, kernels, start, small, cpu, config=config)
        cpu_s = time.perf_counter() - t0
        on_card = one_train_step(torch, kernels, start, small, cuda, config=config)
        print(f"{name} train step f32 at {h}x{w}, S={TRAIN_S}: {cpu_s:.1f} s on the CPU; loss "
              f"CPU {on_cpu[0]:.6f}, card {on_card[0]:.6f}; card launches {on_card[4]}")
        held_train(f"{name} train step f32 at {h}x{w}, card vs CPU",
                   train_diffs(on_cpu, on_card), TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
                   TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
        if on_card[4] != none:
            fail(f"{name} train step f32 launched {on_card[4]}")
        launches[f"{name}, f32"] = on_card[4]
        del on_cpu, on_card

    # bf16 mixed steps of uavsal_lstm on one clip at 360x640
    frames, gaze = train_video(rng, TRAIN_S)
    x, y = torch.from_numpy(frames[None]).to(cuda), torch.from_numpy(gaze[None]).to(cuda)
    g = torch.from_numpy(get_gauss_priors(OUT_H, OUT_W, 8)).to(cuda)
    o = torch.from_numpy(rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)).to(cuda)
    config = {"model_name": "uavsal_lstm"}
    start = init_model(build_adapted_model("uavsal_lstm"),
                       torch.Generator().manual_seed(SEED)).state_dict()
    model = train_model(torch, start, cuda, config=config)
    step = make_train_step(create_train_state(model, make_optimizer(model, 1e-3, TRAIN_WD)),
                           compute_dtype=torch.bfloat16)
    zero = model.init_state(IN_H, IN_W, 1, device=cuda)
    kernels.reset_launches()
    losses = [float(step(x, g, o, zero, y)[0])]
    torch.cuda.synchronize()
    launches["uavsal_lstm, bf16 mixed"] = one = dict(kernels.launches)
    losses += [float(step(x, g, o, zero, y)[0]) for _ in range(ZOO_TRAIN_STEPS - 1)]
    windows = cuda_windows(lambda: step(x, g, o, zero, y), 2, windows=3)
    print(f"uavsal_lstm train step bf16 mixed (360x640, S={TRAIN_S}): launches {one}; "
          f"{ZOO_TRAIN_STEPS} steps on one clip (Adam lr 1e-3): loss "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; median {float(np.median(windows)):.3f} ms per step over 3 windows of 2")
    if one != none:
        fail(f"uavsal_lstm bf16 mixed train step launched {one}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("uavsal_lstm bf16 mixed train step: the loss did not fall")
    del model, step
    torch.cuda.empty_cache()
    return launches


def config_train_phase(torch, kernels):
    """5b. ResNet-50 UAVSal trained on seeded `init_model` weights: (1) one
    f32 train step on the card against the same step on the CPU at
    128x224, S=10; (2) at 360x640, S=10, the f32 and the bf16 mixed step:
    K1's launches in one step exactly (f32 the per-frame kernel once per
    frame, bf16 the persistent kernel once), the loss falling over
    `CONFIG_TRAIN_STEPS` steps on one clip (Adam lr 1e-3), ms per step in
    turns, peak memory, and K1's share of a profiled bf16 step. Returns
    the launches of one step by dtype."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    config = {"cnn_type": "resnet50"}
    rng = np.random.default_rng(SEED + 40)
    start = init_model(UAVSal(**config), torch.Generator().manual_seed(SEED)).state_dict()

    # (1) the card against the CPU, f32, at the reduced size
    h, w = TRAIN_SMALL_H, TRAIN_SMALL_W
    x = torch.from_numpy(rng.integers(0, 256, (1, TRAIN_S, h, w, 3)).astype(np.uint8))
    ymap = rng.uniform(0.0, 1.0, (1, TRAIN_S, h // 8, w // 8, 1))
    ypts = rng.uniform(0.0, 1.0, (1, TRAIN_S, h // 8, w // 8, 1)) < 0.05
    ypts[:, :, 3, 4] = True
    y = torch.from_numpy(np.concatenate([ymap, ypts], -1).astype(np.float32))
    small = (x, y, torch.from_numpy(get_gauss_priors(h // 8, w // 8, 8)),
             torch.from_numpy(rng.uniform(0.0, 1.0, (h // 8, w // 8, 20)).astype(np.float32)),
             torch.from_numpy(rng.normal(0.0, 0.5, (1, h // 8, w // 8, 256)).astype(np.float32)))
    t0 = time.perf_counter()
    on_cpu = one_train_step(torch, kernels, start, small, cpu, config=config)
    cpu_s = time.perf_counter() - t0
    on_card = one_train_step(torch, kernels, start, small, cuda, config=config)
    print(f"ResNet-50 train step f32 at {h}x{w}, S={TRAIN_S}: {cpu_s:.1f} s on the CPU; loss "
          f"CPU {on_cpu[0]:.6f}, card {on_card[0]:.6f}; card launches {on_card[4]}")
    held_train(f"ResNet-50 train step f32 at {h}x{w}, card vs CPU", train_diffs(on_cpu, on_card),
               TOL_R50_TRAIN_LOSS, TOL_R50_TRAIN_GRAD, TOL_R50_TRAIN_GRAD_LEAF,
               TOL_R50_TRAIN_BN, TOL_R50_TRAIN_STATE)
    if on_card[4] != {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}:
        fail(f"ResNet-50 train step f32 at {h}x{w} launched {on_card[4]}")
    del on_cpu, on_card

    # (2) at 360x640: launches, the loss over repeated steps, times, memory
    frames, gaze = train_video(rng, TRAIN_S)
    x, y = torch.from_numpy(frames[None]).to(cuda), torch.from_numpy(gaze[None]).to(cuda)
    g = torch.from_numpy(get_gauss_priors(OUT_H, OUT_W, 8)).to(cuda)
    o = torch.from_numpy(rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)).to(cuda)
    zero = torch.zeros((1, OUT_H, OUT_W, 256), device=cuda)
    want = {torch.bfloat16: {"twa_scan": 1, "twa_step": 0, "dwblock": 0},
            None: {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}}
    launches = {}
    for dtype in (None, torch.bfloat16):
        name = "bf16 mixed" if dtype else "f32"
        model = train_model(torch, start, cuda, config=config)
        step = make_train_step(create_train_state(model, make_optimizer(model, 1e-3, TRAIN_WD)),
                               compute_dtype=dtype)
        kernels.reset_launches()
        losses = [float(step(x, g, o, zero, y)[0])]
        torch.cuda.synchronize()
        launches["bf16" if dtype else "f32"] = one = dict(kernels.launches)
        losses += [float(step(x, g, o, zero, y)[0]) for _ in range(CONFIG_TRAIN_STEPS - 1)]
        print(f"ResNet-50 train step {name} (360x640, S={TRAIN_S}): launches {one}; "
              f"{CONFIG_TRAIN_STEPS} steps on one clip (Adam lr 1e-3): loss "
              + ", ".join(f"{v:.4f}" for v in losses))
        if one != want[dtype]:
            fail(f"ResNet-50 train step {name} launched {one}, expected {want[dtype]}")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"ResNet-50 train step {name}: the loss did not fall")
        del model, step
    steps = {}
    for dtype in (None, torch.bfloat16):
        model = train_model(torch, start, cuda, config=config)
        steps[dtype] = make_train_step(
            create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD)),
            compute_dtype=dtype)
    windows = {None: [], torch.bfloat16: []}
    for dtype in (None, torch.bfloat16, torch.bfloat16, None):
        windows[dtype] += cuda_windows(lambda: steps[dtype](x, g, o, zero, y), 2, windows=3)
    for dtype, step in steps.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(x, g, o, zero, y)
        torch.cuda.synchronize()
        ms = float(np.median(windows[dtype]))
        print(f"ResNet-50 train step {'bf16 mixed' if dtype else 'f32'} (V=1, S={TRAIN_S}, "
              f"360x640, uint8 clip on the card): median {ms:.3f} ms over {len(windows[dtype])} "
              f"windows of 2 steps (turns f32, bf16, bf16, f32), fastest "
              f"{min(windows[dtype]):.3f}; {TRAIN_S / ms * 1e3:.1f} training frames/s; memory "
              f"allocated {before / 2**30:.3f} GiB before the step, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in it")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps[torch.bfloat16](x, g, o, zero, y)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events if "twa_clip_kernel" in e.key) / 1e3
    print(f"ResNet-50 bf16 train step under the profiler: device time {total:.3f} ms, K1's "
          f"forward {k1:.3f} ms ({k1 / total:.1%})")
    del steps
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5. Training at full width (360x640, S=10, V=1)


def train_video(rng, n):
    """n frames for training: `synthetic_video`'s moving disk (uint8
    (n, 360, 640, 3)) and its ground truth at 45x80, (n, 45, 80, 2) f32: a
    fixation at the disk's centre and one at random per frame (channel 1)
    and their blurred map, peak 1 (channel 0)."""
    frames = synthetic_video(rng, n)
    yy, xx = np.mgrid[0:OUT_H, 0:OUT_W]
    gaze = np.zeros((n, OUT_H, OUT_W, 2), np.float32)
    for t in range(n):
        cy, cx = IN_H / 2 + 80 * np.sin(t / 7.0), 60 + t * 8  # the disk, as drawn
        points = [(min(int(cy // 8), OUT_H - 1), min(int(cx // 8), OUT_W - 1)),
                  (int(rng.integers(OUT_H)), int(rng.integers(OUT_W)))]
        blur = np.zeros((OUT_H, OUT_W))
        for py, px in points:
            gaze[t, py, px, 1] = 1.0
            blur += np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * 3.0 ** 2))
        gaze[t, :, :, 0] = blur / blur.max()
    return frames, gaze


def array_video(name, frames, gaze):
    """`train_video`'s frames and ground truth as `Trainer(videos=...)`
    takes a video: (name, frames, maps uint8, fixations uint8)."""
    return (name, frames, (gaze[..., :1] * 255).astype(np.uint8), gaze[..., 1:].astype(np.uint8))


def train_model(torch, start, device, fused=False, scan=None, config=None):
    """The flagship (or the zoo model of `config`, the keyword arguments of
    `build_adapted_model`: a UAVSal configuration, or `model_name` and
    `st_type`) with the weights `start`, channels-last on `device`; `scan`
    is ConvTWA's scan (None: K1 on the card)."""
    from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
    from iip_uavsal_saliency_tpu_torch.ops.layers import to_channels_last

    config = dict(config or {})
    model = build_adapted_model(config.pop("model_name", "uavsal"), filter_kwargs=True,
                                fused_dwblock=fused, **config)
    model.load_state_dict(start, strict=True)
    if scan is not None:
        model.rnn.scan = scan
    return to_channels_last(model, device)


def one_train_step(torch, kernels, start, batch, device, dtype=None, fused=False, scan=None,
                   config=None, loss_fn=None, remat=False):
    """One train step (Adam, every parameter trained) from the weights
    `start` on `batch` = (x, y, gauss, ob, state), with `loss_fn` (the
    step's default: `loss_fu`) and `remat`: (loss, {name: gradient},
    {name: buffer after}, new state, its launches), all on the host in f64."""
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    model = train_model(torch, start, device, fused, scan, config)
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}
    step = make_train_step(create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD)),
                           compute_dtype=dtype, remat=remat, **kw)
    x, y, gauss, ob, state = (t.to(device) for t in batch)
    kernels.reset_launches()
    loss, new_state = step(x, gauss, ob, state, y)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if new_state.grad_fn is not None or new_state.dtype != torch.float32:
        fail(f"the train step's carried state has grad_fn {new_state.grad_fn}, dtype "
             f"{new_state.dtype}")
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    bufs = {n: b.detach().double().cpu() for n, b in model.named_buffers()}
    return float(loss), grads, bufs, new_state.double().cpu(), launches


def bn_scale(bufs, name):
    """What an error of a running stat is read against: the largest
    variance, or for a mean the largest mean plus the largest std."""
    if name.endswith("running_var"):
        return bufs[name].abs().max().item()
    return bufs[name].abs().max().item() + bufs[name[:-4] + "var"].max().sqrt().item()


def train_diffs(a, b):
    """Step b against step a: the loss (relative), the whole gradient, its
    worst leaf (the leaf's norm floored) and ConvTWA's leaves together
    (relative L2), the worst leaf's
    largest error over its largest entry, the BN stats (relative to
    `bn_scale`) and the carried state (absolute)."""
    la, ga, ba, sa, _ = a
    lb, gb, bb, sb, _ = b
    total = np.sqrt(sum((g ** 2).sum().item() for g in ga.values()))
    top = max(g.abs().max().item() for g in ga.values())
    grad = np.sqrt(sum(((gb[n] - ga[n]) ** 2).sum().item() for n in ga)) / total
    leaf, leaf_name = max(((gb[n] - ga[n]).norm().item() / max(ga[n].norm().item(), 1e-4 * total),
                           n) for n in ga)
    entry = max((gb[n] - ga[n]).abs().max().item() / max(ga[n].abs().max().item(), 1e-4 * top)
                for n in ga)
    bn, bn_name = max(((bb[n] - ba[n]).abs().max().item() / bn_scale(ba, n), n)
                      for n in ba if "running" in n)
    rnn = [n for n in ga if n.startswith("rnn.")]  # none in a model without a recurrence
    rnn_err = np.sqrt(sum(((gb[n] - ga[n]) ** 2).sum().item() for n in rnn)
                      / sum((ga[n] ** 2).sum().item() for n in rnn)) if rnn else 0.0
    return {"loss": abs(lb - la) / abs(la), "grad": grad, "leaf": leaf, "leaf_name": leaf_name,
            "rnn": rnn_err, "entry": entry, "bn": bn, "bn_name": bn_name,
            "state": (sb - sa).abs().max().item()}


def held_train(name, d, tol_loss, tol_grad, tol_leaf, tol_bn, tol_state):
    """Print step b's differences from step a (`train_diffs`) and fail
    unless each lies within its tolerance (`tol_leaf` None: not held)."""
    print(f"{name}: loss {d['loss']:.3g} (tolerance {tol_loss}), gradient {d['grad']:.3g} "
          f"(tolerance {tol_grad}), worst leaf {d['leaf']:.3g} ({d['leaf_name']}"
          + (f", tolerance {tol_leaf}" if tol_leaf else ", not held") + "), the recurrence's "
          f"leaves {d['rnn']:.3g}, worst leaf's largest error {d['entry']:.3g} of its largest "
          f"entry, BN stats {d['bn']:.3g} ({d['bn_name']}, tolerance {tol_bn}), state "
          f"{d['state']:.3g} (tolerance {tol_state})")
    if not (d["loss"] <= tol_loss and d["grad"] <= tol_grad
            and (tol_leaf is None or d["leaf"] <= tol_leaf)
            and d["bn"] <= tol_bn and d["state"] <= tol_state):
        fail(f"{name}: outside its tolerances")


def train_phase(torch, kernels, twa):
    """Training at 360x640, S=10, V=1 on seeded random weights from
    `init_model`: (1) one f32 train step on the card against the same step
    on the CPU; (2) the bf16 mixed and the f32 step with K1 against the same
    step with the plain scan (`ConvTWA.scan = twa_scan_ref`); (3) the launches
    of one step, with the fused dwBlock off and on; (4) TBPTT over 3 carried
    clips, and the loss over repeated steps on one clip; (5) the trainer's own
    loop over in-memory videos, its `_final.ckpt` read back and served;
    (6) the numbers. Returns the launches counted in one train step, by
    dtype ("bf16", "f32") and with the fused dwBlock on ("bf16 fused",
    "f32 fused")."""
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
    from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (_maybe_normalize,
                                                             create_train_state, make_eval_step,
                                                             make_train_step)
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(SEED + 7)  # its own: the serving phases' draws stay as they were
    start = init_model(UAVSal(), torch.Generator().manual_seed(SEED)).state_dict()
    gauss = torch.from_numpy(get_gauss_priors(OUT_H, OUT_W, 8))
    ob = torch.from_numpy(rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32))
    frames, gaze = train_video(rng, 3 * TRAIN_S)
    clips = [(torch.from_numpy(frames[None, k:k + TRAIN_S]),
              torch.from_numpy(gaze[None, k:k + TRAIN_S])) for k in range(0, 3 * TRAIN_S, TRAIN_S)]
    carried = torch.from_numpy(rng.normal(0.0, 0.5, (1, OUT_H, OUT_W, 256)).astype(np.float32))
    batch = (*clips[0], gauss, ob, carried)
    want = {torch.bfloat16: {"twa_scan": 1, "twa_step": 0, "dwblock": 0},
            None: {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}}

    # (1) the card against the port on the CPU, f32
    t0 = time.perf_counter()
    on_cpu = one_train_step(torch, kernels, start, batch, cpu)
    cpu_s = time.perf_counter() - t0
    on_card = one_train_step(torch, kernels, start, batch, cuda)
    print(f"train step f32 on the CPU took {cpu_s:.1f} s; loss CPU {on_cpu[0]:.6f}, card "
          f"{on_card[0]:.6f}")
    d = train_diffs(on_cpu, on_card)
    held_train("train step f32, card vs CPU", d, TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
               TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
    del on_cpu

    # (2) K1 and its gradient against the plain scan, in the same step
    launches = {}
    for dtype, tols in ((torch.bfloat16, (TOL_TRAIN_BF16_LOSS, TOL_TRAIN_BF16_GRAD, None,
                                          TOL_TRAIN_BF16_BN, TOL_TRAIN_BF16_STATE)),
                        (None, (TOL_TRAIN_K1_LOSS, TOL_TRAIN_K1_GRAD, TOL_TRAIN_K1_LEAF,
                                TOL_TRAIN_K1_BN, TOL_TRAIN_K1_STATE))):
        name = "bf16 mixed" if dtype else "f32"
        k1 = one_train_step(torch, kernels, start, batch, cuda, dtype) if dtype else on_card
        plain = one_train_step(torch, kernels, start, batch, cuda, dtype, scan=twa.twa_scan_ref)
        if k1[4] != want[dtype] or any(plain[4].values()):
            fail(f"train step {name}: K1 path launched {k1[4]} (expected {want[dtype]}), plain "
                 f"path {plain[4]} (expected none)")
        held_train(f"train step {name}, K1 vs the plain scan", train_diffs(plain, k1), *tols)
        # (3) the fused dwBlock is refused in train mode
        fused = one_train_step(torch, kernels, start, batch, cuda, dtype, fused=True)
        print(f"train step {name}: launches {k1[4]}, with the fused dwBlock on {fused[4]}")
        if fused[4] != want[dtype]:
            fail(f"train step {name} with the fused dwBlock on launched {fused[4]}, "
                 f"expected {want[dtype]}")
        launches["bf16" if dtype else "f32"] = k1[4]
        launches[("bf16" if dtype else "f32") + " fused"] = fused[4]
    del on_card, k1, plain, fused

    # (4) TBPTT over 3 carried clips; the loss over repeated steps on one clip
    g, o = gauss.to(cuda), ob.to(cuda)
    falls = {}
    for dtype in (None, torch.bfloat16):
        name = "bf16 mixed" if dtype else "f32"
        model = train_model(torch, start, cuda)
        state = create_train_state(model, make_optimizer(model, 1e-3, TRAIN_WD))
        step = make_train_step(state, compute_dtype=dtype)
        rnn = model.init_state(IN_H, IN_W, device=cuda)
        for k, (x, y) in enumerate(clips):
            loss, new = step(x.to(cuda), g, o, rnn, y.to(cuda))
            if new.grad_fn is not None or new.requires_grad or torch.equal(new, rnn):
                fail(f"TBPTT {name}, clip {k}: the carried state is not new detached data")
            rnn = new
        x, y = (t.to(cuda) for t in clips[0])
        losses = [float(step(x, g, o, model.init_state(IN_H, IN_W, device=cuda), y)[0])
                  for _ in range(TRAIN_REPEATS)]
        falls[name] = losses
        print(f"TBPTT {name}: 3 carried clips, state detached; {TRAIN_REPEATS} steps on one clip "
              f"(Adam lr 1e-3): loss " + ", ".join(f"{v:.4f}" for v in losses))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"TBPTT {name}: the loss did not fall over {TRAIN_REPEATS} steps")
    del model, state, step

    # (5) the trainer's own clip loop on in-memory videos, 2 epochs
    save_dir = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    val_frames, val_gaze = train_video(rng, TRAIN_S)

    cfg = TrainConfig(method_name="ChipSmoke", iosize=(IN_H, IN_W, OUT_H, OUT_W), epochs=2)
    trainer = Trainer(cfg, "", "synthetic", save_dir, device="cuda", ob_prior=ob.numpy(),
                      videos={"train": [array_video("train", frames[:2 * TRAIN_S],
                                                    gaze[:2 * TRAIN_S])],
                              "val": [array_video("val", val_frames, val_gaze)]})
    t0 = time.perf_counter()
    trainer.train()
    train_s = time.perf_counter() - t0
    final = os.path.join(save_dir, "ChipSmoke", "ChipSmoke_final.ckpt")
    with open(os.path.join(save_dir, "ChipSmoke", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    epochs = {r["tag"] + str(r["step"]): round(r["value"], 4) for r in logged
              if r["tag"].endswith("mean_loss")}
    if trainer.state.step != 4 or not os.path.exists(final):
        fail(f"the trainer took {trainer.state.step} steps (expected 4) or wrote no {final}")
    served = load_model_for_inference(final, fold_bn=False, device="cuda")
    serve = make_baked_infer_step(served, gauss.numpy(), ob.numpy())
    x = torch.from_numpy(val_frames[None]).to(cuda)
    zero = served.init_state(IN_H, IN_W, device=cuda)
    maps, _ = serve(x, zero)
    trainer.model.eval()
    with torch.no_grad():
        mine, _ = trainer.model(_maybe_normalize(x), g, o, zero)
    same = torch.equal(maps, mine)
    print(f"trainer: 2 epochs of 2 train clips and 1 val clip in {train_s:.1f} s, epoch mean "
          f"losses {epochs}; {final} read back and served: maps of shape {tuple(maps.shape)} "
          f"equal to the trained model's in eval mode: {same} (max abs diff "
          f"{(maps - mine).abs().max().item():.3g})")
    if not same or not torch.isfinite(maps).all():
        fail("the served _final.ckpt does not give the trained model's maps")
    del trainer, served, serve

    # (6) numbers: step times in turns, peak memory, the eval step, a profile
    x, y = (t.to(cuda) for t in clips[0])
    steps, models = {}, {}
    for dtype in (None, torch.bfloat16):
        model = train_model(torch, start, cuda)
        st = create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD))
        steps[dtype], models[dtype] = make_train_step(st, compute_dtype=dtype), model
    zero = models[None].init_state(IN_H, IN_W, device=cuda)
    windows = {None: [], torch.bfloat16: []}
    for dtype in (None, torch.bfloat16, torch.bfloat16, None):
        windows[dtype] += cuda_windows(lambda: steps[dtype](x, g, o, zero, y), 3)
    peak = {}
    for dtype, step in steps.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(x, g, o, zero, y)
        torch.cuda.synchronize()
        peak[dtype] = (before, torch.cuda.max_memory_allocated())
    eval_ms = cuda_ms(lambda: make_eval_step(models[None])(x, g, o, zero, y), 5)
    for dtype, ws in windows.items():
        ms = float(np.median(ws))
        name = "bf16 mixed" if dtype else "f32"
        print(f"train step {name} (V=1, S={TRAIN_S}, 360x640, uint8 clip on the card): median "
              f"{ms:.3f} ms over {len(ws)} windows of 3 steps (turns f32, bf16, bf16, f32), "
              f"fastest {min(ws):.3f}; {TRAIN_S / ms * 1e3:.1f} training frames/s; memory "
              f"allocated {peak[dtype][0] / 2**30:.3f} GiB before the step, peak "
              f"{peak[dtype][1] / 2**30:.3f} GiB in it")
    print(f"eval step f32 (V=1, S={TRAIN_S}, 360x640): {eval_ms:.3f} ms")

    # the TWA backward's recompute at this step's shape, timed alone
    shape = (1, TRAIN_S, OUT_H, OUT_W, 256)
    xs, gx, w_h, h0 = k1_case(torch, np.random.default_rng(SEED + 8), shape, torch.bfloat16)
    grads_out = [torch.randn_like(xs), torch.randn_like(h0)]

    def recompute():
        args = [xs.requires_grad_(), gx.requires_grad_(), w_h.requires_grad_(), h0]
        with torch.enable_grad():
            outs = twa.twa_scan_ref(*args)
        torch.autograd.grad(outs, args[:3], grads_out)

    recompute_ms = cuda_ms(recompute, 5)
    k1_fwd_ms = cuda_ms(lambda: twa.twa_scan(xs.detach(), gx.detach(), w_h.detach(), h0), 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps[torch.bfloat16](x, g, o, zero, y)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # device events, without the annotations (the optimizer's step) that
    # repeat the time of the kernels launched inside them
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events if e not in annotations) / 1e3
    k1_dev = sum(e.self_device_time_total for e in events if "twa_clip_kernel" in e.key) / 1e3
    adam = sum(e.self_device_time_total for e in annotations if "Optimizer.step" in e.key) / 1e3
    bf16_ms = float(np.median(windows[torch.bfloat16]))
    vjp_bound = k1_vjp_bound(shape, 2, PEAK_BF16_FLOPS)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_train.txt"), "w") as f:
        f.write(table)
    print(f"profile of one bf16 train step: build/chip_smoke_profile_train.txt; device time "
          f"{total:.3f} ms ({total / bf16_ms:.1%} of the step's median), Adam's step "
          f"{adam:.3f} ms, K1 (twa_clip_kernel) {k1_dev:.3f} ms ({k1_dev / total:.1%}); K1's "
          f"forward alone {k1_fwd_ms:.3f} ms, the TWA backward's recompute through twa_scan_ref "
          f"alone (bf16, {shape}) {recompute_ms:.3f} ms (bound {vjp_bound[0]:.4f} ms, "
          f"{vjp_bound[1]}), {recompute_ms / bf16_ms:.1%} of the bf16 step's {bf16_ms:.3f} ms")
    return launches


# ---------------------------------------------------------------------------
# 5d. The rest of training at full width: two videos a step, remat, resume

LOCKSTEP_V = 2      # videos a step (`videos_per_step`)
LOCKSTEP_CPU_S = 5  # frames a video in the card-vs-CPU check (batch_size 1)
# remat against the plain step on the card: the forward is computed once
# either way, so loss, state and BN stats are held as K1 against the plain
# scan is (TOL_TRAIN_K1_*); the gradient, whose backward runs on recomputed
# activations, as the JAX package's remat test holds it
# (tests/test_mixed_precision.py: relative L2 over the whole gradient)
TOL_REMAT_GRAD = 2e-2
REMAT_PEAK = 1.05   # remat's peak memory in a step at most this times the plain step's
# K1 against the plain scan in the f32 V=2 step: the gradient sums twice the
# frames through the same backward; an H100 read 2.0e-4 (V=1: 7.5e-5, held
# to TOL_TRAIN_K1_GRAD), the rest of the V=1 readings' size
TOL_LOCKSTEP_K1_GRAD = 5e-4
LOCKSTEP_VIDEOS = (20, 10, 15)  # frames of the trainer's in-memory train videos
# resumed against uninterrupted on the card, 8 train steps at lr 1e-4: each
# Adam step moves a coordinate by about lr, and one whose gradient sits at
# the noise level of the card's non-deterministic backward may step the
# other way, so parameters within 2 lr a step (and their f32 rounding), BN
# stats within TOL_TRAIN_BN of their scale a step, the epoch means within
# TOL_TRAIN_LOSS; Adam's second moments (an average over all steps, which a
# resume that lost them would restart: about half their size after 4 of 8
# steps) within 1e-3 relative L2
TOL_RESUME_NU = 1e-3


def lockstep_batch(torch, rng, s, valid):
    """Two videos of s frames as one lock-step batch: uint8 (2, s, 360, 640,
    3) and ground truth (2, s, 45, 80, 3) [map, fixations, mask]; video 1
    has `valid` real frames and the rest repeats its last one with the
    mask 0, as the trainer pads a ragged clip."""
    frames, gaze = zip(*(train_video(rng, s) for _ in range(LOCKSTEP_V)))
    x, y = np.stack(frames), np.stack(gaze)
    mask = np.ones(y.shape[:-1] + (1,), np.float32)
    x[1, valid:], y[1, valid:], mask[1, valid:] = x[1, valid - 1], y[1, valid - 1], 0.0
    return torch.from_numpy(x), torch.from_numpy(np.concatenate([y, mask], -1))


def lockstep_phase(torch, kernels, twa):
    """The rest of training at 360x640 on seeded `init_model` weights, TF32
    off, the trainer's masked loss: (1) one f32 step at V=2 (S=5 a video)
    on the card against the CPU; (2) the bf16 mixed and f32 steps at V=2,
    S=10 (video 1 a padded ragged clip) with K1 against the plain scan,
    their launches exact, and the f32 eval step's; (3) the same steps with
    remat against the plain ones, launches exact (K1's forward runs again
    in the backward); (4) ms per step in turns with V=1, frames/s, peak
    memory, remat on and off; (5) `Trainer(videos=..., videos_per_step=2)`
    over 3 videos of unequal length, 2 epochs, against 1 epoch and a
    resumed second, its `_final.ckpt` served back. Returns the launches of
    each path."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
    from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step
    from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint
    from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (_maybe_normalize,
                                                             create_train_state, make_eval_step,
                                                             make_train_step)
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer, _masked_loss

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(SEED + 15)  # its own: the other phases' draws stay as they were
    start = init_model(UAVSal(), torch.Generator().manual_seed(SEED)).state_dict()
    gauss = torch.from_numpy(get_gauss_priors(OUT_H, OUT_W, 8))
    ob = torch.from_numpy(rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32))
    masked = _masked_loss(loss_fu)
    carried = torch.from_numpy(rng.normal(0.0, 0.5, (LOCKSTEP_V, OUT_H, OUT_W, 256))
                               .astype(np.float32))
    launches = {}

    # (1) the card against the port on the CPU, f32
    small = (*lockstep_batch(torch, rng, LOCKSTEP_CPU_S, LOCKSTEP_CPU_S), gauss, ob, carried)
    t0 = time.perf_counter()
    on_cpu = one_train_step(torch, kernels, start, small, cpu, loss_fn=masked)
    cpu_s = time.perf_counter() - t0
    on_card = one_train_step(torch, kernels, start, small, cuda, loss_fn=masked)
    print(f"V=2 train step f32 (S={LOCKSTEP_CPU_S} a video) on the CPU took {cpu_s:.1f} s")
    held_train(f"V=2 train step f32 (S={LOCKSTEP_CPU_S} a video), card vs CPU",
               train_diffs(on_cpu, on_card), TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_GRAD_LEAF,
               TOL_TRAIN_BN, TOL_TRAIN_STATE)
    del on_cpu, on_card, small

    # (2) K1 against the plain scan and (3) remat against plain, V=2, S=10
    batch = (*lockstep_batch(torch, rng, TRAIN_S, TRAIN_S // 2), gauss, ob, carried)
    want = {"bf16": {"twa_scan": 1, "twa_step": 0, "dwblock": 0},
            "f32": {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}}
    for dtype, tols in ((torch.bfloat16, (TOL_TRAIN_BF16_LOSS, TOL_TRAIN_BF16_GRAD, None,
                                          TOL_TRAIN_BF16_BN, TOL_TRAIN_BF16_STATE)),
                        (None, (TOL_TRAIN_K1_LOSS, TOL_LOCKSTEP_K1_GRAD, TOL_TRAIN_K1_LEAF,
                                TOL_TRAIN_K1_BN, TOL_TRAIN_K1_STATE))):
        name = "bf16" if dtype else "f32"
        label = "bf16 mixed" if dtype else "f32"
        k1 = one_train_step(torch, kernels, start, batch, cuda, dtype, loss_fn=masked)
        plain = one_train_step(torch, kernels, start, batch, cuda, dtype, scan=twa.twa_scan_ref,
                               loss_fn=masked)
        if k1[4] != want[name] or any(plain[4].values()):
            fail(f"V=2 train step {label}: K1 path launched {k1[4]} (expected {want[name]}), "
                 f"plain path {plain[4]} (expected none)")
        held_train(f"V=2 train step {label}, K1 vs the plain scan", train_diffs(plain, k1), *tols)
        del plain
        rematted = one_train_step(torch, kernels, start, batch, cuda, dtype, loss_fn=masked,
                                  remat=True)
        twice = {k: 2 * n for k, n in want[name].items()}
        print(f"V=2 train step {label}: launches {k1[4]}, with remat {rematted[4]}")
        if rematted[4] != twice:
            fail(f"V=2 train step {label} with remat launched {rematted[4]}, expected {twice}")
        d = train_diffs(k1, rematted)
        held_train(f"V=2 train step {label}, remat vs plain", d, TOL_TRAIN_K1_LOSS, TOL_REMAT_GRAD,
                   None, TOL_TRAIN_K1_BN, TOL_TRAIN_K1_STATE)
        launches[f"V=2 train step, {name}"] = k1[4]
        launches[f"V=2 remat train step, {name}"] = rematted[4]
        del k1, rematted
    model = train_model(torch, start, cuda)
    x2, y2, g, o, state2 = (t.to(cuda) for t in batch)
    kernels.reset_launches()
    make_eval_step(model, masked)(x2, g, o, state2, y2)
    torch.cuda.synchronize()
    launches["V=2 eval step, f32"] = dict(kernels.launches)
    print(f"V=2 eval step f32: launches {launches['V=2 eval step, f32']}")
    if launches["V=2 eval step, f32"] != want["f32"]:
        fail(f"the V=2 eval step launched {launches['V=2 eval step, f32']}, expected "
             f"{want['f32']}")
    del model

    # (4) ms per step in turns, frames/s, peak memory
    paths = {}
    for dtype in (None, torch.bfloat16):
        for v, remat in ((1, False), (2, False), (2, True)):
            model = train_model(torch, start, cuda)
            step = make_train_step(create_train_state(model, make_optimizer(model, TRAIN_LR,
                                                                            TRAIN_WD)),
                                   masked, dtype, remat=remat)
            zero = model.init_state(IN_H, IN_W, v, device=cuda)
            paths[dtype, v, remat] = (lambda step=step, zero=zero, v=v:
                                      step(x2[:v], g, o, zero, y2[:v]))
    windows = {key: [] for key in paths}
    for dtype in (None, torch.bfloat16):
        order = [(dtype, 1, False), (dtype, 2, False), (dtype, 2, True)]
        for key in order + order[::-1]:
            windows[key] += cuda_windows(paths[key], 2)
    peaks = {}
    for key, fn in paths.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[key] = (before, torch.cuda.max_memory_allocated())
    for (dtype, v, remat), ws in windows.items():
        ms = float(np.median(ws))
        before, peak = peaks[dtype, v, remat]
        print(f"train step {'bf16 mixed' if dtype else 'f32'} V={v}{' remat' if remat else ''} "
              f"(S={TRAIN_S} a video, 360x640): median {ms:.3f} ms over {len(ws)} windows of 2 "
              f"steps (turns V=1, V=2, V=2 remat and back), fastest {min(ws):.3f}; "
              f"{v * TRAIN_S / ms * 1e3:.1f} training frames/s; peak {peak / 2**30:.3f} GiB, "
              f"{(peak - before) / 2**30:.3f} GiB above the {before / 2**30:.3f} allocated "
              "before the step")
    for dtype in (None, torch.bfloat16):
        (b0, p0), (b1, p1) = peaks[dtype, 2, False], peaks[dtype, 2, True]
        ratio = (p1 - b1) / (p0 - b0)
        print(f"remat's peak in a V=2 {'bf16 mixed' if dtype else 'f32'} step: {ratio:.3f} of "
              f"the plain step's (above what lay allocated; limit {REMAT_PEAK})")
        if ratio > REMAT_PEAK:
            fail(f"remat raised the step's peak memory to {ratio:.3f} of the plain step's")
    del paths, model, step

    # (5) the trainer in lock-step over in-memory videos: 2 epochs, and 1
    # epoch then a resumed second
    save_dir = os.path.join(HERE, "build", "chip_smoke_lockstep")
    shutil.rmtree(save_dir, ignore_errors=True)
    videos = {"train": [array_video(f"train{n}", *train_video(rng, n)) for n in LOCKSTEP_VIDEOS],
              "val": [array_video("val", *train_video(rng, TRAIN_S))]}

    def trainer(root, **kw):
        cfg = TrainConfig(method_name="Lockstep", iosize=(IN_H, IN_W, OUT_H, OUT_W),
                          videos_per_step=LOCKSTEP_V, **{"epochs": 2, **kw})
        return Trainer(cfg, "", "synthetic", os.path.join(save_dir, root), device="cuda",
                       ob_prior=ob.numpy(), videos=videos)

    t0 = time.perf_counter()
    whole = trainer("whole")
    whole.train()
    whole_s = time.perf_counter() - t0
    trainer("split", epochs=1).train()
    resumed = trainer("split", resume=True)
    resumed.train()
    dirs = {k: os.path.join(save_dir, k, "Lockstep") for k in ("whole", "split")}
    files = {k: sorted(f for f in os.listdir(d) if f.endswith(".ckpt")) for k, d in dirs.items()}
    steps = (whole.state.step, resumed.state.step)
    if steps != (8, 8) or [f[:11] for f in files["whole"]] != [f[:11] for f in files["split"]]:
        fail(f"lock-step trainer: steps {steps} (expected 8 each), checkpoints {files}")
    logged = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            logged[k] = [json.loads(line) for line in f]
    means = {k: [r["value"] for r in rows if r["tag"].endswith("mean_loss")]
             for k, rows in logged.items()}
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(means["whole"], means["split"]))
    ckpts = {k: load_checkpoint(os.path.join(d, [f for f in files[k] if f.startswith(
        "Lockstep_01_")][0])) for k, d in dirs.items()}
    opt = {k: c["opt_state"]["inner_states"]["train"]["inner_state"]["1"] for k, c in ckpts.items()}
    nu = {k: np.concatenate([a.ravel() for a in _leaves(o["nu"])]) for k, o in opt.items()}
    nu_err = np.linalg.norm(nu["split"] - nu["whole"]) / np.linalg.norm(nu["whole"])
    sw, sr = whole.model.state_dict(), resumed.model.state_dict()
    bitwise = all(torch.equal(sw[k], sr[k]) for k in sw)
    lr = whole.cfg.learning_rate
    worst_p = max(((sr[k] - sw[k]).abs().max().item()
                   - 2 * np.spacing(np.float32(sw[k].abs().max().item()))) / (2 * lr * 8)
                  for k in sw if "running" not in k)
    bufs = {k: v.double().cpu() for k, v in sw.items() if "running" in k}
    worst_bn = max((sr[k].double().cpu() - bufs[k]).abs().max().item() / bn_scale(bufs, k)
                   for k in bufs) / (8 * TOL_TRAIN_BN)
    print(f"lock-step trainer: 2 epochs of {steps[0] // 2} train steps over videos of "
          f"{LOCKSTEP_VIDEOS} frames and 1 val step in {whole_s:.1f} s; epoch means "
          f"{[round(v, 4) for v in means['whole']]}; 1 epoch then a resumed second: checkpoints "
          f"{files['split']}, the same; weights bit for bit equal: {bitwise}; epoch means "
          f"{loss_err:.3g} apart (tolerance {TOL_TRAIN_LOSS}), parameters at {worst_p:.3g} and BN "
          f"stats at {worst_bn:.3g} of their bounds, Adam's second moments {nu_err:.3g} (relative "
          f"L2, tolerance {TOL_RESUME_NU}); opt_state in optax's layout, count "
          f"{opt['split']['count']!r}")
    if not (loss_err <= TOL_TRAIN_LOSS and worst_p <= 1.0 and worst_bn <= 1.0
            and nu_err <= TOL_RESUME_NU and int(opt["split"]["count"]) == 8
            and opt["split"]["count"].dtype == np.int32):
        fail("the resumed lock-step run is not the uninterrupted one")
    final = os.path.join(dirs["whole"], "Lockstep_final.ckpt")
    served = load_model_for_inference(final, fold_bn=False, device="cuda")
    serve = make_baked_infer_step(served, gauss.numpy(), ob.numpy())
    x = torch.from_numpy(videos["val"][0][1][None]).to(cuda)
    zero = served.init_state(IN_H, IN_W, device=cuda)
    maps, _ = serve(x, zero)
    whole.model.eval()
    with torch.no_grad():
        mine, _ = whole.model(_maybe_normalize(x), g, o, zero)
    print(f"lock-step trainer: {final} served: maps {tuple(maps.shape)} equal to the trained "
          f"model's in eval mode: {torch.equal(maps, mine)}")
    if not torch.equal(maps, mine) or not torch.isfinite(maps).all():
        fail("the served lock-step _final.ckpt does not give the trained model's maps")
    print(f"phase 5d (two videos a step, remat, resume) took {time.perf_counter() - t_phase:.1f} s")
    return launches


# the recipe (phase 5c): SALICON's size (`img_iosize`, the reference's
# dataset.py), the CLI's batch, the synthetic dataset's counts
RECIPE_IO = (480, 640, 60, 80)
RECIPE_BATCH = 2
RECIPE_TRAIN, RECIPE_VAL = 8, 4
RECIPE_PREDICT = 8  # images served by `predict_images` at once (`test_images`' default)
RECIPE_STEPS = 3    # video train steps from the transplanted neck, per dtype


def salicon_arrays(rng, n):
    """n synthetic SALICON examples at `RECIPE_IO`: uint8 images (n, 480,
    640, 3) with a bright disk over a noisy gradient, and targets (n, 60,
    80, 2) f32: 3 fixations (one on the disk) and their blurred map, peak 1."""
    in_h, in_w, out_h, out_w = RECIPE_IO
    images = np.empty((n, in_h, in_w, 3), np.uint8)
    targets = np.zeros((n, out_h, out_w, 2), np.float32)
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    for i in range(n):
        images[i] = synthetic_video(rng, 1, in_h, in_w)[0]
        points = [(int(rng.integers(out_h)), int(rng.integers(out_w))) for _ in range(3)]
        blur = np.zeros((out_h, out_w))
        for py, px in points:
            targets[i, py, px, 1] = 1.0
            blur += np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * 3.0 ** 2))
        targets[i, :, :, 0] = blur / blur.max()
    return images, targets


def image_train_step(torch, kernels, start, x, y, device):
    """One image train step (Adam, nothing frozen) from the weights `start`:
    (loss, {name: gradient}, {name: buffer after}, a placeholder state, the
    launches, {name: parameter after}), all on the host in f64."""
    from iip_uavsal_saliency_tpu_torch.models.srfnet_image import SRFNetImage
    from iip_uavsal_saliency_tpu_torch.ops.layers import to_channels_last
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                             make_image_train_step)

    model = SRFNetImage()
    model.load_state_dict(start, strict=True)
    to_channels_last(model, device)
    step = make_image_train_step(create_train_state(
        model, make_optimizer(model, TRAIN_LR, TRAIN_WD)))
    kernels.reset_launches()
    loss = step(x.to(device), y.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    bufs = {n: b.detach().double().cpu() for n, b in model.named_buffers()}
    params = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    return float(loss), grads, bufs, torch.zeros(1, dtype=torch.float64), launches, params


def recipe_phase(torch, kernels):
    """5c. The reference's three-stage recipe on the card, on synthetic
    SALICON arrays at 480x640 (the machine has no cv2: the array entry of
    `data/images.py`) and seeded `init_model` weights: (1) one f32 image
    train step on the card against the CPU (TF32 off), at full size;
    (2) `train_salicon` over 2 epochs, its `_final.ckpt` read back; (3) the
    image train step and `predict_images` timed; (4) `predict_images` on the
    card against the CPU; (5) the trained neck transplanted into the
    flagship video `Trainer` at 360x640, S=10: a bf16 mixed epoch of
    `RECIPE_STEPS` steps and its val clip (the trainer's loop, which writes
    `_final.ckpt`) and `RECIPE_STEPS` f32 steps, K1's and K2's launches
    exact, the neck's parameters the image checkpoint's bits; (6) the
    video `_final.ckpt` served through `load_model_for_inference` and the
    graphed bf16 step over 3 carried clips of S=20. Returns the launches of
    each path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, table_of
    from iip_uavsal_saliency_tpu_torch.models.srfnet_image import (SRFNetImage,
                                                                   is_image_stage_variables)
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
    from iip_uavsal_saliency_tpu_torch.runners.infer import (load_model_for_inference,
                                                             predict_videos)
    from iip_uavsal_saliency_tpu_torch.runners.infer_images import (load_image_model,
                                                                    predict_images)
    from iip_uavsal_saliency_tpu_torch.serving.steps import graph_step, make_baked_infer_step
    from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint
    from iip_uavsal_saliency_tpu_torch.training.image_trainer import (ImageTrainConfig,
                                                                      train_salicon)
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(SEED + 14)  # its own: the other phases' draws stay as they were
    in_h, in_w = RECIPE_IO[:2]
    images, targets = salicon_arrays(rng, RECIPE_TRAIN + RECIPE_VAL)
    start = init_model(SRFNetImage(), torch.Generator().manual_seed(SEED)).state_dict()
    zero = {"twa_scan": 0, "twa_step": 0, "dwblock": 0}
    launches = {}

    # (1) one f32 image train step, card against CPU, at 480x640
    x, y = torch.from_numpy(images[:RECIPE_BATCH]), torch.from_numpy(targets[:RECIPE_BATCH])
    t0 = time.perf_counter()
    on_cpu = image_train_step(torch, kernels, start, x, y, cpu)
    cpu_s = time.perf_counter() - t0
    on_card = image_train_step(torch, kernels, start, x, y, cuda)
    print(f"recipe: image train step f32 ({RECIPE_BATCH}x{in_h}x{in_w}) on the CPU took "
          f"{cpu_s:.1f} s; loss CPU {on_cpu[0]:.6f}, card {on_card[0]:.6f}; launches {on_card[4]}")
    held_train("recipe: image train step f32, card vs CPU", train_diffs(on_cpu[:5], on_card[:5]),
               TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
    # Adam's first step moves a coordinate by less than lr; one whose gradient
    # sits at the noise level may step the other way (tests/test_torch_train_step.py):
    # 2 lr, and the rounding of the f32 values the step lands on
    over = {n: (on_card[5][n] - on_cpu[5][n]).abs().max().item()
            - 2 * np.spacing(np.float32(on_cpu[5][n].abs().max().item()))
            for n in on_cpu[5]}
    moved = max(over.values())
    print(f"recipe: parameters after Adam, card vs CPU: max abs diff less the rounding of the "
          f"values {moved:.3g} (bound {2 * TRAIN_LR:.3g}, 2 lr)")
    if moved > 2 * TRAIN_LR or on_card[4] != zero:
        fail(f"recipe: the image step's update differs by {moved} or it launched {on_card[4]}")
    launches["image train step"] = on_card[4]
    del on_cpu, on_card

    # (2) train_salicon over 2 epochs on the arrays
    save_dir = os.path.join(HERE, "build", "chip_smoke_recipe")
    shutil.rmtree(save_dir, ignore_errors=True)
    n = RECIPE_TRAIN
    cfg = ImageTrainConfig(method_name="ChipSmoke_srfnet", iosize=RECIPE_IO,
                           batch_size=RECIPE_BATCH, epochs=2)
    t0 = time.perf_counter()
    model, variables = train_salicon(cfg, "", save_dir, device="cuda", arrays={
        "train": (images[:n], targets[:n]), "val": (images[n:], targets[n:])})
    salicon_s = time.perf_counter() - t0
    model_dir = os.path.join(save_dir, cfg.method_name)
    names = sorted(os.listdir(model_dir))
    pattern = re.compile(re.escape(cfg.method_name) + r"_\d\d_(.+)\.ckpt$")
    epochs = [float(m.group(1)) for m in map(pattern.match, names) if m]
    image_final = os.path.join(model_dir, f"{cfg.method_name}_final.ckpt")
    read = load_checkpoint(image_final) if os.path.exists(image_final) else {}
    same = is_image_stage_variables(read) and all(
        np.array_equal(a, b) for a, b in zip(_leaves(read), _leaves(variables)))
    print(f"recipe: train_salicon, 2 epochs of {n // RECIPE_BATCH} steps, in {salicon_s:.1f} s: "
          f"{names}; the final checkpoint read back as an image-stage tree equal to the "
          f"returned weights: {same}")
    if len(epochs) != 2 or not np.all(np.isfinite(epochs)) or not same:
        fail(f"recipe: train_salicon wrote {names}")

    # (3) numbers: the image train step, predict_images, peak memory
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                             make_image_train_step)

    step = make_image_train_step(create_train_state(model, make_optimizer(model)))
    xs, ys = x.to(cuda), y.to(cuda)
    train_windows = cuda_windows(lambda: step(xs, ys), 3)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(xs, ys)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    served = load_image_model(image_final, device="cuda")
    x8 = torch.from_numpy(images[:RECIPE_PREDICT]).to(cuda)
    sizes = [(in_h, in_w)] * RECIPE_PREDICT
    predict_windows = cuda_windows(lambda: predict_images(served, x8, sizes), 3)
    train_ms, predict_ms = float(np.median(train_windows)), float(np.median(predict_windows))
    print(f"recipe: image train step f32 ({RECIPE_BATCH}x{in_h}x{in_w}, uint8 on the card, TF32 "
          f"off): median {train_ms:.3f} ms over 7 windows of 3 steps, fastest "
          f"{min(train_windows):.3f}; {RECIPE_BATCH / train_ms * 1e3:.1f} images/s; memory "
          f"allocated {before / 2**30:.3f} GiB before the step, peak {peak / 2**30:.3f} GiB in it")
    print(f"recipe: eval forward + predict_images ({RECIPE_PREDICT}x{in_h}x{in_w} f32, BatchNorm "
          f"folded, maps back on the host): median {predict_ms:.3f} ms, fastest "
          f"{min(predict_windows):.3f}; {RECIPE_PREDICT / predict_ms * 1e3:.1f} images/s")
    # where a step's time goes: the card's share of it, and its top ops
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(xs, ys)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)]
    kept = [e for e in events if e not in annotations]
    device_ms = sum(e.self_device_time_total for e in kept) / 1e3
    top = sorted(kept, key=lambda e: -e.self_device_time_total)[:4]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_recipe.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"recipe: profile of one image train step (build/chip_smoke_profile_recipe.txt): "
          f"device time {device_ms:.3f} ms, {device_ms / train_ms:.1%} of the step's median; "
          "top: " + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms" for e in top))

    # (4) predict_images, card against CPU, on the same weights
    maps = predict_images(served, x8, sizes)
    cpu_maps = predict_images(load_image_model(image_final, device="cpu"),
                              images[:RECIPE_PREDICT], sizes)
    diff = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(maps, cpu_maps)]
    worst, differ = max(int(d.max()) for d in diff), sum(int((d > 0).sum()) for d in diff)
    print(f"recipe: predict_images card vs CPU: {len(maps)} maps of {maps[0].shape} uint8, max "
          f"diff {worst} level(s), {differ} of {RECIPE_PREDICT * in_h * in_w} pixels differ")
    if worst > 1 or any(m.shape != (in_h, in_w) or m.max() != 255 for m in maps):
        fail("recipe: predict_images on the card is not the CPU's within one uint8 level")
    del model, step, served

    # (5) the neck transplanted into the flagship video Trainer, 360x640, S=10
    vrng = np.random.default_rng(SEED + 15)
    frames, gaze = train_video(vrng, RECIPE_STEPS * TRAIN_S)
    val_frames, val_gaze = train_video(vrng, TRAIN_S)
    ob = vrng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)

    def array_video(name, f, gz):
        return (name, f, (gz[..., :1] * 255).astype(np.uint8), gz[..., 1:].astype(np.uint8))

    videos = {"train": [array_video("train", frames, gaze)],
              "val": [array_video("val", val_frames, val_gaze)]}
    neck = {k: v for k, v in from_jax_variables(read, table_of(SRFNetImage())).items()
            if k.startswith("sfnet.") and "running" not in k}
    for mixed in (True, False):
        name = "bf16 mixed" if mixed else "f32"
        tc = TrainConfig(method_name=f"ChipSmokeRecipe{'16' if mixed else '32'}",
                         iosize=(IN_H, IN_W, OUT_H, OUT_W), epochs=1, mixed_precision=mixed)
        trainer = Trainer(tc, "", "synthetic", save_dir, device="cuda", ob_prior=ob,
                          pre_variables=read, videos=videos)
        counts = []
        if mixed:  # the trainer's own loop: RECIPE_STEPS train clips, then the val clip in f32
            kernels.reset_launches()
            trainer.train()
            torch.cuda.synchronize()
            counts.append(dict(kernels.launches))
            want = {"twa_scan": RECIPE_STEPS, "twa_step": TRAIN_S, "dwblock": 0}
            steps = trainer.state.step
        else:
            clips = trainer._clips(*videos["train"][0][1:])
            rnn = trainer.model.init_state(IN_H, IN_W, device=cuda)
            for xc, yc in clips:
                kernels.reset_launches()
                _, rnn = trainer.train_step(torch.from_numpy(xc)[None].to(cuda), trainer.gauss,
                                            trainer.ob, rnn, torch.from_numpy(yc)[None].to(cuda))
                torch.cuda.synchronize()
                counts.append(dict(kernels.launches))
            want = {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}
            steps = trainer.state.step
        params = dict(trainer.model.named_parameters())
        kept = all(torch.equal(params[k].detach().cpu(), v) for k, v in neck.items())
        print(f"recipe: video train {name} from the image checkpoint ({IN_H}x{IN_W}, S={TRAIN_S}): "
              f"{steps} steps, launches {counts}; the transplanted neck's {len(neck)} parameters "
              f"the image checkpoint's bits after training: {kept}")
        if steps != RECIPE_STEPS or any(c != want for c in counts) or not kept:
            fail(f"recipe: video train {name} took {steps} steps, launched {counts} (expected "
                 f"{want} each), neck kept: {kept}")
        launches[f"video train {name}, " + ("epoch of 3 steps and its val clip" if mixed
                                            else "one step")] = counts[0]
        del trainer

    # (6) the trained video model served, graphed bf16, 3 carried clips of S=20
    video_final = os.path.join(save_dir, "ChipSmokeRecipe16", "ChipSmokeRecipe16_final.ckpt")
    model = load_model_for_inference(video_final, device="cuda")
    graphed = graph_step(make_baked_infer_step(model, get_gauss_priors(OUT_H, OUT_W, 8), ob,
                                               compute_dtype=torch.bfloat16))
    video = synthetic_video(vrng, S * CLIPS)
    predict_videos(graphed, model, [video[:S]], [(NATIVE_H, NATIVE_W)], batch_size=4)  # capture
    torch.cuda.synchronize()
    tally = dict(graphed.replayed)
    kept_maps = []

    def keep(xc, state):
        out, new_state = graphed(xc, state)
        kept_maps.append(out.clone())
        return out, new_state

    served_maps = predict_videos(keep, model, [video], [(NATIVE_H, NATIVE_W)], batch_size=4)[0]
    torch.cuda.synchronize()
    tally = {k: v - tally[k] for k, v in graphed.replayed.items()}
    sal = torch.cat(kept_maps)
    print(f"recipe: {video_final} served graphed in bf16, {CLIPS} carried clips of S={S}: the "
          f"replays' launches {tally}, the graph's nodes {graphed.graph_launches()}; saliency "
          f"{tuple(sal.shape)} in [{sal.min().item():.4f}, {sal.max().item():.4f}]; maps "
          f"{served_maps.shape} {served_maps.dtype}")
    if (tally != {"twa_scan": CLIPS, "twa_step": 0, "dwblock": 0} or len(kept_maps) != CLIPS
            or not torch.isfinite(sal).all() or sal.min() < 0 or sal.max() > 1
            or served_maps.shape != (NATIVE_H, NATIVE_W, 1, S * CLIPS)):
        fail("recipe: the trained video model was not served as expected")
    launches[f"served graphed bf16, {CLIPS} clips"] = tally
    print(f"phase 5c (the recipe) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _leaves(tree):
    """The array leaves of a nested dict, in key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield np.asarray(tree[k])


EVAL_H, EVAL_W = 720, 1280  # UAV2-TE's ground truth, the size users evaluate at
EVAL_FRAMES = 300
EVAL_BATCH = 32      # eval_batch_size's default
EVAL_RUNS = 3
EVAL_HOST_FRAMES = 32
# the card against the CPU: f32 sums over 518,400 pixels in other orders
TOL_EVAL = 1e-5
# the card's device path against the host path (device_auc=False): other
# draws of the negatives, means over the frames within the JAX package's
# Monte-Carlo bound (tests/test_losses_metrics.py)
TOL_EVAL_MC = 0.05


def eval_ground_truth(rng, t, h, w, empty=None):
    """(fixmap, fixpts), uint8 (h, w, 1, t) as `.mat` files hold them: 40
    fixations per frame scattered around a centre that moves over the
    frames, and their blurred map (Gaussians of sigma h/30 summed, peak
    255); frame `empty` has none."""
    fixmap = np.zeros((t, h, w), np.uint8)
    fixpts = np.zeros((t, h, w), np.uint8)
    ys, xs = np.arange(h), np.arange(w)
    two_var = 2 * (h / 30) ** 2
    for i in range(t):
        if i == empty:
            continue
        cy, cx = h * (0.5 + 0.25 * np.sin(i / 9.0)), w * (0.5 + 0.3 * np.cos(i / 13.0))
        py = np.clip(rng.normal(cy, h / 10, 40), 0, h - 1).astype(int)
        px = np.clip(rng.normal(cx, w / 10, 40), 0, w - 1).astype(int)
        fixpts[i, py, px] = 1
        blur = (np.exp(-(ys[None] - py[:, None]) ** 2 / two_var).T
                @ np.exp(-(xs[None] - px[:, None]) ** 2 / two_var))
        fixmap[i] = np.round(blur / blur.max() * 255)
    return fixmap.transpose(1, 2, 0)[:, :, None], fixpts.transpose(1, 2, 0)[:, :, None]


def fixation_pool(fixpts):
    """Per frame the normalized fixation coordinates, as
    `scorer.collect_all_fixations` pools a dataset's."""
    h, w = fixpts.shape[:2]
    pool = []
    for i in range(fixpts.shape[3]):
        fy, fx = np.where(fixpts[:, :, 0, i])
        pool.append(np.stack([fy / h, fx / w], axis=1))
    return pool


def judd_tie_bound(sal, pts):
    """Per frame, the most AUC-Judd can move between two orders of its tied
    pixels: a group of equal saliency values holding k fixations and m other
    pixels moves it by at most k*m / (n_fix * n_nonfix). (T, H, W) inputs."""
    out = []
    for s_, p_ in zip(sal, pts):
        fix = p_.ravel() > 0.5
        _, group = np.unique(s_.ravel(), return_inverse=True)
        k = np.bincount(group, weights=fix)
        m = np.bincount(group, weights=~fix)
        n = fix.sum()
        out.append((k * m).sum() / (max(n, 1) * max(fix.size - n, 1)))
    return np.asarray(out)


def eval_saliency(rng, t, h, w):
    """(t, h, w) uint8 saliency with ties: a broad blob following the
    fixations' centre, plus noise, quantized to 32 levels."""
    ys, xs = np.arange(h)[:, None] / h, np.arange(w)[None, :] / w
    noise = rng.uniform(0.0, 0.4, (4, h, w)).astype(np.float32)
    sal = np.empty((t, h, w), np.uint8)
    for i in range(t):
        cy, cx = 0.5 + 0.25 * np.sin(i / 9.0), 0.5 + 0.3 * np.cos(i / 13.0)
        blob = (np.exp(-((ys - cy) / 0.25) ** 2) * np.exp(-((xs - cx) / 0.25) ** 2)).astype(
            np.float32)
        sal[i] = np.floor((blob + noise[i % 4]) / 1.4 * 31.999) * 8
    return sal


def eval_phase(torch, maps):
    """6. Evaluation on the card. (1) The uint8 maps of phase 3's graphed
    K2-off run (3 clips of 20 frames at 540x960) against seeded synthetic
    ground truth, all seven metrics, `_score_video` on the card and on the
    CPU from one seed: the RandomState ends equal, KLD, CC, NSS, SIM,
    AUC-Borji and AUC-shuffled agree within TOL_EVAL on every valid frame,
    the jittered AUC-Judd within the most a tie order can move it, the
    frame without fixations is an all-NaN row in both; then the host path
    (device_auc=False), its AUC means within TOL_EVAL_MC. (2) Times at
    720x1280 (UAV2-TE) over 300 frames of tied uint8 saliency in batches
    of 32: frames/s (median of 3 runs, host clock ending on the returned
    array), the device time of one batch by part (CUDA events), the card's
    busy share over one run under the profiler, peak memory, the host's
    sampling per batch alone, and frames/s of the host path over 32
    frames. (3) `device_dispatch_ms` and the image drivers' choice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.evaluation import scorer
    from iip_uavsal_saliency_tpu_torch.evaluation.metrics_torch import (eval_auc_judd,
                                                                        eval_auc_sweep)

    keys = scorer.KEYS_ORDER
    judd = keys.index("AUC_Judd")
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED + 10)

    # (1) the main path's maps, the card against the CPU and the host path
    t = maps.shape[3]
    empty = 7
    fixmap, fixpts = eval_ground_truth(rng, t, NATIVE_H, NATIVE_W, empty=empty)
    pool = fixation_pool(fixpts)
    runs = {}
    for name, device, device_auc in (("card", cuda, True), ("cpu", "cpu", True),
                                     ("host path", cuda, False)):
        state = np.random.RandomState(SEED)
        t0 = time.perf_counter()
        runs[name] = (scorer._score_video(maps, fixmap, fixpts, pool, keys, EVAL_BATCH, state,
                                          device_auc=device_auc, device=device), state)
        print(f"eval of the main path's maps ({t} frames, {NATIVE_H}x{NATIVE_W}), {name}: "
              f"{time.perf_counter() - t0:.2f} s")
    (card, card_rng), (cpu, cpu_rng), (host, _) = runs["card"], runs["cpu"], runs["host path"]
    same_rng = all(np.array_equal(a, b) for a, b in zip(card_rng.get_state(), cpu_rng.get_state()))
    nan_rows = np.isnan(card).all(axis=1)
    valid = ~np.isnan(card).any(axis=1)
    other = [k for k in range(len(keys)) if k != judd]
    err = np.abs(card[valid][:, other] - cpu[valid][:, other]).max(axis=0)
    bound = judd_tie_bound(maps[:, :, 0, :].transpose(2, 0, 1), fixpts[:, :, 0, :].transpose(2, 0, 1))
    judd_err = np.abs(card[valid, judd] - cpu[valid, judd])
    print("eval, card vs CPU per valid frame: max abs error "
          + ", ".join(f"{keys[k]} {e:.3g}" for k, e in zip(other, err))
          + f" (tolerance {TOL_EVAL}); AUC_Judd (jittered) {judd_err.max():.3g}, its tie bound "
          f"{bound[valid].min():.3g} to {bound[valid].max():.3g} per frame; RandomState equal: "
          f"{same_rng}; NaN rows {np.flatnonzero(nan_rows).tolist()} (CPU "
          f"{np.flatnonzero(np.isnan(cpu).all(axis=1)).tolist()})")
    if not (same_rng and valid.sum() == t - 1 and nan_rows[empty] and nan_rows.sum() == 1
            and np.array_equal(np.isnan(card), np.isnan(cpu)) and np.isfinite(card[valid]).all()
            and (err <= TOL_EVAL).all() and (judd_err <= bound[valid] + 1e-6).all()):
        fail("evaluation on the card disagrees with the CPU")
    means = {name: np.nanmean(scores, axis=0) for name, scores in (("card", card), ("host", host))}
    print("eval means, card (device_auc) / host path: " + ", ".join(
        f"{key} {means['card'][k]:.4f} / {means['host'][k]:.4f}" for k, key in enumerate(keys)))
    for key in ("AUC_Borji", "AUC_shuffled", "AUC_Judd"):
        k = keys.index(key)
        if not abs(means["card"][k] - means["host"][k]) <= TOL_EVAL_MC:
            fail(f"eval: {key} mean on the card {means['card'][k]} vs the host path "
                 f"{means['host'][k]}")

    # (2) times at 720x1280
    t0 = time.perf_counter()
    sal = eval_saliency(rng, EVAL_FRAMES, EVAL_H, EVAL_W)
    gmap, gpts = eval_ground_truth(rng, EVAL_FRAMES, EVAL_H, EVAL_W)
    pool = fixation_pool(gpts[:, :, :, :60])
    gmap = np.ascontiguousarray(gmap[:, :, 0].transpose(2, 0, 1))
    gpts = np.ascontiguousarray(gpts[:, :, 0].transpose(2, 0, 1))
    print(f"eval at {EVAL_H}x{EVAL_W}: {EVAL_FRAMES} frames made in "
          f"{time.perf_counter() - t0:.1f} s; saliency has {len(np.unique(sal[0]))} levels")

    def score(n, device_auc=True, device=cuda):
        return scorer._score_video(None, None, None, pool, keys, EVAL_BATCH,
                                   np.random.RandomState(SEED), device_auc=device_auc,
                                   prepped=(sal[:n], gmap[:n], gpts[:n], n), device=device)

    score(2 * EVAL_BATCH)  # warm-up
    secs = []
    for _ in range(EVAL_RUNS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = score(EVAL_FRAMES)
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (EVAL_FRAMES, len(keys)) or not np.isfinite(out).all():
        fail(f"eval at {EVAL_H}x{EVAL_W}: scores of shape {out.shape} are not all finite")
    print(f"eval at {EVAL_H}x{EVAL_W}, device_auc, batch {EVAL_BATCH}: "
          + ", ".join(f"{EVAL_FRAMES / x:.1f}" for x in secs)
          + f" frames/s over {EVAL_FRAMES} frames; median {EVAL_FRAMES / np.median(secs):.1f}; "
          f"peak memory {peak / 2**30:.3f} GiB; means "
          + ", ".join(f"{key} {v:.4f}" for key, v in zip(keys, out.mean(axis=0))))

    # one batch on the card: device time by part
    b = slice(0, EVAL_BATCH)
    p = torch.from_numpy(sal[b]).to(cuda).float()[..., None]
    tr = torch.stack([torch.from_numpy(g[b]).to(cuda).float() for g in (gmap, gpts)], dim=-1)
    draws = np.random.RandomState(SEED)
    borji = [torch.from_numpy(a).to(cuda)
             for a in scorer._borji_neg_idx(gpts[b], EVAL_H * EVAL_W, 100, draws)]
    inds = [np.flatnonzero(scorer.sample_shufmap(pool, size=(EVAL_H, EVAL_W), rng=draws))
            for _ in range(EVAL_BATCH)]
    shuf = [torch.from_numpy(a).to(cuda)
            for a in scorer._shuffled_neg_idx(gpts[b], inds, 100, draws)]
    gen = torch.Generator(device=cuda)
    parts = {
        "the five device metrics": lambda: scorer._device_metrics(p, tr, gen.manual_seed(1)),
        "AUC-Judd (jitter, sort, gather, cumsum)": lambda: eval_auc_judd(
            p, tr, generator=gen.manual_seed(1)),
        "AUC-Borji sweep": lambda: eval_auc_sweep(p, tr, *borji),
        "AUC-shuffled sweep": lambda: eval_auc_sweep(p, tr, *shuf),
    }
    part_ms = {name: cuda_ms(fn, 5) for name, fn in parts.items()}
    batch_ms = part_ms["the five device metrics"] + part_ms["AUC-Borji sweep"] + part_ms[
        "AUC-shuffled sweep"]
    print(f"eval, one batch of {EVAL_BATCH} at {EVAL_H}x{EVAL_W} on the card (CUDA events): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in part_ms.items())
          + f"; the batch {batch_ms:.3f} ms ({EVAL_BATCH / batch_ms * 1e3:.1f} frames/s of "
          f"device work)")

    # the host's own work per batch: the draws, and shipping (pinned copies)
    draws = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    scorer._borji_neg_idx(gpts[b], EVAL_H * EVAL_W, 100, draws)
    t1 = time.perf_counter()
    inds = [np.flatnonzero(scorer.sample_shufmap(pool, size=(EVAL_H, EVAL_W), rng=draws))
            for _ in range(EVAL_BATCH)]
    scorer._shuffled_neg_idx(gpts[b], inds, 100, draws)
    t2 = time.perf_counter()
    for a in (sal[b], gmap[b], gpts[b]):
        scorer._to_device(a, cuda)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"eval, the host's work per batch of {EVAL_BATCH}: Borji draws {(t1 - t0) * 1e3:.3f} ms, "
          f"{EVAL_BATCH} shufmaps and their draws {(t2 - t1) * 1e3:.3f} ms, pinning and copying "
          f"the batch {(t3 - t2) * 1e3:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score(EVAL_FRAMES)
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    copies = sum(e.self_device_time_total for e in device if "Memcpy" in e.key) / 1e3
    busy = sum(e.self_device_time_total for e in device) / 1e3
    print(f"eval under the profiler, {EVAL_FRAMES} frames: wall {wall:.3f} ms, the card busy "
          f"{busy:.3f} ms ({busy / wall:.1%}; kernels {busy - copies:.3f} ms, copies "
          f"{copies:.3f} ms), idle {1 - busy / wall:.1%}")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_eval.txt"), "w") as f:
        f.write(table)

    t0 = time.perf_counter()
    host_out = score(EVAL_HOST_FRAMES, device_auc=False)
    host_s = time.perf_counter() - t0
    if not np.isfinite(host_out).all():
        fail("eval, host path: scores are not all finite")
    print(f"eval at {EVAL_H}x{EVAL_W}, host path (device_auc=False), {EVAL_HOST_FRAMES} frames: "
          f"{EVAL_HOST_FRAMES / host_s:.2f} frames/s ({host_s:.2f} s)")

    # (3) the image drivers' choice on this card
    ms = scorer.device_dispatch_ms(cuda)
    print(f"eval, device_dispatch_ms on the card {ms:.4f} ms; _resolve_img_device_auc(None) "
          f"picks the {'device-batched' if scorer._resolve_img_device_auc(None, cuda) else 'host'}"
          f" path")


# 4b. the released-weights flow (`cli convert` -> `export_serving` ->
# `ExportedServing`): the three artifacts, by (compute dtype, fused dwBlock)
DEPLOY_PATHS = {"bf16 K2 off": ("bf16", False), "bf16 K2 on": ("bf16", True),
                "f32 K2 off": ("f32", False)}
LATENCY_N = 200  # dispatches timed per path, in two turns of half each
LATENCY_WARMUP = 10


def _keyed_leaves(tree, prefix=()):
    """(path, array) of each leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _keyed_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def reference_pth(torch, weights, path):
    """`weights` written as the reference's released `.pth` holds them: a
    state_dict with BatchNorm's `num_batches_tracked` beside every running
    mean and torchvision's unused last MobileNetV2 conv and BatchNorm
    (`sfnet.features.features.18.*`), which the port's model has not and
    `cli convert` must leave out. Nothing is drawn from a generator."""
    sd = dict(weights)
    for key in weights:
        if key.endswith("running_mean"):
            sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    extra = "sfnet.features.features.18."
    sd[extra + "0.weight"] = torch.full((1280, 320, 1, 1), 0.01)
    for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
        sd[extra + "1." + name] = torch.full((1280,), value)
    sd[extra + "1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, path)


def deploy_phase(torch, kernels, weights, variables, gauss, ob, video, native, live):
    """4b. The reference's released-weights flow on the card: the seeded
    flagship's weights written as a reference `.pth` (`reference_pth`),
    `cli.main(["convert", ...])` to a `.ckpt` (its leaves `variables`' bits:
    `weights` is their state_dict),
    and `export_serving` of the converted checkpoint three times (bf16 with
    K2 off and on, f32 with K2 off), each saved, loaded back with
    `ExportedServing` (export and load seconds, size) and served over 3
    carried clips, eager and graphed: the launches exactly the live paths'
    (eager from the wrappers, graphed from the graph's own nodes, the
    wrappers counting none), the saliency and state against the live baked
    step on the same weights (0 expected; held to TOL_F32 / TOL_BF16), the
    graphed replay the eager artifact's bits, and the uint8 maps through
    `predict_videos` the live path's. Then request->response latency
    (`runners/latency.py`) of the graphed live step and the graphed
    artifact, K2 off and on, in turns, bf16, V=1, S=20, and their ms per
    clip on the card (CUDA events, in turns). `live` maps a path
    of `DEPLOY_PATHS` to (eager live step, graphed live step or None, its
    uint8 maps, its launches per 3 clips). Returns the artifacts' launches
    per path."""
    from iip_uavsal_saliency_tpu_torch import cli
    from iip_uavsal_saliency_tpu_torch.runners.export import (ExportedServing, export_serving,
                                                              save_exported)
    from iip_uavsal_saliency_tpu_torch.runners.infer import (load_model_for_inference,
                                                             predict_videos)
    from iip_uavsal_saliency_tpu_torch.runners.latency import (latency_summary,
                                                               measure_dispatch_latency)
    from iip_uavsal_saliency_tpu_torch.serving.steps import graph_step
    from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "deploy")
    os.makedirs(out_dir, exist_ok=True)
    pth, ckpt = os.path.join(out_dir, "UAVSal_seeded.pth"), os.path.join(out_dir, "seeded.ckpt")
    reference_pth(torch, weights, pth)
    t0 = time.perf_counter()
    if cli.main(["convert", pth, ckpt]) != 0:
        fail("cli convert did not exit 0")
    convert_s = time.perf_counter() - t0
    converted = dict(_keyed_leaves(load_checkpoint(ckpt)))
    want = dict(_keyed_leaves({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]}))
    if converted.keys() != want.keys() or not all(
            np.array_equal(converted[k], want[k]) and converted[k].dtype == want[k].dtype
            for k in want):
        fail("cli convert: the .ckpt is not the seeded variables leaf for leaf")
    print(f"deploy: {os.path.getsize(pth) / 1e6:.1f} MB reference .pth "
          f"({len(torch.load(pth))} entries) -> cli convert in {convert_s:.2f} s -> "
          f"{len(converted)} leaves, the seeded variables' bits")
    clips = [torch.from_numpy(np.ascontiguousarray(video[None, k * S:(k + 1) * S])).cuda()
             for k in range(CLIPS)]
    graphed_arts, launches = {}, {}
    for name, (dtype_name, fused) in DEPLOY_PATHS.items():
        dtype = torch.bfloat16 if dtype_name == "bf16" else None
        tol = TOL_BF16 if dtype_name == "bf16" else TOL_F32
        live_step, _, live_maps, want = live[name]
        path = os.path.join(out_dir, f"{dtype_name}_k2{'on' if fused else 'off'}.aot")
        model = load_model_for_inference(ckpt, fold_bn=True, device="cuda",
                                         fused_dwblock=fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program, meta = export_serving(model, iosize=(IN_H, IN_W, OUT_H, OUT_W),
                                       batch_size=S // 5, time_dims=5, gauss=gauss, ob=ob,
                                       compute_dtype=dtype)
        save_exported(path, program, meta)
        export_s = time.perf_counter() - t0
        del program, model
        t0 = time.perf_counter()
        art = ExportedServing(path)
        load_s = time.perf_counter() - t0
        nodes = sum(1 for n in art._module.graph.nodes
                    if str(n.target).startswith("uavsal."))
        ops = sorted({str(n.target) for n in art._module.graph.nodes
                      if str(n.target).startswith("uavsal.")})
        torch.cuda.synchronize()
        kernels.reset_launches()
        state = art.init_state(IN_H, IN_W, V)
        eager = []
        for x in clips:
            out, state = art(x, state)
            eager.append((out.clone(), state.clone()))
        torch.cuda.synchronize()
        counted = dict(kernels.launches)
        if counted != want:
            fail(f"artifact {name}: launched {counted}, the live path {want}")
        live_state = art.init_state(IN_H, IN_W, V)
        sal_diff = state_diff = 0.0
        for (out, st), x in zip(eager, clips):
            ref, live_state = live_step(x, live_state)
            sal_diff = max(sal_diff, (out.float() - ref.float()).abs().max().item())
            state_diff = max(state_diff, (st.float() - live_state.float()).abs().max().item())
        if not (sal_diff <= tol and state_diff <= tol) or not all(
                torch.isfinite(o).all() for o, _ in eager):
            fail(f"artifact {name}: saliency {sal_diff}, state {state_diff} from the live "
                 f"step (tolerance {tol})")
        graphed = graph_step(art)
        graphed(clips[0], art.init_state(IN_H, IN_W, V))  # capture
        torch.cuda.synchronize()
        kernels.reset_launches()
        state, same = art.init_state(IN_H, IN_W, V), True
        for (out, st), x in zip(eager, clips):
            got, state = graphed(x, state)
            same = same and torch.equal(got, out) and torch.equal(state, st)
        torch.cuda.synchronize()
        per_clip = graphed.graph_launches()
        if not same or any(kernels.launches.values()) or per_clip != {
                k: n // CLIPS for k, n in want.items()}:
            fail(f"artifact {name}, graphed: equal to eager {same}, the wrappers counted "
                 f"{dict(kernels.launches)}, the graph's nodes {per_clip}")
        maps = predict_videos(graphed, art, [video], native, batch_size=4)[0]
        torch.cuda.synchronize()
        off = np.abs(maps.astype(np.int16) - live_maps.astype(np.int16))
        if maps.shape != live_maps.shape or off.max() > (0 if sal_diff == 0 else 1):
            fail(f"artifact {name}: uint8 maps {maps.shape} differ from the live path's "
                 f"{live_maps.shape} by up to {off.max()}")
        print(f"deploy, artifact {name}: export {export_s:.2f} s, load {load_s:.2f} s, "
              f"{os.path.getsize(path) / 1e6:.1f} MB, custom-op nodes {nodes} {ops}; "
              f"launches eager {counted}, graph nodes per clip {per_clip}; against the live "
              f"step over {CLIPS} carried clips: saliency max abs diff {sal_diff:.3g}, state "
              f"{state_diff:.3g} (tolerance {tol}); graphed equals eager: {same}; uint8 maps "
              f"{int((off > 0).sum())} pixels off the live path's (max {off.max()})")
        launches[name] = counted
        if dtype_name == "bf16":
            graphed_arts[name] = graphed
        else:
            del graphed, art, eager
    paths = {"live K2 off": live["bf16 K2 off"][1], "artifact K2 off": graphed_arts["bf16 K2 off"],
             "live K2 on": live["bf16 K2 on"][1], "artifact K2 on": graphed_arts["bf16 K2 on"]}
    zero = torch.zeros((V, OUT_H, OUT_W, 256), dtype=torch.bfloat16, device="cuda")
    times = {key: [] for key in paths}
    for key in list(paths) + list(paths)[::-1]:  # in turns
        times[key] += measure_dispatch_latency(paths[key], clips[0], zero,
                                               n=LATENCY_N // 2, warmup=LATENCY_WARMUP)
    for key, t in times.items():
        print(f"latency, {key}, graphed (bf16, V={V}, S={S}, 360x640, request -> saliency on "
              f"the host): {json.dumps(latency_summary(t, V * S))}")
    step_ms = {key: [] for key in paths}
    for key in list(paths) + list(paths)[::-1]:  # the card's time alone, in turns
        step_ms[key].append(cuda_ms(lambda: paths[key](clips[0], zero), 10))
    for key, (first, second) in step_ms.items():
        print(f"step, {key}, graphed (bf16, V={V}, S={S}, 360x640, CUDA events): {first:.3f} "
              f"and {second:.3f} ms per clip")
    print(f"deploy phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from iip_uavsal_saliency_tpu_torch import kernels
        from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
        from iip_uavsal_saliency_tpu_torch.models import recurrent
        from iip_uavsal_saliency_tpu_torch.models.adapters import ZooModelAdapter
        from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
        from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
        from iip_uavsal_saliency_tpu_torch.ops import dwblock, twa
        from iip_uavsal_saliency_tpu_torch.ops.layers import DWBlock
        from iip_uavsal_saliency_tpu_torch.runners.infer import (
            load_model_for_inference, predict_videos)
        from iip_uavsal_saliency_tpu_torch.serving.steps import graph_step, make_baked_infer_step
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    import torch.nn.functional as F

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in build_s.items()})})")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  {name}: {line.strip()}")

    # 2. kernels against their plain versions, and the gradient wrappers
    rng = np.random.default_rng(SEED)
    k1_err = check_k1(torch, kernels, twa, rng)
    k2_errs = check_k2(torch, dwblock, rng)
    check_gradients(torch, kernels, dwblock, twa, rng)

    # 3. the main paths at full width
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = random_state_dict(UAVSal(), rng)
    # the seeded network: every agreement below is on this one set of weights
    print(f"seeded weights: {len(weights)} tensors, sum |w| "
          f"{sum(t.double().abs().sum().item() for t in weights.values()):.6f}")
    variables = to_jax_variables(weights)
    gauss = get_gauss_priors(OUT_H, OUT_W, 8)
    ob = rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)
    video = synthetic_video(rng, V * S * CLIPS)
    native = [(NATIVE_H, NATIVE_W)]

    def serve(compute_dtype, fused, tree=None, config=None, priors=None):
        """A served model and its eager step: the flagship, or the UAVSal of
        `config` (keyword arguments) with the weights `tree`; `priors` are
        the (Gaussian, observed) priors at another output size."""
        config = config or {}
        bias = config.get("bias_type", (1, 1, 1))
        g, o = priors or (gauss, ob)
        model = load_model_for_inference(tree or variables, fold_bn=True, device="cuda",
                                         fused_dwblock=fused, **config)
        step = make_baked_infer_step(model, g if bias[0] else None, o if bias[1] else None,
                                     compute_dtype=compute_dtype)
        seen = []

        def spy(x, state):
            out, new_state = step(x, state)
            seen.append((out.clone(), state.float().clone(), new_state.float().clone()))
            return out, new_state

        return model, step, spy, seen

    def drive(name, model, step, spy, seen, bf16, k2_launches, video=video, native=native,
              k1=True):
        """One main path, the eager step: warm-up clip, counts to 0, the whole
        video through `predict_videos`, counts read and held to the expected
        ones exactly: K1's persistent kernel once per clip where its gate
        takes the state (bf16 at 45x80), else its per-frame kernel once per
        frame (f32; bf16 at a state too wide for the persistent kernel); a
        zoo model without ConvTWA (`k1=False`) neither, and ConvTWA is never
        called. A model with a recurrent state must change it every clip; a
        model without one carries its dummy zeros unchanged.
        Then the same path replayed from a CUDA graph (`drive_graphed`)."""
        out_h, out_w = video.shape[1] // 8, video.shape[2] // 8
        route = twa.kernel_route((V, S, out_h, out_w, getattr(model, "planes", None) or 256),
                                 torch.bfloat16 if bf16 else torch.float32) if k1 else None
        stateful = not isinstance(model, ZooModelAdapter)
        predict_videos(step, model, [video[:S]], native, batch_size=4)  # warm-up
        torch.cuda.synchronize()
        taken = []

        def recorder(*args, **kwargs):  # ConvTWA's call of K1, its arguments and results kept
            out = twa.twa_scan(*args, **kwargs)
            taken.append(([a.clone() for a in args], [o.clone() for o in out]))
            return out

        recurrent.twa_scan = recorder
        kernels.reset_launches()
        maps = predict_videos(spy, model, [video], native, batch_size=4)[0]
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        recurrent.twa_scan = twa.twa_scan
        print(f"{name}: {V * S * CLIPS} frames in {CLIPS} clips, launches {launches}")
        want = {"twa_scan": CLIPS if route == "twa_scan" else 0,
                "twa_step": S * CLIPS if route == "twa_step" else 0, "dwblock": k2_launches}
        if launches != want:
            fail(f"{name}: launched {launches}, expected {want}")
        if maps.shape != (*native[0], 1, V * S * CLIPS) or maps.dtype != np.uint8:
            fail(f"{name}: postprocessed output has shape {maps.shape} dtype {maps.dtype}")
        if len(seen) != CLIPS:
            fail(f"{name}: expected {CLIPS} serving steps, saw {len(seen)}")
        for k, (out, st_in, st_out) in enumerate(seen):
            if out.shape != (V, S, out_h, out_w, 1) or not torch.isfinite(out).all():
                fail(f"{name} clip {k}: saliency of shape {tuple(out.shape)} is not finite")
            if out.min().item() < 0 or out.max().item() > 1:
                fail(f"{name} clip {k}: saliency outside [0, 1]")
            if stateful and (not torch.isfinite(st_out).all() or torch.equal(st_in, st_out)):
                fail(f"{name} clip {k}: the carried state did not change or is not finite")
            if not stateful and (st_out.any() or not torch.equal(st_in, st_out)):
                fail(f"{name} clip {k}: the dummy state did not pass through as zeros")
        if len(taken) != (CLIPS if k1 else 0):
            fail(f"{name}: ConvTWA called K1 {len(taken)} times in {CLIPS} clips")
        if bf16 and k1:
            check_k1_served(torch, twa, name, taken)
        graphed, graphed_maps = drive_graphed(name, model, step, want, seen, maps, video, native)
        return (launches, graphed, torch.cat([o[0, :, :, :, 0] for o, _, _ in seen]).double(),
                graphed_maps)

    def drive_graphed(name, model, step, want, seen, maps, video, native):
        """The main path as a user runs it: `predict_videos` with the step
        replayed from a CUDA graph (`graph_step`), after one warm-up clip
        that captures it, under the profiler. The kernels that ran on the
        card: the graph's own kernel nodes must be the eager run's launches
        per clip, and the trace must show each of them (`kernels.
        trace_shows_graph`: the profiler drops records); the wrappers must
        count none (a replay runs without them), and the step's own tally
        must agree. Its maps must be the eager
        run's bits, and over the same 3 carried clips its saliency and
        state the eager step's bits."""
        from torch.profiler import ProfilerActivity, profile

        graphed = graph_step(step)
        predict_videos(graphed, model, [video[:S]], native, batch_size=4)  # capture
        torch.cuda.synchronize()
        kernels.reset_launches()
        tally = dict(graphed.replayed)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graphed_maps = predict_videos(graphed, model, [video], native, batch_size=4)[0]
            torch.cuda.synchronize()
        traced = kernels.traced_launches(prof)
        counted = dict(kernels.launches)
        tally = {k: n - tally[k] for k, n in graphed.replayed.items()}
        per_clip = {k: n // CLIPS for k, n in want.items()}
        nodes = graphed.graph_launches()
        if nodes != per_clip:
            fail(f"{name}, graphed: the graph's kernel nodes are {nodes}, expected {per_clip} "
                 "(the eager run's launches per clip)")
        if not kernels.trace_shows_graph(traced, nodes, CLIPS):
            fail(f"{name}, graphed: the trace of {CLIPS} replays shows {traced} kernel "
                 f"launches, expected each of {nodes} and at most {CLIPS} times as many")
        if any(counted.values()) or tally != want:
            fail(f"{name}, graphed: the wrappers counted {counted} (expected none) and the "
                 f"replays' tally is {tally} (expected {want})")
        replayed = []

        def keep(x, state):  # the replayed step's outputs, kept before the next replay
            out, new_state = graphed(x, state)
            replayed.append((out.clone(), new_state.float().clone()))
            return out, new_state

        predict_videos(keep, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        sal_diff = max((g.float() - e.float()).abs().max().item()
                       for (g, _), (e, _, _) in zip(replayed, seen))
        state_diff = max((g - e).abs().max().item() for (_, g), (_, _, e) in zip(replayed, seen))
        same_maps = np.array_equal(graphed_maps, maps)
        print(f"{name}, graphed: the graph's kernel nodes {nodes}, kernels in the trace "
              f"{traced}, the replays' tally {tally}; "
              f"against the eager step over {CLIPS} "
              f"carried clips: saliency max abs diff {sal_diff:.3g}, state max abs diff "
              f"{state_diff:.3g}; uint8 maps equal: {same_maps}")
        if len(replayed) != CLIPS or sal_diff != 0 or state_diff != 0 or not same_maps:
            fail(f"{name}: the graphed path does not give the eager step's bits")
        return graphed, graphed_maps

    def compare(name, a, b):
        cc = frame_cc(torch, a, b)
        print(f"{name}: CC per frame min {cc.min().item():.6f} mean {cc.mean().item():.6f}, "
              f"max abs diff {(a - b).abs().max().item():.3g}")
        if not cc.min().item() >= CC_MIN:
            fail(f"{name}: min CC {cc.min().item()} < {CC_MIN}")

    # the blocks K2's gate admits at these shapes, from the blocks' own facts,
    # and K2 against its plain version at each of them
    first_clip = torch.from_numpy(video[None, :S]).cuda()
    model16k, step16k, spy16k, seen16k = serve(torch.bfloat16, True)
    print("K2 bf16 at the admitted blocks of one serving step:")
    admitted, taken16k = check_k2_admitted(torch, dwblock, DWBlock, model16k, step16k,
                                           first_clip,
                                           model16k.init_state(IN_H, IN_W, V, device="cuda"))
    needed = {"st_layer.0.stconv_sp.spconv", "st_layer.1.stconv_sp.spconv", "fust_layer.0",
              "fucbst_layer.0"}
    if not needed <= {name for name, _ in admitted}:
        fail(f"the flagship blocks {sorted(needed)} are not all admitted")

    model16, step16, spy16, seen16 = serve(torch.bfloat16, False)
    launches_off, graphed16, sal16, maps16 = drive("main path, K2 off (bf16)", model16, step16,
                                                   spy16, seen16, True, 0)
    launches_on, graphed16k, sal16k, maps16k = drive("main path, K2 on (bf16)", model16k,
                                                     step16k, spy16k, seen16k, True,
                                                     len(admitted) * CLIPS)
    model32, step32, spy32, seen32 = serve(None, False)
    launches_f32, graphed32, sal32, maps32 = drive("main path, K2 off (f32)", model32, step32,
                                                   spy32, seen32, False, 0)
    model32k, step32k, spy32k, seen32k = serve(None, True)
    print("K2 f32 at the admitted blocks of one serving step:")
    admitted32, taken32k = check_k2_admitted(torch, dwblock, DWBlock, model32k, step32k,
                                             first_clip,
                                             model32k.init_state(IN_H, IN_W, V, device="cuda"))
    if admitted32 != admitted:
        fail("the gate admits other blocks in f32 than in bf16")
    launches_f32k, graphed32k, sal32k, _ = drive("main path, K2 on (f32)", model32k, step32k,
                                                 spy32k, seen32k, False, len(admitted) * CLIPS)
    del step32, step32k, spy32, spy32k
    print(f"f32 map mean {sal32.mean().item():.4g} std {sal32.std().item():.4g}")
    compare("bf16 vs f32 saliency, K2 off", sal16, sal32)
    compare("bf16 K2 on vs f32 saliency", sal16k, sal32)
    compare("bf16 K2 on vs bf16 K2 off saliency", sal16k, sal16)
    compare("f32 K2 on vs f32 K2 off saliency", sal32k, sal32)
    f32_diff = (sal32k - sal32).abs().max().item()
    if not f32_diff <= TOL_F32_PATHS:
        fail(f"f32 saliency with K2 on differs from K2 off by {f32_diff} > {TOL_F32_PATHS}")

    # 3b. the other configurations
    config_launches = configs_phase(torch, kernels, dwblock, DWBlock, serve, drive, compare,
                                    video, native, first_clip, (graphed16, model16, ob))
    # 3c. the flagship at 720x1280
    zero16 = torch.zeros((V, OUT_H, OUT_W, 256), dtype=torch.bfloat16, device="cuda")
    native_launches = native_phase(torch, kernels, twa, serve, drive, compare,
                                   (graphed16, model16, video, native, first_clip, zero16))
    config_launches[f"flagship at {NATIVE_IO[0]}x{NATIVE_IO[1]}"] = native_launches
    # 3d. the ablation zoo
    config_launches.update(zoo_phase(torch, kernels, serve, drive, compare, video, native,
                                     first_clip, (graphed16, model16, ob, step16)))

    # 4. measurements
    clip = first_clip
    state = model16.init_state(IN_H, IN_W, V, dtype=torch.bfloat16, device="cuda")
    paths = {("off", "eager"): step16, ("off", "graphed"): graphed16,
             ("on", "eager"): step16k, ("on", "graphed"): graphed16k}
    times = {key: [] for key in paths}
    for which in ("off", "on", "on", "off"):  # in turns, on one card
        for how in ("eager", "graphed"):
            step = paths[which, how]
            times[which, how].append(cuda_ms(lambda: step(clip, state), 10))
    for (which, how), (first, second) in times.items():
        print(f"serving step, K2 {which}, {how} (bf16, V={V}, S={S}, 360x640, uint8 clip on "
              f"the card): {first:.3f} and {second:.3f} ms per clip, "
              f"{V * S / first * 1e3:.1f} and {V * S / second * 1e3:.1f} FPS")
    # the f32 serving step (the parity path), graphed as users run it, K2 off
    # and on, in turns
    f32_paths, state32 = {"off": graphed32, "on": graphed32k}, state.float()
    f32_times = {which: [] for which in f32_paths}
    for which in ("off", "on", "on", "off"):
        f32_times[which].append(cuda_ms(lambda: f32_paths[which](clip, state32), 10))
    for which, (first, second) in f32_times.items():
        print(f"serving step f32, K2 {which}, graphed (V={V}, S={S}, 360x640, TF32 off): "
              f"{first:.3f} and {second:.3f} ms per clip, {V * S / first * 1e3:.1f} and "
              f"{V * S / second * 1e3:.1f} FPS")
    del f32_paths, graphed32, graphed32k, model32, model32k
    time_host_issue(torch, paths, clip, state)
    time_runner(torch, paths, {"off": model16, "on": model16k}, video, native)
    write_profile(torch, step16, clip, state, "chip_smoke_profile.txt")
    write_profile(torch, step16k, clip, state, "chip_smoke_profile_k2.txt")
    # 4b. the released-weights flow: convert, export, serve the artifacts
    live = {"bf16 K2 off": (step16, graphed16, maps16, launches_off),
            "bf16 K2 on": (step16k, graphed16k, maps16k, launches_on),
            "f32 K2 off": (serve(None, False)[1], None, maps32, launches_f32)}
    deploy_launches = deploy_phase(torch, kernels, weights, variables, gauss, ob, video, native,
                                   live)
    del live

    k1_times, k1_bound_ms, k1_bound_by = time_k1(torch, F, twa, rng, 1)
    time_k1(torch, F, twa, rng, 4)
    # the bf16 per-frame kernel at 720x1280 serving's state, on inputs of its own
    k1_native, k1_native_bound, k1_native_by = time_k1(torch, F, twa, np.random.default_rng(
        SEED + 13), 1, NATIVE_IO[2:])
    k2_ms, k2_plain_ms, k2_library_ms, k2_bound_ms, k2_bound_by = time_k2(torch, F, dwblock, rng)
    print(f"K2 bf16 at N,H,W,C,E,Co={K2_FLAGSHIP}, residual: kernel {k2_ms * 1e3:.2f} us/launch, "
          f"plain {k2_plain_ms * 1e3:.2f}, library (three cuDNN convs) {k2_library_ms * 1e3:.2f}, "
          f"bound {k2_bound_ms * 1e3:.2f} ({k2_bound_by})")
    time_k2_admitted(torch, dwblock, taken16k)
    # the f32 kernel as the f32 K2-on path launches it, on inputs of its own
    # (the main generator's draws stay as they were)
    k2_f32 = time_k2(torch, F, dwblock, np.random.default_rng(SEED + 9), torch.float32)
    fma_ms = k2_bound(*K2_FLAGSHIP, "fma")[0]
    print(f"K2 f32 at N,H,W,C,E,Co={K2_FLAGSHIP}, residual: kernel {k2_f32[0] * 1e3:.2f} us/launch, "
          f"plain {k2_f32[1] * 1e3:.2f}, library (three cuDNN convs, TF32 off) "
          f"{k2_f32[2] * 1e3:.2f}, bound {k2_f32[3] * 1e3:.2f} ({k2_f32[4]}, 3xTF32 at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; {fma_ms * 1e3:.2f} on FMA at "
          f"{PEAK_F32_FLOPS / 1e12:.0f}); kernel/library {k2_f32[0] / k2_f32[2]:.3f}; launches "
          f"on the f32 K2-on path {launches_f32k['dwblock']} per {CLIPS} clips")
    k2_f32_sums = time_k2_admitted(torch, dwblock, taken32k)
    del taken32k

    k1_f32 = time_k1_f32(torch, F, twa, rng)

    # 5. training
    train_launches = train_phase(torch, kernels, twa)
    # 5d. two videos a step, remat, resume
    lockstep_launches = lockstep_phase(torch, kernels, twa)
    config_train_launches = config_train_phase(torch, kernels)
    # 5c. the reference's three-stage recipe
    recipe_launches = recipe_phase(torch, kernels)

    # 6. evaluation
    eval_phase(torch, maps16)
    # 7. data parallelism over videos, and planes=128
    dp_launches = dp_phase(torch, kernels, twa, dwblock, DWBlock, serve, drive, compare, weights,
                           gauss, ob, first_clip, len(admitted), smi)
    # 8. the spatial axis
    spatial_launches = spatial_phase(torch, kernels, twa, weights, smi)

    def by_config(kernel):
        """The kernel's launches on each path of each configuration of phase
        3b (serving: per 3 clips or one clip; ResNet-50 training: per step),
        and under "recipe" on each path of phase 5c."""
        counts = {f"{name}, {path}": n[kernel] for name, paths in config_launches.items()
                  for path, n in paths.items()}
        counts.update({f"ResNet-50 train step, {dtype}": n[kernel]
                       for dtype, n in config_train_launches.items()})
        counts["recipe"] = {path: n[kernel] for path, n in recipe_launches.items()}
        counts["lockstep"] = {path: n[kernel] for path, n in lockstep_launches.items()}
        counts["artifact"] = {path: n[kernel] for path, n in deploy_launches.items()}
        counts["dp"] = {path: n[kernel] for path, n in dp_launches.items()
                        if not path.startswith("planes128")}
        counts["planes128"] = {path[len("planes128 "):]: n[kernel]
                               for path, n in dp_launches.items() if path.startswith("planes128")}
        counts["spatial"] = {path: n[kernel] for path, n in spatial_launches.items()}
        return counts

    print(smi)
    k1 = {"route": "cuda", "source": "iip_uavsal_saliency_tpu_torch/csrc/twa_scan.cu",
          "replaces": "iip_uavsal_saliency_tpu/ops/pallas_twa.py:147"}
    print(json.dumps({"kernels": [{
        # the persistent kernel: one launch is a clip of S frames of 1x45x80x256 bf16
        "name": "twa_scan", **k1,
        "launches": launches_off["twa_scan"],
        "max_abs_err": k1_err["twa_scan"],
        "ms": k1_times["persistent"][0],
        "plain_ms": k1_times["plain"][0],
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": k1_times["library"][0],
        "frames_per_launch": S,
        "train_step_launches": train_launches["bf16"]["twa_scan"],
        "config_launches": by_config("twa_scan"),
    }, {
        # the per-frame kernel as the f32 paths launch it: one frame of 1x45x80x256 f32
        "name": "twa_step", **k1,
        "launches": launches_f32["twa_step"],
        "max_abs_err": k1_err["twa_step"],
        "ms": k1_f32["kernel"],
        "plain_ms": k1_f32["plain"],
        "bound_ms": k1_f32["bound"],
        "bound_by": k1_f32["bound_by"],
        "bound_route": "3xTF32 at 495 TFLOP/s",
        "bound_fma_ms": k1_f32["bound_fma"],
        "library_ms": k1_f32["library"],
        "frames_per_launch": 1,
        "train_step_launches": train_launches["f32"]["twa_step"],
        "config_launches": by_config("twa_step"),
    }, {
        # the per-frame kernel as bf16 720x1280 serving launches it: one frame of 1x90x160x256
        "name": "twa_step_bf16", **k1,
        "launches": native_launches["bf16"]["twa_step"],
        "max_abs_err": k1_err["twa_step_bf16"],
        "ms": k1_native["per-frame"][0] / S,
        "plain_ms": k1_native["plain"][0] / S,
        "bound_ms": k1_native_bound / S,
        "bound_by": k1_native_by,
        "library_ms": k1_native["library"][0] / S,
        "frames_per_launch": 1,
        "train_step_launches": native_launches["bf16 mixed train step"]["twa_step"],
        "config_launches": by_config("twa_step"),
    }, {
        "name": "dwblock",
        "route": "cuda",
        "source": "iip_uavsal_saliency_tpu_torch/csrc/dwblock.cu",
        "replaces": "iip_uavsal_saliency_tpu/ops/pallas_dwblock.py:162",
        "launches": launches_on["dwblock"],
        "max_abs_err": k2_errs[torch.bfloat16],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": k2_bound_by,
        "library_ms": k2_library_ms,
        "train_step_launches": train_launches["bf16 fused"]["dwblock"],
        "config_launches": by_config("dwblock"),
    }, {
        # the same kernel source in f32 (3xTF32), as the f32 K2-on path launches it
        "name": "dwblock_f32",
        "route": "cuda",
        "source": "iip_uavsal_saliency_tpu_torch/csrc/dwblock.cu",
        "replaces": "iip_uavsal_saliency_tpu/ops/pallas_dwblock.py:162",
        "launches": launches_f32k["dwblock"],
        "max_abs_err": k2_errs[torch.float32],
        "ms": k2_f32[0],
        "plain_ms": k2_f32[1],
        "bound_ms": k2_f32[3],
        "bound_by": k2_f32[4],
        "bound_route": "3xTF32 at 495 TFLOP/s, depthwise at 67",
        "library_ms": k2_f32[2],
        "admitted_blocks_ms": k2_f32_sums[0],
        "admitted_blocks_library_ms": k2_f32_sums[1],
        "train_step_launches": train_launches["f32 fused"]["dwblock"],
        "config_launches": by_config("dwblock"),
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# 7. Data parallelism over videos, and planes=128

DP_RANKS = 2
DP_VIDEOS = 4        # served with videos_per_batch 2: one video a rank a group
DP_FRAMES = 2 * S    # two clips a video
DP_TIMEOUT_S = 300   # every collective of the phase's ranks, and each spawn
PLANES_NARROW = 128


def maps_stack(torch, maps):
    """A video's uint8 maps (H, W, 1, T) as a (T, H, W) f64 stack."""
    return torch.from_numpy(np.ascontiguousarray(maps[:, :, 0].transpose(2, 0, 1))).double()


def dp_train_result(torch, ranks, i):
    """The train step of run i on the ranks as `one_train_step` returns
    one: (loss, gradients, BN stats after, the state of both videos (rank r
    holds video r), launches of rank 0), all f64 on the host."""
    r0 = ranks[0][-1][i]
    grads = {n: torch.from_numpy(a) for n, a in r0["grads"][0].items()}
    bufs = {n: torch.from_numpy(a) for n, a in r0["after"].items() if "running" in n}
    state = torch.from_numpy(np.concatenate([r[-1][i]["rnn"][0] for r in ranks]))
    return r0["losses"][0], grads, bufs, state, r0["launches"][0]


def dp_phase(torch, kernels, twa, dwblock, DWBlock, serve, drive, compare, weights, gauss, ob,
             first_clip, k2_blocks, smi):
    """(a) Two gloo ranks on this card serve 4 videos of 2 clips at 360x640,
    bf16, graphed, K2 off and on (`cli test --dp_devices` serving, one video
    a rank a group): each rank's maps the bits of one process serving the
    same video at V=1, and within CC_MIN per frame of one process at V=2;
    K1 and K2 per rank from the graphs' own nodes, exactly phase 3's per
    replay. (b) The same ranks take one train step with a video each, bf16
    mixed and f32, against one process's V=2 step that reduces each
    BatchNorm's batch as the ranks do (`ranks_arithmetic`): f32 at
    `TOL_TRAIN_K1_*`, bf16 mixed at `TOL_TRAIN_BF16_*`; f32 also against the
    plain one-process step at the bounds of an f32 run's drift through ~100
    train-mode BatchNorms (`TOL_TRAIN_*`, as phase 5d holds the card against
    the CPU); bf16 against it printed (module docstring); their launches
    exactly phase 5d's, the replicas equal. (c) One rank through an NCCL group takes the
    f32 step, deterministic algorithms on, between two plain steps: the
    bits of the plain step. (d) UAVSal(planes=128) served at 360x640 in
    bf16, K2 off and on, and in f32, through phase 3's `drive` (K1 as
    served against the plain version, K2 at each admitted block against
    its plain version, launches exact, graphed equal to eager), and K1's
    f32 kernel at 1x20x45x80x128 against the plain version. Returns the
    launches of each path."""
    from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
    from iip_uavsal_saliency_tpu_torch.parallel import spawn
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _dp_runs import ranks_arithmetic, run_jobs, serve_videos  # shared with the tests
    from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
    from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED + 17)  # its own: the other phases' draws stay as they were
    variables = to_jax_variables(weights)
    videos = [synthetic_video(rng, DP_FRAMES) for _ in range(DP_VIDEOS)]
    native = [(NATIVE_H, NATIVE_W)] * DP_VIDEOS
    served = {k2: {"model": {"fused_dwblock": k2}, "weights": variables, "gauss": gauss,
                   "ob": ob, "compute_dtype": "bfloat16", "videos": videos, "native": native,
                   "batch_size": 4, "time_dims": 5, "videos_per_batch": DP_RANKS,
                   "graphed": True} for k2 in (False, True)}
    start = init_model(UAVSal(), torch.Generator().manual_seed(SEED)).state_dict()
    x, y = lockstep_batch(torch, rng, TRAIN_S, TRAIN_S // 2)
    ob_train = rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)
    carried = rng.normal(0.0, 0.5, (DP_RANKS, OUT_H, OUT_W, 256)).astype(np.float32)
    gauss_train = torch.from_numpy(gauss)
    step_run = {"model": {}, "weights": {k: v.numpy() for k, v in start.items()},
                "loss": "masked", "lr": TRAIN_LR, "wd": TRAIN_WD, "tf32": False,
                "clips": [(x.numpy(), y.numpy())], "rnn": carried, "gauss": gauss,
                "ob": ob_train}
    trained = [dict(step_run, compute_dtype="bfloat16"), step_run]
    launches = {}

    # (a) and (b): one spawn of two ranks sharing the card
    t0 = time.perf_counter()
    ranks = spawn(run_jobs, DP_RANKS, "gloo",
                  ([("serve_videos", served[False]), ("serve_videos", served[True]),
                    ("train_steps", trained)],), device_type="cuda", timeout_s=DP_TIMEOUT_S,
                  deadline_s=DP_TIMEOUT_S)
    print(f"dp: two gloo ranks on one card served and trained in {time.perf_counter() - t0:.1f} s "
          "(the processes' start, CUDA and the kernels' load included)")
    for j, k2 in enumerate((False, True)):
        path = f"serve bf16 K2 {'on' if k2 else 'off'}"
        want = {"twa_scan": 1, "twa_step": 0, "dwblock": k2_blocks if k2 else 0}
        one = {vpb: serve_videos(None, dict(served[k2], videos_per_batch=vpb, device="cuda"))
               for vpb in (1, DP_RANKS)}
        frames = 0
        for r, rank in enumerate(ranks):
            got = rank[j]
            nodes = got["graph_launches"]
            print(f"dp {path}, rank {r}: videos {got['indices']}, the graph's kernel nodes "
                  f"{nodes} a replay, the wrappers' launches in the run {got['launches']} "
                  f"(warm-up and capture), {got['seconds']:.3f} s for "
                  f"{sum(m.shape[3] for m in got['maps'])} frames")
            if nodes != want or not all(got["launches"][k] for k, n in want.items() if n):
                fail(f"dp {path}, rank {r}: the graph's nodes {nodes} (expected {want}), "
                     f"launches {got['launches']}")
            launches[f"{path}, rank {r}, per replay"] = nodes
            frames += sum(m.shape[3] for m in got["maps"])
            for i, maps in zip(got["indices"], got["maps"]):
                if not np.array_equal(maps, one[1]["maps"][i]):
                    fail(f"dp {path}: video {i} on rank {r} differs from one process at V=1")
                compare(f"dp {path}, video {i} (rank {r}) vs one process at V={DP_RANKS}",
                        maps_stack(torch, maps), maps_stack(torch, one[DP_RANKS]["maps"][i]))
        seconds = max(rank[j]["seconds"] for rank in ranks)
        print(f"dp {path}: {frames} frames in {seconds:.3f} s on two ranks sharing one card, "
              f"{frames / seconds:.1f} frames/s, graph captures included (two processes on "
              f"one card: no measure of scaling; {smi})")
    masked = _masked_loss(loss_fu)
    batch = (x, y, gauss_train, torch.from_numpy(ob_train), torch.from_numpy(carried))
    for i, (dtype, want) in enumerate(((torch.bfloat16, {"twa_scan": 1, "twa_step": 0,
                                                          "dwblock": 0}),
                                       (None, {"twa_scan": 0, "twa_step": TRAIN_S,
                                               "dwblock": 0}))):
        label = "bf16 mixed" if dtype else "f32"
        dp = dp_train_result(torch, ranks, i)
        one = one_train_step(torch, kernels, start, batch, cuda, dtype, loss_fn=masked)
        with ranks_arithmetic(DP_RANKS):
            same_sums = one_train_step(torch, kernels, start, batch, cuda, dtype, loss_fn=masked)
        with ranks_arithmetic(1):
            one_part = one_train_step(torch, kernels, start, batch, cuda, dtype, loss_fn=masked)
        name = f"dp train step {label}, two ranks of V=1 vs one process of V=2"
        diffs = train_diffs(same_sums, dp)
        print(f"{name} with the ranks' BatchNorm sums (`parts={DP_RANKS}`): the state's bits "
              f"equal {torch.equal(same_sums[3], dp[3])}")
        if dtype is None:
            held_train(f"{name} with the ranks' BatchNorm sums", diffs, TOL_TRAIN_K1_LOSS,
                       TOL_TRAIN_K1_GRAD, TOL_TRAIN_K1_LEAF, TOL_TRAIN_K1_BN, TOL_TRAIN_K1_STATE)
            held_train(name, train_diffs(one, dp), TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
                       TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
        else:
            held_train(f"{name} with the ranks' BatchNorm sums", diffs, TOL_TRAIN_BF16_LOSS,
                       TOL_TRAIN_BF16_GRAD, None, TOL_TRAIN_BF16_BN, TOL_TRAIN_BF16_STATE)
            for what, a, b in (("two ranks of V=1 vs one process of V=2", one, dp),
                               ("one process, the cross-rank BatchNorm's sums over one part vs "
                                "F.batch_norm's", one, one_part)):
                d = train_diffs(a, b)
                print(f"dp train step {label}, not held, {what}: loss {d['loss']:.3g}, "
                      f"gradient {d['grad']:.3g}, BN stats {d['bn']:.3g}, state "
                      f"{d['state']:.3g}")
        got = [rank[-1][i]["launches"][0] for rank in ranks]
        print(f"dp train step {label}: launches a rank {got}, one process {one[4]}")
        if any(g != want for g in got) or one[4] != want:
            fail(f"dp train step {label}: launched {got} a rank, expected {want}")
        if ranks[0][-1][i]["digest"] != ranks[1][-1][i]["digest"]:
            fail(f"dp train step {label}: the two replicas differ after the step")
        launches[f"train step {label}, a rank"] = got[0]

    # (c) the NCCL path at one rank, between two plain steps
    t0 = time.perf_counter()
    det = dict(step_run, deterministic=True)
    (plain, nccl, again), = spawn(run_jobs, 1, "nccl",
                                 ([("train_steps", [dict(det, grouped=False), det,
                                                    dict(det, grouped=False)])],),
                                 device_type="cuda", timeout_s=DP_TIMEOUT_S,
                                 deadline_s=DP_TIMEOUT_S)[0]
    same = {"loss": plain["losses"] == nccl["losses"],
            "grads": all(np.array_equal(g, nccl["grads"][0][n])
                         for n, g in plain["grads"][0].items()),
            "state": np.array_equal(plain["rnn"][0], nccl["rnn"][0]),
            "after": plain["digest"] == nccl["digest"]}
    repeat = plain["digest"] == again["digest"] and plain["losses"] == again["losses"]
    print(f"dp f32 train step through an NCCL group of one rank against the plain step "
          f"(deterministic algorithms): equal bits {same}; plain against plain again: "
          f"{repeat}; {time.perf_counter() - t0:.1f} s with the process's start")
    if not repeat:
        fail("the plain train step is not deterministic on this card: NCCL cannot be held "
             "bit for bit")
    if not all(same.values()):
        fail(f"the NCCL step is not the plain step bit for bit: {same}")
    launches["train step f32, nccl, one rank"] = nccl["launches"][0]

    # (d) planes=128 at full width
    tree = to_jax_variables(random_state_dict(UAVSal(planes=PLANES_NARROW), rng))
    config = {"planes": PLANES_NARROW}
    model16, step16, spy16, seen16 = serve(torch.bfloat16, False, tree, config)
    launches["planes128 bf16 K2 off"], _, sal16, _ = drive(
        "planes=128, K2 off (bf16)", model16, step16, spy16, seen16, True, 0)
    model16k, step16k, spy16k, seen16k = serve(torch.bfloat16, True, tree, config)
    print("K2 bf16 at the admitted blocks of one planes=128 serving step:")
    admitted, _ = check_k2_admitted(torch, dwblock, DWBlock, model16k, step16k, first_clip,
                                    model16k.init_state(IN_H, IN_W, V, device="cuda"))
    launches["planes128 bf16 K2 on"], _, sal16k, _ = drive(
        "planes=128, K2 on (bf16)", model16k, step16k, spy16k, seen16k, True,
        len(admitted) * CLIPS)
    model32, step32, spy32, seen32 = serve(None, False, tree, config)
    launches["planes128 f32"], _, sal32, _ = drive(
        "planes=128, K2 off (f32)", model32, step32, spy32, seen32, False, 0)
    compare("planes=128 bf16 vs f32 saliency, K2 off", sal16, sal32)
    compare("planes=128 bf16 K2 on vs f32 saliency", sal16k, sal32)
    shape = (1, S, OUT_H, OUT_W, PLANES_NARROW)
    args = k1_case(torch, rng, shape, torch.float32)
    kernels.reset_launches()
    ys, last = twa._twa_scan_cuda(*args, route="twa_step")
    torch.cuda.synchronize()
    ref, ref_last = twa.twa_scan_ref(*args)
    err = max((ys - ref).abs().max().item(), (last - ref_last).abs().max().item())
    print(f"K1 per-frame f32 at {shape}: max_abs_err {err:.3g} (tolerance {TOL_F32}), "
          f"launches {dict(kernels.launches)}")
    if not err <= TOL_F32 or kernels.launches["twa_step"] != S:
        fail(f"K1 f32 at {shape} disagrees with twa_scan_ref: {err}")
    print(f"phase 7 (data parallelism, planes=128) took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 8. The spatial axis: image rows over ranks

SPATIAL_RANKS = 2
SPATIAL_CLIPS = 2     # carried clips of S frames served
SPATIAL_TRAIN_S = 5   # frames of the f32 train step
SPATIAL_TIMEOUT_S = 300


def spatial_phase(torch, kernels, twa, weights, smi):
    """8. Two gloo ranks on this card, a spatial mesh of 2 (each rank 360 of
    the 720 rows, 45 of the state's 90), serve the flagship at 720x1280
    (`make_infer_step(mesh=)`, eager: a graph cannot capture the exchanges)
    over 2 carried clips of S=20, in bf16 with K2 off and on and in f32
    (TF32 off); their bands put back together against one process's step
    on the same clips: f32 within TOL_F32 of the largest value of the
    saliency and of the state, bf16 at CC >= CC_MIN per frame (the largest
    uint8 difference printed). K1 runs once per frame on each rank's band
    with its halo rows (its route at that shape: the per-frame kernel, W =
    160), K2 once per DWBlock call whose whole-map input its gate admits
    (counted by a hook on the blocks); each rank's launches must be exactly
    these, and so must one process's. Then an f32 train step at 720x1280,
    V=1, S=5 on the same two ranks against one process's, at the bounds of
    an f32 run's drift (`TOL_TRAIN_*`), K1 once per frame per rank. Prints
    each rank's peak memory and the phase's seconds; no scaling figure (the
    ranks share one card). Returns the launches of each path, per rank."""
    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.parallel import spawn
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _dp_runs import train_steps  # shared with the tests
    from _spatial_runs import assemble, infer_clips, run_jobs

    t_phase = time.perf_counter()
    in_h, in_w, out_h, out_w = NATIVE_IO
    rng = np.random.default_rng(SEED + 18)  # its own: the other phases' draws stay as they were
    gauss = get_gauss_priors(out_h, out_w, 8)
    ob = rng.uniform(0.0, 1.0, (out_h, out_w, 20)).astype(np.float32)
    video = synthetic_video(rng, SPATIAL_CLIPS * S, in_h, in_w)[None]
    arrays = {k: v.numpy() for k, v in weights.items()}
    mesh = (1, SPATIAL_RANKS)
    base = {"mesh": mesh, "weights": arrays, "x": video, "clips": SPATIAL_CLIPS,
            "state": np.zeros((1, out_h, out_w, 256), np.float32), "gauss": gauss, "ob": ob,
            "tf32": False}
    paths = {"bf16 K2 off": dict(base, compute_dtype="bfloat16"),
             "bf16 K2 on": dict(base, compute_dtype="bfloat16", model={"fused_dwblock": True}),
             "f32": dict(base)}
    gaze = rng.uniform(0.0, 1.0, (1, SPATIAL_TRAIN_S, out_h, out_w, 2)).astype(np.float32)
    gaze[..., 1] = gaze[..., 1] < 0.01
    gaze[:, :, out_h // 2, out_w // 2, 1] = 1.0
    train = {"mesh": mesh, "model": {}, "weights": arrays, "tf32": False, "lr": TRAIN_LR,
             "wd": TRAIN_WD, "clips": [(video[:, :SPATIAL_TRAIN_S], gaze)],
             "rnn": rng.normal(0.0, 0.5, (1, out_h, out_w, 256)).astype(np.float32),
             "gauss": gauss, "ob": ob}
    t0 = time.perf_counter()
    ranks = spawn(run_jobs, SPATIAL_RANKS, "gloo",
                  ([("infer_clips", run) for run in paths.values()]
                   + [("train_steps", [train])],), device_type="cuda",
                  timeout_s=SPATIAL_TIMEOUT_S, deadline_s=SPATIAL_TIMEOUT_S)
    print(f"spatial: two gloo ranks on one card served and trained in "
          f"{time.perf_counter() - t0:.1f} s (the processes' start, CUDA and the kernels' load "
          "included)")
    route = twa.kernel_route((1, 1, out_h // SPATIAL_RANKS + 2, out_w, 256), torch.bfloat16)
    launches = {}
    for j, (path, run) in enumerate(paths.items()):
        one = infer_clips(None, dict(run, mesh=None, device="cuda"))
        got = [rank[j] for rank in ranks]
        k1 = {"twa_scan": 0, "twa_step": 0}
        k1[route if run.get("compute_dtype") else "twa_step"] = S
        k2 = run.get("model", {}).get("fused_dwblock", False)
        for k in range(SPATIAL_CLIPS):
            want = dict(k1, dwblock=one["admitted"][k] if k2 else 0)
            for who, r in [("one process", one)] + [(f"rank {i}", g) for i, g in enumerate(got)]:
                if r["launches"][k] != want or r["admitted"][k] != one["admitted"][k]:
                    fail(f"spatial {path}, clip {k}, {who}: launched {r['launches'][k]}, "
                         f"expected {want}")
            sal, state = assemble(got, "saliency", k, 2), assemble(got, "state", k, 1)
            ref_sal, ref_state = one["saliency"][k], one["state"][k]
            if path == "f32":
                errs = [np.abs(a - b).max() / np.abs(b).max()
                        for a, b in ((sal, ref_sal), (state, ref_state))]
                print(f"spatial {path}, clip {k}: two ranks' bands against one process: "
                      f"saliency {errs[0]:.3g}, state {errs[1]:.3g} of the largest value "
                      f"(tolerance {TOL_F32})")
                if not max(errs) <= TOL_F32:
                    fail(f"spatial {path}, clip {k}: {errs} above {TOL_F32}")
            else:
                a, b = (torch.from_numpy(m[0, :, :, :, 0]) for m in (sal, ref_sal))
                cc = frame_cc(torch, a, b)
                u8 = np.abs(np.rint(sal * 255) - np.rint(ref_sal * 255)).max()
                print(f"spatial {path}, clip {k}: two ranks' bands against one process: CC per "
                      f"frame min {cc.min().item():.6f}, largest uint8 difference {u8:.0f}, "
                      f"state max abs diff {np.abs(state - ref_state).max():.3g}")
                if not cc.min().item() >= CC_MIN:
                    fail(f"spatial {path}, clip {k}: min CC {cc.min().item()} < {CC_MIN}")
        for i, g in enumerate(got):
            print(f"spatial {path}, rank {i}: launches per clip {g['launches'][0]}, "
                  f"{g['seconds']:.3f} s for {SPATIAL_CLIPS} clips, peak memory "
                  f"{g['peak_bytes'] / 2 ** 30:.2f} GiB")
        print(f"spatial {path}, one process: {one['seconds']:.3f} s for {SPATIAL_CLIPS} clips "
              f"({smi})")
        launches[f"serve {path}, a rank, per clip"] = got[0]["launches"][0]

    # the f32 train step
    one, = train_steps(None, [dict(train, mesh=None, device="cuda")])
    got = [rank[-1][0] for rank in ranks]

    def as_step(r, state):
        return (r["losses"][0], {n: torch.from_numpy(a) for n, a in r["grads"][0].items()},
                {n: torch.from_numpy(a) for n, a in r["after"].items() if "running" in n},
                torch.from_numpy(state), r["launches"][0])

    held_train("spatial f32 train step, two ranks' bands against one process",
               train_diffs(as_step(one, one["rnn"][0]), as_step(got[0], assemble(got, "rnn", 0, 1))),
               TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
    want = {"twa_scan": 0, "twa_step": SPATIAL_TRAIN_S, "dwblock": 0}
    for i, g in enumerate(got):
        print(f"spatial f32 train step, rank {i}: loss {g['losses'][0]:.6f}, launches "
              f"{g['launches'][0]}, peak memory {g['peak_bytes'] / 2 ** 30:.2f} GiB")
        if g["launches"][0] != want:
            fail(f"spatial f32 train step, rank {i}: launched {g['launches'][0]}, expected {want}")
    if got[0]["digest"] != got[1]["digest"]:
        fail("spatial f32 train step: the two ranks' parameters differ after the step")
    print(f"spatial f32 train step, one process: peak memory {one['peak_bytes'] / 2 ** 30:.2f} GiB")
    launches["train step f32, a rank"] = got[0]["launches"][0]
    print(f"phase 8 (the spatial axis) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def time_host_issue(torch, paths, clip, state, calls: int = 21) -> None:
    """The host's time to issue one step, eager against graphed: perf_counter
    around the call alone, no synchronize inside; the queue is drained
    before each call so that no call waits on the card. Median of `calls`
    per path, the paths in turns."""
    secs = {key: [] for key in paths}
    for rep in range(calls):
        for key in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths[key](clip, state)
            secs[key].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    for (which, how), ts in secs.items():
        print(f"host issue time of one step, K2 {which}, {how}: median "
              f"{float(np.median(ts)) * 1e3:.3f} ms, fastest {min(ts) * 1e3:.3f} ms over {calls} "
              f"calls")


def time_runner(torch, paths, models, video, native) -> None:
    """End to end through the pipelined `predict_videos` (clip building on
    the host, pinned copies, serving, postprocess to 540x960 uint8 and the
    copy back), graphed and eager, K2 off and on: host clock from the call
    to its last map on the host, ending in `synchronize()`. The four paths
    in turns (the order reversed every other round), `E2E_RUNS` rounds, over
    the 3 clips of the main path and over `LONG_CLIPS` clips (the same
    frames repeated), whose steady state the short video does not show."""
    from iip_uavsal_saliency_tpu_torch.runners.infer import predict_videos

    long_video = np.concatenate([video] * -(-LONG_CLIPS * S // len(video)))[:LONG_CLIPS * S]
    for vid in (video, long_video):
        secs = {key: [] for key in paths}
        for rep in range(E2E_RUNS):
            for key in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predict_videos(paths[key], models[key[0]], [vid], native, batch_size=4)
                torch.cuda.synchronize()
                secs[key].append(time.perf_counter() - t0)
        n = len(vid)
        for (which, how), ts in secs.items():
            fps = ", ".join(f"{n / t:.1f}" for t in ts)
            print(f"runner end to end, K2 {which}, {how}: FPS over {n} frames ({n // S} clips), "
                  f"{E2E_RUNS} runs in turns: {fps}; median {n / float(np.median(ts)):.1f}")
    runner_costs(torch, paths[("on", "graphed")], models["on"], long_video, native)


def runner_costs(torch, graphed, model, video, native) -> None:
    """Where the runner's time goes beside the step. (1) The runner alone:
    `predict_videos` with a step that returns a saliency made beforehand
    and does no work, so what is left is building and shipping the clips,
    the postprocess on the card and the copy back, per clip, median of
    `E2E_RUNS`. (2) One graphed K2-on run over the video under the
    profiler: wall time beside the time the serving stream is busy (the
    sum of its kernels and device-to-device copies; the copies to and from
    the host run on streams of their own, beside it, and are counted
    apart); the table goes to build/chip_smoke_profile_runner.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.runners.infer import predict_videos

    made = torch.rand((V, S, OUT_H, OUT_W, 1), device="cuda")

    def no_work(x, state):
        return made, state

    secs = []
    for _ in range(E2E_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_videos(no_work, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    clips = len(video) // S
    print(f"runner alone (a step that does no work), {clips} clips: "
          + ", ".join(f"{t / clips * 1e3:.3f}" for t in secs)
          + f" ms per clip; median {float(np.median(secs)) / clips * 1e3:.3f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_videos(graphed, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    h2d = sum(e.self_device_time_total for e in device if "HtoD" in e.key) / 1e3
    d2h = sum(e.self_device_time_total for e in device if "DtoH" in e.key) / 1e3
    busy = sum(e.self_device_time_total for e in device) / 1e3 - h2d - d2h
    print(f"runner under the profiler, K2 on, graphed, {clips} clips: wall {wall * 1e3:.3f} ms, "
          f"the serving stream busy {busy:.3f} ms ({busy / (wall * 1e3):.1%}; idle "
          f"{1 - busy / (wall * 1e3):.1%}); copies to the card {h2d:.3f} ms and back "
          f"{d2h:.3f} ms, each on a stream of its own")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_runner.txt"), "w") as f:
        f.write(table)


def write_profile(torch, step, clip, state, filename: str, top: int = 0):
    """Device time by kernel for one serving step, into build/. Returns the
    step's device time and K1's part of it (its two kernels), in ms; with
    `top`, also prints the `top` ATen ops that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(clip, state)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events
             if "twa_clip_kernel" in e.key or "twa_step" in e.key) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(table)
    print(f"profile of one serving step: build/{filename}; device time {total:.3f} ms, K1 "
          f"{k1:.3f} ms ({k1 / total:.1%})")
    if top:  # the ATen ops, each with the device time of the kernels it launched
        ranked = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                        key=lambda e: -e.self_device_time_total)[:top]
        print("  top ops by device time: " + "; ".join(
            f"{e.key} {e.self_device_time_total / 1e3:.3f} ms ({e.count}x)" for e in ranked))
    return total, k1


if __name__ == "__main__":
    main()
