#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfdtpu_torch) on one NVIDIA GPU.

Drives the port's paths at full width: the WIDERFACE-L inference engine
(random seeded weights with randomized BatchNorm statistics and affines and
head Scales, so the BN folding is exercised), captured into a CUDA graph as
a user gets it on the card, the WIDERFACE-L training step, the training
entry point with its val loop, and the evaluation script; then the TT100K
and TrafficLight workloads (serving, training entry points, evaluation) and
the LFDv2 family, FCOS-R50-FPN, the int8 engine, engine files, and
learning on synthetic scenes, data-parallel training, and the spatial
mesh (the image height split over ranks) of the engine and the eval step.
What pytest on the card holds more simply lives in tests/test_torch_cuda.py:
each kernel against its plain version at the engine's shapes and batches
(K1's cases, K2, K3 and K5 at 1080p and TT100K's levels, K4's routes), and
captured engines against eager ones (every variant at 1080p, batch 1 and 4;
float frames). This script keeps what needs fresh processes, ranks, the
workload scripts or training, and times each kernel alone. It times no path
end to end: the benchmark (python3 benchmark/run.py) does, in its cells.
It checks them:

  1. card     the GPU's name and power limit (nvidia-smi);
  2. build    the hand-written kernels from lfdtpu_torch/csrc/*.cu (nvcc);
 3-4.         (the kernels against their plain versions: tests/test_torch_cuda.py)
  5. engine   engines at 1088x1920 (1080p padded to the stride-64
              multiple), built as a user builds them: on the card
              compile_inference returns a CAPTURED engine, one CUDA graph of
              net + decode + NMS that a call replays. Four of them (fp32,
              bf16 with K1-K3 at batch 1 and 4, bf16 with the plain NMS);
              then 8 single frames through
              predict_for_single_image_with_engine and one batch of 4 with
              different valid extents through predict_for_batch_with_engine,
              with all three kernels on. The kernels' launch counters
              (zeroed before the engines are built) tick in the warmup calls
              and during the capture, where the wrappers launch them; the 9
              replays' launches are counted from a torch.profiler trace by
              kernel name and must be 9 x K1/K2/K3 = 1/1/10. Then: dense
              outputs of the kernel engine against the plain bf16 engine and
              both against fp32; decode + NMS on the same dense outputs, K1
              against plain, rows identical; the fp32 engine on the GPU
              against the fp32 port on the CPU at 256x256, TF32 off;
  6. train    the training path (forward, on-device target assignment,
              loss, backward, clip, SGD) of WIDERFACE-L, whose one
              hand-written kernel is K6, the target assignment: two fp32
              steps at 128x128, batch 2, on the GPU against the same steps on
              the CPU (loss, grad_norm, every param and BN running stat,
              max|err|/max|ref| < 1e-3, TF32 off); then full width at the
              workload's batch 64, crop 480x480, GT padded to 200 rows: K6
              against its plain version on that batch (one launch, both
              outputs equal), then SGD momentum 0.9 / wd 1e-4, clip 10 and its
              warmup schedule, 20 steps in fp32 and 20 in bf16 autocast on one
              fixed batch (finite, loss falls, fp32 master weights, BN stats
              move; peak memory; one K6 launch a step by its counter, and one
              more bf16 step profiled: K6 once by kernel name, no engine
              kernel); then the trained net is compiled into the
              bf16 engine with all three kernels and serves a frame (every
              kernel launches, rows checked), and predict_for_single_image
              on the net left in train() leaves its running stats alone;
  7. kernels  each kernel alone at the shapes the engine gives it (K6: the
              train cell's batch 64 at 480x480, C 1, N 200): its
              device ms (CUDA events around replays of a CUDA graph of its
              launches, warm on repeated inputs and cold rotating over more
              than the 50 MB L2) beside its bound (kernel_bound_ms), its
              share of the bound, its plain version (eager) and, for K3,
              cuDNN in bf16 with the BN folded in: conv2d alone, with the
              bias, followed by the residual add and ReLU, and the fused call
              of K3's own function (cudnn_convolution_add_relu / _relu),
              which is K3's library call where the card runs it; K1 on
              random boxes at B=1, K=1000, on the walk's hard cases and at
              B=4, each with its kept count; K5 at WIDERFACE-L's and
              TT100K-L's first head levels and FCOS's P3 beside ATen's
              group_norm + relu on the channels_last map with its copies;
              K6 beside its plain version (no library call assigns targets);
              K7 at Deformable DETR-R50's 800x1333 encoder and decoder calls,
              recorded from one eager forward of its bf16 engine (12
              launches), warm and cold beside its plain version, and the
              captured engine's 12 launches a frame at its capture and by
              profiled replays.
              Each timed launch's output is held once to its plain
              version's on the same inputs (alone_err: K1 exact, K2/K3/K5/K7
              within K2_TOL/K3_TOL/K5_TOL/K7_TOL; K6 equal), and so, untimed,
              are K2 and K3
              at the engines' batch 1 and 4 (K3 on its three levels with
              and without the residual and the ReLU) and K5 at WIDERFACE-
              L's five head levels (engine_shape_errs). Then one frame of the
              bf16_kernels engine launches K1 once, K2 once, K3 10 times
              and K5 10 times (the wrappers' counters for the eager engine,
              the capture's record and 5 profiled replays for the captured
              one);
  8. workload the WIDERFACE training entry point end to end: a seeded
              synthetic pack (170 uint8 images 1024 wide, 680-1024 high, 0-30
              faces of 4-320 px, every fifth a negative: 3 iterations per
              epoch at batch 64) built with the port's Dataset in a temporary
              directory; the port's WIDERFACE_LFD_L config (its _common, with
              LFD_DEVICE_AUG=1: batch 64, crop 480, Nmax 200, fp32) trains 2
              epochs through the Executor (finite losses that do not blow up,
              the warmup lr, epoch_1.pth), resumes from epoch_1.pth (counters,
              params exact) for the last epoch under the Executor's profiler
              hook (its trace written), then the host-augmentation config
              (LFD_DEVICE_AUG=0) trains the same iterations; the device half
              of the augmentation on the GPU against the CPU on one loader
              batch (1e-3 pixel units); the final checkpoint served through
              the bf16 kernel engine (every kernel launches). The first of
              these runs also validates: a val loader over the pack's first
              24 images (whole images, batch 8), val_interval 1 and a
              COCOEvaluator over their boxes (one result list per val image,
              finite metrics, the net's weights, BN statistics and train mode
              untouched by the val pass); and the port's evaluation.py script
              runs its SIO evaluation on the final checkpoint over 6 JPEGs
              written from the pack into event folders (one txt per image, in
              the WIDERFACE format);
  9. traffic  TT100K-L at 2048x2048 (45-class softmax head; batch 1 and 4)
     serve    and TL-L / TL-S at 768x1280 (720p padded; one class,
              class-agnostic, BGR -> RGB and the imagenet normalize), each
              with its classifier's output conv drawn at std 0.2 so the
              softmax is not near uniform. Each model's main path: counters
              zeroed, the captured engine with every kernel its net takes
              built (TL-S's 48-channel stem does not fit K2: its
              kernel_stem=True engine must raise, it serves K1 and K3),
              frames served through the predict entry points, the replays
              counted from a profile; launches against expected_launches,
              counted from the net (no hard-coded count). Then K2 with the
              engine's folded constants against its plain version; dense
              bf16 kernel outputs against the plain bf16 engine; decode +
              NMS with K1 (45 class offsets for TT100K) against the plain
              NMS, rows identical; the fp32 engine against the CPU at
              256x256; fp32, bf16 and the kernel variant captured against
              eager twins, bit-equal; a 3-frame profile. Then K3 timed alone
              at TT100K's 512x512 with and without the residual and 256x256
              with it (bound, plain, cuDNN), K2 at 2048x2048 and with TL-L's
              folded constants at 768x1280;
 10. traffic  the TT100K_LFD_L and TL_LFD_L configs (their _common, as the
     train    scripts build them) trained end to end: 2 epochs with device
              augmentation, a resume from epoch_1.pth (exact), 2 epochs
              (TT100K: TT_HOST_EPOCHS, 1) with host augmentation; losses
              finite, lr on the warmup. The
              packs are made by the port's own scripts from seeded files
              written here. TT100K: 100 2048x2048 JPEGs with 1-8 signs of
              8-200 px over the 45 classes, 8 without one, and the margins
              that generate_neg_images.py cuts (min_size_threshold 512),
              packed by pack_tt100k.py through TT100KParser: 2 iterations
              per epoch at batch 64 (cut: the dataset, 2 epochs). TL: 20
              720x1280 JPEGs, 16 with 1-6 lights of 8-80 px, and one of 24
              px height that pack_TL.py drops (COCOParser, filter_min_size
              32): 4 iterations per epoch at batch 4 (cut: the dataset, 2
              epochs). Each final checkpoint served through the captured
              kernel engine at 768x1280 and scored by the task's
              evaluation.py (TT100K: 4 images, minscore 0; TL: every image,
              COCOEvaluator); the TT100K-L train step at batch 64, crop 512,
              Nmax 100 in fp32 and bf16 (as phase 6's full-width steps);
 11. LFDv2    LFDv2 on WIDERFACE-L's backbone, neck and head at 1088x1920:
              its main path (counters zeroed, the captured bf16 engine with
              K1-K3 built, two frames served, replays counted), the
              candidates K1's wrapper receives (at most nms_budget), the
              captured engine against an eager twin; two fp32 train steps of
              LFDv2 and of LFDv2Q on the GPU against the CPU (TRAIN_TOL);
 12. FCOS     FCOS-R50-FPN (fcos_r50_fpn: mmdetection's
              fcos_r50_caffe_fpn_gn-head_1x_coco.py at full width, seeded
              random weights, the classifier scaled so that more than 1000
              (point, class) pairs pass the 0.05 threshold). Its main path,
              counters zeroed: 3 800x1333 frames (padded to 896x1408) through
              predict_for_single_image with the fp32 net and with the net cast
              to bf16, and get_results on a batch of 2; K1 launched once per
              call on (B, 1000, 4) class-offset boxes (80 classes, read from
              its wrapper's input), and held to its plain version on them.
              Then its captured bf16 engine (K5 40 times and K1 once a frame)
              against the eager bf16 net's rows; decode + NMS with K1
              against the plain NMS on the same dense outputs (rows
              identical, fp32 and bf16); the fp32 net on the GPU against the
              CPU at 256x384 (DENSE_FP32_TOL); two fp32 train steps of FCOS
              and FCOSv1 at 256x256 on the GPU against the CPU (TRAIN_TOL),
              and in FCOS's GPU net the frozen stem and stage 1 moved by
              weight decay alone (F7); steps at 896x1408, Nmax 100, batch 2
              and 8, fp32 and bf16 (finite, BN statistics untouched:
              norm_eval; peak memory); K1 timed alone at the FCOS shape
              (warm, cold, bound, plain);
 13. int8     the int8 engine (compile_inference(precision="int8"): the fused
              int8 chain, every conv of the backbone and neck one K4 launch,
              then the float remainder, decode and K1) of WIDERFACE-L at
              1088x1920. K4 against its plain version, EXACT, at every
              (shape, mode) one eager call hands its wrapper (read from its
              inputs, as phase 12 reads K1's), at batch 1 and 4, each
              launch on the route ops.int8_conv.route_of names (wgmma or
              stem, none on the mma.sync route). The main path, counters
              zeroed: the captured int8 engines with a float32
              and a bf16 head, each calibrated by default, 3 frames each
              through predict_for_single_image_with_engine (the replays
              counted from a profile), and one JPEG through the port's
              WIDERFACE_train/predict_engine.py with precision="int8"; K4
              and K1 launches against expected_launches, which counts K4
              from the chain's plan, K4's by route. Then each captured
              engine against an
              eager twin (bit-equal on two frames in a row), the int8 dense
              outputs against the fp32 engine's by lfdtpu's criteria
              (correlation > 0.95, mean-magnitude ratio in 0.8-1.25), decode
              + NMS with K1 against the plain NMS on the int8 outputs (rows
              identical), the int8 chain on the GPU against the CPU at
              256x256 with one amax dict (every int8 edge equal, dense within
              DENSE_FP32_TOL), a profile of a fresh capture of each. TL-L
              at 768x1280 in int8, whose norm-free
              head runs int8 too (F15's path): its main path, captured
              against eager, K4 at its shapes. K4's mma.sync route, which
              no zoo chain takes, timed alone on K4_MMA_SHAPES (each launch
              on that route and exact). Then WIDERFACE-XS at
              1088x1920 and TL-S at 768x1280 in int8 (narrow_int8_path),
              whose 32- and 48-channel convs the wgmma and stem routes take:
              K4 against its plain version on every call of one eager frame
              at batch 1 and 4 (XS 1 stem + 34 wgmma launches a frame, TL-S
              1 + 39, none on the mma.sync route), their main paths as
              WIDERFACE-L's (the captured float32- and bf16-head engines,
              the replays counted from a profile), captured against eager,
              int8 against fp32, a profile of a fresh capture, and K4
              timed alone at every distinct (shape, mode) of a frame on its
              route and on the mma.sync route. Last, K4 timed alone at every
              distinct (shape, mode) of a WIDERFACE-L frame (launches, warm,
              cold (rotating inputs, or after an L2-evicting write where the
              inputs are too small), bound, gap; the plain version and
              cuDNN's bf16 fused conv as a yardstick at five of them,
              torch._int_mm beside the stride-1 1x1s: PyTorch has no CUDA
              int8 conv), ranked by gap, with the frame's sum of bounds;
 14. files    serving from engine files, WIDERFACE-L at 1088x1920. With the
              counters zeroed: the bf16 engine with K1-K3 and the int8
              engines with a float32 and a bf16 head built (captured), each
              serving two frames under a profile (replays counted by kernel
              name), saved with deploy.engine_io.save_engine, and loaded in
              a FRESH Python process on the card (this script with
              --serve-file, the three at once: each imports engine_io and no
              model code, recaptures, serves the same two frames under a
              profile of that fresh capture and writes its outputs). The
              loaded outputs must be bit-equal to the built engine's, its
              capture's launches and its replays by kernel name equal to the
              built one's. Then the WIDERFACE predict_engine.py with
              engine_file (the first run saves, the second loads: rows
              equal); run_stream over 64 uint8 numpy frames with the bf16
              K1-K3 engine at depths 1, 2, 4, 4, 2 and 1, bit-equal to the
              synchronous loop, then with output_dtype="f16" (within
              lfdtpu's 0.5 px / 2e-3 of the float32 stream, its bytes to the
              host); a BucketedEngineSet over DEFAULT_BUCKETS (bf16 K1-K3),
              prewarmed, routing three frames of different sizes, rows equal
              to engines built directly at each bucket;
 15. learning the port learns (`chip_smoke.learning_phase`).
              multiclass_nms on CUDA tensors (K1) against its plain path
              on seeded candidates with ties, invalid rows and more
              survivors than max_num: keep, order and count equal. The
              WIDERFACE-L train step with remat=True against the plain one
              at batch 64, crop 480 (fp32 and bf16, one step each, its
              peak GiB; after that step from the same weights the BN
              statistics equal, the params within TRAIN_TOL). Then lfdtpu's
              synthetic runs and bars (tests/test_synthetic_e2e.py) through
              the port's lfdtpu_torch/tools/synthetic_e2e.py on the card: lfd
              multiscale (80 epochs, mAP_50 > 0.42, every range's recall
              >= 0.6), lfdv2 (60, > 0.5), lfdv2q (80, lr 0.025, clip the
              whole run, > 0.5), fcos (60, > 0.5), lfd with its fp32 and
              int8 engines (60, > 0.5, int8 >= fp32 - 0.05); then
              WIDERFACE-XS and -L as tools/int8_quality_cell.py trains them
              (single class, 60 epochs, > 0.2), each scored through the
              captured fp32, bf16 (K1, K3, and K2 where the stem takes it)
              and int8 engines with a float32 and a bf16 head, fp32 > 0.2
              and each other engine >= fp32 - 0.05. Each run is a path
              (counters zeroed before it, read after; the engines' replays
              of the 16 val frames counted from profiles, 16 x each
              capture's launches); every kernel its engines launch is held
              to its plain version on two val frames (K1 and K4 exact, K2
              and K3 within K2_TOL / K3_TOL), and the kernels are timed
              alone at the trained WIDERFACE-L engines' 128x128 shapes.
 16. data     data parallelism (`chip_smoke.ddp_phase`), counters zeroed
     parallel before each path and read after it. WIDERFACE-L's train
              step at phase 6's shape (batch 64, crop 480, Nmax 200) in a
              process group of one rank over NCCL (opened in process on a
              free 127.0.0.1 port): make_train_step(mesh=make_mesh()),
              DistributedDataParallel at world size 1, against the plain
              step from the same weights, fp32 (TF32 off) and bf16, params
              and BN statistics within TRAIN_TOL after one step. Then two
              ranks on the one card, each a fresh process
              (`chip_smoke.py --ddp-rank R DIR`, gloo with CUDA tensors:
              NCCL refuses two ranks on one device) on its 32 rows of the
              same seeded batch of 64: after 1 and 3 steps the global
              loss, params and BN statistics within TRAIN_TOL of the
              one-process batch-64 step in fp32 and with remat; in bf16
              the loss within TRAIN_TOL and the state no farther from the
              fp32 step than BF16_BAND times the one-process bf16 step
              (each rank rounds its bf16 weight gradients before the
              ranks' sum); every rank's state equal.
              Then Executor.run() of WIDERFACE_LFD_L on phase 8's pack, two
              ranks, one epoch and a val pass: rank 0 alone checkpoints,
              its checkpoint equals rank 1's weights, its val rows (each
              rank decodes its rows, K1 on every rank, gathered in order)
              equal a one-process val pass of that checkpoint, K1's
              launches counted per rank. The loader order (F21): the ranks'
              train loaders run the config's 12 workers, their crops seeded
              by sample index (seed_by_sample); each rank records every
              train and val batch it hands out, row by row; every train
              step's rows, rank 0's then rank 1's, equal a one-worker
              loader's global batch k from rank 0's sampler state, and every
              rank's val step k is the one-worker val loader's batch k with
              its own image ids. A rank that fails, dies or hangs past
              DDP_CHILD_TIMEOUT fails the run.
 17. spatial  the image height split over a mesh's spatial axis
              (`chip_smoke.spatial_phase`), counters zeroed before each path
              and read after it. First compile_inference(mesh=make_mesh())
              in a process group of one rank over NCCL, WIDERFACE-L at
              1088x1920, bf16 with K1-K3 and int8: captured, the same
              launches per capture and every output bit-equal to mesh=None.
              Then gloo ranks sharing the card, each a
              fresh process (`chip_smoke.py --spatial-rank R DIR`), in
              SPATIAL_SHAPES: 2 ranks (spatial 2, one frame) and 4 ranks (2
              data x 2 spatial, a batch of 2). Each rank builds WIDERFACE-L
              at full width and its eager mesh engines (fp32, bf16 with
              K1-K3, int8 with a float32 and a bf16 head: the default
              calibration on each rank's whole noise frames, rank 0's
              scales), serves the 4K frames (DEFAULT_BUCKETS' largest;
              SPATIAL_FRAMES calls: peak memory, launches), counts one
              call's collectives under a profiler session (the counter
              `spatial.collectives` of lfdtpu_torch/tracing.py), holds
              every K1-K4 launch of one call on its strips to the plain
              version (K1, K4 exact; K2, K3 within K2_TOL / K3_TOL), then the
              one-process eager engine of the same build on the same frames:
              counts equal, rows and dense outputs within SPATIAL_ROW_TOL /
              SPATIAL_DENSE_TOL, every int8 edge of the rank's rows
              bit-equal, and that engine's peak memory. Then
              make_eval_step(spatial=True) of WIDERFACE-L at 1088x1920 and
              FCOS-R50-FPN at 800x1333 (fp32) against the one-process
              forward (DENSE_FP32_TOL), peak memory of each. Memory
              (F20): on a spatial axis of 2 every rank's engine peak at most
              SPATIAL_PEAK_SHARE of one process's, every variant, and every
              rank's eval-step peak at most one process's; beside them
              cuDNN's fp32 3x3 conv against the strips' GEMM at the named
              shapes of tools/cudnn_workspace.py. A rank that fails, dies or
              hangs past SPATIAL_CHILD_TIMEOUT fails the run.

The second-to-last line is a JSON object {"kernels": [...]} (K1-K7; each
kernel's launches on its main path: WIDERFACE-L's bf16 engines for K1-K3
and K5, its int8 engines for K4, phase 6's training for K6 (K6's
launches_by_path: phases 6, 8 and 10's training, replayed null; K7's
phase 7's Deformable DETR engine, its decoder call in other_shapes); and, for
K1-K5, on every path in
launches_by_path: an engine path's launches at build and capture and by its
replays, the FCOS path's eager launches and replayed null (it has no
engine), the engine files' loaded path's launches at load and capture and
by its replays, in the fresh processes, phase 15's paths (multiclass_nms,
and each synthetic run's val loop and engines: eager_and_capture and
replayed), phase 16's paths (the train steps, and each rank's Executor run
with K1 in its val decode; replayed null), phase 17's paths (the one-rank
NCCL mesh engines' build and capture; each 4K mesh engine's and eval
step's launches by rank, replayed null: eager); each kernel's phase 7 times
at the main shapes; K2's and K3's times at the new shapes, K1's at the FCOS
shape, K4's at its other shapes of a WIDERFACE-L frame and its mma.sync
route's synthetic shapes, and each kernel's at the trained 128x128 engines'
shapes in other_shapes; K4's main-path launches by route in
launches_by_route). Its max_abs_err is, for K1, K2, K3 and K5, the largest
|kernel - plain| of phase 7's launches, each compared once with its plain
version on the same inputs: the timed ones, and untimed K2 and K3 at batch 1
and 4 of HW with every residual/relu pair the engines launch, K5 at
WIDERFACE-L's five head levels (K1 and K6: 0.0, their outputs equal); for K4, of
every K4 call this script holds to its plain version (phases 13, 15 and 17;
exact, so 0.0). A line before it holds K4's rows
of the WIDERFACE-XS and TL-S frames ({"k4_narrow_rows": ...});
the last line is {"ok": true, "device": {...}}. Any failed check exits non-zero. Needs a
CUDA device: without one it exits 1 and prints no result. No CUDA graph
is replayed under two torch.profiler sessions: profile_engine takes a
freshly captured engine (see there).

Run from the root of a checkout:  python3 chip_smoke.py
(phase 14 runs it again as `python3 chip_smoke.py --serve-file FILE DIR` in
its fresh processes, phase 16 as `python3 chip_smoke.py --ddp-rank R DIR` and
phase 17 as `python3 chip_smoke.py --spatial-rank R DIR` in its ranks)
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import hashlib
import importlib
import importlib.util
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HW = (1088, 1920)           # 1080p padded to the stride-64 multiple
SMALL_HW = (256, 256)       # fp32 GPU vs CPU reference size
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
K2_TOL, K3_TOL = 0.03, 0.02
# K5 against its plain version in bf16, max|err| / max|ref|: each side's own
# rounding of the output may go either way, one ulp (up to 2^-7 of a value)
# apart, twice that for room
K5_TOL = 2.0 ** -6
# K5's shapes (N, H, W, C, G) that tests/test_torch_cuda.py holds it to:
# WIDERFACE-L's five head levels at HW, TT100K-L's first at TT_HW, batch 2,
# and FCOS's 256 channels in 32 groups
K5_SHAPES = ((1, 272, 480, 128, 16), (1, 136, 240, 128, 16), (1, 68, 120, 128, 16),
             (1, 34, 60, 128, 16), (1, 17, 30, 128, 16), (1, 512, 512, 128, 16),
             (2, 68, 120, 128, 16), (1, 100, 152, 256, 32),
             (1, 112, 176, 256, 32), (1, 7, 11, 256, 32))  # FCOS-R50-FPN's P3 and P7
# bf16 engines, max|err| / max|ref| of the dense outputs: a random deep net
# amplifies bf16 rounding (each bf16 engine lands 3-4% from fp32 at small
# sizes on the CPU), and the kernels round at other places (fp32 normalize in
# the stem, one rounding after the folded BN) than the plain engine. So the
# kernel engine must stay near the plain one AND no further from fp32.
DENSE_BF16_TOL = 0.1
DENSE_BF16_VS_PLAIN = 1.5
DENSE_FP32_TOL = 1e-3       # GPU vs CPU fp32 engine, max|err| / max|ref|
TIMED_ITERS, WARMUP = 20, 3
# kernel bounds: NVIDIA's H100 SXM data sheet, dense rates (see kernel_bound_ms)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
IOU_FLOPS = 14              # per box pair: 4 min/max, 2 sub, 2 clamp, mul, 2 add/sub,
#                             max, div, compare (K1's IoU test)
GRAPH_LAUNCHES = 20         # kernel timing: launches per CUDA graph
COLD_BYTES = 100 * 2 ** 20  # cold timing rotates over more inputs than the L2 holds
PROFILED_FRAMES = 5
# the hand-written kernels' names in a profile, per wrapper (K1 launches two):
# an engine's (K1-K5), and K6, which a train step launches and no engine
ENGINE_KERNELS = {"pair_conv3x3": ("pair_conv_kernel",), "stem_conv": ("stem_conv_kernel",),
                  "nms_mask_sorted": ("nms_iou_kernel", "nms_walk_kernel"),
                  "int8_conv": ("int8_conv_",),  # K4's three routes' kernels
                  "group_norm_relu": ("group_norm_stats_kernel", "group_norm_relu_kernel")}
KERNEL_NAMES = {**ENGINE_KERNELS, "lfd_assign": ("lfd_assign_kernel",),
                "ms_deform_attn": ("ms_deform_attn_kernel",)}  # K7: Deformable DETR only
ASSIGN_FLOPS = 8            # per (point, real GT row): 4 deltas, 4 compares (K6's hit test)
# K7 at the Deformable DETR cell's frame (mmdetection pads to a divisor of 1)
# and its transformer (8 heads, 4 levels, 4 points, 256 wide)
DETR_HW = (800, 1333)
DETR_MSDA = dict(heads=8, levels=4, points=4, embed_dims=256)
# K7 against its plain version in bf16, max|err| / max|ref|: both round
# nearly the same float32 sum to bf16, so a value on either side of a
# rounding boundary lands one bf16 step apart: one step at the largest
# value is at most 2^-7 of it
K7_TOL = 2.0 ** -7
# engine variants: compile_inference's switches (lfdtpu's defaults: K1 on, K2
# and K3 off); expected_launches counts what one capture of a net launches
VARIANTS = {
    "fp32": dict(precision="fp32"),
    "bf16": dict(precision="bf16"),
    "bf16_kernels": dict(precision="bf16", kernel_convs=True, kernel_stem=True),
    "bf16_plain": dict(precision="bf16", nms_use_kernel=False),
    # a net whose stem K2 does not take (TL-S: 48 channels) serves K1 and K3
    "bf16_k1_k3": dict(precision="bf16", kernel_convs=True),
    # the fused int8 chain (K4 for every int8 conv) and K1; float32 or bf16 head
    "int8": dict(precision="int8"),
    "int8_bf16": dict(precision="int8", int8_head_dtype="bf16"),
}
VAL_IMAGES, VAL_BATCH = 24, 8  # the val loader: the pack's first images
SIO_IMAGES = 6              # JPEGs written from the pack for the SIO evaluation
# training: the WIDERFACE workload's batch, crop, GT padding and optimizer
# (`workloads/WIDERFACE_train/_common.py:82-158`)
TRAIN_HW, TRAIN_BATCH, TRAIN_NMAX = (480, 480), 64, 200
TRAIN_STEPS = 20
TRAIN_SMALL_HW = (128, 128)  # GPU vs CPU, batch 2
TRAIN_TOL = 1e-3            # GPU vs CPU fp32 steps, max|err| / max|ref|
SERVE_HW = (480, 480)       # the trained net's engine
# the workload phase: pack size and the checks' tolerances
PACK_IMAGES, PACK_NEG_EVERY = 170, 5  # 136 positives: 3 iterations of 52 + 12 negs
AUG_TOL = 1e-3              # device-aug GPU vs CPU, pixel units (0-255)
LOSS_BLOWUP = 1.5           # the last loss may not exceed the first by more
SERVE_THRESHOLD = 1e-4      # the workload checkpoint's engine, see workload_phase
# the traffic workloads (phases 9 and 10)
TT_HW = (2048, 2048)        # a TT100K frame, a multiple of every stride
TL_HW = (768, 1280)         # 720p padded to the stride-64 multiple
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
CLS_STD = 0.2               # the traffic classifiers' output conv, see build_detector
TRAFFIC = {  # zoo name: (frame, the workload's normalize and BGR -> RGB, engine switches,
    #                     batches)
    "TT100K-L": (TT_HW, (MEAN, STD, False), dict(), (1, 4)),
    "TL-L": (TL_HW, (*IMAGENET, True), dict(class_agnostic=True), (1,)),
    "TL-S": (TL_HW, (*IMAGENET, True), dict(class_agnostic=True), (1,)),
}
SERVED_FRAMES = 3           # frames each traffic main path serves
TT_PACK_POS, TT_PACK_BARE = 100, 8  # 2 iterations of 58 positives (+ 6 negatives) at batch 64
TL_PACK_IMAGES = 20         # 16 with lights: 4 iterations at batch 4
TT_HOST_EPOCHS = 1          # TT100K's host-aug run (2 iterations at its 5-6 images/s)
EVAL_IMAGES = 4             # TT100K images scored by evaluation.py
TRAIN_SERVE_HW = (768, 1280)  # the trained traffic nets' engines
TT_TRAIN_HW, TT_TRAIN_NMAX = (512, 512), 100  # the TT100K workload's crop and GT rows
# FCOS-R50-FPN (phase 12): mmdetection's fcos_r50_caffe_fpn_gn-head_1x_coco.py
FCOS_FRAME = (800, 1333)    # its test scale; predict pads it to 896x1408 (128)
FCOS_HW = (896, 1408)
FCOS_SMALL_HW = (256, 384)  # fp32 GPU vs CPU
FCOS_TRAIN_SMALL_HW = (256, 256)  # fp32 train steps GPU vs CPU, batch 2
FCOS_FRAMES = 3             # frames predicted per precision on the main path
FCOS_TRAIN_BATCHES = (2, 8)  # the published per-GPU batch, and 8
FCOS_STEPS = 6
FCOS_NMAX = 100
# the int8 engine (phase 13)
INT8_FRAMES = 3             # frames each int8 engine serves on the main path
INT8_CORR, INT8_RATIO = 0.95, (0.8, 1.25)  # lfdtpu's criteria against fp32
# the narrow LFDs' int8 paths (narrow_int8_path): frame, the workload's
# device preprocess (None: WIDERFACE's), engine switches, build seed, K4's
# launches a frame by route, and K4's shapes also timed against the plain
# version and cuDNN (time_k4's `timed`)
NARROW_INT8 = {
    "WIDERFACE-XS": (HW, None, dict(), 6, {"mma": 0, "stem": 1, "wgmma": 34},
                     (("XS stem0 3x3/s2 3->32", (3, 32, 3, 2, "a")),
                      ("XS stem1 1x1 32->32", (32, 32, 1, 1, "a")))),
    "TL-S": (TL_HW, "TL-S", dict(class_agnostic=True), 4,
             {"mma": 0, "stem": 1, "wgmma": 39},
             (("TL-S stem0 3x3/s2 3->48", (3, 48, 3, 2, "a")),
              ("TL-S stage 0 3x3 48->48, mode a", (48, 48, 3, 1, "a")))),
}
# The widths the wgmma route took in its first design: a conv outside them
# (or the 3 -> 64 stem) went to the mma.sync route then.
FIRST_WGMMA_WIDTHS = (64, 128)
# K4's mma.sync route takes no conv of the zoo's int8 chains: it is held to
# its plain version on these (N, H, W, Cin, Cout, k, stride): Cout 8, 16, 24
# and 96, 5x5 kernels, the flat layout (Cin 3 and 8), odd sizes.
K4_MMA_SHAPES = ((1, 67, 93, 3, 8, 3, 2), (2, 33, 31, 8, 16, 3, 2), (1, 17, 16, 16, 24, 1, 1),
                 (1, 35, 61, 24, 96, 3, 1), (1, 33, 47, 64, 96, 3, 1), (2, 37, 50, 32, 64, 5, 1),
                 (1, 19, 23, 48, 32, 5, 2), (1, 136, 240, 48, 96, 1, 2))
# K4's timed shapes: the first of the main path's calls (the largest level)
# with these (Cin, Cout, k, stride, mode); the first is the kernels line's.
# At 1088x1920: 272x480 (stage 0, the neck's first level), 1088x1920 (stem0)
# and 544x960 (stem1)
K4_TIMED = (
    ("stage 0 3x3 64->64, mode a", (64, 64, 3, 1, "a")),
    ("stage 0 3x3 64->64, int8 residual", (64, 64, 3, 1, "c8")),
    ("stem0 3x3/s2 3->64", (3, 64, 3, 2, "a")),
    ("stem1 1x1 64->64", (64, 64, 1, 1, "a")),
    ("neck 1x1 64->128", (64, 128, 1, 1, "a")),
)


# serving from engine files (phase 14)
FILE_VARIANTS = ("bf16_kernels", "int8", "int8_bf16")  # saved, then loaded afresh
FILE_FRAMES = 2             # frames the built and the loaded engines serve
STREAM_FRAMES = 64          # uint8 numpy frames run_stream serves per depth
STREAM_DEPTHS = (1, 2, 4)
F16_TOL = (0.5, 2e-3)       # lfdtpu's output_dtype="f16" tolerances: boxes px, scores
BUCKET_FRAMES = ((450, 600), (700, 1200), (1000, 1800))  # one per bucket below 4K
# learning (phase 15): lfdtpu's synthetic runs and bars (tests/test_synthetic_e2e.py)
LEARNING_RUNS = (
    ("lfd multiscale", dict(family="lfd", multiscale=True, epochs=80, threshold=0.42,
                            recall_threshold=0.6)),
    ("lfdv2", dict(family="lfdv2", epochs=60, threshold=0.5)),
    ("lfdv2q", dict(family="lfdv2q", epochs=80, threshold=0.5, base_lr=0.025,
                    clip_whole_run=True)),
    ("fcos", dict(family="fcos", epochs=60, threshold=0.5)),
    ("lfd engines", dict(family="lfd", epochs=60, threshold=0.5, engine_quality=True)),
)
# the zoo models tools/int8_quality_cell.py trains, and lfdtpu's int8 bound
# applied to each engine faster than fp32
QUALITY_MODELS, QUALITY_EPOCHS = ("WIDERFACE-XS", "WIDERFACE-L"), 60
ENGINE_DELTA = 0.05
MCNMS_SHAPE, MCNMS_MAX, MCNMS_SCORE_THR, MCNMS_IOU = (4, 1000), 100, 0.05, 0.5
# the trained WIDERFACE-L engines' shapes timed (time_learned_shapes): K3
# at its levels of a 128x128 frame, (H, W), residual; K4's plain version and
# yardstick at its stage-0 3x3
LEARNED_K3 = (((32, 32), True), ((32, 32), False), ((8, 8), True))
LEARNED_K4 = (("stage 0 3x3 64->64 at 32x32, mode a", (64, 64, 3, 1, "a")),)
# data parallelism (phase 16): the two-rank step is held to the one-process
# step after DDP_CHECKED[0] and DDP_CHECKED[1] steps
DDP_CHECKED = (1, 3)
DDP_MODES = {"fp32": dict(), "bf16": dict(mixed_precision=True),
             "fp32 remat": dict(remat=True)}
DDP_WORLD = 2               # ranks on the one card, over gloo
DDP_CHILD_TIMEOUT = 600     # seconds a rank may take, its start included
DDP_ROW_TOL = 1e-3          # val rows of two ranks against one process, max |err|
DDP_SAMPLE_SEED = 31        # the per-sample crop draws of phase 16's order check
# bf16: two ranks round each rank's weight gradients to bf16 before their
# sum, one process once. The two-rank bf16 step is held to the fp32 step:
# at most BF16_BAND times as far from it as the one-process bf16 step is
BF16_BAND = 2.0
# spatial parallelism (phase 17): WIDERFACE-L at the largest of
# DEFAULT_BUCKETS (4K) on SPATIAL_SHAPES of gloo ranks sharing the card, each
# engine variant eager (several ranks: host collectives), SPATIAL_FRAMES
# calls before its peak memory is read; the eval step at each model's test size
SPATIAL_HW = (2160, 3840)
SPATIAL_VHW = ((2160, 3840), (2100, 3712))  # each frame's valid extent
SPATIAL_SHAPES = (  # (label, ranks, spatial axis, global batch)
    ("2 ranks: spatial 2", 2, 2, 1),
    ("4 ranks: 2 data x 2 spatial", 4, 2, 2))
SPATIAL_ENGINES = ("fp32", "bf16_kernels", "int8", "int8_bf16")
SPATIAL_FRAMES = 4
SPATIAL_EVAL = (("WIDERFACE-L", (1088, 1920)), ("FCOS-R50-FPN", (800, 1333)))
SPATIAL_SEED = 23
SPATIAL_CHILD_TIMEOUT = 900  # seconds a rank may take, its start included
# strips against the whole frame on one card: the strips' convs run other
# cuDNN algorithms than the whole frame's, which sum in another order. fp32
# (TF32 off) and the int8 engine's float32 head: the dense outputs within
# DENSE_FP32_TOL (max|err| / max|ref|), every row matched (same label, box
# within 0.1 px, score within 1e-3). bf16 (and int8's bf16 head): a bf16
# rounding that falls the other way moves what follows by 2^-8 and more
# (tests/test_torch_spatial.py's BF16_DENSE_TOL, 2^-4), and at the max_det
# cut dozens of candidates share a few score values (sigmoid of bf16
# logits), so which of the tied ones make the cut turns on that rounding:
# rows within 1 px and 0.02, and a row of one process without a twin only
# with a score within SPATIAL_CUT_TOL of the lowest kept score. Counts
# equal in every engine.
SPATIAL_DENSE_TOL = {"fp32": DENSE_FP32_TOL, "int8": DENSE_FP32_TOL,
                     "bf16_kernels": 2.0 ** -4, "int8_bf16": 2.0 ** -4}
SPATIAL_ROW_TOL = {"fp32": (0.1, 1e-3), "int8": (0.1, 1e-3), "bf16_kernels": (1.0, 0.02),
                   "int8_bf16": (1.0, 0.02)}
SPATIAL_CUT_TOL = 1e-3
# F20: on a spatial axis of 2, every rank's peak memory at most this share of
# one process's (engines; the eval step's at most one process's)
SPATIAL_PEAK_SHARE = 0.65
SPATIAL_CUT_VARIANTS = ("bf16_kernels", "int8_bf16")  # the engines whose cut may trade rows


class SmokeFailure(RuntimeError):
    pass


def zero_counts(counters):
    """Every wrapper's launch count to 0 (K4's per-route counts too)."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def time_ms(fn, iters=TIMED_ITERS, warmup=WARMUP):
    """Mean ms per call by CUDA events around `iters` calls, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, launches=GRAPH_LAUNCHES, reps=5):
    """Device ms per call: CUDA events around `reps` replays of a CUDA graph
    of `launches` calls cycling through `calls` (one per input set), after
    one eager call each and one replay. Replaying keeps the host's cost of an
    eager call (Python, ctypes; tens of µs, more than the small launches
    take on the device) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * reps)


def kernel_work(name, shape, residual=False):
    """(bytes, operations, their type) of one launch: each input read once
    and each output written once, the operations its inputs need.
    shape: (N, H, W) of K3's activations or K2's frame; (B, K) for K1;
    (N, H, W, Cin, Cout, k, stride, mode) for K4; (N, H, W, C) for K5."""
    if name == "pair_conv3x3":
        n, h, w = shape
        act = n * h * w * 64 * 2  # bf16 NHWC
        weights = 9 * 64 * 64 * 2 + 2 * 64 * 4  # + fp32 scale, bias
        return act * (3 if residual else 2) + weights, 2 * n * h * w * 64 * 9 * 64, "bf16"
    if name == "stem_conv":
        n, h, w = shape
        out = n * ((h + 1) // 2) * ((w + 1) // 2)
        consts = 27 * 64 * 4 + 2 * 3 * 4 + 2 * 64 * 4  # fp32 weights, mean/std, scale/bias
        return n * h * w * 3 + out * 64 * 2 + consts, 2 * out * 64 * 27, "bf16"
    if name == "nms_mask_sorted":
        b, k = shape  # fp32 xyxy boxes and a bool mask in, a bool mask out
        return b * k * (16 + 1 + 1), b * k * (k - 1) // 2 * IOU_FLOPS, "fp32"
    if name == "int8_conv":
        # shape (N, H, W, Cin, Cout, k, stride, mode): mode "a" int8 out, "b"
        # f32 out, "c8" int8 out with an int8 residual, "cf" with an f32 one
        n, h, w, cin, cout, k, stride, mode = shape
        p = k // 2
        ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
        outs = n * ho * wo * cout
        consts = cout * k * k * cin + 2 * cout * 4  # int8 weights, fp32 mult and bias
        # a strided 1x1 conv reads only the pixels it samples
        ins = n * ho * wo * cin if k == 1 else n * h * w * cin
        nbytes = (ins + consts + outs * (4 if mode == "b" else 1)
                  + outs * {"a": 0, "b": 0, "c8": 1, "cf": 4}[mode])
        return nbytes, 2 * outs * k * k * cin, "int8"
    if name == "group_norm_relu":
        # shape (N, H, W, C), bf16: the statistics need the whole map before
        # the first output, so the map is read twice and written once
        n, h, w, c = shape
        return 3 * n * h * w * c * 2 + 2 * c * 4, 5 * n * h * w * c, "fp32"
    if name == "ms_deform_attn":
        # shape (tokens, queries), Deformable DETR's transformer: the bf16
        # map read once, 12 bytes a sample, the bf16 output written once
        # (the benchmark's msda_roofline); a multiply-add a channel for each
        # of a sample's 4 corners, 32 channels a head
        from benchmark.core import msda_roofline

        tokens, queries = shape
        t = DETR_MSDA
        samples = queries * t["heads"] * t["levels"] * t["points"]
        return (msda_roofline.call_bytes(tokens, queries, t),
                samples * 4 * 2 * t["embed_dims"] // t["heads"], "fp32")
    if name == "lfd_assign":
        # shape (B, P, C, N, R): R real GT rows of B x N. The float32 targets
        # (B, P, C + 4) written; each point's 7 constants, the mask and the
        # real rows' xywh and int64 label read; the hit test of every point
        # against its image's real rows
        b, p, c, n, r = shape
        return b * p * (c + 4) * 4 + p * 7 * 4 + b * n + r * 24, p * r * ASSIGN_FLOPS, "fp32"
    raise ValueError(f"unknown kernel {name}")


def kernel_bound_ms(name, shape, residual=False):
    """The least time the card could take for one launch: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    their type (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 tensor, 1,979 TOP/s
    int8 tensor, 67 TFLOP/s fp32). Returns (ms, "bytes" or "operations"),
    whichever binds."""
    nbytes, ops, kind = kernel_work(name, shape, residual)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_shapes(hw=HW):
    """K3's (H, W) in the engine: the stride-4, -8 and -16 levels."""
    h, w = (hw[0] + 3) // 4, (hw[1] + 3) // 4
    return (h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 3) // 4, (w + 3) // 4)


# --------------------------------------------------------------------- model

def build_detector(device, seed=0, size="L", name=None, cls_std=None):
    """WIDERFACE-L (or `size`, or the zoo's `name`) at full width, seeded
    init, randomized norms and Scales; with `cls_std`, the classifier's
    output conv drawn at that std (a 45-class softmax of the init's N(0,
    0.01) head is near uniform on any frame: every score a near tie)."""
    import torch

    from lfdtpu_torch import zoo

    det = zoo.ZOO[name]() if name else zoo.widerface_lfd(size)
    g = torch.Generator().manual_seed(seed)
    det.init(g)
    with torch.no_grad():
        if cls_std is not None:
            det.net._head.head0_classification_path[-1].weight.normal_(0.0, cls_std,
                                                                       generator=g)
    randomize_norms_(det.net, g)
    det.net.to(device).eval()
    return det


def randomize_norms_(net, g):
    """Norm affines, BatchNorm statistics and Scales drawn from `g` (an init
    has identity norms and unit Scales, which would leave the BN folding and
    the Scales unexercised)."""
    import torch
    from torch import nn

    from lfdtpu_torch.models.layers import Scale

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            if isinstance(m, Scale):
                m._scale.uniform_(0.5, 1.5, generator=g)


def frames(rng, n, hw):
    return rng.randint(0, 256, (n,) + tuple(hw) + (3,)).astype(np.uint8)


def expected_launches(det, switches):
    """K1-K5 launches of one captured frame of an engine of `det` with
    compile_inference's `switches`, counted from the net: K1 once unless
    the NMS kernel is off, K2 once with the stem kernel, K3 twice for each
    FasterBlock that deploy/kernel_net.py::eligible_faster_block routes
    (bf16 kernel_convs engines), K4 once for each unit of the int8 chain's
    plan (deploy/int8_net.py::planned_launches; int8 engines), K5 once for
    each GroupNorm call of the head (kernel_net.group_norm_calls; every
    engine but a mesh engine split over rows). A batch launches each as
    often as a frame."""
    from lfdtpu_torch.deploy.kernel_net import eligible_faster_block, group_norm_calls

    from lfdtpu_torch.deploy.int8_net import planned_launches

    blocks = sum(map(eligible_faster_block, det.net.modules()))
    convs = switches.get("kernel_convs", False) and switches.get("precision") == "bf16"
    int8 = switches.get("precision") == "int8"
    return {"nms_mask_sorted": int(switches.get("nms_use_kernel", True)),
            "stem_conv": int(switches.get("kernel_stem", False)),
            "pair_conv3x3": 2 * blocks if convs else 0,
            "int8_conv": planned_launches(det.net) if int8 else 0,
            "group_norm_relu": group_norm_calls(det.net)}


def kernel_variant(det):
    """The bf16 variant with every kernel `det`'s net takes: K2 only where
    deploy/kernel_net.py::eligible_stem holds (TL-S's stem is 48 wide: its
    engines run K1 and K3)."""
    from lfdtpu_torch.deploy.kernel_net import eligible_stem

    return "bf16_kernels" if eligible_stem(det.net) else "bf16_k1_k3"


# ----------------------------------------------------------------- engine

def k5_inputs(device, g, n, h, w, c, dtype, offset=0.0, spread=1.0):
    """An NHWC map whose channels differ in mean and scale, and K5's float32
    gamma and beta."""
    import torch

    x = (torch.randn(n, h, w, c, generator=g, device=device)
         * (torch.rand(c, generator=g, device=device) + 0.5) * spread
         + torch.randn(c, generator=g, device=device) + offset)
    return (x.to(dtype), torch.rand(c, generator=g, device=device) + 0.5,
            torch.randn(c, generator=g, device=device))


def compile_engine(det, hw, device, variant, batch_size=1, captured=None, preprocess=None,
                   **kw):
    """One engine of VARIANTS: captured (the default on the card) or eager;
    WIDERFACE's device preprocess unless another is given."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    return compile_inference(det, hw, preprocess=preprocess or make_device_preprocess(MEAN, STD),
                             batch_size=batch_size, device=device, captured=captured,
                             **VARIANTS[variant], **kw)


def compile_engines(det, hw, device):
    """The captured engines the main path serves and the parity check reads."""
    engines = {name: compile_engine(det, hw, device, name)
               for name in ("fp32", "bf16_kernels", "bf16_plain")}
    engines["bf16_kernels_b4"] = compile_engine(det, hw, device, "bf16_kernels", batch_size=4)
    for name, engine in engines.items():
        check(engine.captured, f"compile_inference returned an eager {name} engine on the card")
    return engines


PROFILE_MARK = "lfd_counted_window"
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: the device-side bracket
SPIN_CYCLES = 1000


def profiled(warm, work):
    """torch.profiler over `work()`, which ends synchronized. The trace has
    been seen to miss a kernel launched right after it starts (one K2 launch
    of five, on the eager and on the captured engine), so `warm()` runs
    first inside the trace and the device drains. Then `work()` runs inside
    a record_function range named PROFILE_MARK, bracketed on the device by
    two torch.cuda._sleep kernels: device_events returns what started
    between them, on the device's own clock (the host's range start has
    been seen to fall after the first kernels of a replay that began at
    once, so a window on the host's clock lost them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(0.005)
        with record_function(PROFILE_MARK):
            torch.cuda._sleep(SPIN_CYCLES)
            out = work()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
    return prof, out


def device_events(prof):
    """(the device events of a profiled trace's counted window, what the
    window is): what started between its two spin kernels, on the device's
    own clock; a trace without the spin pair fails."""
    from torch.autograd import DeviceType

    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = sorted((e.time_range.start, e.time_range.end) for e in cuda
                   if SPIN_KERNEL in e.name)
    check(len(spins) == 2, f"a profiled trace holds {len(spins)} {SPIN_KERNEL} events, "
          "not the 2 that bracket its window on the device")
    lo, hi = spins[0][1], spins[1][0]
    what = "window: device clock between the spin kernels"
    # (the range itself also shows up as a device-side annotation: not work)
    dev = [e for e in cuda if e.name != PROFILE_MARK and SPIN_KERNEL not in e.name
           and lo <= e.time_range.start <= hi]
    return dev, what


def kernel_launches_in(prof, names=ENGINE_KERNELS):
    """({wrapper name: launches} of `names`, the window it was counted in)
    from a profile's device events by kernel name: what a CUDA graph's
    replays launch, which the wrappers' host counters do not see (K1's two
    kernels count as one launch). Any other hand-written kernel in the
    window fails: an engine launches no K6, a train step no engine kernel."""
    counts = {name: 0 for name in KERNEL_NAMES}
    events, what = device_events(prof)
    for e in events:
        for name, keys in KERNEL_NAMES.items():
            if keys[0] in e.name:
                counts[name] += 1
    stray = {k: n for k, n in counts.items() if n and k not in names}
    check(not stray, f"the profiled window launched {stray}, which its path does not run")
    return {k: counts[k] for k in names}, what


def serve(det, engines, hw, rng):
    """The main path: 8 single frames and one batch of 4 with different
    valid extents, through the predict entry points. Returns the rows."""
    h, w = hw
    singles = []
    for i in range(8):
        singles.append(frames(rng, 1, (h - 8 - i * (h // 32), w - i * (w // 16)))[0])
    rows_single = [det.predict_for_single_image_with_engine(engines["bf16_kernels"], f)
                   for f in singles]
    batch = [frames(rng, 1, s)[0] for s in ((h - 8, w), (h * 2 // 3, w * 2 // 3),
                                             (h, w * 3 // 4), (h // 2, w // 3))]
    rows_batch = det.predict_for_batch_with_engine(engines["bf16_kernels_b4"], batch)
    for rows, img in zip(rows_single + rows_batch, singles + batch):
        check_rows(det, rows, img)
    return rows_single, rows_batch


def check_rows(det, rows, img):
    """Reference result rows [label, score, x, y, w, h] of one image."""
    arr = np.asarray(rows, np.float64).reshape(-1, 6)
    check(np.isfinite(arr).all(), "non-finite detection rows")
    check(len(arr) <= det.post_nms_bbox_limit, "more rows than max_det")
    if len(arr):
        check(((arr[:, 0] >= 0) & (arr[:, 0] < det.num_classes)
               & (arr[:, 0] == np.round(arr[:, 0]))).all(), "label outside the classes")
        check(((arr[:, 1] > 0) & (arr[:, 1] <= 1)).all(), "score outside (0, 1]")
        x2 = arr[:, 2] + arr[:, 4] - 1
        y2 = arr[:, 3] + arr[:, 5] - 1
        check((arr[:, 2] >= 0).all() and (x2 <= img.shape[1] + 1e-3).all()
              and (arr[:, 3] >= 0).all() and (y2 <= img.shape[0] + 1e-3).all(),
              "box outside the image's valid extent")


def check_engine_parity(det, engines, hw, rng, label="WIDERFACE-L"):
    import torch

    imgs = frames(rng, 1, hw)
    vhw = np.asarray([hw[0] - 8, hw[1]], np.float32)
    ck, rk = engines["bf16_kernels"].dense(imgs)
    cp, rp = engines["bf16_plain"].dense(imgs)
    cf, rf = engines["fp32"].dense(imgs)
    ec, er = rel_err(ck, cp), rel_err(rk, rp)
    kc, kr = rel_err(ck, cf), rel_err(rk, rf)
    pc, pr = rel_err(cp, cf), rel_err(rp, rf)
    print(f"{label} engine bf16 dense max|err|/max|ref|: kernels vs plain cls {ec:.3e} reg "
          f"{er:.3e} (tol {DENSE_BF16_TOL}); vs fp32: kernels cls {kc:.3e} reg "
          f"{kr:.3e}, plain cls {pc:.3e} reg {pr:.3e} (kernels within "
          f"{DENSE_BF16_VS_PLAIN}x of plain)")
    check(ec < DENSE_BF16_TOL and er < DENSE_BF16_TOL,
          "bf16 kernel engine disagrees with the plain bf16 engine")
    check(kc <= DENSE_BF16_VS_PLAIN * pc + 1e-3 and kr <= DENSE_BF16_VS_PLAIN * pr + 1e-3,
          "bf16 kernel engine is further from fp32 than the plain bf16 engine")
    dk = engines["bf16_kernels"].decode(ck, rk, vhw)
    dp = engines["bf16_plain"].decode(ck, rk, vhw)
    same = all(torch.equal(dk[k], dp[k]) for k in dk)
    print(f"{label} decode + NMS on the same dense outputs, K1 vs plain: "
          f"{int(dk['count'][0])} rows, labels {sorted(set(dk['labels'][0].tolist()))[:12]}, "
          f"identical={same}")
    check(same, "decode with K1 differs from decode with the plain NMS")
    return imgs


def captured_vs_eager(det, hw, device, rng, name, batch, label, captured=None,
                      preprocess=None, **kw):
    """A captured engine of variant `name` (built here unless given)
    against an eager engine of the same build on two different frames in a
    row: the same count and labels, boxes and scores bit-equal; the first
    result survives the second call; its capture recorded the launches that
    expected_launches counts from the net."""
    import torch

    if captured is None:
        captured = compile_engine(det, hw, device, name, batch_size=batch,
                                  preprocess=preprocess, **kw)
    eager = compile_engine(det, hw, device, name, batch_size=batch, captured=False,
                           preprocess=preprocess, **kw)
    check(captured.captured and not eager.captured, "wrong engine form")
    want = expected_launches(det, VARIANTS[name])
    got = captured.captured_launches
    f1, f2 = frames(rng, batch, hw), frames(rng, batch, hw)
    vhw = np.asarray([[hw[0] - 8 * i, hw[1] - 16 * i] for i in range(batch)], np.float32)
    r1 = captured(f1, vhw)
    kept = {k: v.clone() for k, v in r1.items()}
    r2 = captured(torch.as_tensor(f2, device=device), torch.as_tensor(vhw, device=device))
    e1, e2 = eager(f1, vhw), eager(f2, vhw)
    torch.cuda.synchronize()
    survived = all(torch.equal(r1[k], kept[k]) for k in kept)
    differ = not torch.equal(r1["scores"], r2["scores"])
    same = all(torch.equal(r[k], e[k]) for r, e in ((r1, e1), (r2, e2)) for k in r)
    key = f"{label} {name} batch {batch}"
    print(f"captured vs eager {key}: rows {r1['count'].tolist()} and "
          f"{r2['count'].tolist()}, bit-equal={same}, first result survives={survived}, "
          f"frames differ={differ}, K1/K2/K3 per capture {tuple(got.values())} "
          f"(counted from the net {tuple(want.values())})")
    check(got == want, f"{key}: a capture should launch {want}")
    check(int(r1["count"].sum()) > 0 and int(r2["count"].sum()) > 0, f"{key}: no rows")
    check(same, f"{key}: the captured engine's rows differ from the eager engine's")
    check(survived, f"{key}: a result did not survive the next call")
    check(differ, f"{key}: two different frames gave the same result")
    del captured, eager
    torch.cuda.empty_cache()


def check_fp32_reference(det, device, rng, preprocess=None, **kw):
    """The fp32 engine on the GPU against the fp32 port on the CPU."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    pre = preprocess or make_device_preprocess(MEAN, STD)
    gpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device=device, **kw)
    cpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device="cpu", **kw)
    imgs = frames(rng, 1, SMALL_HW)
    vhw = np.asarray(SMALL_HW, np.float32)
    (cg, rg), (cc, rc) = gpu.dense(imgs), cpu.dense(imgs)
    ec, er = rel_err(cg.cpu(), cc), rel_err(rg.cpu(), rc)
    print(f"fp32 {SMALL_HW} dense GPU vs CPU: cls {ec:.3e}, reg {er:.3e} "
          f"max|err|/max|ref| (tol {DENSE_FP32_TOL}, TF32 off)")
    check(ec < DENSE_FP32_TOL and er < DENSE_FP32_TOL, "fp32 GPU engine disagrees with CPU")
    dg = {k: v.cpu().numpy() for k, v in gpu(imgs, vhw).items()}
    dc = {k: v.numpy() for k, v in cpu(imgs, vhw).items()}
    ng, nc = int(dg["count"][0]), int(dc["count"][0])
    # near-tied scores may swap the greedy order: match rows, not positions
    matched = 0
    for i in range(ng):
        d = (np.abs(dc["scores"][0, :nc] - dg["scores"][0, i]) < 1e-4) & \
            (np.abs(dc["boxes"][0, :nc] - dg["boxes"][0, i]).max(-1) < 0.05) & \
            (dc["labels"][0, :nc] == dg["labels"][0, i])
        matched += bool(d.any())
    print(f"fp32 {SMALL_HW} detections GPU vs CPU: {ng} vs {nc} rows, "
          f"{matched} GPU rows matched (score 1e-4, box 0.05 px)")
    check(ng > 0 and abs(ng - nc) <= 2 and matched >= 0.9 * ng,
          "fp32 GPU detections disagree with the CPU reference")


# ----------------------------------------------------------------- train

def train_schedule():
    """The workload's lr: base 0.1, milestones (500, 700, 900), linear
    warmup over 200 iterations from ratio 0.1."""
    from lfdtpu_torch.execution import MultiStepLRSchedule, WarmupSetting

    return MultiStepLRSchedule(0.1, (500, 700, 900), 0.1,
                               WarmupSetting(False, "linear", 200, 0.1))


def train_batch(rng, n, hw, nmax, num_classes=1, top=None):
    """Seeded uint8 frames and GT padded to `nmax` rows: 0 to 30 boxes per
    image (about 20% of images none, the sampler's neg_ratio 0.2), sides
    log-uniform over 4 px to `top` (default: the WIDERFACE scales' 320,
    capped at 0.8 of the crop), aspect 0.7..1.3, inside the crop, labels
    drawn over `num_classes`."""
    images = frames(rng, n, hw)
    gt = np.zeros((n, nmax, 4), np.float32)
    labels = np.zeros((n, nmax), np.int32)
    mask = np.zeros((n, nmax), bool)
    top = top or min(320.0, 0.8 * min(hw))
    for i in range(n):
        k = 0 if rng.rand() < 0.2 else rng.randint(1, 31)
        side = np.exp(rng.uniform(np.log(4.0), np.log(top), k))
        aspect = rng.uniform(0.7, 1.3, k)
        w = np.minimum(side * aspect, hw[1])
        h = np.minimum(side / aspect, hw[0])
        x = rng.uniform(0, 1, k) * (hw[1] - w)
        y = rng.uniform(0, 1, k) * (hw[0] - h)
        gt[i, :k] = np.stack([x, y, w, h], -1)
        mask[i, :k] = True
        if num_classes > 1:
            labels[i, :k] = rng.randint(0, num_classes, k)
    return images, gt, labels, mask


def init_weights(seed, name="WIDERFACE-L"):
    """The zoo model's state_dict from lfdtpu's initializers, seeded."""
    import torch

    from lfdtpu_torch import zoo

    det = zoo.ZOO[name]()
    det.init(torch.Generator().manual_seed(seed))
    return det.net.state_dict()


def make_trainer(device, hw, weights, mixed_precision=False, factory=None, remat=False,
                 mesh=None):
    """A fresh WIDERFACE-L (or factory()) with `weights`, its TrainState on
    `device` (or the rank's device of a data `mesh`) and the train step:
    SGD momentum 0.9, wd 1e-4, clip 10, uint8 frames through the (0.5, 0.5)
    device preprocess, remat and the mesh as asked."""
    from lfdtpu_torch import zoo
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    det = factory() if factory else zoo.widerface_lfd("L")
    det.net.load_state_dict(weights)
    state = create_train_state(det, SGD(momentum=0.9, weight_decay=1e-4), device=device,
                               mesh=mesh)
    step = make_train_step(det, state.optimizer, hw, clip_max_norm=10.0,
                           preprocess=make_device_preprocess(MEAN, STD),
                           mixed_precision=mixed_precision, remat=remat, mesh=mesh)
    return det, step


def check_train_gpu_vs_cpu(device, factory=None, label="WIDERFACE-L", num_classes=1,
                           hw=TRAIN_SMALL_HW):
    """Two fp32 steps at 128x128, batch 2, on the GPU and on the CPU from
    the same weights and batch. The weights have randomized norm affines and Scales (build_detector): a
    parameter that starts at zero would be held to the relative error of
    its update alone. factory: a detector with such weights (WIDERFACE-L's
    by default); num_classes: the classes the GT labels are drawn over; hw:
    the input size. Returns the GPU's net, the two steps' learning rates and
    the starting weights (a CPU state_dict)."""
    weights = (factory() if factory else build_detector("cpu", seed=7)).net.state_dict()
    batch = train_batch(np.random.RandomState(7), 2, hw, TRAIN_NMAX, num_classes=num_classes)
    lrs = [train_schedule()(0, it) for it in range(2)]
    runs = {}
    for dev in (device, "cpu"):
        det, step = make_trainer(dev, hw, weights, factory=factory)
        metrics = [step(*batch, lr, True) for lr in lrs]
        runs[dev] = (det.net, metrics)
    (gnet, gm), (cnet, cm) = runs[device], runs["cpu"]
    worst = {}
    for i, (g, c) in enumerate(zip(gm, cm)):
        for k in ("loss", "grad_norm"):
            worst[f"step{i + 1} {k}"] = rel_err(g[k].cpu(), c[k])
    csd = cnet.state_dict()
    for kind in ("param", "running"):
        errs = {k: rel_err(v.cpu(), csd[k]) for k, v in gnet.state_dict().items()
                if v.is_floating_point() and ("running" in k) == (kind == "running")}
        name = max(errs, key=errs.get)
        worst[f"{kind} (worst of {len(errs)}: {name})"] = errs[name]
    print(f"train fp32 GPU vs CPU, {label} {hw[0]}x{hw[1]} "
          "batch 2, 2 steps, "
          "max|err|/max|ref|: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {TRAIN_TOL}, TF32 off)")
    check(gm[0]["num_pos"].item() > 0, "the small training batch has no positives")
    check(max(worst.values()) < TRAIN_TOL, f"{label}: GPU train steps disagree with the CPU")
    return gnet, lrs, weights


def assign_args(det, hw, gt, labels, mask):
    """The arguments the detector's train step hands lfd_assign (K6) for a
    batch's GT on its device (models/detector.py::LFD._assign)."""
    info = det.level_arrays(hw, gt.device)
    return (info["points"], info["strides"], info["ranges"], info["gray_ranges"], gt, labels,
            mask, det.num_classes, det.range_assign_mode,
            det.regression_loss_type == "independent")


def check_assign_kernel(det, hw, gt, labels, mask, label):
    """K6 against its plain version on the card, on the same tensors: one
    launch, both outputs equal (torch.equal)."""
    import torch

    from lfdtpu_torch.ops import assign

    args = assign_args(det, hw, gt, labels, mask)
    before = assign.lfd_assign.launches
    got = assign.lfd_assign(*args)
    launched = assign.lfd_assign.launches - before
    want = assign.lfd_assign_plain(*args)
    torch.cuda.synchronize()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"K6 {label} batch {gt.shape[0]} {hw[0]}x{hw[1]}, C {det.num_classes}, N "
          f"{gt.shape[1]} ({int(mask.sum())} real rows): {launched} launch, cls and reg equal "
          f"to the plain version {same}, positives {int((got[0] > 0).any(-1).sum())}")
    check(launched == 1 and all(same), f"K6 disagrees with its plain version ({label})")


def train_full_width(device, card, model="WIDERFACE-L", hw=TRAIN_HW, nmax=TRAIN_NMAX):
    """The zoo `model` at full width on its workload's batch (GT padded to
    `nmax` rows, labels over its classes): K6 against its plain version on
    that batch, then TRAIN_STEPS steps in fp32 and in bf16 on it, each step
    one K6 launch, and one more bf16 step profiled (K6 once by kernel name,
    no engine kernel). Returns the bf16-trained detector."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.ops import assign

    weights = init_weights(11, model)
    factory = zoo.ZOO[model]
    batch = [torch.as_tensor(a, device=device) for a in train_batch(
        np.random.RandomState(11), TRAIN_BATCH, hw, nmax,
        num_classes=factory().num_classes)]
    n_boxes = int(batch[3].sum())
    check_assign_kernel(factory(), hw, *batch[1:], model)
    sched = train_schedule()
    for name, mp in (("fp32", False), ("bf16", True)):
        det, step = make_trainer(device, hw, weights, mixed_precision=mp, factory=factory)
        stats0 = {k: v.clone() for k, v in det.net.state_dict().items() if "running" in k}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = assign.lfd_assign.launches
        metrics = [step(*batch, sched(0, it), True) for it in range(TRAIN_STEPS)]
        k6 = assign.lfd_assign.launches - before
        vals = {k: torch.stack([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"train {name} {model} batch {TRAIN_BATCH} {hw[0]}x{hw[1]} "
              f"({n_boxes} GT boxes, Nmax {nmax}): peak {peak:.2f} GiB allocated [{card}]")
        print(f"  loss {vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f} over {TRAIN_STEPS} "
              f"steps, grad_norm {vals['grad_norm'][0]:.3f} -> {vals['grad_norm'][-1]:.3f}, "
              f"num_pos {vals['num_pos'][0]:.0f}, lr {sched(0, 0):.5f} -> "
              f"{sched(0, TRAIN_STEPS - 1):.5f}; K6 launches {k6}")
        check(k6 == TRAIN_STEPS, f"{TRAIN_STEPS} {name} steps launched K6 {k6} times")
        check(all(np.isfinite(v).all() for v in vals.values()),
              f"non-finite train metrics ({name})")
        check(vals["loss"][-1] < vals["loss"][0], f"the {name} loss did not fall")
        check(all(p.dtype == torch.float32 for p in det.net.parameters()),
              f"master weights left fp32 ({name})")
        moved = sum(not torch.equal(v, stats0[k]) for k, v in det.net.state_dict().items()
                    if k in stats0)
        check(moved == len(stats0), f"{len(stats0) - moved} BN running stats did not "
              f"move ({name})")
    lr = sched(0, TRAIN_STEPS)
    prof, _ = profiled(lambda: step(*batch, lr, True), lambda: step(*batch, lr, True))
    counted, window = kernel_launches_in(prof, names=("lfd_assign",))
    print(f"one profiled bf16 step: hand-written kernels by name {counted} ({window})")
    check(counted == {"lfd_assign": 1}, f"a profiled train step launched {counted}")
    return det


def train_to_serve(det, device, counters, classification_threshold=None, preprocess=None,
                   hw=SERVE_HW, **engine_kw):
    """The trained net (left in train mode) into the bf16 engine with every
    kernel its net takes, one frame served; then predict_for_single_image on
    the net itself must leave its running stats and its mode alone. Returns
    the engine's rows."""
    import torch

    from lfdtpu_torch.deploy import make_device_preprocess

    preprocess = preprocess or make_device_preprocess(MEAN, STD)
    variant = kernel_variant(det)
    zero_counts(counters)  # they tick while the engine is built and captured
    engine = compile_engine(det, hw, device, variant, preprocess=preprocess,
                            classification_threshold=classification_threshold, **engine_kw)
    frame = frames(np.random.RandomState(13), 1, (hw[0] - 24, hw[1] - 8))[0]
    rows = det.predict_for_single_image_with_engine(engine, frame)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = expected_launches(det, VARIANTS[variant])
    print(f"trained net served through the captured {variant} engine {hw}: "
          f"{len(rows)} rows; launches at build and capture {launches}, per capture "
          f"{engine.captured_launches} (counted from the net {want})")
    for name, n in want.items():
        check(n == 0 or launches[name] > 0, f"the trained net's engine never launched {name}")
    check(engine.captured and engine.captured_launches == want,
          "the trained net's engine did not capture every kernel")
    check_rows(det, rows, frame)
    check(det.net.training, "the trained net left train mode")
    before = {k: v.clone() for k, v in det.net.state_dict().items()}
    image = copy.deepcopy(preprocess)(torch.as_tensor(frame)).numpy()  # the host's normalize
    rows_direct = det.predict_for_single_image(image)
    same = all(torch.equal(v, before[k]) for k, v in det.net.state_dict().items())
    print(f"predict_for_single_image on the net in train mode: {len(rows_direct)} rows, "
          f"state unchanged={same}, still training={det.net.training}")
    check(same and det.net.training, "predict_for_single_image changed the training net")
    return rows


# --------------------------------------------------------------- workload

def build_pack(path, seed=17):
    """A WIDERFACE-like pack: uint8 BGR arrays 1024 wide, 680-1024 high,
    0-30 face boxes of 4-320 px per image (phase 6's draw), every
    PACK_NEG_EVERY-th image a negative (no boxes)."""
    from lfdtpu_torch.data import Dataset, Parser, Sample

    class SyntheticFaces(Parser):
        def get_meta_info(self):
            return None

        def generate_sample(self):
            rng = np.random.RandomState(seed)
            for i in range(PACK_IMAGES):
                h = int(rng.randint(680, 1025))
                s = Sample()
                s["image"] = rng.randint(0, 256, (h, 1024, 3), dtype=np.uint8)
                if i % PACK_NEG_EVERY != PACK_NEG_EVERY - 1:
                    _, gt, _, mask = train_batch(rng, 1, (h, 1024), 30)
                    boxes = gt[0][mask[0]]
                    if len(boxes) == 0:  # train_batch draws 20% empty: keep a face
                        boxes = np.asarray([[100.0, 100.0, 40.0, 48.0]], np.float32)
                    s["bboxes"] = [[int(v) for v in b] for b in np.maximum(boxes, 1)]
                    s["bbox_labels"] = [0] * len(boxes)
                yield s

    Dataset(parser=SyntheticFaces(), save_path=path, verbose=False)


def script_path(task, script):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "lfdtpu_torch",
                        "workloads", task, script)


def load_script(task, script):
    """A port workload script as a module under a name of its own (every
    task directory holds a _common.py, an evaluation.py, ...)."""
    spec = importlib.util.spec_from_file_location(f"{task}_{script[:-3]}",
                                                  script_path(task, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_config(task, script, pack, device_aug, epochs=2, size="L"):
    """config_dict of a port training script (its task's _common, as the
    script builds it) with the environment overrides of a smoke run."""
    os.environ.update(LFD_DEVICE_AUG=str(int(device_aug)), LFD_EPOCHS=str(epochs),
                      LFD_DATASET_PATH=pack, LFD_DEVICE="cuda")
    common, cfg = load_script(task, "_common.py"), {}
    common.prepare_common_settings(cfg, script_path(task, script))
    common.prepare_model(cfg, size)
    common.prepare_data_pipeline(cfg)
    common.prepare_optimizer(cfg)
    return cfg


def _record_hook():
    import torch

    from lfdtpu_torch.execution import Hook, Priority

    class Record(Hook):
        """Per iteration: the lr and the step's metrics (device tensors, no
        sync)."""

        def __init__(self):
            super().__init__()
            self.priority = Priority.HIGH
            self.lrs, self.metrics = [], []

        def after_train_iter(self, executor):
            self.lrs.append(executor.config_dict["current_lr"])
            self.metrics.append(executor.last_metrics)

        def values(self, key):
            return torch.stack([m[key] for m in self.metrics]).cpu().numpy()

    return Record()


def run_workload(cfg, card, label):
    """Run the config through the Executor: finite losses that do not blow
    up, the lr on the warmup."""
    from lfdtpu_torch.execution import Executor

    rec = _record_hook()
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [rec]
    ex = Executor(cfg)
    ex.run()
    loss = rec.values("loss")
    sched = cfg["lr_schedule"]
    want = [0.1 * (1 - (1 - (i + 1) / 200) * 0.9) for i in range(len(rec.lrs))]
    print(f"workload {label}: {len(rec.lrs)} iterations, loss "
          + " ".join(f"{v:.4f}" for v in loss)
          + f", lr {rec.lrs[0]:.6f} -> {rec.lrs[-1]:.6f} [{card}]")
    check(np.isfinite(loss).all() and np.isfinite(rec.values("grad_norm")).all(),
          f"non-finite losses ({label})")
    check(loss[-1] <= LOSS_BLOWUP * loss[0], f"the loss blew up ({label})")
    check(np.allclose(rec.lrs, want, rtol=1e-12, atol=0)
          and rec.lrs == [sched(0, i) for i in range(len(rec.lrs))],
          f"the lr does not follow the warmup ({label})")
    return ex, rec


def check_aug_gpu_vs_cpu(aug, batch, device, card):
    """The config's DeviceAugment on one loader batch: GPU against CPU
    (pixel units: the normalize divides by 127.5)."""
    import torch

    host = {"buffer": batch["images"], "scale": batch["aug_scale"],
            "translation": batch["aug_translation"], "flip": batch["aug_flip"]}
    cpu = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in host.items()}
    gpu = {k: v.to(device) for k, v in cpu.items()}
    aug_gpu = copy.deepcopy(aug).to(device)
    got = aug_gpu(gpu)
    ref = aug(cpu)
    err = float((got.cpu() - ref).abs().max()) * 127.5
    print(f"device aug {tuple(batch['images'].shape)} -> {tuple(got.shape)}: GPU vs CPU "
          f"max|err| {err:.3e} pixel units (tol {AUG_TOL}) [{card}]")
    check(err <= AUG_TOL, "device aug on the GPU disagrees with the CPU")


class _ValSet:
    """The pack's first VAL_IMAGES images with the image ids that a
    COCOEvaluator matches on."""

    def __init__(self, dataset):
        self._ds, self._indexes = dataset, dataset.get_indexes()[:VAL_IMAGES]

    def __getitem__(self, i):
        sample = dict(self._ds[i])
        sample["image_id"] = int(i) + 1
        return sample

    def __len__(self):
        return len(self._indexes)

    def get_indexes(self):
        return list(self._indexes)


def add_val_loop(cfg, tmp):
    """val_interval 1, a val loader over _ValSet (whole images, padded to
    the batch's largest, the workload's val pipeline) and a COCOEvaluator
    over its boxes. Returns the hook that watches the val passes."""
    import torch

    from lfdtpu_torch.data import (DataLoader, IdleRegionSampler, RandomDatasetSampler,
                                   simple_widerface_val_pipeline)
    from lfdtpu_torch.evaluation import COCOEvaluator
    from lfdtpu_torch.execution import Hook

    val = _ValSet(cfg["train_data_loader"]._dataset)
    images, annotations = [], []
    for i in val.get_indexes():
        s = val[i]
        h, w = s["image"].shape[:2]
        images.append({"id": s["image_id"], "height": h, "width": w, "file_name": f"{i}.jpg"})
        for x, y, bw, bh in s.get("bboxes", []):
            annotations.append({"id": len(annotations) + 1, "image_id": s["image_id"],
                                "category_id": 1, "bbox": [x, y, bw, bh], "iscrowd": 0,
                                "area": bw * bh})
    ann_path = os.path.join(tmp, "val.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "face"}]}, f)
    # a few steps on noise may leave every score under the detector's 0.05:
    # a lower threshold makes the val pass emit rows to evaluate
    cfg["model"].classification_threshold = SERVE_THRESHOLD
    cfg["val_interval"] = 1
    cfg["val_data_loader"] = DataLoader(
        val, RandomDatasetSampler(val, batch_size=VAL_BATCH, shuffle=False), IdleRegionSampler(),
        augmentation_pipeline=simple_widerface_val_pipeline, num_workers=2, pad_divisor=64)
    cfg["evaluator"] = COCOEvaluator(ann_path, {0: 1})

    class WatchVal(Hook):
        """Per val pass: the result lists by image id, and whether the net's
        state (weights, BN statistics) and mode came through unchanged."""

        def __init__(self):
            super().__init__()
            self.passes = []

        def before_val_epoch(self, executor):
            net = executor.state.net
            self._before = {k: v.clone() for k, v in net.state_dict().items()}
            self._results = {}

        def after_val_iter(self, executor):
            c = executor.config_dict
            for rows, meta in zip(c["eval_results"], c["eval_meta"]):
                self._results[meta["image_id"]] = rows

        def after_val_epoch(self, executor):
            net = executor.state.net
            same = all(torch.equal(v, self._before[k]) for k, v in net.state_dict().items())
            self.passes.append(dict(results=self._results, untouched=same and net.training,
                                    metrics=dict(executor.config_dict["evaluator"].metrics)))

    watch = WatchVal()
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [watch]
    return watch, len(annotations)


def check_val_loop(watch, n_boxes, card):
    check(len(watch.passes) == 2, "val_interval 1 over 2 epochs should validate twice")
    for i, p in enumerate(watch.passes):
        rows = sum(len(r) for r in p["results"].values())
        print(f"val pass {i + 1}: {len(p['results'])} images ({n_boxes} GT boxes; fp32 eval "
              f"forward, batch {VAL_BATCH}, decode, COCOEvaluator), {rows} result rows, metrics "
              + ", ".join(f"{k} {v:.4f}" for k, v in p["metrics"].items())
              + f", net state and train mode untouched={p['untouched']} [{card}]")
        check(sorted(p["results"]) == list(range(1, VAL_IMAGES + 1)),
              "not one result list per val image")
        check(p["metrics"] and np.isfinite(list(p["metrics"].values())).all(),
              "non-finite evaluation metrics")
        check(p["untouched"], "the val pass changed the net's state or mode")


def check_sio_evaluation(pack, ckpt, tmp):
    """The port's evaluation.py script over SIO_IMAGES JPEGs written from the
    pack into two event folders: one txt per image, in the WIDERFACE
    format."""
    from lfdtpu_torch.data import Dataset, jpeg_encode

    ds = Dataset(load_path=pack)
    val_root, out_root = os.path.join(tmp, "WIDER_val"), os.path.join(tmp, "sio")
    want = []
    for n, i in enumerate(ds.get_indexes()[:SIO_IMAGES]):
        event = f"{n % 2}--Event{n % 2}"
        os.makedirs(os.path.join(val_root, event), exist_ok=True)
        with open(os.path.join(val_root, event, f"img_{n}.jpg"), "wb") as f:
            f.write(jpeg_encode(ds[i]["image"], quality=90))
        want.append(os.path.join(event, f"img_{n}.txt"))
    script = load_script("WIDERFACE_train", "evaluation.py")
    n = script.run_SIO_evaluation("L", ckpt, val_root, out_root,
                                  classification_threshold=SERVE_THRESHOLD)
    got = sorted(os.path.relpath(os.path.join(d, f), out_root)
                 for d, _, files in os.walk(out_root) for f in files)
    rows = 0
    for rel in got:
        with open(os.path.join(out_root, rel)) as f:
            lines = f.read().splitlines()
        ok = (lines[0] == os.path.basename(rel)[:-4] and int(lines[1]) == len(lines) - 2
              and lines[2] == "0 0 0 0 0.001")
        for line in lines[3:]:
            parts = line.split(" ")
            ok = ok and len(parts) == 5 and all(p.lstrip("-").isdigit() for p in parts[:4]) \
                and re.fullmatch(r"[01]\.\d{3}", parts[4]) is not None
        check(ok, f"{rel} is not in the WIDERFACE result format")
        rows += len(lines) - 3
    print(f"SIO evaluation script: {n} JPEGs (quality 90, from the pack), {len(got)} txt "
          f"files, {rows} rows")
    check(n == SIO_IMAGES and got == sorted(want) and rows > 0,
          "the SIO evaluation did not write one txt per image")


def workload_phase(device, card, counters):
    """Phase 8: the WIDERFACE training entry point, end to end."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.execution import ProfilerHook

    task, script = "WIDERFACE_train", "WIDERFACE_LFD_L.py"
    zero_counts(counters)
    tmp = tempfile.mkdtemp(prefix="lfd_workload_")
    cwd, hook, env = os.getcwd(), sys.excepthook, dict(os.environ)
    try:
        os.chdir(tmp)  # the scripts' work dirs go under the temp dir
        pack = os.path.join(tmp, "widerface_synthetic.pkl")
        build_pack(pack)
        print(f"pack: {PACK_IMAGES} images ({os.path.getsize(pack) / 2 ** 20:.0f} MiB)")

        cfg = workload_config(task, script, pack, device_aug=True)
        watch, n_boxes = add_val_loop(cfg, tmp)
        ex, rec = run_workload(cfg, card, "device aug, 2 epochs, a val pass after each")
        check_val_loop(watch, n_boxes, card)
        work = cfg["work_dir"]
        ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pth"))
        print(f"checkpoints: {ckpts}")
        check(ckpts == ["epoch_1.pth"], "the workload wrote no epoch_1.pth")
        ckpt_path = os.path.join(work, "epoch_1.pth")
        saved = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        aug_batch = next(iter(cfg["train_data_loader"]))
        del ex

        cfg2 = workload_config(task, script, pack, device_aug=True)
        cfg2["resume_path"] = ckpt_path
        prof = ProfilerHook(os.path.join(tmp, "trace"), start_iter=4, num_iters=2)
        cfg2["extra_hooks"] = [prof]
        from lfdtpu_torch.execution import Executor

        resumed = Executor(cfg2)
        same = all(torch.equal(v.cpu(), saved["state_dict"][k])
                   for k, v in resumed.state.net.state_dict().items())
        counters_ok = (cfg2["epoch"], cfg2["train_iter"]) == (1, 3)
        print(f"resumed from epoch_1.pth: epoch {cfg2['epoch']}, train_iter "
              f"{cfg2['train_iter']}, params and BN stats equal the saved ones: {same}")
        check(same and counters_ok, "resume did not restore the checkpoint exactly")
        resumed.run()
        check(cfg2["train_iter"] == 6, "the resumed run did not train one more epoch")
        check(os.path.isfile(os.path.join(tmp, "trace", "trace.json")),
              "the profiler hook wrote no trace of train iterations 5-6")
        final = os.path.join(work, "final.pth")
        resumed.save(final)
        del resumed

        host_cfg = workload_config(task, script, pack, device_aug=False)
        host_ex, _ = run_workload(host_cfg, card, "host aug, 2 epochs")
        del host_ex

        check_aug_gpu_vs_cpu(cfg["device_augment"], aug_batch, device, card)

        print("engine kernel launches during training (K1 in the val loop's decode; K6, "
              "counted in main, assigns the targets): "
              f"{ {c.__name__: c.launches for c in counters} }")
        det = zoo.widerface_lfd("L")
        det.net.load_state_dict(torch.load(final, map_location="cpu",
                                           weights_only=True)["state_dict"])
        det.net.to(device)
        # nine steps on noise leave every score under the detector's 0.05:
        # a lower threshold makes the engine emit rows to check
        rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD)
        check(len(rows) > 0, "the trained checkpoint's engine returned no rows")
        check_sio_evaluation(pack, final, tmp)
    finally:
        os.chdir(cwd)
        sys.excepthook = hook
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- timings

def k2_inputs(device, g, n, hw):
    """K2's arguments at (n, *hw): a uint8 frame, its weights, WIDERFACE's
    normalize in pixel units and a folded BN's scale and bias."""
    import torch

    frame = torch.randint(0, 256, (n,) + tuple(hw) + (3,), generator=g, device=device,
                          dtype=torch.uint8)
    w = torch.randn(3, 3, 3, 64, generator=g, device=device) * 0.2
    mean = std = torch.full((3,), 127.5, device=device)
    return (frame, w, mean, std, torch.rand(64, generator=g, device=device) + 0.5,
            torch.randn(64, generator=g, device=device) * 0.1)


def k3_consts(device, g):
    """K3's bf16 weights and a folded BN's scale and bias."""
    import torch

    wk = (torch.randn(3, 3, 64, 64, generator=g, device=device) * 0.05).bfloat16()
    return (wk, torch.rand(64, generator=g, device=device) + 0.5,
            torch.randn(64, generator=g, device=device) * 0.1)


def alone_err(name, got, ref, tol=None):
    """A timed kernel's output against its plain version's on the same
    inputs, checked: K1's masks equal (returns 0.0), any other kernel
    within `tol` of max|ref|. Returns max|kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    if got.dtype == torch.bool:
        check(torch.equal(got, ref), f"{name} disagrees with its plain version")
        return 0.0
    err = rel_err(got, ref)
    check(got.shape == ref.shape and err < tol, f"{name} {tuple(got.shape)} disagrees with "
          f"its plain version: max|err|/max|ref| {err:.3e} (tol {tol})")
    return float((got.float() - ref.float()).abs().max())


def _timing(name, shape, card, ms, cold, plain_ms, library_ms, residual=False, note="",
            library_call=None):
    """One kernel timing: printed beside its bound, and returned as the
    fields of the kernels line (the warm time is the one the line carries:
    in the engine a kernel reads what the previous launch just wrote)."""
    bound, by = kernel_bound_ms(name, shape, residual)
    pct = 100.0 * bound / ms
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms ({library_call})"
    print(f"kernel {name} {shape}{' +residual' if residual else ''}: {ms:.4f} ms warm, "
          f"{cold:.4f} ms cold; bound {bound:.4f} ms ({by}), {pct:.1f}% of it (warm); "
          f"plain {plain_ms:.4f} ms; library {lib}{note} [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                pct_of_bound=pct, library_ms=library_ms, library_call=library_call)


def k3_library_ms(y, x, wk, s, b, w_cd, b_cd, shape, k3_ms, card):
    """K3's yardsticks at one shape, each a CUDA-graph time of cuDNN in bf16
    on channels_last with the BN folded into the weights: the bare conv2d
    (less work than K3: no bias, residual or ReLU), conv2d with the bias,
    that followed by the residual add and ReLU, and the fused call that
    computes K3's own function, cudnn_convolution_add_relu with the residual
    or cudnn_convolution_relu without. The fused call is the library call
    when cuDNN runs it and it agrees with K3's plain version; else the bare
    conv2d is. Returns (library ms, which call)."""
    import torch
    import torch.nn.functional as F

    from lfdtpu_torch.ops import conv_kernels as ck

    y_cl = y.permute(0, 3, 1, 2)
    x_cl = None if x is None else x.permute(0, 3, 1, 2)
    one = [1, 1]
    bare = graph_ms([lambda: F.conv2d(y_cl, w_cd, None, padding=1)])
    biased = graph_ms([lambda: F.conv2d(y_cl, w_cd, b_cd, padding=1)])
    times = [f"bare conv2d {bare:.4f}", f"conv2d + bias {biased:.4f}"]
    if x is not None:
        chain = graph_ms([lambda: torch.relu(F.conv2d(y_cl, w_cd, b_cd, padding=1) + x_cl)])
        times.append(f"+ residual add and ReLU unfused {chain:.4f}")
    name = "cudnn_convolution_relu" if x is None else "cudnn_convolution_add_relu"

    def fused_call():
        if x is None:
            return torch.cudnn_convolution_relu(y_cl, w_cd, b_cd, one, one, one, 1)
        return torch.cudnn_convolution_add_relu(y_cl, w_cd, x_cl, 1.0, b_cd, one, one, one, 1)

    # a yardstick the card may refuse: try it eagerly before timing it
    try:
        got = fused_call().permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        err = rel_err(got, ck.pair_conv3x3_plain(y, wk, s, b, residual=x))
        refusal = None if err < K3_TOL else f"{err:.3e} from K3's plain version"
    except RuntimeError as e:
        refusal = f"refused: {str(e).splitlines()[0][:120]}"
    if refusal is None:
        fused = graph_ms([fused_call])
        times.append(f"{name} (fused) {fused:.4f}")
        lib = (fused, f"cuDNN {name}, BN folded")
    else:
        times.append(f"{name} (fused) not timed, {refusal}")
        lib = (bare, "cuDNN bf16 conv2d alone, BN folded into the weights")
    print(f"  library calls pair_conv3x3 {shape}{' +residual' if x is not None else ''}, "
          f"ms: " + "; ".join(times) + f"; K3 {k3_ms:.4f} is "
          f"{'no slower than' if k3_ms <= bare else 'SLOWER than'} the bare conv2d [{card}]")
    return lib


def time_kernels(device, card):
    """Each kernel's device ms at the engine's shapes, warm (the same inputs
    every launch) and cold (rotating over more than COLD_BYTES); the plain
    versions eager (CUDA events, warmup excluded; K1's syncs on the host);
    K3's cuDNN yardsticks (k3_library_ms); each kernel's output on the
    timed inputs, and untimed at the engines' shapes (engine_shape_errs),
    against its plain version's (alone_err). Returns ({kernel: fields of
    the kernels line} for the main shapes, {kernel: max|kernel - plain|
    over those inputs})."""
    import torch

    g = torch.Generator(device=device).manual_seed(3)
    out, errs = {}, {}
    l0, l1, l2 = k3_shapes()
    rows, errs["pair_conv3x3"] = time_k3(device, card, k3_consts(device, g), g,
                                         ((l0, True), (l0, False), (l1, True), (l2, True)))
    out["pair_conv3x3"] = rows[0]
    out["stem_conv"], errs["stem_conv"] = time_k2(device, card, k2_inputs(device, g, 1, HW), g)
    boxes = torch.rand(1, 1000, 4, generator=g, device=device) * 500
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 1000, dtype=torch.bool, device=device)
    out["nms_mask_sorted"], errs["nms_mask_sorted"] = time_k1(boxes, valid, g, card)
    out["group_norm_relu"], errs["group_norm_relu"] = time_k5(device, card, g)
    for name, err in engine_shape_errs(device, g).items():
        errs[name] = max(errs[name], err)
    out["lfd_assign"], errs["lfd_assign"] = time_k6(device, card)
    out["ms_deform_attn"], errs["ms_deform_attn"] = time_k7(device, card)
    return out, errs


def engine_shape_errs(device, g):
    """Untimed: K2 and K3 at every shape the bf16_kernels engines give them
    (batch 1 and 4 at HW; K3 on its three levels with each residual, relu
    pair they launch) and K5 in bf16 at WIDERFACE-L's five head levels
    (K5_SHAPES[:5]), each against its plain version (alone_err). Returns
    {kernel: the largest max|kernel - plain|}."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck
    from lfdtpu_torch.ops import group_norm as gn

    errs = dict.fromkeys(("stem_conv", "pair_conv3x3", "group_norm_relu"), 0.0)
    wk, s, b = k3_consts(device, g)
    for n in (1, 4):
        k2_in = k2_inputs(device, g, n, HW)
        errs["stem_conv"] = max(errs["stem_conv"], alone_err(
            "stem_conv", ck.stem_conv(*k2_in), ck.stem_conv_plain(*k2_in), K2_TOL))
        for hh, ww in k3_shapes():
            y = torch.randn(n, hh, ww, 64, generator=g, device=device).bfloat16()
            for residual, relu in ((None, True), (y, True), (None, False)):
                errs["pair_conv3x3"] = max(errs["pair_conv3x3"], alone_err(
                    "pair_conv3x3", ck.pair_conv3x3(y, wk, s, b, residual=residual, relu=relu),
                    ck.pair_conv3x3_plain(y, wk, s, b, residual=residual, relu=relu), K3_TOL))
    for n, h, w, c, groups in K5_SHAPES[:5]:
        x, gamma, beta = k5_inputs(device, g, n, h, w, c, torch.bfloat16)
        errs["group_norm_relu"] = max(errs["group_norm_relu"], alone_err(
            "group_norm_relu", gn.group_norm_relu(x, gamma, beta, groups, 1e-5),
            gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-5), K5_TOL))
    return errs


def time_k3(device, card, consts, g, cases):
    """K3 at each (H, W), residual case of `cases`, batch 1: warm and cold
    CUDA-graph ms, its bound, its plain version and cuDNN's yardsticks.
    Returns (the fields of the kernels line per case, in order; the largest
    max|kernel - plain| on the timed inputs)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    wk, s, b = consts
    w_cd = (wk.float() * s).bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_cd = b.bfloat16()
    rows, err = [], 0.0
    for (hh, ww), residual in cases:
        shape = (1, hh, ww)
        sets = COLD_BYTES // kernel_work("pair_conv3x3", shape, residual)[0] + 2
        ys = [torch.randn(1, hh, ww, 64, generator=g, device=device).bfloat16()
              for _ in range(sets)]
        xs = [torch.randn(1, hh, ww, 64, generator=g, device=device).bfloat16()
              if residual else None for _ in range(sets)]
        err = max(err, alone_err("pair_conv3x3", ck.pair_conv3x3(ys[0], wk, s, b, residual=xs[0]),
                                 ck.pair_conv3x3_plain(ys[0], wk, s, b, residual=xs[0]), K3_TOL))
        warm = graph_ms([lambda: ck.pair_conv3x3(ys[0], wk, s, b, residual=xs[0])])
        cold = graph_ms([lambda i=i: ck.pair_conv3x3(ys[i], wk, s, b, residual=xs[i])
                         for i in range(sets)])
        plain = time_ms(lambda: ck.pair_conv3x3_plain(ys[0], wk, s, b, residual=xs[0]))
        lib_ms, call = k3_library_ms(ys[0], xs[0], wk, s, b, w_cd, b_cd, shape, warm, card)
        rows.append(dict(shape=list(shape), residual=residual, **_timing(
            "pair_conv3x3", shape, card, warm, cold, plain, lib_ms, residual,
            library_call=call)))
        del ys, xs
    return rows, err


def time_k2(device, card, k2_in, g):
    """K2 on k2_in's frame and constants: warm and cold CUDA-graph ms, its
    bound and its plain version. Returns (the fields of the kernels line,
    max|kernel - plain| on the timed frame)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    frame, w2, mean, std, s2, b2 = k2_in
    err = alone_err("stem_conv", ck.stem_conv(*k2_in), ck.stem_conv_plain(*k2_in), K2_TOL)
    sets = COLD_BYTES // kernel_work("stem_conv", tuple(frame.shape[:3]))[0] + 2
    frames_ = [frame] + [torch.randint(0, 256, tuple(frame.shape), generator=g,
                                       device=device, dtype=torch.uint8)
                         for _ in range(sets - 1)]
    warm = graph_ms([lambda: ck.stem_conv(frame, w2, mean, std, s2, b2)])
    cold = graph_ms([lambda f=f: ck.stem_conv(f, w2, mean, std, s2, b2) for f in frames_])
    plain = time_ms(lambda: ck.stem_conv_plain(frame, w2, mean, std, s2, b2))
    print("stem_conv library call: none (no single PyTorch call does the uint8 "
          "normalize, conv, BN and ReLU)")
    return _timing("stem_conv", tuple(frame.shape[:3]), card, warm, cold, plain, None), err


def time_k1(boxes, valid, g, card):
    """K1 at the engine's B=1, K=1000, thr 0.4 on the random boxes (rand*500)
    that earlier runs timed, then on the walk's hard cases
    (nms_kernel.walk_cases) and at B=4, each with its kept count and held
    to the plain version. Returns (the fields of the kernels line, the
    largest max|kernel - plain|: 0.0, the masks are equal)."""
    import torch

    from lfdtpu_torch.ops import nms_kernel

    device = boxes.device
    b4 = torch.rand(4, 1000, 4, generator=g, device=device) * 500
    b4[..., 2:] += b4[..., :2]
    inputs = {"random boxes (rand*500)": (boxes, valid),
              "random boxes (rand*500), B=4": (b4, torch.ones(4, 1000, dtype=torch.bool,
                                                                device=device))}
    for name, (b, v) in nms_kernel.walk_cases(1, 1000).items():
        inputs[name] = (b.to(device), v.to(device))
    case_ms, err = {}, 0.0
    for name, (b, v) in inputs.items():
        got = nms_kernel.nms_mask_sorted(b, v, 0.4)
        err = max(err, alone_err(f"nms_mask_sorted ({name})", got,
                                 nms_kernel.nms_mask_sorted_plain(b, v, 0.4)))
        case_ms[name] = graph_ms([lambda b=b, v=v: nms_kernel.nms_mask_sorted(b, v, 0.4)])
        print(f"K1 {name} K=1000: {case_ms[name]:.4f} ms, kept {int(got.sum())}/{v.numel()} "
              f"[{card}]")
    print(f"K1 all kept / all suppressed: "
          f"{case_ms['all kept'] / case_ms['all suppressed']:.2f}x")
    warm = case_ms["random boxes (rand*500)"]
    plain = time_ms(lambda: nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4))
    print("nms_mask_sorted library call: none (torchvision's nms is not on the "
          "card's machine, and the port may not need it)")
    return _timing("nms_mask_sorted", (1, 1000), card, warm, warm, plain, None,
                   note=" (inputs of 17 KB: warm = cold)"), err


def time_k5(device, card, g):
    """K5 at WIDERFACE-L's first head level (272x480x128) and TT100K-L's
    (512x512x128), bf16, G=16, and FCOS-R50-FPN's P3 at 896x1408
    (112x176x256, G=32): warm and cold CUDA-graph ms, its bound (the
    map read twice and written once), its plain version eager, and ATen's
    group_norm then relu on the channels_last map with the copy back to
    channels_last (what the engine ran before K5) as a graph. Returns (the
    fields of the kernels line per shape, the largest max|kernel - plain| on
    the timed maps)."""
    import torch
    import torch.nn.functional as F

    from lfdtpu_torch.ops import group_norm as gn

    rows, err = [], 0.0
    for h, w, c, groups in ((272, 480, 128, 16), (512, 512, 128, 16), (112, 176, 256, 32)):
        shape = (1, h, w, c)
        sets = COLD_BYTES // (h * w * c * 2) + 2
        maps = [k5_inputs(device, g, 1, h, w, c, torch.bfloat16) for _ in range(sets)]
        x, gamma, beta = maps[0]
        err = max(err, alone_err("group_norm_relu",
                                 gn.group_norm_relu(x, gamma, beta, groups, 1e-5),
                                 gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-5), K5_TOL))
        warm = graph_ms([lambda: gn.group_norm_relu(x, gamma, beta, groups, 1e-5)])
        cold = graph_ms([lambda m=m: gn.group_norm_relu(m[0], gamma, beta, groups, 1e-5)
                         for m in maps])
        plain = time_ms(lambda: gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-5))
        x_cl, wb = x.permute(0, 3, 1, 2), (gamma.bfloat16(), beta.bfloat16())
        aten = graph_ms([lambda: torch.relu(F.group_norm(x_cl, groups, *wb, 1e-5)).contiguous(
            memory_format=torch.channels_last)])
        moments = graph_ms([lambda: F.group_norm(x_cl, groups, *wb, 1e-5)])
        print(f"  ATen group_norm {shape} on channels_last, ms: alone {moments:.4f}, with "
              f"the ReLU and the copy back {aten:.4f}; K5 {warm:.4f} [{card}]")
        rows.append(dict(shape=list(shape), **_timing(
            "group_norm_relu", shape, card, warm, cold, plain, aten,
            library_call="ATen group_norm + relu on channels_last, its NCHW round trip")))
        del maps
    return rows, err


def time_k6(device, card):
    """K6 at the train cell's shape: WIDERFACE-L's batch 64 at 480x480 (P
    19,189, C 1), GT padded to 200 rows (phase 6's batch): its device ms
    (CUDA-graph replays; its inputs are under 1 MB, so warm = cold) beside
    its bound (the targets written) and its plain version eager, its output
    held to the plain version's (equal). Returns (the fields of the kernels
    line, max|kernel - plain|: 0.0)."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.ops import assign

    det = zoo.widerface_lfd("L")
    _, gt, labels, mask = (torch.as_tensor(a, device=device) for a in train_batch(
        np.random.RandomState(11), TRAIN_BATCH, TRAIN_HW, TRAIN_NMAX))
    check_assign_kernel(det, TRAIN_HW, gt, labels, mask, "timed")
    args = assign_args(det, TRAIN_HW, gt, labels, mask)
    warm = graph_ms([lambda: assign.lfd_assign(*args)])
    plain = time_ms(lambda: assign.lfd_assign_plain(*args))
    shape = (gt.shape[0], args[0].shape[0], det.num_classes, gt.shape[1], int(mask.sum()))
    return _timing("lfd_assign", shape, card, warm, warm, plain, None,
                   note=" (inputs under 1 MB: warm = cold; no PyTorch call assigns targets)"), 0.0


def time_k7(device, card):
    """K7 at the Deformable DETR cell's calls. One eager bf16 forward of the
    zoo's net (seeded init) at DETR_HW, through the engine the cell builds,
    records its 12 ms_deform_attn calls and launches K7 12 times (the
    wrapper's count). The first encoder call (22,223 queries) and the last
    decoder call (300) are held to the plain version (alone_err, K7_TOL)
    and timed: warm CUDA-graph ms on the call's own inputs, cold over the 6
    layers' inputs of that shape (each launch another layer's map and
    locations: 341 MB for the encoder's), beside the bound (the map, 12
    bytes a sample and the output at 3.35 TB/s) and the plain version eager.
    Then the captured engine records 12 launches at its capture, and
    PROFILED_FRAMES profiled replays launch K7 12 times each by kernel name.
    Returns (the fields of the kernels line for the encoder call, with
    launches, replayed_launches, launches_by_path and the decoder call's
    timing in other_shapes; the largest max|kernel - plain|)."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
    from lfdtpu_torch.ops import msda

    torch.manual_seed(0)
    det = zoo.deformable_detr_r50()
    det.net.to(device).eval()
    pre = make_device_preprocess((123.675, 116.28, 103.53), (58.395, 57.12, 57.375),
                                 bgr2rgb=True)
    frame = frames(np.random.RandomState(26), 1, DETR_HW)
    vhw = torch.tensor([DETR_HW], dtype=torch.float32, device=device)
    eager = compile_inference(det, DETR_HW, "bf16", preprocess=pre, device=device,
                              captured=False)
    real, calls = msda.ms_deform_attn, []

    def record(*args):
        calls.append(args)
        return real(*args)

    msda.ms_deform_attn = record
    before = real.launches
    try:
        with torch.inference_mode():
            eager.program(torch.as_tensor(frame, device=device), vhw)
        torch.cuda.synchronize()
    finally:
        msda.ms_deform_attn = real
    launches = real.launches - before
    check(len(calls) == 12 and launches == 12,
          f"one Deformable DETR forward called ms_deform_attn {len(calls)} times and "
          f"launched K7 {launches} times, not 12")
    rows, err = [], 0.0
    for label, group in (("encoder", calls[:6]), ("decoder", calls[6:])):
        value, shapes, starts, loc, weights = group[0]
        shape = (value.shape[1], loc.shape[1])
        with torch.inference_mode():
            err = max(err, alone_err("ms_deform_attn", real(*group[0]),
                                     msda.ms_deform_attn_plain(*group[0]), K7_TOL))
            warm = graph_ms([lambda: real(*group[0])])
            cold = graph_ms([lambda a=a: real(*a) for a in group])
            plain = time_ms(lambda: msda.ms_deform_attn_plain(*group[0]), iters=5, warmup=1)
        rows.append(dict(shape=list(shape), **_timing(
            "ms_deform_attn", shape, card, warm, cold, plain, None,
            note=f" ({label} call, bf16; no PyTorch call samples deformably)")))
    del calls, eager
    captured = compile_inference(det, DETR_HW, "bf16", preprocess=pre, device=device)
    at_capture = captured._graphs[torch.uint8].msda_launches
    x = torch.as_tensor(frame)
    prof, _ = profiled(lambda: captured(x, DETR_HW),
                       lambda: [captured(x, DETR_HW) for _ in range(PROFILED_FRAMES)])
    replayed, window = kernel_launches_in(prof, names=("ms_deform_attn",))
    print(f"Deformable DETR-R50 bf16 at {DETR_HW[0]}x{DETR_HW[1]}: K7 launched {launches} "
          f"times by one eager forward, {at_capture} in the capture, {replayed} by "
          f"{PROFILED_FRAMES} profiled replays ({window}) [{card}]")
    check(at_capture == 12 and replayed["ms_deform_attn"] == 12 * PROFILED_FRAMES,
          "the captured Deformable DETR engine did not launch K7 12 times a frame")
    del captured
    torch.cuda.empty_cache()
    encoder = {k: v for k, v in rows[0].items() if k != "shape"}
    return dict(encoder, launches=launches, replayed_launches=replayed["ms_deform_attn"],
                launches_by_path={"Deformable DETR-R50 bf16 engine, 800x1333": dict(
                    eager=launches, capture=at_capture,
                    replayed=replayed["ms_deform_attn"])},
                other_shapes=rows[1:]), err


def profile_engine(engine, x, vhw, label, counters, want, frames_=PROFILED_FRAMES):
    """One frame of a kernel engine launches each kernel as `want` (from
    expected_launches) says: counted by the wrappers for the eager engine, and
    for the captured one at its capture and, over PROFILED_FRAMES profiled
    replays, by kernel name.

    A captured `engine` must be a fresh capture that no earlier profiler
    session replayed: replaying a graph under a second session has crashed
    CUPTI (a segfault in libcuda under libcupti's cuGraphLaunch callback,
    torch 2.11, CUDA 12.8, in phase 13 once phase 11 had run; ROADMAP F16),
    and a fresh graph never did."""
    import torch

    zero_counts(counters)
    engine(x, vhw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"one frame of the {label} kernel engine: the wrappers counted {launches}"
          + (f", the capture {engine.captured_launches}" if engine.captured else "")
          + f" (counted from the net {want})")
    check(launches == ({k: 0 for k in launches} if engine.captured else want)
          and (not engine.captured or engine.captured_launches == want),
          f"one {label} frame should launch {want}")
    prof, _ = profiled(lambda: engine(x, vhw),
                       lambda: [engine(x, vhw) for _ in range(frames_)])
    counted, window = kernel_launches_in(prof)  # a replay's launches are visible only here
    print(f"  {frames_} profiled frames launched {counted} ({window})")
    check(counted == {k: frames_ * v for k, v in want.items()},
          f"{frames_} {label} frames launched {counted}, not {want} each")


# ------------------------------------------------------------- traffic serve

def traffic_preprocess(name):
    """The workload's device normalize: TT100K's (0.5, 0.5), TL's imagenet
    constants after BGR -> RGB (which K2 folds into its weights)."""
    from lfdtpu_torch.deploy import make_device_preprocess

    mean, std, swap = TRAFFIC[name][1]
    return make_device_preprocess(mean, std, bgr2rgb=swap)


def serve_traffic(name, device, card, counters, rng):
    """Phase 9, one traffic model at its frame size. Its main path first:
    the counters zeroed, the captured engine with every kernel the net takes
    built (batch 1, and 4 for TT100K), SERVED_FRAMES frames (and a batch of
    4) through the predict entry points, the replays counted from a profile;
    K1/K2/K3 launched as expected_launches counts from the net. Then: K2
    with the engine's folded constants against its plain version; the
    kernel engine's dense outputs against the plain bf16 engine, decode and
    NMS with K1 against the plain NMS (rows identical); the fp32 engine
    against the CPU; every captured variant against an eager twin; a
    profile of the kernel engine. Returns (the main path's launches at
    build and capture, its replayed launches)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    hw, _, extra, batches = TRAFFIC[name]
    det = build_detector(device, seed=len(name), name=name, cls_std=CLS_STD)
    pre = traffic_preprocess(name)
    kv = kernel_variant(det)
    want = expected_launches(det, VARIANTS[kv])
    print(f"{name} {hw[0]}x{hw[1]}: {det.num_classes} classes, strides {det.point_strides}, "
          f"levels {det.level_sizes(hw)} points; {kv} engines launch {want} per frame "
          f"(counted from the net)")
    if kv != "bf16_kernels":
        try:
            compile_engine(det, hw, device, "bf16_kernels", preprocess=pre, **extra)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        print(f"{name} with kernel_stem=True: {refusal}")
        check(refusal is not None and "stem0" in refusal,
              f"{name}: a kernel_stem engine of a 48-channel stem should raise")

    zero_counts(counters)
    engines = {b: compile_engine(det, hw, device, kv, batch_size=b, preprocess=pre, **extra)
               for b in batches}
    h, w = hw
    singles = [frames(rng, 1, (h - 8 * i - 7, w - 16 * i))[0] for i in range(SERVED_FRAMES)]
    batch4 = [frames(rng, 1, (h - h // 8 * i, w - w // 6 * i))[0] for i in range(4)]

    def work():
        rows = [det.predict_for_single_image_with_engine(engines[1], f) for f in singles]
        if 4 in engines:
            rows += det.predict_for_batch_with_engine(engines[4], batch4)
        return rows

    prof, rows = profiled(lambda: engines[1](frames(rng, 1, hw), hw), work)
    launches = {c.__name__: c.launches for c in counters}
    replays = SERVED_FRAMES + (4 in engines)
    replayed, window = kernel_launches_in(prof)
    print(f"{name} main path: {replays} replays served {[len(r) for r in rows]} rows; "
          f"launches at build and capture {launches}; by the replays (profile) {replayed} "
          f"({window})")
    for k, v in want.items():
        check((launches[k] > 0) == (v > 0), f"{name}: {k} launched {launches[k]} times "
              f"at build and capture, the net takes it {v} times a frame")
    check(all(e.captured_launches == want for e in engines.values()),
          f"{name}: a capture did not record {want}")
    check(replayed == {k: replays * v for k, v in want.items()},
          f"{name}: the replays did not launch each kernel as captured")
    for r, img in zip(rows, singles + batch4):
        check_rows(det, r, img)
    check(sum(map(len, rows)) > 0, f"{name}: the main path returned no rows")

    if want["stem_conv"]:
        pack = engines[1].net._backbone.fused_stem.pack
        for b in batches:
            x = torch.as_tensor(frames(rng, b, hw), device=device)
            got, ref = ck.stem_conv(x, *pack), ck.stem_conv_plain(x, *pack)
            err = rel_err(got, ref)
            print(f"K2 {name} engine constants (mean {[round(v, 2) for v in pack[1].tolist()]}, "
                  f"std {[round(v, 2) for v in pack[2].tolist()]}, bgr2rgb "
                  f"{TRAFFIC[name][1][2]}) {tuple(x.shape)}: max|err|/max|ref| {err:.3e} "
                  f"(tol {K2_TOL})")
            check(err < K2_TOL, f"{name}: K2 disagrees with its plain version")

    eager = {"bf16_kernels": kv, "bf16_plain": "bf16_plain", "fp32": "fp32"}
    check_engine_parity(det, {k: compile_engine(det, hw, device, v, captured=False,
                                                preprocess=pre, **extra)
                              for k, v in eager.items()}, hw, rng, label=name)
    check_fp32_reference(det, device, rng, preprocess=pre, **extra)
    x = torch.as_tensor(frames(rng, 1, hw), device=device)
    vhw = torch.tensor([h - 8, w], dtype=torch.float32, device=device)
    profile_engine(compile_engine(det, hw, device, kv, preprocess=pre, **extra), x, vhw,
                   name, counters, want, frames_=3)
    for b in batches:
        for variant in ("fp32", "bf16", kv):
            captured_vs_eager(det, hw, device, rng, variant, b, name,
                              captured=engines.pop(b) if variant == kv else None,
                              preprocess=pre, **extra)
    torch.cuda.empty_cache()
    return launches, replayed


def time_new_shapes(device, card):
    """K3 at TT100K's 2048x2048 levels, 512x512 with and without the
    residual and 256x256 with it, and K2 at 2048x2048 and at TL's 768x1280
    with TL-L's folded constants, each held to its plain version on the
    timed inputs. Returns the timing rows."""
    import torch

    from lfdtpu_torch.deploy import compile_inference

    g = torch.Generator(device=device).manual_seed(4)
    l0, l1, _ = k3_shapes(TT_HW)
    rows = time_k3(device, card, k3_consts(device, g), g, ((l0, True), (l0, False), (l1, True)))[0]
    rows.append(dict(shape=[1, *TT_HW],
                     **time_k2(device, card, k2_inputs(device, g, 1, TT_HW), g)[0]))
    det = build_detector(device, seed=2, name="TL-L")
    eng = compile_inference(det, TL_HW, "bf16", preprocess=traffic_preprocess("TL-L"),
                            kernel_stem=True, device=device, captured=False)
    frame = torch.randint(0, 256, (1, *TL_HW, 3), generator=g, device=device,
                          dtype=torch.uint8)
    rows.append(dict(shape=[1, *TL_HW], bgr2rgb=True, **time_k2(
        device, card, (frame, *eng.net._backbone.fused_stem.pack), g)[0]))
    return rows


# ---------------------------------------------------------- traffic training

def write_frame(path, hw, rng, boxes=()):
    """A smooth seeded BGR frame (random 32x32-pixel cells, linearly
    upsampled) with each xyxy box filled in a flat color, as a JPEG of
    quality 90."""
    from lfdtpu_torch.data import jpeg_encode, resize_linear

    cells = rng.randint(0, 256, (hw[0] // 32 + 1, hw[1] // 32 + 1, 3)).astype(np.uint8)
    img = resize_linear(cells, size=(hw[1], hw[0]))
    for x0, y0, x1, y1 in boxes:
        img[int(y0):int(y1) + 1, int(x0):int(x1) + 1] = rng.randint(0, 256, 3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(jpeg_encode(img, quality=90))


def build_tt100k_pack(tmp, seed=19):
    """A TT100K-like data root (annotations.json, train/ids.txt,
    test/ids.txt, 2048x2048 JPEGs): TT_PACK_POS images with type45 signs of
    8-200 px (log-uniform): every tenth image 1-8 of them in the middle
    1024 px, so its four margins become negatives, the others 2-8 anywhere
    with one in the top-left and one in the bottom-right 400 px, so they
    give none; TT_PACK_BARE images without a type45 sign. The port's
    generate_neg_images.py cuts the negatives (min_size_threshold 512) and
    its pack_tt100k.py packs through TT100KParser. Returns (pack path, data
    root)."""
    from lfdtpu_torch.data import TT100K_TYPE45

    rng = np.random.RandomState(seed)
    root = os.path.join(tmp, "TT100K", "data")
    imgs, ids = {}, []
    for i in range(TT_PACK_POS + TT_PACK_BARE):
        iid = str(10000 + i)
        objs = []
        central = i % 10 == 0
        for k in range(rng.randint(1 if central else 2, 9) if i < TT_PACK_POS else 0):
            side = float(np.exp(rng.uniform(np.log(8.0), np.log(200.0))))
            lo, hi = (512, 1536 - side) if central else (
                (0, 400 - side) if k == 0 else (TT_HW[0] - 400, TT_HW[0] - side - 1)
                if k == 1 else (0, TT_HW[0] - side - 1))
            x0, y0 = rng.uniform(lo, hi, 2)
            objs.append(dict(category=TT100K_TYPE45[rng.randint(45)],
                             bbox=dict(xmin=x0, ymin=y0, xmax=x0 + side, ymax=y0 + side)))
        if i >= TT_PACK_POS:  # a sign outside the 45 classes: an image without one
            objs.append(dict(category="pl0", bbox=dict(xmin=40, ymin=50, xmax=90, ymax=99)))
        imgs[iid] = dict(path=f"train/{iid}.jpg", objects=objs)
        ids.append(iid)
        write_frame(os.path.join(root, "train", f"{iid}.jpg"), TT_HW, rng,
                    [tuple(o["bbox"].values()) for o in objs])
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump({"imgs": imgs}, f)
    for split, chosen in (("train", ids), ("test", ids[:EVAL_IMAGES])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "ids.txt"), "w") as f:
            f.write("\n".join(chosen))
    n_neg = load_script("TT100K_train", "generate_neg_images.py").generate_neg_images(
        root, "train", "train_neg", min_size_threshold=512)
    pack = os.path.join(tmp, "tt100k_train.pkl")
    ds = load_script("TT100K_train", "pack_tt100k.py").pack(
        root, os.path.join(root, "annotations.json"), os.path.join(root, "train", "ids.txt"),
        neg_image_root=os.path.join(root, "train_neg"), save_path=pack)
    print(f"TT100K pack: {len(ds)} samples ({TT_PACK_POS} with signs, {TT_PACK_BARE} without, "
          f"{n_neg} negatives cut by generate_neg_images.py), {TT_HW[0]}x{TT_HW[1]} JPEGs")
    return pack, root


def build_tl_pack(tmp, seed=23):
    """A TrafficLight-like COCO set: TL_PACK_IMAGES 720x1280 JPEGs, all but
    every fifth with 1-6 lights of 4-80 px (aspect 0.3-0.5, as lights
    stand), one category; one image of 24 px height that the pack drops
    (filter_min_size 32). The port's pack_TL.py packs it through COCOParser
    (images without boxes kept). Returns (pack path, annotation json, image
    root)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(tmp, "TL", "images")
    images, anns = [], []
    for i in range(TL_PACK_IMAGES + 1):
        hw = (720, 1280) if i < TL_PACK_IMAGES else (24, 128)
        boxes = []
        for _ in range(rng.randint(1, 7) if i % 5 != 4 and i < TL_PACK_IMAGES else 0):
            bh = float(np.exp(rng.uniform(np.log(8.0), np.log(80.0))))
            bw = max(4.0, bh * rng.uniform(0.3, 0.5))
            x0, y0 = rng.uniform(0, hw[1] - bw - 1), rng.uniform(0, hw[0] - bh - 1)
            boxes.append([x0, y0, bw, bh])
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                             bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0))
        images.append(dict(id=i + 1, file_name=f"{i}.jpg", height=hw[0], width=hw[1]))
        write_frame(os.path.join(root, f"{i}.jpg"), hw, rng,
                    [(x, y, x + bw, y + bh) for x, y, bw, bh in boxes])
    ann = os.path.join(tmp, "TL", "train.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="traffic_light")]), f)
    pack = os.path.join(tmp, "tl_train.pkl")
    ds = load_script("TrafficLight_train", "pack_TL.py").pack(ann, root, save_path=pack)
    check(len(ds) == TL_PACK_IMAGES, "pack_TL.py should drop the image under 32 px")
    print(f"TL pack: {len(ds)} samples of 720x1280 JPEGs, {len(anns)} lights")
    return pack, ann, root


def train_entry_point(task, script, size, pack, card, host_epochs=2):
    """A port workload script's config trained end to end through the
    Executor: 2 epochs with device augmentation, a resume from epoch_1.pth
    (counters and params exact) for the last epoch, then `host_epochs` with
    host augmentation. Returns the final checkpoint."""
    import torch

    from lfdtpu_torch.execution import Executor

    label = script[:-3]
    cfg = workload_config(task, script, pack, device_aug=True, size=size)
    iters = len(cfg["train_data_loader"])
    check(iters >= 2, f"{label}: the pack gives {iters} iterations per epoch, not 2 or more")
    ex, rec = run_workload(cfg, card, f"{label}, device aug, 2 epochs of {iters} iterations")
    ckpt = os.path.join(cfg["work_dir"], "epoch_1.pth")
    check(os.path.isfile(ckpt), f"{label}: no epoch_1.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    del ex
    cfg2 = workload_config(task, script, pack, device_aug=True, size=size)
    cfg2["resume_path"] = ckpt
    resumed = Executor(cfg2)
    same = all(torch.equal(v.cpu(), saved["state_dict"][k])
               for k, v in resumed.state.net.state_dict().items())
    print(f"{label} resumed from epoch_1.pth: epoch {cfg2['epoch']}, train_iter "
          f"{cfg2['train_iter']}, params and BN stats equal the saved ones: {same}")
    check(same and (cfg2["epoch"], cfg2["train_iter"]) == (1, iters),
          f"{label}: resume did not restore the checkpoint exactly")
    resumed.run()
    check(cfg2["train_iter"] == 2 * iters, f"{label}: the resumed run did not train an epoch")
    final = os.path.join(cfg2["work_dir"], "final.pth")
    resumed.save(final)
    del resumed
    host_cfg = workload_config(task, script, pack, device_aug=False, size=size,
                               epochs=host_epochs)
    host_ex, _ = run_workload(host_cfg, card, f"{label}, host aug, {host_epochs} epoch"
                              + "s" * (host_epochs > 1))
    del host_ex
    torch.cuda.empty_cache()
    return final


def train_traffic(device, card, counters, tmp):
    """Phase 10: the TT100K and TrafficLight training entry points, end to
    end (train_entry_point on packs made by the port's own pack scripts),
    then each final checkpoint served through the kernel engine and scored
    by the port's evaluation.py; and the TT100K-L train step at the
    workload's batch 64, crop 512."""
    import torch

    from lfdtpu_torch import zoo

    tt_pack, tt_root = build_tt100k_pack(tmp)
    zero_counts(counters)
    final = train_entry_point("TT100K_train", "TT100K_LFD_L.py", "L", tt_pack, card,
                              host_epochs=TT_HOST_EPOCHS)
    print("engine kernel launches during TT100K training (its path runs none; K6, counted "
          f"in main, assigns the targets): { {c.__name__: c.launches for c in counters} }")
    det = zoo.tt100k_lfd("L")
    det.net.load_state_dict(torch.load(final, map_location="cpu",
                                       weights_only=True)["state_dict"])
    det.net.to(device)
    rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD,
                          preprocess=traffic_preprocess("TT100K-L"), hw=TRAIN_SERVE_HW)
    check(len(rows) > 0, "the trained TT100K checkpoint's engine returned no rows")
    summary = load_script("TT100K_train", "evaluation.py").evaluate(
        "L", final, data_root=tt_root, annotation_json=os.path.join(tt_root, "annotations.json"),
        test_id_file=os.path.join(tt_root, "test", "ids.txt"),
        classification_threshold=SERVE_THRESHOLD, minscore=0)
    print(f"TT100K evaluation.py on {EVAL_IMAGES} {TT_HW[0]}x{TT_HW[1]} images: accuracy "
          f"{summary['accuracy']:.4f}, recall {summary['recall']:.4f} (minscore 0)")
    check(0 <= summary["accuracy"] <= 1 and 0 <= summary["recall"] <= 1
          and len(summary["wrong"]["imgs"]) == EVAL_IMAGES, "bad TT100K evaluation summary")
    del det
    train_full_width(device, card, "TT100K-L", TT_TRAIN_HW, TT_TRAIN_NMAX)
    torch.cuda.empty_cache()

    tl_pack, tl_ann, tl_root = build_tl_pack(tmp)
    final = train_entry_point("TrafficLight_train", "TL_LFD_L.py", "L", tl_pack, card)
    det = zoo.trafficlight_lfd("L")
    det.net.load_state_dict(torch.load(final, map_location="cpu",
                                       weights_only=True)["state_dict"])
    det.net.to(device)
    rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD,
                          preprocess=traffic_preprocess("TL-L"), hw=TRAIN_SERVE_HW,
                          class_agnostic=True)
    check(len(rows) > 0, "the trained TL checkpoint's engine returned no rows")
    metrics = load_script("TrafficLight_train", "evaluation.py").evaluate(
        "L", final, val_annotation_path=tl_ann, val_image_root=tl_root,
        val_dataset_pkl=tl_pack, classification_threshold=SERVE_THRESHOLD)
    print(f"TL evaluation.py on {TL_PACK_IMAGES + 1} images: "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(metrics and np.isfinite(list(metrics.values())).all(), "non-finite TL metrics")


# ------------------------------------------------------------------- LFDv2

def k1_inputs(fn):
    """(fn(), [(boxes, valid, iou_thr) of each call of K1's wrapper while fn
    ran]): what reaches K1, read where ops/nms.py calls the wrapper (a
    capture calls it on the host, so this reads a captured engine too; there
    the tensors are the graph's buffers, and only their shapes mean
    anything)."""
    # the module (the package's attribute `nms` is the host function)
    out, calls = recorded_calls(importlib.import_module("lfdtpu_torch.ops.nms"),
                                "nms_mask_sorted", fn)
    return out, [args for args, _ in calls]


def recorded_calls(module, name, fn):
    """(fn(), [(args, kwargs) of each call of module.<name> while fn ran])."""
    calls, wrapper = [], getattr(module, name)

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        return fn(), calls
    finally:
        setattr(module, name, wrapper)


def lfdv2_detector(cls, device, seed=31, **kw):
    """LFDv2 or LFDv2Q on WIDERFACE-L's backbone, neck and head
    (build_detector's seeded, randomized weights), WIDERFACE's classes,
    scales and strides; LFDv2Q classifies with QualityFocalLoss."""
    from lfdtpu_torch import zoo
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss, QualityFocalLoss

    base = build_detector(device, seed=seed)
    net = base.net
    q = cls.__name__ == "LFDv2Q"
    cls_loss = QualityFocalLoss(beta=2.0) if q else FocalLoss()
    if not q:  # LFDv2Q decodes 'exp' only
        kw.setdefault("distance_to_bbox_mode", "sigmoid")
    det = cls(net._backbone, net._neck, net._head, num_classes=1,
              regression_ranges=zoo.WIDERFACE_SCALES, point_strides=base.point_strides,
              classification_loss_func=cls_loss, regression_loss_func=IoULoss(eps=1e-6), **kw)
    det.net.to(device).eval()
    return det


def serve_and_train_lfdv2(device, card, counters, rng):
    """Phase 11: LFDv2 on WIDERFACE-L's parts at 1088x1920. Its main path:
    the counters zeroed, the captured bf16 engine with K1-K3 built and two
    frames served, the replays counted from a profile; then the captured
    engine against an eager twin (bit-equal, launches counted from the
    net), the candidates that reach K1 as read from its wrapper's input;
    then two fp32 train steps
    of LFDv2 and of LFDv2Q on the GPU against the CPU. Returns (the main
    path's launches, its replayed launches)."""
    from lfdtpu_torch.models import LFDv2, LFDv2Q

    det = lfdv2_detector(LFDv2, device)
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    spec = det.decode_spec()
    sizes = det.level_sizes(HW)
    zero_counts(counters)
    engine, calls = k1_inputs(lambda: compile_engine(det, HW, device, "bf16_kernels"))
    k1_shapes = [tuple(b.shape) for b, _, _ in calls]
    print(f"LFDv2 {HW[0]}x{HW[1]}: levels {sizes} points, per-level limit "
          f"{spec.per_level_limit} -> {sum(min(n, spec.per_level_limit) for n in sizes)} "
          f"points to stage 2 (computed); K1's boxes at build and capture (read) "
          f"{sorted(set(k1_shapes))} (nms_budget {spec.nms_budget})")
    check(k1_shapes and all(k[1] <= spec.nms_budget == det.pre_nms_bbox_limit
                            for k in k1_shapes),
          "LFDv2 passes K1 more candidates than its budget")
    imgs = [frames(rng, 1, (HW[0] - 8 * i, HW[1]))[0] for i in range(2)]
    prof, rows = profiled(lambda: engine(frames(rng, 1, HW), HW),
                          lambda: [det.predict_for_single_image_with_engine(engine, f)
                                   for f in imgs])
    launches = {c.__name__: c.launches for c in counters}
    replayed, window = kernel_launches_in(prof)
    print(f"LFDv2 main path: 2 replays served {[len(r) for r in rows]} rows; launches at "
          f"build and capture {launches}; by the replays (profile) {replayed} ({window})")
    for k, v in want.items():
        check((launches[k] > 0) == (v > 0), f"LFDv2's main path launched {k} {launches[k]} "
              f"times, the net takes it {v} times a frame")
    check(replayed == {k: 2 * v for k, v in want.items()},
          "LFDv2's replays did not launch each kernel as captured")
    for r, img in zip(rows, imgs):
        check_rows(det, r, img)
    captured_vs_eager(det, HW, device, rng, "bf16_kernels", 1, "LFDv2 (WIDERFACE-L parts)",
                      captured=engine)
    for cls in (LFDv2, LFDv2Q):
        check_train_gpu_vs_cpu(device, lambda cls=cls: lfdv2_detector(cls, "cpu"),
                               cls.__name__)
    return launches, replayed


# -------------------------------------------------------------------- FCOS

def fcos_r50_fpn(device, seed=None, v1=False, spiced=True):
    """FCOS-R50-FPN at full width, as the port's zoo builds it
    (lfdtpu_torch.zoo.fcos_r50_fpn: Tian et al., ICCV 2019, as mmdetection's
    configs/fcos/fcos_r50_caffe_fpn_gn-head_1x_coco.py sets it out): a caffe
    ResNet-50 with stage 1 frozen and norm_eval, tapped at the last block of
    stages 2-4 (512/1024/2048 channels, strides 8/16/32), an FPN of 256
    channels and 5 levels (extra convs on its own output, ReLU before them),
    the FCOSHead (80 classes, 4 convs of 256 per tower, GroupNorm(32)), and
    FCOS's defaults (ranges up to 1e5, strides 8-128, threshold 0.05, NMS
    0.5, 1000 pre-NMS points per level, 100 detections). FCOSv1 on the same
    parts with `v1`.
    With a `seed`: lfdtpu's init from it, randomized norms
    (randomize_norms_) and the conv biases but the classifier's prior drawn
    from N(0, 0.1) (the init's zero biases would hold a GPU-vs-CPU train
    check to the relative error of their first updates alone); `spiced`
    then scales the classification conv by 30
    and its bias by -2, the regression by 5 and the centerness by 3 and +3
    (tests/test_reference_parity_v2.py:287-301): random FCOS logits sit at
    the prior (sigmoid 0.01), and K1 would receive nothing."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.models import FCOSv1

    det = zoo.fcos_r50_fpn()
    if v1:
        det = FCOSv1(det.net._backbone, det.net._neck, det.net._head,
                     classification_loss_func=det.classification_loss_func,
                     regression_loss_func=det.regression_loss_func)
    head = det.net._head
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        det.init(g)
        randomize_norms_(det.net, g)
        with torch.no_grad():
            for m in det.net.modules():
                if (isinstance(m, torch.nn.Conv2d) and m.bias is not None
                        and m is not head._classification):
                    m.bias.normal_(0.0, 0.1, generator=g)
        if spiced:
            with torch.no_grad():
                head._classification.weight.mul_(30.0)
                head._classification.bias.sub_(2.0)
                head._regression.weight.mul_(5.0)
                head._centerness.weight.mul_(3.0)
                head._centerness.bias.add_(3.0)
    det.net.to(device).eval()
    return det


K5_UNPAIRED = 0.05  # tests/test_torch_cuda.py's K5-engine allowance (F23)


def unpaired_above_cut(a, b, px=1.0, score=0.02):
    """Predict-API rows of `a` with no row of `b` of the same label within
    `px` on every box coordinate and `score`, other than those at the score
    cut (within `score` of the lowest score of either set)."""
    if not a:
        return []
    ra, rb = np.asarray(a, np.float64), np.asarray(b, np.float64).reshape(-1, 6)
    cut = min(ra[:, 1].min(), rb[:, 1].min() if len(rb) else np.inf) + score
    near = ((np.abs(ra[:, None, 2:] - rb[None, :, 2:]).max(-1) <= px)
            & (np.abs(ra[:, None, 1] - rb[None, :, 1]) <= score)
            & (ra[:, None, 0] == rb[None, :, 0]))
    return [r for r, ok in zip(a, near.any(1)) if not ok and r[1] > cut]


def fcos_engine_path(det, det16, imgs, counters, device):
    """FCOS-R50-FPN's served path: the captured bf16 engine at FCOS_HW
    (compile_inference; no normalize, as the eager nets here take raw
    pixels) through predict_for_single_image_with_engine on the main path's
    frames: K5 on the towers' 40 GroupNorm + ReLU pairs a frame and K1 in
    the graph, and the rows of the eager bf16 net (ATen's GroupNorm) within
    the K5-engine card test's tolerances (F23): each row paired within 1 px
    and 0.02 of score but at the score cut and at most K5_UNPAIRED of the
    rest."""
    import torch

    from lfdtpu_torch.deploy import compile_inference

    zero_counts(counters)
    eng = compile_inference(det, FCOS_HW, precision="bf16", device=device)
    want = {"nms_mask_sorted": 1, "stem_conv": 0, "pair_conv3x3": 0, "int8_conv": 0,
            "group_norm_relu": 40}
    print(f"FCOS captured bf16 engine {FCOS_HW[0]}x{FCOS_HW[1]}: captured {eng.captured}, "
          f"launches {eng.captured_launches}")
    check(eng.captured and eng.captured_launches == want,
          f"the FCOS engine did not capture K5 40 times and K1 once ({want})")
    for img in imgs:
        served = det.predict_for_single_image_with_engine(eng, img)
        eager = det16.predict_for_single_image(img)
        lost = [unpaired_above_cut(x, y) for x, y in ((served, eager), (eager, served))]
        print(f"FCOS engine frame: {len(served)} rows, eager bf16 {len(eager)}; unpaired above "
              f"the cut {len(lost[0])} / {len(lost[1])}")
        check(len(served) > 0 and all(len(u) <= K5_UNPAIRED * n for u, n in
                                      zip(lost, (len(served), len(eager)))),
              "the FCOS engine's rows stray from the eager bf16 net's")
    del eng
    torch.cuda.empty_cache()


def fcos_serve(det, det16, imgs, batch, metas):
    """FCOS's main path: predict_for_single_image on each frame with the fp32
    and the bf16 net, then get_results on a batch. Returns the rows."""
    rows = {name: [d.predict_for_single_image(f) for f in imgs]
            for name, d in (("fp32", det), ("bf16", det16))}
    rows["batch"] = det.get_results(batch, metas)
    return rows


def fcos_k1_timing(b, v, thr, card):
    """K1 on the inputs an FCOS frame gave it: warm (CUDA-graph replays of
    the same launch) and cold (each launch after a COLD_BYTES write that
    evicts the L2, the write's own graph time taken off), its bound, the
    plain version. Returns the fields of a kernels-line row."""
    import torch

    from lfdtpu_torch.ops import nms_kernel

    flush = torch.empty(COLD_BYTES // 4, device=b.device)
    warm = graph_ms([lambda: nms_kernel.nms_mask_sorted(b, v, thr)])
    both = graph_ms([lambda: (flush.zero_(), nms_kernel.nms_mask_sorted(b, v, thr))])
    cold = both - graph_ms([flush.zero_])
    plain = time_ms(lambda: nms_kernel.nms_mask_sorted_plain(b, v, thr))
    del flush
    print("nms_mask_sorted library call at the FCOS shape: none (torchvision's nms is "
          "not on the card's machine)")
    return dict(shape=list(b.shape[:2]), path="FCOS-R50-FPN", classes=80,
                **_timing("nms_mask_sorted", tuple(b.shape[:2]), card, warm, cold, plain,
                          None, note=f" ({int(v.sum())} valid, 80 class offsets)"))


def fcos_frozen_move_by_decay_alone(net, lrs, weights):
    """F7 on a GPU net after two fp32 steps at learning rates `lrs` from
    `weights` (check_train_gpu_vs_cpu's return): the frozen stem and stage 1 get zero
    gradients, so SGD (momentum 0.9, wd 1e-4) moves them by weight decay
    alone: buf = wd p0, p1 = p0 - lr0 buf, buf' = 0.9 buf + wd p1,
    p2 = p1 - lr1 buf'."""
    import torch

    params = {n: p.detach().cpu() for n, p in net._backbone.named_parameters()
              if n.split(".")[0] in ("conv1", "bn1", "layer1")}
    worst, moved = 0.0, 0
    for n, p in params.items():
        p0 = weights[f"_backbone.{n}"]
        buf = 1e-4 * p0
        p1 = p0 - lrs[0] * buf
        p2 = p1 - lrs[1] * (0.9 * buf + 1e-4 * p1)
        worst = max(worst, rel_err(p, p2))
        moved += not torch.equal(p, p0)
    print(f"F7: {len(params)} frozen parameters (stem, stage 1) after the 2 GPU steps: "
          f"{moved} moved, max|err|/max|ref| against weight decay alone {worst:.2e}")
    check(moved == len(params) and worst < 1e-5,
          "frozen FCOS parameters did not move by weight decay alone")


def fcos_train_full_width(device, card):
    """FCOS-R50-FPN training steps at 896x1408 (800x1333 padded), Nmax 100,
    at batch 2 and 8, fp32 and bf16 autocast: FCOS_STEPS steps on one fixed
    batch, losses finite, BN statistics untouched (norm_eval)."""
    import torch

    weights = fcos_r50_fpn("cpu", seed=45, spiced=False).net.state_dict()
    factory = lambda: fcos_r50_fpn("cpu")  # noqa: E731 (its weights are loaded)
    sched = train_schedule()
    for bsz in FCOS_TRAIN_BATCHES:
        batch = [torch.as_tensor(a, device=device) for a in train_batch(
            np.random.RandomState(45), bsz, FCOS_HW, FCOS_NMAX, num_classes=80,
            top=0.8 * min(FCOS_HW))]
        for name, mp in (("fp32", False), ("bf16", True)):
            det, step = make_trainer(device, FCOS_HW, weights, mixed_precision=mp,
                                     factory=factory)
            stats0 = {k: v.clone() for k, v in det.net.state_dict().items() if "running" in k}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics = [step(*batch, sched(0, it), True) for it in range(FCOS_STEPS)]
            vals = {k: torch.stack([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"train {name} FCOS-R50-FPN batch {bsz} {FCOS_HW[0]}x{FCOS_HW[1]} "
                  f"({int(batch[3].sum())} GT boxes, Nmax {FCOS_NMAX}): peak {peak:.2f} GiB "
                  f"allocated [{card}]")
            print(f"  loss {vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f}, centerness "
                  f"{vals['centerness_loss'][0]:.4f}, num_pos {vals['num_pos'][0]:.0f}")
            check(all(np.isfinite(v).all() for v in vals.values()),
                  f"non-finite FCOS train metrics ({name}, batch {bsz})")
            check(all(torch.equal(v, stats0[k]) for k, v in det.net.state_dict().items()
                      if k in stats0), f"norm_eval: BN statistics moved ({name})")
            del det, step
            torch.cuda.empty_cache()


def fcos_phase(device, card, counters):
    """Phase 12: FCOS-R50-FPN (fcos_r50_fpn) on the card. Its main path:
    the counters zeroed, FCOS_FRAMES
    800x1333 frames through predict_for_single_image with the fp32 net and
    with the net cast to bf16 (the regression's exp stays fp32), and
    get_results on a batch of 2, the counters read: K1 once per call, and
    the (1, 1000, 4) class-offset boxes its wrapper received. Then decode +
    NMS on the same dense outputs with K1 and with the plain NMS (rows
    identical), the fp32 net on the GPU against the CPU, two fp32 train steps
    of FCOS and FCOSv1 on the GPU against the CPU and F7, the full-width
    steps, and K1 timed alone at the FCOS shape. Returns (the main path's
    eager launches, K1's row at the FCOS shape)."""
    import dataclasses

    import torch

    from lfdtpu_torch.models.detector import eval_forward, pad_to_multiple
    from lfdtpu_torch.ops import nms_kernel

    det = fcos_r50_fpn(device, seed=41)
    det16 = copy.copy(det)
    det16.net = copy.deepcopy(det.net).to(torch.bfloat16)
    rng = np.random.RandomState(12)
    imgs = [frames(rng, 1, FCOS_FRAME)[0] for _ in range(FCOS_FRAMES)]
    batch = torch.as_tensor(frames(rng, 2, FCOS_HW), device=device, dtype=torch.float32)
    metas = [dict(resized_height=FCOS_FRAME[0], resized_width=FCOS_FRAME[1]), None]
    spec = det.decode_spec()
    sizes = det.level_sizes(FCOS_HW)
    print(f"FCOS-R50-FPN: {sum(p.numel() for p in det.net.parameters())} parameters; {FCOS_FRAME[0]}x"
          f"{FCOS_FRAME[1]} frames pad to {FCOS_HW[0]}x{FCOS_HW[1]}: {sum(sizes)} points "
          f"{sizes}, {sum(min(n, spec.per_level_limit) for n in sizes)} after the per-level "
          f"limit {spec.per_level_limit}")

    zero_counts(counters)
    rows, calls = k1_inputs(lambda: fcos_serve(det, det16, imgs, batch, metas))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    shapes = [tuple(b.shape) for b, _, _ in calls]
    n_valid = [v.sum(-1).tolist() for _, v, _ in calls]  # per image
    print(f"FCOS main path: {FCOS_FRAMES} fp32 and {FCOS_FRAMES} bf16 frames "
          f"({[len(r) for r in rows['fp32']]} / {[len(r) for r in rows['bf16']]} rows), "
          f"get_results batch 2 ({[len(r) for r in rows['batch']]} rows); launches "
          f"{launches}; K1's boxes (read) {shapes}, valid {n_valid}")
    want = 2 * FCOS_FRAMES + 1
    check(launches == {"nms_mask_sorted": want, "stem_conv": 0, "pair_conv3x3": 0,
                       "int8_conv": 0, "group_norm_relu": 0},
          f"the FCOS main path did not launch K1 once per call ({want})")
    check(shapes == [(1, spec.nms_budget, 4)] * (2 * FCOS_FRAMES) + [(2, spec.nms_budget, 4)]
          and min(map(min, n_valid)) == spec.nms_budget,
          "K1 did not receive the FCOS frames' 1000 candidates")
    for r, img in zip(rows["fp32"] + rows["bf16"], imgs + imgs):
        check(len(r) > 0, "an FCOS frame gave no detection")
        check_rows(det, r, img)
    for r, hw in zip(rows["batch"], (FCOS_FRAME, FCOS_HW)):
        check_rows(det, r, np.zeros(hw + (3,)))
    fcos_engine_path(det, det16, imgs, counters, device)
    k1_err = 0.0
    for b, v, thr in calls:
        bad = int((nms_kernel.nms_mask_sorted(b, v, thr)
                   != nms_kernel.nms_mask_sorted_plain(b, v, thr)).sum())
        k1_err = max(k1_err, float(bad > 0))
    print(f"K1 against its plain version on the main path's {len(calls)} inputs: "
          f"max|err| {k1_err}")
    check(k1_err == 0, "K1 disagrees with its plain version on FCOS's boxes")

    # decode + NMS on the same dense outputs, K1 against the plain NMS
    plain_spec = dataclasses.replace(spec, nms_use_kernel=False)
    x = torch.as_tensor(pad_to_multiple(imgs[1].astype(np.float32), 128)[None], device=device)
    for name, d in (("fp32", det), ("bf16", det16)):
        outs = tuple(o[0] for o in eval_forward(d.net, x))
        with torch.inference_mode():
            a = d.decode_single(outs, FCOS_HW, FCOS_FRAME, spec)
            b = d.decode_single(outs, FCOS_HW, FCOS_FRAME, plain_spec)
        same = all(torch.equal(a[k], b[k]) for k in a)
        print(f"FCOS {name} decode + NMS, K1 against plain: {int(a['count'])} rows, "
              f"identical={same}")
        check(same, f"FCOS {name} rows with K1 differ from the plain NMS")

    # the fp32 net on the GPU against the CPU, TF32 off
    small = torch.as_tensor(frames(rng, 1, FCOS_SMALL_HW), dtype=torch.float32)
    got = eval_forward(det.net, small.to(device))
    ref = eval_forward(copy.deepcopy(det.net).cpu(), small)
    errs = [rel_err(g.cpu(), r) for g, r in zip(got, ref)]
    print(f"FCOS fp32 {FCOS_SMALL_HW} dense GPU vs CPU (cls, reg, ctr): "
          + ", ".join(f"{e:.3e}" for e in errs) + f" max|err|/max|ref| (tol {DENSE_FP32_TOL})")
    check(max(errs) < DENSE_FP32_TOL, "FCOS fp32 GPU net disagrees with the CPU")

    # at 256x256: at 128x128 the stride-128 level is one pixel, and its
    # GroupNorm over 8 values a group amplifies float32 rounding (as F8's BN)
    for v1, label in ((False, "FCOS-R50-FPN"), (True, "FCOSv1-R50-FPN")):
        trained = check_train_gpu_vs_cpu(
            device, lambda v1=v1: fcos_r50_fpn("cpu", 43, v1, False), label,
            num_classes=80, hw=FCOS_TRAIN_SMALL_HW)
        if not v1:
            fcos_frozen_move_by_decay_alone(*trained)
        del trained
    fcos_train_full_width(device, card)

    b, v, thr = calls[0]
    k1_row = fcos_k1_timing(b, v, thr, card)
    del det, det16
    torch.cuda.empty_cache()
    return launches, k1_row


# ------------------------------------------------------------------- int8

def k4_inputs(fn):
    """(fn(), [the keyword arguments of each call of K4's wrapper while fn
    ran]), read where the int8 chain calls it (deploy/int8_net.py)."""
    from lfdtpu_torch.deploy import int8_net

    calls, wrapper = [], int8_net.int8_conv

    def recorded(x8, wpack, mult, bias, kernel_size, stride, relu=False, out_scale=None,
                 residual=None, residual_scale=None):
        kw = dict(x=x8, wpack=wpack, mult=mult, bias=bias, kernel_size=kernel_size,
                  stride=stride, relu=relu, out_scale=out_scale, residual=residual,
                  residual_scale=residual_scale)
        calls.append(kw)
        return wrapper(**kw)

    int8_net.int8_conv = recorded
    try:
        return fn(), calls
    finally:
        int8_net.int8_conv = wrapper


def k4_mode(call):
    """K4's output mode of one call: a (int8), b (f32), c8 / cf (an int8 /
    f32 residual fused)."""
    if call["out_scale"] is None:
        return "b"
    if call.get("residual") is None:
        return "a"
    return "cf" if call["residual"].is_floating_point() else "c8"


def k4_shape(call):
    n, h, w, cin = call["x"].shape
    return (n, h, w, cin, call["wpack"].shape[0], call["kernel_size"], call["stride"],
            k4_mode(call))


def check_k4_routes(fn, label, expect=None):
    """fn() (k4_inputs of one eager int8 call), checking that each of its K4
    launches went to the route ops.int8_conv.route_of names for its shape,
    none to the mma.sync route (no zoo chain has a shape of it), and, with
    `expect`, that many to each route. Returns fn()'s value."""
    from lfdtpu_torch.ops import int8_conv as k4

    before = dict(k4.int8_conv.routes)
    out, calls = fn()
    got = {r: k4.int8_conv.routes[r] - before[r] for r in before}
    want = dict.fromkeys(before, 0)
    for c in calls:
        want[k4.route_of(*k4_shape(c)[3:7])] += 1
    print(f"{label}: K4's {len(calls)} launches by route {got}")
    check(got == want and got["mma"] == 0 and expect in (None, got),
          f"{label}: K4's routes {got}, not {want} with none on mma ({expect})")
    return out, calls


def check_k4(calls, label):
    """K4 against its plain version on each recorded call: EXACT (int8 and
    float32 outputs bit-equal). Returns (max|err|, the distinct (shape,
    mode)s)."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    err, seen = 0.0, {}
    for c in calls:
        got = k4.int8_conv(**c)
        ref = k4.int8_conv_plain(**c)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype and got.shape == ref.shape, f"{label}: K4 output form")
        e = float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0
        err = max(err, e)
        seen[k4_shape(c)] = seen.get(k4_shape(c), 0) + 1
        check(e == 0.0, f"{label}: K4 disagrees with its plain version at {k4_shape(c)} "
              f"(max|err| {e})")
    print(f"K4 against its plain version, {label}: {len(calls)} calls, {len(seen)} distinct "
          f"(N, H, W, Cin, Cout, k, stride, mode), max|err| {err} (exact)")
    for shape, n in seen.items():
        print(f"  {shape} x{n}")
    return err, seen


def predict_engine_jpeg(det, hw, rng, tmp):
    """One JPEG through the port's WIDERFACE_train/predict_engine.py with
    precision="int8": `det`'s weights as a checkpoint, a seeded frame of
    `hw` as a JPEG, the script's own engine (fake-quantized weights,
    calibrated on noise, captured). Returns its rows."""
    from lfdtpu_torch.execution import save_checkpoint

    ckpt, jpg = os.path.join(tmp, "int8.pth"), os.path.join(tmp, "frame.jpg")
    save_checkpoint(ckpt, det.net)
    write_frame(jpg, hw, rng)
    script = load_script("WIDERFACE_train", "predict_engine.py")
    with contextlib.redirect_stdout(io.StringIO()):  # the script prints every row
        return script.predict_with_engine("L", ckpt, jpg, precision="int8",
                                          classification_threshold=SERVE_THRESHOLD,
                                          out_path=os.path.join(tmp, "out.jpg"))


def corr_and_ratio(got, ref):
    """lfdtpu's closeness criteria of an int8 output against fp32
    (tests/test_deploy.py:126-160): correlation, mean-magnitude ratio."""
    g, r = got.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    return float(np.corrcoef(g, r)[0, 1]), float(np.abs(g).mean() / np.abs(r).mean())


def check_int8_close_to_fp32(engine, fp32, x, label):
    for out8, out32, what in zip(engine.dense(x), fp32.dense(x), ("cls", "reg")):
        cc, ratio = corr_and_ratio(out8, out32)
        print(f"{label} {what} against fp32: correlation {cc:.4f} (> {INT8_CORR}), "
              f"mean-magnitude ratio {ratio:.4f} (in {INT8_RATIO})")
        check(cc > INT8_CORR and INT8_RATIO[0] < ratio < INT8_RATIO[1],
              f"{label} {what} is not close to fp32 by lfdtpu's criteria")


def check_int8_gpu_vs_cpu(det, device, rng):
    """The int8 chain on the GPU against the port's int8 chain on the CPU
    at SMALL_HW with one amax dict: every int8 edge equal (K4 against the
    plain version, constants folded on the CPU for both), the dense outputs
    within DENSE_FP32_TOL (the float head)."""
    import torch

    from lfdtpu_torch.deploy import calibrate_module_amax, make_device_preprocess
    from lfdtpu_torch.deploy.int8_net import Int8Chain

    pre = make_device_preprocess(MEAN, STD)
    f = frames(rng, 1, SMALL_HW)
    amax = calibrate_module_amax(det.net, [f], pre.to(device))
    x = pre.cpu()(torch.as_tensor(f)).float()
    keys = {k[:-4]: None for k in amax if k.endswith("#out") and k != "__input__#out"}
    cap_gpu, cap_cpu = dict(keys), dict(keys)
    with torch.inference_mode():
        cg, rg = Int8Chain(det.net, amax)(x.to(device), capture=cap_gpu)
        net_cpu = copy.deepcopy(det.net).cpu()
        cc, rc = Int8Chain(net_cpu, amax)(x, capture=cap_cpu)
    edges = [k for k, v in cap_cpu.items() if isinstance(v, tuple)]
    same = all(torch.equal(cap_gpu[k][0].cpu(), cap_cpu[k][0]) for k in edges)
    ec, er = rel_err(cg.cpu(), cc), rel_err(rg.cpu(), rc)
    print(f"int8 {SMALL_HW} GPU vs CPU, one amax dict: {len(edges)} int8 edges equal={same}; "
          f"dense cls {ec:.3e}, reg {er:.3e} max|err|/max|ref| (tol {DENSE_FP32_TOL})")
    check(same and len(edges) > 0, "an int8 edge differs between the GPU and the CPU")
    check(ec < DENSE_FP32_TOL and er < DENSE_FP32_TOL, "int8 dense GPU disagrees with CPU")


def k4_yardstick_ms(call, card):
    """cuDNN in bf16 of K4's conv shape with its epilogue fused where cuDNN
    has the call (cudnn_convolution_relu, or _add_relu with the residual; a
    yardstick only: a bf16 conv, not K4's function). Returns (ms, call)."""
    import torch
    import torch.nn.functional as F

    n, h, w, cin, cout, k, stride, mode = k4_shape(call)
    g = torch.Generator(device="cuda").manual_seed(k * 100 + cin)
    x = torch.randn(n, cin, h, w, generator=g, device="cuda").bfloat16().contiguous(
        memory_format=torch.channels_last)
    wt = (torch.randn(cout, cin, k, k, generator=g, device="cuda") * 0.05).bfloat16() \
        .contiguous(memory_format=torch.channels_last)
    b = torch.zeros(cout, device="cuda").bfloat16()
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    z = torch.randn(n, cout, ho, wo, generator=g, device="cuda").bfloat16().contiguous(
        memory_format=torch.channels_last)
    st, pad, one = [stride] * 2, [k // 2] * 2, [1, 1]

    def fused():
        if mode in ("c8", "cf"):
            return torch.cudnn_convolution_add_relu(x, wt, z, 1.0, b, st, pad, one, 1)
        return torch.cudnn_convolution_relu(x, wt, b, st, pad, one, 1)

    try:
        fused()
        torch.cuda.synchronize()
        name = ("cudnn_convolution_add_relu" if mode in ("c8", "cf")
                else "cudnn_convolution_relu")
        return graph_ms([fused]), f"cuDNN bf16 {name} (yardstick, not int8)"
    except RuntimeError:
        return (graph_ms([lambda: F.conv2d(x, wt, None, stride, k // 2)]),
                "cuDNN bf16 conv2d alone (yardstick, not int8)")


def k4_int_mm_ms(call):
    """torch._int_mm (cuBLASLt's int8 GEMM) of a stride-1 1x1 conv's product:
    a yardstick only, not K4's function (int32 out, no epilogue)."""
    import torch

    x = call["x"].reshape(-1, call["x"].shape[-1])
    w = call["wpack"][:, :x.shape[1]].contiguous().t()  # (Cin, Cout), column-major
    return graph_ms([lambda: torch._int_mm(x, w)])


def first_route(shape):
    """The route the rule gave a K4 shape before the wgmma and stem routes
    took 32 and 48 channels: mma outside FIRST_WGMMA_WIDTHS and the 3 -> 64
    stem."""
    cin, cout, k, stride = shape[3:7]
    if cin in FIRST_WGMMA_WIDTHS and cout in FIRST_WGMMA_WIDTHS:
        return "wgmma"
    return "stem" if (cin, cout, k, stride) == (3, 64, 3, 2) else "mma"


def time_k4(calls, card, device, timed=K4_TIMED, on_mma=False, label="one frame"):
    """K4 at every distinct (shape, mode) of one frame's calls (WIDERFACE-L:
    28 of 32 launches), each on the inputs the chain gave it: launches a
    frame, warm and cold CUDA-graph ms, bound, % of bound and the gap,
    launches x (warm - bound). Cold rotates over more than COLD_BYTES of
    inputs where GRAPH_LAUNCHES inputs hold that much, else each launch
    follows a COLD_BYTES write (its own time taken off). The `timed` shapes
    (K4_TIMED's (Cin, Cout, k, stride, mode)) also get the plain version
    (eager) and the bf16 cuDNN yardstick, the stride-1 1x1s torch._int_mm;
    with `on_mma`, every shape also its warm time on the mma.sync route
    (ops.int8_conv.launch_on) and the route its first design took
    (first_route). Prints the table ranked by gap and the frame's sum of
    bounds. Returns the rows, the `timed` shapes first (the kernels line's
    first row is K4_TIMED's: stage 0's 3x3)."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    distinct = {}
    for c in calls:
        distinct.setdefault(k4_shape(c), [c, 0])[1] += 1
    picks = {pick: what for what, pick in timed}
    order = [next(sh for sh in distinct if sh[3:] == pick) for _, pick in timed]
    order += [sh for sh in distinct if sh not in order]
    rows, bound_sum = [], 0.0
    flush = torch.empty(COLD_BYTES // 4, device=device)
    flush_ms = graph_ms([flush.zero_])
    for shape in order:
        call, n = distinct[shape]
        bound, by = kernel_bound_ms("int8_conv", shape)
        bound_sum += n * bound
        warm = graph_ms([lambda: k4.int8_conv(**call)])
        sets = COLD_BYTES // kernel_work("int8_conv", shape)[0] + 2
        if sets <= GRAPH_LAUNCHES:  # one graph rotates over more inputs than the L2 holds
            g = torch.Generator(device=device).manual_seed(len(rows))
            xs = [call["x"]] + [torch.randint(-127, 128, tuple(call["x"].shape), generator=g,
                                              device=device, dtype=torch.int8)
                                for _ in range(sets - 1)]
            cold = graph_ms([lambda xi=xi: k4.int8_conv(**dict(call, x=xi)) for xi in xs])
            cold_by = f"rotation over {sets} inputs"
            del xs
        else:  # too small for that: each launch after a write that evicts the L2
            cold = graph_ms([lambda: (flush.zero_(), k4.int8_conv(**call))]) - flush_ms
            cold_by = "after a COLD_BYTES write, its time taken off"
        route = k4.route_of(*shape[3:7])
        row = dict(shape=list(shape), k4_route=route, launches_per_frame=n, ms=warm,
                   cold_ms=cold, cold_by=cold_by, bound_ms=bound, bound_by=by,
                   pct_of_bound=100.0 * bound / warm,
                   gap_ms=n * (warm - bound), plain_ms=None, library_ms=None,
                   library_call="none: PyTorch has no int8 convolution on CUDA")
        if shape[3:] in picks and shape == order[list(picks).index(shape[3:])]:
            row["what"] = picks[shape[3:]]
            row["plain_ms"] = time_ms(lambda: k4.int8_conv_plain(**call), iters=5, warmup=1)
            row["yardstick_ms"], row["yardstick_call"] = k4_yardstick_ms(call, card)
        if shape[5] == 1 and shape[6] == 1 and shape[0] * shape[1] * shape[2] > 16:
            row["int_mm_ms"] = k4_int_mm_ms(call)  # (torch._int_mm takes more than 16 rows)
        if on_mma:
            row["first_route"] = first_route(shape)
            row["mma_ms"] = graph_ms([lambda: k4.launch_on("mma", **call)])
        rows.append(row)
    del flush
    print(f"K4, every distinct (N, H, W, Cin, Cout, k, stride, mode) of {label}, ranked by "
          f"gap = launches x (warm - bound) [{card}]:")
    for r in sorted(rows, key=lambda r: -r["gap_ms"]):
        extra = ""
        if r["plain_ms"] is not None:
            extra += (f"; plain {r['plain_ms']:.4f}; {r['yardstick_call']} "
                      f"{r['yardstick_ms']:.4f}")
        if "int_mm_ms" in r:
            extra += (f"; torch._int_mm {r['int_mm_ms']:.4f} (not K4's function: int32 out, "
                      "no epilogue)")
        if "mma_ms" in r:
            extra += f"; mma.sync route {r['mma_ms']:.4f} (first design: {r['first_route']})"
        print(f"  {tuple(r['shape'])} {r['k4_route']} x{r['launches_per_frame']}: warm "
              f"{r['ms']:.4f} ms, cold {r['cold_ms']:.4f} ({r['cold_by']}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), {r['pct_of_bound']:.1f}% of it, gap "
              f"{r['gap_ms']:.4f}" + extra)
    graph_sum = sum(r["launches_per_frame"] * r["ms"] for r in rows)
    print(f"K4's bounds summed over {label}'s {len(calls)} launches: {bound_sum:.4f} ms; "
          f"its warm CUDA-graph times summed the same way: {graph_sum:.4f} ms [{card}]")
    if on_mma:  # the launches that took the mma.sync route in its first design
        was = [r for r in rows if r["first_route"] == "mma"]
        n = sum(r["launches_per_frame"] for r in was)
        print(f"K4 in {label}, the {n} launches the first design sent to the mma.sync "
              "route, warm ms a frame: "
              f"{sum(r['launches_per_frame'] * r['ms'] for r in was):.4f} on their routes now, "
              f"{sum(r['launches_per_frame'] * r['mma_ms'] for r in was):.4f} on the mma.sync "
              f"route, bounds {sum(r['launches_per_frame'] * r['bound_ms'] for r in was):.4f} "
              f"[{card}]")
    return rows


def time_k4_mma_route(device, card):
    """K4's mma.sync route, which no conv of the zoo's int8 chains takes, on
    K4_MMA_SHAPES in mode a (tests/test_torch_cuda.py holds every mode to
    the plain version): each launch on that route and EXACT against the
    plain version, its warm CUDA-graph ms beside its bound. Returns
    (max|err|, one row per shape for the kernels line)."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4
    from lfdtpu_torch.tools.kernel_trace import k4_case

    g = torch.Generator(device=device).manual_seed(21)
    err, rows = 0.0, []
    for n, h, w, cin, cout, k, stride in K4_MMA_SHAPES:
        check(k4.route_of(cin, cout, k, stride) == "mma", f"{cin}->{cout} {k}x{k}/s{stride} "
              "does not take the mma.sync route")
        call = k4_case(device, g, n, h, w, cin, cout, k, stride, "a")
        before = k4.int8_conv.routes["mma"]
        e, _ = check_k4([call], f"the mma.sync route, ({n}, {h}, {w}) {cin}->{cout} "
                        f"{k}x{k}/s{stride}")
        check(k4.int8_conv.routes["mma"] - before == 1,
              "a synthetic shape's launch left the mma.sync route")
        err = max(err, e)
        shape = k4_shape(call)
        bound, by = kernel_bound_ms("int8_conv", shape)
        warm = graph_ms([lambda: k4.int8_conv(**call)])
        rows.append(dict(shape=list(shape), k4_route="mma", launches_per_frame=0, ms=warm,
                         bound_ms=bound, bound_by=by, pct_of_bound=100.0 * bound / warm,
                         max_abs_err=e, plain_ms=None, library_ms=None,
                         note="synthetic: no conv of the zoo's int8 chains takes this route"))
        print(f"  mma.sync route {tuple(shape)}: warm {warm:.4f} ms, bound {bound:.4f} ({by}), "
              f"{rows[-1]['pct_of_bound']:.1f}% of it [{card}]")
    return err, rows


def narrow_int8_path(name, device, card, counters, rng):
    """Phase 13, one narrow LFD of NARROW_INT8 (WIDERFACE-XS, TL-S), whose
    32- and 48-channel convs the wgmma and stem routes take at their own
    widths. K4 against its plain version on every call of one eager frame at
    batch 1 and 4, each launch on its route (the counts of NARROW_INT8). The
    main path, counters zeroed: the captured int8 engines (float32 and bf16
    head, calibrated by default), INT8_FRAMES frames each through
    predict_for_single_image_with_engine, the replays counted from a
    profile. Each captured engine against an eager twin, int8 against fp32
    by lfdtpu's criteria; a fresh int8 capture's launches (profile_engine).
    Then K4 timed alone at every distinct (shape, mode) of a frame on its
    route and on the mma.sync route. Returns (launches, replays, K4's
    max|err|, K4's rows)."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    hw, pre_name, switches, seed, by_route, timed = NARROW_INT8[name]
    det = build_detector(device, seed=seed, name=name, cls_std=CLS_STD if pre_name else None)
    pre = traffic_preprocess(pre_name) if pre_name else None
    want = expected_launches(det, VARIANTS["int8"])
    print(f"{name} int8 chain plan: {want['int8_conv']} K4 launches a frame")

    k4_err, calls_b1 = 0.0, None
    for batch in (1, 4):
        eager = compile_engine(det, hw, device, "int8", batch_size=batch, captured=False,
                               preprocess=pre, **switches)
        _, calls = check_k4_routes(
            lambda: k4_inputs(lambda: eager.dense(frames(rng, batch, hw))),
            f"{name} int8 batch {batch}", expect=by_route)
        check(len(calls) == want["int8_conv"],
              f"{name}: one eager int8 call gave K4 {len(calls)} calls")
        k4_err = max(k4_err, check_k4(calls, f"{name} int8 batch {batch}")[0])
        if batch == 1:
            calls_b1 = calls
        del eager, calls
    torch.cuda.empty_cache()

    # the main path
    zero_counts(counters)
    engines = {v: compile_engine(det, hw, device, v, preprocess=pre, **switches)
               for v in ("int8", "int8_bf16")}
    imgs = [frames(rng, 1, (hw[0] - 8 - 24 * i, hw[1] - 40 * i))[0] for i in range(INT8_FRAMES)]
    prof, rows = profiled(lambda: engines["int8"](frames(rng, 1, hw), hw),
                          lambda: {v: [det.predict_for_single_image_with_engine(e, f)
                                       for f in imgs] for v, e in engines.items()})
    replayed, window = kernel_launches_in(prof)
    launches = {c.__name__: c.launches for c in counters}
    routes = dict(k4.int8_conv.routes)
    print(f"{name} int8 main path: {2 * INT8_FRAMES} replays served "
          f"{ {v: [len(r) for r in rr] for v, rr in rows.items()} } rows; launches at build and "
          f"capture {launches}, K4's by route {routes}; by the replays (profile) {replayed} "
          f"({window}); per capture {engines['int8'].captured_launches} (counted from the net "
          f"{want})")
    check(routes["mma"] == 0 and sum(routes.values()) == launches["int8_conv"],
          f"the {name} int8 main path sent a K4 launch to the mma.sync route")
    for k, v in want.items():
        check((launches[k] > 0) == (v > 0), f"{name} int8: {k} launched {launches[k]}")
    check(all(e.captured and e.captured_launches == want for e in engines.values()),
          f"{name} int8: a capture did not record {want}")
    check(replayed == {k: 2 * INT8_FRAMES * v for k, v in want.items()},
          f"the {name} int8 replays did not launch each kernel as captured")
    for v, rr in rows.items():
        for r, img in zip(rr, imgs):
            check_rows(det, r, img)
    for v, e in engines.items():
        captured_vs_eager(det, hw, device, rng, v, 1, name, captured=e, preprocess=pre,
                          act_scales=e.int8_chain.amax, **switches)
    x = frames(rng, 1, hw)
    fp32 = compile_engine(det, hw, device, "fp32", captured=False, preprocess=pre, **switches)
    for v, e in engines.items():
        check_int8_close_to_fp32(e, fp32, x, f"{name} {v}")
    fresh = compile_engine(det, hw, device, "int8", preprocess=pre,
                           act_scales=engines["int8"].int8_chain.amax, **switches)
    profile_engine(fresh, torch.as_tensor(x, device=device),
                   torch.tensor(hw, dtype=torch.float32, device=device),
                   f"captured {name} int8", counters, want)
    del fp32, engines, fresh
    torch.cuda.empty_cache()

    print(f"[13 int8 kernel timings, {name}] {card}")
    k4_rows = time_k4(calls_b1, card, device, timed=timed, on_mma=True,
                      label=f"a {name} frame")
    del calls_b1
    torch.cuda.empty_cache()
    for r in k4_rows:
        r["path"] = f"{name} int8 {hw[0]}x{hw[1]}"
    return launches, replayed, k4_err, k4_rows


def int8_phase(device, card, counters, tmp):
    """Phase 13: the int8 engine (the fused int8 chain with K4, then the float
    remainder, decode and K1) of WIDERFACE-L at 1088x1920. K4 against its
    plain version at every (shape, mode) one eager call hands it, at batch 1
    and 4. The main path, counters zeroed: the captured int8 engines (float32
    and bf16 head), each calibrated by default (compile_inference's noise
    frames), INT8_FRAMES frames each through
    predict_for_single_image_with_engine (the replays counted from a
    profile), and one JPEG through the port's predict_engine.py with
    precision="int8". Then the captured engines against eager twins, int8
    against fp32 (lfdtpu's criteria), decode + NMS with K1 against the plain
    NMS, the GPU against the CPU at SMALL_HW; TL-L at 768x1280 (its
    norm-free head runs int8: F15's path), the same checks and K4 at its
    shapes; K4's mma.sync route on K4_MMA_SHAPES (time_k4_mma_route);
    WIDERFACE-XS and TL-S (narrow_int8_path); each int8 engine's launches
    (profile_engine); then K4 timed alone. Returns (main path launches,
    replays, K4's max|err|, K4's timing rows and the mma route's rows,
    TL-L's launches and replays, the main path's routes, {narrow path:
    (launches, replays, K4's rows)})."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    det = build_detector(device)
    rng = np.random.RandomState(13)
    want = expected_launches(det, VARIANTS["int8"])
    print(f"WIDERFACE-L int8 chain plan: {want['int8_conv']} K4 launches a frame "
          "(deploy/int8_net.py::planned_launches)")

    # K4 against its plain version at the shapes the main path gives it
    k4_err, calls_b1 = 0.0, None
    for batch in (1, 4):
        eager = compile_engine(det, HW, device, "int8", batch_size=batch, captured=False)
        _, calls = check_k4_routes(lambda: k4_inputs(lambda: eager.dense(frames(rng, batch, HW))),
                                   f"WIDERFACE-L int8 batch {batch}")
        check(len(calls) == want["int8_conv"],
              f"one eager int8 call gave K4 {len(calls)} calls, not {want['int8_conv']}")
        k4_err = max(k4_err, check_k4(calls, f"WIDERFACE-L int8 batch {batch}")[0])
        if batch == 1:
            calls_b1 = calls
        del eager, calls
    torch.cuda.empty_cache()

    # the main path
    zero_counts(counters)
    engines = {v: compile_engine(det, HW, device, v) for v in ("int8", "int8_bf16")}
    imgs = [frames(rng, 1, (HW[0] - 8 - 24 * i, HW[1] - 40 * i))[0] for i in range(INT8_FRAMES)]

    def work():
        return {v: [det.predict_for_single_image_with_engine(e, f) for f in imgs]
                for v, e in engines.items()}

    prof, rows = profiled(lambda: engines["int8"](frames(rng, 1, HW), HW), work)
    replayed, window = kernel_launches_in(prof)
    script_rows = predict_engine_jpeg(det, (HW[0] - 8, HW[1]), rng, tmp)
    launches = {c.__name__: c.launches for c in counters}
    routes = dict(k4.int8_conv.routes)
    print(f"WIDERFACE-L int8 main path, K4's launches by route at build and capture: {routes}")
    check(routes["mma"] == 0 and sum(routes.values()) == launches["int8_conv"],
          "the int8 main path sent a K4 launch to the mma.sync route")
    print(f"WIDERFACE-L int8 main path: {2 * INT8_FRAMES} replays served "
          f"{ {v: [len(r) for r in rr] for v, rr in rows.items()} } rows, predict_engine.py "
          f"(int8) {len(script_rows)} rows; launches at build and capture {launches}; by the "
          f"replays (profile) {replayed} ({window}); per capture "
          f"{ {v: e.captured_launches for v, e in engines.items()} } (counted from the net "
          f"{want})")
    for k, v in want.items():
        check((launches[k] > 0) == (v > 0), f"the int8 main path launched {k} "
              f"{launches[k]} times, the net takes it {v} times a frame")
    check(all(e.captured and e.captured_launches == want for e in engines.values()),
          f"an int8 capture did not record {want}")
    check(replayed == {k: 2 * INT8_FRAMES * v for k, v in want.items()},
          "the int8 replays did not launch each kernel as captured")
    for v, rr in rows.items():
        for r, img in zip(rr, imgs):
            check_rows(det, r, img)
    check_rows(det, script_rows, np.zeros((HW[0] - 8, HW[1], 3)))

    # captured against eager twins (the same scales), int8 against fp32, K1
    for v, e in engines.items():
        captured_vs_eager(det, HW, device, rng, v, 1, "WIDERFACE-L", captured=e,
                          act_scales=e.int8_chain.amax)
    x = frames(rng, 1, HW)
    fp32 = compile_engine(det, HW, device, "fp32", captured=False)
    for v, e in engines.items():
        check_int8_close_to_fp32(e, fp32, x, f"WIDERFACE-L {v}")
    del fp32
    amax = engines["int8"].int8_chain.amax
    plain_nms = compile_engine(det, HW, device, "int8", captured=False, nms_use_kernel=False,
                               act_scales=amax)
    c8, r8 = engines["int8"].dense(x)
    vhw = np.asarray([HW[0] - 8, HW[1]], np.float32)
    dk, dp = engines["int8"].decode(c8, r8, vhw), plain_nms.decode(c8, r8, vhw)
    same = all(torch.equal(dk[k], dp[k]) for k in dk)
    print(f"WIDERFACE-L int8 decode + NMS on the same dense outputs, K1 vs plain: "
          f"{int(dk['count'][0])} rows, identical={same}")
    check(same and int(dk["count"][0]) > 0, "int8 decode with K1 differs from the plain NMS")
    del plain_nms
    check_int8_gpu_vs_cpu(det, device, rng)
    xc = torch.as_tensor(x, device=device)
    vhw_c = torch.as_tensor(vhw, device=device)
    for v in ("int8", "int8_bf16"):
        fresh = compile_engine(det, HW, device, v, act_scales=engines[v].int8_chain.amax)
        profile_engine(fresh, xc, vhw_c, f"captured WIDERFACE-L {v}", counters, want)
        del fresh
    del engines
    torch.cuda.empty_cache()

    # TL-L: its norm-free head runs int8 too (F15's path)
    tl = build_detector(device, seed=3, name="TL-L", cls_std=CLS_STD)
    pre = traffic_preprocess("TL-L")
    want_tl = expected_launches(tl, VARIANTS["int8"])
    zero_counts(counters)
    tl_engine = compile_engine(tl, TL_HW, device, "int8", preprocess=pre, class_agnostic=True)
    tl_imgs = [frames(rng, 1, (TL_HW[0] - 48, TL_HW[1]))[0]  # 720p in its bucket
               for _ in range(SERVED_FRAMES)]
    prof, tl_rows = profiled(lambda: tl_engine(frames(rng, 1, TL_HW), TL_HW),
                             lambda: [tl.predict_for_single_image_with_engine(tl_engine, f)
                                      for f in tl_imgs])
    tl_launches = {c.__name__: c.launches for c in counters}
    tl_routes = dict(k4.int8_conv.routes)
    print(f"TL-L int8 main path, K4's launches by route at build and capture: {tl_routes}")
    check(tl_routes["mma"] == 0 and sum(tl_routes.values()) == tl_launches["int8_conv"],
          "the TL-L int8 main path sent a K4 launch to the mma.sync route")
    tl_replayed, window = kernel_launches_in(prof)
    print(f"TL-L int8 main path: {SERVED_FRAMES} replays served {[len(r) for r in tl_rows]} "
          f"rows; launches at build and capture {tl_launches}; by the replays (profile) "
          f"{tl_replayed} ({window}); per capture {tl_engine.captured_launches} (counted "
          f"from the net {want_tl})")
    for k, v in want_tl.items():
        check((tl_launches[k] > 0) == (v > 0), f"TL-L int8: {k} launched {tl_launches[k]}")
    check(tl_engine.captured_launches == want_tl, f"TL-L int8: a capture did not record {want_tl}")
    check(tl_replayed == {k: SERVED_FRAMES * v for k, v in want_tl.items()},
          "TL-L int8 replays did not launch each kernel as captured")
    for r, img in zip(tl_rows, tl_imgs):
        check_rows(tl, r, img)
    captured_vs_eager(tl, TL_HW, device, rng, "int8", 1, "TL-L", captured=tl_engine,
                      preprocess=pre, act_scales=tl_engine.int8_chain.amax, class_agnostic=True)
    eager = compile_engine(tl, TL_HW, device, "int8", captured=False, preprocess=pre,
                           act_scales=tl_engine.int8_chain.amax, class_agnostic=True)
    _, calls = check_k4_routes(lambda: k4_inputs(lambda: eager.dense(frames(rng, 1, TL_HW))),
                               "TL-L int8")
    check(len(calls) == want_tl["int8_conv"], f"TL-L int8: {len(calls)} K4 calls a frame")
    err, seen = check_k4(calls, "TL-L int8 (its head's merge units included)")
    k4_err = max(k4_err, err)
    check(any(s[3] == 128 and s[4] == 128 and s[5] == 1 for s in seen),
          "TL-L's int8 head convs did not reach K4")
    del eager, calls, tl_engine
    torch.cuda.empty_cache()
    mma_err, mma_rows = time_k4_mma_route(device, card)
    k4_err = max(k4_err, mma_err)
    narrow = {}
    for name in NARROW_INT8:
        n_launches, n_replayed, n_err, n_rows = narrow_int8_path(name, device, card, counters,
                                                                 rng)
        narrow[name] = (n_launches, n_replayed, n_rows)
        k4_err = max(k4_err, n_err)

    print(f"[13 int8 kernel timings] {card}")
    k4_rows = time_k4(calls_b1, card, device)
    del calls_b1
    torch.cuda.empty_cache()
    return (launches, replayed, k4_err, k4_rows + mma_rows, tl_launches, tl_replayed, routes,
            narrow)


# ------------------------------------------------------------------ main

# ------------------------------------------------------- engine files

def serve_file(path, out_dir):
    """A fresh process of phase 14 (`chip_smoke.py --serve-file FILE DIR`):
    load one engine file with deploy.engine_io alone, as a serving process
    does (no model code), capture it, serve the FILE_FRAMES frames of
    DIR/../frames.npy under a profile of that fresh capture, and write the
    outputs (DIR/loaded.npz) and what it saw (DIR/loaded.json)."""
    # PyTorch's own TF32 switches (cuDNN's on): the loaded engine runs
    # under the file's, those of the process that built it
    from lfdtpu_torch.deploy.engine_io import load_engine
    from lfdtpu_torch.deploy.runner import launch_counts, tf32_switches

    engine = load_engine(path)
    launches = launch_counts()  # at load and capture: the warmup calls and the capture
    imgs = np.load(os.path.join(os.path.dirname(out_dir), "frames.npy"))
    vhw = np.asarray([HW[0] - 8, HW[1]], np.float32)
    prof, outs = profiled(lambda: engine(imgs[:1], vhw),
                          lambda: [engine(f[None], vhw) for f in imgs])
    replayed, window = kernel_launches_in(prof)
    np.savez(os.path.join(out_dir, "loaded.npz"),
             **{f"{k}{i}": v.cpu().numpy() for i, o in enumerate(outs) for k, v in o.items()})
    with open(os.path.join(out_dir, "loaded.json"), "w") as f:
        json.dump(dict(
            captured=engine.captured, captured_launches=engine.captured_launches,
            process_tf32=tf32_switches(), engine_tf32=engine.tf32, launches=launches,
            replayed=replayed, window=window, modules=sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "flax", "lfdtpu")
                           or m.startswith(("lfdtpu_torch.models", "lfdtpu_torch.zoo")))), f)
    return 0


def check_engine_files(det, device, card, counters, tmp, rng):
    """Phase 14's first path: each FILE_VARIANTS engine built (counters
    zeroed before), serving FILE_FRAMES frames under a profile, and saved;
    then the three files loaded in three fresh processes at once
    (serve_file). Returns (the built engines' launches at build and
    capture, their replays, the loaded engines' at load and capture, their
    replays)."""
    from lfdtpu_torch.deploy.engine_io import read_meta, save_engine

    imgs = frames(rng, FILE_FRAMES, HW)
    np.save(os.path.join(tmp, "frames.npy"), imgs)
    vhw = np.asarray([HW[0] - 8, HW[1]], np.float32)
    zero_counts(counters)
    built = {}
    for variant in FILE_VARIANTS:
        before = {c.__name__: c.launches for c in counters}
        engine = compile_engine(det, HW, device, variant)
        at_build = {c.__name__: c.launches - before[c.__name__] for c in counters}
        want = expected_launches(det, VARIANTS[variant])
        check(engine.captured and engine.captured_launches == want,
              f"the built {variant} engine did not capture {want}")
        prof, outs = profiled(lambda: engine(frames(rng, 1, HW), vhw),
                              lambda: [engine(f[None], vhw) for f in imgs])
        replayed, _ = kernel_launches_in(prof)
        check(replayed == {k: FILE_FRAMES * n for k, n in want.items()},
              f"the built {variant} engine's replays launched {replayed}")
        path = os.path.join(tmp, variant, "engine.lfde")
        os.makedirs(os.path.dirname(path))
        save_engine(engine, path)
        built[variant] = dict(
            path=path, outs=[{k: v.cpu().numpy() for k, v in o.items()} for o in outs],
            launches=at_build, captured_launches=engine.captured_launches,
            replayed=replayed)
        del engine, outs
    launches = {c.__name__: c.launches for c in counters}
    procs = {}
    for v, b in built.items():
        log = open(os.path.join(os.path.dirname(b["path"]), "log.txt"), "w")
        procs[v] = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve-file",
                                     b["path"], os.path.dirname(b["path"])],
                                    stdout=log, stderr=subprocess.STDOUT)
        log.close()
    try:
        for p in procs.values():
            p.wait(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:  # no process outlives the run
                p.kill()
                p.wait()
    built_replayed = dict.fromkeys(ENGINE_KERNELS, 0)
    loaded_launches = dict.fromkeys(ENGINE_KERNELS, 0)
    loaded_replayed = dict.fromkeys(ENGINE_KERNELS, 0)
    for variant, b in built.items():
        d = os.path.dirname(b["path"])
        with open(os.path.join(d, "log.txt")) as f:
            log = f.read()
        check(procs[variant].returncode == 0,
              f"the fresh process serving {variant} failed:\n{log[-4000:]}")
        with open(os.path.join(d, "loaded.json")) as f:
            got = json.load(f)
        loaded = np.load(os.path.join(d, "loaded.npz"))
        same = all(np.array_equal(o[k], loaded[f"{k}{i}"])
                   for i, o in enumerate(b["outs"]) for k in o)
        counts = [int(o["count"][0]) for o in b["outs"]]
        print(f"{variant}: saved to {os.path.getsize(b['path']) / 1e6:.3f} MB (program calls "
              f"{read_meta(b['path'])['ops']}); its fresh process loaded and captured it, "
              f"model modules imported {got['modules']}; {FILE_FRAMES} frames ({counts} rows) bit-equal to "
              f"the built engine={same}; launches at build / load (warmup calls and capture) "
              f"{b['launches']} / {got['launches']}, per capture built "
              f"{b['captured_launches']}, loaded {got['captured_launches']}; replays (profile "
              f"of a fresh capture, by "
              f"kernel name) built {b['replayed']}, loaded {got['replayed']} "
              f"({got['window']}) [{card}]")
        check(got["captured"] and got["modules"] == [],
              f"{variant}: the loaded engine was not captured, or its process imported "
              f"model code {got['modules']}")
        # the fresh process keeps PyTorch's own switches (cuDNN TF32 on); the
        # loaded engine ran under the file's, the building process's (off)
        check(got["process_tf32"][1] and got["engine_tf32"] == [False, False],
              f"{variant}: TF32 switches of the process {got['process_tf32']}, of the "
              f"loaded engine {got['engine_tf32']}")
        check(same and min(counts) > 0, f"{variant}: the loaded engine's outputs differ")
        check(got["captured_launches"] == b["captured_launches"]
              and got["launches"] == b["launches"],
              f"{variant}: the loaded engine launched {got['launches']} at load, "
              f"{got['captured_launches']} in its capture")
        check(got["replayed"] == b["replayed"],
              f"{variant}: the replays launched built {b['replayed']}, loaded {got['replayed']}")
        for k in ENGINE_KERNELS:
            built_replayed[k] += b["replayed"][k]
            loaded_launches[k] += got["launches"][k]
            loaded_replayed[k] += got["replayed"][k]
    return launches, built_replayed, loaded_launches, loaded_replayed


def check_predict_engine_file(det, rng, tmp):
    """The WIDERFACE predict_engine.py with engine_file: the first run
    builds and saves, the second loads (no model built); rows equal."""
    from lfdtpu_torch.execution import save_checkpoint

    ckpt, jpg = os.path.join(tmp, "files.pth"), os.path.join(tmp, "files.jpg")
    engine_file = os.path.join(tmp, "script.lfde")
    save_checkpoint(ckpt, det.net)
    write_frame(jpg, (HW[0] - 8, HW[1]), rng)
    script = load_script("WIDERFACE_train", "predict_engine.py")
    rows = []
    for _ in range(2):
        with contextlib.redirect_stdout(io.StringIO()):  # the script prints every row
            rows.append(script.predict_with_engine(
                "L", ckpt, jpg, classification_threshold=SERVE_THRESHOLD,
                out_path=os.path.join(tmp, "files_out.jpg"), engine_file=engine_file))
    print(f"predict_engine.py with engine_file: the first run built and saved "
          f"({len(rows[0])} rows), the second loaded the file ({len(rows[1])} rows); rows "
          f"equal={rows[0] == rows[1]}")
    check(len(rows[0]) > 0 and rows[0] == rows[1], "predict_engine.py: the loaded rows differ")


def check_streams(det, device, card, rng):
    """run_stream at STREAM_DEPTHS up and down (1 2 4 4 2 1: the staging
    slots grow, then serve fewer requests in flight) with the captured bf16
    K1-K3 engine, bit-equal to the synchronous loop; then the output_dtype="f16"
    engine, the same, and within lfdtpu's tolerances of the float32
    outputs."""
    import torch

    from lfdtpu_torch.deploy import run_stream

    engines = {"f32": compile_engine(det, HW, device, "bf16_kernels"),
               "f16": compile_engine(det, HW, device, "bf16_kernels", output_dtype="f16")}
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    check(all(e.captured and e.captured_launches == want for e in engines.values()),
          f"a stream engine did not capture {want}")
    vhw = np.asarray([HW[0] - 8, HW[1]], np.float32)
    reqs = [(frames(rng, 1, HW), vhw) for _ in range(STREAM_FRAMES)]
    for name, engine in engines.items():
        sync = [{k: v.cpu().numpy() for k, v in engine(*r).items()} for r in reqs]
        for depth in STREAM_DEPTHS + STREAM_DEPTHS[::-1]:
            got = list(run_stream(engine, iter(reqs), depth=depth))
            same = len(got) == len(sync) and all(
                all(np.array_equal(g[k], s[k]) for k in s) for g, s in zip(got, sync))
            print(f"run_stream {name} outputs, depth {depth}: {len(got)} frames, staging slots "
                  f"{len(engine._graphs[torch.uint8].slots)}; bit-equal to the synchronous "
                  f"loop={same} [{card}]")
            check(same, f"run_stream at depth {depth} differs from the synchronous loop")
        if name == "f32":
            ref = sync
        else:
            n = [int(r["count"][0]) for r in ref]
            close = all(int(g["count"][0]) == m and np.array_equal(g["labels"], r["labels"])
                        and np.abs(g["boxes"].astype(np.float32) - r["boxes"]).max() <= F16_TOL[0]
                        and np.abs(g["scores"].astype(np.float32) - r["scores"]).max()
                        <= F16_TOL[1] for g, r, m in zip(sync, ref, n))
            nbytes = {k: sum(v.nbytes for v in out.values()) for k, out in
                      (("f32", ref[0]), ("f16", sync[0]))}
            print(f"output_dtype f16 against float32 outputs over {STREAM_FRAMES} frames: "
                  f"counts and labels equal, boxes within {F16_TOL[0]} px, scores within "
                  f"{F16_TOL[1]}={close}; bytes to the host a frame {nbytes}")
            check(close and min(n) > 0, "the f16 outputs are not within lfdtpu's tolerances")
    del engines


def check_buckets(det, device, card, rng):
    """BucketedEngineSet over DEFAULT_BUCKETS (bf16 K1-K3), prewarmed; three
    frames routed; rows equal to engines built at each bucket."""
    import torch

    from lfdtpu_torch.deploy import BucketedEngineSet, make_device_preprocess
    from lfdtpu_torch.deploy.buckets import DEFAULT_BUCKETS

    kw = {k: v for k, v in VARIANTS["bf16_kernels"].items() if k != "precision"}
    bset = BucketedEngineSet(det, DEFAULT_BUCKETS, precision="bf16", device=device,
                             preprocess=make_device_preprocess(MEAN, STD), **kw)
    bset.prewarm()
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    check(sorted(bset._engines) == list(bset.buckets)
          and all(e.captured and e.captured_launches == want for e in bset._engines.values()),
          "BucketedEngineSet.prewarm did not capture every bucket")
    routed = []
    for hw in BUCKET_FRAMES:
        img = frames(rng, 1, hw)[0]
        bucket = bset.bucket_for(*hw)
        rows = bset.predict(img)
        direct = compile_engine(det, bucket, device, "bf16_kernels")
        ref = det.predict_for_single_image_with_engine(direct, img)
        check(len(rows) > 0 and rows == ref, f"a {hw} frame's rows in bucket {bucket} differ "
              "from the engine built at that bucket")
        check_rows(det, rows, img)
        routed.append((hw, bucket, len(rows)))
        del direct
    print(f"BucketedEngineSet over {bset.buckets} (bf16 K1-K3), prewarmed: "
          f"frames routed (size, bucket, rows) {routed}, rows equal to engines built at each "
          f"bucket [{card}]")
    del bset
    torch.cuda.empty_cache()


def files_phase(det, device, card, counters, tmp):
    """Phase 14: serving from engine files, streaming and buckets (see the
    module's head). Returns the engine-file paths' launch counts."""
    rng = np.random.RandomState(14)
    counts = check_engine_files(det, device, card, counters, tmp, rng)
    check_predict_engine_file(det, rng, tmp)
    check_streams(det, device, card, rng)
    check_buckets(det, device, card, rng)
    return counts


# ------------------------------------------------------------ learning

def check_multiclass_nms(device, counters):
    """multiclass_nms on CUDA tensors (K1) against its plain path
    (use_kernel=False) on MCNMS_SHAPE seeded candidates offset by class,
    scores tied in twentieths, invalid rows, and more NMS survivors than
    max_num in every image: keep, the order over the survivors and count
    equal. The kernel call runs with the counters zeroed; returns (its
    launches, K1's max|err| as 0/1)."""
    import torch

    from lfdtpu_torch.ops.nms import multiclass_nms, nms_mask

    rng = np.random.RandomState(15)
    B, K = MCNMS_SHAPE
    xy = rng.rand(B, K, 2) * 12 * K ** 0.5
    boxes = np.concatenate([xy, xy + rng.rand(B, K, 2) * 60 + 1], -1)
    labels = rng.randint(0, 3, (B, K))
    boxes += (labels * (boxes.max() + 1.0))[..., None]
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=device)
    scores = torch.as_tensor(rng.randint(0, 21, (B, K)) / 20.0, dtype=torch.float32,
                             device=device)
    valid = torch.as_tensor(rng.rand(B, K) > 0.1, device=device)
    args = (boxes, scores, MCNMS_SCORE_THR, MCNMS_IOU)
    zero_counts(counters)
    keep, order, count = multiclass_nms(*args, max_num=MCNMS_MAX, valid=valid)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    pkeep, porder, pcount = multiclass_nms(*args, max_num=MCNMS_MAX, valid=valid,
                                           use_kernel=False)
    survivors = nms_mask(boxes, scores, MCNMS_IOU, valid=valid & (scores > MCNMS_SCORE_THR),
                         use_kernel=False).sum(-1)
    same = torch.equal(keep, pkeep) and torch.equal(count, pcount) and all(
        torch.equal(order[b, :n], porder[b, :n]) for b, n in enumerate(survivors.tolist()))
    print(f"multiclass_nms (B, K) = {MCNMS_SHAPE}, max_num {MCNMS_MAX}: survivors "
          f"{survivors.tolist()}, count {count.tolist()}; K1 against the plain path: keep, "
          f"order over the survivors and count equal={same}; launches {launches}")
    check(bool((survivors > MCNMS_MAX).all()), "multiclass_nms: an image without more "
          "survivors than max_num")
    check(launches["nms_mask_sorted"] == 1, "multiclass_nms did not launch K1 once")
    check(same, "multiclass_nms with K1 differs from its plain path")
    return launches, 0.0


def remat_step(device, card):
    """WIDERFACE-L's train step at phase 6's batch (64, crop 480, Nmax 200)
    with and without remat, fp32 and bf16 autocast, from the same weights
    and batch: one step each and its peak GiB allocated. After that step the remat net's BN running statistics
    equal the plain net's bit for bit (a second update in the recomputation
    would move running_mean and running_var by a tenth of the batch's
    statistics and count the batch twice) and its params agree within
    TRAIN_TOL."""
    import torch

    weights = init_weights(11)
    batch = [torch.as_tensor(a, device=device) for a in train_batch(
        np.random.RandomState(11), TRAIN_BATCH, TRAIN_HW, TRAIN_NMAX)]
    sched = train_schedule()
    for mp in (False, True):
        first, peaks = {}, {}
        for remat in (False, True):
            det, step = make_trainer(device, TRAIN_HW, weights, mixed_precision=mp,
                                     remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(*batch, sched(0, 0), True)
            first[remat] = {k: v.clone() for k, v in det.net.state_dict().items()}
            peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
            del det, step
            torch.cuda.empty_cache()
        plain, remat = first[False], first[True]
        stats = [k for k in plain if "running" in k or "num_batches_tracked" in k]
        bit_equal = all(torch.equal(plain[k], remat[k]) for k in stats)
        stat_err = max(rel_err(remat[k], plain[k]) for k in stats if "running" in k)
        tracked = {int(plain[k]) for k in stats if "num_batches_tracked" in k} | \
            {int(remat[k]) for k in stats if "num_batches_tracked" in k}
        param_err = max(rel_err(remat[k], plain[k]) for k in plain
                        if k not in stats and plain[k].is_floating_point())
        name = "bf16" if mp else "fp32"
        print(f"train {name} WIDERFACE-L batch {TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, "
              f"one step: peak GiB allocated plain {peaks[False]:.2f}, remat "
              f"{peaks[True]:.2f} [{card}]")
        print(f"  after one step from the same weights, remat against plain: BN statistics "
              f"bit-equal={bit_equal} (max|err|/max|ref| {stat_err:.2e}), "
              f"num_batches_tracked {sorted(tracked)}, params max|err|/max|ref| "
              f"{param_err:.2e} (tol {TRAIN_TOL})")
        check(tracked == {1}, f"remat ({name}) counted a batch twice in its BN statistics")
        check(bit_equal, f"remat ({name}) moved the BN statistics: {stat_err}")
        check(param_err < TRAIN_TOL, f"remat ({name}) params differ: {param_err}")


class EngineWatch:
    """run_synthetic's on_engine for phase 15: each engine's scoring runs
    under a profile (its replays counted by kernel name, which must be
    VAL_IMAGES times its capture's launches, and those what expected_launches
    counts from the net); the engine is kept for check_kernels."""

    def __init__(self, label):
        self.label = label
        self.engines = {}
        self.replayed = {name: 0 for name in ENGINE_KERNELS}
        self.calls = {}  # {engine: {kernel: its calls on the first frame}}, by check_kernels

    def __call__(self, name, engine, score):
        from lfdtpu_torch.tools import synthetic_e2e as syn

        det = engine.program.detector
        size = engine.input_resolution
        want = expected_launches(det, syn.engine_switches(det, name))
        prof, mAP = profiled(lambda: engine(np.zeros((1, *size, 3), np.uint8), size), score)
        replayed, window = kernel_launches_in(prof)
        print(f"  {self.label} {name} engine {size[0]}x{size[1]}: mAP_50 {mAP:.4f}; launches "
              f"per capture {engine.captured_launches}, by the {syn.VAL_IMAGES} scored "
              f"frames' replays {replayed} ({window})")
        check(engine.captured and engine.captured_launches == want,
              f"{self.label} {name}: the capture did not record {want}")
        check(replayed == {k: syn.VAL_IMAGES * v for k, v in want.items()},
              f"{self.label} {name}: the replays did not launch each kernel as captured")
        for k, v in replayed.items():
            self.replayed[k] += v
        self.engines[name] = (engine, want)
        return mAP

    def check_kernels(self, frames_, errs):
        """Every kernel the kept engines launch against its plain version on
        what an eager pass over each of `frames_` hands it: K1 and K4
        exactly, K2 and K3 within K2_TOL and K3_TOL (max|err| / max|ref|).
        Folds each kernel's max|err| into `errs` and keeps the first
        frame's calls in self.calls."""
        import torch

        from lfdtpu_torch.deploy import kernel_net
        from lfdtpu_torch.ops import conv_kernels as ck
        from lfdtpu_torch.ops import nms_kernel

        for name, (engine, want) in self.engines.items():
            label = f"{self.label} {name}"
            size = engine.input_resolution
            vhw = torch.tensor(size, dtype=torch.float32, device=engine.device)
            seen = {}
            for i, frame in enumerate(frames_):
                x = torch.as_tensor(frame[None], device=engine.device)
                k2 = k3 = calls = ()
                if want["int8_conv"]:
                    dense, calls = check_k4_routes(lambda: k4_inputs(lambda: engine.dense(x)),
                                                   label)
                    check(len(calls) == want["int8_conv"], f"{label}: {len(calls)} K4 calls")
                    errs["int8_conv"] = max(errs["int8_conv"], check_k4(calls, label)[0])
                else:
                    (dense, k3), k2 = recorded_calls(kernel_net, "stem_conv", lambda: (
                        recorded_calls(kernel_net, "pair_conv3x3", lambda: engine.dense(x))))
                    check((len(k2), len(k3)) == (want["stem_conv"], want["pair_conv3x3"]),
                          f"{label}: K2/K3 called {len(k2)}/{len(k3)} times, not {want}")
                    for kernel, plain, calls, tol in (
                            ("stem_conv", ck.stem_conv_plain, k2, K2_TOL),
                            ("pair_conv3x3", ck.pair_conv3x3_plain, k3, K3_TOL)):
                        for args, kw in calls:
                            got = getattr(ck, kernel)(*args, **kw)
                            ref = plain(*args, **kw)
                            e = rel_err(got, ref)
                            errs[kernel] = max(errs[kernel],
                                               float((got.float() - ref.float()).abs().max()))
                            shape = (kernel, tuple(args[0].shape), kw.get("residual") is not None)
                            seen[shape] = max(seen.get(shape, 0.0), e)
                            check(e < tol, f"{label}: {kernel} at {shape[1]} disagrees with "
                                  f"its plain version ({e:.3e}, tol {tol})")
                _, k1 = k1_inputs(lambda: engine.decode(*dense, vhw))
                if i == 0:
                    self.calls[name] = dict(nms_mask_sorted=k1, stem_conv=k2, pair_conv3x3=k3,
                                            int8_conv=calls)
                check(len(k1) == want["nms_mask_sorted"], f"{label}: {len(k1)} K1 calls")
                for b, v, thr in k1:
                    got = nms_kernel.nms_mask_sorted(b, v, thr)
                    ref = nms_kernel.nms_mask_sorted_plain(b, v, thr)
                    bad = int((got != ref).sum())
                    seen[("nms_mask_sorted", tuple(b.shape), int(v.sum()))] = float(bad)
                    check(bad == 0, f"{label}: K1 disagrees with its plain version")
            torch.cuda.synchronize()
            print(f"  {label}: K1-K3 against their plain versions at (kernel, shape, "
                  f"residual or valid rows): max|err|/max|ref| (K2, K3) or mismatches (K1) "
                  + "; ".join(f"{k} {v:.3e}" for k, v in seen.items()))


def time_learned_shapes(watch, device, card):
    """The kernels at the shapes a trained 128x128 engine gave them (phase
    15, WIDERFACE-L's watch): K1 on the fp32 engine's input (its valid rows
    this run's), K2 and K3 (LEARNED_K3 levels) on the bf16 engine's calls,
    K4 at every distinct (shape, mode) of the int8 engine's frame; each
    beside its bound, its plain version and, for K3, cuDNN. Returns
    {kernel: [rows]}."""
    import torch

    from lfdtpu_torch.ops import nms_kernel

    g = torch.Generator(device=device).manual_seed(15)
    rows = {}
    b, v, thr = watch.calls["fp32"]["nms_mask_sorted"][0]
    warm = graph_ms([lambda: nms_kernel.nms_mask_sorted(b, v, thr)])
    plain = time_ms(lambda: nms_kernel.nms_mask_sorted_plain(b, v, thr))
    rows["nms_mask_sorted"] = [dict(shape=list(b.shape[:2]), valid=int(v.sum()), **_timing(
        "nms_mask_sorted", tuple(b.shape[:2]), card, warm, warm, plain, None,
        note=f" ({int(v.sum())} valid rows, a trained {watch.label} engine)"))]
    bf16 = watch.calls["bf16"]
    (k2_args, _), = bf16["stem_conv"]
    rows["stem_conv"] = [dict(shape=list(k2_args[0].shape[:3]),
                              **time_k2(device, card, k2_args, g)[0])]
    _, wk, s, bias = bf16["pair_conv3x3"][0][0]
    rows["pair_conv3x3"] = time_k3(device, card, (wk, s, bias), g, LEARNED_K3)[0]
    rows["int8_conv"] = time_k4(watch.calls["int8"]["int8_conv"], card, device,
                                timed=LEARNED_K4, label=f"a trained {watch.label} frame")
    for r in rows["int8_conv"]:
        r["path"] = f"trained {watch.label} int8 128x128"
    return rows


def learning_phase(device, card, counters):
    """Phase 15: the port learns. multiclass_nms on CUDA tensors against its
    plain path; the remat train step (remat_step); lfdtpu's synthetic runs
    and bars (LEARNING_RUNS) through the port's run_synthetic on the card,
    then WIDERFACE-XS and -L trained as int8_quality_cell.py trains them and
    scored through four engines each (fp32, bf16 with K1 and K3 plus K2
    where the stem takes it, int8 with a float32 and with a bf16 head),
    each faster engine within ENGINE_DELTA of fp32. Each run is a path:
    counters zeroed before it, read after it (K1 in the val loop's eager
    decode, the engines' warmups and captures), its engines' replays counted
    from profiles; then every kernel its engines launch against its plain
    version (EngineWatch.check_kernels). Any bar missed fails the run.
    Then the kernels at the trained WIDERFACE-L engines' shapes
    (time_learned_shapes). Returns ({path: launches}, {kernel: max|err|},
    {kernel: timing rows})."""
    import torch

    from lfdtpu_torch.tools import int8_quality_cell
    from lfdtpu_torch.tools import synthetic_e2e as syn

    errs = {name: 0.0 for name in ENGINE_KERNELS}
    paths = {}
    launches, errs["nms_mask_sorted"] = check_multiclass_nms(device, counters)
    paths["multiclass_nms (CUDA tensors)"] = dict(eager=launches, replayed=None)
    remat_step(device, card)

    watches = {}

    def path(label, run, multiscale=False, zoo_model=None):
        watch = watches[label] = EngineWatch(label)
        zero_counts(counters)
        result = run(watch)
        launches = {c.__name__: c.launches for c in counters}
        size, buckets, num_classes = syn.scenes(multiscale, zoo_model)
        val, _ = syn.make_dataset(2, seed=1, size=size, buckets=buckets,
                                  num_classes=num_classes)
        watch.check_kernels([s["image"] for s in val.values()], errs)
        paths[f"synthetic {label} {size}x{size} (val loop, engines)"] = dict(
            eager_and_capture=launches, replayed=watch.replayed)
        if label != "WIDERFACE-L":  # its engines' calls are timed at the end
            watch.engines, watch.calls = {}, {}
        torch.cuda.empty_cache()
        return result, launches

    for label, kw in LEARNING_RUNS:
        m, launches = path(
            label, lambda watch: syn.run_synthetic(device=device, on_engine=watch, **kw),
            kw.get("multiscale", False))
        extra = ""
        if "per_range_recall" in m:
            extra += f", per-range recall {[round(r, 4) for r in m['per_range_recall']]} " \
                     f"(bar >= {kw['recall_threshold']})"
        if "engine_mAP_50" in m:
            q = m["engine_mAP_50"]
            extra += f", engines' mAP_50 {q} (bar: int8 >= fp32 - {ENGINE_DELTA})"
            check(q["int8"] >= q["fp32"] - ENGINE_DELTA, f"{label}: int8 engine {q}")
        print(f"learning {label}: {kw['epochs']} epochs, mAP_50 {m.get('mAP_50', 0.0):.4f} (bar > "
              f"{kw['threshold']}){extra}, launches {launches} [{card}]")
    for model in QUALITY_MODELS:
        res, launches = path(
            model, lambda watch: int8_quality_cell.quality_cell(
                model, QUALITY_EPOCHS, device=device, on_engine=watch), zoo_model=model)
        print("QUALITY_RESULT " + json.dumps({k: v for k, v in res.items() if k != "total_s"}))
        q = {k: res[f"mAP_50_{k}_engine"] for k in ("fp32", "bf16", "int8", "int8_bf16")}
        print(f"learning {model}: {QUALITY_EPOCHS} epochs, mAP_50 {res['mAP_50_predict']} "
              f"(bar > {int8_quality_cell.THRESHOLD}), engines' mAP_50 {q} (bars: fp32 > "
              f"{int8_quality_cell.THRESHOLD}, each other >= fp32 - {ENGINE_DELTA}), "
              f"launches {launches} [{card}]")
        check(q["fp32"] > int8_quality_cell.THRESHOLD, f"{model}: fp32 engine {q['fp32']}")
        for k in ("bf16", "int8", "int8_bf16"):
            check(q[k] >= q["fp32"] - ENGINE_DELTA, f"{model}: the {k} engine {q}")
    print(f"[15 timings at the trained engines' shapes] {card}")
    rows = time_learned_shapes(watches["WIDERFACE-L"], device, card)
    return paths, errs, rows


# ---------------------------------------------------------- data parallelism

def free_port():
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cpu_state(net):
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def state_errs(got, ref, worst=False):
    """max|err| / max|ref| over the params and over the BN running
    statistics of two CPU state_dicts: (params, statistics), or with
    `worst` ((params, its worst tensor), (statistics, its worst))."""
    out = []
    for stats in (False, True):
        errs = {k: rel_err(got[k], v) for k, v in ref.items()
                if v.is_floating_point() and ("running" in k) == stats}
        name = max(errs, key=errs.get)
        out.append((errs[name], name) if worst else errs[name])
    return tuple(out)


def ddp_batch(device):
    """Phase 16's weights (randomized norms: a parameter that starts at zero
    would be held to the relative error of its update alone) and
    WIDERFACE-L batch (phase 6's shape), seeded."""
    import torch

    weights = build_detector("cpu", seed=13).net.state_dict()
    batch = train_batch(np.random.RandomState(13), TRAIN_BATCH, TRAIN_HW, TRAIN_NMAX)
    return weights, batch, [torch.as_tensor(a, device=device) for a in batch]


def ddp_world_size_1(device, card):
    """The train step through make_train_step(mesh=make_mesh()) in a process
    group of one rank over NCCL (DistributedDataParallel at world size 1)
    against the plain step, fp32 and bf16, from the same weights and batch:
    after one step the params and BN statistics within TRAIN_TOL (and
    whether bit-equal)."""
    import torch
    import torch.distributed as dist

    from lfdtpu_torch.parallel import make_mesh

    weights, _, batch = ddp_batch(device)
    sched = train_schedule()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        check(mesh.size == 1 and mesh.group is not None and dist.get_backend() == "nccl"
              and mesh.device == torch.device("cuda", 0), f"the NCCL mesh is {mesh}")
        for mode in ("fp32", "bf16"):
            first = {}
            for ddp in (False, True):
                det, step = make_trainer(device, TRAIN_HW, weights, mesh=mesh if ddp else None,
                                         mixed_precision=mode == "bf16")
                loss = step(*batch, sched(0, 0), True)["loss"]
                first[ddp] = (cpu_state(det.net), float(loss))
                del det, step
                torch.cuda.empty_cache()
            (plain, plain_loss), (ddp_state, ddp_loss) = first[False], first[True]
            perr, serr = state_errs(ddp_state, plain)
            lerr = abs(ddp_loss - plain_loss) / abs(plain_loss)
            bit = all(torch.equal(ddp_state[k], v) for k, v in plain.items())
            print(f"train {mode} WIDERFACE-L batch {TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, "
                  f"world size 1 over NCCL (DDP) [{card}]")
            print(f"  after one step from the same weights, DDP against plain: loss "
                  f"{lerr:.2e}, params {perr:.2e}, BN statistics {serr:.2e} max|err|/max|ref| "
                  f"(tol {TRAIN_TOL}), bit-equal={bit}")
            check(max(perr, serr, lerr) < TRAIN_TOL,
                  f"world size 1 ({mode}): the DDP step disagrees with the plain step")
    finally:
        dist.destroy_process_group()


class _SampleIndexed:
    """A dataset whose samples carry their index as the meta key
    `row_index` (the loader hands it out in the batch's meta)."""

    def __init__(self, dataset):
        self._ds = dataset

    def __getitem__(self, i):
        return dict(self._ds[i], row_index=int(i))

    def __len__(self):
        return len(self._ds)

    def get_indexes(self):
        return self._ds.get_indexes()


class _SeededBySample:
    """A region sampler whose draws from `random` are seeded by the sample's
    row_index, under a lock: the loader's worker threads share `random` and
    draw in whatever order they run, so only this makes a row's crop a
    function of its index alone, whatever worker makes it."""

    _lock = threading.Lock()

    def __init__(self, inner, seed):
        self._inner, self._seed = inner, seed

    def __call__(self, sample):
        with self._lock:
            random.seed(f"{self._seed}:{sample['row_index']}")
            return self._inner(sample)


def seed_by_sample(loader):
    """Phase 16's order check on a train loader: its samples indexed, its
    crops seeded by sample (before its first iteration)."""
    loader._dataset = _SampleIndexed(loader._dataset)
    loader._region_sampler = _SeededBySample(loader._region_sampler, DDP_SAMPLE_SEED)
    return loader


AUG_PARAMS = ("aug_scale", "aug_translation", "aug_flip")


def train_rows(batch):
    """(sample index, digest of its image bytes, padded boxes, labels, mask
    and aug params) of each row of a train batch."""
    keys = ("images", "gt_bboxes", "gt_labels", "gt_mask") + AUG_PARAMS
    out = []
    for i, meta in enumerate(batch["meta"]):
        h = hashlib.sha1()
        for k in keys:
            if k in batch:
                h.update(np.ascontiguousarray(batch[k][i]).tobytes())
        out.append((meta["row_index"], h.hexdigest()[:16]))
    return out


def val_rows(batch):
    """(image id, digest of its image bytes) of each row of a val batch."""
    return [(meta["image_id"], hashlib.sha1(np.ascontiguousarray(im).tobytes()).hexdigest()[:16])
            for im, meta in zip(batch["images"], batch["meta"])]


def recorded(loader, steps, rows):
    """loader, made to append rows(batch) of every batch it hands out to
    steps."""
    base = type(loader)

    class Recorded(base):
        def __iter__(self):
            for batch in base.__iter__(self):
                steps.append(rows(batch))
                yield batch

    loader.__class__ = Recorded
    return loader


def one_worker(loader):
    """A DataLoader over loader's dataset, sampler, region sampler and
    pipeline with one worker: the reference order."""
    from lfdtpu_torch.data import DataLoader

    return DataLoader(loader._dataset, loader._dataset_sampler, loader._region_sampler,
                      loader._augmentation_pipeline, num_workers=1,
                      max_boxes_per_image=loader._max_boxes, pad_divisor=loader._pad_divisor,
                      image_dtype=loader._image_dtype)


def ddp_rank(rank, out_dir):
    """One rank of phase 16's two (`chip_smoke.py --ddp-rank R DIR`), on the
    one card over gloo with CUDA tensors. The train step on its 32 rows of
    the seeded batch of 64 in every DDP_MODES mode: the state after each
    DDP_CHECKED step count and the global losses; then Executor.run() of WIDERFACE_LFD_L on DIR's pack for one
    epoch with a val pass, its K1 launches counted. Writes DIR/rank{R}.pt."""
    import torch
    import torch.distributed as dist

    from lfdtpu_torch.ops import conv_kernels, group_norm, int8_conv, kernel_lib, nms_kernel
    from lfdtpu_torch.parallel import (initialize_distributed, local_batch_slice,
                                       make_mesh)

    faulthandler.enable(all_threads=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "job.json")) as f:
        job = json.load(f)
    initialize_distributed("gloo", f"tcp://127.0.0.1:{job['port']}", job["world"], rank)
    mesh = make_mesh()
    check(mesh.device.type == "cuda" and dist.get_backend() == "gloo"
          and (mesh.rank, mesh.size) == (rank, job["world"]), f"rank {rank}: mesh {mesh}")
    kernel_lib.library()  # the parent built it
    counters = (nms_kernel.nms_mask_sorted, conv_kernels.stem_conv,
                conv_kernels.pair_conv3x3, int8_conv.int8_conv, group_norm.group_norm_relu)
    card = card_line()
    weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
    arrays = np.load(os.path.join(out_dir, "batch.npz"))
    lo, hi = local_batch_slice(TRAIN_BATCH, mesh.rank, mesh.size)
    batch = [torch.as_tensor(arrays[f"arr_{i}"][lo:hi], device=mesh.device) for i in range(4)]
    sched = train_schedule()
    out = dict(states={}, losses={}, rows=(lo, hi))
    zero_counts(counters)
    for mode, kw in DDP_MODES.items():
        det, step = make_trainer(mesh.device, TRAIN_HW, weights, mesh=mesh, **kw)
        states, losses = {}, []
        for it in range(max(DDP_CHECKED)):
            losses.append(float(step(*batch, sched(0, it), True)["loss"]))
            if it + 1 in DDP_CHECKED and (rank == 0 or it + 1 == max(DDP_CHECKED)):
                states[it + 1] = cpu_state(det.net)
        out["states"][mode], out["losses"][mode] = states, losses
        print(f"[rank {rank}] train {mode} WIDERFACE-L, rows {lo}-{hi} of {TRAIN_BATCH}, "
              f"{hi - lo} a rank over gloo (CUDA tensors) [{card}]", flush=True)
        del det, step
        torch.cuda.empty_cache()
    out["train_launches"] = {c.__name__: c.launches for c in counters}

    work = os.path.join(out_dir, f"work{rank}")
    os.makedirs(work)
    os.chdir(work)
    cfg = workload_config("WIDERFACE_train", "WIDERFACE_LFD_L.py", job["pack"],
                          device_aug=True, epochs=1)
    watch, _ = add_val_loop(cfg, work)
    # the order check (F21): each rank records every train and val batch it
    # hands out, row by row, and the sampler's state the epoch starts from
    steps = dict(train=[], val=[])
    recorded(seed_by_sample(cfg["train_data_loader"]), steps["train"], train_rows)
    recorded(cfg["val_data_loader"], steps["val"], val_rows)
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [_sampler_state_hook(out)]
    zero_counts(counters)
    ex, _ = run_workload(cfg, card, f"rank {rank} of {mesh.size}, device aug, 1 epoch, "
                         "a val pass")
    torch.cuda.synchronize()
    out["executor_launches"] = {c.__name__: c.launches for c in counters}
    out["steps"], out["train_workers"] = steps, cfg["train_data_loader"]._num_workers
    check(ex.mesh is not None and ex.mesh.size == mesh.size
          and cfg["train_data_loader"].batch_size == TRAIN_BATCH // mesh.size
          and cfg["batch_size"] == TRAIN_BATCH, f"rank {rank}: the Executor is not sharded")
    out["val"] = watch.passes[0]["results"]
    out["ckpts"] = sorted(os.path.abspath(os.path.join(cfg["work_dir"], f))
                          for f in os.listdir(cfg["work_dir"]) if f.endswith(".pth"))
    out["weights"] = cpu_state(ex.state.net)
    out["train_iter"] = cfg["train_iter"]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _sampler_state_hook(out):
    from lfdtpu_torch.execution import Hook

    class SamplerState(Hook):
        """The train sampler's random state when the run starts (after the
        Executor shared rank 0's), into out["sampler_state"]."""

        def before_run(self, executor):
            sharded = executor.config_dict["train_data_loader"]._dataset_sampler
            out["sampler_state"] = sharded._sampler._rng.getstate()

    return SamplerState()


def check_loader_order(ranks, cfg, card):
    """F21 on the card's run: every train step's rows, rank 0's then rank
    1's, equal the one-process, one-worker loader's global batch k from the
    same sampler state (sample index and digest of each row); every rank's
    val step k holds val batch k's rows with their own image ids, so the
    rows rank 0 evaluates carry their own images' ids."""
    train = seed_by_sample(one_worker(cfg["train_data_loader"]))
    train._dataset_sampler._rng.setstate(ranks[0]["sampler_state"])
    ref_train = [train_rows(b) for b in train]
    ref_val = [val_rows(b) for b in one_worker(cfg["val_data_loader"])]
    steps = [r["steps"] for r in ranks]
    train_ok = all(len(s["train"]) == len(ref_train) for s in steps) and all(
        sum((s["train"][k] for s in steps), []) == want for k, want in enumerate(ref_train))
    val_ok = all(s["val"] == ref_val for s in steps)
    workers = [r["train_workers"] for r in ranks]
    print(f"loader order (F21): {len(ref_train)} train steps, {workers} train loader workers "
          f"by rank: each step's rows, rank by rank, are the one-process, one-worker loader's "
          f"global batch k (sample index; image bytes, padded boxes and aug params): "
          f"{train_ok}; {len(ref_val)} val steps, each rank's val step k the one-worker val "
          f"loader's batch k with its own image ids: {val_ok} [{card}]")
    if not train_ok:
        for k, want in enumerate(ref_train):
            print(f"  step {k}: one process {[i for i, _ in want]}; ranks "
                  f"{[[i for i, _ in s['train'][k]] for s in steps if k < len(s['train'])]}")
    check(all(w == int(os.environ.get("LFD_NUM_WORKERS", 12)) for w in workers),
          f"the ranks' train loaders run {workers} workers, not the config's default")
    check(train_ok, "a train step's rows on the ranks are not the global batch of that step")
    check(val_ok, "a rank's val rows are not the val batch of that step, or carry other ids")


def same_rows(got, ref, tol=DDP_ROW_TOL):
    """(equal row counts per image, max |err| over rows sorted by score):
    the rows of two val passes, {image_id: rows}."""
    if sorted(got) != sorted(ref) or any(len(got[i]) != len(ref[i]) for i in ref):
        return False, float("inf")
    worst = 0.0
    for i, rows in ref.items():
        if len(rows):
            key = lambda r: (-r[1], r[2], r[3])  # noqa: E731  (score, then the box)
            a = np.asarray(sorted(map(list, got[i]), key=key), np.float64)
            b = np.asarray(sorted(map(list, rows), key=key), np.float64)
            worst = max(worst, float(np.abs(a - b).max()))
    return worst <= tol, worst


def ddp_two_ranks(device, card, counters, tmp):
    """DDP_WORLD fresh processes on the one card (ddp_rank), each on its
    share of the seeded batch: after DDP_CHECKED steps rank 0's global loss,
    params and BN statistics within TRAIN_TOL of the one-process batch-64
    step (fp32 and bf16; remat against fp32), every rank's weights equal;
    then their Executor run: rank 0's checkpoint equal to rank 1's weights,
    rank 0's val rows equal to a one-process val pass of that checkpoint
    (counts exact, values within DDP_ROW_TOL), K1 launched on every rank.
    Returns {rank: K1-K4 launches of its Executor run} and the train steps'
    launches."""
    import torch

    from lfdtpu_torch.execution import Executor

    weights, arrays, batch = ddp_batch(device)
    torch.save(weights, os.path.join(tmp, "weights.pt"))
    np.savez(os.path.join(tmp, "batch.npz"), *arrays)
    sched = train_schedule()
    refs = {}
    for mode in ("fp32", "bf16"):
        det, step = make_trainer(device, TRAIN_HW, weights, mixed_precision=mode == "bf16")
        states, losses = {}, []
        for it in range(max(DDP_CHECKED)):
            losses.append(float(step(*batch, sched(0, it), True)["loss"]))
            if it + 1 in DDP_CHECKED:
                states[it + 1] = cpu_state(det.net)
        refs[mode] = (states, losses)
        del det, step
    del batch
    torch.cuda.empty_cache()
    pack = os.path.join(tmp, "pack.pkl")
    build_pack(pack)
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(dict(port=free_port(), world=DDP_WORLD, pack=pack), f)

    start = time.time()
    procs, logs = [], []
    for r in range(DDP_WORLD):
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r), tmp],
                stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DDP_CHILD_TIMEOUT - (time.time() - start)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:  # a hung rank fails the run; none outlives it
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            log = f.read()
        for line in log.splitlines():
            if line.startswith(("[rank", "workload rank")):
                print(line)
        check(p.returncode == 0, f"rank {r} of {DDP_WORLD} exited {p.returncode} "
              f"(killed after {DDP_CHILD_TIMEOUT} s if negative):\n{log[-4000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]

    failures = []
    for mode in DDP_MODES:
        states, losses = refs["bf16" if "bf16" in mode else "fp32"]
        got = ranks[0]
        errs = []
        for n in DDP_CHECKED:
            (perr, pname), (serr, sname) = state_errs(got["states"][mode][n], states[n], True)
            lerr = abs(got["losses"][mode][n - 1] - losses[n - 1]) / abs(losses[n - 1])
            band = None
            if "bf16" in mode:  # distances from the fp32 step: two ranks', one process's
                fp32_states, fp32_losses = refs["fp32"]
                band = (state_errs(got["states"][mode][n], fp32_states[n])
                        + state_errs(states[n], fp32_states[n])
                        + tuple(abs(x - fp32_losses[n - 1]) / abs(fp32_losses[n - 1])
                                for x in (got["losses"][mode][n - 1], losses[n - 1])))
            errs.append((n, lerr, perr, pname, serr, sname, band))
        last = max(DDP_CHECKED)
        ranks_equal = all(torch.equal(r["states"][mode][last][k], v) for r in ranks[1:]
                          for k, v in got["states"][mode][last].items())
        print(f"train {mode}, {DDP_WORLD} ranks x {TRAIN_BATCH // DDP_WORLD} rows against one "
              f"process x {TRAIN_BATCH} ({'plain' if 'remat' in mode else 'the same mode'}), "
              "max|err|/max|ref|: " + "; ".join(
                  f"after {n} step{'s' if n > 1 else ''}: global loss {le:.2e}, params "
                  f"{pe:.2e} ({pn}), BN statistics {se:.2e} ({sn})"
                  + ("" if band is None else "; against the fp32 step, two ranks / one "
                     f"process: params {band[0]:.2e} / {band[2]:.2e}, BN statistics "
                     f"{band[1]:.2e} / {band[3]:.2e}, global loss {band[4]:.2e} / "
                     f"{band[5]:.2e}")
                  for n, le, pe, pn, se, sn, band in errs)
              + f" (tol {TRAIN_TOL}); every rank's state equal={ranks_equal} [{card}]")
        if not ranks_equal:
            failures.append(f"{mode}: the ranks' states differ")
        if "bf16" in mode:
            far = [b[i] > BF16_BAND * max(b[i + j], TRAIN_TOL)
                   for *_, b in errs for i, j in ((0, 2), (1, 2), (4, 1))]
            if any(far):
                failures.append(f"{mode}: the two-rank step is farther from fp32 than "
                                f"{BF16_BAND} x the one-process step")
        elif max(max(e[1], e[2], e[4]) for e in errs) >= TRAIN_TOL:
            failures.append(f"{mode}: the two-rank step disagrees with the one-process step")

    # the Executor: rank 0 alone checkpoints; its val rows against one process
    ckpts = ranks[0]["ckpts"]
    check([os.path.basename(c) for c in ckpts] == ["epoch_1.pth"]
          and all(not r["ckpts"] for r in ranks[1:]), "rank 0 alone must checkpoint")
    saved = torch.load(ckpts[0], map_location="cpu", weights_only=True)["state_dict"]
    check(all(torch.equal(saved[k], v) for r in ranks[1:] for k, v in r["weights"].items()),
          "rank 0's checkpoint differs from another rank's weights")
    os.chdir(tmp)
    cfg = workload_config("WIDERFACE_train", "WIDERFACE_LFD_L.py", pack, device_aug=True,
                          epochs=1)
    watch, _ = add_val_loop(cfg, tmp)
    check_loader_order(ranks, cfg, card)
    cfg["weight_path"] = ckpts[0]
    single = Executor(cfg)
    zero_counts(counters)
    single.val()
    torch.cuda.synchronize()
    single_k1 = counters[0].launches
    ok, worst = same_rows(ranks[0]["val"], watch.passes[0]["results"])
    n_rows = sum(len(v) for v in watch.passes[0]["results"].values())
    launches = {f"rank {r}": x["executor_launches"] for r, x in enumerate(ranks)}
    print(f"Executor WIDERFACE_LFD_L on {DDP_WORLD} ranks: rank 0's checkpoint equals every "
          f"rank's weights; its val rows ({len(ranks[0]['val'])} images, {n_rows} rows) against "
          f"a one-process val pass of that checkpoint: counts equal={ok or worst < float('inf')}, "
          f"max|err| {worst:.2e} (tol {DDP_ROW_TOL}); K1 launches by rank "
          f"{[x['nms_mask_sorted'] for x in launches.values()]}, one process {single_k1} "
          f"[{card}]")
    check(ok, f"rank 0's val rows differ from a one-process val pass: {worst}")
    check(all(x["nms_mask_sorted"] > 0 for x in launches.values()),
          "a rank's val pass launched no K1")
    check(not failures, "; ".join(failures))
    del single
    torch.cuda.empty_cache()
    return launches, {f"rank {r}": x["train_launches"] for r, x in enumerate(ranks)}


def ddp_phase(device, card, counters):
    """Phase 16: data parallelism. The WIDERFACE-L train step at world size
    1 over NCCL (ddp_world_size_1), then two ranks on the card over gloo
    (ddp_two_ranks). Returns its paths' launches."""
    import torch

    zero_counts(counters)
    ddp_world_size_1(device, card)
    torch.cuda.synchronize()
    world1 = {c.__name__: c.launches for c in counters}
    tmp = tempfile.mkdtemp(prefix="lfd_ddp_")
    cwd, hook, env = os.getcwd(), sys.excepthook, dict(os.environ)
    try:
        executor, train = ddp_two_ranks(device, card, counters, tmp)
    finally:
        os.chdir(cwd)
        sys.excepthook = hook
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"data parallel: train step, world size 1 over NCCL (DDP and plain)":
            dict(eager=world1, replayed=None),
            f"data parallel: train steps, {DDP_WORLD} ranks over gloo": dict(
                **{f"{r} eager": n for r, n in train.items()}, replayed=None),
            f"data parallel: WIDERFACE_LFD_L Executor, {DDP_WORLD} ranks (train, val decode)":
            dict(**{f"{r} eager": n for r, n in executor.items()}, replayed=None)}


# ------------------------------------------------------ spatial (phase 17)

def spatial_world_size_1(device, card):
    """compile_inference(mesh=make_mesh()) in a process group of one rank
    over NCCL against mesh=None, both captured, WIDERFACE-L at HW, bf16 with
    K1-K3 and int8: the same launches per capture and every output
    bit-equal on two frames."""
    import torch
    import torch.distributed as dist

    from lfdtpu_torch.parallel import make_mesh

    det = build_detector(device, seed=SPATIAL_SEED)
    rng = np.random.RandomState(SPATIAL_SEED)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        check(mesh.world_size == 1 and dist.get_backend() == "nccl"
              and mesh.device.type == "cuda", f"the NCCL mesh is {mesh}")
        for variant in ("bf16_kernels", "int8"):
            plain = compile_engine(det, HW, device, variant)
            kw = dict(act_scales=plain.int8_chain.amax) if variant == "int8" else {}
            meshed = compile_engine(det, HW, device, variant, mesh=mesh, **kw)
            same = []
            for _ in range(2):
                imgs = frames(rng, 1, HW)
                a, b = plain(imgs, HW), meshed(imgs, HW)
                same.append(all(torch.equal(a[k], b[k]) for k in a))
            print(f"spatial: {variant} WIDERFACE-L {HW[0]}x{HW[1]} through compile_inference("
                  "mesh=make_mesh()), one rank over NCCL, against mesh=None: captured="
                  f"{meshed.captured}, launches per capture {meshed.captured_launches} "
                  f"(mesh=None {plain.captured_launches}), two frames bit-equal={same} [{card}]")
            check(meshed.captured and meshed.mesh is None and all(same)
                  and meshed.captured_launches == plain.captured_launches,
                  f"the one-rank mesh engine ({variant}) is not the engine of mesh=None")
            del plain, meshed
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def match_rows(got, ref, px, score):
    """Rows of two engines' detections matched in any order: (counts equal,
    one process's rows without a twin in `got` (same label, box within
    `px`, score within `score`): each as its image, row, score, the lowest
    kept score and the nearest box's distance and score; the largest box
    and score errors of the matched rows)."""
    got = {k: v.float().cpu().numpy() for k, v in got.items()}
    ref = {k: v.float().cpu().numpy() for k, v in ref.items()}
    counts = bool(np.array_equal(got["count"], ref["count"]))
    missed, box_err, score_err = [], 0.0, 0.0
    for b, n in enumerate(ref["count"].astype(int).reshape(-1)):
        free = list(range(int(got["count"].reshape(-1)[b])))
        for i in range(n):
            cand = [j for j in free if got["labels"][b, j] == ref["labels"][b, i]
                    and np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max() <= px
                    and abs(got["scores"][b, j] - ref["scores"][b, i]) <= score]
            if not cand:
                near = min(range(int(got["count"].reshape(-1)[b])), default=None,
                           key=lambda j: np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max())
                missed.append(dict(
                    image=b, row=i, score=float(ref["scores"][b, i]),
                    cut=float(ref["scores"][b, n - 1]),
                    nearest_box_px=None if near is None else float(
                        np.abs(got["boxes"][b, near] - ref["boxes"][b, i]).max()),
                    nearest_score=None if near is None else float(got["scores"][b, near])))
                continue
            j = min(cand, key=lambda j: np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max())
            box_err = max(box_err, float(np.abs(got["boxes"][b, j] - ref["boxes"][b, i]).max()))
            score_err = max(score_err, float(abs(got["scores"][b, j] - ref["scores"][b, i])))
            free.remove(j)
    return counts, missed, box_err, score_err


def strip_kernels(engine, imgs, vhw, label):
    """Every kernel the mesh engine launches on one call, held to its plain
    version on the inputs it was given on this rank's strips: K1 and K4
    exact, K2 within K2_TOL and K3 within K3_TOL (max|err| / max|ref|).
    Returns {kernel: (calls, max error)}."""
    import torch

    from lfdtpu_torch.deploy import kernel_net
    from lfdtpu_torch.ops import conv_kernels, nms_kernel

    (((_, k4calls), k3calls), k2calls) = recorded_calls(
        kernel_net, "stem_conv", lambda: recorded_calls(
            kernel_net, "pair_conv3x3", lambda: k4_inputs(lambda: engine(imgs, vhw))))
    _, k1calls = k1_inputs(lambda: engine(imgs, vhw))
    out = {}
    for name, calls, run, plain, tol in (
            ("stem_conv", k2calls, conv_kernels.stem_conv, conv_kernels.stem_conv_plain, K2_TOL),
            ("pair_conv3x3", k3calls, conv_kernels.pair_conv3x3,
             conv_kernels.pair_conv3x3_plain, K3_TOL)):
        errs = [rel_err(run(*a, **kw), plain(*a, **kw)) for a, kw in calls]
        out[name] = (len(calls), max(errs, default=0.0))
        check(out[name][1] < tol, f"{label}: {name} on strips disagrees with its plain version")
    if k4calls:
        out["int8_conv"] = (len(k4calls), check_k4(k4calls, label)[0])
    errs = []
    for boxes, valid, thr in k1calls:
        got = nms_kernel.nms_mask_sorted(boxes, valid, thr)
        errs.append(float((got != nms_kernel.nms_mask_sorted_plain(boxes, valid, thr)).sum()))
    out["nms_mask_sorted"] = (len(k1calls), max(errs, default=0.0))
    check(out["nms_mask_sorted"][1] == 0, f"{label}: K1 disagrees with its plain version")
    torch.cuda.synchronize()
    return out


def spatial_engine(det, variant, mesh, imgs, vhw, counters, label, device):
    """One mesh engine of phase 17 on this rank: built and served
    SPATIAL_FRAMES times (the path: counters zeroed before, read after) and
    its peak memory read, one call's collectives counted by their span
    counter (tracing.py), its kernels held to their plain versions, and the
    one-process eager engine of the same build on the same frames (rows,
    dense outputs, int8 edges, peak memory). Returns the rank's record."""
    import torch

    from lfdtpu_torch import tracing
    from lfdtpu_torch.parallel import local_batch_slice, owned_rows
    from lfdtpu_torch.parallel.spatial import SpatialNet

    batch = len(imgs)
    rec = {}
    zero_counts(counters)
    engine = compile_engine(det, SPATIAL_HW, device, variant, batch_size=batch, mesh=mesh)
    check(not engine.captured and isinstance(engine.spatial, SpatialNet),
          f"{label}: the mesh engine is not an eager spatial engine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = engine(imgs, vhw)  # the plan, cuDNN's algorithms
    for _ in range(SPATIAL_FRAMES - 1):
        engine(imgs, vhw)
    torch.cuda.synchronize()
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    rec["launches"] = {c.__name__: c.launches for c in counters}
    # one call under a profiler session (CPU activity only: the program's
    # spans need no CUPTI): its collectives counted by tracing.py's counter
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine(imgs, vhw)
    rec["collectives"] = tracing.summary()["counters"]["spatial.collectives"]
    rec["kernels"] = strip_kernels(engine, imgs, vhw, label)
    dense = [d.float() for d in engine.dense(imgs)]
    amax, edges = None, None
    if variant.startswith("int8"):
        amax = engine.spatial.module.amax
        capture = dict.fromkeys(engine.spatial.module.int8_edges())
        x, _ = engine._local(imgs, vhw)
        with torch.inference_mode():
            engine.spatial(engine.program.preprocess(x).float(), capture=capture)
        edges = {k: v[0].cpu() for k, v in capture.items()}
    got = {k: v.cpu() for k, v in got.items()}
    del engine
    torch.cuda.empty_cache()

    one = compile_engine(det, SPATIAL_HW, device, variant, batch_size=batch, captured=False,
                         **(dict(act_scales=amax) if amax is not None else {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = one(imgs, vhw)
    torch.cuda.synchronize()
    rec["one_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    rec["dense_err"] = max(rel_err(a, b.float()) for a, b in zip(dense, one.dense(imgs)))
    rec["rows"] = match_rows(got, ref, *SPATIAL_ROW_TOL[variant])
    rec["count"] = ref["count"].tolist()
    if edges is not None:
        b0, b1 = local_batch_slice(batch, mesh.rank, mesh.size)
        capture = dict.fromkeys(edges)
        with torch.inference_mode():
            one.int8_chain(one.program.preprocess(torch.as_tensor(imgs, device=device)).float(),
                           capture=capture)
        equal = 0
        for name, a in edges.items():
            b = capture[name][0][b0:b1]
            lo, hi = owned_rows(b.shape[1], mesh.spatial, mesh.spatial_rank)
            equal += int(torch.equal(a, b[:, lo:hi].cpu()))
        rec["edges"] = (equal, len(edges))
    del one
    torch.cuda.empty_cache()
    return rec


def spatial_eval(name, hw, mesh, batch, counters, label, device):
    """make_eval_step(spatial=True) of `name` at `hw` on this rank's rows of
    a seeded global batch (fp32, TF32 off), against the one-process eval
    forward: peak memory of each (the step's second call), the dense
    outputs' max|err| / max|ref|, the launches (counters zeroed before,
    read after)."""
    import torch

    from lfdtpu_torch.models.detector import eval_forward
    from lfdtpu_torch.parallel import make_eval_step
    from lfdtpu_torch.parallel.data_parallel import TrainState

    det = (build_detector(device, seed=SPATIAL_SEED) if name == "WIDERFACE-L"
           else fcos_r50_fpn(device, seed=SPATIAL_SEED))
    images = np.random.RandomState(SPATIAL_SEED).uniform(
        -1.0, 1.0, (batch,) + tuple(hw) + (3,)).astype(np.float32)
    state = TrainState(det.net, None)
    zero_counts(counters)
    step = make_eval_step(det, mesh, spatial=True)
    step(state, images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = step(state, images)
    torch.cuda.synchronize()
    rec = dict(peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               launches={c.__name__: c.launches for c in counters})
    torch.cuda.reset_peak_memory_stats()
    refs = eval_forward(det.net, images)
    torch.cuda.synchronize()
    rec["one_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    rec["err"] = max(rel_err(a, b) for a, b in zip(outs, refs))
    check(len(outs) == len(refs) and all(a.shape == b.shape for a, b in zip(outs, refs)),
          f"{label}: the spatial eval step's outputs are not one process's shapes")
    del det, step, outs, refs
    torch.cuda.empty_cache()
    return rec


def spatial_rank(rank, out_dir):
    """One rank of phase 17 (`chip_smoke.py --spatial-rank R DIR`), on the
    one card over gloo with CUDA tensors, on the mesh of DIR/job.json: the
    spatial engines of SPATIAL_ENGINES at SPATIAL_HW (spatial_engine), then
    the eval steps of SPATIAL_EVAL. Writes DIR/rank{R}.json."""
    import torch
    import torch.distributed as dist

    from lfdtpu_torch.ops import conv_kernels, group_norm, int8_conv, kernel_lib, nms_kernel
    from lfdtpu_torch.parallel import initialize_distributed, make_mesh

    faulthandler.enable(all_threads=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "job.json")) as f:
        job = json.load(f)
    initialize_distributed("gloo", f"tcp://127.0.0.1:{job['port']}", job["world"], rank)
    mesh = make_mesh(spatial=job["spatial"])
    device = job["device"]
    check(mesh.device.type == torch.device(device).type and dist.get_backend() == "gloo"
          and mesh.world_size == job["world"] and mesh.spatial == job["spatial"],
          f"rank {rank}: mesh {mesh}")
    kernel_lib.library()  # the parent built it
    counters = (nms_kernel.nms_mask_sorted, conv_kernels.stem_conv,
                conv_kernels.pair_conv3x3, int8_conv.int8_conv, group_norm.group_norm_relu)
    card = card_line()
    batch = job["batch"]
    imgs = frames(np.random.RandomState(SPATIAL_SEED), batch, SPATIAL_HW)
    vhw = np.asarray(SPATIAL_VHW[:batch], np.float32)
    det = build_detector(device, seed=SPATIAL_SEED)
    where = f"rank {rank} (data {mesh.rank}, spatial {mesh.spatial_rank})"
    out = dict(coords=(mesh.rank, mesh.spatial_rank), engines={}, eval={})
    for variant in SPATIAL_ENGINES:
        rec = spatial_engine(det, variant, mesh, imgs, vhw, counters, f"{where} {variant}",
                             device)
        out["engines"][variant] = rec
        print(f"[rank {rank}] {variant} WIDERFACE-L {SPATIAL_HW[1]}x{SPATIAL_HW[0]} batch "
              f"{batch}, {where} of {job['label']}: eager, {rec['collectives']} collectives a "
              f"call; peak {rec['peak_mib']:.0f} MiB (one process, whole frames: "
              f"{rec['one_peak_mib']:.0f}); launches {rec['launches']} [{card}]", flush=True)
    for name, hw in SPATIAL_EVAL:
        rec = spatial_eval(name, hw, mesh, batch, counters, f"{where} {name}", device)
        out["eval"][name] = rec
        print(f"[rank {rank}] make_eval_step(spatial=True) {name} {hw[1]}x{hw[0]} batch {batch}, "
              f"{where}: peak {rec['peak_mib']:.0f} MiB (one process {rec['one_peak_mib']:.0f}), "
              f"max|err|/max|ref| against one process {rec['err']:.2e}, launches "
              f"{rec['launches']} [{card}]", flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def spatial_ranks(label, world, spatial, batch, card, tmp, device):
    """`world` fresh processes on the one card (spatial_rank), each must
    exit 0 within SPATIAL_CHILD_TIMEOUT; prints their lines and checks
    their records. Returns {rank: record}."""
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(dict(port=free_port(), world=world, spatial=spatial, batch=batch,
                       label=label, device=device), f)
    start = time.time()
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--spatial-rank", str(r), tmp],
                stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SPATIAL_CHILD_TIMEOUT - (time.time() - start)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:  # a hung rank fails the run; none outlives it
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            log = f.read()
        for line in log.splitlines():
            if line.startswith("[rank"):
                print(line)
        check(p.returncode == 0, f"spatial rank {r} of {world} exited {p.returncode} "
              f"(killed after {SPATIAL_CHILD_TIMEOUT} s if negative):\n{log[-4000:]}")
    ranks = {}
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks[r] = json.load(f)
    failures = []
    for r, rec in ranks.items():
        for variant, e in rec["engines"].items():
            counts, missed, box_err, score_err = e["rows"]
            n = sum(e["count"])
            at_cut = [m for m in missed if m["score"] - m["cut"] <= SPATIAL_CUT_TOL]
            cut_ok = len(at_cut) == len(missed) and (not missed or variant in SPATIAL_CUT_VARIANTS)
            print(f"  rank {r} {variant}: counts {e['count']} equal={counts}, rows without a "
                  f"twin {len(missed)} of {n} ({len(at_cut)} within {SPATIAL_CUT_TOL} of the "
                  f"max_det cut's score), matched rows' max box err "
                  f"{box_err:.3g} px, score {score_err:.3g}; dense max|err|/max|ref| "
                  f"{e['dense_err']:.2e} (tol {SPATIAL_DENSE_TOL[variant]:.3g})"
                  + (f"; int8 edges equal {e['edges'][0]} of {e['edges'][1]}"
                     if "edges" in e else "")
                  + "; on strips against plain (calls, max err): "
                  + ", ".join(f"{k} {v[0]} {v[1]:.2e}" for k, v in e["kernels"].items()))
            for m in missed:
                print(f"    without a twin: {m}")
            if not (counts and cut_ok and e["dense_err"] < SPATIAL_DENSE_TOL[variant]):
                failures.append(f"rank {r} {variant}: the mesh engine disagrees with one process")
            if "edges" in e and e["edges"][0] != e["edges"][1]:
                failures.append(f"rank {r} {variant}: an int8 edge differs from one process's")
            want = ("pair_conv3x3", "stem_conv") if variant == "bf16_kernels" else \
                ("int8_conv",) if variant.startswith("int8") else ()
            if not (e["launches"]["nms_mask_sorted"] > 0
                    and all(e["launches"][k] > 0 and e["kernels"][k][0] > 0 for k in want)):
                failures.append(f"rank {r} {variant}: a kernel of the path launched no time")
        for name, ev in rec["eval"].items():
            if ev["err"] >= DENSE_FP32_TOL:
                failures.append(f"rank {r}: the {name} eval step disagrees with one process")
    check(not failures, f"spatial, {label}: " + "; ".join(failures))
    return ranks


def spatial_phase(device, card, counters):
    """Phase 17: the spatial axis. The one-rank mesh engine over NCCL
    (spatial_world_size_1), then each SPATIAL_SHAPES of gloo ranks on the
    card (spatial_ranks).
    Returns (its paths' launches, {kernel: max error on strips})."""
    import torch

    zero_counts(counters)
    spatial_world_size_1(device, card)
    torch.cuda.synchronize()
    paths = {"spatial: one-rank mesh engines over NCCL (bf16 K1-K3, int8) and mesh=None":
             dict(build_and_capture={c.__name__: c.launches for c in counters},
                  replayed=None)}
    errs, failures = {}, []
    # F20's cause: cuDNN's fp32 engine by shape, beside the spatial module's
    # row-chunked GEMM that the strips' convs run instead
    from lfdtpu_torch.tools import cudnn_workspace

    for h, w, (cm, cms), (gm, gms) in cudnn_workspace.named(device):
        print(f"fp32 3x3/s1 64->64 at 1x64x{h}x{w}: cuDNN +{cm:.1f} MiB, {cms:.4f} ms; "
              f"the spatial module's GEMM +{gm:.1f} MiB, {gms:.4f} ms [{card}]")
    for label, world, spatial, batch in SPATIAL_SHAPES:
        tmp = tempfile.mkdtemp(prefix="lfd_spatial_")
        try:
            ranks = spatial_ranks(label, world, spatial, batch, card, tmp, device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for variant in SPATIAL_ENGINES:
            peaks = [rec["engines"][variant]["peak_mib"] / rec["engines"][variant]["one_peak_mib"]
                     for rec in ranks.values()]
            print(f"spatial {variant}, {label}: peak memory by rank / one process's "
                  + ", ".join(f"{v:.3f}" for v in peaks)
                  + (f" (at most {SPATIAL_PEAK_SHARE})" if spatial == 2 else "") + f" [{card}]")
            if spatial == 2:
                failures += [f"{variant}, {label}: a rank's peak memory is {v:.3f} of one "
                             "process's" for v in peaks if v > SPATIAL_PEAK_SHARE]
            paths[f"spatial: WIDERFACE-L {SPATIAL_HW[1]}x{SPATIAL_HW[0]} {variant} engine, "
                  f"{label} over gloo"] = dict(
                **{f"rank {r} eager": rec["engines"][variant]["launches"]
                   for r, rec in ranks.items()}, replayed=None)
            for rec in ranks.values():
                for k, (_, e) in rec["engines"][variant]["kernels"].items():
                    errs[k] = max(errs.get(k, 0.0), e)
        for name, hw in SPATIAL_EVAL:
            paths[f"spatial: make_eval_step {name} {hw[1]}x{hw[0]}, {label} over gloo"] = dict(
                **{f"rank {r} eager": rec["eval"][name]["launches"] for r, rec in ranks.items()},
                replayed=None)
            evals = [rec["eval"][name] for rec in ranks.values()]
            print(f"spatial eval step {name} {hw[1]}x{hw[0]} fp32, {label}: peak MiB by rank "
                  + ", ".join(f"{e['peak_mib']:.0f}" for e in evals) + ", one process's "
                  + ", ".join(f"{e['one_peak_mib']:.0f}" for e in evals)
                  + " (at most one process's)" + f" [{card}]")
            failures += [f"the {name} eval step, {label}: a rank's peak {e['peak_mib']:.0f} MiB "
                         f"exceeds one process's {e['one_peak_mib']:.0f}"
                         for e in evals if e["peak_mib"] > e["one_peak_mib"]]
    check(not failures, "spatial memory (F20): " + "; ".join(failures))
    return paths, errs


def main(argv=()):
    import torch

    if argv[:1] == ["--serve-file"]:
        return serve_file(*argv[1:3])
    if argv[:1] == ["--ddp-rank"]:
        return ddp_rank(int(argv[1]), argv[2])
    if argv[:1] == ["--spatial-rank"]:
        return spatial_rank(int(argv[1]), argv[2])

    # a crash in native code prints the crashing thread's Python stack (the
    # loaders' idle worker threads would crowd it out of an all-threads dump)
    faulthandler.enable(all_threads=False)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from lfdtpu_torch.ops import (assign, conv_kernels, group_norm, int8_conv, kernel_lib,
                                  nms_kernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    t_start = time.time()

    card = card_line()
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off")

    t0 = time.time()
    lib_path = kernel_lib.build()
    kernel_lib.library()
    print(f"[2 build] {lib_path.relative_to(kernel_lib.BUILD_DIR.parents[1])} "
          f"in {time.time() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print("[5 engine]")
    det = build_detector(device)
    rng = np.random.RandomState(5)
    counters = (nms_kernel.nms_mask_sorted, conv_kernels.stem_conv,
                conv_kernels.pair_conv3x3, int8_conv.int8_conv, group_norm.group_norm_relu)
    # The main path: compile_inference (the wrappers launch their kernels in
    # the warmup calls and while the graph is captured; that is where the
    # host counters tick), then the predict entry points, whose calls replay
    # the graphs: those launches are counted from a profile by kernel name.
    zero_counts(counters)
    engines = compile_engines(det, HW, device)
    print(f"compiled {len(engines)} captured engines {HW[0]}x{HW[1]}; launches per capture "
          f"{ {k: e.captured_launches for k, e in engines.items()} }")
    warm = frames(rng, 1, HW)
    prof, (rows_single, rows_batch) = profiled(
        lambda: engines["bf16_kernels"](warm, HW), lambda: serve(det, engines, HW, rng))
    launches = {c.__name__: c.launches for c in counters}
    replayed, window = kernel_launches_in(prof)
    print(f"served 8 single frames ({sum(map(len, rows_single))} rows) and a batch "
          f"of 4 ({[len(r) for r in rows_batch]} rows); launches at build and capture "
          f"{launches}; launches by the 9 replays (profile, by kernel name) {replayed} "
          f"({window})")
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    for name, n in launches.items():
        check((n > 0) == (want[name] > 0), f"the main path launched {name} {n} times")
    check(replayed == {k: 9 * v for k, v in want.items()},
          "the served replays did not launch each kernel as captured")
    imgs = check_engine_parity(det, engines, HW, rng)
    check_fp32_reference(det, device, rng)
    del engines
    torch.cuda.empty_cache()

    print("[6 train]")
    t0 = time.time()
    # K6's launches on each training path, counted from zero before it
    k6_paths = {}
    check_train_gpu_vs_cpu(device)
    zero_counts(counters + (assign.lfd_assign,))
    trained = train_full_width(device, card)
    torch.cuda.synchronize()
    k6_paths["WIDERFACE-L batch 64, 480x480: the check, 2 x 20 steps, 2 profiled"] = \
        assign.lfd_assign.launches
    check(assign.lfd_assign.launches == 2 * TRAIN_STEPS + 3,
          f"phase 6 launched K6 {assign.lfd_assign.launches} times")
    print("engine kernel launches during training (the step runs none): "
          f"{ {c.__name__: c.launches for c in counters} }")
    check(not any(c.launches for c in counters), "the train step launched an engine kernel")
    train_to_serve(trained, device, counters)
    del trained
    torch.cuda.empty_cache()
    print(f"train phase {time.time() - t0:.1f} s")

    print(f"[7 kernels] {card}")
    timings, errs = time_kernels(device, card)
    x = torch.as_tensor(imgs, device=device)
    vhw = torch.tensor([HW[0] - 8, HW[1]], dtype=torch.float32, device=device)
    for form in ("eager", "captured"):
        profile_engine(compile_engine(det, HW, device, "bf16_kernels", captured=form == "captured"),
                       x, vhw, f"{form} WIDERFACE-L", counters, want)
    print(f"[8 workload] {card}")
    t0 = time.time()
    assign.lfd_assign.launches = 0
    workload_phase(device, card, counters)
    k6_paths["WIDERFACE_LFD_L through the Executor (phase 8's runs)"] = assign.lfd_assign.launches
    check(assign.lfd_assign.launches > 0, "the WIDERFACE training entry point never ran K6")
    print(f"workload phase {time.time() - t0:.1f} s")

    # each further path is driven with the counters zeroed just before it
    # and read just after (an engine path's launches at build and capture,
    # and its replays counted from a profile; FCOS's eager launches, and no
    # replays since it has no engine)
    paths = {"WIDERFACE-L": dict(build_and_capture=launches, replayed=replayed)}
    print(f"[9 traffic serve] {card}")
    t0 = time.time()
    for name in TRAFFIC:
        launches_n, replayed_n = serve_traffic(name, device, card, counters, rng)
        paths[name] = dict(build_and_capture=launches_n, replayed=replayed_n)
    new_rows = time_new_shapes(device, card)
    print(f"traffic serve phase {time.time() - t0:.1f} s")
    print(f"[10 traffic train] {card}")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lfd_traffic_")
    cwd, hook, env = os.getcwd(), sys.excepthook, dict(os.environ)
    assign.lfd_assign.launches = 0
    try:
        os.chdir(tmp)  # the scripts' work dirs go under the temp dir
        train_traffic(device, card, counters, tmp)
        k6_paths["TT100K_LFD_L and TL_LFD_L entry points, TT100K-L steps (phase 10)"] = \
            assign.lfd_assign.launches
        check(assign.lfd_assign.launches > 0, "the traffic training paths never ran K6")
    finally:
        os.chdir(cwd)
        sys.excepthook = hook
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"traffic train phase {time.time() - t0:.1f} s")
    print(f"[11 LFDv2] {card}")
    t0 = time.time()
    launches_v2, replayed_v2 = serve_and_train_lfdv2(device, card, counters, rng)
    paths["LFDv2 (WIDERFACE-L parts)"] = dict(build_and_capture=launches_v2,
                                              replayed=replayed_v2)
    print(f"LFDv2 phase {time.time() - t0:.1f} s")
    print(f"[12 FCOS] {card}")
    t0 = time.time()
    launches_f, fcos_k1 = fcos_phase(device, card, counters)
    paths["FCOS-R50-FPN (no engine: predict and get_results)"] = dict(eager=launches_f,
                                                                      replayed=None)
    print(f"FCOS phase {time.time() - t0:.1f} s")
    print(f"[13 int8] {card}")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lfd_int8_")
    try:
        (launches8, replayed8, k4_err, k4_rows, tl_launches8, tl_replayed8, routes8,
         narrow8) = int8_phase(device, card, counters, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths["WIDERFACE-L int8 (float32 and bf16 heads, predict_engine.py)"] = dict(
        build_and_capture=launches8, replayed=replayed8)
    paths["TL-L int8"] = dict(build_and_capture=tl_launches8, replayed=tl_replayed8)
    for name, (n_launches, n_replayed, _) in narrow8.items():
        paths[f"{name} int8 (float32 and bf16 heads)"] = dict(build_and_capture=n_launches,
                                                              replayed=n_replayed)
    timings["int8_conv"] = {k: v for k, v in k4_rows[0].items()
                            if k not in ("shape", "what")}
    # K4's main-path launches by route (its int8 engines' build and capture)
    timings["int8_conv"]["launches_by_route"] = routes8
    print(f"int8 phase {time.time() - t0:.1f} s")
    print(f"[14 files] {card}")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lfd_files_")
    try:
        built_f, built_replayed_f, loaded_f, loaded_replayed_f = files_phase(
            det, device, card, counters, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths["WIDERFACE-L engine files built and saved (bf16 K1-K3, int8 float32 and bf16 heads)"] = \
        dict(build_and_capture=built_f, replayed=built_replayed_f)
    paths["WIDERFACE-L engine files loaded in fresh processes"] = dict(
        load_and_capture=loaded_f, replayed=loaded_replayed_f)
    print(f"files phase {time.time() - t0:.1f} s")
    print(f"[15 learning] {card}")
    t0 = time.time()
    paths_l, errs_l, rows_l = learning_phase(device, card, counters)
    paths.update(paths_l)
    k4_err = max(k4_err, errs_l["int8_conv"])
    print(f"learning phase {time.time() - t0:.1f} s")
    print(f"[16 data parallel] {card}")
    t0 = time.time()
    paths.update(ddp_phase(device, card, counters))
    print(f"data parallel phase {time.time() - t0:.1f} s")
    print(f"[17 spatial] {card}")
    t0 = time.time()
    paths_s, errs_s = spatial_phase(device, card, counters)
    paths.update(paths_s)
    k4_err = max(k4_err, errs_s.get("int8_conv", 0.0))
    print(f"spatial phase {time.time() - t0:.1f} s")

    sources = {
        "nms_mask_sorted": ("lfdtpu_torch/csrc/nms.cu", "lfdtpu/ops/nms_pallas.py:49",
                            errs["nms_mask_sorted"]),
        "stem_conv": ("lfdtpu_torch/csrc/stem_conv.cu", "lfdtpu/ops/conv_pallas.py:359",
                      errs["stem_conv"]),
        "pair_conv3x3": ("lfdtpu_torch/csrc/pair_conv.cu", "lfdtpu/ops/conv_pallas.py:171",
                         errs["pair_conv3x3"]),
        # not a Pallas kernel: XLA's int8 conv of lfdtpu's fused int8 chain
        # (its stem route: csrc/int8_conv_stem.cu; the entry point and the
        # mma.sync route for other widths: csrc/int8_conv.cu)
        "int8_conv": ("lfdtpu_torch/csrc/int8_conv_wgmma.cuh", "lfdtpu/deploy/int8_net.py:276",
                      k4_err),
        # not a Pallas kernel: XLA's GroupNorm (flax) of lfdtpu's heads
        "group_norm_relu": ("lfdtpu_torch/csrc/group_norm.cu", "lfdtpu/models/layers.py:67",
                            errs["group_norm_relu"]),
    }
    other = {"nms_mask_sorted": [fcos_k1],
             "stem_conv": [r for r in new_rows if "residual" not in r],
             "pair_conv3x3": [r for r in new_rows if "residual" in r],
             "int8_conv": k4_rows[1:],
             "group_norm_relu": timings["group_norm_relu"][1:]}
    timings["group_norm_relu"] = {k: v for k, v in timings["group_norm_relu"][0].items()
                                  if k != "shape"}
    for name, rows in rows_l.items():
        other[name] += rows
    # each kernel's launches on its main path: WIDERFACE-L's bf16 engines for
    # K1-K3 (phase 5), its int8 engines for K4 (phase 13)
    main = {name: (launches8, replayed8) if name == "int8_conv" else (launches, replayed)
            for name in sources}
    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=main[name][0][name], replayed_launches=main[name][1][name],
                    max_abs_err=err, **timings[name],
                    launches_by_path={p: {k: None if n is None else n[name]
                                          for k, n in counts.items()}
                                      for p, counts in paths.items()},
                    other_shapes=[{k: v for k, v in r.items() if k != "library_call"}
                                  for r in other[name]])
               for name, (src, tpu, err) in sources.items()]
    # K6 trains and serves nothing: its launches on the training paths (no
    # graph replays them), its phase 7 time at the train cell's shape
    # (not a Pallas kernel: XLA's fusion of lfdtpu's jnp assignment)
    kernels.append(dict(name="lfd_assign", route="cuda", source="lfdtpu_torch/csrc/assign.cu",
                        replaces="lfdtpu/ops/assign.py:84", launches=next(iter(k6_paths.values())),
                        replayed_launches=None, max_abs_err=errs["lfd_assign"],
                        **timings["lfd_assign"], launches_by_path=k6_paths, other_shapes=[]))
    # K7 serves Deformable DETR, whose engine no other phase builds: its
    # launches and times from phase 7 (not a Pallas kernel: lfdtpu has no
    # deformable attention)
    kernels.append(dict(name="ms_deform_attn", route="cuda", source="lfdtpu_torch/csrc/msda.cu",
                        replaces=None, max_abs_err=errs["ms_deform_attn"],
                        **timings["ms_deform_attn"]))

    print(json.dumps({"k4_narrow_rows": [r for _, _, rows in narrow8.values() for r in rows]}))
    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
