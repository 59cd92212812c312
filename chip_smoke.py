#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sodt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero without
the final ok line:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions
  2. build    nvcc builds the kernels of sodt_tpu_torch/csrc (seconds)
     ptxas    registers, static shared memory and spills of the K8 / K10
              kernels, of the GEMM core's instantiations (K6, K7, K2's
              four GEMMs with their two f32-residual epilogues, K3's two,
              K4's three, K5's two), of the backward's register body (K9
              on the map, K11's backward on token windows), of the
              windowed-attention forward's register body (K1, K5's core,
              K11 forward, K2's and K3's cores: head dims 16-64, four
              addressings) and of K13's row body (its four fronts: LN,
              add + LN, K2's LN2 on f32 rows, K4's un-shift + add + LN)
              (`nvcc -Xptxas -v`, run beside the build), the dynamic
              shared memory their launches take, and which instantiation
              each launch of K6, K7, the chains of K2, K3, K4 and K5, the
              backward's and the forward's register bodies and the LN
              body at each width runs
  3. kernels  each kernel vs its plain PyTorch version on the same bf16
              inputs at the shapes its path gives it (batch 2, and the
              paths' batch 4), max |diff| / max |ref| <= 2e-2 (the f32
              dbias of K9 / K10: <= 1e-3), with the kernel's, the plain
              version's and (K1, K8, K9, K10, K11, K13) the library call's
              time, the library call's also as summed device time per call
              (torch.profiler); K1-K7, K11 (forward and backward) and
              K13 also with the summed device time per call of the
              kernel and of the plain version, their TFLOP/s, and
              bit-equal over two runs; the chains (K2-K5) also with
              each launch's device time and the bytes bound of the
              chain's own traffic beside the function's bound;
              K1 at the 608 px path's shape and at the four shapes of the
              training step's replays; K8 also at the 608 px path's four
              windows; K10 on K8's statistics, as training runs it, and
              (path `own_stats`, outside the kernels line) on its own; K11 forward and backward at the
              four stage shapes of the SwinV2 family, masked and unmasked,
              and K13 at the five shapes that family gives it;
              the backward kernels (K9, K10, K11) also dq, dk and dv
              singly, beside the error that the bf16 store alone would
              leave, and their dbias bit-equal over two runs; K12's five
              int8 bodies against their plain int8 versions on the SAME
              bf16 inputs (the rounding points are part of the function),
              with the bf16 kernel's time at the same shape beside them,
              K2's also at the 608 px stage 1 (19 windows per strip);
              and against the plain int8 version with the kernels' own
              attention core: relative L2 <= 3e-3 and every strip's
              abs-max slot within 1e-2, where the bf16 kernel's output
              and strip maxima over wrong rows (one 64-row tile, the
              unshifted rows, no halo row) must read above those limits
     autograd torch.autograd.grad through K1 -> K9, K8 -> K10 and K11 ->
              K11 backward against autograd of the f32 plain version
  4. main     `python -m sodt_tpu_torch.val --task val --synthetic
              --synthetic-n 4 --img-size 512 --batch-size 4` in-process
              (bf16, seeded weights), launch counts per forward K2 3, K3 3,
              K4 3, K5 4, K6 2, K7 2, K8 1, K13 11 + 5; then raw Detect maps
              of one batch, bf16 kernels vs the f32 plain path on the same
              weights, relative L2 <= 2e-2, and the kernels of one bf16
              forward (torch.profiler): none named gemm_bias_kernel (K5's
              retired WMMA GEMM; every path of this phase checks it)
     608px    the same at 608 px (4 images): stage 2's 76x76 map takes the
              generic block path, K1 4 launches per forward, and stage 3
              pads into four windows for K8
     train    `python -m sodt_tpu_torch.train --synthetic --synthetic-n 16
              --img-size 512 --batch-size 4 --nbs 4 --epochs 2 --notest`
              in-process (8 optimizer steps on the augmented device-bank
              feed, bf16, seeded weights, a hyp file with warmup_iters 4):
              finite losses, the launches of every step (PER_STEP), a
              non-zero gradient on every parameter at the first step,
              parameters that moved
     swinv2   `python -m sodt_tpu_torch.val --cfg model_swinv2.yaml` at
              512 px, batch 4, 4 images, weights from a seed with the
              post-norm scales drawn too (at their zero init every V2 block
              is the identity): K11 12 launches per forward, K13 31; raw
              Detect maps bf16 vs f32 as on the main path
     swinv2_train  `python -m sodt_tpu_torch.train --cfg model_swinv2.yaml`
              on the same weights, 4 optimizer steps at batch 4: K11 12 +
              12 and K13 31 per step, a non-zero gradient on every
              parameter at the first step, parameters that moved
     grads    one training batch, two seeds: gradients (and raw Detect
              maps) of the bf16 kernel path vs the f32 plain path on the
              same weights
     int8     `python -m sodt_tpu_torch.val --int8` on the main path's
              arguments (int8 serving, K12): launches per forward K2-K7's
              int8 bodies 3, 3, 3, 4, 2, 2 (their bf16 kernels 0), K8 1,
              K13 11 + 5; raw Detect maps of one batch, the int8 kernels vs
              the plain int8 bodies on the card and vs the bf16 kernels
              (relative L2 <= 2e-2 each), vs the plain int8 bodies with the
              kernels' attention core (reported); each of the 17 K12 calls
              of that forward
              held on its own arguments as the kernel cases are; then
              `--task speed` with and without --int8
     trained  the trained flagship (checkpoints/flagship_r5_150ep_ema.npz,
              its sha256 held to the sidecar's first): `val --weights` at
              512 px, batch 4, SyntheticVedai(n=16, seed=1) in bf16, on the
              f32 plain path and with --int8, launches per forward as on
              `main` / `int8` (f32: none); mAP@0.5 and mAP beside JAX's f32
              values from the sidecar (bf16 within 1e-2, f32 within 5e-3 of
              JAX's mAP@0.5, int8 at least 0.9x bf16's; int8's gap to bf16
              is its cost in mAP) and bf16's beside JAX's bf16 values (the
              same bounds), raw Detect maps bf16 vs f32
     reference_io  the reference-checkpoint tools on the trained npz:
              `tools.export_torch --no-module` (its round trip exact over
              the sidecar's 244 arrays) then `tools.import_torch` back,
              bit-equal to the npz; `tools.parity_check.run` on that .pt
              (512 px, batch 4, bf16, `trained`'s 16 images, --ref-map50 the
              sidecar's JAX f32 mAP@0.5): pass true, mAP@0.5 and mAP equal to
              `trained`'s bf16 readings, launches PER_FORWARD x 4; the A/B of
              the kernels against JAX's composition (`kernels.no_kernels()`):
              one warm bf16 forward of the trained flagship (batch 4, 512
              px) and one training step (forward, loss, backward) of the
              seeded flagship, each way, CUDA-event ms and device-busy ms,
              no counter moving inside the switch, the forward's raw Detect
              maps within 2e-2 of the kernel path's; `python -m
              sodt_tpu_torch.tools.profile_eval --batch 4 --iters 2` in a
              subprocess started first, beside the export, the parity
              check and the A/B's set-up (its timings, taken on a shared
              card, are not kept), whose categories must name the
              kernels' bodies
     train_aug  `python -m sodt_tpu_torch.train --weights` the .npz, 512 px,
              batch 4, nbs 4: 2 epochs with --save-dir / --save-period 1
              (every array but the anchors loaded), --resume last.pt for one
              more epoch after the restored state is held to the saved one
              bit for bit, 2 steps with the gather warp, mixup and the
              mosaic gate, 3 steps of --multi-scale at 384, 512 and 640 px
              (launches per step and per forward at each size), 1 epoch of
              --image-weights: finite losses and the launches of each run;
              the feed's device time per step (torch.profiler) beside a
              training step's and the idle share of the two; one augmented
              batch on the card against the same tiles and draws on the
              CPU (images <= 1e-2 on the 0-255 scale, labels <= 1e-3 px,
              masks equal), for the hyp file's and the gather / mixup hyps
     folders  VEDAI folders written on the card by the port's own PNG
              encoder: 16 pairs of 1024 px (`SyntheticVedai(seed=0)`, RGB
              `_co`, gray `_ir`, every row filter type, raw 14-column
              annotations), decoded back bit-equal and `prepare`d; `train
              --data --weights` the .npz at 512 px, batch 4: 2 epochs
              streaming (the bank gate at 0), 1 epoch from the device bank,
              1 epoch of --rect, PER_STEP on every step, finite losses, the
              feed's regime and tile source printed; `val --data` square
              (PER_FORWARD) and --rect (544 px, OFF_FORWARD); `trained`'s
              16 images as a 512 px PNG folder (labels written with 9
              digits, read back bit-equal) whose bf16 mAP@0.5 and mAP must
              equal `trained`'s to the digit; the port's C++ tile loader
              (`csrc/tile_loader.cpp`, built by the host compiler beside
              nvcc) is the tile source of the streaming and bank feeds
              (required) and its tiles of the 1024 px folder are bit-equal
              to the python source's; decode ms per pair (native with the
              cache off, on its pool and on one core, and python), the
              bank's setup, the first epoch's feed against a warm one,
              feed + step ms and the idle share of the streaming, bank and
              rect feeds
     jpeg     the port's JPEG decoder (`csrc/jpeg.cpp`, in the host
              library): (a) bit-equal to the numpy decoder (`data/jpeg.py`)
              on every file of tests/torch_port_jpeg/ (made by cv2, which
              the CPU tests hold both decoders to); (b) `trained`'s 16
              images at 512 px written as JPEG by the port's encoder
              (`write_jpeg`, PIL's defaults) and, beside them, as PNG of
              the pixels those JPEGs decode to: `val --data` in bf16 on
              each (PER_FORWARD, counts reset just before and read just
              after each run) reads the same mAP@0.5 and mAP to the last
              digit; (c) the tile loader's 512 px tiles of the JPEG folder
              bit-equal to the python source's; (d) ms to decode a 1024 px
              JPEG pair: the tile loader at 1024 px (decode and copy, no
              resize) on its pool and held to one core, and the numpy
              decoder, beside the card's name and power limit; (e) the
              kinds cv2 reads beyond those: C++ = numpy, as cv2 5.0 reads
              and as OpenCV 4.6 reads (the tiles' libjpeg-turbo 2.1
              smoothing), on the fixtures of cut and scan-stripped
              progressive, arithmetic-coded, CMYK / YCCK, lossless and
              12-bit files and on 6 damaged copies of each (the same
              pixels or the same error); the 16 images as JPEGs of three
              kinds in turn, written from the port's encoder's
              coefficients: progressive (a DC scan, an AC scan a
              component) cut to 60% of their bytes, CMYK (Adobe, the
              RGB as C M Y, K 255), sequential arithmetic-coded (a QM
              encoder, jcarith.c's); and as DNG (TIFF named .dng), each
              folder beside a PNG twin of its decoded pixels: `val`
              reads one mAP on each pair; ms to decode a 1024 px cut
              progressive pair, beside the predictions written before the
              run (JPEG_KINDS_PREDICTED). Each of (a)-(e) prints its own
              line
     bmp_tiff the port's BMP and TIFF decoders (`csrc/bmp.cpp`,
              `csrc/tiff.cpp`, in the host library): (a) bit-equal to the
              numpy decoders (`data/bmp.py`, `data/tiff.py`) on every file
              of tests/torch_port_bmp_tiff/ (which the CPU tests hold to
              cv2 and PIL), and on 4 damaged copies of each from a seed
              (the same pixels, a broken strip filled as libtiff fills
              it, or an error of the same type); (b) `trained`'s 16
              images at 512 px written by the port's `write_bmp` (24-bit
              RGB, 8-bit gray) and
              `write_tiff` (deflate, predictor 2, 64 x 128 tiles) and as
              PNG: the tile loader's 512 px tiles of each folder bit-equal
              to the python source's, and `val --data` in bf16 on each
              (PER_FORWARD) reading the PNG twin's mAP@0.5 and mAP to the
              last digit (both formats are lossless); (c) ms to decode a
              1024 px BMP pair and TIFF pair: the tile loader at 1024 px on
              its pool and held to one core, and the numpy decoders,
              beside the card's name and power limit; (d) aerial TIFF:
              `trained`'s first 8 images with the RGB as YCbCr 4:2:0
              JPEG in 256 px tiles (`write_tiff`, JPEGTables) and the IR
              as float32 under predictor 3 holding ir / 255 as the card
              computes it, beside a PNG twin (the decoded RGB, the 8-bit
              IR): `val` on each reading one mAP to the last digit (the
              float IR reaches the model unscaled, as in JAX, so both
              give it the same inputs), the tiles bit-equal to the
              python source's as OpenCV 4.6 converts its items, C++ =
              numpy on the files; (e) ms to decode a 1024 px such pair
              (pool, one core, numpy) beside the predictions written
              before the run (BT_AERIAL_PREDICTED). Each of (a)-(e)
              prints its own line
     webp     the port's WebP decoder (`csrc/webp.cpp`, in the host
              library): (a) bit-equal to the numpy decoder (`data/webp.py`)
              on every file of tests/torch_port_webp/ (which the CPU tests
              hold to cv2), the animated one raising NotImplementedError in
              both, and on 4 damaged copies of each from a seed (the same
              pixels or an error of the same type); (b) `trained`'s 16
              images at 512 px written lossless by the tests' minimal VP8L
              writer (`tests/torch_port_common.write_webp_lossless`), and
              the 4 checked-in quality-90 pairs of the same source
              (tests/torch_port_webp/vedai_q90/), each beside a PNG twin
              (the source's pixels; the numpy decode's pixels, held equal
              to the C++ decode): the tile loader's 512 px tiles of each
              WebP folder bit-equal to the python source's, and `val
              --data` in bf16 (PER_FORWARD) reading its twin's mAP@0.5 and
              mAP to the last digit; (c) ms to decode a 1024 px pair,
              lossless and lossy: the tile loader on its pool and held to
              one core, the C++ decode on the calling thread, and the numpy
              decoder on smaller files (a 128 px lossless pair, the 512 px
              lossy pair of (b)), beside the card's name and power limit.
              Each of (a)-(c) prints its own line
     eval_extras  the eval protocol's extras and the serving path on the
              trained weights (predictions printed first): `val --augment`
              in bf16 and f32 on `trained`'s 16 images (mAP@0.5 and mAP
              within 2e-2 / 5e-3 of JAX's f32 TTA from the sidecar;
              TTA_STEP launches a step: two PER_FORWARD passes at 512 and
              448 px and an OFF_FORWARD one at 352 px), the TTA step's ms
              beside the plain step's; `val --weights trained,perturbed`
              (an NMS ensemble of the trained weights and a copy with its
              biases and BatchNorm statistics moved: ENSEMBLE_STEP, bf16
              mAP within `trained`'s bounds of the same ensemble on the
              f32 plain path, and on one batch survivors equal to one NMS
              over both members' own candidates and unlike the first
              member's alone); `val --save-hybrid` (mAP@0.5 >= 0.99); `val --data` on `folders`' 1024 px folder with
              --save-json --save-txt --save-conf, square and --rect (mAP
              equal to `folders`' to the digit, one json record a txt
              line, every box inside its frame, per_class.csv / .xlsx);
              `val --task study` at 384, 640 and 1024 px (PER_FORWARD at
              each); the Predictor on the 16 images (bit-equal to its own
              eval step after scale_coords; its bf16 detections held to
              the same Predictor on the f32 plain model within SERVE_*;
              ms per image); `python -m
              sodt_tpu_torch.detect` over the 1024 px pairs with --save-txt
              (one label file a pair, per-image counts equal to the
              Predictor's on the same decoded pairs)
     eval_runner  the whole-pass eval (`train.evaluate.EvalRunner`) on
              the trained flagship at 512 px, batch 4, bf16, over
              SyntheticVedai(n=32, seed=1) (8 batches; predictions printed
              first): (a) the pass's detections bit-equal to the per-batch
              path's and its metrics equal, the ms a batch of each; (b) the
              issue loop under torch.cuda.set_sync_debug_mode("error"), the
              one fetch outside it, plain and TTA; (c) one runner over the
              trained weights, then the same weights with biases, BN
              statistics and rel-pos tables moved: the second call equal
              (metrics, and detections bit for bit) to a runnerless eval of
              those weights; (d) stack_cache: the second call leaves a
              poisoned iterator untouched; (e) int8 serving through the
              runner equal to its per-batch path; (f) `train` at 128 px,
              2 epochs, --save-period 1, deterministic algorithms: its
              asynchronously written epoch0.pt bit-equal to last.pt of a
              1-epoch run, the epoch's blocking checkpoint wall beside the
              synchronous save's and the snapshot's device memory; (g) the
              pass's launches, PER_FORWARD x 8 (`launches_runner` in the
              kernels line); the phase's seconds
     mono     `val --cfg model_mono.yaml --input_mode RGB` on the main
              path's arguments (the flagship's Swin stages behind one RGB
              patch embed, full width and depth): MONO_FORWARD launches (K13
              LN 7: no cross-channel block), raw maps bf16 vs f32 as on
              `main`
     mono_train  `train --cfg model_mono.yaml --input_mode RGB`, 4 steps
              at batch 4: MONO_STEP on every step (K13 LN 19)
     mono_int8  `val --int8 --cfg model_mono.yaml --input_mode RGB` on the
              main path's arguments: MONO_INT8_FORWARD launches (the K12
              twins 3, 3, 3, 4, 2, 2, bf16 K2-K7 0, K8 1, K13 LN 7 + 5); raw
              maps held to the plain int8 bodies on the card and to the
              mono bf16 path (relative L2 <= 2e-2 each), every K12 call on
              its own arguments, `--task speed` of the mono model with and
              without --int8
     families `val` on yolo5m (RGB, three Detect levels), SRyolo_PF
              (RGB+IR) and SRyolo_MF (RGB+IR+MF) at 512 px: every counter 0;
              raw maps of calibrated weights, bf16 vs f32 on the card and
              f32 on the card vs the CPU
     layers   `val --cfg every_layer.yaml --input_mode RGB` at 512 px (the
              twelve registry layers that no shipped config uses, an
              Upsample of each resize method, two Detect levels): every
              counter 0; raw maps of calibrated weights, bf16 vs f32 on the
              card (<= 0.1) and f32 on the card vs the CPU (<= 1e-4)
     sr_train `train --cfg SRyolo_MF.yaml --input_mode RGB+IR+MF --super
              --factor 2 --down-factor 2` on 1024 px originals (the model
              at 512 px, the SR output 1024 px, 4 channels), 4 steps: every
              counter 0, finite losses, sr > 0; the first step's loss
              parts and SR output, bf16 vs f32 on one batch
     autoanchor  `train --synthetic --synthetic-n 8 --img-size 128`, 2
              steps of the flagship: the anchors of its Detect, decode and
              loss equal to check_anchors' refit of the same labels on the
              host, and its `autoanchor: ... -> anchors refit` line (phase
              `train` and every training path print theirs: BPR 1.0000 at
              512 px, the yaml's anchors kept)
     scan_epoch  `train --scan-epoch on` against `off` (the flagship at
              256 px, 8 images, batch 2, two epochs with an eval after
              each: two chunks against 8 steps; deterministic algorithms):
              parameters, BN statistics and EMA bit-equal, the epoch losses
              the all-step means (recomputed from a reading hook), the host
              syncs per chunk outside evals and checkpoints (wrapped
              torch.cuda.synchronize, Tensor.item / float / int / bool /
              cpu / tolist) and between steps, each run's seconds
     remat    one forward + backward of the flagship at 512 px, batch 4,
              with and without --remat from the same weights: gradients of
              every leaf (bit-equal, else the largest difference and its
              leaf), peak memory of each (remat's below), launches
              (remat's: one more forward of the blocks, REMAT_FORWARD),
              warm ms of each
     sam      three updates of `train.sam.make_sam_optimizer` on the mono
              model at 256 px, batch 2, each held to the hand composition
              (the gradient at p - rho g / |g| through the same kernels,
              then the base update); SAM's own launches
     evolve   `train --evolve 2` at 128 px, 8 images, one epoch a
              generation: evolve.txt two rows of 28 numbers,
              hyp_evolved.yaml and hyp_gen{0,1}.yaml, the first
              generation's hyperparameters equal to `mutate` on the host
     run_logs a short run's events.jsonl keys (JAX's TAGS that it logs and
              wall/*); `val --plots` and `detect --save-img` write their
              plots or, without matplotlib, say so on one line;
              `model_info` of the flagship (parameters equal to
              named_parameters'), `time_fn` of its bf16 forward
     ddp      data parallelism (`parallel.mesh`), the flagship at 512 px,
              global batch 4: world size 1 over nccl (RANK / WORLD_SIZE /
              LOCAL_RANK set, this process), 3 bf16 steps under
              deterministic algorithms, parameters, BN statistics and EMA
              bit-equal to the plain step's; world size 2 over gloo (two
              processes of this script, `--ddp-worker`, on the one card, 2
              images each), one step against world size 1's in f32 (loss,
              gradients, BN running statistics within DDP_F32_TOL) and in
              bf16 (DDP_BF16_TOL: its gradients against f32's within the
              bf16 bound on batch statistics; beside them bf16's spread at
              world size 1, against f32 and against the batch in another
              order), every rank's bf16 launches PER_STEP; more than one
              card is not measured
     bench    `sodt_tpu_torch.bench.run(["--int8"])` in this process, at
              its defaults (the flagship at 512 px, bf16, eval batch 128 x
              8 batches, training batch 32 with remat, the int8 pass):
              each path's peak memory on a line, then the bench's JSON
              line; every numeric field finite and above 0, both MFUs in
              (0, 1.05], and the launches of the run (`launches_bench` in
              the kernels line) non-zero for every kernel but K11; then
              each kernel of the bench's paths (`main`, `train`, `int8`)
              once at batch 128 against its plain version (the kernel
              check above), the check of the grid limits and 32-bit
              offsets at the bench's shapes
     Each path's seconds follow it on a line of their own.
  5. profile  torch.profiler over one warm eval step at the main path's
              shape: device-busy and idle share, the top 40 kernels by
              device time and the top 25 categories
              (`utils.profiler.breakdown`, as tools/profile_eval prints);
              the forward's time by CUDA events (host gaps included), its
              summed kernel time, the host's time to issue it and the
              host's largest ops
     profile_train  the same over one warm training step
     profile_swinv2, profile_swinv2_train  the same two for the SwinV2
              model
     profile_int8  one warm eval step in int8 serving
     profiler the run's torch.profiler sessions, those that recorded no
              device kernel (each run again, up to 5 sessions in all) and
              the device times that then fell back to CUDA events (a
              kernel row names its own in `cuda_event_fallbacks`)
  6. the {"kernels": [...]} line (each entry also with its launches on
     the `remat` and `sam` runs, on rank 0's step of `ddp` at world size 2,
     on one whole pass of `eval_runner` and on the `bench` run), the card
     line, the ok line.

Needs a CUDA card; exits 1 without one and 2 when the port is missing.
Refuses to run (exit 1, before any phase) with SODT_NO_KERNELS set: every
path would take the composition and launch nothing of what it checks.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, published peak
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, published
INT8_OPS_PER_S = 1979e12       # dense s8 tensor-core peak, published
KERNEL_TOL = 2e-2              # max |kernel - plain| / max |plain|, bf16
# the f32 dbias of K9 / K10 sums dS over the batch and up to 1024 windows;
# every term is formed in f32 from exact bf16 inputs, so only the order of
# the sums and expf separate it from the f32 plain version (measured:
# see PERF.md)
DBIAS_TOL = 1e-3
DETECT_REL_L2 = 2e-2           # ||raw_bf16 - raw_f32|| / ||raw_f32||
# K12 against its plain int8 version with the same attention core
# (`dispatch=True`: K1, which the int8 kernels run as their core) on the
# same bf16 inputs, where only the int8 arithmetic separates them: a wrong
# strip scale moves every code of the strip, ~1e-2 of the output (the bf16
# kernel, un-quantized, must read above Q8_REL_L2). The same scales leave
# K5's, K6's and K7's bodies bit-equal; K2 reads up to 1.5e-3 (an f32 LN1
# that differs in the last ulp can move its attention output's strip
# maximum by a bf16 step, and with it that strip's codes). The strip
# abs-max slots (`quant.strip_amax_log`) are held one by one (K2: up to
# 2.9e-3); strip maxima over a wrong set of rows (one 64-row GEMM tile, the
# unshifted rows of a shifted block, a conv tail's strip without its halo
# row) must read above Q8_AMAX_TOL. Measured: PERF.md, PR 4.
Q8_REL_L2 = 3e-3               # ||kernel - plain|| / ||plain||
Q8_AMAX_TOL = 1e-2             # max over strips |slot - plain| / plain
# gradients of the bf16 kernel path against the f32 plain path, one batch,
# same weights: relative L2 over all gradients together, and the worst
# leaf among those that carry at least 1e-3 of the largest leaf's norm
# (a leaf whose true gradient is ~0, such as a key bias, is all rounding
# noise). Two settings:
#  * BatchNorm on its running statistics: bf16 rounds every activation and
#    cotangent of ~60 layers to 2^-8 relative and the errors add like a
#    random walk, a few 1e-2 (measured 1.35e-2 and 3.33e-2 on the two
#    seeds, worst leaf 0.16): the bound that holds the backward kernels.
#  * BatchNorm on batch statistics, the real training step: its backward
#    subtracts the mean of the cotangent and its projection on x-hat, and
#    at a seeded initialization the objectness gradient is nearly constant
#    over the map, so the difference cancels most of the signal and keeps
#    the bf16 rounding; the forward alone (raw Detect maps, the same
#    kernels) is 3.1e-2 from f32 in this mode against 4e-3 to 5e-3 on
#    running statistics. Measured 0.225 and 0.200 on the two seeds; the
#    bound is 1.5 times the larger.
GRAD_REL_L2 = 5e-2
GRAD_WORST_LEAF = 0.2
GRAD_REL_L2_BATCH_STATS = 0.34
GRAD_SEEDS = (0, 1)            # weights and training batch
MAIN_ARGS = ["--task", "val", "--synthetic", "--synthetic-n", "4",
             "--img-size", "512", "--batch-size", "4"]
MAIN_BATCH = 4
# launches per forward on the main path (512 px): stage 1 K2 x3 + (K3, K4)
# x3; stage 2 K5 x4, K6 x2, K7 x2; stage 3 K8. K13: LN of the four
# cross-channel maps, stage 2's four LN1, stage 3's LN1, two PatchMergings;
# add+LN2 of stage 2's four blocks and stage 3's
PER_FORWARD = {"window_attention": 0, "swin_block": 3,
               "block_attention_ln": 3, "conv_mlp_tail": 3,
               "block_attention": 4, "mlp_tail": 2, "conv_mlp_tail_noln": 2,
               "global_attention": 1, "window_attention_bwd": 0,
               "global_attention_bwd": 0, "window_attention_tokens": 0,
               "window_attention_tokens_bwd": 0, "layernorm": 11,
               "add_layernorm": 5, "swin_block_q8": 0,
               "block_attention_ln_q8": 0, "conv_mlp_tail_q8": 0,
               "block_attention_q8": 0, "mlp_tail_q8": 0,
               "conv_mlp_tail_noln_q8": 0}
# int8 serving (`val --int8`, JAX's int8 gate) on the main path's
# arguments: each bf16 K2-K7 launch becomes its int8 twin's (K12)
INT8_ARGS = ["--int8"] + MAIN_ARGS
INT8_FORWARD = dict(PER_FORWARD, swin_block=0, block_attention_ln=0,
                    conv_mlp_tail=0, block_attention=0, mlp_tail=0,
                    conv_mlp_tail_noln=0, swin_block_q8=3,
                    block_attention_ln_q8=3, conv_mlp_tail_q8=3,
                    block_attention_q8=4, mlp_tail_q8=2,
                    conv_mlp_tail_noln_q8=2)
# launches per training step (forward + backward). The backward of K2, K3
# and K5 replays a composition whose core is K1 (10 windowed blocks: K1 10,
# K9 10); K8's backward is K10, with no replay. K13 in the replays: K2's
# LN1 and LN2 (3 x 2), K3's LN1 (3), K4's LN2 (3): 11 + 12 = 23.
PER_STEP = dict(PER_FORWARD, window_attention=10, window_attention_bwd=10,
                global_attention_bwd=1, layernorm=23)
TRAIN_ARGS = ["--synthetic", "--synthetic-n", "16", "--img-size", "512",
              "--batch-size", "4", "--nbs", "4", "--epochs", "2", "--notest"]
TRAIN_STEPS = 8
# the trained flagship (runs/flagship_r5_150ep, EMA weights), committed as
# an .npz with a sidecar that holds its sha256 and JAX's own f32 mAP on
# SyntheticVedai(n=16, seed=1) at 512 px, batch 4 (tools/export_flagship_npz.py)
TRAINED_NPZ = "checkpoints/flagship_r5_150ep_ema.npz"
TRAINED_ARGS = ["--task", "val", "--synthetic", "--synthetic-n", "16",
                "--img-size", "512", "--batch-size", "4", "--weights",
                TRAINED_NPZ]
TRAINED_FORWARDS = 4
# mAP@0.5 on the card against JAX's f32 value: the bf16 kernels within
# 1e-2, the f32 plain path within 5e-3; int8 serving at least 0.9x bf16's.
# mAP@0.5 saturates near 0.99 on these 16 images, so mAP@0.5:0.95 is held
# too: bf16 and int8 within 2e-2 of JAX's f32 value, f32 within 5e-3
TRAINED_BF16_TOL = 1e-2
TRAINED_F32_TOL = 5e-3
TRAINED_INT8_FRACTION = 0.9
TRAINED_MAP_TOL = {"bf16": 2e-2, "f32": 5e-3, "int8": 2e-2}
# reference_io: the A/B of the kernels against JAX's composition holds the
# composition's raw Detect maps to the kernel path's (max |diff| / max
# |ref|); profile_eval's categories must name the bodies that K1-K8 and K13
# run in an eval forward
REF_IO_MAP_TOL = 2e-2
PROFILE_EVAL_BODIES = ("sodt::window_attn_fwd_kernel",
                       "sodt::gemm_core_kernel", "sodt::layernorm_kernel",
                       "sodt::global_attn_fwd_kernel")
PROFILE_EVAL_TIMEOUT = 300
# the augmented training feed from the trained weights (train_aug): the
# flagship at full width and depth, 512 px, batch 4, nbs 4
AUG_ARGS = ["--synthetic", "--img-size", "512", "--batch-size", "4",
            "--nbs", "4", "--weights", TRAINED_NPZ]
# the hyps that turn on the gather warp, mixup and the mosaic gate
AUG_GATHER_HYP = dict(degrees=10.0, shear=2.0, perspective=0.0005,
                      mixup=0.5, mosaic=0.5)
# the card's augmented batch against the CPU's on the same tiles and draws:
# images on the 0-255 scale, labels in px
AUG_IMG_TOL = 1e-2
AUG_LABEL_TOL = 1e-3
AUG_TOP = 12          # the feed's largest kernels printed by device time
# the off-window path (608 px): stage 2's 76x76 map is no multiple of the
# window, so its four blocks take the generic composition with the K1 core;
# stage 3's 38x38 map pads to four 32x32 windows for K8
OFF_ARGS = ["--task", "val", "--synthetic", "--synthetic-n", "4",
            "--img-size", "608", "--batch-size", "4"]
OFF_FORWARD = dict(PER_FORWARD, window_attention=4, block_attention=0,
                   mlp_tail=0, conv_mlp_tail_noln=0)
# the SwinV2 family at 512 px: every one of its 12 blocks (depths 2/2/6/2)
# runs K11 on its pre-partitioned windows, forward and - in a training step
# - backward. K13: the four LNs of the cross-channel block, the two
# post-norms of each block, the three PatchMergings; its backward is plain
# PyTorch, so a step launches no more of it than a forward
V2_CFG = "model_swinv2.yaml"
V2_ARGS = ["--cfg", V2_CFG, "--task", "val", "--synthetic", "--synthetic-n",
           "4", "--img-size", "512", "--batch-size", "4"]
V2_FORWARD = dict({k: 0 for k in PER_FORWARD}, window_attention_tokens=12,
                  layernorm=31)
V2_STEP = dict(V2_FORWARD, window_attention_tokens_bwd=12)
V2_TRAIN_ARGS = ["--cfg", V2_CFG, "--synthetic", "--synthetic-n", "16",
                 "--img-size", "512", "--batch-size", "4", "--nbs", "4",
                 "--epochs", "1", "--notest"]
V2_TRAIN_STEPS = 4
# K11's shapes at 512 px: (windows per image, C, heads, blocks of each kind
# - unshifted, and shifted with a mask - in a forward); N = 64, head dim 32
V2_STAGES = ((256, 96, 3, 1), (64, 192, 6, 1), (16, 384, 12, 3),
             (4, 768, 24, 1))
# the mono family (model_mono.yaml, RGB): the flagship's Swin stages behind
# one RGB patch embed, at the flagship's width and depth. Its forward
# launches what the flagship's does less K13's four LNs of the
# cross-channel block, which it has not: LN 11 - 4 = 7, and 7 + 12 in a
# step (the replays' LNs are the flagship's)
MONO_CFG = "model_mono.yaml"
MONO_ARGS = ["--cfg", MONO_CFG, "--input_mode", "RGB"] + MAIN_ARGS
MONO_FORWARD = dict(PER_FORWARD, layernorm=7)
MONO_STEP = dict(PER_STEP, layernorm=19)
MONO_TRAIN_ARGS = ["--cfg", MONO_CFG, "--input_mode", "RGB", "--synthetic",
                   "--synthetic-n", "16", "--img-size", "512",
                   "--batch-size", "4", "--nbs", "4", "--epochs", "1",
                   "--notest"]
MONO_TRAIN_STEPS = 4
# int8 serving of the mono model on the main path's arguments: MONO_FORWARD
# with each bf16 K2-K7 launch moved to its K12 twin (INT8_FORWARD less the
# cross-channel block's LNs). Its raw maps are held to the plain int8
# bodies and to the bf16 path as on `int8` (the flagship's int8 read
# 7.25e-3 from its bf16 on an H100, PERF.md; the mono model's 5.5e-3 on a
# CPU at 128 px)
MONO_INT8_ARGS = ["--int8"] + MONO_ARGS
MONO_INT8_FORWARD = dict(INT8_FORWARD, layernorm=MONO_FORWARD["layernorm"])
# the all-CNN families at their configs' widths, 512 px, batch 4: PyTorch
# convolutions, no kernel of the port (every counter must read 0); raw
# Detect maps of the bf16 model against the f32 plain one on the same
# weights, whose biases are moved from the seeded init (FAMILY_SEED) and
# whose BatchNorm statistics are calibrated on the compared batch, so that
# the maps are not the bias prior (`calibrated`)
FAMILIES = (("yolo5m.yaml", "RGB", 3), ("SRyolo_PF.yaml", "RGB+IR", 1),
            ("SRyolo_MF.yaml", "RGB+IR+MF", 1))
NO_LAUNCH = {k: 0 for k in PER_FORWARD}
FAMILY_SEED = 7
# Two comparisons of the raw maps (all levels), relative L2. The f32 model
# on the card against the same model on the CPU (the function the CPU
# tests hold to JAX): only the convolutions' summation order separates
# them. bf16 against f32 on the card: a seeded CNN whose BatchNorms
# normalize (calibrated) amplifies rounding from layer to layer (on a
# CPU, yolo5m at 256 px: 1.0e-2 after its first layer, 0.13
# after SPP, 0.74 at its last C3), so the bound is loose: it catches a
# wrong path (uncorrelated maps read ~1.4), not a rounding point. Measured
# on an H100 (PERF.md): bf16 vs f32 yolo5m 0.0907 (0.076 / 0.124
# / 0.174 by level), SRyolo_PF 0.0422, SRyolo_MF 0.0421; f32 card vs CPU
# 1.6e-5 at most. The bounds are about twice and sixty times those
FAMILY_F32_REL_L2 = 1e-3
FAMILY_REL_L2 = 0.2
# the SR regime: SRyolo_MF under RGB+IR+MF with --super --factor 2
# --down-factor 2 on 1024 px originals (the model sees 512 px, the SR
# output is 1024 px with 4 channels), 4 steps at batch 4. On one batch and
# one set of weights the first step's loss parts and the SR output (the
# training-mode forward: batch statistics) of the bf16 model are held to
# the f32 plain model's: relative difference of each part, relative L2 of
# the output
SR_CFG = "SRyolo_MF.yaml"
SR_MODE = "RGB+IR+MF"
SR_RAW = 1024
SR_TRAIN_ARGS = ["--cfg", SR_CFG, "--input_mode", SR_MODE, "--super",
                 "--factor", "2", "--down-factor", "2", "--synthetic",
                 "--synthetic-n", "16", "--img-size", str(SR_RAW),
                 "--batch-size", "4", "--nbs", "4", "--epochs", "1",
                 "--notest"]
SR_TRAIN_STEPS = 4
# The loss parts in bf16 move with the logits' rounding: the objectness
# loss at a seeded init is the BCE of logits near the prior's -6.7, where
# bf16's step is 3.1e-2, i.e. ~3 % of the loss's exp(logit) (measured on
# a CPU at 128 px: obj 4.6e-2, cls 2.1e-2, sr 1.2e-2, box
# 2.5e-3, the total 2.6e-3). The SR output leaves the training-mode
# backbone (bf16 vs f32 raw maps at a seeded init: 2.6e-2-3.1e-2 on
# SRyolo_PF / MF at 256 px on the CPU) through 38 more convs: 9.3e-2 on
# the CPU at 128 px. Measured on an H100 (PERF.md): obj 3.9e-2,
# box 1.0e-2, cls 7.4e-3, sr 5.7e-3; the SR output 6.8e-2
SR_PART_REL = 0.1
SR_OUT_REL_L2 = 0.15
# every layer of JAX's registry that no shipped config uses and an Upsample
# of each resize method (`every_layer.yaml`, RGB, strides 4 and 8) at the
# main path's arguments: PyTorch operations only, every counter 0; raw maps
# of calibrated weights as in `families`. f32 on the card against the CPU:
# the summation order alone; bf16 against f32: on a CPU 3.5e-2 at 512 px
# (2.7e-2 / 5.4e-2 by level), the bound about three times that
LAYERS_CFG = "every_layer.yaml"
LAYERS_MODE = "RGB"
LAYERS_F32_REL_L2 = 1e-4
LAYERS_REL_L2 = 0.1
# autoanchor on the card: the flagship trained 2 steps at 128 px on 8
# synthetic images, whose labels put the yaml's anchors under the 0.98
# recall gate: the model's Detect, its decode and the loss must take the
# anchors that check_anchors refits on the host from the same labels
AA_N, AA_PX = 8, 128
AA_ARGS = ["--synthetic", "--synthetic-n", str(AA_N), "--img-size",
           str(AA_PX), "--batch-size", "4", "--nbs", "4", "--epochs", "1",
           "--notest"]
AA_STEPS = 2
# the epoch path against the per-step path (`scan_epoch`): the flagship at
# 256 px, 8 synthetic images, batch 2, two epochs with an eval after each,
# so that the epoch path runs two chunks of 4 steps where the per-step path
# runs 8 steps; seeded weights, deterministic algorithms for every run, the
# paths run in the order SCAN_ORDER (the first run of a process is cold)
SCAN_ARGS = ["--synthetic", "--synthetic-n", "8", "--img-size", "256",
             "--batch-size", "2", "--nbs", "2", "--epochs", "2",
             "--eval-every", "1", "--noautoanchor", "--nosave"]
SCAN_ORDER = ("on", "off", "off", "on")
SCAN_STEPS, SCAN_CHUNKS = 8, 2
# remat: one forward + backward of the flagship at 512 px, batch 4, with
# and without it, from the same weights and batch. Remat runs the Swin
# blocks' forward again in the backward: the kernels of PER_FORWARD that
# live in the blocks once more (K2-K8, add + LN2 5; of K13's LN the 5
# inside blocks, stage 2's four LN1 and stage 3's, not the cross-channel
# block's four or the two PatchMergings')
REMAT_FORWARD = dict(PER_FORWARD, layernorm=5)
# SAM (`train.sam.make_sam_optimizer`, rho 0.05) on the mono model at
# 256 px, batch 2: three updates, each held to the hand composition of the
# gradient at p - rho g / |g| through the same kernels and the base update
SAM_PX, SAM_BATCH, SAM_UPDATES, SAM_RHO = 256, 2, 3, 0.05
SAM_TOL = 1e-6         # max |SAM - hand| / max |hand| over an update
# data parallelism at world size 2 (two processes on one card, 2 images
# each) against world size 1 (4 images), one step of the flagship in f32
# and in bf16: |loss - loss1| / |loss1|, relative L2 of all the gradients
# together, relative L2 of the BN running statistics. f32 is held to
# DDP_F32_TOL; bf16 (its gradients re-round with the batch's partition:
# PERF.md §6) to DDP_BF16_TOL, its gradients against f32's at
# world size 1 to the bf16 bound on batch statistics, as bf16's own are
DDP_STEPS = 3
DDP_F32_TOL = {"loss": 1e-4, "grads": 1e-3, "bn": 1e-4}
DDP_BF16_TOL = {"loss": 1e-2, "grads_vs_f32": GRAD_REL_L2_BATCH_STATS,
                "bn": 1e-2}
DDP_TIMEOUT = 300      # seconds for each rank's process
# hyperparameter evolution, two generations of one epoch each
EVOLVE_ARGS = ["--synthetic", "--synthetic-n", "8", "--img-size", "128",
               "--batch-size", "4", "--nbs", "4", "--epochs", "1",
               "--noautoanchor", "--evolve", "2", "--seed", "3"]
# the run's record: one short run, its events.jsonl keys (JAX's trainer
# logs the TAGS it has inputs for, and wall/* every epoch)
LOG_ARGS = ["--synthetic", "--synthetic-n", "4", "--img-size", "128",
            "--batch-size", "4", "--nbs", "4", "--epochs", "1",
            "--noautoanchor"]
LOG_KEYS = {"train/box_loss", "train/obj_loss", "train/cls_loss",
            "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
            "metrics/mAP_0.5:0.95", "x/lr0", "x/lr1", "x/lr2", "wall/sched",
            "wall/dispatch", "wall/fetch", "wall/chunk", "wall/eval",
            "wall/ckpt", "wall/ckpt_fetch", "wall/ckpt_write", "wall/epoch"}
# counter name -> (tag, source, TPU kernel it replaces, paths whose runs
# count its launches: one entry of the kernels line for each, with the
# times of that path's shapes)
TPU_KERNEL = {
    "window_attention": ("K1", "sodt_tpu_torch/csrc/block_attention.cu",
                         "sodt_tpu/pallas/window_attention.py:378",
                         ("608px", "train")),
    "swin_block": ("K2", "sodt_tpu_torch/csrc/swin_block_chain.cu",
                   "sodt_tpu/pallas/swin_block.py:93",
                ("main",)),
    "block_attention_ln": ("K3", "sodt_tpu_torch/csrc/shifted_block_chain.cu",
                           "sodt_tpu/pallas/window_attention.py:690",
                ("main",)),
    "conv_mlp_tail": ("K4", "sodt_tpu_torch/csrc/shifted_block_chain.cu",
                      "sodt_tpu/pallas/swin_block.py:329",
                ("main",)),
    "block_attention": ("K5", "sodt_tpu_torch/csrc/block_attention.cu",
                        "sodt_tpu/pallas/window_attention.py:491",
                ("main",)),
    "mlp_tail": ("K6", "sodt_tpu_torch/csrc/gemm_core.cu",
                 "sodt_tpu/pallas/swin_block.py:544",
                ("main",)),
    "conv_mlp_tail_noln": ("K7", "sodt_tpu_torch/csrc/gemm_core.cu",
                           "sodt_tpu/pallas/swin_block.py:622",
                ("main",)),
    "global_attention": ("K8", "sodt_tpu_torch/csrc/global_attention.cu",
                         "sodt_tpu/pallas/window_attention.py:941",
                         ("main", "608px")),
    "window_attention_bwd": ("K9",
                             "sodt_tpu_torch/csrc/window_attention_bwd.cu",
                             "sodt_tpu/pallas/window_attention.py:761",
                             ("train",)),
    "global_attention_bwd": ("K10",
                             "sodt_tpu_torch/csrc/global_attention_bwd.cu",
                             "sodt_tpu/pallas/window_attention.py:1023",
                             ("train",)),
    "window_attention_tokens": (
        "K11", "sodt_tpu_torch/csrc/window_attention_tokens.cu",
        "sodt_tpu/pallas/window_attention.py:61", ("swinv2",)),
    "window_attention_tokens_bwd": (
        "K11", "sodt_tpu_torch/csrc/window_attention_tokens.cu",
        "sodt_tpu/pallas/window_attention.py:206", ("swinv2_train",)),
    "layernorm": ("K13", "sodt_tpu_torch/csrc/layernorm.cu",
                  "sodt_tpu/pallas/layernorm.py:67",
                  ("train", "swinv2", "swinv2_train")),
    "add_layernorm": ("K13", "sodt_tpu_torch/csrc/layernorm.cu",
                      "sodt_tpu/pallas/layernorm.py:72", ("train",)),
    # K12: the int8 branches of the bodies of K2-K7, chains on the s8 wgmma
    # core
    "swin_block_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                      "sodt_tpu/pallas/swin_block.py:158", ("int8",)),
    "block_attention_ln_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                              "sodt_tpu/pallas/window_attention.py:522",
                              ("int8",)),
    "conv_mlp_tail_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                         "sodt_tpu/pallas/swin_block.py:356", ("int8",)),
    "block_attention_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                           "sodt_tpu/pallas/window_attention.py:558",
                           ("int8",)),
    "mlp_tail_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                    "sodt_tpu/pallas/swin_block.py:549", ("int8",)),
    "conv_mlp_tail_noln_q8": ("K12", "sodt_tpu_torch/csrc/int8_chains.cu",
                              "sodt_tpu/pallas/swin_block.py:630",
                              ("int8",)),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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
    end.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler sessions of the run: how many, the labels of those that
# recorded no device kernel at all (CUPTI now and then hands a session none:
# 4 of 165 sessions in one run on an NVIDIA H100 80GB HBM3, 700.00 W, and
# in the next 3 in a row of one call), and the device times that fell back
# to CUDA events after PROFILE_TRIES such sessions in a row
PROFILE_TRIES = 5
PROFILER = {"sessions": 0, "empty_sessions": [], "event_fallbacks": []}


def profiled(run, label: str, cuda_only: bool = False) -> list[dict]:
    """The device kernels (`_device_rows`) of one torch.profiler session
    around `run()` (`cuda_only`: the CUDA activity alone, which records
    far fewer events for a training step). A session that recorded none
    is run again after a pause that grows, up to PROFILE_TRIES sessions
    in all; [] if none of them recorded any."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]
    for i in range(PROFILE_TRIES):
        time.sleep(0.1 * i)
        PROFILER["sessions"] += 1
        with profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        rows = _device_rows(prof)
        if rows:
            return rows
        PROFILER["empty_sessions"].append(label)
    return []


def device_split(fn, label: str, iters: int = 5,
                 cuda_only: bool = False) -> tuple[float, dict]:
    """Summed device time of the kernels of one call of `fn`, from
    torch.profiler over `iters` warm calls: the time on the card without
    the host's share of the call; and its split by kernel name (ms a
    call). Where no session recorded a kernel, the CUDA events' time per
    call (host gaps included), listed under `label` in PROFILER, and no
    split."""
    import torch
    fn()
    torch.cuda.synchronize()
    rows = profiled(lambda: [fn() for _ in range(iters)], label, cuda_only)
    if not rows:
        PROFILER["event_fallbacks"].append(label)
        return time_ms(fn, iters=iters), {}
    return (sum(r["device_ms"] for r in rows) / iters,
            {r["kernel"]: r["device_ms"] / iters for r in rows})


def device_ms(fn, label: str, iters: int = 5,
              cuda_only: bool = False) -> float:
    return device_split(fn, label, iters, cuda_only)[0]


def host_ms(fn, iters: int = 10) -> float:
    """Host time to issue one call of `fn`: the clock stops before the
    card is waited for, so a call the host holds back reads about its
    CUDA-event time, and one the card holds back reads less."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def host_ops(fn, top: int = 10) -> list[dict]:
    """The host's self time of one call of `fn` by op, the `top` largest,
    from one CPU-only torch.profiler session (which adds its own cost to
    every op it records)."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
             "count": e.count} for e in rows[:top]]


def bound_ms(nbytes: float, flops: float,
             int8_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' (bf16 FLOPs at
    the bf16 peak plus s8 operations at the int8 peak)."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = flops / BF16_FLOPS_PER_S + int8_ops / INT8_OPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------- ptxas

# the sources of the redesigned kernels (K8, K10; K6 and K7 on the GEMM
# core; the backward's register body, window_attn_bwd_regs_kernel<head dim,
# N padded, addressing>, of K9 and K11's backward; the forward's register
# body, window_attn_fwd_kernel<head dim, N padded, addressing>, of K1, K5's
# core, K11's forward and K2's core; K2's chain and the LayerNorm body it
# runs on f32 rows): registers, static shared memory and spills as
# `nvcc -Xptxas -v` reports them
PTXAS_SOURCES = ("global_attention.cu", "global_attention_bwd.cu",
                 "gemm_core.cu", "window_attention_bwd.cu",
                 "block_attention.cu", "window_attention_tokens.cu",
                 "swin_block_chain.cu", "shifted_block_chain.cu",
                 "layernorm.cu", "int8_chains.cu")
# the forward's register body as the paths launch it at N 64 (head dim,
# addressing of csrc/window_attention_fwd.cuh)
FWD_LAUNCHES = {"K1 stage 1 (train)": (16, "FwdMap"),
                "K1 stage 2 (train, 608 px)": (32, "FwdMap"),
                "K5 core, unshifted": (32, "FwdMap"),
                "K5 core, shifted": (32, "FwdShiftedMap"),
                "K11 forward (SwinV2)": (32, "FwdTokens"),
                "K2 core, unshifted (main)": (16, "FwdMap"),
                "K2 core, shifted (no path)": (16, "FwdRolledMap"),
                "K3 core, shifted (main)": (16, "FwdShiftedMap")}
# the backward's register body as the paths launch it at N 64 (head dim,
# addressing of csrc/window_attention.cuh)
BWD_LAUNCHES = {"K9 stage 1 (train)": (16, "WrMap"),
                "K9 stage 2 (train)": (32, "WrMap"),
                "K11 backward (SwinV2 train)": (32, "WrTokens")}


def kernel_entry(mangled: str) -> str:
    """sodt's kernel name with its template arguments from a mangled
    name: _ZN4sodt<len><name>_kernelI Li<a>E ... NS_<len><class>E ... ->
    name<a,...,class>."""
    k = re.search(r"4sodt\d+(\w+?_kernel)(I\w*)?", mangled)
    if not k:
        return mangled
    args, rest = [], k.group(2) or ""
    while (rest[:1] in ("I", "f") or rest[:1].isdigit()
           or rest[:2] in ("Li", "Lb", "NS")):
        if rest[0] == "I":
            rest = rest[1:]
        elif rest[0].isdigit():     # a type by its source name
            m = re.match(r"(\d+)", rest)
            end = m.end() + int(m.group(1))
            args.append(rest[m.end():end])
            rest = rest[end:]
        elif rest[0] == "f":
            args.append("float")
            rest = rest[1:]
        elif rest.startswith("Li"):
            m = re.match(r"Li(\d+)E", rest)
            args.append(m.group(1))
            rest = rest[m.end():]
        elif rest.startswith("Lb"):
            args.append("true" if rest[2] == "1" else "false")
            rest = rest[4:]
        else:
            m = re.match(r"NS_(\d+)", rest)
            end = m.end() + int(m.group(1))
            args.append(rest[m.end():end])
            rest = rest[end + 1:]
    return k.group(1) + ("<" + ",".join(args) + ">" if args else "")
# csrc/gemm_core.cuh: the GEMM core's template arguments (loader, epilogue,
# tile width BN, stages) for an output width N, as `launch_gemm_core` picks
# them, and the launches of K6 and K7 at the flagship's stage 2 (C 384,
# hidden 1536): (loader, epilogue, N)

def gemm_core_entry(loader: int, epi: int, n: int) -> str:
    return (f"gemm_core_kernel<{loader},{epi},128,3>" if n > 512
            else f"gemm_core_kernel<{loader},{epi},96,4>")


GEMM_CORE_LAUNCHES = {"K6 fc1": (0, 0, 1536), "K6 fc2": (0, 2, 384),
                      "K7 fc1": (0, 1, 384), "K7 conv": (1, 0, 384),
                      "K7 fc2": (0, 2, 384),
                      # K2's chain at the flagship's stage 1 (C 192,
                      # hidden 768): 3 / 4 the f32-residual epilogues
                      "K2 qkv": (0, 1, 576), "K2 proj + res1 (f32 out)":
                      (0, 3, 192), "K2 fc1": (0, 0, 768),
                      "K2 fc2 + res1 (f32 in)": (0, 4, 192),
                      # K3's and K4's chains at the same shapes
                      "K3 qkv": (0, 1, 576), "K3 proj": (0, 1, 192),
                      "K4 fc1": (0, 1, 192), "K4 conv": (1, 0, 192),
                      "K4 fc2 + res1 (f32 in)": (0, 4, 192),
                      # K5's chain at the flagship's stage 2 (C 384)
                      "K5 qkv": (0, 1, 1152), "K5 proj": (0, 1, 384)}
# csrc/layernorm.cu: K13's row body, layernorm_kernel<front, V, L> (front 0
# bf16 rows, 1 f32 rows, 2 add, 3 un-shift add; V vectors a lane, L lanes a
# row: `layernorm.ln_body`) at each width the paths run it: (front, C)
LN_LAUNCHES = {**{f"K13 LN C {c}": (0, c) for c in (24, 48, 96, 192, 384,
                                                     768)},
               "K13 add + LN C 384": (2, 384), "K13 add + LN C 768": (2, 768),
               "K2 LN2 (f32 rows)": (1, 192),
               "K4 un-shift + add + LN": (3, 192)}


def ln_entry(front: int, c: int) -> str:
    from sodt_tpu_torch.kernels.layernorm import ln_body
    lanes, vecs = ln_body(c)
    return f"layernorm_kernel<{front},{vecs},{lanes}>"


def start_ptxas(out_dir: Path) -> list:
    """One `nvcc -Xptxas -v` per source, started beside the build."""
    from sodt_tpu_torch.kernels import _build
    procs = []
    for name in PTXAS_SOURCES:
        cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, "-Xptxas",
               "-v", "-I", str(_build.CSRC), "-c", str(_build.CSRC / name),
               "-o", str(out_dir / (name + ".o"))]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def ptxas_report(procs) -> dict:
    """{kernel<template args>: registers, static smem, spill bytes} from
    ptxas's lines; with the dynamic shared memory each launch asks for at
    the main path's shape (head dim 64, N 1024, no mask; the layouts of
    csrc/global_attention.cuh and csrc/global_attention_bwd.cu)."""
    kernels, entry = {}, None
    for name, proc in procs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {name}:\n{out}")
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = kernel_entry(m.group(1))
                kernels[entry] = {}
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                kernels[entry]["spill_stores"] = int(m.group(1))
                kernels[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[entry]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                kernels[entry]["static_smem"] = int(sm.group(1)) if sm else 0
    n, ld = 1024, 64 + 8
    dynamic = {
        "global_attn_fwd_kernel": 2 * (2 * 64 * ld * 2 + 64 * 72 * 4),
        "global_attn_bwd_dq_kernel": (2 * (2 * 64 * ld * 2 + 32 * 72 * 4)
                                      + 2 * 32 * ld * 2 + 32 * (n + 8) * 4),
        "global_attn_bwd_dkv_kernel": (2 * 64 * ld * 2 + 2 * (
            2 * 64 * ld * 2 + 64 * 68 * 4 + 2 * 64 * 4))}
    for entry, row in kernels.items():
        if entry.startswith("gemm_core_kernel<"):
            bn, stages = map(int, entry[17:-1].split(",")[2:4])
            row["dynamic_smem"] = stages * (128 + bn) * 128 + 1024
    launched = {k: gemm_core_entry(*v) for k, v in GEMM_CORE_LAUNCHES.items()}
    # K9 on the training step: head dims 16 and 32 at N 64 (two stages of
    # Q, K, V, dO rows of hd + 8, + the 64 x 72 f32 mask rows when masked;
    # the bf16 P and dS tiles and the output staging rows,
    # csrc/window_attention_bwd.cuh WrLayout); K11's backward the same
    # layout at head dim 32
    bwd = {k: f"window_attn_bwd_regs_kernel<{hd},64,{a}>"
           for k, (hd, a) in BWD_LAUNCHES.items()}
    k9 = [e for k, e in bwd.items() if k.startswith("K9")]
    k11 = [e for k, e in bwd.items() if k.startswith("K11")]
    k9_smem = {f"{e} mask {m}": 2 * (4 * 64 * (hd + 8) * 2 + m * 64 * 72 * 4)
               + 2 * 64 * 72 * 2 + 64 * (hd + 8) * 2
               for e, hd in zip(k9, (16, 32)) for m in (0, 1)}
    # the forward's register body: two stages of Q, K, V rows of hd + 8
    # (+ the 64 x 72 f32 mask rows when masked), csrc/window_attention_fwd.cuh
    # WfLayout
    fwd = {k: f"window_attn_fwd_kernel<{hd},64,{a}>"
           for k, (hd, a) in FWD_LAUNCHES.items()}
    fwd_smem = {f"head dim {hd} mask {m}": 2 * (3 * 64 * (hd + 8) * 2
                                                + m * 64 * 72 * 4)
                for hd in (16, 32) for m in (0, 1)}
    spills = lambda es: sum(kernels.get(e, {}).get("spill_stores", -1)
                            + kernels.get(e, {}).get("spill_loads", -1)
                            for e in set(es))
    k2 = {k: v for k, v in launched.items() if k.startswith("K2")}
    k2.update({k: v for k, v in fwd.items() if k.startswith("K2")})
    ln = {k: ln_entry(*v) for k, v in LN_LAUNCHES.items()}
    k2.update({"K2 LN1 (K13's body)": ln_entry(0, 192),
               "K2 LN2 (f32 rows)": ln["K2 LN2 (f32 rows)"]})
    k34 = {k: v for k, v in launched.items() if k[:2] in ("K3", "K4")}
    k34.update({k: v for k, v in fwd.items() if k.startswith("K3")})
    k34.update({"K3 LN (K13's body)": ln_entry(0, 192),
                "K4 un-shift + add + LN": ln["K4 un-shift + add + LN"]})
    k5 = {k: v for k, v in launched.items() if k.startswith("K5")}
    k5.update({k: v for k, v in fwd.items() if k.startswith("K5")})
    return {"phase": "ptxas", "kernels": kernels,
            "k2_chain_launches": k2, "k2_chain_spill_bytes": spills(
                e for k, e in k2.items() if "LN" not in k),
            "k3_k4_chain_launches": k34, "k3_k4_chain_spill_bytes": spills(
                k34.values()),
            "k5_chain_launches": k5, "k5_chain_spill_bytes": spills(
                k5.values()),
            "ln_launches": ln, "ln_spill_bytes": spills(ln.values()),
            "bwd_launches": bwd, "k11_bwd_spill_bytes": spills(k11),
            "fwd_launches": fwd, "fwd_dynamic_smem": fwd_smem,
            "fwd_spill_bytes": sum(
                kernels.get(e, {}).get("spill_stores", -1)
                + kernels.get(e, {}).get("spill_loads", -1)
                for e in set(fwd.values())),
            "k9_dynamic_smem": k9_smem,
            "k9_spill_bytes": sum(kernels.get(e, {}).get("spill_stores", -1)
                                  + kernels.get(e, {}).get("spill_loads", -1)
                                  for e in k9),
            "dynamic_smem_bytes_hd64_n1024": dynamic,
            "gemm_core_launches": launched,
            "gemm_core_spill_bytes": sum(
                kernels.get(e, {}).get("spill_stores", -1)
                + kernels.get(e, {}).get("spill_loads", -1)
                for e in set(launched.values())),
            # K12's chains (csrc/int8_chains.cu): the s8 core and the row
            # passes, every instantiation
            "k12_chain_spill_bytes": sum(
                r.get("spill_stores", -1) + r.get("spill_loads", -1)
                for e, r in kernels.items()
                if e.startswith(("gemm_s8_kernel<", "q8_rowpass_kernel<")))}


# ------------------------------------------------------------------ kernels

def _cast(args, dt):
    """The same inputs, bf16 tensors upcast to dt (f32 for the reference)."""
    import torch
    return tuple(a.to(dt) if isinstance(a, torch.Tensor)
                 and a.dtype == torch.bfloat16 else a for a in args)


def kernel_cases(batch: int, sink=None) -> list[dict]:
    """Every kernel call shape of one flagship forward at 512 px, K1's at
    608 px, the training step's (K1's replays, K9, K10, K13) and the SwinV2
    family's (K11 forward and backward, K13): the kernel
    and its plain version on the same arguments, the bytes and operations
    the function needs, its calls per forward (per step) of its path (the
    `path` whose run counts its launches), and (K1, K8, K9, K10, K13) one
    library call computing the same function. A kernel with
    two outputs (K9, K10: dqkv and the f32 dbias; add+LN) has one tolerance
    for each. `sink(case)`, where given, takes each case as it is made (the
    list comes back empty), so that no case's tensors outlive it. The
    inputs are drawn on the card (at batch 128 the host's draws would take
    minutes)."""
    import torch
    import torch.nn.functional as F
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.kernels import swin_block as sb
    from sodt_tpu_torch.kernels import layernorm as kln
    from sodt_tpu_torch.models.swin import shift_attn_mask

    bf = torch.bfloat16
    g = torch.Generator("cuda").manual_seed(0)

    def rnd(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    def ln(c):
        return (1 + rnd((c,), 0.1, torch.float32), rnd((c,), 0.1, torch.float32))

    def msk(hw, ws, shift):
        return (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).to("cuda")
                if shift else None)

    cases = []

    def case(name, shape, kern, plain, args, nb, fl, calls, lib=None,
             tols=(KERNEL_TOL,), path="main", int8_ops=0, bf16=None,
             q8=None, device=False, chain_bytes=None):
        """`int8_ops`: s8 operations of the function (K12, whose plain
        version then runs on the same bf16 inputs); `bf16`: the bf16
        kernel at the same shape, timed beside it; `q8`: what
        `q8_readings` needs; `device`: also the kernel's and the plain
        version's summed device time per call from torch.profiler (no host
        time), the kernel's split by launch, and its bit-equality over two
        runs; `chain_bytes`: the bytes a chain of launches moves, each
        launch reading its inputs and writing its outputs once (K2-K4)."""
        (sink or cases.append)(dict(
            name=name, shape=shape, kern=kern, plain=plain, args=args,
            nbytes=nb, flops=fl, calls=calls, lib=lib, tols=tols, path=path,
            int8_ops=int8_ops, bf16=bf16, q8=q8, device=device,
            chain_bytes=chain_bytes))

    def sdpa_bwd(q, k, v, am, scale):
        """The backward of SDPA with the same additive bias (no dbias: the
        mask asks for no gradient), on a graph built once, at the first
        call."""
        graph = []

        def run():
            if not graph:
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                out = F.scaled_dot_product_attention(*qkv, attn_mask=am,
                                                     scale=scale)
                graph.append((out, qkv, torch.ones_like(out)))
            out, qkv, gy = graph[0]
            return torch.autograd.grad(out, qkv, gy, retain_graph=True)
        return run

    nh, ws, n = 12, 8, 64
    # stage 1 (c 192): K2 for blocks 0/2/4, K3 + K4 (shift 2) for 1/3/5
    hw, c = 128, 192
    m = batch * hw * hw
    x = rnd((batch, hw, hw, c))
    att = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    lin = (rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.1),
           rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.1))
    conv = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
            rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
            rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    ln1, ln2 = ln(c), ln(c)
    scale = (c // nh) ** -0.5
    # the chains' own traffic, in (M, C) bf16 maps (f32 res1 counts two):
    # K2 29 (x twice, ln1 2, qkv 3 + 3, attn 2, res1 2 + 2 + 2, ln2 2,
    # hidden 4 + 4, out), K3 12 (x, ln 2, qkv 3 + 3, attn 2, out), K4 13 (x,
    # a, res1 2 + 2, t 2, f1 2, z 2, out); plus the weights once
    mc2 = m * c * 2
    case("swin_block", f"({batch},{hw},{hw},{c}) shift 0",
         sb.fused_swin_block, sb.swin_block_plain,
         (x, *ln1, *att, *ln2, *lin, bias, None, ws, nh, scale, 0),
         nbytes(x, *ln1, *att, *ln2, *lin, bias) + nbytes(x),
         m * (24 * c * c + 4 * n * c), 3, device=True,
         chain_bytes=29 * mc2 + nbytes(*ln1, *att, *ln2, *lin, bias))
    mask = msk(hw, ws, 2)
    case("block_attention_ln", f"({batch},{hw},{hw},{c}) shift 2",
         wa.fused_block_attention_ln, wa.block_attention_ln_plain,
         (x, *ln1, *att, bias, mask, ws, nh, scale, 2),
         nbytes(x, *ln1, *att, bias, mask) + nbytes(x),
         m * (8 * c * c + 4 * n * c), 3, device=True,
         chain_bytes=12 * mc2 + nbytes(*ln1, *att, bias, mask))
    a = rnd((batch, hw, hw, c))
    case("conv_mlp_tail", f"({batch},{hw},{hw},{c}) shift 2",
         sb.fused_conv_mlp_tail, sb.conv_mlp_tail_plain,
         (x, a, *ln2, *conv, 2), nbytes(x, a, *ln2, *conv) + nbytes(x),
         12 * m * c * c, 3, device=True,
         chain_bytes=13 * mc2 + nbytes(*ln2, *conv))

    # stage 2 (c 384): the LN-outside split, K5 + K6 / K7
    hw, c = 64, 384
    m = batch * hw * hw
    x = rnd((batch, hw, hw, c))
    wts = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    # K5's chain moves 10 (M, C) bf16 maps (x, qkv 3 + 3, attn 1 + 1, out)
    # and the weights, bias and mask once
    for shift in (0, 2):
        mask = msk(hw, ws, shift)
        case("block_attention", f"({batch},{hw},{hw},{c}) shift {shift}",
             wa.fused_block_attention, wa.block_attention_plain,
             (x, *wts, bias, mask, ws, nh, (c // nh) ** -0.5, shift),
             nbytes(x, *wts, bias, mask) + nbytes(x),
             m * (8 * c * c + 4 * n * c), 2, device=True,
             chain_bytes=10 * m * c * 2 + nbytes(*wts, bias, mask))
    r, y = rnd((batch, hw, hw, c)), rnd((batch, hw, hw, c))
    hid = 4 * c
    w6 = (rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
          rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
    case("mlp_tail", f"({batch},{hw},{hw},{c}) hidden {hid}",
         sb.fused_mlp_tail, sb.mlp_tail_plain, (r, y, *w6),
         nbytes(r, y, *w6) + nbytes(r), 4 * m * c * hid, 2, device=True)
    w7 = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
          rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
          rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    case("conv_mlp_tail_noln", f"({batch},{hw},{hw},{c})",
         sb.fused_conv_mlp_tail_noln, sb.conv_mlp_tail_noln_plain,
         (r, y, *w7), nbytes(r, y, *w7) + nbytes(r), 12 * m * c * c, 2,
         device=True)

    # K1 on the 608 px path: stage 2's 76x76 map padded to 80x80, blocks
    # 0/2 unshifted, 1/3 shifted (masked)
    hw = 80
    qkv = rnd((batch, hw, hw, 3 * c))
    scale = (c // nh) ** -0.5
    nw = (hw // ws) ** 2
    heads = (qkv.reshape(batch, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
             .permute(5, 0, 1, 3, 6, 2, 4, 7)
             .reshape(3, batch * nw, nh, n, c // nh))
    q1, k1, v1 = (t.contiguous() for t in heads)
    for shift in (0, 2):
        mask = msk(hw, ws, shift)
        full = bias[None].repeat(nw, 1, 1, 1)
        if mask is not None:
            full = full + mask[:, None]
        am = full.to(bf).repeat(batch, 1, 1, 1)
        case("window_attention", f"({batch},{hw},{hw},{3 * c}) shift {shift}",
             wa.fused_window_attention_nhwc, wa.reference_attention_nhwc,
             (qkv, bias, mask, ws, nh, scale),
             nbytes(qkv, bias, mask) + nbytes(qkv) // 3,
             4 * batch * hw * hw * n * c, 2,
             lambda am=am, scale=scale: F.scaled_dot_product_attention(
                 q1, k1, v1, attn_mask=am, scale=scale), path="608px",
             device=True)

    # K1 and K9 in a training step at 512 px: the core that the backward of
    # a windowed block replays, and its backward, stage 1 (c 192, head dim
    # 16: K2's three unshifted and K3's three shifted blocks) and stage 2
    # (c 384, head dim 32: K5's two and two); the replay rolls the map and
    # calls the core with shift 0 and the mask. K9's bytes: qkv, gy read,
    # dqkv written (7 * C * 2 per token), bias (+ mask) read, dbias
    # written; operations: five N x N x hd products per window and head
    # (10 * N * C per token).
    n = ws * ws
    bias = rnd((nh, n, n), 1.0, torch.float32)
    for hw, c, calls in ((128, 192, 3), (64, 384, 2)):
        qkv, gy = rnd((batch, hw, hw, 3 * c)), rnd((batch, hw, hw, c))
        scale = (c // nh) ** -0.5
        nw = (hw // ws) ** 2
        heads = (qkv.reshape(batch, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
                 .permute(5, 0, 1, 3, 6, 2, 4, 7)
                 .reshape(3, batch * nw, nh, n, c // nh))
        q9, k9, v9 = (t.contiguous() for t in heads)
        for shift in (0, 2):
            mask = msk(hw, ws, shift)
            full = bias[None].repeat(nw, 1, 1, 1)
            if mask is not None:
                full = full + mask[:, None]
            am = full.to(bf).repeat(batch, 1, 1, 1)
            case("window_attention",
                 f"({batch},{hw},{hw},{3 * c}) shift {shift}",
                 wa.fused_window_attention_nhwc, wa.reference_attention_nhwc,
                 (qkv, bias, mask, ws, nh, scale),
                 nbytes(qkv, bias, mask) + nbytes(qkv) // 3,
                 4 * batch * hw * hw * n * c, calls,
                 lambda q=q9, k=k9, v=v9, am=am, scale=scale:
                 F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                scale=scale), path="train",
                 device=True)
            case("window_attention_bwd",
                 f"({batch},{hw},{hw},{3 * c}) shift {shift}",
                 wa.window_attention_bwd, wa.attention_nhwc_bwd_plain,
                 (qkv, bias, mask, ws, nh, scale, gy),
                 2 * nbytes(qkv) + nbytes(gy) + 2 * nbytes(bias) + nbytes(mask),
                 10 * batch * hw * hw * n * c, calls,
                 sdpa_bwd(q9, k9, v9, am, scale), (KERNEL_TOL, DBIAS_TOL),
                 path="train")

    # K11 forward and backward at the SwinV2 family's four stages (512 px):
    # the unshifted blocks without a mask, the shifted ones with the mask
    # of their stage (window w takes mask[w mod nw]); scale 1.0 (the
    # cosine attention folds its logit scale into q). Bytes and operations
    # as for K1 / K9. SDPA gets the bias (+ mask) as its attn_mask.
    for nw, c2, nh2, calls in V2_STAGES:
        w2, n2 = batch * nw, 64
        qkv, gy = rnd((w2, n2, 3 * c2)), rnd((w2, n2, c2))
        bias2 = rnd((nh2, n2, n2), 1.0, torch.float32)
        heads = qkv.reshape(w2, n2, 3, nh2, c2 // nh2).permute(2, 0, 3, 1, 4)
        q11, k11, v11 = (t.contiguous() for t in heads)
        side = int(nw ** 0.5) * 8
        for shift in (0, 4):
            mask = msk(side, 8, shift)
            full = bias2[None].repeat(nw, 1, 1, 1)
            if mask is not None:
                full = full + mask[:, None]
            am = full.to(bf).repeat(batch, 1, 1, 1)
            tag = f"({w2},{n2},{3 * c2}) nh {nh2}" + (f" mask nw {nw}"
                                                      if shift else "")
            mnw = nw if shift else 1
            case("window_attention_tokens", tag, wa.fused_window_attention,
                 wa.reference_attention_qkv, (qkv, bias2, mask, mnw, nh2, 1.0),
                 nbytes(qkv, bias2, mask) + nbytes(qkv) // 3,
                 4 * w2 * n2 * n2 * c2, calls,
                 lambda q=q11, k=k11, v=v11, am=am:
                 F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                scale=1.0), path="swinv2",
                 device=True)
            case("window_attention_tokens_bwd", tag,
                 wa.window_attention_tokens_bwd, wa.attention_qkv_bwd_plain,
                 (qkv, bias2, mask, mnw, nh2, 1.0, gy),
                 2 * nbytes(qkv) + nbytes(gy) + 2 * nbytes(bias2)
                 + nbytes(mask), 10 * w2 * n2 * n2 * c2, calls,
                 sdpa_bwd(q11, k11, v11, am, 1.0), (KERNEL_TOL, DBIAS_TOL),
                 path="swinv2_train", device=True)

    # K13: every LayerNorm of a training step outside a megakernel (calls
    # per step in the comment of PER_STEP), bound by bytes: x read, y
    # written (add+LN: two reads, two writes)
    for hw, c, calls in ((128, 48, 4), (128, 192, 12), (64, 384, 5),
                         (32, 768, 2)):
        x = rnd((batch, hw, hw, c))
        w, b = ln(c)
        wb, bb = w.to(bf), b.to(bf)
        case("layernorm", f"({batch},{hw},{hw},{c})", kln.layernorm,
             kln.layernorm_plain, (x, w, b), 2 * nbytes(x) + nbytes(w, b),
             8 * x.numel(), calls,
             lambda x=x, c=c, wb=wb, bb=bb: F.layer_norm(x, (c,), wb, bb),
             path="train", device=True)
    # K13 on the SwinV2 paths (31 calls per forward, and no more per step):
    # the four LNs of the cross-channel block on its 2x2 windows, the two
    # post-norms of each block of the four stages and the PatchMerging norm
    # that follows stages 0 to 2
    for shape, calls in (((batch * 4096, 4, 24), 4),
                         ((batch, 128, 128, 96), 4),
                         ((batch, 64, 64, 192), 4 + 1),
                         ((batch, 32, 32, 384), 12 + 1),
                         ((batch, 16, 16, 768), 4 + 1)):
        x = rnd(shape)
        c = shape[-1]
        w, b = ln(c)
        wb, bb = w.to(bf), b.to(bf)
        for path in ("swinv2", "swinv2_train"):
            case("layernorm", "(" + ",".join(map(str, shape)) + ")",
                 kln.layernorm, kln.layernorm_plain, (x, w, b),
                 2 * nbytes(x) + nbytes(w, b), 8 * x.numel(), calls,
                 lambda x=x, c=c, wb=wb, bb=bb: F.layer_norm(x, (c,), wb, bb),
                 path=path, device=True)
    for hw, c, calls in ((64, 384, 4), (32, 768, 1)):
        x, y = rnd((batch, hw, hw, c)), rnd((batch, hw, hw, c))
        w, b = ln(c)
        wb, bb = w.to(bf), b.to(bf)
        case("add_layernorm", f"({batch},{hw},{hw},{c})", kln.add_layernorm,
             kln.add_layernorm_plain, (x, y, w, b),
             4 * nbytes(x) + nbytes(w, b), 9 * x.numel(), calls,
             lambda x=x, y=y, c=c, wb=wb, bb=bb: F.layer_norm(
                 x + y, (c,), wb, bb), (KERNEL_TOL, KERNEL_TOL), path="train",
             device=True)

    # stage 3: one 32x32 window, K8
    c, hw = 768, 32
    n = hw * hw
    qkv = rnd((batch, hw, hw, 3 * c))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    scale = (c // nh) ** -0.5
    heads = qkv.reshape(batch, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in heads)
    mask_bf = bias.to(bf)[None]
    case("global_attention", f"({batch},{hw},{hw},{3 * c}) N {n}",
         wa.fused_global_attention, wa.global_attention_plain,
         (qkv, bias, nh, scale), nbytes(qkv, bias) + nbytes(qkv) // 3,
         4 * batch * n * n * c, 1,
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf,
                                                scale=scale))
    # K8 on the 608 px path: stage 3's 38x38 map padded to 64x64, four
    # 32x32 windows per image, no mask (stage 3's one block is unshifted)
    hw6 = 64
    qkv6 = rnd((batch, hw6, hw6, 3 * c))
    heads6 = (qkv6.reshape(batch, 2, hw, 2, hw, 3, nh, c // nh)
              .permute(5, 0, 1, 3, 6, 2, 4, 7)
              .reshape(3, batch * 4, nh, n, c // nh))
    q6, k6, v6 = (t.contiguous() for t in heads6)
    case("global_attention", f"({batch},{hw6},{hw6},{3 * c}) ws {hw}",
         wa.fused_global_attention, wa.global_attention_plain,
         (qkv6, bias, nh, scale, hw), nbytes(qkv6, bias) + nbytes(qkv6) // 3,
         4 * batch * hw6 * hw6 * n * c, 1,
         lambda: F.scaled_dot_product_attention(q6, k6, v6,
                                                attn_mask=mask_bf,
                                                scale=scale), path="608px")
    # K10, its backward, as the training step runs it: on K8's statistics
    # (head dim 64, scale 1/8: `lse_reusable`). qkv, gy and K8's f32 output
    # and log-sum-exp read, dqkv written, the 50 MB bias read and the 50 MB
    # dbias written once. Beside it (path "own_stats", not a path of the
    # kernels line) K10 taking its own statistics, as a direct call does.
    gy = rnd((batch, hw, hw, c))
    _, k8_stats = wa._launch_global(qkv, bias, None, nh, scale, hw, True)
    case("global_attention_bwd", f"({batch},{hw},{hw},{3 * c}) N {n} "
         "K8 stats",
         lambda *a: wa.global_attention_bwd(*a, stats=k8_stats),
         wa.global_attention_bwd_plain, (qkv, bias, nh, scale, gy),
         2 * nbytes(qkv) + nbytes(gy) + 2 * nbytes(bias) + nbytes(*k8_stats),
         10 * batch * n * n * c, 1, sdpa_bwd(q, k, v, mask_bf, scale),
         (KERNEL_TOL, DBIAS_TOL), path="train")
    case("global_attention_bwd", f"({batch},{hw},{hw},{3 * c}) N {n}",
         wa.global_attention_bwd, wa.global_attention_bwd_plain,
         (qkv, bias, nh, scale, gy),
         2 * nbytes(qkv) + nbytes(gy) + 2 * nbytes(bias),
         10 * batch * n * n * c, 1, sdpa_bwd(q, k, v, mask_bf, scale),
         (KERNEL_TOL, DBIAS_TOL), path="own_stats")
    int8_cases(batch, rnd, ln, msk, case)
    return cases


def int8_cases(batch: int, rnd, ln, msk, case) -> None:
    """K12 at the int8 path's shapes (512 px): stage 1 (c 192, hidden 768)
    K2's body x3, K3's + K4's (shift 2) x3; stage 2 (c 384) K5's x2 + x2
    (shift 0 / 2), K6's x2, K7's x2; and K2's at 608 px's stage 1 (152 x
    152: 19 windows per strip; 0 calls on the path). The kernels get the
    int8 weights precomputed, as the model's cache hands them over. Bytes:
    activations in and out, int8 weights; operations: the projections as s8
    (two per multiply-add; K4 / K7's fc1 also over the halo row of each
    8-row strip) plus the bf16 attention core (4 N C per token)."""
    import functools
    import torch
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.kernels import swin_block as sb
    from sodt_tpu_torch.kernels.quant import q8_weights, tail_ws

    def q8case(name, shape, fn, plain, args, q8, nb, ops, attn, calls,
               chain_bytes):
        """`attn`: the attention core's FLOPs (0 for the tails, whose plain
        version has no core to share); `chain_bytes`: the bytes its chain
        of csrc/int8_chains.cu moves (the row carries the split by
        launch)."""
        b, h, w = args[0].shape[:3]
        ws = i8ws if attn else tail_ws(h)
        shift = args[-1] if isinstance(args[-1], int) else 0
        case(name, shape, functools.partial(fn, int8=True, q8=q8),
             functools.partial(plain, q8=q8), args, nb, attn, calls,
             path="int8", int8_ops=ops, bf16=functools.partial(fn, *args),
             device=True, chain_bytes=chain_bytes,
             q8=dict(same_core=functools.partial(
                 plain, q8=q8, **({"dispatch": True} if attn else {})),
                 geom=(b, h, w, ws, shift if attn else 0)))

    def wbytes(q8):
        return sum(nbytes(q, s) for q, s in q8.values())

    i8nh, i8ws, i8n = 12, 8, 64
    for hw, calls2 in ((128, 3), (152, 0)):
        c1 = 192
        m1 = batch * hw * hw
        xa = rnd((batch, hw, hw, c1))
        att1 = (rnd((3 * c1, c1), c1 ** -0.5), rnd((3 * c1,), 0.1),
                rnd((c1, c1), c1 ** -0.5), rnd((c1,), 0.1))
        lin1 = (rnd((4 * c1, c1), c1 ** -0.5), rnd((4 * c1,), 0.1),
                rnd((c1, 4 * c1), (4 * c1) ** -0.5), rnd((c1,), 0.1))
        lna, lnb_ = ln(c1), ln(c1)
        bias1 = rnd((i8nh, i8n, i8n), 1.0, torch.float32)
        sc1 = (c1 // i8nh) ** -0.5
        q2 = q8_weights(None, wqkv=att1[0], wp=att1[2], w1=lin1[0],
                        w2=lin1[2])
        q8case("swin_block_q8", f"({batch},{hw},{hw},{c1}) shift 0",
               sb.fused_swin_block, sb.swin_block_q8_plain,
               (xa, *lna, *att1, *lnb_, *lin1, bias1, None, i8ws, i8nh, sc1,
                0), q2, 2 * nbytes(xa) + wbytes(q2) + nbytes(
                    bias1, *lna, *lnb_, att1[1], att1[3], lin1[1], lin1[3]),
               24 * m1 * c1 * c1,
               4 * m1 * i8n * c1, calls2,
               # in (M, C) int8 bytes: x 2 + 2 + 2, codes 1 + 1 + 1 + 1 + 1
               # + 1, qkv 6 + 6, att 2 + 2 + 2, res1 4 + 4 + 4 + 4, the
               # hidden's 4 + 4, out 2
               chain_bytes=57 * m1 * c1 + wbytes(q2))
        if hw != 128:
            continue
        mask1 = msk(hw, i8ws, 2)
        q3 = {k: q2[k] for k in ("wqkv", "wp")}
        q8case("block_attention_ln_q8", f"({batch},{hw},{hw},{c1}) shift 2",
               wa.fused_block_attention_ln, wa.block_attention_ln_q8_plain,
               (xa, *lna, *att1, bias1, mask1, i8ws, i8nh, sc1, 2), q3,
               2 * nbytes(xa) + wbytes(q3) + nbytes(
                   bias1, mask1, *lna, att1[1], att1[3]), 8 * m1 * c1 * c1,
               4 * m1 * i8n * c1, 3,
               # in (M, C) int8 bytes: x 2 + 2, codes 1 + 1 + 1 + 1, qkv 6
               # + 6, att 2 + 2 + 2, out 2
               chain_bytes=28 * m1 * c1 + wbytes(q3))
        aa = rnd((batch, hw, hw, c1))
        conv1 = (rnd((c1, c1), c1 ** -0.5), rnd((c1,), 0.1),
                 rnd((c1, 2, 2, c1), (4 * c1) ** -0.5), rnd((c1,), 0.1),
                 rnd((c1, c1), c1 ** -0.5), rnd((c1,), 0.1))
        q4 = q8_weights(None, w1=conv1[0], wc=conv1[2], w2=conv1[4])
        halo1 = m1 // 8
        q8case("conv_mlp_tail_q8", f"({batch},{hw},{hw},{c1}) shift 2",
               sb.fused_conv_mlp_tail, sb.conv_mlp_tail_q8_plain,
               (xa, aa, *lnb_, *conv1, 2), q4, 3 * nbytes(xa) + wbytes(q4),
               2 * (m1 + halo1) * c1 * c1 + 10 * m1 * c1 * c1, 0, 3,
               # x + a over the rows and halo rows 4.5 + 4.5, t 1.125 +
               # 1.125, f1 1.125 + 1.125 + 1.125, the conv's f32 y 4 + 4, y's
               # codes 1 + 1, fc2's x + a + out 6 (M C bytes)
               chain_bytes=int(30.625 * m1 * c1) + wbytes(q4))

    hw, c2 = 64, 384
    m2 = batch * hw * hw
    xb = rnd((batch, hw, hw, c2))
    att2 = (rnd((3 * c2, c2), c2 ** -0.5), rnd((3 * c2,), 0.1),
            rnd((c2, c2), c2 ** -0.5), rnd((c2,), 0.1))
    bias2 = rnd((i8nh, i8n, i8n), 1.0, torch.float32)
    q5 = q8_weights(None, wqkv=att2[0], wp=att2[2])
    for sh in (0, 2):
        q8case("block_attention_q8", f"({batch},{hw},{hw},{c2}) shift {sh}",
               wa.fused_block_attention, wa.block_attention_q8_plain,
               (xb, *att2, bias2, msk(hw, i8ws, sh), i8ws, i8nh,
                (c2 // i8nh) ** -0.5, sh), q5, 2 * nbytes(xb) + wbytes(q5)
               + nbytes(bias2, msk(hw, i8ws, sh), att2[1], att2[3]),
               8 * m2 * c2 * c2, 4 * m2 * i8n * c2, 2,
               chain_bytes=28 * m2 * c2 + wbytes(q5))  # as K3's twin
    rb, yb = rnd((batch, hw, hw, c2)), rnd((batch, hw, hw, c2))
    hid2 = 4 * c2
    lin2 = (rnd((hid2, c2), c2 ** -0.5), rnd((hid2,), 0.1),
            rnd((c2, hid2), hid2 ** -0.5), rnd((c2,), 0.1))
    q6 = q8_weights(None, w1=lin2[0], w2=lin2[2])
    q8case("mlp_tail_q8", f"({batch},{hw},{hw},{c2}) hidden {hid2}",
           sb.fused_mlp_tail, sb.mlp_tail_q8_plain, (rb, yb, *lin2), q6,
           3 * nbytes(rb) + wbytes(q6), 4 * m2 * c2 * hid2, 0, 2,
           # in (M, C) int8 bytes: y 2 + 2, codes 1 + 1 + 1, fc1's f32
           # hidden 16 + 16, its codes 4 + 4, r 2, out 2
           chain_bytes=50 * m2 * c2 + wbytes(q6))
    conv2 = (rnd((c2, c2), c2 ** -0.5), rnd((c2,), 0.1),
             rnd((c2, 2, 2, c2), (4 * c2) ** -0.5), rnd((c2,), 0.1),
             rnd((c2, c2), c2 ** -0.5), rnd((c2,), 0.1))
    q7 = q8_weights(None, w1=conv2[0], wc=conv2[2], w2=conv2[4])
    q8case("conv_mlp_tail_noln_q8", f"({batch},{hw},{hw},{c2})",
           sb.fused_conv_mlp_tail_noln, sb.conv_mlp_tail_noln_q8_plain,
           (rb, yb, *conv2), q7, 3 * nbytes(rb) + wbytes(q7),
           2 * (m2 + m2 // 8) * c2 * c2 + 10 * m2 * c2 * c2, 0, 2,
           chain_bytes=int(24.125 * m2 * c2) + wbytes(q7))


def _as_tuple(o) -> tuple:
    return o if isinstance(o, tuple) else (o,)


def kernel_vs_plain(cs) -> tuple:
    """A case's kernel and plain version on its arguments: (outputs,
    references, max |diff| of each output, max |diff| / max |ref|)."""
    import torch
    args = cs["args"]
    outs = _as_tuple(cs["kern"](*args))
    # K12's plain version takes the same bf16 inputs: its rounding points
    # are part of the function
    refs = _as_tuple(cs["plain"](*(args if cs["int8_ops"]
                                   else _cast(args, torch.float32))))
    torch.cuda.synchronize()
    errs = [(o.float() - r.float()).abs().max().item()
            for o, r in zip(outs, refs)]
    rels = [e / r.float().abs().max().item() for e, r in zip(errs, refs)]
    return outs, refs, errs, rels


def within(rels, tols) -> bool:
    return bool(len(rels) == len(tols) and all(
        math.isfinite(r) and r <= t for r, t in zip(rels, tols)))


def phase_kernels(batch: int) -> list[dict]:
    import torch
    rows = []
    for cs in kernel_cases(batch):
        args = cs["args"]
        outs, refs, errs, rels = kernel_vs_plain(cs)
        singly = bit_equal = None
        if cs["name"].endswith("_bwd") or cs["device"]:
            # no atomics (the dbias sums, the GEMM core of K6 / K7): a
            # second run gives the same bits
            again = _as_tuple(cs["kern"](*args))
            bit_equal = all(torch.equal(a, o) for a, o in zip(again, outs))
            del again
        if cs["name"].endswith("_bwd"):
            # dq, dk, dv singly (the last axis of dqkv is [q | k | v]): the
            # kernel rounds P and dS to bf16 before its tensor-core
            # products, the plain version keeps them in f32; beside each,
            # what rounding the f32 result to bf16 at the store leaves
            rel = lambda a, r: ((a.float() - r).abs().max()
                                / r.abs().max()).item()
            singly = {
                "kernel": [rel(o, r) for o, r in zip(outs[0].chunk(3, -1),
                                                     refs[0].chunk(3, -1))],
                "bf16_store_alone": [rel(r.to(torch.bfloat16), r)
                                     for r in refs[0].chunk(3, -1)]}
        del outs, refs
        ms = time_ms(lambda: cs["kern"](*args))
        pms = time_ms(lambda: cs["plain"](*args))
        lms = time_ms(cs["lib"]) if cs["lib"] is not None else None
        b16 = time_ms(cs["bf16"]) if cs["bf16"] is not None else None
        bms, by = bound_ms(cs["nbytes"], cs["flops"], cs["int8_ops"])
        dev = {}
        tag = f'{cs["name"]} {cs["shape"]} batch {batch}'
        fell_back = len(PROFILER["event_fallbacks"])
        if cs["lib"] is not None:
            dev["library_device_ms"] = device_ms(cs["lib"], f"{tag} library")
        if cs["device"]:
            dev["device_ms"], split = device_split(lambda: cs["kern"](*args),
                                                   tag)
            if cs["chain_bytes"] is not None:
                # the chain's launches one by one, and the least time of
                # the bytes they move beside the function's bound_ms
                dev["launch_device_ms"] = split
                dev["chain_bytes"] = cs["chain_bytes"]
                dev["chain_bytes_bound_ms"] = (1e3 * cs["chain_bytes"]
                                               / HBM_BYTES_PER_S)
            dev["plain_device_ms"] = device_ms(lambda: cs["plain"](*args),
                                               f"{tag} plain")
            dev["tflops"] = cs["flops"] / dev["device_ms"] / 1e9
            dev["plain_tflops"] = cs["flops"] / dev["plain_device_ms"] / 1e9
        if PROFILER["event_fallbacks"][fell_back:]:
            # these device times are CUDA-event times, host gaps included
            dev["cuda_event_fallbacks"] = PROFILER["event_fallbacks"][fell_back:]
        q8 = (q8_readings(lambda: cs["kern"](*args),
                          lambda: cs["q8"]["same_core"](*args), cs["bf16"],
                          cs["q8"]["geom"]) if cs["q8"] is not None else {})
        row = {"phase": "kernel", "name": cs["name"], "shape": cs["shape"],
               "batch": batch, "path": cs["path"],
               "calls_per_forward": cs["calls"],
               "max_abs_err": errs[0], "rel_err": rels[0],
               "rel_errs": rels, "tols": list(cs["tols"]),
               "dq_dk_dv_rel_err": singly,
               "bit_equal_over_two_runs": bit_equal,
               "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bf16_kernel_ms": b16, "bound_ms": bms, "bound_by": by,
               **dev, **q8,
               "ok": bool(within(rels, cs["tols"])
                          and bit_equal is not False
                          and q8.get("q8_ok", True))}
        emit(row)
        rows.append(row)
    return rows


def _amax_err(klog, slots) -> float:
    """max over points and strips of |kernel slot - slot| / slot."""
    return max(((k.amax(-1) - c).abs() / c.clamp_min(1e-30)).max().item()
               for k, c in zip(klog, slots))


def int8_bodies() -> dict:
    """K12's bodies: counter -> (module, launcher, plain int8 body, bf16
    wrapper, has an attention core). A launcher and its plain body take the
    same arguments; the bf16 wrapper takes them without the int8 weights."""
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.kernels import swin_block as sb
    return {
        "swin_block_q8": (sb, "_launch_swin_block_q8", sb.swin_block_q8_plain,
                          sb.fused_swin_block, True),
        "block_attention_ln_q8": (
            wa, "_launch_block_attention_ln_q8",
            wa.block_attention_ln_q8_plain, wa.fused_block_attention_ln,
            True),
        "conv_mlp_tail_q8": (sb, "_launch_conv_tail_q8",
                             sb.conv_mlp_tail_q8_plain, sb.fused_conv_mlp_tail,
                             False),
        "block_attention_q8": (wa, "_launch_block_attention_q8",
                               wa.block_attention_q8_plain,
                               wa.fused_block_attention, True),
        "mlp_tail_q8": (sb, "_launch_mlp_tail_q8", sb.mlp_tail_q8_plain,
                        sb.fused_mlp_tail, False),
        "conv_mlp_tail_noln_q8": (sb, "_launch_conv_tail_noln_q8",
                                  sb.conv_mlp_tail_noln_q8_plain,
                                  sb.fused_conv_mlp_tail_noln, False)}


def q8_readings(kern, same_core, bf16, geom) -> dict:
    """K12: the kernel (`kern()`) against its plain int8 version with the
    same attention core (`same_core()`), output and strip abs-max slots,
    and the controls each reading must tell from the kernel: the bf16
    kernel's output (`bf16()`), and strip maxima over one 64-row tile, over
    the unshifted rows (a shifted block) and without the halo row (the conv
    tails). geom: (B, H, W, strip rows, shift of the strips' coordinates)."""
    import torch
    from sodt_tpu_torch.kernels.quant import strip_amax_log
    b, h, w, ws, shift = geom
    with strip_amax_log() as klog:
        out = kern()
    with strip_amax_log() as plog:
        ref = same_core()
    bf = bf16()
    ref32 = ref.float()
    rl2 = lambda a: ((a.float() - ref32).norm() / ref32.norm()).item()
    slots = [p.amax(-1) for p in plog]
    controls = {
        "bf16_kernel_rel_l2": rl2(bf),
        "tile_amax_rel_err": _amax_err(klog, [p[:, :64].amax(-1)
                                              for p in plog]),
        "unshifted_amax_rel_err": _amax_err(klog, [
            torch.roll(p.reshape(b, h, w), (shift, shift), (1, 2))
            .reshape(p.shape).amax(-1) for p in plog]) if shift else None,
        "no_halo_amax_rel_err": _amax_err(
            [k for k, p in zip(klog, plog) if p.shape[1] > ws * w],
            [p[:, :ws * w].amax(-1) for p in plog if p.shape[1] > ws * w])
        if any(p.shape[1] > ws * w for p in plog) else None}
    r = {"q8_rel_l2": rl2(out), "q8_amax_rel_err": _amax_err(klog, slots),
         "q8_amax_bit_equal_share": sum(
             int((k.amax(-1) == c).sum()) for k, c in zip(klog, slots))
         / sum(c.numel() for c in slots),
         "q8_points": [len(klog), len(plog)],
         "q8_limits": [Q8_REL_L2, Q8_AMAX_TOL], "q8_controls": controls}
    r["q8_ok"] = bool(
        len(klog) == len(plog) > 0 and r["q8_rel_l2"] <= Q8_REL_L2
        and r["q8_amax_rel_err"] <= Q8_AMAX_TOL
        and controls["bf16_kernel_rel_l2"] > Q8_REL_L2
        and all(v > Q8_AMAX_TOL for k, v in controls.items()
                if k != "bf16_kernel_rel_l2" and v is not None))
    return r


# ---------------------------------------------------------------- main path

def seeded_model(cfg: str, dtype, seed: int = 0, input_mode: str = "RGB+IR",
                 **build):
    """The model of `cfg` under `input_mode` with weights from `seed`, on
    the CPU (`build`: more arguments of build_model, such as the SR
    branch's). The SwinV2 blocks' post-norm scales are drawn from the seed
    as well: at their zero initialization every V2 block is the identity,
    K11 contributes nothing to the output and its backward returns zeros
    (a model without V2 blocks is left as `init_weights` made it)."""
    import torch
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.models.swinv2 import SwinBlockV2
    from sodt_tpu_torch.train.trainer import CH_IN
    from sodt_tpu_torch.weights import init_weights
    model = init_weights(build_model(cfg, ch_in=CH_IN[input_mode],
                                     dtype=dtype, input_mode=input_mode,
                                     **build), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SwinBlockV2):
                for norm in (mod.norm1, mod.norm2):
                    norm.weight.copy_(0.5 + torch.rand(norm.weight.shape,
                                                       generator=g))
    return model


def seeded_weights_file(cfg: str, workdir: Path) -> str:
    """`seeded_model`'s weights as the .npz that --weights-npz reads."""
    import torch
    from sodt_tpu_torch.weights import save_npz
    path = workdir / (Path(cfg).stem + "_seed0.npz")
    save_npz(seeded_model(cfg, torch.float32).state_dict(), path)
    return str(path)


def map_spread(raw) -> float:
    """The spread of a raw Detect map over its positions: the mean over
    its output channels of their standard deviation over batch and cells
    (0 for a map that is the bias prior alone)."""
    return float(raw.flatten(0, 2).std(dim=0).mean())


def phase_path(label: str, args: list[str], expected: dict) -> dict:
    """Drive `sodt_tpu_torch.val` in-process with the launch counts set to
    0 just before and read just after; then hold the raw Detect maps of one
    batch, bf16 kernels vs the f32 plain path on the same weights
    (`seeded_model` of the path's --cfg: what val builds itself for the
    flagship, what --weights-npz hands it for SwinV2)."""
    import torch
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches

    opt = val.parser().parse_args(args)
    n_img, img_size, bs = opt.synthetic_n, opt.img_size, opt.batch_size
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = val.main(args)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    forwards = math.ceil(n_img / bs)
    per_fwd = {k: v / forwards for k, v in counts.items()}
    finite = all(math.isfinite(m[k]) for k in ("map50", "map", "speed_ms"))

    ds = SyntheticVedai(n=bs, img_size=img_size, nc=8, seed=1)
    batch = next(make_eval_batches(ds, bs, img_size))
    img = torch.from_numpy(batch["img"]).cuda().float() / 255
    ir = torch.from_numpy(batch["ir"]).cuda().float() / 255
    raws = {}
    for dt in (torch.bfloat16, torch.float32):
        model = cache_rel_bias(seeded_model(
            opt.cfg, dt, input_mode=opt.input_mode).cuda().eval())
        with torch.no_grad():
            raws[dt] = model(img, ir)["raw"][0].float()
            if dt == torch.bfloat16:
                # the kernels of one bf16 forward: K5 runs its chain on the
                # GEMM core, and K5's old WMMA GEMM (gemm_bias_kernel) runs
                # nowhere
                seen = [r["kernel"] for r in profiled(
                    lambda: model(img, ir), f"{label} forward kernels")]
    a, b = raws[torch.bfloat16], raws[torch.float32]
    rel_l2 = ((a - b).norm() / b.norm()).item()
    g = img_size // 4
    ok = (per_fwd == {k: float(v) for k, v in expected.items()}
          and finite and bool(torch.isfinite(a).all())
          and tuple(a.shape) == (bs, g, g, 3, 13)
          and m["seen"] == n_img and rel_l2 <= DETECT_REL_L2
          and bool(seen) and not any("gemm_bias" in k for k in seen))
    row = {"phase": label, "args": args, "wall_s": wall,
           "images_per_s": m["images_per_s"], "speed_ms": m["speed_ms"],
           "map50": m["map50"], "map": m["map"], "seen": m["seen"],
           "launches": counts, "launches_per_forward": per_fwd,
           "expected_per_forward": expected,
           "detect_rel_l2_bf16_vs_f32": rel_l2, "rel_l2_bound": DETECT_REL_L2,
           "raw_shape": list(a.shape), "raw_spread": map_spread(b),
           "forward_kernels_seen": len(seen),
           "gemm_bias_kernels_seen": [k for k in seen if "gemm_bias" in k],
           "ok": bool(ok)}
    emit(row)
    return row


@contextlib.contextmanager
def swapped_int8_launchers(make):
    """Within the context each K12 launcher is `make(name, launcher)`. A
    launcher that is not where it is looked for raises here."""
    bodies = int8_bodies()
    saved = {name: getattr(mod, fn) for name, (mod, fn, *_) in bodies.items()}
    try:
        for name, (mod, fn, *_) in bodies.items():
            setattr(mod, fn, make(name, saved[name]))
        yield
    finally:
        for name, (mod, fn, *_) in bodies.items():
            setattr(mod, fn, saved[name])


@contextlib.contextmanager
def plain_int8(same_core: bool):
    """Within the context the int8 wrappers run their plain int8 bodies on
    the card, each in place of its launcher (with `same_core`, the
    attention core through K1, as in the kernels): the yardstick of the
    int8 path's Detect maps. A `*_q8` launch inside the context (a swap
    that did not take) fails on exit."""
    import functools
    from sodt_tpu_torch import kernels
    bodies = int8_bodies()

    def make(name, _):
        _, _, plain, _, core = bodies[name]
        return (functools.partial(plain, dispatch=True)
                if core and same_core else plain)

    q8_launches = lambda: sum(v for k, v in kernels.launches().items()
                              if k.endswith("_q8"))
    before = q8_launches()
    with swapped_int8_launchers(make):
        yield
    if q8_launches() != before:
        raise RuntimeError("plain_int8: an int8 kernel launched")


def int8_call_readings(calls) -> dict:
    """`q8_readings` of every K12 call a forward made, on the arguments it
    was given (the path's own activations, weights and int8 weights), by
    counter: the largest reading and the smallest control of its calls."""
    import functools
    from sodt_tpu_torch.kernels.quant import tail_ws
    bodies = int8_bodies()
    out = {}
    for name, launch, a in calls:
        _, _, plain, bf16, core = bodies[name]
        b, h, w = a[0].shape[:3]
        geom = (b, h, w, a[-5], a[-2]) if core else (b, h, w, tail_ws(h), 0)
        same = (functools.partial(plain, dispatch=True) if core else plain)
        r = q8_readings(lambda: launch(*a), lambda: same(*a),
                        lambda: bf16(*a[:-1]), geom)
        if name not in out:
            out[name] = dict(r, calls=1)
            continue
        o = out[name]
        o["calls"] += 1
        for k in ("q8_rel_l2", "q8_amax_rel_err"):
            o[k] = max(o[k], r[k])
        for k, v in r["q8_controls"].items():
            if v is not None:
                was = o["q8_controls"][k]
                o["q8_controls"][k] = v if was is None else min(was, v)
        o["q8_ok"] = o["q8_ok"] and r["q8_ok"]
        o["q8_amax_bit_equal_share"] = min(o["q8_amax_bit_equal_share"],
                                           r["q8_amax_bit_equal_share"])
    return out


def phase_int8(label: str, args: list[str], expected: dict) -> dict:
    """The int8 serving path: `sodt_tpu_torch.val --int8` in-process with
    the launch counts set to 0 just before and read just after; raw Detect
    maps of one batch on the seeded weights, the int8 kernels against the
    plain int8 bodies on the card and against the bf16 kernels (bound
    DETECT_REL_L2 each: it catches a wrong path, not a rounding point;
    quantization makes the model discontinuous, so a code that one ulp
    moved in one body moves later strips' scales, and the maps of two
    sound int8 forwards sit about as far apart as int8 from bf16), and
    against the plain int8 bodies with the kernels' attention core
    (reported); every K12 call of that forward held on its own arguments
    as the kernel cases are (`int8_call_readings`, bounds Q8_REL_L2 /
    Q8_AMAX_TOL, with their controls); then `--task speed` of the same
    model with and without --int8 (ms per image, conf 0.25)."""
    import torch
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches

    opt = val.parser().parse_args(args)
    n_img, img_size, bs = opt.synthetic_n, opt.img_size, opt.batch_size
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = val.main(args)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    forwards = math.ceil(n_img / bs)
    per_fwd = {k: v / forwards for k, v in counts.items()}
    finite = all(math.isfinite(m[k]) for k in ("map50", "map", "speed_ms"))

    ds = SyntheticVedai(n=bs, img_size=img_size, nc=8, seed=1)
    batch = next(make_eval_batches(ds, bs, img_size))
    img = torch.from_numpy(batch["img"]).cuda().float() / 255
    ir = torch.from_numpy(batch["ir"]).cuda().float() / 255
    model = cache_rel_bias(seeded_model(
        opt.cfg, torch.bfloat16, input_mode=opt.input_mode).cuda().eval())
    raws, calls = {}, []

    def recorder(name, launch):
        def record(*a):
            calls.append((name, launch, a))
            return launch(*a)
        return record

    with torch.no_grad():
        with kernels.int8_serving():
            with swapped_int8_launchers(recorder):
                raws["int8"] = model(img, ir)["raw"][0].float()
            with plain_int8(same_core=True):
                raws["plain_core"] = model(img, ir)["raw"][0].float()
            with plain_int8(same_core=False):
                raws["plain"] = model(img, ir)["raw"][0].float()
        raws["bf16"] = model(img, ir)["raw"][0].float()
        bodies = int8_call_readings(calls)
    rel = lambda a, b: ((raws[a] - raws[b]).norm() / raws[b].norm()).item()
    vs_plain, vs_bf16 = rel("int8", "plain"), rel("int8", "bf16")
    vs_core = rel("int8", "plain_core")
    per_call = {k: v["calls"] for k, v in bodies.items()}
    speed = {}
    for tag, extra in (("int8", ["--int8"]), ("bf16", [])):
        speed[tag] = val.main(extra + [
            "--cfg", opt.cfg, "--input_mode", opt.input_mode, "--task",
            "speed", "--img-size", str(img_size), "--batch-size",
            str(bs)])["ms_per_image"]
    a = raws["int8"]
    g = img_size // 4
    ok = (per_fwd == {k: float(v) for k, v in expected.items()}
          and finite and bool(torch.isfinite(a).all()) and m["int8"] is True
          and tuple(a.shape) == (bs, g, g, 3, 13) and m["seen"] == n_img
          and vs_plain <= DETECT_REL_L2 and 0 < vs_bf16 <= DETECT_REL_L2
          and per_call == {k: v for k, v in expected.items()
                           if k.endswith("_q8")}
          and all(v["q8_ok"] for v in bodies.values()))
    row = {"phase": label, "args": args, "wall_s": wall,
           "images_per_s": m["images_per_s"], "speed_ms": m["speed_ms"],
           "map50": m["map50"], "map": m["map"], "seen": m["seen"],
           "launches": counts, "launches_per_forward": per_fwd,
           "expected_per_forward": expected,
           "detect_rel_l2_int8_kernels_vs_plain_int8": vs_plain,
           "rel_l2_bound": DETECT_REL_L2,
           "detect_rel_l2_int8_kernels_vs_plain_int8_same_core": vs_core,
           "detect_rel_l2_int8_vs_bf16_kernels": vs_bf16,
           "bodies_on_the_path_inputs": bodies,
           "speed_ms_per_image": speed, "raw_shape": list(a.shape),
           "ok": bool(ok)}
    emit(row)
    return row


def phase_autograd() -> list[str]:
    """torch.autograd.grad through the three attention functions (K1 -> K9
    at stage 1 with the shift mask and at stage 2 without, K8 -> K10, K11
    -> K11 backward on the windows of SwinV2's stage 0 with the mask) at
    the training batch, against autograd of the f32 plain version on the
    same inputs; the cotangent arrives as a view."""
    import torch
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.models.swin import shift_attn_mask

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(1)
    rnd = lambda shape: torch.randn(shape, generator=g).cuda()
    failed = []
    for kind, (hw, c, ws), shift, nh in (("window", (128, 192, 8), 2, 12),
                                         ("window", (64, 384, 8), 0, 12),
                                         ("global", (32, 768, 32), 0, 12),
                                         ("tokens", (128, 96, 8), 4, 3)):
        n = ws * ws
        mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
                if shift else None)
        scale = (c // nh) ** -0.5
        bias = rnd((nh, n, n)).requires_grad_()
        if kind == "tokens":      # (W, N, 3C) windows, scale 1 as V2 calls it
            nw, scale = (hw // ws) ** 2, 1.0
            qkv = rnd((MAIN_BATCH * nw, n, 3 * c)).to(bf).requires_grad_()
            gy = rnd((MAIN_BATCH * nw, c, n)).to(bf).transpose(1, 2)
            plain = lambda q, b: wa.reference_attention_qkv(q, b, mask, nw,
                                                            nh, scale)
        else:
            qkv = rnd((MAIN_BATCH, hw, hw, 3 * c)).to(bf).requires_grad_()
            gy = rnd((MAIN_BATCH, hw, c, hw)).to(bf).transpose(2, 3)
            plain = lambda q, b: wa.reference_attention_nhwc(q, b, mask, ws,
                                                             nh, scale)
        kernels.reset_launches()
        if kind == "window":
            out = wa.fused_window_attention_nhwc(qkv, bias, mask, ws, nh,
                                                 scale)
        elif kind == "global":
            out = wa.fused_global_attention(qkv, bias, nh, scale)
        else:
            out = wa.fused_window_attention(qkv, bias, mask, nw, nh, scale)
        dq, db = torch.autograd.grad(out, [qkv, bias], gy)
        counts = {k: v for k, v in kernels.launches().items() if v}
        q32 = qkv.detach().float().requires_grad_()
        b32 = bias.detach().clone().requires_grad_()
        rq, rb = torch.autograd.grad(plain(q32, b32), [q32, b32], gy.float())
        torch.cuda.synchronize()
        rel = lambda a, b: ((a.float() - b).abs().max() / b.abs().max()).item()
        # dbias against the plain FORWARD's autograd: that forward scales q
        # in bf16-free f32 but before the product, the kernels scale the
        # scores: 5e-3 leaves room for the reassociation
        row = {"phase": "autograd", "function": kind,
               "shape": list(qkv.shape), "masked": bool(shift),
               "launches": counts,
               "dqkv_rel_err": rel(dq, rq), "dbias_rel_err": rel(db, rb),
               "dqkv_max_abs": dq.float().abs().max().item(),
               "tols": [KERNEL_TOL, 5e-3]}
        row["ok"] = bool(row["dqkv_rel_err"] <= KERNEL_TOL
                         and row["dbias_rel_err"] <= 5e-3
                         and row["dqkv_max_abs"] > 0
                         and sorted(counts.values()) == [1, 1])
        emit(row)
        if not row["ok"]:
            failed.append(f"autograd {kind} {hw}")
    return failed


def phase_train(label: str, workdir: Path, train_args: list[str], steps: int,
                per_step: dict, per_forward: dict) -> dict:
    """Drive `sodt_tpu_torch.train` in-process for `steps` optimizer steps,
    the launch counts set to 0 just before and read just after. A step hook
    reads the counts of each step and the synchronized step times, a
    gradient hook the first step's gradients. The run starts from
    `seeded_model` of its --cfg: the trainer's own seeded initialization
    for the flagship, --weights-npz for SwinV2."""
    import torch
    import yaml
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train import cli

    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = yaml.safe_load(f)
    hyp_path = workdir / "hyp_smoke.yaml"
    hyp_path.write_text(yaml.safe_dump(dict(hyp, warmup_iters=4)))
    args = train_args + ["--hyp", str(hyp_path), "--save-dir",
                         str(workdir / label)]
    opt = cli.parser().parse_args(args)

    seen = {"counts": [], "losses": [], "t": [], "no_grad": None,
            "state": None}

    def on_step(state, metrics):
        torch.cuda.synchronize()
        seen["t"].append(time.perf_counter())
        seen["counts"].append(kernels.launches())
        seen["losses"].append({k: float(v) for k, v in metrics.items()})
        seen["state"] = state

    def on_grads(grads):
        if seen["no_grad"] is None:
            seen["no_grad"] = [k for k, g in grads.items()
                               if not (torch.isfinite(g).all()
                                       and g.abs().max() > 0)]
            seen["n_params"] = len(grads)

    kernels.reset_launches()
    t0 = time.perf_counter()
    with stdout_lines("autoanchor") as autoanchor:
        m = cli.main(args, on_step=on_step, on_grads=on_grads)
    wall = time.perf_counter() - t0
    counts = kernels.launches()

    zero = {k: 0 for k in counts}
    counted = [{k: c[k] - p[k] for k in c}
               for p, c in zip([zero] + seen["counts"], seen["counts"])]
    step_ms = [1e3 * (b - a) for a, b in zip(seen["t"], seen["t"][1:])]
    # the run ends with one eval forward of the EMA weights (4 images)
    expected_total = {k: steps * per_step[k] + per_forward[k]
                      for k in per_step}
    start = dict(seeded_model(opt.cfg, torch.bfloat16,
                              input_mode=opt.input_mode).named_parameters())
    params = dict(seen["state"].model.named_parameters())
    unmoved = [k for k, p in params.items()
               if torch.equal(p.detach().cpu(), start[k].detach())]
    finite = all(math.isfinite(v) for l in seen["losses"] for v in l.values())
    ok = (len(counted) == steps and all(p == per_step for p in counted)
          and counts == expected_total and finite and not seen["no_grad"]
          and not unmoved and m["steps"] == steps
          and seen["state"].ema_updates == steps
          and math.isfinite(m["map50"]) and len(autoanchor) == 1)
    row = {"phase": label, "args": args, "wall_s": wall,
           "steps": len(counted), "step_ms": step_ms,
           "losses": seen["losses"], "launches": counts,
           "launches_per_step": counted[0] if counted else {},
           "expected_per_step": per_step, "expected_total": expected_total,
           "params": seen.get("n_params"),
           "params_without_gradient_at_step_1": seen["no_grad"],
           "params_unmoved": unmoved, "map50": m["map50"],
           "ema_updates": seen["state"].ema_updates,
           "autoanchor": autoanchor, "ok": bool(ok)}
    emit(row)
    return row


def perturbed(model, seed: int):
    """`model` with `perturb_state` of its state_dict, in place."""
    perturb_state(model.state_dict(), seed)
    return model


def calibrated(model, img, ir):
    """`model` with every BatchNorm's running statistics set to the batch
    statistics of one training-mode forward of (img, ir), in eval mode. A
    seeded CNN's BatchNorms at their init statistics do not renormalize:
    the signal fades through the layers (yolo5m's raw maps at 128 px vary
    by 2e-4 about the bias prior, below bf16's step of 3e-2 at the prior's
    -6.7), and a comparison of such maps is blind."""
    import torch
    from sodt_tpu_torch.models.layers import BatchNorm
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        model.train()(img, ir)
    for m in bns:
        m.momentum = 0.97
    return model.eval()


def _main_batch():
    """One batch of the main path (4 synthetic images at 512 px) on the
    card: (img, ir) in [0, 1]."""
    import torch
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    ds = SyntheticVedai(n=MAIN_BATCH, img_size=512, nc=8, seed=1)
    batch = next(make_eval_batches(ds, MAIN_BATCH, 512))
    return (torch.from_numpy(batch["img"]).cuda().float() / 255,
            torch.from_numpy(batch["ir"]).cuda().float() / 255)


def _cnn_row(cfg: str, mode: str, levels: int, img, ir, rel_bound: float,
             f32_bound: float) -> dict:
    """`val --cfg <cfg> --input_mode <mode>` at the main path's arguments:
    every launch counter at 0, finite metrics; then the raw Detect maps of
    one batch on the same weights (perturbed, their BatchNorm statistics
    calibrated on the batch by the f32 model), with their spread: bf16 vs
    f32 plain on the card within `rel_bound`, and f32 on the card vs f32 on
    the CPU within `f32_bound`."""
    import torch
    from sodt_tpu_torch import kernels, val
    t0 = time.perf_counter()
    args = ["--cfg", cfg, "--input_mode", mode] + MAIN_ARGS
    kernels.reset_launches()
    m = val.main(args)
    counts = kernels.launches()
    ref = calibrated(perturbed(seeded_model(cfg, torch.float32,
                                            input_mode=mode),
                               FAMILY_SEED).cuda(), img, ir)
    raws = {}
    for dt, dev in ((torch.bfloat16, "cuda"), (torch.float32, "cuda"),
                    (torch.float32, "cpu")):
        model = seeded_model(cfg, dt, input_mode=mode).to(dev).eval()
        model.load_state_dict(ref.state_dict())
        with torch.no_grad():
            raws[dt, dev] = [r.float().cpu() for r in
                             model(img.to(dev), ir.to(dev))["raw"]]
    a, b = raws[torch.bfloat16, "cuda"], raws[torch.float32, "cuda"]
    cat = lambda rs: torch.cat([r.flatten() for r in rs])
    rel = lambda x, y: ((cat(x) - cat(y)).norm() / cat(y).norm()).item()
    rel_l2 = rel(a, b)
    f32_rel = rel(b, raws[torch.float32, "cpu"])
    shapes = [list(r.shape) for r in a]
    strides = [512 // s[1] for s in shapes]
    good = (counts == NO_LAUNCH and m["seen"] == MAIN_BATCH
            and all(math.isfinite(m[k]) for k in ("map50", "map"))
            and len(a) == levels
            and all(bool(torch.isfinite(r).all()) for r in a)
            and strides == [int(s) for s in model.strides]
            and rel_l2 <= rel_bound and f32_rel <= f32_bound)
    return {"cfg": cfg, "input_mode": mode, "seconds":
            time.perf_counter() - t0, "launches": counts,
            "map50": m["map50"], "speed_ms": m["speed_ms"],
            "raw_shapes": shapes,
            "raw_spread": [map_spread(r) for r in b],
            "detect_rel_l2_bf16_vs_f32": rel_l2, "rel_l2_bound": rel_bound,
            "level_rel_l2_bf16_vs_f32": [
                ((x - y).norm() / y.norm()).item() for x, y in zip(a, b)],
            "detect_rel_l2_f32_card_vs_cpu": f32_rel,
            "f32_rel_l2_bound": f32_bound, "ok": bool(good)}


def phase_families(label: str) -> dict:
    """`_cnn_row` for each of FAMILIES (bounds FAMILY_REL_L2,
    FAMILY_F32_REL_L2)."""
    img, ir = _main_batch()
    rows = [_cnn_row(cfg, mode, levels, img, ir, FAMILY_REL_L2,
                     FAMILY_F32_REL_L2) for cfg, mode, levels in FAMILIES]
    row = {"phase": label, "families": rows,
           "ok": all(r["ok"] for r in rows)}
    emit(row)
    return row


def phase_layers(label: str) -> dict:
    """`_cnn_row` of `every_layer.yaml` (the twelve registry layers that no
    shipped config uses and an Upsample of each resize method; bounds
    LAYERS_REL_L2, LAYERS_F32_REL_L2), with the names it built."""
    from sodt_tpu_torch.models.compiler import parse_config
    img, ir = _main_batch()
    row = _cnn_row(LAYERS_CFG, LAYERS_MODE, 2, img, ir, LAYERS_REL_L2,
                   LAYERS_F32_REL_L2)
    spec = parse_config(LAYERS_CFG, ch_in=3)
    row = {"phase": label, **row,
           "layers": sorted({ld.name for ld in spec.backbone + spec.head}),
           "upsample_methods": [ld.args[1] for ld in spec.head
                                if ld.name == "Upsample"]}
    emit(row)
    return row


@contextlib.contextmanager
def stdout_lines(prefix: str):
    """Within the context, the lines written to stdout that start with
    `prefix` are also collected into the list it yields."""
    real, found = sys.stdout, []

    class Tee:
        def write(self, text):
            found.extend(l for l in text.splitlines() if l.startswith(prefix))
            return real.write(text)

        def __getattr__(self, name):
            return getattr(real, name)

    sys.stdout = Tee()
    try:
        yield found
    finally:
        sys.stdout = real


def phase_autoanchor(label: str, workdir: Path) -> dict:
    """`python -m sodt_tpu_torch.train` in-process at AA_PX on AA_N
    synthetic images (AA_STEPS steps, the flagship on the card): the
    trainer's autoanchor line, and the anchors of its model's Detect and
    decode and of its loss (the trainer's `loss_config`, wrapped here to
    read what it returns) equal to `check_anchors` of the same labels on
    the host, which refits the yaml's here."""
    import numpy as np
    import torch
    import yaml
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.models.compiler import parse_config, resolve_config_path
    from sodt_tpu_torch.train import cli, trainer
    from sodt_tpu_torch.utils.autoanchor import check_anchors

    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = yaml.safe_load(f)
    spec = parse_config("configs/model.yaml", ch_in=4, nc=8)
    a0 = np.asarray(spec.anchors, np.float32).reshape(len(spec.anchors), -1,
                                                      2)
    labels = SyntheticVedai(n=AA_N, img_size=AA_PX, nc=8, seed=0).labels
    new, changed, bpr = check_anchors(
        labels, np.full((AA_N, 2), AA_PX, float), a0, img_size=AA_PX,
        thr=hyp.get("anchor_t", 4.0), seed=0)
    want = tuple(tuple(float(v) for v in lvl.reshape(-1)) for lvl in new)

    seen = {"losses": []}
    real = trainer.loss_config

    def recording(model, hyp_, nc):
        cfg = real(model, hyp_, nc)
        seen["loss_anchors"] = cfg.anchors
        return cfg

    def on_start(state):
        seen["model"] = state.model

    def on_step(state, metrics):
        seen["losses"].append({k: float(v) for k, v in metrics.items()})

    args = AA_ARGS + ["--save-dir", str(workdir / label)]
    trainer.loss_config = recording
    try:
        with stdout_lines("autoanchor") as lines:
            m = cli.main(args, on_step=on_step, on_start=on_start)
    finally:
        trainer.loss_config = real
    model = seen["model"]
    per_level = np.asarray(want, np.float32).reshape(len(want), -1, 2)
    finite = all(math.isfinite(v) for l in seen["losses"] for v in l.values())
    ok = (changed and want != spec.anchors
          and model.spec.anchors == want and model.detect.anchors == want
          and seen.get("loss_anchors") == want
          and np.array_equal(model.anchors_per_level, per_level)
          and next(model.parameters()).is_cuda
          and len(seen["losses"]) == AA_STEPS and m["steps"] == AA_STEPS
          and finite and math.isfinite(m["map50"])
          and lines == [f"autoanchor: BPR {bpr:.4f} -> anchors refit"])
    row = {"phase": label, "args": args, "autoanchor_lines": lines,
           "yaml_anchors": spec.anchors, "refit_on_host": want,
           "bpr_after_refit": bpr, "detect_anchors": model.detect.anchors,
           "loss_anchors": seen.get("loss_anchors"),
           "model_on": str(next(model.parameters()).device),
           "losses": seen["losses"], "ok": bool(ok)}
    emit(row)
    return row


@contextlib.contextmanager
def counting_syncs():
    """Count the host's reads of device values while the context is open
    and `count["on"]`, on the thread that opened it (the training loop's;
    the trainer's checkpoint worker fetches its snapshot on a thread and a
    stream of its own): torch.cuda.synchronize, and on a CUDA tensor
    Tensor.item, float / int / bool of it, Tensor.cpu and Tensor.tolist."""
    import threading
    import torch
    count, patched = {"n": 0, "on": True}, []
    loop = threading.get_ident()

    def wrap(owner, name, cuda_only: bool):
        orig = getattr(owner, name)

        def counted(*a, **k):
            if (count["on"] and threading.get_ident() == loop
                    and (not cuda_only or getattr(a[0], "is_cuda",
                                                  False))):
                count["n"] += 1
            return orig(*a, **k)
        setattr(owner, name, counted)
        patched.append((owner, name, orig))
    for name in ("item", "__float__", "__int__", "__bool__", "cpu",
                 "tolist"):
        wrap(torch.Tensor, name, True)
    wrap(torch.cuda, "synchronize", False)
    try:
        yield count
    finally:
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms for the block (warn_only: the
    cuBLAS workspace variable cannot be set this late in the process)."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _scan_run(flag: str, workdir: Path, hyp_path: Path, tag: str) -> dict:
    """One `train --scan-epoch <flag>` run of SCAN_ARGS: its host syncs
    outside the evals and the checkpoints' blocking parts on the loop's
    thread (their timers are taken out of the training time), the syncs
    between consecutive steps of a chunk, the per-step launch counts, the
    epoch losses and the final state."""
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.train import trainer
    seen = {"at": [], "counts": [], "state": None, "paused_s": 0.0}
    saver = trainer._Saver
    real_eval, real_save = trainer.evaluate, (saver.submit, saver.wait)
    with counting_syncs() as count:
        def paused(fn):
            def run(*a, **k):
                count["on"] = False
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    seen["paused_s"] += time.perf_counter() - t0
                    count["on"] = True
            return run

        def on_step(state, metrics):           # reads no device value
            seen["at"].append(count["n"])
            seen["counts"].append(kernels.launches())
            seen["state"] = state
        trainer.evaluate = paused(real_eval)
        saver.submit, saver.wait = map(paused, real_save)
        kernels.reset_launches()
        try:
            t0 = time.perf_counter()
            m, out = _train_cli(SCAN_ARGS + [
                "--scan-epoch", flag, "--hyp", str(hyp_path), "--save-dir",
                str(workdir / f"scan_{tag}")], on_step=on_step)
            wall = time.perf_counter() - t0
        finally:
            trainer.evaluate = real_eval
            saver.submit, saver.wait = real_save
        syncs = count["n"]
    per_chunk = SCAN_STEPS // SCAN_CHUNKS
    between = [b - a for i, (a, b) in enumerate(zip(seen["at"],
                                                    seen["at"][1:]))
               if (i + 1) % per_chunk]
    return {"m": m, "state": seen["state"], "wall_s": wall,
            "train_s": wall - seen["paused_s"], "syncs": syncs,
            "syncs_between_steps": between,
            "per_step": _per_step(seen["counts"]),
            "epoch_path": "epoch-scan dispatch" in out,
            "losses": m["losses"]}


def phase_scan_epoch(label: str, workdir: Path) -> dict:
    """The epoch path (`--scan-epoch on`: two chunks of 4 steps) against
    the per-step path (`off`: 8 steps) on the same run (SCAN_ARGS), two
    runs of each in SCAN_ORDER: the parameters, BatchNorm statistics and
    EMA after every run bit-equal to the first's; the epoch path's losses
    the all-step means, recomputed here from a hook of its own that reads
    every step's losses (a run of its own: the reads are syncs); the host
    syncs per chunk (per epoch on the per-step path) outside evals and
    checkpoints, and between steps; the seconds of each run, with and
    without its evals and checkpoint writes."""
    import numpy as np
    import torch
    import yaml
    from sodt_tpu_torch.models.compiler import resolve_config_path

    hyp = yaml.safe_load(Path(resolve_config_path(
        "configs/hyp.scratch.yaml")).read_text())
    hyp_path = workdir / "hyp_scan.yaml"
    hyp_path.write_text(yaml.safe_dump(dict(hyp, warmup_iters=4)))
    with deterministic():
        order = [(flag, _scan_run(flag, workdir, hyp_path, f"{flag}{i}"))
                 for i, flag in enumerate(SCAN_ORDER)]
    a = order[0][1]["state"]
    sa, diff = a.model.state_dict(), {}
    for i, (_, r) in enumerate(order[1:], 1):
        b = r["state"]
        sb = b.model.state_dict()
        for k in sa:
            diff[f"run{i}.{k}"] = float((sa[k].float()
                                         - sb[k].float()).abs().max())
        for k in a.ema:
            diff[f"run{i}.ema.{k}"] = float((a.ema[k].float()
                                             - b.ema[k].float()).abs().max())
    worst = max(diff, key=diff.get)
    runs = {flag: r for flag, r in reversed(order)}    # each path's first
    # the all-step means, from a third run whose hook reads each step
    seen = []
    m, _ = _train_cli(SCAN_ARGS + [
        "--scan-epoch", "on", "--hyp", str(hyp_path), "--save-dir",
        str(workdir / "scan_read")],
        on_step=lambda s, mt: seen.append({k: float(v)
                                           for k, v in mt.items()}))
    per_ep = SCAN_STEPS // 2
    means = [{k: float(np.mean(np.array([r[k] for r in
                                         seen[e * per_ep:(e + 1) * per_ep]],
                                        np.float32)))
              for k in seen[0]} for e in range(2)]
    means_ok = m["losses"] == means
    row = {"phase": label, "args": SCAN_ARGS,
           "bit_equal": diff[worst] == 0.0,
           "max_abs_diff": diff[worst], "worst_leaf": worst,
           "leaves": len(diff) // (len(order) - 1),
           "epoch_losses": m["losses"],
           "all_step_means": means, "losses_are_all_step_means": means_ok}
    for flag, name in (("on", "epoch_path"), ("off", "per_step_path")):
        r = runs[flag]
        mine = [o for f, o in order if f == flag]
        row[name] = {
            "epoch_path_taken": r["epoch_path"],
            "wall_s": [o["wall_s"] for o in mine],
            "train_s_without_eval_and_ckpt": [o["train_s"] for o in mine],
            "train_s_mean": sum(o["train_s"] for o in mine) / len(mine),
            "host_syncs": r["syncs"],
            "host_syncs_per_chunk": r["syncs"] / SCAN_CHUNKS,
            "host_syncs_between_steps_of_a_chunk":
                r["syncs_between_steps"],
            "steps": len(r["per_step"]),
            "launches_per_step": r["per_step"][0] if r["per_step"] else {}}
    row["train_s_epoch_over_per_step"] = (
        row["epoch_path"]["train_s_mean"] / row["per_step_path"]["train_s_mean"])
    on, off = runs["on"], runs["off"]
    ok = (row["bit_equal"] and means_ok and on["epoch_path"]
          and not off["epoch_path"] and len(on["per_step"]) == SCAN_STEPS
          and on["per_step"] == off["per_step"]
          and all(on["per_step"][0][k] > 0 for k in (
              "window_attention", "window_attention_bwd",
              "global_attention_bwd", "layernorm"))
          and not any(on["syncs_between_steps"])
          and all(math.isfinite(v) for ep in on["losses"]
                  for v in ep.values()))
    row["launches"] = {k: sum(c[k] for c in on["per_step"])
                       for k in on["per_step"][0]}
    row["ok"] = bool(ok)
    emit(row)
    return row


def phase_remat(label: str) -> dict:
    """One forward + backward of the flagship at 512 px, batch 4, with
    remat and without, from the same seeded weights and batch
    (deterministic algorithms): the gradients of every leaf (bit-equal, or
    the largest difference and its leaf), the peak memory of each above
    what was allocated before it, the launches of each (remat: those
    without it plus REMAT_FORWARD), and the warm time of each by CUDA
    events."""
    import torch
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.train.loss import compute_loss

    model, batch, _, cfg = _train_setup(torch.bfloat16)
    del model
    runs, grads = {}, {}
    for remat in (False, True):
        model = seeded_model("configs/model.yaml", torch.bfloat16,
                             remat=remat).cuda().train()
        names = [k for k, _ in model.named_parameters()]

        def step():
            out = model(batch["img"], batch["ir"])
            total, _ = compute_loss(out["raw"], batch["targets"],
                                    batch["tmask"], cfg)
            return torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launches()
        with deterministic():
            gs = step()
        torch.cuda.synchronize()
        runs[remat] = {"peak_bytes_above_start":
                       torch.cuda.max_memory_allocated() - base,
                       "launches": kernels.launches()}
        grads[remat] = dict(zip(names, gs))
        del gs
        runs[remat]["step_ms"] = time_ms(step, iters=5, warmup=1)
        del model
    diff = {k: float((grads[True][k] - g).abs().max())
            for k, g in grads[False].items()}
    worst = max(diff, key=diff.get)
    plain, rem = runs[False]["launches"], runs[True]["launches"]
    expected = {k: plain[k] + REMAT_FORWARD[k] for k in plain}
    row = {"phase": label, "batch": MAIN_BATCH, "img": 512,
           "bit_equal": diff[worst] == 0.0, "max_abs_diff": diff[worst],
           "worst_leaf": worst, "leaves": len(diff),
           "peak_mib": {("remat" if r else "plain"):
                        runs[r]["peak_bytes_above_start"] / 2**20
                        for r in runs},
           "step_ms": {("remat" if r else "plain"): runs[r]["step_ms"]
                       for r in runs},
           "launches_plain": plain, "launches_remat": rem,
           "expected_remat": expected, "launches": rem}
    row["ok"] = bool(row["bit_equal"] and rem == expected and (
        runs[True]["peak_bytes_above_start"]
        < runs[False]["peak_bytes_above_start"])
        and all(torch.isfinite(g).all() for g in grads[True].values()))
    emit(row)
    return row


def phase_sam(label: str) -> dict:
    """SAM_UPDATES updates of `make_sam_optimizer` on the mono model at
    SAM_PX, batch SAM_BATCH (deterministic algorithms), each held to the
    hand composition: the gradient at p - rho g / |g| through the same
    kernels, then a copy of the base optimizer's update. The launches are
    SAM's own (its two gradients an update), not the hand composition's."""
    import copy
    import torch
    import yaml
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train.loss import compute_loss
    from sodt_tpu_torch.train.sam import make_sam_optimizer
    from sodt_tpu_torch.train.trainer import loss_config, scale_hyp

    model = seeded_model(MONO_CFG, torch.bfloat16,
                         input_mode="RGB").cuda().train()
    hyp = yaml.safe_load(Path(resolve_config_path(
        "configs/hyp.scratch.yaml")).read_text())
    hyp = scale_hyp(dict(hyp, warmup_iters=4), len(model.spec.anchors), 8,
                    SAM_PX)
    cfg = loss_config(model, hyp, 8)
    batch = plain_batch(SyntheticVedai(n=SAM_BATCH, img_size=SAM_PX, nc=8,
                                       seed=0), 0)
    params = dict(model.named_parameters())

    def grads_at(p, i=0):
        with torch.no_grad():
            for k, v in p.items():
                params[k].copy_(v)
        out = model(batch["img"], batch["ir"])
        total, _ = compute_loss(out["raw"], batch["targets"],
                                batch["tmask"], cfg)
        return dict(zip(params, torch.autograd.grad(
            total, list(params.values()))))

    sam = make_sam_optimizer(hyp, params, epochs=1, nb=SAM_UPDATES,
                             rho=SAM_RHO)
    counted = {k: 0 for k in kernels.launches()}
    errs, finite = [], True
    with deterministic():
        for _ in range(SAM_UPDATES):
            p0 = {k: v.detach().clone() for k, v in params.items()}
            base = copy.deepcopy(sam.base)
            kernels.reset_launches()
            g = grads_at(p0)
            ups = sam.update(g, p0, grad_fn=grads_at)
            for k, v in kernels.launches().items():
                counted[k] += v
            norm = torch.sqrt(sum((x.float() ** 2).sum() for x in g.values()))
            adv = {k: p0[k] - SAM_RHO * (g[k] / norm) for k in g}
            want = base.update(grads_at(adv), p0)
            scale = max(float(w.abs().max()) for w in want.values())
            errs.append(max(float((ups[k] - want[k]).abs().max())
                            for k in want) / scale)
            finite = finite and all(torch.isfinite(u).all()
                                    for u in ups.values())
            with torch.no_grad():
                for k, u in ups.items():
                    params[k].copy_(p0[k] + u)
    moved = any(not torch.equal(params[k].detach(), p0[k]) for k in params)
    row = {"phase": label, "img": SAM_PX, "batch": SAM_BATCH, "rho": SAM_RHO,
           "updates": SAM_UPDATES, "max_rel_err_vs_hand": errs,
           "tol": SAM_TOL, "optimizer_steps": sam.base.count,
           "launches": counted}
    row["ok"] = bool(all(e <= SAM_TOL for e in errs) and finite and moved
                     and sam.base.count == SAM_UPDATES
                     and counted["window_attention_bwd"] > 0)
    emit(row)
    return row


def _ddp_setup() -> dict:
    """`_train_setup`'s flagship (bf16), the same weights in an f32 model,
    the batch and the loss configuration."""
    import torch
    from sodt_tpu_torch.models import build_model
    model, batch, hyp, cfg = _train_setup(torch.bfloat16)
    f32 = build_model("configs/model.yaml", ch_in=4,
                      input_mode="RGB+IR").cuda()
    f32.load_state_dict(model.state_dict())
    return {"models": {torch.bfloat16: model, torch.float32: f32},
            "batch": batch, "hyp": hyp, "cfg": cfg}


def _ddp_steps(d: dict, steps: int, shard: bool, dtype=None,
               order=None) -> dict:
    """`steps` steps of `make_train_step` on a fresh copy of the model of
    `_ddp_setup`'s `d` in `dtype` (bf16 by default; 512 px, this rank's
    rows of the batch where `shard`, its rows in `order` where given): the
    metrics, the last step's gradients and launches, the state after
    (parameters and BN statistics, EMA), on the CPU."""
    import copy
    import torch
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.parallel.mesh import shard_batch
    from sodt_tpu_torch.train.optim import make_optimizer
    from sodt_tpu_torch.train.state import TrainState, make_train_step

    model = copy.deepcopy(d["models"][dtype or torch.bfloat16]).train()
    batch = shard_batch(d["batch"]) if shard else d["batch"]
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
    tx = make_optimizer(d["hyp"], dict(model.named_parameters()), epochs=1,
                        nb=steps)
    seen = {}
    step = make_train_step(model, tx, d["cfg"],
                           on_grads=lambda g: seen.update(grads=g))
    state = TrainState.create(model, tx)
    metrics = []
    for _ in range(steps):
        kernels.reset_launches()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}
    return {"metrics": metrics, "launches": kernels.launches(),
            "grads": cpu(seen["grads"]), "sd": cpu(model.state_dict()),
            "ema": cpu(state.ema)}


def ddp_worker(workdir: Path) -> int:
    """One rank of `phase_ddp`'s world of 2 (`chip_smoke.py --ddp-worker
    DIR`): gloo over the file store DIR/store, one bf16 and one f32 step
    on its rows, its results in DIR/rank{r}.pt."""
    import torch
    import torch.distributed as dist
    from sodt_tpu_torch.parallel.mesh import init_from_env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = init_from_env("cuda", backend="gloo",
                         init_method=f"file://{workdir / 'store'}")
    t0 = time.perf_counter()
    out = {"world": mesh.world, "backend": mesh.backend}
    d = _ddp_setup()
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[name] = _ddp_steps(d, 1, shard=True, dtype=dtype)
        del out[name]["ema"]
    out["step_s"] = time.perf_counter() - t0
    torch.save(out, workdir / f"rank{mesh.rank}.pt")
    dist.destroy_process_group()
    return 0


def _bn(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def phase_ddp(label: str, workdir: Path) -> dict:
    """World size 1 over nccl against the plain step (bit-equal, 3
    steps); world size 2 over gloo, two processes on the one card, against
    world size 1 (one step, in bf16 and in f32); every rank's launches
    PER_STEP."""
    import os
    import torch
    import torch.distributed as dist
    from sodt_tpu_torch.parallel.mesh import init_from_env, world_size

    row = {"phase": label, "img": 512, "global_batch": MAIN_BATCH,
           "cards": 1, "more_than_one_card": "not measured (one card)"}
    t0 = time.perf_counter()
    # world size 2 first: its processes start while this one works
    w2 = workdir / "ddp_w2"
    w2.mkdir()
    logs = [open(w2 / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ddp-worker",
         str(w2)], env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                            LOCAL_RANK="0"),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        d = _ddp_setup()
        with deterministic():
            plain = _ddp_steps(d, DDP_STEPS, shard=False)
            env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                mesh = init_from_env("cuda", init_method=f"file://{workdir}/"
                                     "store_w1")
                row["w1_backend"], row["w1_world"] = (mesh.backend,
                                                      world_size())
                one = _ddp_steps(d, DDP_STEPS, shard=True)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        ref = {"bf16": _ddp_steps(d, 1, shard=False),
               "f32": _ddp_steps(d, 1, shard=False, dtype=torch.float32),
               "bf16_reordered": _ddp_steps(d, 1, shard=False,
                                            order=[2, 3, 0, 1])}
        for proc in procs:
            proc.wait(timeout=DDP_TIMEOUT)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for f in logs:
            f.close()
    diff = {f"{part}.{k}": float((one[part][k] - v).abs().max())
            for part in ("sd", "ema") for k, v in plain[part].items()}
    worst = max(diff, key=diff.get)
    row["w1"] = {"steps": DDP_STEPS, "bit_equal": diff[worst] == 0.0
                 and one["metrics"] == plain["metrics"],
                 "max_abs_diff": diff[worst], "worst_leaf": worst,
                 "leaves": len(diff), "losses": [m["loss"] for m in
                                                 one["metrics"]],
                 "launches_per_step": one["launches"]}
    for r, proc in enumerate(procs):
        if proc.returncode:
            print((w2 / f"rank{r}.log").read_text()[-6000:], file=sys.stderr)
            raise RuntimeError(f"ddp rank {r} exited {proc.returncode}")
    ranks = [torch.load(w2 / f"rank{r}.pt") for r in range(2)]
    w2row = {"backend": ranks[0]["backend"], "world": ranks[0]["world"],
             "rank_s": [r["step_s"] for r in ranks],
             "launches_rank0": ranks[0]["bf16"]["launches"],
             "launches_rank1": ranks[1]["bf16"]["launches"],
             "tol": {"f32": DDP_F32_TOL, "bf16": DDP_BF16_TOL}}
    for name in ("bf16", "f32"):
        got, want = ranks[0][name], ref[name]
        gl, wl = got["metrics"][0]["loss"], want["metrics"][0]["loss"]
        w2row[name] = {
            "loss": gl, "loss_w1": wl, "loss_rel_err": abs(gl - wl) / abs(wl),
            "grad_rel_l2": _grad_diff(got["grads"],
                                      want["grads"])["rel_l2_all"],
            "grad_rel_l2_vs_f32_w1": _grad_diff(
                got["grads"], ref["f32"]["grads"])["rel_l2_all"],
            "bn_rel_l2": _grad_diff(_bn(got["sd"]),
                                    _bn(want["sd"]))["rel_l2_all"],
            "ranks_same_metrics": got["metrics"] == ranks[1][name]["metrics"],
            "ranks_same_grads": all(torch.equal(v, ranks[1][name]["grads"][k])
                                    for k, v in got["grads"].items()),
            "ranks_same_bn": all(torch.equal(v, ranks[1][name]["sd"][k])
                                 for k, v in _bn(got["sd"]).items())}
    # bf16's own spread: world size 1 against f32, and against itself with
    # the batch's images in another order (the same sum)
    w2row["bf16_w1_vs_f32_w1_grad_rel_l2"] = _grad_diff(
        ref["bf16"]["grads"], ref["f32"]["grads"])["rel_l2_all"]
    w2row["bf16_w1_reordered_grad_rel_l2"] = _grad_diff(
        ref["bf16_reordered"]["grads"], ref["bf16"]["grads"])["rel_l2_all"]
    row["w2"] = w2row
    row["seconds"] = time.perf_counter() - t0
    want_launches = {k: v for k, v in PER_STEP.items() if v}
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    row["launches"] = ranks[0]["bf16"]["launches"]
    row["ok"] = bool(
        row["w1"]["bit_equal"] and row["w1_backend"] == "nccl"
        and row["w1_world"] == 1
        and nonzero(one["launches"]) == want_launches
        and w2row["backend"] == "gloo" and w2row["world"] == 2
        and w2row["f32"]["loss_rel_err"] <= DDP_F32_TOL["loss"]
        and w2row["f32"]["grad_rel_l2"] <= DDP_F32_TOL["grads"]
        and w2row["f32"]["bn_rel_l2"] <= DDP_F32_TOL["bn"]
        and w2row["bf16"]["loss_rel_err"] <= DDP_BF16_TOL["loss"]
        and (w2row["bf16"]["grad_rel_l2_vs_f32_w1"]
             <= DDP_BF16_TOL["grads_vs_f32"])
        and w2row["bf16"]["bn_rel_l2"] <= DDP_BF16_TOL["bn"]
        and all(w2row[n]["ranks_same_metrics"]
                and w2row[n]["ranks_same_grads"]
                and w2row[n]["ranks_same_bn"]
                and math.isfinite(w2row[n]["loss"]) for n in ("bf16", "f32"))
        and all(nonzero(r["bf16"]["launches"]) == want_launches
                for r in ranks))
    emit(row)
    return row


def phase_evolve(label: str, workdir: Path) -> dict:
    """`train --evolve 2` (EVOLVE_ARGS): evolve.txt two rows of 28
    numbers, hyp_evolved.yaml and hyp_gen{0,1}.yaml written, the first
    generation's hyperparameters equal to `mutate` on the host from the
    same seed."""
    import numpy as np
    import yaml
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train.evolve import mutate

    hyp = yaml.safe_load(Path(resolve_config_path(
        "configs/hyp.scratch.yaml")).read_text())
    base = dict(hyp, warmup_iters=4)
    hyp_path = workdir / "hyp_evolve.yaml"
    hyp_path.write_text(yaml.safe_dump(base))
    out_dir = workdir / label
    kernels.reset_launches()
    m, _ = _train_cli(EVOLVE_ARGS + ["--hyp", str(hyp_path), "--save-dir",
                                     str(out_dir)])
    counts = kernels.launches()
    seed = int(EVOLVE_ARGS[EVOLVE_ARGS.index("--seed") + 1])
    first = mutate(base, out_dir / "none.txt", np.random.default_rng(seed))
    rows = np.loadtxt(out_dir / "evolve.txt", ndmin=2)
    gen0 = yaml.safe_load((out_dir / "hyp_gen0.yaml").read_text())
    files = sorted(p.name for p in out_dir.iterdir())
    row = {"phase": label, "args": EVOLVE_ARGS, "evolve_txt": rows.tolist(),
           "files": files, "best_fitness": m["best_fitness"],
           "first_mutation_equals_host": gen0 == first, "launches": counts}
    row["ok"] = bool(rows.shape == (2, 28) and gen0 == first and all(
        f in files for f in ("hyp_evolved.yaml", "hyp_gen0.yaml",
                             "hyp_gen1.yaml", "gen0", "gen1"))
        and counts["window_attention_bwd"] > 0)
    emit(row)
    return row


def phase_run_logs(label: str, workdir: Path) -> dict:
    """The run's record on the card: a short run's events.jsonl keys
    (LOG_KEYS); `val --plots` and `detect --save-img` write their plots,
    or, without matplotlib, say on one line that they wrote none;
    `model_info` of the flagship (its parameters equal to the count from
    named_parameters; FLOPs from the plain versions on the CPU) and
    `time_fn` of its bf16 eval forward by CUDA events."""
    import numpy as np
    import torch
    from sodt_tpu_torch import detect, val
    from sodt_tpu_torch.data.png import write_png
    from sodt_tpu_torch.utils.plots import missing_reason
    from sodt_tpu_torch.utils.profiler import model_info, time_fn

    run = workdir / label
    _train_cli(LOG_ARGS + ["--save-dir", str(run)])
    events = [json.loads(l) for l in (run / "events.jsonl").open()]
    keys = set().union(*events) - {"t", "step"}
    row = {"phase": label, "events": len(events), "keys": sorted(keys),
           "missing_keys": sorted(LOG_KEYS - keys),
           "matplotlib": missing_reason() or "installed"}
    with stdout_lines("--") as said:
        val.main(["--plots", "--synthetic", "--synthetic-n", "4",
                  "--img-size", "256", "--batch-size", "4", "--save-dir",
                  str(run / "val")])
        write_png(run / "img.png", np.full((200, 300, 3), 90, np.uint8))
        detect.main(["--source", str(run / "img.png"), "--img-size", "256",
                     "--input_mode", "RGB+IR", "--save-img", "--save-dir",
                     str(run / "detect")])
    row["lines"] = said
    if missing_reason():
        plots_ok = (any(l.startswith("--plots: no plot written") for l in said)
                    and any(l.startswith("--save-img: no image written")
                            for l in said))
    else:
        plots_ok = ((run / "val" / "confusion_matrix.png").exists()
                    and (run / "detect" / "img.png").exists())
    model = seeded_model("configs/model.yaml", torch.bfloat16).cuda().eval()
    info = model_info(model, img_size=256)
    x = torch.rand(MAIN_BATCH, 512, 512, 3, device="cuda")
    with torch.no_grad():
        t = time_fn(model, x, x, iters=10, warmup=2)
    n = sum(p.numel() for _, p in model.named_parameters())
    row.update(plots_ok=plots_ok, model_info_256px=info,
               params_named=n, forward_bf16_512px_batch4=t)
    row["ok"] = bool(not row["missing_keys"] and plots_ok
                     and info["params"] == n and t["timer"] == "cuda_events"
                     and t["seconds"] > 0)
    emit(row)
    return row


def _sr_step_pair() -> dict:
    """One batch of 1024 px originals and one set of seeded weights: the
    SR output of the training-mode forward at 512 px and the first step's
    loss parts, bf16 against the f32 plain model."""
    import copy
    import torch
    import yaml
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.ops.resize import resize_bilinear
    from sodt_tpu_torch.train.optim import make_optimizer
    from sodt_tpu_torch.train.state import TrainState, make_train_step
    from sodt_tpu_torch.train.trainer import loss_config, scale_hyp

    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = scale_hyp(dict(yaml.safe_load(f), warmup_iters=4), 1, 8,
                        SR_RAW)
    batch = plain_batch(SyntheticVedai(n=MAIN_BATCH, img_size=SR_RAW, nc=8,
                                       seed=0), 0)
    half = (SR_RAW // 2, SR_RAW // 2)
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        model = seeded_model(SR_CFG, dt, input_mode=SR_MODE, sr=True,
                             factor=2).cuda()
        with torch.no_grad():      # a copy: training mode moves BN stats
            sr = copy.deepcopy(model).train()(
                resize_bilinear(batch["img"], half),
                resize_bilinear(batch["ir"], half))["sr"].float()
        tx = make_optimizer(hyp, dict(model.named_parameters()), epochs=1,
                            nb=1)
        step = make_train_step(model, tx, loss_config(model, hyp, 8),
                               sr=True, down_factor=2)
        _, met = step(TrainState.create(model, tx), batch)
        got[dt] = (sr, {k: float(v) for k, v in met.items()})
    (a, pa), (b, pb) = got[torch.bfloat16], got[torch.float32]
    parts = {k: abs(pa[k] - pb[k]) / max(abs(pb[k]), 1e-12) for k in pb}
    return {"sr_shape": list(a.shape),
            "sr_rel_l2_bf16_vs_f32": ((a - b).norm() / b.norm()).item(),
            "sr_spread": float(b.std()), "parts_f32": pb, "parts_bf16": pa,
            "parts_rel_diff": parts,
            "ok": (list(a.shape) == [MAIN_BATCH, SR_RAW, SR_RAW, 4]
                   and bool(torch.isfinite(a).all())
                   and ((a - b).norm() / b.norm()).item() <= SR_OUT_REL_L2
                   and all(v <= SR_PART_REL for v in parts.values()))}


def phase_sr_train(label: str, workdir: Path) -> dict:
    """`train --super --factor 2 --down-factor 2` on SRyolo_MF (SR_TRAIN_*):
    every counter 0, finite losses and sr > 0 on every step; then
    `_sr_step_pair`."""
    import yaml
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.models.compiler import resolve_config_path

    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = yaml.safe_load(f)
    hyp_path = workdir / "hyp_sr.yaml"
    hyp_path.write_text(yaml.safe_dump(dict(hyp, warmup_iters=4)))
    seen, hooks = _step_recorder()
    kernels.reset_launches()
    t0 = time.perf_counter()
    m, _ = _train_cli(SR_TRAIN_ARGS + ["--hyp", str(hyp_path), "--save-dir",
                                       str(workdir / label)], **hooks)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    pair = _sr_step_pair()
    losses = seen["losses"]
    ok = (counts == NO_LAUNCH and m["steps"] == SR_TRAIN_STEPS
          and len(losses) == SR_TRAIN_STEPS
          and all(math.isfinite(v) for l in losses for v in l.values())
          and all(l["sr"] > 0 for l in losses)
          and seen["sizes"] == [SR_RAW // 2] * SR_TRAIN_STEPS
          and math.isfinite(m["map50"]) and pair["ok"])
    row = {"phase": label, "args": SR_TRAIN_ARGS, "wall_s": wall,
           "losses": losses, "model_input_px": seen["sizes"],
           "launches": counts, "map50": m["map50"], **pair,
           "bounds": {"parts_rel": SR_PART_REL, "sr_rel_l2": SR_OUT_REL_L2},
           "ok": bool(ok)}
    emit(row)
    return row


def trained_weights() -> tuple[str, dict]:
    """The committed .npz of the trained flagship and its sidecar, after
    the file's sha256 is held to the sidecar's."""
    import hashlib
    npz = Path(TRAINED_NPZ)
    side = json.loads(npz.with_suffix(".json").read_text())
    digest = hashlib.sha256(npz.read_bytes()).hexdigest()
    if digest != side["sha256"]:
        raise RuntimeError(f"{npz}: sha256 {digest} is not the sidecar's "
                           f"{side['sha256']}")
    return str(npz), side


def phase_trained(label: str) -> dict:
    """The trained flagship on the card: `val --weights` the committed
    .npz at 512 px, batch 4, on SyntheticVedai(n=16, seed=1) in bf16 (the
    kernels), on the f32 plain path (--no-bf16) and in int8 serving
    (--int8), each with the launch counts set to 0 just before and read
    just after; mAP@0.5 and mAP beside JAX's f32 values from the sidecar,
    and bf16's beside JAX's bf16 values (its compose path on the CPU); the
    raw Detect maps of one batch, bf16 against f32. int8's gap to bf16 is
    its cost in mAP."""
    import torch
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias

    npz, side = trained_weights()
    ref, ref16 = side["jax_f32_eval"], side["jax_bf16_eval"]
    runs, ok = {}, True
    for tag, extra, expected in (
            ("bf16", [], PER_FORWARD),
            ("f32", ["--no-bf16"], {k: 0 for k in PER_FORWARD}),
            ("int8", ["--int8"], INT8_FORWARD)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = val.main(extra + TRAINED_ARGS)
        wall = time.perf_counter() - t0
        per_fwd = {k: v / TRAINED_FORWARDS
                   for k, v in kernels.launches().items()}
        runs[tag] = {k: m[k] for k in ("map50", "map", "mp", "mr", "seen",
                                       "images_per_s", "speed_ms")}
        runs[tag].update(wall_s=wall, launches_per_forward=per_fwd)
        ok = ok and (per_fwd == {k: float(v) for k, v in expected.items()}
                     and m["seen"] == 16
                     and all(math.isfinite(m[k]) for k in ("map50", "map")))

    ds = SyntheticVedai(n=16, img_size=512, nc=8, seed=1)
    batch = next(make_eval_batches(ds, MAIN_BATCH, 512))
    img = torch.from_numpy(batch["img"]).cuda().float() / 255
    ir = torch.from_numpy(batch["ir"]).cuda().float() / 255
    sd, raws = load_weights(npz), {}
    for dt in (torch.bfloat16, torch.float32):
        model = build_model("configs/model.yaml", ch_in=4, dtype=dt)
        model.load_state_dict(sd)
        model = cache_rel_bias(model.cuda().eval())
        with torch.no_grad():
            raws[dt] = model(img, ir)["raw"][0].float()
    a, b = raws[torch.bfloat16], raws[torch.float32]
    rel_l2 = ((a - b).norm() / b.norm()).item()
    gaps = {tag: runs[tag]["map50"] - ref["map50"] for tag in runs}
    map_gaps = {tag: runs[tag]["map"] - ref["map"] for tag in runs}
    ok = ok and (abs(gaps["bf16"]) <= TRAINED_BF16_TOL
                 and abs(gaps["f32"]) <= TRAINED_F32_TOL
                 and runs["int8"]["map50"]
                 >= TRAINED_INT8_FRACTION * runs["bf16"]["map50"]
                 and all(abs(map_gaps[t]) <= TRAINED_MAP_TOL[t] for t in runs)
                 and abs(runs["bf16"]["map50"] - ref16["map50"])
                 <= TRAINED_BF16_TOL
                 and abs(runs["bf16"]["map"] - ref16["map"])
                 <= TRAINED_MAP_TOL["bf16"]
                 and bool(torch.isfinite(a).all()))
    row = {"phase": label, "args": TRAINED_ARGS, "npz_sha256": side["sha256"],
           "jax_f32": {"map50": ref["map50"], "map": ref["map"]},
           "jax_bf16": {"map50": ref16["map50"], "map": ref16["map"]},
           "bf16_minus_jax_bf16": {k: runs["bf16"][k] - ref16[k]
                                   for k in ("map50", "map")},
           "runs": runs, "map50_minus_jax_f32": gaps,
           "map_minus_jax_f32": map_gaps,
           "int8_cost": {k: runs["bf16"][k] - runs["int8"][k]
                         for k in ("map50", "map")},
           "detect_rel_l2_bf16_vs_f32": rel_l2,
           "bounds": {"bf16": TRAINED_BF16_TOL, "f32": TRAINED_F32_TOL,
                      "int8_fraction_of_bf16": TRAINED_INT8_FRACTION,
                      "map": TRAINED_MAP_TOL},
           "ok": bool(ok)}
    emit(row)
    return row


def _ab_run(fn, way: str, label: str, iters: int) -> dict:
    """One way of the kernel A/B: `fn` once warm, then the launches of one
    call, its CUDA-event ms and its device-busy ms (torch.profiler, the
    CUDA activity alone); the counters are read again after the timing
    (inside `no_kernels()` nothing may have moved)."""
    import torch
    from sodt_tpu_torch import kernels
    fn()
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    one = kernels.launches()
    ms = time_ms(fn, iters=iters, warmup=0)
    busy = device_ms(fn, f"{label} {way}", iters=iters, cuda_only=True)
    return {"out": out, "launches": one, "after_timing": kernels.launches(),
            "ms": ms, "device_busy_ms": busy}


def _profile_eval_tool(workdir: Path) -> subprocess.Popen:
    """`python -m sodt_tpu_torch.tools.profile_eval` as a user runs it, at
    the paths' batch, started in the background (SODT_NO_KERNELS unset)."""
    env = {k: v for k, v in os.environ.items() if k != "SODT_NO_KERNELS"}
    return subprocess.Popen(
        [sys.executable, "-m", "sodt_tpu_torch.tools.profile_eval",
         "--batch", str(MAIN_BATCH), "--iters", "2", "--out",
         str(workdir / "profile")], cwd=Path(__file__).resolve().parent,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_reference_io(label: str, workdir: Path, trained: dict | None
                       ) -> dict:
    """The reference-checkpoint tools and the kernel switch on the card
    (module doc, `reference_io`). profile_eval's subprocess runs beside
    (a), (b) and the A/B's set-up, and is waited for before the A/B is
    timed: its own timings are taken on a shared card and are not kept."""
    import torch
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.tools import export_torch, import_torch, parity_check
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.train.loss import compute_loss
    from sodt_tpu_torch.weights import load_npz

    npz, side = trained_weights()
    wd = workdir / label
    wd.mkdir(parents=True, exist_ok=True)
    row, ok, t0 = {"phase": label}, True, time.perf_counter()
    proc = _profile_eval_tool(wd)
    try:
        # (a) export to a plain reference state_dict, import it back
        pt, back = wd / "reference.pt", wd / "imported.npz"
        with stdout_lines("round-trip") as said:
            exp = export_torch.main(["--weights", npz, "--out", str(pt),
                                     "--no-module"])
        imp = import_torch.main([str(pt), "--out", str(back)])
        src, got = load_weights(npz), load_npz(back)
        same = sorted(src) == sorted(got) and all(
            torch.equal(src[k], got[k]) for k in src)
        row["round_trip"] = {"export": said, "reference_keys":
                             exp["reference_keys"], "arrays": len(got),
                             "sidecar_arrays": side["arrays"],
                             "bit_equal": same,
                             "seconds": time.perf_counter() - t0}
        ok = ok and same and exp["arrays"] == imp["arrays"] == side["arrays"]

        # (b) parity_check on that .pt: trained's protocol and numbers
        t1 = time.perf_counter()
        metrics, run_map = [], val.run_map

        def recorded(a, size):
            metrics.append(run_map(a, size))
            return metrics[-1]
        val.run_map = recorded
        try:
            kernels.reset_launches()
            pc = parity_check.run(
                str(pt), "configs/model.yaml", "configs/data_vedai.yaml",
                img_size=512, batch_size=MAIN_BATCH, synthetic=True,
                synthetic_n=16, ref_map50=side["jax_f32_eval"]["map50"],
                save_dir=str(wd / "parity"))
            launched = kernels.launches()
        finally:
            val.run_map = run_map
        bf16 = (trained or {}).get("runs", {}).get("bf16", {})
        m = metrics[-1]
        per = {k: v * TRAINED_FORWARDS for k, v in PER_FORWARD.items()}
        row["parity_check"] = {
            **pc, "map50_unrounded": m["map50"], "map_unrounded": m["map"],
            "trained_bf16": {k: bf16.get(k) for k in ("map50", "map")},
            "launches": launched, "expected_launches": per,
            "seconds": time.perf_counter() - t1}
        ok = ok and (pc["pass"] is True and m["map50"] == bf16.get("map50")
                     and m["map"] == bf16.get("map") and launched == per)

        # (c) the A/B of the kernels against JAX's composition
        t1 = time.perf_counter()
        ds = SyntheticVedai(n=16, img_size=512, nc=8, seed=1)
        batch = next(make_eval_batches(ds, MAIN_BATCH, 512))
        img = torch.from_numpy(batch["img"]).cuda().float() / 255
        ir = torch.from_numpy(batch["ir"]).cuda().float() / 255
        model = build_model("configs/model.yaml", ch_in=4,
                            dtype=torch.bfloat16)
        model.load_state_dict(load_weights(npz))
        model = cache_rel_bias(model.cuda().eval())
        tmodel, tb, _, cfg = _train_setup(torch.bfloat16)
        params = list(tmodel.parameters())
        setup_s = time.perf_counter() - t1
    finally:
        try:
            out, err = proc.communicate(timeout=PROFILE_EVAL_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()

    def step():
        o = tmodel(tb["img"], tb["ir"])
        total, _ = compute_loss(o["raw"], tb["targets"], tb["tmask"], cfg)
        return torch.autograd.grad(total, params)

    t2 = time.perf_counter()
    ab, secs = {}, {}
    none = {k: 0 for k in PER_FORWARD}
    for way in ("kernels", "composition"):
        ctx = (kernels.no_kernels() if way == "composition"
               else contextlib.nullcontext())
        t3 = time.perf_counter()
        with ctx:
            with torch.no_grad():
                f = _ab_run(lambda: model(img, ir)["raw"][0], way,
                            f"{label} forward", 5)
            s = _ab_run(step, way, f"{label} step", 3)
        secs[way] = time.perf_counter() - t3
        raw = f.pop("out").float()
        s.pop("out")
        ab[way] = {"forward": f, "step": s, "raw": raw}
        if way == "kernels":
            ok = (ok and f["launches"] == PER_FORWARD
                  and s["launches"] == PER_STEP)
        else:
            ok = ok and all(r[k] == none for r in (f, s)
                            for k in ("launches", "after_timing"))
    ref, comp = ab["kernels"].pop("raw"), ab["composition"].pop("raw")
    gap = ((comp - ref).abs().max() / ref.abs().max()).item()
    for way in ab:
        for part in ab[way].values():
            part.pop("after_timing")
    row["ab"] = {**ab, "detect_max_rel": gap, "bound": REF_IO_MAP_TOL,
                 "composition_over_kernels": {
                     part: {k: ab["composition"][part][k]
                            / ab["kernels"][part][k]
                            for k in ("ms", "device_busy_ms")}
                     for part in ("forward", "step")},
                 "seconds": {"setup": setup_s, "waited_for_profile_eval":
                             t2 - t1 - setup_s, **secs}}
    ok = ok and gap <= REF_IO_MAP_TOL and bool(torch.isfinite(comp).all())
    del model, tmodel, params

    # (d) the trace tool's result
    lines = out.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        res = {}
    names = [c["name"] for c in res.get("categories", [])]
    row["profile_eval"] = {
        "rc": proc.returncode, "device_ms_per_iter":
        res.get("device_ms_per_iter"), "sessions": res.get("sessions"),
        "categories": [(c["name"], c["share"])
                       for c in res.get("categories", [])[:12]],
        "bodies_named": {b: b in names for b in PROFILE_EVAL_BODIES}}
    if proc.returncode:
        row["profile_eval"]["stderr"] = err[-2000:]
    ok = ok and proc.returncode == 0 and all(b in names
                                             for b in PROFILE_EVAL_BODIES)
    row.update(launches=launched, seconds=time.perf_counter() - t0,
               ok=bool(ok))
    emit(row)
    return row


def _train_cli(args: list[str], **hooks) -> tuple[dict, str]:
    """`sodt_tpu_torch.train` in-process; its printed lines are passed on
    and returned."""
    import io
    from sodt_tpu_torch.train import cli
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            m = cli.main(args, **hooks)
    finally:
        sys.stdout.write(buf.getvalue())
    return m, buf.getvalue()


def _step_recorder():
    """Hooks that keep each step's launch counts and losses (on_step) and
    the image size of each training forward (on_start: a forward pre-hook
    on the model, which the EMA model of the evals copies but leaves in
    eval mode)."""
    from sodt_tpu_torch import kernels
    seen = {"counts": [], "losses": [], "sizes": []}

    def on_step(state, metrics):
        seen["counts"].append(kernels.launches())
        seen["losses"].append({k: float(v) for k, v in metrics.items()})

    def size(module, args):
        if module.training:
            seen["sizes"].append(int(args[0].shape[1]))

    def on_start(state):
        state.model.register_forward_pre_hook(size)
    return seen, {"on_step": on_step, "on_start": on_start}


def _per_step(counts: list[dict]) -> list[dict]:
    zero = {k: 0 for k in counts[0]} if counts else {}
    return [{k: c[k] - p[k] for k in c}
            for p, c in zip([zero] + counts, counts)]


def _distinct_scale_seed() -> tuple[int, list[int]]:
    """The first seed whose multi-scale stream draws the three buckets in
    its first three steps, and the sizes it should give at 512 px (the run
    is held to the sizes its forwards saw)."""
    import inspect
    import numpy as np
    from sodt_tpu_torch.data.loader import make_train_batches
    buckets = inspect.signature(make_train_batches).parameters[
        "multi_scale_buckets"].default
    for seed in range(100):
        rng = np.random.default_rng(seed)
        draws = [int(rng.integers(len(buckets))) for _ in range(3)]
        if len(set(draws)) == 3:
            return seed, [int(round(512 * buckets[d] / 32) * 32)
                          for d in draws]
    raise RuntimeError("no seed draws three distinct buckets")


def _state_equals(state, ckpt: dict) -> bool:
    """The TrainState equals the checkpoint bit for bit: parameters and
    BatchNorm statistics, EMA, optimizer state, step, EMA counter."""
    import torch
    eq = lambda a, b: torch.equal(a.detach().cpu(), b)
    sd, opt = state.model.state_dict(), state.tx.state_dict()
    same = lambda got, want: (
        (got is None) == (want is None)
        and set(got or {}) == set(want or {})
        and all(eq(got[k], v) for k, v in (want or {}).items()))
    return (same(sd, ckpt["model"]) and same(state.ema, ckpt["ema"])
            and all(same(opt[k], ckpt["opt_state"][k])
                    for k in ("acc", "trace", "nu"))
            and (opt["count"], opt["ni"]) == (ckpt["opt_state"]["count"],
                                              ckpt["opt_state"]["ni"])
            and state.step == ckpt["step"]
            and state.ema_updates == ckpt["ema_updates"])


def _aug_card_vs_cpu(hyp: dict) -> dict:
    """One augmented batch of the bank feed made on the card against the
    same tiles and draws augmented on the CPU."""
    import torch
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.data.loader import BankFeed
    ds = SyntheticVedai(n=16, img_size=512, nc=8, seed=0)
    gpu = BankFeed(ds, MAIN_BATCH, 512, hyp, seed=3, device="cuda")
    cpu = BankFeed(ds, MAIN_BATCH, 512, hyp, seed=3, device="cpu")
    prim, sec, draws = gpu.step_schedule()
    a = {k: v.cpu() for k, v in gpu.augment(prim, sec, draws).items()}
    b = cpu.augment(prim, sec, draws)
    img = max((a[k] - b[k]).abs().max().item() * 255 for k in ("img", "ir"))
    lab = ((a["targets"][..., 1:] - b["targets"][..., 1:]).abs().max().item()
           * 512)
    same = (torch.equal(a["tmask"], b["tmask"])
            and torch.equal(a["targets"][..., 0], b["targets"][..., 0]))
    return {"img_max_abs_diff_0_255": img, "labels_max_abs_diff_px": lab,
            "masks_and_classes_equal": bool(same),
            "boxes_kept": int(b["tmask"].sum()),
            "ok": bool(img <= AUG_IMG_TOL and lab <= AUG_LABEL_TOL and same)}


def _aug_stages(feed, timer) -> dict:
    """Time of each stage of one mosaic pass of `augment_batch` on one
    step's tiles and draws from `feed` (a BankFeed): the bank gather, the
    mosaic paste, the perspective warp (its sampler and the labels), HSV,
    the flips (fed the warped pixel labels: the values do not change their
    work). `timer(fn, label)` gives the ms of a call of fn. Mixup repeats
    the first three for its second mosaic."""
    import torch
    from sodt_tpu_torch.data.augment import (PerspectiveParams, draw_cols,
                                             flips, hsv_apply, mosaic4,
                                             random_perspective)
    from sodt_tpu_torch.ops.boxes import xywhn2xyxy
    s, dev = feed.img_size, feed.device
    prim, _, draws = feed.step_schedule()
    p = torch.from_numpy(prim).to(dev)
    d = torch.from_numpy(draws).to(dev)
    rgb, ir, lab, msk = feed.banks
    persp = PerspectiveParams.from_hyp(feed.hyp)
    r4, i4, l4, k4 = rgb[p], ir[p], lab[p], msk[p]
    lab_px = xywhn2xyxy(l4[..., 1:5], s, s)
    mos = mosaic4(r4, i4, lab_px, k4, draw_cols(d, "center_a"), s)
    warped = random_perspective(*mos, draw_cols(d, "warp_a"), persp, (s, s))
    img = hsv_apply(warped[0], draw_cols(d, "hsv"))
    cls = l4[..., 0].reshape(len(prim), -1)
    targets = torch.cat([cls[..., None], warped[2]], -1)
    ud, lr = (draw_cols(d, "flip") > 0).unbind(1)
    stages = {
        "bank_gather": lambda: (rgb[p], ir[p], lab[p], msk[p]),
        "mosaic": lambda: mosaic4(r4, i4, lab_px, k4,
                                  draw_cols(d, "center_a"), s),
        "perspective": lambda: random_perspective(
            *mos, draw_cols(d, "warp_a"), persp, (s, s)),
        "hsv": lambda: hsv_apply(warped[0], draw_cols(d, "hsv")),
        "flips": lambda: flips(img, warped[1], targets, warped[3], ud, lr)}
    return {k: timer(fn, f"train_aug stage {k}") for k, fn in stages.items()}


def _aug_profile(hyp_path: Path, hyp: dict) -> dict:
    """Device time of the feed's kernels for one step (torch.profiler over
    `augment_step`) with its AUG_TOP largest kernels and its stages
    (`_aug_stages`), one training step's, and the idle share of the two
    together against their CUDA-event time, warm, from the trained
    weights."""
    import torch
    import yaml
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.data.loader import BankFeed
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.train.optim import make_optimizer
    from sodt_tpu_torch.train.state import TrainState, make_train_step
    from sodt_tpu_torch.train.trainer import loss_config, scale_hyp

    model = build_model("configs/model.yaml", ch_in=4, dtype=torch.bfloat16)
    model.load_state_dict(load_weights(TRAINED_NPZ))
    model = model.cuda().train()
    base = yaml.safe_load(hyp_path.read_text())
    h = scale_hyp(dict(base, **hyp), len(model.spec.anchors), 8, 512)
    tx = make_optimizer(h, dict(model.named_parameters()), epochs=1, nb=4)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, loss_config(model, h, 8))
    feed = BankFeed(SyntheticVedai(n=16, img_size=512, nc=8, seed=0),
                    MAIN_BATCH, 512, h, seed=0, device="cuda")
    both = lambda: step(state, feed.augment_step())
    for _ in range(2):
        both()
    aug_ms, split = device_split(feed.augment_step, "train_aug feed",
                                 iters=3)
    batch = feed.augment_step()
    step_dev = device_ms(lambda: step(state, batch), "train_aug step",
                         iters=3)
    wall_ms = time_ms(both, iters=5, warmup=1)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:AUG_TOP]
    return {"augment_device_ms": aug_ms, "train_step_device_ms": step_dev,
            "augment_top_kernels_ms": [{"kernel": k, "ms": v}
                                       for k, v in top],
            "augment_kernels": len(split),
            "stage_device_ms": _aug_stages(
                feed, lambda fn, label: device_ms(fn, label, iters=3)),
            "augment_plus_step_ms": wall_ms,
            "augment_share_of_device": aug_ms / (aug_ms + step_dev),
            "idle_share": max(0.0, 1 - (aug_ms + step_dev) / wall_ms)}


def phase_train_aug(label: str, workdir: Path) -> dict:
    """The augmented training feed from the trained weights, through
    `sodt_tpu_torch.train` (--weights the .npz; the counts set to 0 just
    before each run and read just after):
      1. 2 epochs (8 steps), --save-dir, --save-period 1;
      2. --resume last.pt for one more epoch (opt.yaml's epochs raised to
         3, as a user extends a run: --resume reloads the run's opt.yaml),
         the restored state held to the saved one bit for bit first;
      3. 2 steps with the gather warp, mixup and the mosaic gate on;
      4. 3 steps of --multi-scale, one at each of 384, 512 and 640 px
         (a seed whose bucket stream draws all three), launches per step
         and per eval forward at each size;
      5. 1 epoch of --image-weights.
    Then the feed's device time per step beside a training step's, the
    idle share, and the card's augmented batch against the CPU's."""
    import re
    import torch
    import yaml
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train.checkpoint import load_checkpoint, load_weights

    trained_weights()
    hyp_path = Path(resolve_config_path("configs/hyp.scratch.yaml"))
    hyp_file = yaml.safe_load(hyp_path.read_text())
    gather_path = workdir / "hyp_gather.yaml"
    gather_path.write_text(yaml.safe_dump(dict(hyp_file, **AUG_GATHER_HYP)))
    total = lambda steps, evals: {k: steps * PER_STEP[k]
                                  + evals * PER_FORWARD[k] for k in PER_STEP}
    row, ok = {"phase": label}, True

    def run(tag, args, steps, evals, on_start=None):
        nonlocal ok
        seen, hooks = _step_recorder()
        if on_start is not None:
            record = hooks["on_start"]
            hooks["on_start"] = lambda st: (on_start(st), record(st))
        kernels.reset_launches()
        t0 = time.perf_counter()
        m, out = _train_cli(AUG_ARGS + args, **hooks)
        counts = kernels.launches()
        losses = seen["losses"]
        finite = all(math.isfinite(v) for l in losses for v in l.values())
        r = {"args": args, "wall_s": time.perf_counter() - t0,
             "steps": len(losses), "losses": losses, "finite": finite,
             "map50": m["map50"], "launches": counts,
             "launches_ok": counts == total(steps, evals)}
        ok = ok and finite and r["launches_ok"] and len(losses) == steps
        row[tag] = r
        return m, out, seen

    d = workdir / "aug"
    _, out, _ = run("epochs2", ["--synthetic-n", "16", "--epochs", "2",
                                "--save-dir", str(d), "--save-period", "1"],
                    8, 2)
    hit = re.search(r"pretrained: (\d+)/(\d+)", out)
    n_loaded, n_total = (int(hit[1]), int(hit[2])) if hit else (0, -1)
    files = sorted(p.name for p in d.iterdir())
    row["pretrained"] = {"n_loaded": n_loaded, "n_total": n_total}
    row["files"] = files
    ok = ok and n_loaded == n_total and {"last.pt", "best.pt",
                                         "epoch0.pt"} <= set(files)

    opt = yaml.safe_load((d / "opt.yaml").read_text())
    (d / "opt.yaml").write_text(yaml.safe_dump(dict(opt, epochs=3)))
    saved = load_checkpoint(d / "last.pt")
    restored = {}
    m, _, _ = run("resume", ["--resume", str(d / "last.pt")], 4, 1,
                  on_start=lambda st: restored.update(
                      bit_equal=_state_equals(st, saved)))
    row["resume"].update(restored_bit_equal=restored.get("bit_equal"),
                         saved_epoch=saved["epoch"], steps_after=m["steps"])
    ok = ok and restored.get("bit_equal") is True and m["steps"] == 12

    run("gather_mixup", ["--synthetic-n", "8", "--epochs", "1", "--hyp",
                         str(gather_path), "--save-dir", str(workdir / "g")],
        2, 1)

    seed, sizes = _distinct_scale_seed()
    _, _, seen = run("multi_scale", ["--synthetic-n", "12", "--epochs", "1",
                                     "--multi-scale", "--seed", str(seed),
                                     "--save-dir", str(workdir / "ms")], 3, 1)
    steps = _per_step(seen["counts"])
    model = build_model("configs/model.yaml", ch_in=4, dtype=torch.bfloat16)
    model.load_state_dict(load_weights(TRAINED_NPZ))
    model = model.cuda().eval()
    fwd = {}
    for size in sorted(set(sizes)):
        x = torch.rand(MAIN_BATCH, size, size, 3, device="cuda")
        kernels.reset_launches()
        with torch.no_grad():
            model(x, x)
        fwd[size] = kernels.launches()
    row["multi_scale"].update(
        seed=seed, sizes_expected=sizes, sizes_seen=seen["sizes"],
        launches_per_step={str(z): c for z, c in zip(seen["sizes"], steps)},
        launches_per_forward={str(z): c for z, c in fwd.items()})
    ok = ok and sorted(seen["sizes"]) == [384, 512, 640] and (
        seen["sizes"] == sizes) and all(
        c == PER_STEP for c in steps) and all(
        c == PER_FORWARD for c in fwd.values())

    run("image_weights", ["--synthetic-n", "16", "--epochs", "1",
                          "--image-weights", "--save-dir",
                          str(workdir / "iw")], 4, 1)

    row["profile"] = {tag: _aug_profile(hyp_path, h) for tag, h in
                      (("hyp_file", {}), ("gather_mixup", AUG_GATHER_HYP))}
    row["card_vs_cpu"] = {
        tag: _aug_card_vs_cpu(dict(hyp_file, **h)) for tag, h in
        (("hyp_file", {}), ("gather_mixup", AUG_GATHER_HYP))}
    ok = ok and all(v["ok"] for v in row["card_vs_cpu"].values())
    row.update(bounds={"img_0_255": AUG_IMG_TOL, "labels_px": AUG_LABEL_TOL},
               launches={}, ok=bool(ok))
    emit(row)
    return row


# ------------------------------------------------------------------ folders

# VEDAI folders written on the card's machine by the port's own encoder
# (1024 px `_co` RGB / `_ir` gray pairs in the raw layout, the rows of
# every file cycling through the five filter types), trained and evaluated
# at 512 px from the trained weights
FOLDER_N = 16
FOLDER_RAW = 1024
FOLDER_ARGS = ["--img-size", "512", "--batch-size", "4", "--nbs", "4",
               "--weights", TRAINED_NPZ, "--nosave", "--notest"]
FOLDER_VAL = ["--task", "val", "--img-size", "512", "--batch-size", "4",
              "--weights", TRAINED_NPZ]
FOLDER_STEPS = FOLDER_N // MAIN_BATCH
FOLDER_FORWARDS = FOLDER_N // MAIN_BATCH
# training id -> a raw VEDAI id that `prepare` maps onto it
RAW_CLASS = {0: 1, 1: 11, 2: 5, 3: 2, 4: 10, 5: 4, 6: 23, 7: 9}
# --rect eval at 512 px batches the square tiles at 544 px (pad 0.5):
# stage 2's 68 x 68 map is off the window grid and stage 3 pads to four
# windows, as at 608 px
RECT_EVAL_PX = 544
RECT_FORWARD = OFF_FORWARD


def _row_filters(path: Path) -> list[int]:
    """The filter types used by the rows of a PNG written by the port."""
    import numpy as np
    import zlib
    from sodt_tpu_torch.data import png
    data = path.read_bytes()
    chunks = list(png._chunks(data))
    w, h, _, ctype = png._ihdr(chunks[0][1])[:4]
    raw = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    return sorted(set(rows[:, 0].tolist()))


def _write_png_folder(root: Path, ds, stems, raw_size: int | None) -> dict:
    """Items of `ds` as `images/<stem>_co.png` (RGB) and `_ir.png` (gray),
    written by `png.write_png` with the rows' filters cycling through all
    five types, each file decoded back and held bit-equal to the array
    written. With `raw_size`, 14-column annotations in pixels under
    `Annotations<raw_size>/`; else label files written with 9 significant
    digits, which `np.loadtxt` reads back into the float32 labels bit for
    bit (held)."""
    import numpy as np
    from sodt_tpu_torch.data.png import read_png, write_png
    (root / "images").mkdir(parents=True)
    ann = root / (f"Annotations{raw_size}" if raw_size else "labels")
    ann.mkdir()
    exact, decode_ms, write_ms = True, [], []
    for i, stem in enumerate(stems):
        rgb, ir, labels = ds[i]
        filters = np.arange(rgb.shape[0]) % 5
        co, irp = (root / "images" / f"{stem}_{m}.png" for m in ("co", "ir"))
        t0 = time.perf_counter()
        write_png(co, rgb, filters=filters)
        write_png(irp, ir[..., 0], filters=filters)
        t1 = time.perf_counter()
        back = (read_png(co), read_png(irp))
        decode_ms.append(1e3 * (time.perf_counter() - t1))
        write_ms.append(1e3 * (t1 - t0))
        exact = exact and np.array_equal(back[0], rgb) and np.array_equal(
            back[1], ir[..., :1])
        s = raw_size
        if s:
            rows = []
            for c, cx, cy, w, h in labels:
                x1, x2, y1, y2 = ((cx - w / 2) * s, (cx + w / 2) * s,
                                  (cy - h / 2) * s, (cy + h / 2) * s)
                rows.append(
                    f"{cx * s:.1f} {cy * s:.1f} 0.0 {RAW_CLASS[int(c)]} 0 0 "
                    f"{x1:.1f} {x2:.1f} {x2:.1f} {x1:.1f} "
                    f"{y1:.1f} {y1:.1f} {y2:.1f} {y2:.1f}")
        else:
            rows = [" ".join(f"{v:.9g}" for v in r) for r in labels]
        (ann / f"{stem}.txt").write_text("\n".join(rows) + "\n")
        if not s:
            back_lab = np.loadtxt(ann / f"{stem}.txt", ndmin=2,
                                  dtype=np.float32)
            exact = exact and np.array_equal(back_lab, labels)
    return {"bit_equal": bool(exact),
            "filters": _row_filters(root / "images" / f"{stems[0]}_co.png"),
            "decode_ms_per_pair": decode_ms,
            "write_ms_per_pair": sum(write_ms) / len(write_ms)}


def _data_yaml(root: Path, fold: str) -> str:
    data = root / "data.yaml"
    data.write_text(json.dumps({"train": fold, "val": fold, "nc": 8,
                                "names": [str(c) for c in range(8)]}))
    return str(data)


def _folder_feed(fold: str, hyp_path: Path, regime: str) -> dict:
    """Feed + step on the folder from the trained weights, warm: ms of the
    two on CUDA events, the device's busy ms (torch.profiler) and the idle
    share. `stream` (the bank gate at 0) and `rect` first time each feed
    call of a first epoch (tiles decoded from the PNGs) and of a second
    (the RAM cache); `bank` times its upload (`setup_s`)."""
    import torch
    import yaml
    from sodt_tpu_torch.data import VedaiDataset, loader
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.train.optim import make_optimizer
    from sodt_tpu_torch.train.state import TrainState, make_train_step
    from sodt_tpu_torch.train.trainer import loss_config, scale_hyp

    model = build_model("configs/model.yaml", ch_in=4, dtype=torch.bfloat16)
    model.load_state_dict(load_weights(TRAINED_NPZ))
    model = model.cuda().train()
    h = scale_hyp(yaml.safe_load(hyp_path.read_text()),
                  len(model.spec.anchors), 8, 512)
    tx = make_optimizer(h, dict(model.named_parameters()), epochs=1, nb=4)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, loss_config(model, h, 8))
    ds = VedaiDataset(fold, img_size=512)
    out = {"regime": regime}
    gate = loader.DEVICE_BANK_MAX_GB
    said = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(said):
            if regime == "rect":
                batches = loader.make_rect_train_batches(
                    ds, MAIN_BATCH, 512, h, device="cuda")
            else:
                loader.DEVICE_BANK_MAX_GB = (0.0 if regime == "stream"
                                             else gate)
                batches = loader.make_train_batches(ds, MAIN_BATCH, 512, h,
                                                    device="cuda")
    finally:
        loader.DEVICE_BANK_MAX_GB = gate
    out["setup_s"] = time.perf_counter() - t0
    print(said.getvalue(), end="", flush=True)
    src = re.search(r"tile source: (\w+)", said.getvalue())
    out["tile_source"] = src[1] if src else None

    def feed_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        b = next(batches)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t), b
    if regime != "bank":
        # a first epoch decodes the PNGs into the RAM cache, later ones not
        first = [feed_ms()[0] for _ in range(FOLDER_STEPS)]
        warm = [feed_ms()[0] for _ in range(FOLDER_STEPS)]
        out.update(feed_ms_first_epoch=first, feed_ms_warm_epoch=warm)
    both = lambda: step(state, next(batches))
    both()
    out["feed_plus_step_ms"] = time_ms(both, iters=FOLDER_STEPS, warmup=1)
    wall = []

    def run():
        t = time.perf_counter()
        both()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
    busy, _ = _busy(profiled(run, f"folders {regime}"))
    out.update(device_busy_ms=busy, profiled_wall_ms=wall[-1],
               idle_share=_idle(busy, out["feed_plus_step_ms"]))
    return out


def _as_tile(img):
    """An item as OpenCV 4.6's `convertTo(CV_8U)` leaves it in the tile
    loader: uint8 as it is, float rounded half to even and saturated (NaN
    0), integers saturated."""
    import numpy as np
    if img.dtype == np.uint8:
        return img
    with np.errstate(invalid="ignore"):
        v = np.where(np.isnan(img), 0, np.clip(np.rint(img), 0, 255))
    return v.astype(np.uint8)


def _native_tiles(fold: str, size: int = 512) -> dict:
    """The port's tile loader on a folder at `size` px: every pair's tiles
    bit-equal to the python source's (its items as the loader converts
    them, `_as_tile`), and the ms to decode and resize one pair with the
    cache off, on its pool (the rgb and ir tiles on two threads) and, for
    its first 4 pairs, with the process held to one core, beside the python
    source's ms a pair (`VedaiDataset.__getitem__`)."""
    import os
    import numpy as np
    from sodt_tpu_torch.data import VedaiDataset, native_loader
    ds = VedaiDataset(fold, img_size=size)
    out = {"cpus": os.cpu_count(), "load_error": native_loader.load_error()}
    if out["load_error"] is not None:
        return dict(out, bit_equal=False)
    py_ms, native_ms, equal = [], [], True
    nat = native_loader.NativeTileLoader(ds.img_files, ds.ir_files, size,
                                         cache_gb=0.0)
    try:
        for i in range(len(ds)):
            t = time.perf_counter()
            rgb, ir, _ = ds[i]
            py_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            nrgb, nir = nat.get(np.array([i]))
            native_ms.append(1e3 * (time.perf_counter() - t))
            equal = equal and np.array_equal(nrgb[0], _as_tile(rgb)) and \
                np.array_equal(nir[0], _as_tile(ir))
    finally:
        nat.close()
    # one core: the loader's threads inherit the mask of the thread that
    # made them, so the loader is made under it
    mask = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {min(mask)})
    one_core = []
    try:
        nat = native_loader.NativeTileLoader(ds.img_files, ds.ir_files,
                                             size, cache_gb=0.0)
        try:
            for i in range(min(4, len(ds))):
                t = time.perf_counter()
                nat.get(np.array([i]))
                one_core.append(1e3 * (time.perf_counter() - t))
        finally:
            nat.close()
    finally:
        os.sched_setaffinity(0, mask)
    return dict(out, bit_equal=bool(equal), pairs=len(ds),
                python_ms_per_pair=py_ms, native_ms_per_pair=native_ms,
                native_ms_per_pair_one_core=one_core)


def _tie_val(root: Path, stems: list, ext: str) -> dict:
    """`val --data` in bf16 on the folder `root` of `stems`
    (`images/<stem>_co.<ext>`, labels beside), with the launch counts set
    to 0 just before and read just after: its mAP@0.5 and mAP, the images
    seen, and whether every forward launched PER_FORWARD."""
    from sodt_tpu_torch import kernels, val
    fold = root / "fold.txt"
    fold.write_text("".join(f"{root / 'images' / s}_co.{ext}\n"
                            for s in stems))
    kernels.reset_launches()
    m = val.main(FOLDER_VAL + ["--data", _data_yaml(root, str(fold))])
    per = {k: v / (len(stems) // MAIN_BATCH)
           for k, v in kernels.launches().items()}
    return {"map50": m["map50"], "map": m["map"], "seen": m["seen"],
            "launches_ok": per == {k: float(v)
                                   for k, v in PER_FORWARD.items()}}


def _vedai1024(workdir: Path) -> tuple[dict, str, str]:
    """`workdir/vedai1024`: FOLDER_N synthetic 1024 px pairs written by the
    port's encoder with raw annotations, `prepare`d into labels and the fold
    list. Returns the write report, the fold list and the data yaml."""
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.data.prepare import changepath, makelabels
    root = workdir / "vedai1024"
    stems = [f"{i + 1:08d}" for i in range(FOLDER_N)]
    write = _write_png_folder(
        root, SyntheticVedai(n=FOLDER_N, img_size=FOLDER_RAW, nc=8, seed=0),
        stems, FOLDER_RAW)
    (root / "fold01.txt").write_text("\n".join(stems) + "\n")
    makelabels(str(root / f"Annotations{FOLDER_RAW}"), str(root / "labels"),
               img_size=float(FOLDER_RAW))
    fold = str(root / "fold01_write.txt")
    changepath(str(root / "fold01.txt"), fold, str(root / "images"),
               suffix="_co.png")
    return write, fold, _data_yaml(root, fold)


def phase_folders(label: str, workdir: Path, trained: dict) -> dict:
    """VEDAI folders on the card (module doc, phase `folders`):
      1. a 1024 px raw-layout folder written with the port's encoder
         (every filter type), decoded back bit-equal, `prepare`d;
      2. `sodt_tpu_torch.train --data` on it from the trained weights at
         512 px: 2 epochs streaming (the bank gate at 0), 1 epoch from the
         device bank, 1 epoch of --rect; PER_STEP on every step, finite
         losses, the tile source printed: the port's C++ tile loader
         (`native`) for streaming and the bank;
      3. `val --data` on it, square (PER_FORWARD) and --rect (544 px,
         RECT_FORWARD);
      4. `trained`'s 16 images at 512 px as a PNG folder: `val` in bf16
         reads `trained`'s bf16 mAP@0.5 and mAP to the last digit;
      5. the tile loader's tiles of the folder bit-equal to the python
         source's, and each one's ms a pair (`_native_tiles`);
      6. feed + step and the idle share of each regime, its tile source
         (`native` for streaming and the bank) and its setup.
    The launch counts are set to 0 just before each run and read after."""
    import numpy as np
    import torch
    import yaml
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.data import SyntheticVedai, VedaiDataset, loader
    from sodt_tpu_torch.data import make_eval_batches
    from sodt_tpu_torch.models.compiler import resolve_config_path

    trained_weights()
    row, ok = {"phase": label}, True
    row["write"], fold, data = _vedai1024(workdir)
    ok = ok and row["write"]["bit_equal"] and row["write"]["filters"] == [
        0, 1, 2, 3, 4]

    hyp = yaml.safe_load(Path(resolve_config_path(
        "configs/hyp.scratch.yaml")).read_text())
    hyp_path = workdir / "hyp_folders.yaml"
    hyp_path.write_text(yaml.safe_dump(dict(hyp, warmup_iters=4)))

    def train(tag, extra, epochs, stream=False):
        nonlocal ok
        seen, hooks = _step_recorder()
        gate = loader.DEVICE_BANK_MAX_GB
        if stream:
            loader.DEVICE_BANK_MAX_GB = 0.0
        kernels.reset_launches()
        try:
            m, out = _train_cli(FOLDER_ARGS + [
                "--data", data, "--hyp", str(hyp_path), "--epochs",
                str(epochs), "--save-dir", str(workdir / f"f_{tag}")] + extra,
                **hooks)
        finally:
            loader.DEVICE_BANK_MAX_GB = gate
        counts = kernels.launches()
        steps = _per_step(seen["counts"])
        n = epochs * FOLDER_STEPS
        src = re.search(r"feed: ([^,(]+).*tile source: (\w+) \(([^)]*)\)",
                        out)
        finite = all(math.isfinite(v) for l in seen["losses"]
                     for v in l.values())
        expected = {k: n * PER_STEP[k] + FOLDER_FORWARDS * PER_FORWARD[k]
                    for k in PER_STEP}
        r = {"args": extra, "steps": len(steps), "losses": seen["losses"],
             "sizes": sorted(set(seen["sizes"])),
             "feed": src[1].strip() if src else None,
             "tile_source": src[2] if src else None,
             "tile_source_why": src[3] if src else None,
             "launches_per_step_ok": all(c == PER_STEP for c in steps),
             "launches_ok": counts == expected, "map50": m["map50"]}
        ok = ok and (len(steps) == n and r["launches_per_step_ok"]
                     and r["launches_ok"] and finite and src is not None
                     and r["sizes"] == [512])
        # the card's feed reads the folder through the port's C++ loader
        ok = ok and (tag == "rect" or r["tile_source"] == "native")
        row[tag] = r

    train("stream", [], 2, stream=True)
    train("bank", [], 1)
    train("rect", ["--rect"], 1)

    evals = {}
    for tag, extra, per_fwd in (("square", [], PER_FORWARD),
                                ("rect", ["--rect"], RECT_FORWARD)):
        kernels.reset_launches()
        m = val.main(FOLDER_VAL + ["--data", data] + extra)
        per = {k: v / FOLDER_FORWARDS for k, v in kernels.launches().items()}
        evals[tag] = {k: m[k] for k in ("map50", "map", "seen")}
        evals[tag]["launches_per_forward"] = per
        ok = ok and per == {k: float(v) for k, v in per_fwd.items()} and (
            m["seen"] == FOLDER_N)
    shape = next(make_eval_batches(VedaiDataset(fold, img_size=512),
                                   MAIN_BATCH, 512, rect=True))["net_shape"]
    evals["rect"]["net_shape"] = list(shape)
    ok = ok and tuple(shape) == (RECT_EVAL_PX, RECT_EVAL_PX)
    row["eval"] = evals

    # the lossless tie: `trained`'s images as PNGs at 512 px
    tie = workdir / "trained_png"
    tstems = [f"{i:08d}" for i in range(16)]
    row["tie_write"] = _write_png_folder(
        tie, SyntheticVedai(n=16, img_size=512, nc=8, seed=1), tstems, None)
    m = _tie_val(tie, tstems, "png")
    want = (trained or {}).get("runs", {}).get("bf16")
    if want is None:
        want = val.main(TRAINED_ARGS)
    row["tie"] = {"folder": m,
                  "trained_bf16": {k: want[k] for k in ("map50", "map")}}
    ok = ok and row["tie_write"]["bit_equal"] and m["launches_ok"] and all(
        m[k] == want[k] for k in ("map50", "map"))

    row["native_tiles"] = nat = _native_tiles(fold)
    ok = ok and nat["bit_equal"]
    row["feed"] = {regime: _folder_feed(fold, hyp_path, regime)
                   for regime in ("stream", "bank", "rect")}
    ok = ok and all(row["feed"][k]["tile_source"] == "native"
                    for k in ("stream", "bank"))
    dec = row["write"]["decode_ms_per_pair"]
    mean = lambda key: (float(np.mean(nat[key])) if nat.get(key) else None)
    row["summary"] = {
        "decode_ms_per_1024_pair_first": dec[0],
        "decode_ms_per_1024_pair_mean": sum(dec) / len(dec),
        "tile_ms_per_1024_pair_native_mean": mean("native_ms_per_pair"),
        "tile_ms_per_1024_pair_native_one_core_mean": mean(
            "native_ms_per_pair_one_core"),
        "tile_ms_per_1024_pair_python_mean": mean("python_ms_per_pair"),
        **{f"{k}_tile_source": v["tile_source"]
           for k, v in row["feed"].items()},
        **{f"{k}_setup_s": v["setup_s"] for k, v in row["feed"].items()},
        **{f"{k}_feed_ms_{e}_epoch_mean": float(np.mean(
            row["feed"][k][f"feed_ms_{e}_epoch"]))
           for k in ("stream", "rect") for e in ("first", "warm")},
        **{f"{k}_feed_plus_step_ms": v["feed_plus_step_ms"]
           for k, v in row["feed"].items()},
        **{f"{k}_idle_share": v["idle_share"] for k, v in row["feed"].items()}}
    row.update(launches={}, ok=bool(ok))
    emit(row)
    return row


# ------------------------------------------------------------------- jpeg

JPEG_FIXTURES = Path("tests/torch_port_jpeg")
JPEG_N = 16           # `trained`'s images, at 512 px
JPEG_RAW = 1024       # the side of the pairs whose decode is timed
JPEG_PAIRS = 4


def _write_jpeg_folder(root: Path, items, stems: list) -> str:
    """`items` ((rgb, ir, labels) each) as `images/<stem>_co.jpg` (RGB) and
    `_ir.jpg` (gray) by the port's encoder, labels with 9 significant
    digits; returns the fold list."""
    from sodt_tpu_torch.data.jpeg import write_jpeg
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for (rgb, ir, labels), stem in zip(items, stems):
        write_jpeg(root / "images" / f"{stem}_co.jpg", rgb)
        write_jpeg(root / "images" / f"{stem}_ir.jpg", ir[..., 0])
        (root / "labels" / f"{stem}.txt").write_text("\n".join(
            " ".join(f"{v:.9g}" for v in r) for r in labels) + "\n")
    fold = root / "fold.txt"
    fold.write_text("".join(f"{root / 'images' / s}_co.jpg\n"
                            for s in stems))
    return str(fold)


def _jpeg_decode_ms(workdir: Path) -> dict:
    """ms to decode one 1024 px JPEG pair (RGB 4:2:0 and gray, written by
    the port's encoder): `_native_tiles` at 1024 px (decode and copy, no
    resize) on JPEG_PAIRS pairs, which gives the tile loader on its pool
    and held to one core and the python source (the C++ decode on the
    calling thread); the numpy decoder on the first pair."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, jpeg
    src = SyntheticVedai(n=JPEG_PAIRS, img_size=JPEG_RAW, nc=8, seed=5)
    stems = [f"{i:08d}" for i in range(JPEG_PAIRS)]
    root = workdir / "jpeg1024"
    nat = _native_tiles(_write_jpeg_folder(
        root, (src[i] for i in range(JPEG_PAIRS)), stems), JPEG_RAW)
    numpy_ms = []
    for _ in range(2):
        t = time.perf_counter()
        for m in ("co", "ir"):
            jpeg.read_jpeg(root / "images" / f"{stems[0]}_{m}.jpg")
        numpy_ms.append(1e3 * (time.perf_counter() - t))
    keys = {"cpp_pool": "native_ms_per_pair",
            "cpp_one_core": "native_ms_per_pair_one_core",
            "cpp_calling_thread": "python_ms_per_pair"}
    return {"side": JPEG_RAW, "pairs": JPEG_PAIRS,
            "bytes_per_pair": sum(p.stat().st_size for p in
                                  (root / "images").iterdir()) / JPEG_PAIRS,
            "tiles": nat, "numpy_ms_per_pair": numpy_ms,
            "median": {**{k: float(np.median(nat[v])) if nat.get(v) else None
                          for k, v in keys.items()},
                       "numpy": float(np.median(numpy_ms))}}


def _decode_or_error(read, path):
    """`read(path)`, or the words of the ValueError it raises past the
    file's name."""
    try:
        return read(path)
    except ValueError as e:
        return str(e).split(": ", 1)[-1]


def _same_decode(a, b) -> bool:
    """Two decodes gave the same pixels, or failed with the same words."""
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return bool(a.shape == b.shape and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())


# (e) (module doc, phase `jpeg`): the fixtures of the kinds and their
# damaged copies, a folder of cut progressive JPEGs and one of DNGs beside
# PNG twins, the decode ms of a 1024 px cut progressive pair; written
# before (e) first ran on the card (PERF.md, section 6)
JPEG_KINDS_CUT = 0.6         # the share of each progressive file kept
JPEG_KINDS_PREDICTED = {
    "fixtures": "C++ = numpy (cv2 5.0's reading and OpenCV 4.6's) on every "
                "kind's fixture and on 6 damaged copies of each",
    "tie": "the folder of cut progressive, CMYK and arithmetic-coded JPEGs "
           "and the DNG folder each read their PNG twin's mAP@0.5 and mAP "
           "to the last digit",
    "cut_1024_pair_ms": {"cpp": "15-40", "cpp_opencv46": "15-40",
                         "numpy": "400-1200"},
    "part_e_s": "10-30",
}


def _progressive(data: bytes) -> bytes:
    """A baseline JPEG of the port's encoder as a progressive one: its
    coefficients in an interleaved DC scan, then one AC scan (1-63) for each
    component, coded with the same standard tables (an AC-first block's
    codes are a baseline block's after its DC; EOB is an EOB run of one)."""
    import numpy as np
    from sodt_tpu_torch.data import jpeg
    dec = jpeg._Decoder(data, "x")
    dec.run()
    f, head = dec.frame, data[:data.index(b"\xff\xda")]
    i = head.index(b"\xff\xc0\x00")
    head = head[:i] + b"\xff\xc2" + head[i + 2:]
    coefs = [np.asarray(c.coef, np.int64).reshape(c.ph, c.pw, 64)
             for c in f["comps"]]
    zero = np.zeros(256, np.int64)
    tabs = [jpeg._code_arrays(*jpeg.STD_HUFFMAN[(0, min(ci, 1))])
            + jpeg._code_arrays(*jpeg.STD_HUFFMAN[(1, min(ci, 1))])
            for ci in range(len(coefs))]
    dc_blocks, dc_comp = [], []
    for my in range(f["mcuy"]):
        for mx in range(f["mcux"]):
            for ci, c in enumerate(f["comps"]):
                for yy in range(c.v):
                    for xx in range(c.h):
                        b = np.zeros(64, np.int64)
                        b[0] = coefs[ci][my * c.v + yy, mx * c.h + xx, 0]
                        dc_blocks.append(b)
                        dc_comp.append(ci)
    no_eob = [(d, dl, a, np.where(np.arange(256) == 0, 0, al))
              for d, dl, a, al in tabs]
    n = len(coefs)
    out = [head, jpeg._marker(0xDA, bytes([n, *[b for ci, c in enumerate(
        f["comps"]) for b in (c.id, min(ci, 1) << 4 | min(ci, 1))]])
        + b"\x00\x00\x00"), jpeg._entropy_encode(
            np.stack(dc_blocks), np.array(dc_comp), no_eob)]
    for ci, c in enumerate(f["comps"]):
        blocks = coefs[ci][:c.bh, :c.bw].reshape(-1, 64).copy()
        blocks[:, 0] = 0
        t = min(ci, 1)
        out += [jpeg._marker(0xDA, bytes([1, c.id, t << 4 | t, 1, 63, 0])),
                jpeg._entropy_encode(blocks, np.zeros(len(blocks), np.int64),
                                     [(zero, zero, *tabs[ci][2:])])]
    return b"".join(out) + b"\xff\xd9"


def _cmyk_jpeg(rgb) -> bytes:
    """`rgb` as a 4-component baseline JPEG under an Adobe marker with
    transform 0 (CMYK as stored), the samples R, G, B, 255, from which
    OpenCV's CMYK to BGR gives back about the RGB: 1 x 1 sampling, quality
    75's luma table and the standard luma Huffman tables for all four,
    through the port's encoder's steps (FDCT, quantisation, Huffman)."""
    import struct
    import numpy as np
    from sodt_tpu_torch.data import jpeg
    h, w = rgb.shape[:2]
    planes = [rgb[..., i].astype(np.int64) for i in range(3)]
    planes.append(np.full((h, w), 255, np.int64))
    qt = jpeg.quality_table(jpeg.QT_LUMA, jpeg.QUALITY)
    bw, bh = -(-w // 8), -(-h // 8)
    per = []
    for p in planes:
        x = jpeg._pad(p, bh * 8, bw * 8)
        blk = x.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        co = jpeg._fdct_islow((blk - 128).reshape(-1, 8, 8)).reshape(-1, 64)
        per.append(jpeg._quantize(co, qt))
    blocks = np.stack(per, 1).reshape(-1, 64)     # each MCU: C, M, Y, K
    tab = (jpeg._code_arrays(*jpeg.STD_HUFFMAN[(0, 0)])
           + jpeg._code_arrays(*jpeg.STD_HUFFMAN[(1, 0)]))
    scan = jpeg._entropy_encode(blocks, np.tile(np.arange(4), bh * bw),
                                [tab] * 4)
    out = [jpeg.SOI, jpeg._marker(0xEE, b"Adobe\x00\x64" + bytes(5)),
           jpeg._marker(0xDB, bytes([0]) + bytes(qt[jpeg.NATURAL[k]]
                                                 for k in range(64))),
           jpeg._marker(0xC0, struct.pack(">BHHB", 8, h, w, 4) + b"".join(
               bytes([i + 1, 0x11, 0]) for i in range(4)))]
    for tc in (0, 1):
        counts, syms = jpeg.STD_HUFFMAN[(tc, 0)]
        out.append(jpeg._marker(0xC4, bytes([tc << 4]) + bytes(counts)
                                + bytes(syms)))
    out.append(jpeg._marker(0xDA, bytes([4]) + b"".join(
        bytes([i + 1, 0]) for i in range(4)) + b"\x00\x3f\x00"))
    return b"".join(out) + scan + b"\xff\xd9"


class _ArithEncoder:
    """libjpeg's QM encoder (jcarith.c arith_encode, finish_pass): the
    decisions of one scan into stuffed bytes."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer, self.out = -1, bytearray()

    def _emit(self, v):
        self.out.append(v)
        if v == 0xFF:
            self.out.append(0)

    def _flush_zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def __call__(self, st, k, val):
        from sodt_tpu_torch.data.jpeg import _ARITAB
        sv = st[k]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _settle(self):
        """Out with the buffered byte and the stacked 0xFF bytes."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._flush_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0x8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_jpeg(data: bytes) -> bytes:
    """A baseline JPEG of the port's encoder as a sequential arithmetic-
    coded one (SOF9, jcarith.c's encode_mcu, the default conditioning):
    the same coefficients, quantisation tables and scan."""
    import numpy as np
    from sodt_tpu_torch.data import jpeg
    dec = jpeg._Decoder(data, "x")
    dec.run()
    f = dec.frame
    sos = data.index(b"\xff\xda")
    head = data[:sos]
    i = head.index(b"\xff\xc0\x00")
    head = head[:i] + b"\xff\xc9" + head[i + 2:]
    n = int.from_bytes(data[sos + 2:sos + 4], "big")
    enc, fixed = _ArithEncoder(), bytearray([113])
    dc_stats = [bytearray(64) for _ in range(2)]
    ac_stats = [bytearray(256) for _ in range(2)]
    last = [0] * len(f["comps"])
    ctx = [0] * len(f["comps"])
    coefs = [np.asarray(c.coef, np.int64).reshape(c.ph, c.pw, 64)
             for c in f["comps"]]
    for my in range(f["mcuy"]):
        for mx in range(f["mcux"]):
            for ci, c in enumerate(f["comps"]):
                t = min(ci, 1)
                for yy in range(c.v):
                    for xx in range(c.h):
                        blk = coefs[ci][my * c.v + yy, mx * c.h + xx]
                        st = dc_stats[t]
                        s0 = ctx[ci]
                        v = int(blk[0]) - last[ci]
                        if v == 0:
                            enc(st, s0, 0)
                            ctx[ci] = 0
                        else:
                            last[ci] = int(blk[0])
                            enc(st, s0, 1)
                            if v > 0:
                                enc(st, s0 + 1, 0)
                                k, ctx[ci] = s0 + 2, 4
                            else:
                                v = -v
                                enc(st, s0 + 1, 1)
                                k, ctx[ci] = s0 + 3, 8
                            m = 0
                            v -= 1
                            if v:
                                enc(st, k, 1)
                                m, v2, k = 1, v, 20
                                v2 >>= 1
                                while v2:
                                    enc(st, k, 1)
                                    m <<= 1
                                    k += 1
                                    v2 >>= 1
                            enc(st, k, 0)
                            if m > 1:            # the default U = 1
                                ctx[ci] += 8
                            k += 14
                            m >>= 1
                            while m:
                                enc(st, k, 1 if m & v else 0)
                                m >>= 1
                        st = ac_stats[t]
                        nat = blk[jpeg.NATURAL[:64]]
                        nz = np.nonzero(nat[1:])[0]
                        ke = int(nz[-1]) + 1 if len(nz) else 0
                        k = 1
                        while k <= ke:
                            b = 3 * (k - 1)
                            enc(st, b, 0)
                            while nat[k] == 0:
                                enc(st, b + 1, 0)
                                b += 3
                                k += 1
                            enc(st, b + 1, 1)
                            v = int(nat[k])
                            enc(fixed, 0, 0 if v > 0 else 1)
                            v = abs(v)
                            b += 2
                            m = 0
                            v -= 1
                            if v:
                                enc(st, b, 1)
                                m, v2 = 1, v >> 1
                                if v2:
                                    enc(st, b, 1)
                                    m <<= 1
                                    b = 189 if k <= 5 else 217
                                    v2 >>= 1
                                    while v2:
                                        enc(st, b, 1)
                                        m <<= 1
                                        b += 1
                                        v2 >>= 1
                            enc(st, b, 0)
                            b += 14
                            m >>= 1
                            while m:
                                enc(st, b, 1 if m & v else 0)
                                m >>= 1
                            k += 1
                        if k <= 63:
                            enc(st, 3 * (k - 1), 1)
    return head + data[sos:sos + 2 + n] + enc.finish() + b"\xff\xd9"


def _cut_progressive(data: bytes) -> bytes:
    """`_progressive(data)` cut to JPEG_KINDS_CUT of its bytes, not inside
    a scan's header."""
    data = _progressive(data)
    cut = int(len(data) * JPEG_KINDS_CUT)
    sos = data.rfind(b"\xff\xda", 0, cut)
    return data[:sos - 1 if cut - sos < 16 else cut]


JPEG_KINDS = ("cut_progressive", "cmyk", "arithmetic")


def _kinds_folder(root: Path, items, stems: list) -> dict:
    """`items` as `_write_jpeg_folder` writes them, then item i's files
    rewritten as JPEG_KINDS[i % 3]: both cut progressive
    (`_cut_progressive`), the RGB as CMYK (`_cmyk_jpeg`, the IR left
    baseline), or both arithmetic-coded (`_arith_jpeg`). Returns the
    files of each kind."""
    import numpy as np
    _write_jpeg_folder(root, items, stems)
    kinds = {k: 0 for k in JPEG_KINDS}
    for i, ((rgb, _, _), s) in enumerate(zip(items, stems)):
        kind = JPEG_KINDS[i % 3]
        for m in ("co", "ir"):
            f = root / "images" / f"{s}_{m}.jpg"
            if kind == "cmyk":
                if m == "co":
                    f.write_bytes(_cmyk_jpeg(np.asarray(rgb)))
                    kinds[kind] += 1
                continue
            f.write_bytes((_cut_progressive if kind == "cut_progressive"
                           else _arith_jpeg)(f.read_bytes()))
            kinds[kind] += 1
    return kinds


def _jpeg_kinds(workdir: Path, items, stems: list) -> dict:
    """(e): C++ = numpy, as cv2 5.0 reads and as OpenCV 4.6 reads, on the
    kinds' fixtures (tests/torch_port_jpeg/: cut and scan-stripped
    progressive, arithmetic-coded, CMYK / YCCK, lossless, 12-bit) and 6
    damaged copies of each from a seed; `items` as a folder of cut
    progressive, CMYK and arithmetic-coded JPEGs (`_kinds_folder`) and as
    a folder of DNGs (TIFF named .dng, BT_TIFF), each beside a PNG twin of
    its decoded pixels, read by `val` in bf16 (PER_FORWARD) to one mAP; ms
    to decode a 1024 px cut progressive pair (C++ on the calling thread in
    both readings, numpy once)."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, jpeg, native_loader
    t0 = time.perf_counter()
    names = ("cut_", "keep", "arith", "cmyk", "ycck", "lossless", "bits12")
    files = sorted(f for f in JPEG_FIXTURES.glob("*.jpg")
                   if f.name.startswith(names))
    dmg = workdir / "jpeg_kinds_damaged"
    dmg.mkdir(parents=True, exist_ok=True)
    n = agree = decoded = 0
    for f in files:
        good = f.read_bytes()
        rng = np.random.default_rng(sum(good[-64:]))
        copies = [good]
        for k in range(6):
            data = bytearray(good)
            if k % 2:
                data = data[:int(rng.integers(8, len(data)))]
            else:
                for i in rng.integers(8, len(data), int(rng.integers(1, 6))):
                    data[i] = int(rng.integers(256))
            copies.append(bytes(data))
        for k, data in enumerate(copies):
            path = dmg / f"{n}.jpg"
            path.write_bytes(data)
            for o46 in (False, True):
                a = _decode_or_error(lambda p: native_loader.decode_jpeg(
                    p, opencv46=o46), path)
                b = _decode_or_error(lambda p: jpeg.decode_jpeg(
                    p.read_bytes(), str(p), opencv46=o46), path)
                agree += _same_decode(a, b)
                decoded += not isinstance(a, str)
            n += 1
    fixtures = {"files": len(files), "decodes": 2 * n, "agree": agree,
                "decoded": decoded}
    ok_fixtures = len(files) >= 20 and agree == 2 * n
    # the folders and their twins
    evals = {}
    kinds_root = workdir / "kinds_jpeg"
    written = _kinds_folder(kinds_root, items, stems)
    dng = workdir / "kinds_dng"
    _write_bt_folder(dng, items, stems, "dng")
    twins_ok = True
    for name, root, ext, read in (
            ("jpeg_kinds", kinds_root, "jpg", native_loader.decode_jpeg),
            ("dng", dng, "dng", native_loader.decode_tiff)):
        decoded_items = [tuple(read(root / "images" / f"{s}_{m}.{ext}")
                               for m in ("co", "ir")) + (lab,)
                         for s, (_, _, lab) in zip(stems, items)]
        twin = workdir / f"kinds_{name}_as_png"
        twins_ok = twins_ok and _write_png_folder(
            twin, decoded_items, stems, None)["bit_equal"]
        evals[name] = _tie_val(root, stems, ext)
        evals[f"{name}_png"] = _tie_val(twin, stems, "png")
    ok_tie = twins_ok and all(
        evals[k][m] == evals[f"{k}_png"][m]
        for k in ("jpeg_kinds", "dng") for m in ("map50", "map")) and all(
        e["launches_ok"] and e["seen"] == len(stems) for e in evals.values())
    # decode ms of a 1024 px cut progressive pair
    src = SyntheticVedai(n=1, img_size=JPEG_RAW, nc=8, seed=5)
    big = workdir / "kinds_cut1024"
    _write_jpeg_folder(big, [src[0]], ["00000000"])
    pair = [big / "images" / f"00000000_{m}.jpg" for m in ("co", "ir")]
    for p in pair:
        p.write_bytes(_cut_progressive(p.read_bytes()))
    ms = {}
    for key, fn in (("cpp", lambda p: native_loader.decode_jpeg(p)),
                    ("cpp_opencv46",
                     lambda p: native_loader.decode_jpeg(p, opencv46=True)),
                    ("numpy", jpeg.read_jpeg)):
        runs = []
        for _ in range(1 if key == "numpy" else 7):
            t = time.perf_counter()
            for p in pair:
                fn(p)
            runs.append(1e3 * (time.perf_counter() - t))
        ms[key] = float(np.median(runs))
    same = all(_same_decode(native_loader.decode_jpeg(p), jpeg.read_jpeg(p))
               for p in pair)
    return {"fixtures": fixtures, "kinds_written": written, "tie": evals,
            "cut_1024_pair_ms": ms,
            "cut_1024_bytes_per_pair": sum(p.stat().st_size for p in pair),
            "cut_1024_cpp_equals_numpy": same,
            "predicted": JPEG_KINDS_PREDICTED,
            "part_e_s": time.perf_counter() - t0,
            "ok": bool(ok_fixtures and ok_tie and same)}


def phase_jpeg(label: str, workdir: Path, trained: dict) -> dict:
    """The port's JPEG decoder on the card's machine (module doc, phase
    `jpeg`); (a)-(d) each print a line of their own."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, jpeg, native_loader

    trained_weights()
    row, ok = {"phase": label}, True
    if native_loader.load_error() is not None:
        raise RuntimeError(native_loader.load_error())

    # (a) the C++ decoder against the numpy one on the checked-in files
    files = sorted(JPEG_FIXTURES.glob("*.jpg"))
    fixtures = {}
    for f in files:
        a, b = _decode_or_error(native_loader.decode_jpeg, f), \
            _decode_or_error(jpeg.read_jpeg, f)
        fixtures[f.name] = {"shape": list(getattr(a, "shape", [])),
                            "bit_equal": _same_decode(a, b)}
    ok_a = len(files) >= 12 and all(v["bit_equal"] for v in fixtures.values())
    emit({"phase": f"{label}_fixtures", "files": fixtures, "ok": ok_a})
    ok = ok and ok_a

    # (b) the same pixels as JPEG and as PNG: one mAP to the digit
    src = SyntheticVedai(n=JPEG_N, img_size=512, nc=8, seed=1)
    items = [src[i] for i in range(JPEG_N)]
    stems = [f"{i:08d}" for i in range(JPEG_N)]
    root, twin = workdir / "trained_jpeg", workdir / "trained_jpeg_as_png"
    fold = _write_jpeg_folder(root, items, stems)
    decoded = [tuple(native_loader.decode_jpeg(
        root / "images" / f"{s}_{m}.jpg") for m in ("co", "ir")) + (lab,)
        for s, (_, _, lab) in zip(stems, items)]
    twin_write = _write_png_folder(twin, decoded, stems, None)
    evals = {"jpeg": _tie_val(root, stems, "jpg"),
             "png": _tie_val(twin, stems, "png")}
    ok_b = (all(evals["jpeg"][k] == evals["png"][k] for k in ("map50", "map"))
            and all(e["launches_ok"] and e["seen"] == JPEG_N
                    for e in evals.values())
            and twin_write["bit_equal"] and evals["jpeg"]["map50"] > 0.5)
    trained_bf16 = (trained or {}).get("runs", {}).get("bf16")
    emit({"phase": f"{label}_tie", **evals,
          "trained_bf16": ({k: trained_bf16[k] for k in ("map50", "map")}
                           if trained_bf16 else None),
          "jpeg_bytes_per_pair": sum(p.stat().st_size for p in
                                     (root / "images").iterdir()) / JPEG_N,
          "ok": ok_b})
    ok = ok and ok_b

    # (c) the tile loader's tiles of the JPEG folder against the python
    # source's
    tiles = _native_tiles(fold)
    emit({"phase": f"{label}_tiles", "size": 512, **tiles,
          "ok": tiles["bit_equal"]})
    ok = ok and tiles["bit_equal"]

    # (d) decode ms of a 1024 px pair, beside the card
    dec = _jpeg_decode_ms(workdir)
    ok = ok and dec["tiles"]["bit_equal"]
    emit({"phase": f"{label}_decode_ms", "card": card_line(), **dec})

    # (e) the kinds cv2 reads beyond baseline and progressive, and DNG
    kinds = _jpeg_kinds(workdir, items, stems)
    emit({"phase": f"{label}_kinds", "card": card_line(), **kinds})
    ok = ok and kinds["ok"]
    row.update(fixtures_ok=ok_a, tie=evals,
               tiles_bit_equal=tiles["bit_equal"], decode_ms=dec["median"],
               kinds_ok=kinds["ok"], launches={}, ok=bool(ok))
    emit(row)
    return row


# --------------------------------------------------------------- bmp_tiff

BT_FIXTURES = Path("tests/torch_port_bmp_tiff")
BT_TIFF = {"compression": "deflate", "predictor": 2, "tile": (64, 128)}


def _write_bt_folder(root: Path, items, stems: list, ext: str) -> str:
    """`items` ((rgb, ir, labels) each) as `images/<stem>_co.<ext>` (RGB)
    and `_ir.<ext>` (gray) by the port's `write_bmp` or `write_tiff`
    (BT_TIFF), labels with 9 significant digits; returns the fold list."""
    from sodt_tpu_torch.data.bmp import write_bmp
    from sodt_tpu_torch.data.tiff import write_tiff
    write = (write_bmp if ext == "bmp"
             else lambda p, a: write_tiff(p, a, **BT_TIFF))
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for (rgb, ir, labels), stem in zip(items, stems):
        write(root / "images" / f"{stem}_co.{ext}", rgb)
        write(root / "images" / f"{stem}_ir.{ext}", ir[..., 0])
        (root / "labels" / f"{stem}.txt").write_text("\n".join(
            " ".join(f"{v:.9g}" for v in r) for r in labels) + "\n")
    fold = root / "fold.txt"
    fold.write_text("".join(f"{root / 'images' / s}_co.{ext}\n"
                            for s in stems))
    return str(fold)


def _bt_decode_ms(workdir: Path, ext: str) -> dict:
    """ms to decode one 1024 px pair of `ext` (written as in
    `_write_bt_folder`): `_native_tiles` at 1024 px (decode and copy, no
    resize) on JPEG_PAIRS pairs, which gives the tile loader on its pool
    and held to one core and the python source (the C++ decode of
    `_read_image` on the calling thread); the numpy decoder on the first
    pair."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, bmp, tiff
    src = SyntheticVedai(n=JPEG_PAIRS, img_size=JPEG_RAW, nc=8, seed=5)
    stems = [f"{i:08d}" for i in range(JPEG_PAIRS)]
    root = workdir / f"{ext}1024"
    nat = _native_tiles(_write_bt_folder(
        root, (src[i] for i in range(JPEG_PAIRS)), stems, ext), JPEG_RAW)
    read = bmp.read_bmp if ext == "bmp" else tiff.read_tiff
    numpy_ms = []
    for _ in range(2):
        t = time.perf_counter()
        for m in ("co", "ir"):
            read(root / "images" / f"{stems[0]}_{m}.{ext}")
        numpy_ms.append(1e3 * (time.perf_counter() - t))
    keys = {"cpp_pool": "native_ms_per_pair",
            "cpp_one_core": "native_ms_per_pair_one_core",
            "cpp_calling_thread": "python_ms_per_pair"}
    return {"side": JPEG_RAW, "pairs": JPEG_PAIRS,
            "bytes_per_pair": sum(p.stat().st_size for p in
                                  (root / "images").iterdir()) / JPEG_PAIRS,
            "tiles": nat, "numpy_ms_per_pair": numpy_ms,
            "median": {**{k: float(np.median(nat[v])) if nat.get(v) else None
                          for k, v in keys.items()},
                       "numpy": float(np.median(numpy_ms))}}


def _bit_equal(a, b) -> bool:
    """The same shape, dtype and bytes (a float NaN equal to itself)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def _damaged_agree(files, out: Path, per_file: int = 4) -> dict:
    """Each BMP, TIFF or WebP fixture with bytes overwritten or cut, from a
    seed: the C++ decoder gives the numpy decoder's pixels (a broken TIFF
    strip filled as libtiff fills it) or raises an error of its type.
    Counts the files, those where the two agree, and those that
    decoded."""
    import numpy as np
    from sodt_tpu_torch.data import bmp, native_loader, tiff, webp
    readers = {".bmp": (native_loader.decode_bmp, bmp.read_bmp),
               ".tif": (native_loader.decode_tiff, tiff.read_tiff),
               ".webp": (native_loader.decode_webp, webp.read_webp)}
    out.mkdir(parents=True, exist_ok=True)
    n = agree = decoded = 0
    for f in files:
        cpp, plain = readers[f.suffix]
        good = f.read_bytes()
        rng = np.random.default_rng(sum(good[-64:]))
        for k in range(per_file):
            data = bytearray(good)
            if k % 2:
                data = data[:int(rng.integers(8, len(data)))]
            else:
                for i in rng.integers(8, len(data), int(rng.integers(1, 6))):
                    data[i] = int(rng.integers(256))
            path = out / f"{n}{f.suffix}"
            path.write_bytes(bytes(data))
            n += 1
            got = want = None
            try:
                want = plain(path)
            except (ValueError, NotImplementedError) as e:
                want = type(e)
            try:
                got = cpp(path)
            except (ValueError, NotImplementedError) as e:
                got = type(e)
            if isinstance(want, type) or isinstance(got, type):
                agree += got is want
            else:
                decoded += 1
                agree += _bit_equal(got, want)
    return {"files": n, "agree": agree, "decoded": decoded}


# aerial imagery as TIFF (module doc, phase `bmp_tiff` (d), (e)): RGB as
# YCbCr 4:2:0 JPEG in 256 px tiles, IR as float32 under the floating-point
# predictor, deflated
BT_AERIAL_N = 8                  # `trained`'s first images, at 512 px
BT_AERIAL_RGB = {"compression": "jpeg", "tile": (256, 256)}
BT_AERIAL_IR = {"compression": "deflate", "predictor": 3}
# written before (d) and (e) first ran on the card (PERF.md, section 6)
BT_AERIAL_PREDICTED = {
    "tie": "mAP@0.5 and mAP equal to the PNG twin's (the decoded RGB, the "
           "8-bit IR) to the last digit; tiles bit-equal",
    "aerial_1024_pair_ms": {"cpp_pool": "35-70", "cpp_one_core": "45-80",
                            "cpp_calling_thread": "50-100",
                            "numpy": "250-450"},
    "parts_d_e_s": "3-8",
}


def _aerial_folder(root: Path, items, stems: list, ir_scaled) -> str:
    """`items` as aerial TIFF (BT_AERIAL_RGB, BT_AERIAL_IR): the IR samples
    `ir_scaled(ir)` (float32); labels as `_write_bt_folder` writes them;
    returns the fold list."""
    from sodt_tpu_torch.data.tiff import write_tiff
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for (rgb, ir, labels), stem in zip(items, stems):
        write_tiff(root / "images" / f"{stem}_co.tif", rgb, **BT_AERIAL_RGB)
        write_tiff(root / "images" / f"{stem}_ir.tif", ir_scaled(ir),
                   **BT_AERIAL_IR)
        (root / "labels" / f"{stem}.txt").write_text("\n".join(
            " ".join(f"{v:.9g}" for v in r) for r in labels) + "\n")
    fold = root / "fold.txt"
    fold.write_text("".join(f"{root / 'images' / s}_co.tif\n"
                            for s in stems))
    return str(fold)


def _aerial_tie(workdir: Path, items, stems: list) -> dict:
    """(d): the aerial folder of `items` and its PNG twin (the RGB as the
    numpy decoder reads the JPEG TIFF, the IR's 8-bit pixels). The float IR
    holds ir / 255 as the card computes it (`img.float() / 255.0` of the
    eval step), so that both folders give the model the same inputs: the
    float IR reaches it unscaled, as in JAX. `val --data` in bf16 on each
    (PER_FORWARD), the tiles of the aerial folder against the python
    source's, C++ = numpy on its files."""
    import numpy as np
    import torch
    from sodt_tpu_torch.data import native_loader, tiff
    scaled = lambda ir: (torch.from_numpy(np.ascontiguousarray(
        ir[..., 0])).cuda().float() / 255.0).cpu().numpy()
    root = workdir / "aerial_tif"
    fold = _aerial_folder(root, items, stems, scaled)
    twin = workdir / "aerial_twin"
    decoded = [(tiff.read_tiff(root / "images" / f"{s}_co.tif"), ir, lab)
               for (_, ir, lab), s in zip(items, stems)]
    twin_write = _write_png_folder(twin, decoded, stems, None)
    files = sorted((root / "images").iterdir())
    cpp_equal = all(_bit_equal(native_loader.decode_tiff(f),
                               tiff.read_tiff(f)) for f in files)
    ir_exact = all(np.array_equal(tiff.read_tiff(root / "images" /
                                                 f"{s}_ir.tif")[..., 0],
                                  scaled(ir))
                   for (_, ir, _), s in zip(items, stems))
    evals = {"aerial": _tie_val(root, stems, "tif"),
             "png": _tie_val(twin, stems, "png")}
    tiles = _native_tiles(fold)
    ok = (all(evals["aerial"][k] == evals["png"][k] for k in ("map50", "map"))
          and all(e["launches_ok"] and e["seen"] == len(stems)
                  for e in evals.values())
          and tiles["bit_equal"] and twin_write["bit_equal"] and cpp_equal
          and ir_exact and evals["png"]["map50"] > 0.5)
    return {**evals, "tiles_bit_equal": tiles["bit_equal"],
            "cpp_equals_numpy": cpp_equal, "ir_samples_exact": ir_exact,
            "predicted": BT_AERIAL_PREDICTED["tie"], "ok": bool(ok)}


def _aerial_decode_ms(workdir: Path) -> dict:
    """(e): ms to decode one 1024 px aerial pair (JPEG_PAIRS pairs of
    `SyntheticVedai(seed=5)`, as (c)): the tile loader at 1024 px on its
    pool and held to one core, the C++ decode of `_read_image` on the
    calling thread (`_native_tiles`), and the numpy decoder on the first
    pair, twice."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, tiff
    src = SyntheticVedai(n=JPEG_PAIRS, img_size=JPEG_RAW, nc=8, seed=5)
    stems = [f"{i:08d}" for i in range(JPEG_PAIRS)]
    root = workdir / "aerial1024"
    nat = _native_tiles(_aerial_folder(
        root, (src[i] for i in range(JPEG_PAIRS)), stems,
        lambda ir: ir[..., 0] / np.float32(255)), JPEG_RAW)
    numpy_ms = []
    for _ in range(2):
        t = time.perf_counter()
        for m in ("co", "ir"):
            tiff.read_tiff(root / "images" / f"{stems[0]}_{m}.tif")
        numpy_ms.append(1e3 * (time.perf_counter() - t))
    keys = {"cpp_pool": "native_ms_per_pair",
            "cpp_one_core": "native_ms_per_pair_one_core",
            "cpp_calling_thread": "python_ms_per_pair"}
    return {"side": JPEG_RAW, "pairs": JPEG_PAIRS,
            "bytes_per_pair": sum(p.stat().st_size for p in
                                  (root / "images").iterdir()) / JPEG_PAIRS,
            "tiles": nat, "numpy_ms_per_pair": numpy_ms,
            "median": {**{k: float(np.median(nat[v])) if nat.get(v) else None
                          for k, v in keys.items()},
                       "numpy": float(np.median(numpy_ms))},
            "predicted": BT_AERIAL_PREDICTED["aerial_1024_pair_ms"]}


def phase_bmp_tiff(label: str, workdir: Path, trained: dict) -> dict:
    """The port's BMP and TIFF decoders on the card's machine (module doc,
    phase `bmp_tiff`); (a)-(c) each print a line of their own."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, bmp, native_loader, tiff

    trained_weights()
    t0 = time.perf_counter()
    row, ok = {"phase": label}, True
    if native_loader.load_error() is not None:
        raise RuntimeError(native_loader.load_error())

    # (a) the C++ decoders against the numpy ones on the checked-in files
    files = sorted(BT_FIXTURES.glob("*.bmp")) + sorted(
        BT_FIXTURES.glob("*.tif"))
    fixtures = {}
    for f in files:
        cpp, plain = ((native_loader.decode_bmp, bmp.read_bmp)
                      if f.suffix == ".bmp"
                      else (native_loader.decode_tiff, tiff.read_tiff))
        a, b = cpp(f), plain(f)
        fixtures[f.name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                            "bit_equal": _bit_equal(a, b)}
    damaged = _damaged_agree(files, workdir / "bt_damaged")
    ok_a = (len(files) >= 40 and all(v["bit_equal"]
                                     for v in fixtures.values())
            and damaged["agree"] == damaged["files"])
    emit({"phase": f"{label}_fixtures", "files": fixtures,
          "damaged": damaged, "ok": ok_a})
    ok = ok and ok_a

    # (b) the same pixels as BMP, as TIFF and as PNG: tiles, one mAP
    src = SyntheticVedai(n=JPEG_N, img_size=512, nc=8, seed=1)
    items = [src[i] for i in range(JPEG_N)]
    stems = [f"{i:08d}" for i in range(JPEG_N)]
    twin = workdir / "trained_bt_as_png"
    twin_write = _write_png_folder(twin, items, stems, None)
    evals, tiles = {"png": _tie_val(twin, stems, "png")}, {}
    for ext in ("bmp", "tif"):
        root = workdir / f"trained_{ext}"
        fold = _write_bt_folder(root, items, stems, ext)
        tiles[ext] = _native_tiles(fold)
        evals[ext] = _tie_val(root, stems, ext)
    ok_b = (all(evals[e][k] == evals["png"][k] for e in ("bmp", "tif")
                for k in ("map50", "map"))
            and all(e["launches_ok"] and e["seen"] == JPEG_N
                    for e in evals.values())
            and all(t["bit_equal"] for t in tiles.values())
            and twin_write["bit_equal"] and evals["png"]["map50"] > 0.5)
    trained_bf16 = (trained or {}).get("runs", {}).get("bf16")
    emit({"phase": f"{label}_tie", **evals,
          "tiles_bit_equal": {e: t["bit_equal"] for e, t in tiles.items()},
          "trained_bf16": ({k: trained_bf16[k] for k in ("map50", "map")}
                           if trained_bf16 else None), "ok": ok_b})
    ok = ok and ok_b

    # (c) decode ms of a 1024 px pair, beside the card
    dec = {ext: _bt_decode_ms(workdir, ext) for ext in ("bmp", "tif")}
    ok = ok and all(d["tiles"]["bit_equal"] for d in dec.values())
    emit({"phase": f"{label}_decode_ms", "card": card_line(), **dec})

    # (d) aerial TIFF (YCbCr JPEG RGB, float32 IR): one mAP with its PNG
    # twin; (e) the decode ms of a 1024 px such pair
    t_de = time.perf_counter()
    aerial = _aerial_tie(workdir, items[:BT_AERIAL_N], stems[:BT_AERIAL_N])
    emit({"phase": f"{label}_aerial_tie", **aerial})
    aerial_dec = _aerial_decode_ms(workdir)
    emit({"phase": f"{label}_aerial_decode_ms", "card": card_line(),
          **aerial_dec, "parts_d_e_s": time.perf_counter() - t_de,
          "parts_d_e_s_predicted": BT_AERIAL_PREDICTED["parts_d_e_s"]})
    ok = ok and aerial["ok"] and aerial_dec["tiles"]["bit_equal"]
    row.update(fixtures_ok=ok_a, tie=evals,
               tiles_bit_equal={e: t["bit_equal"] for e, t in tiles.items()},
               decode_ms={e: d["median"] for e, d in dec.items()},
               aerial_tie={k: aerial[k] for k in ("aerial", "png", "ok")},
               aerial_decode_ms=aerial_dec["median"],
               wall_s=time.perf_counter() - t0, launches={}, ok=bool(ok))
    emit(row)
    return row


# ------------------------------------------------------------------- webp

WEBP_FIXTURES = Path("tests/torch_port_webp")
WEBP_Q90 = WEBP_FIXTURES / "vedai_q90"       # 4 pairs of `trained`'s source
WEBP_LOSSY_N = 4
WEBP_PAIR_1024 = "00001024"                  # SyntheticVedai(1, 1024, seed 2)
WEBP_NUMPY_LOSSLESS_SIDE = 128               # numpy's lossless timing side
# written before this phase first ran on the card (PERF.md, section 6)
WEBP_PREDICTED = {
    "fixtures_bit_equal": "all 60, and the 240 damaged copies agree",
    "lossless_tie": "mAP@0.5 and mAP equal to the PNG twin's (lossless: "
                    "the same pixels), tiles bit-equal",
    "lossy_tie": "equal to the PNG twin of the numpy decode, tiles equal",
    "lossless_1024_pair_ms": {"cpp_pool": "15-40", "cpp_one_core": "25-60",
                              "cpp_calling_thread": "40-80"},
    "lossy_1024_pair_ms": {"cpp_pool": "35-80", "cpp_one_core": "45-100",
                           "cpp_calling_thread": "55-110"},
    "numpy_ms": "lossy 512 px pair 1200-2500; lossless 128 px pair 40-120",
    "phase_s": "25-40",
}


def _webp_folder(root: Path, twin: Path, stems: list) -> str:
    """`root/images` beside the PNG twin's labels: the twin's label files
    copied, the fold list of `<stem>_co.webp` written; returns it."""
    (root / "labels").mkdir(parents=True, exist_ok=True)
    for stem in stems:
        (root / "labels" / f"{stem}.txt").write_bytes(
            (twin / "labels" / f"{stem}.txt").read_bytes())
    fold = root / "fold.txt"
    fold.write_text("".join(f"{root / 'images' / s}_co.webp\n"
                            for s in stems))
    return str(fold)


def _webp_decode_ms(workdir: Path, lossless_pair, plain_sources,
                    lossy_numpy_ms: float) -> dict:
    """ms to decode one 1024 px WebP pair, lossless (the tests' VP8L
    writer) and lossy (the checked-in pair at quality 90): `_native_tiles`
    at 1024 px (decode and copy, no resize) gives the tile loader on its
    pool, held to one core, and the C++ decode of `_read_image` on the
    calling thread. The numpy decoder, being slow, is timed on smaller
    files (`plain_sources`): a lossless 128 px pair here, twice, and the
    lossy 512 px pair that (b) decoded once (`lossy_numpy_ms`)."""
    import numpy as np
    import shutil
    from sodt_tpu_torch.data import webp
    from torch_port_common import write_webp_lossless
    out, keys = {}, {"cpp_pool": "native_ms_per_pair",
                     "cpp_one_core": "native_ms_per_pair_one_core",
                     "cpp_calling_thread": "python_ms_per_pair"}
    for kind in ("lossless", "lossy"):
        root = workdir / f"webp1024_{kind}"
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        for m in ("co", "ir"):
            dst = root / "images" / f"{WEBP_PAIR_1024}_{m}.webp"
            if kind == "lossy":
                shutil.copyfile(WEBP_Q90 / dst.name, dst)
            else:
                write_webp_lossless(dst, lossless_pair[m])
        (root / "labels" / f"{WEBP_PAIR_1024}.txt").write_text(
            "0 0.5 0.5 0.2 0.2\n")
        fold = root / "fold.txt"
        fold.write_text(f"{root / 'images' / WEBP_PAIR_1024}_co.webp\n")
        nat = _native_tiles(str(fold), 1024)
        numpy_ms = [lossy_numpy_ms] if kind == "lossy" else []
        for _ in range(0 if kind == "lossy" else 2):
            t = time.perf_counter()
            for p in plain_sources[kind]:
                webp.read_webp(p)
            numpy_ms.append(1e3 * (time.perf_counter() - t))
        out[kind] = {
            "bytes_per_pair": sum(p.stat().st_size for p in
                                  (root / "images").iterdir()),
            "tiles": nat, "numpy_ms_per_pair": numpy_ms,
            "numpy_pair": [f"{Path(p).name}: {webp.webp_size(p)}"
                           for p in plain_sources[kind]],
            "median": {**{k: float(np.median(nat[v])) if nat.get(v) else None
                          for k, v in keys.items()},
                       "numpy": float(np.median(numpy_ms))}}
    return out


def phase_webp(label: str, workdir: Path, trained: dict) -> dict:
    """The port's WebP decoder on the card's machine (module doc, phase
    `webp`); (a)-(c) each print a line of their own."""
    import numpy as np
    from sodt_tpu_torch.data import SyntheticVedai, native_loader, webp
    from sodt_tpu_torch.data.png import write_png
    sys.path.insert(0, str(Path("tests").resolve()))
    from torch_port_common import write_webp_lossless

    trained_weights()
    t0 = time.perf_counter()
    row, ok = {"phase": label, "predicted": WEBP_PREDICTED}, True
    if native_loader.load_error() is not None:
        raise RuntimeError(native_loader.load_error())

    # (a) the C++ decoder against the numpy one on the checked-in files
    files = sorted(WEBP_FIXTURES.glob("*.webp"))
    fixtures = {}
    for f in files:
        res = []
        for read in (native_loader.decode_webp, webp.read_webp):
            try:
                res.append(read(f))
            except NotImplementedError:             # the animated file
                res.append(NotImplementedError)
        a, b = res
        same = (a is b) if isinstance(a, type) else (
            not isinstance(b, type) and a.shape == b.shape
            and np.array_equal(a, b))
        fixtures[f.name] = {"shape": None if isinstance(a, type)
                            else list(a.shape), "bit_equal": bool(same)}
    damaged = _damaged_agree(files, workdir / "webp_damaged")
    ok_a = (len(files) >= 30 and all(v["bit_equal"]
                                     for v in fixtures.values())
            and damaged["agree"] == damaged["files"])
    emit({"phase": f"{label}_fixtures", "files": fixtures,
          "damaged": damaged, "ok": ok_a})
    ok = ok and ok_a

    # (b) trained's images as lossless WebP (the tests' VP8L writer) and 4
    # of them as the checked-in lossy pairs, each beside a PNG twin
    src = SyntheticVedai(n=JPEG_N, img_size=512, nc=8, seed=1)
    items = [src[i] for i in range(JPEG_N)]
    stems = [f"{i:08d}" for i in range(JPEG_N)]
    twin = workdir / "trained_webp_as_png"
    twin_write = _write_png_folder(twin, items, stems, None)
    evals, tiles = {"png": _tie_val(twin, stems, "png")}, {}
    ll = workdir / "trained_webp_lossless"
    (ll / "images").mkdir(parents=True)
    for (rgb, ir, _), stem in zip(items, stems):
        write_webp_lossless(ll / "images" / f"{stem}_co.webp", rgb)
        write_webp_lossless(ll / "images" / f"{stem}_ir.webp", ir[..., 0])
    tiles["lossless"] = _native_tiles(_webp_folder(ll, twin, stems))
    evals["lossless"] = _tie_val(ll, stems, "webp")
    lossy_stems = stems[:WEBP_LOSSY_N]
    lossy, lossy_twin = (workdir / "trained_webp_q90",
                         workdir / "trained_webp_q90_as_png")
    (lossy / "images").mkdir(parents=True)
    (lossy_twin / "images").mkdir(parents=True)
    (lossy_twin / "labels").mkdir()
    numpy_equal, numpy_ms = True, []
    for stem in lossy_stems:
        for m in ("co", "ir"):
            name = f"{stem}_{m}.webp"
            (lossy / "images" / name).write_bytes(
                (WEBP_Q90 / name).read_bytes())
            t = time.perf_counter()
            px = webp.read_webp(WEBP_Q90 / name)
            numpy_ms.append(1e3 * (time.perf_counter() - t))
            numpy_equal = numpy_equal and np.array_equal(
                px, native_loader.decode_webp(WEBP_Q90 / name))
            write_png(lossy_twin / "images" / f"{stem}_{m}.png", px)
        (lossy_twin / "labels" / f"{stem}.txt").write_bytes(
            (twin / "labels" / f"{stem}.txt").read_bytes())
    tiles["lossy"] = _native_tiles(_webp_folder(lossy, twin, lossy_stems))
    evals["lossy"] = _tie_val(lossy, lossy_stems, "webp")
    evals["lossy_png"] = _tie_val(lossy_twin, lossy_stems, "png")
    ok_b = (all(evals["lossless"][k] == evals["png"][k]
                and evals["lossy"][k] == evals["lossy_png"][k]
                for k in ("map50", "map"))
            and all(e["launches_ok"] for e in evals.values())
            and evals["png"]["seen"] == evals["lossless"]["seen"] == JPEG_N
            and evals["lossy"]["seen"] == evals["lossy_png"]["seen"]
            == WEBP_LOSSY_N
            and all(t["bit_equal"] for t in tiles.values())
            and twin_write["bit_equal"] and numpy_equal
            and evals["png"]["map50"] > 0.5)
    trained_bf16 = (trained or {}).get("runs", {}).get("bf16")
    emit({"phase": f"{label}_tie", **evals,
          "tiles_bit_equal": {e: t["bit_equal"] for e, t in tiles.items()},
          "lossy_numpy_equals_cpp": bool(numpy_equal),
          "lossy_numpy_ms_per_image": numpy_ms,
          "trained_bf16": ({k: trained_bf16[k] for k in ("map50", "map")}
                           if trained_bf16 else None), "ok": ok_b})
    ok = ok and ok_b

    # (c) decode ms of a 1024 px pair, beside the card
    big = SyntheticVedai(n=1, img_size=1024, nc=8, seed=2)[0]
    small = SyntheticVedai(n=1, img_size=WEBP_NUMPY_LOSSLESS_SIDE, nc=8,
                           seed=2)[0]
    small_dir = workdir / "webp_numpy_lossless"
    small_dir.mkdir()
    plain = {"lossy": [WEBP_Q90 / f"{lossy_stems[0]}_{m}.webp"
                       for m in ("co", "ir")],
             "lossless": [small_dir / f"small_{m}.webp"
                          for m in ("co", "ir")]}
    write_webp_lossless(plain["lossless"][0], small[0])
    write_webp_lossless(plain["lossless"][1], small[1][..., 0])
    dec = _webp_decode_ms(workdir, {"co": big[0], "ir": big[1][..., 0]},
                          plain, numpy_ms[0] + numpy_ms[1])
    ok = ok and all(d["tiles"]["bit_equal"] for d in dec.values())
    emit({"phase": f"{label}_decode_ms", "card": card_line(), **dec})
    row.update(fixtures_ok=ok_a, tie=evals,
               tiles_bit_equal={e: t["bit_equal"] for e, t in tiles.items()},
               decode_ms={e: d["median"] for e, d in dec.items()},
               wall_s=time.perf_counter() - t0, launches={}, ok=bool(ok))
    emit(row)
    return row


# the eval protocol's extras and the serving path on the trained weights
# (phase eval_extras). A TTA step runs three forwards: 512 px (PER_FORWARD);
# the lr-flipped 0.83 pass padded to 448 px, whose stage 1 (112 x 112) and
# stage 2 (56 x 56) stay on the window grid and whose stage 3 (28 x 28)
# pads to one window for K8 (PER_FORWARD); the 0.67 pass at 352 px, whose
# stage 2 (44 x 44) leaves the grid (OFF_FORWARD: K1 instead of K5-K7)
TTA_STEP = {k: 2 * PER_FORWARD[k] + OFF_FORWARD[k] for k in PER_FORWARD}
# TTA's mAP@0.5 and mAP against JAX's f32 TTA values from the sidecar
TTA_TOL = {"bf16": 2e-2, "f32": 5e-3}
# an NMS ensemble of two flagships: two forwards a step
ENSEMBLE_STEP = {k: 2 * v for k, v in PER_FORWARD.items()}
# its second member: the trained weights with every bias and BatchNorm
# running mean moved by 0.05 N(0, 1) and every running variance scaled by
# 1 + 0.1 U(-1, 1), drawn from ENSEMBLE_SEED (the moves of the CPU tests'
# randomize_variables), so that it puts candidates of its own above the
# conf gate; the bf16 ensemble is held to the same ensemble on the f32
# plain path within `trained`'s bounds (TRAINED_BF16_TOL, TRAINED_MAP_TOL)
ENSEMBLE_SEED = 7
HYBRID_MAP50 = 0.99
# --task study: stage 2 stays on the window grid at all three sizes, and
# stage 3 (24, 40 and 64 px maps) takes one K8 launch over one or four
# padded windows, so each forward launches PER_FORWARD
STUDY_SIZES = (384, 640, 1024)
STUDY_FORWARD = PER_FORWARD
SERVE_N = 16          # the Predictor's images: `trained`'s 16, at 512 px
# the Predictor in bf16 against the same Predictor on the f32 plain model:
# each detection of either side whose confidence is at least the 0.25 gate
# plus SERVE_CONF_TOL has a partner of its class on the other side at IoU
# >= SERVE_IOU, with every corner within SERVE_BOX_PX native pixels and the
# confidence within SERVE_CONF_TOL
SERVE_BOX_PX = 3.0
SERVE_IOU = 0.9
SERVE_CONF_TOL = 0.05
# written before this phase first ran on the card (PERF.md, section 6)
EXTRAS_PREDICTED = {
    "tta_map50_bf16": "0.96-0.99 (JAX f32 TTA 0.97856)",
    "tta_map_bf16": "0.680-0.695 (JAX f32 TTA 0.69288)",
    "tta_f32_minus_jax": "< 1e-4 on both",
    "tta_launches_per_step": "TTA_STEP",
    "tta_step_ms_over_plain": "2.0-3.0x",
    "ensemble_map50": "0.97-0.995 (the perturbed member's candidates "
                      "merged with the trained model's)",
    "ensemble_bf16_minus_f32": "|mAP@0.5| < 5e-3, |mAP| < 1e-2",
    "ensemble_second_member_candidates": "> 1000 above obj 0.001 on 4 "
                                         "images",
    "predictor_bf16_vs_f32": "every confident detection matched, IoU >= "
                             "0.97, corners <= 1 px, conf <= 0.02",
    "hybrid_map50": ">= 0.99 (CPU f32 0.99535)",
    "exports_map": "equal to folders' to the digit",
    "study_map50": {"384": "0.85-0.99", "640": "0.9-0.99",
                    "1024": "0.5-0.95"},
    "study_speed_ms": {"384": "12-15", "640": "12-15", "1024": "15-25"},
    "predictor_ms_per_image": "2-6",
    "detect_wall_ms_per_image": "200-400"}


# phase eval_runner: the whole-pass eval (`train.evaluate.EvalRunner`) on
# the trained flagship at 512 px, batch 4, bf16, over 8 batches
RUNNER_N = 32
RUNNER_BATCHES = RUNNER_N // MAIN_BATCH
RUNNER_SEED = 11           # the second weight set's perturbation
RUNNER_PREDICTED = {
    "whole_pass_over_per_batch_ms_a_batch": [0.85, 1.0],
    "why": "the host still issues ~292 forward launches and ~2,400 of the "
           "NMS loop a batch; the pass removes one wait a batch, not the "
           "launches (a CUDA graph over the pass is the later gain)",
    "async_blocking_ckpt": "falls from fetch + write to the snapshot alone",
}
# the asynchronous save: the flagship at 128 px, 8 images, batch 4 (2 steps
# an epoch), the flat one-cycle schedule (lrf 1) so that epoch 0 of a
# 2-epoch run is the whole of a 1-epoch run
ASYNC_ARGS = ["--synthetic", "--synthetic-n", "8", "--img-size", "128",
              "--batch-size", "4", "--nbs", "4", "--noautoanchor"]


def _trained_model(dtype, path: str = TRAINED_NPZ):
    import torch
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    model = build_model("configs/model.yaml", ch_in=4, dtype=dtype)
    model.load_state_dict(load_weights(path))
    return cache_rel_bias(model.cuda().eval())


def perturb_state(sd: dict, seed: int) -> dict:
    """`sd` with its biases and BatchNorm means moved by 0.05 x N(0, 1)
    and its BatchNorm variances scaled by 1 +- 0.1, from `seed`, in
    place."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k in sorted(sd):
            v = sd[k]
            if k.endswith((".bias", ".running_mean")):
                v.add_(0.05 * torch.randn(v.shape, generator=g))
            elif k.endswith(".running_var"):
                v.mul_(1 + 0.1 * (2 * torch.rand(v.shape, generator=g) - 1))
    return sd


def perturbed_trained_file(workdir: Path) -> str:
    """The ensemble's second member (ENSEMBLE_SEED) as an .npz."""
    from sodt_tpu_torch.train.checkpoint import load_weights
    from sodt_tpu_torch.weights import save_npz
    sd = perturb_state(load_weights(TRAINED_NPZ), ENSEMBLE_SEED)
    path = workdir / "trained_perturbed.npz"
    save_npz(sd, path)
    return str(path)


def _extras_ensemble(workdir: Path) -> tuple[dict, bool]:
    """`val --weights trained,perturbed` in bf16 (ENSEMBLE_STEP launches a
    step) and on the f32 plain path, held to each other within `trained`'s
    bounds; then on one batch of 4, the ensemble's eval step against one
    NMS over both members' own decoded candidates (bit-equal) and against
    the first member's step alone (unlike it)."""
    import torch
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.models.detect import decode_detections
    from sodt_tpu_torch.ops.nms import batched_nms
    from sodt_tpu_torch.train.evaluate import make_eval_step
    pert = perturbed_trained_file(workdir)
    args = TRAINED_ARGS[:-1] + [f"{TRAINED_NPZ},{pert}"]
    out, ok = {}, True
    for tag, extra, want in (("bf16", [], ENSEMBLE_STEP),
                             ("f32", ["--no-bf16"],
                              {k: 0 for k in PER_FORWARD})):
        m, per, _ = _val_counted(extra + args, TRAINED_FORWARDS)
        out[tag] = {"map50": m["map50"], "map": m["map"],
                    "launches_per_step": per}
        ok = ok and (per == {k: float(v) for k, v in want.items()}
                     and m["seen"] == 16
                     and all(math.isfinite(m[k]) for k in ("map50", "map")))
    gap = {k: out["bf16"][k] - out["f32"][k] for k in ("map50", "map")}
    out["bf16_minus_f32"] = gap
    ok = ok and (abs(gap["map50"]) <= TRAINED_BF16_TOL
                 and abs(gap["map"]) <= TRAINED_MAP_TOL["bf16"])

    members = [_trained_model(torch.bfloat16),
               _trained_model(torch.bfloat16, pert)]
    b = next(make_eval_batches(SyntheticVedai(n=MAIN_BATCH, img_size=512,
                                              nc=8, seed=1), MAIN_BATCH, 512))
    img = torch.from_numpy(b["img"]).cuda().float() / 255
    ir = torch.from_numpy(b["ir"]).cuda().float() / 255
    with torch.no_grad():
        preds = [decode_detections(m(img, ir)["raw"], m.anchors_per_level,
                                   m.strides) for m in members]
        want_d, want_v = batched_nms(torch.cat(preds, 1), conf_thres=0.001,
                                     iou_thres=0.6, multi_label=True,
                                     max_det=300, top_k=4096, merge=True)
    ens_d, ens_v, _ = make_eval_step(members)(img, ir)
    one_d, one_v, _ = make_eval_step(members[0])(img, ir)
    out["step"] = {
        "second_member_candidates": int((preds[1][..., 4] > 0.001).sum()),
        "survivors": int(ens_v.sum()), "first_member_survivors":
            int(one_v.sum()),
        "equal_to_nms_of_both": bool(torch.equal(ens_d, want_d)
                                     and torch.equal(ens_v, want_v)),
        "unlike_first_member": not (torch.equal(ens_d, one_d)
                                    and torch.equal(ens_v, one_v))}
    ok = ok and (out["step"]["second_member_candidates"] > 0
                 and out["step"]["equal_to_nms_of_both"]
                 and out["step"]["unlike_first_member"])
    return out, bool(ok)


def _det_gap(got: list, ref: list, gate: float) -> dict:
    """Each detection (x1, y1, x2, y2, conf, cls) of either side whose
    confidence is at least `gate`, paired with the other side's detection
    of its class of highest IoU: the worst IoU, corner gap (px) and
    confidence gap over the pairs, and how many found no partner."""
    import numpy as np
    gap = {"pairs": 0, "unmatched": 0, "min_iou": 1.0, "max_corner_px": 0.0,
           "max_conf": 0.0}
    for a_all, b_all in [*zip(got, ref), *zip(ref, got)]:
        for d in a_all[a_all[:, 4] >= gate]:
            same = b_all[b_all[:, 5] == d[5]]
            if not len(same):
                gap["unmatched"] += 1
                continue
            lt = np.maximum(d[:2], same[:, :2])
            rb = np.minimum(d[2:4], same[:, 2:4])
            inter = np.clip(rb - lt, 0, None).prod(1)
            area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
            iou = inter / (area(d) + area(same) - inter)
            j = int(iou.argmax())
            gap["pairs"] += 1
            gap["min_iou"] = min(gap["min_iou"], float(iou[j]))
            gap["max_corner_px"] = max(gap["max_corner_px"], float(
                np.abs(d[:4] - same[j, :4]).max()))
            gap["max_conf"] = max(gap["max_conf"],
                                  float(abs(d[4] - same[j, 4])))
    return gap


def _val_counted(args: list[str], steps: int) -> tuple[dict, dict, float]:
    """`val.main(args)` with the launch counts set to 0 just before: the
    metrics, the launches per step and the wall seconds."""
    from sodt_tpu_torch import kernels, val
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = val.main(args)
    wall = time.perf_counter() - t0
    return m, {k: v / steps for k, v in kernels.launches().items()}, wall


def _extras_tta(side: dict) -> tuple[dict, bool]:
    """`val --augment` in bf16 and on the f32 plain path against JAX's f32
    TTA; the TTA step's ms beside the plain step's (bf16, batch 4)."""
    import torch
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.train.evaluate import make_eval_step
    ref = side["jax_f32_tta_eval"]
    out, ok = {"jax_f32_tta": {k: ref[k] for k in ("map50", "map")}}, True
    for tag, extra, want in (("bf16", [], TTA_STEP),
                             ("f32", ["--no-bf16"],
                              {k: 0 for k in PER_FORWARD})):
        m, per, wall = _val_counted(["--augment"] + extra + TRAINED_ARGS,
                                    TRAINED_FORWARDS)
        gap = {k: m[k] - ref[k] for k in ("map50", "map")}
        out[tag] = {"map50": m["map50"], "map": m["map"],
                    "minus_jax_f32_tta": gap, "speed_ms": m["speed_ms"],
                    "wall_s": wall, "launches_per_step": per}
        ok = ok and (per == {k: float(v) for k, v in want.items()}
                     and m["seen"] == 16
                     and all(abs(g) <= TTA_TOL[tag] for g in gap.values()))
    model = _trained_model(torch.bfloat16)
    b = next(make_eval_batches(SyntheticVedai(n=MAIN_BATCH, img_size=512,
                                              nc=8, seed=1), MAIN_BATCH, 512))
    img = torch.from_numpy(b["img"]).cuda()
    ir = torch.from_numpy(b["ir"]).cuda()
    for tag, aug in (("plain_step_ms", False), ("tta_step_ms", True)):
        step = make_eval_step(model, augment=aug)
        out[tag] = time_ms(lambda: step(img, ir), iters=5, warmup=2)
    out["tta_over_plain"] = out["tta_step_ms"] / out["plain_step_ms"]
    return out, ok


def _extras_exports(workdir: Path, folders: dict) -> tuple[dict, bool]:
    """`val --data` on phase `folders`' 1024 px folder with --save-json
    --save-txt --save-conf, square and --rect: mAP equal to `folders`' own
    to the last digit, one json record a txt line, every box inside its
    image's frame (the 512 px one the dataset resizes the 1024 px pairs
    to: the exports are in that frame, in JAX too)."""
    root = workdir / "vedai1024"
    data = str(root / "data.yaml")
    out, ok = {}, True
    for tag, extra, want in (("square", [], PER_FORWARD),
                             ("rect", ["--rect"], RECT_FORWARD)):
        d = workdir / f"exports_{tag}"
        m, per, _ = _val_counted(
            FOLDER_VAL + ["--data", data, "--save-json", "--save-txt",
                          "--save-conf", "--save-dir", str(d)] + extra,
            FOLDER_FORWARDS)
        recs = json.loads((d / "predictions.json").read_text())
        lines = [ln for f in sorted((d / "labels").iterdir())
                 for ln in f.read_text().splitlines()]
        inside = all(min(r["bbox"]) >= 0
                     and r["bbox"][0] + r["bbox"][2] <= 512 + 1e-3
                     and r["bbox"][1] + r["bbox"][3] <= 512 + 1e-3
                     for r in recs)
        six = all(len(ln.split()) == 6 for ln in lines)
        want_m = folders["eval"][tag]
        out[tag] = {"map50": m["map50"], "map": m["map"],
                    "folders": {k: want_m[k] for k in ("map50", "map")},
                    "records": len(recs), "txt_lines": len(lines),
                    "txt_files": len(list((d / "labels").iterdir())),
                    "boxes_inside": inside, "launches_per_forward": per,
                    "per_class_files": sorted(
                        p.name for p in d.glob("per_class.*"))}
        ok = ok and (all(m[k] == want_m[k] for k in ("map50", "map"))
                     and len(recs) == len(lines) > 0 and inside and six
                     and per == {k: float(v) for k, v in want.items()}
                     and out[tag]["per_class_files"] == [
                         "per_class.csv", "per_class.xlsx"])
    return out, ok


def _extras_study() -> tuple[list, bool]:
    """`val --task study --study-sizes 384,640,1024` on the trained
    weights: one row per size with its launches per forward."""
    from sodt_tpu_torch import kernels, val
    counts, orig = {}, val.run_map

    def counted(a, size):
        kernels.reset_launches()
        m = orig(a, size)
        counts[size] = {k: v / TRAINED_FORWARDS
                        for k, v in kernels.launches().items()}
        return m
    val.run_map = counted
    try:
        args = TRAINED_ARGS[:]
        args[args.index("val")] = "study"
        rows = val.main(args + ["--study-sizes",
                                ",".join(map(str, STUDY_SIZES))])["study"]
    finally:
        val.run_map = orig
    ok = [r["img_size"] for r in rows] == list(STUDY_SIZES)
    for r in rows:
        r["launches_per_forward"] = counts.get(r["img_size"])
        ok = ok and (all(math.isfinite(r[k])
                         for k in ("map50", "map", "speed_ms"))
                     and r["launches_per_forward"] == {
                         k: float(v) for k, v in STUDY_FORWARD.items()})
    return rows, bool(ok)


def _extras_serving(workdir: Path) -> tuple[dict, bool]:
    """The Predictor on `trained`'s 16 images at their native 512 px in
    bf16, bit-equal to its own eval step after scale_coords; then
    `python -m sodt_tpu_torch.detect` over the 1024 px `_co` / `_ir`
    folder with --save-txt, its per-image counts held to the Predictor's
    on the same decoded pairs (one image a call, as detect runs)."""
    import numpy as np
    import torch
    from sodt_tpu_torch import detect, kernels
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.data.vedai import _read_image
    from sodt_tpu_torch.models.infer import Predictor
    from sodt_tpu_torch.ops.boxes import scale_coords

    pred = Predictor(_trained_model(torch.bfloat16), 512)
    ds = SyntheticVedai(n=SERVE_N, img_size=512, nc=8, seed=1)
    rgbs, irs = zip(*[ds[i][:2] for i in range(SERVE_N)])
    kernels.reset_launches()
    res = pred(list(rgbs), ir=list(irs))
    launches = kernels.launches()
    dets, valid, _ = pred.step(pred.letterbox(rgbs), pred.letterbox(irs))
    bit_equal = True
    for i, d in enumerate(res.dets):
        ref = dets[i][valid[i]].cpu().clone()
        ref[:, :4] = scale_coords((512, 512), ref[:, :4], rgbs[i].shape[:2])
        bit_equal = bit_equal and torch.equal(torch.from_numpy(d), ref)
    n_det = sum(len(d) for d in res.dets)
    ms = time_ms(lambda: pred(list(rgbs), ir=list(irs)), iters=3,
                 warmup=1) / SERVE_N
    plain = Predictor(_trained_model(torch.float32), 512)
    kernels.reset_launches()
    res32 = plain(list(rgbs), ir=list(irs))
    plain_launches = sum(kernels.launches().values())
    gap = _det_gap(res.dets, res32.dets, plain.conf + SERVE_CONF_TOL)
    out = {"images": SERVE_N, "detections": n_det, "bit_equal": bit_equal,
           "ms_per_image": ms, "launches": launches,
           "f32_plain_detections": sum(len(d) for d in res32.dets),
           "bf16_vs_f32_plain": gap}
    ok = (bit_equal and n_det > 0 and launches == PER_FORWARD
          and plain_launches == 0 and gap["pairs"] > 0
          and gap["unmatched"] == 0 and gap["min_iou"] >= SERVE_IOU
          and gap["max_corner_px"] <= SERVE_BOX_PX
          and gap["max_conf"] <= SERVE_CONF_TOL)

    images = workdir / "vedai1024" / "images"
    save = workdir / "detect_out"
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = detect.main(["--source", str(images), "--input_mode", "RGB+IR",
                       "--weights", TRAINED_NPZ, "--save-txt", "--save-dir",
                       str(save)])
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    want = []
    for r in got["results"]:
        co = r["source"]
        ir = co.replace("_co.png", "_ir.png")
        want.append(len(pred([_read_image(co)],
                             ir=[_read_image(ir)]).dets[0]))
    files = sorted((save / "labels").iterdir())
    out["detect"] = {
        "images": got["images"], "detections": got["detections"],
        "counts": [r["n"] for r in got["results"]],
        "predictor_counts": want, "label_files": len(files),
        "wall_ms_per_image_build_included": 1e3 * wall / max(
            got["images"], 1),
        "launches_per_image": {k: v / max(got["images"], 1)
                               for k, v in counts.items()}}
    ok = ok and (got["images"] == FOLDER_N and len(files) == FOLDER_N
                 and [r["n"] for r in got["results"]] == want
                 and got["detections"] > 0
                 and out["detect"]["launches_per_image"] == {
                     k: float(v) for k, v in PER_FORWARD.items()}
                 and all(np.isfinite(d).all() for d in res.dets))
    return out, bool(ok)


def phase_eval_extras(label: str, workdir: Path, folders: dict) -> dict:
    """The eval protocol's extras and the serving path on the trained
    flagship (module doc, phase `eval_extras`): TTA, an NMS ensemble,
    hybrid labels, the exports on `folders`' 1024 px folder, --task study,
    the Predictor and the detect CLI. Launch counts are set to 0 just
    before each run and read just after."""
    _, side = trained_weights()
    emit({"phase": f"{label}_predictions", **EXTRAS_PREDICTED})
    row, ok = {"phase": label}, True
    row["tta"], good = _extras_tta(side)
    ok = ok and good

    row["ensemble"], good = _extras_ensemble(workdir)
    ok = ok and good

    m, per, _ = _val_counted(["--save-hybrid"] + TRAINED_ARGS,
                             TRAINED_FORWARDS)
    row["hybrid"] = {"map50": m["map50"], "map": m["map"],
                     "launches_per_forward": per}
    ok = ok and m["map50"] >= HYBRID_MAP50 and per == {
        k: float(v) for k, v in PER_FORWARD.items()}

    if not (folders or {}).get("eval"):
        raise RuntimeError("phase folders gave no folder to export from")
    row["exports"], good = _extras_exports(workdir, folders)
    ok = ok and good
    row["study"], good = _extras_study()
    ok = ok and good
    row["serving"], good = _extras_serving(workdir)
    row.update(launches={}, ok=bool(ok and good))
    emit(row)
    return row


def _stacked(blist) -> tuple:
    import numpy as np
    import torch
    up = lambda k: torch.from_numpy(np.stack([b[k] for b in blist])).cuda()
    return up("img"), up("ir"), up("targets"), up("tmask")


def _per_batch_dets(step, blist) -> list:
    """The per-batch path's detections: the step and a fetch a batch."""
    import torch
    out = []
    for b in blist:
        d, v, _ = step(*(torch.from_numpy(b[k]).cuda() for k in ("img",
                                                                "ir")))
        out.append((d.cpu().numpy(), v.cpu().numpy()))
    return out


def _pass_dets(step, blist, runner=None) -> list:
    """The whole pass's detections, batch by batch."""
    import torch
    from sodt_tpu_torch.train import evaluate as ev
    got, _ = ev._try_scan_eval(step, iter(blist), True, torch.device("cuda"),
                               runner)
    return [b["_results"][:2] for b in got]


def _same_dets(a: list, b: list) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def _same_map(a: dict, b: dict) -> bool:
    keys = set(a) - {"speed_ms"}
    return keys == set(b) - {"speed_ms"} and all(a[k] == b[k] for k in keys)


def _issue_unsynced(runner, stacks) -> tuple:
    """The runner's whole pass with the CUDA sync debug mode at "error"
    around the issue loop (a synchronizing call raises); the one fetch
    after it. Returns the fetched detections and the launch counts of the
    pass."""
    import torch
    from sodt_tpu_torch import kernels
    run = runner.scan_fn()
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dets, valid, _ = run(*stacks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launches()
    return dets.cpu().numpy(), valid.cpu().numpy(), counts


def _runner_weights(seed: int) -> dict:
    """The trained weights with biases and BatchNorm statistics moved
    (`perturb_state`) and every rel-pos table moved by 0.1 x N(0, 1): the
    runner's cached biases and bf16 kernel weights both go stale."""
    import torch
    from sodt_tpu_torch.train.checkpoint import load_weights
    sd = perturb_state(load_weights(TRAINED_NPZ), seed)
    g = torch.Generator().manual_seed(seed)
    for k in sorted(sd):
        if k.endswith("relative_position_bias_table"):
            sd[k].add_(0.1 * torch.randn(sd[k].shape, generator=g))
    return sd


def _async_save(workdir: Path) -> tuple[dict, bool]:
    """(f): `train` at 128 px, 2 epochs, --save-period 1, deterministic
    algorithms; its epoch0.pt against last.pt of the same run cut to 1
    epoch, bit for bit. Beside it the epoch's blocking checkpoint wall
    (events.jsonl wall/ckpt) and the worker's fetch / write, and on the
    final state the synchronous save (fetch + write, as before the worker)
    and the snapshot alone, with the snapshot's device memory."""
    import torch
    import yaml
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train.checkpoint import (checkpoint_tree,
                                                 load_checkpoint,
                                                 snapshot_tree,
                                                 write_checkpoint)
    hyp = yaml.safe_load(Path(resolve_config_path(
        "configs/hyp.scratch.yaml")).read_text())
    workdir = Path(tempfile.mkdtemp(prefix="async_", dir=workdir))
    hyp_path = workdir / "hyp_async.yaml"
    hyp_path.write_text(yaml.safe_dump(dict(hyp, warmup_iters=4, lrf=1.0)))
    kept = {}
    runs = {}
    with deterministic():
        for epochs in (2, 1):
            d = workdir / f"epochs_{epochs}"
            runs[epochs] = d
            _train_cli(ASYNC_ARGS + ["--epochs", str(epochs), "--save-period",
                                     "1", "--hyp", str(hyp_path),
                                     "--save-dir", str(d)],
                       on_step=lambda s, m: kept.update(state=s))
            if epochs == 2:
                state = kept["state"]
    a = load_checkpoint(runs[2] / "epoch0.pt")
    b = load_checkpoint(runs[1] / "last.pt")
    same = lambda x, y: set(x) == set(y) and all(torch.equal(x[k], y[k])
                                                  for k in x)
    opt_same = all(
        (a["opt_state"][f] is None) == (b["opt_state"][f] is None)
        and same(a["opt_state"][f] or {}, b["opt_state"][f] or {})
        for f in ("acc", "trace", "nu"))
    bit_equal = (same(a["model"], b["model"]) and same(a["ema"], b["ema"])
                 and opt_same and all(a[k] == b[k] for k in (
                     "step", "ema_updates", "epoch", "best_fitness"))
                 and a["opt_state"]["count"] == b["opt_state"]["count"])
    with open(runs[2] / "events.jsonl") as f:
        ev = [json.loads(x) for x in f]
    at = lambda key, e: next(r[key] for r in ev
                             if r.get("step") == e and key in r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_checkpoint(workdir / "sync.pt",
                     checkpoint_tree(state, epoch=1, best_fitness=0.0))
    sync_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    snap = snapshot_tree(state, epoch=1, best_fitness=0.0)
    snap_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    snap_bytes = torch.cuda.memory_allocated() - mem0
    del snap
    nparams = sum(p.numel() for p in state.model.parameters())
    row = {"args": ASYNC_ARGS, "epoch0_equals_1_epoch_last": bit_equal,
           "blocking_ckpt_s": {e: at("wall/ckpt", e) for e in (0, 1)},
           "worker_fetch_s": {e: at("wall/ckpt_fetch", e) for e in (0, 1)},
           "worker_write_s": {e: at("wall/ckpt_write", e) for e in (0, 1)},
           "sync_save_s": sync_s, "snapshot_s": snap_s,
           "snapshot_device_bytes": snap_bytes, "params": nparams,
           "step": a["step"]}
    return row, bit_equal and a["step"] == 2


def phase_eval_runner(label: str, workdir: Path) -> dict:
    """The whole-pass eval on the trained flagship (module doc, phase
    `eval_runner`), over SyntheticVedai(n=32, seed=1) at 512 px, batch 4,
    bf16: (a) the pass against the per-batch path, (b) no synchronizing
    call while the pass is issued (plain and TTA), (c) one runner over two
    weight sets, (d) stack_cache, (e) int8, (f) the trainer's asynchronous
    save, (g) the pass's launches (PER_FORWARD x 8). Nothing gives way to
    the per-batch path: a failure anywhere fails the phase. Two modules
    serve every part: `a` (runnerless evals and the pass of (b)) and `b`
    (the runners of (c)-(e), which load their weights into it)."""
    import torch
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train import evaluate as ev
    from sodt_tpu_torch.train.checkpoint import load_weights

    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    emit({"phase": f"{label}_predictions", **RUNNER_PREDICTED})
    blist = list(make_eval_batches(SyntheticVedai(n=RUNNER_N, img_size=512,
                                                  nc=8, seed=1),
                                   MAIN_BATCH, 512))
    kw = dict(nc=8, img_size=512, device="cuda")
    row, ok = {"phase": label, "batches": len(blist)}, True
    sd1, sd2 = load_weights(TRAINED_NPZ), _runner_weights(RUNNER_SEED)

    def module():
        m = build_model("configs/model.yaml", ch_in=4, dtype=torch.bfloat16)
        m.load_state_dict(sd1)
        return ev.cache_rel_bias(m.cuda().eval())
    a, b = module(), module()
    part("setup")

    # (a) the whole pass against the per-batch path; ms a batch of each
    step = ev.make_eval_step(a)
    _pass_dets(step, blist[:2])                               # warm
    _per_batch_dets(step, blist[:2])
    whole = ev.evaluate(a, iter(blist), scan=True, **kw)
    per = ev.evaluate(a, iter(blist), scan=False, **kw)
    per_dets = _per_batch_dets(step, blist)
    dets_equal = _same_dets(_pass_dets(step, blist), per_dets)
    row["a_whole_vs_per_batch"] = {
        "dets_bit_equal": dets_equal, "metrics_equal": _same_map(whole, per),
        "map50": whole["map50"], "map": whole["map"],
        "whole_pass_ms_a_batch": whole["speed_ms"] * MAIN_BATCH,
        "per_batch_ms_a_batch": per["speed_ms"] * MAIN_BATCH}
    ok = ok and dets_equal and _same_map(whole, per) and whole["seen"] == 32
    part("a")

    # (b) + (g) no sync while the pass is issued; the pass's launches
    stacks = _stacked(blist)
    d, v, counts = _issue_unsynced(ev.EvalRunner(a), stacks)
    want = {k: n * RUNNER_BATCHES for k, n in PER_FORWARD.items()}
    _issue_unsynced(ev.EvalRunner(a, augment=True), stacks)
    row["b_no_sync"] = {"plain": True, "tta": True}
    row["g_launches_runner"] = counts
    ok = ok and counts == want and _same_dets(
        [(d[i], v[i]) for i in range(len(blist))], per_dets)
    part("b_g")

    # (c) one runner over two weight sets; (d) stack_cache
    runner = ev.EvalRunner(b)
    m1 = ev.evaluate(sd1, iter(blist), runner=runner, **kw)
    m2 = ev.evaluate(sd2, iter(blist), runner=runner, **kw)
    got2 = _pass_dets(runner.step, blist, runner)
    a.load_state_dict(sd2)
    m2_ref = ev.evaluate(a, iter(blist), **kw)
    ref_dets = _pass_dets(ev.make_eval_step(a), blist)
    c_ok = (_same_map(m2, m2_ref) and _same_dets(got2, ref_dets)
            and _same_map(m1, whole) and not _same_map(m1, m2))
    row["c_two_weight_sets"] = {
        "second_equals_runnerless": _same_map(m2, m2_ref),
        "second_dets_bit_equal": _same_dets(got2, ref_dets),
        "first_equals_a": _same_map(m1, whole),
        "map50": [m1["map50"], m2["map50"]]}
    s1 = ev.evaluate(sd1, iter(blist), runner=runner, stack_cache="val",
                     **kw)
    consumed = []

    def poisoned():
        for batch in blist:
            consumed.append(1)
            yield batch
    s2 = ev.evaluate(sd1, poisoned(), runner=runner, stack_cache="val", **kw)
    d_ok = not consumed and _same_map(s1, whole) and _same_map(s2, whole)
    row["d_stack_cache"] = {"iterator_untouched": not consumed,
                            "metrics_equal": _same_map(s2, whole)}
    ok = ok and c_ok and d_ok
    part("c_d")

    # (e) int8 serving through the runner against its per-batch path
    a.load_state_dict(sd1)
    with kernels.int8_serving():
        r8 = ev.EvalRunner(b)
        w8 = ev.evaluate(sd1, iter(blist), runner=r8, **kw)
        p8 = ev.evaluate(a, iter(blist), scan=False, **kw)
        e_dets = _same_dets(_pass_dets(r8.step, blist, r8),
                            _per_batch_dets(ev.make_eval_step(a), blist))
    row["e_int8"] = {"dets_bit_equal": e_dets,
                     "metrics_equal": _same_map(w8, p8),
                     "map50": w8["map50"],
                     "whole_pass_ms_a_batch": w8["speed_ms"] * MAIN_BATCH,
                     "per_batch_ms_a_batch": p8["speed_ms"] * MAIN_BATCH}
    ok = ok and e_dets and _same_map(w8, p8)
    part("e")

    row["f_async_save"], good = _async_save(workdir)
    ok = ok and good
    part("f")
    row.update(launches=counts, seconds=time.perf_counter() - t_phase,
               seconds_by_part=parts, card=card_line(), ok=bool(ok))
    emit(row)
    return row


def _train_setup(dtype, seed: int = 0, cfg: str = "configs/model.yaml"):
    """The model of `cfg` (the flagship) in training mode with weights from
    `seed`, one synthetic training batch from `seed` on the card, and its
    loss configuration."""
    import yaml
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.models.compiler import resolve_config_path
    from sodt_tpu_torch.train.trainer import loss_config, scale_hyp

    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = yaml.safe_load(f)
    model = seeded_model(cfg, dtype, seed).cuda().train()
    hyp = scale_hyp(dict(hyp, warmup_iters=4), len(model.spec.anchors), 8, 512)
    ds = SyntheticVedai(n=MAIN_BATCH, img_size=512, nc=8, seed=seed)
    return model, plain_batch(ds, seed), hyp, loss_config(model, hyp, 8)


def plain_batch(ds, seed: int) -> dict:
    """One un-augmented training batch of the whole dataset `ds` in a
    seeded order, uint8 images scaled on the card: the input that the
    gradient bounds (GRAD_*) were measured on."""
    import numpy as np
    from sodt_tpu_torch.data import pad_labels
    from sodt_tpu_torch.weights import batch_to_torch
    order = np.random.default_rng(seed * 7919).permutation(len(ds))
    items = [ds[int(i)] for i in order]
    labs = [pad_labels(lab, 30) for _, _, lab in items]
    return batch_to_torch({"img": np.stack([r for r, _, _ in items]),
                           "ir": np.stack([q for _, q, _ in items]),
                           "targets": np.stack([l for l, _ in labs]),
                           "tmask": np.stack([k for _, k in labs])}, "cuda")


def _grad_diff(a: dict, b: dict) -> dict:
    """Relative L2 of gradients a against b over all leaves together, the
    cosine between them, and the worst single leaf among those with at
    least 1e-3 of the largest leaf's norm."""
    num = math.sqrt(sum(((a[k] - b[k]).double() ** 2).sum().item() for k in b))
    den = math.sqrt(sum((b[k].double() ** 2).sum().item() for k in b))
    dot = sum((a[k].double() * b[k].double()).sum().item() for k in b)
    na = math.sqrt(sum((a[k].double() ** 2).sum().item() for k in b))
    norms = {k: b[k].norm().item() for k in b}
    floor = 1e-3 * max(norms.values())
    leaf = {k: ((a[k] - b[k]).norm() / b[k].norm()).item()
            for k in b if norms[k] >= floor}
    worst = max(leaf, key=leaf.get)
    return {"rel_l2_all": num / den, "cosine": dot / (na * den),
            "leaves_compared_singly": len(leaf), "worst_leaf": worst,
            "worst_leaf_rel_l2": leaf[worst]}


def phase_grads() -> dict:
    """Gradients of the detection loss on one training batch, for each
    seed of GRAD_SEEDS: the bf16 kernel path against the f32 plain path on
    the same weights, with BatchNorm on its running statistics (the tight
    bound) and on batch statistics (the training step itself). The raw
    Detect maps of the same two forwards are held beside them: they show
    how far the forward alone moves with the BatchNorm mode."""
    import torch
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.train.loss import compute_loss

    row = {"phase": "grads", "batch": MAIN_BATCH, "seeds": list(GRAD_SEEDS)}
    ok = True
    for seed in GRAD_SEEDS:
        for stats in ("running", "batch"):
            grads, raws = {}, {}
            for dt in (torch.bfloat16, torch.float32):
                model, batch, _, cfg = _train_setup(dt, seed)
                model.train(stats == "batch")
                kernels.reset_launches()
                out = model(batch["img"], batch["ir"])
                total, _ = compute_loss(out["raw"], batch["targets"],
                                        batch["tmask"], cfg)
                names = [k for k, _ in model.named_parameters()]
                gs = torch.autograd.grad(total, list(model.parameters()))
                grads[dt] = dict(zip(names, gs))
                raws[dt] = out["raw"][0].detach().float()
                launched = kernels.launches()
                ok = ok and (launched == PER_STEP if dt == torch.bfloat16
                             else not any(launched.values()))
                del model, out, total
            d = _grad_diff(grads[torch.bfloat16], grads[torch.float32])
            a, b = raws[torch.bfloat16], raws[torch.float32]
            d["raw_maps_rel_l2"] = ((a - b).norm() / b.norm()).item()
            row[f"seed{seed}_{stats}_stats"] = d
            row["leaves"] = len(grads[torch.float32])
            ok = ok and math.isfinite(d["rel_l2_all"]) and all(
                g.dtype == torch.float32
                for g in grads[torch.bfloat16].values())
            if stats == "running":
                ok = ok and (d["rel_l2_all"] <= GRAD_REL_L2
                             and d["worst_leaf_rel_l2"] <= GRAD_WORST_LEAF)
            else:
                ok = ok and d["rel_l2_all"] <= GRAD_REL_L2_BATCH_STATS
    row.update(rel_l2_bound=GRAD_REL_L2, worst_leaf_bound=GRAD_WORST_LEAF,
               rel_l2_bound_batch_stats=GRAD_REL_L2_BATCH_STATS, ok=bool(ok))
    emit(row)
    return row


def _device_rows(prof) -> list[dict]:
    """Device kernels only (`utils.profiler.device_rows`): a host-side op
    (an aten op, an autograd function) carries its kernels' time a second
    time."""
    from sodt_tpu_torch.utils.profiler import device_rows
    return device_rows(prof)


def _categories(rows) -> list[dict]:
    """The 25 largest kernel categories of `rows` with their shares, as
    tools/profile_eval prints them."""
    from sodt_tpu_torch.utils.profiler import breakdown
    return breakdown(rows)["categories"]


def _busy(rows) -> tuple:
    """Device-busy ms and the port's kernels' share of it; None, None where
    no profiler session recorded a kernel."""
    if not rows:
        return None, None
    return (sum(r["device_ms"] for r in rows),
            sum(r["device_ms"] for r in rows if "sodt::" in r["kernel"]))


def _idle(busy, step_ms):
    return None if busy is None else max(0.0, 1 - busy / step_ms)


def phase_profile_train(label: str = "profile_train",
                        cfg: str = "configs/model.yaml") -> None:
    """Kernel-time breakdown of one warm training step (forward, loss,
    backward, optimizer update, EMA) of `cfg`'s model at the train paths'
    shape."""
    import torch
    from sodt_tpu_torch.train.optim import make_optimizer
    from sodt_tpu_torch.train.state import TrainState, make_train_step

    model, batch, hyp, cfg = _train_setup(torch.bfloat16, cfg=cfg)
    tx = make_optimizer(hyp, dict(model.named_parameters()), epochs=2, nb=4)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, cfg)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, batch), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    wall = []

    def run():
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    rows = profiled(run, label)
    wall_ms = wall[-1]
    busy, ours = _busy(rows)
    emit({"phase": label, "batch": MAIN_BATCH, "img": 512,
          "train_step_ms": step_ms, "images_per_s": 1e3 * MAIN_BATCH / step_ms,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "port_kernels_ms": ours,
          "idle_share": _idle(busy, step_ms),
          "peak_memory_bytes": peak, "top": rows[:40],
          "categories": _categories(rows)})


def phase_profile(label: str = "profile",
                  cfg: str = "configs/model.yaml", int8: bool = False) -> None:
    """Kernel-time breakdown of one warm eval step (forward + decode + NMS)
    of `cfg`'s model at the eval paths' shape (int8: in int8 serving)."""
    from sodt_tpu_torch.kernels import int8_serving
    with int8_serving() if int8 else contextlib.nullcontext():
        _profile_eval(label, cfg, int8)


def _profile_eval(label: str, cfg: str, int8: bool) -> None:
    import torch
    from sodt_tpu_torch.train.evaluate import cache_rel_bias, make_eval_step

    model = cache_rel_bias(seeded_model(cfg, torch.bfloat16).cuda().eval())
    step = make_eval_step(model)
    x = torch.randint(0, 255, (MAIN_BATCH, 512, 512, 3), dtype=torch.uint8,
                      device="cuda")
    for _ in range(2):
        step(x, x)
    torch.cuda.synchronize()
    fwd = lambda: model(x.float() / 255, x.float() / 255)
    with torch.no_grad():
        fwd_ms = time_ms(fwd, iters=5, warmup=1)
        # the forward's summed kernel time and the host's time to issue it:
        # where the host launches slower than the card runs, fwd_ms reads
        # the host
        fwd_dev = device_ms(fwd, f"{label} forward")
        fwd_host = host_ms(fwd)
        fwd_ops = host_ops(fwd)
    step_ms = time_ms(lambda: step(x, x), iters=5, warmup=1)
    wall = []

    def run():
        t0 = time.perf_counter()
        step(x, x)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    rows = profiled(run, label)
    wall_ms = wall[-1]
    busy, ours = _busy(rows)
    # idle share against the unprofiled step time (the profiler's own host
    # overhead stretches the profiled wall)
    out = {"phase": label, "batch": MAIN_BATCH, "img": 512, "int8": int8,
           "forward_ms": fwd_ms, "forward_device_ms": fwd_dev,
           "forward_host_ms": fwd_host, "forward_host_ops": fwd_ops,
           "eval_step_ms": step_ms,
           "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "port_kernels_ms": ours,
           "idle_share": _idle(busy, step_ms),
           "top": rows[:40], "categories": _categories(rows)}
    emit(out)


# --------------------------------------------------------------------- main

# the bench (`python -m sodt_tpu_torch.bench`) at its defaults with the int8
# pass; its numeric fields, the counters its run must move (all but K11's)
# and the batch of the kernels' check at its shapes
BENCH_ARGS = ["--int8"]
BENCH_FIELDS = ("value", "inference_ips", "e2e_host_ips", "e2e_feed_mbps",
                "gflops_per_img", "inference_mfu", "int8_ips", "train_ips",
                "train_mfu", "train_feed_ips", "train_scan_feed_ips",
                "power_limit_w")
BENCH_MFU_MAX = 1.05
BENCH_LAUNCHED = tuple(k for k in TPU_KERNEL if TPU_KERNEL[k][0] != "K11")
BENCH_PATHS = ("main", "train", "int8")
BENCH_BATCH = 128


def kernels_at_batch(batch: int, label: str) -> list[dict]:
    """Each kernel case of the bench's paths once at `batch` against its
    plain version (each case dropped once read): max |diff| / max |ref|
    within its tolerances."""
    import torch
    rows = []

    def check(cs):
        if cs["path"] not in BENCH_PATHS:
            return
        _, _, errs, rels = kernel_vs_plain(cs)
        row = {"phase": label, "name": cs["name"], "shape": cs["shape"],
               "batch": batch, "path": cs["path"], "max_abs_err": errs[0],
               "rel_errs": rels, "tols": list(cs["tols"]),
               "ok": within(rels, cs["tols"])}
        emit(row)
        rows.append(row)
        torch.cuda.empty_cache()

    kernel_cases(batch, sink=check)
    return rows


def phase_bench(label: str) -> dict:
    """The bench's run in this process (its launches counted from 0 just
    before it), its peak memory a path and its JSON line, then the kernels
    of its paths at its batch against their plain versions."""
    import torch
    from sodt_tpu_torch import bench, kernels
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rec = bench.run(BENCH_ARGS)
    counts = kernels.launches()
    seconds = time.perf_counter() - t0
    for path, n in rec["peak_memory_bytes"].items():
        emit({"phase": label, "path": path, "peak_memory_bytes": n,
              "peak_gib": n / 2**30})
    print(json.dumps(rec), flush=True)
    bad = [k for k in BENCH_FIELDS
           if not (isinstance(rec.get(k), (int, float))
                   and math.isfinite(rec[k]) and rec[k] > 0)]
    bad += [k for k in ("inference_mfu", "train_mfu")
            if k not in bad and not 0 < rec[k] <= BENCH_MFU_MAX]
    idle = [k for k in BENCH_LAUNCHED if not counts.get(k)]
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rows = kernels_at_batch(BENCH_BATCH, f"{label}_kernels")
    row = {"phase": label, "args": BENCH_ARGS, "bench_seconds": seconds,
           "kernels_seconds": time.perf_counter() - t1,
           "fields_failed": bad, "not_launched": idle, "launches": counts,
           "kernels_checked": len(rows),
           "kernels_failed": [f"{r['name']} {r['shape']}" for r in rows
                              if not r["ok"]],
           "worst_rel_err": max((max(r["rel_errs"]) for r in rows),
                                default=None)}
    row["ok"] = bool(not bad and not idle and rows
                     and not row["kernels_failed"]
                     and rec["topk_path"] == "exact"
                     and rec["vs_baseline"] is None)
    emit(row)
    return row


def _build_tile_loader(out: dict) -> None:
    """The port's tile loader (host C++), built while nvcc builds the
    kernels: its seconds, or why it did not build (phase `folders` then
    fails: the card's feed must be the native one)."""
    from sodt_tpu_torch.data import native_loader
    t0 = time.perf_counter()
    out["built"] = native_loader.available()
    out["seconds"] = time.perf_counter() - t0
    out["error"] = native_loader.load_error()


def main() -> int:
    if os.environ.get("SODT_NO_KERNELS"):
        print("chip_smoke: SODT_NO_KERNELS is set: every path would take "
              "JAX's composition and launch none of the kernels this run "
              "checks; unset it", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    try:
        import sodt_tpu_torch  # noqa: F401
        from sodt_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    failed = []
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    ptx_dir = tempfile.TemporaryDirectory()
    ptxas = start_ptxas(Path(ptx_dir.name))
    host = {}
    host_build = threading.Thread(target=_build_tile_loader, args=(host,))
    host_build.start()
    try:
        _build.build()
        host_build.join()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "tile_loader": host})
        emit(ptxas_report(ptxas))
    except Exception:
        traceback.print_exc()
        failed.append("build / ptxas")
    finally:
        host_build.join()
        for _, proc in ptxas:
            proc.kill()
            proc.wait()
        ptx_dir.cleanup()

    rows = []
    for batch in (2, MAIN_BATCH):
        try:
            rows += phase_kernels(batch)
        except Exception:
            traceback.print_exc()
            failed.append(f"kernels batch {batch}")
    failed += [f"{r['name']} {r['shape']}" for r in rows if not r["ok"]]
    try:
        failed += phase_autograd()
    except Exception:
        traceback.print_exc()
        failed.append("autograd")
    paths = {}

    def drive(label, phase, *args):
        """One path: its row, or a failure that the run reports; then its
        seconds on a line of their own."""
        t0 = time.perf_counter()
        try:
            paths[label] = phase(label, *args)
            if not paths[label]["ok"]:
                failed.append(f"{label} path")
        except Exception:
            traceback.print_exc()
            failed.append(f"{label} path")
            paths[label] = {"launches": {}}
        emit({"phase": "seconds", "of": label,
              "seconds": time.perf_counter() - t0})

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        drive("main", phase_path, MAIN_ARGS, PER_FORWARD)
        drive("608px", phase_path, OFF_ARGS, OFF_FORWARD)
        drive("train", phase_train, tmp, TRAIN_ARGS, TRAIN_STEPS, PER_STEP,
              PER_FORWARD)
        try:
            v2_weights = ["--weights-npz", seeded_weights_file(V2_CFG, tmp)]
        except Exception:
            traceback.print_exc()
            failed.append("swinv2 seeded weights file")
            v2_weights = []
        drive("swinv2", phase_path, V2_ARGS + v2_weights, V2_FORWARD)
        drive("swinv2_train", phase_train, tmp, V2_TRAIN_ARGS + v2_weights,
              V2_TRAIN_STEPS, V2_STEP, V2_FORWARD)
        drive("int8", phase_int8, INT8_ARGS, INT8_FORWARD)
        drive("trained", phase_trained)
        drive("reference_io", phase_reference_io, tmp, paths.get("trained"))
        drive("train_aug", phase_train_aug, tmp)
        drive("folders", phase_folders, tmp, paths.get("trained"))
        drive("jpeg", phase_jpeg, tmp, paths.get("trained"))
        drive("bmp_tiff", phase_bmp_tiff, tmp, paths.get("trained"))
        drive("webp", phase_webp, tmp, paths.get("trained"))
        drive("eval_extras", phase_eval_extras, tmp, paths.get("folders"))
        drive("eval_runner", phase_eval_runner, tmp)
        drive("mono", phase_path, MONO_ARGS, MONO_FORWARD)
        drive("mono_train", phase_train, tmp, MONO_TRAIN_ARGS,
              MONO_TRAIN_STEPS, MONO_STEP, MONO_FORWARD)
        drive("mono_int8", phase_int8, MONO_INT8_ARGS, MONO_INT8_FORWARD)
        drive("families", phase_families)
        drive("layers", phase_layers)
        drive("sr_train", phase_sr_train, tmp)
        drive("autoanchor", phase_autoanchor, tmp)
        drive("scan_epoch", phase_scan_epoch, tmp)
        drive("remat", phase_remat)
        drive("sam", phase_sam)
        drive("evolve", phase_evolve, tmp)
        drive("run_logs", phase_run_logs, tmp)
        drive("ddp", phase_ddp, tmp)
        drive("bench", phase_bench)
    for label, phase, args in (
            ("grads", phase_grads, ()), ("profile", phase_profile, ()),
            ("profile_train", phase_profile_train, ()),
            ("profile_swinv2", phase_profile, ("profile_swinv2", V2_CFG)),
            ("profile_swinv2_train", phase_profile_train,
             ("profile_swinv2_train", V2_CFG)),
            ("profile_int8", phase_profile,
             ("profile_int8", "configs/model.yaml", True))):
        try:
            row = phase(*args)
            if row is not None and not row["ok"]:
                failed.append(label)
        except Exception:
            traceback.print_exc()
            failed.append(label)

    emit({"phase": "profiler", **PROFILER})

    # per-forward (on the train path: per-step) totals at the paths' batch:
    # the sum over one forward's or step's calls of each kernel on its path
    # (calls_per_forward of each shape); launches as counted on that
    # path's run; a kernel of its path that was never launched fails
    entries = []
    for name, (tag, src, tpu, on_paths) in TPU_KERNEL.items():
        for path in on_paths:
            mine = [r for r in rows if r["name"] == name
                    and r["path"] == path and r["batch"] == MAIN_BATCH]
            tot = lambda key: (
                sum(r["calls_per_forward"] * r[key] for r in mine)
                if mine and all(r[key] is not None for r in mine) else None)
            entries.append({
                "name": f"{tag} {name}" + (f" ({path} path)"
                                           if len(on_paths) > 1 else ""),
                "route": "cuda", "source": src, "replaces": tpu, "path": path,
                "launches": paths[path]["launches"].get(name, 0),
                "launches_remat": paths["remat"]["launches"].get(name, 0),
                "launches_sam": paths["sam"]["launches"].get(name, 0),
                "launches_ddp": paths["ddp"]["launches"].get(name, 0),
                "launches_runner": paths["eval_runner"]["launches"].get(
                    name, 0),
                "launches_bench": paths["bench"]["launches"].get(name, 0),
                "max_abs_err": max((r["max_abs_err"] for r in mine),
                                   default=None),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": tot("bound_ms"),
                "bound_by": (max(mine, key=lambda r: r["bound_ms"])["bound_by"]
                             if mine else None),
                "library_ms": tot("library_ms"),
                **({key: tot(key) for key in ("device_ms", "library_device_ms")
                    if mine and all(key in r for r in mine)}),
                **({"bf16_kernel_ms": tot("bf16_kernel_ms")}
                   if tag == "K12" else {})})
    failed += [f"{e['name']} not launched on the {e['path']} path"
               for e in entries if not e["launches"]]
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    emit({"phase": "wall", "seconds": time.perf_counter() - START})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(Path(sys.argv[2])))
    sys.exit(main())
