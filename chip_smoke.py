"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a host with a CUDA card (Hopper: the
kernels are built for sm_90a). Phases, in order; any failure raises and the
script exits non-zero:

  1. device and toolchain: card name and power limit (nvidia-smi), torch
     and CUDA versions, triton and nvcc versions, ninja;
  2. build every kernel of the paths from the sources in the checkout, one
     nvcc per kernel, and the native GeoTIFF decoders (``build_native``:
     ``native/fastcodecs.c`` with setuptools), all started together; the
     decoders must load;
  3. each kernel against its plain PyTorch version on the card, and its time
     per launch at the main path's shape beside its bound:
       a. confusion counts with both rules (the training metric's rounding
          rule and the assessment's strict ``p > thr``), exact integer
          equality (ties at the threshold and +-1 ulp, masked tails, ragged
          sizes, several thresholds, a scene past 2^24 valid pixels), two
          launches equal; its time per launch back to back and from CUDA
          graphs of 20 launches, the two rules replayed in turns;
       b. bn_stats at every BatchNorm shape of a full-width training step and
          at ragged shapes, bf16 and f32, ``a is b`` and not, against the
          plain version in float64 (|kernel - ref| <= 1e-5 · Σ|a·b| per
          channel), and two launches on one input bit-equal; its time per
          launch from CUDA graphs (:func:`bn_kernel_times`, as phase 8a
          times it), and beside it the one PyTorch call that computes the
          same sums (``torch.batch_norm_backward_reduce``), as a yardstick;
          then its time and bound share at every BatchNorm shape of the
          step;
       c. conv3x3, the op's own path (no model calls it): at the JAX test's
          shape, the Pallas tool's shape, every U-Net level at batch 8 and
          256^2 crops and a ragged shape, bf16 and f32, against the plain
          version in float32 without TF32 (f32: atol 1e-4; bf16: one bf16
          ulp plus 1e-4), two launches bit-equal; the kernel's ptxas report
          per instantiation; then, outside the counted path, time per
          launch from CUDA graphs replayed in turns with cuDNN's
          ``F.conv2d`` on channels_last bf16 tensors (kernel, cuDNN, cuDNN,
          kernel), beside the bound, the plain version and the wrapper's
          host time per call;
  4. the inference path at full width: a synthetic SpaceNet7-layout split
     of ~1000^2 scenes, ``configs/siamese.yaml`` (topology [64,128,256,512],
     6 channels per date, bf16), seeded random weights and BN statistics,
     ``evaluation.inference_loop`` — with the kernels' launch counts read
     around it — then the checks of its output;
  5. the training path at full width over the same split: ``trainers.
     run_training`` (batch 8, 256^2 importance crops, flip and rot90, bf16
     autocast, AdamW) with the kernels' launch counts read around it,
     patches/s per log window, peak device memory, in-training
     ``model_evaluation`` (the confusion kernel) and a checkpoint; then a
     profile of one step, and a ``latest`` resume that takes one more step;
  6. the dual-task path at full width over the same split: ``trainers.
     run_training(cfg, 'dualtask')`` on ``configs/dtsiamese.yaml`` (88
     bn_stats launches a step, finite change and semantic losses, a
     checkpoint holding the auxiliary head, which weight decay alone
     moves), a profile of one step, then ``evaluation.
     dualtask_quantitative_counts`` over the 20 scenes with the strict
     kernel's launches counted around it, and every group's kernel counts
     against the plain version on the card's probabilities;
  7. the semi-supervised path at full width over the same split plus 4
     unlabeled AOIs: ``trainers.run_training(cfg, 'semisupervised')`` on
     ``configs/siamese_mmcr_alpha0500.yaml`` (whatevernet, batch 4, 8
     labeled + 4 unlabeled AOIs; 112 bn_stats launches a step, finite
     window losses, both loss terms above 0, the run's labeled share 8/12),
     the run's own kernel launches against the plain versions on their
     inputs (bn_stats at the first launch of each shape, dtype and
     ``a is b``, as in 3b; every confusion launch of its evaluations,
     exact), its checkpoint rebuilt, one all-labeled and one all-unlabeled step
     (each term 0 where its partition is absent), a timed and profiled
     step; then one staged step each of whatevernet2 and dtsiameseunet
     (semi-supervised) and unet and dualstreamunet (supervised), each with
     its bn_stats launches counted;
  8. a. ``siamunet_diff`` (FC-Siam-diff, fixed widths 16..128, spatial
     dropout) trained supervised at batch 8 over the same split
     (``trainers.run_training``, 24 steps, 58 bn_stats launches a step at
     channels 16-128), the run's own kernel launches held against the plain
     versions as in phase 7, its checkpoint reloaded, ``inference_loop``
     over the 20 scenes, a timed and profiled step, and ``bn_stats`` timed
     at the model's BatchNorm shapes beside the bound;
     b. the offline CLIs in process through each module's ``main``:
     ``assessment_change`` on phase 5's checkpoint (its printed line equal
     to ``inference_loop``'s on that checkpoint), ``assessment_semantics``
     on phase 6's (its three blocks equal to the pooled strict counts of
     that checkpoint, its strict launches counted), again with the scene
     cache off (the float32 items counted on the card by the strict kernel,
     equal to ``dualtask_item_counts``), the colored zoom
     comparison over 3 AOIs, ``sanity_check`` for 2 samples, and
     ``preprocessing`` on a hard-linked copy of the split (its
     metadata.json equal to the split's);
  9. a. serving: phase 5's checkpoint exported through ``export_serving.
     main`` for the card (buckets 256, 512, 1024; batch sizes 1 and 8),
     loaded in process, ``predict`` on each of the 20 scenes held bit for
     bit against ``evaluation.scene_probabilities`` on the same checkpoint,
     ``predict_batch`` on the 20 scenes and two 256^2 crops against
     ``predict`` (limit ``SERVE_BATCH_LIMIT``) and its first chunk of 8 bit
     for bit against ``eval_forward`` on the same padded scenes; bundle
     size, export time, scenes/s, peak memory;
     b. the training knobs: one staged full-width siameseunet step at batch
     8 in each of plain, GRAD_ACCUM 2, REMAT and both (bn_stats launches 56
     / 112 / 84 / 168, held against the plain version as in phase 7; REMAT's
     running statistics and ``num_batches_tracked`` equal to the plain
     step's), step time and peak memory, then plain and REMAT at batch 32;
     c. ``trainers.run_training`` with GRAD_ACCUM 2, process loader workers
     and PROFILE_DIR (16 steps): finite window losses, a trace file, and the
     process batches equal to a thread loader's;
 10. data parallelism (``multimodal_siamese_cd_tpu_torch.parallel``):
     a. a world of two ranks on the one card over gloo (NCCL refuses two
     ranks on one device; gloo runs all_reduce, broadcast and barrier, all
     the port uses, on CUDA tensors), started by ``parallel.cluster_check.
     launch_cluster``: from phase 5's checkpoint, one full-width sync-BN
     step at global batch 8 (4 rows per rank), held against the one-process
     batch-8 step on the same weights and batch (limits ``PARALLEL_LIMITS``),
     the ranks' gradients, parameters and buffers bit-equal, each rank's 56
     bn_stats launches, their first launch of each signature held against
     the plain version as in phase 7; the step time, the share of it inside
     all-reduces and the peak memory per rank; then ``run_measurer`` over
     the 20 scenes sharded over the two ranks, its counts equal on both
     ranks and exactly the one-process counts of the same shares (whose
     bn_stats and confusion launches, and the one-process step's, are held
     against the plain versions as in phase 7, which then holds the ranks'
     counts too), and their distance from the counts of whole groups;
     b. ``trainers.run_training`` under ``MSCD_DISTRIBUTED=1`` at world size
     1 over NCCL (the production backend; the trainer's env-gated
     initialisation, tried again on a new port if the store's was taken):
     finite windows, one checkpoint, 56 bn_stats launches a step and the
     evaluations' confusion launches, all held against the plain versions
     as in phase 7;
 11. height sharding (``TRAINER.SPATIAL_SHARDS 2``, ``parallel.halo``) on a
     world of two ranks over gloo on the one card (data 1 x space 2), one
     launch of ``parallel.cluster_check`` for every case:
     a. from phase 5's checkpoint, one full-width sync-BN step at global
     batch 8 of 256^2 crops, each rank 128 of each crop's rows, held against
     the one-process step (``PARALLEL_LIMITS``), the ranks' gradients,
     parameters and buffers bit-equal, each rank's 56 bn_stats launches at
     the half-height shapes, the first of each signature held against the
     plain version as in phase 7; the step time, the share of it in
     collectives with the halo exchanges apart (54 predicted: one forward
     and one backward for each of the 28 3x3 convs, but none backward for
     the stem's first conv on each date, whose input takes no gradient),
     the peak memory per rank against the one-process step;
     b. one staged step at 1024^2 crops, batch 8: time and peak memory per
     rank against one process (the loss within ``PARALLEL_LIMITS``);
     c. ``evaluation.sharded_scene_probabilities`` of the two validation
     scenes against ``scene_probabilities`` at fp32 with TF32 off (limit
     ``SPACE_FP32_LIMIT``) and at bf16 (printed), peak memory per rank;
     ``run_measurer`` over the 20 scenes on the grid, every confusion launch
     of each rank held against the plain version, the counts equal on both
     ranks and their distance from the one-process counts; then bn_stats
     timed (as in 3b) at the shapes a rank feeds it in 10a and in 11a.

12. multi-step execution (``TRAINER.STEPS_PER_EXECUTION`` 4: one CUDA graph
     of the step's augmentation, forward and backward, replayed once per
     step, AdamW after each replay), each graph window from one seeded state
     against the same steps run eagerly, the k = 1 step (``GRAPH_LIMITS``:
     window metrics, running statistics, parameters; the eager steps'
     bn_stats launches held against the plain
     version as in phase 7; a replayed window's bn_stats kernels counted in
     a profiler trace):
     a. siameseunet at full width (batch 8, 256^2 crops, bf16 autocast,
     PowerJaccard, AdamW), then with GRAD_ACCUM 2 + REMAT; the k = 1 step
     and the replayed step timed by CUDA events and by host clock, the
     device busy share of a window of each, patches/s, the capture time and
     the peak memory;
     b. siamunet_diff (dropout masks drawn outside the graph) and
     whatevernet semi-supervised (a window with an all-labeled and an
     all-unlabeled batch: presence weights and window means);
     c. ``trainers.run_training`` with ``STEPS_PER_EXECUTION 4`` to its first
     log window against a k = 1 run (``GRAPH_LIMITS['metrics']``), and the
     ``auto`` probe's milliseconds and k.
13. the training lifecycle through the port's CLIs (phase 13's datasets
     are written by a process of their own while phase 4's split is
     written, after phase 3's host-timed measurements):
     a. ``convergence_run``'s command for the hard fixture at the JAX
     package's settings (``CONVERGENCE_ARGS``: 512^2 scenes, signal 0.3, 6
     epochs of 64 steps of 8, LOG_FREQ 16, full width, bf16) run through
     ``train_supervised.main`` in this process, every bn_stats and
     confusion launch counted and held against the plain versions as in
     phase 7; the F1 trajectory, wall seconds and patches/s, and the
     trajectory held to ``CONVERGENCE_BAND``;
     b. ``lifecycle_run`` at its smoke shape (``LIFECYCLE_ARGS``), each CLI a
     child process of this script (``--watch-child``: the launch counts are
     copied into a memory-mapped file after every call, so they survive
     the SIGKILL, and the kept launches are saved for this process to hold
     against the plain versions): a SIGKILL of the training process once
     the seam window is logged, the resume from ``latest``, every seam
     record within 1e-6, and the assessment CLI's line equal to
     ``assessment_change`` in this process on the same checkpoint.
14. the measurement modules through their ``main`` in this process, each
     printing its own lines (the module's defaults unless said), their
     kernels' launches counted and held against the plain versions:
     a. ``bench`` (three regimes, K 20 steps a call as CUDA graphs, 2 + 5
     calls, one more call under the sync debug mode listing the step's
     synchronising calls), then the supervised regime at k = 1; bn_stats'
     launches exactly (K + 1) x 56 / 88 / 112 (the first call's eager
     steps and the capture) and 56 a k = 1 step;
     b. ``bench_eval --sol`` (16 x 1024^2, 8 calls; the convolution FLOPs
     and the share of the dense bf16 peak);
     c. ``bench_assessment`` on phase 4's split (``--data-dir``): its F1
     equal to ``inference_loop``'s on the same weights, the warm-up pass's
     confusion launches held against the plain version;
     d. ``profile_step`` of the supervised regime: device time by category
     and busy share of replayed and eager steps, each trace's bn_stats
     kernels counted;
     e. ``ablate_step`` at batch 8 and ``bench_remat_memory`` (1024^2,
     batch 8: plain, REMAT, GRAD_ACCUM 4, both), the latter's 1024^2
     bn_stats signatures held against plain from one more staged step of
     plain and of GRAD_ACCUM, outside its measured run.
15. the entry points of ``graft_entry`` and the collective count:
     a. ``graft_entry.entry()`` on the card, a shape and finiteness smoke:
     its ``fn`` on its flagship model and batches (siameseunet
     [64,128,256,512], 8 x 256^2 s1s2, the JAX entry's draws) gives finite
     (8, 1, 256, 256) float32 probabilities. ``fn`` is
     ``train_lib.probabilities`` in eval mode, so its bit-equality with that
     function on the same model and batches holds the wrapper only, not the
     forward; no hand-written kernel runs on an eval forward;
     b. ``graft_entry.dryrun_multichip(4)``: four ranks sharing the card
     over gloo, joined through ``env://``, run the 12 surfaces of the JAX
     dry run at full width (crop 32, batch 8), each held against this
     process, every line printed; each rank's bn_stats and confusion
     launches counted, every launch signature of the ranks and of this
     process's references held against the plain versions as in phase 7;
     c. ``model_scaling`` for the three regimes at world 2 (full width,
     batch 8 a rank, 256^2 crops), its step times 14a's bench readings:
     the records printed; the counted gradient bytes 4 x ``param_count``,
     the BatchNorm sums 2 x 8C over the forward's BatchNorm calls and the
     global rows n x batch x (heads + 3) x crop^2 x 4 plus the label mask,
     exactly.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``. Imports only the port,
torch, numpy and the standard library.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import importlib
import io
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_siamese_cd_tpu_torch import (ablate_step, assessment_change,
                                             assessment_semantics, bench,
                                             bench_assessment, bench_eval,
                                             bench_remat_memory, build_native,
                                             checkpoints, convergence_run, evaluation,
                                             experiment_manager, export_serving,
                                             geofiles, geotiff, graft_entry,
                                             lifecycle_run, metrics, model_scaling,
                                             parallel, parsers, png,
                                             preprocessing, profile_step,
                                             qualitative_comparison, sanity_check,
                                             serving, train_lib, train_supervised,
                                             trainers, wandb_compat)
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.data import synthetic
from multimodal_siamese_cd_tpu_torch.data.dataset import MultimodalCDDataset
from multimodal_siamese_cd_tpu_torch.data.loader import (TrainLoader, group_batches,
                                                          prefetch_to_device)
from multimodal_siamese_cd_tpu_torch.data.synthetic import generate_fixture_dataset
from multimodal_siamese_cd_tpu_torch.metrics import MultiThresholdMetric
from multimodal_siamese_cd_tpu_torch.models import batchnorm
from multimodal_siamese_cd_tpu_torch.models.factory import create_network
from multimodal_siamese_cd_tpu_torch.ops import _build, bn_stats, confusion, conv3x3
from multimodal_siamese_cd_tpu_torch.parallel import cluster_check
from multimodal_siamese_cd_tpu_torch.train_lib import eval_forward

# Peak memory rate (bytes/s), fp32 non-tensor-core rate and bf16 dense
# tensor-core rate (op/s) by the name torch reports (NVIDIA data sheets;
# dense, no sparsity).
PEAKS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12),     # SXM
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H200": (4.8e12, 67e12, 989e12),
}
MAIN_SCENES, MAIN_SIDE = 16, 1024          # one full eval group of 1024^2 scenes
N_AOIS, AOI_SIDE = 20, 1000                # scenes 1000..1016 px pad to 1024:
                                           # one full group of 16, then 4
# every BatchNorm input of a full-width training step (batch 8, 256^2 crops,
# topology [64,128,256,512]): stem and Down1-4 on each date, Up4..Up1
BN_SHAPES = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64),
             (8, 512, 32, 32), (8, 512, 16, 16), (8, 256, 32, 32),
             (8, 128, 64, 64), (8, 64, 128, 128)]
BN_RAGGED = [(1, 3, 17, 19), (1, 3, 256, 256), (2, 3, 10, 10), (3, 5, 7, 9),
             (1, 3, 1, 1)]
# training phases: 8 AOIs x 48 = 384 crops = 48 steps of 8 at batch 8, four
# LOG_FREQ windows of 12 (the first is warm-up); 2 + 2 AOIs to validate/test
TRAIN_AOIS, TRAIN_MULTIPLIER, TRAIN_LOG_FREQ = 8, 48, 12
# the semi-supervised phase: 4 unlabeled AOIs written after the labeled ones;
# (8 + 4) x 16 = 192 crops = 48 steps of 4 at batch 4
UNLABELED_AOIS = [f"smoke_unlabeled_{i}" for i in range(4)]
SEMISUP_MULTIPLIER = 16
# siamunet_diff: 8 AOIs x 24 = 192 crops = 24 steps of 8, four LOG_FREQ
# windows of 6; its BatchNorm inputs at batch 8 and 256^2 crops (encoder
# 16@256, 32@128, 64@64, 128@32; decoder 128@32, 64@32, 64@64, 32@64,
# 32@128, 16@128, 16@256)
DIFF_MULTIPLIER, DIFF_LOG_FREQ = 24, 6
DIFF_BN_SHAPES = [(8, 16, 256, 256), (8, 32, 128, 128), (8, 64, 64, 64),
                  (8, 128, 32, 32), (8, 64, 32, 32), (8, 32, 64, 64),
                  (8, 16, 128, 128)]
DIFF_BN_PER_STEP = 2 * (2 * 10 + 9)     # 10 encoder BNs per date, 9 decoder
# conv3x3 (B, H, W, Cin, Cout): the JAX test's shape, the Pallas tool's own
# (Cin padded to 128), every U-Net level at batch 8 and 256^2 crops, and a
# ragged one; the U-Net's top level is the row's headline shape
CONV_SHAPES = [(2, 32, 64, 128, 16), (8, 256, 256, 128, 64),
               (8, 256, 256, 64, 64), (8, 128, 128, 128, 128),
               (8, 64, 64, 256, 256), (8, 32, 32, 512, 512), (1, 37, 29, 64, 64)]
CONV_MAIN = (8, 256, 256, 64, 64)
# phase 3c timing: launches per CUDA graph, rounds of (kernel, cuDNN, cuDNN,
# kernel) replays, host calls of the wrapper timed on the host clock
CONV_INNER, CONV_ROUNDS, CONV_HOST_CALLS = 20, 5, 50
# phase 9a: the serving export's buckets and batch sizes; the limit of
# predict_batch (batch 8) against predict (batch 1), phase 4's group limit
SERVE_BUCKETS, SERVE_BATCHES, SERVE_BATCH_LIMIT = "256,512,1024", "1,8", 2e-2
# phase 9b: (label, GRAD_ACCUM, REMAT) of the staged steps
KNOB_MODES = (("plain", 1, False), ("GRAD_ACCUM 2", 2, False),
              ("REMAT", 1, True), ("GRAD_ACCUM 2 + REMAT", 2, True))
# phase 9c: 8 AOIs x 16 = 128 crops = 16 steps of 8 (past the profiler's
# start at step 10), two LOG_FREQ windows of 8
KNOB_MULTIPLIER, KNOB_LOG_FREQ = 16, 8
# phase 10a: ranks on the one card, the two-rank step's limits against the
# one-process step in bf16 (relative: |dloss| / |loss|, and the L2 norm of
# the difference over that of the one-process value for the flat gradient
# and the flat running statistics), steps timed after the counted one;
# 10b: 8 AOIs x 4 = 32 crops = 4 steps of 8, two LOG_FREQ windows
PARALLEL_RANKS, PARALLEL_TIMED_STEPS = 2, 5
PARALLEL_LIMITS = {"loss": 5e-3, "grads": 2e-2, "buffers": 1e-3}
NCCL_MULTIPLIER, NCCL_LOG_FREQ = 4, 2
NCCL_PORT_TRIES = 3
# phase 11: the grid's space ranks on the one card, the side of 11b's staged
# crops, the limit of the fp32 sharded scene probabilities (TF32 off)
SPACE_RANKS, SPACE_BIG_SIDE, SPACE_FP32_LIMIT = 2, 1024, 1e-5
# phase 12: steps per window (TRAINER.STEPS_PER_EXECUTION); the limits of a
# CUDA-graph window against the same steps run eagerly, the k = 1 step
# (each window metric |graph - eager| / |eager|; the L2 norm
# of the running statistics' difference over theirs; the largest parameter
# difference over the largest parameter entry), also those of 12c's logged
# window against a k = 1 run; windows timed in 12a; 12c: 8 AOIs x 8 = 64
# crops = 8 steps of 8, one LOG_FREQ window of 8
STEPS_K, STEPS_TIMED_WINDOWS = 4, 3
GRAPH_LIMITS = {"metrics": 1e-6, "buffers": 5e-5, "params": 1e-3}
STEPS_MULTIPLIER, STEPS_LOG_FREQ = 8, 8
# phase 13a: the hard-fixture convergence of siameseunet at the JAX package's
# settings (8 AOIs x 64 = 512 crops = 64 steps of 8 a epoch, 6 epochs = 384
# steps, LOG_FREQ 16), and the band written down before its first run: the
# mean of the last four validation F1s (steps 336-384), the test F1 at step
# 384, the rise of the validation F1 from step 16 to step 384
CONVERGENCE_ARGS = ["--regime", "supervised", "--hard", "--scene", "512",
                    "--signal", "0.3", "--multiplier", "64", "--log-freq", "16",
                    "--epochs", "6"]
CONVERGENCE_BAND = {"last4_validation": 0.73, "test": 0.66, "rise": 0.3}
# phase 13b: lifecycle_run at the smoke shape (39 AOIs x 16 / 8 = 78 steps a
# epoch, 3 epochs, LOG_FREQ 100: the SIGKILL after the seam window at step
# 200, the resume from epoch 2 at step 156)
LIFECYCLE_ARGS = ["--scene", "128", "--multiplier", "16", "--crop", "128",
                  "--epochs", "3"]
# phase 14: the measurement modules' argv (each runs at the module's defaults
# on the card; 14a's bench adds one call under the sync debug mode after its
# timed ones), the topology their expected launch counts assume, and the
# bench's BatchNorm calls a step by regime (bn_per_step's keywords)
BENCH_ARGV = ["--sync-debug"]
BENCH_K1_ARGV = ["--regime", "supervised", "--steps-per-call", "1", "--sync-debug"]
BENCH_EVAL_ARGV = ["--sol"]
ASSESS_ARGV: list = []
PROFILE_ARGV = ["8", "--regime", "supervised", "--top", "12"]
ABLATE_ARGV = ["--batch-sizes", "8"]
REMAT_ARGV: list = []
PHASE14_TOPOLOGY = [64, 128, 256, 512]
BENCH_BN_CALLS = {"supervised": {}, "dualtask": {"decoder_calls": 3},
                  "semisupervised": {"streams": 2}}
# phase 15: the dry run's ranks (sharing the one card over gloo) and
# model_scaling's world; the bn_stats launches a rank makes in each of the
# dry run's training cases, in steps of its model (REMAT's recompute and
# GRAD_ACCUM 2 make the triad's three)
DRYRUN_RANKS, SCALING_WORLD = 4, 2
DRYRUN_STEPS = {"supervised": 1, "dualtask": 1, "semisupervised": 1, "bf16": 1,
                "scanned_sync1": 2, "scanned_sync1_k1": 2, "scanned_sync0": 2,
                "scanned_sync0_k1": 2, "space": 1, "triad": 3, "cluster_step": 1}
# each regime's heads, which global_rows makes global with the 3 label planes
HEADS = {"supervised": 1, "dualtask": 3, "semisupervised": 3}
# BatchNorm calls of a full-width siameseunet step at each of BN_SHAPES (the
# stem on both dates and Up1, Down1-4 on both dates, Up4..Up2); each is one
# forward and one backward bn_stats launch
BN_STEP_COUNTS = (6, 4, 4, 4, 4, 2, 2, 2)


def log(*args) -> None:
    print(*args, flush=True)


def peaks(name: str) -> tuple[float, float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak rates on record for card {name!r}")


def cuda_time_ms(fn, runs: int, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``runs`` of CUDA-event time per call, each run timing
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_time_ms(fns: dict, order: list, inner: int, rounds: int) -> dict:
    """Per-call device time of each function in ``fns``: each is captured
    once as a CUDA graph of ``inner`` back-to-back calls, and the graphs
    are replayed ``rounds`` times in ``order`` (e.g. kernel, cuDNN, cuDNN,
    kernel), each replay timed with CUDA events; the median per name."""
    graphs = {}
    for name, fn in fns.items():
        fn()                                     # warm-up, outside the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(inner):
                fn()
        graphs[name] = g
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / inner)
    del graphs
    return {name: statistics.median(t) for name, t in times.items()}


def profile_breakdown(label: str, fn, top: int = 8, match: str = "") -> dict | None:
    """One profiled call of ``fn`` (``profile_step.trace``: the profiler's
    user annotations left out): the device's busy share of the host wall
    time and the kernels that take the most device time (and the total of
    those whose name holds ``match``). Returns the wall and busy
    microseconds and the launches of the ``match`` kernels, or None when the
    profiler saw no device time."""
    traced = profile_step.trace(fn, torch.device("cuda"))
    kernels, wall_us = traced["kernels"], traced["wall_us"]
    busy_us = sum(us for us, _ in kernels.values())
    if busy_us <= 0:
        log(f"profile {label}: the profiler saw no device time (not measured)")
        return None
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us * 100:.1f}%), idle "
        f"{max(0.0, 1 - busy_us / wall_us) * 100:.1f}%")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / busy_us * 100:5.1f}% {us / 1e3:8.2f} ms x{n:<4d} {name[:90]}")
    hits = [v for name, v in kernels.items() if match and match in name]
    if match:
        us = sum(t for t, _ in hits)
        log(f"  kernels named *{match}*: {us / busy_us * 100:.1f}% of device "
            f"time, {us / 1e3:.2f} ms in {sum(n for _, n in hits)} launches")
    return {"wall_us": wall_us, "busy_us": busy_us,
            "matched": sum(n for _, n in hits)}


# -- phase 1 ------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    nvcc = _build.nvcc_path()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log(f"nvcc {nvcc}: {out[-1] if out else '?'}")
    log(f"ninja: {shutil.which('ninja') or 'not found'} "
        f"(not needed: kernels build with nvcc and load with ctypes)")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    log(f"device: {name}, {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB, count {torch.cuda.device_count()}")
    return {"name": name, "smi": smi}


# -- phase 2 ------------------------------------------------------------------

def phase_build() -> None:
    """One nvcc per kernel and the native GeoTIFF decoders (setuptools and
    the C compiler), all started together."""
    from concurrent.futures import ThreadPoolExecutor

    kernels = {"confusion": confusion._kernel, "bn_stats": bn_stats._kernel,
               "conv3x3": conv3x3._kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        native = pool.submit(build_native.build)
        for fut in [pool.submit(fn) for fn in kernels.values()] + [native]:
            fut.result()
    log(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s "
        f"wall, into {_build.BUILD_DIR} (route: nvcc -shared + ctypes)")
    geotiff._fastcodecs = geotiff.load_native()
    if geotiff._fastcodecs is None or \
            geotiff._packbits_decode(bytes([1, 7, 7, 254, 9])) != bytes([7, 7, 9, 9, 9]):
        raise AssertionError(f"the native GeoTIFF decoders built at {native.result()} "
                             f"did not load")
    log(f"native GeoTIFF decoders (LZW, PackBits) built and loaded: "
        f"{native.result()}")
    for name in kernels:
        info = _build.BUILD_INFO[name]
        log(f"build {name}: {info['seconds']:.2f} s nvcc")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "entry function" in line:
                log(f"  ptxas: {line.strip()}")


# -- phase 3 ------------------------------------------------------------------

def _case(gen: np.random.Generator, n_scenes: int, n_pixels: int,
          thresholds: np.ndarray, tail: float = 0.1):
    """Random probs with exact ties and ±1 ulp neighbours at every
    threshold, random labels, a valid mask with holes and a masked tail."""
    probs = gen.uniform(0, 1, (n_scenes, n_pixels)).astype(np.float32)
    for thr in thresholds.astype(np.float32):
        for val in (thr, np.nextafter(thr, np.float32(2)),
                    np.nextafter(thr, np.float32(-1))):
            idx = gen.integers(0, n_pixels, size=(n_scenes, 257))
            np.put_along_axis(probs, idx, val, axis=1)
    y = (gen.uniform(size=(n_scenes, n_pixels)) > 0.7).astype(np.uint8)
    valid = (gen.uniform(size=(n_scenes, n_pixels)) > 0.05).astype(np.uint8)
    valid[:, int(n_pixels * (1 - tail)):] = 0
    dev = torch.device("cuda")
    return (torch.from_numpy(probs).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(valid).to(dev),
            torch.from_numpy(thresholds.astype(np.float32)).to(dev))


def phase_kernel(card: dict) -> tuple:
    gen = np.random.default_rng(0)
    max_err = {False: 0, True: 0}

    def check(label, args):
        """Both rules against their plain versions, and two launches of
        each equal."""
        out = {}
        for strict, fn, plain in (
                (False, confusion.confusion_counts, confusion.confusion_counts_plain),
                (True, confusion.strict_confusion_counts,
                 confusion.strict_confusion_counts_plain)):
            got = fn(*args)
            again = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err[strict] = max(max_err[strict], err)
            if err != 0 or not torch.equal(got, again):
                raise AssertionError(f"confusion kernel (strict={strict}) != "
                                     f"plain version or not repeatable ({label})")
            out[strict] = got
        differ = int((out[True][:, 0] - out[False][:, 0]).abs().sum())
        log(f"  {label}: shape {tuple(args[0].shape)} T={args[3].numel()} valid px "
            f"{int(args[2].sum())}: both rules equal their plain versions, "
            f"launches repeat; the rules' tp differ on {differ} px")
        return out[False]

    log("kernel vs plain, rounding and strict rule (exact int64 equality):")
    for n_px in (1_000_003, 1_024_000):      # ragged -> scalar path; /4 -> vector path
        for thr in (np.array([0.5]), np.linspace(0.1, 0.9, 5),
                    np.linspace(0.05, 0.95, 11)):
            check(f"N={n_px}", _case(gen, 3, n_px, thr))
    big = _case(gen, 1, 4300 * 4300, np.array([0.5]), tail=0.0)
    got = check("one scene of 4300^2", big)
    total = int(got.sum())
    if total <= 2 ** 24:
        raise AssertionError(f"big case has {total} valid px, not > 2^24")
    log(f"  4300^2 scene: {total} valid px > 2^24 = {2 ** 24}, counts exact")

    # time at the main path's shape: one full group of 1024^2 scenes, T = 1
    args = _case(gen, MAIN_SCENES, MAIN_SIDE * MAIN_SIDE, np.array([0.5]),
                 tail=0.02)
    check("main shape", args)
    probs, y, valid, thr = args
    n_scenes, n_px = probs.shape
    out = torch.zeros((n_scenes, 4, 1), dtype=torch.int64, device="cuda")
    bw, flops, _ = peaks(card["name"])
    n_bytes = n_scenes * n_px * (4 + 1 + 1) + 4 + n_scenes * 4 * 8
    n_ops = 4 * n_scenes * n_px          # sub, add, rint, compare per px per thr
    bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    graphed = graph_time_ms(
        {"rounding": lambda: confusion.launch(*args, out, False),
         "strict": lambda: confusion.launch(*args, out, True)},
        ["rounding", "strict", "strict", "rounding"], inner=20, rounds=13)
    rows = []
    for strict, name, fn, plain in (
            (False, "confusion_counts", confusion.confusion_counts,
             confusion.confusion_counts_plain),
            (True, "confusion_counts_strict", confusion.strict_confusion_counts,
             confusion.strict_confusion_counts_plain)):
        kernel_ms = cuda_time_ms(lambda: confusion.launch(*args, out, strict),
                                 runs=25, inner=20)
        graph_ms = graphed["strict" if strict else "rounding"]
        wrapper_ms = cuda_time_ms(lambda: fn(*args), runs=25)
        plain_ms = cuda_time_ms(lambda: plain(*args), runs=21, warmup=2)
        log(f"{name} kernel at {n_scenes} x {MAIN_SIDE}^2, T=1 on {card['smi']}: "
            f"{kernel_ms * 1e3:.1f} us/launch (back-to-back, median of 25 x 20), "
            f"{wrapper_ms * 1e3:.1f} us per wrapper call (alloc + launch), "
            f"plain {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.1f} us "
            f"({n_bytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; ops bound "
            f"{ops_ms * 1e3:.2f} us), {bytes_ms / kernel_ms * 100:.1f}% of the "
            f"memory roofline, {n_bytes / kernel_ms / 1e6:.0f} GB/s achieved; "
            f"from CUDA graphs {graph_ms * 1e3:.1f} us/launch (20 launches a "
            f"graph, the rules replayed in turns, median of 13 rounds), "
            f"{bound_ms / graph_ms * 100:.1f}% of the bound")
        rows.append({"name": name, "route": "cuda",
                     "source": "multimodal_siamese_cd_tpu_torch/ops/csrc/confusion.cu",
                     "replaces": "multimodal_siamese_cd_tpu/ops/confusion.py:27",
                     "launches": None, "max_abs_err": max_err[strict],
                     "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None})
    del args, probs, y, valid, big
    torch.cuda.empty_cache()
    return tuple(rows)


# -- phase 3b -----------------------------------------------------------------

def _bn_error(got, a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """``bn_stats`` sums ``got`` against the plain version in float64 on
    ``(a, b)``: the largest |kernel - ref| over its limit (1e-5 · Σ|a|, resp.
    1e-5 · Σ|a·b|, per channel) and the largest |kernel - ref|."""
    ref = bn_stats.bn_stats_reference(a, b, torch.float64)
    scale = (a.double().abs().sum(dim=(0, 2, 3)),
             (a.double() * b.double()).abs().sum(dim=(0, 2, 3)))
    diff = [(g.to(r.device).double() - r).abs() for g, r in zip(got, ref)]
    ratio = max(float((d / (1e-5 * m + 1e-30)).max()) for d, m in zip(diff, scale))
    return ratio, max(float(d.max()) for d in diff)


def bn_kernel_times(card: dict, dy: torch.Tensor, x: torch.Tensor) -> dict:
    """``bn_stats`` per launch on ``dy``, ``x`` (B, C, H, W): backward
    ``(dy, x)`` and forward ``(x, x)``, the device time from CUDA graphs of
    20 launches replayed in turns (backward, forward, forward, backward),
    median of 5 rounds, beside the bound: bytes (each input read once, two
    (C,) float32 sums written) or operations (an add and an fma per
    element at the float32 rate), whichever is larger."""
    c = x.shape[1]
    s1 = torch.empty(c, device=x.device)
    s2 = torch.empty(c, device=x.device)
    chunks = -(-x.shape[0] * x.shape[2] * x.shape[3] // bn_stats.CHUNK)
    partial = torch.empty(c * chunks * 2, device=x.device)
    got = graph_time_ms(
        {"backward": lambda: bn_stats.launch(dy, x, s1, s2, partial),
         "forward": lambda: bn_stats.launch(x, x, s1, s2, partial)},
        ["backward", "forward", "forward", "backward"], inner=20, rounds=5)
    bw, flops, _ = peaks(card["name"])
    out_bytes = 2 * c * 4
    back_bytes = dy.numel() * dy.element_size() + x.numel() * x.element_size() \
        + out_bytes
    fwd_bytes = x.numel() * x.element_size() + out_bytes
    ops_ms = 3 * x.numel() / flops * 1e3
    return {"chunks": chunks, "back_ms": got["backward"], "fwd_ms": got["forward"],
            "back_bytes": back_bytes, "fwd_bytes": fwd_bytes, "ops_ms": ops_ms,
            "back_bound": max(back_bytes / bw * 1e3, ops_ms),
            "fwd_bound": max(fwd_bytes / bw * 1e3, ops_ms),
            "back_by": "bytes" if back_bytes / bw * 1e3 >= ops_ms else "operations"}


def phase_bn_stats(card: dict) -> dict:
    """bn_stats against its plain version in float64, at every BN shape of a
    full-width step and at ragged shapes; determinism; times at the largest
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    worst, max_err = 0.0, 0.0
    log("bn_stats vs plain in float64 (limit |kernel - ref| <= 1e-5 * "
        "sum|a*b| per channel; two launches bit-equal):")
    for shape in BN_SHAPES + BN_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            b = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
            for same in (True, False):
                bb = a if same else b
                got = bn_stats.bn_stats(a, bb)
                again = bn_stats.bn_stats(a, bb)
                ratio, err = _bn_error(got, a, bb)
                bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
                worst, max_err = max(worst, ratio), max(max_err, err)
                if ratio > 1.0 or not bitwise:
                    raise AssertionError(
                        f"bn_stats {shape} {dtype} same={same}: error ratio "
                        f"{ratio:.3g} (limit 1), bit-equal {bitwise}")
            log(f"  {shape} {str(dtype)[6:]}: a is b and a != b within limit, "
                f"bit-equal")
            del a, b
    log(f"  largest error / limit over all cases: {worst * 1e-5:.3e} of "
        f"sum|a*b| ({worst:.4f} of the limit); max |kernel - ref| {max_err:.3e}")

    # time at the largest BN shape of the step (the stem and up1: 64 x 256^2)
    shape, c = BN_SHAPES[0], BN_SHAPES[0][1]
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    t = bn_kernel_times(card, dy, x)
    plain_ms = cuda_time_ms(lambda: bn_stats.bn_stats_reference(dy, x),
                            runs=11, warmup=2)
    zeros, ones = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    try:
        lib = lambda: torch.batch_norm_backward_reduce(  # noqa: E731
            dy, x, zeros, ones, None, True, False, False)
        lib_out = lib()
        lib_note = "bf16 inputs"
    except RuntimeError as e:
        dy32, x32 = dy.float(), x.float()
        lib = lambda: torch.batch_norm_backward_reduce(  # noqa: E731
            dy32, x32, zeros, ones, None, True, False, False)
        lib_out = lib()
        lib_note = f"rejected bf16 ({str(e).splitlines()[0][:80]}); timed on f32"
    got = bn_stats.bn_stats(dy, x)
    lib_diff = max(float((g - l.float()).abs().max()) for g, l in zip(got, lib_out[:2]))
    library_ms = cuda_time_ms(lib, runs=25, inner=5)
    bw = peaks(card["name"])[0]
    log(f"bn_stats at {shape} bf16 on {card['smi']} (CUDA graphs of 20 launches, "
        f"median of 5 rounds): backward (dy, x) {t['back_ms'] * 1e3:.1f} us, bound "
        f"{t['back_bound'] * 1e3:.1f} us ({t['back_bytes'] / 1e6:.1f} MB at "
        f"{bw / 1e12:.2f} TB/s; operations {t['ops_ms'] * 1e3:.2f} us), "
        f"{t['back_bytes'] / t['back_ms'] / 1e6:.0f} GB/s; forward (x, x, read "
        f"once) {t['fwd_ms'] * 1e3:.1f} us, bound {t['fwd_bound'] * 1e3:.1f} us, "
        f"{t['fwd_bytes'] / t['fwd_ms'] / 1e6:.0f} GB/s")
    log(f"  plain version {plain_ms * 1e3:.1f} us; torch.batch_norm_backward_"
        f"reduce {library_ms * 1e3:.1f} us ({lib_note}; max |diff| vs kernel "
        f"{lib_diff:.3e})")
    del dy, x, lib, got, lib_out
    torch.cuda.empty_cache()
    log(f"bn_stats per launch at every BatchNorm shape of a full-width siameseunet "
        f"step (batch 8, bf16; CUDA graphs of 20 launches, median of 5 rounds) on "
        f"{card['smi']}:")
    for shape in BN_SHAPES:
        ts = t if shape == BN_SHAPES[0] else bn_kernel_times(
            card, torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16))
        log(f"  {shape}: backward {ts['back_ms'] * 1e3:.2f} us (bound "
            f"{ts['back_bound'] * 1e3:.2f} us by {ts['back_by']}, "
            f"{ts['back_bound'] / ts['back_ms'] * 100:.1f}%), forward "
            f"{ts['fwd_ms'] * 1e3:.2f} us (bound {ts['fwd_bound'] * 1e3:.2f} us, "
            f"{ts['fwd_bound'] / ts['fwd_ms'] * 100:.1f}%)")
    torch.cuda.empty_cache()
    return {"name": "bn_stats", "route": "cuda",
            "source": "multimodal_siamese_cd_tpu_torch/ops/csrc/bn_stats.cu",
            "replaces": "tools/bench_bn_reduce.py:35",
            "launches": None, "max_abs_err": max_err, "ms": t["back_ms"],
            "plain_ms": plain_ms, "bound_ms": t["back_bound"],
            "bound_by": t["back_by"], "library_ms": library_ms}


# -- phase 3c -----------------------------------------------------------------

def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t`` (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _conv_inputs(gen, shape, dtype):
    b, h, w, cin, cout = shape
    dev = torch.device("cuda")
    x = torch.rand((b, h, w, cin), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
          * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    return x, wt


def _ptxas_summary(name: str) -> list:
    """One line per kernel instantiation in ``name``'s build log: its
    template arguments (channel tile, 64-pixel blocks per warpgroup, output
    type), registers and spill bytes."""
    out, entry, spills = [], None, ""
    for line in _build.BUILD_INFO[name]["log"].splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"kernelILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)EE", line)
            entry = (f"<{m.group(1)}, {m.group(2)}, "
                     f"{'float' if m.group(3) == 'f' else 'bf16'}>"
                     if m else line.split("'")[1])
            spills = ""
        elif entry and "spill stores" in line:
            spills = line.strip()
        elif entry and "Used" in line and "registers" in line:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spills}")
            entry = None
    return out


def phase_conv3x3(card: dict) -> dict:
    """conv3x3's own path (the op through its entry point; no model calls
    it) at every CONV_SHAPES shape in bf16 and f32, each output held
    against the plain version and a second launch bit-equal; then, outside
    the counted path, times per launch from CUDA graphs replayed in
    alternating order (kernel, cuDNN, cuDNN, kernel) beside the bound, the
    plain version, cuDNN and the wrapper's host time per call."""
    dev = torch.device("cuda")
    bw, _, tensor_flops = peaks(card["name"])
    for line in _ptxas_summary("conv3x3"):
        log(f"  ptxas conv3x3_kernel{line}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # the plain f32 conv is f32
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_ulps = 0.0
    times = {}
    log("conv3x3 vs plain (float32 conv without TF32; f32 inputs atol 1e-4, "
        "bf16 inputs one bf16 ulp + 1e-4; second launch bit-equal):")
    try:
        # ---- the op's path, with the kernel's launch count around it ----
        gen = torch.Generator(device=dev).manual_seed(3)
        conv3x3.conv3x3.launches = 0
        for shape in CONV_SHAPES:
            b, h, w, cin, cout = shape
            for dtype in (torch.bfloat16, torch.float32):
                x, wt = _conv_inputs(gen, shape, dtype)
                y = conv3x3.conv3x3(x, wt)                  # the path
                again = torch.empty_like(y)
                conv3x3.launch(*conv3x3.prepare(x, wt), again)   # uncounted repeat
                want = conv3x3.conv3x3_plain(x, wt)
                err = (y.float() - want.float()).abs()
                if dtype == torch.float32:
                    ok = float(err.max()) <= 1e-4
                else:
                    ok = bool((err <= _bf16_ulp(want) + 1e-4).all())
                    away = want.float().abs() >= 1e-2   # away from cancellation
                    worst_ulps = max(worst_ulps,
                                     float((err / _bf16_ulp(want))[away].max()))
                max_err[dtype] = max(max_err[dtype], float(err.max()))
                bitwise = torch.equal(y, again)
                if not ok or not bitwise or y.shape != (b, h, w, cout):
                    raise AssertionError(f"conv3x3 {shape} {dtype}: max |kernel - "
                                         f"plain| {float(err.max()):.3e}, "
                                         f"bit-equal {bitwise}")
                log(f"  {shape} {str(dtype)[6:]}: max |err| {float(err.max()):.3e}, "
                    f"bit-equal, plan {conv3x3.plan(b, h, w, cin, cout, dtype)}")
                del x, wt, y, again, want, err
        launches = conv3x3.conv3x3.launches
        # ------------------------------------------------------------------
        log(f"conv3x3 times on {card['smi']}: CUDA graphs of {CONV_INNER} "
            f"launches, median of {CONV_ROUNDS} rounds of kernel, cuDNN, cuDNN, "
            f"kernel; cuDNN is F.conv2d on channels_last bf16 (the same function "
            f"for bf16 inputs); host = the wrapper's host time per call:")
        gen = torch.Generator(device=dev).manual_seed(4)
        for shape in CONV_SHAPES:
            b, h, w, cin, cout = shape
            for dtype in (torch.bfloat16, torch.float32):
                x, wt = _conv_inputs(gen, shape, dtype)
                xb, wk = conv3x3.prepare(x, wt)
                y = torch.empty((b, h, w, cout), dtype=dtype, device=dev)
                fns = {"kernel": lambda: conv3x3.launch(xb, wk, y)}
                if dtype == torch.bfloat16:
                    xc = x.permute(0, 3, 1, 2)
                    wc = wt.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    fns["cudnn"] = lambda: F.conv2d(xc, wc, padding=1)
                order = ["kernel", "cudnn", "cudnn", "kernel"] if len(fns) == 2 \
                    else ["kernel"]
                got = graph_time_ms(fns, order, CONV_INNER, CONV_ROUNDS)
                k_ms, lib_ms = got["kernel"], got.get("cudnn")
                p_ms = cuda_time_ms(lambda: conv3x3.conv3x3_plain(x, wt), runs=5,
                                    warmup=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CONV_HOST_CALLS):
                    conv3x3.conv3x3(x, wt)
                host_us = (time.perf_counter() - t0) / CONV_HOST_CALLS * 1e6
                torch.cuda.synchronize()
                n_bytes = (x.numel() * x.element_size() + wt.numel() * wt.element_size()
                           + y.numel() * y.element_size())
                n_ops = 2 * b * h * w * cin * cout * 9
                bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / tensor_flops * 1e3
                bound = max(bytes_ms, ops_ms)
                bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
                times[(shape, dtype)] = (k_ms, p_ms, lib_ms, bound, bound_by)
                log(f"  {shape} {str(dtype)[6:]}: kernel {k_ms * 1e3:.1f} us "
                    f"({n_ops / k_ms / 1e9:.1f} TFLOP/s, {bound / k_ms * 100:.1f}% of "
                    f"the bound {bound * 1e3:.1f} us by {bound_by}: "
                    f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP); cuDNN "
                    + (f"{lib_ms * 1e3:.1f} us (kernel / cuDNN {k_ms / lib_ms:.2f})"
                       if lib_ms else "n/a (no single call rounds f32 operands to "
                       "bf16)")
                    + f"; plain {p_ms * 1e3:.1f} us; host {host_us:.1f} us per call")
                del x, wt, xb, wk, y, fns
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    expect = 2 * len(CONV_SHAPES)
    log(f"conv3x3 path: {launches} launches (expected {expect}); max |err| "
        f"f32 {max_err[torch.float32]:.3e}, bf16 {max_err[torch.bfloat16]:.3e} "
        f"(at most {worst_ulps:.2f} bf16 ulp where |y| >= 1e-2); on {card['smi']}")
    if launches != expect:
        raise AssertionError(f"conv3x3 launched {launches} times on its path")
    k_ms, p_ms, lib_ms, bound, bound_by = times[(CONV_MAIN, torch.bfloat16)]
    return {"name": "conv3x3", "route": "cuda",
            "source": "multimodal_siamese_cd_tpu_torch/ops/csrc/conv3x3.cu",
            "replaces": "tools/pallas_conv3x3_experiment.py:51",
            "launches": launches, "max_abs_err": max(max_err.values()),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


# -- phase 4 ------------------------------------------------------------------

def write_split(root: Path) -> list:
    """The labeled AOIs, then UNLABELED_AOIS (written after them, so the
    labeled scenes are those of a split without them); returns the labeled
    ones."""
    aois = [f"smoke_aoi_{i}" for i in range(N_AOIS)]
    t0 = time.perf_counter()
    with _threaded_tif_writes():
        generate_fixture_dataset(root, seed=11, scene_size=(AOI_SIDE, AOI_SIDE),
                                 n_timestamps=3,
                                 aois={**{a: True for a in aois},
                                       **{a: False for a in UNLABELED_AOIS}})
    log(f"synthetic split: {N_AOIS} labeled and {len(UNLABELED_AOIS)} unlabeled "
        f"AOIs, 3 timestamps, sides {AOI_SIDE}..{AOI_SIDE + 16} px, written in "
        f"{time.perf_counter() - t0:.1f} s ({os.cpu_count()} writer threads)")
    return aois


@contextlib.contextmanager
def _threaded_tif_writes():
    """A dataset generator's draws in their order, its GeoTIFFs written by a
    pool of threads (the deflate of each strip, nine tenths of the time,
    releases the GIL; the files are byte for byte the same); every write
    has finished when the block ends."""
    write_tif = geofiles.write_tif
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        writes = []

        def write_later(file, arr, transform, crs):
            Path(file).parent.mkdir(parents=True, exist_ok=True)
            writes.append(pool.submit(write_tif, file, arr, transform, crs))

        with mock.patch.object(geofiles, "write_tif", write_later):
            yield
        for w in writes:
            w.result()


def _randomize_bn(model, gen: torch.Generator) -> None:
    """Random BN running statistics (default 0/1 would make BN the
    identity up to its affine)."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.empty(buf.shape).uniform_(-0.1, 0.1, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.5, 1.5, generator=gen))


def phase_main_path(card: dict, kernel_row: dict, dev: torch.device,
                    root: Path, aois: list) -> None:
    cfg = load_cfg("siamese")
    cfg.PATHS.DATASET = str(root)
    cfg.DATASET.TEST_IDS = aois
    log(f"config siamese: {cfg.MODEL.TYPE} topology {list(cfg.MODEL.TOPOLOGY)} "
        f"precision {cfg.TRAINER.get('PRECISION', 'bf16')} input "
        f"{cfg.DATALOADER.INPUT_MODE}")
    model = create_network(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
    _randomize_bn(model, torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params} params on {next(model.parameters()).device}")

    # exactly as model_evaluation builds it (JAX evaluation.py:330-332)
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last",
                             disable_multiplier=True, disable_unlabeled=True)
    t0 = time.perf_counter()
    wires = [ds.eval_wire(i) for i in range(len(ds))]   # builds the cache
    log(f"scene cache built in {time.perf_counter() - t0:.1f} s; wire "
        f"{wires[0]['x1'].shape} {wires[0]['x1'].dtype}")

    # warm-up pass (cuDNN algorithm selection), not counted
    evaluation.inference_loop(model, ds, device=dev)
    torch.cuda.synchronize()

    # ---- the main path, with the kernels' launch counts around it ----
    confusion.confusion_counts.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = evaluation.inference_loop(model, ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = confusion.confusion_counts.launches
    # ------------------------------------------------------------------
    kernel_row["launches"] = launches
    if launches < 1:
        raise AssertionError("inference_loop never launched the "
                             "confusion kernel")
    f1, precision, recall = result["change"]
    log(f"inference_loop: {len(ds)} scenes in {wall:.3f} s = "
        f"{len(ds) / wall:.2f} scenes/s, confusion kernel launches "
        f"{launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  F1 {f1:.6f}, precision {precision:.6f}, recall {recall:.6f}")
    if not all(np.isfinite([f1, precision, recall])):
        raise AssertionError("non-finite metrics")

    # kernel counts == plain counts on the same card probabilities, group
    # by group as the stream forms them; the summed counts reproduce
    # inference_loop's metrics
    m = MultiThresholdMetric([0.5])
    group = evaluation.eval_group_limit(wires[0]["x1"].shape[1:])
    for g0 in range(0, len(wires), group):
        stack = {k: np.stack([w[k] for w in wires[g0:g0 + group]])
                 for k in ("x1", "x2", "y", "valid")}
        probs = eval_forward(model, torch.from_numpy(stack["x1"]).to(dev).float(),
                             torch.from_numpy(stack["x2"]).to(dev).float())
        n = probs.shape[0]
        if probs.shape != (n, 1, MAIN_SIDE, MAIN_SIDE) or not torch.isfinite(probs).all():
            raise AssertionError(f"bad probabilities {tuple(probs.shape)}")
        args = (probs.reshape(n, -1),
                torch.from_numpy(stack["y"]).to(dev).reshape(n, -1),
                torch.from_numpy(stack["valid"]).to(dev).reshape(n, -1),
                torch.tensor([0.5], device=dev))
        got = confusion.confusion_counts(*args)
        want = confusion.confusion_counts_plain(*args)
        err = int((got - want).abs().max())
        kernel_row["max_abs_err"] = max(kernel_row["max_abs_err"], err)
        if err != 0:
            raise AssertionError("kernel counts != plain counts on the "
                                 "main path's probabilities")
        m.add_counts(*want.cpu().numpy().astype(np.float64).sum(axis=0))
        if g0 == 0:
            first_group = (probs[0, 0].cpu().numpy(), n)
        del probs, args, got, want
    f1_plain = float(m.compute_f1()[0])
    log(f"  kernel == plain counts on every group's card probabilities; "
        f"F1 from plain counts {f1_plain:.6f} (|dF1| "
        f"{abs(f1_plain - f1):.2e} vs inference_loop)")
    if abs(f1_plain - f1) > 1e-3:  # two separate forwards of one group
        raise AssertionError("inference_loop F1 disagrees with the plain counts")

    # serving forward on one scene == the matching crop of the group
    item = ds[0]
    p_scene = evaluation.scene_probabilities(model, item, device=dev)
    h, w = item["x_t1"].shape[:2]
    p_group, n_group = first_group
    d_serve = float(np.abs(p_scene - p_group[:h, :w]).max())
    log(f"  scene_probabilities vs grouped forward crop ({h}x{w}): "
        f"max |dp| = {d_serve:.3e} (bf16, batch 1 vs {n_group}; tolerance 2e-2)")
    if p_scene.shape != (h, w) or d_serve > 2e-2:
        raise AssertionError("serving forward disagrees with the group")

    # bf16 autocast vs fp32 (no TF32) on one scene, for information
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    p32 = evaluation.scene_probabilities(model, item, device=dev)
    model.compute_dtype = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = tf32
    log(f"  bf16 autocast vs fp32: max |dp| = "
        f"{float(np.abs(p_scene - p32).max()):.3e} on one scene")

    # one FULL eval group (16 x 1024^2) through the wire-path dispatch:
    # ms per group and peak memory, for the group-size constants
    gen = np.random.default_rng(2)
    c = wires[0]["x1"].shape[0]
    full = (gen.uniform(0, 1, (MAIN_SCENES, c, MAIN_SIDE, MAIN_SIDE)).astype(np.float16),
            gen.uniform(0, 1, (MAIN_SCENES, c, MAIN_SIDE, MAIN_SIDE)).astype(np.float16),
            (gen.uniform(size=(MAIN_SCENES, MAIN_SIDE, MAIN_SIDE)) > 0.9).astype(np.uint8),
            np.ones((MAIN_SCENES, MAIN_SIDE, MAIN_SIDE), np.uint8))
    thr = torch.tensor([0.5], device=dev)
    evaluation._eval_wire_counts(model, *full, thr, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        counts = evaluation._eval_wire_counts(model, *full, thr, dev)
        counts.cpu()
        times.append(time.perf_counter() - t0)
    group_ms = statistics.median(times) * 1e3
    log(f"full group {MAIN_SCENES} x {MAIN_SIDE}^2 (bf16, {card['smi']}): "
        f"{group_ms:.1f} ms/group (host clock, median of 3) = "
        f"{MAIN_SCENES / group_ms * 1e3:.2f} scenes/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
    profile_breakdown(f"full group {MAIN_SCENES} x {MAIN_SIDE}^2",
                      lambda: evaluation._eval_wire_counts(
                          model, *full, thr, dev).cpu())
    profile_breakdown(f"inference_loop over {len(ds)} scenes",
                      lambda: evaluation.inference_loop(model, ds, device=dev))


# -- phase 5 ------------------------------------------------------------------

def _train_cfg(root: Path, out: Path, aois: list, name: str = "siamese"):
    cfg = load_cfg(name)
    cfg.PATHS.DATASET = str(root)
    cfg.PATHS.OUTPUT = str(out)
    cfg.DATASET.TRAINING_IDS = aois[:TRAIN_AOIS]
    cfg.DATASET.VALIDATION_IDS = aois[TRAIN_AOIS:TRAIN_AOIS + 2]
    cfg.DATASET.TEST_IDS = aois[TRAIN_AOIS + 2:TRAIN_AOIS + 4]
    cfg.DATALOADER.TRAINING_MULTIPLIER = TRAIN_MULTIPLIER
    cfg.LOG_FREQ = TRAIN_LOG_FREQ
    cfg.TRAINER.EPOCHS = 1
    cfg.SAVE_CHECKPOINTS = [1]
    return cfg


def bn_per_step(topology, decoder_calls: int = 1, encoder_calls: int = 2,
                streams: int = 1) -> int:
    """Train-mode BatchNorm calls of one step: in each stream, the stem and
    every Down (two each) on each encoder call (one per date in a Siamese
    stream, one on the stacked dates in an early-fusion one), and every Up
    (two each) of each decoder call. At full width: 28 for siameseunet, 44
    for dtsiameseunet (the change decoder, the semantic one on both dates),
    56 for whatevernet (two Siamese streams), 36 for whatevernet2 and
    dualstreamunet (two early-fusion streams), 18 for unet."""
    return streams * (encoder_calls * (2 + 2 * len(topology))
                      + decoder_calls * 2 * len(topology))


def _records(out: Path, name: str) -> list:
    path = out / "logs" / f"{name}.jsonl"
    return [r for r in map(json.loads, path.read_text().splitlines())
            if "_event" not in r]


def _reset_counts() -> None:
    bn_stats.bn_stats.launches = 0
    confusion.confusion_counts.launches = 0
    confusion.strict_confusion_counts.launches = 0


def _counts() -> tuple:
    """Launches of bn_stats, the rounding-rule and the strict-rule confusion
    kernel since the last reset."""
    return (bn_stats.bn_stats.launches, confusion.confusion_counts.launches,
            confusion.strict_confusion_counts.launches)


def phase_train(card: dict, rows: dict, dev: torch.device, root: Path,
                aois: list) -> None:
    out = root / "train_out"
    out.mkdir()
    cfg = _train_cfg(root, out, aois)
    a = cfg.AUGMENTATION
    log(f"training: {cfg.MODEL.TYPE} topology {list(cfg.MODEL.TOPOLOGY)}, "
        f"batch {cfg.TRAINER.BATCH_SIZE}, {a.CROP_SIZE}^2 "
        f"{a.IMAGE_OVERSAMPLING_TYPE} crops, flip {a.RANDOM_FLIP}, rotate "
        f"{a.RANDOM_ROTATE}, precision {cfg.TRAINER.get('PRECISION', 'bf16')}, "
        f"loss {cfg.MODEL.LOSS_TYPE}, lr {cfg.TRAINER.LR}, "
        f"{cfg.DATALOADER.NUM_WORKER} loader threads, LOG_FREQ {cfg.LOG_FREQ}")
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        # ---- the training path, with the kernels' launch counts around it --
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        trainers.run_training(cfg, "supervised", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bn_launches, conf_launches, _ = _counts()
        # --------------------------------------------------------------------
        peak_run = torch.cuda.max_memory_allocated()
    finally:
        wandb_compat.finish()
    records = _records(out, cfg.NAME)
    windows = [r for r in records if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    rows["bn_stats"]["launches"] = bn_launches
    expect = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)   # forward + backward
    log(f"run_training: {steps} steps in {wall:.1f} s wall (with its evals); "
        f"launches bn_stats {bn_launches} ({bn_launches / max(steps, 1):.1f} per "
        f"step, expected {expect}), confusion {conf_launches}; peak "
        f"device memory {peak_run / 2**30:.2f} GiB (training steps and eval "
        f"groups)")
    if bn_launches != expect * steps or steps == 0:
        raise AssertionError(f"bn_stats launched {bn_launches} times in {steps} "
                             f"steps, expected {expect} per step")
    if conf_launches < 1:
        raise AssertionError("model_evaluation never launched the confusion kernel")
    patches = []
    for r in windows:
        rate = cfg.LOG_FREQ * cfg.TRAINER.BATCH_SIZE / r["train_time"]
        patches.append(rate)
        log(f"  window to step {r['step']}: loss {r['loss']:.6f}, train_time "
            f"{r['train_time']:.3f} s = {rate:.2f} patches/s, window time "
            f"{r['time']:.3f} s")
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"non-finite loss {r['loss']}")
    if len(patches) < 4:
        raise AssertionError(f"expected 4 log windows, got {len(patches)}")
    log(f"training throughput (host clock, batch {cfg.TRAINER.BATCH_SIZE} x "
        f"{a.CROP_SIZE}^2, {card['smi']}): {statistics.median(patches[1:]):.2f} "
        f"patches/s, median of windows 2-4 (window 1 is warm-up: "
        f"{patches[0]:.2f})")
    evals = [r for r in records if "test F1" in r]
    log(f"  in-training evaluation: test F1 {evals[-1]['test F1']:.6f} at step "
        f"{evals[-1]['step']}")

    # the checkpoint: parameters moved away from the seeded initial weights
    ckpt = checkpoints.checkpoint_file(cfg, 1)
    model, optimizer, step = checkpoints.load_checkpoint(1, cfg, device=dev)
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    with torch.no_grad():
        moved = [float((p - q).abs().max()) for p, q in
                 zip(model.parameters(), init.parameters())]
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB) at "
        f"step {step}: {sum(m > 0 for m in moved)} of {len(moved)} parameter "
        f"tensors changed (max |dw| {max(moved):.3e}), all finite {finite}")
    if step != steps or sum(m > 0 for m in moved) < len(moved) // 2 or not finite:
        raise AssertionError("checkpoint: wrong step, parameters unchanged or "
                             "not finite")
    del init

    # one step alone: device time, the training peak, a profile, 56 launches
    step_fn = train_lib.make_supervised_train_step(model, optimizer, cfg)
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                         cfg.TRAINER.BATCH_SIZE, num_workers=0, seed=1)
    batch = next(prefetch_to_device(loader, dev))
    for _ in range(2):
        step_fn(batch["stack"], batch["is_labeled"], step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"],
                                           step), runs=5, warmup=0)
    per_step = bn_stats.bn_stats.launches / 5
    log(f"one step on a staged batch (CUDA events, median of 5): "
        f"{step_ms:.1f} ms = {cfg.TRAINER.BATCH_SIZE / step_ms * 1e3:.2f} "
        f"patches/s of device time; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bn_stats "
        f"launches per step {per_step:g}")
    if per_step != expect:
        raise AssertionError(f"{per_step} bn_stats launches per step")
    profile_breakdown("one training step",
                      lambda: step_fn(batch["stack"], batch["is_labeled"], step),
                      top=12, match="bn_stats")
    del model, optimizer, step_fn, batch
    torch.cuda.empty_cache()

    # resume from the latest checkpoint and take one more step (DEBUG)
    cfg = _train_cfg(root, out, aois)
    cfg.TRAINER.RESUME_CHECKPOINT = "latest"
    cfg.TRAINER.EPOCHS = 2
    cfg.DEBUG = True
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        _reset_counts()
        trainers.run_training(cfg, "supervised", device=dev)
        torch.cuda.synchronize()
        bn_launches, conf_launches, _ = _counts()
    finally:
        wandb_compat.finish()
    last = _records(out, cfg.NAME)[-1]
    log(f"resume 'latest' + one step (DEBUG): bn_stats launches {bn_launches}, "
        f"confusion {conf_launches}; last eval at step {last['step']} (epoch "
        f"{last['epoch']:.4f})")
    if bn_launches != expect or last["step"] != steps + 1:
        raise AssertionError("the resumed run did not take exactly one step "
                             "from the checkpoint's")


# -- phase 6 ------------------------------------------------------------------

def _assessment_groups(ds, group: int):
    """The dual-task assessment's wire groups as the stream forms them
    (one padded shape here): stacked (x1, x2, y, ysem1, ysem2, valid)."""
    keys = ("x1", "x2", "y", "ysem1", "ysem2", "valid")
    wires = [ds.eval_wire(i, sem=True) for i in range(len(ds))]
    for g0 in range(0, len(wires), group):
        yield tuple(np.stack([w[k] for w in wires[g0:g0 + group]]) for k in keys)


def phase_dualtask(card: dict, rows: dict, dev: torch.device, root: Path,
                   aois: list) -> None:
    out = root / "dualtask_out"
    out.mkdir()
    cfg = _train_cfg(root, out, aois, "dtsiamese")
    a = cfg.AUGMENTATION
    log(f"dual-task training: {cfg.MODEL.TYPE} topology {list(cfg.MODEL.TOPOLOGY)}, "
        f"batch {cfg.TRAINER.BATCH_SIZE}, {a.CROP_SIZE}^2 {a.IMAGE_OVERSAMPLING_TYPE} "
        f"crops, flip {a.RANDOM_FLIP}, rotate {a.RANDOM_ROTATE}, precision "
        f"{cfg.TRAINER.get('PRECISION', 'bf16')}, loss {cfg.MODEL.LOSS_TYPE}, "
        f"building labels {cfg.DATALOADER.INCLUDE_BUILDING_LABELS}, LOG_FREQ "
        f"{cfg.LOG_FREQ}")
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        # ---- the dual-task training path, with the launch counts around it --
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        trainers.run_training(cfg, "dualtask", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bn_launches, conf_launches, strict_launches = _counts()
        # --------------------------------------------------------------------
        peak_run = torch.cuda.max_memory_allocated()
    finally:
        wandb_compat.finish()
    records = _records(out, cfg.NAME)
    windows = [r for r in records if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    expect = 2 * bn_per_step(cfg.MODEL.TOPOLOGY, decoder_calls=3)   # fwd + bwd
    log(f"run_training dualtask: {steps} steps in {wall:.1f} s wall (with its "
        f"evals); launches bn_stats {bn_launches} ({bn_launches / max(steps, 1):.1f} "
        f"per step, expected {expect}), confusion {conf_launches}, strict "
        f"{strict_launches}; peak device memory {peak_run / 2**30:.2f} GiB")
    if bn_launches != expect * steps or steps == 0:
        raise AssertionError(f"bn_stats launched {bn_launches} times in {steps} "
                             f"steps, expected {expect} per step")
    if conf_launches < 1:
        raise AssertionError("model_evaluation never launched the confusion kernel")
    patches = []
    for r in windows:
        rate = cfg.LOG_FREQ * cfg.TRAINER.BATCH_SIZE / r["train_time"]
        patches.append(rate)
        log(f"  window to step {r['step']}: loss {r['loss']:.6f}, change_loss "
            f"{r['change_loss']:.6f}, sem_loss {r['sem_loss']:.6f}, "
            f"{rate:.2f} patches/s, window time {r['time']:.3f} s")
        if not all(np.isfinite([r["loss"], r["change_loss"], r["sem_loss"]])):
            raise AssertionError(f"non-finite dual-task losses at step {r['step']}")
    if len(patches) < 4:
        raise AssertionError(f"expected 4 log windows, got {len(patches)}")
    log(f"dual-task training throughput (host clock, batch {cfg.TRAINER.BATCH_SIZE} "
        f"x {a.CROP_SIZE}^2, {card['smi']}): {statistics.median(patches[1:]):.2f} "
        f"patches/s, median of windows 2-4 (window 1 is warm-up: "
        f"{patches[0]:.2f})")

    # the checkpoint holds the auxiliary head, which only weight decay moved
    ckpt = checkpoints.checkpoint_file(cfg, 1)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    if "module.outc_sem_change.conv.weight" not in payload["network"]:
        raise AssertionError("the dual-task checkpoint lacks outc_sem_change")
    model, optimizer, step = checkpoints.load_checkpoint(1, cfg, device=dev)
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    with torch.no_grad():
        w0 = init.outc_sem_change.conv.weight.double()
        moved = model.outc_sem_change.conv.weight.double() - w0
        decay = w0 * ((1 - cfg.TRAINER.LR * 0.01) ** step - 1)
        rel = float(((moved - decay).abs() / decay.abs()).max())
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"checkpoint {ckpt.name} at step {step}: outc_sem_change moved by weight "
        f"decay alone: max |dw - w0((1 - lr wd)^{step} - 1)| / |that| = {rel:.3e} "
        f"(limit 0.1); all finite {finite}")
    if step != steps or rel > 0.1 or not finite:
        raise AssertionError("dual-task checkpoint: wrong step, auxiliary head "
                             "not decayed as AdamW decays it, or not finite")
    del init

    # one step alone: device time, peak, 88 launches, a profile
    step_fn = train_lib.make_train_step(model, optimizer, cfg, "dualtask")
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                         cfg.TRAINER.BATCH_SIZE, num_workers=0, seed=1)
    batch = next(prefetch_to_device(loader, dev))
    for _ in range(2):
        step_fn(batch["stack"], batch["is_labeled"], step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"],
                                           step), runs=5, warmup=0)
    per_step = bn_stats.bn_stats.launches / 5
    log(f"one dual-task step on a staged batch (CUDA events, median of 5): "
        f"{step_ms:.1f} ms = {cfg.TRAINER.BATCH_SIZE / step_ms * 1e3:.2f} "
        f"patches/s of device time; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bn_stats launches "
        f"per step {per_step:g}")
    if per_step != expect:
        raise AssertionError(f"{per_step} bn_stats launches per dual-task step")
    profile_breakdown("one dual-task training step",
                      lambda: step_fn(batch["stack"], batch["is_labeled"], step),
                      top=12, match="bn_stats")
    del optimizer, step_fn, batch
    torch.cuda.empty_cache()

    # ---- the assessment path over the 20-scene split, strict counts ----
    cfg.DATASET.TEST_IDS = aois
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    counts = evaluation.dualtask_quantitative_counts(model, ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, conf_launches, strict_launches = _counts()
    # ---------------------------------------------------------------------
    rows["confusion_counts_strict"]["launches"] = strict_launches
    log(f"dualtask_quantitative_counts: {len(ds)} scenes in {wall:.3f} s = "
        f"{len(ds) / wall:.2f} scenes/s, strict kernel launches {strict_launches} "
        f"(rounding-rule launches {conf_launches}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if strict_launches < 1 or conf_launches != 0:
        raise AssertionError("the dual-task assessment did not count through "
                             "the strict kernel alone")
    f1s = {}
    for key, triple in counts.items():
        f1s[key] = metrics.prob_metrics_from_counts(*triple)
        log(f"  {key}: tp/fp/fn {tuple(int(v) for v in triple)}, F1 "
            f"{f1s[key][0]:.6f}, precision {f1s[key][1]:.6f}, recall "
            f"{f1s[key][2]:.6f}")
        if not np.isfinite(f1s[key][0]) or sum(triple) <= 0:
            raise AssertionError(f"dual-task {key} metrics not finite")

    # every group's kernel counts == plain counts on the card's probabilities
    group = max(1, evaluation.eval_group_limit((MAIN_SIDE, MAIN_SIDE)) // 2)
    thr = torch.tensor([0.5], device=dev)
    totals = {k: np.zeros(3) for k in counts}
    err = 0
    for arrs in _assessment_groups(ds, group):
        x1, x2, ych, ys1, ys2, valid = (torch.from_numpy(a).to(dev) for a in arrs)
        heads = evaluation._dualtask_forward(model, x1.float(), x2.float())
        n = x1.shape[0]
        for probs, truth, key in zip(heads, (ych, ys1, ys2, ych),
                                     ("change", "sem", "sem", "change_sem")):
            args = (probs.reshape(n, -1), truth.reshape(n, -1),
                    valid.reshape(n, -1), thr)
            got = confusion.strict_confusion_counts(*args)
            want = confusion.strict_confusion_counts_plain(*args)
            err = max(err, int((got - want).abs().max()))
            totals[key] += want[:, [0, 2, 3], 0].sum(dim=0).cpu().numpy()
        del heads, x1, x2
    rows["confusion_counts_strict"]["max_abs_err"] = max(
        rows["confusion_counts_strict"]["max_abs_err"], err)
    df1 = max(abs(metrics.prob_metrics_from_counts(*totals[k])[0] - f1s[k][0])
              for k in counts)
    log(f"  kernel == plain strict counts on every group's card probabilities "
        f"(max |diff| {err}); F1 from plain counts within {df1:.2e} of the "
        f"fused path's (two separate forwards; tolerance 1e-3)")
    if err != 0 or df1 > 1e-3:
        raise AssertionError("strict kernel counts != plain, or the fused "
                             "assessment disagrees with the plain counts")
    del model
    torch.cuda.empty_cache()


# -- phase 7 ------------------------------------------------------------------

def _semisup_cfg(root: Path, out: Path, aois: list, name: str):
    cfg = _train_cfg(root, out, aois, name)
    cfg.DATASET.UNLABELED_IDS = UNLABELED_AOIS
    cfg.DATALOADER.TRAINING_MULTIPLIER = SEMISUP_MULTIPLIER
    return cfg


def _partition_batch(ds, labeled: bool, size: int, dev: torch.device) -> dict:
    """A batch of ``size`` training crops of labeled or of unlabeled AOIs
    alone, on the card."""
    idx = [i for i, lab in enumerate(ds.labeled) if lab == labeled][:size]
    stack = np.stack([ds.get(i, np.random.default_rng([3, i]))["stack"] for i in idx])
    return {"stack": torch.from_numpy(stack).to(dev),
            "is_labeled": torch.full((size,), float(labeled), device=dev)}


def _staged_step(dev: torch.device, root: Path, aois: list, name: str,
                 regime: str, expect: int) -> str:
    """One staged step of ``name``'s model under ``regime`` at full width on
    a loader batch: a warm-up step, then three timed with CUDA events and
    their bn_stats launches counted; ``expect`` launches per step."""
    cfg = _semisup_cfg(root, root / "unused", aois, name)
    model = create_network(cfg, device=dev,
                           generator=torch.Generator().manual_seed(cfg.SEED))
    optimizer = train_lib.make_optimizer(model, cfg)
    step_fn = train_lib.make_train_step(model, optimizer, cfg, regime)
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                         cfg.TRAINER.BATCH_SIZE, num_workers=0, seed=1)
    batch = next(prefetch_to_device(loader, dev))
    out = step_fn(batch["stack"], batch["is_labeled"], 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"], 1),
                           runs=3, warmup=0)
    per_step = bn_stats.bn_stats.launches / 3
    losses = {k: float(v) for k, v in out.items()}
    line = (f"{cfg.MODEL.TYPE} ({name}, {regime}, batch {cfg.TRAINER.BATCH_SIZE}, "
            f"{int(sum(batch['is_labeled'].tolist()))} labeled): {step_ms:.1f} ms "
            f"per step (CUDA events, median of 3), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, bn_stats launches "
            f"per step {per_step:g} (expected {expect}), loss {losses['loss']:.6f}")
    if per_step != expect or not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"staged step: {line}")
    del model, optimizer, step_fn, batch
    torch.cuda.empty_cache()
    return line


@contextlib.contextmanager
def _watch(module, name: str, keep):
    """Route the path's calls of the kernel wrapper ``module.name`` (the
    name the calling module looks up) through ``keep(args, out)`` after
    the wrapper, which still launches, and counts, once per call."""
    wrapper = getattr(module, name)

    def watched(*args):
        out = wrapper(*args)
        keep(args, out)
        return out

    setattr(module, name, watched)
    try:
        yield
    finally:
        setattr(module, name, wrapper)


def _keepers() -> tuple:
    """Host copies of a path's kernel inputs and outputs, to hold them
    against the plain versions once the counts are read: bn_stats at the
    first launch of each signature (the first step), every confusion
    launch. Returns (bn_seen, conf_calls, keep_bn, keep_conf) for
    :func:`_watch` and :func:`_check_path_launches`."""
    bn_seen, conf_calls = {}, []

    def keep_bn(args, out):
        a, b = args
        key = (tuple(a.shape), a.dtype, a is b)
        # a copy to the host would end a CUDA graph's capture; its first
        # launch of a signature came in the eager steps before it
        if key not in bn_seen and not (a.is_cuda
                                       and torch.cuda.is_current_stream_capturing()):
            bn_seen[key] = (a.detach().cpu(),
                            None if a is b else b.detach().cpu(),
                            tuple(o.detach().cpu() for o in out))

    def keep_conf(args, out):
        conf_calls.append((tuple(t.detach().cpu() for t in args), out.cpu()))

    return bn_seen, conf_calls, keep_bn, keep_conf


def _check_bn_launches(rows: dict, dev: torch.device, bn_seen: dict,
                       path: str) -> tuple:
    """bn_stats at the first launch of every (shape, dtype, a is b) a path
    gave it against the plain version in float64 (the limit of phase 3b),
    and a relaunch bit-equal; returns (worst ratio, max |kernel - ref|)."""
    worst, err = 0.0, 0.0
    for (shape, dtype, same), (a, b, got) in bn_seen.items():
        a = a.to(dev)
        b = a if same else b.to(dev)
        ratio, e = _bn_error(got, a, b)
        again = bn_stats.bn_stats(a, b)
        bitwise = all(torch.equal(g.to(dev), h) for g, h in zip(got, again))
        worst, err = max(worst, ratio), max(err, e)
        log(f"  bn_stats path launch {shape} {str(dtype)[6:]} a is b {same}: "
            f"error / limit {ratio:.4f}, relaunch bit-equal {bitwise}")
        if ratio > 1.0 or not bitwise:
            raise AssertionError(f"bn_stats on the {path} path's input "
                                 f"{shape} {dtype} same={same}: error ratio "
                                 f"{ratio:.3g} (limit 1), bit-equal {bitwise}")
    rows["bn_stats"]["max_abs_err"] = max(rows["bn_stats"]["max_abs_err"], err)
    if not bn_seen:
        raise AssertionError(f"no bn_stats launch of the {path} path was kept")
    return worst, err


def _check_path_launches(rows: dict, dev: torch.device, bn_seen: dict,
                         conf_calls: list, path: str = "semi-supervised") -> None:
    """The path's own kernel outputs against the plain versions on the same
    inputs: bn_stats as :func:`_check_bn_launches` holds them, and every
    rounding-rule confusion launch (:func:`_check_conf_launches`)."""
    worst, err = _check_bn_launches(rows, dev, bn_seen, path)
    log(f"  the path's bn_stats launches at {len(bn_seen)} input signatures: "
        f"within the limit (worst {worst:.4f} of it, max |kernel - ref| "
        f"{err:.3e})")
    _check_conf_launches(rows, dev, conf_calls, path)


def _check_conf_launches(rows: dict, dev: torch.device, conf_calls: list,
                         path: str) -> None:
    """Every kept rounding-rule confusion launch ``(args, out)`` of a path
    against the plain version on the same inputs, exactly."""
    conf_err = 0
    for args, got in conf_calls:
        args = tuple(t.to(dev) for t in args)
        conf_err = max(conf_err, int((got.to(dev) - confusion.confusion_counts_plain(
            *args)).abs().max()))
    rows["confusion_counts"]["max_abs_err"] = max(
        rows["confusion_counts"]["max_abs_err"], conf_err)
    log(f"  the path's {len(conf_calls)} confusion launches: max |kernel - "
        f"plain| {conf_err} on {sum(int(a[0].numel()) for a, _ in conf_calls)} "
        f"probabilities")
    if not conf_calls or conf_err != 0:
        raise AssertionError(f"the {path} path's confusion counts != plain, "
                             f"or no launch was kept")


def phase_semisup(card: dict, rows: dict, dev: torch.device, root: Path,
                  aois: list) -> None:
    out = root / "semisup_out"
    out.mkdir()
    cfg = _semisup_cfg(root, out, aois, "siamese_mmcr_alpha0500")
    a = cfg.AUGMENTATION
    log(f"semi-supervised training: {cfg.MODEL.TYPE} topology "
        f"{list(cfg.MODEL.TOPOLOGY)}, batch {cfg.TRAINER.BATCH_SIZE}, "
        f"{a.CROP_SIZE}^2 crops, {TRAIN_AOIS} labeled + {len(UNLABELED_AOIS)} "
        f"unlabeled AOIs x {cfg.DATALOADER.TRAINING_MULTIPLIER}, precision "
        f"{cfg.TRAINER.get('PRECISION', 'bf16')}, loss {cfg.MODEL.LOSS_TYPE}, "
        f"consistency {cfg.CONSISTENCY_TRAINER.LOSS_TYPE} alpha "
        f"{cfg.CONSISTENCY_TRAINER.LOSS_FACTOR}, LOG_FREQ {cfg.LOG_FREQ}")
    bn_seen, conf_calls, keep_bn, keep_conf = _keepers()
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        with _watch(batchnorm, "bn_stats", keep_bn), \
                _watch(evaluation, "confusion_counts", keep_conf):
            # ---- the semi-supervised path, with the launch counts around it --
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            trainers.run_training(cfg, "semisupervised", device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            bn_launches, conf_launches, _ = _counts()
            # ------------------------------------------------------------------
        peak_run = torch.cuda.max_memory_allocated()
    finally:
        wandb_compat.finish()
    records = _records(out, cfg.NAME)
    windows = [r for r in records if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    topology = cfg.MODEL.TOPOLOGY
    expect = 2 * bn_per_step(topology, streams=2)   # forward + backward
    rows["bn_stats"]["launches"] = bn_launches
    rows["confusion_counts"]["launches"] = conf_launches
    log(f"run_training semisupervised: {steps} steps in {wall:.1f} s wall (with "
        f"its evals); launches bn_stats {bn_launches} ({bn_launches / max(steps, 1):.1f} "
        f"per step, expected {expect}), confusion {conf_launches}; peak device "
        f"memory {peak_run / 2**30:.2f} GiB")
    if bn_launches != expect * steps or steps != 48:
        raise AssertionError(f"bn_stats launched {bn_launches} times in {steps} "
                             f"steps, expected {expect} per step over 48")
    if conf_launches < 1:
        raise AssertionError("model_evaluation never launched the confusion kernel")
    _check_path_launches(rows, dev, bn_seen, conf_calls)
    del bn_seen, conf_calls
    keys = ("loss", "sup_loss", "cons_loss", "fusion_loss", "stream1_loss",
            "stream2_loss")
    patches = []
    for r in windows:
        rate = cfg.LOG_FREQ * cfg.TRAINER.BATCH_SIZE / r["train_time"]
        patches.append(rate)
        log(f"  window to step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.6f}" for k in keys)
            + f", labeled {r['labeled_percentage']:.2f}%, {rate:.2f} patches/s, "
            f"window time {r['time']:.3f} s")
        if not all(np.isfinite([r[k] for k in keys])):
            raise AssertionError(f"non-finite semi-supervised losses at step {r['step']}")
    share = statistics.mean(r["labeled_percentage"] for r in windows)
    log(f"  labeled share over the run {share:.6f}% (expected {800 / 12:.6f}%: "
        f"{TRAIN_AOIS} of {TRAIN_AOIS + len(UNLABELED_AOIS)} AOIs, whole epoch)")
    if len(patches) != 4 or abs(share - 800 / 12) > 1e-9:
        raise AssertionError(f"{len(patches)} windows, labeled share {share}")
    if not (max(r["sup_loss"] for r in windows) > 0
            and max(r["cons_loss"] for r in windows) > 0):
        raise AssertionError("a loss term stayed 0 over the whole run")
    log(f"semi-supervised training throughput (host clock, batch "
        f"{cfg.TRAINER.BATCH_SIZE} x {a.CROP_SIZE}^2, {card['smi']}): "
        f"{statistics.median(patches[1:]):.2f} patches/s, median of windows 2-4 "
        f"(window 1 is warm-up: {patches[0]:.2f})")
    evals = [r for r in records if "test F1" in r]
    log(f"  in-training evaluation (fusion head): test F1 "
        f"{evals[-1]['test F1']:.6f} at step {evals[-1]['step']}")

    # the checkpoint rebuilds the model; its parameters moved and are finite
    ckpt = checkpoints.checkpoint_file(cfg, 1)
    model, optimizer, step = checkpoints.load_checkpoint(1, cfg, device=dev)
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    with torch.no_grad():
        moved = [float((p - q).abs().max()) for p, q in
                 zip(model.parameters(), init.parameters())]
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    # AdamW's step counters stay on the host (on the card each would cost a
    # device-to-host copy per parameter tensor at every step), its moments
    # go to the card
    state = list(optimizer.state.values())
    placed = (all(s["step"].device.type == "cpu" for s in state)
              and all(s["exp_avg_sq"].device.type == "cuda" for s in state))
    log(f"checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB) at step "
        f"{step}: {type(model).__name__}, {sum(m > 0 for m in moved)} of "
        f"{len(moved)} parameter tensors changed (max |dw| {max(moved):.3e}), all "
        f"finite {finite}; AdamW step counters on the host, moments on the card: "
        f"{placed}")
    if (type(model).__name__ != "WhateverNet" or step != steps or not placed
            or sum(m > 0 for m in moved) < len(moved) // 2 or not finite):
        raise AssertionError("semi-supervised checkpoint: wrong model or step, "
                             "parameters unchanged or not finite, or AdamW's "
                             "state misplaced")
    del init

    # one all-labeled and one all-unlabeled step: the absent term is 0
    step_fn = train_lib.make_train_step(model, optimizer, cfg, "semisupervised")
    ds = MultimodalCDDataset(cfg, "training")
    for labeled, absent, present in ((True, "cons_loss", "sup_loss"),
                                     (False, "sup_loss", "cons_loss")):
        batch = _partition_batch(ds, labeled, cfg.TRAINER.BATCH_SIZE, dev)
        _reset_counts()
        got = {k: float(v) for k, v in
               step_fn(batch["stack"], batch["is_labeled"], step).items()}
        log(f"  all-{'labeled' if labeled else 'unlabeled'} step: {absent} "
            f"{got[absent]}, loss {got['loss']:.6f} == {present} "
            f"{got[present]:.6f}, n_labeled {got['n_labeled']:g}, bn_stats launches "
            f"{bn_stats.bn_stats.launches}")
        if (got[absent] != 0.0 or got["loss"] != got[present] or got[present] <= 0
                or bn_stats.bn_stats.launches != expect):
            raise AssertionError(f"all-{'labeled' if labeled else 'unlabeled'} "
                                 f"step: {got}")

    # one step alone on a loader batch: device time, peak, launches, profile
    loader = TrainLoader(ds, cfg.TRAINER.BATCH_SIZE, num_workers=0, seed=1)
    batch = next(prefetch_to_device(loader, dev))
    for _ in range(2):
        step_fn(batch["stack"], batch["is_labeled"], step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"],
                                           step), runs=5, warmup=0)
    per_step = bn_stats.bn_stats.launches / 5
    log(f"one semi-supervised step on a staged batch "
        f"({int(sum(batch['is_labeled'].tolist()))} of {cfg.TRAINER.BATCH_SIZE} "
        f"labeled; CUDA events, median of 5): {step_ms:.1f} ms = "
        f"{cfg.TRAINER.BATCH_SIZE / step_ms * 1e3:.2f} patches/s of device time; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"bn_stats launches per step {per_step:g}")
    if per_step != expect:
        raise AssertionError(f"{per_step} bn_stats launches per semi-supervised step")
    profile_breakdown("one semi-supervised training step",
                      lambda: step_fn(batch["stack"], batch["is_labeled"], step),
                      top=12, match="bn_stats")
    del model, optimizer, step_fn, batch
    torch.cuda.empty_cache()

    # the rest of the factory: one staged step each
    for name, regime, expect_bn in (
            ("unet_mmcr_alpha0500", "semisupervised",
             bn_per_step(topology, encoder_calls=1, streams=2)),
            ("dtsiamese_ssl", "semisupervised", bn_per_step(topology, decoder_calls=3)),
            ("unet", "supervised", bn_per_step(topology, encoder_calls=1)),
            ("baseline_dualstream", "supervised",
             bn_per_step(topology, encoder_calls=1, streams=2))):
        log("  staged step " + _staged_step(dev, root, aois, name, regime,
                                            2 * expect_bn))


# -- phase 8 ------------------------------------------------------------------

def phase_siamunet_diff(card: dict, rows: dict, dev: torch.device, root: Path,
                        aois: list) -> None:
    out = root / "diff_out"
    out.mkdir()
    cfg = _train_cfg(root, out, aois)
    cfg.MODEL.TYPE = "siamunet_diff"
    cfg.DATALOADER.TRAINING_MULTIPLIER = DIFF_MULTIPLIER
    cfg.LOG_FREQ = DIFF_LOG_FREQ
    a = cfg.AUGMENTATION
    log(f"siamunet_diff training: FC-Siam-diff (widths 16/32/64/128, dropout "
        f"0.2), batch {cfg.TRAINER.BATCH_SIZE}, {a.CROP_SIZE}^2 "
        f"{a.IMAGE_OVERSAMPLING_TYPE} crops, flip {a.RANDOM_FLIP}, rotate "
        f"{a.RANDOM_ROTATE}, precision {cfg.TRAINER.get('PRECISION', 'bf16')}, "
        f"loss {cfg.MODEL.LOSS_TYPE}, {TRAIN_AOIS} AOIs x {DIFF_MULTIPLIER}, "
        f"LOG_FREQ {cfg.LOG_FREQ}")
    bn_seen, conf_calls, keep_bn, keep_conf = _keepers()
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        with _watch(batchnorm, "bn_stats", keep_bn), \
                _watch(evaluation, "confusion_counts", keep_conf):
            # ---- the siamunet_diff path, with the launch counts around it --
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            trainers.run_training(cfg, "supervised", device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            bn_launches, conf_launches, _ = _counts()
            # ------------------------------------------------------------------
        peak_run = torch.cuda.max_memory_allocated()
    finally:
        wandb_compat.finish()
    records = _records(out, cfg.NAME)
    windows = [r for r in records if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    log(f"run_training siamunet_diff: {steps} steps in {wall:.1f} s wall (with "
        f"its evals); launches bn_stats {bn_launches} ({bn_launches / max(steps, 1):.1f} "
        f"per step, expected {DIFF_BN_PER_STEP}), confusion {conf_launches}; peak "
        f"device memory {peak_run / 2**30:.2f} GiB")
    expect_steps = TRAIN_AOIS * DIFF_MULTIPLIER // cfg.TRAINER.BATCH_SIZE
    if bn_launches != DIFF_BN_PER_STEP * steps or steps != expect_steps:
        raise AssertionError(f"bn_stats launched {bn_launches} times in {steps} "
                             f"steps, expected {DIFF_BN_PER_STEP} per step over "
                             f"{expect_steps}")
    if conf_launches < 1:
        raise AssertionError("model_evaluation never launched the confusion kernel")
    shapes = {key[0] for key in bn_seen}
    if shapes != set(DIFF_BN_SHAPES):
        raise AssertionError(f"siamunet_diff's BatchNorm shapes {sorted(shapes)}")
    _check_path_launches(rows, dev, bn_seen, conf_calls, "siamunet_diff")
    del bn_seen, conf_calls
    patches = []
    for r in windows:
        rate = cfg.LOG_FREQ * cfg.TRAINER.BATCH_SIZE / r["train_time"]
        patches.append(rate)
        log(f"  window to step {r['step']}: loss {r['loss']:.6f}, {rate:.2f} "
            f"patches/s, window time {r['time']:.3f} s")
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"non-finite siamunet_diff loss at step {r['step']}")
    if len(patches) != 4:
        raise AssertionError(f"expected 4 log windows, got {len(patches)}")
    log(f"siamunet_diff training throughput (host clock, batch "
        f"{cfg.TRAINER.BATCH_SIZE} x {a.CROP_SIZE}^2, {card['smi']}): "
        f"{statistics.median(patches[1:]):.2f} patches/s, median of windows 2-4 "
        f"(window 1 is warm-up: {patches[0]:.2f})")
    evals = [r for r in records if "test F1" in r]
    log(f"  in-training evaluation: test F1 {evals[-1]['test F1']:.6f} at step "
        f"{evals[-1]['step']}")

    # the checkpoint reloads through load_checkpoint; parameters moved
    ckpt = checkpoints.checkpoint_file(cfg, 1)
    model, optimizer, step = checkpoints.load_checkpoint(1, cfg, device=dev)
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    with torch.no_grad():
        moved = [float((p - q).abs().max()) for p, q in
                 zip(model.parameters(), init.parameters())]
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.2f} MiB) at step "
        f"{step}: {type(model).__name__}, {sum(m > 0 for m in moved)} of "
        f"{len(moved)} parameter tensors changed (max |dw| {max(moved):.3e}), all "
        f"finite {finite}")
    if (type(model).__name__ != "SiamUnetDiff" or step != steps or not finite
            or sum(m > 0 for m in moved) < len(moved) // 2):
        raise AssertionError("siamunet_diff checkpoint: wrong model or step, "
                             "parameters unchanged or not finite")
    del init

    # inference over the 20 scenes with the checkpoint
    cfg.DATASET.TEST_IDS = aois
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    _reset_counts()
    t0 = time.perf_counter()
    f1, precision, recall = evaluation.inference_loop(model, ds, device=dev)["change"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = confusion.confusion_counts.launches
    log(f"inference_loop siamunet_diff: {len(ds)} scenes in {wall:.3f} s = "
        f"{len(ds) / wall:.2f} scenes/s (first pass), confusion launches "
        f"{launches}; F1 {f1:.6f}, precision {precision:.6f}, recall {recall:.6f}")
    if launches < 1 or not all(np.isfinite([f1, precision, recall])):
        raise AssertionError("siamunet_diff inference: no launch or non-finite")

    # one step alone: device time, peak, 58 launches, a profile
    step_fn = train_lib.make_supervised_train_step(model, optimizer, cfg)
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                         cfg.TRAINER.BATCH_SIZE, num_workers=0, seed=1)
    batch = next(prefetch_to_device(loader, dev))
    for _ in range(2):
        step_fn(batch["stack"], batch["is_labeled"], step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"],
                                           step), runs=5, warmup=0)
    per_step = bn_stats.bn_stats.launches / 5
    log(f"one siamunet_diff step on a staged batch (CUDA events, median of 5): "
        f"{step_ms:.1f} ms = {cfg.TRAINER.BATCH_SIZE / step_ms * 1e3:.2f} "
        f"patches/s of device time; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bn_stats launches "
        f"per step {per_step:g}")
    if per_step != DIFF_BN_PER_STEP:
        raise AssertionError(f"{per_step} bn_stats launches per siamunet_diff step")
    profile_breakdown("one siamunet_diff step",
                      lambda: step_fn(batch["stack"], batch["is_labeled"], step),
                      top=12, match="bn_stats")
    del model, optimizer, step_fn, batch
    torch.cuda.empty_cache()
    log(f"bn_stats per launch at siamunet_diff's BatchNorm shapes on {card['smi']} "
        f"(CUDA graphs of 20 launches, median of 5 rounds), bf16:")
    gen = torch.Generator(device=dev).manual_seed(8)
    for shape in DIFF_BN_SHAPES:
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        t = bn_kernel_times(card, dy, x)
        log(f"  bn_stats at {shape}, {t['chunks']} x {shape[1]} blocks: backward "
            f"{t['back_ms'] * 1e3:.2f} us (bound {t['back_bound'] * 1e3:.2f} us, "
            f"{t['back_bound'] / t['back_ms'] * 100:.1f}%), forward "
            f"{t['fwd_ms'] * 1e3:.2f} us (bound {t['fwd_bound'] * 1e3:.2f} us, "
            f"{t['fwd_bound'] / t['fwd_ms'] * 100:.1f}%)")
        del dy, x


def _split_opts(aois: list, test_ids: list) -> list:
    """``KEY VALUE`` overrides pointing a shipped config at the smoke split
    and at the phases' checkpoints (epoch 1)."""
    return ["DATASET.TRAINING_IDS", repr(aois[:TRAIN_AOIS]),
            "DATASET.VALIDATION_IDS", repr(aois[TRAIN_AOIS:TRAIN_AOIS + 2]),
            "DATASET.TEST_IDS", repr(test_ids), "INFERENCE_CHECKPOINT", "1"]


def _run_cli(label: str, main, *args, **kw):
    """Call a CLI's ``main`` in process; its stdout is kept and echoed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(*args, **kw)
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  [{label}] {line}")
    return buf.getvalue(), result, seconds


def phase_clis(dev: torch.device, root: Path, aois: list) -> None:
    """The offline CLIs through their ``main``, on phases 5 and 6's
    checkpoints and the smoke split."""
    device = ["--device", dev.type]
    t_start = time.perf_counter()
    base = ["-d", str(root), "-r", "test"]

    # assessment_change on phase 5's siamese checkpoint == inference_loop's
    train_out = root / "train_out"
    text, _, sec = _run_cli("assessment_change", assessment_change.main,
                            ["-c", "siamese", "-o", str(train_out)] + base + device
                            + _split_opts(aois, aois))
    cfg = _train_cfg(root, train_out, aois)
    cfg.DATASET.TEST_IDS = aois
    model, _, _ = checkpoints.load_checkpoint(1, cfg, device=dev)
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    f1, p, r = evaluation.inference_loop(model, ds, device=dev)["change"]
    want = f"F1 score: {f1:.3f} - Precision: {p:.3f} - Recall {r:.3f}"
    log(f"assessment_change ({sec:.2f} s): printed == inference_loop's line on "
        f"the checkpoint ({want}): {want in text.splitlines()}")
    if want not in text.splitlines():
        raise AssertionError("assessment_change printed another line than "
                             "inference_loop's")
    del model

    # assessment_semantics on phase 6's dtsiamese checkpoint == the pooled
    # strict counts of that checkpoint
    dual_out = root / "dualtask_out"
    _reset_counts()
    text, _, sec = _run_cli("assessment_semantics", assessment_semantics.main,
                            ["-c", "dtsiamese", "-o", str(dual_out)] + base + device
                            + _split_opts(aois, aois))
    _, _, strict_cli = _counts()
    cfg = _train_cfg(root, dual_out, aois, "dtsiamese")
    cfg.DATASET.TEST_IDS = aois
    model, _, _ = checkpoints.load_checkpoint(1, cfg, device=dev)
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    counts = evaluation.dualtask_quantitative_counts(model, ds, device=dev)

    def blocks(counts: dict) -> list:
        lines = []
        for title, key in (("Change", "change"), ("Change Sem", "change_sem"),
                           ("Sem", "sem")):
            f1, p, r = metrics.prob_metrics_from_counts(*counts[key])
            lines += [f"--{title}--",
                      f"F1 score: {f1:.3f} - Precision: {p:.3f} - Recall {r:.3f}"]
        return lines

    want = blocks(counts)
    got = [line for line in text.splitlines() if line.startswith(("--", "F1"))]
    log(f"assessment_semantics ({sec:.2f} s): strict launches {strict_cli}; the "
        f"three blocks == prob_metrics_from_counts over the checkpoint's pooled "
        f"counts: {got == want}")
    if got != want or strict_cli < 1:
        raise AssertionError(f"assessment_semantics printed {got}, expected {want}")

    # the scene cache off: the float32 items, counted on the card by the
    # strict kernel == dualtask_item_counts in process
    _reset_counts()
    text, _, sec = _run_cli("assessment_semantics, cache off",
                            assessment_semantics.main,
                            ["-c", "dtsiamese", "-o", str(dual_out)] + base + device
                            + _split_opts(aois, aois)
                            + ["DATALOADER.SCENE_CACHE", "False"])
    _, _, strict_off = _counts()
    cfg.DATALOADER.SCENE_CACHE = False
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    counts_off = evaluation.dualtask_item_counts(model, ds, device=dev)
    want = blocks(counts_off)
    got = [line for line in text.splitlines() if line.startswith(("--", "F1"))]
    log(f"assessment_semantics, cache off ({sec:.2f} s): strict launches "
        f"{strict_off}; the three blocks == prob_metrics_from_counts over "
        f"dualtask_item_counts: {got == want}; pooled (tp, fp, fn) equal to "
        f"the cached wires': {counts_off == counts}")
    if got != want or strict_off < 1:
        raise AssertionError(f"assessment_semantics (cache off) printed {got}, "
                             f"expected {want}")
    del model

    # the colored zoom comparison over 3 of the split's AOIs
    _, figure, sec = _run_cli(
        "qualitative_comparison", qualitative_comparison.main,
        ["-c", "siamese", "-o", str(train_out), "-d", str(root)] + device
        + _split_opts(aois, aois[:3]),
        aoi_ids=aois[:3], zooms=[(100, 200, 300), (0, 0, 256), (500, 400, None)])
    log(f"qualitative_comparison ({sec:.2f} s): {figure} ({figure.stat().st_size} "
        f"bytes, {png.read_png(figure).shape} px)")

    # sanity_check: 2 augmented training samples
    out = root / "cli_out"
    _, files, sec = _run_cli("sanity_check", sanity_check.main,
                             ["-c", "siamese", "-d", str(root), "-n", "2", "-o",
                              str(out / "sanity")] + _split_opts(aois, aois))
    log(f"sanity_check ({sec:.2f} s): {[str(f) for f in files]}")
    if len(files) != 2 or not all(f.is_file() for f in files):
        raise AssertionError("sanity_check did not write its two figures")

    # preprocessing on a hard-linked copy of the split == its metadata.json
    meta = geofiles.load_json(root / "metadata.json")
    copy = out / "split_copy"
    for aoi in meta:
        shutil.copytree(root / aoi, copy / aoi, copy_function=os.link)
    _, written, sec = _run_cli("preprocessing", preprocessing.main, ["-d", str(copy)])
    same = geofiles.load_json(copy / "metadata.json") == meta == written
    log(f"preprocessing ({sec:.2f} s): {copy / 'metadata.json'} == the split's "
        f"metadata.json ({len(meta)} AOIs): {same}")
    if not same:
        raise AssertionError("preprocessing wrote another metadata.json")
    log(f"offline CLIs: {time.perf_counter() - t_start:.1f} s wall, checks included")


# -- phase 9 ------------------------------------------------------------------

def phase_serving(card: dict, dev: torch.device, root: Path, aois: list) -> None:
    """9a: phase 5's checkpoint exported through ``export_serving.main`` for
    the card, loaded, and every served map held against
    ``evaluation.scene_probabilities`` on the same checkpoint and scene."""
    train_out = root / "train_out"
    dest = root / "serving" / "siamese_serving.zip"
    argv = (["-c", "siamese", "-p", "smoke", "-o", str(train_out), "-d", str(root),
             "--dest", str(dest), "--buckets", SERVE_BUCKETS, "--platforms", "cuda",
             "--batch-sizes", SERVE_BATCHES, "--device", dev.type]
            + _split_opts(aois, aois))
    _, path, export_s = _run_cli("export_serving", export_serving.main, argv)
    t0 = time.perf_counter()
    served = serving.load_serving_bundle(path)          # the card: device=None
    load_s = time.perf_counter() - t0
    log(f"serving bundle {path.name}: {path.stat().st_size / 1e6:.1f} MB, exported "
        f"in {export_s:.2f} s ({len(served.buckets)} buckets x batch sizes "
        f"{served.batch_sizes}, platform {served.platform}, compute "
        f"{served.meta['compute_dtype'][served.platform]}), loaded in {load_s:.2f} s")

    cfg = _train_cfg(root, train_out, aois)
    cfg.DATASET.TEST_IDS = aois
    model, _, _ = checkpoints.load_checkpoint(1, cfg, device=dev)
    ds = MultimodalCDDataset(cfg, "test", no_augmentations=True,
                             dataset_mode="first_last", disable_multiplier=True,
                             disable_unlabeled=True)
    items = [ds[i] for i in range(len(ds))]
    want = [evaluation.scene_probabilities(model, it, device=dev) for it in items]
    # the first batch-8 chunk of predict_batch below (the scenes share one
    # square bucket), through eval_forward
    side = served._bucket_for(*items[0]["x_t1"].shape[:2])[0]
    padded = [[evaluation.pad_to_bucket(it[k], side)[0] for it in items[:8]]
              for k in ("x_t1", "x_t2")]
    want8 = eval_forward(model, *(evaluation._nchw(np.stack(p), dev) for p in padded))
    want8 = [want8[j, 0, :it["x_t1"].shape[0], :it["x_t1"].shape[1]].cpu().numpy()
             for j, it in enumerate(items[:8])]
    del model, padded
    torch.cuda.empty_cache()

    served.predict(items[0]["x_t1"], items[0]["x_t2"])   # loads the artifact
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = [served.predict(it["x_t1"], it["x_t2"]) for it in items]
    predict_s = time.perf_counter() - t0
    peak_predict = torch.cuda.max_memory_allocated()
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    equal = all(g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))
    buckets = sorted({served._bucket_for(*it["x_t1"].shape[:2]) for it in items})
    log(f"  predict over {len(items)} scenes (~{AOI_SIDE}^2, buckets {buckets}, batch 1): "
        f"{len(items) / predict_s:.2f} scenes/s (host clock), peak device memory "
        f"{peak_predict / 2**30:.2f} GiB; == scene_probabilities bit for bit: "
        f"{equal} (max |dp| {diff:.3e})")

    rng = np.random.default_rng(9)
    crops = [tuple(rng.uniform(0, 1, (256, 256, served.meta["in_channels"]))
                   .astype(np.float32) for _ in range(2)) for _ in range(2)]
    pairs = [(it["x_t1"], it["x_t2"]) for it in items] + crops
    served.predict_batch(pairs[:2] + crops)       # loads the batch-8 artifacts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batched = served.predict_batch(pairs)
    batch_s = time.perf_counter() - t0
    peak_batch = torch.cuda.max_memory_allocated()
    single = got + [served.predict(*c) for c in crops]
    bdiff = max(float(np.abs(b - p).max()) for b, p in zip(batched, single))
    bequal = all(np.array_equal(b, p) for b, p in zip(batched, single))
    equal8 = all(np.array_equal(b, w) for b, w in zip(batched[:8], want8))
    log(f"  predict_batch over {len(pairs)} pairs ({len(items)} scenes in chunks of "
        f"up to 8 and two 256^2 crops, each chunk through the batch-8 artifact): "
        f"{len(pairs) / batch_s:.2f} pairs/s (host clock), peak device memory "
        f"{peak_batch / 2**30:.2f} GiB; == predict bit for bit: {bequal} (max "
        f"|dp| {bdiff:.3e}; limit {SERVE_BATCH_LIMIT:g}: another batch size may "
        f"take other cuDNN bf16 algorithms, as phase 4's group does); its first "
        f"chunk == eval_forward on the same 8 padded scenes bit for bit: {equal8}")
    if not equal or not equal8:
        raise AssertionError(f"served maps differ from the eval forward's (batch "
                             f"1: up to {diff:.3e}; batch 8 equal: {equal8})")
    if not all(b.shape == p.shape and np.isfinite(b).all()
               for b, p in zip(batched, single)) or bdiff > SERVE_BATCH_LIMIT:
        raise AssertionError(f"predict_batch differs from predict by {bdiff:.3e}")
    del served, items, want, want8, got, batched, single
    torch.cuda.empty_cache()


def _knob_step(rows: dict, dev: torch.device, cfg, batch: dict, state: dict,
               accum: int, remat: bool) -> tuple:
    """One staged supervised step from ``state`` with ``TRAINER.GRAD_ACCUM
    accum`` and ``MODEL.REMAT remat``, its bn_stats launches counted and
    held against the plain version (:func:`_watch`); then three more timed
    with CUDA events, the peak device memory around them. Returns (launches,
    the running statistics after the counted step, ms, peak bytes)."""
    cfg = cfg.clone()
    cfg.TRAINER.GRAD_ACCUM = accum
    cfg.MODEL.REMAT = remat
    model = create_network(cfg, device=dev)
    model.load_state_dict(state)
    step_fn = train_lib.make_supervised_train_step(
        model, train_lib.make_optimizer(model, cfg), cfg)
    bn_seen, _, keep_bn, _ = _keepers()
    with _watch(batchnorm, "bn_stats", keep_bn):
        # ---- one step of the path, with the launch count around it ----
        torch.cuda.synchronize()
        _reset_counts()
        step_fn(batch["stack"], batch["is_labeled"], 0)
        torch.cuda.synchronize()
        launches = bn_stats.bn_stats.launches
        # -----------------------------------------------------------------
    buffers = {k: v.clone() for k, v in model.state_dict().items()
               if k.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                           "num_batches_tracked")}
    _check_bn_launches(rows, dev, bn_seen, f"accum {accum} remat {remat}")
    del bn_seen
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: step_fn(batch["stack"], batch["is_labeled"], 1),
                      runs=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    del model, step_fn
    torch.cuda.empty_cache()
    return launches, buffers, ms, peak


def phase_knobs(card: dict, rows: dict, dev: torch.device, root: Path,
                aois: list) -> int:
    """9b: one staged full-width siameseunet step in each knob mode at batch
    8, then plain and REMAT at batch 32; returns the path's bn_stats
    launches."""
    cfg = _train_cfg(root, root / "unused", aois)
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    state = {k: v.clone() for k, v in init.state_dict().items()}
    del init
    per_step = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    total = 0
    for batch_size, modes in ((8, KNOB_MODES), (32, KNOB_MODES[::2])):
        loader = TrainLoader(MultimodalCDDataset(cfg, "training"), batch_size,
                             num_workers=0, seed=1)
        batch = next(prefetch_to_device(loader, dev))
        plain = None
        for label, accum, remat in modes:
            launches, buffers, ms, peak = _knob_step(rows, dev, cfg, batch, state,
                                                     accum, remat)
            expect = per_step * accum * (3 if remat else 2) // 2
            total += launches
            same = None        # REMAT's buffers against the plain step's
            if plain is None:
                plain = buffers
            elif accum == 1:
                same = all(torch.equal(v, plain[k]) for k, v in buffers.items())
            log(f"  {label} at batch {batch_size} (micro-batch {batch_size // accum}"
                f"): {ms:.1f} ms per step (CUDA events, median of 3) = "
                f"{batch_size / ms * 1e3:.2f} patches/s of device time, peak "
                f"device memory {peak / 2**30:.2f} GiB, bn_stats launches "
                f"{launches} (expected {expect})"
                + ("" if same is None else
                   f"; running statistics == plain's bit for bit: {same}"))
            if launches != expect or same is False:
                raise AssertionError(f"knob mode {label} at batch {batch_size}: "
                                     f"{launches} launches or running statistics "
                                     f"off the plain step's")
        del batch, loader
        torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def _batch_digests(digests: list, arrivals: list):
    """Record a digest of every batch the trainer's loader hands to
    ``prefetch_to_device`` (its stack bytes and label mask) and the host
    clock when it arrived."""
    wrapped = trainers.prefetch_to_device

    def spy(iterator, device):
        def recorded():
            for batch in iterator:
                arrivals.append(time.perf_counter())
                digests.append(_digest(batch))
                yield batch
        return wrapped(recorded(), device)

    trainers.prefetch_to_device = spy
    try:
        yield
    finally:
        trainers.prefetch_to_device = wrapped


def _digest(batch: dict) -> str:
    h = hashlib.sha256(batch["stack"].tobytes())
    h.update(batch["is_labeled"].tobytes())
    return h.hexdigest()


def phase_knob_run(card: dict, rows: dict, dev: torch.device, root: Path,
                   aois: list) -> int:
    """9c: ``trainers.run_training`` with GRAD_ACCUM 2, process loader
    workers and PROFILE_DIR; returns its bn_stats launches."""
    out, prof = root / "knob_out", root / "knob_profile"
    out.mkdir()
    cfg = _train_cfg(root, out, aois)
    cfg.DATALOADER.TRAINING_MULTIPLIER = KNOB_MULTIPLIER
    cfg.LOG_FREQ = KNOB_LOG_FREQ
    cfg.SAVE_CHECKPOINTS = []
    cfg.TRAINER.GRAD_ACCUM = 2
    cfg.DATALOADER.WORKER_TYPE = "process"
    cfg.TRAINER.PROFILE_DIR = str(prof)
    digests, arrivals = [], []
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        with _batch_digests(digests, arrivals):
            # ---- the run, with the kernels' launch counts around it ----
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            trainers.run_training(cfg, "supervised", device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            bn_launches, conf_launches, _ = _counts()
            # ------------------------------------------------------------
    finally:
        wandb_compat.finish()
    rows["confusion_counts"]["launches"] += conf_launches
    windows = [r for r in _records(out, cfg.NAME) if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    expect = 2 * 2 * bn_per_step(cfg.MODEL.TOPOLOGY)     # two micro-batches
    traces = sorted(prof.glob("*.json"))
    thread_loader = TrainLoader(MultimodalCDDataset(cfg, "training"),
                                cfg.TRAINER.BATCH_SIZE, shuffle=cfg.DATALOADER.SHUFFLE,
                                num_workers=cfg.DATALOADER.NUM_WORKER, seed=cfg.SEED)
    threads = [_digest(b) for b in thread_loader]
    log(f"run_training, GRAD_ACCUM 2, {cfg.DATALOADER.NUM_WORKER} process loader "
        f"workers, PROFILE_DIR: {steps} steps in {wall:.1f} s wall (with its "
        f"evals; the first batch came {arrivals[0] - t0:.2f} s after the start, "
        f"the pool's start-up), bn_stats launches {bn_launches} "
        f"({bn_launches / max(steps, 1):g} "
        f"per step, expected {expect}), confusion {conf_launches}; window losses "
        + ", ".join(f"{r['loss']:.6f}" for r in windows)
        + f"; trace {[f'{t.name} ({t.stat().st_size / 1e6:.1f} MB)' for t in traces]}; "
        f"{len(digests)} process batches == the thread loader's {len(threads)}: "
        f"{digests == threads}")
    if (steps != TRAIN_AOIS * KNOB_MULTIPLIER // cfg.TRAINER.BATCH_SIZE
            or bn_launches != expect * steps or conf_launches < 1
            or not all(np.isfinite(r["loss"]) for r in windows)
            or len(traces) != 1 or digests != threads):
        raise AssertionError("the knob run: wrong step or launch count, a "
                             "non-finite loss, no trace, or process batches "
                             "other than the thread loader's")
    return bn_launches


# -- phase 10 -----------------------------------------------------------------

def _rel(got: dict, want: dict, keys) -> float:
    """L2 norm of ``got - want`` over that of ``want``, over ``keys``."""
    diff = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
    norm = sum(float(want[k].double().square().sum()) for k in keys)
    return (diff / max(norm, 1e-300)) ** 0.5


def _bn_seen(kept: list) -> dict:
    """A worker's kept bn_stats launches in :func:`_keepers`' layout."""
    return {(tuple(k["shape"]), getattr(torch, k["dtype"]), k["same"]):
            (k["a"], k["b"], tuple(k["out"])) for k in kept}


def phase_parallel(card: dict, rows: dict, dev: torch.device, root: Path,
                   aois: list) -> tuple:
    """10a: two ranks over gloo on the one card, from phase 5's checkpoint;
    returns the world's bn_stats and rounding-rule confusion launches."""
    cfg = _train_cfg(root, root / "train_out", aois)
    ckpt = str(checkpoints.checkpoint_file(cfg, 1))
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"), cfg.TRAINER.BATCH_SIZE,
                         num_workers=0, seed=1)
    batch = next(iter(loader))
    # the workers' config: phase 5's, from the shipped file and overrides
    opts = _split_opts(aois, aois) + [
        "MODEL.TOPOLOGY", repr(list(cfg.MODEL.TOPOLOGY)),
        "TRAINER.PRECISION", str(cfg.TRAINER.get("PRECISION", "bf16")),
        "TRAINER.BATCH_SIZE", str(cfg.TRAINER.BATCH_SIZE)]
    common = dict(config="siamese", overrides=opts, paths={"DATASET": str(root)},
                  checkpoint=ckpt)
    step = dict(common, name="step", kind="step", regime="supervised",
                stack=torch.from_numpy(batch["stack"]),
                is_labeled=torch.from_numpy(batch["is_labeled"]))
    scenes = dict(common, name="eval", kind="measurer", split="test")
    out_dir = root / "parallel_out"
    t0 = time.perf_counter()
    rcs, outs = cluster_check.launch_cluster(
        {"device": dev.type, "backend": "gloo",
         "cases": [dict(step, keep_bn=True, timed_steps=PARALLEL_TIMED_STEPS),
                   scenes]},
        out_dir, world=PARALLEL_RANKS, timeout=300)
    world_s = time.perf_counter() - t0
    for rank, (out, err) in enumerate(outs):
        for line in out.splitlines():
            log(f"  [rank {rank}] {line}")
        if rcs[rank] != 0:
            log(err[-6000:])
    if rcs != [0] * PARALLEL_RANKS:
        raise AssertionError(f"the world of {PARALLEL_RANKS} ranks exited {rcs}")
    got = {name: [torch.load(out_dir / f"{name}.rank{r}.pt", weights_only=False)
                  for r in range(PARALLEL_RANKS)] for name in ("step", "eval")}

    # ---- the one-process references, on the same weights and inputs; their
    # kernel launches held against the plain versions (the world's counts
    # must equal the shares' exactly, so this holds the ranks' too) ----
    torch.cuda.synchronize()
    bn_seen, conf_calls, keep_bn, keep_conf = _keepers()
    with _watch(batchnorm, "bn_stats", keep_bn), \
            _watch(evaluation, "confusion_counts", keep_conf):
        one = cluster_check.run_case(dict(step, timed_steps=PARALLEL_TIMED_STEPS),
                                     dev)
        shares = [cluster_check.run_case(dict(scenes, shard=(r, PARALLEL_RANKS)),
                                         dev) for r in range(PARALLEL_RANKS)]
    _check_path_launches(rows, dev, bn_seen, conf_calls,
                         "one-process batch-8 step and shares")
    whole = cluster_check.run_case(scenes, dev)

    ranks = got["step"]
    per_step = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    for rank, res in enumerate(ranks):
        worst, err = _check_bn_launches(rows, dev, _bn_seen(res["bn_kept"]),
                                        f"two-rank (rank {rank})")
        log(f"  rank {rank}: bn_stats launches {res['launches']} (expected "
            f"{per_step}), its {len(res['bn_kept'])} signatures within the limit "
            f"(worst {worst:.4f}, max |kernel - ref| {err:.3e})")
        if res["launches"] != per_step:
            raise AssertionError(f"rank {rank} launched bn_stats {res['launches']} "
                                 f"times in one step, expected {per_step}")
    same = all(torch.equal(t, ranks[1][part][name]) for part in ("grads", "params",
                                                                 "buffers")
               for name, t in ranks[0][part].items())
    stats = [k for k in one["buffers"] if "running" in k]
    errors = {
        "loss": abs(ranks[0]["metrics"]["loss"] - one["metrics"]["loss"])
        / abs(one["metrics"]["loss"]),
        "grads": _rel(ranks[0]["grads"], one["grads"], one["grads"]),
        "buffers": _rel(ranks[0]["buffers"], one["buffers"], stats),
    }
    log(f"two ranks over gloo on one card, global batch {cfg.TRAINER.BATCH_SIZE} "
        f"({cfg.TRAINER.BATCH_SIZE // PARALLEL_RANKS} rows per rank), "
        f"{cfg.TRAINER.get('PRECISION', 'bf16')}, sync-BN, "
        f"from {Path(ckpt).name}: loss {ranks[0]['metrics']['loss']:.6f} (one "
        f"process {one['metrics']['loss']:.6f}); against the one-process step "
        + ", ".join(f"{k} {v:.3e} (limit {PARALLEL_LIMITS[k]:g})"
                    for k, v in errors.items())
        + f"; ranks' gradients, parameters and buffers bit-equal: {same}")
    if not same or any(errors[k] > PARALLEL_LIMITS[k] for k in errors):
        raise AssertionError(f"the two-rank step: {errors}, ranks equal {same}")
    for rank, res in enumerate(ranks):
        t = res["timing"]
        log(f"  rank {rank}: step {t['step_s'] * 1e3:.1f} ms (host clock, median "
            f"of {PARALLEL_TIMED_STEPS}: "
            + ", ".join(f"{x * 1e3:.1f}" for x in t["steps_s"])
            + f"); an instrumented step {t['instrumented_s'] * 1e3:.1f} ms, of it "
            f"{t['all_reduce_s'] * 1e3:.1f} ms in {t['all_reduce_calls']} "
            f"all-reduces of {t['all_reduce_bytes'] / 2**20:.1f} MiB "
            f"({t['all_reduce_s'] / t['instrumented_s'] * 100:.1f}%); peak "
            f"{t['peak_bytes'] / 2**30:.2f} GiB ({card['smi']})")
    t = one["timing"]
    log(f"  one process, batch {cfg.TRAINER.BATCH_SIZE}: step {t['step_s'] * 1e3:.1f} "
        f"ms (host clock, median of {PARALLEL_TIMED_STEPS}); peak "
        f"{t['peak_bytes'] / 2**30:.2f} GiB")

    evals = got["eval"]
    keys = ("TP", "TN", "FP", "FN")
    equal = all(torch.equal(evals[0][k], evals[1][k]) for k in keys)
    exact = all(torch.equal(evals[0][k], shares[0][k] + shares[1][k]) for k in keys)
    dist = {k: float((evals[0][k] - whole[k]).abs().max()) for k in keys}
    conf = sum(e["launches"] for e in evals)
    log(f"run_measurer over {len(aois)} scenes sharded over {PARALLEL_RANKS} ranks: "
        + ", ".join(f"{k} {int(evals[0][k][0])}" for k in keys)
        + f", F1 {evals[0]['f1']:.6f}; equal on both ranks {equal}; == the "
        f"one-process counts of the same shares {exact}; |counts - whole groups' "
        f"counts| " + ", ".join(f"{k} {v:g}" for k, v in dist.items())
        + f" (F1 {whole['f1']:.6f}); confusion launches per rank "
        f"{[e['launches'] for e in evals]}, one process per share "
        f"{[s['launches'] for s in shares]}")
    if not (equal and exact) or min(e["launches"] for e in evals) < 1:
        raise AssertionError("the sharded counts differ between the ranks or from "
                             "the one-process shares, or no rank launched the "
                             "confusion kernel")
    log(f"phase 10a: the world's launch {world_s:.1f} s wall")
    return sum(r["launches"] for r in ranks), conf


def phase_nccl(card: dict, rows: dict, dev: torch.device, root: Path,
               aois: list) -> tuple:
    """10b: ``trainers.run_training`` with ``MSCD_DISTRIBUTED=1`` in a world
    of one rank over NCCL; returns its bn_stats and confusion launches."""
    import socket

    out = root / "nccl_out"
    out.mkdir()
    cfg = _train_cfg(root, out, aois)
    cfg.DATALOADER.TRAINING_MULTIPLIER = NCCL_MULTIPLIER
    cfg.LOG_FREQ = NCCL_LOG_FREQ
    env = {"MSCD_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in [*env, "MASTER_PORT"]}
    os.environ.update(env)
    bn_seen, conf_calls, keep_bn, keep_conf = _keepers()
    wandb_compat.init(name=cfg.NAME, config=cfg, mode="jsonl", out_dir=out)
    try:
        for attempt in range(NCCL_PORT_TRIES):
            # a free port, released for the store to bind: another process may
            # take it in between, and then the init fails before the run
            # starts and the run is tried again on a new port
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                os.environ["MASTER_PORT"] = str(sock.getsockname()[1])
            try:
                with _watch(batchnorm, "bn_stats", keep_bn), \
                        _watch(evaluation, "confusion_counts", keep_conf):
                    # ---- the run, with the kernels' launch counts around it --
                    torch.cuda.synchronize()
                    _reset_counts()
                    t0 = time.perf_counter()
                    trainers.run_training(cfg, "supervised")  # this rank's card
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    bn_launches, conf_launches, _ = _counts()
                    # ----------------------------------------------------------
                break
            except torch.distributed.DistNetworkError as e:
                if (torch.distributed.is_initialized()
                        or attempt + 1 == NCCL_PORT_TRIES):
                    raise
                log(f"  the store's port {os.environ['MASTER_PORT']} was taken "
                    f"({str(e).splitlines()[0][:200]}); again on another")
        backend = torch.distributed.get_backend()
        world_size = torch.distributed.get_world_size()
    finally:
        wandb_compat.finish()
        parallel.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _check_path_launches(rows, dev, bn_seen, conf_calls, "NCCL")
    windows = [r for r in _records(out, cfg.NAME) if "train_time" in r]
    steps = windows[-1]["step"] if windows else 0
    expect = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    ckpts = sorted(p.name for p in (out / "networks").iterdir())
    log(f"run_training under MSCD_DISTRIBUTED=1, backend {backend}, world size "
        f"{world_size}: {steps} steps in {wall:.1f} s wall (with its evals), "
        f"bn_stats launches {bn_launches} ({bn_launches / max(steps, 1):g} per "
        f"step, expected {expect}), confusion {conf_launches}; window losses "
        + ", ".join(f"{r['loss']:.6f}" for r in windows) + f"; checkpoints {ckpts}")
    if (backend != "nccl" or world_size != 1
            or steps != TRAIN_AOIS * NCCL_MULTIPLIER // cfg.TRAINER.BATCH_SIZE
            or bn_launches != expect * steps or conf_launches < 1
            or len(windows) != steps // NCCL_LOG_FREQ
            or not all(np.isfinite(r["loss"]) for r in windows)
            or ckpts != [f"{cfg.NAME}_checkpoint1.pt"]):
        raise AssertionError("the NCCL run: wrong backend, world, step or launch "
                             "count, a non-finite loss, or not one checkpoint")
    return bn_launches, conf_launches


# -- phase 11 -----------------------------------------------------------------

def bn_world_times(card: dict) -> None:
    """``bn_stats`` per launch (:func:`bn_kernel_times`, CUDA graphs) at the
    BatchNorm shapes one rank feeds it in phase 10a (batch 4, full height)
    and in phase 11a (batch 8, half height), each beside its bound, and the
    sums over a step's 56 launches (every shape at its count per step)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for label, to_rank in (("10a: a rank's batch 4 of 8, 256^2",
                            lambda s: (4,) + s[1:]),
                           ("11a: batch 8, a rank's 128 of 256 rows",
                            lambda s: s[:2] + (s[2] // 2, s[3]))):
        log(f"bn_stats per launch at the BatchNorm shapes of phase {label} "
            f"(bf16; CUDA graphs of 20 launches, median of 5 rounds) on "
            f"{card['smi']}:")
        step_ms = step_bound = 0.0
        for shape, count in zip(BN_SHAPES, BN_STEP_COUNTS):
            shape = to_rank(shape)
            dy, x = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(2))
            t = bn_kernel_times(card, dy, x)
            step_ms += count * (t["back_ms"] + t["fwd_ms"])
            step_bound += count * (t["back_bound"] + t["fwd_bound"])
            log(f"  {shape} x{count}: backward {t['back_ms'] * 1e3:.2f} us (bound "
                f"{t['back_bound'] * 1e3:.2f} us by {t['back_by']}, "
                f"{t['back_bound'] / t['back_ms'] * 100:.1f}%), forward "
                f"{t['fwd_ms'] * 1e3:.2f} us (bound {t['fwd_bound'] * 1e3:.2f} us, "
                f"{t['fwd_bound'] / t['fwd_ms'] * 100:.1f}%)")
        log(f"  a step's {2 * sum(BN_STEP_COUNTS)} launches on one rank: "
            f"{step_ms * 1e3:.1f} us against a {step_bound * 1e3:.1f} us bound "
            f"({step_bound / step_ms * 100:.1f}%)")
    torch.cuda.empty_cache()


def _timing_line(t: dict) -> str:
    """A worker's timed step: the host-clock median, the collectives' share
    of an instrumented step (halo exchanges apart) and the peak memory."""
    coll = t["all_reduce_s"] + t["halo_s"]
    return (f"step {t['step_s'] * 1e3:.1f} ms (host clock, median of "
            f"{len(t['steps_s'])}: " + ", ".join(f"{x * 1e3:.1f}" for x in t["steps_s"])
            + f"); an instrumented step {t['instrumented_s'] * 1e3:.1f} ms, of it "
            f"{coll * 1e3:.1f} ms ({coll / t['instrumented_s'] * 100:.1f}%) in "
            f"collectives: {t['halo_calls']} halo exchanges, "
            f"{t['halo_s'] * 1e3:.1f} ms ({t['halo_s'] / t['instrumented_s'] * 100:.1f}"
            f"%), {t['halo_bytes'] / 2**20:.1f} MiB; {t['all_reduce_calls']} other "
            f"all-reduces, {t['all_reduce_s'] * 1e3:.1f} ms "
            f"({t['all_reduce_s'] / t['instrumented_s'] * 100:.1f}%), "
            f"{t['all_reduce_bytes'] / 2**20:.1f} MiB; peak "
            f"{t['peak_bytes'] / 2**30:.2f} GiB")


def phase_space(card: dict, rows: dict, dev: torch.device, root: Path,
                aois: list) -> tuple:
    """11: ``TRAINER.SPATIAL_SHARDS 2`` on a world of two ranks over gloo on
    the one card (data 1 x space 2), from phase 5's checkpoint: a. one
    full-width step at batch 8 on 256^2 crops, each rank 128 rows; b. one
    staged step at 1024^2 crops; c. ``sharded_scene_probabilities`` and
    ``run_measurer`` on the grid; then the bn_stats times at the world
    paths' shapes. Returns the grid's bn_stats and rounding-rule confusion
    launches."""
    cfg = _train_cfg(root, root / "train_out", aois)
    ckpt = str(checkpoints.checkpoint_file(cfg, 1))
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"), cfg.TRAINER.BATCH_SIZE,
                         num_workers=0, seed=1)
    batch = next(iter(loader))
    opts = _split_opts(aois, aois) + [
        "MODEL.TOPOLOGY", repr(list(cfg.MODEL.TOPOLOGY)),
        "TRAINER.PRECISION", str(cfg.TRAINER.get("PRECISION", "bf16")),
        "TRAINER.BATCH_SIZE", str(cfg.TRAINER.BATCH_SIZE)]
    space_opts = opts + ["TRAINER.SPATIAL_SHARDS", str(SPACE_RANKS)]
    common = dict(config="siamese", paths={"DATASET": str(root)}, checkpoint=ckpt)
    step = dict(common, name="step", kind="step", regime="supervised",
                overrides=space_opts,
                stack=torch.from_numpy(batch["stack"]),
                is_labeled=torch.from_numpy(batch["is_labeled"]))
    big = dict(common, name="big", kind="step", regime="supervised",
               overrides=space_opts + ["AUGMENTATION.CROP_SIZE", str(SPACE_BIG_SIDE)],
               synthetic=(cfg.TRAINER.BATCH_SIZE, SPACE_BIG_SIDE, 0))
    fp32 = opts + ["TRAINER.PRECISION", "fp32"]
    probs = [dict(common, name="probs_fp32", kind="scene_probs", overrides=fp32,
                  items=[0, 1], tf32=False),
             dict(common, name="probs_bf16", kind="scene_probs", overrides=opts,
                  items=[0, 1])]
    scenes = dict(common, name="eval", kind="measurer", split="test",
                  overrides=space_opts)
    out_dir = root / "space_out"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()    # the two ranks share the card with this process
    t0 = time.perf_counter()
    rcs, outs = cluster_check.launch_cluster(
        {"device": dev.type, "backend": "gloo",
         "cases": [dict(step, keep_bn=True, timed_steps=PARALLEL_TIMED_STEPS),
                   dict(big, timed_steps=1), *probs,
                   dict(scenes, keep_conf=True)]},
        out_dir, world=SPACE_RANKS, timeout=300)
    world_s = time.perf_counter() - t0
    for rank, (out, err) in enumerate(outs):
        for line in out.splitlines():
            log(f"  [rank {rank}] {line}")
        if rcs[rank] != 0:
            log(err[-6000:])
    if rcs != [0] * SPACE_RANKS:
        raise AssertionError(f"the grid of {SPACE_RANKS} ranks exited {rcs}")
    got = {name: [torch.load(out_dir / f"{name}.rank{r}.pt", weights_only=False)
                  for r in range(SPACE_RANKS)]
           for name in ("step", "big", "probs_fp32", "probs_bf16", "eval")}

    # ---- 11a: the 256^2 step against one process on the same weights ----
    ranks = got["step"]
    per_step = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    # a 3x3 conv before each BatchNorm, each one exchange forward and one
    # back, but the stem's first on each date, whose input (the data) takes
    # no gradient: its backward exchanges nothing
    halos = per_step - 2
    side = cfg.AUGMENTATION.CROP_SIZE
    rank_shapes = {(b, c, h // SPACE_RANKS, w) for b, c, h, w in BN_SHAPES}
    for rank, res in enumerate(ranks):
        shapes = sorted({tuple(k["shape"]) for k in res["bn_kept"]})
        worst, err = _check_bn_launches(rows, dev, _bn_seen(res["bn_kept"]),
                                        f"height-sharded (rank {rank})")
        log(f"  rank {rank}: bn_stats launches {res['launches']} (expected "
            f"{per_step}) at {shapes}, the first of each signature within the "
            f"limit (worst {worst:.4f}, max |kernel - ref| {err:.3e})")
        if res["launches"] != per_step:
            raise AssertionError(f"rank {rank} launched bn_stats {res['launches']} "
                                 f"times in one step, expected {per_step}")
        if set(shapes) != rank_shapes:
            raise AssertionError(f"rank {rank}'s BatchNorm inputs {shapes} are not "
                                 f"the step's at 1/{SPACE_RANKS} of the height")
    torch.cuda.synchronize()
    bn_seen, _, keep_bn, _ = _keepers()
    with _watch(batchnorm, "bn_stats", keep_bn):
        one = cluster_check.run_case(dict(step, timed_steps=PARALLEL_TIMED_STEPS),
                                     dev)
    _check_bn_launches(rows, dev, bn_seen, "one-process batch-8 step")
    same = all(torch.equal(t, ranks[1][part][name]) for part in ("grads", "params",
                                                                 "buffers")
               for name, t in ranks[0][part].items())
    stats = [k for k in one["buffers"] if "running" in k]
    errors = {
        "loss": abs(ranks[0]["metrics"]["loss"] - one["metrics"]["loss"])
        / abs(one["metrics"]["loss"]),
        "grads": _rel(ranks[0]["grads"], one["grads"], one["grads"]),
        "buffers": _rel(ranks[0]["buffers"], one["buffers"], stats),
    }
    log(f"SPATIAL_SHARDS {SPACE_RANKS}: two ranks over gloo on one card (data 1 x "
        f"space {SPACE_RANKS}), global batch {cfg.TRAINER.BATCH_SIZE} of "
        f"{side}^2 crops ({side // SPACE_RANKS} rows per rank), "
        f"{cfg.TRAINER.get('PRECISION', 'bf16')}, sync-BN, from {Path(ckpt).name}: "
        f"loss {ranks[0]['metrics']['loss']:.6f} (one process "
        f"{one['metrics']['loss']:.6f}); against the one-process step "
        + ", ".join(f"{k} {v:.3e} (limit {PARALLEL_LIMITS[k]:g})"
                    for k, v in errors.items())
        + f"; ranks' gradients, parameters and buffers bit-equal: {same}")
    if not same or any(errors[k] > PARALLEL_LIMITS[k] for k in errors):
        raise AssertionError(f"the height-sharded step: {errors}, ranks equal {same}")
    for rank, res in enumerate(ranks):
        t = res["timing"]
        log(f"  rank {rank}: {_timing_line(t)} ({card['smi']}); halo exchanges "
            f"predicted {halos} (2 per 3x3 conv, forward and backward, but for "
            f"the backward of the stem's first conv on each date)")
        if t["halo_calls"] != halos:
            raise AssertionError(f"rank {rank} made {t['halo_calls']} halo exchanges "
                                 f"in a step, predicted {halos}")
    t = one["timing"]
    log(f"  one process, batch {cfg.TRAINER.BATCH_SIZE} at {side}^2: step "
        f"{t['step_s'] * 1e3:.1f} ms (host clock, median of "
        f"{PARALLEL_TIMED_STEPS}); peak {t['peak_bytes'] / 2**30:.2f} GiB")
    del one, bn_seen

    # ---- 11b: the staged 1024^2 step, peak memory per rank ----
    torch.cuda.empty_cache()
    one = cluster_check.run_case(dict(big, timed_steps=1), dev)
    torch.cuda.empty_cache()
    for rank, res in enumerate(got["big"]):
        log(f"  rank {rank}, staged batch {cfg.TRAINER.BATCH_SIZE} of "
            f"{SPACE_BIG_SIDE}^2 ({SPACE_BIG_SIDE // SPACE_RANKS} rows): "
            f"{_timing_line(res['timing'])}")
    t = one["timing"]
    big_loss = abs(got["big"][0]["metrics"]["loss"] - one["metrics"]["loss"]) \
        / abs(one["metrics"]["loss"])
    log(f"  one process, staged batch {cfg.TRAINER.BATCH_SIZE} of {SPACE_BIG_SIDE}^2:"
        f" step {t['step_s'] * 1e3:.1f} ms (host clock); peak "
        f"{t['peak_bytes'] / 2**30:.2f} GiB; the grid's peak per rank "
        + ", ".join(f"{r['timing']['peak_bytes'] / 2**30:.2f}" for r in got["big"])
        + f" GiB; loss {got['big'][0]['metrics']['loss']:.6f} against "
        f"{one['metrics']['loss']:.6f} (relative {big_loss:.3e}, limit "
        f"{PARALLEL_LIMITS['loss']:g})")
    if big_loss > PARALLEL_LIMITS["loss"] or got["big"][0]["metrics"] != \
            got["big"][1]["metrics"]:
        raise AssertionError(f"the 1024^2 grid step's loss: {big_loss}, or the "
                             f"ranks' metrics differ")
    del one

    # ---- 11c: sharded scene probabilities and the grid's counts ----
    for name in ("probs_fp32", "probs_bf16"):
        case = next(c for c in probs if c["name"] == name)
        ccfg = cluster_check.case_cfg(case)
        model, _ = cluster_check._model(case, ccfg, dev)
        ds = cluster_check._eval_dataset(case, ccfg)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        if not case.get("tf32", True):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            torch.cuda.reset_peak_memory_stats()
            single = [evaluation.scene_probabilities(model, ds[i], device=dev)
                      for i in case["items"]]
            one_peak = torch.cuda.max_memory_allocated()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        diff = max(float(np.abs(r["probs"][k].numpy() - s).max())
                   for r in got[name] for k, s in enumerate(single))
        equal = all(torch.equal(a, b) for a, b in zip(got[name][0]["probs"],
                                                      got[name][1]["probs"]))
        log(f"sharded_scene_probabilities, {name[6:]}"
            f"{' (TF32 off)' if not case.get('tf32', True) else ''}, scenes "
            f"{[tuple(p.shape) for p in got[name][0]['probs']]} over {SPACE_RANKS} "
            f"ranks: max |sharded - scene_probabilities| {diff:.3e}; equal on the "
            f"ranks {equal}; peak per rank "
            + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in got[name])
            + f" GiB, one process {one_peak / 2**30:.2f} GiB")
        if not equal or (name == "probs_fp32" and diff >= SPACE_FP32_LIMIT):
            raise AssertionError(f"{name}: max diff {diff} (fp32 limit "
                                 f"{SPACE_FP32_LIMIT}), ranks equal {equal}")
        del model
    torch.cuda.empty_cache()
    evals = got["eval"]
    _check_conf_launches(rows, dev, [(tuple(k["args"]), k["out"]) for e in evals
                                     for k in e["conf_kept"]], "grid run_measurer")
    whole = cluster_check.run_case(scenes, dev)
    keys = ("TP", "TN", "FP", "FN")
    equal = all(torch.equal(evals[0][k], evals[1][k]) for k in keys)
    dist = {k: float((evals[0][k] - whole[k]).abs().max()) for k in keys}
    conf = sum(e["launches"] for e in evals)
    log(f"run_measurer over {len(aois)} scenes on the grid (heights over "
        f"{SPACE_RANKS} space ranks): " + ", ".join(f"{k} {int(evals[0][k][0])}"
                                                    for k in keys)
        + f", F1 {evals[0]['f1']:.6f}; equal on both ranks {equal}; |counts - "
        f"one-process counts| " + ", ".join(f"{k} {v:g}" for k, v in dist.items())
        + f" (F1 {whole['f1']:.6f}); confusion launches per rank "
        f"{[e['launches'] for e in evals]}, every one held against plain")
    if not equal or min(e["launches"] for e in evals) < 1:
        raise AssertionError("the grid's counts differ between the ranks, or a "
                             "rank launched no confusion kernel")
    bn_world_times(card)
    log(f"phase 11: the world's launch {world_s:.1f} s wall")
    return sum(r["launches"] for r in ranks), conf


# -- phase 12 -----------------------------------------------------------------

def _windows(cfg, dev: torch.device, n: int, k: int = STEPS_K) -> list:
    """The first ``n`` super-batches ``(k, B, ...)`` of ``cfg``'s training
    loader on the card, as the trainer stages them (``group_batches``
    through ``prefetch_to_device``)."""
    loader = TrainLoader(MultimodalCDDataset(cfg, "training"), cfg.TRAINER.BATCH_SIZE,
                         shuffle=True, num_workers=0, seed=1)
    stream = prefetch_to_device(group_batches(loader, k), dev)
    try:
        return [next(stream) for _ in range(n)]
    finally:
        stream.close()


def _window_diffs(got: dict, want: dict) -> dict:
    """Each window metric's |got - want| / |want| (0 where both are 0)."""
    out = {}
    for key, w in want.items():
        g, w = float(got[key]), float(w)
        out[key] = abs(g - w) / abs(w) if w else (0.0 if g == w else float("inf"))
    return out


def _graph_against_eager(rows: dict, dev: torch.device, cfg, regime: str,
                         windows: list, label: str) -> dict:
    """From one seeded state: ``windows`` through ``make_scanned_train_step``
    on the card (a CUDA graph; the first window eager, then captured, every
    later one replayed) and the same steps eagerly (the k = 1 step), their
    bn_stats launches held against the plain version
    (:func:`_watch`). Every replayed window's metrics, and every parameter
    and running statistic after the last, held against the eager steps'
    (``GRAPH_LIMITS``); the last window is replayed under the profiler,
    which counts its bn_stats kernels. Returns the models, the window, the
    eager step and the numbers."""
    k = windows[0]["stack"].shape[0]
    init = create_network(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg.SEED))
    state = {key: v.clone() for key, v in init.state_dict().items()}
    model = init
    window = train_lib.make_scanned_train_step(
        model, train_lib.make_optimizer(model, cfg), cfg, regime)
    if window.mode != "graph":
        raise AssertionError(f"{label}: the window runs {window.mode}, not as a "
                             f"CUDA graph, on the card in a world of one")
    torch.cuda.synchronize()
    _reset_counts()
    got = [window(windows[0]["stack"], windows[0]["is_labeled"], 0)]
    torch.cuda.synchronize()
    first_launches = bn_stats.bn_stats.launches
    for j, w in enumerate(windows[1:-1], start=1):
        got.append(window(w["stack"], w["is_labeled"], j * k))
    _reset_counts()
    traced = profile_breakdown(
        f"{label}: one replayed window of {k} steps",
        lambda: got.append(window(windows[-1]["stack"], windows[-1]["is_labeled"],
                                  (len(windows) - 1) * k)),
        match="bn_stats_partial")
    replay_counted = bn_stats.bn_stats.launches

    eager_model = create_network(cfg, device=dev)
    eager_model.load_state_dict(state)
    step = train_lib.make_train_step(eager_model,
                                     train_lib.make_optimizer(eager_model, cfg), cfg,
                                     regime)
    bn_seen, _, keep_bn, _ = _keepers()
    eager = []
    with _watch(batchnorm, "bn_stats", keep_bn):
        # ---- the eager steps, with the launch count around them ----
        torch.cuda.synchronize()
        _reset_counts()
        for j, w in enumerate(windows):
            metrics = [step(w["stack"][i], w["is_labeled"][i], j * k + i)
                       for i in range(k)]
            eager.append(train_lib._reduce_window_metrics(metrics))
        torch.cuda.synchronize()
        eager_launches = bn_stats.bn_stats.launches
        # ------------------------------------------------------------
    _check_bn_launches(rows, dev, bn_seen, label)
    diffs = {key: max(_window_diffs(g, e)[key] for g, e in zip(got[1:], eager[1:]))
             for key in eager[0]}
    ours, theirs = model.state_dict(), eager_model.state_dict()
    buffers = [key for key in ours if key.rsplit(".", 1)[-1] in ("running_mean",
                                                                "running_var")]
    params = [name for name, _ in model.named_parameters()]
    bitwise = all(torch.equal(ours[key], theirs[key]) for key in ours) and all(
        float(g[key]) == float(e[key]) for g, e in zip(got, eager) for key in e)
    out = {
        "metrics": max(diffs.values()),
        "buffers": _rel(ours, theirs, buffers),
        "params": max(float((ours[n] - theirs[n]).abs().max()) for n in params)
        / max(float(theirs[n].abs().max()) for n in params),
    }
    per_step = eager_launches // (len(windows) * k)
    replayed = traced["matched"] if traced else None
    log(f"  {label}: {len(windows)} windows of {k} (the first eager, then captured "
        f"in {window.graph.capture_s:.2f} s) against {len(windows) * k} eager "
        f"steps (k = 1): largest window-metric "
        f"relative difference {out['metrics']:.3g} ({', '.join(f'{key} {v:.3g}' for key, v in diffs.items())}), "
        f"running statistics {out['buffers']:.3g}, parameters {out['params']:.3g} "
        f"of the largest entry (limits {GRAPH_LIMITS}); bit-equal {bitwise}; "
        f"bn_stats launches: first window {first_launches} (eager {k} x "
        f"{per_step} + the capture's {first_launches - k * per_step}), the "
        f"replayed window's {replayed} bn_stats kernels in the trace (expected "
        f"{k * per_step}; the wrapper counted {replay_counted}), eager steps "
        f"{eager_launches}")
    if any(out[key] > GRAPH_LIMITS[key] for key in out):
        raise AssertionError(f"{label}: the graph's window is off the eager steps: "
                             f"{out}")
    if (replayed != k * per_step or replay_counted != 0
            or first_launches != (k + 1) * per_step):
        raise AssertionError(f"{label}: bn_stats launches of the graph's windows: "
                             f"first {first_launches}, replayed kernels {replayed}, "
                             f"expected {k * per_step} a window")
    return {"model": model, "window": window, "step": step, "got": got,
            "eager": eager, "launches": first_launches + replayed + eager_launches,
            "per_step": per_step}


def _steps_timing(card: dict, windows: list, graphed: dict) -> None:
    """12a's times: the k = 1 step and the replayed step (each on its model
    of :func:`_graph_against_eager`), each over ``STEPS_TIMED_WINDOWS``
    windows of k steps by CUDA events and by host clock (median), the
    device busy share of one window of each, patches/s, the capture time
    and the peak memory."""
    k, batch = windows[0]["stack"].shape[:2]
    step = graphed["step"]
    runs = {
        "eager (k = 1)": lambda w, g: [step(w["stack"][i], w["is_labeled"][i], g + i)
                                       for i in range(k)],
        "graph replay": lambda w, g: graphed["window"](w["stack"], w["is_labeled"], g),
    }
    for label, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev, host = [], []
        for r in range(STEPS_TIMED_WINDOWS):
            w = windows[r % len(windows)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run(w, 100 + r * k)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 / k)
            ev.append(start.elapsed_time(end) / k)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_breakdown(f"12a {label}: one window of {k} steps",
                                 lambda: run(windows[0], 200), top=3)
        busy = ("not measured" if prof is None else
                f"{prof['busy_us'] / prof['wall_us'] * 100:.1f}% busy")
        ms_ev, ms_host = statistics.median(ev), statistics.median(host)
        log(f"  12a {label}: {ms_ev:.2f} ms per step by CUDA events, {ms_host:.2f} "
            f"ms by host clock (median of {STEPS_TIMED_WINDOWS} windows of {k}), "
            f"{batch / ms_host * 1e3:.2f} patches/s by host clock, device {busy} "
            f"over a window, peak device memory {peak / 2**30:.2f} GiB allocated "
            f"outside a graph's pool (12c has the runs' reserved peaks) "
            f"({card['smi']})")
    log(f"  12a capture of the step: {graphed['window'].graph.capture_s:.3f} s host "
        f"({card['smi']})")


def _window_means(entries: list) -> dict:
    """A semi-supervised log window's payload from window or step metrics
    (``trainers._window_summary``, as the trainer reduces them)."""
    sets = {key: [e[key] for e in entries] for key in trainers._REGIMES[
        "semisupervised"]["keys"]}
    counts = [tuple(e[key] for key in trainers._LABEL_KEYS if key in e)
              for e in entries]
    return trainers._window_summary(sets, counts, True)


def phase_steps(card: dict, rows: dict, dev: torch.device, root: Path,
                aois: list) -> tuple:
    """Phase 12: multi-step execution on the card. Returns (bn_stats,
    confusion) launches of its paths."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bn_total, conf_total = 0, 0
    try:
        # 12a: the main path at full width
        t0 = time.perf_counter()
        cfg = _train_cfg(root, root / "unused", aois)
        windows = _windows(cfg, dev, 2)
        graphed = _graph_against_eager(rows, dev, cfg, "supervised", windows,
                                       "12a siameseunet")
        bn_total += graphed["launches"]
        if graphed["per_step"] != 2 * bn_per_step(cfg.MODEL.TOPOLOGY):
            raise AssertionError(f"12a: {graphed['per_step']} bn_stats launches a step")
        _steps_timing(card, windows, graphed)
        del graphed
        knob = cfg.clone()
        knob.TRAINER.GRAD_ACCUM, knob.MODEL.REMAT = 2, True
        bn_total += _graph_against_eager(rows, dev, knob, "supervised", windows,
                                         "12a GRAD_ACCUM 2 + REMAT")["launches"]
        del windows
        torch.cuda.empty_cache()
        t1 = time.perf_counter()

        # 12b: the traps that differ by regime
        diff = _train_cfg(root, root / "unused", aois)
        diff.MODEL.TYPE = "siamunet_diff"
        out = _graph_against_eager(rows, dev, diff, "supervised",
                                   _windows(diff, dev, 2), "12b siamunet_diff")
        bn_total += out["launches"]
        del out
        semi = _semisup_cfg(root, root / "unused", aois, "siamese_mmcr_alpha0500")
        windows = _windows(semi, dev, 2)
        ds = MultimodalCDDataset(semi, "training")
        size = semi.TRAINER.BATCH_SIZE
        parts = [_partition_batch(ds, True, size, dev),
                 _partition_batch(ds, False, size, dev)]
        last = windows[-1]     # one all-labeled and one all-unlabeled batch
        for key in ("stack", "is_labeled"):
            last[key] = torch.cat([torch.stack([p[key].to(last[key].dtype)
                                                for p in parts]), last[key][2:]])
        out = _graph_against_eager(rows, dev, semi, "semisupervised", windows,
                                   "12b whatevernet semi-supervised")
        bn_total += out["launches"]
        weights = [(float(g["n_lab_steps"]), float(g["n_notlab_steps"]))
                   for g in out["got"]]
        eager_weights = [(float(e["n_lab_steps"]), float(e["n_notlab_steps"]))
                         for e in out["eager"]]
        means = _window_means(out["got"][1:])
        eager_means = _window_means(out["eager"][1:])
        mean_diff = max(_window_diffs(means, eager_means).values())
        log(f"  12b whatevernet: presence weights (n_lab_steps, n_notlab_steps) per "
            f"window {weights} (eager {eager_weights}); the replayed window's means "
            f"{ {key: round(v, 6) for key, v in means.items()} }, largest relative "
            f"difference from the eager steps' {mean_diff:.3g}")
        if (weights != eager_weights or max(weights[-1]) >= STEPS_K
                or mean_diff > GRAPH_LIMITS["metrics"]):
            raise AssertionError("12b whatevernet: presence weights or window means "
                                 "off the eager steps'")
        del out, windows, parts, last
        torch.cuda.empty_cache()
        t2 = time.perf_counter()

        # 12c: run_training through the trainer, k = 4 against k = 1
        ms = trainers.measure_dispatch_latency_ms(device=dev)
        runs = {}
        for k in (STEPS_K, 1):
            run_out = root / f"steps_out_k{k}"
            run_out.mkdir()
            run_cfg = _train_cfg(root, run_out, aois)
            run_cfg.DATALOADER.TRAINING_MULTIPLIER = STEPS_MULTIPLIER
            run_cfg.LOG_FREQ = STEPS_LOG_FREQ
            run_cfg.SAVE_CHECKPOINTS = []
            run_cfg.TRAINER.STEPS_PER_EXECUTION = k
            wandb_compat.init(name=run_cfg.NAME, config=run_cfg, mode="jsonl",
                              out_dir=run_out)
            try:
                printed = io.StringIO()
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                # ---- the run, with the kernels' launch counts around it ----
                torch.cuda.synchronize()
                _reset_counts()
                w0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    trainers.run_training(run_cfg, "supervised", device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
                bn_launches, conf_launches, _ = _counts()
                # ------------------------------------------------------------
            finally:
                wandb_compat.finish()
            sys.stdout.write(printed.getvalue())
            windows_logged = [r for r in _records(run_out, run_cfg.NAME)
                              if "train_time" in r]
            runs[k] = (windows_logged, printed.getvalue(), wall, bn_launches)
            log(f"  12c k = {k}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                f"GiB allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved "
                f"(a graph's pool included) ({card['smi']})")
            bn_total, conf_total = bn_total + bn_launches, conf_total + conf_launches
        steps_per_epoch = TRAIN_AOIS * STEPS_MULTIPLIER // cfg.TRAINER.BATCH_SIZE
        k_auto = trainers.auto_steps_per_execution(STEPS_LOG_FREQ, steps_per_epoch, ms)
        (w_k, printed_k, wall_k, bn_k), (w_1, _, wall_1, _) = runs[STEPS_K], runs[1]
        rel = (max(_window_diffs({"loss": a["loss"]}, {"loss": b["loss"]})["loss"]
                   for a, b in zip(w_k, w_1)) if w_k and len(w_k) == len(w_1)
               else float("inf"))
        per_step = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
        log(f"  12c run_training STEPS_PER_EXECUTION {STEPS_K}: windows "
            f"{[(r['step'], round(r['loss'], 7)) for r in w_k]} in {wall_k:.1f} s "
            f"wall (evals included), k = 1: {[(r['step'], round(r['loss'], 7)) for r in w_1]} "
            f"in {wall_1:.1f} s; largest relative loss difference {rel:.3g} (limit "
            f"{GRAPH_LIMITS['metrics']}); train_time k = {STEPS_K} "
            f"{w_k[0]['train_time'] if w_k else float('nan'):.3f} s, k = 1 "
            f"{w_1[0]['train_time'] if w_1 else float('nan'):.3f} s; bn_stats launches "
            f"the wrapper counted {bn_k} (expected {(STEPS_K + 1) * per_step}: the "
            f"first window's eager steps and the capture); auto's dispatch probe "
            f"{ms:.4f} ms -> k = {k_auto} at LOG_FREQ {STEPS_LOG_FREQ}, "
            f"{steps_per_epoch} steps/epoch ({card['smi']})")
        if (rel > GRAPH_LIMITS["metrics"] or [r["step"] for r in w_k] != [STEPS_LOG_FREQ]
                or f"STEPS_PER_EXECUTION={STEPS_K}: {STEPS_K} steps per window, one "
                   f"CUDA graph" not in printed_k
                or bn_k != (STEPS_K + 1) * per_step):
            raise AssertionError("12c: the k = 4 run's logged window is off the k = 1 "
                                 "run's, or it did not run as a CUDA graph")
        log(f"phase 12: {time.perf_counter() - t0:.1f} s wall (12a {t1 - t0:.1f} s, "
            f"12b {t2 - t1:.1f} s, 12c {time.perf_counter() - t2:.1f} s)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return bn_total, conf_total


# -- phase 13 -----------------------------------------------------------------

def _convergence_argv(root: Path) -> list:
    return CONVERGENCE_ARGS + ["--data-dir", str(root / "conv_ds"),
                               "--out-dir", str(root / "conv_out")]


def _lifecycle_argv(root: Path) -> list:
    return LIFECYCLE_ARGS + ["--data-dir", str(root / "life_ds"),
                             "--out-dir", str(root / "life_out")]


def _join(process) -> None:
    """Wait for a writer process; raise if it failed."""
    process.join()
    if process.exitcode != 0:
        raise RuntimeError(f"{process.name} failed: exit code {process.exitcode}")


def make_datasets(root: str) -> None:
    """Phase 13's datasets, written by a process of their own while phase 4's
    split is written: 13a's hard fixture and 13b's lifecycle split, each
    through its tool's ``ensure_dataset``."""
    root = Path(root)

    def threaded(generate):
        def run(*args, **kw):
            with _threaded_tif_writes():
                return generate(*args, **kw)
        return run

    # the tools import the generators when they write, and rename or mark
    # the tree after the generator returns, every file written by then
    with mock.patch.object(synthetic, "generate_fixture_dataset",
                           threaded(synthetic.generate_fixture_dataset)), \
            mock.patch.object(synthetic, "generate_hard_dataset",
                              threaded(synthetic.generate_hard_dataset)):
        args = convergence_run.parse_args(_convergence_argv(root))
        convergence_run.ensure_dataset(convergence_run.paths(args)[0], args.scene,
                                       hard=args.hard, signal=args.signal,
                                       seed=args.seed)
        args = lifecycle_run.parser().parse_args(_lifecycle_argv(root))
        lifecycle_run.ensure_dataset(Path(args.data_dir), args.scene, hard=args.hard)


def phase_convergence(card: dict, rows: dict, dev: torch.device, root: Path) -> tuple:
    """13a: ``convergence_run``'s training command for the hard fixture,
    through ``train_supervised.main`` in this process, its kernel launches
    counted and held against the plain versions; the trajectory against
    ``CONVERGENCE_BAND``. Returns (bn_stats, confusion) launches."""
    args = convergence_run.parse_args(_convergence_argv(root))
    module, argv, log_path = convergence_run.prepare(args)
    if module != train_supervised.__name__:
        raise AssertionError(f"convergence_run runs {module}")
    log(f"13a convergence: python -m {module} {' '.join(argv)}"[:300])
    bn_seen, conf_calls, keep_bn, keep_conf = _keepers()
    printed = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _watch(batchnorm, "bn_stats", keep_bn), \
            _watch(evaluation, "confusion_counts", keep_conf):
        # ---- the convergence run, with the kernels' launch counts around it ----
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                mock.patch.dict(os.environ, wandb_compat.SINK_ENV):
            train_supervised.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bn_launches, conf_launches, _ = _counts()
        # ----------------------------------------------------------------------
    for line in printed.getvalue().splitlines()[:8]:
        log(f"  [train_supervised] {line}")
    records = [r for r in lifecycle_run.read_jsonl(log_path) if "_event" not in r]
    cfg = experiment_manager.setup_cfg(
        parsers.training_argument_parser().parse_known_args(argv)[0])
    batch = cfg.TRAINER.BATCH_SIZE
    steps_per_epoch = len(convergence_run.TRAIN) * args.multiplier // batch
    steps = steps_per_epoch * args.epochs
    expect = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    log(f"  {steps} steps in {wall:.1f} s wall (evaluations included); launches "
        f"bn_stats {bn_launches} (expected {expect} a step), confusion "
        f"{conf_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if bn_launches != expect * steps or conf_launches < 1:
        raise AssertionError("13a: the run's bn_stats or confusion launches are off")
    _check_path_launches(rows, dev, bn_seen, conf_calls, path="13a convergence")
    del bn_seen, conf_calls

    convergence_run.print_trajectory(log_path)
    sys.stdout.flush()
    val, test = {}, {}
    for r in records:
        if "validation F1" in r:
            val[r["step"]] = r["validation F1"]
        if "test F1" in r:
            test[r["step"]] = r["test F1"]
    last4 = [val[s] for s in sorted(val)[-4:]]
    got = {"last4_validation": statistics.mean(last4), "test": test.get(steps, -1.0),
           "rise": val.get(steps, -1.0) - val.get(args.log_freq, 2.0)}
    rates = lifecycle_run.window_rates(records, steps_per_epoch, batch)
    log(f"13a hard-fixture convergence ({cfg.MODEL.TYPE} {list(cfg.MODEL.TOPOLOGY)}, "
        f"{cfg.TRAINER.get('PRECISION', 'bf16')}, batch {batch}, "
        f"{cfg.AUGMENTATION.CROP_SIZE}^2 crops, {args.scene}^2 scenes, signal "
        f"{args.signal}): at step {steps} "
        f"validation F1 {val.get(steps, float('nan')):.4f}, test F1 "
        f"{got['test']:.4f}; validation F1 at steps {sorted(val)[-4:]} {last4}, "
        f"mean {got['last4_validation']:.4f}; from step {args.log_freq} "
        f"{val.get(args.log_freq, float('nan')):.4f} (rise {got['rise']:.4f}); "
        f"{wall:.1f} s wall, median train {statistics.median(rates):.2f} patches/s "
        f"over {len(rates)} windows (host clock, {card['smi']})")
    missed = {k: v for k, v in got.items() if not v >= CONVERGENCE_BAND[k]}
    log(f"  the band {CONVERGENCE_BAND}: {'met' if not missed else f'MISSED {missed}'}")
    if missed:
        raise AssertionError(f"13a: the convergence run missed the band: {missed}")
    return bn_launches, conf_launches


def watch_child(watch_dir: Path, module: str, argv: list) -> None:
    """Run the port's CLI ``module`` with ``argv`` in this process (13b's
    lifecycle_run starts it), its kernel launches watched: after every call
    the wrappers' launch counts are copied into ``counts.bin``, a file
    mapped into memory (what is written there survives a SIGKILL), and the
    inputs and outputs of bn_stats' first launch of each (shape, dtype, a is
    b) and of every confusion launch are saved for the parent to hold
    against the plain versions."""
    watch_dir.mkdir(parents=True, exist_ok=True)
    counts = np.memmap(watch_dir / "counts.bin", dtype=np.int64, mode="w+", shape=(2,))
    seen, saved = set(), [0]

    def save(kind, obj):
        path = watch_dir / f"{kind}_{saved[0]}.pt"
        saved[0] += 1
        torch.save(obj, path.with_suffix(".part"))
        path.with_suffix(".part").replace(path)

    def keep_bn(args, out):
        counts[0] = bn_stats.bn_stats.launches
        a, b = args
        key = (tuple(a.shape), a.dtype, a is b)
        if key not in seen:
            seen.add(key)
            save("bn", (key, a.detach().cpu(), None if a is b else b.detach().cpu(),
                        tuple(o.detach().cpu() for o in out)))

    def keep_conf(args, out):
        counts[1] = confusion.confusion_counts.launches
        save("conf", (tuple(t.detach().cpu() for t in args), out.cpu()))

    with _watch(batchnorm, "bn_stats", keep_bn), \
            _watch(evaluation, "confusion_counts", keep_conf):
        importlib.import_module(f"multimodal_siamese_cd_tpu_torch.{module}").main(argv)


def _watched(watch_dir: Path) -> tuple:
    """A child's launch counts and its kept launches, as :func:`_keepers`
    keeps them: (bn_stats launches, confusion launches, bn_seen,
    conf_calls)."""
    bn_launches, conf_launches = np.fromfile(watch_dir / "counts.bin", dtype=np.int64)
    bn_seen, conf_calls = {}, []
    for path in sorted(watch_dir.glob("*.pt")):
        kept = torch.load(path, weights_only=False)
        if path.name.startswith("bn_"):
            bn_seen[kept[0]] = kept[1:]
        else:
            conf_calls.append(kept)
    return int(bn_launches), int(conf_launches), bn_seen, conf_calls


def phase_lifecycle(card: dict, rows: dict, dev: torch.device, root: Path) -> tuple:
    """13b: ``lifecycle_run`` at the smoke shape, its CLIs run as child
    processes of this script (:func:`watch_child`): the SIGKILL of the first
    training process once the seam window is logged, the resume from
    ``latest``, the seam check, the assessment CLI; each child's kernel
    launches counted and held against the plain versions, and the CLI's
    assessment line against ``assessment_change`` in this process on the
    same checkpoint. Returns (bn_stats, confusion) launches."""
    argv = _lifecycle_argv(root)
    args = lifecycle_run.parser().parse_args(argv)
    watch = root / "life_watch"
    children = []
    here = str(Path(__file__).resolve())

    def cli(module):
        children.append((module, watch / f"{len(children)}_{module}"))
        return [sys.executable, here, "--watch-child", str(children[-1][1]), module]

    real_cli = lifecycle_run.cli
    lifecycle_run.cli = cli
    printed = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = lifecycle_run.main(argv)
        wall = time.perf_counter() - t0
    finally:
        lifecycle_run.cli = real_cli
        for line in printed.getvalue().splitlines():
            if not line.startswith("  step"):
                log(f"  [lifecycle_run] {line[:300]}")
    out, data = Path(args.out_dir), Path(args.data_dir)
    report = json.loads((out / "lifecycle_report.json").read_text())
    plan = lifecycle_run.plan("supervised", args.multiplier, args.log_freq, args.epochs)
    cfg = load_cfg("siamese")
    cfg.merge_from_list(args.extra)
    per_step = 2 * bn_per_step(cfg.MODEL.TOPOLOGY)
    if rc != 0 or [m for m, _ in children] != ["train_supervised", "train_supervised",
                                               "assessment_change"]:
        raise AssertionError(f"13b: lifecycle_run returned {rc}, children {children}")

    bn_total, conf_total = 0, 0
    resumed_steps = plan["steps_per_epoch"] * (args.epochs - plan["resume_epoch"])
    for (module, watch_dir), label in zip(children, ("phase A (killed)", "phase B (resumed)",
                                                     "assessment_change")):
        bn_launches, conf_launches, bn_seen, conf_calls = _watched(watch_dir)
        log(f"  13b {label}: launches bn_stats {bn_launches}, confusion "
            f"{conf_launches}; kept {len(bn_seen)} bn_stats signatures, "
            f"{len(conf_calls)} confusion launches")
        if label.startswith("phase A"):
            ok = (bn_launches >= per_step * plan["seam_step"] and conf_launches >= 1
                  and len(conf_calls) >= conf_launches - 1)
        elif label.startswith("phase B"):
            ok = (bn_launches == per_step * resumed_steps
                  and len(conf_calls) == conf_launches >= 1)
        else:
            ok = bn_launches == 0 and len(conf_calls) == conf_launches >= 1
        if not ok:
            raise AssertionError(f"13b {label}: launches off the schedule")
        if bn_seen:
            _check_path_launches(rows, dev, bn_seen, conf_calls, path=f"13b {label}")
        else:
            _check_conf_launches(rows, dev, conf_calls, f"13b {label}")
        bn_total, conf_total = bn_total + bn_launches, conf_total + conf_launches
        del bn_seen, conf_calls

    # the CLI's printed line == assessment_change in this process
    _, conf_calls, _, keep_conf = _keepers()
    with _watch(evaluation, "confusion_counts", keep_conf):
        _reset_counts()
        text, _, seconds = _run_cli(
            "assessment_change in process", assessment_change.main,
            lifecycle_run.assessment_argv(args, "siamese", out, data))
        torch.cuda.synchronize()
        conf_launches = _counts()[1]
    _check_conf_launches(rows, dev, conf_calls, "13b assessment in process")
    conf_total += conf_launches
    cli_line, here_line = report["assessment_tail"][-1], text.strip().splitlines()[-1]
    log(f"13b lifecycle_run ({args.scene}^2, {report['shape']['aois']} AOIs, "
        f"{plan['steps_per_epoch']} steps/epoch x {args.epochs}, LOG_FREQ "
        f"{args.log_freq}): SIGKILLed after step {report['killed_after_step']}, "
        f"resumed from epoch {report['resume_epoch']}, seam step {report['seam_step']} "
        f"max |A - B| {report['seam_max_abs_diff']} (limit {lifecycle_run.SEAM_LIMIT}); "
        f"assessment CLI '{cli_line}', in process '{here_line}' ({seconds:.1f} s); "
        f"median train {report['median_train_patches_per_sec']} patches/s over "
        f"{len(report['window_rates'])} windows; {wall:.1f} s wall "
        f"({card['smi']})")
    if (report["seam_max_abs_diff"] is None
            or report["seam_max_abs_diff"] > lifecycle_run.SEAM_LIMIT
            or cli_line != here_line or not cli_line.startswith("F1 score: ")):
        raise AssertionError("13b: the seam shows, or the assessment CLI's line "
                             "differs from the in-process one")
    return bn_total, conf_total


# -- phase 14 -----------------------------------------------------------------

def _drive(label: str, main, argv: list) -> list:
    """``main(argv)`` of a measurement module in this process, its output
    printed here as it printed it; returns its JSON lines. A module that
    exits non-zero fails the phase."""
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = main(argv)
    sys.stdout.write(printed.getvalue())
    log(f"  {label}: {time.perf_counter() - t0:.1f} s wall, argv {argv}")
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}")
    return [json.loads(line) for line in printed.getvalue().splitlines()
            if line.startswith("{")]


def _counted(label: str, main, argv: list, keep_bn=None, keep_conf=None) -> tuple:
    """:func:`_drive` with the kernels' launch counts around it (bn_stats'
    and the confusion kernel's calls routed through the keepers where
    given). Returns (JSON lines, bn_stats launches, confusion launches)."""
    with contextlib.ExitStack() as stack:
        if keep_bn is not None:
            stack.enter_context(_watch(batchnorm, "bn_stats", keep_bn))
        if keep_conf is not None:
            stack.enter_context(_watch(evaluation, "confusion_counts", keep_conf))
        # ---- the module's run, with the kernels' launch counts around it ----
        torch.cuda.synchronize()
        _reset_counts()
        lines = _drive(label, main, argv)
        torch.cuda.synchronize()
        bn_launches, conf_launches, _ = _counts()
        # ---------------------------------------------------------------------
    return lines, bn_launches, conf_launches


def _gib(value, per_gib: float) -> str:
    """A memory figure of a module's line in GiB (``per_gib`` units a GiB),
    or what the line says instead (``"not measured"``)."""
    return f"{value / per_gib:.2f} GiB" if isinstance(value, float) else str(value)


def _bench_line(card: dict, line: dict, label: str) -> None:
    """Log and check a bench line: its keys, every regime's rate finite and
    above 0, and the card it names."""
    regimes = line["per_regime"]
    for regime, r in regimes.items():
        syncs = r.get("syncs", {})
        log(f"  14a {label} {regime}: {r['value']:.2f} patches/s, {r['step_ms']:.3f} "
            f"ms a step ({r['mode']}), loss {r['loss']:.5f}; synchronising calls "
            f"in one more call: {sum(syncs.values()) if isinstance(syncs, dict) else syncs} "
            f"at {sorted(syncs) if isinstance(syncs, dict) else '-'} ({card['smi']})")
    if (line["metric"] != bench.METRIC or set(line["regimes"]) != set(regimes)
            or not all(np.isfinite(r["loss"]) and r["value"] > 0
                       for r in regimes.values())
            or line["device"]["name"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"14a {label}: the bench's line is off: {line}")


def phase_measure(card: dict, rows: dict, dev: torch.device, root: Path,
                  aois: list) -> tuple:
    """Phase 14: the measurement modules through their ``main`` on the card,
    their kernels' launches counted and held against the plain versions.
    Returns (bn_stats, confusion) launches of its paths and 14a's step ms by
    regime."""
    t0 = time.perf_counter()
    per_step = {r: 2 * bn_per_step(PHASE14_TOPOLOGY, **kw)
                for r, kw in BENCH_BN_CALLS.items()}
    args = bench.parse_args(BENCH_ARGV)
    k = args.steps_per_call
    bn_total = 0

    # 14a: the bench at its defaults, then the supervised regime at k = 1
    bn_seen, _, keep_bn, _ = _keepers()
    (line,), bn_graph, _ = _counted("14a bench", bench.main, BENCH_ARGV, keep_bn)
    _bench_line(card, line, "graph")
    step_ms = {r: v["step_ms"] for r, v in line["per_regime"].items()}
    regimes = list(line["per_regime"])
    graph = all(r["mode"] == "graph" for r in line["per_regime"].values())
    expect = sum((k + 1) * per_step[r] for r in regimes)
    replays = (max(1, args.warmup_calls) - 1 + args.calls + args.sync_debug) * k
    log(f"  14a bn_stats launches the wrapper counted {bn_graph} (expected {expect}: "
        f"each regime's first call, {k} eager steps and the capture); the later "
        f"calls replayed {sum(replays * per_step[r] for r in regimes)} more from "
        f"the graphs ({replays} steps a regime; 14d counts a replayed window's "
        f"in a trace)")
    if not graph or bn_graph != expect:
        raise AssertionError("14a: the bench's windows did not run as CUDA graphs, "
                             "or its bn_stats launches are off")
    (line1,), bn_eager, _ = _counted("14a bench k = 1", bench.main, BENCH_K1_ARGV,
                                      keep_bn)
    _bench_line(card, line1, "k = 1")
    a1 = bench.parse_args(BENCH_K1_ARGV)
    # the sync debug mode's call runs on the card alone
    synced = a1.sync_debug and dev.type == "cuda"
    expect = (max(1, a1.warmup_calls) + a1.calls + synced) * per_step["supervised"]
    if line1["per_regime"]["supervised"]["mode"] != "eager" or bn_eager != expect:
        raise AssertionError(f"14a k = 1: {bn_eager} bn_stats launches, expected "
                             f"{expect}")
    _check_bn_launches(rows, dev, bn_seen, "14a bench")
    bn_total += bn_graph + bn_eager
    del bn_seen
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    # 14b: the eval forward at 16 x 1024^2 with its FLOP count
    (line,) = _drive("14b bench_eval", bench_eval.main, BENCH_EVAL_ARGV)
    log(f"  14b bench_eval: {line['value']:.2f} scenes/s at {line['group']} x "
        f"{line['scene']}^2, {line['ms_per_scene']:.2f} ms a scene, peak "
        f"{_gib(line['peak_gib'], 1)}; {line.get('effective_tflops', float('nan')):.1f} "
        f"effective TFLOP/s, {line.get('bf16_peak_share', float('nan')) * 100:.1f}% of "
        f"the dense bf16 peak ({card['smi']})")
    if not line["value"] > 0 or line["device"]["name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"14b: the line is off: {line}")
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # 14c: end to end over phase 4's split; the warm-up pass's confusion
    # launches kept (the timed pass's repeat them on the same inputs, and a
    # copy to the host inside it would be timed): a launch a group of the
    # split's padded shapes (write_split's sides)
    pad = lambda side: -(-side // evaluation.EVAL_BUCKET) * evaluation.EVAL_BUCKET  # noqa: E731
    shapes = collections.Counter((pad(AOI_SIDE + 8 * (i % 3)), pad(AOI_SIDE + 8 * (i % 2)))
                                 for i in range(N_AOIS))
    groups = sum(-(-n // evaluation.eval_group_limit(shape)) for shape, n in shapes.items())
    conf_calls = []

    def keep_warm_pass(args_, out):
        if len(conf_calls) < groups:
            conf_calls.append((tuple(t.detach().cpu() for t in args_), out.cpu()))

    (line,), _, conf = _counted("14c bench_assessment", bench_assessment.main,
                                ["--data-dir", str(root)] + ASSESS_ARGV,
                                keep_conf=keep_warm_pass)
    _check_conf_launches(rows, dev, conf_calls, "14c bench_assessment")
    cfg = bench_assessment.assessment_cfg(root, aois)
    cfg.merge_from_list(bench_assessment.parser().parse_args(ASSESS_ARGV).opts)
    model = create_network(cfg, device=dev,
                           generator=torch.Generator().manual_seed(bench.SEED))
    f1 = evaluation.inference_loop(model, bench_assessment.assessment_dataset(cfg),
                                   device=dev)["change"][0]
    log(f"  14c bench_assessment: {line['value']:.2f} scenes/s end to end over "
        f"{line['n_scenes']} scenes of {line['scene_class']}^2, host alone "
        f"{line['host_only_scenes_per_sec']:.2f} scenes/s, {line['e2e_wall_s']:.3f} s; "
        f"F1 {line['f1']:.6f} against inference_loop's {f1:.6f} on the same weights "
        f"(|dF1| {abs(line['f1'] - f1):.2e}); confusion launches {conf} "
        f"({card['smi']})")
    if (line["n_scenes"] != len(aois) or conf != 2 * groups
            or abs(line["f1"] - f1) > 1e-6
            or line["device"]["name"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"14c: the line is off inference_loop's: {line}")
    del model
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    # 14d: the step profile of the supervised regime. The profiler drops
    # kernel records now and then (a window's first kernels after the card
    # idled; PERF.md §6): where the mode and the wrapper's count are right
    # and a trace holds fewer bn_stats kernels than launched, the profile is
    # taken once more, and that reading must be exact
    for attempt in (1, 2):
        bn_seen, _, keep_bn, _ = _keepers()
        (line,), bn_prof, _ = _counted("14d profile_step", profile_step.main,
                                       PROFILE_ARGV, keep_bn)
        _check_bn_launches(rows, dev, bn_seen, "14d profile_step")
        bn_total += bn_prof
        steps = line["windows"] * line["k"]
        cats = {key: line[key]["launches"].get("bn_stats", 0)
                for key in ("graph", "eager")}
        for key in ("graph", "eager"):
            s_ = line[key]
            share = ("not measured" if s_["busy_share"] is None
                     else f"{s_['busy_share'] * 100:.1f}% busy")
            log(f"  14d {key}: {s_['device_ms_per_step']:.3f} device ms a step, "
                f"{s_['wall_ms_per_step']:.3f} host ms, {share}; "
                + ", ".join(f"{c} {v:.3f} ms ({v / s_['device_ms_per_step'] * 100:.1f}%)"
                            for c, v in s_["categories_ms_per_step"].items())
                + f" ({card['smi']})")
        expect = (line["k"] + 1 + 1 + steps) * per_step["supervised"]
        # each bn_stats launch is two kernels, the partial sums and their finalize
        want = 2 * steps * per_step["supervised"]
        log(f"  14d bn_stats kernels in the traces: graph {cats['graph']}, eager "
            f"{cats['eager']} (expected {want} each); the wrapper counted {bn_prof} "
            f"(expected {expect}: the graph's first window and capture, the eager "
            f"warm step and steps)")
        off = (f"14d: the profile's bn_stats launches are off: graph mode "
               f"{line['graph']['mode']}, the wrapper counted {bn_prof} (expected "
               f"{expect}), the traces hold {cats} (expected {want} each)")
        if line["graph"]["mode"] != "graph" or bn_prof != expect or any(
                v > want for v in cats.values()):
            raise AssertionError(off)
        if all(v == want for v in cats.values()):
            break
        if attempt == 2:
            raise AssertionError(off + ", in a second profile too")
        log(f"  14d: the traces hold {cats} bn_stats kernels of {want}: the "
            f"profiler dropped records; profiling once more")
    bn_total += cats["graph"] // 2
    del bn_seen
    torch.cuda.empty_cache()
    t4 = time.perf_counter()

    # 14e: the segmented step, then the memory table at 1024^2
    bn_seen, _, keep_bn, _ = _keepers()
    lines, bn_ablate, _ = _counted("14e ablate_step", ablate_step.main, ABLATE_ARGV,
                                   keep_bn)
    aargs = ablate_step.parser().parse_args(ABLATE_ARGV)
    one = per_step["supervised"]
    expect = len(lines) * (5 * aargs.k * one // 2 + 5 * aargs.k * one
                           + (aargs.k + 1) * one)
    for line in lines:
        log(f"  14e ablate_step batch {line['batch']}: "
            + ", ".join(f"{key} {v:.2f}" for key, v in line["ms_per_step"].items())
            + f" ms a step, {line['patches_per_sec']:.1f} patches/s (segments "
              f"{line['modes']['segments']}, full {line['modes']['full']}) "
              f"({card['smi']})")
    log(f"  14e ablate_step bn_stats launches {bn_ablate} (expected {expect})")
    if bn_ablate != expect or any(line["modes"]["full"] != "graph" for line in lines):
        raise AssertionError("14e: ablate_step's launches or modes are off")
    _check_bn_launches(rows, dev, bn_seen, "14e ablate_step")
    del bn_seen
    lines, bn_remat, _ = _counted("14e bench_remat_memory", bench_remat_memory.main,
                                  REMAT_ARGV)
    rargs = bench_remat_memory.parser().parse_args(REMAT_ARGV)
    accum = rargs.grad_accum
    remat = 3 * one // 2          # REMAT runs every forward BatchNorm twice
    expect = one + remat + accum * one + accum * remat
    for rec in lines[:-1]:
        log(f"  14e bench_remat_memory {rec['label']} at {rec['crop']}^2 batch "
            f"{rec['batch']}: "
            + (f"OOM ({rec['error']})" if rec.get("oom") else
               f"{_gib(rec['max_allocated_mib'], 1024)} allocated, "
               f"{_gib(rec['max_reserved_mib'], 1024)} reserved, "
               f"{rec['step_ms']:.1f} ms") + f" ({card['smi']})")
    log(f"  14e bench_remat_memory summary {lines[-1]}; bn_stats launches "
        f"{bn_remat} (expected {expect} with no mode out of memory)")
    if any(rec.get("oom") for rec in lines[:-1]) or bn_remat != expect:
        raise AssertionError("14e: a memory mode failed or its launches are off")
    # its launches at 1024^2 held against plain from one more staged step of
    # plain and of GRAD_ACCUM (REMAT's signatures are theirs), outside the
    # measured run: a copy to the host inside it would be in its step times
    bn_seen, _, keep_bn, _ = _keepers()
    with _watch(batchnorm, "bn_stats", keep_bn), \
            contextlib.redirect_stdout(io.StringIO()):
        _reset_counts()
        for label, extra in (("plain", []), ("grad_accum", ["TRAINER.GRAD_ACCUM",
                                                           str(accum)])):
            bench_remat_memory.analyze(label, rargs.opts + extra, rargs.crop,
                                       rargs.batch, rargs.regime, dev)
        bn_check = _counts()[0]
    _check_bn_launches(rows, dev, bn_seen, "14e bench_remat_memory")
    bn_total += bn_ablate + bn_remat + bn_check
    del bn_seen
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t0:.1f} s wall, checks included (14a "
        f"{t1 - t0:.1f} s, 14b {t2 - t1:.1f} s, 14c {t3 - t2:.1f} s, 14d "
        f"{t4 - t3:.1f} s, 14e {time.perf_counter() - t4:.1f} s)")
    return bn_total, conf, step_ms


# -- phase 15 -----------------------------------------------------------------

def _bn_sum_bytes(regime: str, dev: torch.device) -> int:
    """The sync-BN bytes of one step of the regime's full-width model: a
    ``2C`` float32 all-reduce for every BatchNorm call of a train-mode
    forward (counted by forward pre-hooks on a throwaway model at batch 1,
    crop 32) and one more for each in the backward."""
    cfg = load_cfg("base")
    cfg.merge_from_list(model_scaling.regime_overrides(regime, 1, 1, 32))
    model = create_network(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    channels = []
    for m in model.modules():
        if isinstance(m, batchnorm.BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, args: channels.append(args[0].shape[1]))
    x = torch.rand(1, 6, 32, 32, device=dev)
    with torch.no_grad():
        model.train()(x, x)
    return 2 * sum(2 * c * 4 for c in channels)


def _dryrun_launches(rows: dict, dev: torch.device, results: dict, who: str,
                     per_step: dict) -> tuple:
    """One process's dry-run cases (``{name: result}``): every kept
    bn_stats and confusion launch held against the plain versions
    (:func:`_check_bn_launches`, :func:`_check_conf_launches`), each
    training case's bn_stats launches against ``DRYRUN_STEPS`` steps of its
    model. Returns (bn_stats, confusion) launches."""
    bn = conf = 0
    for name, res in results.items():
        path = f"dry run {name} ({who})"
        if res.get("bn_kept"):
            _check_bn_launches(rows, dev, _bn_seen(res["bn_kept"]), path)
        if res.get("conf_kept"):
            _check_conf_launches(rows, dev, [(tuple(k["args"]), k["out"])
                                             for k in res["conf_kept"]], path)
        if name in DRYRUN_STEPS:
            want = DRYRUN_STEPS[name] * per_step.get(name, per_step["supervised"])
            if res["launches"] != want:
                raise AssertionError(f"{path}: {res['launches']} bn_stats launches, "
                                     f"expected {want}")
            bn += res["launches"]
        elif "f1" in res:
            conf += res["launches"]
    return bn, conf


def phase_entry(card: dict, rows: dict, dev: torch.device, step_ms: dict) -> tuple:
    """Phase 15: ``graft_entry.entry``'s shape and finiteness (and the
    wrapper against the ``train_lib.probabilities`` it wraps),
    ``graft_entry.dryrun_multichip`` over four ranks on the card with every
    launch held against plain, and ``model_scaling``'s counts at world 2
    held to the step's shapes, with ``step_ms`` (14a's bench, by regime) as
    its step times. Returns the (bn_stats, confusion) launches of 15b."""
    t0 = time.perf_counter()
    fn, (model, x1, x2) = graft_entry.entry()
    got = fn(model, x1, x2)
    with torch.inference_mode():
        want = train_lib.probabilities(model, x1, x2)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    log(f"15a entry(): fn on the flagship ({model.compute_dtype}, "
        f"{sum(p.numel() for p in model.parameters()):,} parameters) and "
        f"{tuple(x1.shape)} x 2 batches -> {tuple(got.shape)} {got.dtype}, finite "
        f"{bool(torch.isfinite(got).all())}, mean {float(got.mean()):.6f}; the "
        f"wrapper equal to the train_lib.probabilities it wraps: {equal}")
    if (not equal or got.shape != (x1.shape[0], 1) + x1.shape[2:]
            or not torch.isfinite(got).all()):
        raise AssertionError("15a: entry()'s fn: not (B, 1, H, W), not finite, or "
                             "not the train_lib.probabilities it wraps")
    del fn, model, x1, x2, got, want
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    out = graft_entry.dryrun_multichip(DRYRUN_RANKS)
    per_step = {r: 2 * bn_per_step(PHASE14_TOPOLOGY, **kw)
                for r, kw in BENCH_BN_CALLS.items()}
    bn = conf = 0
    for who, results in [(f"rank {r}", res) for r, res in enumerate(out["world"])] + [
            ("this process", out["one"])]:
        b, c = _dryrun_launches(rows, dev, results, who, per_step)
        log(f"  15b {who}: bn_stats launches {b}, confusion launches {c}, all held "
            f"against plain")
        if c < 1:
            raise AssertionError(f"15b {who}: no confusion launch")
        bn, conf = bn + b, conf + c
    slowest = sorted(out["world"][0].items(), key=lambda kv: -kv[1]["seconds"])[:4]
    log(f"15b dryrun_multichip({DRYRUN_RANKS}): {len(out['surfaces'])} surfaces in "
        f"{out['wall_s']:.1f} s wall: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in out["seconds"].items())
        + "; rank 0's slowest cases " + ", ".join(f"{k} {r['seconds']:.1f} s"
                                                 for k, r in slowest)
        + f" ({card['smi']})")
    if len(out["surfaces"]) != 12:
        raise AssertionError(f"15b: {len(out['surfaces'])} surfaces, expected 12")
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    regimes = list(bench.REGIME_MODELS)
    records = _drive("15c model_scaling", model_scaling.main,
                     ["--world", str(SCALING_WORLD), "--step-ms",
                      ",".join(repr(step_ms[r]) for r in regimes)])
    for rec in records:
        regime, n, b, crop = (rec["regime"], rec["world"], rec["batch_per_rank"],
                              rec["crop"])
        cfg = load_cfg("base")
        cfg.merge_from_list(model_scaling.regime_overrides(regime, 1, b, crop))
        params = sum(p.numel() for p in create_network(cfg, device="cpu").parameters())
        want = {"gradient": 4 * params, "bn_sums": _bn_sum_bytes(regime, dev),
                "global_rows": n * b * (HEADS[regime] + 3) * crop * crop * 4 + n * b * 4}
        got = {site: rec["by_site"][site]["bytes"] for site in want}
        log(f"  15c {regime} at world {n}: "
            + ", ".join(f"{site} {rec['by_site'][site]['calls']} calls "
                        f"{v / 2**20:.4f} MiB" for site, v in got.items())
            + f"; {rec['allreduce_mib']:.2f} MiB all-reduced, "
              f"{rec['allreduce_vs_param_bytes']:.3f} x the parameters' bytes; ring "
              f"at {rec['link_gbps_per_dir']:g} GB/s a direction "
              f"{rec['link_wire_ms_ring']:.3f} ms beside a {rec['measured_step_ms_1card']:.3f}"
              f" ms step: efficiency {rec['dp_efficiency_no_overlap']:.4f} without "
              f"overlap, {rec['dp_efficiency_overlapped']:.4f} overlapped ({card['smi']})")
        if got != want:
            raise AssertionError(f"15c {regime}: counted bytes {got}, expected {want}")
    if [r["regime"] for r in records] != regimes:
        raise AssertionError(f"15c: records for {[r['regime'] for r in records]}")
    log(f"phase 15: {time.perf_counter() - t0:.1f} s wall, checks included (15a "
        f"{t1 - t0:.1f} s, 15b {t2 - t1:.1f} s, 15c {time.perf_counter() - t2:.1f} s)")
    return bn, conf


def main() -> None:
    if sys.argv[1:2] == ["--watch-child"]:
        watch_child(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
        return
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    rows = dict(zip(("confusion_counts", "confusion_counts_strict"),
                    phase_kernel(card)))
    rows["bn_stats"] = phase_bn_stats(card)
    rows["conv3x3"] = phase_conv3x3(card)
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    maker = None
    try:
        root, root13 = Path(tmp.name) / "split", Path(tmp.name) / "phase13"
        root13.mkdir()
        # phase 13's datasets, written by a process of their own beside the
        # split: after phase 3's host-timed measurements, before phase 4's
        maker = multiprocessing.get_context("spawn").Process(
            target=make_datasets, args=(str(root13),), name="phase 13's datasets")
        maker.start()
        aois = write_split(root)
        t4 = time.perf_counter()
        _join(maker)
        log(f"phase 13: its datasets ready {time.perf_counter() - t4:.1f} s "
            f"after the split")
        phase_main_path(card, rows["confusion_counts"], dev, root, aois)
        phase_train(card, rows, dev, root, aois)
        phase_dualtask(card, rows, dev, root, aois)
        phase_semisup(card, rows, dev, root, aois)
        phase_siamunet_diff(card, rows, dev, root, aois)
        phase_clis(dev, root, aois)
        t9a = time.perf_counter()
        phase_serving(card, dev, root, aois)
        t9b = time.perf_counter()
        rows["bn_stats"]["launches"] += phase_knobs(card, rows, dev, root, aois)
        t9c = time.perf_counter()
        rows["bn_stats"]["launches"] += phase_knob_run(card, rows, dev, root, aois)
        t9 = time.perf_counter()
        log(f"phase 9: {t9 - t9a:.1f} s wall, checks included (9a {t9b - t9a:.1f} "
            f"s, 9b {t9c - t9b:.1f} s, 9c {t9 - t9c:.1f} s)")
        for phase in (phase_parallel, phase_nccl):
            bn_launches, conf_launches = phase(card, rows, dev, root, aois)
            rows["bn_stats"]["launches"] += bn_launches
            rows["confusion_counts"]["launches"] += conf_launches
        t10 = time.perf_counter()
        log(f"phase 10: {t10 - t9:.1f} s wall, checks included")
        bn_launches, conf_launches = phase_space(card, rows, dev, root, aois)
        rows["bn_stats"]["launches"] += bn_launches
        rows["confusion_counts"]["launches"] += conf_launches
        log(f"phase 11: {time.perf_counter() - t10:.1f} s wall, checks included")
        bn_launches, conf_launches = phase_steps(card, rows, dev, root, aois)
        rows["bn_stats"]["launches"] += bn_launches
        rows["confusion_counts"]["launches"] += conf_launches
        t13 = time.perf_counter()
        for phase in (phase_convergence, phase_lifecycle):
            bn_launches, conf_launches = phase(card, rows, dev, root13)
            rows["bn_stats"]["launches"] += bn_launches
            rows["confusion_counts"]["launches"] += conf_launches
            log(f"phase {phase.__name__}: {time.perf_counter() - t13:.1f} s into phase 13")
        log(f"phase 13: {time.perf_counter() - t13:.1f} s wall, checks included")
        bn_launches, conf_launches, step_ms = phase_measure(card, rows, dev, root, aois)
        rows["bn_stats"]["launches"] += bn_launches
        rows["confusion_counts"]["launches"] += conf_launches
        bn_launches, conf_launches = phase_entry(card, rows, dev, step_ms)
        rows["bn_stats"]["launches"] += bn_launches
        rows["confusion_counts"]["launches"] += conf_launches
    finally:
        if maker is not None and maker.is_alive():
            maker.terminate()
            maker.join()
        tmp.cleanup()
    log(f"kernels: {json.dumps(list(rows))}; chip_smoke wall "
        f"{time.perf_counter() - t_start:.1f} s (builds included) on {card['smi']}")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
