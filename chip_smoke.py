#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
no install: it puts ``src/`` on the path itself).  Phases:

1. print the card's name and power limit (``nvidia-smi``);
2. (Z1) build the five CUDA kernels from ``src/repro_torch/csrc``, one nvcc
   each, all at once;
3. hold each bottleneck kernel, on every tile of ``kernels/tiles.py``,
   against its plain PyTorch version on the card at the main path's shapes
   (full-width VGG16, batch 8), N = 1, two ragged N and the llama3.2-3b cut
   of phase Z4, and every tile against every other bit for bit; time each
   tile, the plain version and ``torch.addmm`` of the matmul alone on the
   device (CUDA-graph replay with L2 warm, and again L2-flushed), and the
   picked tile's wrapper as a caller pays it (eager calls); print picked /
   fastest per shape;
4. serve full-width VGG16 (random weights from a fixed seed, batch 8) with a
   ``SplitRuntime`` cut at pool16, pool23 and fc0_relu, an AE and an int8
   wire at each cut, eager and fused; then an int8 split at pool16, no AE;
   each codec kernel launches 36 times in phases 4-5;
5. serve 4 clients through ``run_clients`` and a 4-slot ``TailServer``;
6. (Z2) hold ``flash_attention`` against its plain version at the
   llama3.2-3b and jamba prefill shapes and four more masks (window,
   non-causal, Sq < Sk, ragged), each in bf16 (the ``wgmma_bf16`` route) and
   f32 (``simt_f32``), timed beside ``scaled_dot_product_attention``; every
   bf16 row again on the mask-edge probe (``ref.flash_edge_probe``), where
   a key off by one at a causal, window or key-range edge moves the output
   far past the bf16 bar;
7. (Z3) hold ``rwkv6_scan`` against its plain version at the rwkv6-1.6b
   prefill and decode shapes, a ragged one and the prefill at the served
   model's decays;
8. (Z4) serve full-width, full-depth llama3.2-3b (bf16, random weights)
   through ``ServingEngine`` on 4 ragged prompts, 16 new tokens each, hold
   each step's logits against a full forward over the same tokens, then cut
   it after layer 14 with an AE and the int8 wire through
   ``transformer_as_layered``, and time the view's Table I
   (``stats.summary`` with the served tokens as its sample) cold and cached;
9. (Z5) serve full-width, full-depth rwkv6-1.6b the same way; then both
   served runs again in f32, held to the f32 bar;
10. (Z6) for each model, a full-width depth-2 f32 copy through the kernels
    on the card against the plain versions on the CPU, same weights;
11. (Z7) hold ``mamba_scan`` against its plain version at the jamba-v0.1-52b
    prefill (zero state), a ragged S from a given state, a decode step and
    the prefill again with the served model's own A;
12. (Z8) serve jamba-v0.1-52b with its dense FFN (``moe=None``; the MoE
    layers wait for ROADMAP A13b) at full width and full depth in bf16
    through ``ServingEngine``, Z4's prompts, 16 new tokens each, each step's
    logits held against one full forward under Z4's rule; (Z9) the same in
    f32; (Z10) Z6's check for a one-period (8-layer) f32 copy of it;
13. (Z11) the paper's split-point search on phase 4's VGG16 (the same
    seed): Table I/II from ``core.stats``, held equal to the reference's
    (``VGG16_TOTALS_16``); the Grad-CAM CS curve over the 18 feature ops on
    16 toy images (``data.synthetic``), timed, run 6 times and held to the
    CPU's curve at 2 images; the candidates ``Study.candidates`` would rank;
14. (Z12) ``train_bottleneck`` (Eq. 3) at the top SC candidate and at
    pool23, 50 steps at batch 8, the loss falling and the first 3 steps
    replayed on the CPU at 2 images; ``finetune`` (Eq. 4) at pool23, 3
    steps, held to ``finetune`` on the CPU from the same start, and its
    first 2 steps' gradients at 2 images to the CPU's; then a
    ``SplitRuntime`` at each trained cut with its AE and the int8 wire,
    through both codec kernels, held to the plain chain;
15. (Z13) the paper's communication-aware simulator (§IV, Figs. 3-4) on the
    same VGG16 with Z12's AEs: LC, RC and SC at both trained cuts, over TCP
    and UDP at 5 loss rates (``bench_protocol.py``'s channel), 64 toy
    images, "accuracy" read as agreement with the unsplit model; each
    flow's analytic times held to the CPU copy's, the simulator's own
    per-chunk inference held to the CPU's with the same loss masks, and
    Fig. 4's shape (TCP agreement flat and latency rising, UDP latency
    flat);
16. (Z14) hardware-in-the-loop calibration (``runtime.calibrate``, fused) at
    batch 8 over relu1, pool16, pool23 and fc0_relu, the AE cuts through
    both codec kernels; the table's JSON round trip, each cut's frame
    length, its measured cells priced through ``measure_flow`` beside the
    analytic ``server-gpu`` profile, fed to the simulator, and
    ``HILPlatform.measure`` of the unsplit forward;
17. (Z15) fault recovery in the split runtime (``SplitRuntime(faults=,
    recovery=)``, a twin of ``benchmarks/bench_faults.py``) at both trained
    AE cuts, 16 requests at batch 1: with no faults the SEI1 frames byte for
    byte and fused logits equal to eager; under the chaos plan every request
    answered, the ones not degraded bit for bit the fault-free run's, the
    degraded ones within their rung's bar, and every request's fates equal
    to a CPU run of the same plan; under a blackout every request on the
    local fallback; then a 4-slot ``TailServer(faults=)`` that rejects
    corrupted frames and serves nothing inside a blackout window;
18. (Z16) the fleet layers (twins of ``examples/fleet_planning.py`` and
    ``examples/adaptive_replanning.py``): ``DeploymentPlanner`` over three
    device classes and a 1000-request diurnal trace, its accuracy legs on the
    card over Z13's images, its server stage priced by Z14's table; the event
    and vectorized cluster engines held together on the suggested plans, the
    card's plan points to a CPU planner's over 2 images, and
    ``AdaptiveController.from_planner`` deciding the same under both engines;
19. print the kernels' launch counts with their errors, times and bounds as
    one JSON line, then ``{"ok": true, "device": ...}``.

Each path (phases 4-5, Z4, Z5, Z6, Z8-Z10, Z11, Z12's training and its
deploy, Z13, Z14, each part of Z15, Z16) runs with the launch counts set to 0
just before it and read just after; a served run's prefill and decode are
counted apart as well, and ``flash_attention``'s launches by route
(``wgmma_bf16`` for a bf16 model, ``simt_f32`` for an f32 one).  Z11, Z12's
training, Z13 and Z16 launch no kernel (a wrapper refuses an input that
requires grad; the simulator runs the plain f32 forward); Z14 and Z15 launch
each codec kernel a number of times worked out from the code (Z15: from the
rungs each request took).  Any failed check raises, so the script exits
non-zero and prints no result.  It exits non-zero as well where CUDA is not
available.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api.types import AnalyticCost, CostStack, legal_split_candidates  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.core import bottleneck as B  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.core.qos import rank_candidates  # noqa: E402
from repro_torch.core.saliency import candidate_split_points, cumulative_saliency  # noqa: E402
from repro_torch.core.bottleneck import latent_channels  # noqa: E402
from repro_torch.core.scenarios import (PLATFORMS, HILPlatform, Scenario,  # noqa: E402
                                        scenario_times_and_payload)
from repro_torch.core.split import SplitPlan  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ref, reset_launches, tiles  # noqa: E402
from repro_torch.kernels import bottleneck_compress as comp  # noqa: E402
from repro_torch.kernels import bottleneck_decompress as decomp  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.data.synthetic import toy_image_iter, toy_images  # noqa: E402
from repro_torch.models.vgg import feature_index, vgg16  # noqa: E402
from repro_torch.training.optimizer import adam_init, adam_update  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.qos import QoSRequirements  # noqa: E402
from repro_torch.fleet import (PCTL_RTOL, AdaptiveController, ControllerConfig,  # noqa: E402
                               DeploymentPlanner, DeviceClass, Phase, RegimeChangeTrace,
                               SearchSpace, generate_trace, simulate_deployment)
from repro_torch.fleet.vectorized import PCTL_ATOL  # noqa: E402
from repro_torch.netsim.channel import INTERFACES, Channel  # noqa: E402
from repro_torch.netsim.simulator import (ApplicationSimulator, NetworkConfig,  # noqa: E402
                                          measure_flow)
from repro_torch.runtime import wire as W  # noqa: E402
from repro_torch.runtime.calibrate import CalibrationTable, calibrate  # noqa: E402
from repro_torch.runtime.engine import SplitRuntime, TailServer, run_clients  # noqa: E402
from repro_torch.runtime.faults import FaultPlan, RecoveryPolicy  # noqa: E402
from repro_torch.runtime.partition import make_partition  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 off the tensor cores,
# bf16 / fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# exponentials on the special-function units (MUFU.EX2): 16 a clock on each
# of the 132 SMs at 1.98 GHz, the clock F32_FLOPS assumes (132 * 128 * 2 *
# 1.98e9); the f32 FMA lanes do 8 times as many operations a clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
BATCH = 8
L2_FLUSH_BYTES = 256 << 20      # five times the H100's 50 MB L2
VGG_CUTS = {"relu3": 3, "pool16": 16, "pool23": 23, "flatten": 31, "fc0_relu": 33}
# the zoo's served requests (Z4, Z5): prompt lengths, new tokens each
LLAMA_PROMPTS = (2000, 1800, 1234, 777)
RWKV_PROMPTS = (1000, 640, 333, 1)
NEW_TOKENS = 16
LLAMA_CUT_ROWS = len(LLAMA_PROMPTS) * max(LLAMA_PROMPTS)   # the (B*S, 3072) residual at the cut
# beside the batch-8 cuts: N 1, ragged widths, one phase-5 client's two
# images at pool23, and the llama3.2-3b cut
EXTRA_SHAPES = [("n1", 1, 512, 256), ("ragged_rows", 4237, 96, 48),
                ("ragged_cols", 777, 300, 100), ("pool23_client", 2 * 14 * 14, 512, 256),
                ("llama_cut14", LLAMA_CUT_ROWS, 3072, 1536)]
# flash_attention at the llama3.2-3b prefill (B 4, S 2000, H 24, K 8, D 128),
# at the jamba-v0.1-52b prefill (H 32, K 8: a GQA group of 4, not 3) and
# around them: (label, B, Sq, Sk, H, K, D, causal, window, dtype)
# Each mask also in f32, where the bar (1e-5) is far below what a key off by
# one at the window's or the alignment's edge would move; the bf16 rows run
# the mask-edge probe for that.
FLASH_SHAPES = [
    ("llama_prefill", 4, 2000, 2000, 24, 8, 128, True, None, torch.bfloat16),
    ("llama_f32", 4, 1000, 1000, 24, 8, 128, True, None, torch.float32),
    ("jamba_prefill", 4, 2000, 2000, 32, 8, 128, True, None, torch.bfloat16),
    ("jamba_prefill_f32", 4, 2000, 2000, 32, 8, 128, True, None, torch.float32),
    ("window512", 4, 2000, 2000, 24, 8, 128, True, 512, torch.bfloat16),
    ("window512_f32", 4, 2000, 2000, 24, 8, 128, True, 512, torch.float32),
    ("noncausal", 4, 1000, 1000, 24, 8, 128, False, None, torch.bfloat16),
    ("noncausal_f32", 4, 1000, 1000, 24, 8, 128, False, None, torch.float32),
    ("sq500_sk2000", 4, 500, 2000, 24, 8, 128, True, None, torch.bfloat16),
    ("sq500_sk2000_f32", 4, 500, 2000, 24, 8, 128, True, None, torch.float32),
    ("ragged777", 4, 777, 777, 24, 8, 128, True, None, torch.bfloat16),
    ("ragged777_f32", 4, 777, 777, 24, 8, 128, True, None, torch.float32),
]
# flash_attention against its plain version, as tests/test_kernels.py holds
# the TPU kernel to its ref
FLASH_BAR = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# rwkv6_scan at the rwkv6-1.6b prefill and decode (H 32, D 64): (label, B, S,
# H, D, nonzero initial state, decays and bonus as the served model's).  The
# other rows take w = exp(-exp(N(0, 1) - 1)), down to about 1e-9, and u =
# 0.3 N(0, 1); "served_w" takes w = exp(-exp(-4 + 0.5 N(0, 1))), near 0.98,
# the range the served model's decay_base of -4 gives (models/rwkv.py), and
# u = 0.1 N(0, 1), as its bonus: the state then sums some 50 steps of k v^T,
# where a changed summation order shows most.
RWKV_SHAPES = [("rwkv_prefill", 4, 1000, 32, 64, False, False),
               ("rwkv_decode", 4, 1, 32, 64, True, False),
               ("ragged333", 4, 333, 32, 64, True, False),
               ("served_w", 4, 1000, 32, 64, False, True)]
# mamba_scan at the jamba-v0.1-52b prefill and decode (d_inner 8192, d_state
# 16): (label, B, S, di, ds, nonzero initial state, A as the model's init
# makes it).  The other rows take A = -exp(0.3 N(0, 1)) and dt = 0.1
# softplus(N(0, 1)); "served_a" takes the served model's own A, -(1 .. 16) in
# every channel (models/mamba.py), and dt = softplus(N(0, 1)), where |dt A|
# reaches 10-20 and the kernel's ex2.approx departs most from torch.exp.
MAMBA_SHAPES = [("jamba_prefill", 4, 2000, 8192, 16, False, False),
                ("ragged333", 4, 333, 8192, 16, True, False),
                ("jamba_decode", 4, 1, 8192, 16, True, False),
                ("served_a", 4, 2000, 8192, 16, False, True)]
# its bar, relative to max |plain| of y and of the final state: f32 in
# another order (fused multiply-adds, the kernel's own sum over d_state in
# two lanes' partials) and exp as ex2.approx of a pre-scaled argument
MAMBA_RTOL = 1e-5
# jamba-v0.1-52b as served (configs.SERVED: every FFN the dense SwiGLU, its
# MoE layers wait for ROADMAP A13b); Z4's prompts
JAMBA = "jamba-v0.1-52b"
SERVED_CUTS = (16, 23, 33)
HEADLINE = "pool23"           # the shape whose numbers head each kernel's entry
# each codec kernel's launches in phases 4-5: 3 cuts x (1 + 3 timed) in the
# eager and again in the fused infer, 3 in each frame chain, 4 clients, and
# 1 + 1 in the one-client infer
VGG_CODEC_LAUNCHES = 36
# Logits of the ae8 chain against the same chain through the plain versions,
# relative to max |logit|.  The kernels sum in another order than cuBLAS, so
# a latent that sits at a rounding tie of z / s may take the neighbouring
# code; each such code moves the decoded activation by one step s.
LOGIT_RTOL = 1e-2
# Z4 / Z5: each decode step's logits against one full forward over the same
# tokens, relative to max |logit|: within ZOO_RTOL, or within ULP_FACTOR times
# the forward's own response to one rounding at its input (the last bit of
# every embedding entry flipped), whichever is larger.  The decode path
# rounds otherwise than the forward (one-token against whole-prompt products
# on the card; on the CPU rwkv6's bf16 decode equals its forward bit for bit,
# tests/test_torch_zoo.py), and a random-weight rwkv6-1.6b amplifies a
# rounding some 1e5-fold through its 24 layers, so its logits cannot be held
# tighter than that response.  A fault in the decode path moves them by far
# more.  ULP_FACTOR: the decode-forward gap was 0.3-1.4x the response on
# the CPU (f32, depths 2 and 6) and 0.24-0.89x on an H100 (full depth).
ZOO_RTOL = {"float32": 1e-3, "bfloat16": 1e-2}
ULP_FACTOR = 2.0
# Z11: VGG16's Table II at batch 16 as the reference computes it
# (``repro.core.stats.totals(vgg16(), params, 16)``, params from
# ``jax.eval_shape``; tests/test_torch_stats.py holds these to it), which the
# port's ``stats.totals`` must equal: this machine has no JAX
VGG16_TOTALS_16 = {"total_params": 138357544, "trainable_params": 138357544,
                   "mult_adds_G": 247.52422912, "fwd_bwd_MB": 1749.74853515625,
                   "input_MB": 9.1875, "params_MB": 527.7921447753906,
                   "total_MB": 2286.7281799316406}
# Z11 / Z12: the split-point search and the bottleneck training of the
# paper's main path (paper §III, Eqs. 1-4), on phase 4's full-width VGG16,
# as Study.candidates and Study.bottlenecks run them
# (repro/api/study.py:294-370); the data is the port's copy of
# data/synthetic.py at seed 0, toy images at 224 x 224
SEARCH_IMAGES = 16
TOP_N = 3                     # Study.candidates' default
# the card's CS curve against the CPU's on the same weights and the first
# REPLAY_BATCH images, on the normalised curve: both f32 in other orders
# (cuDNN and oneDNN convolutions, their backward passes), some 1e-6 apart
CS_ATOL = 1e-4
AE_STEPS, AE_BATCH, AE_LR, AE_RATE, AE_SEED = 50, 8, 5e-4, 0.5, 0
FINETUNE_STEPS, FINETUNE_CUT = 3, 23
# each loss of the first steps on the card against the same steps on the
# CPU from the same start, relative
REPLAY_BATCH, AE_REPLAY_STEPS, FINETUNE_REPLAY_STEPS = 2, 3, 2
TRAIN_RTOL = 1e-4
# finetune's backward on the card: at each replayed step, from the card's own
# state, the card's gradient against the CPU's gradient of the same state and
# batch, leaf by leaf over the leaf's max |g|.  Sound f32 gradients part by up
# to 4.4e-3 there (PR 25: the CPU's own distance from a float64 gradient); a
# leaf the card gets wrong or leaves at zero reads about 1
GRAD_RTOL = 2e-2
# the timed finetune against ``finetune`` on the CPU from the same start and
# batches, both run free: each loss, and the loss of each one's final state
# on a batch neither saw, relative.  Adam's first steps move a weight by about
# +-lr wherever |g| >> eps, so a weight whose gradient is rounding-sized
# steps either way and the runs part: PR 25 saw 4.1e-4 at the second loss
# (batch 2, runs 1-6), 1.0e-4 and 4.8e-5 at the second and third (batch 8,
# run 7).  A state left unchanged reads about 0.5 at the second loss
FREE_RTOL = 1e-2
DEPLOY_DATA_SEED = 10_000     # a batch no training step saw
# Z13 / Z14: the paper's simulator (§IV, Figs. 3-4) and its hardware-in-the-loop
# calibration on phase 4's VGG16 with Z12's AEs, as twins of
# benchmarks/bench_protocol.py (its channel, loss rates, image seed and frame
# count), bench_split_latency.py and bench_runtime.py
SIM_IMAGES, SIM_IMAGE_SEED, SIM_FRAMES = 64, 777, 8
SIM_LOSSES = (0.0, 0.05, 0.1, 0.2, 0.3)
SIM_CHANNEL = {"latency_s": 100e-6, "capacity_bps": 1e9, "interface_bps": 1e9, "seed": 11}
# each flow's FLOP-count times and payload against the same from the CPU copy
# of the weights: the same integers and numpy arithmetic
SIM_REL = 1e-12
# the simulator's own inference of the first SIM_HOLD_IMAGES images on the card
# against the CPU's with the same masks, relative to max |logit|: Z11's bar for
# f32 summed in another order (its readings were about 2e-6)
SIM_HOLD_IMAGES, SIM_LOGIT_RTOL = 2, 1e-4
UDP_LATENCY_SPREAD = 0.2      # bench_protocol.py's fig4.udp.latency_flat
CAL_BATCH, CAL_ITERS = 8, 3
CAL_CUTS = ("relu1", "pool16", "pool23", "fc0_relu")
CAL_PRICED = ("relu1", "pool23", "pool16")
CAL_LEFT_OUT = "relu3"        # priced analytically: not in the grid
SIM_CAL_LOSSES = (0.0, 0.1)
# each codec kernel's launches in Z14's calibrate, at each cut with an AE:
# compress in the eager encode and in the fused edge segment, decompress in
# the eager decode and in the fused server leg, each a warm-up and CAL_ITERS
# timed calls (runtime/calibrate.py, runtime/engine.timeit_blocked)
CAL_CODEC_LAUNCHES_PER_AE_CUT = 2 * (1 + CAL_ITERS)
# Z15: fault recovery in the split runtime, a twin of
# benchmarks/bench_faults.py:69-160 at full width: its requests (batch 1,
# numpy seed 0), channel, chaos plan and policy, blackout plan and policy;
# each infer times every leg once after a warm-up (iters=1), as the bench does
FAULT_REQUESTS, FAULT_ITERS = 16, 1
FAULT_CHANNEL = {"latency_s": 2e-3, "capacity_bps": 50e6, "interface_bps": 100e6, "seed": 0}
CHAOS_PLAN = {"seed": 7, "drop_rate": 0.35, "corrupt_rate": 0.25, "straggle_rate": 0.1,
              "straggle_s": 0.01}
CHAOS_POLICY = {"max_attempts": 6, "deadline_s": 5.0, "downgrade_after": 2}
BLACKOUT_PLAN = {"seed": 1, "blackouts": ((0.0, 1e9),)}
BLACKOUT_POLICY = {"max_attempts": 3}
# a degraded request's logits against the unsplit forward, relative to max
# |logit|: the int8 rung quantises the raw activation per row (no kernel), a
# code step of 1/127 of the row's max; the f32 rung and the local fallback
# carry the activation exactly
RUNG_RTOL = {"int8": LOGIT_RTOL, "f32": 1e-5, "local": 1e-5}
# the 4-slot tail server at the pool23 cut: 8 clients, the frames of the
# clients in SERVER_CORRUPT corrupted, steps at SERVER_STEPS_AT on the
# virtual clock against SERVER_BLACKOUT
SERVER_CLIENTS, SERVER_CORRUPT = 8, (2, 5)
SERVER_BLACKOUT = ((1.0, 2.0),)
SERVER_STEPS_AT = (1.2, 1.9, 2.0, 2.5, 3.0)
# Z16: the fleet layers, twins of examples/fleet_planning.py (its three
# device classes, its 1000-request diurnal trace at 400 req/s, its search
# grid and QoS) and examples/adaptive_replanning.py (its --quick phases and
# controller config), on phase 4's VGG16 with Z12's AEs, Z13's 64 images and
# Z14's calibration table as the cost model
FLEET_MIX = (("mcu", {"latency_s": 2e-3, "capacity_bps": 10e6, "interface_bps": 10e6,
                      "loss_rate": 0.08, "seed": 1}, 2.0),
             ("edge-embedded", {"latency_s": 5e-4, "capacity_bps": INTERFACES["fast-ethernet"],
                                "interface_bps": INTERFACES["fast-ethernet"], "loss_rate": 0.02,
                                "seed": 2}, 1.5),
             ("edge-accelerator", {"latency_s": 1e-4, "capacity_bps": INTERFACES["gigabit"],
                                   "interface_bps": INTERFACES["gigabit"], "seed": 3}, 1.0))
FLEET_REQUESTS, FLEET_RATE_HZ, FLEET_SEED = 1000, 400.0, 42
FLEET_QOS = {"max_latency_s": 0.05, "min_accuracy": 0.5}
FLEET_FRAMES = 8
# hold (b): the card's plan points against a CPU planner's, both over the
# first FLEET_HOLD_IMAGES images: latencies and rates to 1e-9 relative (the
# same numpy arithmetic from the same cost table; accuracy on the same argmax)
FLEET_HOLD_IMAGES, FLEET_REL = 2, 1e-9
RUSH_PHASES = ((1.0, 20000.0), (4.0, 1500.0))
RUSH_CHANNEL = {"latency_s": 1e-4, "capacity_bps": 100e6, "interface_bps": 100e6, "seed": 1}
RUSH_CONFIG = {"control_period_s": 0.25, "drift_threshold": 0.3, "min_improvement": 0.05,
               "warmup_s": 0.02, "max_switches": 4}


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS, exps: float = 0) -> tuple:
    """The least time of the work in ms and what sets it: the bytes at the
    HBM rate, the operations at ``peak`` or the exponentials on the SFUs."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / peak,
             "sfu": exps / SFU_EXP_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def check_ptxas(name, log) -> None:
    """Every kernel function in ``log`` (``-Xptxas -v``) spills nothing and
    uses fewer than 255 registers."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    if not regs or max(regs) >= 255 or any(spills):
        raise AssertionError(f"{name}: registers {regs}, spill bytes {spills}")


def call_ms(fn, budget_ms: float = 30.0) -> float:
    """Mean time of one call as a caller pays it: CUDA events around a run
    of eager calls, so where the host takes longer to issue a call than the
    card to run it, this is the host's time."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(5, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so no host work sits between the launches.  The inputs stay
    in L2 where they fit in its 50 MB, as they do on the served path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


_FLUSH = []


def flushed_ms(fn) -> float:
    """Device time of one call with L2 cold: each call, in a replayed CUDA
    graph, follows a write of a buffer larger than the 50 MB L2, and that
    write, timed alone the same way, is taken off."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    flush = _FLUSH[0].zero_
    return device_ms(lambda: (flush(), fn())) - device_ms(flush)


def main_path_shapes(model, params) -> list:
    """(label, N, C, L) of the wire codec at each VGG16 cut, batch 8."""
    acts = model.activation_shapes(params, BATCH)
    out = []
    for label, cut in VGG_CUTS.items():
        shape = acts[cut]
        c = shape[-1]
        out.append((label, int(np.prod(shape[:-1])), c, latent_channels(c, 0.5)))
    return out + EXTRA_SHAPES


def check_tiles(kernel, label, run, want, dims) -> dict:
    """Run ``run(tile)`` on every codec tile: each result is held to the
    plain version by ``want(out)`` (which raises past its bar and returns
    the row's error fields) and to every other tile's bit for bit, and
    timed by replay with L2 warm, L2-flushed, and (the picked tile) as a
    caller pays it."""
    n, k, m = dims
    picked = tiles.pick_tile(n, k, m, tiles.sm_count(0))
    e, outs = {"shape": label, "picked": picked}, {}
    for t in tiles.TILES:
        outs[t] = run(t)
        torch.cuda.synchronize()
        for key, v in want(t, outs[t]).items():
            e[f"{t}_{key}"] = v
        e[f"{t}_ms"] = device_ms(lambda t=t: run(t))
        e[f"{t}_flushed_ms"] = flushed_ms(lambda t=t: run(t))
    for t, out in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(out, outs[picked])):
            raise AssertionError(f"{kernel}[{t}] at {label} differs from [{picked}] in some bit")
    e["fastest"] = min(tiles.TILES, key=lambda t: e[f"{t}_ms"])
    e["picked_over_fastest"] = e[f"{picked}_ms"] / e[f"{e['fastest']}_ms"]
    e["max_abs_err"] = e[f"{picked}_max_abs_err"]
    e["ms"], e["flushed_ms"] = e[f"{picked}_ms"], e[f"{picked}_flushed_ms"]
    e["call_ms"] = call_ms(lambda: run(picked))
    return e


def check_compress(label, n, c, l, gen) -> dict:
    f = torch.randn((n, c), generator=gen, device="cuda").abs()
    w = torch.randn((c, l), generator=gen, device="cuda") / c ** 0.5
    b = 0.1 * torch.randn((l,), generator=gen, device="cuda")
    qr, sr = ref.bottleneck_compress_ref(f, w, b)

    def want(t, out):
        q, s = out
        dq = (q.int() - qr.int()).abs()
        if int(dq.max()) > 1:
            raise AssertionError(f"compress[{t}] at {label}: a code is off by {int(dq.max())}")
        s_rel = float(((s - sr).abs() / sr).max())
        if s_rel > 1e-5:
            raise AssertionError(f"compress[{t}] at {label}: scale rel err {s_rel}")
        return {"code_mismatch_frac": float((dq > 0).float().mean()), "scale_rel_err": s_rel,
                "max_abs_err": float((q.float() * s - qr.float() * sr).abs().max())}
    e = {"shape": label, "N": n, "C": c, "L": l,
         **check_tiles("compress", label, lambda t: comp.bottleneck_compress(f, w, b, tile=t),
                       want, (n, c, l))}
    plain = lambda: ref.bottleneck_compress_ref(f, w, b)  # noqa: E731
    library = lambda: torch.addmm(b, f, w)  # noqa: E731
    e["plain_ms"], e["plain_flushed_ms"] = device_ms(plain), flushed_ms(plain)
    e["library_ms"], e["library_flushed_ms"] = device_ms(library), flushed_ms(library)
    e["bound_ms"], e["bound_by"] = bound_ms(4 * (n * c + c * l + l + n) + n * l,
                                            2 * n * c * l)
    return e


def check_decompress(label, n, c, l, gen) -> dict:
    q = torch.randint(-127, 128, (n, l), generator=gen, device="cuda").to(torch.int8)
    s = 1e-3 + 0.1 * torch.rand((n, 1), generator=gen, device="cuda")
    w = torch.randn((l, c), generator=gen, device="cuda") / l ** 0.5
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    expect = ref.bottleneck_decode_ref(q, s, w, b)
    top = float(expect.abs().max())

    def want(t, out):
        err = float((out[0] - expect).abs().max())
        if err > 1e-4 * top:
            raise AssertionError(f"decompress[{t}] at {label}: max err {err}, max |out| {top}")
        return {"max_abs_err": err, "rel_err": err / top}
    e = {"shape": label, "N": n, "L": l, "C": c,
         **check_tiles("decompress", label,
                       lambda t: (decomp.bottleneck_decompress(q, s, w, b, tile=t),),
                       want, (n, l, c))}
    z = q.float() * s
    plain = lambda: ref.bottleneck_decode_ref(q, s, w, b)  # noqa: E731
    library = lambda: torch.addmm(b, z, w)  # noqa: E731
    e["plain_ms"], e["plain_flushed_ms"] = device_ms(plain), flushed_ms(plain)
    e["library_ms"], e["library_flushed_ms"] = device_ms(library), flushed_ms(library)
    e["bound_ms"], e["bound_by"] = bound_ms(n * l + 4 * (n + l * c + c + n * c),
                                            2 * n * l * c)
    return e


def frames_eager(part, x) -> tuple:
    """The wire frames and logits of the eager chain."""
    frames, cur = [], x
    for k in range(part.n_stages):
        cur = part.stage(k)(cur)
        if k == len(part.splits):
            return frames, cur
        ae = part.ae_map.get(part.splits[k])
        frames.append(W.to_bytes(W.encode_activation(cur, ae)))
        cur = W.decode_activation(W.from_bytes(frames[-1]), ae, device=part.device)


def frames_fused(part, x) -> tuple:
    """The wire frames and logits of the fused segment chain."""
    segs, kinds = part.fused_segments(), part.wire_kinds()
    frames, out = [], segs[0](x)
    for k in range(len(part.splits)):
        frames.append(W.frame_arrays(kinds[k], *out))
        out = segs[k + 1](W.parse_arrays(frames[-1], device=part.device))
    return frames, out


def plain_chain(model, params, aes, x, cuts=SERVED_CUTS) -> torch.Tensor:
    """The ae8 chain at ``cuts`` with the plain versions in place of the kernels."""
    bounds = (0,) + tuple(c + 1 for c in cuts) + (len(model.layers),)
    cur = x
    with torch.inference_mode():
        for k, (a, b) in enumerate(zip(bounds, bounds[1:])):
            cur = model.apply_range(params, cur, a, b)
            if k == len(cuts):
                return cur
            ae = aes[cuts[k]]
            shape = cur.shape
            q, s = ref.bottleneck_compress_ref(cur.reshape(-1, shape[-1]), ae["enc"]["w"],
                                               ae["enc"]["b"])
            cur = ref.bottleneck_decode_ref(q, s, ae["dec"]["w"], ae["dec"]["b"]).reshape(shape)


def serve(model, params, x) -> dict:
    """Phases 4-5 on the card; returns what they measured."""
    acts = model.activation_shapes(params, 1)
    aes = {c: B.init_bottleneck(100 + c, acts[c][1:], 0.5, device="cuda")
           for c in SERVED_CUTS}
    out = {}
    eager = SplitRuntime(model, params, SERVED_CUTS, ae=aes, device="cuda")
    fused = SplitRuntime(model, params, SERVED_CUTS, ae=aes, fused=True, device="cuda")
    r_eager, r_fused = eager.infer(x), fused.infer(x)
    if not np.array_equal(r_eager.logits, r_fused.logits):
        raise AssertionError("eager and fused logits differ")
    fe, le = frames_eager(eager.part, x)
    ff, lf = frames_fused(eager.part, x)
    if fe != ff or not torch.equal(le, lf):
        raise AssertionError("eager and fused wire frames differ")
    if not np.array_equal(le.cpu().numpy(), r_eager.logits):
        raise AssertionError("the runtime's logits differ from a plain run of its chain")
    plain = plain_chain(model, params, aes, x).cpu().numpy()
    rel = float(np.abs(r_eager.logits - plain).max() / np.abs(plain).max())
    if not np.isfinite(r_eager.logits).all() or rel > LOGIT_RTOL:
        raise AssertionError(f"ae8 logits off the plain chain by {rel} (bar {LOGIT_RTOL})")
    out["ae8"] = {"cuts": list(SERVED_CUTS), "frame_bytes": [len(f) for f in fe],
                  "logit_rel_err_vs_plain": rel,
                  "eager_total_ms": 1e3 * r_eager.compute_s,
                  "fused_total_ms": 1e3 * r_fused.compute_s,
                  "eager_stage_ms": [1e3 * s for s in r_eager.stage_s],
                  "fused_stage_ms": [1e3 * s for s in r_fused.stage_s],
                  "eager_hop_encode_decode_ms": [(1e3 * h["encode_s"], 1e3 * h["decode_s"])
                                                 for h in r_eager.hops],
                  "fused_hop_frame_parse_ms": [(1e3 * h["encode_s"], 1e3 * h["decode_s"])
                                               for h in r_fused.hops]}

    int8 = SplitRuntime(model, params, 16, device="cuda")
    r_int8 = int8.infer(x)
    full = int8.reference(x)
    agree = float((r_int8.logits.argmax(-1) == full.argmax(-1)).mean())
    if agree != 1.0:
        raise AssertionError(f"int8 split at pool16 agrees in argmax on {agree} of the batch")
    out["int8_pool16"] = {"argmax_agreement": agree, "total_ms": 1e3 * r_int8.compute_s,
                          "wire_bytes": r_int8.wire_bytes}

    # phase 5: four clients of two images each, one 4-slot tail server
    t0 = time.perf_counter()
    clients = [x[2 * i:2 * i + 2] for i in range(4)]
    results, server = run_clients(model, params, 23, clients, ae=aes[23], n_slots=4,
                                  device="cuda")
    wall_ms = 1e3 * (time.perf_counter() - t0)
    if sorted(results) != [0, 1, 2, 3]:
        raise AssertionError(f"clients answered: {sorted(results)}")
    one = SplitRuntime(model, params, 23, ae=aes[23], device="cuda").infer(x, iters=1)
    got = np.concatenate([results[i] for i in range(4)])
    rel = float(np.abs(got - one.logits).max() / np.abs(one.logits).max())
    if got.shape != (BATCH, 1000) or not np.isfinite(got).all() or rel > LOGIT_RTOL:
        raise AssertionError(f"served logits {got.shape} off a one-client run by {rel}")
    out["clients"] = {"n_clients": 4, "n_slots": 4, "n_batches": server.n_batches,
                      "n_served": server.n_served, "wall_ms": wall_ms,
                      "logit_rel_err_vs_one_client": rel}
    return out


def card_runs(fn, n=5) -> tuple:
    """``fn`` once to warm up, then ``n`` times, each timed by CUDA events
    (up to its own synchronisation); returns (ms each, results)."""
    fn()
    times, results = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results.append(fn())
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, results


def to_cpu(tree):
    return tree_map(torch.Tensor.cpu, tree)


def search(model, params, params_cpu) -> dict:
    """Z11: Table I/II, the CS curve over the 18 feature ops and the
    candidates ranked from it, as ``Study.candidates`` does
    (repro/api/study.py:323-341): the curve's legal maxima, else the legal
    cuts with the highest CS.  No kernel of the port is on this path."""
    rows = stats.summary(model, params, SEARCH_IMAGES)
    table = stats.totals(model, params, SEARCH_IMAGES)
    print(stats.format_table(rows), flush=True)
    print("Table II", json.dumps(table), flush=True)
    if table != VGG16_TOTALS_16:
        raise AssertionError(f"Table II {table} differs from the reference's {VGG16_TOTALS_16}")
    xs, ys = toy_images(SEARCH_IMAGES, hw=224, seed=0)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    idx = feature_index(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, curves = card_runs(lambda: cumulative_saliency(model, params, x, y, layer_idx=idx))
    check_launches("Z11 search", launch_counts(), {})
    out = {"images": SEARCH_IMAGES, "layer_idx": idx, "cs_ms": float(np.median(times)),
           "cs_ms_runs": times, "cs_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launch_counts()}
    cs = curves[0]
    if cs.shape != (len(idx),) or not np.isfinite(cs).all():
        raise AssertionError(f"CS curve {cs}")
    out["cs_curve"] = cs.tolist()
    out["cs_spread_card"] = float(max(np.abs(c - cs).max() for c in curves))
    # the CPU path on the same weights and the first images
    card = cumulative_saliency(model, params, x[:REPLAY_BATCH], y[:REPLAY_BATCH], layer_idx=idx)
    cpu = cumulative_saliency(model, params_cpu, x[:REPLAY_BATCH].cpu(), y[:REPLAY_BATCH].cpu(),
                              layer_idx=idx)
    out["cs_card_vs_cpu"] = float(np.abs(card - cpu).max())
    if out["cs_card_vs_cpu"] > CS_ATOL:
        raise AssertionError(f"CS curve on the card off the CPU's by {out['cs_card_vs_cpu']} "
                             f"(bar {CS_ATOL})")
    points = candidate_split_points(model, cs, idx, top_n=TOP_N)
    out["peaks"] = points
    if not points:
        ranked = sorted(legal_split_candidates(model, cs, idx), key=lambda c: -c.accuracy_proxy)
        points = [c.split_layer for c in ranked[:TOP_N]]
    out["candidates"] = [(c.label, c.accuracy_proxy) for c in rank_candidates(cs, idx, points)]
    out["top_sc"] = points[0]
    return out


def batches(n, batch) -> list:
    """The first ``n`` batches of ``toy_image_iter`` (seed 0), made before
    timing."""
    it = toy_image_iter(batch, hw=224, seed=0)
    return [next(it) for _ in range(n)]


def train_at(model, params, params_cpu, cut) -> tuple:
    """Z12, stage 1 (Eq. 3) at ``cut``: ``train_bottleneck`` for AE_STEPS;
    the loss must fall.  Its first steps again on the card and on the CPU
    from the card's initial AE at REPLAY_BATCH images.  Returns (AE, row)."""
    data = batches(AE_STEPS + 1, AE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ae, losses = B.train_bottleneck(model, params, cut, iter(data), AE_STEPS, AE_LR, AE_RATE,
                                    AE_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches(f"Z12 train at {cut}", launch_counts(), {})
    row = {"cut": cut, "layer": model.layers[cut].name, "steps": AE_STEPS, "batch": AE_BATCH,
           "step_ms": 1e3 * wall / AE_STEPS, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1], "losses": losses}
    if not np.isfinite(losses).all() or np.mean(losses[-5:]) >= np.mean(losses[:5]):
        raise AssertionError(f"Z12 AE at {cut}: the loss does not fall: {losses}")
    feat = tuple(model.activation_shapes(params, 1)[cut][1:])
    ae0 = B.init_bottleneck(AE_SEED, feat, AE_RATE, device="cuda")
    small = [(x[:REPLAY_BATCH], y[:REPLAY_BATCH]) for x, y in data[1:1 + AE_REPLAY_STEPS]]
    _, card = B.train_bottleneck_from(model, params, cut, ae0, iter(small), AE_REPLAY_STEPS,
                                      AE_LR, device="cuda")
    _, cpu = B.train_bottleneck_from(model, params_cpu, cut, to_cpu(ae0), iter(small),
                                     AE_REPLAY_STEPS, AE_LR, device="cpu")
    row["replay_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if not np.isfinite(card).all() or row["replay_rel_err"] > TRAIN_RTOL:
        raise AssertionError(f"Z12 AE at {cut}: losses {card} on the card, {cpu} on the CPU "
                             f"(bar {TRAIN_RTOL} relative)")
    return ae, row


def leaf_gap(got, want) -> float:
    """The largest gap of two nests, leaf by leaf, over the leaf's max |want|."""
    return max(float((a.cpu() - b.cpu()).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def finetune_replay(model, params, ae, small) -> dict:
    """Finetune's first steps at REPLAY_BATCH images on the card, each held
    to the CPU from the card's own state: the same loss (TRAIN_RTOL,
    relative) and the same gradient (GRAD_RTOL of each leaf's max).  A
    free-running replay cannot hold TRAIN_RTOL: Adam's first step sends a
    weight whose gradient is rounding-sized +-lr either way."""
    state = {"params": params, "ae": ae}
    opt = adam_init(state)
    gaps = {"loss": 0.0, "grad": 0.0}
    for x, y in small:
        def loss_on(dev):
            xt = torch.as_tensor(x, device=dev, dtype=torch.float32)
            yt = torch.as_tensor(y, device=dev)
            return lambda st: B.task_loss(model, st["params"], st["ae"], FINETUNE_CUT, xt, yt)
        loss, g = B.value_and_grad(loss_on("cuda"), state)
        loss_cpu, g_cpu = B.value_and_grad(loss_on("cpu"), to_cpu(state))
        gaps["loss"] = max(gaps["loss"], abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)))
        gaps["grad"] = max(gaps["grad"], leaf_gap(g, g_cpu))
        del g_cpu
        state, opt = adam_update(state, g, opt, AE_LR)
    if gaps["loss"] > TRAIN_RTOL or gaps["grad"] > GRAD_RTOL:
        raise AssertionError(f"Z12 finetune replay: gaps {gaps} (bars {TRAIN_RTOL} for the loss, "
                             f"{GRAD_RTOL} for the gradient)")
    return gaps


def finetune_at(model, params, params_cpu, ae) -> dict:
    """Z12, stage 2 (Eq. 4) at FINETUNE_CUT: ``finetune`` of backbone and AE
    for FINETUNE_STEPS, timed and held to ``finetune`` on the CPU from the
    same start (FREE_RTOL); then its first steps' gradients
    (``finetune_replay``)."""
    data = batches(FINETUNE_STEPS, AE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tuned, tuned_ae, losses = B.finetune(model, params, ae, FINETUNE_CUT, iter(data),
                                         FINETUNE_STEPS, AE_LR, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("Z12 finetune", launch_counts(), {})
    row = {"cut": FINETUNE_CUT, "steps": FINETUNE_STEPS, "batch": AE_BATCH,
           "step_ms": 1e3 * wall / FINETUNE_STEPS,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses}
    cpu_tuned, cpu_ae, cpu_losses = B.finetune(model, params_cpu, to_cpu(ae), FINETUNE_CUT,
                                               iter(data), FINETUNE_STEPS, AE_LR, device="cpu")
    xs, ys = toy_images(AE_BATCH, hw=224, seed=DEPLOY_DATA_SEED)
    with torch.no_grad():
        after = [float(B.task_loss(model, p, a, FINETUNE_CUT, torch.from_numpy(xs).to(dev),
                                   torch.from_numpy(ys).to(dev)))
                 for p, a, dev in ((tuned, tuned_ae, "cuda"), (cpu_tuned, cpu_ae, "cpu"))]
    row["loss_after"] = after[0]
    row["free_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(losses + after[:1],
                                                               cpu_losses + after[1:])]
    if not np.isfinite(losses + after).all() or max(row["free_rel_err"]) > FREE_RTOL:
        raise AssertionError(f"Z12 finetune: {row} against the CPU's losses {cpu_losses} and "
                             f"{after[1]} after (bar {FREE_RTOL} relative)")
    del tuned, tuned_ae, cpu_tuned, cpu_ae
    small = [(x[:REPLAY_BATCH], y[:REPLAY_BATCH]) for x, y in data[:FINETUNE_REPLAY_STEPS]]
    row["replay_rel_err"] = finetune_replay(model, params, ae, small)
    torch.cuda.empty_cache()
    return row


def deploy(model, params, aes) -> dict:
    """Z12, deploy: a ``SplitRuntime`` at each trained cut with its AE and
    the int8 wire.  Each codec kernel launches twice a cut (``infer`` with
    iters=1: a warm-up and a timed call of each hop); the logits are held
    to the same chain through the plain versions, and their top-1
    agreement with the unsplit model is printed, not held."""
    x = torch.from_numpy(toy_images(BATCH, hw=224, seed=DEPLOY_DATA_SEED)[0]).cuda()
    out = {}
    reset_launches()
    for cut, ae in aes.items():
        rt = SplitRuntime(model, params, cut, ae=ae, quantize=True, device="cuda")
        r = rt.infer(x, iters=1)
        plain = plain_chain(model, params, {cut: ae}, x, cuts=(cut,)).cpu().numpy()
        rel = float(np.abs(r.logits - plain).max() / np.abs(plain).max())
        if r.logits.shape != (BATCH, 1000) or not np.isfinite(r.logits).all() or rel > LOGIT_RTOL:
            raise AssertionError(f"Z12 deploy at {cut}: logits off the plain chain by {rel} "
                                 f"(bar {LOGIT_RTOL})")
        full = rt.reference(x)
        out[model.layers[cut].name] = {
            "cut": cut, "wire_bytes": r.wire_bytes, "logit_rel_err_vs_plain": rel,
            "top1_agreement_with_unsplit": float((r.logits.argmax(-1) == full.argmax(-1)).mean()),
            "total_ms": 1e3 * r.compute_s}
    out["launches"] = launch_counts()
    check_launches("Z12 deploy", out["launches"],
                   {"bottleneck_compress": 2 * len(aes), "bottleneck_decompress": 2 * len(aes)})
    return out


def simulate_fig4(model, params, params_cpu, aes) -> tuple:
    """Z13: ``ApplicationSimulator`` over TCP and UDP at SIM_LOSSES for each
    configuration, on SIM_IMAGES toy images labelled with the unsplit
    model's own argmax (random weights: "accuracy" is agreement with it).
    Holds (a) each flow's analytic times and payload to the CPU copy's, (b)
    at the lowest and highest loss the simulator's inference of the first
    images on the card to the CPU's with the same masks, (c) TCP agreement
    equal at every loss, (d) TCP latency rising with loss, (e) UDP latency
    within UDP_LATENCY_SPREAD.  No kernel runs.  Returns (images, labels)."""
    xs, _ = toy_images(SIM_IMAGES, hw=224, seed=SIM_IMAGE_SEED)
    with torch.inference_mode():
        ys = model.apply(params, torch.from_numpy(xs).cuda()).argmax(-1).cpu().numpy()
    input_bytes = int(np.prod(xs.shape[1:])) * 4
    scenarios = {"LC": (Scenario("LC"), None), "RC": (Scenario("RC"), None)}
    scenarios.update({f"SC@{model.layers[cut].name}": (Scenario("SC", SplitPlan(cut)), ae)
                      for cut, ae in aes.items()})
    reset_launches()
    rows, cpu_logits = [], {}
    for name, (sc, ae) in scenarios.items():
        want = scenario_times_and_payload(sc, model, params_cpu, input_bytes)
        for proto in ("tcp", "udp"):
            for p in SIM_LOSSES:
                net = NetworkConfig(proto, Channel(loss_rate=p, **SIM_CHANNEL))
                sim = ApplicationSimulator(model, params, net, ae=ae, device="cuda")
                t0 = time.perf_counter()
                flow = measure_flow(sc, net, model, params, input_bytes, n_frames=SIM_FRAMES)
                v = sim.simulate(sc, xs, ys, flow=flow)
                row = {"scenario": name, "protocol": proto, "loss": p,
                       "latency_ms": 1e3 * v.latency_s, "wire_bytes": v.meta["wire_bytes"],
                       "mean_tx": v.meta.get("mean_tx"), "agreement": v.accuracy,
                       "sim_s": time.perf_counter() - t0}
                for k in ("edge_s", "server_s", "wire_bytes"):
                    if not math.isclose(flow[k], want[k], rel_tol=SIM_REL, abs_tol=0):
                        raise AssertionError(f"Z13 {name} {proto} {p}: {k} {flow[k]} against "
                                             f"{want[k]} from the CPU copy (bar {SIM_REL})")
                if p in (SIM_LOSSES[0], SIM_LOSSES[-1]):
                    lossy = proto == "udp" and sc.kind != "LC"
                    masks = (sim.loss_masks(sc, flow["frames"], SIM_HOLD_IMAGES, xs.shape[1:])
                             if lossy else None)
                    key = (name, proto, p) if lossy else name
                    if key not in cpu_logits:
                        cpu_sim = ApplicationSimulator(
                            model, params_cpu, net, device="cpu",
                            ae=None if ae is None else to_cpu(ae))
                        cpu_logits[key] = cpu_sim.predict(sc, xs[:SIM_HOLD_IMAGES], masks)
                    card = sim.predict(sc, xs[:SIM_HOLD_IMAGES], masks)
                    cpu = cpu_logits[key]
                    gap, scale = float(np.abs(card - cpu).max()), float(np.abs(cpu).max())
                    row["card_vs_cpu"] = gap / scale if scale > 0 else gap
                    if not (np.isfinite(card).all() and row["card_vs_cpu"] <= SIM_LOGIT_RTOL):
                        raise AssertionError(f"Z13 {name} {proto} {p}: logits on the card off "
                                             f"the CPU's by {row['card_vs_cpu']} "
                                             f"(bar {SIM_LOGIT_RTOL})")
                rows.append(row)
                print("Z13 simulate", json.dumps(row), flush=True)
    check_launches("Z13 simulate", launch_counts(), {})
    for name in scenarios:
        tcp = [r for r in rows if r["scenario"] == name and r["protocol"] == "tcp"]
        udp = [r for r in rows if r["scenario"] == name and r["protocol"] == "udp"]
        if len({r["agreement"] for r in tcp}) != 1:
            raise AssertionError(f"Z13 {name}: TCP agreement moves with loss: {tcp}")
        if name != "LC" and not tcp[-1]["latency_ms"] > tcp[0]["latency_ms"]:
            raise AssertionError(f"Z13 {name}: TCP latency does not grow with loss: {tcp}")
        lat0, lat1 = udp[0]["latency_ms"], udp[-1]["latency_ms"]
        if abs(lat1 - lat0) > UDP_LATENCY_SPREAD * lat0:
            raise AssertionError(f"Z13 {name}: UDP latency {lat0} -> {lat1} ms moves by more "
                                 f"than {UDP_LATENCY_SPREAD} of it")
        print(f"Z13 {name}: UDP agreement by loss {[r['agreement'] for r in udp]}, "
              f"falls: {udp[-1]['agreement'] < udp[0]['agreement']}", flush=True)
    return xs, ys


def calibrate_hil(model, params, aes, xs, ys) -> tuple:
    """Z14: ``calibrate`` (fused) at CAL_BATCH over CAL_CUTS, the trained AEs
    at their cuts; the codec kernels' launches held to the count worked out
    from the code, every time finite and positive, each cut's frame length,
    the JSON round trip.  Then the measured cells priced through
    ``measure_flow`` with a CostStack over the analytic model (held
    "measured", and "analytic" at CAL_LEFT_OUT), printed against the
    analytic ``server-gpu`` profile, fed to the simulator over TCP; and
    ``HILPlatform.measure`` of the unsplit forward beside the LC entry.
    Returns (what it measured, the table)."""
    names = {layer.name: i for i, layer in enumerate(model.layers)}
    cuts = [names[n] for n in CAL_CUTS]
    ae_map = {c: ae for c, ae in aes.items() if c in cuts}
    # the images calibrate would draw itself (numpy, seed 0), kept for the checks
    x = np.random.default_rng(0).standard_normal(
        (CAL_BATCH,) + tuple(model.input_shape)).astype(np.float32)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    table = calibrate(model, params, cuts, ae_map=ae_map, x=x, iters=CAL_ITERS, fused=True,
                      device="cuda")
    out = {"batch": table.batch, "cuts": {model.layers[c].name: c for c in cuts},
           "calibrate_s": time.perf_counter() - t0, "launches": launch_counts()}
    n = CAL_CODEC_LAUNCHES_PER_AE_CUT * len(ae_map)
    check_launches("Z14 calibrate", out["launches"],
                   {"bottleneck_compress": n, "bottleneck_decompress": n})
    xt = torch.from_numpy(x).cuda()
    entries = {}
    for key, e in table.entries.items():
        kind, _, split = key.partition("@")
        timed = {"LC": [e.head_s], "RC": [e.tail_s]}.get(
            kind, [e.head_s, e.tail_s, e.encode_s, e.decode_s, e.fused_edge_s, e.fused_server_s])
        if not all(math.isfinite(t) and t > 0 for t in timed):
            raise AssertionError(f"Z14 {key}: times {e}")
        entries[key] = {k: 1e3 * v if k.endswith("_s") else v
                        for k, v in dataclasses.asdict(e).items()}
        if kind == "SC":
            cut = int(split)
            with torch.inference_mode():
                f = model.apply_range(params, xt, 0, cut + 1)
                frame = W.to_bytes(W.encode_activation(f, ae_map.get(cut)))
            if e.wire_bytes != len(frame):
                raise AssertionError(f"Z14 {key}: wire_bytes {e.wire_bytes}, frame {len(frame)}")
    out["entries_ms"] = entries
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        table.to_json(path)
        back = CalibrationTable.from_json(path)
    if (back.entries != table.entries or back.batch != table.batch
            or back.meta != table.meta or back.model_name != table.model_name):
        raise AssertionError("Z14: the table's JSON round trip changed it")

    # from here on, pricing and simulation: no kernel
    reset_launches()
    input_bytes = int(np.prod(x.shape[1:])) * 4
    gpu = PLATFORMS["server-gpu"]
    analytic = AnalyticCost(model, params, input_bytes, edge=gpu, server=gpu, batch=CAL_BATCH)
    stack = CostStack([table, analytic])
    priced = {}
    for name in CAL_PRICED + (CAL_LEFT_OUT,):
        cut = names[name]
        sc = Scenario("SC", SplitPlan(cut), edge=gpu, server=gpu)
        tcp = NetworkConfig("tcp", Channel(**SIM_CHANNEL))
        flow = measure_flow(sc, tcp, model, params, input_bytes, SIM_FRAMES, cost=stack,
                            batch=CAL_BATCH)
        want = "analytic" if name == CAL_LEFT_OUT else "measured"
        if flow["cost_source"] != want:
            raise AssertionError(f"Z14 SC@{name}: cost_source {flow['cost_source']}, want {want}")
        model_t = analytic.flow_times("SC", cut)
        row = {"cost_source": flow["cost_source"], "edge_ms": 1e3 * flow["edge_s"],
               "server_ms": 1e3 * flow["server_s"], "wire_bytes": flow["wire_bytes"],
               "analytic_edge_ms": 1e3 * model_t["edge_s"],
               "analytic_server_ms": 1e3 * model_t["server_s"],
               "analytic_wire_bytes": model_t["wire_bytes"]}
        if name != CAL_LEFT_OUT:
            ae = aes.get(cut)
            for p in SIM_CAL_LOSSES:
                net = NetworkConfig("tcp", Channel(loss_rate=p, **SIM_CHANNEL))
                flow = measure_flow(sc, net, model, params, input_bytes, SIM_FRAMES,
                                    cost=stack, batch=CAL_BATCH)
                v = ApplicationSimulator(model, params, net, ae=ae, device="cuda").simulate(
                    sc, xs, ys, flow=flow)
                row[f"verdict_loss_{p}"] = {"latency_ms": 1e3 * v.latency_s,
                                            "agreement": v.accuracy,
                                            "mean_tx": v.meta["mean_tx"]}
        priced[f"SC@{name}"] = row
    out["priced"] = priced
    rc = analytic.flow_times("RC")
    out["analytic_unsplit_ms"] = 1e3 * rc["server_s"]
    hil = HILPlatform("card")
    with torch.inference_mode():
        out["hil_unsplit_ms"] = 1e3 * hil.measure("unsplit", lambda v: model.apply(params, v),
                                                  xt, iters=CAL_ITERS)
    out["lc_head_ms"] = 1e3 * table.lookup("LC").head_s
    check_launches("Z14 pricing and simulation", launch_counts(), {})
    return out, table


def fates(r) -> dict:
    """What the fault plan and the policy decided for one request: pure
    functions of (seed, rid, hop, attempt) and the channel, which a CPU run
    of the same plan must repeat."""
    rec = r.meta["recovery"]
    return {"faults": rec["faults"], "retries": rec["retries"], "timeouts": rec["timeouts"],
            "backoff_s": rec["backoff_s"], "downgrades": rec["downgrades"],
            "local_fallback": rec["local_fallback"],
            "hops": [(h["attempts"], h["kind"], h["delivered"], h["bytes"]) for h in r.hops]}


def deadline_distance(r, deadline_s) -> float:
    """Seconds between the deadline and the nearest point the request's
    virtual clock passed through, as its record gives them: the end of its
    first stage and of each event of its hop.  The engine checks the
    deadline only at such points, so no check came nearer: a fate the CPU
    replay must repeat cannot flip by measured seconds smaller than this."""
    t = r.stage_s[0]
    points = [t]
    for _, _, d in r.hops[0]["events"]:
        t += d
        points.append(t)
    return min(abs(deadline_s - p) for p in points)


def fault_recovery(model, params, params_cpu, aes) -> dict:
    """Z15: ``SplitRuntime(faults=, recovery=)`` at each trained AE cut, a
    twin of benchmarks/bench_faults.py:69-160 at full width.  Holds (a) with
    ``faults=None`` fused logits equal to eager bit for bit and within
    LOGIT_RTOL of the same chain through the plain versions (the SEI1 bytes
    are host code, held against the reference in tests/test_torch_faults.py);
    (b) under the chaos plan every request
    answered, each one not degraded bit for bit the fault-free run's, each
    degraded one within its rung's bar of the unsplit forward, and every
    request's fates equal to a CPU run of the port under the same plan (the
    plan has no blackout, and its 5 s deadline lies far from every point of
    each request's virtual clock: the least distance is printed); (c) under the blackout plan every
    request on the local fallback, equal to the unsplit forward; (e) each
    codec kernel's launches, worked out from the rungs each request took:
    one encode a request at the ae8 rung and one decode a request delivered
    there, each a warm-up and FAULT_ITERS timed calls."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1,) + tuple(model.input_shape)).astype(np.float32)
          for _ in range(FAULT_REQUESTS)]
    ch = Channel(**FAULT_CHANNEL)
    n, per = FAULT_REQUESTS, 1 + FAULT_ITERS
    out = {"requests": n, "channel": FAULT_CHANNEL, "chaos_plan": CHAOS_PLAN,
           "chaos_policy": CHAOS_POLICY, "cuts": {}, "launches": {}}
    for cut, ae in aes.items():
        name = model.layers[cut].name
        row = {"cut": cut}
        # (a) zero faults
        t0 = time.perf_counter()
        eager = SplitRuntime(model, params, cut, ae=ae, channel=ch, device="cuda")
        fused = SplitRuntime(model, params, cut, ae=ae, channel=ch, fused=True, device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        clean, rels = [], []
        for x in xs:
            r, rf = eager.infer(x, iters=FAULT_ITERS), fused.infer(x, iters=FAULT_ITERS)
            if "recovery" in r.meta or not np.array_equal(r.logits, rf.logits):
                raise AssertionError(f"Z15 {name}: zero-fault fused logits differ from eager")
            plain = plain_chain(model, params, {cut: ae}, torch.from_numpy(x).cuda(),
                                cuts=(cut,)).cpu().numpy()
            rels.append(float(np.abs(r.logits - plain).max() / np.abs(plain).max()))
            if rels[-1] > LOGIT_RTOL:
                raise AssertionError(f"Z15 {name}: zero-fault logits off the plain chain by "
                                     f"{rels[-1]} (bar {LOGIT_RTOL})")
            clean.append(r)
        out["launches"][f"{name} zero faults"] = launch_counts()
        check_launches(f"Z15 {name} zero faults", launch_counts(),
                       {"bottleneck_compress": n * 2 * per,
                        "bottleneck_decompress": n * 2 * per})
        row["zero_fault_rel_err_vs_plain"] = max(rels)
        row["zero_fault_s"] = time.perf_counter() - t0
        row["frame_bytes"] = clean[0].wire_bytes

        # (b) chaos
        t0 = time.perf_counter()
        plan, pol = FaultPlan(**CHAOS_PLAN), RecoveryPolicy(**CHAOS_POLICY)
        rt = SplitRuntime(model, params, cut, ae=ae, channel=ch, faults=plan, recovery=pol,
                          device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        chaos = [rt.infer(x, iters=FAULT_ITERS, rid=rid) for rid, x in enumerate(xs)]
        counts = launch_counts()
        out["launches"][f"{name} chaos"] = counts
        delivered_ae8 = sum(h["delivered"] and h["kind"] == "ae8" for r in chaos for h in r.hops)
        check_launches(f"Z15 {name} chaos", counts,
                       {"bottleneck_compress": n * per, "bottleneck_decompress": per * delivered_ae8})
        row["chaos_s"] = time.perf_counter() - t0
        identical, rungs = 0, {}
        for rid, (r, c) in enumerate(zip(chaos, clean)):
            if r.logits.shape != (1, 1000) or not np.isfinite(r.logits).all():
                raise AssertionError(f"Z15 {name} chaos request {rid}: logits {r.logits.shape}")
            if not r.meta["degraded"]:
                if not np.array_equal(r.logits, c.logits):
                    raise AssertionError(f"Z15 {name} chaos request {rid}: retried, not degraded, "
                                         "and its logits differ from the fault-free run's")
                identical += 1
                continue
            rung = "local" if r.meta["local_fallback"] else r.hops[0]["kind"]
            full = rt.reference(xs[rid])
            rel = float(np.abs(r.logits - full).max() / np.abs(full).max())
            rungs.setdefault(rung, []).append(rel)
            if rel > RUNG_RTOL[rung]:
                raise AssertionError(f"Z15 {name} chaos request {rid}: the {rung} rung's logits "
                                     f"off the unsplit forward by {rel} (bar {RUNG_RTOL[rung]})")
        recs = [r.meta["recovery"] for r in chaos]
        row["chaos"] = {
            "completion_rate": len(chaos) / n, "identical": identical,
            "degraded": n - identical, "degraded_rel_err_by_rung": rungs,
            "faults": {k: sum(rc["faults"][k] for rc in recs) for k in recs[0]["faults"]},
            "retries": sum(rc["retries"] for rc in recs),
            "timeouts": sum(rc["timeouts"] for rc in recs),
            "downgrades": sum(len(rc["downgrades"]) for rc in recs),
            "local_fallbacks": sum(rc["local_fallback"] for rc in recs),
            "backoff_s": sum(rc["backoff_s"] for rc in recs),
            "overhead_ms_per_req": 1e3 * sum(r.total_s - c.total_s
                                             for r, c in zip(chaos, clean)) / n,
            "encode_ms": [1e3 * r.encode_s for r in chaos],
            "decode_ms": [1e3 * r.decode_s for r in chaos],
            "deadline_distance_s": min(deadline_distance(r, pol.deadline_s) for r in chaos)}
        # the same plan on the CPU: the same fates, request by request
        t0 = time.perf_counter()
        cpu_rt = SplitRuntime(model, params_cpu, cut, ae=to_cpu(ae), channel=ch, faults=plan,
                              recovery=pol, device="cpu")
        cpu = [cpu_rt.infer(x, iters=FAULT_ITERS, rid=rid) for rid, x in enumerate(xs)]
        for rid, (r, c) in enumerate(zip(chaos, cpu)):
            if fates(r) != fates(c):
                raise AssertionError(f"Z15 {name} chaos request {rid}: fates {fates(r)} on the "
                                     f"card, {fates(c)} on the CPU")
        row["chaos"]["cpu_deadline_distance_s"] = min(deadline_distance(r, pol.deadline_s)
                                                      for r in cpu)
        row["cpu_replay_s"] = time.perf_counter() - t0

        # (c) blackout
        t0 = time.perf_counter()
        rtb = SplitRuntime(model, params, cut, ae=ae, channel=ch,
                           faults=FaultPlan(**BLACKOUT_PLAN),
                           recovery=RecoveryPolicy(**BLACKOUT_POLICY), device="cuda")
        torch.cuda.synchronize()
        reset_launches()
        black = [rtb.infer(x, iters=FAULT_ITERS, rid=rid) for rid, x in enumerate(xs)]
        out["launches"][f"{name} blackout"] = launch_counts()
        check_launches(f"Z15 {name} blackout", launch_counts(), {"bottleneck_compress": n * per})
        rels = []
        for rid, r in enumerate(black):
            full = rtb.reference(xs[rid])
            rels.append(float(np.abs(r.logits - full).max() / np.abs(full).max()))
            if not r.meta["local_fallback"] or r.hops[0]["delivered"] or rels[-1] > RUNG_RTOL["local"]:
                raise AssertionError(f"Z15 {name} blackout request {rid}: fell back "
                                     f"{r.meta['local_fallback']}, off the unsplit forward "
                                     f"by {rels[-1]}")
        row["blackout"] = {"fallback_rate": sum(r.meta["local_fallback"] for r in black) / n,
                           "blackout_timeouts": sum(r.meta["recovery"]["faults"]["blackout"]
                                                    for r in black),
                           "max_rel_err_vs_unsplit": max(rels)}
        row["blackout_s"] = time.perf_counter() - t0
        out["cuts"][name] = row
        print(f"Z15 {name}", json.dumps(row), flush=True)
    return out


def tail_server_faults(model, params, cut, ae) -> dict:
    """Z15 (d): a 4-slot ``TailServer(faults=)`` at ``cut``: SERVER_CLIENTS
    clients send SEI2 frames, those of SERVER_CORRUPT corrupted past the
    header; the server rejects and counts them, serves nothing at a step
    inside SERVER_BLACKOUT, and serves the rest with the logits of a clean
    server given the accepted frames, bit for bit, each within LOGIT_RTOL of
    the same chain through the plain versions."""
    part = make_partition(model, params, cut, ae, device="cuda")
    plan = FaultPlan(seed=0, blackouts=SERVER_BLACKOUT)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (SERVER_CLIENTS, 1) + tuple(model.input_shape)).astype(np.float32)).cuda()
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        frames = [W.to_bytes(W.encode_activation(part.head(xi), ae), checksum=True) for xi in x]
    lo = SplitRuntime._payload_lo(frames[0])
    sent = [plan.corrupt_bytes(f, cid, 0, 0, lo=lo) if cid in SERVER_CORRUPT else f
            for cid, f in enumerate(frames)]
    srv = TailServer(part, n_slots=4, client_batch=1, faults=plan, device="cuda")
    accepted = [srv.submit(cid, f) for cid, f in enumerate(sent)]
    if (accepted != [cid not in SERVER_CORRUPT for cid in range(SERVER_CLIENTS)]
            or srv.n_rejected != len(SERVER_CORRUPT) or srv.rejected != list(SERVER_CORRUPT)):
        raise AssertionError(f"Z15 tail server: accepted {accepted}, rejected {srv.rejected}")
    served, steps = {}, []
    for now in SERVER_STEPS_AT:
        got = srv.step(now=now)
        if plan.blackout_at(now) and got:
            raise AssertionError(f"Z15 tail server served {sorted(got)} inside a blackout at {now}")
        steps.append((now, sorted(got)))
        served.update(got)
    clean = TailServer(part, n_slots=4, client_batch=1, device="cuda")
    for cid, f in enumerate(frames):
        if cid not in SERVER_CORRUPT:
            clean.submit(cid, f)
    want = clean.drain()
    counts = launch_counts()
    n_ok = SERVER_CLIENTS - len(SERVER_CORRUPT)
    check_launches("Z15 tail server", counts, {"bottleneck_compress": SERVER_CLIENTS,
                                              "bottleneck_decompress": 2 * n_ok})
    if sorted(served) != sorted(want) or any(not np.array_equal(served[c], want[c]) for c in want):
        raise AssertionError(f"Z15 tail server: served {sorted(served)}, the clean server "
                             f"{sorted(want)}, or their logits differ")
    rels = []
    for c, got in served.items():
        plain = plain_chain(model, params, {cut: ae}, x[c], cuts=(cut,)).cpu().numpy()
        rels.append(float(np.abs(got - plain).max() / np.abs(plain).max()))
        if rels[-1] > LOGIT_RTOL:
            raise AssertionError(f"Z15 tail server: client {c}'s logits off the plain chain by "
                                 f"{rels[-1]} (bar {LOGIT_RTOL})")
    blackout_steps = sum(plan.blackout_at(t) for t in SERVER_STEPS_AT)
    if srv.n_blackout_steps != blackout_steps:
        raise AssertionError(f"Z15 tail server: {srv.n_blackout_steps} blackout steps, "
                             f"want {blackout_steps}")
    return {"cut": cut, "clients": SERVER_CLIENTS, "rejected": srv.rejected,
            "n_blackout_steps": srv.n_blackout_steps, "steps": steps,
            "n_batches": srv.n_batches, "rel_err_vs_plain": max(rels), "launches": counts}


def fleet_on_card(model, params, params_cpu, aes, found, xs, ys, table) -> dict:
    """Z16: ``DeploymentPlanner`` over the example's fleet on the card, its
    accuracy legs ``ApplicationSimulator`` forwards of Z13's images, its
    server stage priced by Z14's table.  Holds (a) the event and vectorized
    cluster engines' stats on the suggested plans within ``PCTL_RTOL``; (b)
    the card's plan points over FLEET_HOLD_IMAGES images equal to a CPU
    planner's over the same images, same weights and table; (c)
    ``AdaptiveController.from_planner`` making the same switch decisions
    under both engines on the example's regime change.  No kernel runs."""
    mix = [DeviceClass.make(name, Channel(**ch), weight=w) for name, ch, w in FLEET_MIX]
    trace = generate_trace(mix, FLEET_REQUESTS, FLEET_RATE_HZ, pattern="diurnal",
                           seed=FLEET_SEED)
    cs, idx = np.asarray(found["cs_curve"]), found["layer_idx"]
    cuts = tuple(sorted(aes))
    space = SearchSpace(split_points=cuts, protocols=("tcp", "udp"), batch_sizes=(1, 8, 32),
                        replica_counts=(1, 2), top_k_splits=len(cuts), include_rc=True)
    qos = QoSRequirements(**FLEET_QOS)

    def planner(p, ae_map, data, device):
        return DeploymentPlanner(model, p, cs_curve=cs, layer_idx=idx, ae_map=ae_map,
                                 eval_data=data, n_frames=FLEET_FRAMES, cost=table,
                                 device=device)

    out = {"requests": len(trace), "horizon_s": trace.horizon_s,
           "by_device": {d.name: len(trace.for_device(d.name)) for d in mix}}
    reset_launches()
    t0 = time.perf_counter()
    card = planner(params, aes, (xs, ys), "cuda")
    points = card.search(trace, mix, space)
    plans = card.suggest(qos, (trace, mix), points=points)
    out["search_s"] = time.perf_counter() - t0
    out["n_points"], out["n_legs"] = len(points), len(card._flow_cache)
    out["n_infeasible_legs"] = card.n_infeasible_legs
    out["front"] = [dataclasses.asdict(p) for p in card.pareto_front(points)]
    out["plans"] = {k: None if p is None else dataclasses.asdict(p) for k, p in plans.items()}
    out["leg_accuracy"] = {"/".join(k): f["accuracy"] for k, f in card._flow_cache.items()}
    if not any(p is not None for p in plans.values()):
        raise AssertionError("Z16: no QoS-feasible plan for any device class")
    # (a) the two cluster engines on the suggested plans
    t0 = time.perf_counter()
    reports = {e: simulate_deployment(plans, trace, mix, card, engine=e)
               for e in ("event", "vectorized")}
    out["deployment_s"] = time.perf_counter() - t0
    for key, ev in reports["event"].items():
        ve = reports["vectorized"][key]
        same = (ev["n_served"] == ve["n_served"] and ev["drop_fraction"] == ve["drop_fraction"]
                and ev["devices"] == ve["devices"]
                and all(math.isclose(ev[k], ve[k], rel_tol=PCTL_RTOL, abs_tol=PCTL_ATOL)
                        for k in ("p50_s", "p99_s", "mean_batch", "utilization")))
        if not same:
            raise AssertionError(f"Z16 deployment {key}: event {ev}, vectorized {ve}")
    out["deployment"] = {str(k): v for k, v in reports["event"].items()}
    # (b) the card's planner against the CPU's, over the first images
    t0 = time.perf_counter()
    few = (xs[:FLEET_HOLD_IMAGES], ys[:FLEET_HOLD_IMAGES])
    held = {"card": planner(params, aes, few, "cuda"),
            "cpu": planner(params_cpu, {c: to_cpu(a) for c, a in aes.items()}, few, "cpu")}
    pts = {k: pl.search(trace, mix, space) for k, pl in held.items()}
    if len(pts["card"]) != len(pts["cpu"]):
        raise AssertionError(f"Z16: {len(pts['card'])} plan points on the card, "
                             f"{len(pts['cpu'])} on the CPU")
    for a, b in zip(pts["card"], pts["cpu"]):
        keys = ("device", "label", "split_layer", "protocol", "max_batch", "n_replicas",
                "engine", "batch_window_s")
        if (any(getattr(a, k) != getattr(b, k) for k in keys) or a.satisfies(qos) != b.satisfies(qos)
                or a.accuracy != b.accuracy
                or not all(math.isclose(getattr(a, k), getattr(b, k), rel_tol=FLEET_REL, abs_tol=0)
                           for k in ("p50_s", "p99_s", "server_flops_per_s", "drop_fraction"))):
            raise AssertionError(f"Z16 plan point on the card {a}, on the CPU {b}")
    out["hold_points"] = len(pts["card"])
    out["hold_s"] = time.perf_counter() - t0
    # (c) the adaptive controller under both engines
    t0 = time.perf_counter()
    rush = (DeviceClass.make("edge-embedded", Channel(**RUSH_CHANNEL), name="rush-client"),)
    scenario = RegimeChangeTrace.from_phases(rush, [Phase(d, r) for d, r in RUSH_PHASES], seed=7)
    ctl_space = SearchSpace(split_points=cuts, protocols=("tcp", "udp"), batch_sizes=(1, 8, 64),
                            replica_counts=(1,), top_k_splits=len(cuts), include_rc=True)
    ctl = AdaptiveController.from_planner(card, ctl_space, config=ControllerConfig(**RUSH_CONFIG))
    runs = {e: ctl.run(scenario, engine=e) for e in ("vectorized", "event")}

    def decisions(r):
        return {"plan_keys": list(r.plan_keys),
                "switches": [(s.t_s, s.from_key, s.to_key, s.reason, s.forced)
                             for s in r.switches],
                "migration": r.migration, "dropped": r.dropped,
                "counts": [r.n_decisions, r.n_replans, r.n_suppressed]}
    if decisions(runs["vectorized"]) != decisions(runs["event"]):
        raise AssertionError(f"Z16 controller: vectorized {decisions(runs['vectorized'])}, "
                             f"event {decisions(runs['event'])}")
    out["controller"] = {"candidates": len(ctl.candidates), "requests": len(scenario.trace),
                         **decisions(runs["vectorized"]),
                         "p99_ms": {e: 1e3 * r.p99_s for e, r in runs.items()},
                         "drop_fraction": runs["vectorized"].drop_fraction}
    out["controller_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    check_launches("Z16 fleet", out["launches"], {})
    return out


def live_pairs(sq, sk, causal, window) -> int:
    """Query-key pairs the mask leaves live (queries at the last Sq keys)."""
    p = np.arange(sq) + (sk - sq)
    hi = p if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_err(label, q, k, v, causal, window) -> tuple:
    """Max |kernel - plain| of ``flash_attention`` and the plain output;
    raises past the bar."""
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != q.dtype or not torch.isfinite(got).all() or err > FLASH_BAR[q.dtype]:
        raise AssertionError(f"flash_attention at {label}: max err {err} "
                             f"(bar {FLASH_BAR[q.dtype]})")
    return err, want


def check_flash(label, b, sq, sk, h, kh, d, causal, window, dtype, gen) -> dict:
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, sk, kh, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    err, want = flash_err(label, q, k, v, causal, window)
    # the mask-edge probe: rising scores find the causal (or key-range)
    # edge, falling ones the window's
    probe = {}
    edges = ([True] if causal or window is None else []) + ([False] if window else [])
    if dtype == torch.bfloat16:
        for rising in edges:
            pq, pk, pv = ref.flash_edge_probe(b, sq, sk, h, kh, d, rising=rising, seed=sq,
                                              device="cuda")
            probe["rising" if rising else "falling"] = flash_err(
                f"{label} edge probe", pq, pk, pv, causal, window)[0]
            del pq, pk, pv
    # the library yardstick: SDPA with the same mask, heads first, GQA as is
    mask = None
    if window is not None or (causal and sq != sk):
        qp = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
        kp = torch.arange(sk, device="cuda")[None, :]
        mask = (kp <= qp) if causal else torch.ones((sq, sk), dtype=torch.bool, device="cuda")
        if window is not None:
            mask &= kp > qp - window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal and mask is None, enable_gqa=True)
    lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
    if lib_err > 2 * FLASH_BAR[dtype]:
        raise AssertionError(f"SDPA at {label} is not the same function: err {lib_err}")
    run = lambda: FA.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    pairs = live_pairs(sq, sk, causal, window)
    e = {"shape": label, "B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "D": d,
         "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
         "route": FA.ROUTES[dtype], "max_abs_err": err, "edge_probe_err": probe,
         "library_max_abs_err": lib_err, "live_pairs": pairs,
         "ms": device_ms(run), "call_ms": call_ms(run),
         "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                                window=window), reps=3),
         "library_ms": device_ms(library)}
    nbytes = q.element_size() * (2 * b * sq * h * d + 2 * b * sk * kh * d)
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    e["bound_ms"], e["bound_by"] = bound_ms(nbytes, 4 * b * h * d * pairs, peak)
    return e


def check_rwkv(label, b, s, h, d, nonzero, served_w, gen) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (0.5 * randn(b, s, h, d) for _ in range(3))
    if served_w:
        w = torch.exp(-torch.exp(-4.0 + 0.5 * randn(b, s, h, d)))
        u = 0.1 * randn(h, d)
    else:
        w = torch.exp(-torch.exp(randn(b, s, h, d) - 1.0))   # decays in (0, 1)
        u = 0.3 * randn(h, d)
    st = 0.2 * randn(b, h, d, d) if nonzero else torch.zeros((b, h, d, d), device="cuda")
    want_out, want_st = ref.rwkv6_scan_ref(r, k, v, w, u, st)
    out, final = RS.rwkv6_scan(r, k, v, w, u, st)
    torch.cuda.synchronize()
    err_out = float((out - want_out).abs().max())
    err_st = float((final - want_st).abs().max())
    top_out, top_st = float(want_out.abs().max()), float(want_st.abs().max())
    if (not (torch.isfinite(out).all() and torch.isfinite(final).all())
            or err_out > 1e-4 * top_out or err_st > 1e-4 * top_st):
        raise AssertionError(f"rwkv6_scan at {label}: out err {err_out} of {top_out}, "
                             f"state err {err_st} of {top_st}")
    run = lambda: RS.rwkv6_scan(r, k, v, w, u, st)  # noqa: E731
    e = {"shape": label, "B": b, "S": s, "H": h, "D": d, "initial_state": nonzero,
         "served_w": served_w, "max_abs_err": max(err_out, err_st),
         "out_rel_err": err_out / top_out, "state_rel_err": err_st / top_st,
         "ms": device_ms(run), "call_ms": call_ms(run),
         "plain_ms": device_ms(lambda: ref.rwkv6_scan_ref(r, k, v, w, u, st),
                               reps=1, replays=2),
         "library_ms": None}
    e["ms_per_step"] = e["ms"] / s
    # r, k, v, w read and out written; u and both states.  Operations a step
    # and head: 5 a state entry (k v; r S and its sum; w S and its sum with
    # k v) and 5 a row (u k, r u k and its sum into a_t; v a_t and its sum)
    e["bound_ms"], e["bound_by"] = bound_ms(4 * (5 * b * s * h * d + 2 * b * h * d * d + h * d),
                                            b * s * h * (5 * d * d + 5 * d))
    return e


def check_mamba(label, b, s, di, ds, nonzero, served_a, gen) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = (1.0 if served_a else 0.1) * F.softplus(randn(b, s, di))
    bm, cm = (0.5 * randn(b, s, ds) for _ in range(2))
    x = randn(b, s, di)
    if served_a:
        a = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds)
        a = a.contiguous()
    else:
        a = -torch.exp(0.3 * randn(di, ds))
    st = 0.3 * randn(b, di, ds) if nonzero else torch.zeros((b, di, ds), device="cuda")
    want_y, want_st = ref.mamba_scan_ref(dt, bm, cm, x, a, st)
    y, final = MS.mamba_scan(dt, bm, cm, x, a, st)
    torch.cuda.synchronize()
    err_y = float((y - want_y).abs().max())
    err_st = float((final - want_st).abs().max())
    top_y, top_st = float(want_y.abs().max()), float(want_st.abs().max())
    if (not (torch.isfinite(y).all() and torch.isfinite(final).all())
            or err_y > MAMBA_RTOL * top_y or err_st > MAMBA_RTOL * top_st):
        raise AssertionError(f"mamba_scan at {label}: y err {err_y} of {top_y}, "
                             f"state err {err_st} of {top_st} (bar {MAMBA_RTOL})")
    run = lambda: MS.mamba_scan(dt, bm, cm, x, a, st)  # noqa: E731
    e = {"shape": label, "B": b, "S": s, "di": di, "ds": ds, "initial_state": nonzero,
         "served_a": served_a, "max_abs_err": max(err_y, err_st), "y_rel_err": err_y / top_y,
         "state_rel_err": err_st / top_st,
         "ms": device_ms(run), "call_ms": call_ms(run),
         "plain_ms": device_ms(lambda: ref.mamba_scan_ref(dt, bm, cm, x, a, st),
                               reps=1, replays=2),
         "library_ms": None}
    e["ms_per_step"] = e["ms"] / s
    # dt, x read and y written; B, C, A and both states; 6 f32 operations a
    # state entry and step (dt*A, dx*B, dA*h and its sum, h*C and its sum)
    # and dt*x a channel and step; one exponential a state entry and step
    e["bound_ms"], e["bound_by"] = bound_ms(4 * (3 * b * s * di + 2 * b * s * ds + di * ds
                                                 + 2 * b * di * ds),
                                            6 * b * s * di * ds + b * s * di,
                                            exps=b * s * di * ds)
    return e


def padded(prompts) -> np.ndarray:
    """Left-padded with token 0, as ``ServingEngine.run`` pads."""
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    return toks


def ulp_flip(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every entry moved by one unit in its last place."""
    t = t.clone()
    t.view(torch.int16 if t.element_size() == 2 else torch.int32).bitwise_xor_(1)
    return t


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


# the zoo kernels' device function names, as the profiler reports them
ZOO_KERNEL_NAMES = {"flash_attention": "flash_fwd", "rwkv6_scan": "wkv6",
                    "mamba_scan": "selective_scan"}


def device_breakdown(fn, top=6) -> dict:
    """One run of ``fn`` under ``torch.profiler``: the device's busy time
    (the union of its kernel, copy and fill intervals) against the wall
    time, device time by kernel name (the ``top`` largest) and that of each
    zoo kernel, with its share of the device time.  The profiler slows the
    host, so the busy share reads low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # "Command Buffer Full" marks the host waiting on a full launch queue
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full")
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    total = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda r: -r[1])[:top]
    zoo = {k: sum(us for name, us in by_name.items() if part in name)
           for k, part in ZOO_KERNEL_NAMES.items()}
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / wall_us,
            "n_kernel_names": len(by_name),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "share": us / total} for k, us in rows],
            "zoo_kernels": {k: {"ms": us / 1e3, "share": us / total} for k, us in zoo.items()}}


def served_cfg(arch, **changes):
    """The configuration the port serves under ``arch``."""
    return dataclasses.replace(get_config(arch), **SERVED.get(arch, {}), **changes)


def per_token_launches(cfg) -> tuple:
    """Kernel launches ``{kernel: n}`` of one prefill and of one decode step
    of ``cfg``: ``flash_attention`` once an attention layer in the prefill
    (decode attention is plain ops), each scan once a layer of its mixer in
    the prefill and in every decode step."""
    descs, n_groups = T.block_structure(cfg)
    attn = n_groups * sum(d.mixer == "attn" for d in descs)
    rwkv = n_groups * sum(d.mixer == "rwkv" for d in descs)
    mamba = n_groups * sum(d.mixer == "mamba" for d in descs)
    return ({"flash_attention": attn, "rwkv6_scan": rwkv, "mamba_scan": mamba},
            {"flash_attention": 0, "rwkv6_scan": rwkv, "mamba_scan": mamba})


def check_launches(what, counts, want) -> None:
    """Every kernel launched exactly as ``want`` says (0 where it is silent)."""
    got = {k: sum(c.values()) for k, c in counts.items()}
    if any(n != want.get(k, 0) for k, n in got.items()):
        raise AssertionError(f"{what}: launches {got}, want {want}")


def check_flash_route(what, counts, dtype, n) -> dict:
    """``flash_attention`` launched ``n`` times, all on ``dtype``'s route."""
    want = {route: 0 for route in FA.ROUTES.values()}
    want[FA.ROUTES[getattr(torch, dtype)]] = n
    if counts["flash_attention"] != want:
        raise AssertionError(f"{what}: flash_attention launches {counts['flash_attention']}, "
                             f"want {want}")
    return want


def serve_zoo(arch, prompt_lens, dtype="bfloat16") -> dict:
    """Z4 / Z5 / Z8 / Z9: full-width, full-depth serving of ``arch`` through
    ``ServingEngine``; every kernel launches as ``per_token_launches`` says,
    in the served run and in a prefill and the decode steps counted apart.
    The served tokens are then fed through prefill + serve_step again, and
    the logits of each step held against one full forward over prompt +
    served tokens (see ``ZOO_RTOL``)."""
    cfg = served_cfg(arch, dtype=dtype)
    per_prefill, per_step = per_token_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    out = {"arch": arch, "dtype": dtype, "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9,
           "prompt_lens": list(prompt_lens), "new_tokens": NEW_TOKENS,
           "n_layers": cfg.n_layers, "moe": cfg.moe}
    torch.cuda.reset_peak_memory_stats()      # peak_gb: serving, the weights included
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    slots = max(prompt_lens) + NEW_TOKENS
    engine = ServingEngine(cfg, params, cache_slots=slots, device="cuda")
    reqs = [Request(i, p, max_new=NEW_TOKENS) for i, p in enumerate(prompts)]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    out["run_ms"] = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    out["launches"] = counts
    check_launches(f"{arch} {dtype} served", counts,
                   {k: n + NEW_TOKENS * per_step[k] for k, n in per_prefill.items()})
    check_flash_route(f"{arch} {dtype} served", counts, dtype, per_prefill["flash_attention"])
    for r in reqs:
        if len(r.out) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"{arch}: request {r.rid} got {r.out}")
    out["tokens"] = [r.out for r in reqs]
    served = torch.tensor(out["tokens"], dtype=torch.int32, device="cuda")

    # the same work again, prefill and decode timed apart, fed the served
    # tokens; each step's logits are kept
    toks = torch.from_numpy(padded(prompts)).cuda()
    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, {"tokens": toks}, slots)
        torch.cuda.synchronize()
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        out["prefill_launches"] = launch_counts()
        check_launches(f"{arch} {dtype} prefill", out["prefill_launches"], per_prefill)
        out["flash_routes_prefill"] = check_flash_route(
            f"{arch} {dtype} prefill", out["prefill_launches"], dtype,
            per_prefill["flash_attention"])
        print(f"{arch} {dtype}: flash_attention launches a prefill {out['flash_routes_prefill']}",
              flush=True)
        steps = [logits.float()]
        reset_launches()
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = T.serve_step(params, cfg, cache, served[:, step:step + 1], pos + step)
            steps.append(logits.float())
        torch.cuda.synchronize()
        out["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / NEW_TOKENS
        out["decode_launches"] = launch_counts()
        check_launches(f"{arch} {dtype} decode", out["decode_launches"],
                       {k: NEW_TOKENS * n for k, n in per_step.items()})
        del cache
        steps = torch.stack(steps[:NEW_TOKENS], 1)            # (B, NEW_TOKENS, V)
        if not torch.equal(steps.argmax(-1).int(), served):
            raise AssertionError(f"{arch}: the replay's greedy tokens differ from the served")
        if dtype == "bfloat16":
            out["prefill_profile"] = device_breakdown(
                lambda: T.prefill(params, cfg, {"tokens": toks}, slots))
            _, cache, _ = T.prefill(params, cfg, {"tokens": toks}, slots)
            out["decode_step_profile"] = device_breakdown(
                lambda: T.serve_step(params, cfg, cache, served[:, :1], pos))
            del cache
        # one full forward over prompt + served tokens, and the same forward
        # with its input moved by one rounding
        seq = torch.cat([toks, served[:, :-1]], dim=1)
        x = T.forward(params, cfg, {"tokens": seq})["x"][:, toks.shape[1] - 1:]
        flogits = T.logits_from_x(params, cfg, x).float()
        flipped = {**params, "embed": ulp_flip(params["embed"])}
        x = T.forward(flipped, cfg, {"tokens": seq})["x"][:, toks.shape[1] - 1:]
        ulp_err = float((T.logits_from_x(flipped, cfg, x).float() - flogits).abs().max())
        del flipped, x
    top = float(flogits.abs().max())
    row_err = (steps - flogits).abs().amax(-1)                 # (B, NEW_TOKENS)
    rel = float(row_err.max()) / top
    bar = max(ZOO_RTOL[dtype], ULP_FACTOR * ulp_err / top)
    differ = flogits.argmax(-1) != served.long()
    margins = top2_margin(flogits)
    out["vs_forward"] = {"prefill_rel_err": float(row_err[:, 0].max()) / top,
                         "decode_rel_err": float(row_err[:, 1:].max()) / top,
                         "one_ulp_input_response": ulp_err / top, "bar": bar,
                         "max_abs_logit": top,
                         "tokens_compared": int(differ.numel()),
                         "tokens_differ": int(differ.sum()),
                         "differ_margins_rel": (margins[differ] / top).tolist(),
                         "min_margin_rel": float(margins.min()) / top}
    if not torch.isfinite(steps).all() or rel > bar:
        raise AssertionError(f"{arch} {dtype}: step logits off the forward's by {rel} of "
                             f"max |logit| (bar {bar})")
    # a token may differ only where the forward's top two lie closer than
    # twice the step's own logit error
    if bool((differ & (margins > 2 * row_err)).any()):
        raise AssertionError(f"{arch} {dtype}: served tokens differ from the forward's at "
                             f"margins {margins[differ].tolist()}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if arch.startswith("llama") and dtype == "bfloat16":
        out["split"] = split_lens(cfg, params, toks)
    del params
    torch.cuda.empty_cache()
    return out


def split_lens(cfg, params, toks) -> dict:
    """Z4's split: the twin of examples/serve_split.py.  Cut the served batch
    at the middle block boundary, compress the residual through the
    bottleneck kernels, decode it and run the tail."""
    lay = transformer_as_layered(cfg, params)
    cuts = lay.cut_points()
    cut = cuts[len(cuts) // 2]
    ae = B.init_bottleneck(7, (cfg.d_model,), 0.5, device="cuda")
    reset_launches()
    with torch.inference_mode():
        x = lay.layers[0].apply({}, {"tokens": toks})
        for layer in lay.layers[1:cut + 1]:
            x = layer.apply({}, x)
        q, s = B.encode_wire(ae, x)
        y = B.decode_wire(ae, q, s).to(x.dtype)
        for layer in lay.layers[cut + 1:-1]:
            y = layer.apply({}, y)
        logits = lay.layers[-1].apply({}, y[:, -1:])
    torch.cuda.synchronize()
    counts = launch_counts()
    if not torch.isfinite(logits.float()).all() or logits.shape != (toks.shape[0], 1, cfg.vocab):
        raise AssertionError(f"split logits {tuple(logits.shape)} not finite")
    check_flash_route("Z4 split", counts, cfg.dtype, cfg.n_layers)
    if (sum(counts["bottleneck_compress"].values()) != 1
            or sum(counts["bottleneck_decompress"].values()) != 1):
        raise AssertionError(f"split launches {counts}")
    with torch.inference_mode():
        encode_ms = device_ms(lambda: B.encode_wire(ae, x))
        decode_ms = device_ms(lambda: B.decode_wire(ae, q, s))
    # Table I of the view at the served batch, as the planner's and
    # measure_flow's pricing would ask for it: the view's blocks close over
    # real parameters, so ``activation_shapes(sample=)`` runs a real forward
    # (no ``meta`` path); ``summary`` then caches the rows by shape
    summary_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = stats.summary(lay, [{} for _ in lay.layers], sample={"tokens": toks})
        torch.cuda.synchronize()
        summary_ms.append(1e3 * (time.perf_counter() - t0))
    if len(rows) != len(lay.layers) or rows[-1].output_shape[:2] != tuple(toks.shape):
        raise AssertionError(f"Z4 split: Table I of the view {[r.output_shape for r in rows]}")
    return {"cut_after_layer": cut, "layer_name": lay.layers[cut].name,
            "rows": int(q.shape[0] * q.shape[1]), "d_model": cfg.d_model,
            "latent": int(q.shape[-1]), "wire_bytes": q.numel() + 4 * s.numel(),
            "raw_bytes": x.numel() * x.element_size(), "launches": counts,
            "encode_wire_ms": encode_ms, "decode_wire_ms": decode_ms,
            "view_summary_cold_ms": summary_ms[0], "view_summary_cached_ms": summary_ms[1]}


def e2e_check(arch, n_layers=2, prompt_lens=(256, 181), n_new=8, rtol=1e-3) -> dict:
    """Z6 / Z10: a full-width f32 copy of ``arch`` cut to ``n_layers``
    through the kernels on the card and through the plain versions on the
    CPU, same weights."""
    cfg = served_cfg(arch, n_layers=n_layers, dtype="float32")
    per_prefill, per_step = per_token_launches(cfg)
    params_cpu = T.init_params(0, cfg, device="cpu")
    params_gpu = tree_map(torch.Tensor.cuda, params_cpu)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(padded([rng.integers(0, cfg.vocab, n).astype(np.int32)
                                    for n in prompt_lens]))
    slots = toks.shape[1] + n_new

    def greedy_run(params, dev):
        with torch.inference_mode():
            logits, cache, pos = T.prefill(params, cfg, {"tokens": toks.to(dev)}, slots)
            steps = [logits.float().cpu()]
            for step in range(n_new):
                token = torch.argmax(logits, -1).to(torch.int32)[:, None]
                logits, cache = T.serve_step(params, cfg, cache, token, pos + step)
                steps.append(logits.float().cpu())
        return torch.stack(steps, 1)           # (B, n_new + 1, V)

    reset_launches()
    got = greedy_run(params_gpu, "cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"Z6 {arch}", counts,
                   {k: n + n_new * per_step[k] for k, n in per_prefill.items()})
    check_flash_route(f"Z6 {arch}", counts, "float32", per_prefill["flash_attention"])
    want = greedy_run(params_cpu, "cpu")
    top = float(want[:, 0].abs().max())
    prefill_err = float((got[:, 0] - want[:, 0]).abs().max()) / top
    if prefill_err > rtol:
        raise AssertionError(f"Z6 {arch}: prefill logits off by {prefill_err} of max (bar {rtol})")
    # greedy tokens, request by request, as long as both histories agree
    compared, step_err, diverged = 0, 0.0, []
    for i in range(toks.shape[0]):
        for t in range(n_new + 1):
            g, w = got[i, t], want[i, t]
            step_err = max(step_err, float((g - w).abs().max()) / float(w.abs().max()))
            compared += 1
            if int(g.argmax()) != int(w.argmax()):
                margin = float(top2_margin(w))
                if margin > rtol * float(w.abs().max()):
                    raise AssertionError(f"Z6 {arch}: request {i} step {t} token differs "
                                         f"at margin {margin}")
                diverged.append((i, t, margin))
                break
    if step_err > rtol:
        raise AssertionError(f"Z6 {arch}: decode logits off by {step_err} of max (bar {rtol})")
    del params_gpu
    torch.cuda.empty_cache()
    return {"arch": arch, "n_layers": n_layers, "dtype": "float32",
            "prompt_lens": list(prompt_lens),
            "new_tokens": n_new, "prefill_rel_err": prefill_err, "step_rel_err": step_err,
            "tokens_compared": compared, "diverged_at_near_ties": diverged, "launches": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    # phase 2 (Z1)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    # ptxas -v: each kernel function, its registers, shared memory and spills
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "warpgroup",
                                       "wgmma")):
                print(f"  {name}: {line.strip()}")
        if name.startswith("bottleneck_") or name in ("mamba_scan", "rwkv6_scan"):
            check_ptxas(name, log)

    # phase 3
    model = vgg16()
    params = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    comp_rows, dec_rows = [], []
    for label, n, c, l in main_path_shapes(model, params):
        comp_rows.append(check_compress(label, n, c, l, gen))
        print("compress", json.dumps(comp_rows[-1]), flush=True)
        dec_rows.append(check_decompress(label, n, c, l, gen))
        print("decompress", json.dumps(dec_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    for kernel, rows in (("compress", comp_rows), ("decompress", dec_rows)):
        for e in rows:
            fastest = e["fastest"]
            print(f"{kernel} {e['shape']}: picked / fastest = {e['picked']} {e['ms']:.5f} / "
                  f"{fastest} {e[fastest + '_ms']:.5f} ms = {e['picked_over_fastest']:.3f}")

    # phases 4-5, counted
    x = torch.randn((BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(0)).cuda()
    reset_launches()
    served = serve(model, params, x)
    vgg_counts = launch_counts()
    print("served", json.dumps(served), flush=True)
    for kernel in ("bottleneck_compress", "bottleneck_decompress"):
        if sum(vgg_counts[kernel].values()) != VGG_CODEC_LAUNCHES:
            raise AssertionError(f"{kernel} launched {vgg_counts[kernel]} on the served path, "
                                 f"want {VGG_CODEC_LAUNCHES} in all")
    del model, params, x
    torch.cuda.empty_cache()

    # Z2, Z3: the zoo's kernels against their plain versions
    flash_rows = []
    for label, *shape in FLASH_SHAPES:
        flash_rows.append(check_flash(label, *shape, gen))
        print("flash_attention", json.dumps(flash_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    rwkv_rows = []
    for label, *shape in RWKV_SHAPES:
        rwkv_rows.append(check_rwkv(label, *shape, gen))
        print("rwkv6_scan", json.dumps(rwkv_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    # Z7
    mamba_rows = []
    for label, *shape in MAMBA_SHAPES:
        mamba_rows.append(check_mamba(label, *shape, gen))
        print("mamba_scan", json.dumps(mamba_rows[-1]), flush=True)
        torch.cuda.empty_cache()

    # Z4, Z5, Z8: full-width, full-depth serving, counted; then each served
    # run again in f32 (Z9 for jamba), held to the f32 bar; Z6, Z10: kernels
    # against the plain path
    llama = serve_zoo("llama3.2-3b", LLAMA_PROMPTS)
    print("served llama3.2-3b", json.dumps(llama), flush=True)
    rwkv = serve_zoo("rwkv6-1.6b", RWKV_PROMPTS)
    print("served rwkv6-1.6b", json.dumps(rwkv), flush=True)
    jamba = serve_zoo(JAMBA, LLAMA_PROMPTS)
    print(f"served {JAMBA}", json.dumps(jamba), flush=True)
    f32 = {}
    for arch, prompts in (("llama3.2-3b", LLAMA_PROMPTS), ("rwkv6-1.6b", RWKV_PROMPTS),
                          (JAMBA, LLAMA_PROMPTS)):
        f32[arch] = serve_zoo(arch, prompts, dtype="float32")
        print(f"served {arch} float32", json.dumps(f32[arch]), flush=True)
    e2e = [e2e_check(arch) for arch in ("llama3.2-3b", "rwkv6-1.6b")]
    # jamba cut to one period: 1 attention and 7 Mamba layers
    e2e.append(e2e_check(JAMBA, n_layers=len(T.block_structure(served_cfg(JAMBA))[0])))
    print("end to end", json.dumps(e2e), flush=True)

    # Z11, Z12: the split-point search, bottleneck training and the deploy
    # of the trained AEs, on phase 4's VGG16 (the same seed), last so that
    # the phases before keep their numbers (search and train before the
    # deploy: tensors made under inference_mode cannot enter autograd); the
    # phase-3 L2 flush buffer goes first, so their peaks hold their own work
    _FLUSH.clear()
    torch.cuda.empty_cache()
    model = vgg16()
    params = model.init(seed=0, device="cuda")
    params_cpu = to_cpu(params)
    found = search(model, params, params_cpu)
    print("Z11 split search", json.dumps(found), flush=True)
    aes = {}
    for cut in dict.fromkeys((found["top_sc"], FINETUNE_CUT)):
        aes[cut], row = train_at(model, params, params_cpu, cut)
        print("Z12 train_bottleneck", json.dumps(row), flush=True)
    tuned = finetune_at(model, params, params_cpu, aes[FINETUNE_CUT])
    print("Z12 finetune", json.dumps(tuned), flush=True)
    deployed = deploy(model, params, aes)
    print("Z12 deploy", json.dumps(deployed), flush=True)
    # Z13, Z14: the simulator and its hardware-in-the-loop calibration, on the
    # same VGG16 and the AEs Z12 trained
    t0 = time.perf_counter()
    xs, ys = simulate_fig4(model, params, params_cpu, aes)
    print(f"Z13 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hil, table = calibrate_hil(model, params, aes, xs, ys)
    print("Z14 calibrate", json.dumps(hil), flush=True)
    print(f"Z14 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z15, Z16: fault recovery in the split runtime and the fleet layers, on
    # the same VGG16 with Z12's AEs, Z13's images and Z14's table
    t0 = time.perf_counter()
    faults = fault_recovery(model, params, params_cpu, aes)
    faults["tail_server"] = tail_server_faults(model, params, FINETUNE_CUT, aes[FINETUNE_CUT])
    print("Z15 tail server", json.dumps(faults["tail_server"]), flush=True)
    print(f"Z15 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fleet = fleet_on_card(model, params, params_cpu, aes, found, xs, ys, table)
    print("Z16 fleet", json.dumps(fleet), flush=True)
    print(f"Z16 took {time.perf_counter() - t0:.1f} s", flush=True)
    del model, params, params_cpu, aes, xs, ys, table
    torch.cuda.empty_cache()

    # the kernels line: launches from each kernel's main path
    paths = {"bottleneck_compress": ("vgg16 phases 4-5", vgg_counts),
             "bottleneck_decompress": ("vgg16 phases 4-5", vgg_counts),
             "flash_attention": ("Z4 llama3.2-3b ServingEngine.run", llama["launches"]),
             "rwkv6_scan": ("Z5 rwkv6-1.6b ServingEngine.run", rwkv["launches"]),
             "mamba_scan": (f"Z8 {JAMBA} ServingEngine.run", jamba["launches"])}
    also = {"Z12 deploy": deployed["launches"],
            "Z14 calibrate": hil["launches"],
            **{f"Z15 {k}": c for k, c in faults["launches"].items()},
            "Z15 tail server": faults["tail_server"]["launches"],
            "Z16 fleet": fleet["launches"],
            "Z4 split": llama["split"]["launches"],
            f"Z8 {JAMBA}": jamba["launches"],
            f"Z8 {JAMBA} prefill": jamba["prefill_launches"],
            f"Z8 {JAMBA} decode": jamba["decode_launches"],
            **{f"{arch} float32": f32[arch]["launches"] for arch in f32},
            **{f"Z6 {e['arch']} depth {e['n_layers']}": e["launches"] for e in e2e}}

    def entry(name, rows, replaces, headline):
        head = next(e for e in rows if e["shape"] == headline)
        path, counts = paths[name]
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": sum(counts[name].values()),
                "launches_on": path, "launches_by": counts[name],
                "launches_elsewhere": {k: sum(c[name].values()) for k, c in also.items()},
                "max_abs_err": max(e["max_abs_err"] for e in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "at": headline, "shapes": rows}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        entry("bottleneck_compress", comp_rows, "src/repro/kernels/bottleneck_compress.py:80",
              HEADLINE),
        entry("bottleneck_decompress", dec_rows, "src/repro/kernels/bottleneck_decompress.py:41",
              HEADLINE),
        entry("flash_attention", flash_rows, "src/repro/kernels/flash_attention.py:86",
              "llama_prefill"),
        entry("rwkv6_scan", rwkv_rows, "src/repro/kernels/rwkv6_scan.py:56", "rwkv_prefill"),
        entry("mamba_scan", mamba_rows, "src/repro/kernels/mamba_scan.py:55", "jamba_prefill"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
