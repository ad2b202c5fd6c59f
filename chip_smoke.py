#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels against
their plain versions.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
no install: it puts ``src/`` on the path itself).  Phases:

1. print the card's name and power limit (``nvidia-smi``);
2. (Z1) build the eight CUDA kernel libraries from ``src/repro_torch/csrc``
   (the five forward kernels and the backwards of flash_attention,
   rwkv6_scan and mamba_scan), one nvcc each, all at once;
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
   llama3.2-3b, jamba, deepseek-moe-16b, internvl2-76b and
   qwen3-moe-235b-a22b (a GQA group of 16) prefill shapes,
   four more masks (window, non-causal, Sq < Sk, ragged) and whisper-tiny's
   head dim 64 (its encoder, its decoder's self-attention, its
   cross-attention with Sq > Sk, and a window), each in bf16 (the
   ``wgmma_bf16`` route) and f32 (``simt_f32``), timed beside
   ``scaled_dot_product_attention``, each row with the kernel's tiles,
   registers and shared memory (a kernel that spills fails the row); the
   training route's forward
   (``flash_attention_lse``) bit for bit the same output, its row
   log-sum-exp within ``FLASH_LSE_BAR`` of the plain one; every bf16 row
   also within a bar relative to |o| (``FLASH_BF16_STEP``) and again on
   the mask-edge probe (``ref.flash_edge_probe``), where a key off by one
   at a causal, window or key-range edge moves the output far past the
   bf16 bar;
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
    prefill (zero state), a ragged S from a given state, a decode step, the
    prefill again with the served model's own A and jamba's training shape
    (B 1, S 4096); (Z7b) ``mamba_scan_bwd`` as Z5b holds ``rwkv6_scan_bwd``,
    at the training shape, the prefill and the prefill at the served A;
12. (Z8) serve jamba-v0.1-52b with its dense FFN (``moe=None``; with its
    MoE the whole model does not fit one card: Z21 cuts it) at full width
    and full depth in bf16
    through ``ServingEngine``, Z4's prompts, 16 new tokens each, each step's
    logits held against one full forward under Z4's rule; (Z9) the same in
    f32; (Z10) Z6's check for a one-period (8-layer) f32 copy of it;
13. (Z18a) serve deepseek-moe-16b (all 28 layers MoE, 64 routed experts
    top-6 and 2 shared, capacity factor 1.25) at full width and depth in
    bf16 through ``ServingEngine`` on Z4's prompts: the prefill must drop
    (token, expert) pairs at capacity and the decode steps none, and each
    step's logits are held under Z4's rule against a forward that routes
    as the served run did (``served_forward``: the prompt in the prefill's
    groups, each served token a group of its own); (Z18b) the same in f32
    at 14 layers; (Z18c) Z6's check for a one-layer f32 copy, its prefill
    dropping pairs;
13b. (Z19) serve whisper-tiny whole (4 encoder and 4 decoder layers) in
    bf16 and f32 through ``ServingEngine`` on Z4's prompts (zero frames, as
    the engine feeds them), hold each step's logits, replayed with N(0, 1)
    frames, against a forward over the same frames under Z4's rule, and its
    f32 copy on the card against the CPU at full depth: 12
    ``flash_attention`` launches a prefill (4 encoder, 4 self-, 4
    cross-attention), none a decode step; (Z20a) internvl2-76b at full
    width and 24 of its 80 layers in bf16, the same way with 256 N(0, 1)
    patches before the prompts in the hold; (Z20b) 8 layers in f32; (Z20c)
    Z6's check for a one-layer f32 copy;
13c. (Z22a) serve qwen3-moe-235b-a22b (128 experts top-8, H 64 over K 4,
    n_heads * head_dim twice d_model) at full width and 8 of 94 layers in
    bf16 as Z18a serves deepseek, (Z22b) 4 layers in f32, (Z22c) Z6's check
    for a one-layer f32 copy; (Z21a) jamba-v0.1-52b with its MoE (behind
    Mamba mixers and its attention) at full width and 16 of 32 layers in
    bf16, (Z21b) one 8-layer period in f32, (Z21c) its first two f32 layers
    (a Mamba mixer with its dense FFN, then one with its MoE) one at a time
    on the card against the CPU; each prefill dropping pairs at capacity,
    no decode step any, each step held to ``served_forward``;
13d. (Z23) the continuous batcher (``ContinuousBatcher``, 4 slots) on
    llama3.2-3b and rwkv6-1.6b whole in bf16, then in f32: 8 requests
    arriving at ``BATCHER_ARRIVALS`` with ``BATCHER_MAX_NEW`` new tokens, so
    slots free and refill mid-decode; every request finishes with its
    tokens, the launches counted from the admits and the decode steps, and a
    replay's logits at each tick, slot by slot, held against one forward
    over each request's prompt and served tokens under Z4's rule, and in f32
    against the request served alone at the f32 bar; one admit and one full
    tick profiled;
13e. (Z2b) hold ``flash_attention_bwd`` (the backward of the autograd path;
    bf16 on ``wgmma``, f32 on register tiles, both reading the forward's lse)
    against ``ref.flash_attention_bwd_ref`` on the kernel's own output and
    against autograd through the plain forward, bf16 and f32, two calls bit
    for bit equal, each row with the tiles and each kernel's registers and
    shared memory (a kernel of either dtype that spills fails), at llama3.2-3b's
    training shape (B 1, S 4096), the llama prefill, ``window512_d64``,
    whisper-tiny's encoder and cross-attention (Sq 448 and 2000 over 1500
    frames), timed beside SDPA's backward; (Z5b) ``rwkv6_scan_bwd`` the same
    way at Z3's prefill and rwkv6-1.6b's training shape (B 1, S 4096), from
    a nonzero state with a nonzero final-state gradient, each row with the
    workspace, each of its four kernels' registers, shared memory, resident
    blocks an SM and local bytes (a spill fails), and one profiled call's
    time by kernel (these run right after Z3); (Z24a-c) train llama3.2-3b
    and rwkv6-1.6b whole in bf16 at train_4k's sequence (batch 1),
    whisper-tiny (batch 4, 448 tokens) and jamba-v0.1-52b (``moe=None``) at
    one 8-layer period, full width, S 4096
    through ``make_train_step``, 6 steps on one ``token_batch``, the losses
    finite and falling, every step's launches held to the code's count (each
    kernel's forward twice a layer: the checkpointed group is recomputed in
    the backward), step ms, tokens a second, init and step peak GB, one step
    under ``device_breakdown``; (Z24d) the loss and every gradient leaf of
    depth-2 f32 llama and rwkv (B 1, S 512), whole f32 whisper and 8-layer
    f32 jamba (B 1, S 256) on the card against the CPU; (Z25) ``Study`` over
    llama3.2-3b, rwkv6-1.6b and jamba-v0.1-52b (``moe=None``) whole in bf16
    on the card (profile, candidates, simulate, suggest; the profile
    launches each kernel's forward and backward once a layer), and 4-layer
    (jamba: 8) f32 copies held to the same study on the CPU;
14. (Z11) the paper's split-point search on phase 4's VGG16 (the same
    seed): Table I/II from ``core.stats``, held equal to the reference's
    (``VGG16_TOTALS_16``); the Grad-CAM CS curve over the 18 feature ops on
    16 toy images (``data.synthetic``), timed, run 6 times and held to the
    CPU's curve at 2 images; the candidates ``Study.candidates`` would rank;
15. (Z12) ``train_bottleneck`` (Eq. 3) at the top SC candidate and at
    pool23, 50 steps at batch 8, the loss falling and the first 3 steps
    replayed on the CPU at 2 images; ``finetune`` (Eq. 4) at pool23, 3
    steps, held to ``finetune`` on the CPU from the same start, and its
    first 2 steps' gradients at 2 images to the CPU's on the card's branch
    (its ReLU masks and pool elements, each within rounding of the CPU's
    choice); then a
    ``SplitRuntime`` at each trained cut with its AE and the int8 wire,
    through both codec kernels, held to the plain chain;
16. (Z13) the paper's communication-aware simulator (§IV, Figs. 3-4) on the
    same VGG16 with Z12's AEs: LC, RC and SC at both trained cuts, over TCP
    and UDP at 5 loss rates (``bench_protocol.py``'s channel), 64 toy
    images, "accuracy" read as agreement with the unsplit model; each
    flow's analytic times held to the CPU copy's, the simulator's own
    per-chunk inference held to the CPU's with the same loss masks, and
    Fig. 4's shape (TCP agreement flat and latency rising, UDP latency
    flat);
17. (Z14) hardware-in-the-loop calibration (``runtime.calibrate``, fused) at
    batch 8 over relu1, pool16, pool23 and fc0_relu, the AE cuts through
    both codec kernels; the table's JSON round trip, each cut's frame
    length, its measured cells priced through ``measure_flow`` beside the
    analytic ``server-gpu`` profile, fed to the simulator, and
    ``HILPlatform.measure`` of the unsplit forward;
18. (Z15) fault recovery in the split runtime (``SplitRuntime(faults=,
    recovery=)``, a twin of ``benchmarks/bench_faults.py``) at both trained
    AE cuts, 16 requests at batch 1: with no faults the SEI1 frames byte for
    byte and fused logits equal to eager; under the chaos plan every request
    answered, the ones not degraded bit for bit the fault-free run's, the
    degraded ones within their rung's bar, and every request's fates equal
    to a CPU run of the same plan; under a blackout every request on the
    local fallback; then a 4-slot ``TailServer(faults=)`` that rejects
    corrupted frames and serves nothing inside a blackout window;
19. (Z16) the fleet layers (twins of ``examples/fleet_planning.py`` and
    ``examples/adaptive_replanning.py``): ``DeploymentPlanner`` over three
    device classes and a 1000-request diurnal trace, its accuracy legs on the
    card over Z13's images, its server stage priced by Z14's table; the event
    and vectorized cluster engines held together on the suggested plans, the
    card's plan points to a CPU planner's over 2 images, and
    ``AdaptiveController.from_planner`` deciding the same under both engines;
20. (Z17) the paper's design flow through the ``Study`` facade (twins of
    ``examples/quickstart.py``, ``examples/multi_tier.py``,
    ``tests/test_obs.py::test_study_observe_fleet_and_runtime`` and
    ``benchmarks/bench_api.py``'s hand-stitched comparison) on phase 4's
    VGG16 and Z11's images, telemetry armed: ``profile`` (held to a direct
    ``cumulative_saliency``), ``candidates``, ``bottlenecks`` at the SC cuts,
    ``calibrate`` (fused), ``simulate`` (each measured verdict held to a
    direct ``measure_flow`` with the study's table), the path mode and a
    tier plan over ``tests/test_multitier.py``'s topology (deployed, held to
    the plain chain), the fleet planner over Z16's classes with its
    observed joint run, ``adapt`` on Z16's rush, a deploy of the top SC cut
    (held to the plain chain) and a 4-slot tail server for 4 clients; the
    Chrome trace's span names; then ``fit`` on a second study, its first
    step replayed on the CPU; each verb's host seconds and peak memory;
20b. (Z26) the multi-pod split pipeline (``core/split.py``
    ``multipod_split_step``, the twin of ``examples/multipod_pipeline.py``
    and ``benchmarks/bench_multipod_wire.py``): llama3-8b whole in bf16
    (random weights, seed 0), B 8 of 2048 tokens in 4 microbatches, its two
    stages as two ``gloo`` ranks spawned on the one card, each handed its
    ``stage_params`` by CUDA IPC, in three wire modes (the bf16 residual
    stream, the f32 latent of a rate-0.5 AE, int8 codes and row scales
    through the codec kernels); each mode's tail logits held bit for bit to
    the one-process composition (``sequential_split_step``), the raw one also
    to one ``forward`` under Z4's rule; the bytes sent, each rank's
    launches, its host-clock step beside the composition's, its busy share
    and peak; the codec kernels timed at the wire's shape (N 4096, C 4096,
    L 2048); then the two launchers as a user runs them:
    ``python -m repro_torch.launch.serve`` on llama3.2-3b whole (its tokens
    equal to a ``ServingEngine`` run here, its last line naming the card)
    and ``python -m repro_torch.launch.train`` on rwkv6-1.6b whole for 2
    steps with ``--ckpt`` (the checkpoint restored bit for bit equal to the
    same run's parameters made here);
20c. (Z27) sharded training (``sharding/rules.py``, ``sharding/blocks.py``,
    ``make_train_step`` on a mesh, the twin of the reference's
    ``launch/train.py --mesh`` step): llama3.2-3b at full width in bf16 cut
    to 8 of its 28 layers (random weights, seed 0), one ``token_batch`` of
    B 4 x S 1024, ``OptConfig()``, 2 steps, first as the one-process step,
    then as four ``gloo`` ranks spawned on the one card on a ("data",
    "model") = (2, 2) mesh, each holding its blocks of the train state,
    gathering each layer's weights as it runs and reducing the gradients
    back (host-staged collectives); each step's loss held to the
    one-process step's (1e-2 relative), every block to its part of the
    one-process parameters, mapped by CUDA IPC (AdamW's step size, 2 lr a
    step, plus one ulp a step), each rank's launches to the code's (8
    flash forwards and 8 recomputes on ``wgmma_bf16``, 8 backwards on
    ``bwd_bf16`` a step); then depth-2 f32 llama (B 4, S 512) the same way
    (both runs in one spawn of the four ranks), its losses at 1e-6, ``m``
    after step 1 within 1e-5 of each leaf's max and ``m``, ``v`` after step
    2 within 1e-4; each rank's step ms (the first step on the host clock,
    the last under ``device_breakdown``), busy share, peak and the bytes its
    collectives moved, beside the one-process step's ms and peak;
20d. (Z28) sharded serving (``sharding/parallel.py``; ``prefill``,
    ``serve_step`` and ``ServingEngine`` with a mesh, the twin of the
    reference's ``shard_fn=`` serving path): llama3.2-3b whole in bf16
    (random weights, seed 0), B 4 x a 512-token prompt, 16 new tokens,
    first through the one-process ``ServingEngine`` and a teacher-forced
    replay (and the replay again with every embedding entry moved by one
    rounding), then as four ``gloo`` ranks spawned on the one card, on
    ("data", "model") = (1, 4) and (2, 2) meshes in one spawn, each drawing
    its inference-profile blocks block by block, serving the requests
    through ``ServingEngine(mesh=)`` and replaying the one-process tokens:
    each step's logits and each rank's cache blocks held to the one-process
    run's (2e-2 of the max; the one-ulp response printed beside it), the
    served tokens equal on every rank (where they part from the one-process
    tokens, the top-2 margins there printed), 28 ``wgmma_bf16`` flash forwards a rank at the prefill
    (on its 6 or 12 query heads) and none at decode; each rank's prefill
    ms, decode ms a token, busy share, peak and collective bytes beside the
    one-process figures; then ``flash_attention`` at a rank's heads
    (``SERVE_SHARDED_FLASH``) against its plain version, as Z2's rows;
20e. (Z29) sharded serving of the recurrent and encoder-decoder families
    (``Plan.tm_heads``, ``Plan.mamba_split`` with its ``in_proj``
    exchange, cross heads; the reference's ``shard_fn=`` serving with its
    recurrent and cross caches under ``cache_specs``): rwkv6-1.6b whole,
    jamba-v0.1-52b as served (``moe=None``) at one 8-layer period and
    whisper-tiny whole, full width in bf16 (random weights, seed 0), B 4 x a
    512-token prompt (whisper over N(0, 1) frames), 16 new tokens, first
    each through the one-process ``ServingEngine`` (counted) and a
    teacher-forced replay (and the replay with every embedding and frame
    entry moved by one rounding), then as four ``gloo`` ranks spawned on the
    one card, on (1, 4) and (2, 2) meshes in one spawn, each drawing its
    blocks block by block and replaying prefill and decode under the mesh:
    each step's logits and each rank's blocks of every cache leaf (``wkv``,
    ``tm_prev``, ``cm_prev``, ``conv``, ``ssm``, ``ck``, ``cv``, ``k``,
    ``v``; ``kv_pos`` exactly) held to the one-process run's (the larger of
    2e-2 of the max and twice the one-ulp response, leaf by leaf), each
    rank's launches to the code's (``rwkv6_scan`` 24 at the prefill and 24
    a step on its 8 or 16 heads, ``mamba_scan`` 7 and 7 on its 2048 or 4096
    channels, flash on ``wgmma_bf16`` at the prefill only: jamba's attention
    layer, whisper's encoder, self- and cross-attention); each rank's
    prefill ms, decode ms a token, busy share, peak and collective bytes
    beside the one-process figures; then ``rwkv6_scan``, ``mamba_scan`` and
    ``flash_attention`` at a rank's share (``SERVE_RECURRENT_RWKV``,
    ``SERVE_RECURRENT_MAMBA``, ``SERVE_RECURRENT_FLASH``) against their plain
    versions, as Z3's, Z7's and Z2's rows;
21. print the kernels' launch counts with their errors, times and bounds as
    one JSON line (the three backward kernels with their training runs'
    launches), then ``{"ok": true, "device": ...}``.

Each path (phases 4-5, Z4, Z5, Z6, Z8-Z10, Z18-Z25, Z11, Z12's training and its
deploy, Z13, Z14, each part of Z15, Z16, Z17 and its ``fit``, Z26's composition
and each of its ranks' steps, Z27's one-process steps and each of its ranks'
steps, Z28's one-process run and each rank's served run, prefill and decode, Z29's
one-process runs and each rank's prefill and decode) runs with the
launch counts set to 0 just before it and read just after; a served run's
prefill and decode are counted apart as well, and ``flash_attention``'s
launches by route (``wgmma_bf16`` for a bf16 model, ``simt_f32`` for an f32
one; a training step's backward routes, ``bwd_bf16`` or ``bwd_f32``, and
``rwkv6_scan``'s and ``mamba_scan``'s ``bwd``, apart).  Z11, Z12's training, Z13, Z16 and Z17's
``fit`` launch no kernel (VGG16's layers are cuDNN and cuBLAS, and the codec
wrappers refuse an input that requires grad; the simulator runs the plain
f32 forward); Z14, Z15 and Z17 launch each codec kernel a number of times
worked out from the code (Z15: from the rungs each request took; Z17: its
calibrate at each AE cut, its two deploys' infers at each hop with an AE,
and its 4 clients).  Any failed check raises, so the script exits
non-zero and prints no result.  It exits non-zero as well where CUDA is not
available.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import contextlib
import io
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api import NetworkPath, Study, Tier, TierTopology  # noqa: E402
from repro_torch.api.study import fit_loss  # noqa: E402
from repro_torch.api.types import AnalyticCost, CostStack, legal_split_candidates  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.core import bottleneck as B  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.core.qos import rank_candidates  # noqa: E402
from repro_torch.core.saliency import (candidate_split_points, cumulative_saliency,  # noqa: E402
                                       layer_saliency_maps)
from repro_torch.core.bottleneck import latent_channels  # noqa: E402
from repro_torch.core.scenarios import (PLATFORMS, HILPlatform, Scenario,  # noqa: E402
                                        scenario_times_and_payload)
from repro_torch.core import split as SP  # noqa: E402
from repro_torch.core.split import SplitPlan  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ref, reset_launches, tiles  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.sharding import blocks as shard_blocks  # noqa: E402
from repro_torch.sharding import rules as sharding_rules  # noqa: E402
from repro_torch.kernels import bottleneck_compress as comp  # noqa: E402
from repro_torch.kernels import bottleneck_decompress as decomp  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.mamba import mamba_seq  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.data.synthetic import token_batch, toy_image_iter, toy_images  # noqa: E402
from repro_torch.models.vgg import feature_index, vgg16  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.optimizer import OptConfig, adam_init, adam_update  # noqa: E402
from repro_torch.training.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.qos import QoSRequirements  # noqa: E402
from repro_torch.fleet import (PCTL_RTOL, AdaptiveController, ControllerConfig,  # noqa: E402
                               DeploymentPlanner, DeviceClass, Phase, RegimeChangeTrace,
                               SearchSpace, generate_trace, simulate_deployment)
from repro_torch.fleet.vectorized import PCTL_ATOL  # noqa: E402
from repro_torch.netsim.channel import INTERFACES, Channel  # noqa: E402
from repro_torch.netsim.simulator import (ApplicationSimulator, NetworkConfig,  # noqa: E402
                                          flow_latency_s, measure_flow)
from repro_torch.runtime import wire as W  # noqa: E402
from repro_torch.runtime.calibrate import CalibrationTable, calibrate  # noqa: E402
from repro_torch.runtime.engine import SplitRuntime, TailServer, run_clients  # noqa: E402
from repro_torch.runtime.faults import FaultPlan, RecoveryPolicy  # noqa: E402
from repro_torch.runtime.partition import make_partition  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher, StreamRequest  # noqa: E402
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
# at the jamba-v0.1-52b prefill (H 32, K 8: a GQA group of 4, not 3), at the
# deepseek-moe-16b prefill (H 16, K 16: a GQA group of 1) and around them:
# (label, B, Sq, Sk, H, K, D, causal, window, dtype)
# Each mask also in f32, where the bar (1e-5) is far below what a key off by
# one at the window's or the alignment's edge would move; the bf16 rows run
# the mask-edge probe for that.
FLASH_SHAPES = [
    ("llama_prefill", 4, 2000, 2000, 24, 8, 128, True, None, torch.bfloat16),
    ("llama_f32", 4, 1000, 1000, 24, 8, 128, True, None, torch.float32),
    ("jamba_prefill", 4, 2000, 2000, 32, 8, 128, True, None, torch.bfloat16),
    ("jamba_prefill_f32", 4, 2000, 2000, 32, 8, 128, True, None, torch.float32),
    ("deepseek_prefill", 4, 2000, 2000, 16, 16, 128, True, None, torch.bfloat16),
    ("deepseek_prefill_f32", 4, 2000, 2000, 16, 16, 128, True, None, torch.float32),
    ("window512", 4, 2000, 2000, 24, 8, 128, True, 512, torch.bfloat16),
    ("window512_f32", 4, 2000, 2000, 24, 8, 128, True, 512, torch.float32),
    ("noncausal", 4, 1000, 1000, 24, 8, 128, False, None, torch.bfloat16),
    ("noncausal_f32", 4, 1000, 1000, 24, 8, 128, False, None, torch.float32),
    ("sq500_sk2000", 4, 500, 2000, 24, 8, 128, True, None, torch.bfloat16),
    ("sq500_sk2000_f32", 4, 500, 2000, 24, 8, 128, True, None, torch.float32),
    ("ragged777", 4, 777, 777, 24, 8, 128, True, None, torch.bfloat16),
    ("ragged777_f32", 4, 777, 777, 24, 8, 128, True, None, torch.float32),
    # whisper-tiny at head dim 64 (H 6, K 6) on Z4's longest prompt: the
    # encoder over its 1500 frames (no mask, 1500 not a multiple of the
    # 128-key tile), the decoder's self-attention, and its cross-attention,
    # 2000 queries over the 1500 frames' keys (Sq > Sk, no mask); a window at
    # D 64 for the probe's falling edge; internvl2-76b's prefill, 256 patches
    # before Z4's 2000 tokens (H 64, K 8, D 128)
    ("whisper_enc", 4, 1500, 1500, 6, 6, 64, False, None, torch.bfloat16),
    ("whisper_enc_f32", 4, 1500, 1500, 6, 6, 64, False, None, torch.float32),
    ("whisper_dec", 4, 2000, 2000, 6, 6, 64, True, None, torch.bfloat16),
    ("whisper_dec_f32", 4, 2000, 2000, 6, 6, 64, True, None, torch.float32),
    ("whisper_cross", 4, 2000, 1500, 6, 6, 64, False, None, torch.bfloat16),
    ("whisper_cross_f32", 4, 2000, 1500, 6, 6, 64, False, None, torch.float32),
    ("window512_d64", 4, 2000, 2000, 6, 6, 64, True, 512, torch.bfloat16),
    ("window512_d64_f32", 4, 2000, 2000, 6, 6, 64, True, 512, torch.float32),
    ("internvl_prefill", 4, 2256, 2256, 64, 8, 128, True, None, torch.bfloat16),
    ("internvl_prefill_f32", 4, 2256, 2256, 64, 8, 128, True, None, torch.float32),
    # qwen3-moe-235b-a22b's prefill on Z4's prompts: H 64 over K 4 (a GQA
    # group of 16), n_heads * head_dim = 8192 against d_model 4096
    ("qwen3_prefill", 4, 2000, 2000, 64, 4, 128, True, None, torch.bfloat16),
    ("qwen3_prefill_f32", 4, 2000, 2000, 64, 4, 128, True, None, torch.float32),
]
# flash_attention against its plain version, as tests/test_kernels.py holds
# the TPU kernel to its ref
FLASH_BAR = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# beside it in bf16, element by element, a bar relative to |o|: the kernel
# rounds each softmax weight and each output to bf16 (at most 2**-8 of the
# value each), so |kernel - plain| <= 2**-8 (|o| + (P|V|)), with P|V| the
# plain attention over |v|; the bar allows twice that, one bf16 step of o.
# At |o| >= 4 that step (0.031) is past the absolute bar's 2e-2, and at |o|
# near 0.1 the absolute bar lets 20% through
FLASH_BF16_STEP = 2.0 ** -7
# the row log-sum-exp the forward keeps for the backward (flash_attention_lse)
# against ref.flash_attention_lse_ref, absolute (lse is near ln Sk + 0.5 at
# these shapes, 7-9, where an f32 step is 4.8e-7 to 9.5e-7): f32 sums in
# another order; in bf16 also the scores summed on the tensor cores, the
# softmax in base 2 and lse taken back to base e (at most 1.9e-6 over
# twelve backward shapes on an H100 before this bar was set)
FLASH_LSE_BAR = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
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
                ("served_a", 4, 2000, 8192, 16, False, True),
                ("jamba_train", 1, 4096, 8192, 16, False, False)]
# Z2b: flash_attention's backward (csrc/flash_attention_bwd.cu) at the
# shapes training gives it: llama3.2-3b's train_4k step (B 1, S 4096), the
# llama prefill row's shape, window512_d64, whisper-tiny's encoder and its
# cross-attention at 448 text tokens over 1500 frames, and the cross-attention
# at Sq > Sk: (label, B, Sq, Sk, H, K, D, causal, window, dtype)
FLASH_BWD_SHAPES = [
    (label + suffix, *shape, dtype)
    for label, *shape in [("llama_train", 1, 4096, 4096, 24, 8, 128, True, None),
                          ("llama_prefill", 4, 2000, 2000, 24, 8, 128, True, None),
                          ("window512_d64", 4, 2000, 2000, 6, 6, 64, True, 512),
                          ("whisper_enc", 4, 1500, 1500, 6, 6, 64, False, None),
                          ("whisper_cross", 4, 448, 1500, 6, 6, 64, False, None),
                          ("whisper_cross_sq2000", 4, 2000, 1500, 6, 6, 64, False, None)]
    for suffix, dtype in (("", torch.bfloat16), ("_f32", torch.float32))]
# each gradient against the plain backward and autograd through the plain
# forward, relative to its max |g|: f32 sums in another order; in bf16 the
# gradients are rounded to bf16 and the kernel's delta = rowsum(dO o) reads
# its forward's output, whose softmax weights were rounded to bf16
FLASH_BWD_BAR = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Z5b: rwkv6_scan's backward (csrc/rwkv6_scan_bwd.cu) at Z3's rwkv prefill
# shape and at rwkv6-1.6b's train_4k step (B 1, S 4096, H 32, D 64), from a
# nonzero start state with a nonzero final-state gradient, the train row at
# the served model's decays: (label, B, S, H, D, served decays)
RWKV_BWD_SHAPES = [("rwkv_prefill", 4, 1000, 32, 64, False),
                   ("rwkv_train", 1, 4096, 32, 64, True)]
RWKV_BWD_BAR = 1e-4
# Z7b: mamba_scan's backward (csrc/mamba_scan_bwd.cu) at jamba-v0.1-52b's
# train_4k step (B 1, S 4096, d_inner 8192), Z7's prefill and the prefill at
# the served model's own A, from a nonzero start state with nonzero gradients
# of y and of the final state: (label, B, S, di, served A); RWKV_BWD_BAR's bar
MAMBA_BWD_SHAPES = [("jamba_train", 1, 4096, 8192, False),
                    ("jamba_prefill", 4, 2000, 8192, False),
                    ("served_a", 4, 2000, 8192, True)]
MAMBA_BWD_BAR = 1e-4
# Z5b, Z7b: profiled calls whose median gives each backward kernel's time
PHASE_RUNS = 3
# Z24: training on one card, bf16, OptConfig() (lr 3e-4, b1 0.9, b2 0.95,
# clip 1.0, f32 moments, no master copy): TRAIN_STEPS steps on one
# data.synthetic.token_batch (seed 0).  train_4k's sequence at batch 1 (its
# global batch of 256 cut to one card's 1); whisper-tiny at batch 4 over 448
# text tokens and its 1500 frames (numpy seed FRONT_SEED); jamba-v0.1-52b
# (moe=None) at full width cut to one period of 8 layers (7 Mamba, 1
# attention; 2.698 B parameters, 26.98 GB of train state, bf16 weights with f32
# moments at 10 bytes a parameter; whole, 9.18 B parameters take about 92 GB,
# more than one card's 80 GB): (arch, layers or None for whole, B, S)
TRAIN_STEPS = 6
TRAIN_LR = 3e-4
TRAIN_RUNS = [("llama3.2-3b", None, 1, 4096), ("rwkv6-1.6b", None, 1, 4096),
              ("whisper-tiny", None, 4, 448), ("jamba-v0.1-52b", 8, 1, 4096)]
# Z24d: the gradients on the card (kernels) against the CPU (plain
# versions), f32, same weights and batch: (arch, layers or None for whole,
# B, S); the loss within 1e-5 relative, every leaf within 1e-4 of its max
# |g| (a key bias, whose gradient is 0 in exact arithmetic, at its wk's
# scale) or, as Z4 holds logits, within ULP_FACTOR times the CPU gradient's
# own response to one rounding at its input (the last bit of every
# embedding entry flipped), whichever is larger.  jamba (one 8-layer period
# at full width) at S 256: its CPU side, the plain Python scan over 7 Mamba
# layers and 2.7 B f32 weights, twice, took 110 s at S 512
GRAD_RUNS = [("llama3.2-3b", 2, 1, 512), ("rwkv6-1.6b", 2, 1, 512), ("whisper-tiny", None, 1, 448),
             ("jamba-v0.1-52b", 8, 1, 256)]
ZOO_LOSS_RTOL, ZOO_GRAD_RTOL = 1e-5, 1e-4
# Z25: the Study facade over zoo models on the card, bf16 and whole, and f32
# copies held to the same study on the CPU: the CS curve within CS_ATOL, the
# candidate labels equal.  At depth 2 the min-max normalised curve is [1, 0]
# whatever the maps, so the copies keep ZOO_STUDY_LAYERS layers.  Each
# block's raw map (alpha-weighted, summed over channels of either sign) is
# printed beside: rwkv's part from the CPU's by 2.6e-4 to 5.1e-4 of max on
# the card's plain path alone, without a kernel (a diagnostic call, PR 32)
# jamba-v0.1-52b with moe=None (configs.SERVED), whole in bf16 (18.38 GB);
# its copy keeps one 8-layer period, since a depth cut holds whole periods
ZOO_STUDIES = ("llama3.2-3b", "rwkv6-1.6b", "jamba-v0.1-52b")
ZOO_STUDY_LAYERS = 4
# Z26: the multi-pod split pipeline (core/split.py), the twin of
# examples/multipod_pipeline.py and benchmarks/bench_multipod_wire.py:
# llama3-8b whole in bf16, B 8 of 2048 tokens in 4 microbatches (the
# benchmark's B 32 cut to 8, which keeps the tail's logits at 4.2 GB), an AE
# at rate 0.5, the two stages as two gloo ranks on the one card; one counted
# step a mode, then MULTIPOD_STEPS timed between barriers, then one profiled
MULTIPOD_ARCH = "llama3-8b"
MULTIPOD_BATCH, MULTIPOD_SEQ, MULTIPOD_MICRO = 8, 2048, 4
MULTIPOD_STEPS = 3
MULTIPOD_TIMEOUT_S = 600
# the bytes the head sends a step: the bf16 residual stream, the f32 latent,
# int8 codes and one f32 scale a token
MULTIPOD_WIRE_BYTES = {"raw": 8 * 2048 * 4096 * 2, "ae_f32": 8 * 2048 * 2048 * 4,
                       "ae_int8": 8 * 2048 * 2048 + 8 * 2048 * 4}
# Z26's launchers as a user runs them: serve llama3.2-3b whole; train
# rwkv6-1.6b whole (1.597 B parameters, a 6.4 GB f32 checkpoint: the
# smallest full-width model the train launcher takes, since whisper-tiny
# needs frames its token stream does not carry) for 2 steps at the
# launcher's batch 8 of 64 tokens
LAUNCH_SERVE = ["--arch", "llama3.2-3b", "--full-size"]
LAUNCH_TRAIN = ["--arch", "rwkv6-1.6b", "--full-size", "--steps", "2", "--log-every", "1"]
# Z27: sharded training (sharding/, training/train.py on a mesh), the twin
# of the reference's launch/train.py --mesh step: llama3.2-3b at full width
# in bf16 (seed 0), one token_batch of B 4 x S 1024, OptConfig(),
# SHARDED_STEPS steps, first as the one-process step on the card, then as
# four gloo ranks spawned on the one card on a ("data", "model") = (2, 2)
# mesh (a row a rank); then depth-2 f32 llama (B 4, S 512) the same way:
# (dtype, layers or None for whole, B, S).  The bf16 run is cut to 8 of 28
# layers: gloo moves the collectives' operands through host memory at about
# 0.3-0.5 GB/s a rank, so a whole-depth step took 58.7 s (30 GB of operands;
# an H100 80GB HBM3 at 700 W), 12 layers 22.7-36.7 s, and the phase is kept
# under 150 s
SHARDED_ARCH = "llama3.2-3b"
SHARDED_MESH = ((2, 2), ("data", "model"))
SHARDED_RUNS = [("bfloat16", 8, 4, 1024), ("float32", 2, 4, 512)]
SHARDED_STEPS = 2
SHARDED_TIMEOUT_S = 600
# each sharded step's loss against the one-process step's, relative: bf16
# rows split over ranks round otherwise (gradients summed in bf16 over the
# ranks); f32 sums in another order.  The f32 m after step 1 within 1e-5
# of each leaf's max (m is then the clipped gradient times 1 - b1, so this
# holds the gradients); m and v after step 2 within the reference's
# cross-device bar (tests/test_multipod.py), 1e-4, since AdamW moves a
# weight whose gradient is near its eps by a share of lr that the
# gradient's last bits set, and step 2's gradient is taken there (6.1e-5 of
# max measured on an H100).  Every parameter within AdamW's own step size,
# 2 lr a step (a gradient near 0 may take either sign), plus one ulp a step
# (each run rounds the parameter once a step; one ulp of the bf16 bound
# alone was passed 1.0045-fold on an H100); a block put in the wrong place
# misses by the weights' scale
SHARDED_LOSS_RTOL = {"bfloat16": 1e-2, "float32": 1e-6}
SHARDED_MOMENT = {"step 1": 1e-5, "step 2": 1e-4}
# Z28: sharded serving (sharding/parallel.py; prefill, serve_step and
# ServingEngine with a mesh), the twin of the reference's shard_fn= serving:
# llama3.2-3b whole at full width in bf16 (seed 0), B 4 x a 512-token prompt,
# NEW_TOKENS new tokens, first the one-process ServingEngine and a
# teacher-forced replay on the card, then four gloo ranks spawned on the one
# card on ("data", "model") = (1, 4) and (2, 2) meshes in one spawn, each
# serving the same requests through ServingEngine(mesh=) and the replay's
# prefill and decode steps fed the one-process tokens
SERVE_SHARDED_ARCH = "llama3.2-3b"
# flash_attention at a rank's heads in sharded serving, held as FLASH_SHAPES'
# rows are, after Z28, the last phase.  llama3.2-3b on (1, 4) (24 / 4 query
# heads over 8 / 4 kv heads) and on (2, 2) (2 rows a data shard, 12 over 4),
# B 4 x 512 tokens; internvl2-76b on (1, 4) in the four-card test, 256
# patches and 1024 tokens (16 over 2: a GQA group of 8)
SERVE_SHARDED_FLASH = [
    ("llama_tp4", 4, 512, 512, 6, 2, 128, True, None, torch.bfloat16),
    ("llama_tp2x2", 2, 512, 512, 12, 4, 128, True, None, torch.bfloat16),
    ("internvl_tp4", 4, 1280, 1280, 16, 2, 128, True, None, torch.bfloat16),
]
SERVE_SHARDED_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SERVE_SHARDED_PROMPT = 512
SERVE_SHARDED_TIMEOUT_S = 300
# each step's logits against the one-process step's, relative to its max
# |logit|, and each k, v cache block against its part of the one-process
# cache, relative to the whole leaf's max: bf16 products over a rank's heads
# and hidden units, the row-parallel sums added in f32 and rounded once
# where one product rounds once in another order, so some bf16 roundings
# differ and the layers carry them (on an H100: logits 1.88e-2 at (1, 4) and
# 1.875e-2 at (2, 2), cache blocks up to 1.65e-2, the same in every run).
# The one-process run's response to every embedding entry moved by one
# rounding (3.6e-2 of max |logit|) is printed beside it, not a bar.
SERVE_SHARDED_RTOL = 2e-2
# its bar, relative to max |plain| of y and of the final state: f32 in
# another order (fused multiply-adds, the kernel's own sum over d_state in
# two lanes' partials) and exp as ex2.approx of a pre-scaled argument
MAMBA_RTOL = 1e-5
# jamba-v0.1-52b as served whole (configs.SERVED: every FFN the dense
# SwiGLU; with its MoE, 51.5 B parameters, it does not fit one card); Z4's
# prompts.  Z21: with its MoE (16 experts top-2 on every second layer) at
# full width, cut in depth: 16 of 32 layers (two periods) in bf16 (52.0 GB),
# one period in f32 (53.1 GB), and its first two layers (a Mamba mixer with
# its dense FFN, then one with its MoE) in f32 on the card against the CPU
JAMBA = "jamba-v0.1-52b"
JAMBA_MOE_BF16_LAYERS, JAMBA_MOE_F32_LAYERS = 16, 8
# Z22: qwen3-moe-235b-a22b (94 layers, every one MoE: 128 experts top-8;
# H 64, K 4, head dim 128) at full width, cut in depth: 8 layers in bf16
# (42.3 GB; at init the model, one stacked expert leaf of 12.9 GB and the f32
# embedding of 2.5 GB), 4 in f32 (44.8 GB), and a one-layer f32 copy against
# the CPU (14.9 GB of f32 weights on the host)
QWEN3 = "qwen3-moe-235b-a22b"
QWEN3_BF16_LAYERS, QWEN3_F32_LAYERS = 8, 4
# Z23: the continuous batcher (serving.continuous) on 4 slots, llama3.2-3b
# and rwkv6-1.6b whole in bf16 and in f32: 8 requests, Z4's prompts (rwkv: Z5's) then 4
# drawn with numpy seed 2 of 1-2000 tokens, arriving at these ticks with
# these max_new, so slots free and refill while others decode
BATCHER_SLOTS = 4
BATCHER_ARRIVALS = (0, 0, 0, 0, 3, 5, 8, 13)
BATCHER_MAX_NEW = (16, 4, 9, 16, 16, 7, 16, 5)
# Z18: deepseek-moe-16b (the reference's config: all 28 layers MoE, 64 routed
# experts top-6 and 2 shared, capacity factor 1.25) on Z4's prompts, in bf16
# at full depth and in f32 cut to DEEPSEEK_F32_LAYERS (the full-depth f32
# weights, 67.5 GB, and one stacked expert leaf, 20.7 GB, do not fit)
DEEPSEEK = "deepseek-moe-16b"
DEEPSEEK_F32_LAYERS = 14
# the depth of Z18c's, Z20c's and Z22c's f32 copies against the CPU: one
# layer each (every one of deepseek's and qwen3's is MoE), cut from 2 when
# zoo training joined the script, whose CPU halves of these copies took 23,
# 53 and 80 s of a 650 s run (PR 32)
E2E_MOE_LAYERS = 1
# Z19: whisper-tiny whole (4 encoder and 4 decoder layers) on Z4's prompts;
# Z20: internvl2-76b at full width, Z4's prompts after its 256 patches, cut
# in depth: 24 of 80 layers in bf16 (45.5 GB of weights; the model plus one
# stacked w_gate leaf, 11.3 GB, at init), 8 in f32 (36.2 GB).  Each served
# run feeds zero frames or patches, as ServingEngine does; each hold feeds
# N(0, 1) ones from numpy seed 0 (FRONT_SEED): zero frames would leave the
# encoder's projection untested
WHISPER = "whisper-tiny"
INTERNVL = "internvl2-76b"
INTERNVL_BF16_LAYERS, INTERNVL_F32_LAYERS = 24, 8
FRONT_SEED = 0
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
# Z17's fit replay: the card's gradient against the CPU's of the same weights
# and batch, leaf by leaf over the leaf's max |g|, each on its own branch.
# Where the two forwards round a ReLU input to other sides of 0, or a pool's
# two largest inputs the other way round, the gradients part by up to 4.4e-3
# of a leaf's max (see BRANCH_RTOL); a leaf the card gets wrong or leaves at
# zero reads about 1
GRAD_RTOL = 2e-2
# Z12's finetune replay takes the CPU's gradient on the card's branch: each
# ReLU passes where the card's input was > 0 and each 2x2 pool takes the
# card's element.  A step has 3-9 ReLU inputs that the card and the CPU
# round to other sides of 0 and 4-6 pools they resolve the other way; on
# its own branch the CPU's gradient parts from the card's by 1.8e-3 to
# 4.4e-3 of a leaf's max, and by 0.0251 in two runs, while on the card's it
# parts by 3.1e-6 to 8.6e-6 (tools/z12_card_state_probe.py on an H100, 24
# steps).  The branch is held too: each ReLU input the card sends the other
# way, and each pool element it takes instead of the CPU's, lies within
# BRANCH_RTOL of the CPU's choice over the layer's max |input| (read: at
# most 1.1e-6), the loss's bar; the gradient on it within BRANCH_GRAD_RTOL
# of each leaf's max, about ten times the largest reading
BRANCH_RTOL = 1e-4
BRANCH_GRAD_RTOL = 1e-4
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
# Z17: the Study facade (repro_torch.api.study), a twin of examples/quickstart.py,
# examples/multi_tier.py, tests/test_obs.py::test_study_observe_fleet_and_runtime and
# benchmarks/bench_api.py's hand-stitched comparison, on phase 4's VGG16 (the same
# seed) and Z11's images (its toy labels: on random weights the measured accuracies
# are chance, so the QoS bars below ask for none)
STUDY_AE_STEPS = 20
STUDY_REL = 1e-9              # a facade verdict against the direct measure_flow
# tests/test_multitier.py:147-150 and :275-282; tier plans priced a frame at a time
# (batch=1): the fastest 2-cut plan over the mcu tier takes 2.1 s a frame
STUDY_PATH = ((1e-3, 20e6, 20e6, 1), (1e-3, 30e6, 30e6, 2))
STUDY_TIERS = (("device", "mcu"), ("edge", "edge-accelerator"), ("cloud", "server-gpu"))
STUDY_LINK_QOS = {"max_latency_s": 1.0, "min_accuracy": 0.0}
STUDY_TIER_QOS = {"max_latency_s": 5.0, "min_accuracy": 0.0}
STUDY_FLEET_REQUESTS, STUDY_FLEET_SPACE = 300, {"protocols": ("tcp", "udp"),
                                                "batch_sizes": (1, 8), "replica_counts": (1, 2)}
STUDY_RUSH_SPACE = {"batch_sizes": (1, 8, 64), "replica_counts": (1,), "top_k_splits": 1}
STUDY_CLIENTS = 4
STUDY_FIT_STEPS, STUDY_FIT_BATCH, STUDY_FIT_SEED = 3, 8, 1
# Z29: sharded serving of the recurrent and encoder-decoder families (the
# twin of the reference's shard_fn= serving with its recurrent and cross
# caches under cache_specs): (arch, config changes) at full width in bf16
# (seed 0): rwkv6-1.6b whole (24 layers, 32 heads of 64), jamba-v0.1-52b as
# served (moe=None) at one 8-layer period (its attention layer and 7 Mamba
# layers) and whisper-tiny whole (6 heads: 3 a rank at (2, 2), run whole at
# (1, 4)); B 4 x a 512-token prompt (whisper over N(0, 1) frames), first
# served in one process through ServingEngine and replayed teacher-forced,
# then four gloo ranks spawned on the one card, on the (1, 4) and (2, 2)
# meshes of SERVE_SHARDED_MESHES in one spawn, each replaying prefill and
# NEW_TOKENS decode steps under the mesh on its blocks.  Bars: each step's
# logits, and each cache leaf's blocks, within SERVE_SHARDED_RTOL of the
# one-process run's max, or within twice that run's response to every
# embedding and frame entry moved by one rounding where that is larger
# (PERF.md's rule for bf16 served logits; bf16 rwkv's response is a fifth of
# max |logit| on an H100, so its bars are loose, as Z23's are)
SERVE_RECURRENT = [("rwkv6-1.6b", {}), (JAMBA, {"n_layers": 8}), (WHISPER, {})]
SERVE_RECURRENT_TIMEOUT_S = 600
# the scans and flash at a rank's share of Z29's prefill, held against their
# plain versions as RWKV_SHAPES', MAMBA_SHAPES' and FLASH_SHAPES' rows are (a
# prefill starts from a zero state; the served model's decays and A):
# rwkv6-1.6b's 8 heads a rank at (1, 4) and 16 at (2, 2) (2 rows), jamba's
# d_inner 8192 as 2048 channels a rank at (1, 4) and 4096 at (2, 2), and
# whisper-tiny's encoder at (2, 2): 3 heads of 64 over 1500 frames, 2 rows
SERVE_RECURRENT_RWKV = [("rwkv_tp4", 4, 512, 8, 64, False, True),
                        ("rwkv_tp2x2", 2, 512, 16, 64, False, True)]
SERVE_RECURRENT_MAMBA = [("mamba_tp4", 4, 512, 2048, 16, False, True),
                         ("mamba_tp2x2", 2, 512, 4096, 16, False, True)]
SERVE_RECURRENT_FLASH = [
    ("whisper_enc_tp2", 2, 1500, 1500, 3, 3, 64, False, None, torch.bfloat16)]


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


def once_ms(fn) -> float:
    """Time of one call after one warm-up, CUDA events around it: for the
    plain versions, long loops of small launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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
    """The ae8 chain at ``cuts`` with the plain versions in place of the
    kernels; a cut with no AE in ``aes`` rides the int8 wire (no kernel)."""
    bounds = (0,) + tuple(c + 1 for c in cuts) + (len(model.layers),)
    cur = x
    with torch.inference_mode():
        for k, (a, b) in enumerate(zip(bounds, bounds[1:])):
            cur = model.apply_range(params, cur, a, b)
            if k == len(cuts):
                return cur
            ae = aes.get(cuts[k])
            if ae is None:
                cur = W.decode_arrays(W.wire_kind(None), *W.encode_arrays(cur))
                continue
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


def branch_loss(model, state, cut, x, y, branch=None, record=None) -> torch.Tensor:
    """``B.task_loss`` (mse) at ``cut`` on a VGG, written out layer by layer,
    the same ops on the branch it finds.  ``record`` gets each ReLU's and
    each pool's ``(kind, choice, input)``: the choice is the mask ``input >
    0`` or the pool's argmax.  ``branch``, such a record, replaces each ReLU
    by its mask and each pool by a gather of its element."""
    taken = iter(branch or ())
    params, ae = state["params"], state["ae"]

    def relu(t):
        if record is not None:
            record.append(("relu", (t > 0).cpu(), t.detach().cpu()))
        if branch is None:
            return torch.relu(t)
        return torch.where(next(taken)[1].to(t.device), t, 0.0)

    def pool(t):
        nchw = t.permute(0, 3, 1, 2)
        out, idx = F.max_pool2d(nchw, 2, 2, return_indices=True)
        if record is not None:
            record.append(("pool", idx.cpu(), t.detach().cpu()))
        if branch is None:
            return out.permute(0, 2, 3, 1)
        idx = next(taken)[1].to(t.device)               # (N, C, Ho, Wo) into H x W
        n, c, ho, wo = idx.shape
        return t.reshape(n, -1, c).gather(1, idx.flatten(2).transpose(1, 2)).view(n, ho, wo, c)

    def run(t, lo, hi):
        for layer, p in zip(model.layers[lo:hi], params[lo:hi]):
            t = (relu(t) if layer.kind == "relu" else pool(t) if layer.kind == "pool"
                 else layer.apply(p, t))
        return t

    z = relu(run(x, 0, cut + 1) @ ae["enc"]["w"] + ae["enc"]["b"])
    logits = run(B.decode(ae, z), cut + 1, len(model.layers))
    onehot = F.one_hot(y.long(), logits.shape[-1]).float()
    return torch.mean(torch.square(logits.float() - onehot))


def branch_moves(card, cpu) -> dict:
    """Where the card's branch leaves the CPU's: ReLU inputs sent to the
    other side of 0 (``flips``) and pools on another element (``moves``),
    and the largest distance of such a choice from the CPU's, on the CPU's
    inputs over the layer's max |input| (``rel``)."""
    out = {"flips": 0, "moves": 0, "rel": 0.0}
    for (kind, a, _), (_, b, v) in zip(card, cpu):
        bad = a != b
        if not bad.any():
            continue
        if kind == "relu":
            out["flips"] += int(bad.sum())
            far = v[bad].abs()
        else:
            out["moves"] += int(bad.sum())
            flat = v.permute(0, 3, 1, 2).flatten(2)
            far = (flat.gather(2, b.flatten(2)) - flat.gather(2, a.flatten(2)))[bad.flatten(2)]
        out["rel"] = max(out["rel"], float(far.max() / v.abs().max()))
    return out


def finetune_replay(model, params, ae, small) -> dict:
    """Finetune's first steps at REPLAY_BATCH images on the card, each held
    to the CPU from the card's own state: the same loss (TRAIN_RTOL,
    relative), a branch the CPU's rounding could have taken (BRANCH_RTOL),
    and on that branch the same gradient (BRANCH_GRAD_RTOL of each leaf's
    max).  A free-running replay cannot hold TRAIN_RTOL: Adam's first step
    sends a weight whose gradient is rounding-sized +-lr either way."""
    state = {"params": params, "ae": ae}
    opt = adam_init(state)
    gaps = {"loss": 0.0, "grad": 0.0, "branch": 0.0, "flips": 0, "moves": 0}
    for x, y in small:
        xc, yc = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y)
        xd, yd = xc.cuda(), yc.cuda()
        loss, g = B.value_and_grad(
            lambda st: B.task_loss(model, st["params"], st["ae"], FINETUNE_CUT, xd, yd), state)
        card_branch, cpu_branch = [], []
        state_cpu = to_cpu(state)
        with torch.no_grad():
            branch_loss(model, state, FINETUNE_CUT, xd, yd, record=card_branch)
            loss_cpu = branch_loss(model, state_cpu, FINETUNE_CUT, xc, yc, record=cpu_branch)
        moved = branch_moves(card_branch, cpu_branch)
        del cpu_branch
        _, g_cpu = B.value_and_grad(
            lambda st: branch_loss(model, st, FINETUNE_CUT, xc, yc, branch=card_branch),
            state_cpu)
        gaps["loss"] = max(gaps["loss"], abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)))
        gaps["grad"] = max(gaps["grad"], leaf_gap(g, g_cpu))
        gaps["branch"] = max(gaps["branch"], moved["rel"])
        gaps["flips"] += moved["flips"]
        gaps["moves"] += moved["moves"]
        del g_cpu, card_branch, state_cpu
        state, opt = adam_update(state, g, opt, AE_LR)
    if (gaps["loss"] > TRAIN_RTOL or gaps["grad"] > BRANCH_GRAD_RTOL
            or gaps["branch"] > BRANCH_RTOL):
        raise AssertionError(f"Z12 finetune replay: gaps {gaps} (bars {TRAIN_RTOL} for the loss, "
                             f"{BRANCH_GRAD_RTOL} for the gradient, {BRANCH_RTOL} for the "
                             "branch)")
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


def study_facade(card) -> dict:
    """Z17: the paper's design flow through ``Study`` at full width on the
    card, with telemetry armed: profile (held to ``cumulative_saliency``
    called directly), candidates, AEs at the SC cuts, calibrate (fused),
    the measured link verdicts (held to a direct ``measure_flow`` with the
    study's table), the path mode and a tier plan (deployed and held to the
    plain chain), the fleet planner with its observed joint run, the
    adaptive controller, a deploy of the top SC cut (held to the plain
    chain) and a 4-slot tail server for STUDY_CLIENTS clients; the Chrome
    trace's span names; then ``fit`` on a second study of the same model,
    its first step replayed on the CPU.  The codec kernels' launches are
    held to a count worked out from the code."""
    model = vgg16()
    params = model.init(seed=0, device="cuda")
    xs, ys = toy_images(SEARCH_IMAGES, hw=224, seed=0)
    verbs, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        verbs[name] = {"s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        return result

    reset_launches()
    study = timed("Study", lambda: Study(model, params=params, data=(xs, ys), device="cuda"))
    report = study.observe()
    timed("profile", study.profile)
    direct = cumulative_saliency(model, params, torch.from_numpy(xs).cuda(),
                                 torch.from_numpy(ys).cuda(), layer_idx=feature_index(model))
    out["cs_vs_direct"] = float(np.abs(study.cs_curve - direct).max())
    if study.layer_idx != feature_index(model) or out["cs_vs_direct"] > CS_ATOL:
        raise AssertionError(f"Z17 profile: the curve off a direct call by {out['cs_vs_direct']}"
                             f" (bar {CS_ATOL})")
    timed("candidates", study.candidates)
    out["candidates"] = [(c.label, c.accuracy_proxy) for c in study.candidate_list]
    sc = study.split_candidates()
    timed("bottlenecks", lambda: study.bottlenecks(steps=STUDY_AE_STEPS))
    ae_cuts = sorted(study._ae_map)
    if ae_cuts != sorted(c.split_layer for c in sc):
        raise AssertionError(f"Z17 bottlenecks at {ae_cuts}, the SC cuts {sc}")
    timed("calibrate", lambda: study.calibrate(iters=CAL_ITERS, fused=True))

    # the measured link verdicts against the direct calls bench_api.py stitches
    timed("simulate", study.simulate)
    netcfg = study.scenario.netcfg()
    out["verdicts"] = []
    for v in study.verdicts:
        scen = v.candidate.scenario(study.scenario.edge, study.scenario.server)
        flow = measure_flow(scen, netcfg, model, params, study.input_bytes,
                            n_frames=study.scenario.n_frames, cost=study.calibration)
        if (not math.isclose(v.latency_s, flow_latency_s(flow), rel_tol=STUDY_REL)
                or v.meta["cost_source"] != flow["cost_source"] != "measured"):
            raise AssertionError(f"Z17 simulate {v.candidate.label}: {v.latency_s} "
                                 f"({v.meta['cost_source']}), direct {flow_latency_s(flow)} "
                                 f"({flow['cost_source']})")
        out["verdicts"].append({"label": v.candidate.label, "latency_ms": 1e3 * v.latency_s,
                                "accuracy": v.accuracy, "cost_source": v.meta["cost_source"]})
    best = timed("suggest", lambda: study.suggest(QoSRequirements(**STUDY_LINK_QOS)))
    out["suggested"] = None if best is None else best.candidate.label

    # the path mode, a tier plan over tests/test_multitier.py's topology, its deploy
    path = NetworkPath(tuple(NetworkConfig("tcp", Channel(*h[:3], seed=h[3]))
                             for h in STUDY_PATH))
    timed("simulate_path", lambda: study.simulate(path=path, batch=1))
    out["path"] = [{"label": v.candidate.label, "pipelined_ms": 1e3 * v.latency_s,
                    "sequential_ms": 1e3 * v.meta["sequential_s"]} for v in study.verdicts]
    links = [Channel(*h[:3], seed=h[3]) for h in STUDY_PATH] + [None]
    topo = TierTopology(tuple(Tier(name, plat, ch) for (name, plat), ch
                              in zip(STUDY_TIERS, links)))
    plan = timed("suggest_tiers", lambda: study.suggest(QoSRequirements(**STUDY_TIER_QOS),
                                                        tiers=topo, cut_counts=[2], batch=1))
    if plan is None:
        raise AssertionError(f"Z17: no tier plan within {STUDY_TIER_QOS}")
    x = torch.from_numpy(toy_images(BATCH, hw=224, seed=DEPLOY_DATA_SEED)[0]).cuda()
    rt = timed("deploy_tiers", study.deploy)
    r = rt.infer(x, iters=1)
    tier_aes = sum(c in study._ae_map for c in plan.splits)
    plain = plain_chain(model, params, study._ae_map, x, cuts=plan.splits).cpu().numpy()
    rel = float(np.abs(r.logits - plain).max() / np.abs(plain).max())
    out["tier_plan"] = {"splits": list(plan.splits), "stage_tiers": list(plan.stage_tiers),
                        "latency_ms": 1e3 * plan.latency_s, "speedup": plan.speedup,
                        "aes_on_hops": tier_aes, "logit_rel_err_vs_plain": rel}
    if rt.part.splits != plan.splits or len(rt.hops) != 2 or rel > LOGIT_RTOL:
        raise AssertionError(f"Z17 tier deploy: {out['tier_plan']} (bar {LOGIT_RTOL})")

    # the fleet planner (Z16's device classes) with its observed joint run, the controller
    mix = [DeviceClass.make(name, Channel(**ch), weight=w) for name, ch, w in FLEET_MIX]
    trace = generate_trace(mix, STUDY_FLEET_REQUESTS, FLEET_RATE_HZ, pattern="diurnal",
                           seed=FLEET_SEED)
    timed("simulate_fleet", lambda: study.simulate(fleet=(trace, mix), **STUDY_FLEET_SPACE))
    plans = timed("suggest_fleet", lambda: study.suggest(QoSRequirements(**STUDY_LINK_QOS)))
    out["fleet"] = {"points": len(study.plan_points),
                    "plans": {k: None if p is None else (p.label, p.protocol, p.max_batch,
                                                         p.n_replicas, 1e3 * p.p99_s)
                              for k, p in plans.items()}}
    if study.deployment_stats is None:
        raise AssertionError(f"Z17: no observed fleet run for the plans {out['fleet']}")
    rush = (DeviceClass.make("edge-embedded", Channel(**RUSH_CHANNEL), name="rush-client"),)
    scenario = RegimeChangeTrace.from_phases(rush, [Phase(d, r) for d, r in RUSH_PHASES], seed=7)
    adapted = timed("adapt", lambda: study.adapt(scenario, config=ControllerConfig(**RUSH_CONFIG),
                                                 **STUDY_RUSH_SPACE))
    out["adapt"] = {k: {"p99_ms": 1e3 * adapted[k].p99_s, "switches": adapted[k].n_switches,
                        "plan_keys": list(adapted[k].plan_keys)} for k in ("adaptive", "static")}

    # a deploy of the top SC cut, then a 4-slot tail server for its clients
    top = sc[0]
    rt = timed("deploy", lambda: study.deploy(candidate=top.label))
    r = rt.infer(x, iters=1)
    ae = study._ae_map[top.split_layer]
    plain = plain_chain(model, params, {top.split_layer: ae}, x, cuts=(top.split_layer,))
    plain = plain.cpu().numpy()
    rel = float(np.abs(r.logits - plain).max() / np.abs(plain).max())
    out["deploy"] = {"cut": top.split_layer, "wire_bytes": r.wire_bytes,
                     "total_ms": 1e3 * r.compute_s, "logit_rel_err_vs_plain": rel}
    if r.logits.shape != (BATCH, 1000) or not np.isfinite(r.logits).all() or rel > LOGIT_RTOL:
        raise AssertionError(f"Z17 deploy: {out['deploy']} (bar {LOGIT_RTOL})")
    srv = timed("deploy_serve", lambda: study.deploy(candidate=top.label, serve=True,
                                                     n_slots=STUDY_CLIENTS))
    with torch.inference_mode():
        for cid in range(STUDY_CLIENTS):
            head = srv.part.head(x[cid:cid + 1])
            srv.submit(cid, W.to_bytes(W.encode_activation(head, ae)))
    served = srv.drain()
    rels = [float(np.abs(served[c] - plain[c:c + 1]).max() / np.abs(plain[c]).max())
            for c in range(STUDY_CLIENTS)]
    out["tail_server"] = {"clients": STUDY_CLIENTS, "n_batches": srv.n_batches,
                          "rel_err_vs_plain": max(rels)}
    if sorted(served) != list(range(STUDY_CLIENTS)) or max(rels) > LOGIT_RTOL:
        raise AssertionError(f"Z17 tail server: {out['tail_server']} (bar {LOGIT_RTOL})")
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    n_comp = CAL_CODEC_LAUNCHES_PER_AE_CUT * len(ae_cuts) + 2 + 2 * tier_aes + STUDY_CLIENTS
    check_launches("Z17 study", out["launches"],
                   {"bottleneck_compress": n_comp, "bottleneck_decompress": n_comp})

    # the Chrome trace of everything observed
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "study.json")
        report.to_chrome_trace(trace_path)
        with open(trace_path) as fh:
            names = {e["name"] for e in json.load(fh)["traceEvents"]}
    out["trace"] = {"spans": len(report.spans), "series": len(report.series_names()),
                    "names": sorted(n for n in names if n.startswith("study."))}
    if not {"study.calibrate", "study.adapt", "infer", "request"} <= names:
        raise AssertionError(f"Z17 trace names {sorted(names)}")

    # fit on a second study of the same model (quickstart's LC study), its
    # first step replayed on the CPU at REPLAY_BATCH images
    reset_launches()
    lc = Study(model, params=params, device="cuda")
    timed("fit", lambda: lc.fit(steps=STUDY_FIT_STEPS, batch=STUDY_FIT_BATCH,
                                data_iter=toy_image_iter(STUDY_FIT_BATCH, hw=224,
                                                         seed=STUDY_FIT_SEED)))
    check_launches("Z17 fit", launch_counts(), {})
    if lc._cs is not None or not all(torch.isfinite(t).all() for t in tree_leaves(lc.params)):
        raise AssertionError("Z17 fit: non-finite weights, or a stage left cached")
    x0, y0 = next(toy_image_iter(STUDY_FIT_BATCH, hw=224, seed=STUDY_FIT_SEED))
    x0, y0 = torch.from_numpy(x0[:REPLAY_BATCH]), torch.from_numpy(y0[:REPLAY_BATCH])
    loss, g = B.value_and_grad(lambda p: fit_loss(model, p, x0.cuda(), y0.cuda()), params)
    loss_cpu, g_cpu = B.value_and_grad(lambda p: fit_loss(model, p, x0, y0), to_cpu(params))
    out["fit_replay"] = {"loss_rel_err": abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)),
                         "grad_rel_err": leaf_gap(g, g_cpu)}
    if (out["fit_replay"]["loss_rel_err"] > TRAIN_RTOL
            or out["fit_replay"]["grad_rel_err"] > GRAD_RTOL):
        raise AssertionError(f"Z17 fit replay: {out['fit_replay']} (bars {TRAIN_RTOL} for the "
                             f"loss, {GRAD_RTOL} for the gradient)")
    print(card, flush=True)
    print("Z17 verbs", json.dumps(verbs), flush=True)
    del study, lc, rt, srv, g, g_cpu
    torch.cuda.empty_cache()
    return out


def live_pairs(sq, sk, causal, window) -> int:
    """Query-key pairs the mask leaves live (queries at the last Sq keys)."""
    p = np.arange(sq) + (sk - sq)
    hi = p if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_err(label, q, k, v, causal, window) -> tuple:
    """Max |kernel - plain| of ``flash_attention``, in bf16 its largest share
    of the step bar (``FLASH_BF16_STEP``; None in f32), and the plain
    output; raises past either bar."""
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err, step = float(diff.max()), None
    if q.dtype == torch.bfloat16:
        spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window)
        bar = FLASH_BF16_STEP * (want.float().abs() + spread.float())
        step = float((diff / bar).max())
        del spread, bar
    if (got.dtype != q.dtype or not torch.isfinite(got).all() or err > FLASH_BAR[q.dtype]
            or (step is not None and step > 1)):
        raise AssertionError(f"flash_attention at {label}: max err {err} "
                             f"(bar {FLASH_BAR[q.dtype]}), share of the step bar {step}")
    return err, step, want


def check_flash(label, b, sq, sk, h, kh, d, causal, window, dtype, gen) -> dict:
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, sk, kh, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    err, step, want = flash_err(label, q, k, v, causal, window)
    # the kernel's tiles, registers and shared memory; a spill fails the row
    info = FA.kernel_info(dtype, d)
    if any(k_["local_bytes"] for k_ in info["kernels"].values()):
        raise AssertionError(f"flash_attention at {label}: the kernel spills: {info}")
    # the training route's forward: the same output bit for bit, and lse
    out, lse = FA.flash_attention_lse(q, k, v, causal=causal, window=window)
    same = torch.equal(out, FA.flash_attention(q, k, v, causal=causal, window=window))
    lse_err = float((lse - ref.flash_attention_lse_ref(q, k, causal=causal, window=window))
                    .abs().max())
    if not same or not lse_err <= FLASH_LSE_BAR[dtype]:
        raise AssertionError(f"flash_attention at {label}: the output with lse equal to the one "
                             f"without: {same}; lse off the plain one by {lse_err} (bar "
                             f"{FLASH_LSE_BAR[dtype]})")
    del out, lse
    # the mask-edge probe: rising scores find the causal (or key-range)
    # edge, falling ones the window's
    probe = {}
    edges = ([True] if causal or window is None else []) + ([False] if window else [])
    if dtype == torch.bfloat16:
        for rising in edges:
            pq, pk, pv = ref.flash_edge_probe(b, sq, sk, h, kh, d, rising=rising, seed=sq,
                                              device="cuda")
            probe["rising" if rising else "falling"] = flash_err(
                f"{label} edge probe", pq, pk, pv, causal, window)[:2]
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
         "route": FA.ROUTES[dtype], "max_abs_err": err, "step_bar_share": step,
         "lse_max_abs_err": lse_err, "edge_probe_err_and_step_share": probe,
         "library_max_abs_err": lib_err, "live_pairs": pairs, "tiles": info["tiles"],
         "kernels": info["kernels"], "ms": device_ms(run), "call_ms": call_ms(run),
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


def grad_gaps(got, want, scales=None) -> list:
    """max |got - want| of each gradient over its max |want| (or ``scales``);
    where that is 0 (a parameter the loss does not read, such as an RMSNorm's
    unused bias), max |got| itself."""
    scales = scales or [float(w.float().abs().max()) for w in want]
    return [float((g.float() - w.float()).abs().max()) / (sc or 1.0)
            for g, w, sc in zip(got, want, scales)]


def check_flash_bwd(label, b, sq, sk, h, kh, d, causal, window, dtype, gen) -> dict:
    """Z2b: ``flash_attention_bwd`` at one shape against the plain backward
    (on the kernel's own forward output and lse) and autograd through the
    plain forward, on the card; two calls bit for bit equal, and the
    autograd route of the wrapper bit for bit the direct call; the tiles and
    each kernel's registers and shared memory (``cudaFuncGetAttributes``);
    timed beside SDPA's backward and its bound."""
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, sk, kh, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal, window=window)
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    if not all(g.dtype == dtype and torch.isfinite(g).all() for g in got):
        raise AssertionError(f"flash backward at {label}: not finite or not {dtype}")
    deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
    if not deterministic:
        raise AssertionError(f"flash backward at {label}: two calls differ")
    del again
    info = FA.bwd_kernel_info(dtype, d)
    if any(k_["local_bytes"] for k_ in info["kernels"].values()):
        raise AssertionError(f"flash backward at {label}: a kernel spills: {info}")
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    err_ref = grad_gaps(got, want)
    abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    del want
    live = [t.detach().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(ref.flash_attention_ref(*live, causal=causal, window=window),
                                live, do)
    err_plain = grad_gaps(got, plain)
    del plain
    bar = FLASH_BWD_BAR[dtype]
    if max(err_ref + err_plain) > bar:
        raise AssertionError(f"flash backward at {label}: dq, dk, dv off the plain backward by "
                             f"{err_ref}, off autograd of the plain forward by {err_plain} of "
                             f"their max (bar {bar})")
    # the route a training step takes: the wrapper under autograd
    reset_launches()
    out = FA.flash_attention(*live, causal=causal, window=window)
    via = torch.autograd.grad(out, live, do)
    torch.cuda.synchronize()
    counts = launch_counts()["flash_attention"]
    if (not all(torch.equal(a, g) for a, g in zip(via, got))
            or counts[FA.ROUTES[dtype]] != 1 or counts[FA.BWD_ROUTES[dtype]] != 1):
        raise AssertionError(f"flash backward at {label}: the autograd route differs from the "
                             f"direct call, or launched {counts}")
    del via, out
    # SDPA's backward: its forward and backward less its forward, the same mask,
    # each timed as the kernels are, by CUDA-graph replay
    mask = None
    if window is not None or (causal and sq != sk):
        mask = ref.attention_mask(sq, sk, causal, window, "cuda")
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()
    pairs = live_pairs(sq, sk, causal, window)
    e = {"shape": label, "B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "D": d,
         "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
         "route": FA.BWD_ROUTES[dtype], "rel_err_vs_plain_bwd": err_ref,
         "rel_err_vs_autograd": err_plain, "max_abs_err": abs_err,
         "deterministic": deterministic, "tiles": info["tiles"], "kernels": info["kernels"],
         "live_pairs": pairs,
         "ms": device_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                                        window=window), reps=3),
         "plain_ms": once_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                                                 window=window)),
         "library_ms": device_ms(sdpa_fwd_bwd, reps=3) - device_ms(sdpa_fwd, reps=3),
         "forward_ms": device_ms(lambda: FA.flash_attention(q, k, v, causal=causal,
                                                            window=window))}
    # q, k, v, o, dO read once, dq, dk, dv written once; 10 D flops a live
    # pair and head (S, dP, dV, dQ, dK)
    nbytes = q.element_size() * (4 * b * sq * h * d + 4 * b * sk * kh * d)
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    e["bound_ms"], e["bound_by"] = bound_ms(nbytes, 10 * b * h * d * pairs, peak)
    return e


def kernel_ms(fn, names) -> dict:
    """Device time of each kernel function in ``names``, which one run of
    ``fn`` launches once each: the median over ``PHASE_RUNS`` runs under
    ``torch.profiler`` (each profiler name to the longest of ``names`` it
    holds).  The window's first kernels can go unrecorded (two of a call's
    four have gone missing so), which the median rides over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(PHASE_RUNS):
            fn()
        torch.cuda.synchronize()
    times = {n: [] for n in names}
    for e in prof.events():
        hits = [n for n in names if n in e.name]
        if e.device_type == DeviceType.CUDA and hits:
            times[max(hits, key=len)].append((e.time_range.end - e.time_range.start) / 1e3)
    return {n: float(np.median(t)) if t else 0.0 for n, t in times.items()}


def check_rwkv_bwd(label, b, s, h, d, served_w, gen) -> dict:
    """Z5b: ``rwkv6_scan_bwd`` at one shape, from a nonzero start state with
    nonzero gradients of out and of the final state, against the plain
    backward and autograd through the plain scan on the card; two calls bit
    for bit equal; the workspace, each kernel's registers, shared memory,
    resident blocks an SM and local bytes (a kernel that spills fails), and
    the call's device time split over its kernels (one profiled call)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (0.5 * randn(b, s, h, d) for _ in range(3))
    if served_w:
        w = torch.exp(-torch.exp(-4.0 + 0.5 * randn(b, s, h, d)))
        u = 0.1 * randn(h, d)
    else:
        w = torch.exp(-torch.exp(randn(b, s, h, d) - 1.0))
        u = 0.3 * randn(h, d)
    st = 0.2 * randn(b, h, d, d)
    dout, dst = randn(b, s, h, d), randn(b, h, d, d)
    ins = (r, k, v, w, u, st)
    got = RS.rwkv6_scan_bwd(*ins, dout, dst)
    again = RS.rwkv6_scan_bwd(*ins, dout, dst)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"rwkv backward at {label}: not finite")
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        raise AssertionError(f"rwkv backward at {label}: two calls differ")
    del again
    info = RS.bwd_kernel_info()
    if any(k_["local_bytes"] for k_ in info["kernels"].values()):
        raise AssertionError(f"rwkv backward at {label}: a kernel spills: {info}")
    want = ref.rwkv6_scan_bwd_ref(*ins, dout, dst)
    err_ref = grad_gaps(got, want)
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    del want
    live = [t.detach().requires_grad_() for t in ins]
    plain = torch.autograd.grad(ref.rwkv6_scan_ref(*live), live, (dout, dst))
    err_plain = grad_gaps(got, plain)
    del plain
    if max(err_ref + err_plain) > RWKV_BWD_BAR:
        raise AssertionError(f"rwkv backward at {label}: dr, dk, dv, dw, du, dstate off the "
                             f"plain backward by {err_ref}, off autograd of the plain scan by "
                             f"{err_plain} of their max (bar {RWKV_BWD_BAR})")
    reset_launches()
    out, final = RS.rwkv6_scan(*live)
    via = torch.autograd.grad((out, final), live, (dout, dst))
    torch.cuda.synchronize()
    if (not all(torch.equal(a, g) for a, g in zip(via, got))
            or launch_counts()["rwkv6_scan"] != {"chain": 1, "bwd": 1}):
        raise AssertionError(f"rwkv backward at {label}: the autograd route differs from the "
                             f"direct call, or launched {launch_counts()['rwkv6_scan']}")
    del via, out, final, live
    run = lambda: RS.rwkv6_scan_bwd(*ins, dout, dst)  # noqa: E731
    e = {"shape": label, "B": b, "S": s, "H": h, "D": d, "served_w": served_w,
         "rel_err_vs_plain_bwd": err_ref, "rel_err_vs_autograd": err_plain,
         "max_abs_err": abs_err, "deterministic": True,
         "workspace_bytes": 4 * RS.bwd_workspace(b, s, h), "sizes": info["sizes"],
         "kernels": info["kernels"], "chunk_clusters": info["chunk_clusters"],
         "phase_ms": kernel_ms(run, RS.BWD_KERNELS),
         "ms": device_ms(run, reps=3), "call_ms": call_ms(run),
         "plain_ms": once_ms(lambda: ref.rwkv6_scan_bwd_ref(*ins, dout, dst)),
         "library_ms": None,
         "forward_ms": device_ms(lambda: RS.rwkv6_scan(r, k, v, w, u, st))}
    e["ms_per_step"] = e["ms"] / s
    # r, k, v, w, dout read and dr, dk, dv, dw written; u, du and three
    # states.  Operations a step and head: 14 a state entry (the state
    # recomputed: k v, w S and the sum; dr, dk, dv, dw: a product and a sum
    # each; G: w G, r dout and the sum) and 10 a row (v . dout, the bonus
    # terms of dr, dk and dv, du)
    e["bound_ms"], e["bound_by"] = bound_ms(4 * (9 * b * s * h * d + 3 * b * h * d * d + 2 * h * d),
                                            b * s * h * (14 * d * d + 10 * d))
    return e


def check_mamba_bwd(label, b, s, di, served_a, gen) -> dict:
    """Z7b: ``mamba_scan_bwd`` at one shape, from a nonzero start state with
    nonzero gradients of y and of the final state, against the plain
    backward and autograd through the plain scan on the card; two calls bit
    for bit equal; the workspace, each kernel's registers, shared memory,
    resident blocks and warps an SM and local bytes (a kernel that spills
    fails), and the call's device time split over its kernels (one profiled
    call)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = (1.0 if served_a else 0.1) * F.softplus(randn(b, s, di))
    bm, cm = (0.5 * randn(b, s, 16) for _ in range(2))
    x = randn(b, s, di)
    if served_a:
        a = -torch.arange(1, 17, dtype=torch.float32, device="cuda").expand(di, 16).contiguous()
    else:
        a = -torch.exp(0.3 * randn(di, 16))
    st = 0.3 * randn(b, di, 16)
    dy, dst = randn(b, s, di), randn(b, di, 16)
    ins = (dt, bm, cm, x, a, st)
    got = MS.mamba_scan_bwd(*ins, dy, dst)
    again = MS.mamba_scan_bwd(*ins, dy, dst)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"mamba backward at {label}: not finite")
    if not all(torch.equal(a_, g) for a_, g in zip(again, got)):
        raise AssertionError(f"mamba backward at {label}: two calls differ")
    del again
    info = MS.bwd_kernel_info()
    if any(k_["local_bytes"] for k_ in info["kernels"].values()):
        raise AssertionError(f"mamba backward at {label}: a kernel spills: {info}")
    want = ref.mamba_scan_bwd_ref(*ins, dy, dst)
    err_ref = grad_gaps(got, want)
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    del want
    live = [t.detach().requires_grad_() for t in ins]
    plain = torch.autograd.grad(ref.mamba_scan_ref(*live), live, (dy, dst))
    err_plain = grad_gaps(got, plain)
    del plain
    if max(err_ref + err_plain) > MAMBA_BWD_BAR:
        raise AssertionError(f"mamba backward at {label}: ddt, db, dc, dx, da, dstate off the "
                             f"plain backward by {err_ref}, off autograd of the plain scan by "
                             f"{err_plain} of their max (bar {MAMBA_BWD_BAR})")
    reset_launches()
    y, final = MS.mamba_scan(*live)
    via = torch.autograd.grad((y, final), live, (dy, dst))
    torch.cuda.synchronize()
    if (not all(torch.equal(a_, g) for a_, g in zip(via, got))
            or launch_counts()["mamba_scan"] != {"chain": 1, "bwd": 1}):
        raise AssertionError(f"mamba backward at {label}: the autograd route differs from the "
                             f"direct call, or launched {launch_counts()['mamba_scan']}")
    del via, y, final, live
    run = lambda: MS.mamba_scan_bwd(*ins, dy, dst)  # noqa: E731
    e = {"shape": label, "B": b, "S": s, "di": di, "ds": 16, "served_a": served_a,
         "rel_err_vs_plain_bwd": err_ref, "rel_err_vs_autograd": err_plain,
         "max_abs_err": abs_err, "deterministic": True,
         "workspace_bytes": 4 * MS.bwd_workspace(b, s, di), "sizes": info["sizes"],
         "kernels": info["kernels"],
         "phase_ms": kernel_ms(run, MS.BWD_KERNELS),
         "ms": device_ms(run, reps=3), "call_ms": call_ms(run),
         "plain_ms": once_ms(lambda: ref.mamba_scan_bwd_ref(*ins, dy, dst)),
         "library_ms": None,
         "forward_ms": device_ms(lambda: MS.mamba_scan(*ins))}
    e["ms_per_step"] = e["ms"] / s
    # dt, x, dy read and ddt, dx written; B, C read and dB, dC written; A,
    # dA and the three states.  19 operations an entry and step (the state
    # recomputed: dt A, (dt x) B and a h + u; g = C dy + ghat; sums of g B
    # and of g A a h_{t-1}; a h_{t-1}, g times it, dA's dt times that; dB's g
    # (dt x) and dC's h dy and their sums over channels; a g); one
    # exponential an entry and step
    e["bound_ms"], e["bound_by"] = bound_ms(
        4 * (5 * b * s * di + 4 * b * s * 16 + 2 * di * 16 + 3 * b * di * 16),
        19 * b * s * di * 16, exps=b * s * di * 16)
    return e


def train_batch(cfg, b, s, device) -> dict:
    """``data.synthetic.token_batch`` (seed 0) of ``cfg``'s vocab, with the
    stub frontend's N(0, 1) frames or patches (``front_inputs``)."""
    batch = {k: torch.from_numpy(a).to(device)
             for k, a in token_batch(b, s, cfg.vocab, seed=0).items()}
    return {**batch, **front_inputs(cfg, b, device)}


def scan_and_flash_launches(cfg, per_fwd) -> dict:
    """The launches a forward and backward of ``cfg`` under the recompute
    make, ``{kernel: {route: n}}``: each kernel's forward twice a layer, its
    backward once (``per_fwd``: a forward's launches)."""
    fwd = {"flash_attention": FA.ROUTES[cfg.tdtype], "rwkv6_scan": "chain", "mamba_scan": "chain"}
    bwd = {"flash_attention": FA.BWD_ROUTES[cfg.tdtype], "rwkv6_scan": "bwd", "mamba_scan": "bwd"}
    return {k: {fwd[k]: 2 * per_fwd[k], bwd[k]: per_fwd[k]} for k in fwd}


def train_zoo(arch, n_layers, b, s) -> dict:
    """Z24: ``arch`` in bf16 (whole, or cut to ``n_layers``) trained
    TRAIN_STEPS steps on one batch through ``make_train_step`` (AdamW in
    place, each group recomputed in its backward), every step's launches
    counted and held to the counts worked out from the code, the losses
    finite and falling; step times, tokens a second and peak memory; one
    step under ``device_breakdown``."""
    cfg = served_cfg(arch) if n_layers is None else served_cfg(arch, n_layers=n_layers)
    oc = OptConfig(lr=TRAIN_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, state = init_train_state(0, cfg, oc, device="cuda")
    torch.cuda.synchronize()
    row = {"arch": arch, "n_layers": cfg.n_layers, "B": b, "S": s, "dtype": cfg.dtype,
           "lr": TRAIN_LR,
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "state_gb": sum(t.numel() * t.element_size()
                           for t in tree_leaves((params, state))) / 1e9}
    batch = train_batch(cfg, b, s, "cuda")
    step = make_train_step(cfg, oc)
    want = scan_and_flash_launches(cfg, per_token_launches(cfg)[0])
    losses, times, peaks, counts = [], [], [], None
    total = {k: dict.fromkeys(launch_counts()[k], 0) for k in want}
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        loss = float(metrics["loss"])          # synchronises
        times.append(time.perf_counter() - t0)
        peaks.append((torch.cuda.max_memory_allocated() - base) / 1e9)
        counts = launch_counts()
        losses.append(loss)
        for kernel in total:
            for r, n in counts[kernel].items():
                total[kernel][r] += n
        check_train_launches(f"Z24 {arch} step {i}", counts, want)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"Z24 {arch}: losses {losses} not finite and falling")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    row.update(losses=losses, step_s=times, step_ms=1e3 * steady,
               tokens_per_s=b * s / steady, step_peak_gb=max(peaks),
               launches_per_step={k: counts[k] for k in want}, launches=total,
               breakdown=device_breakdown(lambda: step(params, state, batch), top=8))
    del params, state, batch, step
    torch.cuda.empty_cache()
    return row


def key_bias_scales(paths, want) -> list:
    """Each gradient leaf's scale: its max |g|, and for a key bias (whose
    gradient is 0 in exact arithmetic: softmax ignores a shift common to a
    query's scores) that of its wk."""
    by_path = dict(zip(paths, want))
    out = []
    for path, w in zip(paths, want):
        top = float(w.float().abs().max())
        if path[-1] == "bk":
            top = max(top, float(by_path[path[:-1] + ("wk",)].float().abs().max()))
        out.append(top)
    return out


def leaf_paths(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, path + (k,))]
    return [path]


def loss_and_grads(params, cfg, batch) -> tuple:
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    loss, _ = T.loss_fn(tree_map(lambda _: next(it), params), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(live, grads)]


def grads_vs_cpu(arch, n_layers, b, s) -> dict:
    """Z24d: the loss and every gradient of an f32 copy of ``arch`` (cut to
    ``n_layers``, or whole) through the kernels on the card against the
    plain versions on the CPU, same weights and batch; each leaf's bar the
    larger of ZOO_GRAD_RTOL and ULP_FACTOR times its CPU response to a
    one-ulp flip of the embedding."""
    changes = {"dtype": "float32"} if n_layers is None else {"dtype": "float32",
                                                              "n_layers": n_layers}
    cfg = served_cfg(arch, **changes)
    params = T.init_params(0, cfg, device="cuda")
    batch = train_batch(cfg, b, s, "cuda")
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    want = scan_and_flash_launches(cfg, per_token_launches(cfg)[0])
    for kernel, routes in want.items():
        if {r: n for r, n in counts[kernel].items() if n} != {r: n for r, n in routes.items() if n}:
            raise AssertionError(f"Z24d {arch}: {kernel} launched {counts[kernel]}, want {routes}")
    grads = [g.cpu() for g in grads]
    params_cpu, batch_cpu = to_cpu(params), to_cpu(batch)
    del params, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want_loss, want_grads = loss_and_grads(params_cpu, cfg, batch_cpu)
    cpu_s = time.perf_counter() - t0
    paths = leaf_paths(params_cpu)
    scales = key_bias_scales(paths, want_grads)
    gaps = grad_gaps(grads, want_grads, scales)
    flipped = dict(params_cpu, embed=ulp_flip(params_cpu["embed"]))
    flip_loss, flip_grads = loss_and_grads(flipped, cfg, batch_cpu)
    response = grad_gaps(flip_grads, want_grads, scales)
    bars = [max(ZOO_GRAD_RTOL, ULP_FACTOR * r) for r in response]
    loss_gap = abs(loss - want_loss) / abs(want_loss)
    loss_bar = max(ZOO_LOSS_RTOL, ULP_FACTOR * abs(flip_loss - want_loss) / abs(want_loss))
    worst = max(range(len(gaps)), key=lambda i: gaps[i] / bars[i])
    row = {"arch": arch, "n_layers": cfg.n_layers, "B": b, "S": s, "loss": loss,
           "cpu_loss": want_loss, "loss_rel_err": loss_gap, "loss_bar": loss_bar,
           "max_grad_rel_err": max(gaps), "worst_leaf": "/".join(map(str, paths[worst])),
           "worst_gap": gaps[worst], "worst_bar": bars[worst],
           "worst_ulp_response": response[worst], "max_ulp_response": max(response),
           "n_leaves": len(gaps), "card_s": card_s, "cpu_s": cpu_s,
           "launches": {k: counts[k] for k in want}}
    if loss_gap > loss_bar or gaps[worst] > bars[worst]:
        raise AssertionError(f"Z24d {arch}: {row}")
    return row


def zoo_study(arch) -> dict:
    """Z25: ``Study(arch, reduce=False)`` whole in bf16 on the card (``arch``
    as ``configs.SERVED`` serves it) through profile -> candidates ->
    simulate -> suggest, each verb timed and its launches counted (profile:
    one forward and one backward over the view, each kernel once a layer);
    then an f32 copy cut to ZOO_STUDY_LAYERS (or one period, if longer) on
    the card against the same study on the CPU with the same weights."""
    out, verbs = {"arch": arch}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        verbs[name] = {"s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {k: {r: n for r, n in c.items() if n}
                                    for k, c in launch_counts().items() if sum(c.values())}}
        return result

    study = timed("Study", lambda: Study(served_cfg(arch), reduce=False, device="cuda"))
    cfg = study.cfg
    timed("profile", study.profile)
    per_fwd = per_token_launches(cfg)[0]
    # the view's forward and backward: each kernel's forward and backward once a layer
    routes = {k: dict.fromkeys(c, per_fwd[k])
              for k, c in scan_and_flash_launches(cfg, per_fwd).items() if per_fwd[k]}
    if verbs["profile"]["launches"] != routes:
        raise AssertionError(f"Z25 {arch} profile launched {verbs['profile']['launches']}, "
                             f"want {routes}")
    if not np.isfinite(study.cs_curve).all():
        raise AssertionError(f"Z25 {arch}: CS curve {study.cs_curve}")
    timed("candidates", study.candidates)
    timed("simulate", study.simulate)
    best = timed("suggest", lambda: study.suggest(QoSRequirements(**STUDY_LINK_QOS)))
    # simulate prices each candidate: the view's Table I once (cached on the
    # model after), and one more forward for each SC candidate's stages; no
    # verb but profile runs a backward
    n_sc = sum(c.kind == "SC" for c in study.candidate_list)
    fwd_routes = ("chain", FA.ROUTES[cfg.tdtype])
    fwd_only = {k: {r: n * (1 + n_sc) for r, n in c.items() if r in fwd_routes}
                for k, c in routes.items()}
    if (verbs["simulate"]["launches"] != fwd_only
            or verbs["candidates"]["launches"] or verbs["suggest"]["launches"]):
        raise AssertionError(f"Z25 {arch}: launches {verbs}, want simulate's {fwd_only} "
                             f"({n_sc} SC candidates)")
    out.update(cs_curve=[float(x) for x in study.cs_curve],
               candidates=[(c.label, c.accuracy_proxy) for c in study.candidate_list],
               suggested=None if best is None else best.candidate.label, verbs=verbs)
    del study
    torch.cuda.empty_cache()
    # the f32 copy, card against CPU: the curve, each block's raw map, labels
    n_layers = max(ZOO_STUDY_LAYERS, len(T.block_structure(cfg)[0]))
    cfg2 = served_cfg(arch, n_layers=n_layers, dtype="float32")
    backbone = T.init_params(0, cfg2, device="cuda")
    card = Study(cfg2, reduce=False, params=backbone, device="cuda").profile().candidates()
    cpu = Study(cfg2, reduce=False, params=to_cpu(backbone), device="cpu").profile().candidates()
    gap = float(np.abs(card.cs_curve - cpu.cs_curve).max() / np.abs(cpu.cs_curve).max())
    rng = np.random.default_rng(0)              # the studies' own sample (seed 0)
    toks = rng.integers(0, cfg2.vocab, (2, 32)).astype(np.int32)
    labels_np = rng.integers(0, cfg2.vocab, (2, 32)).astype(np.int32)
    maps = {}
    for dev, st in (("cuda", card), ("cpu", cpu)):
        maps[dev] = layer_saliency_maps(st.model, st.params,
                                        {"tokens": torch.from_numpy(toks).to(dev)},
                                        torch.from_numpy(labels_np).to(dev))
    labels = ([c.label for c in card.candidate_list], [c.label for c in cpu.candidate_list])
    out["f32_copy"] = {"n_layers": n_layers, "cs_rel_err": gap,
                       "cs_curve": [float(x) for x in cpu.cs_curve],
                       "map_rel_err": grad_gaps([m.cpu() for m in maps["cuda"]], maps["cpu"]),
                       "labels": labels[0],
                       "proxies": [c.accuracy_proxy for c in cpu.candidate_list]}
    if gap > CS_ATOL or labels[0] != labels[1]:
        raise AssertionError(f"Z25 {arch} f32 copy: CS off the CPU by {gap} of max (bar "
                             f"{CS_ATOL}), labels {labels}")
    del card, cpu, backbone, maps
    torch.cuda.empty_cache()
    return out


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
ZOO_KERNEL_NAMES = {"flash_attention": "flash_fwd", "flash_attention_bwd": "flash_bwd",
                    "rwkv6_scan": "wkv6", "rwkv6_scan_bwd": "wkv6_bwd",
                    "mamba_scan": "selective_scan", "mamba_scan_bwd": "mamba_bwd"}
# the flash kernels one by one (each device name to the longest it holds)
FLASH_KERNEL_NAMES = ("flash_fwd_wgmma", "flash_fwd", "flash_bwd_delta", "flash_bwd_dkdv_wgmma",
                      "flash_bwd_dq_wgmma", "flash_bwd_dkdv", "flash_bwd_dq")


def device_breakdown(fn, top=6) -> dict:
    """One run of ``fn`` under ``torch.profiler``: the device's busy time
    (the union of its kernel, copy and fill intervals) against the wall
    time, device time by kernel name (the ``top`` largest) and that of each
    zoo kernel and of each flash kernel function, with its share of the
    device time.  The profiler slows the host, so the busy share reads
    low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # "Command Buffer Full" marks the host waiting on a full launch queue;
    # "gloo:send" and "gloo:recv" span a rank's host-side transfers
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"
                   and not e.name.startswith("gloo:"))
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    total = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda r: -r[1])[:top]
    # each kernel name to the longest part it holds ("wkv6_bwd" before "wkv6")
    zoo = dict.fromkeys(ZOO_KERNEL_NAMES, 0.0)
    flash = {}
    for name, us in by_name.items():
        hits = [k for k, part in ZOO_KERNEL_NAMES.items() if part in name]
        if hits:
            zoo[max(hits, key=lambda k: len(ZOO_KERNEL_NAMES[k]))] += us
        parts = [part for part in FLASH_KERNEL_NAMES if part in name]
        if parts:
            part = max(parts, key=len)
            flash[part] = flash.get(part, 0.0) + us
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / wall_us,
            "n_kernel_names": len(by_name),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "share": us / total} for k, us in rows],
            "zoo_kernels": {k: {"ms": us / 1e3, "share": us / total} for k, us in zoo.items()},
            "flash_kernels": {k: {"ms": us / 1e3, "share": us / total}
                              for k, us in flash.items()}}


def served_cfg(arch, **changes):
    """The configuration the port serves under ``arch``, with ``changes``
    over ``configs.SERVED``'s (``moe=get_config(JAMBA).moe`` keeps jamba's
    MoE)."""
    return dataclasses.replace(get_config(arch), **{**SERVED.get(arch, {}), **changes})


def per_token_launches(cfg) -> tuple:
    """Kernel launches ``{kernel: n}`` of one prefill and of one decode step
    of ``cfg``: ``flash_attention`` once an attention layer in the prefill,
    once more a cross-attention and once an encoder layer (decode attention
    is plain ops, the cross step too), each scan once a layer of its mixer
    in the prefill and in every decode step."""
    descs, n_groups = T.block_structure(cfg)
    attn = n_groups * sum((d.mixer == "attn") + d.cross for d in descs)
    attn += cfg.n_enc_layers if cfg.family == "encdec" else 0
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
    want = {route: 0 for route in FA.launches}
    want[FA.ROUTES[getattr(torch, dtype)]] = n
    if counts["flash_attention"] != want:
        raise AssertionError(f"{what}: flash_attention launches {counts['flash_attention']}, "
                             f"want {want}")
    return want


def front_inputs(cfg, b, device) -> dict:
    """The stub frontend's input a hold feeds ``cfg``: whisper's frames or a
    VLM's patch embeddings, N(0, 1) from numpy seed ``FRONT_SEED``, in the
    config's dtype; ``{}`` for a model without a frontend."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    key, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
              else ("patch_embeds", cfg.n_patches))
    a = np.random.default_rng(FRONT_SEED).standard_normal((b, n, cfg.d_frontend))
    return {key: torch.from_numpy(a.astype(np.float32)).to(device, cfg.tdtype)}


def n_prefix(cfg) -> int:
    """Positions before the tokens: a VLM's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def served_forward(params, cfg, seq, n_prompt, front=None) -> tuple:
    """The final-normed x (B,S,D) that a served run computes over ``seq``
    (the prompt's ``n_prompt`` tokens, then the served ones), and the
    (token, expert) pairs each MoE layer drops, ``{"prefill": [...],
    "decode": [...]}``.  ``T.forward`` but for the MoE layers: a prefill
    routes the prompt in its own groups (one row of ``n_prompt`` tokens)
    and each decode step routes its token as a group of its own, where one
    forward over ``seq`` would group prompt and served tokens together, at
    another capacity, and drop other prompt tokens.  So the MoE of the
    prompt positions runs at the default ``group_chunk`` and that of each
    served position at ``group_chunk=1``.  The mixer before an MoE layer
    (attention, or a Mamba mixer in the hybrid family) runs over the whole
    of ``seq``, as it does over the prompt and then each served token.
    Without MoE it is ``T.forward``, fed ``front`` (frames or patch
    embeddings) beside the tokens."""
    if cfg.moe is None:
        return T.forward(params, cfg, {"tokens": seq, **(front or {})})["x"], {}
    descs, n_groups = T.block_structure(cfg)
    x, positions, _ = T.embed_inputs(params, cfg, {"tokens": seq})
    drops = {"prefill": [], "decode": []}
    for g in range(n_groups):
        group_p = T._group(params["layers"], g)
        for j, desc in enumerate(descs):
            p = group_p[f"l{j}"]
            if desc.ffn != "moe":
                x, _, _ = T.apply_layer_seq(p, desc, x, cfg, positions,
                                            window=cfg.sliding_window)
                continue
            h = T._apply_norm(p["norm1"], x, cfg)
            if desc.mixer == "attn":
                x = x + T._attn_seq(p["attn"], h, cfg, positions, causal=True,
                                    window=cfg.sliding_window)[0]
            else:
                x = x + mamba_seq(p["mamba"], h, cfg)[0]
            h = T._apply_norm(p["norm2"], x, cfg)
            f = []
            for phase, part, chunk in (("prefill", h[:, :n_prompt], M.GROUP_CHUNK),
                                       ("decode", h[:, n_prompt:], 1)):
                if part.shape[1]:
                    f.append(M.moe_ffn(part, p["ffn"], cfg.moe, group_chunk=chunk)[0])
                    drops[phase].append(int(M.dropped_pairs(part, p["ffn"], cfg.moe,
                                                            group_chunk=chunk)))
            x = x + torch.cat(f, dim=1)
    return T._apply_norm(params["final_norm"], x, cfg), drops


def serve_zoo(arch, prompt_lens, dtype="bfloat16", **changes) -> dict:
    """Z4 / Z5 / Z8 / Z9: full-width, full-depth serving of ``arch`` through
    ``ServingEngine``; every kernel launches as ``per_token_launches`` says,
    in the served run and in a prefill and the decode steps counted apart.
    The served tokens are then fed through prefill + serve_step again, and
    the logits of each step held against one full forward over prompt +
    served tokens (see ``ZOO_RTOL``), with an MoE model's tokens routed as
    the served run routed them (``served_forward``).  Z18: an MoE model's
    prefill must drop pairs at capacity, its decode steps none.  Z19, Z20:
    the served run feeds zero frames or patches, as ``ServingEngine`` does;
    the replay and the forward are both fed ``front_inputs``, so the replay
    greedy-decodes other tokens than the served ones and is fed the served
    ones.  ``changes`` go to ``served_cfg`` (``n_layers`` cuts the depth)."""
    t_phase = time.perf_counter()
    cfg = served_cfg(arch, dtype=dtype, **changes)
    per_prefill, per_step = per_token_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9     # held by earlier phases
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    out = {"arch": arch, "dtype": dtype, "base_gb": base_gb, "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9,
           "prompt_lens": list(prompt_lens), "new_tokens": NEW_TOKENS,
           "n_layers": cfg.n_layers,
           "moe": None if cfg.moe is None else dataclasses.asdict(cfg.moe)}
    torch.cuda.reset_peak_memory_stats()      # peak_gb: serving, the weights included
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    slots = n_prefix(cfg) + max(prompt_lens) + NEW_TOKENS
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
    front = front_inputs(cfg, len(prompts), "cuda")
    batch = {"tokens": toks, **front}
    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, batch, slots)
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
        greedy = steps.argmax(-1).int()
        if not front and not torch.equal(greedy, served):
            raise AssertionError(f"{arch}: the replay's greedy tokens differ from the served")
        if dtype == "bfloat16":
            out["prefill_profile"] = device_breakdown(
                lambda: T.prefill(params, cfg, batch, slots))
            _, cache, _ = T.prefill(params, cfg, batch, slots)
            out["decode_step_profile"] = device_breakdown(
                lambda: T.serve_step(params, cfg, cache, served[:, :1], pos))
            del cache
        # one full forward over prompt + served tokens, routed as served, and
        # the same forward with its input moved by one rounding (in bf16 that
        # response takes in the routes that one rounding flips)
        seq = torch.cat([toks, served[:, :-1]], dim=1)
        first = n_prefix(cfg) + toks.shape[1] - 1                # the prefill's position
        x, drops = served_forward(params, cfg, seq, toks.shape[1], front)
        flogits = T.logits_from_x(params, cfg, x[:, first:]).float()
        flipped = {**params, "embed": ulp_flip(params["embed"])}
        x, _ = served_forward(flipped, cfg, seq, toks.shape[1], front)
        x = x[:, first:]
        ulp_err = float((T.logits_from_x(flipped, cfg, x).float() - flogits).abs().max())
        del flipped, x
    if cfg.moe is not None:
        pairs, layers = toks.numel() * cfg.moe.top_k, len(drops["prefill"])
        out["moe_drops"] = {"prefill_by_layer": drops["prefill"], "pairs_a_layer": pairs,
                            "prefill_share": sum(drops["prefill"]) / (pairs * layers),
                            "decode": sum(drops["decode"]),
                            "capacity": M.group_capacity(toks.shape[1], cfg.moe)}
        print(f"{arch} {dtype}: prefill drops by layer {drops['prefill']} of {pairs} pairs, "
              f"decode drops {sum(drops['decode'])}", flush=True)
        if sum(drops["prefill"]) == 0 or sum(drops["decode"]) != 0:
            raise AssertionError(f"{arch} {dtype}: drops {drops}; want some in the prefill, "
                                 f"none in the decode steps")
    top = float(flogits.abs().max())
    row_err = (steps - flogits).abs().amax(-1)                 # (B, NEW_TOKENS)
    rel = float(row_err.max()) / top
    bar = max(ZOO_RTOL[dtype], ULP_FACTOR * ulp_err / top)
    differ = flogits.argmax(-1) != greedy.long()
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
        raise AssertionError(f"{arch} {dtype}: greedy tokens differ from the forward's at "
                             f"margins {margins[differ].tolist()}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} {dtype}: one-ulp response {out['vs_forward']['one_ulp_input_response']} "
          f"of max |logit|, bar {bar}, step error {rel}", flush=True)
    if arch.startswith("llama") and dtype == "bfloat16":
        out["split"] = split_lens(cfg, params, toks)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
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
    """Z6 / Z10 / Z18c / Z19 / Z20 / Z22c: a full-width f32 copy of ``arch``
    cut to ``n_layers`` through the kernels on the card and through the
    plain versions on the CPU, same weights (and the same ``front_inputs``)."""
    cfg = served_cfg(arch, n_layers=n_layers, dtype="float32")
    per_prefill, per_step = per_token_launches(cfg)
    params_cpu = T.init_params(0, cfg, device="cpu")
    params_gpu = tree_map(torch.Tensor.cuda, params_cpu)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(padded([rng.integers(0, cfg.vocab, n).astype(np.int32)
                                    for n in prompt_lens]))
    front = front_inputs(cfg, len(prompt_lens), "cpu")
    slots = n_prefix(cfg) + toks.shape[1] + n_new

    def greedy_run(params, dev):
        batch = {k: t.to(dev) for k, t in {"tokens": toks, **front}.items()}
        with torch.inference_mode():
            logits, cache, pos = T.prefill(params, cfg, batch, slots)
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
    out = {"arch": arch, "n_layers": n_layers, "dtype": "float32",
           "prompt_lens": list(prompt_lens),
           "new_tokens": n_new, "prefill_rel_err": prefill_err, "step_rel_err": step_err,
           "tokens_compared": compared, "diverged_at_near_ties": diverged, "launches": counts}
    if cfg.moe is not None:
        # Z18c: the prompt's drops at capacity, on the card (uncounted)
        with torch.inference_mode():
            drops = served_forward(params_gpu, cfg, toks.cuda(), toks.shape[1])[1]["prefill"]
        out["prefill_drops_by_layer"] = drops
        out["capacity"] = M.group_capacity(toks.shape[1], cfg.moe)
        if sum(drops) == 0:
            raise AssertionError(f"Z18c {arch}: the prefill dropped no pair")
    del params_gpu
    torch.cuda.empty_cache()
    return out


def layers_check(arch, prompt_lens=(256, 181), rtol=1e-3, **changes) -> dict:
    """Z21c: the first two layers of one full-width f32 period of ``arch``
    (for jamba with its MoE: l0, a Mamba mixer with its dense FFN, and l1,
    one with its MoE), each through ``T.apply_layer_seq`` on the card (the
    kernels) and on the CPU (the plain versions) with the same weights, fed
    the same input: N(0, 1) for l0, the CPU's output of l0 for l1.  A whole
    f32 period would put 53 GB on the host."""
    cfg = served_cfg(arch, dtype="float32", **changes)
    descs, _ = T.block_structure(cfg)
    gen = torch.Generator().manual_seed(0)
    b, s = len(prompt_lens), max(prompt_lens)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((b, s, cfg.d_model))
                         .astype(np.float32))
    positions = torch.arange(s)
    rows = []
    for j, desc in enumerate(descs[:2]):
        t0 = time.perf_counter()
        p_cpu = T.init_layer(gen, desc, cfg, torch.device("cpu"))
        p_gpu = tree_map(torch.Tensor.cuda, p_cpu)
        with torch.inference_mode():
            reset_launches()
            got = T.apply_layer_seq(p_gpu, desc, x.cuda(), cfg, positions.cuda(),
                                    window=cfg.sliding_window)[0]
            torch.cuda.synchronize()
            counts = launch_counts()
            want = T.apply_layer_seq(p_cpu, desc, x, cfg, positions,
                                     window=cfg.sliding_window)[0]
        check_launches(f"Z21c {arch} l{j}", counts, {"mamba_scan": int(desc.mixer == "mamba"),
                                                    "flash_attention": int(desc.mixer == "attn")})
        rel = float((got.cpu() - want).abs().max()) / float(want.abs().max())
        row = {"layer": f"l{j}", "mixer": desc.mixer, "ffn": desc.ffn, "B": b, "S": s,
               "rel_err": rel, "launches": counts,
               "param_gb": sum(t.numel() * t.element_size() for t in tree_leaves(p_cpu)) / 1e9,
               "s": time.perf_counter() - t0}
        if desc.ffn == "moe":
            with torch.inference_mode():
                h = T._apply_norm(p_cpu["norm1"], x, cfg)
                h = T._apply_norm(p_cpu["norm2"], x + mamba_seq(p_cpu["mamba"], h, cfg)[0], cfg)
                row["drops"] = int(M.dropped_pairs(h, p_cpu["ffn"], cfg.moe))
                row["pairs"] = b * s * cfg.moe.top_k
        rows.append(row)
        print(f"Z21c {arch}", json.dumps(row), flush=True)
        if not torch.isfinite(got).all() or rel > rtol:
            raise AssertionError(f"Z21c {arch} l{j}: the card's output off the CPU's by {rel} "
                                 f"of max (bar {rtol})")
        x = want
        del p_gpu, got
        torch.cuda.empty_cache()
    return {"arch": arch, "dtype": "float32", "layers": rows}


def batcher_requests(cfg, prompt_lens) -> list:
    """Z23's requests: ``prompt_lens`` drawn as ``serve_zoo`` draws them, then
    4 prompts of 1-2000 tokens from numpy seed 2; ``BATCHER_ARRIVALS`` and
    ``BATCHER_MAX_NEW``."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    rng = np.random.default_rng(2)
    prompts += [rng.integers(0, cfg.vocab, n).astype(np.int32)
                for n in rng.integers(1, 2001, len(BATCHER_ARRIVALS) - len(prompts))]
    return [StreamRequest(i, p, max_new=m, arrival=a)
            for i, (p, m, a) in enumerate(zip(prompts, BATCHER_MAX_NEW, BATCHER_ARRIVALS))]


def batcher_run(arch, prompt_lens, dtype="bfloat16") -> dict:
    """Z23: ``ContinuousBatcher`` on ``BATCHER_SLOTS`` slots, ``arch`` whole in
    ``dtype``.  Each admit prefills one request (its kernels once a layer),
    each decode step runs every slot (the scans once a layer); the launches
    are counted from the admits and the steps.  Every request must finish
    with ``max_new`` tokens in the vocabulary.  Then a second batcher replays
    the same requests, its step wrapped to keep each slot's logits at each
    tick, and must serve the same tokens; each request's logits at its ticks
    are held under Z4's rule against one full forward over its prompt and
    served tokens.  In f32 they are also held at ``ZOO_RTOL["float32"]``
    against the request served alone (``T.prefill`` and ``T.serve_step`` at
    an int position), which holds the slot rows and refills where Z4's bar
    is loose: bf16's one-ulp response puts rwkv6-1.6b's at 0.4-2 of max
    |logit|, and even f32's is about 1e-2 at its one-token prompt.
    Last, one admit of the longest prompt and one tick with every slot
    active run under ``device_breakdown``."""
    t_phase = time.perf_counter()
    cfg = served_cfg(arch, dtype=dtype)
    per_prefill, per_step = per_token_launches(cfg)
    params = T.init_params(0, cfg, device="cuda")
    reqs = batcher_requests(cfg, prompt_lens)
    cache_len = max(len(r.prompt) for r in reqs) + max(BATCHER_MAX_NEW)
    batcher = ContinuousBatcher(cfg, params, n_slots=BATCHER_SLOTS, cache_len=cache_len,
                                device="cuda")

    def timed_admits(b) -> list:
        """Wrap ``b``'s admit to time each behind a synchronize."""
        took, admit = [], b._admit

        def timed_admit(req, slot):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            admit(req, slot)
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t0)
        b._admit = timed_admit
        return took
    admit_s = timed_admits(batcher)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = batcher.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: len(reqs) * n + batcher.steps * per_step[k] for k, n in per_prefill.items()}
    check_launches(f"Z23 {arch}", counts, want)
    for r in reqs:
        if not r.done or len(r.out) != r.max_new or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"Z23 {arch}: request {r.rid} (max_new {r.max_new}) got {r.out}")
    if len(done) != len(reqs):
        raise AssertionError(f"Z23 {arch}: {len(done)} of {len(reqs)} requests finished")
    out = {"arch": arch, "dtype": cfg.dtype, "slots": BATCHER_SLOTS, "cache_len": cache_len,
           "prompt_lens": [len(r.prompt) for r in reqs], "arrivals": list(BATCHER_ARRIVALS),
           "max_new": list(BATCHER_MAX_NEW), "finish_order": [r.rid for r in done],
           "admits": len(admit_s), "steps": batcher.steps, "run_ms": 1e3 * run_s,
           "admit_ms": [1e3 * t for t in admit_s],
           "tick_ms": 1e3 * (run_s - sum(admit_s)) / batcher.steps,
           "launches": counts, "launches_want": want}

    # the replay: the same requests on a fresh batcher, each step's logits kept
    replay = ContinuousBatcher(cfg, params, n_slots=BATCHER_SLOTS, cache_len=cache_len,
                               device="cuda")
    ticks, step = [], replay._step

    def kept_step(cache, token, pos):
        logits, cache = step(cache, token, pos)
        ticks.append(([(slot, r.rid) for slot, r in replay.pool.occupied()], logits))
        return logits, cache
    replay._step = kept_step
    replay_admit_s = timed_admits(replay)
    again = batcher_requests(cfg, prompt_lens)
    replay.run(again)
    if [r.out for r in again] != [r.out for r in reqs]:
        raise AssertionError(f"Z23 {arch}: the replay served other tokens")
    out["replay_admit_ms"] = [1e3 * t for t in replay_admit_s]
    by_rid = {r.rid: [] for r in reqs}
    for slots, logits in ticks:
        for slot, rid in slots:
            by_rid[rid].append(logits[slot])
    holds = []
    with torch.inference_mode():
        for r in reqs:
            steps = torch.stack(by_rid[r.rid])                    # (max_new - 1, V)
            served = torch.tensor(r.out, dtype=torch.int32, device="cuda")
            seq = torch.cat([torch.from_numpy(r.prompt).cuda(), served[:-1]])[None]
            first = len(r.prompt)             # the forward's position of the first tick
            flogits = T.logits_from_x(params, cfg,
                                      T.forward(params, cfg, {"tokens": seq})["x"])[0, first:]
            flogits = flogits.float()
            flipped = {**params, "embed": ulp_flip(params["embed"])}
            ulp = T.logits_from_x(flipped, cfg,
                                  T.forward(flipped, cfg, {"tokens": seq})["x"])[0, first:]
            del flipped
            top = float(flogits.abs().max())
            ulp_err = float((ulp.float() - flogits).abs().max())
            row_err = (steps - flogits).abs().amax(-1)
            rel = float(row_err.max()) / top
            bar = max(ZOO_RTOL[cfg.dtype], ULP_FACTOR * ulp_err / top)
            differ = flogits.argmax(-1) != served[1:].long()
            margins = top2_margin(flogits)
            if not torch.isfinite(steps).all() or rel > bar:
                raise AssertionError(f"Z23 {arch}: request {r.rid}'s tick logits off the forward's "
                                     f"by {rel} of max |logit| (bar {bar})")
            if bool((differ & (margins > 2 * row_err)).any()):
                raise AssertionError(f"Z23 {arch}: request {r.rid}'s tokens differ from the "
                                     f"forward's at margins {margins[differ].tolist()}")
            hold = {"rid": r.rid, "ticks": len(by_rid[r.rid]), "rel_err": rel, "bar": bar,
                    "tokens_differ": int(differ.sum())}
            if cfg.dtype == "float32":
                logits, cache, pos = T.prefill(params, cfg, {"tokens": seq[:, :first]}, cache_len)
                alone = []
                for i in range(len(r.out) - 1):
                    logits, cache = T.serve_step(params, cfg, cache, served[None, i:i + 1], pos + i)
                    alone.append(logits[0])
                del cache
                hold["vs_alone"] = float((steps - torch.stack(alone)).abs().max()) / top
                if hold["vs_alone"] > ZOO_RTOL["float32"]:
                    raise AssertionError(f"Z23 {arch}: request {r.rid}'s tick logits off the "
                                         f"request served alone by {hold['vs_alone']} of max "
                                         f"|logit| (bar {ZOO_RTOL['float32']})")
            holds.append(hold)
    out["vs_forward"] = holds

    # one admit of the longest prompt into a free pool, then one tick with
    # every slot active: the other slots admitted too, each request one
    # token from its end, so ``run`` makes exactly one tick
    longest = max(reqs, key=lambda r: len(r.prompt))
    fresh = [StreamRequest(r.rid, r.prompt, max_new=2) for r in reqs[:BATCHER_SLOTS]]
    fresh[0] = StreamRequest(longest.rid, longest.prompt, max_new=2)
    with torch.inference_mode():
        out["admit_profile"] = device_breakdown(lambda: replay._admit(fresh[0], 0))
        for slot, r in enumerate(fresh[1:], 1):
            replay._admit(r, slot)
    out["admit_profile"]["prompt_len"] = len(longest.prompt)
    steps_before = replay.steps
    out["tick_profile"] = device_breakdown(lambda: replay.run([]))
    if replay.steps != steps_before + 1 or not all(r.done for r in fresh):
        raise AssertionError(f"Z23 {arch}: the profiled run made {replay.steps - steps_before} "
                             f"ticks, want 1")
    del params, batcher, replay
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def multipod_rank(rank, world, tmp, stages, ae, tokens, refs, cfg) -> dict:
    """One pod of Z26, a spawned process on the one card: in each wire mode
    one counted step (launches, the bytes sent, the tail's logits held to
    the sequential composition's bit for bit), ``MULTIPOD_STEPS`` steps on
    the host clock between barriers, and one under ``device_breakdown``;
    this process's peak (the weights are the parent's, mapped by CUDA IPC,
    and not in it)."""
    launch_mesh.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cuda:0",
                                    timeout_s=MULTIPOD_TIMEOUT_S)
    try:
        mesh = launch_mesh.make_mesh_compat((2, 1, 1), ("pod", "data", "model"))
        stage = mesh.get_local_rank("pod")
        torch.cuda.reset_peak_memory_stats()
        out = {"rank": rank, "stage": stage, "modes": {}}
        for mode in SP.WIRE_MODES:
            def step():
                return SP.multipod_split_step(stages[stage], cfg, {"tokens": tokens}, mesh,
                                              ae=None if mode == "raw" else ae,
                                              n_micro=MULTIPOD_MICRO,
                                              quantize_wire=mode == "ae_int8")
            reset_launches()
            logits = step()
            torch.cuda.synchronize()
            row = {"launches": launch_counts(), "returned": logits is not None,
                   "wire_bytes": SP.multipod_split_step.wire_bytes[mode]}
            if logits is not None:
                row["bit_equal"] = bool(torch.equal(logits, refs[mode]))
                row["max_abs_err"] = rows_max_abs(logits, refs[mode])
            del logits
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MULTIPOD_STEPS):
                step()
            torch.cuda.synchronize()
            dist.barrier()
            row["step_ms"] = 1e3 * (time.perf_counter() - t0) / MULTIPOD_STEPS
            dist.barrier()
            row["profile"] = device_breakdown(step, top=8)
            out["modes"][mode] = row
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
    return out


def rows_max_abs(a, b) -> float:
    """max |a - b| over (B, S, V) logits, a batch row at a time in f32."""
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def multipod(gen) -> dict:
    """Z26: the multi-pod split pipeline, llama3-8b whole in bf16 over two
    gloo ranks on the one card.  The parent draws the weights once and
    hands each rank its ``stage_params`` through CUDA IPC.  Each wire mode's
    sequential composition (``sequential_split_step``: the same microbatches
    and shapes in one process) is timed here first; the raw one is held to
    one ``forward`` over the whole batch under Z4's rule; the codec kernels
    are timed at the wire's shape; then the ranks run and the tail's logits
    are held bit for bit to the composition's, the wire bytes to
    ``MULTIPOD_WIRE_BYTES`` and each rank's launches to the code's."""
    t_phase = time.perf_counter()
    cfg = get_config(MULTIPOD_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "batch": MULTIPOD_BATCH, "seq": MULTIPOD_SEQ, "n_micro": MULTIPOD_MICRO,
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9}
    ae = B.init_bottleneck(3, (cfg.d_model,), 0.5, device="cuda")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (MULTIPOD_BATCH, MULTIPOD_SEQ))
                              .astype(np.int32)).cuda()
    n_groups = T.block_structure(cfg)[1]
    flash = n_groups // 2 * MULTIPOD_MICRO      # a stage's launches a step
    refs, modes = {}, {}
    with torch.no_grad():
        for mode in SP.WIRE_MODES:
            codec = MULTIPOD_MICRO * (mode == "ae_int8")

            def run():
                return SP.sequential_split_step(params, cfg, {"tokens": tokens},
                                                ae=None if mode == "raw" else ae,
                                                n_micro=MULTIPOD_MICRO,
                                                quantize_wire=mode == "ae_int8")
            reset_launches()
            refs[mode] = run()
            torch.cuda.synchronize()
            counts = launch_counts()
            check_launches(f"Z26 {mode} sequential", counts,
                           {"flash_attention": 2 * flash, "bottleneck_compress": codec,
                            "bottleneck_decompress": codec})
            t0 = time.perf_counter()
            for _ in range(MULTIPOD_STEPS):
                again = run()
            torch.cuda.synchronize()
            modes[mode] = {"sequential_ms": 1e3 * (time.perf_counter() - t0) / MULTIPOD_STEPS,
                           "sequential_launches": counts}
            if not torch.equal(again, refs[mode]):
                raise AssertionError(f"Z26 {mode}: two sequential steps differ in some bit")
            del again
        # the raw composition against one forward over the whole batch, and
        # that forward's response to one rounding of its embedding (Z4's rule)
        flogits = T.logits_from_x(params, cfg, T.forward(params, cfg, {"tokens": tokens})["x"])
        flipped = {**params, "embed": ulp_flip(params["embed"])}
        moved = T.logits_from_x(flipped, cfg, T.forward(flipped, cfg, {"tokens": tokens})["x"])
        del flipped
    top = max(float(x.abs().max()) for x in flogits)
    ulp_err, err = rows_max_abs(moved, flogits) / top, rows_max_abs(refs["raw"], flogits) / top
    del flogits, moved
    bar = max(ZOO_RTOL["bfloat16"], ULP_FACTOR * ulp_err)
    modes["raw"]["vs_forward"] = {"rel_err": err, "one_ulp_input_response": ulp_err, "bar": bar,
                                  "max_abs_logit": top}
    if err > bar:
        raise AssertionError(f"Z26 raw: the composition's logits are off the forward's by {err} "
                             f"of max |logit| (bar {bar})")
    # the codec kernels at the wire's shape: a microbatch's rows
    n, latent = MULTIPOD_BATCH // MULTIPOD_MICRO * MULTIPOD_SEQ, B.latent_channels(cfg.d_model, 0.5)
    out["codec"] = [check_compress("multipod_wire", n, cfg.d_model, latent, gen),
                    check_decompress("multipod_wire", n, cfg.d_model, latent, gen)]
    torch.cuda.empty_cache()
    out["parent_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    stages = (SP.stage_params(params, cfg, 0), SP.stage_params(params, cfg, 1))
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_mesh.spawn_ranks(multipod_rank, 2, (tmp, stages, ae, tokens, refs, cfg),
                                        timeout_s=MULTIPOD_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t0
    by_stage = {r["stage"]: r for r in ranks}
    if sorted(by_stage) != [0, 1]:
        raise AssertionError(f"Z26: the ranks hold stages {sorted(by_stage)}")
    for mode in SP.WIRE_MODES:
        head, tail = by_stage[0]["modes"][mode], by_stage[1]["modes"][mode]
        codec = MULTIPOD_MICRO * (mode == "ae_int8")
        check_launches(f"Z26 {mode} head", head["launches"],
                       {"flash_attention": flash, "bottleneck_compress": codec})
        check_launches(f"Z26 {mode} tail", tail["launches"],
                       {"flash_attention": flash, "bottleneck_decompress": codec})
        for row in (head, tail):
            check_flash_route(f"Z26 {mode}", row["launches"], cfg.dtype, flash)
        if head["returned"] or not tail["returned"]:
            raise AssertionError(f"Z26 {mode}: the head returned logits or the tail none")
        if not tail["bit_equal"]:
            raise AssertionError(f"Z26 {mode}: the tail's logits differ from the sequential "
                                 f"composition's by up to {tail['max_abs_err']}")
        if (head["wire_bytes"], tail["wire_bytes"]) != (MULTIPOD_WIRE_BYTES[mode], 0):
            raise AssertionError(f"Z26 {mode}: sent {head['wire_bytes']} and "
                                 f"{tail['wire_bytes']} B, want {MULTIPOD_WIRE_BYTES[mode]} and 0")
        modes[mode].update(
            step_ms=max(head["step_ms"], tail["step_ms"]),
            step_over_sequential=max(head["step_ms"], tail["step_ms"])
            / modes[mode]["sequential_ms"],
            wire_bytes=head["wire_bytes"],
            # the reference's HLO count: both directions and the drain wave
            reference_count_bytes=head["wire_bytes"] * 2 * (MULTIPOD_MICRO + 1) // MULTIPOD_MICRO,
            busy_share={"head": head["profile"]["busy_share"],
                        "tail": tail["profile"]["busy_share"]})
    out["modes"], out["ranks"] = modes, ranks
    del params, stages, refs
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def launchers() -> dict:
    """Z26's launchers as subprocesses, as a user runs them: ``serve`` on
    llama3.2-3b whole, its tokens equal to a ``ServingEngine`` run in this
    process and its last line naming the card; ``train`` on rwkv6-1.6b
    whole for 2 steps with ``--ckpt``, its checkpoint restored and held bit
    for bit to the parameters of the same run made here by ``main`` (bf16
    -> f32 -> bf16 is exact, and the two runs are the same work on the same
    card)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    card = torch.cuda.get_device_name(0)

    def cli(module, args) -> list:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=MULTIPOD_TIMEOUT_S)
        if run.returncode:
            raise AssertionError(f"Z26: {module} exited {run.returncode}:\n{run.stderr[-3000:]}")
        print(f"Z26 {module} took {time.perf_counter() - t0:.1f} s", flush=True)
        return run.stdout.splitlines()

    out = {}
    lines = cli("repro_torch.launch.serve", LAUNCH_SERVE)
    got = [json.loads(line.split(": ", 1)[1]) for line in lines if line.startswith("req ")]
    cfg = get_config("llama3.2-3b")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16).astype(np.int32), max_new=16)
            for i in range(4)]
    ServingEngine(cfg, T.init_params(0, cfg, device="cuda"), cache_slots=16 + 16 + 8,
                  device="cuda").run(reqs)
    want = [r.out for r in reqs]
    if got != want or not lines[-1].endswith(f"tok/s on {card})"):
        raise AssertionError(f"Z26 serve launcher: tokens {got}, want {want}; last line "
                             f"{lines[-1]!r}")
    out["serve"] = {"args": LAUNCH_SERVE, "last_line": lines[-1], "tokens_equal": True}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rwkv.npz")
        lines = cli("repro_torch.launch.train", LAUNCH_TRAIN + ["--ckpt", path])
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            params, metrics = launch_train.main(LAUNCH_TRAIN)
        t0 = time.perf_counter()
        back = checkpoint.restore(path, params)
        out["train"] = {"args": LAUNCH_TRAIN, "log": lines, "loss": float(metrics["loss"]),
                        "log_here": log.getvalue().splitlines(),
                        "checkpoint_gb": os.path.getsize(path) / 1e9,
                        "restore_s": time.perf_counter() - t0,
                        "equal": all(torch.equal(a, b) for a, b in
                                     zip(tree_leaves(back), tree_leaves(params)))}
        if not math.isfinite(out["train"]["loss"]) or not out["train"]["equal"]:
            raise AssertionError(f"Z26 train launcher: {out['train']}")
        del params, metrics, back
    torch.cuda.empty_cache()
    return out


def ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each value of ``t``, in f32."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[dtype]
    return torch.exp2((torch.frexp(t.float())[1] - bits).float())


def sharded_rank(rank, world, tmp, runs) -> list:
    """One rank of Z27, a spawned process on the one card, running each of
    ``runs`` (``(cfg, B, S, ref)``) in turn on the (2, 2) mesh
    (:func:`sharded_run`)."""
    launch_mesh.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cuda:0",
                                    timeout_s=SHARDED_TIMEOUT_S)
    try:
        mesh = launch_mesh.make_mesh_compat(*SHARDED_MESH)
        rows = []
        for cfg, b, s, ref in runs:
            rows.append(dict(sharded_run(cfg, b, s, ref, mesh), rank=rank))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


def sharded_run(cfg, b, s, ref, mesh) -> dict:
    """The train state drawn whole and cut into this rank's blocks
    (``init_train_state`` with the mesh), then ``SHARDED_STEPS`` steps of
    the sharded ``make_train_step``, each counted (kernel launches, the
    collectives' bytes), the first on the host clock between barriers, the
    last under ``device_breakdown``; each block and, in f32, each moment
    ``ref`` holds held on the card to its part of the one-process step's
    tree (``ref``, the parent's, mapped by CUDA IPC)."""
    oc = OptConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = init_train_state(0, cfg, oc, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    row = {"coord": shard_blocks.coordinates(mesh), "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "state_gb": sum(t.numel() * t.element_size()
                           for t in tree_leaves((params, state))) / 1e9,
           "losses": [], "launches": [], "traffic": [], "moments": {}}
    batch = train_batch(cfg, b, s, "cuda")
    step = make_train_step(cfg, oc, mesh=mesh)
    specs = sharding_rules.param_specs(T.param_spec(cfg), mesh)
    torch.cuda.reset_peak_memory_stats()
    for i in range(SHARDED_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shard_blocks.reset_traffic()
        t0 = time.perf_counter()
        if i < SHARDED_STEPS - 1:
            params, state, metrics = step(params, state, batch)
            row["losses"].append(float(metrics["loss"]))        # synchronises
            row["step_ms"] = 1e3 * (time.perf_counter() - t0)
        else:
            done = {}
            row["profile"] = device_breakdown(
                lambda: done.update(out=step(params, state, batch)), top=8)
            params, state, metrics = done.pop("out")
            row["losses"].append(float(metrics["loss"]))
        row["launches"].append(launch_counts())
        row["traffic"].append(dict(shard_blocks.traffic))
        if f"m{i + 1}" in ref:
            row["moments"][f"step {i + 1}"] = {
                key: max(float((blk - shard_blocks.local_block(full, spec, mesh)).abs().max())
                         / max(float(full.abs().max()), 1e-30)
                         for blk, spec, full in zip(tree_leaves(state[key]), tree_leaves(specs),
                                                    tree_leaves(ref[f"{key}{i + 1}"])))
                for key in ("m", "v") if f"{key}{i + 1}" in ref}
    row["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del batch, step
    torch.cuda.empty_cache()
    size = 2 * oc.lr * SHARDED_STEPS
    worst, err = 0.0, 0.0
    for blk, spec, full in zip(tree_leaves(params), tree_leaves(specs),
                               tree_leaves(ref["params"])):
        want = shard_blocks.local_block(full, spec, mesh).float()
        gap = (blk.float() - want).abs()
        bound = size + SHARDED_STEPS * ulp(want.abs() + size, blk.dtype)
        err = max(err, float(gap.max()))
        worst = max(worst, float((gap / bound).max()))
    row["params"] = {"max_abs_err": err, "over_bound": worst, "step_size": size}
    return row


def sharded_training() -> dict:
    """Z27: each of ``SHARDED_RUNS`` first as the one-process step on the
    card (``SHARDED_STEPS`` steps, launches counted; its parameters, and in
    f32 its moments after step 1 and after the last step, kept on the card,
    the rest freed), then, in one spawn, as four gloo ranks on a (2, 2) mesh
    (:func:`sharded_rank`); each step's loss held to the one-process
    step's, every block to its part of the one-process tree, each rank's
    launches to the code's count."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    out = {"arch": SHARDED_ARCH, "mesh": SHARDED_MESH, "steps": SHARDED_STEPS, "runs": [],
           "card_free_gb_at_start": free / 1e9, "card_gb": total / 1e9}
    given = []
    for dtype, n_layers, b, s in SHARDED_RUNS:
        changes = {"dtype": dtype} if n_layers is None else {"dtype": dtype, "n_layers": n_layers}
        cfg = served_cfg(SHARDED_ARCH, **changes)
        want = scan_and_flash_launches(cfg, per_token_launches(cfg)[0])
        oc = OptConfig()
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, state = init_train_state(0, cfg, oc, device="cuda")
        batch = train_batch(cfg, b, s, "cuda")
        step = make_train_step(cfg, oc)
        one, ref = {"losses": [], "step_ms": []}, {}
        for i in range(SHARDED_STEPS):
            reset_launches()
            t1 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            one["losses"].append(float(metrics["loss"]))
            one["step_ms"].append(1e3 * (time.perf_counter() - t1))
            check_train_launches(f"Z27 {dtype} one-process step {i}", launch_counts(), want)
            if dtype == "float32":
                ref[f"m{i + 1}"] = tree_map(torch.clone, state["m"])
                if i == SHARDED_STEPS - 1:
                    ref[f"v{i + 1}"] = tree_map(torch.clone, state["v"])
        one["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        one["s"] = time.perf_counter() - t0
        ref["params"] = params
        del state, batch, step, params
        given.append((cfg, b, s, ref))
        out["runs"].append({"dtype": dtype, "n_layers": cfg.n_layers, "B": b, "S": s,
                            "one_process": one, "want": want})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_mesh.spawn_ranks(sharded_rank, 4, (tmp, given),
                                        timeout_s=SHARDED_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t0
    del given
    torch.cuda.empty_cache()
    for j, run in enumerate(out["runs"]):
        one, want, dtype = run["one_process"], run.pop("want"), run["dtype"]
        run["ranks"] = [rows[j] for rows in ranks]
        print(f"Z27 {dtype} {run['n_layers']} layers: one-process step {one['step_ms'][-1]:.1f} "
              f"ms, peak {one['peak_gb']:.2f} GB; ranks " + "; ".join(
                  f"{r['rank']}: step {r['step_ms']:.1f} ms (profiled "
                  f"{r['profile']['wall_ms']:.1f}), busy {r['profile']['busy_share']:.3f}, "
                  f"peak {r['step_peak_gb']:.2f} GB, gathered {r['traffic'][-1]['all_gather']} "
                  f"B, reduced {r['traffic'][-1]['reduce_scatter'] + r['traffic'][-1]['all_reduce']}"
                  f" B, params {r['params']}, moments {r['moments']}" for r in run["ranks"]),
              flush=True)
        for r in run["ranks"]:
            what = f"Z27 {dtype} rank {r['rank']}"
            for i, counts in enumerate(r["launches"]):
                check_train_launches(f"{what} step {i}", counts, want)
            for i, (got, ref_loss) in enumerate(zip(r["losses"], one["losses"])):
                if not abs(got - ref_loss) <= SHARDED_LOSS_RTOL[dtype] * abs(ref_loss):
                    raise AssertionError(f"{what} step {i}: loss {got}, one-process {ref_loss}")
            if r["params"]["over_bound"] > 1:
                raise AssertionError(f"{what}: a parameter is off the one-process step's by "
                                     f"{r['params']} of AdamW's bound")
            for when, gaps in r["moments"].items():
                if max(gaps.values()) > SHARDED_MOMENT[when]:
                    raise AssertionError(f"{what}: moments after {when} off by {gaps} of their "
                                         f"leaf's max (bar {SHARDED_MOMENT[when]})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def serving_rank(rank, world, tmp, cfg, prompts, ref) -> list:
    """One rank of Z28, a spawned process on the one card: each of
    ``SERVE_SHARDED_MESHES`` in turn (:func:`serving_run`)."""
    launch_mesh.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cuda:0",
                                    timeout_s=SERVE_SHARDED_TIMEOUT_S)
    try:
        rows = []
        for name, shape in SERVE_SHARDED_MESHES.items():
            mesh = launch_mesh.make_mesh_compat(shape, ("data", "model"))
            rows.append(dict(serving_run(cfg, prompts, ref, mesh), rank=rank, mesh=name))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


def serving_run(cfg, prompts, ref, mesh) -> dict:
    """This rank's blocks drawn block by block (``init_params(..., mesh=,
    profile="inference")``), each held to its spec's block shape; the
    requests served through ``ServingEngine(mesh=)``, counted; then the
    replay: ``prefill`` and ``NEW_TOKENS`` decode steps under the mesh
    fed the one-process tokens, each counted (launches, the collectives'
    bytes) and on the host clock between barriers, the last step under
    ``device_breakdown``; each step's logits and the cache blocks after the
    prefill and after the last step held on the card to ``ref``, the
    one-process run's (the parent's, mapped by CUDA IPC)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda", mesh=mesh, profile="inference")
    torch.cuda.synchronize()
    specs = sharding_rules.param_specs(T.param_spec(cfg), mesh, profile="inference")
    for blk, spec, full in zip(tree_leaves(params), tree_leaves(specs),
                               tree_leaves(T.param_spec(cfg))):
        if blk.shape != shard_blocks.local_block(full, spec, mesh).shape:
            raise AssertionError(f"Z28: a block of {tuple(full.shape)} under {spec} is "
                                 f"{tuple(blk.shape)}")
    row = {"coord": shard_blocks.coordinates(mesh), "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "block_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9}
    slots = SERVE_SHARDED_PROMPT + NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()
    reqs = [Request(i, p, max_new=NEW_TOKENS) for i, p in enumerate(prompts)]
    dist.barrier()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ServingEngine(cfg, params, cache_slots=slots, device="cuda", mesh=mesh).run(reqs)
    torch.cuda.synchronize()
    row["run_ms"] = 1e3 * (time.perf_counter() - t0)
    row["launches"] = launch_counts()
    row["tokens"] = [r.out for r in reqs]
    batch = {"tokens": torch.from_numpy(padded(prompts)).cuda()}
    served = ref["tokens"]

    def gap(got, want):
        return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())

    def cache_gaps(cache, want) -> dict:
        cspecs = sharding_rules.cache_specs(want, mesh)
        out = {}
        for layer, leaves in want.items():
            for key, full in leaves.items():
                blk = shard_blocks.local_block(full, cspecs[layer][key], mesh)
                mine = cache[layer][key]
                if mine.shape != blk.shape:
                    raise AssertionError(f"Z28: cache {key} block {tuple(mine.shape)}, want "
                                         f"{tuple(blk.shape)}")
                if key == "kv_pos":
                    out[key] = int((mine != blk).sum())
                else:
                    out[key] = (float((mine.float() - blk.float()).abs().max())
                                / float(full.float().abs().max()))
        return out

    with torch.inference_mode():
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shard_blocks.reset_traffic()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, batch, slots, mesh=mesh)
        torch.cuda.synchronize()
        row["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        row["prefill_launches"] = launch_counts()
        row["prefill_traffic"] = dict(shard_blocks.traffic)
        replay = [logits]
        gaps = [gap(logits, ref["logits"][0])]
        row["cache_prefill"] = cache_gaps(cache, ref["cache_prefill"])
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shard_blocks.reset_traffic()
        steps = []
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS - 1):
            logits, cache = T.serve_step(params, cfg, cache, served[:, step:step + 1],
                                         pos + step, mesh=mesh)
            steps.append(logits)
        torch.cuda.synchronize()
        row["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / (NEW_TOKENS - 1)
        row["decode_traffic_per_token"] = {k: v // (NEW_TOKENS - 1)
                                           for k, v in shard_blocks.traffic.items()}
        last = NEW_TOKENS - 1
        done = {}
        row["decode_step_profile"] = device_breakdown(lambda: done.update(out=T.serve_step(
            params, cfg, cache, served[:, last:last + 1], pos + last, mesh=mesh)))
        logits, cache = done.pop("out")
        steps.append(logits)
        row["decode_launches"] = launch_counts()
        gaps += [gap(lg, want) for lg, want in zip(steps, ref["logits"][1:])]
        row["logits_rel_err"] = gaps
        row["first_splits"] = first_splits(row["tokens"], ref, replay + steps)
        row["cache_last"] = cache_gaps(cache, ref["cache_last"])
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, steps
    return row


def first_splits(tokens, ref, replay) -> list:
    """Where each batch row's served ``tokens`` first part from the
    one-process run's: the step; the one-process logits' top-2 margin there
    and this rank's teacher-forced replay's (fed the same tokens up to that
    step, so the served run saw the same logits), and the replay's largest
    gap in that row, each over the row's max |logit|; both picks."""
    out = []
    for b, (mine, want) in enumerate(zip(tokens, ref["tokens"].tolist())):
        i = next((i for i, (x, y) in enumerate(zip(mine, want)) if x != y), None)
        if i is None:
            continue
        w, g = ref["logits"][i][b].float(), replay[i][b].float()
        top = float(w.abs().max())
        wv, gv = w.topk(2).values, g.topk(2).values
        out.append({"row": b, "step": i, "margin": float(wv[0] - wv[1]) / top,
                    "replay_margin": float(gv[0] - gv[1]) / top,
                    "gap": float((g - w).abs().max()) / top,
                    "picks": [int(w.argmax()), int(g.argmax())]})
    return out


def sharded_serving() -> dict:
    """Z28: llama3.2-3b whole in bf16, first served in one process through
    ``ServingEngine`` (counted) and replayed, prefill and decode timed
    apart, fed the served tokens (each step's logits and the cache after
    the prefill and after the last step kept on the card, the weights then
    freed); then, in one spawn, four gloo ranks on the card on each of
    ``SERVE_SHARDED_MESHES`` (:func:`serving_run`).  Each rank's launches
    are held to the code's (28 ``wgmma_bf16`` flash forwards at the
    prefill, on its heads, none at decode), its replay's logits and cache
    blocks to the one-process run's, and every rank's served tokens to its
    "model" group's (one batch: every rank's)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = served_cfg(SERVE_SHARDED_ARCH)
    per_prefill, _ = per_token_launches(cfg)
    n_flash = per_prefill["flash_attention"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, SERVE_SHARDED_PROMPT).astype(np.int32)
               for _ in range(4)]
    slots = SERVE_SHARDED_PROMPT + NEW_TOKENS
    out = {"arch": SERVE_SHARDED_ARCH, "B": len(prompts), "prompt": SERVE_SHARDED_PROMPT,
           "new_tokens": NEW_TOKENS, "meshes": SERVE_SHARDED_MESHES}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = T.init_params(0, cfg, device="cuda")
    reqs = [Request(i, p, max_new=NEW_TOKENS) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ServingEngine(cfg, params, cache_slots=slots, device="cuda").run(reqs)
    torch.cuda.synchronize()
    one = {"run_ms": 1e3 * (time.perf_counter() - t0), "launches": launch_counts(),
           "tokens": [r.out for r in reqs]}
    check_flash_route("Z28 one-process served", one["launches"], cfg.dtype, n_flash)
    served = torch.tensor(one["tokens"], dtype=torch.int32, device="cuda")
    batch = {"tokens": torch.from_numpy(padded(prompts)).cuda()}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, batch, slots)
        torch.cuda.synchronize()
        one["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        cache_prefill = tree_map(torch.clone, cache)
        steps = [logits.float()]
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = T.serve_step(params, cfg, cache, served[:, step:step + 1], pos + step)
            steps.append(logits)
        torch.cuda.synchronize()
        one["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / NEW_TOKENS
        # the same replay with every embedding entry moved by one rounding:
        # how far one bf16 rounding moves these logits (printed, not a bar)
        flipped = {**params, "embed": ulp_flip(params["embed"])}
        flogits, fcache, _ = T.prefill(flipped, cfg, batch, slots)
        moved = [flogits.float()]

        def cache_moved(a, b) -> float:
            return max(float((a[layer][key].float() - b[layer][key].float()).abs().max())
                       / float(b[layer][key].float().abs().max())
                       for layer in b for key in ("k", "v"))
        one["cache_one_ulp_response"] = cache_moved(fcache, cache_prefill)
        for step in range(NEW_TOKENS):
            flogits, fcache = T.serve_step(flipped, cfg, fcache, served[:, step:step + 1],
                                           pos + step)
            moved.append(flogits)
        one["one_ulp_response"] = max(
            float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(moved, steps))
        one["cache_one_ulp_response"] = max(one["cache_one_ulp_response"],
                                            cache_moved(fcache, cache))
        del flipped, flogits, fcache, moved
    one["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # outside inference mode, so that CUDA IPC can map them into the ranks
    ref = {"tokens": served.clone(), "logits": torch.stack(steps).clone(),
           "cache_prefill": tree_map(torch.clone, cache_prefill),
           "cache_last": tree_map(torch.clone, cache)}
    del params, cache, cache_prefill, steps, logits
    torch.cuda.empty_cache()
    out["one_process"] = one
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_mesh.spawn_ranks(serving_rank, 4, (tmp, cfg, prompts, ref),
                                        timeout_s=SERVE_SHARDED_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    out["ranks"] = [row for rows in ranks for row in rows]
    first = {name: next(r for r in out["ranks"] if r["mesh"] == name)
             for name in SERVE_SHARDED_MESHES}
    out["bars"] = {"logits": SERVE_SHARDED_RTOL, "cache": SERVE_SHARDED_RTOL}
    for r in out["ranks"]:
        what = f"Z28 {r['mesh']} rank {r['rank']}"
        check_flash_route(f"{what} served", r["launches"], cfg.dtype, n_flash)
        check_flash_route(f"{what} prefill", r["prefill_launches"], cfg.dtype, n_flash)
        check_launches(f"{what} decode", r["decode_launches"], {})
        if r["tokens"] != first[r["mesh"]]["tokens"]:
            raise AssertionError(f"{what}: served other tokens than rank "
                                 f"{first[r['mesh']]['rank']}")
        worst = max(r["logits_rel_err"])
        if not worst <= out["bars"]["logits"]:
            raise AssertionError(f"{what}: logits off the one-process run's by {worst} of max "
                                 f"|logit| (bar {out['bars']['logits']})")
        for when in ("cache_prefill", "cache_last"):
            gaps = r[when]
            if gaps["kv_pos"] or max(gaps["k"], gaps["v"]) > out["bars"]["cache"]:
                raise AssertionError(f"{what}: {when} blocks off the one-process cache: {gaps} "
                                     f"(bar {out['bars']['cache']})")
    for name in SERVE_SHARDED_MESHES:
        rows = [r for r in out["ranks"] if r["mesh"] == name]
        agree = sum(a == b for a, b in zip(sum(rows[0]["tokens"], []), sum(one["tokens"], [])))
        out.setdefault("tokens_equal_one_process", {})[name] = agree
        print(f"Z28 {name}: one-process prefill {one['prefill_ms']:.1f} ms, decode "
              f"{one['decode_ms_per_token']:.2f} ms/token, peak {one['peak_gb']:.2f} GB, "
              f"one-ulp response {one['one_ulp_response']:.2e} of max |logit| (cache "
              f"{one['cache_one_ulp_response']:.2e}), bars {out['bars']}; served "
              f"tokens equal to the one-process run's: {agree} of {NEW_TOKENS * len(prompts)}; "
              "ranks " + "; ".join(
                  f"{r['rank']}: prefill {r['prefill_ms']:.1f} ms, decode "
                  f"{r['decode_ms_per_token']:.2f} ms/token, busy "
                  f"{r['decode_step_profile']['busy_share']:.3f}, peak {r['peak_gb']:.2f} GB, "
                  f"blocks {r['block_gb']:.2f} GB, prefill collectives {r['prefill_traffic']} "
                  f"B, a decode step's {r['decode_traffic_per_token']} B, logits err "
                  f"{max(r['logits_rel_err']):.2e}" for r in rows)
              + f"; rank 0's first splits from the one-process tokens {rows[0]['first_splits']}",
              flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def leaf_gaps(cache, want, mesh=None) -> dict:
    """Each cache leaf of ``cache`` against ``want``'s (its block under
    ``cache_specs`` where ``mesh`` is given): the largest gap over the
    layers relative to the whole leaf's max, ``kv_pos`` as the count of
    slots that differ."""
    cspecs = sharding_rules.cache_specs(want, mesh) if mesh is not None else None
    out = {}
    for layer, leaves in want.items():
        for key, full in leaves.items():
            blk = (shard_blocks.local_block(full, cspecs[layer][key], mesh) if mesh is not None
                   else full)
            mine = cache[layer][key]
            if mine.shape != blk.shape:
                raise AssertionError(f"Z29: cache {layer}/{key} block {tuple(mine.shape)}, want "
                                     f"{tuple(blk.shape)}")
            if key == "kv_pos":
                out[key] = out.get(key, 0) + int((mine != blk).sum())
            else:
                top = float(full.float().abs().max())
                gap = float((mine.float() - blk.float()).abs().max()) / top if top else 0.0
                out[key] = max(out.get(key, 0.0), gap)
    return out


def recurrent_one_process(arch, changes, prompts) -> tuple:
    """Z29's one-process run of ``arch``: ``ServingEngine`` (counted), then
    the teacher-forced replay (prefill and ``NEW_TOKENS`` steps fed
    the served tokens, timed apart) and the replay with every embedding
    entry moved by one rounding.  Returns the row and ``ref``, the served
    tokens, each step's logits and the cache after the prefill and after
    the last step, kept on the card outside inference mode (for CUDA IPC)."""
    cfg = served_cfg(arch, **changes)
    per_prefill, per_step = per_token_launches(cfg)
    slots = SERVE_SHARDED_PROMPT + NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = T.init_params(0, cfg, device="cuda")
    reqs = [Request(i, p, max_new=NEW_TOKENS) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ServingEngine(cfg, params, cache_slots=slots, device="cuda").run(reqs)
    torch.cuda.synchronize()
    one = {"arch": arch, "n_layers": cfg.n_layers, "run_ms": 1e3 * (time.perf_counter() - t0),
           "launches": launch_counts(), "tokens": [r.out for r in reqs]}
    check_launches(f"Z29 {arch} one-process served", one["launches"],
                   {k: n + NEW_TOKENS * per_step[k] for k, n in per_prefill.items()})
    check_flash_route(f"Z29 {arch} one-process served", one["launches"], cfg.dtype,
                      per_prefill["flash_attention"])
    served = torch.tensor(one["tokens"], dtype=torch.int32, device="cuda")
    batch = {"tokens": torch.from_numpy(padded(prompts)).cuda(),
             **front_inputs(cfg, len(prompts), "cuda")}

    def replay(p, batch):
        logits, cache, pos = T.prefill(p, cfg, batch, slots)
        prefilled = tree_map(torch.clone, cache)
        steps = [logits.float()]
        for step in range(NEW_TOKENS):
            logits, cache = T.serve_step(p, cfg, cache, served[:, step:step + 1], pos + step)
            steps.append(logits)
        return steps, prefilled, cache
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, batch, slots)
        torch.cuda.synchronize()
        one["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        cache_prefill = tree_map(torch.clone, cache)
        steps = [logits.float()]
        t0 = time.perf_counter()
        for step in range(NEW_TOKENS):
            logits, cache = T.serve_step(params, cfg, cache, served[:, step:step + 1], pos + step)
            steps.append(logits)
        torch.cuda.synchronize()
        one["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / NEW_TOKENS
        # how far one bf16 rounding of every embedding entry (and of every
        # frame: whisper's cross cache comes from them alone) moves the
        # logits and each cache leaf (the bars' second term)
        moved, fprefill, fcache = replay({**params, "embed": ulp_flip(params["embed"])},
                                         {k: ulp_flip(v) if v.is_floating_point() else v
                                          for k, v in batch.items()})
        one["one_ulp_response"] = max(
            float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(moved, steps))
        first, last = leaf_gaps(fprefill, cache_prefill), leaf_gaps(fcache, cache)
        one["cache_one_ulp_response"] = {k: max(first[k], last[k]) for k in last
                                         if k != "kv_pos"}
        del moved, fprefill, fcache
    one["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    ref = {"tokens": served.clone(), "logits": torch.stack(steps).clone(),
           "cache_prefill": tree_map(torch.clone, cache_prefill),
           "cache_last": tree_map(torch.clone, cache)}
    del params, cache, cache_prefill, steps, logits
    torch.cuda.empty_cache()
    return one, ref


def recurrent_rank(rank, world, tmp, runs) -> list:
    """One rank of Z29, a spawned process on the one card: each of
    ``SERVE_SHARDED_MESHES`` in turn, each of ``runs`` on it
    (:func:`recurrent_run`)."""
    launch_mesh.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cuda:0",
                                    timeout_s=SERVE_RECURRENT_TIMEOUT_S)
    try:
        rows = []
        for name, shape in SERVE_SHARDED_MESHES.items():
            mesh = launch_mesh.make_mesh_compat(shape, ("data", "model"))
            for arch, changes, prompts, ref in runs:
                row = recurrent_run(served_cfg(arch, **changes), prompts, ref, mesh)
                rows.append(dict(row, rank=rank, mesh=name, arch=arch))
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return rows


def recurrent_run(cfg, prompts, ref, mesh) -> dict:
    """This rank's blocks drawn block by block, each held to its spec's
    block shape; the replay under the mesh: ``prefill`` and
    ``NEW_TOKENS`` decode steps fed the one-process tokens, each
    part counted (launches, the collectives' bytes) and on the host clock
    between barriers, the last step under ``device_breakdown``; each step's
    logits and every cache leaf's blocks after the prefill and after the
    last step measured against ``ref``, the one-process run's (the
    parent's, mapped by CUDA IPC)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda", mesh=mesh, profile="inference")
    torch.cuda.synchronize()
    specs = sharding_rules.param_specs(T.param_spec(cfg), mesh, profile="inference")
    for blk, spec, full in zip(tree_leaves(params), tree_leaves(specs),
                               tree_leaves(T.param_spec(cfg))):
        if blk.shape != shard_blocks.local_block(full, spec, mesh).shape:
            raise AssertionError(f"Z29: a block of {tuple(full.shape)} under {spec} is "
                                 f"{tuple(blk.shape)}")
    row = {"coord": shard_blocks.coordinates(mesh), "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "block_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9}
    slots = SERVE_SHARDED_PROMPT + NEW_TOKENS
    batch = {"tokens": torch.from_numpy(padded(prompts)).cuda(),
             **front_inputs(cfg, len(prompts), "cuda")}
    served = ref["tokens"]

    def gap(got, want):
        return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shard_blocks.reset_traffic()
        t0 = time.perf_counter()
        logits, cache, pos = T.prefill(params, cfg, batch, slots, mesh=mesh)
        torch.cuda.synchronize()
        row["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        row["prefill_launches"] = launch_counts()
        row["prefill_traffic"] = dict(shard_blocks.traffic)
        gaps = [gap(logits, ref["logits"][0])]
        row["cache_prefill"] = leaf_gaps(cache, ref["cache_prefill"], mesh)
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shard_blocks.reset_traffic()
        steps = []
        last = NEW_TOKENS - 1
        t0 = time.perf_counter()
        for step in range(last):
            logits, cache = T.serve_step(params, cfg, cache, served[:, step:step + 1],
                                         pos + step, mesh=mesh)
            steps.append(logits)
        torch.cuda.synchronize()
        row["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / last
        row["decode_traffic_per_token"] = {k: v // last for k, v in shard_blocks.traffic.items()}
        done = {}
        row["decode_step_profile"] = device_breakdown(lambda: done.update(out=T.serve_step(
            params, cfg, cache, served[:, last:last + 1], pos + last, mesh=mesh)))
        logits, cache = done.pop("out")
        steps.append(logits)
        row["decode_launches"] = launch_counts()
        gaps += [gap(lg, want) for lg, want in zip(steps, ref["logits"][1:])]
        row["logits_rel_err"] = gaps
        row["cache_last"] = leaf_gaps(cache, ref["cache_last"], mesh)
        row["finite"] = bool(torch.isfinite(logits).all())
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, steps
    return row


def launched(counts) -> dict:
    """``{kernel: {route: n}}`` without the kernels and routes never launched."""
    return {k: {r: n for r, n in c.items() if n} for k, c in counts.items() if sum(c.values())}


def recurrent_serving() -> dict:
    """Z29: each of ``SERVE_RECURRENT`` first in one process
    (:func:`recurrent_one_process`), then, in one spawn, four gloo ranks on
    the card on each of ``SERVE_SHARDED_MESHES`` (:func:`recurrent_run`).
    Each rank's launches are held to the code's (each scan once a layer of
    its mixer at the prefill and in every decode step, on the rank's heads
    or channels; ``flash_attention`` on ``wgmma_bf16`` once an attention
    layer, cross-attention and encoder layer at the prefill, none at
    decode), its logits and cache blocks to the one-process run's under the
    bars (the larger of ``SERVE_SHARDED_RTOL`` and twice the one-ulp
    response, the cache leaf by leaf)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    out = {"B": 4, "prompt": SERVE_SHARDED_PROMPT, "new_tokens": NEW_TOKENS,
           "meshes": SERVE_SHARDED_MESHES, "one_process": {}}
    runs, cfgs = [], {}
    for arch, changes in SERVE_RECURRENT:
        cfg = cfgs[arch] = served_cfg(arch, **changes)
        prompts = [rng.integers(0, cfg.vocab, SERVE_SHARDED_PROMPT).astype(np.int32)
                   for _ in range(4)]
        one, ref = recurrent_one_process(arch, changes, prompts)
        out["one_process"][arch] = one
        runs.append((arch, changes, prompts, ref))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_mesh.spawn_ranks(recurrent_rank, 4, (tmp, runs),
                                        timeout_s=SERVE_RECURRENT_TIMEOUT_S)
    out["ranks_s"] = time.perf_counter() - t0
    del runs
    torch.cuda.empty_cache()
    out["ranks"] = [row for rows in ranks for row in rows]
    out["bars"] = {}
    for arch, one in out["one_process"].items():
        out["bars"][arch] = {
            "logits": max(SERVE_SHARDED_RTOL, ULP_FACTOR * one["one_ulp_response"]),
            **{k: max(SERVE_SHARDED_RTOL, ULP_FACTOR * v)
               for k, v in one["cache_one_ulp_response"].items()}}
    for r in out["ranks"]:
        arch, cfg = r["arch"], cfgs[r["arch"]]
        what = f"Z29 {arch} {r['mesh']} rank {r['rank']}"
        per_prefill, per_step = per_token_launches(cfg)
        check_launches(f"{what} prefill", r["prefill_launches"], per_prefill)
        check_flash_route(f"{what} prefill", r["prefill_launches"], cfg.dtype,
                          per_prefill["flash_attention"])
        check_launches(f"{what} decode", r["decode_launches"],
                       {k: n * NEW_TOKENS for k, n in per_step.items()})
        bars = out["bars"][arch]
        worst = max(r["logits_rel_err"])
        if not (r["finite"] and worst <= bars["logits"]):
            raise AssertionError(f"{what}: logits off the one-process run's by {worst} of max "
                                 f"|logit| (bar {bars['logits']}), finite {r['finite']}")
        for when in ("cache_prefill", "cache_last"):
            gaps = r[when]
            if gaps.get("kv_pos", 0) or any(g > bars[k] for k, g in gaps.items()
                                            if k != "kv_pos"):
                raise AssertionError(f"{what}: {when} blocks off the one-process cache: {gaps} "
                                     f"(bars {bars})")
    for arch, one in out["one_process"].items():
        for name in SERVE_SHARDED_MESHES:
            rows = [r for r in out["ranks"] if r["mesh"] == name and r["arch"] == arch]
            print(f"Z29 {arch} {name}: one-process prefill {one['prefill_ms']:.1f} ms, decode "
                  f"{one['decode_ms_per_token']:.2f} ms/token, peak {one['peak_gb']:.2f} GB, "
                  f"one-ulp response {one['one_ulp_response']:.2e} of max |logit|, bars "
                  f"{out['bars'][arch]}; ranks " + "; ".join(
                      f"{r['rank']}: prefill {r['prefill_ms']:.1f} ms, decode "
                      f"{r['decode_ms_per_token']:.2f} ms/token, busy "
                      f"{r['decode_step_profile']['busy_share']:.3f}, peak {r['peak_gb']:.2f} GB, "
                      f"blocks {r['block_gb']:.3f} GB, prefill collectives "
                      f"{r['prefill_traffic']} B, a decode step's "
                      f"{r['decode_traffic_per_token']} B, logits err "
                      f"{max(r['logits_rel_err']):.2e}, cache {r['cache_last']}, launches: "
                      f"prefill {launched(r['prefill_launches'])}, decode "
                      f"{launched(r['decode_launches'])}" for r in rows), flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def sum_launches(steps) -> dict:
    """``{kernel: {route: n}}`` summed over a list of such counts."""
    return {k: {r: sum(c[k][r] for c in steps) for r in steps[0][k]} for k in steps[0]}


def check_train_launches(what, counts, want) -> None:
    """A training step's launches, ``{kernel: {route: n}}``, equal to
    ``want`` (:func:`scan_and_flash_launches`), and no other kernel's."""
    for kernel, routes in want.items():
        got = {r: n for r, n in counts[kernel].items() if n}
        if got != {r: n for r, n in routes.items() if n}:
            raise AssertionError(f"{what}: {kernel} launched {counts[kernel]}, want {routes}")
    if any(sum(c.values()) for k, c in counts.items() if k not in want):
        raise AssertionError(f"{what}: launched {counts}")


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
        if name.startswith("bottleneck_") or name in ("mamba_scan", "mamba_scan_bwd",
                                                      "rwkv6_scan", "rwkv6_scan_bwd"):
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
    # Z2b, Z5b: the backward kernels against their plain versions
    t0 = time.perf_counter()
    flash_bwd_rows = []
    for label, *shape in FLASH_BWD_SHAPES:
        flash_bwd_rows.append(check_flash_bwd(label, *shape, gen))
        print("Z2b flash_attention_bwd", json.dumps(flash_bwd_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    rwkv_bwd_rows = []
    for label, *shape in RWKV_BWD_SHAPES:
        rwkv_bwd_rows.append(check_rwkv_bwd(label, *shape, gen))
        print("Z5b rwkv6_scan_bwd", json.dumps(rwkv_bwd_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(f"Z2b, Z5b took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z7, Z7b: mamba_scan and its backward against their plain versions
    mamba_rows = []
    for label, *shape in MAMBA_SHAPES:
        mamba_rows.append(check_mamba(label, *shape, gen))
        print("mamba_scan", json.dumps(mamba_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mamba_bwd_rows = []
    for label, *shape in MAMBA_BWD_SHAPES:
        mamba_bwd_rows.append(check_mamba_bwd(label, *shape, gen))
        print("Z7b mamba_scan_bwd", json.dumps(mamba_bwd_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(f"Z7b took {time.perf_counter() - t0:.1f} s", flush=True)

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
    # Z18: deepseek-moe-16b, its MoE at the served capacity factor: (a) bf16
    # at full width and depth, (b) f32 cut in depth, (c) Z6's check at depth
    # E2E_MOE_LAYERS
    deep = serve_zoo(DEEPSEEK, LLAMA_PROMPTS)
    print(f"Z18a served {DEEPSEEK}", json.dumps(deep), flush=True)
    print(f"Z18a took {deep['phase_s']:.1f} s", flush=True)
    deep32 = serve_zoo(DEEPSEEK, LLAMA_PROMPTS, dtype="float32", n_layers=DEEPSEEK_F32_LAYERS)
    print(f"Z18b served {DEEPSEEK} float32", json.dumps(deep32), flush=True)
    print(f"Z18b took {deep32['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    deep_e2e = e2e_check(DEEPSEEK, n_layers=E2E_MOE_LAYERS)
    print(f"Z18c end to end {DEEPSEEK}", json.dumps(deep_e2e), flush=True)
    print(f"Z18c took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z19: whisper-tiny whole, bf16 and f32, and its f32 copy against the
    # CPU at full depth; Z20: internvl2-76b at full width, cut in depth
    t0 = time.perf_counter()
    whisper = {dtype: serve_zoo(WHISPER, LLAMA_PROMPTS, dtype=dtype)
               for dtype in ("bfloat16", "float32")}
    for dtype, row in whisper.items():
        print(f"Z19 served {WHISPER} {dtype}", json.dumps(row), flush=True)
    whisper_e2e = e2e_check(WHISPER, n_layers=get_config(WHISPER).n_layers)
    print(f"Z19 end to end {WHISPER}", json.dumps(whisper_e2e), flush=True)
    print(f"Z19 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    internvl = {"bfloat16": serve_zoo(INTERNVL, LLAMA_PROMPTS, n_layers=INTERNVL_BF16_LAYERS)}
    print(f"Z20a served {INTERNVL}", json.dumps(internvl["bfloat16"]), flush=True)
    internvl["float32"] = serve_zoo(INTERNVL, LLAMA_PROMPTS, dtype="float32",
                                    n_layers=INTERNVL_F32_LAYERS)
    print(f"Z20b served {INTERNVL} float32", json.dumps(internvl["float32"]), flush=True)
    internvl_e2e = e2e_check(INTERNVL, n_layers=E2E_MOE_LAYERS)
    print(f"Z20c end to end {INTERNVL}", json.dumps(internvl_e2e), flush=True)
    print(f"Z20 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z22: qwen3-moe-235b-a22b at full width, cut in depth: (a) bf16, (b)
    # f32, (c) Z6's check at depth E2E_MOE_LAYERS
    t0 = time.perf_counter()
    qwen3 = {"bfloat16": serve_zoo(QWEN3, LLAMA_PROMPTS, n_layers=QWEN3_BF16_LAYERS)}
    print(f"Z22a served {QWEN3}", json.dumps(qwen3["bfloat16"]), flush=True)
    qwen3["float32"] = serve_zoo(QWEN3, LLAMA_PROMPTS, dtype="float32", n_layers=QWEN3_F32_LAYERS)
    print(f"Z22b served {QWEN3} float32", json.dumps(qwen3["float32"]), flush=True)
    qwen3_e2e = e2e_check(QWEN3, n_layers=E2E_MOE_LAYERS)
    print(f"Z22c end to end {QWEN3}", json.dumps(qwen3_e2e), flush=True)
    print(f"Z22 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z21: jamba-v0.1-52b with its MoE at full width, cut in depth: (a) two
    # periods in bf16, (b) one in f32, (c) its first two layers in f32
    # against the CPU
    t0 = time.perf_counter()
    moe = get_config(JAMBA).moe
    jamba_moe = {"bfloat16": serve_zoo(JAMBA, LLAMA_PROMPTS, n_layers=JAMBA_MOE_BF16_LAYERS,
                                       moe=moe)}
    print(f"Z21a served {JAMBA} with its MoE", json.dumps(jamba_moe["bfloat16"]), flush=True)
    jamba_moe["float32"] = serve_zoo(JAMBA, LLAMA_PROMPTS, dtype="float32",
                                     n_layers=JAMBA_MOE_F32_LAYERS, moe=moe)
    print(f"Z21b served {JAMBA} with its MoE float32", json.dumps(jamba_moe["float32"]),
          flush=True)
    jamba_layers = layers_check(JAMBA, moe=moe)
    print(f"Z21 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z23: the continuous batcher on llama3.2-3b and rwkv6-1.6b whole, bf16,
    # then f32 also held to each request served alone
    t0 = time.perf_counter()
    batched = {}
    for dtype in ("bfloat16", "float32"):
        for arch, prompts in (("llama3.2-3b", LLAMA_PROMPTS), ("rwkv6-1.6b", RWKV_PROMPTS)):
            batched[f"{arch} {dtype}"] = row = batcher_run(arch, prompts, dtype)
            print(f"Z23 batcher {arch} {dtype}", json.dumps(row), flush=True)
    print(f"Z23 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z24: llama3.2-3b, rwkv6-1.6b and whisper-tiny trained whole in bf16,
    # jamba-v0.1-52b at one period;
    # Z24d: f32 copies' gradients on the card against the CPU; Z25: the Study
    # facade over zoo models on the card
    trained = {}
    for arch, n_layers, b, s in TRAIN_RUNS:
        t0 = time.perf_counter()
        trained[arch] = train_zoo(arch, n_layers, b, s)
        print(f"Z24 trained {arch}", json.dumps(trained[arch]), flush=True)
        print(f"Z24 {arch} took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    grad_rows = [grads_vs_cpu(*run) for run in GRAD_RUNS]
    print("Z24d gradients against the CPU", json.dumps(grad_rows), flush=True)
    print(f"Z24d took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    studies = {arch: zoo_study(arch) for arch in ZOO_STUDIES}
    for arch, row in studies.items():
        print(f"Z25 study {arch}", json.dumps(row), flush=True)
    print(f"Z25 took {time.perf_counter() - t0:.1f} s", flush=True)

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
    # Z17: the Study facade at full width, counted
    t0 = time.perf_counter()
    study = study_facade(card)
    print("Z17 study", json.dumps(study), flush=True)
    print(f"Z17 took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z26: the multi-pod split pipeline over two ranks on the card, the codec
    # kernels timed at its wire's shape, and the two launchers
    pipeline = multipod(gen)
    comp_rows.append(pipeline["codec"][0])
    dec_rows.append(pipeline["codec"][1])
    print("Z26 multipod", json.dumps(pipeline), flush=True)
    for mode, row in pipeline["modes"].items():
        print(f"Z26 {mode}: step {row['step_ms']:.1f} ms, sequential {row['sequential_ms']:.1f} "
              f"ms, wire {row['wire_bytes']} B (the reference's count "
              f"{row['reference_count_bytes']} B), busy {row['busy_share']}", flush=True)
    print(f"Z26 pipeline took {pipeline['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    launched = launchers()
    print("Z26 launchers", json.dumps(launched), flush=True)
    print(f"Z26 launchers took {time.perf_counter() - t0:.1f} s", flush=True)
    # Z27: sharded training over four ranks on the card
    sharded = sharded_training()
    print("Z27 sharded training", json.dumps(sharded), flush=True)
    print(f"Z27 took {sharded['phase_s']:.1f} s", flush=True)
    # Z28: sharded serving over four ranks on the card, and flash_attention
    # at a rank's heads
    serving_mesh = sharded_serving()
    print("Z28 sharded serving", json.dumps(serving_mesh), flush=True)
    for label, *shape in SERVE_SHARDED_FLASH:
        flash_rows.append(check_flash(label, *shape, gen))
        print("flash_attention", json.dumps(flash_rows[-1]), flush=True)
    print(f"Z28 took {serving_mesh['phase_s']:.1f} s", flush=True)
    # Z29: sharded serving of the recurrent and encoder-decoder families over
    # four ranks on the card, and the scans and flash at a rank's share
    recurrent = recurrent_serving()
    print("Z29 sharded recurrent serving", json.dumps(recurrent), flush=True)
    for label, *shape in SERVE_RECURRENT_RWKV:
        rwkv_rows.append(check_rwkv(label, *shape, gen))
        print("rwkv6_scan", json.dumps(rwkv_rows[-1]), flush=True)
    for label, *shape in SERVE_RECURRENT_MAMBA:
        mamba_rows.append(check_mamba(label, *shape, gen))
        print("mamba_scan", json.dumps(mamba_rows[-1]), flush=True)
    for label, *shape in SERVE_RECURRENT_FLASH:
        flash_rows.append(check_flash(label, *shape, gen))
        print("flash_attention", json.dumps(flash_rows[-1]), flush=True)
    print(f"Z29 took {recurrent['phase_s']:.1f} s", flush=True)

    # the kernels line: launches from each kernel's main path
    counts_keys = list(launch_counts())
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
            "Z17 study": study["launches"],
            "Z4 split": llama["split"]["launches"],
            f"Z8 {JAMBA}": jamba["launches"],
            f"Z8 {JAMBA} prefill": jamba["prefill_launches"],
            f"Z8 {JAMBA} decode": jamba["decode_launches"],
            **{f"{arch} float32": f32[arch]["launches"] for arch in f32},
            **{f"Z6 {e['arch']} depth {e['n_layers']}": e["launches"] for e in e2e},
            f"Z18a {DEEPSEEK}": deep["launches"],
            f"Z18a {DEEPSEEK} prefill": deep["prefill_launches"],
            f"Z18b {DEEPSEEK} float32 depth {DEEPSEEK_F32_LAYERS}": deep32["launches"],
            f"Z18c {DEEPSEEK} depth {deep_e2e['n_layers']}": deep_e2e["launches"],
            **{f"Z19 {WHISPER} {dt}": r["launches"] for dt, r in whisper.items()},
            **{f"Z19 {WHISPER} {dt} prefill": r["prefill_launches"] for dt, r in whisper.items()},
            f"Z19 {WHISPER} end to end": whisper_e2e["launches"],
            **{f"Z20 {INTERNVL} {dt} depth {r['n_layers']}": r["launches"]
               for dt, r in internvl.items()},
            f"Z20c {INTERNVL} depth {internvl_e2e['n_layers']}": internvl_e2e["launches"],
            **{f"Z22 {QWEN3} {dt} depth {r['n_layers']}": r["launches"] for dt, r in qwen3.items()},
            f"Z22a {QWEN3} prefill": qwen3["bfloat16"]["prefill_launches"],
            f"Z22c {QWEN3} depth {qwen3_e2e['n_layers']}": qwen3_e2e["launches"],
            **{f"Z21 {JAMBA} with its MoE {dt} depth {r['n_layers']}": r["launches"]
               for dt, r in jamba_moe.items()},
            **{f"Z21c {JAMBA} {row['layer']}": row["launches"] for row in jamba_layers["layers"]},
            **{f"Z23 {key} batcher": r["launches"] for key, r in batched.items()},
            **{f"Z24 {arch} training": {k: r["launches"].get(k, {}) for k in counts_keys}
               for arch, r in trained.items()},
            **{f"Z25 {arch} profile": {k: row["verbs"]["profile"]["launches"].get(k, {})
                                       for k in counts_keys} for arch, row in studies.items()},
            **{f"Z26 {mode} sequential": row["sequential_launches"]
               for mode, row in pipeline["modes"].items()},
            **{f"Z26 {mode} {('head', 'tail')[r['stage']]}": r["modes"][mode]["launches"]
               for r in pipeline["ranks"] for mode in SP.WIRE_MODES},
            **{f"Z27 {run['dtype']} rank {r['rank']}, {SHARDED_STEPS} steps": sum_launches(
                r["launches"]) for run in sharded["runs"] for r in run["ranks"]},
            "Z28 one-process served": serving_mesh["one_process"]["launches"],
            **{f"Z28 {r['mesh']} rank {r['rank']} {part}": r[key]
               for r in serving_mesh["ranks"]
               for part, key in (("served", "launches"), ("prefill", "prefill_launches"),
                                 ("decode", "decode_launches"))},
            **{f"Z29 {arch} one-process served": one["launches"]
               for arch, one in recurrent["one_process"].items()},
            **{f"Z29 {r['arch']} {r['mesh']} rank {r['rank']} {part}": r[key]
               for r in recurrent["ranks"]
               for part, key in (("prefill", "prefill_launches"), ("decode", "decode_launches"))}}

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

    def bwd_entry(name, kernel, rows, headline, run, fwd_replaces):
        head = next(e for e in rows if e["shape"] == headline)
        counts = trained[run]["launches"][kernel]
        by = {r: n for r, n in counts.items() if r.startswith("bwd") or r == "bwd"}
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": f"{fwd_replaces} (its backward: the TPU kernel has none)",
                "launches": sum(by.values()), "launches_on": f"Z24 {run} training, "
                f"{TRAIN_STEPS} steps", "launches_by": by,
                "launches_elsewhere": {
                    **{f"Z24d {e['arch']}": sum(
                        n for r, n in e["launches"][kernel].items() if r.startswith("bwd"))
                       for e in grad_rows},
                    **{k: sum(n for r, n in c[kernel].items() if r.startswith("bwd"))
                       for k, c in also.items() if k.startswith("Z27")}},
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
        bwd_entry("flash_attention_bwd", "flash_attention", flash_bwd_rows, "llama_train",
                  "llama3.2-3b", "src/repro/kernels/flash_attention.py:86"),
        bwd_entry("rwkv6_scan_bwd", "rwkv6_scan", rwkv_bwd_rows, "rwkv_train", "rwkv6-1.6b",
                  "src/repro/kernels/rwkv6_scan.py:56"),
        bwd_entry("mamba_scan_bwd", "mamba_scan", mamba_bwd_rows, "jamba_train", JAMBA,
                  "src/repro/kernels/mamba_scan.py:55"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
